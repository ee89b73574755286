"""Smoke run of the PyTorch port (``posendf_torch``) on one CUDA card.

Drives the pose prior's main path through its hand-written CUDA kernels on
the full-width trained field ``docs/quality/ckpt_l8_best.msgpack``:

  1. device: requires CUDA; prints the card's name and power limit
  2. build: compiles ``posendf_torch/csrc/field_kernels.cu`` with nvcc (timed)
  3. load: ``posendf_torch.load_field(ckpt, device="cuda")``
  4. kernel vs plain on the card, at B = 4096 and a ragged B = 1000:
     ``distance_fused`` vs ``distance``, ``distance_and_grad_fused`` vs
     ``distance_and_grad``, 5 steps of ``project(fused=True)`` vs
     ``fused=False``, and each kernel vs its plain PyTorch version
  5. against the JAX package: d, g and a 10-step projection of 256 probes
     vs ``tests/data/torch_port_l8_expected.npz``
  6. main path: ``distance_fused``, ``distance_and_grad_fused`` and a
     200-step ``project(fused=True)`` of 10,000 random poses, with the
     kernels' launch counts set to 0 before and read after; then times
     (CUDA events, after warm-up) of each kernel and its plain version

Tolerances (those of ``tests/test_fused_grad.py``): d and g ``atol=1e-5``;
projection ``rtol=1e-4, atol=1e-5`` -- fp32 sums of up to 1024 terms taken in
another order. TF32 is off for matrix products and convolutions, so the plain
path runs true fp32.

Any failure raises, so the script exits nonzero and prints no result. The
second-to-last line is a JSON object describing the kernels, the last line is
``{"ok": true, "device": {...}}``. Usage, from the repository root::

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

CKPT = "docs/quality/ckpt_l8_best.msgpack"
EXPECTED = "tests/data/torch_port_l8_expected.npz"
D_ATOL = 1e-5
G_ATOL = 1e-5
PROJ_RTOL, PROJ_ATOL = 1e-4, 1e-5
MAIN_BATCH, MAIN_STEPS = 10_000, 200
SERVE_BATCH = 131_072
SEED = 0


def log(*args) -> None:
    print(*args, flush=True)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach() - b.detach()).abs().max())


def assert_close(name: str, got: torch.Tensor, want: torch.Tensor, *, rtol: float = 0.0,
                 atol: float) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} values off, max |err| "
                             f"{float(err.max()):.3e} (rtol={rtol}, atol={atol})")
    log(f"  ok {name}: max |err| {float(err.max()):.3e}")
    return float(err.max())


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def interleaved_ms(kernel, plain, reps: int):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def main() -> None:
    # ---- 1. device ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")

    import posendf_torch
    from posendf_torch import _build
    from posendf_torch.ops import fused_grad, fused_model
    from posendf_torch.projection import project, random_poses

    # ---- 2. build ----
    t0 = time.perf_counter()
    info = _build.build_info()
    log(f"build: {info['path']} compiled={info['built']} nvcc {info['seconds']:.1f} s, "
        f"total {time.perf_counter() - t0:.1f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  " + line.strip())

    # ---- 3. load ----
    field = posendf_torch.load_field(CKPT, device="cuda")
    w = field.weights()
    smem = _build.library().posendf_smem_bytes(w.num_joints, w.feature_size,
                                                w.packed().num_layers, w.packed().maxw)
    log(f"load: {CKPT}, {sum(p.numel() for p in field.module.parameters())} parameters, "
        f"{w.activation}, {smem} bytes of shared memory per block")
    gen = torch.Generator().manual_seed(SEED)
    errs = {"fwd": 0.0, "vag": 0.0, "proj": 0.0}

    # ---- 4. kernel vs plain on the card ----
    for B in (4096, 1000):
        log(f"kernel vs plain, B = {B}")
        q = random_poses(gen, B, device="cuda")
        with torch.no_grad():
            d_k = field.distance_fused(q)
            assert_close("distance_fused vs distance", d_k, field.distance(q), atol=D_ATOL)
            errs["fwd"] = max(errs["fwd"], assert_close(
                "forward kernel vs fused_posendf_forward_ref", d_k,
                fused_model.fused_posendf_forward_ref(q, w), atol=D_ATOL))
            d_k, g_k = field.distance_and_grad_fused(q)
            d_p, g_p = fused_grad.fused_distance_and_grad_ref(q, w)
        d_m, g_m = field.distance_and_grad(q)
        assert_close("distance_and_grad_fused d vs distance_and_grad", d_k, d_m, atol=D_ATOL)
        assert_close("distance_and_grad_fused g vs distance_and_grad", g_k, g_m, atol=G_ATOL)
        errs["vag"] = max(errs["vag"],
                          assert_close("value-and-grad kernel d vs ref", d_k, d_p, atol=D_ATOL),
                          assert_close("value-and-grad kernel g vs ref", g_k, g_p, atol=G_ATOL))
        o_k, h_k = project(field, q, steps=5, fused=True)
        o_m, h_m = project(field, q, steps=5, fused=False)
        assert_close("project(fused=True) poses vs fused=False", o_k, o_m,
                     rtol=PROJ_RTOL, atol=PROJ_ATOL)
        assert_close("project(fused=True) history vs fused=False", h_k, h_m,
                     rtol=PROJ_RTOL, atol=PROJ_ATOL)
        with torch.no_grad():
            s_k = fused_grad.project_step(q, w)
            s_p = fused_grad.project_step_ref(q, w)
        errs["proj"] = max(errs["proj"],
                           assert_close("projection-step kernel d vs ref", s_k[0], s_p[0],
                                        atol=D_ATOL),
                           assert_close("projection-step kernel q vs ref", s_k[1], s_p[1],
                                        rtol=PROJ_RTOL, atol=PROJ_ATOL))

    # a zero pose in the batch: finite d, and g = gx / 1e-12 as in JAX
    q = random_poses(gen, 1000, device="cuda")
    q[7] = 0.0
    with torch.no_grad():
        d_k, g_k = field.distance_and_grad_fused(q)
        d_p, g_p = fused_grad.fused_distance_and_grad_ref(q, w)
    assert_close("zero pose in the batch: d vs ref", d_k, d_p, atol=D_ATOL)
    assert_close("zero pose in the batch: g vs ref", g_k, g_p, rtol=1e-4, atol=G_ATOL)

    # ---- 5. against the JAX package ----
    ref = np.load(EXPECTED)
    probes = torch.from_numpy(ref["probes"]).cuda()
    log(f"vs the JAX package ({EXPECTED}, {probes.shape[0]} probes)")
    with torch.no_grad():
        assert_close("distance_fused vs JAX d", field.distance_fused(probes),
                     torch.from_numpy(ref["dist"]), atol=D_ATOL)
        d_k, g_k = field.distance_and_grad_fused(probes)
    assert_close("distance_and_grad_fused d vs JAX", d_k, torch.from_numpy(ref["dist"]),
                 atol=D_ATOL)
    assert_close("distance_and_grad_fused g vs JAX", g_k, torch.from_numpy(ref["grad"]),
                 atol=G_ATOL)
    steps = ref["proj_hist"].shape[0]
    o_k, h_k = project(field, probes, steps=steps, fused=True)
    assert_close(f"project(fused=True) {steps}-step poses vs JAX", o_k,
                 torch.from_numpy(ref["proj_out"]), rtol=PROJ_RTOL, atol=PROJ_ATOL)
    assert_close(f"project(fused=True) {steps}-step history vs JAX", h_k,
                 torch.from_numpy(ref["proj_hist"]), rtol=PROJ_RTOL, atol=PROJ_ATOL)

    # ---- 6. main path ----
    poses = random_poses(gen, MAIN_BATCH, device="cuda")
    fused_model.LAUNCHES = fused_grad.VAG_LAUNCHES = fused_grad.PROJ_LAUNCHES = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        d_serve = field.distance_fused(poses)
    d_solve, g_solve = field.distance_and_grad_fused(poses)
    out, hist = project(field, poses, steps=MAIN_STEPS, fused=True)
    torch.cuda.synchronize()
    wall_first = time.perf_counter() - t0
    launches = {"fwd": fused_model.LAUNCHES, "vag": fused_grad.VAG_LAUNCHES,
                "proj": fused_grad.PROJ_LAUNCHES}
    log(f"main path: {MAIN_BATCH} poses, {MAIN_STEPS} fused steps, launches {launches}, "
        f"first run {wall_first:.3f} s")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path launched no {name} kernel")
    for name, t, shape in (("d", d_serve, (MAIN_BATCH, 1)), ("d", d_solve, (MAIN_BATCH, 1)),
                           ("g", g_solve, (MAIN_BATCH, 21, 4)), ("poses", out, (MAIN_BATCH, 21, 4)),
                           ("history", hist, (MAIN_STEPS, MAIN_BATCH))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"main path {name}: shape {tuple(t.shape)} or non-finite")
    m0, m1 = float(hist[0].mean()), float(hist[-1].mean())
    log(f"  mean distance {m0:.6f} -> {m1:.6f}")
    if not m1 < m0:
        raise AssertionError(f"projection did not lower the mean distance ({m0} -> {m1})")
    norms = out.norm(dim=-1)
    if float((norms - 1).abs().max()) > 1e-5:
        raise AssertionError("projected quaternions are not unit")

    proj_fused_ms = cuda_ms(lambda: project(field, poses, steps=MAIN_STEPS, fused=True), 3)
    proj_plain_ms = cuda_ms(lambda: project(field, poses, steps=MAIN_STEPS, fused=False), 1)
    log(f"{MAIN_STEPS}-step projection of {MAIN_BATCH} poses: fused {proj_fused_ms:.3f} ms, "
        f"module path {proj_plain_ms:.3f} ms  [{card}]")

    # ---- per-kernel times at the main path's shapes ----
    serve = random_poses(gen, SERVE_BATCH, device="cuda")
    with torch.no_grad():
        fwd_ms, fwd_plain_ms = interleaved_ms(
            lambda: field.distance_fused(poses),
            lambda: fused_model.fused_posendf_forward_ref(poses, w), 20)
        fwd_big_ms, fwd_big_plain_ms = interleaved_ms(
            lambda: field.distance_fused(serve),
            lambda: fused_model.fused_posendf_forward_ref(serve, w), 5)
        vag_ms, vag_plain_ms = interleaved_ms(
            lambda: field.distance_and_grad_fused(poses),
            lambda: fused_grad.fused_distance_and_grad_ref(poses, w), 20)
        proj_ms, proj_plain_ms_step = interleaved_ms(
            lambda: fused_grad.project_step(poses, w),
            lambda: fused_grad.project_step_ref(poses, w), 20)
        fwd_mod_ms = cuda_ms(lambda: field.distance(poses), 20)
    vag_mod_ms = cuda_ms(lambda: field.distance_and_grad(poses), 20)
    log(f"forward B={MAIN_BATCH}: kernel {fwd_ms:.4f} ms, plain {fwd_plain_ms:.4f} ms, "
        f"module {fwd_mod_ms:.4f} ms  [{card}]")
    log(f"forward B={SERVE_BATCH}: kernel {fwd_big_ms:.4f} ms "
        f"({SERVE_BATCH / fwd_big_ms * 1e3:.4g} evals/s), plain {fwd_big_plain_ms:.4f} ms "
        f"({SERVE_BATCH / fwd_big_plain_ms * 1e3:.4g} evals/s)  [{card}]")
    log(f"value-and-grad B={MAIN_BATCH}: kernel {vag_ms:.4f} ms, plain {vag_plain_ms:.4f} ms, "
        f"module {vag_mod_ms:.4f} ms  [{card}]")
    log(f"projection step B={MAIN_BATCH}: kernel {proj_ms:.4f} ms, plain "
        f"{proj_plain_ms_step:.4f} ms  [{card}]")

    src = "posendf_torch/csrc/field_kernels.cu"
    kernels = [
        {"name": "posendf_forward", "route": "cuda", "source": src,
         "replaces": "posendf_tpu/ops/fused_model.py:38", "launches": launches["fwd"],
         "max_abs_err": errs["fwd"], "ms": fwd_ms, "plain_ms": fwd_plain_ms},
        {"name": "posendf_value_and_grad", "route": "cuda", "source": src,
         "replaces": "posendf_tpu/ops/fused_grad.py:229", "launches": launches["vag"],
         "max_abs_err": errs["vag"], "ms": vag_ms, "plain_ms": vag_plain_ms},
        {"name": "posendf_project_step", "route": "cuda", "source": src,
         "replaces": "posendf_tpu/ops/fused_grad.py:245", "launches": launches["proj"],
         "max_abs_err": errs["proj"], "ms": proj_ms, "plain_ms": proj_plain_ms_step},
    ]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    main()
