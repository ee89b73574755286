"""Where the hand-written kernels' time goes: ``posendf_forward_int8``,
``probe_bf16_chain``, ``probe_int8_chain``, ``posendf_project_step``,
``posendf_forward``, ``posendf_train_tile``, ``posendf_encoder`` and the kNN
exact and bf16 engines (``posendf_knn_joint``) timed with parts of their
work cut out of the source, or with another shape of the same kernel.

``ncu`` does not run where the card is, so this measures by subtraction:
each variant is ``csrc/int8_kernels.cu``, ``csrc/field_kernels.cu``,
``csrc/train_kernels.cu`` or ``csrc/knn_kernels.cu`` with some statements
replaced (its results are
wrong; only its time means something), built with the same nvcc flags into
``build/posendf_torch/breakdown/`` and timed through the same wrappers as
the real kernel, in rounds.

``int8_kernels.cu``:

  ``base``     the kernel as it is
  ``noenc``    without the encoder walk
  ``nof32``    without the fp32 layers (0, 5, 6)
  ``nomma``    without the wgmma products (the slabs still stream through
               the ring and are released)
  ``noepi``    without the int8 layers' epilogues
  ``copies``   all four cut: the weight ring alone
  ``rows128``  the int8 probe chain with 128 rows a CTA (two consumer
               warpgroups taking turns) instead of 192 (a whole kernel, held
               to the plain chain)
  ``noconv``   the int8 probe chain without its requantization arithmetic
               (the sums' low bytes stored as they are)
  ``qring``    the int8 probe chain without both: its ring, turns and stores

The bf16 and int8 chains run ``base`` and ``nomma`` (their products cut: the
ring alone), the int8 chain ``rows128`` and ``noconv`` too.

``field_kernels.cu`` (the projection step at 10,000 poses and the forward
at 131,072, each on the trained field in fp32 (the 3xTF32 route) and loaded
with ``compute_dtype="bfloat16"`` (the bf16 route); a cut reaches both
routes where they share the code):

  ``base``     the kernels as they are
  ``noenc``    without the encoder walk and its reverse walk (the calls of
               ``walk_forward`` and ``walk_backward``, each with its rows'
               staging; before the four-lanes-a-pose walks, of ``encode``
               and ``encode_backward``: the same cut)
  ``nomma``    without the wgmma products (the A fragments are still loaded
               and split, the slabs still stream and are released)
  ``noepi``    without the DFNet layers' epilogues (and so without the
               folds into the layers' sums, which nothing reads then)
  ``copies``   those three cut and the A fragments' loads too: the weight
               ring alone (with the output layer and the CUDA-core ends)

``train_kernels.cu``'s tile kernel (both branches at 20,000 + 20,000 poses
of the trained field, the main path's training batch):

  ``base``     the kernel as it is
  ``noenc``    without the encoder's walks (forward, reverse, the e-chain's
               encoder half with the encoder's weight gradient) and the
               eikonal term (the calls of ``walk_forward``, ``walk_backward``,
               ``eikonal`` and ``walk_echain``, each walk with its rows'
               staging; before the four-lanes-a-pose walks, of ``encode``,
               ``encode_backward``, ``eikonal`` and ``encoder_grad``: the
               same cut)
  ``nograd``   without the e-chain's encoder half and the encoder's weight
               gradient alone (the call of ``walk_echain``; before, of
               ``encoder_grad``)
  ``nomma``    without the wgmma products (as the field kernels' cut)
  ``nostore``  without the scratch stores (x_l, c_l, the e-chain's folds)
  ``ring``     those three cut, the epilogues and the A fragments' loads
               too: the weight ring alone (three passes a noisy CTA, two a
               manifold one, with the output layer and the loss)

and its encoder kernel (131,072 poses of the trained field):

  ``base``     the kernel as it is (two threads a pose)
  ``encio``    without the joint walk: the copies in and out alone
  ``walkonly`` the joint walk alone (no poses in, no features out)
  ``wconst``   the walk's weights as constants (no weight loads)

``knn_kernels.cu``'s exact and bf16 engines (pack, top-k and merge at
Q = 4,096 x N = 1,048,576, k = 5, on a synthetic pose manifold and one
run of the reference sampler's noisy queries of it: five noise draws, each
shared by a sigma group; with ``base``, the bound engine and
``fused_geodesic_topk_fast`` on the same queries):

  ``base``     the kernel as it is (12 held-back columns a thread; slab g + 2
               copied from the start of slab g)
  ``late``     slab g + 2 copied from the end of slab g (a whole kernel; its
               results are held to ``base``'s)
  ``pend0``    no held-back columns: each marked column recomputed at its
               slab (a whole kernel, held to ``base``'s results)
  ``nomark``   no column marked (the thresholds at -inf at run time): the
               products, the epilogue and the rows' minima, no recompute
  ``epi``      ``nomark`` without the wgmma products (the epilogue reads
               stale accumulators): the epilogue and the ring
  ``mma``      without the marks (so the compiler drops the epilogue that
               feeds them): the products and the ring
  ``ring``     ``mma`` without the products: the slab ring, the waits and
               the A groups
  ``compute``  ``nomark`` without the ring (every slab after the first two
               computed on a stale slot): the products and the epilogue
  ``epionly``  ``compute`` without the products: the epilogue alone

Run on the card::

    python -m posendf_torch.ops.breakdown [int8|field|train|knn ...]

(no argument: every library).

One line a kernel and variant: the median of CUDA-event means, at the main
shapes (131,072 poses of the trained field; (131,072, 512) x 8 layers;
10,000 poses a projection step; 20,000 + 20,000 poses a training step). A cut that no longer finds its statement in
the source stops the run.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from posendf_torch import _build

__all__ = ["CUTS", "VARIANTS", "variant_source", "main"]

CUTS: Dict[str, Dict[str, List[Tuple[str, str]]]] = {
    "int8": {
        "noenc": [("    encode_tile(a, row0, reinterpret_cast<float*>(x0), hid, reinterpret_cast<float*>(x1));\n",
                   "")],
        "nof32": [("  const int Kb = K - K % kPre;   // rows in whole blocks\n",
                   "  const int Kb = K - K % kPre;   // rows in whole blocks\n  if (W) return;\n")],
        "nomma": [("wgmma_m64n64k32_s8(acc, da, db, (kb | kk) != 0);", "{ (void)da; (void)db; }"),
                  ("wgmma_m64n32k32_s8(acc, da, db, (kb | kk) != 0);", "{ (void)da; (void)db; }"),
                  ("            wgmma_m64n256k16_bf16(acc, desc_sw128(a_base + kb * kPBlock + kk * 32),\n"
                   "                                  desc_sw128(b_base + kk * 32), (kb | kk) != 0);",
                   "            (void)b_base;"),
                  ("            wgmma_m64n128k32_s8(acc, desc_sw128(a_base + kb * kQBlock + kk * 32),\n"
                   "                                desc_sw128(b_base + kk * 32), (kb | kk) != 0);",
                   "            (void)b_base;")],
        "rows128": [("constexpr int kQCW = 3;", "constexpr int kQCW = 2;")],
        "noconv": [("  const float v = rintf(__fmul_rn(__int2float_rn(acc), s));\n"
                    "  return static_cast<signed char>(fminf(fmaxf(v, -127.f), 127.f));\n",
                    "  return static_cast<signed char>(acc + (s > 0.f));\n")],
        "noepi": [("    for (int g = 0; g < WN / 8; ++g) {\n      const int col = col0 + 8 * g;",
                   "    for (int g = 0; g < WN / 8; ++g) {\n      if (a.B >= 0) continue;\n"
                   "      const int col = col0 + 8 * g;")],
    },
    "field": {
        "noenc": [("  walk_forward<kAct, kBf16>(a, row0, x, __ldg(head + 2), ez, ps, reinterpret_cast<float*>(ring));\n",
                   ""),
                  ("  walk_backward<kAct, kBf16>(a, x, ez, gx, ps);\n", "")],
        "nomma": [("  __device__ __forceinline__ void mma(float (&acc)[N / 2], uint32_t bh, uint32_t bl) {\n",
                   "  __device__ __forceinline__ void mma(float (&acc)[N / 2], uint32_t bh, uint32_t bl) {\n"
                   "    if (bh != ~0u) return;\n")],
        "noepi": [("__device__ __forceinline__ void epilogue(const float (&acc)[NG][4 * NJ], int cg0, const Epi& e,\n"
                   "                                         const Ctx& cx, const uint32_t (&zbits)[NG]) {\n",
                   "__device__ __forceinline__ void epilogue(const float (&acc)[NG][4 * NJ], int cg0, const Epi& e,\n"
                   "                                         const Ctx& cx, const uint32_t (&zbits)[NG]) {\n"
                   "  if (e.col0 >= 0) return;\n")],
        "noload": [("      if constexpr (kBf16)\n"
                    "        load_a_bf16(b, r, k + 16 * kk, hi[kk]);\n"
                    "      else\n"
                    "        load_a(b, r, k + 8 * kk, hi[kk], lo[kk]);\n",
                    "      for (int j = 0; j < 4; ++j) hi[kk][j] = lo[kBf16 ? 0 : kk][j] = 0u;\n")],
    },
}
CUTS["train"] = {
    "noenc": [("  walk_forward<kAct>(a, row0, x, __ldg(head + 2), scal, ez, ezb, parents, reinterpret_cast<float*>(ring));\n", ""),
              ("  walk_backward<kAct>(a, row0, x, ezb, gg, gx, parents);\n", ""),
              ("  if (a.eikonal) eikonal(a, row0, gx, gx + J * 4 * kRows, scal);\n", ""),
              ("  walk_echain<kAct>(a, cta, x, ez, ezb, gg, lr, gx, scal, parents, gx + J * 4 * kRows);\n", "")],
    "nograd": [("  walk_echain<kAct>(a, cta, x, ez, ezb, gg, lr, gx, scal, parents, gx + J * 4 * kRows);\n", "")],
    "nomma": [("        wgmma_tf32_rs<64>(acc, al[kk], desc_sw128(hi + kk * 32), kk > 0);\n"
               "        wgmma_tf32_rs<64>(acc, ah[kk], desc_sw128(lo + kk * 32), 1);\n"
               "        wgmma_tf32_rs<64>(acc, ah[kk], desc_sw128(hi + kk * 32), 1);\n",
               "        (void)hi;\n        (void)lo;\n"),
              ("        wgmma_tf32_rs<32>(acc, al[kk], desc_sw128(hi + kk * 32), kk > 0);\n"
               "        wgmma_tf32_rs<32>(acc, ah[kk], desc_sw128(lo + kk * 32), 1);\n"
               "        wgmma_tf32_rs<32>(acc, ah[kk], desc_sw128(hi + kk * 32), 1);\n",
               "        (void)hi;\n        (void)lo;\n")],
    "nostore": [("  if (s.dst == nullptr) return;\n", "  if (s.ld >= 0) return;\n")],
    "walkonly": [("  for (int i = t; i < kEncPoses * J; i += kEncThreads)\n    cp_async16(smem_u32(qs",
                  "  for (int i = t; B < 0 && i < kEncPoses * J; i += kEncThreads)\n    cp_async16(smem_u32(qs"),
                 ("  for (int i = t; i < n / 4; i += kEncThreads)", "  for (int i = t; B < 0 && i < n / 4; i += kEncThreads)")],
    "wconst": [("    const float4 v = *reinterpret_cast<const float4*>(w + 4 * c);",
                "    const float4 v = make_float4(1e-3f * c, 2e-3f, 3e-3f, 4e-3f);")],
    "encio": [("  for (int j = 0; j < J; ++j) {\n    const int pj = par[j];",
               "  for (int j = 0; j < (B < 0 ? J : 0); ++j) {\n    const int pj = par[j];")],
    "noepi": [("__device__ __forceinline__ void epilogue(const float (&acc)[NG][4 * NJ], int cg0, const Epi& e,\n"
               "                                         const Ctx& cx) {\n",
               "__device__ __forceinline__ void epilogue(const float (&acc)[NG][4 * NJ], int cg0, const Epi& e,\n"
               "                                         const Ctx& cx) {\n  if (e.col0 >= 0) return;\n")],
    "noload": [("    for (int kk = 0; kk < 4; ++kk) load_a(a, r, 32 * kb + 8 * kk + c, ah[kk], al[kk]);\n",
                "    for (int kk = 0; kk < 4; ++kk)\n      for (int j = 0; j < 4; ++j) ah[kk][j] = al[kk][j] = 0u;\n"),
               ("      for (int kk = 0; kk < 4; ++kk)\n"
                "        load_a(a, r, 2 * kSlabK * kp + kSlabK * h + 8 * kk + c, ah[kk], al[kk]);\n",
                "      for (int kk = 0; kk < 4; ++kk)\n        for (int j = 0; j < 4; ++j) ah[kk][j] = al[kk][j] = 0u;\n")],
}
CUTS["knn"] = {
    "late": [("    refill(g + kJStages - 1);\n    const uint32_t cb", "    const uint32_t cb"),
             ("  }\n  flush();\n", "    refill(g + kJStages - 1);\n  }\n  flush();\n")],
    "pend0": [("constexpr int kJPend = 12;", "constexpr int kJPend = 0;")],
    "noring": [("    const int s = await_slab(bars, kJStages, g);\n",
                "    const int s = g < kJStages - 1 ? await_slab(bars, kJStages, g) : 0;\n"),
               ("    refill(g + kJStages - 1);\n    const uint32_t cb", "    const uint32_t cb")],
    "nomark": [("  thresholds();\n", "  thresholds();\n  if (a.N > 0) t0 = t1 = -INFINITY;\n")],
    "nofilter": [("    if (__any_sync(0xffffffffu, lo0 <= t0 || lo1 <= t1)) {",
                  "    if (false) {")],
    "nomma": [("        wgmma_m64n64k16_bf16(nxt, desc_sw32(qa + (j + 1) * kJQTile),\n"
               "                             desc_sw32(cb + (j + 1) * kJTile), 0);\n",
               "        (void)nxt;\n"),
              ("    wgmma_m64n64k16_bf16(acc0, desc_sw32(qa), desc_sw32(cb), 0);\n", "")],
}
VARIANTS = {
    "int8": {"base": [], "noenc": ["noenc"], "nof32": ["nof32"], "nomma": ["nomma"],
             "noepi": ["noepi"], "copies": ["noenc", "nof32", "nomma", "noepi"],
             "rows128": ["rows128"], "noconv": ["noconv"],
             "qring": ["nomma", "noconv"]},
    "field": {"base": [], "noenc": ["noenc"], "nomma": ["nomma"], "noepi": ["noepi"],
              "copies": ["noenc", "nomma", "noepi", "noload"]},
    "train": {"base": [], "noenc": ["noenc"], "nograd": ["nograd"], "nomma": ["nomma"],
              "nostore": ["nostore"],
              "ring": ["noenc", "nomma", "nostore", "noepi", "noload"],
              "encio": ["encio"], "walkonly": ["walkonly"],
              "wconst": ["wconst"]},
    "knn": {"base": [], "late": ["late"], "pend0": ["pend0"], "nomark": ["nomark"],
            "epi": ["nomark", "nomma"], "mma": ["nofilter"], "ring": ["nofilter", "nomma"],
            "compute": ["nomark", "noring"], "epionly": ["nomark", "nomma", "noring"]},
}


def variant_source(lib: str, name: str) -> str:
    """Library ``lib``'s source with variant ``name``'s cuts; raises if a cut
    no longer matches the source."""
    text = _build.SOURCES[lib].read_text()
    for cut in VARIANTS[lib][name]:
        for old, new in CUTS[lib][cut]:
            if old not in text:
                raise RuntimeError(f"breakdown cut {cut!r} no longer matches "
                                   f"{_build.SOURCES[lib].name}")
            text = text.replace(old, new)
    return text


def _build_variant(job: Tuple[str, str]) -> ctypes.CDLL:
    lib_name, name = job
    out = _build.BUILD_DIR / "breakdown"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{lib_name}_{name}.cu", out / f"{lib_name}_{name}.so"
    cu.write_text(variant_source(lib_name, name))
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on breakdown variant {lib_name} {name}:\n{proc.stdout}")
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in _build._SIGNATURES[lib_name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def _knn_inputs():
    """The labelling main path's search at its batch: 4,096 noisy queries of
    a 1,048,576-pose synthetic manifold (as ``chip_smoke.py`` phase 13 makes
    it), on the card."""
    from posendf_torch.data.prepare import NoiseSpec, sample_noisy_queries
    from posendf_torch.data.synthetic import manifold_family, synthetic_manifold_poses

    g = np.random.default_rng(13)
    family = manifold_family(g, latents=8)
    corpus = np.concatenate([synthetic_manifold_poses(g, 16_384, family=family)
                             for _ in range(64)])
    queries = sample_noisy_queries(corpus[:16_384], 4096, NoiseSpec(), g)
    return torch.from_numpy(queries).cuda(), torch.from_numpy(corpus).cuda()


def main(which=None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("breakdown: torch.cuda.is_available() is false; it needs a card")
    import posendf_torch
    from posendf_torch.config import PoseNDFConfig
    from posendf_torch.ops import fused_encoder, fused_grad, fused_int8, fused_knn, fused_train
    from posendf_torch.ops import int8_probe as P

    which = list(VARIANTS) if not which else which
    jobs = [(lib, name) for lib in which for name in VARIANTS[lib]]
    with ThreadPoolExecutor(len(jobs)) as pool:   # one nvcc a variant, all at once
        libs = dict(zip(jobs, pool.map(_build_variant, jobs)))
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ckpt = os.path.join(root, "docs", "quality", "ckpt_l8_best.msgpack")
    field = posendf_torch.load_field(ckpt, device="cuda")
    w = field.weights()
    cfg16 = PoseNDFConfig()
    cfg16.dfnet.compute_dtype = "bfloat16"
    f16 = posendf_torch.load_field(ckpt, config=cfg16, device="cuda")
    w16 = f16.weights()
    q = np.random.default_rng(3).normal(size=(131_072, 21, 4)).astype(np.float32)
    q = torch.from_numpy(q / np.linalg.norm(q, axis=-1, keepdims=True)).cuda()
    q10 = q[:10_000].clone()
    qf = field.quantize_int8(q[:4096])
    m = qf.module
    xb, wb, xi, wi, si = P.probe_inputs(seed=2)
    enc = field.module.enc

    def encoder():
        with torch.no_grad():
            return fused_encoder.fused_structure_encoder(q, enc.w1, enc.b1, enc.w2, enc.b2,
                                                         parents=field.module.parents)

    rows = 20_000   # the main path's training batch, each branch
    qt = torch.from_numpy(np.random.default_rng(4).normal(size=(2, rows, 21, 4)).astype(np.float32))
    qt = (qt / qt.norm(dim=-1, keepdim=True)).cuda()
    gt = torch.from_numpy(np.abs(np.random.default_rng(5).normal(size=rows)).astype(np.float32)
                          * 0.1).cuda()
    kw_n, kw_m = fused_train.branch_args(w, qt[0], gt, qt[1], "l1", 1.0, 1.0, 1.0)
    kq, kc = _knn_inputs() if "knn" in which else (None, None)
    knn_base = {}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    library = _build.library
    try:
        for (lib_name, name), lib in libs.items():
            _build.library = (lambda which="field", lib=lib, lib_name=lib_name:
                              lib if which == lib_name else library(which))
            if lib_name == "int8":
                if name not in ("rows128", "noconv", "qring"):
                    t = P.cuda_ms(lambda: fused_int8.fused_posendf_forward_int8(
                        q, qf.qparams, parents=m.parents, activation=m.activation, beta=m.beta),
                        reps=5, rounds=5)
                    print(f"int8 forward {name}: {t[0]:.4f} ms [{t[1]:.4f}-{t[2]:.4f}]", flush=True)
                if name in ("base", "nomma"):
                    t = P.cuda_ms(lambda: P.run_bf16(xb, wb), reps=5, rounds=5)
                    print(f"probe bf16 {name}: {t[0]:.4f} ms [{t[1]:.4f}-{t[2]:.4f}]", flush=True)
                if name in ("base", "nomma", "rows128", "noconv", "qring"):
                    if name == "rows128":   # a whole kernel: held to the plain chain
                        if not torch.equal(P.run_int8(xi, wi, si), P.run_int8_ref(xi, wi, si)):
                            raise AssertionError("probe int8 rows128: other results than plain")
                    t = P.cuda_ms(lambda: P.run_int8(xi, wi, si), reps=5, rounds=5)
                    print(f"probe int8 {name}: {t[0]:.4f} ms [{t[1]:.4f}-{t[2]:.4f}]", flush=True)
                continue
            if lib_name == "knn":
                for e in ("vpu", "mxu_bf16"):
                    out = fused_knn.fused_geodesic_topk(kq, kc, 5, dot_impl=e)
                    if name == "base":
                        knn_base[e] = out
                    elif name in ("late", "pend0") and not all(
                            torch.equal(x, y) for x, y in zip(out, knn_base[e])):
                        raise AssertionError(f"kNN {e} {name}: other results than base")
                    t = P.cuda_ms(lambda: fused_knn.fused_geodesic_topk(kq, kc, 5, dot_impl=e),
                                  reps=3, rounds=5)
                    print(f"kNN {e} Q=4096 N=1048576 k=5 {name}: {t[0]:.4f} ms "
                          f"[{t[1]:.4f}-{t[2]:.4f}]", flush=True)
                if name == "base":   # the other way to exact labels, on the same queries
                    for what, fn in (("mxu_fast (the bound engine)", lambda: fused_knn.fused_geodesic_topk(
                            kq, kc, 5, dot_impl="mxu_fast")), ("fused_geodesic_topk_fast", lambda:
                            fused_knn.fused_geodesic_topk_fast(kq, kc, 5))):
                        t = P.cuda_ms(fn, reps=3, rounds=3)
                        print(f"kNN {what} Q=4096 N=1048576 k=5: {t[0]:.4f} ms "
                              f"[{t[1]:.4f}-{t[2]:.4f}]", flush=True)
                continue
            if lib_name == "train":
                if name in ("base", "encio", "walkonly", "wconst"):
                    t = P.cuda_ms(encoder, reps=20, rounds=5)
                    print(f"encoder B=131072 {name}: {t[0]:.4f} ms [{t[1]:.4f}-{t[2]:.4f}]",
                          flush=True)
                if name in ("encio", "walkonly", "wconst"):
                    continue
                t = P.cuda_ms(lambda: fused_train.launch_tiles(w, qt[0], gt, qt[1], kw_n, kw_m),
                              reps=3, rounds=5)
                print(f"train tile B=M={rows} {name}: {t[0]:.4f} ms [{t[1]:.4f}-{t[2]:.4f}]",
                      flush=True)
                continue
            with torch.no_grad():
                for route, fw, ww in (("", field, w), ("bf16 ", f16, w16)):
                    t = P.cuda_ms(lambda: fused_grad.project_step(q10, ww), reps=10, rounds=5)
                    print(f"{route}projection step B=10000 {name}: {t[0]:.4f} ms "
                          f"[{t[1]:.4f}-{t[2]:.4f}]", flush=True)
                    t = P.cuda_ms(lambda: fw.distance_fused(q), reps=5, rounds=5)
                    print(f"{route}forward B=131072 {name}: {t[0]:.4f} ms [{t[1]:.4f}-{t[2]:.4f}]",
                          flush=True)
    finally:
        _build.library = library


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
