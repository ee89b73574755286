"""The JAX package's side of the quality drivers: the stages of
``scripts/quality_grid.py`` as functions, and the expected values of one
run of it for ``chip_smoke.py`` phase 21 (b).

``scripts/quality_grid.py`` keeps every stage inside ``main``; the functions
here are those stages, line for line, on the JAX package (JAX on the CPU),
so ``tests/test_torch_quality.py`` can hold ``scripts/torch_quality_grid.py``
to them one stage at a time. ``main`` checks that they are the script's: it
runs the script itself on the same settings and requires its rounded JSON
numbers to equal theirs.

The run: ``same_clips_reference.json``'s settings (corpus 131,072, queries
2,048, 8 latents, frequencies 0.5-1.2, ``--load-ckpt
docs/quality/ckpt_l8_best.msgpack``) with the grid cut to sigma 0.05 and
0.5, one clip each, ``--ablate-prior``. Stored in
``tests/data/torch_port_quality_expected.npz`` (numbers, no parameters):

  field             (5,)     field_mae, field_corr, field_live_frac,
                             clean_field_mean, noisy_field_mean (unrounded)
  sigmas            (S,)     the grid's noise levels
  rows              (S, 6)   v2v_input_cm, v2v_out_cm, prior_at_input,
                             final_pose_pr, v2v_out_noprior_cm,
                             improvement_pct of each level (10 x 50 steps)
  noisy, gt         (S, 60, 63)  each level's clip (the eval stream)
  short_pose        (S, 2, 60, 69)  the 2 x 4-step solves of each clip,
                             prior on and off
  short_metrics     (S, 2, 3)  their v2v_cm, v2v_input_cm, final_pose_pr
  ulp_spread        (S, 2)   how far each level's 500-step v2v_out_cm and
                             v2v_out_noprior_cm move when every float of
                             the clip moves one unit in the last place (up
                             or down, the larger): JAX's own sensitivity to
                             rounding over the 500-step horizon

Usage::

    JAX_PLATFORMS=cpu python scripts/make_torch_port_quality_golden.py
"""

from __future__ import annotations

import ast
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(ROOT, "scripts", "quality_grid.py")
CKPT = os.path.join(ROOT, "docs", "quality", "ckpt_l8_best.msgpack")
OUT = os.path.join(ROOT, "tests", "data", "torch_port_quality_expected.npz")
CORPUS, QUERIES, LATENTS, FREQ = 131072, 2048, 8, (0.5, 1.2)
SIGMAS, CLIPS, FRAMES = (0.05, 0.5), 1, 60
SHORT = (2, 4)
FIELD_KEYS = ("field_mae", "field_corr", "field_live_frac", "clean_field_mean",
              "noisy_field_mean")
ROW_KEYS = ("v2v_input_cm", "v2v_out_cm", "prior_at_input", "final_pose_pr",
            "v2v_out_noprior_cm", "improvement_pct")


def jax_script():
    """``scripts/quality_grid.py`` as a module (its ``gentle_family`` and
    ``gate_should_swap``)."""
    spec = importlib.util.spec_from_file_location("quality_grid", JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def script_constants() -> dict:
    """The literal assignments of ``CURRICULUM`` and ``CHUNK``'s cap in the
    JAX script's ``main`` (read from its source)."""
    tree = ast.parse(open(JAX_SCRIPT).read())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name == "CURRICULUM":
                out[name] = ast.literal_eval(node.value)
            elif name == "CHUNK":   # min(STEPS, 500)
                out[name] = ast.literal_eval(node.value.args[1])
    return out


def script_keys() -> tuple:
    """(the keys of the JAX script's result JSON, every key a grid row can
    have), read from its source."""
    tree = ast.parse(open(JAX_SCRIPT).read())
    result, row = set(), set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        t = node.targets[0]
        if isinstance(t, ast.Name) and isinstance(node.value, ast.Dict):
            keys = {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
            {"result": result, "row": row}.get(t.id, set()).update(keys)
        elif (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
              and t.value.id == "row" and isinstance(t.slice, ast.Constant)):
            row.add(t.slice.value)
    return result, row


def curriculum_weights(steps: int) -> list:
    """The manifold weight of each chunk of a ``steps``-step run, as the JAX
    script's loop takes it (``CHUNK``, ``n_chunks``, ``progress``)."""
    c = script_constants()
    chunk = min(steps, c["CHUNK"])
    n_chunks = (steps + chunk - 1) // chunk if steps else 0
    return [next(w for frac, w in c["CURRICULUM"] if ci / n_chunks < frac)
            for ci in range(n_chunks)]


def make_rng(seed: int, i: int) -> np.random.Generator:
    return np.random.default_rng(i if seed == 0 else [seed, i])


def family(seed: int, latents: int, freq) -> tuple:
    return jax_script().gentle_family(seed=123 if seed == 0 else [seed, 123], lo=freq[0],
                                      hi=freq[1], latents=latents)


def manufacture(seed: int, fam, N: int, Q: int, structured_frac: float = 0.0,
                per_pose_noise: bool = False) -> dict:
    """The JAX script's stage 1 on the CPU (``precision="highest"``)."""
    import jax.numpy as jnp

    from posendf_tpu.data.prepare import NoiseSpec, label_sequence
    from posendf_tpu.data.synthetic import synthetic_manifold_poses

    corpus_np = synthetic_manifold_poses(make_rng(seed, 0), N, family=fam)
    corpus = jnp.asarray(corpus_np)
    spec = NoiseSpec(structured_frac=structured_frac)

    def label(n, stream):
        return label_sequence(corpus_np, corpus, corpus_np=corpus_np, num_queries=n, k=5,
                              rng=make_rng(seed, stream), per_pose_noise=per_pose_noise,
                              runs=1 if per_pose_noise else max(1, n // 128),
                              precision="highest", spec=spec)

    labeled = label(Q, 1)
    held = label(min(4096, max(256, Q // 4)), 2)
    return {"corpus_np": corpus_np, "q_pose": np.asarray(labeled["pose"]),
            "q_dist": np.asarray(labeled["dist"].mean(axis=1)),
            "h_pose": np.asarray(held["pose"]), "h_dist": np.asarray(held["dist"].mean(axis=1))}


def model():
    """(module, the JAX script's initial params: ``module.init(key(0))``)."""
    import jax
    import jax.numpy as jnp

    from posendf_tpu.config import PoseNDFConfig

    module = PoseNDFConfig().make_model()
    return module, module.init(jax.random.key(0), jnp.zeros((1, 21, 4)))["params"]


def matched_init(module, params, q_pose, q_dist):
    """The JAX script's he-matched init: the head bias + 0.1, then
    ``moment_matched_head_init`` on the first 4,096 queries and every label."""
    import jax.numpy as jnp

    from posendf_tpu.training import moment_matched_head_init

    last = 1 + max(int(k[1:]) for k in params["dfnet"] if k[0] == "w")
    params = dict(params, dfnet=dict(params["dfnet"], **{
        f"b{last - 1}": params["dfnet"][f"b{last - 1}"] + 0.1}))
    params, _ = moment_matched_head_init(module, params, jnp.asarray(q_pose[:4096]),
                                         np.asarray(q_dist))
    return params


def load_params(module, params, path: str):
    """A ``--save-ckpt`` file read as the JAX script reads it."""
    from flax import serialization as fser

    with open(path, "rb") as f:
        payload = fser.from_bytes({"epoch": 0, "state": {"params": params}}, f.read())
    return payload["state"]["params"], payload["epoch"]


def field_quality(module, params, h_pose, h_dist, corpus_np) -> dict:
    """The JAX script's stage 3, unrounded."""
    import jax
    import jax.numpy as jnp

    ev = jax.jit(lambda p, q: module.apply({"params": p}, q))
    pred = np.asarray(ev(params, jnp.asarray(h_pose))).ravel()
    clean = np.asarray(ev(params, jnp.asarray(corpus_np[:4096]))).ravel()
    return {"mae": float(np.mean(np.abs(pred - h_dist))),
            "corr": float(np.corrcoef(pred, h_dist)[0, 1]) if pred.std() > 0 else float("nan"),
            "live_frac": float(np.mean(pred > 0)), "clean_mean": float(clean.mean()),
            "noisy_mean": float(pred.mean())}


def chunk_indices(key, steps: int, batch: int, Q: int, N: int) -> list:
    """The (query rows, corpus rows) of each step of the JAX script's
    ``train_chunk`` with chunk key ``key``."""
    import jax

    out = []
    for k in jax.random.split(key, steps):
        kq, km = jax.random.split(k)
        out.append((np.asarray(jax.random.randint(kq, (batch,), 0, Q)),
                    np.asarray(jax.random.randint(km, (batch,), 0, N))))
    return out


def train_chunk(module, params, lr: float, wman: float, w_eikonal: float, q_pose, q_dist,
                corpus_np, indices):
    """The JAX script's training chunk from a fresh Adam state, over given
    indices: (params, (steps, 4) terms in the order dist, eikonal,
    man_loss, total)."""
    import jax
    import jax.numpy as jnp

    from posendf_tpu.config import PoseNDFConfig
    from posendf_tpu.training.trainer import make_optimizer, make_train_step

    cfg = PoseNDFConfig()
    opt = make_optimizer(lr, cfg.train.weight_decay)
    step = jax.jit(make_train_step(module, opt, loss_type=cfg.train.loss_type,
                                   weights={"dist": 1.0, "man_loss": wman,
                                            "eikonal": w_eikonal}))
    opt_state = opt.init(params)
    terms = []
    for idx, midx in indices:
        b = {"pose": jnp.asarray(q_pose[idx]), "dist": jnp.asarray(q_dist[idx]),
             "man_poses": jnp.asarray(corpus_np[midx])}
        params, opt_state, m = step(params, opt_state, b)
        terms.append([float(m[k]) for k in ("dist", "eikonal", "man_loss", "total")])
    return params, np.asarray(terms)


def eval_clips(seed: int, fam, sigmas, clips: int, frames: int) -> list:
    """[(sigma, gt (T, 63), noisy (T, 63))] of the eval stream, in the
    script's order."""
    import jax.numpy as jnp

    from posendf_tpu.data.synthetic import synthetic_motion_sequence
    from posendf_tpu.quat import quaternion_to_axis_angle

    rng, out = make_rng(seed, 7), []
    for sigma in sigmas:
        for _ in range(clips):
            clean_q = synthetic_motion_sequence(rng, frames, family=fam)
            gt = np.asarray(quaternion_to_axis_angle(jnp.asarray(clean_q))).reshape(frames, 63)
            noisy = (gt + sigma * rng.standard_normal(gt.shape)).astype(np.float32)
            out.append((sigma, gt, noisy))
    return out


def denoisers(module, params, ablate: bool):
    """(reference denoiser, its prior-off twin) on the 128-vertex body."""
    from posendf_tpu.experiments import MotionDenoiser
    from posendf_tpu.smpl import BodyModel

    body = BodyModel()
    den = MotionDenoiser(module, params, body)
    off = None
    if ablate:
        base = dict(den.specs)
        base["pose_pr"] = base["pose_pr"]._replace(scale=0.0)
        off = MotionDenoiser(module, params, body, specs=base)
    return den, off


def prior_at_input(module, params, noisy63) -> float:
    import jax.numpy as jnp

    from posendf_tpu.quat import axis_angle_to_quaternion

    q = axis_angle_to_quaternion(jnp.asarray(noisy63).reshape(noisy63.shape[0], 21, 3))
    return float(jnp.mean(module.apply({"params": params}, q)))


def grid_rows(module, params, clips, ablate: bool, iterations: int = 10,
              steps_per_iter: int = 50) -> list:
    """The JAX script's grid rows (one clip a level)."""
    import jax.numpy as jnp

    den, off = denoisers(module, params, ablate)
    rows = []
    for sigma, gt, noisy in clips:
        _, m = den.optimize(jnp.asarray(noisy), jnp.asarray(gt), iterations=iterations,
                            steps_per_iter=steps_per_iter)
        row = {"sigma": sigma, "v2v_input_cm": m["v2v_input_cm"], "v2v_out_cm": m["v2v_cm"],
               "prior_at_input": prior_at_input(module, params, noisy),
               "final_pose_pr": m["final_pose_pr"]}
        row["improvement_pct"] = float(100 * (1 - row["v2v_out_cm"]
                                              / max(row["v2v_input_cm"], 1e-9)))
        if off is not None:
            _, m0 = off.optimize(jnp.asarray(noisy), jnp.asarray(gt), iterations=iterations,
                                 steps_per_iter=steps_per_iter)
            row["v2v_out_noprior_cm"] = m0["v2v_cm"]
        rows.append(row)
    return rows


def ulp_spread(module, params, clips, rows) -> np.ndarray:
    """(S, 2): each level's largest move of its 500-step v2v with and
    without the prior when its clip moves one ulp up or down."""
    out = []
    for (sigma, gt, noisy), row in zip(clips, rows):
        moved = [grid_rows(module, params, [(sigma, gt, np.nextafter(
            noisy, np.float32(d)).astype(np.float32))], ablate=True)[0]
            for d in (np.inf, -np.inf)]
        out.append([max(abs(m[k] - row[k]) for m in moved)
                    for k in ("v2v_out_cm", "v2v_out_noprior_cm")])
    return np.asarray(out, np.float64)


def main() -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    fam = family(0, LATENTS, FREQ)
    data = manufacture(0, fam, CORPUS, QUERIES)
    module, params = model()
    params, _ = load_params(module, params, CKPT)
    fq = field_quality(module, params, data["h_pose"], data["h_dist"], data["corpus_np"])
    clips = eval_clips(0, fam, SIGMAS, CLIPS, FRAMES)
    rows = grid_rows(module, params, clips, ablate=True)
    short_pose, short_m = [], []
    for _, gt, noisy in clips:
        solves = [d.optimize(jnp.asarray(noisy), jnp.asarray(gt), iterations=SHORT[0],
                             steps_per_iter=SHORT[1]) for d in denoisers(module, params, True)]
        short_pose.append([np.asarray(p) for p, _ in solves])
        short_m.append([[m["v2v_cm"], m["v2v_input_cm"], m["final_pose_pr"]] for _, m in solves])

    # the same run of the JAX script: its rounded numbers are these
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "run.json")
        subprocess.run([sys.executable, JAX_SCRIPT, "--preset", "tpu", "--device", "cpu",
                        "--corpus", str(CORPUS), "--queries", str(QUERIES), "--latents",
                        str(LATENTS), "--freq", *map(str, FREQ), "--load-ckpt", CKPT,
                        "--sigmas", *map(str, SIGMAS), "--clips", str(CLIPS),
                        "--ablate-prior", "--out", out], cwd=ROOT, check=True)
        run = json.load(open(out))
    for key, mine, nd in (("field_mae", fq["mae"], 5), ("field_corr", fq["corr"], 4),
                          ("field_live_frac", fq["live_frac"], 4),
                          ("clean_field_mean", fq["clean_mean"], 5),
                          ("noisy_field_mean", fq["noisy_mean"], 5)):
        if round(mine, nd) != run[key]:
            raise AssertionError(f"{key}: the stages give {mine}, the script {run[key]}")
    for row, want in zip(rows, run["grid"]):
        for k in ROW_KEYS:
            if not np.isclose(row[k], want[k], rtol=1e-6, atol=0.0):
                raise AssertionError(f"sigma {row['sigma']} {k}: the stages give {row[k]}, "
                                     f"the script {want[k]}")

    np.savez(OUT, field=np.asarray([fq["mae"], fq["corr"], fq["live_frac"], fq["clean_mean"],
                                    fq["noisy_mean"]], np.float64),
             sigmas=np.asarray(SIGMAS), rows=np.asarray([[r[k] for k in ROW_KEYS] for r in rows]),
             noisy=np.stack([c[2] for c in clips]), gt=np.stack([c[1] for c in clips]),
             short_pose=np.stack(short_pose), short_metrics=np.asarray(short_m, np.float64),
             ulp_spread=ulp_spread(module, params, clips, rows),
             corpus=CORPUS, queries=QUERIES, latents=LATENTS, freq=np.asarray(FREQ),
             short=np.asarray(SHORT))
    print(f"wrote {OUT}: field {fq}; rows {rows}; one-ulp spreads "
          f"{np.load(OUT)['ulp_spread'].tolist()}")


if __name__ == "__main__":
    main()
