"""The synthetic noise-grid benchmark end to end on the port: manufacture a
labelled set, train a full-size field from random weights, measure its
quality on held-out poses, then denoise 60-frame clips at a grid of noise
levels (``scripts/quality_grid.py`` is the JAX package's run of it; this
script keeps its flags, defaults, stages and JSON keys).

  1. manufacture: one smooth manifold family, a corpus on it, noisy queries
     with the reference's sigma grid and draw structure, labelled by their
     exact 5 nearest geodesic distances (``label_sequence``: the kNN kernel
     on the card, ``precision="highest"``), and a held-out labelled set;
  2. train: the default architecture from random weights (he-matched init by
     default), a manifold-term curriculum over 500-step chunks, batches drawn
     on the device, the fused train step (the train kernels) on the card for
     lrelu/relu and the autodiff step for softplus or on the CPU; a
     validation gate keeps the parameters of the chunk with the best
     held-out correlation;
  3. field quality: MAE, correlation and live fraction on the held-out set,
     the mean field value on clean and on noisy poses (the forward kernel on
     the card, the module path on the CPU);
  4. the grid: for each sigma, ``MotionDenoiser.optimize`` (10 x 50 steps)
     of noisy clips of held-out motion on the same manifold, v2v before and
     after, and with ``--ablate-prior`` the same solve with the prior off.

Seeds: the numpy streams (family, corpus, labelled and held sets, the eval
clips) are the JAX script's, so a run here and a JAX run with the same
``--seed`` share data and clips. The initial weights and the batch draws come
from ``torch.Generator`` streams seeded from ``(seed, i)`` (JAX draws them
from ``jax.random`` keys): the two runs do not share init or batches.
``--load-ckpt`` reads a JAX ``--save-ckpt`` file and ``--save-ckpt`` writes
one JAX reads.

Each stage is a function of this module; ``main`` strings them together.

Run (the card; ``--device cpu`` for the CPU):
    python scripts/torch_quality_grid.py --preset full --queries 65536 \\
        --steps 12000 --batch 65536 --lr 3e-5 --w-eikonal 0.1 --latents 8 \\
        --freq 0.5 1.2 --ablate-prior --save-ckpt chiprun_out/ckpt.msgpack
CPU smoke:
    python scripts/torch_quality_grid.py --preset smoke --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from posendf_torch.experiments.quality import gentle_family  # noqa: E402, F401

# manifold-term curriculum: (progress below which it holds, w_man)
CURRICULUM = ((0.15, 0.0), (0.30, 0.3), (1.01, 1.0))
CHUNK = 500
# the run of record's recipe (docs/quality/README.md) less --steps and --ablate-prior
RUN_OF_RECORD = ["--preset", "full", "--queries", "65536", "--batch", "65536", "--lr", "3e-5",
                 "--w-eikonal", "0.1", "--latents", "8", "--freq", "0.5", "1.2"]
GRID_SCHEDULE = (10, 50)   # a grid solve's iterations and steps a iteration


def gate_should_swap(best_corr: float, final_corr: float) -> bool:
    """True when the retained best parameters should replace the final ones.
    A non-finite final correlation (a collapsed field: pred.std() == 0)
    swaps too; a bare ``best > nan`` is False."""
    return (not np.isfinite(final_corr)) or best_corr > final_corr


def parse_args(argv=None) -> argparse.Namespace:
    from posendf_torch.experiments.quality import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=("smoke", "full"), default="full",
                    help="sizes: smoke (CPU-sized) or full (the card)")
    ap.add_argument("--corpus", type=int, default=None)
    ap.add_argument("--queries", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None, help="default 1e-4 smoke / 3e-5 full")
    ap.add_argument("--clips", type=int, default=4, help="clips per sigma")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--sigmas", type=float, nargs="+", default=[0.01, 0.05, 0.1, 0.5])
    ap.add_argument("--latents", type=int, default=2,
                    help="intrinsic dimension of the synthetic manifold")
    ap.add_argument("--freq", type=float, nargs=2, default=[0.15, 0.4], metavar=("LO", "HI"),
                    help="per-joint latent frequency range")
    ap.add_argument("--structured-frac", type=float, default=0.0,
                    help="fraction of labelled queries given limb-structured noise")
    ap.add_argument("--per-pose-noise", action="store_true",
                    help="per-pose noise draws instead of the reference's shared-per-group draw")
    ap.add_argument("--specs", choices=("reference", "balanced", "adaptive"),
                    default="reference")
    ap.add_argument("--act", choices=("lrelu", "relu", "softplus"), default="lrelu")
    ap.add_argument("--label-cache", default=None,
                    help="npz path caching the labelled train and held sets")
    ap.add_argument("--beta", type=float, default=None, help="softplus sharpness")
    ap.add_argument("--recenter", type=float, default=0.002,
                    help="target mean head pre-activation of the 'he' init")
    ap.add_argument("--w-eikonal", type=float, default=1.0, help="eikonal weight")
    ap.add_argument("--init", choices=("reference", "he", "he-matched"), default="he-matched")
    ap.add_argument("--save-ckpt", default=None,
                    help="msgpack path to save the trained parameters (the gated best)")
    ap.add_argument("--load-ckpt", default=None,
                    help="msgpack path of a trained field: skip init and training")
    ap.add_argument("--no-val-gate", action="store_true",
                    help="disable the validation gate's best retention")
    ap.add_argument("--ablate-prior", action="store_true",
                    help="per sigma, also denoise with the prior term zeroed")
    ap.add_argument("--out", default=None, help="write the result JSON here")
    ap.add_argument("--seed", type=int, default=0,
                    help="master seed of every stream; 0 reproduces the JAX runs' numpy streams")
    add_device_arg(ap)
    return ap.parse_args(argv)


def sizes(args) -> Dict[str, float]:
    """N, Q, STEPS, BATCH, LR of the preset, each flag given overriding it."""
    smoke = args.preset == "smoke"

    def pick(v, dflt):
        return v if v is not None else dflt

    return {"N": pick(args.corpus, 4096 if smoke else 1 << 17),
            "Q": pick(args.queries, 8192 if smoke else 1 << 18),
            "STEPS": pick(args.steps, 300 if smoke else 20000),
            "BATCH": pick(args.batch, 2048 if smoke else 1 << 16),
            "LR": pick(args.lr, 1e-4 if smoke else 3e-5)}


def make_rng(seed: int, i: int) -> np.random.Generator:
    """Numpy stream ``i``: the bare constant at seed 0 (the JAX runs'),
    derived from (seed, i) otherwise."""
    return np.random.default_rng(i if seed == 0 else [seed, i])


def make_generator(seed: int, i: int, device) -> torch.Generator:
    """Torch stream ``i`` on ``device``, seeded from (seed, i)."""
    g = torch.Generator(device=torch.device(device))
    s = i if seed == 0 else int(np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0])
    return g.manual_seed(s)


def manufacture(args, family, N: int, Q: int, device) -> dict:
    """The corpus and the exact-kNN-labelled train and held-out sets, as
    ``quality_grid.py`` draws them (or from ``--label-cache``).

    Returns ``corpus_np`` (N, 21, 4), ``corpus`` (on ``device``),
    ``q_pose`` / ``q_dist`` (labels: the mean of the 5 nearest; on
    ``device``), ``h_pose`` (on ``device``) / ``h_dist`` (numpy) and
    ``label_s``."""
    from posendf_torch.data.prepare import NoiseSpec, label_sequence
    from posendf_torch.data.synthetic import synthetic_manifold_poses

    t0 = time.perf_counter()
    corpus_np = synthetic_manifold_poses(make_rng(args.seed, 0), N, family=family)
    corpus = torch.from_numpy(corpus_np).to(device)
    cache = args.label_cache
    out = {"corpus_np": corpus_np, "corpus": corpus}
    if cache and os.path.exists(cache):
        z = np.load(cache)
        got = (int(z["corpus_n"]), int(z["queries_n"]), bool(z["per_pose_noise"]),
               float(z["structured_frac"]) if "structured_frac" in z else 0.0,
               int(z["latents"]) if "latents" in z else 2,
               list(z["freq"]) if "freq" in z else [0.15, 0.4],
               int(z["seed"]) if "seed" in z else 0)
        want = (N, Q, args.per_pose_noise, args.structured_frac, args.latents, list(args.freq),
                args.seed)
        if got != want:
            raise SystemExit(f"label cache {cache} was built for corpus={got[0]} queries={got[1]} "
                             f"per_pose_noise={got[2]} structured_frac={got[3]} latents={got[4]} "
                             f"freq={got[5]} seed={got[6]}")
        out.update(q_pose=torch.from_numpy(z["q_pose"]).to(device),
                   q_dist=torch.from_numpy(z["q_dist"]).to(device),
                   h_pose=torch.from_numpy(z["h_pose"]).to(device), h_dist=z["h_dist"],
                   label_s=0.0)
        print(f"== label cache hit: {cache} ({Q} queries)", flush=True)
        return out
    spec = NoiseSpec(structured_frac=args.structured_frac)

    def label(n, stream):
        runs = 1 if args.per_pose_noise else max(1, n // 128)
        return label_sequence(corpus_np, corpus, corpus_np=corpus_np, num_queries=n, k=5,
                              rng=make_rng(args.seed, stream), per_pose_noise=args.per_pose_noise,
                              runs=runs, precision="highest", spec=spec, device=device)

    labeled = label(Q, 1)
    q_dist_np = labeled["dist"].mean(axis=1)
    label_s = time.perf_counter() - t0
    print(f"== labeled {Q} queries against {N}-pose corpus in {label_s:.1f}s (dist: mean "
          f"{float(q_dist_np.mean()):.4f}, max {float(q_dist_np.max()):.4f})", flush=True)
    held = label(min(4096, max(256, Q // 4)), 2)
    h_dist = np.asarray(held["dist"].mean(axis=1))
    if cache:
        np.savez(cache, corpus_n=N, queries_n=Q, per_pose_noise=args.per_pose_noise,
                 structured_frac=args.structured_frac, latents=args.latents,
                 freq=np.asarray(args.freq), seed=args.seed, q_pose=labeled["pose"],
                 q_dist=q_dist_np, h_pose=held["pose"], h_dist=h_dist)
        print(f"== label cache written: {cache}", flush=True)
    out.update(q_pose=torch.from_numpy(labeled["pose"]).to(device),
               q_dist=torch.from_numpy(q_dist_np).to(device),
               h_pose=torch.from_numpy(held["pose"]).to(device), h_dist=h_dist, label_s=label_s)
    return out


def build_module(args, device):
    """(config, the default architecture from the run's init stream on
    ``device``)."""
    from posendf_torch.config import PoseNDFConfig

    cfg = PoseNDFConfig()
    cfg.dfnet.act = args.act
    if args.beta is not None:
        cfg.dfnet.beta = args.beta
    module = cfg.make_model(generator=make_generator(args.seed, 0, "cpu")).to(device)
    return cfg, module


@torch.no_grad()
def init_params(args, module, q_pose: torch.Tensor, q_dist: torch.Tensor) -> None:
    """The from-scratch init of ``quality_grid.py`` in place on ``module``:
    the head bias lifted by 0.1, then 'he-matched' (``moment_matched_head_init``
    on the first 4,096 queries and every label) or 'he' (He gain, the head's
    mean pre-activation recentred to ``--recenter``); 'reference' keeps the
    lifted default init."""
    from posendf_torch.training.init_utils import he_gain, moment_matched_head_init

    params = {k: v.detach().clone() for k, v in module.state_dict().items()}
    b_key = f"dfnet.b{max(int(k[len('dfnet.w'):]) for k in params if k.startswith('dfnet.w'))}"
    params[b_key] = params[b_key] + 0.1
    if args.init == "he-matched":
        params, stats = moment_matched_head_init(module, params, q_pose[:4096], q_dist)
        print(f"== he-matched init: z {stats['z_mean']:+.4f} +- {stats['z_std']:.4f} -> scaled "
              f"x{stats['scale']:.4f}, head bias {stats['new_bias']:+.4f} (labels "
              f"{stats['label_mean']:.4f} +- {stats['label_std']:.4f})", flush=True)
    elif args.init == "he":
        from torch.func import functional_call

        params = he_gain(params)
        shifted = dict(params, **{b_key: params[b_key] + 100.0})
        z = (functional_call(module, shifted, (q_pose[:4096],)) - 100.0).reshape(-1)
        z = z.cpu().numpy()
        recenter = args.recenter - float(z.mean())
        params[b_key] = params[b_key] + recenter
        print(f"== he init: head pre-activation {float(z.mean()):+.4f} +- {float(z.std()):.4f}, "
              f"recentered by {recenter:+.4f}", flush=True)
    module.load_state_dict(params, strict=True)


def curriculum_weight(ci: int, n_chunks: int) -> float:
    """The manifold term's weight in chunk ``ci`` of ``n_chunks``."""
    progress = ci / n_chunks
    return next(w for frac, w in CURRICULUM if progress < frac)


def chunk_plan(steps: int) -> list:
    """[(steps of the chunk, its manifold weight)] of a ``steps``-step run."""
    chunk = min(steps, CHUNK)
    n_chunks = (steps + chunk - 1) // chunk if steps else 0
    return [(min(chunk, steps - ci * chunk), curriculum_weight(ci, n_chunks))
            for ci in range(n_chunks)]


def make_steps(module, optimizer, cfg, args, fused: bool) -> dict:
    """One train step a curriculum weight, over one module and one Adam
    state."""
    from posendf_torch.training.trainer import make_train_step

    return {w: make_train_step(module, optimizer, loss_type=cfg.train.loss_type,
                               weights={"dist": 1.0, "man_loss": w, "eikonal": args.w_eikonal},
                               fused=fused)
            for _, w in CURRICULUM}


_TERMS = ("dist", "eikonal", "man_loss", "total")


def train_chunk(step, q_pose: torch.Tensor, q_dist: torch.Tensor, corpus: torch.Tensor,
                steps: int, batch: int, generator: Optional[torch.Generator] = None,
                indices: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None
                ) -> Dict[str, np.ndarray]:
    """``steps`` train steps, each on ``batch`` labelled queries and ``batch``
    corpus poses drawn with ``generator`` on the device (or taken from
    ``indices``, one (query rows, corpus rows) pair a step). The terms stay
    on the device until the chunk ends: one copy a chunk. Returns each
    term's (steps,) trajectory."""
    dev = q_pose.device
    rows = []
    for s in range(steps):
        if indices is None:
            idx = torch.randint(0, q_pose.shape[0], (batch,), generator=generator, device=dev)
            midx = torch.randint(0, corpus.shape[0], (batch,), generator=generator, device=dev)
        else:
            idx, midx = (torch.as_tensor(np.asarray(i), dtype=torch.long).to(dev)
                         for i in indices[s])
        m = step({"pose": q_pose[idx], "dist": q_dist[idx], "man_poses": corpus[midx]})
        rows.append(torch.stack([m[k] for k in _TERMS]))
    traj = torch.stack(rows).cpu().numpy()
    return {k: traj[:, i] for i, k in enumerate(_TERMS)}


def field_values(field, poses: torch.Tensor, fused: bool) -> np.ndarray:
    """(n,) field values: the forward kernel (``Field.distance_fused``) where
    ``fused``, else the module path."""
    with torch.no_grad():
        d = field.distance_fused(poses) if fused else field.distance(poses)
    return d.reshape(-1).cpu().numpy()


def held_corr(pred: np.ndarray, h_dist: np.ndarray) -> float:
    return float(np.corrcoef(pred, h_dist)[0, 1]) if pred.std() > 0 else float("nan")


def train(args, module, cfg, data: dict, steps: int, batch: int, lr: float, fused: bool,
          val_gate: bool) -> dict:
    """The training stage: 500-step chunks under the curriculum, the
    validation gate once a chunk (the best parameters kept as a clone on
    the device). Returns ``chunks`` (per-chunk trajectories), ``best``
    (corr, params, step) and ``train_s``."""
    from posendf_torch.field import Field
    from posendf_torch.training.trainer import make_optimizer

    optimizer = make_optimizer(module.parameters(), lr, cfg.train.weight_decay)
    by_wman = make_steps(module, optimizer, cfg, args, fused)
    field = Field(module)
    gen = make_generator(args.seed, 3, data["q_pose"].device)
    plan = chunk_plan(steps)
    best = {"corr": -np.inf, "params": None, "step": 0}
    chunks, done = [], 0
    t0 = time.perf_counter()
    for ci, (n, wman) in enumerate(plan):
        chunks.append(train_chunk(by_wman[wman], data["q_pose"], data["q_dist"], data["corpus"],
                                  n, batch, generator=gen))
        done += n
        c = float("nan")
        if val_gate:
            c = held_corr(field_values(field, data["h_pose"], fused), data["h_dist"])
            if np.isfinite(c) and c > best["corr"]:
                best = {"corr": c, "step": done,
                        "params": {k: v.detach().clone() for k, v in module.state_dict().items()}}
        if ci % max(1, len(plan) // 10) == 0:
            gate = (f" val corr={c:.3f} (best {best['corr']:.3f} @ step {best['step']})"
                    if val_gate else "")
            print(f"   chunk {ci + 1}/{len(plan)} (w_man={wman}): "
                  + " ".join(f"{k}={chunks[-1][k][-1]:.5f}" for k in sorted(chunks[-1])) + gate,
                  flush=True)
    train_s = time.perf_counter() - t0
    if chunks:
        losses = np.concatenate([c["total"] for c in chunks])
        print(f"== trained {steps} steps x {batch} poses in {train_s:.1f}s (loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; {steps * batch / train_s / 1e6:.1f}M "
              f"poses/s incl. the first chunk; {1e3 * train_s / steps:.3f} ms a step)",
              flush=True)
    return {"chunks": chunks, "best": best, "train_s": train_s}


def field_quality(field, h_pose: torch.Tensor, h_dist: np.ndarray, corpus_np: np.ndarray,
                  fused: bool) -> dict:
    """MAE, correlation and live fraction on the held-out set; the mean
    field value on 4,096 clean corpus poses and on the held-out noisy ones."""
    pred = field_values(field, h_pose, fused)
    clean = field_values(field, torch.from_numpy(corpus_np[:4096]).to(h_pose.device), fused)
    return {"mae": float(np.mean(np.abs(pred - h_dist))), "corr": held_corr(pred, h_dist),
            "live_frac": float(np.mean(pred > 0)), "clean_mean": float(clean.mean()),
            "noisy_mean": float(pred.mean())}


def jax_tree(state: Dict[str, torch.Tensor]) -> dict:
    """A state dict as the JAX package's params tree (``{"enc": {...},
    "dfnet": {...}}`` of numpy arrays); ``params_from_jax`` inverted."""
    tree: dict = {}
    for name, v in state.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().cpu().numpy().astype(np.float32)
    return tree


def save_ckpt(path: str, module, step: int) -> None:
    """flax's layout ``{"epoch", "state": {"params"}}`` in msgpack, which the
    JAX script's ``--load-ckpt`` reads."""
    from posendf_torch.checkpoints import msgpack_serialize

    payload = {"epoch": int(step), "state": {"params": jax_tree(module.state_dict())}}
    with open(path, "wb") as f:
        f.write(msgpack_serialize(payload))
    print(f"== saved trained params to {path}", flush=True)


def load_ckpt(path: str, module) -> Optional[int]:
    """Loads a ``--save-ckpt`` file (the port's or the JAX script's) into
    ``module``; returns the step it was trained to."""
    from posendf_torch.checkpoints import load_msgpack_params

    state, epoch = load_msgpack_params(path)
    dev = next(module.parameters()).device
    module.load_state_dict({k: v.to(dev) for k, v in state.items()}, strict=True)
    print(f"== loaded trained params from {path} (trained to step {epoch})", flush=True)
    return epoch


def make_denoisers(field, body, specs_name: str, ablate: bool):
    """(denoiser, its prior-off twin or None) of ``--specs``."""
    from posendf_torch.experiments.denoise import BALANCED_SPECS, MotionDenoiser

    specs = {"reference": None, "adaptive": "adaptive",
             "balanced": dict(BALANCED_SPECS)}[specs_name]
    den = MotionDenoiser(field, body, specs=specs)
    off = None
    if ablate:
        if specs == "adaptive":
            off = MotionDenoiser(field, body, specs="adaptive", prior_gain=0.0)
        else:
            base = dict(specs or den.specs)
            base["pose_pr"] = base["pose_pr"]._replace(scale=0.0)
            off = MotionDenoiser(field, body, specs=base)
    return den, off


def field_on_clip(field, noisy63) -> float:
    """The mean field value of a (T, 63) axis-angle clip (module path)."""
    from posendf_torch.quat import axis_angle_to_quaternion

    x = torch.as_tensor(noisy63, dtype=torch.float32).to(field.device)
    with torch.no_grad():
        return float(field.distance(axis_angle_to_quaternion(x.reshape(x.shape[0], 21, 3))).mean())


def eval_clip(rng: np.random.Generator, family, frames: int, sigma: float):
    """(gt (T, 63), noisy (T, 63) float32) of the next clip of ``rng``."""
    from posendf_torch.data.synthetic import synthetic_motion_sequence
    from posendf_torch.quat import quaternion_to_axis_angle

    clean_q = synthetic_motion_sequence(rng, frames, family=family)
    gt = quaternion_to_axis_angle(torch.from_numpy(clean_q)).numpy().reshape(frames, 63)
    noisy = (gt + sigma * rng.standard_normal(gt.shape)).astype(np.float32)
    return gt, noisy


def grid_row(sigma: float, v_in, v_out, pr_in, pr_out, v_nopr, s_lv) -> dict:
    """One sigma's row of the result, as ``quality_grid.py`` makes it."""
    row = {"sigma": sigma, "v2v_input_cm": float(np.mean(v_in)),
           "v2v_out_cm": float(np.mean(v_out)),
           "improvement_pct": float(100 * (1 - np.mean(v_out) / max(np.mean(v_in), 1e-9))),
           "prior_at_input": float(np.mean(pr_in)), "final_pose_pr": float(np.mean(pr_out))}
    if s_lv:
        row["noise_level_s"] = float(np.mean(s_lv))
    if v_nopr:
        row["v2v_out_noprior_cm"] = float(np.mean(v_nopr))
        row["prior_v2v_gain_cm"] = row["v2v_out_noprior_cm"] - row["v2v_out_cm"]
        row["prior_v2v_gain_pct"] = float(100 * row["prior_v2v_gain_cm"]
                                          / max(row["v2v_out_noprior_cm"], 1e-9))
    return row


def run_grid(field, body, family, args, iterations: int, steps_per_iter: int) -> list:
    """The benchmark grid: each sigma's clips (the eval stream, ``make_rng(seed,
    7)``) solved one at a time, as the JAX script solves them."""
    den, den_off = make_denoisers(field, body, args.specs, args.ablate_prior)
    eval_rng = make_rng(args.seed, 7)
    grid = []
    for sigma in args.sigmas:
        v_in, v_out, pr_in, pr_out, v_nopr, s_lv = [], [], [], [], [], []
        for _ in range(args.clips):
            gt, noisy = eval_clip(eval_rng, family, args.frames, sigma)
            pr_in.append(field_on_clip(field, noisy))
            _, m = den.optimize(noisy, gt, iterations=iterations, steps_per_iter=steps_per_iter)
            v_in.append(m["v2v_input_cm"])
            v_out.append(m["v2v_cm"])
            pr_out.append(m["final_pose_pr"])
            if "noise_level_s" in m:
                s_lv.append(m["noise_level_s"])
            if den_off is not None:
                _, m0 = den_off.optimize(noisy, gt, iterations=iterations,
                                         steps_per_iter=steps_per_iter)
                v_nopr.append(m0["v2v_cm"])
        row = grid_row(sigma, v_in, v_out, pr_in, pr_out, v_nopr, s_lv)
        grid.append(row)
        abl = (f"  no-prior {row['v2v_out_noprior_cm']:7.3f} cm (prior gain "
               f"{row['prior_v2v_gain_cm']:+6.3f} cm)" if den_off is not None else "")
        s_tag = f"  s={row['noise_level_s']:.2f}" if s_lv else ""
        print(f"   sigma={sigma:<5}: v2v {row['v2v_input_cm']:7.3f} -> {row['v2v_out_cm']:7.3f} "
              f"cm  ({row['improvement_pct']:+6.1f}%)  prior {row['prior_at_input']:.5f} -> "
              f"{row['final_pose_pr']:.5f}{s_tag}{abl}", flush=True)
    return grid


def main(argv=None) -> dict:
    from posendf_torch.experiments.quality import card_fields, write_result
    from posendf_torch.field import Field, resolve_device
    from posendf_torch.smpl import BodyModel

    args = parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    sz = sizes(args)
    N, Q, STEPS, BATCH, LR = (sz[k] for k in ("N", "Q", "STEPS", "BATCH", "LR"))
    print(f"== device: {dev} corpus={N} queries={Q} steps={STEPS} batch={BATCH} "
          f"seed={args.seed}", flush=True)
    family = gentle_family(seed=123 if args.seed == 0 else [args.seed, 123],
                           lo=args.freq[0], hi=args.freq[1], latents=args.latents)

    data = manufacture(args, family, N, Q, dev)
    cfg, module = build_module(args, dev)
    fused = dev.type == "cuda" and args.act in ("lrelu", "relu")
    if args.load_ckpt:
        load_ckpt(args.load_ckpt, module)
        STEPS = 0
    else:
        init_params(args, module, data["q_pose"], data["q_dist"])
    val_gate = not args.no_val_gate
    tr = train(args, module, cfg, data, STEPS, BATCH, LR, fused, val_gate)
    field = Field(module)
    best = tr["best"]

    final_corr = held_corr(field_values(field, data["h_pose"], fused), data["h_dist"])
    trained_step = STEPS
    if val_gate and best["params"] is not None and gate_should_swap(best["corr"], final_corr):
        print(f"== val gate: final corr {final_corr:.3f} < best {best['corr']:.3f} @ step "
              f"{best['step']}: using the retained best params", flush=True)
        module.load_state_dict(best["params"])
        trained_step = best["step"]
    fq = field_quality(field, data["h_pose"], data["h_dist"], data["corpus_np"], fused)
    print(f"== field quality (held out): MAE {fq['mae']:.4f}, corr {fq['corr']:.3f}, live "
          f"{100 * fq['live_frac']:.1f}%; mean d(manifold)={fq['clean_mean']:.4f} vs "
          f"d(noisy)={fq['noisy_mean']:.4f}", flush=True)
    if args.save_ckpt:
        save_ckpt(args.save_ckpt, module, trained_step)

    t_grid = time.perf_counter()
    grid = run_grid(field, BodyModel(device=dev), family, args, *GRID_SCHEDULE)
    print(f"== grid: {time.perf_counter() - t_grid:.1f} s", flush=True)

    result = {
        "preset": args.preset, "seed": args.seed, "corpus": N, "queries": Q, "steps": STEPS,
        "latents": args.latents, "freq": list(args.freq), "batch": BATCH, "lr": LR,
        "specs": args.specs, "init": "loaded" if args.load_ckpt else args.init,
        "loaded_ckpt": args.load_ckpt, "act": args.act, "beta": cfg.dfnet.beta,
        "recenter": args.recenter if args.init == "he" else None,
        "w_eikonal": args.w_eikonal, "fused": fused, "per_pose_noise": args.per_pose_noise,
        "structured_frac": args.structured_frac, "val_gate": val_gate,
        "field_corr_final": round(final_corr, 4),
        "field_corr_best": (round(best["corr"], 4)
                            if val_gate and best["params"] is not None else None),
        "best_step": best["step"] if val_gate else None,
        "label_s": round(data["label_s"], 1), "train_s": round(tr["train_s"], 1),
        "field_mae": round(fq["mae"], 5), "field_corr": round(fq["corr"], 4),
        "field_live_frac": round(fq["live_frac"], 4),
        "clean_field_mean": round(fq["clean_mean"], 5),
        "noisy_field_mean": round(fq["noisy_mean"], 5),
        "grid": grid,
        **card_fields(dev),
    }
    print(json.dumps(result), flush=True)
    write_result(result, args.out)
    return result


if __name__ == "__main__":
    main()
