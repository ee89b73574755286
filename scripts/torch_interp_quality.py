"""The interpolation closed loop on the port: slerp waypoints between two
endpoints, each projected onto the manifold (``experiments/interpolate.py``),
measured against the true 5-NN geodesic distance to a fresh 131,072-pose
corpus of the field's manifold family (``ops/knn.geodesic_topk``, precision
'highest'), not against the field's own value. ``scripts/interp_quality.py``
is the JAX package's run of it; this script keeps its flags, defaults,
stages and JSON keys.

Per seed x endpoint condition (``clean``: two family poses; ``noisy``: the
same plus sigma-0.25 uniform quaternion noise; ``random``: uniform random
poses), ``--pairs`` endpoint pairs: the raw and projected paths' true 5-NN
mean and max, the field's value on each, the endpoints' separation and the
largest adjacent-step geodesic (smoothness).

Run (the card; ``--device cpu`` for the CPU):
    python scripts/torch_interp_quality.py --ckpt docs/quality/ckpt_l8_best.msgpack \\
        --seeds 1 2 3 --out interp_l8.json
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

CONDITIONS = ("clean", "noisy", "random")


def parse_args(argv=None) -> argparse.Namespace:
    from posendf_torch.experiments.quality import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default="docs/quality/ckpt_l8_best.msgpack")
    ap.add_argument("--family-seed", type=int, default=123,
                    help="the manifold family's seed (the checkpoint's)")
    ap.add_argument("--latents", type=int, default=8)
    ap.add_argument("--freq", type=float, nargs=2, default=[0.5, 1.2])
    ap.add_argument("--num-steps", type=int, default=20)
    ap.add_argument("--projection-steps", type=int, default=50)
    ap.add_argument("--pairs", type=int, default=4, help="endpoint pairs per seed")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--corpus-size", type=int, default=131072)
    ap.add_argument("--noise-sigma", type=float, default=0.25)
    ap.add_argument("--out", default=None)
    add_device_arg(ap)
    return ap.parse_args(argv)


def make_corpus(family, n: int, device) -> torch.Tensor:
    """The oracle's corpus: ``n`` family poses of the stream seeded 777."""
    from posendf_torch.data.synthetic import synthetic_manifold_poses

    return torch.from_numpy(synthetic_manifold_poses(np.random.default_rng(777), n,
                                                     family=family)).to(device)


def endpoints(rng: np.random.Generator, cond: str, family, noise_sigma: float) -> np.ndarray:
    """(2, 21, 4) endpoints of a condition, drawn as the JAX script draws them."""
    from posendf_torch.data.synthetic import synthetic_manifold_poses

    if cond == "random":
        q = rng.normal(size=(2, 21, 4)).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)
    e = synthetic_manifold_poses(rng, 2, family=family)
    if cond == "noisy":
        # the training sampler's noise family (create_data.py:88)
        e = e + noise_sigma * rng.random((2, 21, 4)).astype(np.float32)
        e = e / np.linalg.norm(e, axis=-1, keepdims=True)
    return e


def max_step(path) -> float:
    p = np.asarray(path)
    return float((1 - np.abs(np.sum(p[1:] * p[:-1], -1))).mean(-1).max())


def measure_pair(field, corpus: torch.Tensor, e: np.ndarray, num_steps: int,
                 projection_steps: int) -> dict:
    """One endpoint pair's measurements (the keys of a row before averaging)."""
    from posendf_torch.experiments.interpolate import interpolate
    from posendf_torch.experiments.quality import true_knn_mean
    from posendf_torch.quat import quat_slerp

    a, b = (torch.from_numpy(np.ascontiguousarray(x)).to(field.device) for x in e)
    t = torch.linspace(0.0, 1.0, num_steps, device=field.device)
    raw = quat_slerp(a, b, t)
    proj, d_proj = interpolate(field, a, b, num_steps=num_steps,
                               projection_steps=projection_steps)
    tr, tp = true_knn_mean(raw, corpus), true_knn_mean(proj, corpus)
    with torch.no_grad():
        field_raw = float(field.distance(raw).mean())
    return {"sep": float(torch.mean(1 - torch.abs(torch.sum(a * b, -1)))),
            "true_raw_mean": float(tr.mean()), "true_raw_max": float(tr.max()),
            "true_proj_mean": float(tp.mean()), "true_proj_max": float(tp.max()),
            "field_raw_mean": field_raw, "field_proj_mean": float(d_proj.mean()),
            "max_step_raw": max_step(raw.cpu()), "max_step_proj": max_step(proj.detach().cpu())}


def run_rows(field, corpus, family, args) -> list:
    """Every (seed, condition) row: the means of its pairs' measurements."""
    rows = []
    for seed in args.seeds:
        rng = np.random.default_rng([seed, 602])
        for cond in CONDITIONS:
            acc = {}
            for _ in range(args.pairs):
                m = measure_pair(field, corpus, endpoints(rng, cond, family, args.noise_sigma),
                                 args.num_steps, args.projection_steps)
                for k, v in m.items():
                    acc.setdefault(k, []).append(v)
            row = {"seed": seed, "condition": cond,
                   **{k: float(np.mean(v)) for k, v in acc.items()}}
            row["true_gain_pct"] = float(
                100 * (1 - row["true_proj_mean"] / max(row["true_raw_mean"], 1e-12)))
            rows.append(row)
            print(f"seed {seed} {cond:6s}: endpoint sep {row['sep']:.4f} | true 5-NN raw "
                  f"{row['true_raw_mean']:.5f} -> proj {row['true_proj_mean']:.5f} "
                  f"({row['true_gain_pct']:+.1f}%) | field d {row['field_raw_mean']:.5f} -> "
                  f"{row['field_proj_mean']:.5f} | max step {row['max_step_raw']:.5f} -> "
                  f"{row['max_step_proj']:.5f}", flush=True)
    return rows


def summarize(rows: list) -> dict:
    summary = {}
    for cond in CONDITIONS:
        sel = [r for r in rows if r["condition"] == cond]
        summary[cond] = {k: float(np.mean([r[k] for r in sel]))
                         for k in sel[0] if k not in ("seed", "condition")}
        summary[cond]["proj_improves_true_seeds"] = int(sum(
            r["true_proj_mean"] < r["true_raw_mean"] for r in sel))
        summary[cond]["n"] = len(sel)
    return summary


def main(argv=None) -> dict:
    import json

    from posendf_torch.data.synthetic import synthetic_manifold_poses
    from posendf_torch.experiments.quality import (card_fields, gentle_family, load_trained_field,
                                                   true_knn_mean, write_result)
    from posendf_torch.field import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    family = gentle_family(args.family_seed, *args.freq, args.latents)
    field, epoch = load_trained_field(args.ckpt, dev)
    print(f"== loaded {args.ckpt} (trained to step {epoch}); latents={args.latents} "
          f"device: {dev}", flush=True)
    corpus = make_corpus(family, args.corpus_size, dev)
    t0 = time.perf_counter()
    rows = run_rows(field, corpus, family, args)
    # the corpus's own 5-NN floor (what "on-manifold" reads on this family)
    floor = float(np.mean(true_knn_mean(synthetic_manifold_poses(
        np.random.default_rng(888), 256, family=family), corpus)))
    summary = summarize(rows)
    result = {"ckpt": args.ckpt, "family_seed": args.family_seed, "latents": args.latents,
              "freq": list(args.freq), "num_steps": args.num_steps,
              "projection_steps": args.projection_steps, "pairs": args.pairs,
              "seeds": list(args.seeds), "corpus_size": args.corpus_size,
              "noise_sigma": args.noise_sigma, "manifold_5nn_floor": floor,
              "rows": rows, "summary": summary,
              "wall_s": round(time.perf_counter() - t0, 1), **card_fields(dev)}
    print(f"\nmanifold 5-NN floor: {floor:.5f}")
    print("summary:", json.dumps(summary, indent=2), flush=True)
    write_result(result, args.out)
    return result


if __name__ == "__main__":
    main()
