"""The partial-observation closed loop on the port: clips of the field's
manifold family with only an occluded joint set corrupted, a detectability
probe, then every completion strategy, prior on and off.
``scripts/partial_quality.py`` is the JAX package's run of it; this script
keeps its flags, defaults, stages and JSON keys.

  1. ground truth: smooth clips of the trained field's manifold family;
  2. corrupt only the occluded joints: ``drop_arm`` zeroes the left-arm
     chain, ``noise_arms`` adds sigma-1.0 jitter to both arm chains;
  3. detectability probe: the field's d and the true 5-NN geodesic distance
     (a fresh corpus) of the ground truth and of the corrupted clip;
  4. complete: ``anchor`` (``PARTIAL_SPECS``, 10 x 10, the data term on the
     observed joints), ``inpaint`` (observed dofs frozen, ``INPAINT_SPECS``,
     10 x 50), each with the prior on and off; ``retrieval``
     (``complete_by_retrieval``: the kNN kernel with the occluded joints'
     weights 0, k = 5, a 5-frame window);
  5. v2v against the ground truth and the joint-angle error split into
     occluded and visible joints.

Run (the card; ``--device cpu`` for the CPU):
    python scripts/torch_partial_quality.py --ckpt docs/quality/ckpt_l8_best.msgpack \\
        --seeds 1 2 3 --out partial.json
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# SMPL body-pose joints: the left-arm chain and both arm chains, the
# occlusion sets of the two conditions
LEFT_ARM = (12, 15, 17, 19)
BOTH_ARMS = (12, 13, 15, 16, 17, 18, 19, 20)
CONDITIONS = {"drop_arm": (np.asarray(LEFT_ARM), "zero"),
              "noise_arms": (np.asarray(BOTH_ARMS), "noise")}
# (iterations, steps a iteration) of each solve mode
SCHEDULES = {"anchor": (10, 10), "inpaint": (10, 50)}


def parse_args(argv=None) -> argparse.Namespace:
    from posendf_torch.experiments.quality import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default="docs/quality/ckpt_l8_best.msgpack")
    ap.add_argument("--family-seed", type=int, default=123,
                    help="the manifold family's seed (the checkpoint's)")
    ap.add_argument("--latents", type=int, default=8)
    ap.add_argument("--freq", type=float, nargs=2, default=[0.5, 1.2])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--clips", type=int, default=2, help="clips per seed")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--corpus-size", type=int, default=131072)
    ap.add_argument("--noise-sigma", type=float, default=1.0)
    ap.add_argument("--retrieval-k", type=int, default=5)
    ap.add_argument("--out", default=None)
    add_device_arg(ap)
    return ap.parse_args(argv)


def make_solvers(field, body) -> dict:
    """{(mode, prior on): PartialCompleter} of anchor and inpaint."""
    from posendf_torch.experiments.partial import (INPAINT_SPECS, PARTIAL_SPECS,
                                                   PartialCompleter)

    def off(specs):
        s = dict(specs)
        s["pose_pr"] = s["pose_pr"]._replace(scale=0.0)
        return s

    return {("anchor", True): PartialCompleter(field, body),
            ("anchor", False): PartialCompleter(field, body, specs=off(PARTIAL_SPECS)),
            ("inpaint", True): PartialCompleter(field, body, specs=INPAINT_SPECS),
            ("inpaint", False): PartialCompleter(field, body, specs=off(INPAINT_SPECS))}


def corrupt_clip(rng: np.random.Generator, family, frames: int, occ: np.ndarray, kind: str,
                 noise_sigma: float):
    """(gt quaternions (T, 21, 4), gt (T, 63), corrupted (T, 63) float32) of the
    next clip of ``rng``."""
    from posendf_torch.data.synthetic import synthetic_motion_sequence
    from posendf_torch.quat import quaternion_to_axis_angle

    gt_q = synthetic_motion_sequence(rng, frames, family=family)
    gt63 = quaternion_to_axis_angle(torch.from_numpy(gt_q)).numpy().reshape(frames, 63)
    bad = gt63.copy().reshape(frames, 21, 3)
    if kind == "zero":
        bad[:, occ] = 0.0
    else:
        bad[:, occ] += noise_sigma * rng.standard_normal((frames, len(occ), 3))
    return gt_q, gt63, bad.reshape(frames, 63).astype(np.float32)


def to_quats(p63, device) -> torch.Tensor:
    from posendf_torch.quat import axis_angle_to_quaternion

    a = torch.as_tensor(np.asarray(p63)[:, :63], dtype=torch.float32).to(device)
    return axis_angle_to_quaternion(a.reshape(-1, 21, 3))


def probe(field, corpus: torch.Tensor, gt63, bad63) -> dict:
    """The field's mean d and the true 5-NN mean of the ground truth and of
    the corrupted clip."""
    from posendf_torch.experiments.quality import true_knn_mean

    out = {}
    for tag, p63 in (("gt", gt63), ("corrupted", bad63)):
        q = to_quats(p63, field.device)
        with torch.no_grad():
            out[f"field_d_{tag}"] = float(field.distance(q).mean())
        out[f"true_5nn_{tag}"] = float(true_knn_mean(q, corpus).mean())
    return out


def joint_deg(pose, gt_q: np.ndarray, occ, vis):
    """Mean joint-angle error (degrees) of a (T, 63|69) pose against the
    ground-truth quaternions, over the occluded and over the visible joints."""
    q = to_quats(pose, "cpu").numpy()
    dots = np.abs(np.sum(q * gt_q, axis=-1))
    ang = 2 * np.arccos(np.clip(dots, 0, 1)) * 180.0 / np.pi
    return float(ang[:, occ].mean()), float(ang[:, vis].mean())


def complete_clip(field, body, solvers, corpus_np: np.ndarray, gt_q, gt63, bad63, occ, vis,
                  retrieval_k: int, schedules=SCHEDULES) -> dict:
    """Every strategy on one corrupted clip: its v2v and occluded / visible
    joint errors (and the input's)."""
    from posendf_torch.experiments.partial import complete_by_retrieval
    from posendf_torch.experiments.denoise import v2v_cm
    from posendf_torch.quat import quaternion_to_axis_angle

    out = {}
    out["occ_in"], out["vis_in"] = joint_deg(bad63, gt_q, occ, vis)
    for (mode, prior_on), solver in solvers.items():
        its, spi = schedules[mode]
        pose, m = solver.optimize(bad63, gt63, iterations=its, steps_per_iter=spi,
                                  occluded_joints=occ.tolist(), mode=mode)
        tag = f"{mode}_{'on' if prior_on else 'off'}"
        out[f"v2v_{tag}"] = m["v2v_cm"]
        out[f"occ_{tag}"], out[f"vis_{tag}"] = joint_deg(pose.detach().cpu(), gt_q, occ, vis)
        if mode == "anchor" and prior_on:
            out["v2v_in"] = m["v2v_input_cm"]
    done = complete_by_retrieval(corpus_np, to_quats(bad63, "cpu").numpy(), occ.tolist(),
                                 k=retrieval_k, device=field.device)
    out63 = quaternion_to_axis_angle(torch.from_numpy(done)).numpy().reshape(len(gt63), 63)
    out["occ_retrieval"], out["vis_retrieval"] = joint_deg(out63, gt_q, occ, vis)
    with torch.no_grad():
        gt_v = body(pose_body=gt63).vertices
        out_v = body(pose_body=out63).vertices
    out["v2v_retrieval"] = float(v2v_cm(out_v, gt_v))
    return out


def run_rows(field, body, corpus_np: np.ndarray, corpus: torch.Tensor, family, args,
             schedules=SCHEDULES) -> list:
    solvers = make_solvers(field, body)
    rows = []
    for seed in args.seeds:
        rng = np.random.default_rng([seed, 501])
        for cond, (occ, kind) in CONDITIONS.items():
            vis = np.asarray([j for j in range(21) if j not in set(occ.tolist())], int)
            acc = {}
            for _ in range(args.clips):
                gt_q, gt63, bad63 = corrupt_clip(rng, family, args.frames, occ, kind,
                                                 args.noise_sigma)
                m = dict(probe(field, corpus, gt63, bad63))
                m.update(complete_clip(field, body, solvers, corpus_np, gt_q, gt63, bad63, occ,
                                       vis, args.retrieval_k, schedules))
                for k, v in m.items():
                    acc.setdefault(k, []).append(float(v))
            row = {"seed": seed, "condition": cond, "occluded_joints": occ.tolist(),
                   **{k: float(np.mean(v)) for k, v in acc.items()}}
            rows.append(row)
            print(f"seed {seed} {cond:10s}: probe field d {row['field_d_gt']:.4f}->"
                  f"{row['field_d_corrupted']:.4f}, true5nn {row['true_5nn_gt']:.4f}->"
                  f"{row['true_5nn_corrupted']:.4f} | occluded deg in {row['occ_in']:6.2f} -> "
                  f"anchor {row['occ_anchor_on']:6.2f} inpaint {row['occ_inpaint_on']:6.2f}/"
                  f"{row['occ_inpaint_off']:6.2f} retrieval {row['occ_retrieval']:6.2f} | "
                  f"visible in {row['vis_in']:.3f} -> anchor {row['vis_anchor_on']:6.2f} "
                  f"retrieval {row['vis_retrieval']:.3f}", flush=True)
    return rows


def summarize(rows: list) -> dict:
    summary = {}
    for cond in CONDITIONS:
        sel = [r for r in rows if r["condition"] == cond]
        summary[cond] = {k: float(np.mean([r[k] for r in sel])) for k in sel[0]
                         if k not in ("seed", "condition", "occluded_joints")}
        summary[cond]["retrieval_occ_wins_vs_input"] = int(sum(
            r["occ_retrieval"] < r["occ_in"] for r in sel))
        summary[cond]["n"] = len(sel)
    return summary


def main(argv=None, schedules=SCHEDULES) -> dict:
    import json

    from posendf_torch.data.synthetic import synthetic_manifold_poses
    from posendf_torch.experiments.quality import (card_fields, gentle_family, load_trained_field,
                                                   write_result)
    from posendf_torch.field import resolve_device
    from posendf_torch.smpl import BodyModel

    args = parse_args(argv)
    dev = resolve_device(args.device)
    family = gentle_family(args.family_seed, *args.freq, args.latents)
    field, epoch = load_trained_field(args.ckpt, dev)
    print(f"== loaded {args.ckpt} (trained to step {epoch}); device: {dev}", flush=True)
    # a fresh corpus: the retrieval's database and the probe's oracle
    corpus_np = synthetic_manifold_poses(np.random.default_rng(777), args.corpus_size,
                                         family=family)
    corpus = torch.from_numpy(corpus_np).to(dev)
    t0 = time.perf_counter()
    rows = run_rows(field, BodyModel(device=dev), corpus_np, corpus, family, args, schedules)
    summary = summarize(rows)
    result = {"ckpt": args.ckpt, "family_seed": args.family_seed, "latents": args.latents,
              "freq": list(args.freq), "frames": args.frames, "clips": args.clips,
              "seeds": list(args.seeds), "corpus_size": args.corpus_size,
              "noise_sigma": args.noise_sigma, "retrieval_k": args.retrieval_k,
              "conditions": {c: {"occluded": o.tolist(), "kind": k}
                             for c, (o, k) in CONDITIONS.items()},
              "rows": rows, "summary": summary,
              "wall_s": round(time.perf_counter() - t0, 1), **card_fields(dev)}
    print("\nsummary:", json.dumps(summary, indent=2), flush=True)
    write_result(result, args.out)
    return result


if __name__ == "__main__":
    main()
