"""The image-fitting closed loop on the port: ground-truth poses of the
field's manifold family and a ground-truth camera give 2D keypoints
(``camera.project_points``), which are corrupted and fitted from scratch by
the three-stage ``ImageFitter``, prior on and off.
``scripts/fit_image_quality.py`` is the JAX package's run of it; this script
keeps its flags, defaults, stages and JSON keys.

  1. ground truth: ``--batch`` family poses, a camera about 10 m away, the
     mapped BODY_25 joints projected to pixels;
  2. corrupt: pixel noise, and in the ``occluded`` condition ``--drop`` limb
     keypoints of each pose at confidence 0;
  3. fit from the zero pose with the prior (``ImageFitter``) and with
     ``prior_scale=0`` (the same schedule);
  4. report the joint-angle error (degrees), the body-frame joint error (cm;
     zero orientation and shape, so the camera / orientation gauge cancels)
     and the stage-2 2D residual on the observed keypoints.

Run (the card; ``--device cpu`` for the CPU):
    python scripts/torch_fit_image_quality.py --ckpt docs/quality/ckpt_l8_best.msgpack \\
        --seeds 1 2 3 --out fit_image.json
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# BODY_25 limb keypoints that may be occluded (elbows, wrists, knees, ankles)
LIMB_KPTS = (3, 4, 6, 7, 10, 11, 13, 14)
CENTER = np.array([500.0, 500.0], np.float32)


def parse_args(argv=None) -> argparse.Namespace:
    from posendf_torch.experiments.quality import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default="docs/quality/ckpt_l8_best.msgpack",
                    help="trained field (msgpack); its family must match --latents/--freq/"
                         "--family-seed")
    ap.add_argument("--latents", type=int, default=8)
    ap.add_argument("--freq", type=float, nargs=2, default=[0.5, 1.2])
    ap.add_argument("--family-seed", type=int, default=123,
                    help="the manifold family's seed (the checkpoint's)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3],
                    help="evaluation seeds (poses, camera, noise, occlusion draws)")
    ap.add_argument("--batch", type=int, default=4, help="poses per fit")
    ap.add_argument("--noise-px", type=float, default=5.0)
    ap.add_argument("--drop", type=int, default=4,
                    help="occluded limb keypoints in the 'occluded' condition")
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--steps-per-iter", type=int, default=10)
    ap.add_argument("--prior-form", choices=("reference", "self"), default="self",
                    help="'self' (default): the denoise schedule's self-weighted prior; "
                         "'reference': the reference's linear weighting")
    ap.add_argument("--out", default=None)
    add_device_arg(ap)
    return ap.parse_args(argv)


def body_frame_joints(body, pose69: torch.Tensor) -> torch.Tensor:
    """The joints of ``pose69`` at zero shape and zero orientation."""
    from posendf_torch.smpl.lbs import lbs_forward

    B = pose69.shape[0]
    z = pose69.new_zeros
    _, j = lbs_forward(body.model, z((B, body.num_betas)), z((B, 3)), pose69)
    return j


def pose_metrics(body, fit_pose69, gt_pose69, gt_quats: np.ndarray):
    """(mean joint-angle error in degrees, mean body-frame joint error in cm)."""
    from posendf_torch.quat import axis_angle_to_quaternion

    dev = body.device
    fit = torch.as_tensor(fit_pose69, dtype=torch.float32).to(dev)
    gt = torch.as_tensor(gt_pose69, dtype=torch.float32).to(dev)
    B = fit.shape[0]
    with torch.no_grad():
        fq = axis_angle_to_quaternion(fit[:, :63].reshape(B, 21, 3))
        dots = torch.abs(torch.sum(fq * torch.from_numpy(gt_quats).to(dev), dim=-1))
        ang = 2.0 * torch.arccos(torch.clamp(dots, 0.0, 1.0))
        jf, jg = body_frame_joints(body, fit), body_frame_joints(body, gt)
        jerr = torch.mean(torch.sqrt(torch.sum((jf - jg) ** 2, -1) + 1e-12))
    return float(torch.mean(ang) * 180.0 / np.pi), float(jerr * 100.0)


def ground_truth(rng: np.random.Generator, family, fitter, B: int):
    """(gt quaternions (B, 21, 4), gt pose (B, 69), keypoints' pixels (B, 25, 2))
    of the next draw of ``rng``: poses, orientation, camera translation."""
    from posendf_torch.data.synthetic import synthetic_manifold_poses
    from posendf_torch.experiments.camera import project_points
    from posendf_torch.quat import quaternion_to_axis_angle
    from posendf_torch.smpl.lbs import lbs_forward, with_landmarks

    body, dev = fitter.body_model, fitter.device
    gt_quats = synthetic_manifold_poses(rng, B, family=family)
    gt_pose = np.zeros((B, 69), np.float32)
    gt_pose[:, :63] = quaternion_to_axis_angle(torch.from_numpy(gt_quats)).numpy().reshape(B, 63)
    gt_orient = rng.normal(scale=0.2, size=(B, 3)).astype(np.float32)
    trans = np.zeros((B, 3), np.float32)
    trans[:, :2] = rng.uniform(-0.3, 0.3, (B, 2))
    trans[:, 2] = 10.0 + rng.uniform(-1.0, 1.0, B)
    with torch.no_grad():
        verts, joints = lbs_forward(body.model, torch.zeros((B, body.num_betas), device=dev),
                                    torch.from_numpy(gt_orient).to(dev),
                                    torch.from_numpy(gt_pose).to(dev))
        joints = with_landmarks(verts, joints)
        cam = {"rotation": torch.eye(3, device=dev)[None].repeat(B, 1, 1),
               "translation": torch.from_numpy(trans).to(dev)}
        gt_xy = project_points(cam, fitter._mapped_joints(joints), fitter.focal_length,
                               torch.from_numpy(CENTER).to(dev)[None].repeat(B, 1))
    return gt_quats, gt_pose, gt_xy.cpu().numpy()


def corrupt(rng: np.random.Generator, gt_xy: np.ndarray, sig_px: float, n_drop: int):
    """(B, 25, 3) keypoints: pixel noise, ``n_drop`` limb keypoints a pose at
    confidence 0."""
    kp = np.ones(gt_xy.shape[:2] + (3,), np.float32)
    kp[..., :2] = gt_xy + sig_px * rng.standard_normal(gt_xy.shape)
    for b in range(len(kp)):
        if n_drop:
            kp[b, rng.choice(LIMB_KPTS, n_drop, replace=False), 2] = 0.0
    return kp


def run_rows(fitters: dict, family, args) -> list:
    """Every (seed, condition, prior) fit."""
    B = args.batch
    body = fitters["on"].body_model
    rows = []
    for seed in args.seeds:
        rng = np.random.default_rng([seed, 77])
        gt_quats, gt_pose, gt_xy = ground_truth(rng, family, fitters["on"], B)
        conditions = {"clean": (0.0, 0), "noise": (args.noise_px, 0),
                      "occluded": (args.noise_px, args.drop)}
        for cond, (sig_px, n_drop) in conditions.items():
            kp = corrupt(rng, gt_xy, sig_px, n_drop)
            for label in ("on", "off"):
                t0 = time.perf_counter()
                res, m = fitters[label].optimize(kp, iterations=args.iterations,
                                                 steps_per_iter=args.steps_per_iter,
                                                 center=CENTER)
                dt = time.perf_counter() - t0
                pose_deg, joint_cm = pose_metrics(body, res["pose_body"], gt_pose, gt_quats)
                rows.append({"seed": seed, "condition": cond, "prior": label,
                             "noise_px": sig_px, "dropped": n_drop,
                             "pose_err_deg": round(pose_deg, 3),
                             "joint_err_cm": round(joint_cm, 3),
                             "stage2_px_residual": round(m["stage2_final_data"], 3),
                             "solve_s": round(dt, 2)})
                print(f"   seed {seed} {cond:>8} prior={label:>3}: pose {pose_deg:6.2f} deg, "
                      f"joints {joint_cm:6.2f} cm, 2D residual {m['stage2_final_data']:8.2f} "
                      f"({dt:.1f}s)", flush=True)
    return rows


def summarize(rows: list, n_seeds: int) -> list:
    """Per condition: the errors with and without the prior, the prior's gain
    (positive: the prior reduced the error), the seeds it won."""
    summary = []
    for cond in ("clean", "noise", "occluded"):
        on = [r for r in rows if r["condition"] == cond and r["prior"] == "on"]
        off = [r for r in rows if r["condition"] == cond and r["prior"] == "off"]

        def mean(rs, k):
            return float(np.mean([r[k] for r in rs]))

        s = {"condition": cond,
             "pose_err_deg_on": round(mean(on, "pose_err_deg"), 3),
             "pose_err_deg_off": round(mean(off, "pose_err_deg"), 3),
             "joint_err_cm_on": round(mean(on, "joint_err_cm"), 3),
             "joint_err_cm_off": round(mean(off, "joint_err_cm"), 3),
             "prior_gain_deg": round(mean(off, "pose_err_deg") - mean(on, "pose_err_deg"), 3),
             "prior_gain_cm": round(mean(off, "joint_err_cm") - mean(on, "joint_err_cm"), 3),
             "seeds_prior_wins": sum(
                 1 for a, b in zip(sorted(on, key=lambda r: r["seed"]),
                                   sorted(off, key=lambda r: r["seed"]))
                 if a["joint_err_cm"] < b["joint_err_cm"])}
        summary.append(s)
        print(f"== {cond:>8}: pose {s['pose_err_deg_on']:.2f} vs {s['pose_err_deg_off']:.2f} "
              f"deg (gain {s['prior_gain_deg']:+.2f}), joints {s['joint_err_cm_on']:.2f} vs "
              f"{s['joint_err_cm_off']:.2f} cm (gain {s['prior_gain_cm']:+.2f}), prior wins "
              f"{s['seeds_prior_wins']}/{n_seeds} seeds", flush=True)
    return summary


def make_fitters(field, body, prior_form: str) -> dict:
    from posendf_torch.experiments.fit_image import ImageFitter

    return {"on": ImageFitter(field, body, prior_form=prior_form),
            "off": ImageFitter(field, body, prior_scale=0.0, prior_form=prior_form)}


def main(argv=None) -> dict:
    import json

    from posendf_torch.experiments.quality import (card_fields, gentle_family, load_trained_field,
                                                   write_result)
    from posendf_torch.field import resolve_device
    from posendf_torch.smpl import BodyModel

    args = parse_args(argv)
    dev = resolve_device(args.device)
    family = gentle_family(args.family_seed, *args.freq, args.latents)
    field, epoch = load_trained_field(args.ckpt, dev)
    print(f"== loaded {args.ckpt} (trained to step {epoch}); device: {dev}", flush=True)
    rows = run_rows(make_fitters(field, BodyModel(device=dev), args.prior_form), family, args)
    summary = summarize(rows, len(args.seeds))
    result = {"ckpt": args.ckpt, "latents": args.latents, "freq": list(args.freq),
              "family_seed": args.family_seed, "batch": args.batch,
              "noise_px": args.noise_px, "drop": args.drop, "iterations": args.iterations,
              "steps_per_iter": args.steps_per_iter, "prior_form": args.prior_form,
              "seeds": list(args.seeds), "summary": summary, "runs": rows,
              **card_fields(dev)}
    print(json.dumps({"summary": summary}), flush=True)
    write_result(result, args.out)
    return result


if __name__ == "__main__":
    main()
