"""Pose interpolation: per-joint slerp between two poses, every waypoint
projected onto the learned manifold.

Mirror of ``posendf_tpu/experiments/interpolate.py`` (the capability the
reference advertises, README.md:74-76, and ships as a stub,
``experiments/interpolation.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from posendf_torch.field import Field
from posendf_torch.projection import project, random_poses
from posendf_torch.quat import axis_angle_to_quaternion, quat_slerp

__all__ = ["interpolate", "run_cli"]


def interpolate(field: Field, pose_a, pose_b, num_steps: int = 10,
                projection_steps: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """(path (num_steps, 21, 4), field distances (num_steps,)): the slerp
    waypoints from ``pose_a`` to ``pose_b`` ((21, 4) each) projected
    ``projection_steps`` steps onto the manifold, on the field's device."""
    dev = field.device
    pose_a = torch.as_tensor(pose_a, dtype=torch.float32).to(dev)
    pose_b = torch.as_tensor(pose_b, dtype=torch.float32).to(dev)
    t = torch.linspace(0.0, 1.0, num_steps, device=dev)
    path = quat_slerp(pose_a, pose_b, t)
    projected, _ = project(field, path, steps=projection_steps)
    with torch.no_grad():
        dist = field.module(projected)[:, 0]
    return projected, dist


def _load_endpoint(path: str) -> torch.Tensor:
    """One pose of an .npz: its 'pose' (21, 4) quaternions or 'pose_body'
    (63,) axis-angle (the first frame of either)."""
    with np.load(path) as z:
        if "pose" in z:
            q = np.asarray(z["pose"], np.float32).reshape(-1, 21, 4)[0]
            return torch.from_numpy(q / np.linalg.norm(q, axis=-1, keepdims=True))
        arr = np.asarray(z["pose_body"], np.float32).reshape(-1)[:63]
    return axis_angle_to_quaternion(torch.from_numpy(arr.reshape(21, 3).copy()))


def run_cli(args) -> None:
    """``cli interpolate``."""
    from posendf_torch.field import load_field

    field = load_field(args.ckpt, config=args.config, device=args.device)
    if bool(args.pose_a) != bool(args.pose_b):
        raise SystemExit("--pose-a and --pose-b must be given together")
    random_endpoints = not args.pose_a
    if random_endpoints:
        # from torch.Generator().manual_seed(seed): other poses than the JAX
        # CLI's jax.random.key(seed) (the two packages' generators differ)
        gen = torch.Generator().manual_seed(args.seed)
        pose_a = random_poses(gen, 1)[0]
        pose_b = random_poses(gen, 1)[0]
    else:
        pose_a = _load_endpoint(args.pose_a)
        pose_b = _load_endpoint(args.pose_b)
    path, dist = interpolate(field, pose_a, pose_b, num_steps=args.num_steps)
    if random_endpoints:
        print("NOTE: interpolating between RANDOM poses (no --pose-a/-b). Far off-manifold "
              "is outside the trained field's validity shell: the field under-reports "
              "distance there and the projected path generally stays far from real poses. "
              "Pass real pose endpoints for meaningful interpolation.")
    print(f"interpolated {args.num_steps} steps; field distance per waypoint:")
    print(" ".join(f"{float(d):.5f}" for d in dist))
    if args.out:
        np.savez(args.out, path=path.cpu().numpy(), dist=dist.cpu().numpy())
        print(f"wrote {args.out}")
