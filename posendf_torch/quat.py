"""The two quaternion normalizations on the pose prior's path, and the joint
weights of the weighted distance.

Mirror of ``posendf_tpu/quat.py::quat_normalize``, ``joint_axis_normalize``,
``axis_angle_to_quaternion`` and ``SMPL_JOINT_RANK``. Both normalizations divide by
``sqrt(max(sum of squares, eps^2))`` (the clamp is taken of the squared sum,
so the gradient is finite at zero).
"""

from __future__ import annotations

import torch

__all__ = ["quat_normalize", "joint_axis_normalize", "axis_angle_to_quaternion",
           "SMPL_JOINT_RANK", "JOINT_WEIGHTS"]

# Per-joint importance ranks of the weighted distance (the reference's
# joint_rank, data/dist_utils.py:16,39), and their L2-normalized float32 form,
# the weights every weighted kNN search and label uses.
SMPL_JOINT_RANK = torch.tensor([7, 7, 7, 6, 6, 6, 5, 5, 5, 4, 4, 4, 4, 4, 3, 3, 3, 2, 2, 1, 1],
                               dtype=torch.float32)
JOINT_WEIGHTS = SMPL_JOINT_RANK / torch.linalg.norm(SMPL_JOINT_RANK)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize each quaternion (trailing axis) to unit norm; zero stays zero."""
    n = torch.sum(q * q, dim=-1, keepdim=True).clamp_min(eps * eps).sqrt()
    return q / n


def joint_axis_normalize(pose: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """The reference's ``F.normalize(pose, dim=1)`` quirk.

    A (B, 21, 4) pose is normalized across the JOINT axis: each (batch,
    component) column over the 21 joints, not each quaternion. Trained
    checkpoints bake this in.
    """
    n = torch.sum(pose * pose, dim=1, keepdim=True).clamp_min(eps * eps).sqrt()
    return pose / n


def axis_angle_to_quaternion(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> unit quaternion (..., 4), (w, x, y, z).

    pytorch3d's convention: q = [cos(t/2), sin(t/2) axis], with sin(t/2)/t
    and cos(t/2) taken from their Taylor series below t = 1e-6, written as
    the JAX package writes it (the square root's argument guarded, so the
    gradient is finite at the zero rotation).
    """
    sq = torch.sum(aa * aa, dim=-1, keepdim=True)
    small = sq < 1e-12
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half = 0.5 * angle
    sin_half_over_angle = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    return torch.cat([w, aa * sin_half_over_angle], dim=-1)
