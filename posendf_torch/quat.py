"""The two quaternion normalizations on the pose prior's path.

Mirror of ``posendf_tpu/quat.py::quat_normalize`` and
``joint_axis_normalize``. Both divide by ``sqrt(max(sum of squares, eps^2))``
(the clamp is taken of the squared sum, so the gradient is finite at zero).
"""

from __future__ import annotations

import torch

__all__ = ["quat_normalize", "joint_axis_normalize"]


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
