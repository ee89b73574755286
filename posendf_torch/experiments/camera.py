"""Perspective camera for image-based fitting.

Mirror of ``posendf_tpu/experiments/camera.py`` (the SMPLify-X-derived
``PerspectiveCamera``, ``experiments/exp_utils.py:68-143``): focal length
5000, a rotation and a translation, pinhole projection of 3D joints to
pixels. The camera is a dict of tensors and ``project_points`` a plain
function, so the camera's parameters are optimized by the same annealed
Adam as the body's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["init_camera", "project_points", "FOCAL_LENGTH"]

FOCAL_LENGTH = 5000.0


def init_camera(batch_size: int = 1, dtype=torch.float32, device="cuda") -> Dict[str, torch.Tensor]:
    """Identity rotations (B, 3, 3) and zero translations (B, 3) on
    ``device`` (the card unless the caller asks for the CPU)."""
    from posendf_torch.field import resolve_device

    dev = resolve_device(device)
    return {"rotation": torch.eye(3, dtype=dtype, device=dev)[None].repeat(batch_size, 1, 1),
            "translation": torch.zeros((batch_size, 3), dtype=dtype, device=dev)}


def project_points(camera: Dict[str, torch.Tensor], points: torch.Tensor,
                   focal_length: float = FOCAL_LENGTH,
                   center: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pinhole projection of (B, N, 3) points: x_img = f (R x + t)_xy /
    (R x + t)_z + c, with ``center`` (B, 2) the principal point. A depth
    within 1e-8 of 0 (either sign) is taken as +1e-8, as JAX does."""
    cam_pts = torch.einsum("bij,bnj->bni", camera["rotation"], points) \
        + camera["translation"][:, None, :]
    z = cam_pts[..., 2:3]
    xy = cam_pts[..., :2] / torch.where(torch.abs(z) < 1e-8, 1e-8, z)
    img = focal_length * xy
    if center is not None:
        img = img + center[:, None, :]
    return img
