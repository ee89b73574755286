"""Training losses for the distance field.

Mirror of ``posendf_tpu/losses.py`` (reference ``model/posendf.py:62-99``):

  * distance loss: L1 (or L2) between the predicted and the kNN-labelled
    distance, on the squeezed (B,) prediction;
  * manifold loss: mean |d| on clean poses, which the reference does NOT
    joint-axis-normalize (``normalize_input=False``);
  * eikonal loss: ((||grad_pose d||_2 - 1)^2) averaged over batch x joints,
    with the gradient taken with respect to the raw pose through the
    normalization, and ``+1e-12`` inside the norm (a gradient that is exactly
    zero where the head saturates would otherwise give a NaN derivative).

The eikonal term needs a gradient of a gradient: the pose gradient is taken
with ``torch.autograd.grad(..., create_graph=True)`` and the parameter
gradient of the total differentiates it again. The total always includes
every term (the reference drops the manifold term when eikonal == 0).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["training_loss"]


def training_loss(module, pose: torch.Tensor, dist_gt: torch.Tensor, man_poses: torch.Tensor,
                  *, loss_type: str = "l1", weight_dist: float = 1.0, weight_man: float = 1.0,
                  weight_eikonal: float = 1.0,
                  remat: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total weighted loss and the unweighted terms ``dist``, ``man_loss`` and
    ``eikonal``, differentiable with respect to ``module``'s parameters while
    grad mode is on.

    ``remat=True`` runs both forwards under ``torch.utils.checkpoint``: the
    parameter gradient recomputes their activations instead of keeping them
    alive across the eikonal term (the memory lever for batches of 64k
    poses and more; same math).
    """
    if loss_type not in ("l1", "l2"):
        raise ValueError(f"unknown loss_type {loss_type!r}")
    J = module.num_joints
    pose = pose.reshape(-1, J, 4)
    man_poses = man_poses.reshape(-1, J, 4)
    dist_gt = dist_gt.reshape(-1)
    create = torch.is_grad_enabled()

    def f(p, normalize_input=True):
        if remat:
            return checkpoint(module, p, normalize_input, use_reentrant=False)
        return module(p, normalize_input)

    with torch.enable_grad():
        p = pose.detach().requires_grad_(True)
        dist_pred = f(p)
        (grad_pose,) = torch.autograd.grad(dist_pred, p, torch.ones_like(dist_pred),
                                           create_graph=create)
    if not create:
        dist_pred = dist_pred.detach()

    r = dist_pred[:, 0] - dist_gt
    loss_dist = torch.mean(torch.abs(r)) if loss_type == "l1" else torch.mean(r * r)
    loss_man = torch.mean(torch.abs(f(man_poses, False)))
    grad_norm = torch.sqrt(torch.sum(grad_pose * grad_pose, dim=-1) + 1e-12)   # (B, J)
    loss_eik = torch.mean((grad_norm - 1.0) ** 2)

    total = weight_dist * loss_dist + weight_man * loss_man + weight_eikonal * loss_eik
    return total, {"dist": loss_dist, "man_loss": loss_man, "eikonal": loss_eik}
