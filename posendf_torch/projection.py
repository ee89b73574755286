"""Manifold projection: gradient descent onto the zero level set.

Mirror of ``posendf_tpu/projection.py``: iterate

    q  <-  q - step_scale * d(q) * grad_q d(q)

with optional per-step quaternion renormalization (``renormalize=True``) or
the reference-exact mode without it, and the optional tangent-space step.
JAX runs the loop as one ``lax.scan``; here it is a Python loop, of module
passes (``fused=False``) or of one kernel launch per step (``fused=True``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from posendf_torch.field import Field
from posendf_torch.ops.fused_grad import fused_project
from posendf_torch.quat import quat_normalize
from posendf_torch.utils.profiling import span

__all__ = ["project", "make_projector", "random_poses"]


def random_poses(generator: torch.Generator, batch: int, device="cpu",
                 num_joints: int = 21) -> torch.Tensor:
    """Random unit-quaternion poses, as the reference initializes them
    (uniform [0, 1), then per-joint normalize). The numbers are drawn on the
    generator's device and moved to ``device``, so a CPU generator gives the
    same poses on every device."""
    q = torch.rand((batch, num_joints, 4), generator=generator, device=generator.device)
    return quat_normalize(q).to(device)


def project(field: Field, poses: torch.Tensor, steps: int = 10, renormalize: bool = True,
            step_scale: float = 1.0, tangent: bool = False,
            fused: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project poses onto the learned manifold.

    Args:
      field: the :class:`Field` to descend.
      poses: (B, 21, 4) quaternion poses.
      steps: number of descent steps.
      renormalize: re-normalize each joint quaternion after every step.
      step_scale: multiplier on the d * grad step.
      tangent: remove each joint's radial gradient component before stepping.
      fused: one kernel launch per step (``ops/fused_grad.py``), in the
        module's compute dtype; the standard encoder + DFNet only
        (``ff_enc`` raises ValueError, as in JAX).

    Returns:
      (projected poses (B, 21, 4), distance history (steps, B)); history[i]
      is d before step i's update.
    """
    if fused:
        with span("posendf.project"):
            with span("posendf.project.prepare"):
                weights = field.weights()
            return fused_project(poses, weights, steps=steps, renormalize=renormalize,
                                 step_scale=step_scale, tangent=tangent)
    module = field.module
    q = poses
    history = poses.new_empty((steps, poses.shape[0]))
    for i in range(steps):
        with torch.enable_grad():
            qg = q.detach().requires_grad_(True)
            d = module(qg)
            (g,) = torch.autograd.grad(d, qg, torch.ones_like(d))
        with torch.no_grad():
            d = d.detach()
            if tangent:
                g = g - torch.sum(g * q, dim=-1, keepdim=True) * q
            q = q - step_scale * d[:, :, None] * g
            if renormalize:
                q = quat_normalize(q)
            history[i] = d[:, 0]
    return q.detach(), history


def make_projector(field: Field, steps: int = 10, renormalize: bool = True,
                   step_scale: float = 1.0, fused: bool = False):
    """Pre-bound projector: poses -> (projected, history)."""

    def run(poses):
        return project(field, poses, steps=steps, renormalize=renormalize,
                       step_scale=step_scale, fused=fused)

    return run
