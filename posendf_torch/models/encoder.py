"""Structure encoder: hierarchical per-joint pose encoding.

Mirror of ``posendf_tpu/models/encoder.py``. 21 two-layer BoneMLPs, one per
SMPL body joint, each reading its own unit quaternion (4) concatenated with
its parent's feature (F = 6); the outputs concatenate to a (B, 21 F) code.

All 21 BoneMLPs share one shape once root inputs are zero-padded from 4 to
4 + F input rows (the pad rows multiply a parent feature that is zero for
roots), so the weights are four stacked tensors ``w1 (J, 4+F, H)``,
``b1 (J, H)``, ``w2 (J, H, F)``, ``b2 (J, F)`` with H = 4 + F, stored
(in, out) as in the JAX package; a checkpoint's arrays copy over unchanged.
The forward runs one batched product per dependency level of the kinematic
tree (``kinematics.level_schedule``), or, with ``use_fused``, the whole walk
in one CUDA kernel (``ops/fused_encoder.py``) for CUDA tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from posendf_torch import kinematics
from posendf_torch.models.activations import make_activation

__all__ = ["StructureEncoder", "structure_encoder_apply"]


def _stacked_uniform(generator: Optional[torch.Generator], fan_in: Sequence[int],
                     shape: Tuple[int, ...], device) -> torch.Tensor:
    """torch.nn.Linear-style U(-1/sqrt(fan_in), 1/sqrt(fan_in)) per joint."""
    out = torch.empty(shape)
    for j, fi in enumerate(fan_in):
        bound = 1.0 / math.sqrt(fi)
        out[j].uniform_(-bound, bound, generator=generator)
    return out.to(device)


class StructureEncoder(nn.Module):
    """Kinematic-tree pose encoder: (B, J, 4) -> (B, J * feature_size)."""

    def __init__(self, parents: Tuple[int, ...] = kinematics.REFERENCE_PARENTS,
                 feature_size: int = 6, activation: str = "lrelu",
                 beta: float = 100.0, use_fused: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if generator is None:  # no global RNG: a fixed seed
            generator = torch.Generator().manual_seed(0)
        self.parents = tuple(parents)
        self.feature_size = feature_size
        self.activation = activation
        self.beta = beta
        self.use_fused = use_fused
        J, F = len(self.parents), feature_size
        H = 4 + F
        fan_in = [4 if p == -1 else H for p in self.parents]
        w1 = _stacked_uniform(generator, fan_in, (J, H, H), device)
        for j, fi in enumerate(fan_in):
            w1[j, fi:] = 0.0  # roots: the parent-feature rows stay zero
        self.w1 = nn.Parameter(w1)
        self.b1 = nn.Parameter(_stacked_uniform(generator, fan_in, (J, H), device))
        self.w2 = nn.Parameter(_stacked_uniform(generator, [H] * J, (J, H, F), device))
        self.b2 = nn.Parameter(_stacked_uniform(generator, [H] * J, (J, F), device))

    @property
    def num_joints(self) -> int:
        return len(self.parents)

    @property
    def out_dim(self) -> int:
        return self.num_joints * self.feature_size

    def forward(self, quat: torch.Tensor) -> torch.Tensor:
        if self.use_fused:
            from posendf_torch.ops.fused_encoder import fused_structure_encoder

            return fused_structure_encoder(
                quat, self.w1, self.b1, self.w2, self.b2, parents=self.parents,
                activation=self.activation, beta=self.beta)
        return structure_encoder_apply(
            quat, self.w1, self.b1, self.w2, self.b2, parents=self.parents,
            activation=self.activation, beta=self.beta)


def structure_encoder_apply(quat: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                            w2: torch.Tensor, b2: torch.Tensor, *,
                            parents: Tuple[int, ...], activation: str = "lrelu",
                            beta: float = 100.0) -> torch.Tensor:
    """Level-scheduled forward. (B, J, 4) -> (B, J * F)."""
    act = make_activation(activation, beta)
    B, J = quat.shape[0], len(parents)
    F = w2.shape[-1]
    zero = quat.new_zeros((B, F))
    feats = [None] * J
    for joint_ids, _ in kinematics.level_schedule(tuple(parents)):
        js = list(joint_ids)
        parent_feat = torch.stack(
            [zero if parents[j] == -1 else feats[parents[j]] for j in js], dim=0)
        inp = torch.cat([quat[:, js, :].transpose(0, 1), parent_feat], dim=-1)  # (n,B,4+F)
        h = act(torch.matmul(inp, w1[js]) + b1[js][:, None, :])               # (n,B,H)
        f = act(torch.matmul(h, w2[js]) + b2[js][:, None, :])                 # (n,B,F)
        for i, j in enumerate(js):
            feats[j] = f[i]
    return torch.cat(feats, dim=-1)
