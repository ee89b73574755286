"""PoseNDF: the neural unsigned distance field over the pose manifold.

Mirror of ``posendf_tpu/models/posendf.py``: optional StructureEncoder
feeding DFNet, with the reference's input normalization across the JOINT
axis (``quat.joint_axis_normalize``). A pure function (B, 21, 4) -> (B, 1);
gradients come from autograd in ``posendf_torch.field``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from posendf_torch import kinematics
from posendf_torch.models.dfnet import DFNet
from posendf_torch.models.encoder import StructureEncoder
from posendf_torch.quat import joint_axis_normalize

__all__ = ["PoseNDF"]


class PoseNDF(nn.Module):
    """Distance field d(pose): (B, 21, 4) quaternion pose -> (B, 1).

    ``use_fused`` runs the structure encoder through its CUDA kernel
    (``ops/fused_encoder.py``) for CUDA tensors.

    ``ff_enc=True`` (positional encoding of the DFNet input) and
    ``compute_dtype="bfloat16"`` are not ported yet (ROADMAP Queue 1 item 5)
    and raise ``NotImplementedError``.
    """

    def __init__(self, num_joints: int = 21, use_encoder: bool = True,
                 feature_size: int = 6,
                 dfnet_dims: Tuple[int, ...] = (256, 512, 1024, 512, 256, 64),
                 activation: str = "lrelu", beta: float = 100.0,
                 parents: Tuple[int, ...] = kinematics.REFERENCE_PARENTS,
                 use_fused: bool = False, ff_enc: bool = False, compute_dtype: str = "float32",
                 live_head: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if generator is None:  # no global RNG: a fixed seed
            generator = torch.Generator().manual_seed(0)
        if ff_enc:
            raise NotImplementedError(
                "ff_enc (positional encoding) is not ported yet: ROADMAP Queue 1 item 5")
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={compute_dtype!r} is not ported yet (float32 only): "
                "ROADMAP Queue 1 item 5")
        self.num_joints = num_joints
        self.use_encoder = use_encoder
        self.activation = activation
        self.beta = beta
        self.parents = tuple(parents)
        self.ff_enc = ff_enc
        self.compute_dtype = compute_dtype
        if use_encoder:
            self.enc = StructureEncoder(parents=self.parents, feature_size=feature_size,
                                        activation=activation, beta=beta,
                                        use_fused=use_fused, generator=generator,
                                        device=device)
            in_dim = num_joints * feature_size
        else:
            self.enc = None
            in_dim = num_joints * 4
        self.dfnet = DFNet(in_dim=in_dim, dims=tuple(dfnet_dims), activation=activation,
                           beta=beta, live_head=live_head, generator=generator,
                           device=device)

    def forward(self, pose: torch.Tensor, normalize_input: bool = True) -> torch.Tensor:
        """(B, 21, 4) -> (B, 1) non-negative distances. ``normalize_input``
        applies the joint-axis normalization (the reference leaves the clean
        manifold branch unnormalized)."""
        pose = pose.reshape(-1, self.num_joints, 4)
        x = joint_axis_normalize(pose) if normalize_input else pose
        if self.enc is not None:
            x = self.enc(x)
        return self.dfnet(x)
