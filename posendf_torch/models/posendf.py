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
from posendf_torch.models.pos_encoder import encoded_dim, positional_encoding
from posendf_torch.quat import joint_axis_normalize

__all__ = ["PoseNDF"]


class PoseNDF(nn.Module):
    """Distance field d(pose): (B, 21, 4) quaternion pose -> (B, 1).

    ``use_fused`` runs the structure encoder through its CUDA kernel
    (``ops/fused_encoder.py``) for CUDA tensors. ``ff_enc`` lifts the code
    into ``ff_freqs`` octaves of Fourier features
    (``models/pos_encoder.py``) before the DFNet. ``compute_dtype`` is the
    DFNet's ("bfloat16": bf16 operands, fp32 sums; see ``models/dfnet.py``);
    the encoder stays fp32, as in the JAX module.
    """

    def __init__(self, num_joints: int = 21, use_encoder: bool = True,
                 feature_size: int = 6,
                 dfnet_dims: Tuple[int, ...] = (256, 512, 1024, 512, 256, 64),
                 activation: str = "lrelu", beta: float = 100.0,
                 parents: Tuple[int, ...] = kinematics.REFERENCE_PARENTS,
                 use_fused: bool = False, ff_enc: bool = False, ff_freqs: int = 4,
                 compute_dtype: str = "float32", live_head: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if generator is None:  # no global RNG: a fixed seed
            generator = torch.Generator().manual_seed(0)
        self.num_joints = num_joints
        self.use_encoder = use_encoder
        self.activation = activation
        self.beta = beta
        self.parents = tuple(parents)
        self.ff_enc = ff_enc
        self.ff_freqs = ff_freqs
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
        if ff_enc:
            in_dim = encoded_dim(in_dim, ff_freqs)
        self.dfnet = DFNet(in_dim=in_dim, dims=tuple(dfnet_dims), activation=activation,
                           beta=beta, live_head=live_head, compute_dtype=compute_dtype,
                           generator=generator, device=device)

    def forward(self, pose: torch.Tensor, normalize_input: bool = True) -> torch.Tensor:
        """(B, 21, 4) -> (B, 1) non-negative distances. ``normalize_input``
        applies the joint-axis normalization (the reference leaves the clean
        manifold branch unnormalized)."""
        pose = pose.reshape(-1, self.num_joints, 4)
        x = joint_axis_normalize(pose) if normalize_input else pose
        if self.enc is not None:
            x = self.enc(x)
        if self.ff_enc:
            x = positional_encoding(x.reshape(x.shape[0], -1), self.ff_freqs)
        return self.dfnet(x)
