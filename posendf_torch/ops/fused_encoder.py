"""The structure encoder in one CUDA kernel (forward only).

Port of ``posendf_tpu/ops/fused_encoder.py::_encoder_kernel``. The kernel is
``posendf_encoder`` in ``csrc/train_kernels.cu``: two threads a pose walk
the 21 joints in index order, splitting each joint's hidden units and
features, with the encoder's weights in shared memory as packed once per
parameter version by :func:`pack_encoder` (a row of float4s a unit: its E
weights, its bias, zeros); a CTA's poses come in as one contiguous run and
its rows of the (B, J*F) code go out as one, in the JAX layout.

``fused_structure_encoder`` launches it for a CUDA tensor and runs its plain
version, ``fused_structure_encoder_ref`` (the level-scheduled
``structure_encoder_apply``), for a CPU tensor. Under autograd it is a
``torch.autograd.Function`` whose backward differentiates the plain version,
as the JAX kernel's ``custom_vjp`` reuses the XLA level-scheduled encoder;
that backward is itself differentiable, so the eikonal term's gradient of a
gradient goes through it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from posendf_torch import _build
from posendf_torch.models.encoder import structure_encoder_apply
from posendf_torch.ops.fused_model import (aligned_contiguous, int_table, packed_once,
                                           replay_backward, stream_handle)

__all__ = ["fused_structure_encoder", "fused_structure_encoder_ref", "pack_encoder", "LAUNCHES"]

# launches of the encoder kernel since the count was last set to 0
LAUNCHES = 0

_PACKED: Dict[tuple, tuple] = {}   # pack_encoder's last few packings (fused_model.packed_once)


def fused_structure_encoder_ref(quat, w1, b1, w2, b2, *, parents: Tuple[int, ...],
                                activation: str = "lrelu", beta: float = 100.0) -> torch.Tensor:
    """Plain PyTorch version of the encoder kernel: (B, J, 4) -> (B, J*F)."""
    return structure_encoder_apply(quat, w1, b1, w2, b2, parents=parents,
                                   activation=activation, beta=beta)


def _check(quat, w1, parents) -> None:
    J = len(parents)
    if quat.dim() != 3 or quat.shape[1:] != (J, 4):
        raise ValueError(f"poses must have shape (B, {J}, 4), got {tuple(quat.shape)}")
    if quat.dtype != torch.float32:
        raise TypeError(f"poses must be float32, got {quat.dtype}")
    if quat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"poses must be on the CPU or a CUDA device, got {quat.device}")
    if quat.device != w1.device:
        raise ValueError(f"poses on {quat.device} but the encoder's weights on {w1.device}")


def pack_encoder(w1, b1, w2, b2) -> torch.Tensor:
    """The kernel's weights: (J, E + F, R) fp32, for each joint its E hidden
    units, then its F features, each a row of its E input weights, its bias
    and zeros to R = the next multiple of 4 above E (whole float4s)."""
    with torch.no_grad():
        E = w1.shape[-1]
        hid = torch.cat([w1.detach().float().transpose(1, 2), b1.detach().float()[..., None]], -1)
        feat = torch.cat([w2.detach().float().transpose(1, 2), b2.detach().float()[..., None]], -1)
        rows = torch.cat([hid, feat], 1)
        return torch.nn.functional.pad(rows, (0, (E + 4) // 4 * 4 - (E + 1))).contiguous()


def _launch(quat, w1, b1, w2, b2, parents, activation, beta) -> torch.Tensor:
    global LAUNCHES
    J, F = len(parents), w2.shape[-1]
    if F > 8 or J > 32 or w1.shape[-1] != 4 + F:
        raise ValueError(f"the encoder kernel takes at most 32 joints of feature size 8 "
                         f"with hidden width 4 + F; got J={J}, F={F}, H={w1.shape[-1]}")
    if activation not in _build.ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    wp = packed_once(_PACKED, (w1, b1, w2, b2), pack_encoder)
    par = int_table(tuple(parents), str(quat.device))
    q = aligned_contiguous(quat)
    out = torch.empty((q.shape[0], J * F), dtype=torch.float32, device=q.device)
    lib = _build.library("train")
    _build.check(lib.posendf_encoder(q.data_ptr(), q.shape[0], wp.data_ptr(), par.data_ptr(),
                                     J, F, _build.ACT_CODES[activation], float(beta),
                                     out.data_ptr(), stream_handle(q)),
                 "posendf_encoder", "train")
    LAUNCHES += 1
    return out


class _FusedEncoder(torch.autograd.Function):
    @staticmethod
    def forward(ctx, quat, spec, w1, b1, w2, b2):
        parents, activation, beta = spec
        ctx.spec = spec
        ctx.save_for_backward(quat, w1, b1, w2, b2)
        if quat.device.type == "cpu":
            return fused_structure_encoder_ref(quat, w1, b1, w2, b2, parents=parents,
                                               activation=activation, beta=beta)
        return _launch(quat, w1, b1, w2, b2, parents, activation, beta)

    @staticmethod
    def backward(ctx, grad):
        quat, w1, b1, w2, b2 = ctx.saved_tensors
        parents, activation, beta = ctx.spec

        def plain(q):
            return fused_structure_encoder_ref(q, w1, b1, w2, b2, parents=parents,
                                               activation=activation, beta=beta)

        g_quat, *g_params = replay_backward(plain, quat, [w1, b1, w2, b2], grad,
                                            ctx.needs_input_grad[0])
        return (g_quat, None, *g_params)


def fused_structure_encoder(quat: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                            w2: torch.Tensor, b2: torch.Tensor, *, parents: Tuple[int, ...],
                            activation: str = "lrelu", beta: float = 100.0) -> torch.Tensor:
    """Fused-forward structure encoder: (B, J, 4) -> (B, J*F).

    ``w1`` (J, 4+F, 4+F), ``b1`` (J, 4+F), ``w2`` (J, 4+F, F), ``b2`` (J, F),
    stored (in, out) as in the JAX package. A CUDA tensor goes through the
    kernel, a CPU tensor through the plain version; both are differentiable,
    twice.
    """
    _check(quat, w1, parents)
    return _FusedEncoder.apply(quat, (tuple(parents), activation, float(beta)), w1, b1, w2, b2)
