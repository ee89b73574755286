"""The whole distance field in one CUDA kernel (forward only).

Port of ``posendf_tpu/ops/fused_model.py::_model_kernel``. The kernel is
``posendf_forward`` in ``csrc/field_kernels.cu``: joint-axis normalization,
the 21-joint encoder walk and every DFNet layer for a tile of 16 poses in
one program; only the poses come in and d goes out through device memory.

``fused_posendf_forward`` launches it for a CUDA tensor and runs its plain
PyTorch version, ``fused_posendf_forward_ref``, for a CPU tensor. Under
autograd it is a ``torch.autograd.Function`` whose backward differentiates
the plain version, as the JAX kernel's ``custom_vjp`` differentiates the
XLA formula; that backward is itself differentiable. This module also holds
:class:`FieldWeights`, the view of a model that the kernels read, and its
packing into device buffers.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from posendf_torch import _build
from posendf_torch.models.activations import resolve
from posendf_torch.quat import joint_axis_normalize

__all__ = ["FieldWeights", "fused_posendf_forward", "fused_posendf_forward_ref", "replay_backward",
           "int_table", "aligned_contiguous", "LAUNCHES"]

# launches of the forward kernel since the count was last set to 0
LAUNCHES = 0

_MAX_JOINTS, _MAX_FEATURE, _MAX_LAYERS = 32, 8, 16


@dataclass
class Packed:
    """A field's weights as the kernels read them, on one device."""

    enc: torch.Tensor        # w1 | b1 | w2 | b2, flat fp32
    parents: torch.Tensor    # (J,) int32
    dfw: torch.Tensor        # per layer: W (in, out) | b | W^T (out, in), flat fp32
    meta: torch.Tensor       # (L, 6) int32: in, out, off W, off b, off W^T, off z
    meta_host: torch.Tensor  # the same table on the CPU
    num_layers: int
    maxw: int                # widest activation, input code included
    zsum: int                # sum of hidden widths (pre-activations kept per pose)


@dataclass
class FieldWeights:
    """What the fused kernels need from a PoseNDF: the parent table, the
    activation and the parameter tensors themselves (not copies, so the
    plain versions always see the current values)."""

    parents: Tuple[int, ...]
    activation: str
    beta: float
    enc: Dict[str, torch.Tensor]
    layers: List[Tuple[torch.Tensor, torch.Tensor]]
    _packed: Optional[Packed] = field(default=None, repr=False)

    @classmethod
    def from_module(cls, module) -> "FieldWeights":
        if not module.use_encoder:
            raise ValueError("the fused kernels support the standard encoder+DFNet "
                             "architecture (use_encoder=True)")
        enc = module.enc
        return cls(parents=tuple(module.parents), activation=module.activation,
                   beta=float(module.beta),
                   enc={"w1": enc.w1, "b1": enc.b1, "w2": enc.w2, "b2": enc.b2},
                   layers=module.dfnet.layers())

    @property
    def num_joints(self) -> int:
        return len(self.parents)

    @property
    def feature_size(self) -> int:
        return self.enc["w2"].shape[-1]

    @property
    def device(self) -> torch.device:
        return self.enc["w1"].device

    def tensors(self) -> List[torch.Tensor]:
        return [self.enc[k] for k in ("w1", "b1", "w2", "b2")] + \
            [p for wb in self.layers for p in wb]

    def packed(self) -> Packed:
        """The device buffers the kernels read, built once and reused."""
        if self._packed is None:
            self._packed = _pack(self)
        return self._packed


@functools.lru_cache(maxsize=None)
def int_table(values: tuple, device: str) -> torch.Tensor:
    """An int32 table (the parents, a layer table) on ``device``, made once:
    each copy from the host would make the host wait for the stream."""
    return torch.tensor(values, dtype=torch.int32, device=device)


def _pack(w: FieldWeights) -> Packed:
    J, F, L = w.num_joints, w.feature_size, len(w.layers)
    if J > _MAX_JOINTS or F > _MAX_FEATURE or L > _MAX_LAYERS:
        raise ValueError(f"the kernels take at most {_MAX_JOINTS} joints, feature size "
                         f"{_MAX_FEATURE} and {_MAX_LAYERS} layers; got {J}, {F}, {L}")
    if w.layers[-1][0].shape[1] != 1:
        raise ValueError("the last DFNet layer must have one output")
    with torch.no_grad():
        enc = torch.cat([w.enc[k].detach().reshape(-1).float()
                         for k in ("w1", "b1", "w2", "b2")]).contiguous()
        chunks, meta, off, zoff = [], [], 0, 0

        def put(t: torch.Tensor) -> int:
            nonlocal off
            start = off
            flat = t.detach().reshape(-1).float()
            pad = (-flat.numel()) % 4                     # 16-byte aligned regions
            chunks.append(flat)
            if pad:
                chunks.append(flat.new_zeros(pad))
            off += flat.numel() + pad
            return start

        for wl, bl in w.layers:
            fan_in, fan_out = wl.shape
            meta.append([fan_in, fan_out, put(wl), put(bl), put(wl.t().contiguous()), zoff])
            zoff += fan_out
        zsum = zoff - w.layers[-1][0].shape[1]            # the output's z is not kept
        dfw = torch.cat(chunks).contiguous()
        widths = [w.layers[0][0].shape[0]] + [wl.shape[1] for wl, _ in w.layers]
        meta = tuple(map(tuple, meta))
        return Packed(
            enc=enc, parents=int_table(tuple(w.parents), str(enc.device)), dfw=dfw,
            meta=int_table(meta, str(enc.device)), meta_host=int_table(meta, "cpu"),
            num_layers=L, maxw=max(widths), zsum=zsum)


def check_poses(quat: torch.Tensor, weights: FieldWeights) -> None:
    """Raise on any pose tensor the kernels (or their plain versions) do not take."""
    J = weights.num_joints
    if quat.dim() != 3 or quat.shape[1:] != (J, 4):
        raise ValueError(f"poses must have shape (B, {J}, 4), got {tuple(quat.shape)}")
    if quat.dtype != torch.float32:
        raise TypeError(f"poses must be float32, got {quat.dtype}")
    if quat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"poses must be on the CPU or a CUDA device, got {quat.device}")
    if quat.device != weights.device:
        raise ValueError(f"poses on {quat.device} but the field's weights on {weights.device}")


def aligned_contiguous(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read their inputs: contiguous and 16-byte
    aligned. A strided or permuted view (or a view at an odd offset) is
    copied, as JAX takes any array; the copy is differentiable."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def common_args(quat: torch.Tensor, weights: FieldWeights) -> list:
    """The launchers' leading arguments, shared by the three kernels."""
    pk = weights.packed()
    return [quat.data_ptr(), quat.shape[0], pk.enc.data_ptr(), pk.parents.data_ptr(),
            weights.num_joints, weights.feature_size, pk.dfw.data_ptr(), pk.meta.data_ptr(),
            pk.num_layers, pk.maxw, pk.zsum, _build.ACT_CODES[weights.activation],
            weights.beta]


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def field_forward_ref(x: torch.Tensor, weights: FieldWeights, keep: bool = False):
    """Plain forward over pre-normalized poses x (B, J, 4), walking the joints
    in index order as the kernel does. Returns d (B, 1) and, with ``keep``,
    the pre-activations the backward needs: (encoder h, encoder f, DFNet z)."""
    act, out_act = resolve(weights.activation, weights.beta)
    w1, b1, w2, b2 = (weights.enc[k] for k in ("w1", "b1", "w2", "b2"))
    B, F = x.shape[0], weights.feature_size
    zero = x.new_zeros((B, F))
    feats, zh, zf = [], [], []
    for j, p in enumerate(weights.parents):
        inp = torch.cat([x[:, j], zero if p == -1 else feats[p]], dim=-1)   # (B, 4+F)
        zh.append(torch.matmul(inp, w1[j]) + b1[j])
        zf.append(torch.matmul(act(zh[j]), w2[j]) + b2[j])
        feats.append(act(zf[j]))
    h = torch.cat(feats, dim=-1)
    zs = []
    L = len(weights.layers)
    for l, (w, b) in enumerate(weights.layers):
        z = torch.matmul(h, w) + b
        if l < L - 1:
            zs.append(z)
            h = act(z)
        else:
            h = out_act(z)
    return (h, (zh, zf, zs)) if keep else h


def fused_posendf_forward_ref(quat: torch.Tensor, weights: FieldWeights) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: (B, J, 4) -> (B, 1)."""
    return field_forward_ref(joint_axis_normalize(quat), weights)


def _launch_forward(quat: torch.Tensor, weights: FieldWeights) -> torch.Tensor:
    global LAUNCHES
    out = torch.empty((quat.shape[0], 1), dtype=torch.float32, device=quat.device)
    lib = _build.library()
    _build.check(lib.posendf_forward(*common_args(quat, weights), out.data_ptr(),
                                     stream_handle(quat)), "posendf_forward")
    LAUNCHES += 1
    return out


def replay_backward(plain, inp: torch.Tensor, params: List[torch.Tensor], grad: torch.Tensor,
                    needs_inp: bool) -> tuple:
    """Backward of a kernel's ``autograd.Function``: differentiate its plain
    version ``plain(inp)`` (which reads ``params``) at the saved input.

    With grad mode on inside the backward (an outer ``create_graph=True``,
    as the eikonal term's gradient-of-a-gradient takes it), the gradients
    are built with ``create_graph`` from the caller's own input, so they can
    be differentiated again, with respect to the parameters and the input.
    Returns the input's gradient (None unless ``needs_inp``), then one per
    parameter (None for a frozen one)."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        x = inp if (create and inp.requires_grad) else inp.detach().requires_grad_(True)
        live = [p for p in params if p.requires_grad]
        out = plain(x)
        grads = iter(torch.autograd.grad(out, [x] + live, grad, allow_unused=True,
                                         create_graph=create))
    g_inp = next(grads)
    return (g_inp if needs_inp else None,) + tuple(
        next(grads) if p.requires_grad else None for p in params)


class _FusedForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, quat, weights, *params):
        ctx.weights = weights
        ctx.save_for_backward(quat)
        if quat.device.type == "cpu":
            return fused_posendf_forward_ref(quat, weights)
        return _launch_forward(quat, weights)

    @staticmethod
    def backward(ctx, grad):
        (quat,) = ctx.saved_tensors
        weights = ctx.weights
        g_quat, *g_params = replay_backward(
            lambda q: fused_posendf_forward_ref(q, weights), quat, weights.tensors(), grad,
            ctx.needs_input_grad[0])
        return (g_quat, None, *g_params)


def fused_posendf_forward(quat: torch.Tensor, weights: FieldWeights) -> torch.Tensor:
    """Whole-model forward: (B, J, 4) -> (B, 1) distances.

    A CUDA tensor goes through the kernel, a CPU tensor through the plain
    version; both are differentiable, twice (the backward is the plain
    version's, see :func:`replay_backward`).
    """
    check_poses(quat, weights)
    if quat.device.type == "cuda":
        quat = aligned_contiguous(quat)
    return _FusedForward.apply(quat, weights, *weights.tensors())
