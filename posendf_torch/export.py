"""Serving export: the field as one self-contained ``torch.export`` artifact.

Counterpart of ``posendf_tpu/export.py``, with ``torch.export.export``
standing in for ``jax.export``: the forward (fp32 or int8), or a whole
N-step projection, is traced with the weights baked in and written to one
file that loads with torch alone (no posendf_torch) and runs on the device
it was traced on. The batch is symbolic (``torch.export.Dim``) unless
``batch=`` is given, so one artifact serves any batch, a single pose
included; it is traced with 2 example poses, because torch.export would
specialize an example of size 0 or 1 into the program.

As in JAX (``export.py:12-15``, ``_portable``), the artifact is staged
through the plain paths, never the ctypes kernels, which a trace cannot see
into: the module forward with ``strenc.fused`` turned off,
``ops/fused_int8.py::fused_posendf_forward_int8_ref``, and ``steps``
unrolled ``ops/fused_grad.py::project_step_ref`` (the gradient written out
by hand, no autograd inside).

A file is a version header followed by ``torch.export.save``'s bytes::

    exp = export_forward(field.module)
    save_artifact(exp, "model.pt2")
    d = load_artifact("model.pt2").module()(poses)          # (b, 21, 4) -> (b, 1)

CLI: ``python -m posendf_torch.cli export --ckpt ... --out model.pt2``.
"""

from __future__ import annotations

import contextlib
import io
from typing import Optional

import torch

__all__ = ["export_forward", "export_forward_int8", "export_project", "save_artifact",
           "load_artifact"]

_VERSION_KEY = b"POSENDF_TORCH_EXPORT_V1\n"


def _spec(example: torch.Tensor, batch: Optional[int]):
    """(example poses, dynamic_shapes): a symbolic batch unless ``batch``."""
    if batch is None:
        return example, ({0: torch.export.Dim("b", min=2)},)
    return example[:1].expand(batch, *example.shape[1:]).contiguous(), None


def _example(num_joints: int, device) -> torch.Tensor:
    return torch.full((2, num_joints, 4), 0.5, dtype=torch.float32, device=device)


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, pose):
        return self.fn(pose)


@contextlib.contextmanager
def _portable(module):
    """The module with its encoder kernel turned off while it is traced
    (the weights are the same either way)."""
    enc = getattr(module, "enc", None)
    fused = getattr(enc, "use_fused", False)
    try:
        if fused:
            enc.use_fused = False
        yield module
    finally:
        if fused:
            enc.use_fused = True


def _export(fn, num_joints: int, device, batch: Optional[int]):
    example, dynamic = _spec(_example(num_joints, device), batch)
    with torch.no_grad():
        return torch.export.export(_Fn(fn), (example,), dynamic_shapes=dynamic)


def export_forward(module, *, batch: Optional[int] = None):
    """Stage ``pose (b, J, 4) -> distance (b, 1)`` of a PoseNDF module."""
    device = next(module.parameters()).device
    with _portable(module):
        return _export(lambda pose: module(pose), module.num_joints, device, batch)


def export_forward_int8(quantized_field, *, batch: Optional[int] = None):
    """Stage the int8 forward ``pose (b, J, 4) -> distance (b, 1)`` of a
    :class:`~posendf_torch.field.QuantizedField` (its plain version: the
    same requantize / int8 product / dequantize arithmetic as the kernel)."""
    from posendf_torch.ops.fused_int8 import fused_posendf_forward_int8_ref

    m, qparams = quantized_field.module, quantized_field.qparams

    def fn(pose):
        return fused_posendf_forward_int8_ref(pose, qparams, parents=m.parents,
                                              activation=m.activation, beta=m.beta)

    return _export(fn, m.num_joints, quantized_field.device, batch)


def export_project(module, *, steps: int = 10, batch: Optional[int] = None,
                   renormalize: bool = True, tangent: bool = False):
    """Stage the whole ``steps``-step projection as one program:
    ``pose (b, J, 4) -> (projected (b, J, 4), dist_history (steps, b))``,
    history[i] being d before step i (``projection.project``'s contract)."""
    from posendf_torch.ops.fused_grad import project_step_ref
    from posendf_torch.ops.fused_model import FieldWeights

    weights = FieldWeights.from_module(module)
    device = next(module.parameters()).device

    def fn(pose):
        q, hist = pose, []
        for _ in range(steps):
            d, q = project_step_ref(q, weights, tangent=tangent, renormalize=renormalize)
            hist.append(d[:, 0])
        return q, torch.stack(hist) if hist else pose.new_zeros((0, pose.shape[0]))

    return _export(fn, module.num_joints, device, batch)


def save_artifact(exported, path: str) -> None:
    """Write an ``ExportedProgram`` to one self-contained file."""
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    with open(path, "wb") as f:
        f.write(_VERSION_KEY)
        f.write(buf.getvalue())


def load_artifact(path: str):
    """Load a saved artifact; returns the ``ExportedProgram`` (call it as
    ``.module()(pose)``). Needs only torch."""
    with open(path, "rb") as f:
        payload = f.read()
    if not payload.startswith(_VERSION_KEY):
        raise ValueError(f"{path!r} is not a posendf_torch export artifact (missing version header)")
    return torch.export.load(io.BytesIO(payload[len(_VERSION_KEY):]))
