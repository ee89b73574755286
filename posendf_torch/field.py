"""Distance-field evaluation: value, value-and-gradient, and their kernels.

Mirror of ``posendf_tpu/field.py``. The reference takes pose gradients with
``torch.autograd.grad(outputs, inputs, grad_outputs=ones, create_graph=True)``;
since each distance depends only on its own pose, that is one backward pass
for the whole batch, and it stays differentiable for the eikonal term.

``distance`` / ``distance_and_grad`` are the module path (PyTorch ops, the
matrix products through ``torch.matmul``). ``distance_fused`` /
``distance_and_grad_fused`` go through the hand-written kernels
(``ops/fused_model.py``, ``ops/fused_grad.py``) for CUDA tensors.
The fused paths take the standard encoder + DFNet architecture and refuse
``ff_enc`` with ValueError (``FieldWeights.from_module``), as JAX's do; a
bf16 module (``compute_dtype="bfloat16"``) runs the kernels' bf16 route.
``Field.quantize_int8`` gives the int8 serving view, :class:`QuantizedField`
(``ops/fused_int8.py``), which saves to and loads from the JAX package's
``posendf-int8-v1`` file.
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from posendf_torch.config import PoseNDFConfig, load_config
from posendf_torch.ops.fused_grad import fused_distance_and_grad
from posendf_torch.ops.fused_model import FieldWeights, fused_posendf_forward
from posendf_torch.utils.profiling import span

__all__ = ["Field", "QuantizedField", "make_field", "load_field", "distance_and_grad",
           "resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks for
    the CPU. Raises when a CUDA device is asked for and there is none (no
    silent fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but torch.cuda.is_available() is "
                           "false; pass device='cpu' to run on the CPU")
    return dev


def distance_and_grad(module, pose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched (d, dd/dpose): (B, 21, 4) -> ((B, 1), (B, 21, 4)).

    The gradient is with respect to the raw pose, through the joint-axis
    normalization inside the model. It is taken with ``create_graph=True``,
    so both outputs can be differentiated again.
    """
    with torch.enable_grad():
        p = pose if pose.requires_grad else pose.detach().requires_grad_(True)
        d = module(p)
        (g,) = torch.autograd.grad(d, p, torch.ones_like(d), create_graph=True)
    return d, g.reshape(pose.shape)


class Field:
    """A PoseNDF module with the distance APIs of the JAX package's Field."""

    def __init__(self, module):
        self.module = module
        self._weights: Optional[FieldWeights] = None
        self._weights_key = None

    @property
    def device(self) -> torch.device:
        """The device of the module's parameters."""
        return next(self.module.parameters()).device

    def weights(self) -> FieldWeights:
        """The kernels' view of the module, packed once; rebuilt if a
        parameter was replaced or changed in place since."""
        key = tuple((p.data_ptr(), p._version) for p in self.module.parameters())
        if self._weights is None or key != self._weights_key:
            self._weights = FieldWeights.from_module(self.module)
            self._weights_key = key
        return self._weights

    def distance(self, pose: torch.Tensor) -> torch.Tensor:
        """(B, 21, 4) -> (B, 1)."""
        return self.module(pose)

    def distance_fused(self, pose: torch.Tensor) -> torch.Tensor:
        """Whole-model forward in one kernel; differentiable (its backward is
        the plain formula's) but in bf16, where the backward raises. Its span
        is ``posendf.forward`` (``utils.profiling``)."""
        with span("posendf.forward"):
            pose = pose.reshape(-1, self.module.num_joints, 4)
            return fused_posendf_forward(pose, self.weights())

    def distance_and_grad(self, pose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return distance_and_grad(self.module, pose)

    def quantize_int8(self, calib_poses: torch.Tensor) -> "QuantizedField":
        """Post-training int8 quantization of the DFNet stack for serving
        (``ops/fused_int8.py``). ``calib_poses`` (N, 21, 4), moved to the
        field's device, set the static activation scales; a few thousand
        representative poses suffice. Value-only: gradients stay on the fp32
        paths."""
        from posendf_torch.ops.fused_int8 import quantize_posendf

        m = self.module
        if not m.use_encoder or m.ff_enc:
            raise ValueError("quantize_int8 supports the standard encoder+DFNet "
                             "architecture (use_encoder=True, ff_enc=False)")
        dev = m.dfnet.w0.device
        params = dict(m.named_parameters())
        qparams = quantize_posendf(
            {k: params[f"enc.{k}"] for k in ("w1", "b1", "w2", "b2")},
            {k[len("dfnet."):]: v for k, v in params.items() if k.startswith("dfnet.")},
            calib_poses.to(dev, torch.float32).reshape(-1, m.num_joints, 4),
            parents=m.parents, activation=m.activation, beta=m.beta)
        return QuantizedField(SimpleNamespace(num_joints=m.num_joints, parents=tuple(m.parents),
                                              activation=m.activation, beta=float(m.beta)),
                              qparams)

    def distance_and_grad_fused(self, pose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(d, dd/dpose) in one kernel. Values only: the outputs carry no
        autograd graph. The gradient comes back in the caller's pose shape."""
        orig_shape = pose.shape
        d, g = fused_distance_and_grad(pose.reshape(-1, self.module.num_joints, 4),
                                       self.weights())
        return d, g.reshape(orig_shape)


class QuantizedField:
    """int8 serving view of a :class:`Field` (``ops/fused_int8.py``).

    ``distance`` runs the int8 kernel for poses on the card and its plain
    version for poses on the CPU; ``distance_ref`` runs the plain version
    on any device (the counterpart of JAX's ``distance_xla``). The
    calibration report is at ``qparams["report"]``. ``module`` holds what
    the forward needs: ``num_joints``, ``parents``, ``activation``, ``beta``.

    ``save(path)`` writes the JAX package's self-contained ``posendf-int8-v1``
    msgpack file (the int8 layers, the encoder, window, report and those
    attributes) and ``QuantizedField.load(path)`` reads it back with no
    config; files cross between the two packages both ways.
    """

    MAGIC = "posendf-int8-v1"

    def __init__(self, module, qparams):
        self.module = module
        self.qparams = qparams

    @property
    def device(self) -> torch.device:
        return self.qparams["enc"]["w1"].device

    def save(self, path: str) -> None:
        """One msgpack file, written to ``path + ".tmp"`` and renamed."""
        from posendf_torch.checkpoints import msgpack_serialize
        from posendf_torch.ops.fused_int8 import qparams_to_numpy

        m = self.module
        tree = qparams_to_numpy(self.qparams)
        report = dict(tree["report"])
        report["window"] = list(report.get("window", tree["window"]))
        payload = {
            "magic": self.MAGIC,
            "meta": {"num_joints": int(m.num_joints), "parents": [int(p) for p in m.parents],
                     "activation": str(m.activation), "beta": float(m.beta),
                     "window": list(tree["window"]), "report": report},
            "enc": tree["enc"],
            "layers": {str(i): lyr for i, lyr in enumerate(tree["layers"])},
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(msgpack_serialize(payload))
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "QuantizedField":
        """Read a :meth:`save` file (of either package) onto ``device``, the
        card by default; raises ValueError for any other file."""
        from posendf_torch.checkpoints import msgpack_restore
        from posendf_torch.ops.fused_int8 import qparams_from_numpy

        dev = resolve_device(device)
        with open(path, "rb") as f:
            try:
                payload = msgpack_restore(f.read())
            except (ValueError, UnicodeDecodeError, IndexError) as e:
                raise ValueError(f"{path!r} is not a posendf int8 field file ({e})") from None
        if not isinstance(payload, dict) or payload.get("magic") != cls.MAGIC:
            raise ValueError(f"{path!r} is not a posendf int8 field file")
        meta = payload["meta"]
        qparams = qparams_from_numpy({"enc": payload["enc"], "layers": payload["layers"],
                                      "window": meta["window"], "report": meta["report"]}, dev)
        module = SimpleNamespace(num_joints=int(meta["num_joints"]),
                                 parents=tuple(int(p) for p in meta["parents"]),
                                 activation=str(meta["activation"]), beta=float(meta["beta"]))
        return cls(module, qparams)

    def _kw(self) -> dict:
        m = self.module
        return dict(parents=m.parents, activation=m.activation, beta=m.beta)

    def distance(self, pose: torch.Tensor) -> torch.Tensor:
        """(B, 21, 4) -> (B, 1): the int8 kernel on the card, the plain
        version on the CPU."""
        from posendf_torch.ops.fused_int8 import fused_posendf_forward_int8

        return fused_posendf_forward_int8(pose.reshape(-1, self.module.num_joints, 4),
                                          self.qparams, **self._kw())

    def distance_ref(self, pose: torch.Tensor) -> torch.Tensor:
        """The plain version on any device."""
        from posendf_torch.ops.fused_int8 import fused_posendf_forward_int8_ref

        with torch.no_grad():
            return fused_posendf_forward_int8_ref(pose.reshape(-1, self.module.num_joints, 4),
                                                  self.qparams, **self._kw())


def make_field(module, device=None) -> Field:
    """A :class:`Field` of ``module``, moved to ``device`` if one is given."""
    return Field(module if device is None else module.to(device))


def load_field(ckpt_path=None, config=None, device="cuda") -> Field:
    """One-line entry point: checkpoint -> ready :class:`Field` on ``device``
    (the card by default; ``device="cpu"`` for the CPU).

    ``ckpt_path``: the reference's torch ``.tar``, the JAX package's
    ``.msgpack`` file, a training run's checkpoint directory (its latest,
    falling back to the previous one, see
    :class:`~posendf_torch.training.checkpoints.CheckpointStore`), or None
    for a freshly initialized field (seeded with 0). ``config``: a
    :class:`PoseNDFConfig`, a YAML or JSON path, or None for the
    ``configs/amass.yaml`` hyperparameters.
    """
    from posendf_torch.checkpoints import load_msgpack_params, load_torch_checkpoint

    dev = resolve_device(device)
    if config is None:
        cfg = PoseNDFConfig()
    elif isinstance(config, (str, os.PathLike)):
        cfg = load_config(os.fspath(config))
    else:
        cfg = config
    module = cfg.make_model()
    if ckpt_path:
        path = os.fspath(ckpt_path)
        if os.path.isdir(path):
            from posendf_torch.training.checkpoints import CheckpointStore

            if CheckpointStore(path, create=False).restore(module) is None:
                raise FileNotFoundError(f"no checkpoint in directory {path!r}")
        else:
            if path.endswith(".tar"):
                state, _ = load_torch_checkpoint(
                    path, parents=module.parents, feature_size=cfg.strenc.out_dim)
            else:
                state, _ = load_msgpack_params(path)
            module.load_state_dict(state, strict=True)
    return Field(module.to(dev))
