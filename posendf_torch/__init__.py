"""PoseNDF in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of ``posendf_tpu`` (the JAX package, which stays the reference):
the pose prior's main path, from a checkpoint to d(q), grad d(q) and the
manifold projection, its training (``posendf_torch.training``), the kNN
labelling of training data and int8 serving with ``torch.export`` artifacts.
Imports ``torch`` and never ``jax``.

    import posendf_torch
    field = posendf_torch.load_field("docs/quality/ckpt_l8_best.msgpack")   # on the card
    d, g = field.distance_and_grad_fused(poses)          # (B, 21, 4) -> (B, 1), (B, 21, 4)
    out, hist = posendf_torch.project(field, poses, steps=200, fused=True)
    qfield = field.quantize_int8(calib_poses)            # int8 serving
    d8 = qfield.distance(poses)
"""

from posendf_torch.field import Field, QuantizedField, load_field, make_field
from posendf_torch.models import PoseNDF
from posendf_torch.projection import project

__all__ = ["Field", "QuantizedField", "load_field", "make_field", "PoseNDF", "project"]
