"""The yardstick: operations and bytes of the model's work, and the chip's peaks.

Every count is of the model's mathematics, from the configuration's widths,
whatever the program does to compute it: a multiply-add is 2 operations, each
counted once (no extra passes for 3xTF32, no padding of the DFNet's widths),
and every operation is held to one peak, the H100's dense TF32 tensor-core
rate, so that a change of route (fewer TF32 passes, bf16) reads as time saved
and never as more work. The least time of a piece of work is the larger of its
operations over that peak and its bytes over the memory's rate; a roofline
share is that least time over the measured time.

Frozen from the program's own yardstick (``chip_smoke.py``'s
``traversal_flops`` and ``field_bound``), except that those count 3 TF32
passes (or 1 bf16 pass) by the route taken and the encoder's and output
layer's operations at the fp32 rate.

P below is the multiply-adds of one pass of one pose through the network:
the encoder's J (E E + E F), E = 4 + F (a root joint's zero parent-feature
rows included), and the DFNet's sum of in x out over its layers. At the
published widths (21 joints, F = 6; DFNet 126-256-512-1024-512-256-64-1):
3,360 + 1,359,424 = 1,362,784, or 2,725,568 operations.

* A forward of a pose: 2P operations.
* A projection step: the forward and the backward to the input, 4P.
* A training step (``losses.training_loss``: the distance term on the noisy
  poses, the manifold term, the eikonal term on the noisy poses' pose
  gradient; lrelu or relu, whose second derivative is zero):
  - noisy pose: forward P; pose gradient (the backward to the input, which
    the eikonal term needs) P; the eikonal term's parameter gradient
    pushes its cotangent back through that backward, a pass forward through
    the transposed products, P; each weight's gradient is then one product
    of the layer's input side and its output side, P. The distance term's
    cotangent at each unit is dL/dd times the pose gradient's cotangent
    there, since act'' = 0, so it needs no pass of its own and adds to the
    same weight-gradient product. 4P.
  - manifold pose: forward P; backward to every layer's output P; the
    weight-gradient product P. 3P.
  So a step of n noisy and m manifold poses is 2 P (4 n + 3 m) operations.
  Of it, the DFNet's weight-gradient products, 2 D (n + m) with D the
  DFNet's multiply-adds, are the reduction's; the rest is the tile's.

Bytes are the model's alone: the poses, labels, weights and distances or
gradient that go in and out of a piece of work. What a program keeps between
its own kernels (the rows the train tile writes and its reduction reads) is
its implementation's and is not counted, so that a smaller or a fused
intermediate reads as time saved. The train step's bytes are split as its
operations are: the poses, labels and weights to the tile, the gradient to
the reduction.
  Softplus has act'' != 0 and more terms: its count is not written here.
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["PEAK_TF32", "PEAK_BYTES", "encoder_macs", "dfnet_macs", "pose_macs", "param_count",
           "forward_flops", "project_step_flops", "train_step_flops", "train_reduce_flops",
           "train_tile_flops", "forward_bytes", "project_step_bytes", "train_tile_bytes",
           "train_reduce_bytes", "least_seconds"]

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W limit
PEAK_TF32 = 494.7e12       # TF32 tensor-core operations a second
PEAK_BYTES = 3.35e12       # HBM3 bytes a second
F32 = 4


def encoder_macs(joints: int, feature: int) -> int:
    E = 4 + feature
    return joints * (E * E + E * feature)


def dfnet_macs(widths: Sequence[int]) -> int:
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def pose_macs(spec: dict) -> int:
    return encoder_macs(len(spec["parents"]), spec["feature"]) + dfnet_macs(spec["widths"])


def param_count(spec: dict) -> int:
    J, F = len(spec["parents"]), spec["feature"]
    E = 4 + F
    w = spec["widths"]
    return J * (E * E + E + E * F + F) + sum(a * b + b for a, b in zip(w[:-1], w[1:]))


def forward_flops(spec: dict, poses: int) -> float:
    return 2.0 * pose_macs(spec) * poses


def project_step_flops(spec: dict, poses: int) -> float:
    return 4.0 * pose_macs(spec) * poses


def _piecewise_linear(spec: dict) -> None:
    if spec["activation"] not in ("lrelu", "relu"):
        raise ValueError("the training count is written for lrelu and relu only")


def train_step_flops(spec: dict, noisy: int, manifold: int) -> float:
    _piecewise_linear(spec)
    return 2.0 * pose_macs(spec) * (4 * noisy + 3 * manifold)


def train_reduce_flops(spec: dict, noisy: int, manifold: int) -> float:
    _piecewise_linear(spec)
    return 2.0 * dfnet_macs(spec["widths"]) * (noisy + manifold)


def train_tile_flops(spec: dict, noisy: int, manifold: int) -> float:
    return train_step_flops(spec, noisy, manifold) - train_reduce_flops(spec, noisy, manifold)


def _pose_floats(spec: dict) -> int:
    return 4 * len(spec["parents"])


def forward_bytes(spec: dict, poses: int) -> float:
    """The poses in, one distance out, the weights once."""
    return F32 * (poses * (_pose_floats(spec) + 1) + param_count(spec))


def project_step_bytes(spec: dict, poses: int) -> float:
    """The poses in, the next poses and one distance out, the weights once."""
    return F32 * (poses * (2 * _pose_floats(spec) + 1) + param_count(spec))


def train_tile_bytes(spec: dict, noisy: int, manifold: int) -> float:
    """The model's inputs: the poses and the noisy poses' labels in, the weights once."""
    return F32 * ((noisy + manifold) * _pose_floats(spec) + noisy + param_count(spec))


def train_reduce_bytes(spec: dict, noisy: int, manifold: int) -> float:
    """The model's output: the gradient out."""
    return F32 * param_count(spec)


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_TF32, nbytes / PEAK_BYTES)
