"""Activations and their derivatives, with JAX's semantics.

Mirror of ``posendf_tpu/models/activations.py``:
  * ``lrelu``: leaky ReLU, slope 0.01 below zero; the DFNet head then applies
    a final ReLU so distances are >= 0.
  * ``relu``: ReLU everywhere.
  * ``softplus``: ``softplus(beta * x) / beta`` everywhere, output included.

Two places where PyTorch's own functions would differ from the reference:
  * lrelu is written ``where(z >= 0, z, 0.01 z)``, so its derivative at
    exactly 0 is 1 as in JAX (``F.leaky_relu`` gives 0.01 there). relu'(0)
    is 0 in both frameworks.
  * softplus is ``logaddexp(beta x, 0) / beta``, i.e.
    ``(max(bx, 0) + log1p(exp(-|bx|))) / beta`` with no threshold, which is
    JAX's formula; ``nn.Softplus`` switches to the identity above
    ``beta x = 20``. The CUDA kernels use the same formula.

The derivative helpers are what the plain versions of the fused kernels
use, with the kernels' conventions: lrelu'(z) = [z >= 0] + 0.01 [z < 0],
relu'(z) = [z > 0], softplus'(z) = sigmoid(beta z); the output activation's
derivative is recovered from its own value d.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = [
    "make_activation", "make_output_activation", "resolve",
    "act_grad", "out_act_grad_from_value", "ACTIVATIONS",
]

ACTIVATIONS = ("lrelu", "relu", "softplus")


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.01 * x)


class _Softplus(torch.autograd.Function):
    """softplus(beta x) / beta with the derivative sigmoid(beta x), as JAX's
    custom JVP of ``logaddexp`` defines it. Autograd of ``torch.logaddexp``
    itself gives NaN second derivatives where exp(beta x) overflows."""

    @staticmethod
    def forward(ctx, x, beta):
        ctx.save_for_backward(x)
        ctx.beta = beta
        return torch.logaddexp(beta * x, torch.zeros_like(x)) / beta

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * torch.sigmoid(ctx.beta * x), None


def _softplus(beta: float) -> Callable[[torch.Tensor], torch.Tensor]:
    def fn(x: torch.Tensor) -> torch.Tensor:
        return _Softplus.apply(x, beta)

    return fn


def _check(name: str) -> None:
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; expected lrelu|relu|softplus")


def make_activation(name: str, beta: float = 100.0) -> Callable[[torch.Tensor], torch.Tensor]:
    _check(name)
    if name == "lrelu":
        return _leaky_relu
    if name == "relu":
        return torch.relu
    return _softplus(beta)


def make_output_activation(name: str, beta: float = 100.0) -> Callable[[torch.Tensor], torch.Tensor]:
    """The DFNet output nonlinearity forcing dist >= 0."""
    _check(name)
    if name in ("lrelu", "relu"):
        return torch.relu
    return _softplus(beta)


def resolve(name: str, beta: float = 100.0) -> Tuple[Callable, Callable]:
    return make_activation(name, beta), make_output_activation(name, beta)


def act_grad(name: str, beta: float, z: torch.Tensor) -> torch.Tensor:
    """Derivative of the hidden activation at pre-activation z."""
    _check(name)
    if name == "lrelu":
        return torch.where(z >= 0, 1.0, 0.01).to(z.dtype)
    if name == "relu":
        return (z > 0).to(z.dtype)
    return torch.sigmoid(beta * z)


def out_act_grad_from_value(name: str, beta: float, d: torch.Tensor) -> torch.Tensor:
    """Derivative of the output activation recovered from its value d:
    relu'(z) = [relu(z) > 0]; for softplus, sigmoid(beta z) = 1 - exp(-beta d)."""
    _check(name)
    if name in ("lrelu", "relu"):
        return (d > 0).to(d.dtype)
    return 1.0 - torch.exp(-beta * d)
