"""DFNet: the distance head mapping the structure code to d >= 0.

Mirror of ``posendf_tpu/models/dfnet.py``: an MLP ``in_dim -> dims... -> 1``
with the configured activation between layers and a final output activation
(ReLU for lrelu/relu, softplus for softplus). Weights are stored (in, out),
so a layer is ``x @ w + b`` and JAX checkpoints copy over without a
transpose. This is where the FLOPs are (~1.37M multiply-adds per pose at the
default widths).

``compute_dtype="bfloat16"`` mirrors the JAX module's mode: every product
takes bf16 operands (the activations and the weights rounded to nearest
even) and sums in fp32, the bias and the activation stay fp32, and each
hidden layer's output is rounded to bf16. The products run as an fp32
``torch.matmul`` of the rounded values (exact products, fp32 sums; TF32
must be off): a bf16 ``torch.matmul`` would round its product before the
bias, which JAX's ``preferred_element_type=float32`` does not.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from posendf_torch.models.activations import resolve

__all__ = ["DFNet", "bf16_round"]

COMPUTE_DTYPES = ("float32", "bfloat16")


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even, as JAX's ``astype``) and kept
    in its own dtype; differentiable, the cotangent rounded the same way, as
    JAX's transpose of ``astype`` rounds it."""
    return t.to(torch.bfloat16).to(t.dtype)


def _torch_linear_init(generator: Optional[torch.Generator], fan_in: int,
                       fan_out: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    bound = 1.0 / math.sqrt(fan_in)
    w = torch.empty(fan_in, fan_out).uniform_(-bound, bound, generator=generator)
    b = torch.empty(fan_out).uniform_(-bound, bound, generator=generator)
    return w.to(device), b.to(device)


class DFNet(nn.Module):
    """MLP distance head. (B, in_dim) -> (B, 1), non-negative.

    ``live_head`` replaces the last bias draw by 0.1: with the reference's
    torch-default init an lrelu/relu head is a coin flip between a live
    field and d == 0 everywhere (see the JAX module's note).
    ``compute_dtype``: "float32" or "bfloat16" (module docstring).
    """

    def __init__(self, in_dim: int = 126,
                 dims: Tuple[int, ...] = (256, 512, 1024, 512, 256, 64),
                 activation: str = "lrelu", beta: float = 100.0,
                 live_head: bool = False, compute_dtype: str = "float32",
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if generator is None:  # no global RNG: a fixed seed
            generator = torch.Generator().manual_seed(0)
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype!r}")
        self.activation = activation
        self.beta = beta
        self.compute_dtype = compute_dtype
        self.widths = (in_dim,) + tuple(dims) + (1,)
        self.num_layers = len(self.widths) - 1
        for l in range(self.num_layers):
            w, b = _torch_linear_init(generator, self.widths[l], self.widths[l + 1], device)
            if l == self.num_layers - 1 and live_head:
                b = torch.full_like(b, 0.1)
            setattr(self, f"w{l}", nn.Parameter(w))
            setattr(self, f"b{l}", nn.Parameter(b))

    def layers(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """[(w (in, out), b (out,)), ...] in order."""
        return [(getattr(self, f"w{l}"), getattr(self, f"b{l}"))
                for l in range(self.num_layers)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act, out_act = resolve(self.activation, self.beta)
        x = x.reshape(x.shape[0], -1)
        bf16 = self.compute_dtype == "bfloat16"
        for l, (w, b) in enumerate(self.layers()):
            if bf16:
                x = torch.matmul(bf16_round(x), bf16_round(w)) + b
            else:
                x = torch.matmul(x, w) + b
            if l < self.num_layers - 1:
                x = bf16_round(act(x)) if bf16 else act(x)
            else:
                x = out_act(x)
        return x
