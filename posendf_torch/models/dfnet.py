"""DFNet: the distance head mapping the structure code to d >= 0.

Mirror of ``posendf_tpu/models/dfnet.py``: an MLP ``in_dim -> dims... -> 1``
with the configured activation between layers and a final output activation
(ReLU for lrelu/relu, softplus for softplus). Weights are stored (in, out),
so a layer is ``x @ w + b`` and JAX checkpoints copy over without a
transpose. This is where the FLOPs are (~1.37M multiply-adds per pose at the
default widths).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from posendf_torch.models.activations import resolve

__all__ = ["DFNet"]


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
    """

    def __init__(self, in_dim: int = 126,
                 dims: Tuple[int, ...] = (256, 512, 1024, 512, 256, 64),
                 activation: str = "lrelu", beta: float = 100.0,
                 live_head: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if generator is None:  # no global RNG: a fixed seed
            generator = torch.Generator().manual_seed(0)
        self.activation = activation
        self.beta = beta
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
        for l, (w, b) in enumerate(self.layers()):
            x = torch.matmul(x, w) + b
            x = act(x) if l < self.num_layers - 1 else out_act(x)
        return x
