"""NeRF-style sinusoidal positional encoding of the DFNet input.

Mirror of ``posendf_tpu/models/pos_encoder.py`` (the reference's
``PosEncoder``, ``model/network/net_utils.py:5-22``, behind its ``ff_enc``
switch): with ``ff_enc=True`` in the config the 126-dim structure code is
lifted to ``dim * (2 * num_frequencies [+ 1])`` Fourier features before
the DFNet.
"""

from __future__ import annotations

import torch

__all__ = ["positional_encoding", "encoded_dim"]


def positional_encoding(x: torch.Tensor, num_frequencies: int,
                        include_identity: bool = True) -> torch.Tensor:
    """(..., D) -> (..., D * (2 * num_frequencies + include_identity)).

    Frequencies 2^0 .. 2^(F-1); the layout is [x, sin(2^0 x), cos(2^0 x),
    sin(2^1 x), cos(2^1 x), ...] concatenated on the last axis."""
    parts = [x] if include_identity else []
    for i in range(num_frequencies):
        f = float(2 ** i)
        parts += [torch.sin(x * f), torch.cos(x * f)]
    return torch.cat(parts, dim=-1)


def encoded_dim(dim: int, num_frequencies: int, include_identity: bool = True) -> int:
    return dim * (2 * num_frequencies + (1 if include_identity else 0))
