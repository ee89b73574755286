"""A CPU model of the port's 3xTF32 tensor-core arithmetic, shared by
``tests/test_torch_field_tc.py`` (the field kernels) and
``tests/test_torch_train_tc.py`` (the train tile kernel).

Both kernels run every DFNet product as ``wgmma`` from the weight slabs of
``fused_model.pack_tc`` in the order of its program (``tc_schedule``): A
(the activations) split in registers, B (the weights) split in the slabs,
each product ``lo.hi' + hi.lo' + hi.hi'`` of ``fused_train.tf32_split``,
k8 step by k8 step, into an fp32 accumulator that rounds toward zero (the
tensor cores' accumulation as modelled here); a fresh accumulator for each
32 of K, added to the layer's sums in fp32 (IEEE) in the order of K. The
model takes the slabs from the packed stream in order, reads each back by
the swizzle's formula, and computes the slabs of one K-block at once (their
accumulators are independent).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from posendf_torch.ops import fused_model
from posendf_torch.ops.fused_model import TC_CHUNK, TC_KPERM, TC_SLAB_K, TC_SLAB_N
from posendf_torch.ops.fused_train import tf32_split

__all__ = ["slab_blocks", "features", "toward_zero", "SlabStream", "product", "program",
           "z_widths", "run"]


def slab_blocks(tc) -> List[torch.Tensor]:
    """Each slab read back by the swizzle's formula: a list of (halves, 2,
    rows, 32) tensors in K-position order (hi and lo of each 32 of K)."""
    out = []
    for slab, (_, _, _, _, cols) in zip(tc.slabs, tc.order):
        off = fused_model.tc_slab_offsets(cols).reshape(-1)
        halves = slab.reshape(-1, 2, cols * TC_SLAB_K)[:, :, off]
        out.append(halves.reshape(-1, 2, cols, TC_SLAB_K))
    return out


def features(block: torch.Tensor) -> torch.Tensor:
    """K positions -> features within each 8-group (the inverse of TC_KPERM)."""
    out = torch.empty_like(block)
    out.reshape(*block.shape[:-1], -1, 8)[..., list(TC_KPERM)] = \
        block.reshape(*block.shape[:-1], -1, 8)
    return out


def toward_zero(t: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    t32 = t.float()
    return torch.where(t32.double().abs() > t.abs(), torch.nextafter(t32, torch.zeros_like(t32)),
                       t32)


class SlabStream:
    """The packed slabs in the order the kernels read them. ``restart``
    begins the stream again (the train tile's e-chain reads the forward's
    slabs a second time)."""

    def __init__(self, tc):
        self.blocks = slab_blocks(tc)
        self.pos = 0

    def take(self, n: int) -> List[torch.Tensor]:
        out = self.blocks[self.pos:self.pos + n]
        assert len(out) == n, "the program reads more slabs than were packed"
        self.pos += n
        return out

    def restart(self) -> None:
        self.pos = 0


def product(stream: SlabStream, a: torch.Tensor, K: int, N: int, cols: int = TC_SLAB_N,
            tot: torch.Tensor = None) -> torch.Tensor:
    """``tot`` (fp32, zeros if None) plus a[:, :K] . B for the next slabs of
    the stream: per K-block of a slab (32 of K, or 64 for the first product
    of a chain, ``cols`` = 64), the N / cols slabs of its column groups."""
    B = a.shape[0]
    halves = TC_SLAB_N // cols              # 32-wide K-blocks a slab
    groups = N // cols
    nkb = K // TC_SLAB_K
    bh = torch.empty(nkb, N, TC_SLAB_K, dtype=torch.float64)
    bl = torch.empty_like(bh)
    for s, blk in enumerate(stream.take(nkb // halves * groups)):
        kbs, cg = divmod(s, groups)
        for h in range(halves):
            bh[kbs * halves + h, cg * cols:(cg + 1) * cols] = blk[h, 0]
            bl[kbs * halves + h, cg * cols:(cg + 1) * cols] = blk[h, 1]
    apos = a[:, :K].reshape(B, K // 8, 8)[..., list(TC_KPERM)].reshape(B, nkb, TC_SLAB_K)
    ah, al = (t.double() for t in tf32_split(apos))
    acc = torch.zeros(B, nkb, N)
    for kk in range(TC_SLAB_K // 8):
        k8 = slice(8 * kk, 8 * kk + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):   # the small terms first
            acc = toward_zero(acc.double() + torch.einsum("bkf,knf->bkn", x[..., k8], y[..., k8]))
    tot = torch.zeros(B, N) if tot is None else tot
    for kb in range(nkb):
        tot = tot + acc[:, kb]
    return tot


def program(tc):
    """The header and the forward's and the backward's steps of a pack."""
    prog = tc.prog.tolist()
    head, steps = prog[:fused_model.TC_HEAD], prog[fused_model.TC_HEAD:]
    steps = [steps[i:i + fused_model.TC_STEP] for i in range(0, len(steps), fused_model.TC_STEP)]
    fwd, bwd = steps[:head[0]], steps[head[0]:]
    assert len(bwd) == head[1]
    return head, fwd, bwd


def z_widths(tc) -> Dict[int, int]:
    """Each hidden layer's padded width by its z offset (the program's z1, z2)."""
    D = tc.widths
    return {sum(D[1:l + 1]): D[l + 1] for l in range(len(D) - 1)}


Epilogue = Callable[[torch.Tensor, int, int, slice], torch.Tensor]


def run(stream: SlabStream, x: torch.Tensor, steps, epi: Epilogue):
    """Walk a pass of the program from x (B, D) through ``epi(acc, bias,
    z, cols)`` (bias and z as the step gives them, the columns of the
    layer an accumulator holds). Returns the last output and every step's
    output by its z offset (the chained layer whole)."""
    outs: Dict[int, torch.Tensor] = {}
    for chain, K, N, N2, b1, z1, b2, z2 in steps:
        if chain:
            y, full = None, torch.empty(x.shape[0], N)
            for c in range(N // TC_CHUNK):
                cols = slice(c * TC_CHUNK, (c + 1) * TC_CHUNK)
                full[:, cols] = epi(product(stream, x, K, TC_CHUNK, TC_CHUNK), b1, z1, cols)
                y = product(stream, full[:, cols], TC_CHUNK, N2, tot=y)
            outs[z1] = full
            x = epi(y, b2, z2, slice(0, N2))
            outs[z2] = x
        else:
            x = epi(product(stream, x, K, N), b1, z1, slice(0, N))
            outs[z1] = x
    return x, outs
