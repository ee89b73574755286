"""A CPU model of the port's tensor-core arithmetic, shared by
``tests/test_torch_field_tc.py`` (the field kernels), ``tests/test_torch_bf16_tc.py``
(the field kernels' bf16 route) and ``tests/test_torch_train_tc.py`` (the
train tile kernel).

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

The bf16 route (a pack of ``fused_model.pack_bf16``) reads the slabs of
``tc_schedule(widths, BF16_SLAB_K)``, 128 columns x 64 of K (64 x 128 for
a chain's first product), each read back by ``bf16_slab_offsets``; A is
the activations rounded to bf16 to nearest even; each k16 step's 16
products (exact in fp32) go into an fp32 accumulator that rounds toward
zero, a fresh one for each 64 of K (a slab, or each half of a chain's first
slab), added to the layer's sums in fp32 in the order of K.

``one_thread`` is a module-scoped fixture for the port's CPU test modules
of many small products; a module takes it with ``from tests.tc_model import
one_thread`` and ``pytestmark = pytest.mark.usefixtures("one_thread")``.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import pytest
import torch

from posendf_torch.models.dfnet import bf16_round
from posendf_torch.ops import fused_model
from posendf_torch.ops.fused_model import BF16_SLAB, BF16_SLAB_K, TC_CHUNK, TC_KPERM, TC_SLAB_K, \
    TC_SLAB_N
from posendf_torch.ops.fused_train import tf32_split

__all__ = ["one_thread", "slab_blocks", "bf16_slab_blocks", "features", "toward_zero",
           "SlabStream", "product", "product_bf16", "program", "z_widths", "run"]


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread for a module: its many small CPU products gain
    nothing from a pool, and under a parallel test run (several workers on
    the machine's cores) a pool's threads wait on each other for most of
    the module's time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def slab_blocks(tc) -> List[torch.Tensor]:
    """Each slab read back by the swizzle's formula: a list of (halves, 2,
    rows, 32) tensors in K-position order (hi and lo of each 32 of K)."""
    out = []
    for slab, (_, _, _, _, cols) in zip(tc.slabs, tc.order):
        off = fused_model.tc_slab_offsets(cols).reshape(-1)
        halves = slab.reshape(-1, 2, cols * TC_SLAB_K)[:, :, off]
        out.append(halves.reshape(-1, 2, cols, TC_SLAB_K))
    return out


def bf16_slab_blocks(tc) -> List[torch.Tensor]:
    """Each bf16 slab read back by the layout's formula: a list of (cols,
    BF16_SLAB / cols) float64 tensors, column by K."""
    out = []
    for slab, (_, _, _, _, cols) in zip(tc.slabs, tc.order):
        kl = BF16_SLAB // cols
        out.append(slab[fused_model.bf16_slab_offsets(cols, kl).reshape(-1)].double()
                   .reshape(cols, kl))
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
        self.bf16 = tc.bf16
        self.blocks = bf16_slab_blocks(tc) if tc.bf16 else slab_blocks(tc)
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
    of a chain, ``cols`` = 64), the N / cols slabs of its column groups.
    A bf16 stream takes :func:`product_bf16`."""
    if stream.bf16:
        return product_bf16(stream, a, K, N, cols, tot)
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


def product_bf16(stream: SlabStream, a: torch.Tensor, K: int, N: int, cols: int = TC_SLAB_N,
                 tot: torch.Tensor = None) -> torch.Tensor:
    """``tot`` (fp32, zeros if None) plus a[:, :K] . B in the bf16 route: per
    K-block of a slab (BF16_SLAB / cols of K), the N / cols slabs of its
    column groups; A rounded to bf16, k16 steps into a toward-zero
    accumulator, a fresh one each BF16_SLAB_K of K."""
    B = a.shape[0]
    kl = BF16_SLAB // cols                  # a slab's K: 64, or 128 (cols = 64)
    parts = kl // BF16_SLAB_K               # fresh accumulators a slab
    groups, nf = N // cols, K // BF16_SLAB_K
    bw = torch.empty(nf, N, BF16_SLAB_K, dtype=torch.float64)
    for s, blk in enumerate(stream.take(K // kl * groups)):
        kbs, cg = divmod(s, groups)
        for h in range(parts):
            bw[kbs * parts + h, cg * cols:(cg + 1) * cols] = \
                blk[:, h * BF16_SLAB_K:(h + 1) * BF16_SLAB_K]
    ab = bf16_round(a[:, :K]).double().reshape(B, nf, BF16_SLAB_K)
    acc = torch.zeros(B, nf, N)
    for kk in range(BF16_SLAB_K // 16):
        k16 = slice(16 * kk, 16 * kk + 16)
        acc = toward_zero(acc.double() + torch.einsum("bkf,knf->bkn", ab[..., k16], bw[..., k16]))
    tot = torch.zeros(B, N) if tot is None else tot
    for f in range(nf):
        tot = tot + acc[:, f]
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
