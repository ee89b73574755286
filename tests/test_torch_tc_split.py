"""The arithmetic and layouts of the two tensor-core kernels, on the CPU:

* ``posendf_train_reduce`` (3xTF32 ``wgmma``): a plain model of the split,
  hi = tf32(x) and lo = tf32(x - hi) with tf32 rounding to 10 mantissa bits,
  to nearest and ties away from zero (``fused_train.tf32_split``). With
  x = hi + lo + e, |x - hi| <= 2^-11 |x| and |e| <= 2^-11 |x - hi|, so
  |x x' - (lo hi' + hi lo' + hi hi')| <= (3 + 2^-9) 2^-22 |x x'|: a product
  of 2,048 rows is held to the float64 product within that times the sum of
  |x x'|, and the model of the kernel's fp32 sums (fold groups of 128 rows,
  row ranges of 2,048, ranges in order) to ``reduce_ref`` within the leaf
  bar of ``chip_smoke.py`` (1e-4 x max|leaf|).
* the kNN bound engine (bf16 ``wgmma``): the packed corpus of
  ``fused_knn.pack_bound_ref`` (what ``posendf_knn_pack`` writes) read back
  by the swizzle's formula to the bf16 split; and the thread-partitioned
  lists: each of the 4 x S parts of ``fused_knn.bound_parts`` keeps its
  best KPAD by (distance, index), and their merge equals ``knn_topk_ref``'s
  ``mxu_fast`` result to the bit, on a corpus of duplicated rows too.

The kernels themselves run on the card only (``chip_smoke.py`` holds them
to their plain versions there).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posendf_torch.ops import fused_knn, fused_train  # noqa: E402
from posendf_torch.ops.knn import bf16_round  # noqa: E402

LEAF_TOL = 1e-4
SPLIT_REL = (3 + 2.0 ** -9) * 2.0 ** -22
REDUCE_RANGE, REDUCE_FOLD = 2048, 128   # rows a range / a fresh accumulator (train_kernels.cu)


def _normal(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def test_tf32_split_rounds_to_nearest_away():
    x = torch.cat([_normal(0, 4096) * 10.0 ** torch.arange(-20, 20, 10).repeat(1024),
                   torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 0.0, -0.0])])
    hi, lo = fused_train.tf32_split(x)
    for t in (hi, lo):
        assert bool(((t.view(torch.int32) & 0x1FFF) == 0).all())
    xd, hd, ld = x.double(), hi.double(), lo.double()
    assert bool(((xd - hd).abs() <= 2.0 ** -11 * xd.abs()).all())
    assert bool(((xd - hd - ld).abs() <= 2.0 ** -22 * xd.abs()).all())
    # ties go away from zero; 1 + 3 x 2^-11 lies halfway between 1 + 2^-10 and 1 + 2^-9
    assert hi[-5:].tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9, 0.0, -0.0]


def test_3xtf32_product_within_its_bound():
    """2,048 rows x (127, 64): the three passes summed exactly (float64)
    against the float64 product of the fp32 operands."""
    a, c = _normal(1, 2048, 127), _normal(2, 2048, 64) * 1e-3
    ah, al = (t.double() for t in fused_train.tf32_split(a))
    ch, cl = (t.double() for t in fused_train.tf32_split(c))
    got = al.T @ ch + ah.T @ cl + ah.T @ ch
    exact = a.double().T @ c.double()
    bound = SPLIT_REL * (a.double().abs().T @ c.double().abs())
    excess = float(((got - exact).abs() / bound).max())
    assert excess <= 1.0, excess
    # the split is what makes it fp32-grade: one TF32 pass is far outside the bound
    assert float(((ah.T @ ch - exact).abs() / bound).max()) > 10.0


def _kernel_model(a, c, dd):
    """dW and db as the kernel sums them: per range of 2,048 rows and fold
    group of 128, the three TF32 passes in fp32; fold groups and ranges added
    in order in fp32; db = dd^T c in fp32."""
    ah, al = fused_train.tf32_split(a)
    ch, cl = fused_train.tf32_split(c)
    total = torch.zeros(a.shape[1], c.shape[1])
    for r0 in range(0, a.shape[0], REDUCE_RANGE):
        part = torch.zeros_like(total)
        for f0 in range(r0, min(a.shape[0], r0 + REDUCE_RANGE), REDUCE_FOLD):
            s = slice(f0, min(a.shape[0], f0 + REDUCE_FOLD))
            part = part + ((al[s].T @ ch[s] + ah[s].T @ cl[s]) + ah[s].T @ ch[s])
        total = total + part
    return total, dd @ c


@pytest.mark.parametrize("rows_n,rows_m", [(2048, 2048), (3000, 700)])
def test_3xtf32_reduction_model_within_the_leaf_bar(rows_n, rows_m):
    """Both branches' rows (the manifold's a scaled by dd, as the kernel
    scales them) through the kernel's model and through ``reduce_ref``."""
    widths = [(126, 64), (64, 8), (8, 1)]
    enc = {k: torch.zeros(1) for k in ("w1", "b1", "w2", "b2")}

    def rows(seed, n, scale):
        dd = _normal(seed, n) * 1e-4
        a = [_normal(seed + 1 + l, n, i) for l, (i, _) in enumerate(widths)]
        c = [_normal(seed + 9 + l, n, o) for l, (_, o) in enumerate(widths)]
        if scale:
            a = [dd[:, None] * x for x in a]
        return fused_train.BranchRows(a=a, c=c, dd=dd, enc=enc, loss=torch.zeros(2))

    noisy, man = rows(10, rows_n, False), rows(30, rows_m, True)
    want, _ = fused_train.reduce_ref(SimpleNamespace(layers=widths), noisy, man)
    for l in range(len(widths)):
        w_n, b_n = _kernel_model(noisy.a[l], noisy.c[l], noisy.dd)
        w_m, b_m = _kernel_model(man.a[l], man.c[l], man.dd)
        for got, key in ((w_n + w_m, f"dfnet.w{l}"), (b_n + b_m, f"dfnet.b{l}")):
            scale = float(want[key].abs().max())
            assert float((got - want[key]).abs().max()) <= LEAF_TOL * scale, key


def _bound_operands(n_corpus, n_query, seed, duplicate=False):
    rng = np.random.default_rng(seed)

    def unit(n):
        q = rng.normal(size=(n, 21, 4)).astype(np.float32)
        return torch.from_numpy(q / np.linalg.norm(q, axis=-1, keepdims=True))

    c = unit(n_corpus)
    if duplicate:
        c = torch.cat([c, c])      # row j + n duplicates row j
    q = torch.cat([c[:n_query // 2], unit(n_query - n_query // 2)])
    return fused_knn.kernel_operands(q, c, None, "mxu_fast")


@pytest.mark.parametrize("n", [1, 128, 300])
def test_bound_pack_reads_back_to_the_bf16_split(n):
    _, cf, _, _ = _bound_operands(n, 2, seed=n)
    b = fused_knn.pack_bound_ref(cf).numpy()
    slabs = -(-n // fused_knn.BOUND_SLAB_ROWS)
    assert b.dtype == np.uint8 and b.size == slabs * fused_knn.BOUND_SLAB_BYTES
    # value e of packed row r ([hi | lo], 96 each): byte 2 e, in line 2 e // 128
    # of its slab; 16-byte chunk ch of a 128-row line's row rr at chunk ch ^ (rr % 8)
    r = np.arange(slabs * fused_knn.BOUND_SLAB_ROWS)[:, None]
    byte = 2 * np.arange(2 * fused_knn.BOUND_K)[None, :]
    rr, line, col = r % 128, byte // 128, byte % 128
    off = ((r // 128) * fused_knn.BOUND_SLAB_BYTES + line * 128 * 128 + (rr // 8) * 1024
           + (rr % 8) * 128 + (((col // 16) ^ (rr % 8)) * 16) + col % 16)
    u16 = (b[off].astype(np.uint16) | (b[off + 1].astype(np.uint16) << 8)).astype(np.int16)
    vals = torch.from_numpy(u16).view(torch.bfloat16).float()
    hi = bf16_round(cf)
    lo = bf16_round(cf - hi)
    assert torch.equal(vals[:n, :84], hi)
    assert torch.equal(vals[:n, 96:180], lo)
    rest = torch.ones_like(vals, dtype=torch.bool)
    rest[:n, :84] = rest[:n, 96:180] = False
    assert bool((vals[rest] == 0).all())


def _kpad(k):
    return max(8, -(-k // 8) * 8)


@pytest.mark.parametrize("splits,k,dup", [(1, 5, False), (3, 10, False), (7, 1, False),
                                          (2, 32, False), (3, 5, True)])
def test_bound_thread_lists_merge_to_the_plain_topk(splits, k, dup):
    qf, cf, wj, wt = _bound_operands(700, 40, seed=7 + splits, duplicate=dup)
    N = cf.shape[0]
    parts = fused_knn.bound_parts(N, splits)
    assert len(parts) == 4 * splits
    assert torch.equal(torch.sort(torch.cat(parts)).values, torch.arange(N))
    # every distance as the plain version computes it: its full ranking, inverted
    d_all, i_all = fused_knn.knn_topk_ref(qf, cf, N, weights=wj, w_total=wt, dot_impl="mxu_fast")
    dist = torch.empty_like(d_all).scatter_(1, i_all, d_all)
    kpad = _kpad(k)
    lists_d, lists_i = [], []
    for p in parts:         # each part's best kpad by (distance, index), sentinels past its rows
        d = dist[:, p]
        order = torch.sort(d, dim=1, stable=True).indices[:, :kpad]
        ld, li = d.gather(1, order), p[order]
        pad = kpad - ld.shape[1]
        lists_d.append(torch.cat([ld, torch.full((len(qf), pad), torch.finfo(torch.float32).max)], 1))
        lists_i.append(torch.cat([li, torch.full((len(qf), pad), 2 ** 31 - 1)], 1))
    # the merge: by distance, then index
    md, mi = torch.cat(lists_d, 1), torch.cat(lists_i, 1)
    by_i = torch.sort(mi, dim=1, stable=True).indices
    md, mi = md.gather(1, by_i), mi.gather(1, by_i)
    by_d = torch.sort(md, dim=1, stable=True).indices[:, :k]
    got_d, got_i = md.gather(1, by_d), mi.gather(1, by_d)
    want_d, want_i = fused_knn.knn_topk_ref(qf, cf, k, weights=wj, w_total=wt, dot_impl="mxu_fast")
    assert torch.equal(got_d, want_d) and torch.equal(got_i, want_i)
    if dup and k >= 2:      # a query that is corpus row j finds j, then its copy
        j = torch.arange(20)
        assert torch.equal(got_i[:20, :2], torch.stack([j, j + N // 2], 1))
