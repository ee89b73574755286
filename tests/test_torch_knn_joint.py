"""The kNN exact and bf16 engines' tensor-core design, on the CPU.

* ``fused_knn.pack_joint_ref`` (what ``posendf_knn_pack_joint`` writes) read
  back by the 32-byte swizzle's formula to one bf16 k16 group
  ``[ch | ch | cl | 0]`` a joint and row, zeros past N, and each joint's
  largest norm.
* The filter's arithmetic: a float64 model of the per-joint split products
  (``qh.ch + ql.ch + qh.cl`` for the exact engine, ``qh.ch`` for bf16) lies
  within the derived bound of the exact dot (3.03 2^-16 sum_d |q_d c_d|; 0 for
  bf16), and its distance, and that of an fp32 model of the kernel (the
  tensor cores' sums rounded toward zero after every product, then
  ``d = fmaf(-w_j, |acc|, d)`` from W), within half of
  ``fused_knn.joint_margin`` of ``knn_topk_ref``'s: unit and non-unit
  quaternions (scales 0.5-2), zero rows, weighted and not.
* Filter, then the plain arithmetic: a model of the kernel's selection (64-row
  slabs, a best-KPAD list per lane over its own columns in ascending order,
  the threshold the k-th smallest distance in the quad's four lists plus
  the margin, marked columns held back in a queue and recomputed in the plain
  arithmetic when it would overflow, so the thresholds lag; and with no
  queue, the thresholds fresh at every slab) with
  tensor-core values perturbed adversarially by half the margin, merged by
  (distance, index), equals ``knn_topk_ref``'s bits for both engines, on
  corpora with rows whose distances lie closer together than the margin,
  and with duplicated rows.

The kernels themselves run on the card only (``chip_smoke.py`` holds them to
``knn_topk_ref`` and the pack to ``pack_joint_ref`` there).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posendf_torch.ops import fused_knn  # noqa: E402
from posendf_torch.ops.knn import bf16_round  # noqa: E402
from posendf_torch.quat import JOINT_WEIGHTS  # noqa: E402

ENGINES = ["vpu", "mxu_bf16"]
SPLIT_REL = {"vpu": 3.03 * 2.0 ** -16, "mxu_bf16": 0.0}
BIG, IBIG = float(torch.finfo(torch.float32).max), 2 ** 31 - 1
HELD = 12      # marked columns a thread holds back (csrc/knn_kernels.cu kJPend)


def _poses(rng, n, scaled=False, zeros=0):
    q = rng.normal(size=(n, 21, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    if scaled:
        q *= rng.uniform(0.5, 2.0, size=(n, 21, 1)).astype(np.float32)
    q[:zeros] = 0.0
    return torch.from_numpy(q)


def _operands(seed, n_corpus, n_query, weighted, dot_impl, scaled=False, duplicate=False,
              near=0):
    """Queries (the first half rows of the corpus) and corpus rows; ``near``:
    that many rows near each of queries 12..19 (noise of 2e-4..4e-3, so their
    distances to those queries lie closer together than the margin), the
    corpus shuffled so that they fall in many slabs."""
    rng = np.random.default_rng(seed)
    c = _poses(rng, n_corpus, scaled, zeros=2)
    q = torch.cat([c[:n_query // 2], _poses(rng, n_query - n_query // 2, scaled, zeros=1)])
    if near:
        base = c[12:20].repeat_interleave(near, 0)
        noise = rng.normal(size=base.shape) * rng.uniform(2e-4, 4e-3, size=(len(base), 1, 1))
        x = base + torch.from_numpy(noise.astype(np.float32))
        c = torch.cat([c, x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)])
        c = c[torch.from_numpy(rng.permutation(len(c)))]
    if duplicate:
        c = torch.cat([c, c])      # row j + n duplicates row j
    w = JOINT_WEIGHTS.numpy() if weighted else None
    qf, cf, wj, _ = fused_knn.kernel_operands(q, c, w, dot_impl)
    return qf, cf, wj


def _plain_all(qf, cf, wj, dot_impl):
    """Every distance as the plain version computes it, (Q, N)."""
    d, i = fused_knn.knn_topk_ref(qf, cf, cf.shape[0], weights=wj, dot_impl=dot_impl)
    return torch.empty_like(d).scatter_(1, i, d)


def _splits(x, dot_impl):
    """The filter's bf16 parts of q (A) or c (B) as float64: (hi, lo); the
    bf16 engine's A has no lo part."""
    hi = bf16_round(x)
    lo = bf16_round(x - hi)
    return hi.double(), lo.double()


@pytest.mark.parametrize("n", [1, 127, 128, 129, 20_000])
def test_joint_pack_reads_back_to_the_bf16_groups(n):
    cf = _poses(np.random.default_rng(n), n, scaled=True, zeros=min(n, 3)).reshape(n, 84)
    b, cmax = fused_knn.pack_joint_ref(cf)
    b = b.numpy()
    rows = fused_knn.JOINT_SLAB_ROWS
    slabs = -(-n // rows)
    assert b.dtype == np.uint8 and b.size == slabs * fused_knn.JOINT_SLAB_BYTES
    # value e (0..15) of joint j's group of row r: byte 2 e of the group, in
    # 16-byte chunk ch = 2 e // 16, stored at chunk ch ^ ((r % 64) // 4 % 2)
    r = np.arange(slabs * rows)[:, None, None]
    j = np.arange(21)[None, :, None]
    byte = 2 * np.arange(16)[None, None, :]
    rr, ch = r % rows, byte // 16
    off = ((r // rows) * fused_knn.JOINT_SLAB_BYTES + j * rows * 32 + rr * 32
           + ((ch ^ ((rr // 4) % 2)) * 16) + byte % 16)
    u16 = (b[off].astype(np.uint16) | (b[off + 1].astype(np.uint16) << 8)).astype(np.int16)
    vals = torch.from_numpy(u16).view(torch.bfloat16).float()          # (rows, 21, 16)
    hi = bf16_round(cf).view(n, 21, 4)
    lo = bf16_round(cf - bf16_round(cf)).view(n, 21, 4)
    assert torch.equal(vals[:n, :, 0:4], hi) and torch.equal(vals[:n, :, 4:8], hi)
    assert torch.equal(vals[:n, :, 8:12], lo)
    assert bool((vals[:n, :, 12:] == 0).all()) and bool((vals[n:] == 0).all())
    assert torch.equal(cmax, torch.linalg.vector_norm(cf.view(n, 21, 4), dim=2).amax(0))


def _toward_zero(x: np.ndarray) -> np.ndarray:
    """float64 values rounded to fp32 toward zero."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def _fma32(a, b, c):
    """fp32 fmaf: the exact a b + c (fp32 products are exact in float64),
    rounded once."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("dot_impl", ENGINES)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("scaled", [False, True])
def test_split_products_within_the_margin(dot_impl, weighted, scaled):
    qf, cf, wj = _operands(3 + 2 * weighted + scaled, 300, 40, weighted, dot_impl, scaled)
    Q, N = qf.shape[0], cf.shape[0]
    qh, ql = _splits(qf, dot_impl)
    ch, cl = _splits(cf, dot_impl)
    # the A and B groups: [qh | ql | qh | 0] or [qh | 0 | 0 | 0], and [ch | ch | cl | 0]
    if dot_impl == "mxu_bf16":
        a_parts = (qh, torch.zeros_like(qh), torch.zeros_like(qh))
        q_op, c_op = qh, ch            # the bf16 engine's operands: its products are exact
    else:
        a_parts = (qh, ql, qh)
        q_op, c_op = qf.double(), cf.double()
    q4, c4 = q_op.view(Q, 1, 21, 4), c_op.view(1, N, 21, 4)
    exact = (q4 * c4).sum(-1)                                          # (Q, N, 21)
    p_abs = (q4 * c4).abs().sum(-1)
    terms = [a.view(Q, 1, 21, 4) * b.view(1, N, 21, 4) for a, b in zip(a_parts, (ch, ch, cl))]
    model = sum(t.sum(-1) for t in terms)
    assert bool(((model - exact).abs() <= SPLIT_REL[dot_impl] * p_abs).all())

    w = torch.as_tensor(wj, dtype=torch.float64)
    W = float(w.sum())
    d_model = W - (w * model.abs()).sum(-1)                            # (Q, N), float64
    ref = _plain_all(qf, cf, wj, dot_impl).double()
    _, cmax = fused_knn.pack_joint_ref(cf)
    half = fused_knn.joint_margin(qf, cmax, wj, dot_impl)[:, None] / 2
    assert bool(((d_model - ref).abs() <= half).all())

    # the kernel's fp32 arithmetic: tensor-core sums of the 16 products of a
    # group rounded toward zero at every step, then the FMA chain from W
    prods = np.concatenate([t.numpy() for t in terms] + [np.zeros_like(terms[0].numpy())], -1)
    acc = np.zeros(prods.shape[:-1], np.float32)
    for e in range(prods.shape[-1]):
        acc = _toward_zero(acc.astype(np.float64) + prods[..., e])
    d32 = np.full((Q, N), np.float32(W), np.float32)
    nw = -np.asarray(wj, np.float32)
    for jj in range(21):
        d32 = _fma32(np.full((Q, N), nw[jj], np.float32), np.abs(acc[..., jj]), d32)
    assert bool((np.abs(d32.astype(np.float64) - ref.numpy()) <= half.numpy()).all())


def _kernel_model(qf, cf, wj, k, S, dot_impl, held_max=HELD):
    """The selection of ``knn_joint_kernel`` on the CPU: per corpus range of
    64-row slabs and lane part p (columns 8 m + 2 p + {0, 1} of a slab), a
    best-KPAD list fed in ascending column order. A slab's marked columns,
    d_tc <= (the k-th smallest distance in the four lanes' lists) + margin, with
    d_tc the plain distance moved by half the margin against the answer (up
    for the true top k, down for the rest), wait in the lane's queue of
    ``held_max``; when a slab's marks would overflow it, the queue is entered first,
    in order (and the slab's marks at once if they alone overflow it), and
    at the range's end. A column enters with its plain distance if it comes
    before the list's last entry. Returns the merged first k."""
    Q, N = qf.shape[0], cf.shape[0]
    kpad = max(8, -(-k // 8) * 8)
    plain = _plain_all(qf, cf, wj, dot_impl)
    _, cmax = fused_knn.pack_joint_ref(cf)
    margin = fused_knn.joint_margin(qf, cmax, wj, dot_impl).float()
    _, want_i = fused_knn.knn_topk_ref(qf, cf, k, weights=wj, dot_impl=dot_impl)
    member = torch.zeros((Q, N), dtype=torch.bool).scatter_(1, want_i, True)
    d_tc = (plain + torch.where(member, 0.5, -0.5) * margin[:, None]).tolist()
    plain, margin = plain.tolist(), margin.tolist()
    rows = fused_knn.JOINT_SLAB_ROWS
    rng = -(-(-(-N // S)) // rows) * rows
    parts = fused_knn.joint_parts(N, S)
    out = []
    for q in range(Q):
        lists = []
        for s in range(S):
            start, stop = s * rng, min(N, (s + 1) * rng)
            lst = [[(BIG, IBIG)] * kpad for _ in range(4)]
            held = [[] for _ in range(4)]

            def enter(p, c):    # as the kernel: an equal distance never displaces
                if plain[q][c] < lst[p][-1][0]:
                    lst[p] = sorted(lst[p][:-1] + [(plain[q][c], c)])

            for base in range(start, stop, rows):
                thr = sorted(d for p in range(4) for d, _ in lst[p])[k - 1] + margin[q]
                for p in range(4):
                    marks = [c for m in range(8) for c in (base + 8 * m + 2 * p, base + 8 * m + 2 * p + 1)
                             if c < stop and d_tc[q][c] <= thr]
                    if len(held[p]) + len(marks) > held_max:
                        for c in held[p]:
                            enter(p, c)
                        held[p] = []
                    if len(marks) > held_max:
                        for c in marks:
                            enter(p, c)
                    else:
                        held[p] += marks
            for p in range(4):
                for c in held[p]:
                    enter(p, c)
                assert {c for _, c in lst[p] if c != IBIG} <= set(parts[4 * s + p].tolist())
            lists += [x for p in range(4) for x in lst[p]]
        out.append(sorted(lists)[:k])
    return (torch.tensor([[d for d, _ in r] for r in out], dtype=torch.float32),
            torch.tensor([[c for _, c in r] for r in out], dtype=torch.int64))


@pytest.mark.parametrize("dot_impl", ENGINES)
@pytest.mark.parametrize("k", [1, 5, 8, 32])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("held_max", [0, HELD])
def test_filter_then_plain_merges_to_the_plain_topk(dot_impl, k, splits, dup, held_max):
    qf, cf, wj = _operands(11 + k + splits, 304, 40, k % 2 == 1, dot_impl, duplicate=dup,
                           near=10)
    N = cf.shape[0]
    parts = fused_knn.joint_parts(N, splits)
    assert len(parts) == 4 * splits
    assert torch.equal(torch.sort(torch.cat(parts)).values, torch.arange(N))
    got_d, got_i = _kernel_model(qf, cf, wj, k, splits, dot_impl, held_max)
    want_d, want_i = fused_knn.knn_topk_ref(qf, cf, k, weights=wj, dot_impl=dot_impl)
    assert torch.equal(got_d, want_d) and torch.equal(got_i, want_i)
    if dup and k >= 2:      # a query that is corpus row j finds j, then its copy
        for i in range(2, 12):            # queries 0, 1 are zero rows
            same = torch.nonzero((cf == qf[i]).all(dim=1)).flatten()
            assert len(same) == 2 and same[1] == same[0] + N // 2
            assert torch.equal(got_i[i, :2], same)
