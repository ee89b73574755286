"""Geodesic top-k in hand-written CUDA kernels.

Port of ``posendf_tpu/ops/fused_knn.py::_knn_kernel`` (``fused_geodesic_topk``).
The kernels are in ``csrc/knn_kernels.cu``. Each engine writes best-k lists
of parts of the corpus, and ``posendf_knn_merge`` merges each query's lists.
Every comparison orders by (distance, index), so the result does not depend
on how the corpus was split and exact ties come lowest index first, as in
``ops/knn.py``.

``dot_impl`` keeps the JAX package's names; on the card they mean:

  ``"vpu"``       exact fp32 distances, mean_j (1 - |<q_j, c_j>|) or the
                  joint-weighted sum;
  ``"mxu_bf16"``  the same with q and c rounded to bf16, products and sums in
                  fp32 (the approximation class of ``precision="default"``);
  ``"mxu_fast"``  NOT the distance: the hemisphere-canonicalized upper bound
                  ``W - q~ . (w * c~)`` of ``geodesic_bound_scores``, by the
                  3-pass bf16 split ``hi.hi' + hi.lo' + lo.hi'``, with the
                  weights folded into the corpus rows here; the prescreen of
                  :func:`fused_geodesic_topk_fast`, which reranks exactly;
  ``"mxu"``       not ported: the TPU kept it only for the record (slower than
                  ``"vpu"`` at the same exactness); it raises.

The exact and bf16 engines are one launch over S corpus ranges (a block of
128 queries, one thread each, a best-k list in registers) and the merge.
The bound engine is three: ``posendf_knn_pack`` splits the corpus into bf16
hi and lo parts in the wgmma layout (:func:`pack_bound_ref` is its plain
version) and takes its largest row norm, ``posendf_knn_bound`` runs the
three passes on the tensor cores (wgmma, 128 queries a CTA) as a filter,
recomputes each value that could enter a list in the plain version's
arithmetic, and keeps a best-k list per thread over its own columns (4
lists a query and range: :func:`bound_parts`); then the merge. So all three
engines return the plain version's bits.

A CUDA tensor goes through the kernels (or the call raises); a CPU tensor
goes through :func:`knn_topk_ref`, the kernels' plain version, which computes
the exact and bf16 engines in the kernel's order of operations and the bound
engine with three fp32 matrix products. Indices are int64.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from posendf_torch import _build
from posendf_torch.ops.fused_model import aligned_contiguous, stream_handle
from posendf_torch.ops.knn import bf16_round, geodesic_rerank, stream_topk

__all__ = ["fused_geodesic_topk", "fused_geodesic_topk_fast", "geodesic_bound_scores",
           "knn_topk_ref", "kernel_operands", "pack_bound_ref", "bound_parts", "LAUNCHES",
           "ENGINES", "KMAX", "BOUND_SLAB_ROWS", "BOUND_SLAB_BYTES"]

KMAX = 32                                              # the kernel's list holds <= 32
ENGINES = {"vpu": 0, "mxu_bf16": 1, "mxu_fast": 2}     # dot_impl -> the kernel's engine

# launches of the kNN kernels by engine (a call: the top-k launch and the
# merge; the bound engine's also the corpus pack) since the counts were last
# set to 0
LAUNCHES = dict.fromkeys(ENGINES, 0)
_KPAD = 8
_QTILE = 128              # queries per block (csrc/knn_kernels.cu kQTile, kBQ)
_SLAB = 64                # corpus rows per slab of the exact and bf16 engines (kSlab)
BOUND_SLAB_ROWS = 128     # corpus rows per slab of the bound engine (kBN)
BOUND_K = 96              # K = 84 padded to six bf16 k16 steps
BOUND_SLAB_BYTES = BOUND_SLAB_ROWS * 2 * BOUND_K * 2   # [hi | lo] bf16 rows: 48 KB
_LANE_PARTS = 4           # lists a query per range of the bound engine: one per lane % 4
_KERNEL_JOINTS = 21
_WAVES = 4                # blocks to aim for, in multiples of the SM count
_REF_TILE = 4096          # corpus rows a step of the plain version


def _kpad(k: int) -> int:
    return max(_KPAD, -(-k // 8) * 8)


def _canonicalize_flat(qf: torch.Tensor, J: int) -> torch.Tensor:
    """Flip each joint quaternion of (B, 4J) rows into the w >= 0 hemisphere
    (sign(0) treated as +). Geodesic distances are unchanged."""
    q = qf.reshape(qf.shape[0], J, 4)
    flip = torch.where(q[..., :1] < 0.0, -1.0, 1.0)
    return (q * flip).reshape(qf.shape[0], J * 4)


def _host_weights(weights, J: int) -> Optional[np.ndarray]:
    if weights is None:
        return None
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    w = np.asarray(weights, np.float32).reshape(-1)
    if len(w) != J:
        raise ValueError(f"weights must have {J} entries")
    return w


@functools.lru_cache(maxsize=32)
def _device_weights(values: tuple, device: str) -> torch.Tensor:
    """Joint weights on ``device``, made once: a copy from the host would
    make the host wait for the stream."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def kernel_operands(query_quats, corpus_quats, weights=None, dot_impl: str = "vpu"):
    """The kernel's operands, as the JAX wrapper prepares them: (Q, 4J)
    queries, (N, 4J) corpus rows (canonicalized, and the weights folded in,
    for ``"mxu_fast"``), the (J,) joint weights as a numpy array and the
    bound's W. Checks the weights and the engine's name."""
    Q, J, four = query_quats.shape
    N = corpus_quats.shape[0]
    w = _host_weights(weights, J)
    if dot_impl == "mxu":
        raise ValueError("dot_impl='mxu' is not ported: the TPU kept it only for the record, "
                         "slower than 'vpu' at the same exactness; use 'vpu'")
    if dot_impl not in ENGINES:
        raise ValueError(f"dot_impl must be vpu|mxu|mxu_bf16|mxu_fast, got {dot_impl!r}")
    if query_quats.device != corpus_quats.device:
        raise ValueError(f"queries on {query_quats.device} but the corpus on "
                         f"{corpus_quats.device}")
    qf = query_quats.reshape(Q, J * four).to(torch.float32)
    cf = corpus_quats.reshape(N, J * four).to(torch.float32)
    w_joint = (np.full(J, np.float32(1.0 / J), np.float32) if w is None else w)
    w_total = 1.0
    if dot_impl == "mxu_fast":
        # the bound is geodesic-invariant after canonicalization; the weights
        # fold into the corpus rows, so one product gives sum_j w_j dot_j
        qf = _canonicalize_flat(qf, J)
        cf = _canonicalize_flat(cf, J)
        if w is None:
            cf = cf * np.float32(1.0 / J)
        else:
            cf = cf * _device_weights(tuple(np.repeat(w, 4).tolist()), str(cf.device))[None, :]
            w_total = float(sum(float(x) for x in w))
    return qf, cf, w_joint, w_total


def knn_topk_ref(qf: torch.Tensor, cf: torch.Tensor, k: int, *, weights,
                 w_total: float = 1.0, dot_impl: str = "vpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel on its operands: (Q, 4J) queries,
    (N, 4J) corpus rows, (J,) joint weights (as :func:`kernel_operands`
    returns them). Returns (dists (Q, k), int64
    indices (Q, k)), ascending, equal distances lowest index first.

    Exact and bf16 engines: per joint the 4 products summed in d order, then
    1 - |.|, then the weighted sum in joint order, each operation rounded on
    its own, as the kernel computes them. Bound engine: ``w_total - ((hi.hi'
    + hi.lo') + lo.hi')`` by three fp32 matrix products of bf16 values."""
    J = qf.shape[1] // 4
    w = torch.as_tensor(weights, dtype=torch.float32, device=qf.device)
    if dot_impl == "mxu_fast":
        qh = bf16_round(qf)
        ql = bf16_round(qf - qh)
    elif dot_impl == "mxu_bf16":
        qf = bf16_round(qf)

    def dist(c):
        if dot_impl == "mxu_fast":
            ch = bf16_round(c)
            cl = bf16_round(c - ch)
            return w_total - ((qh @ ch.T + qh @ cl.T) + ql @ ch.T)
        if dot_impl == "mxu_bf16":
            c = bf16_round(c)
        geo = None
        for j in range(J):
            r = 4 * j
            dot = qf[:, r, None] * c[None, :, r]
            for d in range(1, 4):
                dot = dot + qf[:, r + d, None] * c[None, :, r + d]
            term = w[j] * (1.0 - torch.abs(dot))
            geo = term if geo is None else geo + term
        return geo

    return stream_topk(qf, cf, k, _REF_TILE, dist)


def pack_bound_ref(cf: torch.Tensor) -> torch.Tensor:
    """Plain version of the pack kernel (``posendf_knn_pack``): (N, 84) fp32
    corpus rows -> the bytes of ceil(N / 128) slabs (uint8). Each row is
    ``[hi | lo]``, hi = bf16(x) and lo = bf16(x - hi) each padded with zeros
    from K = 84 to 96 (192 bf16, three 128-byte lines); a slab is three
    128-row tiles, one a line, in the K-major 128-byte swizzle
    (``csrc/hopper.cuh``): 16-byte chunk c of row r at chunk c ^ (r % 8) of
    its line. Rows past N are zeros."""
    N, D = cf.shape
    slabs = -(-N // BOUND_SLAB_ROWS)
    hi = cf.to(torch.bfloat16)
    lo = (cf - hi.to(torch.float32)).to(torch.bfloat16)
    rows = torch.zeros((slabs * BOUND_SLAB_ROWS, 2, BOUND_K), dtype=torch.bfloat16,
                       device=cf.device)
    rows[:N, 0, :D] = hi
    rows[:N, 1, :D] = lo
    # (slab, row, line, chunk, 8 values); chunk c' of a row's stored line is chunk c' ^ (row % 8)
    rows = rows.view(slabs, BOUND_SLAB_ROWS, 3, 8, 8)
    r8 = torch.arange(BOUND_SLAB_ROWS, device=cf.device) % 8
    src = torch.arange(8, device=cf.device)[None, :] ^ r8[:, None]
    out = rows.gather(3, src[None, :, None, :, None].expand(rows.shape))
    return out.permute(0, 2, 1, 3, 4).contiguous().view(torch.uint8).reshape(-1)


def bound_parts(N: int, S: int):
    """The parts of the corpus whose best-k lists the bound engine writes, in
    the partial buffer's order: for range s (ceil(N / S) rows rounded up to
    whole slabs, the last one the rest) and lane part p (a thread's lane %
    4), the rows of range s whose index % 8 is 2 p or 2 p + 1 (a thread's
    accumulator columns). A list of index arrays, 4 S of them."""
    rng = -(-(-(-N // S)) // BOUND_SLAB_ROWS) * BOUND_SLAB_ROWS
    idx = torch.arange(N)
    parts = []
    for s in range(S):
        r = idx[s * rng:min(N, (s + 1) * rng)]
        parts += [r[(r % 8) // 2 == p] for p in range(_LANE_PARTS)]
    return parts


def _default_splits(Q: int, N: int, device: torch.device) -> int:
    """Corpus ranges S so that ceil(Q / 128) x S blocks fill the card's SMs
    about four times over."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    qtiles = -(-Q // _QTILE)
    return max(1, min(-(-_WAVES * sms // qtiles), -(-N // _SLAB)))


def _bound_splits(Q: int, N: int, device: torch.device) -> int:
    """Corpus ranges S of the bound engine: as few as fill the SMs once,
    ceil(Q / 128) x S CTAs of one an SM. Every range costs each thread's
    lists a filling (about KPAD ln(rows / KPAD) entries, each recomputed in
    the plain arithmetic), so more ranges than the card needs cost time."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    qtiles = -(-Q // _QTILE)
    return max(1, min(sms // qtiles, -(-N // BOUND_SLAB_ROWS)))


def _launch(qf, cf, k, w_joint, w_total, dot_impl, splits=None):
    """The launches on :func:`kernel_operands`' output. ``splits``: the
    number of corpus ranges S (default: enough blocks to fill the card); the
    result does not depend on it."""
    Q, D = qf.shape
    N = cf.shape[0]
    if D != 4 * _KERNEL_JOINTS:
        raise ValueError(f"the kNN kernel takes {_KERNEL_JOINTS} joints, got {D // 4}")
    qf, cf = aligned_contiguous(qf), aligned_contiguous(cf)
    bound = dot_impl == "mxu_fast"
    if splits is None:
        S = (_bound_splits if bound else _default_splits)(Q, N, qf.device)
    else:
        S = int(splits)
    if S < 1:
        raise ValueError(f"splits must be >= 1, got {S}")
    kpad = _kpad(k)
    parts = _LANE_PARTS * S if bound else S
    part_d = torch.empty((parts, Q, kpad), dtype=torch.float32, device=qf.device)
    part_i = torch.empty((parts, Q, kpad), dtype=torch.int32, device=qf.device)
    dists = torch.empty((Q, k), dtype=torch.float32, device=qf.device)
    idx = torch.empty((Q, k), dtype=torch.int64, device=qf.device)
    lib = _build.library("knn")
    stream = stream_handle(qf)
    if bound:
        packed = torch.empty(lib.posendf_knn_bound_bytes(N), dtype=torch.uint8, device=qf.device)
        cmax = torch.zeros(1, dtype=torch.float32, device=qf.device)   # the largest row norm
        _build.check(lib.posendf_knn_pack(cf.data_ptr(), N, packed.data_ptr(), cmax.data_ptr(),
                                          stream), "posendf_knn_pack", "knn")
        LAUNCHES[dot_impl] += 1
        _build.check(lib.posendf_knn_bound(qf.data_ptr(), Q, packed.data_ptr(), cmax.data_ptr(),
                                           N, float(w_total), kpad, S, part_d.data_ptr(),
                                           part_i.data_ptr(), stream), "posendf_knn_bound", "knn")
    else:
        w_dev = _device_weights(tuple(w_joint.tolist()), str(qf.device))
        _build.check(lib.posendf_knn_partial(qf.data_ptr(), Q, cf.data_ptr(), N, w_dev.data_ptr(),
                                             ENGINES[dot_impl], kpad, S, part_d.data_ptr(),
                                             part_i.data_ptr(), stream),
                     "posendf_knn_partial", "knn")
    LAUNCHES[dot_impl] += 1
    _build.check(lib.posendf_knn_merge(part_d.data_ptr(), part_i.data_ptr(), parts, Q, kpad, k,
                                       dists.data_ptr(), idx.data_ptr(), stream),
                 "posendf_knn_merge", "knn")
    LAUNCHES[dot_impl] += 1
    return dists, idx


def fused_geodesic_topk(query_quats: torch.Tensor, corpus_quats: torch.Tensor, k: int, *,
                        weights=None, dot_impl: str = "vpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Geodesic top-k of (Q, J, 4) queries over (N, J, 4) corpus poses:
    (dists (Q, k), int64 indices (Q, k)), ascending, k <= 32.

    ``weights``: (J,) host joint weights (numpy or a tensor), or None for
    the mean. ``dot_impl``: the engine (module docstring); under
    ``"mxu_fast"`` the returned values are the upper bound, not the
    distance."""
    if k > KMAX:
        raise ValueError(f"fused path supports k <= {KMAX}, got {k}")
    if corpus_quats.shape[0] < k:
        raise ValueError(f"top-k needs a corpus of at least k={k} rows, "
                         f"got {corpus_quats.shape[0]}")
    qf, cf, w_joint, w_total = kernel_operands(query_quats, corpus_quats, weights, dot_impl)
    if qf.device.type == "cpu":
        return knn_topk_ref(qf, cf, k, weights=w_joint, w_total=w_total, dot_impl=dot_impl)
    if qf.device.type != "cuda":
        raise ValueError(f"the kNN search takes tensors on the CPU or a CUDA device, "
                         f"got {qf.device}")
    return _launch(qf, cf, k, w_joint, w_total, dot_impl)


def geodesic_bound_scores(query_quats: torch.Tensor, corpus_quats: torch.Tensor,
                          weights=None) -> torch.Tensor:
    """The ``"mxu_fast"`` engine's prescreen bound as one fp32 product:
    (Q, N) scores ``W - q~ @ (w * c~)^T`` of the hemisphere-canonicalized
    poses, >= the geodesic distance, equal where every canonicalized
    per-joint dot is >= 0."""
    Q, J, _ = query_quats.shape
    N = corpus_quats.shape[0]
    qf = _canonicalize_flat(query_quats.reshape(Q, J * 4).to(torch.float32), J)
    cf = _canonicalize_flat(corpus_quats.reshape(N, J * 4).to(torch.float32), J)
    w = _host_weights(weights, J)
    if w is not None:
        cf = cf * torch.from_numpy(np.repeat(w, 4)).to(cf.device)[None, :]
        w_total = float(w.sum())
    else:
        cf = cf * np.float32(1.0 / J)
        w_total = 1.0
    return w_total - qf @ cf.T


def fused_geodesic_topk_fast(query_quats: torch.Tensor, corpus_quats: torch.Tensor, k: int, *,
                             prescreen_k: Optional[int] = None,
                             weights=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage exact-metric top-k: the ``"mxu_fast"`` bound prescreens
    ``prescreen_k`` (default ``max(2k, 8)``) candidates, then
    ``ops/knn.py::geodesic_rerank`` reranks them with the exact distance.
    Exact wherever the true top-k survives the prescreen, which holds on
    pose corpora (``data/prepare.py::probe_fast_safety`` measures it); the
    returned distances are always the exact metric of the returned rows."""
    if prescreen_k is None:
        prescreen_k = max(2 * k, _KPAD)
    if k > prescreen_k:
        raise ValueError(f"k={k} > prescreen_k={prescreen_k}")
    prescreen_k = max(k, min(prescreen_k, corpus_quats.shape[0]))
    w = _host_weights(weights, query_quats.shape[1])
    _, cand = fused_geodesic_topk(query_quats, corpus_quats, prescreen_k, weights=w,
                                  dot_impl="mxu_fast")
    w_dev = None if w is None else _device_weights(tuple(w.tolist()), str(query_quats.device))
    return geodesic_rerank(query_quats, corpus_quats, cand, k, w_dev)
