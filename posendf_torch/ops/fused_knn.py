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

Every engine is three launches on the card: a pack of the corpus, the
top-k over S corpus ranges (a wgmma kernel whose tensor-core values
filter), and the merge (``posendf_knn_merge``).

* The exact and bf16 engines (``posendf_knn_pack_joint``,
  ``posendf_knn_joint``): the pack stores each corpus row as 21 bf16 k16
  groups ``[ch_j | ch_j | cl_j | 0]`` in the wgmma layout
  (:func:`pack_joint_ref` is its plain version) and takes each joint's
  largest norm; the top-k runs one bf16 ``wgmma`` step a joint (queries
  ``[qh | ql | qh | 0]`` for the exact engine, ``[qh | 0 | 0 | 0]`` for
  bf16) and ``d -= w_j |dot_j|`` on the CUDA cores, marks every column whose
  value lies within :func:`joint_margin` of the k-th smallest distance its
  query's lists hold, and recomputes each marked column in the plain
  version's arithmetic, which alone enters the lists. What bounds them on
  an H100: the 21 FFMA a pair of the epilogue (2.69 ms at 4,096 x 2^20),
  above the products on the tensor cores (three split products a pair,
  2.19 ms, for the exact engine; one, 0.73 ms, for bf16); measured, the
  epilogue with its per-slab tests sets the pace (``python -m
  posendf_torch.ops.breakdown knn``). The
  fp32 CUDA-core design it replaced took ~10 issue slots a joint and pair.
* The bound engine (``posendf_knn_pack``, ``posendf_knn_bound``): the pack
  splits the corpus into bf16 hi and lo parts in the wgmma layout
  (:func:`pack_bound_ref`) and takes its largest row norm; the top-k runs
  the three passes of the K = 84 product on the tensor cores as a filter
  and recomputes each value that could enter a list in the plain version's
  arithmetic.

Both top-k kernels keep a best-k list per thread over its own columns (4
lists a query and range: :func:`joint_parts`, :func:`bound_parts`), so all
three engines return the plain version's bits.

A CUDA tensor goes through the kernels (or the call raises); a CPU tensor
goes through :func:`knn_topk_ref`, the kernels' plain version, which computes
the exact and bf16 engines in the kernel's order of operations and the bound
engine with three fp32 matrix products. Indices are int64.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from posendf_torch import _build
from posendf_torch.ops.fused_model import aligned_contiguous, stream_handle
from posendf_torch.ops.knn import bf16_round, geodesic_rerank, stream_topk

__all__ = ["fused_geodesic_topk", "fused_geodesic_topk_fast", "geodesic_bound_scores",
           "knn_topk_ref", "kernel_operands", "pack_bound_ref", "bound_parts", "pack_joint_ref",
           "joint_parts", "joint_margin", "LAUNCHES", "ENGINES", "KMAX", "BOUND_SLAB_ROWS",
           "BOUND_SLAB_BYTES", "JOINT_SLAB_ROWS", "JOINT_SLAB_BYTES", "JOINT_MARGIN",
           "JOINT_MARGIN_W"]

KMAX = 32                                              # the kernel's list holds <= 32
ENGINES = {"vpu": 0, "mxu_bf16": 1, "mxu_fast": 2}     # dot_impl -> the kernel's engine

# launches of the kNN kernels by engine (a call: the corpus pack, the top-k
# launch and the merge) since the counts were last set to 0
LAUNCHES = dict.fromkeys(ENGINES, 0)
_KPAD = 8
_QTILE = 128              # queries per CTA (csrc/knn_kernels.cu kBQ, kJQ)
JOINT_SLAB_ROWS = 64      # corpus rows per slab of the exact and bf16 engines (kJN)
JOINT_SLAB_BYTES = 21 * JOINT_SLAB_ROWS * 32   # a bf16 k16 group a joint and row: 43,008
# the exact and bf16 engines' filter margin, JOINT_MARGIN[engine] S +
# JOINT_MARGIN_W sum_j |w_j| (csrc/knn_kernels.cu derives it; joint_margin)
JOINT_MARGIN = {"vpu": 1.1e-4, "mxu_bf16": 1.5e-5}
JOINT_MARGIN_W = 6e-6
BOUND_SLAB_ROWS = 128     # corpus rows per slab of the bound engine (kBN)
BOUND_K = 96              # K = 84 padded to six bf16 k16 steps
BOUND_SLAB_BYTES = BOUND_SLAB_ROWS * 2 * BOUND_K * 2   # [hi | lo] bf16 rows: 48 KB
_LANE_PARTS = 4           # lists a query per range of the bound engine: one per lane % 4
_KERNEL_JOINTS = 21
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


def pack_joint_ref(cf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the exact and bf16 engines' pack
    (``posendf_knn_pack_joint``): (N, 84) fp32 corpus rows -> (the bytes of
    ceil(N / 64) slabs (uint8), each joint's largest norm (21,) fp32). Row r,
    joint j is one bf16 k16 group ``[ch_j | ch_j | cl_j | 0]`` (ch = bf16(c),
    cl = bf16(c - ch)); a slab is 21 tiles of 64 rows x 32 bytes, one a
    joint, in the K-major 32-byte swizzle (``csrc/hopper.cuh``): 16-byte
    chunk c of row r at chunk c ^ ((r // 4) % 2). Rows past N are zeros."""
    N, D = cf.shape
    J = D // 4
    slabs = -(-N // JOINT_SLAB_ROWS)
    hi = cf.to(torch.bfloat16)
    lo = (cf - hi.to(torch.float32)).to(torch.bfloat16)
    g = torch.zeros((slabs * JOINT_SLAB_ROWS, J, 16), dtype=torch.bfloat16, device=cf.device)
    g[:N, :, 0:4] = g[:N, :, 4:8] = hi.view(N, J, 4)
    g[:N, :, 8:12] = lo.view(N, J, 4)
    # (slab, row, joint, chunk, 8 values); stored chunk c' of a row is chunk c' ^ ((row // 4) % 2)
    g = g.view(slabs, JOINT_SLAB_ROWS, J, 2, 8)
    sw = (torch.arange(JOINT_SLAB_ROWS, device=cf.device) // 4) % 2
    src = torch.arange(2, device=cf.device)[None, :] ^ sw[:, None]
    out = g.gather(3, src[None, :, None, :, None].expand(g.shape))
    packed = out.permute(0, 2, 1, 3, 4).contiguous().view(torch.uint8).reshape(-1)
    cmax = (torch.linalg.vector_norm(cf.view(N, J, 4), dim=2).amax(0) if N
            else cf.new_zeros(J))
    return packed, cmax


def joint_margin(qf: torch.Tensor, cmax: torch.Tensor, weights, dot_impl: str = "vpu"
                 ) -> torch.Tensor:
    """The exact and bf16 engines' filter margin of each query (float64,
    (Q,)), the plain version of the kernel's: JOINT_MARGIN[engine] S +
    JOINT_MARGIN_W sum_j |w_j|, S = sum_j |w_j| |q_j| cmax_j (q rounded to
    bf16 for ``"mxu_bf16"``); at least twice the largest difference between
    a tensor-core distance and the plain version's (``csrc/knn_kernels.cu``
    derives it)."""
    J = qf.shape[1] // 4
    q = bf16_round(qf) if dot_impl == "mxu_bf16" else qf
    w = torch.as_tensor(weights, dtype=torch.float64, device=qf.device).abs()
    norms = torch.linalg.vector_norm(q.view(-1, J, 4).double(), dim=2)
    S = norms @ (w * cmax.to(torch.float64))
    return JOINT_MARGIN[dot_impl] * S + JOINT_MARGIN_W * float(w.sum())


def _lane_parts(N: int, S: int, slab_rows: int):
    rng = -(-(-(-N // S)) // slab_rows) * slab_rows
    idx = torch.arange(N)
    parts = []
    for s in range(S):
        r = idx[s * rng:min(N, (s + 1) * rng)]
        parts += [r[(r % 8) // 2 == p] for p in range(_LANE_PARTS)]
    return parts


def bound_parts(N: int, S: int):
    """The parts of the corpus whose best-k lists the bound engine writes, in
    the partial buffer's order: for range s (ceil(N / S) rows rounded up to
    whole slabs, the last one the rest) and lane part p (a thread's lane %
    4), the rows of range s whose index % 8 is 2 p or 2 p + 1 (a thread's
    accumulator columns). A list of index arrays, 4 S of them."""
    return _lane_parts(N, S, BOUND_SLAB_ROWS)


def joint_parts(N: int, S: int):
    """The parts of the exact and bf16 engines' lists, as :func:`bound_parts`
    with their 64-row slabs. A list may hold fewer than its part's best
    rows: a column above the k-th smallest distance in the four lists of its
    query and range is not in the top k, and is dropped."""
    return _lane_parts(N, S, JOINT_SLAB_ROWS)


def _splits(Q: int, N: int, slab_rows: int, device: torch.device) -> int:
    """Corpus ranges S of the top-k kernels: as few as fill the SMs once,
    ceil(Q / 128) x S CTAs of one an SM. Every range costs each thread's
    lists a filling (about KPAD ln(rows / KPAD) entries, each recomputed in
    the plain arithmetic), so more ranges than the card needs cost time."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    qtiles = -(-Q // _QTILE)
    return max(1, min(sms // qtiles, -(-N // slab_rows)))


def _launch(qf, cf, k, w_joint, w_total, dot_impl, splits=None):
    """The launches on :func:`kernel_operands`' output. ``splits``: the
    number of corpus ranges S (default: enough CTAs to fill the card); the
    result does not depend on it."""
    Q, D = qf.shape
    N = cf.shape[0]
    if D != 4 * _KERNEL_JOINTS:
        raise ValueError(f"the kNN kernel takes {_KERNEL_JOINTS} joints, got {D // 4}")
    qf, cf = aligned_contiguous(qf), aligned_contiguous(cf)
    bound = dot_impl == "mxu_fast"
    rows = BOUND_SLAB_ROWS if bound else JOINT_SLAB_ROWS
    S = _splits(Q, N, rows, qf.device) if splits is None else int(splits)
    if S < 1:
        raise ValueError(f"splits must be >= 1, got {S}")
    kpad = _kpad(k)
    parts = _LANE_PARTS * S
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
        packed = torch.empty(lib.posendf_knn_joint_bytes(N), dtype=torch.uint8, device=qf.device)
        cmax = torch.zeros(_KERNEL_JOINTS, dtype=torch.float32, device=qf.device)
        _build.check(lib.posendf_knn_pack_joint(cf.data_ptr(), N, packed.data_ptr(),
                                                cmax.data_ptr(), stream),
                     "posendf_knn_pack_joint", "knn")
        LAUNCHES[dot_impl] += 1
        w_host = (ctypes.c_float * _KERNEL_JOINTS)(*(float(x) for x in w_joint))
        w_sum = float(np.float32(np.sum(w_joint, dtype=np.float64)))   # W, rounded once
        _build.check(lib.posendf_knn_joint(qf.data_ptr(), Q, cf.data_ptr(), packed.data_ptr(),
                                           cmax.data_ptr(), N, w_host, w_sum, ENGINES[dot_impl],
                                           k, kpad, S, part_d.data_ptr(), part_i.data_ptr(),
                                           stream), "posendf_knn_joint", "knn")
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
