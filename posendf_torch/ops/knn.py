"""Exact brute-force kNN: the faiss replacement, in plain PyTorch.

Port of ``posendf_tpu/ops/knn.py`` (XLA there, so plain tensor code here):
exact L2 top-k over a dense corpus, the exact quaternion-geodesic and
per-joint-L2 top-k, and the re-ranks of a candidate set. Each search streams
the corpus in tiles and keeps a running best-k, so no (Q, N) matrix is ever
made. These are the exact oracles of the kNN kernel (``ops/fused_knn.py``).

Order: the k smallest come ascending, equal values lowest index first, as
``lax.top_k`` orders them and the JAX scan's ``[best, tile]`` concatenation
keeps across tiles. ``torch.topk`` promises no order among equal values (and
its CPU and CUDA versions differ), so every selection goes through
:func:`smallest_k`, a stable sort.

``precision``: ``"highest"`` is true fp32 (with TF32 off for matrix
products, ``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's
default). ``"default"`` and ``"high"`` round the inputs of the distance
products to bf16 and sum in fp32: the approximation class of the TPU's
single-pass bf16, and the arithmetic of the kNN kernel's bf16 engine.
Indices are int64 (the JAX package returns int32).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "smallest_k", "stream_topk", "bf16_round", "l2_topk", "geodesic_topk", "euclidean_topk",
    "geodesic_rerank", "euclidean_rerank",
]


def _check_k(k: int, n: int) -> None:
    """A corpus smaller than k is an error: unfilled top-k slots would keep
    sentinel values and corrupt the labels downstream."""
    if n < k:
        raise ValueError(f"top-k needs a corpus of at least k={k} rows, got {n}")


def _clamp_tile(corpus_tile: int, k: int, n: int) -> int:
    """Shrink the streaming tile to the corpus size (rounded up to 128), with
    a floor of max(k, 128)."""
    fitted = -(-n // 128) * 128
    return max(min(corpus_tile, fitted), k, 128)


def smallest_k(values: torch.Tensor, k: int,
               index: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest along the last axis, ascending, equal values in the
    order of their positions (``lax.top_k``'s order). Returns (values,
    ``index`` at those positions, or the positions themselves)."""
    v, order = torch.sort(values, dim=-1, stable=True)
    order = order[..., :k]
    return v[..., :k], order if index is None else index.gather(-1, order)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bf16 value (ties to even), kept in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _operands(precision: str):
    if precision == "highest":
        return lambda x: x
    if precision in ("default", "high"):
        return bf16_round
    raise ValueError(f"precision must be highest|high|default, got {precision!r}")


def stream_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int, corpus_tile: int, tile_dist):
    """Running best-k over corpus tiles: each tile's distances (Q, T) from
    ``tile_dist(tile)`` are merged with the best so far by one stable sort of
    ``[best, tile]``, whose indices are ascending among equal values."""
    N = corpus.shape[0]
    _check_k(k, N)
    tile = _clamp_tile(corpus_tile, k, N)
    Q = queries.shape[0]
    best_d = queries.new_empty((Q, 0))
    best_i = torch.empty((Q, 0), dtype=torch.int64, device=queries.device)
    for start in range(0, N, tile):
        d = tile_dist(corpus[start:start + tile])
        col = torch.arange(start, start + d.shape[1], device=queries.device).expand(Q, -1)
        best_d, best_i = smallest_k(torch.cat([best_d, d], dim=1), k,
                                    torch.cat([best_i, col], dim=1))
    return best_d, best_i


def l2_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int, corpus_tile: int = 32768,
            precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k smallest squared-L2 distances of (Q, D) queries to (N, D) rows:
    (dists (Q, k), indices (Q, k)), ascending (faiss IndexFlatL2 semantics)."""
    cast = _operands(precision)
    q_sq = torch.sum(queries * queries, dim=-1, keepdim=True)
    qc = cast(queries)

    def dist(tile):
        c_sq = torch.sum(tile * tile, dim=-1)[None, :]
        return q_sq + c_sq - 2.0 * torch.matmul(qc, cast(tile).T)

    return stream_topk(queries, corpus, k, corpus_tile, dist)


def _per_joint_dots(query_quats: torch.Tensor, tile: torch.Tensor, precision: str) -> torch.Tensor:
    """(Q, J, 4) x (T, J, 4) -> per-joint dots in (J, Q, T) layout, the 4
    products summed in d order."""
    cast = _operands(precision)
    q = cast(query_quats).permute(1, 2, 0)   # (J, 4, Q)
    c = cast(tile).permute(1, 2, 0)          # (J, 4, T)
    acc = q[:, 0, :, None] * c[:, 0, None, :]
    for d in range(1, 4):
        acc = acc + q[:, d, :, None] * c[:, d, None, :]
    return acc


def _joint_reduce(per_joint: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """(J, Q, T) -> (Q, T): the mean over joints, or the weighted sum in fp32."""
    if weights is None:
        return per_joint.mean(dim=0)
    return torch.einsum("jqn,j->qn", per_joint, weights.to(per_joint))


def geodesic_topk(query_quats: torch.Tensor, corpus_quats: torch.Tensor, k: int,
                  corpus_tile: int = 8192, weights: Optional[torch.Tensor] = None,
                  precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact geodesic top-k over the whole corpus, no candidate pre-filter:
    d(q, c) = mean_j (1 - |<q_j, c_j>|), or the joint-weighted sum."""

    def dist(tile):
        return _joint_reduce(1.0 - torch.abs(_per_joint_dots(query_quats, tile, precision)),
                             weights)

    return stream_topk(query_quats, corpus_quats, k, corpus_tile, dist)


def euclidean_topk(query_quats: torch.Tensor, corpus_quats: torch.Tensor, k: int,
                   corpus_tile: int = 8192, weights: Optional[torch.Tensor] = None,
                   precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-joint-L2 top-k (the reference's ``euc`` metric): mean over
    joints of ||q_j - c_j||, or the joint-weighted sum, with the per-joint
    squares from |a|^2 + |b|^2 - 2<a, b>."""
    q_sq = torch.sum(query_quats * query_quats, dim=-1).T   # (J, Q)

    def dist(tile):
        dots = _per_joint_dots(query_quats, tile, precision)
        c_sq = torch.sum(tile * tile, dim=-1).T              # (J, T)
        sq = torch.clamp_min(q_sq[:, :, None] + c_sq[:, None, :] - 2.0 * dots, 0.0)
        return _joint_reduce(torch.sqrt(sq + 1e-24), weights)

    return stream_topk(query_quats, corpus_quats, k, corpus_tile, dist)


def geodesic_rerank(query_quats: torch.Tensor, corpus_quats: torch.Tensor,
                    cand_idx: torch.Tensor, k: int,
                    weights: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank (Q, C) candidate indices by the geodesic distance; returns the
    k smallest (dists (Q, k), corpus indices (Q, k))."""
    _check_k(k, cand_idx.shape[1])
    cand = corpus_quats[cand_idx.long()]                          # (Q, C, J, 4)
    per_joint = 1.0 - torch.abs(torch.sum(query_quats[:, None] * cand, dim=-1))
    if weights is not None:
        geo = torch.sum(weights.to(per_joint)[None, None, :] * per_joint, dim=-1)
    else:
        geo = per_joint.mean(dim=-1)
    return smallest_k(geo, k, cand_idx.long())


def euclidean_rerank(query_quats: torch.Tensor, corpus_quats: torch.Tensor,
                     cand_idx: torch.Tensor, k: int,
                     weights: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank (Q, C) candidates by the per-joint-L2 metric; returns the k
    smallest (dists, corpus indices)."""
    _check_k(k, cand_idx.shape[1])
    cand = corpus_quats[cand_idx.long()]
    diff = query_quats[:, None] - cand
    per_joint = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-24)   # (Q, C, J)
    if weights is not None:
        d = torch.sum(weights.to(per_joint)[None, None, :] * per_joint, dim=-1)
    else:
        d = per_joint.mean(dim=-1)
    return smallest_k(d, k, cand_idx.long())
