"""Data manufacturing: AMASS sampling, noisy-pose generation, kNN labelling.

Port of ``posendf_tpu/data/prepare.py``. The host code (AMASS sampling,
corpus assembly, the noisy-query sampler) is a copy, numpy only, so the
same seed gives the same bytes; the search runs on the device:

  stage 1 ``sample_amass``: keep a random ~24% of the middle 80% of each raw
    AMASS clip (the reference's ``data/sample_poses.py``).
  stage 3 ``label_split`` / ``label_sequence``: draw noisy quaternion
    queries (sigma grid [0.01, 0.05, 0.1, 0.25, 0.5], the reference's
    ``data/create_data.py``) and label each with the mean geodesic distance
    to its k = 5 nearest poses of the split-wide corpus (the reference's
    faiss search + re-rank, ``data/prepare_traindata.py``).

The default search is the exact single-stage geodesic top-k. On the card it
is the kNN kernel (``ops/fused_knn.py``). ``precision="auto"`` picks the
bound-prescreen engine only on a device type where it is the faster one
(:data:`FAST_ENGINE_BACKENDS`, now none: on the card the exact engine is)
and where :func:`probe_fast_safety` finds it exact on this corpus;
elsewhere 'auto' is exact 'highest'. The corpus goes to the
device once per split, and each sequence's results stay there until every
batch is dispatched.
Multi-host fan-out is ``label_split(shard=(i, n))``: host i of n takes every
n-th sequence, restart-safe through the per-sequence skip guard.

``space="joints"`` searches candidates among the corpus's posed SMPL joint
positions (``_fk_joint_embedding``, the body model's forward kinematics),
then re-ranks them by the exact metric.

Sharded labelling (``mesh=``, a :class:`~posendf_torch.parallel.Mesh`):
every rank draws the same queries from the same ``rng``, labels its
contiguous share of each batch against the replicated corpus, and the
results are gathered back in rank order; no other collective. Under a mesh
the search is the kNN kernel wherever it applies (the JAX package keeps its
XLA scan under a mesh unless asked, a choice made for a relay-attached TPU;
on the card that would put the plain search on the main path). The kernel is
``knn_topk_ref``'s to the bit, so the labels are the one-device labels to
the bit. Only rank 0 writes ``label_split``'s files.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from posendf_torch.data.splits import AMASS_SPLITS

__all__ = [
    "sample_amass", "build_corpus", "NoiseSpec", "SMPL_LIMB_CHAINS", "quat_doublecover",
    "sample_noisy_queries", "probe_fast_safety", "FAST_ENGINE_BACKENDS", "resolve_knn_precision",
    "label_sequence", "label_split", "run_cli",
]

# --------------------------------------------------------------------------
# stage 1: raw AMASS -> per-sequence sampled pose files (host-side, IO bound)
# --------------------------------------------------------------------------

def sample_amass(
    raw_dir: str,
    out_dir: str,
    subsets: Sequence[str],
    keep_frac: float = 0.3,
    middle_frac: float = 0.8,
    seed: int = 0,
    skip_if_exists: bool = True,
) -> List[str]:
    """Subsample raw AMASS mocap clips into per-sequence pose files.

    Keeps ``keep_frac`` of the middle ``middle_frac`` of each clip (the
    reference's 0.3 * 0.8 heuristic, ``data/sample_poses.py:42-44``), writing
    ``pose_body`` (N, 63) (SMPL body joints 1..21), ``root_orient`` (N, 3)
    and ``betas``. Idempotent: skips existing outputs (the reference's
    restart guard, ``sample_poses.py:31-33``).
    """
    rng = np.random.default_rng(seed)
    written = []
    for subset in subsets:
        sub_dir = os.path.join(raw_dir, subset)
        if not os.path.isdir(sub_dir):
            continue
        for seq_dir in sorted(os.listdir(sub_dir)):
            seq_path = os.path.join(sub_dir, seq_dir)
            if not os.path.isdir(seq_path):
                continue
            for npz in sorted(glob.glob(os.path.join(seq_path, "*.npz"))):
                base = os.path.basename(npz)
                if "shape" in base or "stagei" in base or base.startswith("neutral"):
                    continue
                out_sub = os.path.join(out_dir, subset)
                os.makedirs(out_sub, exist_ok=True)
                out_path = os.path.join(out_sub, f"{seq_dir}_{base}")
                if skip_if_exists and os.path.exists(out_path):
                    written.append(out_path)
                    continue
                try:
                    with np.load(npz) as z:
                        if "poses" in z:
                            poses = np.asarray(z["poses"])      # (T, 156/72...)
                            pose_body = poses[:, 3:66]          # 21 body joints
                            root_orient = poses[:, :3]
                        elif "pose_body" in z:
                            pose_body = np.asarray(z["pose_body"])[:, :63]
                            root_orient = np.asarray(z.get("root_orient",
                                                           np.zeros((len(pose_body), 3))))
                        else:
                            continue
                        betas = np.asarray(z.get("betas", np.zeros(10)))
                except (OSError, ValueError, KeyError):
                    continue
                T = len(pose_body)
                if T < 10:
                    continue
                lo = int(T * (1 - middle_frac) / 2)
                hi = T - lo
                n_keep = max(1, int(keep_frac * (hi - lo)))
                idx = np.sort(rng.choice(np.arange(lo, hi), size=min(n_keep, hi - lo),
                                         replace=False))
                np.savez(
                    out_path,
                    pose_body=pose_body[idx].astype(np.float32),
                    root_orient=root_orient[idx].astype(np.float32),
                    betas=betas.astype(np.float32),
                )
                written.append(out_path)
    return written


# --------------------------------------------------------------------------
# corpus assembly + noisy query sampling
# --------------------------------------------------------------------------

def _to_quats(pose_body: np.ndarray) -> np.ndarray:
    """(N, 63) axis-angle -> (N, 21, 4) unit quaternions (host numpy math)."""
    aa = pose_body.reshape(-1, 21, 3).astype(np.float64)
    angle = np.linalg.norm(aa, axis=-1, keepdims=True)
    half = 0.5 * angle
    small = angle < 1e-6
    safe = np.where(small, 1.0, angle)
    s = np.where(small, 0.5 - angle * angle / 48.0, np.sin(half) / safe)
    return np.concatenate([np.cos(half), aa * s], axis=-1).astype(np.float32)


def _load_quats(path: str) -> np.ndarray:
    """A sampled sequence file as (N, 21, 4) quaternions: its ``pose_body``
    axis-angle converted, or its ``pose`` quaternions as they are."""
    with np.load(path) as z:
        key = "pose_body" if "pose_body" in z else "pose"
        arr = np.asarray(z[key])
    if arr.ndim == 3 and arr.shape[-1] == 4:
        return arr.astype(np.float32)
    return _to_quats(arr[:, :63])


def build_corpus(sampled_dir: str, subsets: Sequence[str]) -> Tuple[np.ndarray, List[str]]:
    """Concatenate every sampled sequence of the given subsets into one
    (N, 21, 4) quaternion corpus. Returns (corpus, file list)."""
    files = [
        f for f in sorted(glob.glob(os.path.join(sampled_dir, "*", "*.npz")))
        if os.path.basename(os.path.dirname(f)) in subsets
    ]
    chunks = [_load_quats(f) for f in files]
    if not chunks:
        raise FileNotFoundError(f"no sampled sequences under {sampled_dir} for {subsets}")
    return np.concatenate(chunks), files


@dataclass
class NoiseSpec:
    """Sigma grid of the reference noisy-query sampler
    (``data/create_data.py:51-52``), plus the structured-noise extension.

    ``structured_frac > 0`` diverts that fraction of each run's samples to
    limb-structured corruption: a random kinematic chain
    (``SMPL_LIMB_CHAINS``) gets per-joint gaussian quaternion noise at a
    sigma drawn from ``structured_sigma``, all other joints stay clean.
    Default 0.0 = the reference's sampler.
    """

    sigmas: Tuple[float, ...] = (0.01, 0.05, 0.1, 0.25, 0.5)
    distribution: Tuple[float, ...] = (0.2, 0.2, 0.2, 0.2, 0.2)
    structured_frac: float = 0.0
    structured_sigma: Tuple[float, float] = (0.3, 1.0)

    def counts(self, num_samples: int) -> np.ndarray:
        return np.rint(num_samples * np.asarray(self.distribution)).astype(np.int64)


# SMPL body-pose joint chains (body joint i = skeleton joint i+1): the
# corruption units of structured noise
SMPL_LIMB_CHAINS: Tuple[Tuple[int, ...], ...] = (
    (12, 15, 17, 19),    # left arm: collar, shoulder, elbow, wrist
    (13, 16, 18, 20),    # right arm
    (0, 3, 6, 9),        # left leg: hip, knee, ankle, foot
    (1, 4, 7, 10),       # right leg
    (2, 5, 8, 11, 14),   # spine1-3, neck, head
)


def quat_doublecover(quats: np.ndarray, samples: int,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Randomly negate ``samples`` joint quaternions so training data covers
    both hemispheres of the q == -q double cover (reference augmentation,
    ``data/create_data.py:22-27``)."""
    rng = rng or np.random.default_rng(0)
    out = quats.reshape(-1, 4).copy()
    idx = rng.integers(0, len(out), samples)
    out[idx] = -out[idx]
    return out.reshape(quats.shape)


def sample_noisy_queries(
    clean_quats: np.ndarray,
    num_samples: int,
    spec: NoiseSpec = NoiseSpec(),
    rng: Optional[np.random.Generator] = None,
    *,
    per_pose_noise: bool = False,
    runs: int = 1,
) -> np.ndarray:
    """Draw noisy queries: pick clean poses, add sigma * U[0,1) noise,
    renormalize each joint quaternion (``create_data.py:85-91``). Returns
    (runs * sum(counts), 21, 4) float32.

    The reference's quirk is kept on the default path: ONE (21, 4) uniform
    noise draw per sigma group, broadcast across all poses of the group
    (``create_data.py:88``); ``runs`` reproduces the reference's run loop
    (``prepare_traindata.py:45,104``), each run drawing
    ``counts(num_samples // runs)``. ``per_pose_noise=True`` draws
    independent noise per pose.
    """
    rng = rng or np.random.default_rng(0)
    if runs > 1 and num_samples % runs:
        raise ValueError(
            f"num_samples={num_samples} must divide evenly into runs={runs} "
            "(the reference draws equal-sized run batches, "
            "prepare_traindata.py:45) — truncating silently would return "
            "fewer queries than requested")
    out = []
    per_run = num_samples // runs if runs > 1 else num_samples
    n_struct = int(round(per_run * spec.structured_frac))
    n_grid = per_run - n_struct
    if n_struct == 0 and int(spec.counts(per_run).sum()) == 0:
        raise ValueError(
            f"num_samples={num_samples} over runs={runs} rounds every "
            "per-sigma count to zero — nothing to sample")
    if n_struct and n_grid > 0 and int(spec.counts(n_grid).sum()) == 0:
        raise ValueError(
            f"structured_frac={spec.structured_frac} leaves only {n_grid} "
            "grid samples per run, which rounds every per-sigma count to "
            "zero")
    for _ in range(runs):
        for sigma, n in zip(spec.sigmas, spec.counts(n_grid)):
            if n == 0:
                continue
            idx = rng.integers(0, len(clean_quats), n)
            shape = (n, 21, 4) if per_pose_noise else (21, 4)
            noisy = clean_quats[idx] + sigma * rng.random(shape, dtype=np.float32)
            noisy /= np.linalg.norm(noisy, axis=-1, keepdims=True)
            out.append(noisy.astype(np.float32))
        if n_struct:
            # ONE random limb chain per query gets per-joint gaussian noise
            # at a per-query sigma; rng is touched only when n_struct > 0
            idx = rng.integers(0, len(clean_quats), n_struct)
            base = clean_quats[idx].copy()
            chain_ids = rng.integers(0, len(SMPL_LIMB_CHAINS), n_struct)
            sig = rng.uniform(*spec.structured_sigma,
                              size=n_struct).astype(np.float32)
            for c, chain in enumerate(SMPL_LIMB_CHAINS):
                m = chain_ids == c
                if not m.any():
                    continue
                noise = rng.standard_normal(
                    (int(m.sum()), len(chain), 4)).astype(np.float32)
                base[np.ix_(m, np.asarray(chain))] += sig[m, None, None] * noise
            base /= np.linalg.norm(base, axis=-1, keepdims=True)
            out.append(base.astype(np.float32))
    return np.concatenate(out)


# --------------------------------------------------------------------------
# the bound engine's corpus-safety probe ('auto' engine selection)
# --------------------------------------------------------------------------

def _joint_weights_np() -> np.ndarray:
    from posendf_torch.quat import JOINT_WEIGHTS

    return JOINT_WEIGHTS.numpy()


# Device types on which the bound engine is the faster of the two engines
# that give exact labels, so that 'auto' may pick it (where the corpus-safety
# probe passes). None: on an H100 the exact engine, its per-joint products
# on the tensor cores (bf16 wgmma) as a filter, searches a 4,096 x
# 1,048,576 batch in less time than the bound engine's prescreen + exact
# rerank (fused_geodesic_topk_fast) gives the same labels, and the bound
# engine's time grows with the queries' noise where the exact engine's
# does not (chip_smoke.py phase 13 and python -m posendf_torch.ops.breakdown
# knn time both; PERF.md); on the CPU the bound engine is the slower one.
FAST_ENGINE_BACKENDS: frozenset = frozenset()


def probe_fast_safety(
    corpus_np: np.ndarray,      # (N, 21, 4)
    rng: Optional[np.random.Generator] = None,
    *,
    k: int = 5,
    weights: Optional[np.ndarray] = None,
    n_queries: int = 256,
    corpus_cap: int = 16384,
    margin: float = 0.05,
    spec: Optional[NoiseSpec] = None,
    device="cuda",
) -> dict:
    """Measure whether THIS corpus is safe for the bound-prescreen engine
    (``precision="fast"``), whose bound is tight only where the per-joint
    dots of canonicalized near pairs stay positive:

      * ``w_margin_frac``: fraction of joint quaternions within ``margin`` of
        the w = 0 canonicalization boundary (the bound's failure channel);
      * ``topk_overlap`` / ``label_mae``: bound-prescreen + exact rerank
        against the exact top-k on ``n_queries`` noisy queries over a
        <= ``corpus_cap``-row sample of the corpus, with the bound in plain
        fp32 (``ops/fused_knn.py::geodesic_bound_scores``).

    ``safe`` = w_margin_frac <= 0.02 AND topk_overlap >= 0.995. The search
    runs on ``device``: the card unless the caller asks for the CPU.
    """
    import torch

    from posendf_torch.field import resolve_device
    from posendf_torch.ops.fused_knn import geodesic_bound_scores
    from posendf_torch.ops.knn import geodesic_rerank, geodesic_topk, smallest_k

    device = resolve_device(device)
    rng = rng or np.random.default_rng(12345)
    spec = spec or NoiseSpec()
    N = len(corpus_np)
    if N > corpus_cap:
        sub = corpus_np[rng.choice(N, corpus_cap, replace=False)]
    else:
        sub = corpus_np
    k_eff = min(k, len(sub))
    queries = sample_noisy_queries(sub, n_queries, spec, rng, per_pose_noise=True)

    w_frac = float(np.mean(np.abs(np.concatenate([sub, queries])[..., 0]) < margin))

    q = torch.from_numpy(queries).to(device)
    c = torch.from_numpy(np.ascontiguousarray(sub)).to(device)
    w_dev = None if weights is None else torch.as_tensor(weights, dtype=torch.float32,
                                                         device=device)
    d_exact, i_exact = geodesic_topk(q, c, k=k_eff, weights=w_dev, precision="highest")
    scores = geodesic_bound_scores(q, c, weights=weights)
    prescreen_k = min(max(2 * k_eff, 8), len(sub))
    _, cand = smallest_k(scores, prescreen_k)
    d_fast, i_fast = geodesic_rerank(q, c, cand, k_eff, w_dev)

    ie, if_ = i_exact.cpu().numpy(), i_fast.cpu().numpy()
    overlap = float(np.mean([
        len(set(ie[r]) & set(if_[r])) / k_eff for r in range(len(ie))]))
    de, df = d_exact.cpu().numpy(), d_fast.cpu().numpy()
    mae = float(np.mean(np.abs(df - de)))
    scale = max(float(np.mean(de)), 1e-12)
    return {
        "safe": bool(w_frac <= 0.02 and overlap >= 0.995),
        "w_margin_frac": w_frac,
        "topk_overlap": overlap,
        "label_mae": mae,
        "label_mae_rel": mae / scale,
        "n_queries": int(len(queries)),
        "corpus_probe_rows": int(len(sub)),
        "k": int(k_eff),
    }


def resolve_knn_precision(
    precision: str,
    corpus_np: np.ndarray,
    *,
    k: int = 5,
    weighted: bool = False,
    metric: str = "geo",
    k_candidates: int = 0,
    space: str = "quat",
    fused=None,
    mesh=None,
    rng: Optional[np.random.Generator] = None,
    device="cuda",
    backend: Optional[str] = None,
    verbose: bool = True,
) -> Tuple[str, Optional[dict]]:
    """Resolve ``precision='auto'`` to a concrete engine with a measured
    corpus-safety probe; other values pass through unchanged.

    'auto' picks **fast** (bound prescreen + exact rerank) when that engine
    applies to this search (single-stage geodesic, k <= 8, fused not
    disabled, the corpus on a device type of :data:`FAST_ENGINE_BACKENDS`,
    where the bound engine is the faster one) AND :func:`probe_fast_safety`
    passes on this corpus; **highest** (exact) otherwise. Under a ``mesh``
    the fast engine applies only with ``fused=True``, as in the JAX
    package. ``device`` is
    where the corpus is searched (and the probe runs): the card unless the
    caller asks for the CPU;
    ``backend`` ("cuda" or "cpu") overrides its type in the eligibility
    test (tests).
    """
    if precision != "auto":
        return precision, None
    from posendf_torch.field import resolve_device

    if backend is None:
        backend = resolve_device(device).type
    applies = (metric == "geo" and space == "quat" and not k_candidates
               and k <= 8 and fused is not False and (mesh is None or fused is True))
    if not applies or backend not in FAST_ENGINE_BACKENDS:
        if verbose:
            why = (f"the bound engine is slower than the exact one on {backend}" if applies
                   else f"fast engine not applicable to this search (metric={metric}, "
                        f"space={space}, k_candidates={k_candidates}, k={k}, fused={fused}, "
                        f"sharded={mesh is not None})")
            print(f"knn auto: {why} -> exact 'highest'")
        return "highest", None
    w_np = _joint_weights_np() if weighted else None
    stats = probe_fast_safety(corpus_np, rng, k=k, weights=w_np, device=device)
    choice = "fast" if stats["safe"] else "highest"
    if verbose:
        print(f"knn auto probe: w-margin frac {stats['w_margin_frac']:.4f}, "
              f"top-{stats['k']} overlap {stats['topk_overlap']:.4f}, "
              f"label MAE {stats['label_mae']:.2e} "
              f"({100 * stats['label_mae_rel']:.2f}% of label scale) over "
              f"{stats['n_queries']} queries x "
              f"{stats['corpus_probe_rows']} rows -> "
              f"{'FAST (bound tight on this corpus)' if stats['safe'] else 'exact HIGHEST (bound not trustworthy here)'}")
    return choice, stats


# --------------------------------------------------------------------------
# stage 3: device-side labelling
# --------------------------------------------------------------------------

def _fk_joint_embedding(quats, body_model, batch: int = 8192):
    """(N, 21, 4) quaternions (numpy or a tensor) -> (N, 75) posed joint
    positions on the body model's device: the joint-space search embedding,
    Jtr[:, :25] as the reference indexes it (``prepare_traindata.py:42,147``;
    (N, 72) for a mesh without landmark vertices)."""
    import torch

    from posendf_torch.quat import quaternion_to_axis_angle

    quats = torch.as_tensor(quats, dtype=torch.float32)
    outs = []
    with torch.no_grad():
        for s in range(0, len(quats), batch):
            q = quats[s:s + batch].to(body_model.device)
            aa = quaternion_to_axis_angle(q).reshape(len(q), 63)
            j = body_model(pose_body=aa).Jtr[:, :25]
            outs.append(j.reshape(len(q), -1))
    return torch.cat(outs)


def label_sequence(
    seq_quats: np.ndarray,     # clean poses of the sequence (for query sampling)
    corpus,                    # (N, 21, 4): a tensor (searched where it lies) or numpy
    *,
    num_queries: int,
    k: int = 5,
    k_candidates: int = 0,
    metric: str = "geo",
    weighted: bool = False,
    query_batch: int = 4096,
    rng: Optional[np.random.Generator] = None,
    spec: NoiseSpec = NoiseSpec(),
    mesh=None,
    space: str = "quat",
    body_model=None,
    corpus_emb=None,
    corpus_np: Optional[np.ndarray] = None,
    precision: str = "highest",
    per_pose_noise: bool = False,
    runs: int = 1,
    fused: Optional[bool] = None,
    device="cuda",
) -> dict:
    """Label one sequence: noisy queries and their k nearest distances in
    the corpus. Returns ``{"pose", "dist", "nn_pose"}`` as numpy arrays.

    ``metric``: 'geo' (quaternion geodesic) or 'euc' (per-joint L2);
    ``weighted`` uses the joint-rank weights. ``k_candidates > 0`` selects
    the reference-shaped two-stage search (L2 candidates in quaternion
    space, then the exact metric's re-rank); 0 = exact single-stage top-k.

    ``space``: the candidate-search embedding. 'quat' searches the raw
    84-D quaternions; 'joints' runs ``body_model``'s forward kinematics and
    searches the posed joint positions (the reference's ``faiss_idx_np``
    index over ``joints[:, :25]``, ``prepare_traindata.py:50-58,147``: 75-D
    on a real SMPL mesh, 24 skeleton joints and the nose landmark; 72-D on a
    smaller mesh), ``k_candidates`` wide (500, the reference's width, when
    it is 0), then re-ranks by the exact metric.

    ``corpus``: a tensor is searched on its device; a numpy array is moved
    to ``device`` (the card unless the caller asks for the CPU).
    ``corpus_np``: its host copy, and ``corpus_emb`` its joint embedding,
    when the caller has them (``label_split`` makes each once a split).

    ``precision``: 'highest' (default) is exact fp32; 'default'/'high' round
    the distance products' inputs to bf16; 'fast' is the bound prescreen +
    exact rerank (``ops/fused_knn.py::fused_geodesic_topk_fast``) on the
    kernel path, and exact 'highest' where the kernel does not run (the
    caller's choice of ``fused=False`` or an ineligible search: 'fast'
    promises exact labels); 'auto' resolves to 'fast' or 'highest' with
    :func:`resolve_knn_precision`.

    ``fused``: None runs the kNN kernel exactly where it applies (the
    single-stage geodesic search, k <= 8, the corpus on a CUDA device);
    True asks for it (on a CPU tensor that is its plain version); False runs
    the streamed plain search of ``ops/knn.py``.

    ``mesh``: every rank draws the same queries (the same ``rng`` on every
    rank), searches its contiguous share of each query batch against the
    corpus on its own device, and gathers the results in rank order; every
    rank returns the whole result. A numpy corpus goes to the mesh's
    device. None (auto) ``fused`` runs the kernel wherever it applies, as on
    one device.
    """
    import torch

    from posendf_torch.field import resolve_device
    from posendf_torch.ops.fused_knn import fused_geodesic_topk, fused_geodesic_topk_fast
    from posendf_torch.ops.knn import (euclidean_rerank, euclidean_topk, geodesic_rerank,
                                       geodesic_topk, l2_topk)
    from posendf_torch.parallel.mesh import gather_rows, shard_rows

    if mesh is not None:
        device = mesh.device
    if space not in ("quat", "joints"):
        raise ValueError(f"space must be 'quat' or 'joints', got {space!r}")
    queries = sample_noisy_queries(seq_quats, num_queries, spec, rng,
                                   per_pose_noise=per_pose_noise, runs=runs)
    if not isinstance(corpus, torch.Tensor):
        corpus = torch.from_numpy(np.ascontiguousarray(corpus, np.float32)).to(
            resolve_device(device))
    dev = corpus.device
    N = corpus.shape[0]
    if corpus_np is None:
        corpus_np = corpus.cpu().numpy()

    if precision == "auto":
        precision, _ = resolve_knn_precision(
            precision, corpus_np, k=k, weighted=weighted, metric=metric,
            k_candidates=k_candidates, space=space, fused=fused, mesh=mesh, device=dev)
    if space == "joints" and corpus_emb is None:
        if body_model is None:
            raise ValueError("space='joints' requires a body_model")
        corpus_emb = _fk_joint_embedding(corpus, body_model).to(dev)
    w = w_np = None
    if weighted:
        w_np = _joint_weights_np()
        w = torch.from_numpy(w_np).to(dev)

    fused_dot = {"highest": "vpu", "fast": "fast"}.get(precision, "mxu_bf16")
    # the plain searches have no 'fast' engine; 'fast' promises exact labels,
    # so its plain form is exact 'highest'
    plain_precision = "highest" if precision == "fast" else precision
    fused_eligible = (metric == "geo" and corpus_emb is None and not k_candidates and k <= 8
                      and precision in ("highest", "default", "fast"))
    if fused is None:
        use_fused = fused_eligible and dev.type == "cuda"
    elif fused and not fused_eligible:
        raise ValueError(
            "fused=True requires the single-stage geodesic search "
            "(metric='geo', no candidates or embedding, k<=8, "
            "precision='highest', 'default' or 'fast')")
    else:
        use_fused = fused

    queries_dev = torch.from_numpy(queries).to(dev)
    dists, idxs = [], []
    for start in range(0, len(queries), query_batch):
        q = queries_dev[start:start + query_batch]
        # this rank's contiguous share (the whole batch on one device)
        q = q[shard_rows(mesh, len(q))]
        if corpus_emb is not None or k_candidates:
            # two stages: candidates in the embedding, then the exact metric's
            # re-rank (the reference's width: faiss k=500, prepare_traindata.py:45)
            kc = min(k_candidates if k_candidates else 500, N)
            if corpus_emb is not None:
                _, cand = l2_topk(_fk_joint_embedding(q, body_model).to(dev), corpus_emb,
                                  k=kc, precision=plain_precision)
            else:
                _, cand = l2_topk(q.reshape(len(q), -1), corpus.reshape(N, -1), k=kc,
                                  precision=plain_precision)
            rerank = euclidean_rerank if metric == "euc" else geodesic_rerank
            d, i = rerank(q, corpus, cand, k=k, weights=w)
        elif metric == "euc":
            d, i = euclidean_topk(q, corpus, k=k, weights=w, precision=plain_precision)
        elif use_fused and fused_dot == "fast":
            d, i = fused_geodesic_topk_fast(q, corpus, k, weights=w_np)
        elif use_fused:
            d, i = fused_geodesic_topk(q, corpus, k, weights=w_np, dot_impl=fused_dot)
        else:
            d, i = geodesic_topk(q, corpus, k=k, weights=w, precision=plain_precision)
        # results stay on the device until every batch is dispatched; a
        # batch's shares come back in rank order (padded where they differ)
        dists.append(gather_rows(mesh, d))
        idxs.append(gather_rows(mesh, i))
    dist = torch.cat(dists).cpu().numpy()
    idx = torch.cat(idxs).cpu().numpy()
    return {"pose": queries, "dist": dist, "nn_pose": corpus_np[idx]}


def label_split(
    sampled_dir: str,
    out_dir: str,
    subsets: Sequence[str],
    *,
    num_queries: int = 100,
    runs: int = 1000,
    k: int = 5,
    k_candidates: int = 0,
    metric: str = "geo",
    weighted: bool = False,
    space: str = "quat",
    body_model=None,
    seed: int = 0,
    skip_if_exists: bool = True,
    shard: Optional[Tuple[int, int]] = None,
    precision: str = "highest",
    per_pose_noise: bool = False,
    fused: Optional[bool] = None,
    spec: NoiseSpec = NoiseSpec(),
    mesh=None,
    device="cuda",
) -> List[str]:
    """Label every sequence of a split against the split-wide corpus and
    write ``<out_dir>/<subset>/<file>`` with ``pose``, ``dist`` and
    ``nn_pose``.

    ``runs * num_queries`` queries per sequence (the reference's run loop,
    ``prepare_traindata.py:45,104``). Idempotent per sequence (skip-if-
    exists). ``precision='auto'`` is resolved ONCE for the split (the
    corpus-safety probe, where it runs, against the split-wide corpus). The
    corpus goes to ``device`` once (the card
    unless the caller asks for the CPU; raises without one).

    ``mesh``: each sequence's queries are sharded over the ranks
    (:func:`label_sequence`), the corpus on every rank's device; only rank 0
    writes the files, and every rank returns the paths.
    """
    import torch

    from posendf_torch.field import resolve_device
    from posendf_torch.parallel.mesh import barrier

    dev = mesh.device if mesh is not None else resolve_device(device)
    main = mesh is None or mesh.is_main
    if space == "joints" and body_model is None:
        raise ValueError("space='joints' requires a body_model")
    corpus, files = build_corpus(sampled_dir, subsets)
    if shard is not None:
        i, n = shard
        files = files[i::n]
    precision, _ = resolve_knn_precision(
        precision, corpus, k=k, weighted=weighted, metric=metric,
        k_candidates=k_candidates, space=space, fused=fused, mesh=mesh,
        rng=np.random.default_rng([seed, 9999]), device=dev)
    corpus_dev = torch.from_numpy(corpus).to(dev)
    # the corpus's joint embedding, once for the whole split
    corpus_emb = (_fk_joint_embedding(corpus_dev, body_model).to(dev) if space == "joints"
                  else None)
    rng = np.random.default_rng(seed)
    written = []
    for f in files:
        subset = os.path.basename(os.path.dirname(f))
        out_path = os.path.join(out_dir, subset, os.path.basename(f))
        # every rank sees the same skip: rank 0 writes a file only after
        # every rank has looked (the barrier at the end of the loop body)
        if skip_if_exists and os.path.exists(out_path):
            written.append(out_path)
            continue
        labeled = label_sequence(
            _load_quats(f), corpus_dev,
            num_queries=num_queries * runs, k=k, k_candidates=k_candidates,
            metric=metric, weighted=weighted, rng=rng, space=space,
            body_model=body_model, corpus_emb=corpus_emb, corpus_np=corpus, precision=precision,
            per_pose_noise=per_pose_noise, runs=runs, fused=fused, spec=spec, mesh=mesh,
        )
        barrier(mesh)
        if main:
            os.makedirs(os.path.join(out_dir, subset), exist_ok=True)
            np.savez(out_path, **labeled)
        written.append(out_path)
    barrier(mesh)
    return written


def _maybe_body_model(bm_path, space: str, device):
    """The body model of ``--space joints``: the SMPL file at ``--bm-path``
    (required: the synthetic test skeleton would corrupt the labels)."""
    if space != "joints":
        return None
    if not bm_path:
        raise SystemExit("--space joints requires --bm-path (a real SMPL model file); "
                         "the synthetic test skeleton would silently corrupt the labels")
    from posendf_torch.smpl import BodyModel

    return BodyModel(bm_path=bm_path, device=device)


def run_cli(args) -> None:
    """``cli prepare-data``: stage 1 (sample), stage 3 (label) or both."""
    subsets = AMASS_SPLITS.get(args.split, [args.split])
    sampled_dir = os.path.join(args.out_dir, "sampled")
    labeled_dir = os.path.join(args.out_dir, "labeled")
    if args.stage in ("sample", "all"):
        out = sample_amass(args.amass_raw, sampled_dir, subsets)
        print(f"stage 1: sampled {len(out)} sequences -> {sampled_dir}")
    if args.stage in ("label", "all"):
        src = sampled_dir if os.path.isdir(sampled_dir) else args.amass_raw
        out = label_split(
            src, labeled_dir, subsets,
            num_queries=args.num_samples, runs=args.runs,
            k=args.k, k_candidates=args.k_candidates,
            metric=args.metric, weighted=args.weighted, space=args.space,
            body_model=_maybe_body_model(args.bm_path, args.space, args.device),
            precision=args.knn_precision, per_pose_noise=args.per_pose_noise,
            fused={"auto": None, "on": True, "off": False}[args.fused_knn],
            spec=NoiseSpec(structured_frac=args.structured_frac,
                           structured_sigma=tuple(args.structured_sigma)),
            device=args.device,
        )
        print(f"stage 3: labeled {len(out)} sequences -> {labeled_dir}")
