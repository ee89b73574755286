"""Synthetic dataset fabrication for tests, demos and benchmarks.

A copy of ``posendf_tpu/data/synthetic.py`` (the port imports nothing of the
JAX package); for the same seed it writes the same arrays, byte for byte.

The reference has no fixtures at all (SURVEY.md §4); this module fabricates
tiny AMASS-shaped datasets — clean quaternion pose files and kNN-labeled
training files — so the full pipeline (loader -> train step -> checkpoint ->
projection) can run hermetically. The synthetic "manifold" is a smooth
low-dimensional family of poses, so a trained field genuinely learns
something projectable in a few hundred steps.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "manifold_family",
    "synthetic_manifold_poses",
    "synthetic_motion_sequence",
    "write_synthetic_dataset",
]


def manifold_family(rng: "np.random.Generator", num_joints: int = 21,
                    latents: int = 2,
                    freq_range: Tuple[float, float] = (0.5, 2.0)):
    """Draw the parameters of one smooth ``latents``-parameter pose family:
    per-joint rotation axes, latent frequencies and phases. Poses generated
    from the same family lie on the same manifold (the thing the field
    learns).

    ``latents=2`` (default) returns the legacy 3-tuple
    ``(axes (J,3), freq (J,2), phase (J,))`` — every round-3 artifact was
    produced from it and stays reproducible. ``latents != 2`` returns a
    4-tuple ``(axes, freq (J,L), phase (J,L), weights (L,))``; the weights
    are ``1/sqrt(L)`` so the per-joint angle spread stays ~1 rad like the
    2-latent family.

    Why the knob exists: the manifold's INTRINSIC dimension controls the
    clean 5-NN label floor at a given corpus size. On a 2-latent sheet even
    a 4k-pose corpus is so dense the floor is ~0 and all label mass comes
    from the noise offset (measured: labels are corpus-size-INDEPENDENT
    from 4k to 131k); real AMASS (63-dof, ~1M poses) has a large
    density-set floor. Higher ``latents`` reproduces that regime
    synthetically."""
    axes = rng.normal(size=(num_joints, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    if latents == 2:
        freq = rng.uniform(*freq_range, size=(num_joints, 2))
        phase = rng.uniform(0, 2 * np.pi, size=(num_joints,))
        return axes, freq, phase
    freq = rng.uniform(*freq_range, size=(num_joints, latents))
    phase = rng.uniform(0, 2 * np.pi, size=(num_joints, latents))
    weights = np.full(latents, 1.0 / np.sqrt(latents))
    return axes, freq, phase, weights


def synthetic_manifold_poses(rng: np.random.Generator, n: int,
                             num_joints: int = 21, family=None) -> np.ndarray:
    """Sample unit-quaternion poses from a smooth low-dimensional manifold:
    each joint rotates about a fixed per-joint axis by an angle that is a
    smooth function of the latent parameters (2 by default; see
    ``manifold_family(latents=...)``). ``family=None`` draws a fresh family
    from ``rng``. Returns (n, J, 4) float32."""
    if family is None:
        family = manifold_family(rng, num_joints)
    if len(family) == 3:
        # legacy draw ORDER (u then v, two size-n draws) — seeded artifacts
        # (golden checkpoint, round-3 grid runs) depend on this stream
        u = rng.uniform(0, 2 * np.pi, size=n)
        v = rng.uniform(0, 2 * np.pi, size=n)
        return _poses_from_latents(family, np.stack([u, v], axis=-1))
    L = family[1].shape[1]
    z = rng.uniform(0, 2 * np.pi, size=(n, L))
    return _poses_from_latents(family, z)


def _poses_from_latents(family, z: np.ndarray,
                        v: "np.ndarray | None" = None) -> np.ndarray:
    """Poses from latent coordinates. Legacy call shape
    ``(family3, u, v)`` and the general ``(family, z (n, L))`` both work;
    the legacy 2-latent math is kept bit-for-bit (round-3 artifacts)."""
    if v is not None:
        z = np.stack([np.asarray(z), np.asarray(v)], axis=-1)
    z = np.atleast_2d(np.asarray(z))
    if len(family) == 3:
        axes, freq, phase = family
        angle = (0.6 * np.sin(freq[None, :, 0] * z[:, 0:1] + phase[None, :])
                 + 0.4 * np.cos(freq[None, :, 1] * z[:, 1:2]))
    else:
        axes, freq, phase, weights = family
        # (n, 1, L) broadcast against (1, J, L), weighted sum over latents
        angle = np.sum(weights[None, None, :] * np.sin(
            freq[None, :, :] * z[:, None, :] + phase[None, :, :]), axis=-1)
    half = 0.5 * angle
    w = np.cos(half)[..., None]
    xyz = np.sin(half)[..., None] * axes[None]
    return np.concatenate([w, xyz], axis=-1).astype(np.float32)


def synthetic_motion_sequence(rng: np.random.Generator, frames: int,
                              num_joints: int = 21, family=None) -> np.ndarray:
    """A temporally SMOOTH pose sequence on the synthetic manifold: the
    latent parameters follow slow sinusoidal trajectories over time, so
    adjacent frames are similar — the property real mocap has and the
    temporal loss in motion denoising depends on. Returns (frames, J, 4)."""
    if family is None:
        family = manifold_family(rng, num_joints)
    t = np.linspace(0, 1, frames)
    if len(family) == 3:
        u = np.pi * (1 + np.sin(2 * np.pi * 0.4 * t + rng.uniform(0, 2 * np.pi)))
        v = np.pi * (1 + np.cos(2 * np.pi * 0.3 * t + rng.uniform(0, 2 * np.pi)))
        return _poses_from_latents(family, u, v)
    L = family[1].shape[1]
    # slow per-latent sinusoids, distinct rates so the path explores the
    # manifold instead of tracing a closed 1-d loop
    rates = rng.uniform(0.2, 0.5, size=L)
    phases = rng.uniform(0, 2 * np.pi, size=L)
    z = np.pi * (1 + np.sin(2 * np.pi * rates[None, :] * t[:, None]
                            + phases[None, :]))
    return _poses_from_latents(family, z)


def _geodesic(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Mean over joints of 1 - |<qa, qb>| ; a (Q,1,J,4) vs b (1,N,J,4) -> (Q,N)."""
    dots = np.sum(a * b, axis=-1)
    return np.mean(1.0 - np.abs(dots), axis=-1)


def write_synthetic_dataset(
    root: str,
    *,
    subsets: Sequence[str] = ("ACCAD", "CMU"),
    seqs_per_subset: int = 2,
    poses_per_seq: int = 256,
    queries_per_seq: int = 128,
    k: int = 5,
    sigmas: Sequence[float] = (0.01, 0.05, 0.1, 0.25, 0.5),
    seed: int = 0,
    family=None,
) -> Tuple[str, str]:
    """Fabricate ``<root>/amass`` (clean quats) and ``<root>/labeled``
    (noisy quats + exact brute-force kNN geodesic distance labels, the same
    labeling semantics as the reference pipeline). Returns (labeled_dir,
    amass_dir)."""
    rng = np.random.default_rng(seed)
    if family is None:
        family = manifold_family(rng)  # ONE manifold for the whole dataset
    amass_dir = os.path.join(root, "amass")
    labeled_dir = os.path.join(root, "labeled")

    corpus: List[np.ndarray] = []
    clean_files = []
    for subset in subsets:
        os.makedirs(os.path.join(amass_dir, subset), exist_ok=True)
        for s in range(seqs_per_subset):
            poses = synthetic_manifold_poses(rng, poses_per_seq, family=family)
            path = os.path.join(amass_dir, subset, f"seq{s:02d}.npz")
            np.savez(path, pose=poses)
            clean_files.append(path)
            corpus.append(poses)
    corpus_all = np.concatenate(corpus)  # (N, J, 4)

    sigmas = np.asarray(sigmas)
    for subset in subsets:
        os.makedirs(os.path.join(labeled_dir, subset), exist_ok=True)
        for s in range(seqs_per_subset):
            base_idx = rng.integers(0, len(corpus_all), queries_per_seq)
            base = corpus_all[base_idx]
            sig = rng.choice(sigmas, size=(queries_per_seq, 1, 1))
            noisy = base + sig * rng.random(base.shape)
            noisy /= np.linalg.norm(noisy, axis=-1, keepdims=True)
            d = _geodesic(noisy[:, None], corpus_all[None])  # (Q, N)
            nn = np.sort(d, axis=1)[:, :k]
            np.savez(
                # the `_000` suffix mirrors the reference's labeled-shard
                # naming so the training reader's default `*/*000.npz`
                # filter (model/load_data.py:28) matches out of the box
                os.path.join(labeled_dir, subset, f"seq{s:02d}_000.npz"),
                pose=noisy.astype(np.float32),
                dist=nn.astype(np.float32),
            )
    return labeled_dir, amass_dir
