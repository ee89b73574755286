"""Motion-denoising benchmark sweep: the reference's noise grid.

Mirror of ``posendf_tpu/experiments/denoise_benchmark.py`` (the reference's
``__main__`` sweep, ``experiments/motion_denoise.py:158-191``): noise
levels sigma in {0.01, 0.05, 0.1, 0.5} at 60 frames, every sequence
denoised, the v2v-cm error aggregated per level and saved as an ``.npz``
table.

Two data sources:
  * ``data_root``: directories of noisy / ground-truth sequences,
    ``<root>/<grid-name>/<seq>/observations.npz`` + ``gt_results.npz`` (the
    reference's HuMoR results layout);
  * ``synthesize_grid``: a hermetic grid, clean sequences of the synthetic
    manifold perturbed per sigma (no licensed data needed).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from posendf_torch.experiments.denoise import MotionDenoiser, _load_pose_file

__all__ = ["DEFAULT_GRID", "run_sweep", "synthesize_grid"]

# (sigma, frames): the reference grid, motion_denoise.py:171-172
DEFAULT_GRID: Tuple[Tuple[float, int], ...] = (
    (0.01, 60), (0.05, 60), (0.1, 60), (0.5, 60),
)


def synthesize_grid(out_root: str, grid: Sequence[Tuple[float, int]] = DEFAULT_GRID,
                    seqs_per_level: int = 2, seed: int = 0, family=None,
                    family_seed: int = 0) -> str:
    """Write a noise grid: ground truth = temporally smooth pose sequences
    on one synthetic manifold, observations = ground truth + sigma N(0, 1)
    on the 63 body-pose dofs.

    A field denoises toward the manifold it was trained on, so the grid must
    share its family: pass the family itself, or ``family_seed`` equal to
    the ``seed`` given to ``data.synthetic.write_synthetic_dataset``. The
    numpy draws are the JAX package's, so the files hold its values up to
    the float32 rounding of the axis-angle conversion."""
    import torch

    from posendf_torch.data.synthetic import manifold_family, synthetic_motion_sequence
    from posendf_torch.quat import quaternion_to_axis_angle

    if family is None:
        family = manifold_family(np.random.default_rng(family_seed))
    rng = np.random.default_rng(seed)
    for sigma, frames in grid:
        level = f"noise_{sigma}_{frames}"
        for s in range(seqs_per_level):
            d = os.path.join(out_root, level, f"seq{s:02d}")
            os.makedirs(d, exist_ok=True)
            quats = synthetic_motion_sequence(rng, frames, family=family)
            aa = quaternion_to_axis_angle(torch.from_numpy(quats)).numpy()
            gt = aa.reshape(frames, 63).astype(np.float32)
            noisy = gt + sigma * rng.standard_normal(gt.shape).astype(np.float32)
            np.savez(os.path.join(d, "gt_results.npz"), pose_body=gt)
            np.savez(os.path.join(d, "observations.npz"), pose_body=noisy)
    return out_root


def run_sweep(denoiser: MotionDenoiser, data_root: str,
              grid_names: Optional[Sequence[str]] = None, iterations: int = 10,
              steps_per_iter: int = 50, out_path: Optional[str] = None,
              batch_clips: bool = True) -> Dict[str, np.ndarray]:
    """Denoise every sequence of every grid level; returns ``{level: v2v_cm
    array}`` (in sorted sequence-name order) and optionally saves the table
    (the reference's ``posendf_table_2.npz``, ``motion_denoise.py:191``).

    ``batch_clips`` (default): the same-length clips of a level solve as
    one batch (``MotionDenoiser.optimize_many``); a lone clip, and every clip
    with ``batch_clips=False``, solves alone.

    Sequences without a ``gt_results.npz`` have no ground truth to score
    against; their output-vs-input drift is kept apart under
    ``<level>__vs_input`` (a do-nothing denoiser scores 0 there, so it must
    never mix into the v2v-vs-gt table)."""
    levels = grid_names or sorted(os.listdir(data_root))
    results: Dict[str, np.ndarray] = {}
    for level in levels:
        level_dir = os.path.join(data_root, level)
        if not os.path.isdir(level_dir):
            continue
        clips = []
        for seq in sorted(os.listdir(level_dir)):
            obs = os.path.join(level_dir, seq, "observations.npz")
            gt = os.path.join(level_dir, seq, "gt_results.npz")
            if not os.path.exists(obs):
                continue
            noisy = _load_pose_file(obs)
            gt_arr = _load_pose_file(gt, frames=len(noisy)) if os.path.exists(gt) else None
            if gt_arr is not None and len(gt_arr) < len(noisy):
                noisy = noisy[: len(gt_arr)]
            clips.append((noisy, gt_arr))

        # same-shape clips solve together; scores land in per-index slots, so
        # the result arrays keep the sorted sequence order whatever the grouping
        per_idx: Dict[int, Tuple[bool, float]] = {}
        groups: Dict[tuple, List[int]] = {}
        for i, (noisy, gt_arr) in enumerate(clips):
            groups.setdefault((len(noisy), gt_arr is not None), []).append(i)
        for (_, has_gt), idxs in sorted(groups.items()):
            if batch_clips and len(idxs) > 1:
                stack = np.stack([clips[i][0] for i in idxs])
                gt_stack = np.stack([clips[i][1] for i in idxs]) if has_gt else None
                _, m = denoiser.optimize_many(stack, gt_stack, iterations=iterations,
                                              steps_per_iter=steps_per_iter)
                scores = m["v2v_cm"] if has_gt else m["v2v_vs_input_cm"]
                for i, v in zip(idxs, scores):
                    per_idx[i] = (has_gt, float(v))
            else:
                for i in idxs:
                    noisy, gt_arr = clips[i]
                    _, m = denoiser.optimize(noisy, gt_arr, iterations=iterations,
                                             steps_per_iter=steps_per_iter)
                    per_idx[i] = ((True, m["v2v_cm"]) if "v2v_cm" in m
                                  else (False, m["v2v_vs_input_cm"]))
        errors: List[float] = []
        no_gt: List[float] = []
        for i in range(len(clips)):
            has_gt, v = per_idx[i]
            (errors if has_gt else no_gt).append(v)
        results[level] = np.asarray(errors, np.float64)
        mean = results[level].mean() if errors else float("nan")
        print(f"{level}: {len(errors)} seqs, mean v2v {mean:.4f} cm")
        if no_gt:
            results[f"{level}__vs_input"] = np.asarray(no_gt, np.float64)
            print(f"{level}: WARNING {len(no_gt)} seqs without gt_results.npz scored vs input "
                  f"only (mean drift {np.mean(no_gt):.4f} cm, column {level}__vs_input)")
    if out_path:
        np.savez(out_path, **results)
        print(f"wrote {out_path}")
    return results
