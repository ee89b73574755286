"""The numbers that decide ``correct``: the program's answers against the reference's.

Each function takes the program's answers and the reference's (float64) for
the same inputs and returns named numbers; a cell's file in ``workloads/``
gives the limit of each number it compares.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

__all__ = ["distances", "projection", "training", "finite"]


def _scale(ref: torch.Tensor) -> float:
    """The sample's median distance: the unit of a distance's gap (a gap of
    a distance near 0, as a ReLU head gives, is measured against it too)."""
    s = float(ref.abs().median())
    return s if s > 0 else 1.0


def distances(got: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """``d_gap``: the widest gap of a distance, in units of the median distance."""
    got, ref = got.double().reshape(-1), ref.double().reshape(-1)
    return {"d_gap": float((got - ref).abs().max()) / _scale(ref)}


def projection(q: torch.Tensor, hist: torch.Tensor, q_ref: torch.Tensor,
               hist_ref: torch.Tensor, start: torch.Tensor) -> Dict[str, float]:
    """``d_gap``: the widest gap of a distance of the history (every step,
    every pose), in units of the median first distance; ``q_gap``: the widest
    gap of a component of a projected pose; ``step_gap``: the gap of each
    pose's whole displacement from ``start``, summed over the poses, over the
    reference's displacements summed alike. ``step_gap`` reads the input
    gradient of every step: an error of the gradient is an error of the step
    it scales, while the fp32 rounding of a pose is not."""
    hist, hist_ref = hist.double(), hist_ref.double()
    q, q_ref, start = q.double(), q_ref.double(), start.double()
    moved = (q_ref - start).flatten(1).norm(dim=1)
    off = (q - q_ref).flatten(1).norm(dim=1)
    return {"d_gap": float((hist - hist_ref).abs().max()) / _scale(hist_ref[0]),
            "q_gap": float((q - q_ref).abs().max()),
            "step_gap": float(off.sum() / moved.sum().clamp_min(1e-30))}


def _leaf_gap(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names: Iterable[str]) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    against the larger of the reference's norm of that leaf and of the median leaf."""
    names = list(names)
    n_ref = {k: float(ref[k].double().norm()) for k in names}
    n_got = {k: float(got[k].double().norm()) for k in names}
    med = sorted(n_ref.values())[len(names) // 2]
    return max(abs(n_got[k] - n_ref[k]) / max(n_ref[k], med) for k in names)


def training(losses: torch.Tensor, grad: Dict[str, torch.Tensor], change: Dict[str, torch.Tensor],
             losses_ref: torch.Tensor, grad_ref: Dict[str, torch.Tensor],
             change_ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``loss_gap``: the widest relative gap of a step's total loss;
    ``grad_gap``: the first gradient's worst leaf; ``change_gap``: the worst
    leaf of the weights' change over the steps, leaving out leaves whose
    reference gradient is under a thousandth of the median leaf's (they move
    by round-off alone)."""
    losses, losses_ref = losses.double().reshape(-1), losses_ref.double().reshape(-1)
    g_norm = {k: float(v.double().norm()) for k, v in grad_ref.items()}
    med = sorted(g_norm.values())[len(g_norm) // 2]
    moving = [k for k in grad_ref if g_norm[k] >= 1e-3 * med]
    return {"loss_gap": float(((losses - losses_ref).abs() / losses_ref.abs()).max()),
            "grad_gap": _leaf_gap(grad, grad_ref, grad_ref),
            "change_gap": _leaf_gap(change, change_ref, moving)}


def finite(*tensors: torch.Tensor) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)
