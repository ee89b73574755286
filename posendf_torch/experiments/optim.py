"""The annealed-Adam engine the experiments share.

Mirror of ``posendf_tpu/experiments/optim.py``. The reference experiments
(``motion_denoise.py:58-121``, ``partial_observation.py``,
``image_fitting.py:183-213``) all run Adam over SMPL parameters for
``iterations`` outer x ``steps_per_iter`` inner steps, each loss term
entering the total as ``f(loss, it) = scale * loss^power * (1 + it)^anneal``,
gated off until ``it > active_after`` (e.g. the pose prior
``1e7 * loss^2 / (1 + it)``, ``motion_denoise.py:31-34``).

JAX runs the whole solve as one ``lax.scan``; here it is a Python loop over
the steps. The iteration index of every step is made on the device once,
and the history stays there: the loop never waits on the device.

Adam is written out to optax's formula (``optax.adam(lr, b1=0.9, b2=0.999)``,
eps 1e-8, eps_root 0, bias correction counted from step 1, the update
``m_hat / (sqrt(v_hat) + eps)`` times ``-lr``), because ``torch.optim.Adam``
cannot do two things the solves need: scale the UPDATES by
``aux["lr_runtime"]`` and mask them by ``aux["param_mask"]`` (a masked dof
stays at its initial value to the bit).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["AnnealSpec", "make_annealed_solver", "run_annealed_adam"]

B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults (eps_root = 0)


class AnnealSpec(NamedTuple):
    """Annealed weighting f(loss, it) = scale * loss^power * (1+it)^anneal,
    gated off before ``active_after`` iterations."""

    scale: float
    power: int = 1          # 1: linear in the loss; 2: squared (self-weighted)
    anneal: float = 0.0     # exponent on (1 + it): +1 grows, -1 decays
    active_after: int = -1  # term active when it > active_after


def _weighted(loss: torch.Tensor, it: torch.Tensor, spec: AnnealSpec,
              override: Optional[dict] = None) -> torch.Tensor:
    """Apply the spec; ``override`` (a term's entry of
    ``aux["anneal_runtime"]``) replaces scale, anneal and active_after with
    run-time values: floats, or tensors broadcastable to the loss (one value
    a clip of a batched solve)."""
    override = override or {}
    scale = override.get("scale", spec.scale)
    anneal = override.get("anneal", spec.anneal)
    active_after = override.get("active_after", spec.active_after)
    w = scale * (loss ** spec.power) * (1.0 + it) ** anneal
    return torch.where(it > active_after, w, 0.0)


def make_annealed_solver(loss_terms_fn: Callable, specs: Dict[str, AnnealSpec], *,
                         iterations: int = 10, steps_per_iter: int = 50, lr: float = 0.02):
    """A reusable solver ``solve(params, aux) -> (params, history)``.

    ``params``: the optimized tensor, or a dict of tensors (each leaf its
    own Adam moments, as optax keeps them for a pytree; returned as a dict).
    ``loss_terms_fn(params, aux)`` returns ``{term: loss}``; everything it
    reads besides ``params`` comes through ``aux``. A loss may be a scalar, or a (C,) tensor of C
    independent problems (clips that share no parameter): the solve then
    descends the sum of their weighted totals, which, Adam being
    elementwise, is C independent solves up to the order of float sums.

    ``aux`` (a dict, or None) may carry:
      * ``"anneal_runtime"``: ``{term: {"scale"|"anneal"|"active_after": value}}``,
        run-time overrides of the specs (``power`` stays the spec's);
      * ``"lr_runtime"``: a factor on the updates, broadcastable to the
        parameters, or to every leaf of a dict (Adam is invariant to the
        loss's scale, so only the updates can shrink its late-step
        oscillation);
      * ``"param_mask"``: a 0/1 mask on the updates, broadcastable to the
        parameters, or to every leaf of a dict; a dof masked out never moves.

    ``history``: ``{term: (steps, ...), "total": (steps, ...)}``, the terms
    and the weighted total before each step's update, on the device.
    """
    total_steps = iterations * steps_per_iter

    def total_loss(params, aux, it):
        terms = loss_terms_fn(params, aux)
        runtime = aux.get("anneal_runtime", {}) if isinstance(aux, dict) else {}
        tot = sum(_weighted(terms[k], it, specs[k], runtime.get(k)) for k in specs)
        return tot, terms

    def solve(params, aux):
        # a dict of tensors is optimized leaf by leaf (optax's tree_map): each
        # leaf its own moments, the same bias corrections, the runtime step
        # size and mask applied to every leaf's update
        keys = list(params) if isinstance(params, dict) else None
        xs = [params[k].detach() for k in keys] if keys else [params.detach()]
        ms = [torch.zeros_like(x) for x in xs]
        vs = [torch.zeros_like(x) for x in xs]
        lr_mult = aux.get("lr_runtime") if isinstance(aux, dict) else None
        pm = aux.get("param_mask") if isinstance(aux, dict) else None
        its = torch.div(torch.arange(total_steps, device=xs[0].device), steps_per_iter,
                        rounding_mode="floor").to(torch.float32)
        history: Dict[str, list] = {}
        for step in range(total_steps):
            with torch.enable_grad():
                xg = [x.requires_grad_(True) for x in xs]
                tot, terms = total_loss(dict(zip(keys, xg)) if keys else xg[0], aux, its[step])
                # a leaf the loss does not read has a zero gradient, as in JAX
                gs = torch.autograd.grad(tot.sum(), xg, allow_unused=True)
            for k, val in dict(terms, total=tot).items():
                history.setdefault(k, []).append(val.detach())
            # optax's bias corrections, 1 - b^count, in float32
            bc1 = float(1 - np.float32(B1) ** np.float32(step + 1))
            bc2 = float(1 - np.float32(B2) ** np.float32(step + 1))
            with torch.no_grad():
                for i, (x, g, m, v) in enumerate(zip(xs, gs, ms, vs)):
                    if g is None:
                        g = torch.zeros_like(x)
                    m.mul_(B1).add_((1 - B1) * g)          # (1 - b1) g + b1 m
                    v.mul_(B2).add_((1 - B2) * (g * g))    # (1 - b2) g^2 + b2 v
                    u = (m / bc1) / (torch.sqrt(v / bc2) + EPS) * (-lr)
                    if lr_mult is not None:
                        u = u * lr_mult
                    if pm is not None:
                        u = u * pm
                    xs[i] = x.detach() + u
        out = dict(zip(keys, xs)) if keys else xs[0]
        return out, {k: torch.stack(val) for k, val in history.items()}

    return solve


def run_annealed_adam(loss_terms_fn: Callable[..., Dict[str, torch.Tensor]],
                      init_params: torch.Tensor, specs: Dict[str, AnnealSpec], *,
                      iterations: int = 10, steps_per_iter: int = 50,
                      lr: float = 0.02) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One solve of ``loss_terms_fn(params) -> {term: loss}`` from
    ``init_params``: (final params, history of (steps,) tensors per term and
    ``"total"``)."""
    solve = make_annealed_solver(lambda p, _aux: loss_terms_fn(p), specs,
                                 iterations=iterations, steps_per_iter=steps_per_iter, lr=lr)
    return solve(init_params, None)
