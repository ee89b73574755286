"""Training traffic: the published train step on batches of labelled noisy poses and manifold poses.

The mix's file gives ``noisy`` and ``manifold`` (poses of each branch a
step), ``sigmas`` (the noise scales a noisy pose draws from), ``pool``
(distinct batches made in set-up and cycled), ``in_flight`` and
``checked_steps``. The optimizer and the loss are the configuration's
(``train``). A unit of work is one call of the step that
``posendf_torch.training.trainer.make_train_step(fused=True)`` returns: the
weights' pack, the loss and gradient kernels, Adam.

Set-up builds the step once and drives it through ``checked_steps`` steps on
the first batches of the pool, then hands the same step, with its weights and
Adam state, to the window. The check follows those steps with the float64
reference: each step's loss, the first gradient (worked out from Adam's first
moment after one step) and the weights' change after the last of them.
"""

from __future__ import annotations

import torch

from benchmark import compare, costs, inputs
from benchmark.reference import posendf_ref

RATE = "train_poses_per_s"


def hyper(config: dict) -> dict:
    t = config["train"]
    if t["optimizer"] != "Adam":
        raise ValueError(f"the train traffic runs Adam, not {t['optimizer']!r}")
    return dict(lr=float(t["optimizer_param"]), weight_decay=float(t["weight_decay"]),
                loss=dict(loss_type=t["loss_type"], weight_dist=float(t["dist"]),
                          weight_man=float(t["man_loss"]), weight_eikonal=float(t["eikonal"])))


class PortTrainer:
    """The program's step, built as its trainer builds it."""

    def __init__(self, run):
        from posendf_torch.training.trainer import make_optimizer, make_train_step

        from benchmark.program import build_module

        h = hyper(run.config)
        module = build_module(run.config, run.spec, run.weights, run.device)
        self.opt = make_optimizer(module.parameters(), h["lr"], h["weight_decay"])
        loss = h["loss"]
        self.fn = make_train_step(module, self.opt, loss_type=loss["loss_type"], fused=True,
                                  weights={"dist": loss["weight_dist"],
                                           "man_loss": loss["weight_man"],
                                           "eikonal": loss["weight_eikonal"]})
        self.named = list(module.named_parameters())

    def step(self, batch) -> torch.Tensor:
        return self.fn(batch)["total"]

    def params(self):
        return {n: p.detach().clone() for n, p in self.named}

    def first_moment(self):
        """Adam's first moment of each weight (zeros where it has none)."""
        return {n: self.opt.state[p].get("exp_avg", torch.zeros_like(p)).detach().clone()
                for n, p in self.named}


class Work:
    def __init__(self, run, trainer=None):
        t = run.traffic
        self.run, self.t = run, t
        self.h = hyper(run.config)
        self.trainer = trainer if trainer is not None else PortTrainer(run)
        self.noisy, self.manifold = int(t["noisy"]), int(t["manifold"])
        self.pool = inputs.training_pool(run.gen, int(t["pool"]), self.noisy, self.manifold,
                                         len(run.spec["parents"]), t["sigmas"])
        self.poses_per_unit = self.noisy + self.manifold
        self.in_flight = int(t["in_flight"])
        self.checked = int(t["checked_steps"])
        if not 1 <= self.checked < len(self.pool):
            raise ValueError("checked_steps must leave a batch of the pool unseen")
        losses = []
        for k in range(self.checked):     # the window's shapes, and the steps the check follows
            losses.append(self.trainer.step(self.pool[k]))
            if k == 0:
                self.moment = self.trainer.first_moment()
        self.losses = torch.stack(losses)
        self.after = self.trainer.params()
        self.totals = []

    def dispatch(self, i: int) -> None:
        self.totals.append(self.trainer.step(self.pool[(i + self.checked) % len(self.pool)]))

    def flops(self, units: int) -> float:
        return costs.train_step_flops(self.run.spec, self.noisy, self.manifold) * units

    def free(self) -> None:
        self.trainer = None

    def check(self):
        """(numbers, units failed): the set-up's steps against the reference's;
        a unit failed if its loss is not finite."""
        spec, w0 = self.run.spec, self.run.weights
        model = dict(parents=spec["parents"], activation=spec["activation"], beta=spec["beta"])
        failed = int((~torch.isfinite(torch.stack([*self.losses, *self.totals]))).sum())
        beta1 = 0.9     # make_optimizer's and the published Adam's
        grad = {k: m / (1 - beta1) - self.h["weight_decay"] * w0[k] for k, m in self.moment.items()}
        change = {k: self.after[k] - w0[k] for k in w0}
        batches = [{k: v.double() for k, v in b.items()} for b in self.pool[:self.checked]]
        losses_ref, grad_ref, p_ref = posendf_ref.adam_steps(
            posendf_ref.cast(w0, torch.float64), batches, model=model, **self.h)
        change_ref = {k: p_ref[k] - w0[k].double() for k in w0}
        numbers = compare.training(self.losses, grad, change, losses_ref, grad_ref, change_ref)
        return numbers, failed
