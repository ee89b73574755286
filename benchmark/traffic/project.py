"""Projection traffic: batches of random poses, each brought through a whole projection.

The mix's file gives ``batch`` (poses a batch), ``steps``, ``renormalize``,
``step_scale``, ``pool`` (distinct batches made in set-up and cycled),
``in_flight`` (batches dispatched ahead of the one the host waits for) and
``check_poses`` (poses of each kept batch the reference follows). A unit of
work is one call of ``posendf_torch.projection.project(..., fused=True)``.

The check keeps the output of one batch of the first cycle, drawn from the
seed, and of the last batch of the window, and follows ``check_poses`` poses
of each, drawn from the seed, through the same projection in float64.
"""

from __future__ import annotations

import torch

from benchmark import compare, costs, inputs
from benchmark.reference import posendf_ref

RATE = "project_poses_per_s"


class Work:
    def __init__(self, run):
        from posendf_torch import make_field
        from posendf_torch.projection import project

        from benchmark.program import build_module

        t = run.traffic
        self.run, self.t = run, t
        self.kw = dict(steps=int(t["steps"]), renormalize=bool(t["renormalize"]),
                       step_scale=float(t["step_scale"]), fused=True)
        self.field = make_field(build_module(run.config, run.spec, run.weights, run.device))
        self.project = project
        self.pool = inputs.random_poses(run.gen, (int(t["pool"]), int(t["batch"]),
                                                  len(run.spec["parents"])))
        self.poses_per_unit = int(t["batch"])
        self.in_flight = int(t["in_flight"])
        self.keep_at = int(torch.randint(int(t["pool"]), (1,), generator=run.host_gen))
        self.kept = {}
        self.dispatch(-1)                                   # the window's shapes, once

    def dispatch(self, i: int) -> None:
        b = i % len(self.pool)
        q, hist = self.project(self.field, self.pool[b], **self.kw)
        if i == self.keep_at:
            self.kept["kept"] = (b, q, hist)
        self.kept["last"] = (b, q, hist)

    def flops(self, units: int) -> float:
        return costs.project_step_flops(self.run.spec, self.poses_per_unit) * self.kw["steps"] * units

    def free(self) -> None:
        self.field = None

    def check(self):
        """(numbers, units failed): each kept batch's sampled
        poses against the float64 reference's projection of the same poses."""
        spec, n = self.run.spec, int(self.t["check_poses"])
        model = dict(parents=spec["parents"], activation=spec["activation"], beta=spec["beta"])
        w64 = posendf_ref.cast(self.run.weights, torch.float64)
        outs = list({id(v): v for v in self.kept.values()}.values())
        failed = sum(not compare.finite(q, h) for _, q, h in outs)
        start, got_q, got_h = [], [], []
        for b, q, hist in outs:
            idx = torch.randperm(q.shape[0], generator=self.run.host_gen)[:n].to(q.device)
            start.append(self.pool[b][idx]), got_q.append(q[idx]), got_h.append(hist[:, idx])
        ref_q, ref_h = posendf_ref.project(w64, torch.cat(start).double(), steps=self.kw["steps"],
                                           renormalize=self.kw["renormalize"],
                                           step_scale=self.kw["step_scale"], **model)
        numbers = compare.projection(torch.cat(got_q), torch.cat(got_h, 1), ref_q, ref_h,
                                     torch.cat(start))
        return numbers, failed
