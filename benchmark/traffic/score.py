"""Scoring traffic: calls of the whole-field forward on large batches of random poses.

The mix's file gives ``batch`` (poses a call), ``pool`` (distinct batches made
in set-up and cycled), ``in_flight`` and ``check_poses``. A unit of work is
one call of ``Field.distance_fused`` under ``torch.no_grad()``, as a serving
caller makes it.

The check keeps the output of one call of the first cycle, drawn from the
seed, and of the last call of the window, and compares ``check_poses`` poses
of each, drawn from the seed, with the float64 reference's distances.
"""

from __future__ import annotations

import torch

from benchmark import compare, costs, inputs
from benchmark.reference import posendf_ref

RATE = "score_poses_per_s"


class Work:
    def __init__(self, run):
        from posendf_torch import make_field

        from benchmark.program import build_module

        t = run.traffic
        self.run, self.t = run, t
        self.field = make_field(build_module(run.config, run.spec, run.weights, run.device))
        self.pool = inputs.random_poses(run.gen, (int(t["pool"]), int(t["batch"]),
                                                  len(run.spec["parents"])))
        self.poses_per_unit = int(t["batch"])
        self.in_flight = int(t["in_flight"])
        self.keep_at = int(torch.randint(int(t["pool"]), (1,), generator=run.host_gen))
        self.kept = {}
        self.dispatch(-1)                                   # the window's shapes, once

    def dispatch(self, i: int) -> None:
        b = i % len(self.pool)
        with torch.no_grad():
            d = self.field.distance_fused(self.pool[b])
        if i == self.keep_at:
            self.kept["kept"] = (b, d)
        self.kept["last"] = (b, d)

    def flops(self, units: int) -> float:
        return costs.forward_flops(self.run.spec, self.poses_per_unit) * units

    def free(self) -> None:
        self.field = None

    def check(self):
        """(numbers, units failed): each kept call's sampled
        poses against the float64 reference's distances."""
        spec, n = self.run.spec, int(self.t["check_poses"])
        model = dict(parents=spec["parents"], activation=spec["activation"], beta=spec["beta"])
        w64 = posendf_ref.cast(self.run.weights, torch.float64)
        outs = list({id(v): v for v in self.kept.values()}.values())
        failed = sum(not compare.finite(d) for _, d in outs)
        got, start = [], []
        for b, d in outs:
            idx = torch.randperm(d.shape[0], generator=self.run.host_gen)[:n].to(d.device)
            got.append(d[idx, 0]), start.append(self.pool[b][idx])
        with torch.no_grad():
            ref = posendf_ref.forward(w64, torch.cat(start).double(), **model)
        return compare.distances(torch.cat(got), ref), failed
