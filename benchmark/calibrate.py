#!/usr/bin/env python3
"""Readings that a cell's correctness limits are set from, at the cell's own size.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 --as program
    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 --as control
    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 --as control:backward
    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 --as fault:half

For each seed it builds the cell's run as ``run.py`` does and produces the
units of work whose outputs the check keeps, without a measured window, by:

* ``program``: the program, as the window calls it (the lower readings);
* ``control``: the plain reference put in the program's place and computed a
  precision below the configuration's: fp32 with TF32 products (the upper
  readings);
* ``control:backward`` (projection): the same reference with its forward in
  fp32 and only the backward to the input with TF32 products, the lower
  precision a change to the backward alone would bring;
* ``fault:<name>``: the reference in fp32 put in the program's place, with a
  fault planted: ``unchanged`` (a step returns its state unchanged), ``half``
  (half of the batch left out, the mean taken over the rest; unprojected or
  unscored in the other kinds), ``altered`` (training: one leaf's gradient
  doubled where it is produced).

It prints one JSON line a seed: the cell, the seed, who produced the outputs
and the check's numbers. Needs a CUDA device.

    python3 benchmark/calibrate.py --workload <cell> --set-limits readings.jsonl [...]

writes ``workloads/<cell>.json`` from such lines: for each number, the lower
reading (the largest the program gives over its seeds), the upper reading
and the limit between them, 60% of the way from the lower to the upper on a
log scale. The upper reading is the smallest the controls give, where that
is at least 3 times the lower; in a training cell also each fault's, where
that is at least 10 times the lower (3 times for a state left unchanged). In
another cell the faults give the upper reading only of a number no control
can move. A number with no upper reading gets no limit and is not compared.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark import manifest  # noqa: E402
from benchmark.reference import posendf_ref  # noqa: E402
from benchmark.run import Run  # noqa: E402

FAULTS = ("unchanged", "half", "altered")
CONTROLS = ("control", "control:backward")


@contextlib.contextmanager
def tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _model(run: Run) -> dict:
    s = run.spec
    return dict(parents=s["parents"], activation=s["activation"], beta=s["beta"])


class RefProjector:
    """``project(field, poses, ...)`` computed by the reference in fp32; with
    ``lower`` its products in TF32, with ``lower == "backward"`` only those of
    the backward to the input."""

    def __init__(self, run: Run, lower, fault: str = ""):
        self.w, self.model, self.lower, self.fault = (posendf_ref.cast(run.weights, torch.float32),
                                                      _model(run), lower, fault)

    def _backward_lower(self, poses, *, steps, renormalize, step_scale):
        """``posendf_ref.project`` with the forward in fp32 and the backward in TF32."""
        w = {k: v.detach() for k, v in self.w.items()}
        q, history = poses, []
        for _ in range(steps):
            p = q.detach().requires_grad_(True)
            with torch.enable_grad(), tf32(False):
                d = posendf_ref.forward(w, p, **self.model)
            with tf32(True):
                (g,) = torch.autograd.grad(d, p, torch.ones_like(d))
            d = d.detach()
            q = q - step_scale * d[:, None, None] * g
            if renormalize:
                q = q / torch.sqrt(torch.clamp_min(torch.sum(q * q, dim=-1, keepdim=True), 1e-24))
            q = q.detach()
            history.append(d)
        return q, torch.stack(history)

    def __call__(self, field, poses, *, steps, renormalize, step_scale, fused):
        kw = dict(steps=steps, renormalize=renormalize, step_scale=step_scale, **self.model)
        if self.lower == "backward":
            return self._backward_lower(poses, steps=steps, renormalize=renormalize,
                                        step_scale=step_scale)
        with tf32(bool(self.lower)):
            if self.fault == "unchanged":
                d = posendf_ref.forward(self.w, poses, **self.model).detach()
                return poses.clone(), d[None].expand(steps, -1).clone()
            if self.fault == "half":
                h = poses.shape[0] // 2
                q, hist = posendf_ref.project(self.w, poses[:h], **kw)
                d = posendf_ref.forward(self.w, poses[h:], **self.model).detach()
                return (torch.cat([q, poses[h:]]),
                        torch.cat([hist, d[None].expand(steps, -1)], 1))
            return posendf_ref.project(self.w, poses, **kw)


class RefField:
    """``Field.distance_fused`` computed by the reference in fp32."""

    def __init__(self, run: Run, lower: bool, fault: str = ""):
        self.w, self.model, self.lower, self.fault = (posendf_ref.cast(run.weights, torch.float32),
                                                      _model(run), lower, fault)

    def distance_fused(self, poses):
        with tf32(self.lower), torch.no_grad():
            h = poses.shape[0] // 2 if self.fault == "half" else poses.shape[0]
            d = torch.zeros(poses.shape[0], dtype=torch.float32, device=poses.device)
            d[:h] = posendf_ref.forward(self.w, poses[:h], **self.model)
            return d[:, None]


class RefTrainer:
    """The train step computed by the reference's Adam in fp32."""

    def __init__(self, run: Run, lower: bool, fault: str = ""):
        from benchmark.traffic.train import hyper

        self.opt = posendf_ref.Adam(posendf_ref.cast(run.weights, torch.float32),
                                    model=_model(run), **hyper(run.config))
        self.lower, self.fault = lower, fault

    def step(self, batch):
        if self.fault == "half":
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        with tf32(self.lower):
            total, grads = self.opt.grad(batch)
        if self.fault == "altered":
            grads["dfnet.b3"] = 2 * grads["dfnet.b3"]
        if self.fault != "unchanged":
            self.opt.update(grads)
        return total

    def params(self):
        return {k: v.clone() for k, v in self.opt.p.items()}

    def first_moment(self):
        return {k: v.clone() for k, v in self.opt.m.items()}


def _sync(run: Run) -> None:
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        torch.cuda.empty_cache()


def readings(bench: dict, cell: str, seed: int, who: str, device="cuda", traffic=None) -> dict:
    """The check's numbers for one seed, the outputs produced by ``who``;
    ``traffic`` replaces the cell's mix (the tests run small ones)."""
    run = Run(bench, cell, seed, device, traffic)
    kind = manifest.kind_module(run.traffic["kind"])
    lower = "backward" if who == "control:backward" else who == "control"
    fault = who.split(":", 1)[1] if who.startswith("fault:") else ""
    if fault and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    if lower == "backward" and run.traffic["kind"] != "project":
        raise ValueError("control:backward is a projection's control")
    t0 = time.perf_counter()
    if run.traffic["kind"] == "train":
        work = kind.Work(run, None if who == "program" else RefTrainer(run, lower, fault))
    else:
        work = kind.Work(run)
        if who != "program":
            if run.traffic["kind"] == "project":
                work.project = RefProjector(run, lower, fault)
            else:
                work.field = RefField(run, lower, fault)
    if run.traffic["kind"] != "train":      # training's check follows the set-up's steps
        for i in range(int(run.traffic["pool"])):     # the kept unit of the first cycle, a last
            work.dispatch(i)
    _sync(run)
    produced = time.perf_counter() - t0
    work.free()
    gc.collect()
    _sync(run)
    t1 = time.perf_counter()
    numbers, failed = work.check()
    return {"cell": cell, "seed": seed, "as": who, "numbers": numbers, "failed": failed,
            "produce_s": produced, "reference_s": time.perf_counter() - t1}


def _upper(lower: float, least: dict, training: bool):
    """(upper reading, who gave it), or None."""
    need = {w: 3.0 if w in CONTROLS + ("fault:unchanged",) else 10.0 for w in least}
    ok = {w: v for w, v in least.items() if v >= need[w] * lower}
    if not training and any(w in CONTROLS for w in ok):
        ok = {w: v for w, v in ok.items() if w in CONTROLS}
    return min(((v, w) for w, v in ok.items()), default=None)


def set_limits(cell: str, lines, training: bool) -> dict:
    """The cell's limits and readings from ``calibrate`` lines of that cell."""
    by = {}
    for r in lines:
        if r["cell"] == cell:
            by.setdefault(r["as"], []).append(r)
    if len(by.get("program", [])) < 3:
        raise ValueError(f"{cell}: too few program readings")
    limits, readings = {}, {}
    for k in by["program"][0]["numbers"]:
        lower = max(r["numbers"][k] for r in by["program"])
        least = {w: min(r["numbers"][k] for r in rs) for w, rs in by.items() if w != "program"}
        entry = {"lower": lower, "program_seeds": len(by["program"]), "others": least}
        up = _upper(lower, least, training)
        if up is not None:
            limit = float(f"{lower ** 0.4 * up[0] ** 0.6:.2g}")
            entry.update(upper=up[0], upper_from=up[1], limit=limit)
            limits[k] = limit
        readings[k] = entry
    return {"limits": limits, "readings": readings}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", help="comma-separated")
    ap.add_argument("--as", dest="who", default="program")
    ap.add_argument("--set-limits", nargs="+", metavar="READINGS")
    args = ap.parse_args(argv)
    if args.set_limits:
        lines = [json.loads(x) for f in args.set_limits for x in open(f) if x.strip()]
        kind = manifest.traffic(manifest.cell(manifest.load(), args.workload)["traffic"])["kind"]
        out = set_limits(args.workload, lines, kind == "train")
        path = manifest.ROOT / "workloads" / f"{args.workload}.json"
        path.write_text(json.dumps(out, indent=1) + "\n")
        print(json.dumps(out))
        return 0
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    bench = manifest.load()
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(bench, args.workload, seed, args.who)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
