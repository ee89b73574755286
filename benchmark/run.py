#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names a configuration and a traffic mix; the run makes the
weights and the inputs on the card from the seed, builds the program
(``posendf_torch``), warms the cell's shapes (set-up), then dispatches units of
the mix's work for ``--seconds``, a bounded number in flight, with one
synchronise at the end. ``--trace 0`` reports the cell's end-to-end metrics;
``--trace 1`` runs the same window under ``torch.profiler`` and reports its
per-layer metrics. Then the program's state is freed and the check compares
what the window produced with the plain reference (``reference/``); the
numbers compared and their limits are printed last on standard error and last
in the result. Without a CUDA device, or with fewer than the cell asks for, it
exits with 3 and prints no result; if the JAX stack or the JAX package is
loaded once the window has closed, with 4.
"""

from __future__ import annotations

import time

_STARTED = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))
# every cache a run may write stays at a fixed path inside the checkout (the
# program's kernels build into its own build/posendf_torch/ there)
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(CHECKOUT / "build" / "bench_cache" / _sub)

import torch  # noqa: E402

from benchmark import devtrace, inputs, manifest, program  # noqa: E402

__all__ = ["Run", "Window", "run_cell", "main"]


def process_start() -> float:
    """The wall-clock time this process started (from /proc), or the time
    this module began to load where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _STARTED


class Run:
    """What a cell's run is given: its configuration, mix, seed, device and weights."""

    def __init__(self, bench: dict, cell_name: str, seed: int, device, traffic=None):
        self.cell = manifest.cell(bench, cell_name)
        self.name = cell_name
        self.config = manifest.config(bench, self.cell["config"])
        self.traffic = traffic if traffic is not None else manifest.traffic(self.cell["traffic"])
        self.spec = inputs.model_spec(self.config)
        self.seed = seed
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.host_gen = torch.Generator().manual_seed(seed)     # what the check samples
        self.weights = inputs.make_weights(self.spec, self.gen)


class Window:
    """What the measured window did, as the per-layer metrics read it."""

    def __init__(self, run: Run, work, units: int, seconds: float, dispatch_s, trace):
        self.run, self.work = run, work
        self.spec, self.traffic = run.spec, run.traffic
        self.units, self.seconds, self.dispatch_s, self.trace = units, seconds, dispatch_s, trace

    def flops(self) -> float:
        return self.work.flops(self.units)


class _HostMark:
    """Stand-in for a CUDA event on the CPU: the work is done when dispatched."""

    def record(self) -> None:
        pass

    def synchronize(self) -> None:
        pass


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mark(device: torch.device):
    return torch.cuda.Event() if device.type == "cuda" else _HostMark()


def _measure(run: Run, work, seconds: float, span):
    """Dispatch units of work until ``seconds`` have passed, at most
    ``work.in_flight`` ahead of the last one finished, then synchronise.
    Returns (units, window start (wall clock), window seconds, dispatch seconds)."""
    marks, dispatch_s = [], []
    wall0 = time.time()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    with span("bench.window"):
        while True:
            if i >= work.in_flight:
                with span("bench.wait"):
                    marks[i - work.in_flight].synchronize()
            now = time.perf_counter()
            if i and now >= deadline:
                break
            with span("bench.dispatch"):
                work.dispatch(i)
            dispatch_s.append(time.perf_counter() - now)
            mark = _mark(run.device)
            mark.record()
            marks.append(mark)
            i += 1
        with span("bench.drain"):
            _sync(run.device)
    return i, wall0, time.perf_counter() - t0, dispatch_s


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


class ForbiddenModules(RuntimeError):
    """The JAX stack or the JAX package was found loaded once the window closed."""

    def __init__(self, found):
        super().__init__("loaded after the window: " + ", ".join(found))
        self.found = found


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
             device="cuda", traffic=None, started: float = None):
    """One run of a cell: returns (result dict, lines for standard error), or
    raises. ``traffic`` replaces the cell's mix (the tests run small ones)."""
    started = process_start() if started is None else started
    run = Run(bench, cell_name, seed, device, traffic)
    limits = manifest.limits(cell_name)
    kind = manifest.kind_module(run.traffic["kind"])
    work = kind.Work(run)
    _sync(run.device)
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if run.device.type == "cuda" else [])
        prof = profile(activities=acts)
        span = record_function
    else:
        span = lambda name: contextlib.nullcontext()  # noqa: E731
    ctx = prof if prof is not None else contextlib.nullcontext()
    with ctx:
        units, wall0, window_s, dispatch_s = _measure(run, work, seconds, span)
    setup_s = wall0 - started
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    found = program.forbidden_modules()
    if found:
        raise ForbiddenModules(found)

    metrics, device_info, breakdown, lines = {}, {}, None, []
    if trace:
        tr = devtrace.read(prof) if run.device.type == "cuda" else None
        window = Window(run, work, units, window_s, dispatch_s, tr)
        for m in manifest.per_layer(bench, cell_name):
            value = manifest.metric_module(m["name"]).read(window)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if tr is not None:
            device_info = {"busy_s": tr.busy_s, "window_s": tr.window_s,
                           "power_limit": _power_limit()}
            breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
            lines.append(f"card and power limit: {device_info['power_limit']}")
    else:
        values = {"setup_s": setup_s, kind.RATE: units * work.poses_per_unit / window_s}
        for m in manifest.end_to_end(bench, cell_name):
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    work.free()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, failed = work.check()
    check_s = time.perf_counter() - t_check
    checks = {k: {"value": float(numbers[k]), "limit": v} for k, v in limits.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]

    result = {"correct": bool(correct), "attempted": units, "failed": failed, "metrics": metrics,
              "check_s": check_s}
    if run.device.type == "cuda":
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
                            "count": 1, "memory_peak_bytes": int(peak), **device_info}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = process_start()
    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    try:
        result, lines = run_cell(bench, args.workload, args.seed, args.seconds,
                                 bool(args.trace), "cuda", started=started)
    except ForbiddenModules as e:
        print(f"the JAX stack or the JAX package is loaded: {', '.join(e.found)}",
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
