"""The reduction of a ``torch.profiler`` trace to device time, idle time and kernels.

The traced run records the CPU and the card (CUPTI) over the measured window,
marked by the benchmark's own spans (``record_function``): ``bench.window``
around the whole window, ``bench.dispatch`` around each call into the program,
``bench.wait`` where the host waits for a unit of work in flight to finish and
``bench.drain`` for the final synchronise. The trace is written as a Chrome
trace under ``TMPDIR``, read back and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

__all__ = ["Trace", "read"]

_DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}
_HOST = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function"}
_TOP = 10


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _top(totals: Dict[str, float], rest: str) -> List[list]:
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])
    if len(ranked) > _TOP:
        ranked = ranked[:_TOP - 1] + [(rest, sum(v for _, v in ranked[_TOP - 1:]))]
    return [[k, v] for k, v in ranked]


@dataclass
class Trace:
    """Device operations and host spans of the traced window, times in seconds."""

    window: Tuple[float, float]
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def _busy(self) -> List[Tuple[float, float]]:
        a, b = self.window
        return _merge([(max(s, a), min(e, b)) for _, s, e in self.device if e > a and s < b])

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the device."""
        return sum(e - s for s, e in self._busy())

    def kernel_time(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """Total seconds and launches of the device operations whose name matches."""
        hits = [e - s for n, s, e in self.device if match(n)]
        return sum(hits), len(hits)

    def device_ops(self) -> List[list]:
        """[name, seconds] of the device operations that took most time."""
        totals: Dict[str, float] = {}
        for n, s, e in self.device:
            totals[n] = totals.get(n, 0.0) + (e - s)
        return _top(totals, "other device operations")

    def idle_gaps(self) -> List[list]:
        """[what the host was doing, seconds] of the device's idle time in the
        window, summed by the host span that overlaps each gap most (the
        shorter one on a tie)."""
        a, b = self.window
        edges = [a] + [t for s, e in self._busy() for t in (s, e)] + [b]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host, key=lambda h: h[1])
        totals: Dict[str, float] = {}
        active: List[Tuple[str, float, float]] = []
        i = 0
        for g0, g1 in gaps:      # in time order: a sweep over the host spans
            while i < len(host) and host[i][1] < g1:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[2] > g0]
            best, key = "no host span", (0.0, 0.0)
            for n, s, e in active:
                ov = min(e, g1) - max(s, g0)
                if ov > 0 and (ov, -(e - s)) > key:
                    best, key = n, (ov, -(e - s))
            totals[best] = totals.get(best, 0.0) + (g1 - g0)
        return _top(totals, "other host spans")


def read(prof) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    events = events["traceEvents"] if isinstance(events, dict) else events
    window, device, host = None, [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        if cat in _DEVICE:
            device.append((name, s, e))
        elif cat in _HOST:
            if name == "bench.window":
                window = (s, e)
            else:
                host.append((name, s, e))
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    return Trace(window=window, device=device, host=host)
