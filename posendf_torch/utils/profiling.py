"""Profiling and debugging hooks.

Port of ``posendf_tpu/utils/profiling.py``: a ``torch.profiler`` trace
behind a flag (a Chrome trace, viewable in ``chrome://tracing`` or
Perfetto), a light step timer, and the NaN-debugging switch.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

__all__ = ["trace", "StepTimer", "enable_nan_debugging"]


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the block (the CPU, and the card
    when there is one) and write it to ``log_dir/trace.json`` (a Chrome
    trace; a rank of a process group writes ``trace_rank<r>.json``). A no-op
    when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    name = "trace.json"
    if dist.is_available() and dist.is_initialized():
        name = f"trace_rank{dist.get_rank()}.json"
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, name))


def enable_nan_debugging() -> None:
    """Make the backward pass raise at the operation that produced a NaN
    (``torch.autograd.set_detect_anomaly``); slow, for debugging."""
    import torch

    torch.autograd.set_detect_anomaly(True)


class StepTimer:
    """Cheap wall-clock step timer with an exponential moving average."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt
        return dt
