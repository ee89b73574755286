"""Profiling and debugging hooks.

Port of ``posendf_tpu/utils/profiling.py``: a ``torch.profiler`` trace
behind a flag (a Chrome trace, viewable in ``chrome://tracing`` or
Perfetto), the program's spans, the set-up record and the NaN-debugging
switch.

Spans (:func:`span`) mark the program's layer boundaries, named
``posendf.<layer>.<part>``:

* ``posendf.train.step``: one call of ``make_train_step``'s step, holding
  ``posendf.train.pack`` (the kernels' view of the weights and its packs),
  ``posendf.train.grads`` (the loss and the gradient), ``posendf.train.allreduce``
  (under a mesh) and ``posendf.train.adam`` (``optimizer.step()``);
* ``posendf.project``: one ``project(..., fused=True)``, holding two
  ``posendf.project.prepare`` spans (``Field.weights()``; then
  ``fused_project``'s checks, pose copy and scratch) and
  ``posendf.project.steps`` (the loop of step launches);
* ``posendf.forward``: one ``Field.distance_fused`` call.

They are the profiler's own user annotations (``record_function``), so they
share its clock with the device's kernel events, and they exist only while
a ``torch.profiler`` records: ``trace`` here, ``cli train --profile``, or
any profiler a caller opens around a call. Otherwise a span costs one check.
"""

from __future__ import annotations

import contextlib
import os
from typing import ContextManager, Dict, Iterator, Optional

import torch

__all__ = ["trace", "span", "SETUP_S", "enable_nan_debugging"]

# whether a torch profiler records in this process: a C call of about 0.07 us,
# where entering a record_function costs about 12 us even with none recording
_profiling = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()

# seconds the process's first call of a set-up function took, by its name: only
# "make_optimizer" (training/trainer.py), whose torch.optim.Adam loads torch._dynamo
SETUP_S: Dict[str, float] = {}


def span(name: str) -> ContextManager:
    """A ``torch.profiler.record_function(name)`` while a torch profiler
    records, else one shared no-op context."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the block (the CPU, and the card
    when there is one) and write it to ``log_dir/trace.json`` (a Chrome
    trace; a rank of a process group writes ``trace_rank<r>.json``). A no-op
    when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
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
    torch.autograd.set_detect_anomaly(True)
