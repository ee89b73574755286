"""What the per-layer metrics share: each file in ``metrics/`` is one call of these.

Every reader takes the run's :class:`~benchmark.run.Window` and returns a
number, or None where it finds nothing to read (no trace, no kernel of its
name); the run then leaves the metric out.
"""

from __future__ import annotations

import statistics
from typing import Callable, Optional

from benchmark import costs

__all__ = ["dispatch_ms", "mfu", "idle_share", "roofline"]


def dispatch_ms(w) -> Optional[float]:
    """The median host time of one call into the program, before any
    synchronise: what the host pays to enqueue a unit of work."""
    return 1e3 * statistics.median(w.dispatch_s) if w.dispatch_s else None


def mfu(w) -> Optional[float]:
    """The model's operations of the units completed in the window over the
    window times the peak (``costs``), in %."""
    return 100.0 * w.flops() / (w.seconds * costs.PEAK_TF32) if w.units else None


def idle_share(w) -> Optional[float]:
    """The share of the traced window with no operation on the device, in %."""
    if w.trace is None or not w.trace.device:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.trace.window_s)


def roofline(w, match: Callable[[str], bool], per_launch: Callable[[str], bool],
             least_s: float) -> Optional[float]:
    """The least time of one launch's work (``least_s``) over the mean device
    time a launch takes, in %. ``match`` picks the device operations whose
    time counts, ``per_launch`` the one counted once a launch."""
    if w.trace is None:
        return None
    total, _ = w.trace.kernel_time(match)
    _, launches = w.trace.kernel_time(per_launch)
    if not launches or total <= 0:
        return None
    return 100.0 * least_s / (total / launches)
