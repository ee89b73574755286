"""Host milliseconds of the weights' pack in one train step: the program's
``posendf.train.pack`` span inside each ``posendf.train.step`` span of the
traced window, median over the steps.

The program's spans are ``torch.profiler`` user annotations, read from the
trace's host events (``devtrace.Trace.host``); an event belongs to the span
that holds its midpoint. :func:`spans` and :func:`per_unit` are the span
readers' shared reduction: the other ``host_*`` and ``launches.*`` files load
them from here (``manifest.metric_module``). Each returns None where the
trace holds no span of the unit's name, as from a program without spans.
"""

import bisect
import statistics


def _mid(s, e):
    return 0.5 * (s + e)


def spans(w, name):
    """(start, end) of the host spans named ``name`` in the traced window; []
    without a trace."""
    if w.trace is None:
        return []
    a, b = w.trace.window
    return [(s, e) for n, s, e in w.trace.host if n == name and a <= _mid(s, e) <= b]


def per_unit(w, unit, pick, count=False):
    """Median, over the ``unit`` spans of the traced window, of the seconds
    (with ``count``: the number) of the host events whose name ``pick`` takes
    inside each; None where there is no ``unit`` span."""
    units = spans(w, unit)
    if not units:
        return None
    parts = sorted((_mid(s, e), e - s) for n, s, e in w.trace.host if pick(n))
    mids = [m for m, _ in parts]
    values = []
    for s0, e0 in units:
        got = [d for _, d in parts[bisect.bisect_left(mids, s0):bisect.bisect_right(mids, e0)]]
        values.append(len(got) if count else sum(got))
    return statistics.median(values)


def read(w):
    s = per_unit(w, "posendf.train.step", lambda n: n == "posendf.train.pack")
    return None if s is None else 1e3 * s
