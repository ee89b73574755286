"""Host milliseconds of one forward call: the program's ``posendf.forward``
span (``Field.distance_fused``: the weights' key check, the allocation and
the launch), median over the window's calls."""

import statistics

from benchmark import manifest

_spans = manifest.metric_module("host_ms.train_pack")


def read(w):
    calls = _spans.spans(w, "posendf.forward")
    return 1e3 * statistics.median(e - s for s, e in calls) if calls else None
