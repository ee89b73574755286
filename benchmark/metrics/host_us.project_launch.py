"""Host microseconds a projection step's launch takes: the program's
``posendf.project.steps`` span (the loop of step launches) over the mix's
``steps``, median over the window's projections."""

import statistics

from benchmark import manifest

_spans = manifest.metric_module("host_ms.train_pack")


def read(w):
    loops = _spans.spans(w, "posendf.project.steps")
    if not loops:
        return None
    return 1e6 * statistics.median(e - s for s, e in loops) / int(w.traffic["steps"])
