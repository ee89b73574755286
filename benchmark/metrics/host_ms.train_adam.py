"""Host milliseconds of Adam in one train step: the program's
``posendf.train.adam`` span (``optimizer.step()``) inside each
``posendf.train.step``, median over the steps."""

from benchmark import manifest

_spans = manifest.metric_module("host_ms.train_pack")


def read(w):
    s = _spans.per_unit(w, "posendf.train.step", lambda n: n == "posendf.train.adam")
    return None if s is None else 1e3 * s
