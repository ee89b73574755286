"""Host milliseconds of the loss and gradient in one train step: the program's
``posendf.train.grads`` span (``fused_train_grads``) inside each
``posendf.train.step``, median over the steps."""

from benchmark import manifest

_spans = manifest.metric_module("host_ms.train_pack")


def read(w):
    s = _spans.per_unit(w, "posendf.train.step", lambda n: n == "posendf.train.grads")
    return None if s is None else 1e3 * s
