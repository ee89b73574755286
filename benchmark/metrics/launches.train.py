"""Calls that enqueue device work in one train step: the CUDA API calls that
launch a kernel or start a copy or a set (``cudaLaunch*``, ``cuLaunch*``,
``cudaMemcpy*``, ``cudaMemset*``) inside each of the program's
``posendf.train.step`` spans, median over the steps."""

from benchmark import manifest

_spans = manifest.metric_module("host_ms.train_pack")
_ENQUEUE = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


def read(w):
    return _spans.per_unit(w, "posendf.train.step", lambda n: n.startswith(_ENQUEUE), count=True)
