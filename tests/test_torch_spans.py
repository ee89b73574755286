"""The port's spans (``utils/profiling.py``) and the benchmark's readers of them, on the CPU.

Under a CPU ``torch.profiler`` the train step, the fused projection and the
fused forward emit their ``posendf.*`` spans, nested as named; with no
profiler a span is one shared no-op that never builds a ``record_function``.
The benchmark's span readers (``benchmark/metrics/``) read a trace that
``benchmark.devtrace.read`` builds from a CPU profile of real calls inside a
``bench.window`` span, and read nothing from a program without spans.
"""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from benchmark import devtrace, manifest  # noqa: E402
from posendf_torch import make_field  # noqa: E402
from posendf_torch.models import PoseNDF  # noqa: E402
from posendf_torch.parallel.mesh import make_mesh  # noqa: E402
from posendf_torch.projection import project, random_poses  # noqa: E402
from posendf_torch.training.trainer import make_optimizer, make_train_step  # noqa: E402
from posendf_torch.utils import profiling  # noqa: E402
from tests.tc_model import one_thread  # noqa: E402, F401

pytestmark = pytest.mark.usefixtures("one_thread")

STEPS = 3        # projection steps a call
UNITS = 3        # calls a traced window
TRAIN = ("posendf.train.step", ["posendf.train.pack", "posendf.train.grads", "posendf.train.adam"])
# each call's spans: the outer span, then the spans inside it in the order they open
SPANS = {
    "train": TRAIN,
    "train-autodiff": ("posendf.train.step", ["posendf.train.grads", "posendf.train.adam"]),
    "train-mesh": ("posendf.train.step", ["posendf.train.pack", "posendf.train.grads",
                                          "posendf.train.allreduce", "posendf.train.adam"]),
    "train-autodiff-mesh": ("posendf.train.step", ["posendf.train.grads",
                                                   "posendf.train.allreduce",
                                                   "posendf.train.adam"]),
    "project": ("posendf.project", ["posendf.project.prepare", "posendf.project.prepare",
                                    "posendf.project.steps"]),
    "forward": ("posendf.forward", []),
}


def _module():
    return PoseNDF(dfnet_dims=(32, 48), activation="lrelu", live_head=True, device="cpu")


def _call(kind: str):
    """A function making one call of ``kind`` on a small lrelu field."""
    gen = torch.Generator().manual_seed(7)
    poses = random_poses(gen, 16)
    if kind.startswith("train"):
        module = _module()
        step = make_train_step(module, make_optimizer(module.parameters(), 1e-3), loss_type="l1",
                               weights={"dist": 1.0, "man_loss": 1.0, "eikonal": 1.0},
                               fused="autodiff" not in kind,
                               mesh=make_mesh(device="cpu") if "mesh" in kind else None)
        batch = {"pose": poses, "dist": torch.rand(16, generator=gen),
                 "man_poses": random_poses(gen, 12)}
        return lambda: step(batch)
    field = make_field(_module())
    if kind == "project":
        return lambda: project(field, poses, steps=STEPS, step_scale=10.0, fused=True)
    return lambda: field.distance_fused(poses)


def _traced(call, units: int = UNITS) -> devtrace.Trace:
    """The benchmark's trace of ``units`` calls inside a ``bench.window`` span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    call()      # the first call's lazy set-up stays outside the window
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            for _ in range(units):
                call()
    return devtrace.read(prof)


def _window(kind: str, trace=None) -> SimpleNamespace:
    """What a metric reader is given: the run's trace and its mix."""
    return SimpleNamespace(trace=trace if trace is not None else _traced(_call(kind)),
                           traffic={"steps": STEPS})


def _ours(tr: devtrace.Trace):
    return sorted((s, e, n) for n, s, e in tr.host if n.startswith("posendf."))


@pytest.mark.parametrize("kind", list(SPANS))
def test_each_call_emits_its_spans_nested_as_named(kind):
    outer, inner = SPANS[kind]
    spans = _ours(_traced(_call(kind)))
    units = [(s, e) for s, e, n in spans if n == outer]
    assert len(units) == UNITS
    for s0, e0 in units:
        inside = [n for s, e, n in spans if s0 <= s and e <= e0 and n != outer]
        assert inside == inner
    assert len(spans) == UNITS * (1 + len(inner))


def test_without_a_profiler_a_span_is_the_shared_no_op(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function built with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)   # span's; Adam has its own
    first = profiling.span("posendf.test")
    assert first is profiling.span("posendf.other")
    with first:
        pass
    for kind in SPANS:
        _call(kind)()


def _read(metric: str, w) -> float:
    return manifest.metric_module(metric).read(w)


READERS = [("host_ms.train_pack", "train"), ("host_ms.train_grads", "train"),
           ("host_ms.train_adam", "train"), ("host_us.project_launch", "project"),
           ("host_ms.forward", "forward")]


@pytest.mark.parametrize("metric,kind", READERS)
def test_a_span_reader_reads_a_cpu_profile_of_real_calls(metric, kind):
    value = _read(metric, _window(kind))
    assert value is not None and value > 0


def test_the_step_holds_its_parts():
    """Each part is at most the step, and so are the three together, step by step."""
    w = _window("train")
    spans = manifest.metric_module("host_ms.train_pack")
    step_ms = 1e3 * spans.per_unit(w, TRAIN[0], lambda n: n == TRAIN[0])
    parts_ms = 1e3 * spans.per_unit(w, TRAIN[0], lambda n: n in TRAIN[1])
    assert 0 < parts_ms <= step_ms
    for metric in ("host_ms.train_pack", "host_ms.train_grads", "host_ms.train_adam"):
        assert 0 < _read(metric, w) <= parts_ms


def test_the_launch_reader_counts_the_calls_that_enqueue_inside_each_step():
    """The CPU profile has no CUDA runtime calls: 0. With a launch, a copy and an
    event record put inside each step (and a launch outside any), two a step."""
    tr = _traced(_call("train"))
    assert _read("launches.train", _window("train", tr)) == 0
    for s, e in [(s, e) for n, s, e in tr.host if n == "posendf.train.step"]:
        mid = 0.5 * (s + e)
        tr.host += [("cudaLaunchKernel", mid, mid + 1e-7), ("cudaMemcpyAsync", mid, mid + 1e-7),
                    ("cudaEventRecord", mid, mid + 1e-7), ("cuLaunchKernel", e + 1e-6, e + 2e-6)]
    assert _read("launches.train", _window("train", tr)) == 2


def test_make_optimizer_records_its_first_call_and_the_reader_reads_it():
    make_optimizer(_module().parameters(), 1e-3)
    first = profiling.SETUP_S["make_optimizer"]
    make_optimizer(_module().parameters(), 1e-3)
    assert profiling.SETUP_S == {"make_optimizer": first} and first > 0
    assert _read("setup_s.optimizer", SimpleNamespace(trace=None)) == first


@pytest.mark.parametrize("metric", [m for m, _ in READERS] + ["launches.train",
                                                             "setup_s.optimizer"])
def test_a_reader_reads_nothing_from_a_program_without_spans(metric, monkeypatch):
    """As from the program before it had spans: a window of plain torch calls,
    no trace at all, and no set-up record."""
    monkeypatch.delattr(profiling, "SETUP_S")
    plain = _traced(lambda: torch.ones(8, 8) @ torch.ones(8, 8))
    assert _read(metric, _window("plain", plain)) is None
    assert _read(metric, SimpleNamespace(trace=None, traffic={"steps": STEPS})) is None
