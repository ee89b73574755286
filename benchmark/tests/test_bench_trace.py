"""The trace reduction on a hand-made Chrome trace."""

import json

import pytest

from benchmark import devtrace


class _Prof:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace():
    return devtrace.read(_Prof([
        _ev("user_annotation", "bench.window", 0, 1000),
        _ev("user_annotation", "bench.dispatch", 0, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 5),
        _ev("kernel", "void field_kernel<0, false>(Args)", 100, 300),
        _ev("kernel", "void field_kernel<0, false>(Args)", 350, 250),    # overlaps the first
        _ev("user_annotation", "bench.wait", 600, 300),
        _ev("gpu_memset", "Memset (Device)", 700, 100),
        _ev("kernel", "void late_kernel()", 990, 50),                     # past the window's end
        {"ph": "i", "name": "marker", "ts": 5},
    ]))


def test_busy_window_and_kernel_time():
    tr = _trace()
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx((500 + 100 + 10) * 1e-6)
    total, n = tr.kernel_time(lambda name: "field_kernel<" in name)
    assert n == 2 and total == pytest.approx(550e-6)


def test_device_ops_and_idle_gaps_keep_all_time():
    tr = _trace()
    ops = dict(tr.device_ops())
    assert ops["void field_kernel<0, false>(Args)"] == pytest.approx(550e-6)
    assert set(ops) == {"void field_kernel<0, false>(Args)", "Memset (Device)", "void late_kernel()"}
    gaps = dict(tr.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s)
    assert gaps["bench.dispatch"] == pytest.approx(100e-6)
    assert gaps["bench.wait"] == pytest.approx(290e-6)   # [600, 700] and [800, 990]


def test_a_trace_without_the_window_span_is_refused():
    with pytest.raises(RuntimeError):
        devtrace.read(_Prof([_ev("kernel", "k", 0, 1)]))
