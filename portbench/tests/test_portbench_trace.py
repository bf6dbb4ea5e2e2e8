"""The reduction of a Chrome trace: busy time as the union of device
intervals, kernels counted to the span they were launched in, idle gaps
named by the host event around them."""

import pytest

from portbench.harness.trace import SPAN_PREFIX, Trace


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _ev("user_annotation", SPAN_PREFIX + "m:gn", 0, 10),
    _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=1),
    _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=2),        # outside the span
    _ev("user_annotation", SPAN_PREFIX + "m:gn", 20, 5, tid=2),
    _ev("cuda_runtime", "cudaLaunchKernel", 21, 1, tid=2, corr=3),
    _ev("cpu_op", "aten::copy_", 40, 30),
    _ev("kernel", "gn_silu_fwd", 100, 50, tid=9, corr=1),
    _ev("kernel", "other", 140, 20, tid=9, corr=2),               # overlaps the first
    _ev("kernel", "gn_silu_fwd", 200, 10, tid=9, corr=3),
    _ev("gpu_memcpy", "Memcpy HtoD", 210, 5, tid=9),
]


def test_busy_spans_and_ops():
    tr = Trace(EVENTS, window_s=1e-3)
    assert tr.busy_s == pytest.approx((60 + 15) * 1e-6)
    assert tr.span_seconds("m:gn") == pytest.approx(60e-6)
    assert tr.span_seconds("m:missing") is None
    assert tr.top_ops(2) == [["gn_silu_fwd", pytest.approx(60e-6)], ["other", pytest.approx(20e-6)]]


def test_idle_gaps_are_named_by_the_host():
    events = EVENTS + [_ev("cpu_op", "aten::sleep", 150, 60, tid=3)]
    gaps = Trace(events, window_s=1e-3).idle_gaps(3)
    assert gaps == [["aten::sleep", pytest.approx(40e-6)]]
