"""The port's spans in a synthetic hosted pass: host, device and idle
seconds of each phase, kernels launched from another thread counted to the
span open at their launch, and the per-layer readers of the phases."""

import types

import pytest

from portbench.harness import phases
from portbench.harness.spec import Spec
from portbench.harness.trace import Trace


def _ev(cat, name, ts, dur, tid=1, corr=None, pid=7):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, tid=1, pid=7):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid, corr=corr, pid=pid)


def _kernel(ts, dur, corr):
    return _ev("kernel", f"k{corr}", ts, dur, tid=9, corr=corr)


# one update on the loop's thread (1); the backward's kernels are launched
# from the autograd engine's thread (2) while thread 1 waits in the span
EVENTS = [
    _ev("user_annotation", "train.data_wait", 0, 20),
    _ev("user_annotation", "train.step", 20, 180),
    _ev("user_annotation", "train.forward", 20, 60),
    _ev("user_annotation", "train.backward", 80, 70),
    _ev("user_annotation", "train.update", 150, 40),
    _ev("user_annotation", "ProfilerStep#3", 0, 230),
    _ev("cpu_op", "autograd::engine::evaluate_function", 85, 60, tid=2),
    _launch(10, 1), _kernel(12, 6, 1),               # data wait: the gather
    _launch(25, 2), _kernel(30, 30, 2),              # forward
    _launch(90, 3, tid=2), _kernel(95, 15, 3),       # backward, thread 2
    _launch(100, 4, tid=2), _kernel(130, 15, 4),     # backward, thread 2
    _launch(160, 5), _kernel(170, 10, 5),            # update
    _launch(195, 6), _kernel(196, 3, 6),             # the step outside its phases
    _launch(210, 7, tid=2), _kernel(215, 5, 7),      # no span
    _launch(90, 8, pid=8), _kernel(230, 10, 8),      # another process, no span
]
# device intervals 12-18, 30-60, 95-110, 130-145, 170-180, 196-199, 215-220,
# 230-240; the gaps' middles: 24 and 77.5 forward, 120 backward, 157.5 and
# 188 update, 207 and 225 no span
WANT = {  # span: (host, device, idle) in microseconds
    "train.data_wait": (20, 6, 0),
    "train.step": (180, 73, 12 + 35 + 20 + 25 + 16),
    "train.forward": (60, 30, 12 + 35),
    "train.backward": (70, 30, 20),
    "train.update": (40, 10, 25 + 16),
}


@pytest.fixture(scope="module")
def trace():
    return Trace(EVENTS, window_s=1e-3)


@pytest.mark.parametrize("span", sorted(WANT))
def test_host_device_and_idle_seconds(trace, span):
    host, device, idle = WANT[span]
    assert phases.host_seconds(trace, span) == pytest.approx(host * 1e-6)
    assert phases.device_seconds(trace, span) == pytest.approx(device * 1e-6)
    assert phases.idle_seconds(trace, span) == pytest.approx(idle * 1e-6)


def test_a_kernel_counts_by_the_time_of_its_launch_not_its_thread(trace):
    """Thread 2 opened no span, yet its launches inside thread 1's backward
    count to it; the same-thread match of the benchmark's own spans would
    give the backward nothing."""
    one = Trace([e for e in EVENTS if e.get("tid") != 2 or e["cat"] == "kernel"],
                window_s=1e-3)
    assert phases.device_seconds(one, "train.backward") == 0.0
    assert phases.device_seconds(trace, "train.backward") == pytest.approx(30e-6)


def test_nested_ranges_of_one_span_count_once():
    events = EVENTS + [_ev("user_annotation", "train.forward", 30, 20)]  # nested in 20-80
    assert phases.host_seconds(Trace(events, 1e-3), "train.forward") == pytest.approx(60e-6)


@pytest.mark.parametrize("quantity", [phases.host_seconds, phases.device_seconds,
                                      phases.idle_seconds])
def test_a_span_that_never_ran_reads_none(trace, quantity):
    assert quantity(trace, "train.checkpoint") is None
    # a program without the spans: only the benchmark's own ranges
    bare = Trace([e for e in EVENTS if not e["name"].startswith("train.")], 1e-3)
    assert quantity(bare, "train.forward") is None


READERS = {  # reader: (quantity, span)
    "data_wait_ms": (0, "train.data_wait"),
    "fwd_device_ms": (1, "train.forward"),
    "bwd_device_ms": (1, "train.backward"),
    "update_device_ms": (1, "train.update"),
    "fwd_idle_ms": (2, "train.forward"),
    "bwd_idle_ms": (2, "train.backward"),
    "update_idle_ms": (2, "train.update"),
}
SPEC = Spec()
NEW = [m for m in SPEC.data["per_layer"] if m["source"] == "program_span"]


def test_the_entries_are_the_seven_readers_in_both_cells():
    assert sorted(m["name"] for m in NEW) == sorted(
        f"{r}.{c}" for r in READERS for c in ("train", "train_256"))
    for m in NEW:
        assert m["unit"] == "ms" and m["better"] == "lower"
        cell, moves = (("train.dit_s4_256.b64", "train_images_per_s_256")
                       if m["name"].endswith("_256") else
                       ("train.celeba64_attn.b128", "train_images_per_s"))
        assert m["workloads"] == [cell] and m["moves"] == moves


@pytest.mark.parametrize("metric", NEW, ids=lambda m: m["name"])
def test_each_entry_reads_its_span_per_traced_update(trace, metric):
    stem = metric["name"].split(".")[0]
    reader = SPEC.reader(metric["name"])
    assert reader.__file__.endswith(f"metrics/{stem}.train.py")
    quantity, span = READERS[stem]
    ctx = types.SimpleNamespace(trace=trace, layer={"traced_updates": 2})
    assert reader.read(ctx) == pytest.approx(1e3 * WANT[span][quantity] * 1e-6 / 2)
    assert reader.read(types.SimpleNamespace(trace=trace, layer={})) is None
    assert reader.read(types.SimpleNamespace(trace=None, layer={"traced_updates": 2})) is None
    bare = Trace([e for e in EVENTS if not e["name"].startswith("train.")], 1e-3)
    assert reader.read(types.SimpleNamespace(trace=bare, layer={"traced_updates": 2})) is None
