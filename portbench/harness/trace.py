"""The traced slice: ``torch.profiler`` over a few whole updates or
batches, the benchmark's spans around the port's op entry points, and the
reduction of the Chrome trace to device busy time, idle gaps, kernel time
by name and kernel time by span.

A span is ``"<module>:<function>"`` of the port.  While the slice runs the
function is replaced in its module by a wrapper that opens a
``record_function`` range named after the span, so every kernel launched
under the call (found through the launch's correlation id, on the thread
and within the time of the range) is counted to it.  The port looks its op
wrappers up in their module when it calls them, so the forward, the
backward and the no-grad path all pass through the wrapper.  A span whose
function is gone leaves nothing to read: its metrics come out empty.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import json
import os
import tempfile
from typing import Dict, Iterable, List, Optional, Tuple

import torch

__all__ = ["spans", "Trace", "record"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
SPAN_PREFIX = "portbench::"


@contextlib.contextmanager
def spans(names: Iterable[str]):
    """Wrap each ``module:function`` in a ``record_function`` range while
    the block runs; restore the module after."""
    undo = []
    try:
        for name in sorted(set(names)):
            mod_name, fn_name = name.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name, None)
            if fn is None:
                continue

            def wrapped(*a, __fn=fn, __label=SPAN_PREFIX + name, **kw):
                with torch.profiler.record_function(__label):
                    return __fn(*a, **kw)

            functools.update_wrapper(wrapped, fn)
            setattr(mod, fn_name, wrapped)
            undo.append((mod, fn_name, fn))
        yield
    finally:
        for mod, fn_name, fn in reversed(undo):
            setattr(mod, fn_name, fn)


class Trace:
    """The reduced slice.  Device busy seconds (the union of device
    intervals), the window and the kernel seconds by name come from the
    timeline pass, traced with the device's activity alone, so the host
    runs as it does untraced.  Kernel seconds by span and the idle gaps,
    named by what the host was doing, come from the pass traced with the
    host's events as well (all threads), whose host is slower."""

    def __init__(self, events: List[dict], window_s: float,
                 hosted: Optional[List[dict]] = None):
        self.window_s = float(window_s)
        self.kernels = _device(events)
        self.by_name: Dict[str, float] = {}
        for s, t, name, _ in self.kernels:
            self.by_name[name] = self.by_name.get(name, 0.0) + (t - s) * 1e-6
        self.intervals = _union([(s, t) for s, t, _, _ in self.kernels])
        self.busy_s = sum(t - s for s, t in self.intervals) * 1e-6
        hosted = events if hosted is None else hosted
        self._hosted_kernels = _device(hosted)
        host = [e for e in hosted if e.get("ph") == "X" and e.get("cat") in _HOST_CATS]
        self._host = host
        self._launch = {}
        for e in host:
            c = (e.get("args") or {}).get("correlation")
            if c is not None and e.get("cat") in ("cuda_runtime", "cuda_driver"):
                self._launch[c] = (e.get("pid"), e.get("tid"), float(e["ts"]))
        self._ranges: Dict[str, List[Tuple]] = {}
        for e in host:
            if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(SPAN_PREFIX):
                key = e["name"][len(SPAN_PREFIX):]
                self._ranges.setdefault(key, []).append(
                    (e.get("pid"), e.get("tid"), float(e["ts"]), float(e["ts"]) + float(e["dur"])))

    def span_seconds(self, name: str) -> Optional[float]:
        """Device seconds of the kernels launched inside span ``name``
        (None when the span never ran in the slice)."""
        ranges = self._ranges.get(name)
        if not ranges:
            return None
        by_thread: Dict[Tuple, List[Tuple[float, float]]] = {}
        for pid, tid, s, t in ranges:
            by_thread.setdefault((pid, tid), []).append((s, t))
        for v in by_thread.values():
            v.sort()
        total = 0.0
        for s, t, _name, corr in self._hosted_kernels:
            launch = self._launch.get(corr)
            if launch is None:
                continue
            rs = by_thread.get(launch[:2])
            if not rs:
                continue
            i = bisect.bisect_right(rs, (launch[2], float("inf"))) - 1
            # ranges of one thread nest or follow each other: look back
            while i >= 0:
                if rs[i][0] <= launch[2] <= rs[i][1]:
                    total += (t - s) * 1e-6
                    break
                i -= 1
        return total

    def top_ops(self, k: int = 10) -> List[list]:
        return [[n, s] for n, s in sorted(self.by_name.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest gaps between device intervals of the hosted
        pass, each named by the shortest host event that spans its middle."""
        iv = _union([(s, t) for s, t, _, _ in self._hosted_kernels])
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(iv, iv[1:]) if b[0] > a[1]),
                      reverse=True)
        out = []
        for length, s, t in gaps[:k]:
            mid = 0.5 * (s + t)
            best = None
            for e in self._host:
                es = float(e["ts"])
                if es <= mid <= es + float(e.get("dur", 0.0)):
                    if best is None or float(e.get("dur", 0.0)) < float(best.get("dur", 0.0)):
                        best = e
            out.append([best.get("name", "?") if best else "host: no event", length * 1e-6])
        return out


def _device(events: List[dict]) -> List[Tuple]:
    out = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", "?"),
            (e.get("args") or {}).get("correlation"))
           for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    out.sort()
    return out


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, t in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def record(drive, warmup: int, active: int, span_names: Iterable[str]) -> Trace:
    """Profile ``drive(tick, name)`` twice: each call does ``warmup +
    active`` units of work (updates, rounds of requests) and calls
    ``tick()`` after each, and the last ``active`` are traced.  The first
    pass (``"timeline"``) traces the device alone; its window is the host
    time from the end of the warm-up to the device's end of the last unit.
    The second (``"hosted"``) traces the host's events on every thread too,
    with the spans in place."""
    cuda = torch.profiler.ProfilerActivity.CUDA
    timeline, window_s = _profile(drive, "timeline", warmup, active, [cuda], ())
    hosted, _ = _profile(drive, "hosted", warmup, active,
                         [torch.profiler.ProfilerActivity.CPU, cuda], span_names)
    return Trace(timeline, window_s, hosted)


def _all_threads():
    """The profiler's option to record every thread's host events (client
    threads of a service included), where this torch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def _profile(drive, name, warmup, active, acts, span_names):
    import time

    marks: List[float] = []
    done = [0]
    sched = torch.profiler.schedule(wait=0, warmup=warmup, active=active, repeat=1)
    extra = _all_threads() if torch.profiler.ProfilerActivity.CPU in acts else {}
    with spans(span_names):
        with torch.profiler.profile(activities=acts, schedule=sched, **extra) as prof:
            def tick():
                done[0] += 1
                if done[0] in (warmup, warmup + active):
                    torch.cuda.synchronize()
                    marks.append(time.perf_counter())
                if done[0] <= warmup + active:
                    prof.step()

            drive(tick, name)
    if len(marks) != 2:
        raise RuntimeError(f"the traced slice ran {done[0]} of {warmup + active} units")
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return events, marks[1] - marks[0]
