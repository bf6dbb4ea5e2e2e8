"""The port's own spans in a traced slice: host, device and idle seconds
of a phase of the update.

The port opens ``record_function`` ranges around the phases of its
training update (``train.data_wait``, ``train.step``, and inside the step
``train.forward``, ``train.backward`` and ``train.update``) while the
profiler runs.  They land in the hosted pass of the slice beside the
kernels, on the same clock.  This module reads that pass as
:class:`~portbench.harness.trace.Trace` holds it (its host events, its
kernels and their launches) and writes nothing to it.

For a span name:

- host seconds: the time inside the span's ranges, on the thread that
  opened each;
- device seconds: the device time of the kernels whose launch falls inside
  one of the span's ranges, on any thread of that process (the autograd
  engine launches the backward's kernels from a thread of its own while
  the caller waits in ``loss.backward()``);
- idle seconds: the gaps between the pass's device intervals whose middle
  falls inside one of the span's ranges.

Each is None when the span never ran in the slice (a program without the
span gives nothing to read).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from .trace import _union

__all__ = ["host_seconds", "device_seconds", "idle_seconds", "per_update_ms"]

Ranges = Dict[Tuple, List[Tuple[float, float]]]


def _ranges(trace, name: str, key) -> Ranges:
    """The union of span ``name``'s ranges (microseconds) grouped by
    ``key(event)``."""
    out: Ranges = {}
    for e in trace._host:
        if e.get("cat") == "user_annotation" and e.get("name") == name:
            s = float(e["ts"])
            out.setdefault(key(e), []).append((s, s + float(e.get("dur", 0.0))))
    return {k: _union(v) for k, v in out.items()}


def _inside(ranges: List[Tuple[float, float]], ts: float) -> bool:
    i = bisect.bisect_right(ranges, (ts, float("inf"))) - 1
    return i >= 0 and ranges[i][0] <= ts <= ranges[i][1]


def host_seconds(trace, name: str) -> Optional[float]:
    """Seconds inside span ``name``, each thread's ranges counted once."""
    by_thread = _ranges(trace, name, lambda e: (e.get("pid"), e.get("tid")))
    if not by_thread:
        return None
    return sum(t - s for rs in by_thread.values() for s, t in rs) * 1e-6


def device_seconds(trace, name: str) -> Optional[float]:
    """Device seconds of the kernels launched, on any thread of the
    process, while span ``name`` was open."""
    by_pid = _ranges(trace, name, lambda e: e.get("pid"))
    if not by_pid:
        return None
    total = 0.0
    for s, t, _name, corr in trace._hosted_kernels:
        launch = trace._launch.get(corr)
        if launch is not None and _inside(by_pid.get(launch[0], []), launch[2]):
            total += t - s
    return total * 1e-6


def idle_seconds(trace, name: str) -> Optional[float]:
    """Seconds of the gaps between device intervals whose middle falls
    while span ``name`` was open."""
    found = _ranges(trace, name, lambda e: None)
    if not found:
        return None
    ranges = found[None]
    iv = _union([(s, t) for s, t, _, _ in trace._hosted_kernels])
    return sum(b[0] - a[1] for a, b in zip(iv, iv[1:])
               if _inside(ranges, 0.5 * (a[1] + b[0]))) * 1e-6


def per_update_ms(ctx, quantity, name: str) -> Optional[float]:
    """``quantity(trace, name)`` (one of the three above) in milliseconds
    per traced update of a per-layer reader's ``ctx``; None without a
    traced slice, its count of updates or the span."""
    n = ctx.layer.get("traced_updates")
    if ctx.trace is None or not n:
        return None
    v = quantity(ctx.trace, name)
    return None if v is None else 1e3 * v / n
