"""Training observability: step timing, device memory, the log tables'
rules and times, a profiler trace of a block and the update's spans.

Counterpart of ``ddpm_diffusion_model_tpu/training/diagnostics.py``.
PyTorch returns before the card has finished, so the timer synchronizes
before it reads the clock.  :func:`profiler_trace` records a
``torch.profiler`` trace where JAX records a ``jax.profiler`` one;
:func:`span` names the phases of an update in it.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Iterator, Optional, Tuple, Union

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["StepTimer", "device_mem_mb", "fmt_hms", "rule", "profiler_trace", "span"]

_trace_ids = itertools.count()
_NO_SPAN = contextlib.nullcontext()


def fmt_hms(sec: float) -> str:
    """Seconds as h:mm:ss."""
    m, s = divmod(int(sec), 60)
    h, m = divmod(m, 60)
    return f"{h:d}:{m:02d}:{s:02d}"


def rule(w: int = 92, ch: str = "─") -> str:
    return ch * w


def device_mem_mb(device: Optional[Union[str, torch.device]] = None
                  ) -> Tuple[float, float]:
    """(allocated, peak allocated) in MB on a CUDA device; (0, 0) on the
    CPU, which keeps no such statistics."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return 0.0, 0.0
    mb = 1024.0 ** 2
    return (torch.cuda.memory_allocated(dev) / mb,
            torch.cuda.max_memory_allocated(dev) / mb)


class StepTimer:
    """Wall-clock step timer; ``mark(result)`` waits for ``result`` (a
    tensor) to be computed before it reads the clock."""

    def __init__(self) -> None:
        self.t0 = time.perf_counter()

    def reset(self) -> None:
        self.t0 = time.perf_counter()

    def mark(self, result: Optional[torch.Tensor] = None) -> float:
        if result is not None and result.device.type == "cuda":
            torch.cuda.synchronize(result.device)
        return (time.perf_counter() - self.t0) * 1000.0  # ms


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]) -> Iterator[None]:
    """Trace the enclosed block with ``torch.profiler`` (the host's ops, and
    the card's kernels when CUDA is available) and write it into
    ``logdir`` as a Chrome trace JSON (``trace-<pid>-<n>.json``), also
    when the block raises.  With no ``logdir`` it does nothing."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace-{os.getpid()}-{next(_trace_ids)}.json"))


def span(name: str):
    """A ``record_function`` range named ``name`` while a ``torch.profiler``
    runs (it lands in the profiler's trace beside the kernels the range
    launches), else one shared no-op context: with the profiler off a span
    costs one attribute read and no clock read.  The flag read is the one
    the profiler sets on start and clears on stop in every mode; the C-level
    ``_profiler_enabled()`` reads the calling thread's state, which a
    profiler of all threads (``profile_all_threads``) leaves unset."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN
