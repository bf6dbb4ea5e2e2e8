"""Training observability: step timing, device memory, the log tables'
rules and times.

Counterpart of the timing, memory and formatting part of
``ddpm_diffusion_model_tpu/training/diagnostics.py``.  PyTorch returns
before the card has finished, so the timer synchronizes before it reads
the clock.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple, Union

import torch

__all__ = ["StepTimer", "device_mem_mb", "fmt_hms", "rule"]


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
