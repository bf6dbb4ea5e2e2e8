"""Preemption-safe training: SIGTERM/SIGINT -> finish the step in flight,
save an emergency checkpoint, return cleanly.

Counterpart of ``ddpm_diffusion_model_tpu/training/preemption.py`` (plain
Python, copied): ``train_ddpm`` installs these handlers by default, checks
the flag at every batch boundary, flushes the state to
``<run_name>_preempt`` and returns with ``summary["preempted"] = True``, so
a scheduler can relaunch with ``resume_path="auto"``.
"""

from __future__ import annotations

import signal
import threading
from contextlib import contextmanager

__all__ = ["PreemptionFlag", "catch_preemption"]


class PreemptionFlag:
    """Truthiness = "a stop was requested".  Usable directly as a signal
    handler; also trippable by hand (tests, cooperative shutdown)."""

    def __init__(self):
        self.triggered = False
        self.signum = None

    def __call__(self, signum=None, frame=None):
        self.triggered = True
        self.signum = signum

    def __bool__(self) -> bool:
        return self.triggered


@contextmanager
def catch_preemption(signals=(signal.SIGTERM, signal.SIGINT)):
    """Yield a :class:`PreemptionFlag` that trips when any of ``signals``
    arrives; the previous handlers are restored on exit.  Outside the main
    thread (where CPython forbids ``signal.signal``) the flag is yielded
    uninstalled; it can still be tripped by hand."""
    flag = PreemptionFlag()
    installed = {}
    if threading.current_thread() is threading.main_thread():
        for s in signals:
            installed[s] = signal.signal(s, flag)
    try:
        yield flag
    finally:
        for s, old in installed.items():
            signal.signal(s, old)
