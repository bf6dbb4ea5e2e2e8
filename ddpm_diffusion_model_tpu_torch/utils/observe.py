"""What the port's layers report about themselves: the launch counts of
its kernels and the profiler spans around its phases.

The module sits at the bottom of the package and imports nothing else of
it, so the ops, the models and training all report through it.

:data:`launch_counts` is one table for the whole port, keyed
``"<op>.<route>"``: ``gn_silu_fwd.{smem,reread}`` and
``gn_silu_bwd.{smem,reread}`` (the GN kernels' chunk kept in shared memory
or re-read, the plan's route), ``flash_attn_fwd.{tc,fma}``,
``flash_attn_bwd_dq.{tc,wgmma,fma}`` and ``flash_attn_bwd_dkv.{tc,wgmma,fma}``
(bf16 on mma.sync, bf16 on wgmma, fp32 on FMA), ``grouped_mm.{fwd,bwd}``
(the dropless MoE's ``torch._grouped_mm`` calls), ``adamw.fused`` (the
update's one pass over the optimizer state), ``grad_norm.fused`` (its
read-only norm pass, where the clip needs the norm first) and
``ema_lerp.fused`` (the EMA's pass).  An op's routes are
disjoint, so its launches are their sum (:func:`op_total`).  Three counts
are not launches and have no dot in their key: ``gn_silu_bwd_dtb`` (GN
backward launches that also wrote the time-bias gradient),
``gn_dy_layout_copies`` and ``flash_do_layout_copies`` (the autograd
backwards' copies of a non-contiguous upstream gradient).  Reset it with
``launch_counts.clear()``; read it with ``dict(launch_counts)``.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Mapping, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["launch_counts", "op_total", "span"]

#: Launches of the port's kernels by ``"<op>.<route>"``, and the three
#: counts without a dot (module docstring).
launch_counts: collections.Counter = collections.Counter()

_NO_SPAN = contextlib.nullcontext()


def op_total(op: str, counts: Optional[Mapping[str, int]] = None) -> int:
    """Launches of ``op`` on all its routes in ``counts`` (by default
    :data:`launch_counts`)."""
    prefix = op + "."
    counts = launch_counts if counts is None else counts
    return sum(n for key, n in counts.items() if key.startswith(prefix))


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
