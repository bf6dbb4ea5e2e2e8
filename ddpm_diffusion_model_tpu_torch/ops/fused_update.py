"""The tail of a training update on CUDA kernels (``csrc/adamw_ema.cu``):
the global-norm clip and AdamW in one pass, the EMA lerp in another, or
their plain versions.

:func:`adamw_` stands for the two calls every update used to make: the
pre-clip global grad norm (``training/state.py`` ``global_norm``) and the
optimizer step (``AdamWClip.step``), with the norm computed once.  On CUDA
tensors it is one launch of the update kernel (``adamw.fused`` in
``launch_counts``), after one of the read-only norm pass
(``grad_norm.fused``) only where the clip needs the norm before the update
and the caller gives none; without a clip the update pass sums the norm's
squares itself.  :func:`ema_lerp_` is the EMA's multi-tensor lerp
(``training/ema.py`` ``ema_update`` calls it): one launch
(``ema_lerp.fused``).  The results are the plain sequences' bit for bit,
the norm within the order of its sum.  CPU tensors take
:func:`adamw_reference` and :func:`ema_lerp_reference`, the plain
sequences.

The kernels take each tensor flat over its storage, so the tensors of a
parameter (weight, gradient, both moments; shadow and weight) must be
dense with one shape and one set of strides (``channels_last`` conv
weights are); the first moment is float32 or, under
``moment_dtype="bfloat16"``, bf16, the rest float32.  Anything else
raises.  :func:`records` lays out the table a kernel reads: one row of
int64 words per non-empty tensor (its addresses, its size, its first chunk
of :data:`CHUNK` elements).  The gradients' addresses change every update,
so the table reaches the device each call by an asynchronous copy from
pinned memory, without a host sync.

Nothing here builds or loads a kernel when the module is imported.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build

__all__ = ["CHUNK", "records", "adamw_", "adamw_reference", "ema_lerp_", "ema_lerp_reference"]

#: elements a block of the kernels takes (kChunk in csrc/adamw_ema.cu)
CHUNK = 4096

_UPDATE_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_float] * 10
                    + [ctypes.c_void_p])
_EMA_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                 ctypes.c_float, ctypes.c_void_p]
_NORM_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 3


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t`` covers exactly its ``numel()`` consecutive elements of
    storage, in any order of its dimensions."""
    span = 1
    for stride, size in sorted((s, n) for s, n in zip(t.stride(), t.shape) if n != 1):
        if stride != span:
            return False
        span *= size
    return True


def _order(t: torch.Tensor) -> List[Tuple[int, int]]:
    """The strides of ``t``'s dimensions longer than 1: two dense tensors of
    one shape hold their elements in the same storage order iff these
    agree (a dimension of size 1 may carry any stride)."""
    return [(s, n) for s, n in zip(t.stride(), t.shape) if n != 1]


def records(lists: Sequence[Sequence[torch.Tensor]], dtypes: Sequence[torch.dtype],
            names: Sequence[str]) -> Tuple[np.ndarray, int]:
    """(a kernel's table, its number of chunks): per non-empty tensor the
    addresses of its tensor in each of ``lists`` (named ``names``), its
    size and its first chunk.  Raises unless the tensors of every row share
    one device, shape and storage order with the first list's, which are
    dense, and each list holds ``dtypes``' dtype.  The checks run list by
    list (a few C calls a tensor): the train step makes them every
    update."""
    first = lists[0]
    if len({len(ts) for ts in lists}) != 1:
        raise ValueError("fused update: " + ", ".join(
            f"{len(ts)} {what}" for what, ts in zip(names, lists)))
    for i, p in enumerate(first):
        if not (p.is_contiguous() or p.numel() == 0 or _dense(p)):
            raise ValueError(f"fused update: tensor {i} ({tuple(p.shape)} strides {p.stride()}) "
                             "is not dense; the kernels take each tensor flat over its storage")
    dev = first[0].device
    shapes = [p.shape for p in first]
    strides = [p.stride() for p in first]
    for what, ts, dt in zip(names, lists, dtypes):
        if ({t.dtype for t in ts} == {dt} and {t.device for t in ts} == {dev}
                and [t.shape for t in ts] == shapes and [t.stride() for t in ts] == strides):
            continue
        bad = [(i, t) for i, t in enumerate(ts)
               if (t.dtype, t.device, t.shape) != (dt, dev, shapes[i])
               or (t.stride() != strides[i] and _order(t) != _order(first[i]))]
        if bad:
            i, t = bad[0]
            raise ValueError(
                f"fused update: tensor {i}'s {what} is {t.dtype} {tuple(t.shape)} strides "
                f"{t.stride()} on {t.device}; the kernel takes {dt} {tuple(shapes[i])} "
                f"strides {strides[i]} on {dev}, as the {names[0]}")
    k = len(lists)
    table = np.zeros((len(first), k + 2), dtype=np.int64)
    for j, ts in enumerate(lists):
        table[:, j] = [t.data_ptr() for t in ts]
    table[:, k] = [p.numel() for p in first]
    table = table[table[:, k] > 0]
    chunks = (table[:, k] + CHUNK - 1) // CHUNK
    table[:, k + 1] = np.cumsum(chunks) - chunks
    return table, int(chunks.sum())


def _on_device(table: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The table on ``dev``, by an asynchronous copy from pinned memory."""
    return torch.from_numpy(table).pin_memory().to(dev, non_blocking=True)


def _route(t: torch.Tensor, op: str) -> bool:
    """Whether ``t``'s device takes the kernel (cuda) or the plain version
    (cpu); raises on any other."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{op} runs on cuda or cpu, not {t.device}")
    return t.device.type == "cuda"


def _recip(x: float) -> float:
    """1 / x in float32: what the multi-tensor division by a scalar
    multiplies by."""
    return float(np.float32(1.0) / np.float32(x))


@torch.no_grad()
def adamw_reference(tx, params: List[torch.Tensor], grads: List[torch.Tensor],
                    opt_state: Dict[str, Any], grad_norm: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The plain version of :func:`adamw_`: the pre-clip global norm of
    ``grads`` (unless given), then ``tx.step`` clipping by it."""
    from ..training.state import global_norm

    norm = global_norm(grads) if grad_norm is None else grad_norm
    tx.step(params, grads, opt_state, grad_norm=norm)
    return norm


@torch.no_grad()
def adamw_(tx, params: List[torch.Tensor], grads: List[torch.Tensor],
           opt_state: Dict[str, Any], grad_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One optimizer update in place: clip ``grads`` (``tx.cfg.grad_clip``)
    by their global norm, or by ``grad_norm`` where the caller gives it (one
    rank's shards of the gradient), then AdamW on ``params`` and the
    moments of ``opt_state`` (both counts advanced).  Returns the pre-clip
    global norm (``grad_norm`` when given) as a 0-d float32 tensor on the
    params' device.  The grads are left clipped on the plain version and as
    they were on the kernel."""
    if len(grads) != len(params):
        raise ValueError(f"adamw_: {len(grads)} grads for {len(params)} params")
    if not _route(params[0], "adamw_"):
        return adamw_reference(tx, params, grads, opt_state, grad_norm)
    cfg, dev = tx.cfg, params[0].device
    if grad_norm is not None and (grad_norm.numel() != 1 or grad_norm.device != dev):
        raise ValueError(f"adamw_: grad_norm must be one value on {dev}")
    bf16 = tx.mu_dtype == torch.bfloat16
    table, nchunks = records((params, grads, opt_state["mu"], opt_state["nu"]),
                             (torch.float32, torch.float32,
                              torch.bfloat16 if bf16 else torch.float32, torch.float32),
                             ("param", "grad", "mu", "nu"))
    if not nchunks:  # every tensor empty: nothing to move
        tx.advance(opt_state)
        return torch.zeros((), device=dev) if grad_norm is None else grad_norm
    recs = _on_device(table, dev)
    clip = cfg.grad_clip is not None
    norm, partials = grad_norm, None
    if grad_norm is None:
        norm = torch.empty((), dtype=torch.float32, device=dev)
        partials = torch.empty(nchunks, dtype=torch.float64, device=dev)
        if clip:  # the clip needs the norm before the update: a pass of its own
            cuda_build.launch("adamw_ema", "grad_norm", _NORM_ARGTYPES, dev,
                              (recs.data_ptr(), len(table), nchunks, partials.data_ptr(),
                               norm.data_ptr()), "grad_norm.fused")
            partials = None
    norm_in = norm.reshape(()).to(torch.float32).contiguous() if clip else None
    bc1, bc2, lr = tx.scalars(opt_state)
    b1, b2 = cfg.adam_b1, cfg.adam_b2
    cuda_build.launch(
        "adamw_ema", "adamw_update", _UPDATE_ARGTYPES, dev,
        (recs.data_ptr(), len(table), nchunks, int(bf16), int(clip),
         None if norm_in is None else norm_in.data_ptr(),
         None if partials is None else partials.data_ptr(),
         None if partials is None else norm.data_ptr(),
         b1, 1.0 - b1, b2, 1.0 - b2, _recip(bc1), _recip(bc2),
         float(cfg.weight_decay or 0.0), -lr, tx.b1_lo() if bf16 else 0.0,
         float(cfg.grad_clip or 0.0)), "adamw.fused")
    tx.advance(opt_state)
    return norm


@torch.no_grad()
def ema_lerp_reference(shadow: List[torch.Tensor], params: List[torch.Tensor], decay) -> None:
    """The plain version of :func:`ema_lerp_`: two multi-tensor ops."""
    d = np.float32(decay)
    torch._foreach_mul_(shadow, float(d))
    torch._foreach_add_(shadow, params, alpha=float(np.float32(1.0) - d))


@torch.no_grad()
def ema_lerp_(shadow: List[torch.Tensor], params: List[torch.Tensor], decay) -> None:
    """shadow <- decay * shadow + (1 - decay) * params in place, float32,
    with ``decay`` and ``1 - decay`` rounded to float32."""
    if len(shadow) != len(params):
        raise ValueError(f"ema_lerp_: {len(shadow)} shadows for {len(params)} params")
    if not shadow:
        return
    if not _route(shadow[0], "ema_lerp_"):
        ema_lerp_reference(shadow, params, decay)
        return
    table, nchunks = records((shadow, params), (torch.float32, torch.float32), ("ema", "param"))
    if not nchunks:
        return
    d = np.float32(decay)
    cuda_build.launch("adamw_ema", "ema_lerp", _EMA_ARGTYPES, shadow[0].device,
                      (_on_device(table, shadow[0].device).data_ptr(), len(table), nchunks,
                       float(d), float(np.float32(1.0) - d)), "ema_lerp.fused")
