"""Flash attention: CUDA kernels, plain versions and the differentiable op.

Counterpart of ``ddpm_diffusion_model_tpu/ops/flash_attention.py``:
non-causal, no mask, scale 1/sqrt(d), fp32 softmax state, output in the
input dtype and LSE in fp32.  ``flash_attn_fwd`` (O and LSE, from
``csrc/flash_attn.cu``) and ``flash_attn_bwd_dq`` / ``flash_attn_bwd_dkv``
(from ``csrc/flash_attn_bwd.cu``) launch their kernels for CUDA tensors and
run the plain versions for CPU tensors; a CUDA tensor a kernel does not
take raises.  Each of the three has two kernels behind one C entry point,
chosen by dtype: bf16 on the tensor cores, fp32 on fp32 FMA; dQ and dK/dV
each have a third, bf16 on Hopper's wgmma and TMA for long sequences
(``csrc/flash_attn_bwd_sm90.cu``), chosen by :func:`_dkv_route` from the
shape.
:func:`flash_attention` is the custom VJP of the JAX module as a
``torch.autograd.Function``: the forward saves q, k, v, O and LSE, the
backward recomputes the probabilities from the LSE (no N x N buffer).
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import cuda_build

__all__ = ["flash_attn_reference", "flash_attn_fwd",
           "flash_attn_bwd_dq_reference", "flash_attn_bwd_dkv_reference",
           "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "flash_attn_bwd",
           "flash_attention", "launches", "fwd_tc_launches",
           "fwd_fma_launches", "bwd_dq_launches", "bwd_dkv_launches",
           "bwd_dq_tc_launches", "bwd_dq_fma_launches", "bwd_dkv_tc_launches",
           "bwd_dkv_fma_launches", "bwd_dq_wgmma_launches", "bwd_dkv_wgmma_launches",
           "bwd_layout_copies"]

#: Number of times :func:`flash_attn_fwd` launched a CUDA kernel, and of
#: those the tensor-core kernel (bf16) and the FMA kernel (fp32).
launches = 0
fwd_tc_launches = 0
fwd_fma_launches = 0
#: Launches of the dQ and dK/dV kernels by their wrappers, and of each by
#: variant, tensor cores (bf16) and FMA (fp32).
bwd_dq_launches = 0
bwd_dkv_launches = 0
bwd_dq_tc_launches = 0
bwd_dq_fma_launches = 0
bwd_dkv_tc_launches = 0
bwd_dkv_fma_launches = 0
#: Of ``bwd_dq_tc_launches`` and ``bwd_dkv_tc_launches``, those of the
#: wgmma kernels for long sequences.
bwd_dq_wgmma_launches = 0
bwd_dkv_wgmma_launches = 0
#: Number of times the autograd backward had to copy a non-contiguous dO.
bwd_layout_copies = 0

_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128
#: The head dim the wgmma dQ and dK/dV kernels take, and the sequence length
#: from which each beats its mma.sync kernel at every batch measured on an
#: H100 (PERF.md §6); the U-Nets' N = 256 and 64 stay on mma.sync.
WGMMA_HEAD_DIM = 64
WGMMA_MIN_N = 512


def _wide(*ts):
    """The tensors in at least float32 (float64 stays float64)."""
    return tuple(t.to(torch.promote_types(t.dtype, torch.float32)) for t in ts)


def flash_attn_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version on (BH, N, d) operands: fp32 logits and softmax, probs
    cast to ``v.dtype`` before PV (as ``attention_xla``), output in
    ``q.dtype``; LSE (BH, N) fp32 (float64 throughout for float64 inputs)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = _wide(q, k, v)
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(*_wide(probs.to(v.dtype)), vf)
    return out.to(q.dtype), lse


def _check(q, k, v):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k, v must share one (BH, N, d) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    BH, N, d = q.shape
    if BH < 1 or N < 1 or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"need BH >= 1, N >= 1 and 1 <= d <= {MAX_HEAD_DIM}, "
                         f"got {tuple(q.shape)}")


def flash_attn_bwd_dq_reference(q, k, v, do, lse, delta) -> torch.Tensor:
    """Plain dQ on (BH, N, d) operands from the saved LSE and
    delta = rowsum(dO * O) (both (BH, N) fp32): fp32 throughout (float64
    for float64 inputs), output in ``q.dtype``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = _wide(q, k, v, do)
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    return (torch.matmul(ds, kf) * scale).to(q.dtype)


def flash_attn_bwd_dkv_reference(q, k, v, do, lse, delta
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain dK, dV on (BH, N, d) operands, as
    :func:`flash_attn_bwd_dq_reference`; outputs in ``k.dtype``/``v.dtype``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = _wide(q, k, v, do)
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


_c_fns = {}


def _kernel(lib: str, name: str, n_ptrs: int, n_ints: int):
    """The C entry point ``name`` of ``csrc/<lib>.cu``, with its argument
    types declared: ``n_ptrs`` pointers, ``n_ints`` ints, the scale, the
    dtype flag and the stream (pointers and stream as ``c_void_p``, so
    ctypes never cuts them to 32 bits)."""
    fn = _c_fns.get(name)
    if fn is None:
        fn = getattr(cuda_build.library(lib), name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        _c_fns[name] = fn
    return fn


def _check_bwd(q, k, v, do, lse, delta):
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO must match q ({q.dtype} {tuple(q.shape)}), got "
                         f"{do.dtype} {tuple(do.shape)} on {do.device}")
    if not do.is_contiguous():
        raise ValueError("dO must be contiguous")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != q.shape[:2] or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 "
                             f"{tuple(q.shape[:2])} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE) for (BH, N, d) q, k, v: for CUDA tensors the tensor-core
    kernel (bf16) or the FMA kernel (fp32), the plain version for CPU
    tensors."""
    global launches, fwd_tc_launches, fwd_fma_launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attn_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd runs on cuda or cpu, not {q.device}")
    BH, N, d = q.shape
    fn = _kernel("flash_attn", "flash_attn_fwd", 5, 3)
    o = torch.empty_like(q)
    lse = torch.empty((BH, N), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), BH, N, d, 1.0 / math.sqrt(d),
                int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd kernel launch failed: cudaError {rc}")
    launches += 1
    if q.dtype == torch.bfloat16:
        fwd_tc_launches += 1
    else:
        fwd_fma_launches += 1
    return o, lse


def flash_attn_bwd_dq(q, k, v, do, lse, delta) -> torch.Tensor:
    """dQ for (BH, N, d) operands: for CUDA tensors the kernel
    :func:`_dkv_route` names (bf16 on the tensor cores, by wgmma for long
    sequences; fp32 on FMA), the plain version for CPU tensors; ``lse`` and
    ``delta`` (BH, N) fp32."""
    global bwd_dq_launches, bwd_dq_tc_launches, bwd_dq_fma_launches
    global bwd_dq_wgmma_launches
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attn_bwd_dq_reference(q, k, v, do, lse, delta)
    BH, N, d = q.shape
    route = _dkv_route(q.dtype, N, d, all(
        t.data_ptr() % 16 == 0 for t in (q, k, v, do, lse, delta)))
    if route == "wgmma":
        fn = _kernel("flash_attn_bwd_sm90", "flash_attn_bwd_dq_wgmma", 7, 3)
    else:
        fn = _kernel("flash_attn_bwd", "flash_attn_bwd_dq", 7, 3)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, N, d,
                1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd_dq ({route}) kernel launch failed: "
                           f"cudaError {rc}")
    bwd_dq_launches += 1
    if route == "fma":
        bwd_dq_fma_launches += 1
    else:
        bwd_dq_tc_launches += 1
        if route == "wgmma":
            bwd_dq_wgmma_launches += 1
    return dq


def _dkv_route(dtype: torch.dtype, N: int, d: int, aligned: bool) -> str:
    """The kernel of a CUDA call to either backward wrapper, dQ or dK/dV (the
    two cross over at the same lengths): ``"wgmma"`` (bf16, d =
    :data:`WGMMA_HEAD_DIM`, every operand 16-byte aligned, N >=
    :data:`WGMMA_MIN_N`), ``"tc"`` (any other bf16 call, on mma.sync) or
    ``"fma"`` (fp32)."""
    if dtype != torch.bfloat16:
        return "fma"
    if d == WGMMA_HEAD_DIM and aligned and N >= WGMMA_MIN_N:
        return "wgmma"
    return "tc"


def flash_attn_bwd_dkv(q, k, v, do, lse, delta
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) for (BH, N, d) operands: for CUDA tensors the kernel
    :func:`_dkv_route` names (bf16 on the tensor cores, by wgmma for long
    sequences; fp32 on FMA), the plain version for CPU tensors."""
    global bwd_dkv_launches, bwd_dkv_tc_launches, bwd_dkv_fma_launches
    global bwd_dkv_wgmma_launches
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attn_bwd_dkv_reference(q, k, v, do, lse, delta)
    BH, N, d = q.shape
    route = _dkv_route(q.dtype, N, d, all(
        t.data_ptr() % 16 == 0 for t in (q, k, v, do, lse, delta)))
    if route == "wgmma":
        fn = _kernel("flash_attn_bwd_sm90", "flash_attn_bwd_dkv_wgmma", 8, 3)
    else:
        fn = _kernel("flash_attn_bwd", "flash_attn_bwd_dkv", 8, 3)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                BH, N, d, 1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd_dkv ({route}) kernel launch failed: "
                           f"cudaError {rc}")
    bwd_dkv_launches += 1
    if route == "fma":
        bwd_dkv_fma_launches += 1
    else:
        bwd_dkv_tc_launches += 1
        if route == "wgmma":
            bwd_dkv_wgmma_launches += 1
    return dk, dv


def flash_attn_bwd(q, k, v, o, lse, do
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) from the forward's O and LSE: delta = rowsum(dO * O) in
    fp32 (one torch expression, as the JAX backward leaves it to XLA), then
    the dQ and the dK/dV wrappers."""
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_attn_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = flash_attn_bwd_dkv(q, k, v, do, lse, delta)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Attention on (BH, N, d) operands with its backward on
    :func:`flash_attn_bwd`.  The wrappers are looked up in this module
    when called, so a caller can route them to their plain versions by
    rebinding the module names."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attn_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        global bwd_layout_copies
        q, k, v, o, lse = ctx.saved_tensors
        if not do.is_contiguous():
            do = do.contiguous()
            bwd_layout_copies += 1
        return flash_attn_bwd(q, k, v, o, lse, do)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Differentiable (B, h, N, d) non-causal attention, output in the input
    dtype.  With no gradient to take it is :func:`flash_attn_fwd` alone."""
    B, H, N, D = q.shape
    qf, kf, vf = (t.reshape(B * H, N, D).contiguous() for t in (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = _FlashAttention.apply(qf, kf, vf)
    else:
        out = flash_attn_fwd(qf, kf, vf)[0]
    return out.reshape(B, H, N, D)
