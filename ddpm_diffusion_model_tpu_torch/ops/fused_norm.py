"""Fused GroupNorm + SiLU (+ optional time bias): CUDA kernels, plain
versions and the differentiable op.

Counterpart of ``ddpm_diffusion_model_tpu/ops/fused_norm.py``.
``gn_silu_fwd`` and ``gn_silu_bwd`` launch ``csrc/gn_silu.cu`` for CUDA
tensors and run :func:`gn_silu_reference` / :func:`gn_silu_bwd_reference`,
the plain PyTorch versions of the same functions, for CPU tensors.  There
is no other route: a CUDA tensor a kernel does not take raises.
:func:`gn_silu` and :func:`gn_silu_bias` (the custom VJPs of the JAX
module) are a ``torch.autograd.Function`` over the two: the forward saves
x, the affine, the time bias and the fp32 mean/rstd, the backward
recomputes the normalization from them.  Where no gradient is needed they
call ``gn_silu_fwd`` alone and save nothing.

Semantics are those of the fused TPU path: the time bias is added in fp32
inside the normalization, statistics are fp32 (the plain version's by a
two-pass variance, the forward kernel's by one pass over values shifted by
each channel's first value, folded in fp64: both exact where E[u^2] - mu^2
cancels), and the output is in ``x.dtype``; dx comes back in ``x.dtype``,
dgamma, dbeta and the time-bias gradient in fp32.  The kernels take any C
with ``C % num_groups == 0`` (no lane-multiple gate as on the TPU).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import cuda_build

__all__ = ["gn_silu_reference", "gn_silu_fwd", "gn_silu_bwd_reference",
           "gn_silu_bwd", "gn_silu", "gn_silu_bias", "launches",
           "fwd_smem_launches", "fwd_reread_launches", "bwd_launches",
           "bwd_dtb_launches", "bwd_smem_launches", "bwd_reread_launches",
           "bwd_layout_copies"]

#: Number of times :func:`gn_silu_fwd` launched the CUDA kernel, and how
#: many of those launches kept the chunk of x in shared memory or re-read
#: it (the plan's route).
launches = 0
fwd_smem_launches = 0
fwd_reread_launches = 0
#: Number of times :func:`gn_silu_bwd` launched the CUDA kernel, how many
#: of those launches also wrote the time-bias gradient, and how many kept
#: the chunk of x and dy in shared memory or re-read it (the plan's route).
bwd_launches = 0
bwd_dtb_launches = 0
bwd_smem_launches = 0
bwd_reread_launches = 0
#: Number of times the autograd backward had to copy a non-contiguous dy
#: into the NHWC layout the backward kernel reads.
bwd_layout_copies = 0

_DTYPES = (torch.float32, torch.bfloat16)


def gn_silu_reference(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-6,
    time_bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: (x + time_bias) -> GroupNorm (fp32 stats) -> SiLU.

    x (B, H, W, C); scale/bias (C,); time_bias (B, C) or None.  Returns
    ``(y, mean, rstd)``: y in ``x.dtype``, and the fp32 per-(b, c) group
    mean and 1/sqrt(var + eps) that the forward saves for a backward
    (float64 throughout for float64 inputs)."""
    B, H, W, C = x.shape
    cg = C // num_groups
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    if time_bias is not None:
        xf = xf + time_bias.to(acc)[:, None, None, :]
    xf = xf.reshape(B, H * W, num_groups, cg)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(var + eps)
    norm = ((xf - mean) * rstd).reshape(B, H, W, C)
    y = norm * scale.to(acc) + bias.to(acc)
    y = (y * torch.sigmoid(y)).to(x.dtype)
    mean_c = mean.reshape(B, num_groups, 1).expand(B, num_groups, cg).reshape(B, C)
    rstd_c = rstd.reshape(B, num_groups, 1).expand(B, num_groups, cg).reshape(B, C)
    return y, mean_c, rstd_c



def gn_silu_bwd_reference(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    dy: torch.Tensor,
    num_groups: int,
    time_bias: Optional[torch.Tensor] = None,
    want_dtb: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the backward (``_backward_tiled`` of the JAX
    module), from the forward's saved (B, C) fp32 ``mean`` and ``rstd``.

    Returns ``(dx, dgamma, dbeta, dtb)``: dx in ``x.dtype``, the rest fp32
    (float64 for float64 inputs); dtb (B, C) only when ``want_dtb``
    (default: a time bias was given), else None."""
    if want_dtb is None:
        want_dtb = time_bias is not None
    B, H, W, C = x.shape
    cg = C // num_groups
    acc = torch.promote_types(x.dtype, torch.float32)
    u = x.to(acc)
    if time_bias is not None:
        u = u + time_bias.to(acc)[:, None, None, :]
    g = scale.to(acc)
    rs = rstd.to(acc)[:, None, None, :]
    xhat = (u - mean.to(acc)[:, None, None, :]) * rs
    z = xhat * g + bias.to(acc)
    sig = torch.sigmoid(z)
    dz = dy.to(acc) * sig * (1.0 + z * (1.0 - sig))
    s1 = dz.sum(dim=(1, 2))           # (B, C): sum dz
    s2 = (dz * xhat).sum(dim=(1, 2))  # (B, C): sum dz * xhat
    count = float(H * W * cg)
    # per-group correction moments of dxhat = dz * gamma
    m1 = ((s1 * g).reshape(B, num_groups, cg).sum(-1) / count).repeat_interleave(cg, -1)
    m2 = ((s2 * g).reshape(B, num_groups, cg).sum(-1) / count).repeat_interleave(cg, -1)
    du = (dz * g - m1[:, None, None, :] - xhat * m2[:, None, None, :]) * rs
    dtb = du.sum(dim=(1, 2)) if want_dtb else None
    return du.to(x.dtype), s2.sum(0), s1.sum(0), dtb

def _check(x, scale, bias, num_groups, time_bias):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC (an NCHW tensor in "
                         "channels_last memory, permuted to NHWC)")
    B, H, W, C = x.shape
    if num_groups <= 0 or C % num_groups:
        raise ValueError(f"C={C} is not divisible by num_groups={num_groups}")
    for name, t, shape in (("scale", scale, (C,)), ("bias", bias, (C,)),
                           ("time_bias", time_bias, (B, C))):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")


_c_fns = {}


def _kernel(name: str):
    """The C entry point ``name`` of ``csrc/gn_silu.cu``, with its argument
    types declared (pointers and the stream as ``c_void_p``, so ctypes
    never cuts them to 32 bits)."""
    fn = _c_fns.get(name)
    if fn is None:
        fn = getattr(cuda_build.library("gn_silu"), name)
        fn.restype = ctypes.c_int
        if name == "gn_silu_fwd":
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [
                ctypes.c_void_p]
        _c_fns[name] = fn
    return fn


# The GN kernels' block size, the backward's widest channel pass, their
# tiles and ring (kFwdThreads, kMaxPass, kFwdStageBytes, kStageBytes,
# kRingStages in csrc/gn_silu.cu), an H100's SMs and the shared memory one
# of its blocks may use.
_GN_THREADS = 256
_BWD_MAX_PASS = _GN_THREADS * 4
_STAGE_BYTES = 16384
_RING_STAGES = 3
_SMS = 132
_SMEM_MAX = 232_448
# A block asking at most this much leaves room for three on its SM (the
# kernels' __launch_bounds__).
_SMEM_PER_BLOCK = _SMEM_MAX // 3
_MAX_CLUSTER = 16
# The forward's plan splits an image no finer than this many bytes of x
# per block.
_FWD_MIN_CHUNK_BYTES = 65_536


def _grow_cluster(B: int, HW: int, split=lambda cs: True) -> Tuple[int, int]:
    """``(cluster, chunk)``: the cluster doubles while the card has fewer
    than one and a half blocks per SM to run and ``split(cluster)`` allows
    halving the chunk, up to 16 (or H*W); each block owns ``chunk``
    pixels."""
    cs = 1
    while cs < _MAX_CLUSTER and cs < HW and B * cs < _SMS + _SMS // 2 and split(cs):
        cs *= 2
    return cs, -(-HW // cs)


@functools.lru_cache(maxsize=None)
def _gn_fwd_smem(C: int, G: int, chunk: int, in_smem: bool, itemsize: int
                 ) -> Tuple[int, int, int]:
    """``(tile, stages, bytes)``: the shared-memory layout of one forward
    block (``fwd_smem`` in ``csrc/gn_silu.cu``).  Scratch sized for 16-byte
    columns (two fp64 per-group sums, two pass-wide fp32 reduction buffers,
    two fp32 per-channel partials, the pass's fp32 shifts) rounded up to 16
    bytes, then ``stages`` tiles of ``tile`` pixels of x (a ring, or every
    tile of the chunk when ``in_smem``)."""
    row = C * itemsize
    tile = max(1, min(chunk, _STAGE_BYTES // row))
    width = _GN_THREADS * (16 // itemsize)
    scratch = -(-(16 * G + 4 * (2 * width + 3 * min(C, width))) // 16) * 16
    stages = -(-chunk // tile) if in_smem else _RING_STAGES
    while not in_smem and stages > 2 and scratch + stages * tile * row > _SMEM_MAX:
        stages -= 1
    return tile, stages, scratch + stages * tile * row


@functools.lru_cache(maxsize=None)
def _gn_fwd_plan(B: int, HW: int, C: int, G: int, dtype: torch.dtype
                 ) -> Tuple[int, int, bool]:
    """``(cluster, chunk, in_smem)`` of the forward kernel for (B, HW, C)
    NHWC input with G groups: ``cluster`` blocks per image (1, 2, 4, 8 or
    16), each owning ``chunk`` pixels across all C channels, and whether
    that chunk of x stays in shared memory between the statistics and the
    apply sweep.

    As the backward's plan, the cluster doubles until the card has one and
    a half blocks per SM, but not past chunks of ``_FWD_MIN_CHUNK_BYTES``:
    a block's fixed cost (the launch, the first tile's latency, the cluster
    reduction) outweighs what a smaller chunk saves.  The chunk stays in
    shared memory only on a grid of at most one block per two SMs, where
    fetching the whole chunk at once pays; on a fuller grid the ring's
    smaller blocks keep more of them in flight, and the apply sweep
    re-reads the chunk (mostly from L2).  Both rules come from the route
    tables of ``chip_smoke.py`` on an H100 at every main-path shape."""
    item = 2 if dtype == torch.bfloat16 else 4
    image = HW * C * item
    cs, chunk = _grow_cluster(B, HW, lambda cs: image // (2 * cs) >= _FWD_MIN_CHUNK_BYTES)
    resident = B * cs <= _SMS // 2 and _gn_fwd_smem(C, G, chunk, True, item)[2] <= _SMEM_MAX
    return cs, chunk, resident


def _gn_bwd_smem(C: int, G: int, chunk: int, in_smem: bool, itemsize: int
                 ) -> Tuple[int, int, int]:
    """``(tile, stages, bytes)``: the shared-memory layout of one backward
    block (``bwd_smem`` in ``csrc/gn_silu.cu``).  ``stages`` tiles of
    ``tile`` pixels of x and dy (a ring, or every tile of the chunk when
    ``in_smem``), then fp32 scratch: two pass-wide reduction buffers, two
    per-channel partials, two per-group sums."""
    row = 2 * C * itemsize
    tile = max(1, min(chunk, _STAGE_BYTES // row))
    scratch = 4 * (2 * _BWD_MAX_PASS + 2 * min(C, _BWD_MAX_PASS) + 2 * G)
    stages = -(-chunk // tile) if in_smem else _RING_STAGES
    while not in_smem and stages > 2 and scratch + stages * tile * row > _SMEM_MAX:
        stages -= 1
    return tile, stages, scratch + stages * tile * row


def _gn_bwd_plan(B: int, HW: int, C: int, G: int, dtype: torch.dtype
                 ) -> Tuple[int, int, bool]:
    """``(cluster, chunk, in_smem)`` of the backward kernel for (B, HW, C)
    NHWC input with G groups: ``cluster`` blocks per image (1, 2, 4, 8 or
    16), each owning ``chunk`` pixels across all C channels, and whether
    that chunk of x and dy stays in shared memory between the two sweeps.

    The cluster doubles until the card has one and a half blocks per SM
    to run, or it reaches 16 (or H*W): the grid stays one wave of big
    chunks, which measured faster on an H100 than more, smaller chunks
    whose blocks each pay the cluster reduction's latency.  The chunk
    stays in shared memory if that still leaves room for three blocks
    per SM; else the second sweep re-reads it through the ring."""
    item = 2 if dtype == torch.bfloat16 else 4
    cs, chunk = _grow_cluster(B, HW)
    return cs, chunk, _gn_bwd_smem(C, G, chunk, True, item)[2] <= _SMEM_PER_BLOCK


def _gn_fwd_launch(x, scale, bias, num_groups, eps, time_bias, plan):
    """Launch the forward kernel on checked CUDA tensors with ``plan``
    (``(cluster, chunk, in_smem)``); returns (y, mean, rstd)."""
    global launches, fwd_smem_launches, fwd_reread_launches
    B, H, W, C = x.shape
    cluster, chunk, in_smem = plan
    fn = _kernel("gn_silu_fwd")
    y = torch.empty_like(x)
    mean = torch.empty((B, C), dtype=torch.float32, device=x.device)
    rstd = torch.empty((B, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                None if time_bias is None else time_bias.data_ptr(),
                y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                B, H * W, C, num_groups, cluster, chunk, int(in_smem), float(eps),
                int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"gn_silu_fwd kernel launch failed: cudaError {rc} "
                           f"(plan {plan})")
    launches += 1
    if in_smem:
        fwd_smem_launches += 1
    else:
        fwd_reread_launches += 1
    return y, mean, rstd


def gn_silu_fwd(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-6,
    time_bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GroupNorm+SiLU(+time bias) forward on the CUDA kernel (CUDA tensors)
    or the plain version (CPU tensors).  Same arguments and outputs as
    :func:`gn_silu_reference`; x must be contiguous NHWC.  The kernel takes
    C up to about 50,000 channels at 16-bit and 25,000 at 32-bit (two pixel
    rows and the per-channel sums live in shared memory); wider raises."""
    _check(x, scale, bias, num_groups, time_bias)
    if x.device.type == "cpu":
        return gn_silu_reference(x, scale, bias, num_groups, eps, time_bias)
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu_fwd runs on cuda or cpu, not {x.device}")
    B, H, W, C = x.shape
    if _gn_fwd_smem(C, num_groups, 1, False, x.element_size())[2] > _SMEM_MAX:
        raise ValueError(f"gn_silu_fwd: C={C} with {num_groups} groups needs more shared "
                         "memory than a block has")
    plan = _gn_fwd_plan(B, H * W, C, num_groups, x.dtype)
    return _gn_fwd_launch(x, scale, bias, num_groups, eps, time_bias, plan)


def _gn_bwd_launch(x, scale, bias, mean, rstd, dy, num_groups, time_bias, want_dtb,
                   plan):
    """Launch the backward kernel on checked CUDA tensors with ``plan``
    (``(cluster, chunk, in_smem)``); returns (dx, S1, S2, dtb or None)."""
    global bwd_launches, bwd_dtb_launches, bwd_smem_launches, bwd_reread_launches
    B, H, W, C = x.shape
    cluster, chunk, in_smem = plan
    fn = _kernel("gn_silu_bwd")
    dx = torch.empty_like(x)
    s1 = torch.empty((B, C), dtype=torch.float32, device=x.device)
    s2 = torch.empty((B, C), dtype=torch.float32, device=x.device)
    dtb = torch.empty((B, C), dtype=torch.float32, device=x.device) if want_dtb else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                None if time_bias is None else time_bias.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), s1.data_ptr(),
                s2.data_ptr(), None if dtb is None else dtb.data_ptr(),
                B, H * W, C, num_groups, cluster, chunk, int(in_smem),
                int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"gn_silu_bwd kernel launch failed: cudaError {rc} "
                           f"(plan {plan})")
    bwd_launches += 1
    bwd_dtb_launches += int(want_dtb)
    if in_smem:
        bwd_smem_launches += 1
    else:
        bwd_reread_launches += 1
    return dx, s1, s2, dtb


def gn_silu_bwd(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    dy: torch.Tensor,
    num_groups: int,
    time_bias: Optional[torch.Tensor] = None,
    want_dtb: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """GroupNorm+SiLU(+time bias) backward on the CUDA kernel (CUDA
    tensors) or the plain version (CPU tensors).  Same arguments and
    outputs as :func:`gn_silu_bwd_reference`; x and dy must be contiguous
    NHWC of one shape and dtype.  dgamma and dbeta are one torch sum over
    B of the kernel's per-image partials (no atomics).  The kernel takes C
    up to about 26,000 channels at 16-bit and 13,000 at 32-bit (a pixel of
    x and dy and the per-channel sums live in shared memory); wider raises."""
    _check(x, scale, bias, num_groups, time_bias)
    if want_dtb is None:
        want_dtb = time_bias is not None
    B, H, W, C = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x ({x.dtype} {tuple(x.shape)} on "
                         f"{x.device}), got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if not dy.is_contiguous():
        raise ValueError("dy must be contiguous NHWC")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (tuple(t.shape) != (B, C) or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 ({B}, {C}) "
                             f"on {x.device}, got {t.dtype} {tuple(t.shape)}")
    if x.device.type == "cpu":
        return gn_silu_bwd_reference(x, scale, bias, mean, rstd, dy, num_groups,
                                     time_bias, want_dtb)
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu_bwd runs on cuda or cpu, not {x.device}")
    if _gn_bwd_smem(C, num_groups, 1, False, x.element_size())[2] > _SMEM_MAX:
        raise ValueError(f"gn_silu_bwd: C={C} with {num_groups} groups needs more shared "
                         "memory than a block has")
    plan = _gn_bwd_plan(B, H * W, C, num_groups, x.dtype)
    dx, s1, s2, dtb = _gn_bwd_launch(x, scale, bias, mean, rstd, dy, num_groups,
                                     time_bias, want_dtb, plan)
    return dx, s2.sum(0), s1.sum(0), dtb


class _GNSiLU(torch.autograd.Function):
    """GN+SiLU(+time bias) with its backward on :func:`gn_silu_bwd`.  The
    two wrappers are looked up in this module when called, so a caller can
    route both to their plain versions by rebinding the module names."""

    @staticmethod
    def forward(ctx, x, scale, bias, time_bias, num_groups, eps):
        y, mean, rstd = gn_silu_fwd(x, scale, bias, num_groups, eps, time_bias)
        ctx.save_for_backward(x, scale, bias, time_bias, mean, rstd)
        ctx.num_groups = num_groups
        return y

    @staticmethod
    def backward(ctx, dy):
        global bwd_layout_copies
        x, scale, bias, time_bias, mean, rstd = ctx.saved_tensors
        if not dy.is_contiguous():
            dy = dy.contiguous()
            bwd_layout_copies += 1
        want_dtb = time_bias is not None and ctx.needs_input_grad[3]
        dx, dgamma, dbeta, dtb = gn_silu_bwd(x, scale, bias, mean, rstd, dy,
                                             ctx.num_groups, time_bias, want_dtb)
        return dx, dgamma, dbeta, dtb, None, None


def gn_silu(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-6,
    time_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable (x + time_bias) -> GroupNorm -> SiLU of NHWC ``x``;
    returns y in ``x.dtype``.  With no gradient to take (grad mode off, or
    no input requires one) it is :func:`gn_silu_fwd` alone."""
    inputs = (x, scale, bias, time_bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in inputs):
        return _GNSiLU.apply(x, scale, bias, time_bias, num_groups, eps)
    return gn_silu_fwd(x, scale, bias, num_groups, eps, time_bias)[0]


def gn_silu_bias(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 time_bias: torch.Tensor, num_groups: int, eps: float = 1e-6
                 ) -> torch.Tensor:
    """:func:`gn_silu` with a (B, C) fp32 time bias, in the argument order
    of the JAX ``gn_silu_bias``."""
    return gn_silu(x, scale, bias, num_groups, eps, time_bias)
