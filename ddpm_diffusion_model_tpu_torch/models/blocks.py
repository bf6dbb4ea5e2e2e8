"""U-Net building blocks: ResBlock, AttnBlock, Downsample, Upsample.

Counterpart of ``ddpm_diffusion_model_tpu/models/blocks.py``.  ``.train()``
and ``.eval()`` take the place of the JAX ``deterministic`` flag: the
ResBlock's dropout runs only in training mode.

``remat`` on a ResBlock is the JAX ``nn.remat`` of it: ``True`` recomputes
the whole block in the backward (``torch.utils.checkpoint``, non-reentrant,
so the GN and flash autograd Functions' saved tensors are dropped too) and
``"masks"`` saves everything but the dropout bits, which the backward draws
again (``ops/dropout.py`` ``dropout_replayed``).

Layout: blocks take NCHW tensors in ``torch.channels_last`` memory.  The
GroupNorm+SiLU of every ResBlock goes through the differentiable
:func:`gn_silu` on the NHWC view of that memory (no copy); its backward
hands dx back in the same layout.  Precision follows the JAX blocks:
params stay float32 and are cast to the compute ``dtype`` at each call
(flax ``dtype=bf16`` casts input and kernel before the conv); GroupNorm
statistics are float32; the time bias rides into the fused normalization
in float32, as in the fused TPU path.  The parameter names are the
reference's torch names, so reference checkpoints load with
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import multi_head_attention
from ..ops.dropout import dropout as apply_dropout
from ..ops.dropout import dropout_replayed
from ..ops.fused_norm import gn_silu

__all__ = ["ResBlock", "AttnBlock", "Downsample", "Upsample", "conv",
           "gn_silu_nchw"]


def _gn_groups(channels: int, num_groups: int = 32) -> int:
    """min(32, C), falling back to the largest divisor of C (the JAX
    package's single rule for fused and unfused GroupNorm)."""
    groups = min(num_groups, channels)
    while channels % groups:
        groups -= 1
    return groups


def group_norm(channels: int) -> nn.GroupNorm:
    """Parameter holder with the reference's GroupNorm: eps 1e-6, affine."""
    return nn.GroupNorm(_gn_groups(channels), channels, eps=1e-6)


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied with input and params cast to ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias, layer.stride,
                    layer.padding)


def gn_silu_nchw(x: torch.Tensor, norm: nn.GroupNorm,
                 time_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm+SiLU(+time bias) of an NCHW channels_last tensor, through
    the fused op on its NHWC view; returns NCHW channels_last."""
    y = gn_silu(x.permute(0, 2, 3, 1), norm.weight, norm.bias,
                norm.num_groups, norm.eps, time_bias)
    return y.permute(0, 3, 1, 2)


class ResBlock(nn.Module):
    """GN+SiLU -> 3x3 conv -> (+time bias) GN+SiLU -> dropout -> 3x3 conv,
    plus the skip (1x1 conv when the width changes).  Registration order is
    the reference's: norm1, conv1, time_proj (SiLU, Linear), norm2, conv2,
    skip.  Dropout (``"packed"`` or ``"flax"``, ``ops/dropout.py``) holds
    no parameters and runs only in training mode.  ``remat``: False,
    ``True`` (recompute the block in the backward) or ``"masks"`` (replay
    only the dropout bits), as the JAX U-Net's ``remat``."""

    def __init__(self, in_ch: int, out_ch: int, time_dim: int,
                 dtype: torch.dtype = torch.bfloat16, dropout: float = 0.0,
                 dropout_impl: str = "packed", remat=False):
        super().__init__()
        if dropout_impl not in ("packed", "flax"):
            raise ValueError(f"unknown dropout_impl {dropout_impl!r} (packed or flax)")
        self.dtype = dtype
        self.dropout, self.dropout_impl = dropout, dropout_impl
        self.remat = remat
        self.norm1 = group_norm(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_proj = nn.Sequential(nn.SiLU(), nn.Linear(time_dim, out_ch))
        self.norm2 = group_norm(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.skip = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.remat and self.remat != "masks" and torch.is_grad_enabled():
            drops = self.training and self.dropout > 0.0
            return _checkpointed(self._forward, x, t_emb, generator if drops else None)
        return self._forward(x, t_emb, generator)

    def _forward(self, x: torch.Tensor, t_emb: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        h = conv(gn_silu_nchw(x, self.norm1), self.conv1, dt)
        lin = self.time_proj[1]
        t_bias = F.linear(F.silu(t_emb.float()).to(dt), lin.weight.to(dt),
                          lin.bias.to(dt))
        h = gn_silu_nchw(h, self.norm2, time_bias=t_bias.float().contiguous())
        if self.training and self.dropout > 0.0:
            drop = dropout_replayed if self.remat == "masks" else apply_dropout
            h = drop(h, self.dropout, self.dropout_impl, generator)
        h = conv(h, self.conv2, dt)
        skip = x if self.skip is None else conv(x, self.skip, dt)
        return h + skip


def _checkpointed(fn, x: torch.Tensor, t_emb: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """``fn(x, t_emb, generator)`` under non-reentrant checkpointing.

    torch's checkpoint restores the default CPU and CUDA generators for
    the recompute, not a generator passed in, which would draw other
    dropout bits there and give silently wrong gradients.  So the block
    draws from a copy set to the caller's generator's state at entry, in
    the first forward and again in the recompute, and the caller's
    generator is then set where the first forward left the copy: the next
    draws are those of a run without remat."""
    if generator is None:
        return checkpoint(fn, x, t_emb, None, use_reentrant=False)
    start, end = generator.get_state(), []

    def body(x, t_emb):
        gen = torch.Generator(device=generator.device)
        gen.set_state(start)
        out = fn(x, t_emb, gen)
        if not end:
            end.append(gen.get_state())
        return out

    out = checkpoint(body, x, t_emb, use_reentrant=False, preserve_rng_state=False)
    generator.set_state(end[0])
    return out


class AttnBlock(nn.Module):
    """Pre-norm residual multi-head self-attention over the H*W tokens:
    GroupNorm, bias-free 1x1 ``qkv`` to heads*head_dim*3, attention, 1x1
    ``proj``, residual add.  The qkv split order is (B, N, 3, heads, d).
    Attention-weight dropout (``p_drop > 0`` in training) is not ported
    and raises; in eval it is the identity, as in the JAX block."""

    def __init__(self, channels: int, num_heads: int = 4, head_dim: int = 64,
                 dtype: torch.dtype = torch.bfloat16, p_drop: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.p_drop = p_drop
        self.num_heads, self.head_dim = num_heads, head_dim
        inner = num_heads * head_dim
        self.norm = group_norm(channels)
        self.qkv = nn.Conv2d(channels, 3 * inner, 1, bias=False)
        self.proj = nn.Conv2d(inner, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.p_drop > 0.0:
            raise NotImplementedError(
                "attention-weight dropout (attn_p_drop > 0 in training) is "
                "not ported yet")
        dt = self.dtype
        B, C, H, W = x.shape
        N = H * W
        heads, d = self.num_heads, self.head_dim
        inner = heads * d
        h = F.group_norm(x.float(), self.norm.num_groups, self.norm.weight,
                         self.norm.bias, self.norm.eps).to(dt)
        h = h.permute(0, 2, 3, 1).reshape(B, N, C)
        qkv = F.linear(h, self.qkv.weight.reshape(3 * inner, C).to(dt))
        qkv = qkv.reshape(B, N, 3, heads, d).permute(2, 0, 3, 1, 4)
        out = multi_head_attention(qkv[0], qkv[1], qkv[2])  # (B, heads, N, d)
        out = out.permute(0, 2, 1, 3).reshape(B, N, inner)
        out = F.linear(out, self.proj.weight.reshape(C, inner).to(dt),
                       self.proj.bias.to(dt))
        return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2).to(x.dtype)


class Downsample(nn.Module):
    """Factor-2 downsample: 3x3 stride-2 conv, padding 1 on each side."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(x, self.conv, self.dtype)


class Upsample(nn.Module):
    """x2 nearest-neighbour upsample (a plain repeat) + 3x3 conv."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return conv(x, self.conv, self.dtype)
