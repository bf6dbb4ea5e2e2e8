"""The plain float32 U-Net denoiser of Ho et al. (2020) as the repository's
``unet_64x64_config`` lays it out: the reference the benchmark holds the
port's U-Net to.

NCHW float32 throughout, plain torch operations, no kernel of the port.
The module names are those of the reference checkpoints (``time_mlp.net``,
``in_conv``, ``downs.L.blocks.j``, ``mid``, ``ups.L.blocks.n``,
``out_norm``, ``out_conv``), so one name -> tensor map of weights loads
into both.  The topology: one skip per level taken before its downsample,
ResBlocks (GN -> SiLU -> 3x3 conv, + time bias, GN -> SiLU -> dropout ->
3x3 conv, + skip), attention blocks (GN, 1x1 qkv without bias, softmax
attention, 1x1 proj, + residual) at the listed resolutions, a Res -> Attn
-> Res bottleneck, a decoder without attention whose first block per level
takes the concatenated skip, and a GN -> SiLU -> 3x3 conv head.

Dropout is the repository's packed dropout: uint8 bits drawn by
``random_(0, 256)`` from the generator the forward is given, in the
channels-last layout of the activation, an element kept iff its bits are
>= round(rate * 256), survivors scaled by 256 / (256 - threshold).  The
draws come in the forward order of the ResBlocks, so a generator set to a
given state draws the masks any run of this architecture draws from it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .lowp import FP32, Precision

__all__ = ["UNetRef", "MODEL", "sinusoidal_embedding"]


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[sin(t f), cos(t f)] with f = exp(-log(10000) i / (dim/2 - 1)),
    zero-padded by a column for odd ``dim``; float32."""
    half = dim // 2
    scale = math.log(10000.0) / (half - 1)
    freqs = torch.exp(-scale * torch.arange(half, dtype=torch.float32, device=t.device))
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


def _groups(channels: int) -> int:
    g = min(32, channels)
    while channels % g:
        g -= 1
    return g


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


class _Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, bias: bool = True):
        super().__init__()
        self.weight = _param(cout, cin, k, k)
        self.bias = _param(cout) if bias else None


class _Linear(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = _param(cout, cin)
        self.bias = _param(cout)


class _Norm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.groups = _groups(channels)
        self.weight = _param(channels)
        self.bias = _param(channels)


def _conv(p: Precision, x, layer: _Conv, stride: int = 1):
    pad = layer.weight.shape[-1] // 2
    return F.conv2d(p(x), p(layer.weight), layer.bias, stride=stride, padding=pad)


def _lin(p: Precision, x, w, b=None):
    return F.linear(p(x), p(w), b)


def _gn_silu(x, norm: _Norm):
    return F.silu(F.group_norm(x, norm.groups, norm.weight, norm.bias, eps=1e-6))


def attention(p: Precision, q, k, v, rows: int = 1024):
    """softmax(q k^T / sqrt(d)) v over (B, h, N, d), in blocks of ``rows``
    queries so an N = 4096 score matrix never exists whole."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    kt = p(k).transpose(-1, -2)
    vv = p(v)
    outs = []
    for s in range(0, q.shape[2], rows):
        logits = torch.matmul(p(q[:, :, s:s + rows]), kt) * scale
        outs.append(torch.matmul(p(torch.softmax(logits, dim=-1)), vv))
    return torch.cat(outs, dim=2)


class _Res(nn.Module):
    def __init__(self, cin: int, cout: int, tdim: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.norm1 = _Norm(cin)
        self.conv1 = _Conv(cin, cout, 3)
        self.time_proj = nn.ModuleList([nn.Identity(), _Linear(tdim, cout)])
        self.norm2 = _Norm(cout)
        self.conv2 = _Conv(cout, cout, 3)
        self.skip = _Conv(cin, cout, 1) if cin != cout else None

    def forward(self, p, x, temb, gen):
        h = _conv(p, _gn_silu(x, self.norm1), self.conv1)
        lin = self.time_proj[1]
        tb = _lin(p, F.silu(temb), lin.weight, lin.bias)
        h = _gn_silu(h + tb[:, :, None, None], self.norm2)
        if self.dropout > 0.0 and gen is not None:
            thr = min(int(round(self.dropout * 256.0)), 255)
            bits = torch.empty(h.shape, dtype=torch.uint8, device=h.device,
                               memory_format=torch.channels_last).random_(0, 256, generator=gen)
            h = torch.where(bits >= thr, h * (256.0 / (256.0 - thr)), torch.zeros_like(h))
        h = _conv(p, h, self.conv2)
        return h + (x if self.skip is None else _conv(p, x, self.skip))


class _Attn(nn.Module):
    def __init__(self, channels: int, heads: int, head_dim: int):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        inner = heads * head_dim
        self.norm = _Norm(channels)
        self.qkv = _Conv(channels, 3 * inner, 1, bias=False)
        self.proj = _Conv(inner, channels, 1)

    def forward(self, p, x):
        B, C, H, W = x.shape
        N, n, d = H * W, self.heads, self.head_dim
        h = F.group_norm(x, self.norm.groups, self.norm.weight, self.norm.bias, eps=1e-6)
        h = h.permute(0, 2, 3, 1).reshape(B, N, C)
        qkv = _lin(p, h, self.qkv.weight.reshape(3 * n * d, C))
        q, k, v = qkv.reshape(B, N, 3, n, d).permute(2, 0, 3, 1, 4)
        out = attention(p, q, k, v).permute(0, 2, 1, 3).reshape(B, N, n * d)
        out = _lin(p, out, self.proj.weight.reshape(C, n * d), self.proj.bias)
        return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2)


class _Resample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = _Conv(channels, channels, 3)


class _Level(nn.Module):
    def __init__(self, blocks: Sequence[nn.Module], name: str, resample: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.add_module(name, resample if resample is not None else nn.Identity())


class UNetRef(nn.Module):
    """eps = UNet(x_t, t) on NHWC float32 ``x``; ``generator`` feeds the
    dropout masks (None: no dropout, as in evaluation)."""

    def __init__(self, cfg: dict, precision: Precision = FP32):
        super().__init__()
        self.cfg, self.p = cfg, precision
        tdim, base = cfg["time_embed_dim"], cfg["base_channels"]
        attn_res = set(cfg["attn_resolutions"])
        self.time_mlp = nn.Module()
        self.time_mlp.net = nn.ModuleList([_Linear(tdim, tdim), nn.Identity(),
                                           _Linear(tdim, tdim)])
        self.in_conv = _Conv(cfg["in_channels"], base, 3)
        mults = cfg["channel_mults"]
        self.out_norm = _Norm(base * mults[0])
        self.out_conv = _Conv(base * mults[0], cfg["in_channels"], 3)
        res, ch, skips, downs, plan = cfg["img_resolution"], base, [], [], []
        for i, m in enumerate(mults):
            out, last = base * m, i == len(mults) - 1
            blocks = []
            for _ in range(cfg["num_res_blocks"]):
                blocks.append(_Res(ch, out, tdim, cfg["dropout"]))
                ch = out
                if res in attn_res:
                    blocks.append(_Attn(ch, cfg["num_heads"], cfg["head_dim"]))
            skips.append(ch)
            downs.append(_Level(blocks, "down", None if last else _Resample(ch)))
            plan.append(res)
            if not last:
                res //= 2
        self.downs = nn.ModuleList(downs)
        self.mid = nn.ModuleList([
            _Res(ch, ch, tdim, cfg["dropout"]),
            _Attn(ch, cfg["num_heads"], cfg["head_dim"]) if res in attn_res else nn.Identity(),
            _Res(ch, ch, tdim, cfg["dropout"])])
        ups = []
        for li, m in enumerate(reversed(mults)):
            out = base * m
            up = _Resample(ch) if li > 0 else None
            blocks = [_Res(ch + skips.pop(), out, tdim, cfg["dropout"])]
            blocks += [_Res(out, out, tdim, cfg["dropout"]) for _ in range(cfg["num_res_blocks"])]
            ch = out
            ups.append(_Level(blocks, "up", up))
        self.ups = nn.ModuleList(ups)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p, net = self.p, self.time_mlp.net
        temb = sinusoidal_embedding(t, self.cfg["time_embed_dim"])
        temb = _lin(p, F.silu(_lin(p, temb, net[0].weight, net[0].bias)),
                    net[2].weight, net[2].bias)
        h = _conv(p, x.permute(0, 3, 1, 2), self.in_conv)
        skips: List[torch.Tensor] = []
        for level in self.downs:
            for blk in level.blocks:
                h = blk(p, h, temb, generator) if isinstance(blk, _Res) else blk(p, h)
            skips.append(h)
            if isinstance(level.down, _Resample):
                h = _conv(p, h, level.down.conv, stride=2)
        h = self.mid[0](p, h, temb, generator)
        if isinstance(self.mid[1], _Attn):
            h = self.mid[1](p, h)
        h = self.mid[2](p, h, temb, generator)
        for level in self.ups:
            if isinstance(level.up, _Resample):
                h = _conv(p, F.interpolate(h, scale_factor=2, mode="nearest"), level.up.conv)
            skip = skips.pop()
            if h.shape[-2:] != skip.shape[-2:]:
                h = F.interpolate(h, size=skip.shape[-2:], mode="nearest-exact")
            h = torch.cat([h, skip], dim=1)
            for blk in level.blocks:
                h = blk(p, h, temb, generator)
        out = _conv(p, _gn_silu(h, self.out_norm), self.out_conv)
        return out.permute(0, 2, 3, 1)


MODEL = UNetRef
