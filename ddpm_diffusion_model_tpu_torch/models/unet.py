"""Time-conditioned U-Net epsilon-predictor, the port of the JAX ``UNetDenoiser``.

Counterpart of ``ddpm_diffusion_model_tpu/models/unet.py`` with the same
(nonstandard) topology: one skip per level, Res(+Attn) blocks per level,
Res -> Attn? -> Res bottleneck, a decoder without attention whose first
block per level takes the concatenated skip, and a GN -> SiLU -> conv head.

The module tree registers the reference's torch names and order
(``time_mlp.net.{0,2}``, ``in_conv``, ``out_norm``, ``out_conv``,
``downs.L.blocks.j`` / ``downs.L.down.conv``, ``mid.{0,1,2}``,
``ups.L.blocks.n`` / ``ups.L.up.conv``), so reference checkpoints load
with ``load_state_dict(strict=True)``.

The port runs ``y=None``, for sampling and training: ``.train()`` /
``.eval()`` take the place of ``deterministic``, the ResBlocks' dropout
draws from the ``generator`` the forward is given, and ``remat`` (``True``
or ``"masks"``) rematerializes the ResBlocks, not the AttnBlocks, as in
JAX.  ``mode="decode"`` with ``cached=(mid, skips)`` from an earlier
``return_features=True`` forward runs the decoder and head only, the
encoder-cached fast sampler's reuse step.  Class embeddings and
``cond_channels`` come later.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .blocks import (AttnBlock, Downsample, ResBlock, Upsample, conv,
                     gn_silu_nchw, group_norm)
from .embeddings import TimeMLP, sinusoidal_time_embedding

#: the encoder's output a decode forward reuses: (mid, one skip per level)
Features = Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]

__all__ = ["UNetConfig", "UNetDenoiser", "unet_64x64_config",
           "unet_64x64_low_config", "unet_256x256_config", "count_params"]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Architecture knobs of the reference U-Net; field for field the JAX
    ``UNetConfig``."""

    in_channels: int = 3
    base_channels: int = 128
    channel_mults: Tuple[int, ...] = (1, 2, 2, 2)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16, 8)
    time_embed_dim: int = 512
    dropout: float = 0.0
    attn_p_drop: float = 0.0
    num_heads: int = 4
    head_dim: int = 64
    img_resolution: int = 64
    num_classes: int = 0
    cond_channels: int = 0

    def level_plan(self):
        """Per-level dicts (resolution, out_ch, use_attn, downsample) and
        the bottleneck resolution; resolution halves after every non-final
        level."""
        levels = []
        res = self.img_resolution
        for i, mult in enumerate(self.channel_mults):
            is_last = i == len(self.channel_mults) - 1
            levels.append(dict(resolution=res, out_ch=self.base_channels * mult,
                               use_attn=res in set(self.attn_resolutions),
                               downsample=not is_last))
            if not is_last:
                res //= 2
        return levels, res

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "UNetConfig":
        d = dict(d)
        fam = d.pop("family", "unet")
        if fam != "unet":
            raise ValueError(f"not a UNet config (family={fam!r})")
        d["channel_mults"] = tuple(d["channel_mults"])
        d["attn_resolutions"] = tuple(d["attn_resolutions"])
        return cls(**d)


class _Level(nn.Module):
    """One encoder or decoder level: ``blocks`` plus its resampler
    (``down`` or ``up``; ``nn.Identity`` where the reference has none)."""

    def __init__(self, blocks, resample_name: str, resample: nn.Module):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.add_module(resample_name, resample)


class UNetDenoiser(nn.Module):
    """eps_hat = UNet(x_t, t); x NHWC in [-1, 1], t (B,) int or float.

    ``dtype`` is the compute type (bf16 by default, as in the JAX model);
    params are float32.  The time MLP and ``out_conv`` run in float32.
    ``device`` is where the params are made (``"meta"`` builds shapes
    only).  ``dropout_impl`` is ``"packed"`` (the JAX default) or
    ``"flax"``.  ``remat``: False; ``True`` recomputes every ResBlock in
    the backward (the 256x256 memory lever); ``"masks"`` keeps everything
    but the ResBlocks' dropout bits, which the backward draws again."""

    def __init__(self, config: UNetConfig, dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device] = "cuda",
                 dropout_impl: str = "packed", remat=False):
        super().__init__()
        if config.num_classes or config.cond_channels:
            raise NotImplementedError(
                "class-conditional and image-conditional U-Nets are not "
                "ported yet")
        if remat not in (False, True, "masks"):
            raise ValueError(f"remat must be False, True or 'masks', got {remat!r}")
        self.config = config
        self.dtype = dtype
        self.dropout_impl = dropout_impl
        self.remat = remat
        with resolve_device(device):
            self._build(config, dtype)

    def _build(self, cfg: UNetConfig, dt: torch.dtype) -> None:
        levels, bottleneck_res = cfg.level_plan()
        tdim = cfg.time_embed_dim
        attn = lambda ch: AttnBlock(ch, cfg.num_heads, cfg.head_dim, dtype=dt,
                                    p_drop=cfg.attn_p_drop)
        res = lambda cin, cout: ResBlock(cin, cout, tdim, dtype=dt,
                                         dropout=cfg.dropout,
                                         dropout_impl=self.dropout_impl,
                                         remat=self.remat)
        # registration order = the reference's parameters() order
        self.time_mlp = TimeMLP(tdim, tdim)
        self.in_conv = nn.Conv2d(cfg.in_channels, cfg.base_channels, 3, padding=1)
        head_ch = levels[0]["out_ch"]
        self.out_norm = group_norm(head_ch)
        self.out_conv = nn.Conv2d(head_ch, cfg.in_channels, 3, padding=1)

        ch, skip_ch, downs = cfg.base_channels, [], []
        for lv in levels:
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(res(ch, lv["out_ch"]))
                ch = lv["out_ch"]
                if lv["use_attn"]:
                    blocks.append(attn(ch))
            skip_ch.append(ch)
            down = Downsample(ch, dtype=dt) if lv["downsample"] else nn.Identity()
            downs.append(_Level(blocks, "down", down))
        self.downs = nn.ModuleList(downs)

        self.mid = nn.ModuleList([
            res(ch, ch),
            attn(ch) if bottleneck_res in set(cfg.attn_resolutions) else nn.Identity(),
            res(ch, ch),
        ])

        ups = []
        for li, lv in enumerate(reversed(levels)):
            up = Upsample(ch, dtype=dt) if li > 0 else nn.Identity()
            out = lv["out_ch"]
            blocks = [res(ch + skip_ch.pop(), out)]
            blocks += [res(out, out) for _ in range(cfg.num_res_blocks)]
            ch = out
            ups.append(_Level(blocks, "up", up))
        self.ups = nn.ModuleList(ups)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                generator: Optional[torch.Generator] = None, *, mode: str = "full",
                cached: Optional[Features] = None, return_features: bool = False):
        """``generator`` feeds the ResBlocks' dropout in training mode
        (``None``: torch's default generator of the device).

        ``mode="full"`` runs the whole network; with ``return_features``
        it returns ``(eps, (mid, skips))``: the bottleneck's output and one
        skip per level, taken before its downsample, NCHW channels_last in
        the compute dtype (JAX's are NHWC).  ``mode="decode"`` skips
        ``in_conv``, the encoder and the bottleneck: the decoder and head
        run on ``cached`` (cast to the compute dtype) with the fresh time
        embedding of ``t``; ``x`` gives only the output dtype."""
        cfg, dt = self.config, self.dtype
        t_emb = self.time_mlp(sinusoidal_time_embedding(t, cfg.time_embed_dim))
        in_dtype = x.dtype
        if mode == "decode":
            if cached is None:
                raise ValueError('mode="decode" requires cached=(mid, skips)')
            h, skips = cached
            h = h.to(dt)
            skips = [s.to(dt) for s in skips]
        elif mode == "full":
            # NHWC memory viewed as NCHW is channels_last: a no-op for contiguous x
            h = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            h = conv(h, self.in_conv, dt)

            skips = []
            for level in self.downs:
                for blk in level.blocks:
                    h = blk(h, t_emb, generator) if isinstance(blk, ResBlock) else blk(h)
                skips.append(h)  # one skip per level, before the downsample
                h = level.down(h)

            h = self.mid[0](h, t_emb, generator)
            h = self.mid[1](h)
            h = self.mid[2](h, t_emb, generator)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        features = (h, tuple(skips)) if return_features else None

        for level in self.ups:
            h = level.up(h)
            skip = skips.pop()
            if h.shape[-2:] != skip.shape[-2:]:
                # jax.image.resize(method="nearest") == torch "nearest-exact"
                h = F.interpolate(h, size=skip.shape[-2:], mode="nearest-exact")
            h = torch.cat([h, skip.to(h.dtype)], dim=1)
            h = h.contiguous(memory_format=torch.channels_last)
            for blk in level.blocks:
                h = blk(h, t_emb, generator)

        h = gn_silu_nchw(h, self.out_norm)
        out = conv(h, self.out_conv, torch.float32).permute(0, 2, 3, 1).to(in_dtype)
        return (out, features) if return_features else out


def unet_64x64_config(**overrides) -> UNetConfig:
    """``celeba64_attn``: 31,312,131 params."""
    base = dict(in_channels=3, base_channels=128, channel_mults=(1, 2, 2, 2),
                num_res_blocks=2, attn_resolutions=(16, 8), time_embed_dim=512,
                dropout=0.1, num_heads=4, head_dim=64, img_resolution=64)
    base.update(overrides)
    return UNetConfig(**base)


def unet_64x64_low_config(**overrides) -> UNetConfig:
    """``celeba64_low``: base 96, one ResBlock per level, attention at 8x8
    with 2 heads x 32; 12,143,427 params."""
    base = dict(in_channels=3, base_channels=96, channel_mults=(1, 2, 2, 2),
                num_res_blocks=1, attn_resolutions=(8,), time_embed_dim=384,
                dropout=0.0, num_heads=2, head_dim=32, img_resolution=64)
    base.update(overrides)
    return UNetConfig(**base)


def unet_256x256_config(**overrides) -> UNetConfig:
    """``celebahq256``: mults (1,1,2,2,4), attention at 16x16; 63,100,675
    params."""
    base = dict(in_channels=3, base_channels=128, channel_mults=(1, 1, 2, 2, 4),
                num_res_blocks=2, attn_resolutions=(16,), time_embed_dim=512,
                dropout=0.0, num_heads=4, head_dim=64, img_resolution=256)
    base.update(overrides)
    return UNetConfig(**base)


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
