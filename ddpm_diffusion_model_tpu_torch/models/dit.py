"""DiT: the transformer denoiser family of the port, dense or mixture-of-experts.

Counterpart of ``ddpm_diffusion_model_tpu/models/dit.py``: a Diffusion
Transformer (Peebles & Xie 2023) with adaLN-Zero conditioning and the U-Net's
call contract, so the train step, the samplers, the service and the CLI run
it unchanged.  Patchify (one reshape and a Linear) -> fixed 2-D sin/cos
positions -> ``depth`` blocks (adaLN-modulated LayerNorm, multi-head
attention, MLP or a switch-routed or dropless MoE, each residual gated) -> a final
adaLN LayerNorm and a Linear back to pixel patches.

The precision contract is JAX's: params float32; patchify, qkv, proj and
the MLP in the compute ``dtype``; the adaLN heads (``ada``,
``final_ada``), the time MLP (``t_fc1``, ``t_fc2``), ``class_emb`` and
``final_proj`` in float32; LayerNorm without affine, eps 1e-6, float32
statistics; each residual adds ``(g * out.float()).to(x.dtype)``; GELU is
tanh-approximate.  ``ada``, ``final_ada`` and ``final_proj`` start at
zero, so a fresh model returns exactly 0.  The other Linears take flax's
init (LeCun normal, zero bias).

The blocks are an ``nn.ModuleList`` (JAX scans them; both compute the same
function, and ``utils/interop.py`` unstacks JAX's scanned leaves), so
``scan_blocks`` is accepted and changes nothing.  Attention goes through
``ops.attention.multi_head_attention``: the flash kernels for CUDA tensors
at every length, their plain versions for CPU tensors.  ``remat`` takes
JAX's values: ``True`` recomputes each block in the backward, ``"dots"``
saves the Linears' outputs (matmuls without a batch axis, JAX's
``dots_with_no_batch_dims_saveable``) and recomputes the rest of the
block, ``"attn"`` recomputes only the attention call; each gives the
gradients of no remat.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.attention import check_attn_impl, multi_head_attention
from ..ops.dropout import flax_dropout
from ..parallel.tp import head_cols, head_rows, shard_heads
from ..utils.device import resolve_device
from .blocks import _checkpointed
from .embeddings import sinusoidal_time_embedding
from .moe import DroplessMoE, MoEMlp, lecun_normal_

__all__ = ["DiTConfig", "DiTBlock", "DiTDenoiser", "dit_s4_64_config",
           "dit_b4_64_config", "dit_moe_64_config", "dit_s4_256_config",
           "dit_moe_xl2_config"]


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Architecture knobs; field for field the JAX ``DiTConfig``."""

    in_channels: int = 3
    img_resolution: int = 64
    patch_size: int = 4
    hidden_size: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    dropout: float = 0.0
    time_embed_dim: int = 256
    # 0 = dense MLP; else every block's MLP is a switch-routed mixture of
    # num_experts expert MLPs (models/moe.py)
    num_experts: int = 0
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # 0 = unconditional; index num_classes is the NULL token
    num_classes: int = 0
    # the MoE's router: "switch" (top-1 with a capacity, GELU experts with
    # biases: MoEMlp) or "dropless" (top-experts_per_token with no capacity,
    # bias-free SwiGLU experts and a shared expert of shared_expert_dim when
    # above 0: DroplessMoE, DiT-MoE's layer; the loss adds every block's
    # balance loss, where the switch path takes their mean).  The port's
    # own: to_dict leaves them out at their switch values, JAX's config.
    moe_router: str = "switch"
    experts_per_token: int = 1
    shared_expert_dim: int = 0

    def __post_init__(self):
        if self.moe_router not in ("switch", "dropless"):
            raise ValueError(f"moe_router must be 'switch' or 'dropless', got "
                             f"{self.moe_router!r}")
        if self.moe_router == "switch" and (self.experts_per_token != 1
                                            or self.shared_expert_dim):
            raise ValueError("experts_per_token and shared_expert_dim go with "
                             "moe_router='dropless'")
        if self.moe_router == "dropless" and not self.num_experts:
            raise ValueError("moe_router='dropless' needs num_experts > 0")

    @property
    def seq_len(self) -> int:
        return (self.img_resolution // self.patch_size) ** 2

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.moe_router == "switch":
            for k in _DROPLESS_FIELDS:
                del d[k]
        d["family"] = "dit"
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DiTConfig":
        d = dict(d)
        fam = d.pop("family", "dit")
        if fam != "dit":
            raise ValueError(f"not a DiT config (family={fam!r})")
        return cls(**d)


_DROPLESS_FIELDS = ("moe_router", "experts_per_token", "shared_expert_dim")


def _posemb_2d_sincos(h: int, w: int, dim: int) -> np.ndarray:
    """Fixed 2-D sin/cos position table, ``dim / 2`` per axis, computed in
    float64 on the host and returned float32 ``(h * w, dim)``."""
    if dim % 4:
        raise ValueError(f"hidden_size must be divisible by 4, got {dim}")
    quarter = dim // 4
    omega = 1.0 / (10000.0 ** (np.arange(quarter, dtype=np.float64) / quarter))

    def axis(n):
        out = np.einsum("n,d->nd", np.arange(n, dtype=np.float64), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)  # (n, dim/2)

    ey, ex = axis(h), axis(w)
    grid = np.concatenate([np.repeat(ey, w, axis=0), np.tile(ex, (h, 1))], axis=1)
    return grid.astype(np.float32)


def _dense(i: int, o: int, zero: bool = False) -> nn.Linear:
    """A Linear with flax's Dense init: LeCun-normal weight and zero bias,
    or all zeros (adaLN-Zero)."""
    lin = nn.Linear(i, o)
    if zero:
        nn.init.zeros_(lin.weight)
    else:
        lecun_normal_(lin.weight, i)
    nn.init.zeros_(lin.bias)
    return lin


def _linear(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    """``lin`` with input and params cast to ``dt`` (flax ``Dense(dtype=dt)``)."""
    return F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine, eps 1e-6, in float32."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-6)


# "dots": the matmuls without a batch axis (every Linear) are saved
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(_ctx, op, *_args, **_kw):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


class DiTBlock(nn.Module):
    """One transformer block with adaLN-Zero modulation.  ``forward(x, c,
    generator) -> (x, aux)``: ``c`` the float32 conditioning vector, ``aux``
    the MoE layer's load-balance loss (a float32 0 for the dense MLP).
    Under a ``tensor_parallel_mesh`` the heads split over its axis
    (``parallel/tp.py`` :func:`shard_heads`)."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float,
                 dropout: float = 0.0, dtype: torch.dtype = torch.bfloat16,
                 num_experts: int = 0, capacity_factor: float = 1.25,
                 attn_remat: bool = False, attn_impl: str = "auto",
                 moe_router: str = "switch", experts_per_token: int = 1,
                 shared_expert_dim: int = 0):
        super().__init__()
        H = hidden_size
        self.num_heads, self.dropout, self.dtype = num_heads, dropout, dtype
        self.attn_remat = attn_remat
        self.attn_impl = check_attn_impl(attn_impl)
        mlp = int(H * mlp_ratio)
        self.ada = _dense(H, 6 * H, zero=True)
        self.qkv = _dense(H, 3 * H)
        self.proj = _dense(H, H)
        if num_experts and moe_router == "dropless":
            self.moe = DroplessMoE(H, mlp, num_experts, experts_per_token, shared_expert_dim,
                                   dtype=dtype)
        elif num_experts:
            self.moe = MoEMlp(H, mlp, num_experts, capacity_factor, dtype=dtype)
        else:
            self.fc1 = _dense(H, mlp)
            self.fc2 = _dense(mlp, H)

    def _drop(self, h: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.training and self.dropout > 0.0:
            return flax_dropout(h, self.dropout, generator)
        return h

    def _heads(self, h: torch.Tensor, heads: slice) -> torch.Tensor:
        """The ``proj`` output of the head group ``heads``: its rows of
        ``qkv`` (q, k and v), its attention, its columns of ``proj`` (the
        bias with the first group); all heads without a TP context."""
        B, N, H = h.shape
        dt, dh = self.dtype, H // self.num_heads
        n = heads.stop - heads.start
        qkv = F.linear(h, head_rows(self.qkv.weight, heads, dh).to(dt),
                       head_rows(self.qkv.bias, heads, dh).to(dt))
        q, k, v = (a.reshape(B, N, n, dh).transpose(1, 2) for a in qkv.chunk(3, dim=-1))
        if self.attn_remat and torch.is_grad_enabled():
            att = checkpoint(multi_head_attention, q, k, v, self.attn_impl,
                             use_reentrant=False)
        else:
            att = multi_head_attention(q, k, v, self.attn_impl)
        bias = self.proj.bias.to(dt) if heads.start == 0 else None
        return F.linear(att.transpose(1, 2).reshape(B, N, n * dh),
                        head_cols(self.proj.weight, heads, dh).to(dt), bias)

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        nh, dt = self.num_heads, self.dtype
        mods = F.linear(F.silu(c), self.ada.weight, self.ada.bias)[:, None, :]
        sh1, sc1, g1, sh2, sc2, g2 = mods.chunk(6, dim=-1)

        h = (_layer_norm(x) * (1.0 + sc1) + sh1).to(dt)
        att = shard_heads(h, nh, self._heads)
        att = self._drop(att, generator)
        x = x + (g1 * att.float()).to(x.dtype)

        h = (_layer_norm(x) * (1.0 + sc2) + sh2).to(dt)
        if hasattr(self, "moe"):
            h, aux = self.moe(h)
        else:
            h = _linear(F.gelu(_linear(h, self.fc1, dt), approximate="tanh"), self.fc2, dt)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        h = self._drop(h, generator)
        x = x + (g2 * h.float()).to(x.dtype)
        return x, aux


class DiTDenoiser(nn.Module):
    """eps_hat = DiT(x_t, t); x NHWC in [-1, 1], t (B,) int or float; the
    output in x's dtype.  ``dtype`` is the compute type (bf16 by default);
    params are float32.  ``device`` is where the params are made
    (``"meta"`` builds shapes only)."""

    def __init__(self, config: DiTConfig, dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device] = "cuda",
                 param_dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 remat=False, scan_blocks: bool = True):
        super().__init__()
        if remat not in (False, True, "dots", "attn"):
            raise ValueError(f"remat must be False, True, 'dots' or 'attn', got {remat!r}")
        if param_dtype != torch.float32:
            raise ValueError(f"the port keeps float32 params, got param_dtype={param_dtype}")
        self.attn_impl = check_attn_impl(attn_impl)
        del scan_blocks  # JAX's scanned and unrolled blocks compute the same function
        self.config, self.dtype, self.remat = config, dtype, remat
        with resolve_device(device):
            self._build(config, dtype)

    def _build(self, cfg: DiTConfig, dt: torch.dtype) -> None:
        H, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed = _dense(p * p * cfg.in_channels, H)
        self.t_fc1 = _dense(cfg.time_embed_dim, H)
        self.t_fc2 = _dense(H, H)
        if cfg.num_classes:
            # flax nn.Embed's init; the last row is the NULL token
            self.class_emb = nn.Embedding(cfg.num_classes + 1, H)
            nn.init.normal_(self.class_emb.weight, std=H ** -0.5)
        self.blocks = nn.ModuleList(
            DiTBlock(H, cfg.num_heads, cfg.mlp_ratio, cfg.dropout, dt, cfg.num_experts,
                     cfg.capacity_factor, attn_remat=self.remat == "attn",
                     attn_impl=self.attn_impl, moe_router=cfg.moe_router,
                     experts_per_token=cfg.experts_per_token,
                     shared_expert_dim=cfg.shared_expert_dim)
            for _ in range(cfg.depth))
        self.final_ada = _dense(H, 2 * H, zero=True)
        self.final_proj = _dense(H, p * p * cfg.in_channels, zero=True)

    def _block(self, blk: DiTBlock, x, c, generator):
        if self.remat in (True, "dots") and torch.is_grad_enabled():
            drops = self.training and blk.dropout > 0.0
            kw = {"context_fn": _DOTS_CONTEXT} if self.remat == "dots" else {}
            return _checkpointed(blk, x, c, generator if drops else None, **kw)
        return blk(x, c, generator)

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, *, mode: str = "full",
                cached=None, return_features: bool = False,
                x_cond: Optional[torch.Tensor] = None, return_aux: bool = False):
        """``y`` (B,) labels of a class-conditional model (``None``: the
        NULL token); ``generator`` feeds the dropout in training mode.
        ``mode``, ``cached`` and ``return_features`` exist for the call
        contract only: encoder-cached sampling and ``x_cond`` (the SR
        upsampler) are U-Net-only and raise.  ``return_aux`` returns
        ``(eps, aux)`` with ``aux`` the MoE load-balance loss over the
        layers: their mean for the switch router (JAX's), their sum for the
        dropless one (DiT-MoE's, each block's loss added); a float32 0 for a
        dense model."""
        if mode != "full" or return_features:
            raise ValueError(
                "encoder-cached sampling (mode/return_features) is U-Net-"
                "only — DiT has no encoder/decoder split to cache")
        if x_cond is not None:
            raise ValueError("x_cond (image conditioning) is U-Net-only: a DiT has no "
                             "cond_channels")
        tokens, c = self.embed(x, t, y)
        auxes = []
        for blk in self.blocks:
            tokens, aux = self._block(blk, tokens, c, generator)
            auxes.append(aux)
        out = self.head(tokens, c, x)
        if return_aux:
            aux = torch.stack(auxes)
            return out, aux.sum() if self.config.moe_router == "dropless" else aux.mean()
        return out

    def embed(self, x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None):
        """The tokens ``(B, N, H)`` in the compute dtype (patchify and the
        positions) and the float32 conditioning ``c (B, H)`` (the time MLP
        and the class row) that the blocks take."""
        cfg, dt = self.config, self.dtype
        B, Hi, Wi, C = x.shape
        p = cfg.patch_size
        if Hi % p or Wi % p:
            raise ValueError(f"image {Hi}x{Wi} not divisible by patch {p}")
        hp, wp = Hi // p, Wi // p

        tokens = x.to(dt).reshape(B, hp, p, wp, p, C).permute(0, 1, 3, 2, 4, 5)
        tokens = _linear(tokens.reshape(B, hp * wp, p * p * C), self.patch_embed, dt)
        pos = torch.from_numpy(_posemb_2d_sincos(hp, wp, cfg.hidden_size))
        tokens = tokens + pos.to(device=tokens.device, dtype=dt)[None]

        c = self.t_fc1(sinusoidal_time_embedding(t, cfg.time_embed_dim))
        c = self.t_fc2(F.silu(c))
        if cfg.num_classes:
            if y is None:
                y = torch.full((B,), cfg.num_classes, dtype=torch.long, device=c.device)
            c = c + self.class_emb(y.to(device=c.device, dtype=torch.long))
        elif y is not None:
            raise ValueError("labels passed to an unconditional model "
                             "(DiTConfig.num_classes == 0)")
        return tokens, c

    def head(self, tokens: torch.Tensor, c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The final adaLN LayerNorm and the projection back to pixel
        patches, shaped and typed like the input ``x``."""
        cfg, dt = self.config, self.dtype
        B, Hi, Wi, _C = x.shape
        p = cfg.patch_size
        hp, wp = Hi // p, Wi // p
        mods = F.linear(F.silu(c), self.final_ada.weight, self.final_ada.bias)[:, None, :]
        shift, scale = mods.chunk(2, dim=-1)
        h = (_layer_norm(tokens) * (1.0 + scale) + shift).to(dt)
        out = F.linear(h.float(), self.final_proj.weight, self.final_proj.bias)
        out = out.reshape(B, hp, wp, p, p, cfg.in_channels).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(B, Hi, Wi, cfg.in_channels).to(x.dtype)


def dit_s4_64_config(**overrides) -> DiTConfig:
    """``celeba64_dit_s4``: DiT-S/4 at 64 px, 256 tokens, 384 wide, 12 deep;
    32,499,120 params."""
    base = dict(in_channels=3, img_resolution=64, patch_size=4, hidden_size=384, depth=12,
                num_heads=6, mlp_ratio=4.0, dropout=0.0, time_embed_dim=256)
    base.update(overrides)
    return DiTConfig(**base)


def dit_b4_64_config(**overrides) -> DiTConfig:
    """DiT-B/4 at 64 px: 768 wide, 12 heads, 12 deep; 129,583,920 params."""
    base = dict(in_channels=3, img_resolution=64, patch_size=4, hidden_size=768, depth=12,
                num_heads=12, mlp_ratio=4.0, dropout=0.0, time_embed_dim=256)
    base.update(overrides)
    return DiTConfig(**base)


def dit_moe_64_config(**overrides) -> DiTConfig:
    """``celeba64_dit_moe``: the S/4 backbone with every block's MLP a
    switch-routed mixture of 8 experts; 131,787,792 params."""
    base = dict(in_channels=3, img_resolution=64, patch_size=4, hidden_size=384, depth=12,
                num_heads=6, mlp_ratio=4.0, dropout=0.0, time_embed_dim=256, num_experts=8,
                capacity_factor=1.25, moe_aux_weight=0.01)
    base.update(overrides)
    return DiTConfig(**base)


def dit_s4_256_config(**overrides) -> DiTConfig:
    """DiT-S/4 at 256 px: 4,096 tokens, where attention holds most of the
    work; 32,499,120 params."""
    base = dict(in_channels=3, img_resolution=256, patch_size=4, hidden_size=384, depth=12,
                num_heads=6, mlp_ratio=4.0, dropout=0.0, time_embed_dim=256)
    base.update(overrides)
    return DiTConfig(**base)


def dit_moe_xl2_config(**overrides) -> DiTConfig:
    """``imagenet256_dit_moe_xl2``: DiT-MoE-XL/2-8E2A (Fei et al. 2024,
    arXiv:2407.11633) on 32x32x4 latents: patch 2 (N = 256), 28 blocks of
    1,152 with 16 heads of 72, each MLP 8 routed SwiGLU experts of 4,608 (2
    a token, no capacity) and a shared one of 2,304, 1,000 classes;
    4,167,850,768 params, 1,492,409,104 active a token."""
    base = dict(in_channels=4, img_resolution=32, patch_size=2, hidden_size=1152, depth=28,
                num_heads=16, mlp_ratio=4.0, dropout=0.0, time_embed_dim=256, num_experts=8,
                moe_aux_weight=0.01, num_classes=1000, moe_router="dropless",
                experts_per_token=2, shared_expert_dim=2304)
    base.update(overrides)
    return DiTConfig(**base)
