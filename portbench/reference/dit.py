"""The plain float32 DiT of Peebles & Xie (2023, arXiv:2212.09748) as the
repository's ``dit_s4_256_config`` lays it out: the reference the benchmark
holds the port's DiT to.

Patchify (a reshape and a Linear) -> fixed 2-D sin/cos positions -> blocks
of adaLN-Zero modulation (LayerNorm without affine, eps 1e-6; multi-head
attention; a tanh-GELU MLP; each residual gated) -> a final adaLN
LayerNorm and a Linear back to pixel patches.  The conditioning is the
sinusoidal time embedding through ``t_fc1`` -> SiLU -> ``t_fc2``, plus,
for a class-conditional model (``num_classes > 0``), the label's row of
``class_emb`` (``num_classes + 1`` rows, the last the NULL token of a
dropped label).  Module names are the port's (``patch_embed``, ``t_fc1``,
``t_fc2``, ``class_emb``, ``blocks.i.{ada,qkv,proj,fc1,fc2}``,
``final_ada``, ``final_proj``).
Attention runs in blocks of query rows; ``checkpoint_attention`` drops its
probabilities after the forward and computes them again in the backward,
so a batch at N = 4096 fits.  The published model's dropout is 0, and so
is this one's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .lowp import FP32, Precision
from .unet import _Linear, _lin, attention, sinusoidal_embedding

__all__ = ["DiTRef", "MODEL", "posemb_2d"]


def posemb_2d(h: int, w: int, dim: int) -> np.ndarray:
    """(h * w, dim) float32: dim / 2 sin/cos columns for the row index,
    then dim / 2 for the column index, frequencies 10000^(-i / (dim / 4))."""
    quarter = dim // 4
    omega = 1.0 / (10000.0 ** (np.arange(quarter, dtype=np.float64) / quarter))

    def axis(n):
        out = np.arange(n, dtype=np.float64)[:, None] * omega[None, :]
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    ey, ex = axis(h), axis(w)
    return np.concatenate([np.repeat(ey, w, axis=0), np.tile(ex, (h, 1))], axis=1
                          ).astype(np.float32)


def _ln(x):
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


class _Block(nn.Module):
    def __init__(self, H: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.heads = heads
        mlp = int(H * mlp_ratio)
        self.ada = _Linear(H, 6 * H)
        self.qkv = _Linear(H, 3 * H)
        self.proj = _Linear(H, H)
        self.fc1 = _Linear(H, mlp)
        self.fc2 = _Linear(mlp, H)

    def forward(self, p: Precision, x, c, checkpoint_attention: bool):
        B, N, H = x.shape
        mods = _lin(p, F.silu(c), self.ada.weight, self.ada.bias)[:, None, :]
        sh1, sc1, g1, sh2, sc2, g2 = mods.chunk(6, dim=-1)
        h = _ln(x) * (1.0 + sc1) + sh1
        qkv = _lin(p, h, self.qkv.weight, self.qkv.bias)
        q, k, v = (a.reshape(B, N, self.heads, H // self.heads).transpose(1, 2)
                   for a in qkv.chunk(3, dim=-1))
        if checkpoint_attention and torch.is_grad_enabled():
            att = checkpoint(attention, p, q, k, v, use_reentrant=False)
        else:
            att = attention(p, q, k, v)
        att = _lin(p, att.transpose(1, 2).reshape(B, N, H), self.proj.weight, self.proj.bias)
        x = x + g1 * att
        h = _ln(x) * (1.0 + sc2) + sh2
        h = F.gelu(_lin(p, h, self.fc1.weight, self.fc1.bias), approximate="tanh")
        return x + g2 * _lin(p, h, self.fc2.weight, self.fc2.bias)


class DiTRef(nn.Module):
    """eps = DiT(x_t, t[, y]) on NHWC float32 ``x``; ``y`` (B,) the labels
    of a class-conditional model, the NULL token where dropped."""

    def __init__(self, cfg: dict, precision: Precision = FP32,
                 checkpoint_attention: bool = True):
        super().__init__()
        if cfg.get("dropout", 0.0) or cfg.get("num_experts", 0):
            raise ValueError("the DiT reference covers the dense model without dropout")
        self.cfg, self.p, self.ckpt = cfg, precision, checkpoint_attention
        H, pch, C = cfg["hidden_size"], cfg["patch_size"], cfg["in_channels"]
        self.patch_embed = _Linear(pch * pch * C, H)
        self.t_fc1 = _Linear(cfg["time_embed_dim"], H)
        self.t_fc2 = _Linear(H, H)
        if cfg.get("num_classes", 0):
            self.class_emb = nn.Embedding(cfg["num_classes"] + 1, H)
        self.blocks = nn.ModuleList(_Block(H, cfg["num_heads"], cfg["mlp_ratio"])
                                    for _ in range(cfg["depth"]))
        self.final_ada = _Linear(H, 2 * H)
        self.final_proj = _Linear(H, pch * pch * C)

    def forward(self, x: torch.Tensor, t: torch.Tensor, generator=None,
                y=None) -> torch.Tensor:
        del generator  # no dropout
        if (y is not None) != bool(self.cfg.get("num_classes", 0)):
            raise ValueError("labels go with a class-conditional model (num_classes > 0) "
                             "and with it only")
        p, cfg = self.p, self.cfg
        B, Hi, Wi, C = x.shape
        pch, H = cfg["patch_size"], cfg["hidden_size"]
        hp, wp = Hi // pch, Wi // pch
        tok = x.reshape(B, hp, pch, wp, pch, C).permute(0, 1, 3, 2, 4, 5)
        tok = _lin(p, tok.reshape(B, hp * wp, pch * pch * C), self.patch_embed.weight,
                   self.patch_embed.bias)
        tok = tok + torch.from_numpy(posemb_2d(hp, wp, H)).to(tok.device)[None]
        c = _lin(p, sinusoidal_embedding(t, cfg["time_embed_dim"]), self.t_fc1.weight,
                 self.t_fc1.bias)
        c = _lin(p, F.silu(c), self.t_fc2.weight, self.t_fc2.bias)
        if y is not None:
            c = c + self.class_emb.weight[y]
        for blk in self.blocks:
            tok = blk(p, tok, c, self.ckpt)
        shift, scale = _lin(p, F.silu(c), self.final_ada.weight,
                            self.final_ada.bias)[:, None, :].chunk(2, dim=-1)
        h = _ln(tok) * (1.0 + scale) + shift
        out = _lin(p, h, self.final_proj.weight, self.final_proj.bias)
        out = out.reshape(B, hp, wp, pch, pch, C).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(B, Hi, Wi, C)


MODEL = DiTRef
