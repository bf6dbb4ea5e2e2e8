"""The plain float32 DiT-MoE of Fei et al. (2024, "Scaling Diffusion
Transformers to 16 Billion Parameters", arXiv:2407.11633): the reference
the benchmark holds the port's dropless mixture-of-experts DiT to.

The DiT of ``dit.py`` (patchify, fixed 2-D sin/cos positions, adaLN-Zero
blocks, the class row added to the time embedding, the final adaLN
LayerNorm and projection) with every block's MLP replaced by the published
``SparseMoeBlock`` over the block's T = B * N modulated tokens h:

- the gate ``s = softmax(h W_g^T)`` (``moe.gate.weight``, no bias); each
  token's ``experts_per_token`` (k) largest probabilities w and their
  experts e, not renormalised;
- expert i (``moe.experts.<i>``) the bias-free SwiGLU
  ``down_proj(silu(gate_proj(u)) * up_proj(u))`` of width
  ``hidden_size * mlp_ratio``, run here on its own rows in a plain loop
  over the experts; every (token, slot) pair is computed (no capacity);
- ``y_t = sum_j w_tj E_{e_tj}(h_t) + S(h_t)``, S the shared expert
  (``moe.shared_experts``) of width ``shared_expert_dim``;
- the balance loss of DeepSeek-MoE's gate, ``sum_i P_i f_i`` with
  ``P_i = mean_t s_ti`` and ``f_i = E * #{(t, j): e_tj = i} / (k T)``.

``forward`` returns ``(eps, aux)``, ``aux`` every block's balance loss
summed over the blocks and weighted by ``moe_aux_weight``, as the published
code's ``AddAuxiliaryLoss`` adds each block's to the loss.  Every product
(the gate's included) takes its operands through the ``Precision`` given.
Each block is computed again in the backward (``torch.utils.checkpoint``):
its float32 activations at 32,768 tokens would take about 9.5 GB a block.
The parameter names are the port's, so one map of weights loads into both.
Departures from the published model, as the configuration states them: no
``learn_sigma`` channels (eps only) and dropout 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .dit import _ln, posemb_2d
from .lowp import FP32, Precision
from .unet import _Linear, _lin, _param, attention, sinusoidal_embedding

__all__ = ["DiTMoERef", "MODEL", "fwd_flops", "attn_calls"]


class _Weight(nn.Module):
    """A bias-free Linear: its ``weight`` (out, in) alone."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = _param(cout, cin)


class _SwiGLU(nn.Module):
    def __init__(self, H: int, width: int):
        super().__init__()
        self.gate_proj = _Weight(H, width)
        self.up_proj = _Weight(H, width)
        self.down_proj = _Weight(width, H)

    def forward(self, p: Precision, u):
        a = F.silu(_lin(p, u, self.gate_proj.weight)) * _lin(p, u, self.up_proj.weight)
        return _lin(p, a, self.down_proj.weight)


class _MoE(nn.Module):
    def __init__(self, H: int, width: int, num_experts: int, k: int, shared: int):
        super().__init__()
        self.k = k
        self.gate = _Weight(H, num_experts)
        self.experts = nn.ModuleList(_SwiGLU(H, width) for _ in range(num_experts))
        self.shared_experts = _SwiGLU(H, shared) if shared else None

    def forward(self, p: Precision, h):
        """(y, the block's unweighted balance loss) of the (T, H) tokens h."""
        T, E, k = h.shape[0], len(self.experts), self.k
        s = torch.softmax(_lin(p, h, self.gate.weight), dim=-1)
        w, e = s.topk(k, dim=-1)
        e, w = e.reshape(-1), w.reshape(-1)
        token = torch.arange(T, device=h.device).repeat_interleave(k)
        y = torch.zeros_like(h)
        for i, expert in enumerate(self.experts):
            pairs = (e == i).nonzero(as_tuple=True)[0]
            if not len(pairs):
                # an expert no token chose adds nothing and takes a zero
                # gradient (the fp8 rounding has no scale for no rows)
                y = y + 0.0 * sum(q.sum() for q in expert.parameters())
                continue
            rows = token[pairs]
            y = y.index_add(0, rows, expert(p, h[rows]) * w[pairs, None])
        if self.shared_experts is not None:
            y = y + self.shared_experts(p, h)
        f = torch.bincount(e, minlength=E).float() * (E / (k * T))
        return y, (s.mean(0) * f).sum()


class _Block(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        H = cfg["hidden_size"]
        self.heads = cfg["num_heads"]
        self.ada = _Linear(H, 6 * H)
        self.qkv = _Linear(H, 3 * H)
        self.proj = _Linear(H, H)
        self.moe = _MoE(H, int(H * cfg["mlp_ratio"]), cfg["num_experts"],
                        cfg["experts_per_token"], cfg.get("shared_expert_dim", 0))

    def forward(self, p: Precision, x, c):
        B, N, H = x.shape
        mods = _lin(p, F.silu(c), self.ada.weight, self.ada.bias)[:, None, :]
        sh1, sc1, g1, sh2, sc2, g2 = mods.chunk(6, dim=-1)
        h = _ln(x) * (1.0 + sc1) + sh1
        qkv = _lin(p, h, self.qkv.weight, self.qkv.bias)
        q, k, v = (a.reshape(B, N, self.heads, H // self.heads).transpose(1, 2)
                   for a in qkv.chunk(3, dim=-1))
        att = attention(p, q, k, v)
        att = _lin(p, att.transpose(1, 2).reshape(B, N, H), self.proj.weight, self.proj.bias)
        x = x + g1 * att
        h = _ln(x) * (1.0 + sc2) + sh2
        y, aux = self.moe(p, h.reshape(B * N, H))
        return x + g2 * y.reshape(B, N, H), aux


class DiTMoERef(nn.Module):
    """``(eps, aux) = DiT-MoE(x_t, t[, y])`` on NHWC float32 ``x``; ``y`` (B,)
    the labels of a class-conditional model, the NULL token where dropped."""

    def __init__(self, cfg: dict, precision: Precision = FP32):
        super().__init__()
        if cfg.get("moe_router") != "dropless" or cfg.get("dropout", 0.0):
            raise ValueError("the DiT-MoE reference covers the dropless router without dropout")
        self.cfg, self.p = cfg, precision
        H, pch, C = cfg["hidden_size"], cfg["patch_size"], cfg["in_channels"]
        self.patch_embed = _Linear(pch * pch * C, H)
        self.t_fc1 = _Linear(cfg["time_embed_dim"], H)
        self.t_fc2 = _Linear(H, H)
        if cfg.get("num_classes", 0):
            self.class_emb = nn.Embedding(cfg["num_classes"] + 1, H)
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg["depth"]))
        self.final_ada = _Linear(H, 2 * H)
        self.final_proj = _Linear(H, pch * pch * C)

    def forward(self, x: torch.Tensor, t: torch.Tensor, generator=None, y=None):
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
        aux = torch.zeros((), device=x.device)
        for blk in self.blocks:
            if torch.is_grad_enabled():
                tok, a = checkpoint(blk, p, tok, c, use_reentrant=False)
            else:
                tok, a = blk(p, tok, c)
            aux = aux + a
        shift, scale = _lin(p, F.silu(c), self.final_ada.weight,
                            self.final_ada.bias)[:, None, :].chunk(2, dim=-1)
        h = _ln(tok) * (1.0 + scale) + shift
        out = _lin(p, h, self.final_proj.weight, self.final_proj.bias)
        out = out.reshape(B, hp, wp, pch, pch, C).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(B, Hi, Wi, C), float(cfg["moe_aux_weight"]) * aux


MODEL = DiTMoERef


def fwd_flops(m: dict, batch: int) -> int:
    """Matmul FLOPs of one forward, on ``harness/work.py``'s DiT convention
    (qkv and proj 8 N H^2, attention's two products 4 N^2 H, the adaLN head
    12 H^2 a block; the embeddings, the time MLP and the head), the MLP
    being the gate's 2 N H E and 6 H F for each of a token's k routed rows
    and 6 H F_s for its shared row."""
    N = (m["img_resolution"] // m["patch_size"]) ** 2
    H, L = m["hidden_size"], m["depth"]
    Fd, k, Fs = int(H * m["mlp_ratio"]), m["experts_per_token"], m.get("shared_expert_dim", 0)
    pc = m["patch_size"] ** 2 * m["in_channels"]
    mlp = 2 * N * H * m["num_experts"] + 6 * N * H * (k * Fd + Fs)
    per_block = 8 * N * H * H + mlp + 4 * N * N * H + 12 * H * H
    f = 2 * N * pc * H + 2 * (m["time_embed_dim"] * H + H * H) + L * per_block
    f += 4 * H * H + 2 * N * H * pc
    return int(batch * f)


def attn_calls(m: dict, batch: int):
    """Each block's attention as (B * heads, N, head_dim)."""
    N = (m["img_resolution"] // m["patch_size"]) ** 2
    h = m["num_heads"]
    return [(batch * h, N, m["hidden_size"] // h)] * m["depth"]
