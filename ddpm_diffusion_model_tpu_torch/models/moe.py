"""The mixture-of-experts MLPs of the DiT blocks: the switch-routed
``MoEMlp`` and the dropless ``DroplessMoE``.

``MoEMlp`` is the counterpart of ``ddpm_diffusion_model_tpu/models/moe.py``,
with its semantics exactly:

- the router is a float32 Linear over the float32 tokens and a softmax;
  each token goes to its argmax expert (the first on a tie) with ``gate``
  the largest probability;
- capacity ``C = max(1, ceil(int(N * capacity_factor) / E))`` per
  sequence and expert; a token's slot is its running count among the
  tokens of its own sequence sent to the same expert, and a token whose
  slot is ``>= C`` is dropped: its output is exactly 0 (the residual
  stream carries it);
- the experts run in the compute dtype on stacked ``wi (E, H, F)``,
  ``bi (E, F)``, ``wo (E, F, H)``, ``bo (E, H)`` as one batched matmul
  each, GELU tanh-approximate; the combine (gate times the expert's row)
  runs in float32;
- the Switch load-balance loss ``aux = E * sum_e f_e * P_e`` (f the share
  of tokens routed to e, P its mean router probability).

JAX dispatches and combines through one-hot ``(B, N, E, C)`` einsums.  Here
the kept tokens are scattered by index into the expert-major buffer
``(E, B * C, H)`` (row ``b * C + slot`` of expert e, JAX's layout) and
gathered back, the dropped ones into and from one spare row past it; each
output row is the one gated term either way, no ``(B, N, E, C)`` tensor is
formed and nothing waits on the host.  ``gate`` is an ``amax``, whose gradient
splits evenly over tied maxima as ``jnp.max``'s does.  Under an
``expert_parallel_mesh`` the experts split over its axis between the
dispatch and the combine (``parallel/ep.py`` :func:`shard_experts`).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.ep import current_ep_mesh, shard_experts

__all__ = ["MoEMlp", "DroplessMoE", "SwiGLU", "capacity", "lecun_normal_",
           "grouped_swiglu_fwd", "grouped_swiglu_bwd", "grouped_mm_launches",
           "grouped_mm_bwd_launches"]

#: ``torch._grouped_mm`` calls made by the dropless layer's experts (two a
#: forward, four a backward), and of them the backward's
grouped_mm_launches = 0
grouped_mm_bwd_launches = 0


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """Flax's LeCun-normal init in place: a normal truncated at two standard
    deviations, scaled so the variance is ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std)


def capacity(n_tokens: int, capacity_factor: float, num_experts: int) -> int:
    """Slots per sequence and expert: ``max(1, ceil(int(N * cf) / E))``."""
    return max(1, -(-int(n_tokens * capacity_factor) // num_experts))


class MoEMlp(nn.Module):
    """Top-1 (switch) mixture-of-experts MLP over ``(B, N, H)`` tokens.
    ``forward`` returns ``(y, aux)``: ``y`` the gated expert output in the
    input's dtype (dropped tokens 0), ``aux`` the layer's float32
    load-balance loss."""

    def __init__(self, hidden_size: int, mlp_dim: int, num_experts: int,
                 capacity_factor: float = 1.25, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if num_experts < 2:
            raise ValueError(f"MoE needs >= 2 experts, got {num_experts}")
        E, H, Fd = num_experts, hidden_size, mlp_dim
        self.num_experts, self.capacity_factor, self.dtype = E, capacity_factor, dtype
        self.router = nn.Linear(H, E)
        self.wi = nn.Parameter(torch.empty(E, H, Fd))
        self.bi = nn.Parameter(torch.zeros(E, Fd))
        self.wo = nn.Parameter(torch.empty(E, Fd, H))
        self.bo = nn.Parameter(torch.zeros(E, H))
        lecun_normal_(self.router.weight, H)
        nn.init.zeros_(self.router.bias)
        # per expert: fan-in is the input width, the expert axis a batch axis
        lecun_normal_(self.wi, H)
        lecun_normal_(self.wo, Fd)

    def _experts(self, xe: torch.Tensor, experts: slice) -> torch.Tensor:
        """The experts of ``experts`` on their rows ``xe`` of the dispatch
        buffer: one batched matmul each way, GELU between."""
        dt = self.dtype
        h = torch.bmm(xe, self.wi[experts].to(dt)) + self.bi[experts].to(dt)[:, None, :]
        h = F.gelu(h, approximate="tanh")
        return torch.bmm(h, self.wo[experts].to(dt)) + self.bo[experts].to(dt)[:, None, :]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, N, H = x.shape
        E, dt = self.num_experts, self.dtype
        C = capacity(N, self.capacity_factor, E)

        probs = torch.softmax(F.linear(x.float(), self.router.weight, self.router.bias), -1)
        gate = probs.amax(-1)                                  # (B, N)
        idx = probs.argmax(-1)                                 # (B, N), first max
        eo = F.one_hot(idx, E)                                 # (B, N, E)
        slot = (eo.cumsum(1) - 1).gather(-1, idx[..., None])[..., 0]  # (B, N)
        # a dropped token's row is the spare one past the experts' rows: it
        # is never read by the experts, and reads back as 0 (no host sync)
        spare = E * B * C
        b_of = torch.arange(B, device=x.device)[:, None]
        row = torch.where(slot < C, idx * (B * C) + b_of * C + slot, spare).reshape(-1)

        xe = x.new_zeros((spare + 1, H), dtype=dt).index_put((row,), x.to(dt).reshape(-1, H))
        xe = xe[:spare].view(E, B * C, H)
        ye = shard_experts(xe, self._experts)
        ye = torch.cat([ye.reshape(spare, H), ye.new_zeros((1, H))])

        # index_select: its backward adds each row's gradient once (the
        # spare row's many are dropped), where ye[row]'s sorts the indices
        # and walks the spare row's duplicates one by one
        y = ye.index_select(0, row).view(B, N, H).float() * gate[..., None]

        f = eo.float().mean((0, 1))
        p = probs.mean((0, 1))
        aux = float(E) * (f * p).sum()
        return y.to(x.dtype), aux


def _span(name: str):
    # the models load before the training package, which imports them
    from ..training.diagnostics import span

    return span(name)


class SwiGLU(nn.Module):
    """A bias-free SwiGLU MLP, ``down_proj(silu(gate_proj(u)) * up_proj(u))``:
    one expert of :class:`DroplessMoE` (DiT-MoE's ``MoeMLP``)."""

    def __init__(self, hidden_size: int, width: int):
        super().__init__()
        self.gate_proj = nn.Linear(hidden_size, width, bias=False)
        self.up_proj = nn.Linear(hidden_size, width, bias=False)
        self.down_proj = nn.Linear(width, hidden_size, bias=False)
        for lin in (self.gate_proj, self.up_proj):
            lecun_normal_(lin.weight, hidden_size)
        lecun_normal_(self.down_proj.weight, width)

    def forward(self, u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """On ``u`` in ``dtype``, with the weights cast to it."""
        g = F.linear(u, self.gate_proj.weight.to(dtype))
        a = F.silu(g) * F.linear(u, self.up_proj.weight.to(dtype))
        return F.linear(a, self.down_proj.weight.to(dtype))


def _grouped_mm(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor,
                backward: bool = False) -> torch.Tensor:
    global grouped_mm_launches, grouped_mm_bwd_launches
    grouped_mm_launches += 1
    grouped_mm_bwd_launches += int(backward)
    return torch._grouped_mm(a, b, offs=offs)


def grouped_swiglu_fwd(xs: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor,
                       offs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts on their rows: ``xs (R, H)`` in expert order,
    expert ``i`` taking rows ``[offs[i - 1], offs[i])``; ``w13 (E, 2F, H)``
    each expert's gate rows then its up rows, ``w2 (E, H, F)`` its down
    projection.  Returns ``(y (R, H), gu (R, 2F))``: ``gu`` the gate and up
    products, which the backward takes."""
    gu = _grouped_mm(xs, w13.transpose(-2, -1), offs)
    g, u = gu.chunk(2, dim=-1)
    return _grouped_mm(F.silu(g) * u, w2.transpose(-2, -1), offs), gu


def grouped_swiglu_bwd(dy: torch.Tensor, xs: torch.Tensor, w13: torch.Tensor,
                       w2: torch.Tensor, offs: torch.Tensor, gu: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dxs, dw13, dw2)`` of :func:`grouped_swiglu_fwd` for ``dy (R, H)``:
    each input gradient a grouped product over the rows, each weight
    gradient one with the offsets on its reduction axis (an expert with no
    rows gets zeros); the SwiGLU's backward as autograd runs it in the
    compute dtype."""
    g, u = gu.chunk(2, dim=-1)
    sg = F.silu(g)
    da = _grouped_mm(dy, w2, offs, backward=True)
    dw2 = _grouped_mm(dy.t(), sg * u, offs, backward=True)
    dgu = torch.cat([torch.ops.aten.silu_backward(da * u, g), da * sg], dim=-1)
    dw13 = _grouped_mm(dgu.t(), xs, offs, backward=True)
    return _grouped_mm(dgu, w13, offs, backward=True), dw13, dw2


class _GroupedSwiGLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, w13, w2, offs):
        y, gu = grouped_swiglu_fwd(xs, w13, w2, offs)
        ctx.save_for_backward(xs, w13, w2, offs, gu)
        return y

    @staticmethod
    def backward(ctx, dy):
        with _span("moe.experts.bwd"):
            dxs, dw13, dw2 = grouped_swiglu_bwd(dy.contiguous(), *ctx.saved_tensors)
        return dxs, dw13, dw2, None


class DroplessMoE(nn.Module):
    """DiT-MoE's top-``k`` mixture of bias-free SwiGLU experts with no
    capacity and a shared expert, over ``(B, N, H)`` tokens.  ``forward``
    returns ``(y, aux)``: ``y`` in the input's dtype, ``aux`` the layer's
    float32 balance loss, unweighted.  The parameters carry the published
    names (``gate.weight``, ``experts.<i>.{gate,up,down}_proj.weight``,
    ``shared_experts.{gate,up,down}_proj.weight``), each a 2-D matrix."""

    def __init__(self, hidden_size: int, mlp_dim: int, num_experts: int,
                 experts_per_token: int = 2, shared_dim: int = 0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if not 1 <= experts_per_token <= num_experts:
            raise ValueError(f"experts_per_token must lie in [1, {num_experts}], got "
                             f"{experts_per_token}")
        self.num_experts, self.k, self.dtype = num_experts, experts_per_token, dtype
        self.gate = nn.Linear(hidden_size, num_experts, bias=False)
        lecun_normal_(self.gate.weight, hidden_size)
        self.experts = nn.ModuleList(SwiGLU(hidden_size, mlp_dim) for _ in range(num_experts))
        self.shared_experts = SwiGLU(hidden_size, shared_dim) if shared_dim else None

    def _stacked(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(w13 (E, 2F, H), w2 (E, H, F))`` in the compute dtype."""
        E, ex = self.num_experts, self.experts
        F_, H = ex[0].gate_proj.weight.shape
        w13 = torch.stack([w for e in ex for w in (e.gate_proj.weight, e.up_proj.weight)])
        w2 = torch.stack([e.down_proj.weight for e in ex])
        return w13.view(E, 2 * F_, H).to(self.dtype), w2.to(self.dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if current_ep_mesh() is not None:
            raise ValueError("the dropless MoE holds all its experts on each card: it has no "
                             "expert-parallel form (use the switch router under "
                             "expert_parallel_mesh)")
        B, N, H = x.shape
        E, k, dt = self.num_experts, self.k, self.dtype
        T = B * N
        h = x.reshape(T, H)
        with _span("moe.route"):
            probs = torch.softmax(F.linear(h.float(), self.gate.weight), dim=-1)  # (T, E)
            w, e = probs.topk(k, dim=-1)                                           # (T, k)
            e = e.reshape(-1)
            counts = torch.zeros(E, dtype=torch.int32, device=x.device).scatter_add_(
                0, e, torch.ones_like(e, dtype=torch.int32))
            order = torch.sort(e, stable=True).indices   # pairs t * k + j by expert
            offs = counts.cumsum(0, dtype=torch.int32)
            aux = (probs.mean(0) * counts.float()).sum() * (E / (k * T))
        with _span("moe.dispatch"):
            xs = h.to(dt).index_select(0, order // k)
        w13, w2 = self._stacked()
        with _span("moe.experts"):
            ys = _GroupedSwiGLU.apply(xs, w13, w2, offs)
        with _span("moe.shared"):
            shared = None if self.shared_experts is None else self.shared_experts(h.to(dt), dt)
        with _span("moe.combine"):
            back = torch.empty_like(order).scatter_(
                0, order, torch.arange(k * T, device=x.device))
            y = (ys.index_select(0, back).view(T, k, H).float() * w[..., None]).sum(1)
            if shared is not None:
                y = y + shared.float()
        return y.view(B, N, H).to(x.dtype), aux
