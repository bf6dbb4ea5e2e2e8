"""Train config, optimizer and train state.

Counterpart of ``ddpm_diffusion_model_tpu/training/state.py``:

- :class:`TrainConfig`, field for field the JAX one, with the same
  ``from_dict(legacy=)``.  ``flat_optimizer``, ``dropout_rng_impl`` and
  ``flat_step_tail`` choose a JAX memory layout or PRNG family and have no
  numerical meaning; the port accepts them and ignores them.
- :func:`make_lr_schedule`: ``base_lr * min(1, (count + 1) / warmup)``,
  evaluated in float32 at the update count before the step, as optax does.
- :func:`make_optimizer`: optax's ``chain(clip_by_global_norm(clip),
  adamw(schedule, b1, b2, eps=1e-8, eps_root=0, weight_decay, mu_dtype))``
  on lists of tensors, updating params and moments in place with
  multi-tensor ops.  The clip is optax's: ``g / ||g|| * max`` only when
  ``||g|| >= max``, no epsilon.  ``moment_dtype="bfloat16"`` keeps the
  first moment in bf16 between steps, as optax's ``mu_dtype``.  The train
  step's update runs it as one kernel on the card
  (``ops/fused_update.py`` ``adamw_``), and this step is that kernel's
  plain version.
- :class:`TrainState`: step, the model (its parameters are the fp32
  master weights), the optimizer state, the EMA shadow, the EMA decay and
  the ``torch.Generator`` the step draws from.  The step updates it in
  place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .ema import ema_init

__all__ = ["TrainConfig", "TrainState", "AdamWClip", "make_lr_schedule",
           "make_optimizer", "init_train_state", "global_norm"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization knobs, field for field the JAX ``TrainConfig``."""

    base_lr: float = 2e-4
    warmup_steps: Optional[int] = 1000
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    grad_clip: Optional[float] = 1.0
    grad_accum_steps: int = 1
    ema_decay: float = 0.9995
    # per-timestep loss weighting: None | "uniform" | "snr" | "p2" | "min_snr_5"
    loss_weighting: Optional[str] = None
    flat_optimizer: bool = True        # JAX memory layout; ignored here
    dropout_rng_impl: str = "rbg"      # JAX PRNG family; ignored here
    # "bfloat16": keep Adam's first moment in bf16 between steps
    moment_dtype: Optional[str] = None
    cond_dropout: float = 0.1          # class-conditional training: P(label -> NULL)
    superres_factor: int = 0           # SR training: x_cond = the batch's f-x low-res view
    cond_aug: float = 0.0              # SR training: sigma ~ U[0, cond_aug] noise on x_cond
    flat_step_tail: bool = False       # JAX memory layout; ignored here

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict, *, legacy: bool = False) -> "TrainConfig":
        """``legacy=True`` fills the defaults that checkpoint metas written
        before the JAX package's perf knobs imply."""
        d = dict(d)
        if legacy:
            d.setdefault("flat_optimizer", False)
            d.setdefault("dropout_rng_impl", "threefry")
            d.setdefault("flat_step_tail", False)
        return cls(**d)


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """count -> learning rate: linear warmup to ``base_lr``, then constant,
    rounded as the JAX schedule computes it in float32."""
    base, warmup = np.float32(cfg.base_lr), cfg.warmup_steps

    def schedule(count: int) -> float:
        if not warmup or warmup <= 0:
            return float(base)
        ramp = np.float32(count + 1) / np.float32(warmup)
        return float(base * np.minimum(np.float32(1.0), ramp))

    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, as a float32 0-d tensor on
    their device (no host sync)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamWClip:
    """optax ``chain(clip_by_global_norm, adamw)`` on lists of tensors.

    ``init(params)`` returns the state ``{"count", "schedule_count", "mu",
    "nu"}``; ``step(params, grads, state)`` clips ``grads`` in place,
    updates the moments and ``params`` in place and advances both counts.
    ``count`` drives Adam's bias correction and ``schedule_count`` the
    learning-rate schedule, as optax keeps ``ScaleByAdamState.count`` and
    ``ScaleByScheduleState.count`` apart: equal on a fresh state, apart
    after a resume that resets the moments but not the warmup.  A state
    without ``schedule_count`` (written before it existed) runs the
    schedule on ``count``."""

    def __init__(self, cfg: TrainConfig):
        if cfg.moment_dtype not in (None, "bfloat16", "float32"):
            raise ValueError(f"unknown moment_dtype {cfg.moment_dtype!r}")
        self.cfg = cfg
        self.lr = make_lr_schedule(cfg)
        self.mu_dtype = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else None

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        mu = [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        return {"count": 0, "schedule_count": 0, "mu": mu, "nu": nu}

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             state: Dict[str, Any], grad_norm: Optional[torch.Tensor] = None) -> None:
        """``grad_norm``: the global norm the clip divides by, when ``grads``
        are one rank's shards of the gradient (FSDP); else their own norm."""
        cfg = self.cfg
        if cfg.grad_clip is not None:
            g_norm = global_norm(grads) if grad_norm is None else grad_norm
            factor = torch.where(g_norm < cfg.grad_clip, torch.ones_like(g_norm),
                                 cfg.grad_clip / g_norm)
            torch._foreach_mul_(grads, factor)
        b1, b2 = cfg.adam_b1, cfg.adam_b2
        bc1, bc2, lr = self.scalars(state)
        if self.mu_dtype is None:
            mu = state["mu"]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        else:
            # as optax under jit: the weak-typed b1 takes the moment's bf16
            # (0.9 -> 0.8984375), the product and the sum are float32, and
            # the sum is stored back in bf16
            b1_lo = self.b1_lo()
            mu = [g.mul(1.0 - b1).add_(m.float().mul_(b1_lo))
                  for g, m in zip(grads, state["mu"])]
        nu = state["nu"]
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, 1e-8)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        if cfg.weight_decay:
            torch._foreach_add_(upd, params, alpha=cfg.weight_decay)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)
        if self.mu_dtype is not None:
            for m, m32 in zip(state["mu"], mu):
                m.copy_(m32)
        self.advance(state)

    def scalars(self, state: Dict[str, Any]) -> Tuple[float, float, float]:
        """(Adam's two bias corrections, the learning rate) of the next
        update of ``state``: the corrections in float32, as optax computes
        ``1 - decay ** count``, the rate at the schedule's clock."""
        count = state["count"] + 1
        bc1 = float(np.float32(1.0) - np.float32(self.cfg.adam_b1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(self.cfg.adam_b2) ** np.float32(count))
        return bc1, bc2, self.lr(state.get("schedule_count", state["count"]))

    def b1_lo(self) -> float:
        """b1 rounded to the bf16 first moment's dtype (``moment_dtype``)."""
        return float(torch.tensor(self.cfg.adam_b1, dtype=self.mu_dtype))

    @staticmethod
    def advance(state: Dict[str, Any]) -> None:
        """Count one update in ``state``: Adam's count and the schedule's."""
        clock = state.get("schedule_count", state["count"])
        state["count"] += 1
        state["schedule_count"] = clock + 1


def make_optimizer(cfg: TrainConfig) -> AdamWClip:
    """Global-norm clip (when ``cfg.grad_clip``), then AdamW on the warmup
    schedule."""
    return AdamWClip(cfg)


@dataclasses.dataclass
class TrainState:
    """What the train step advances.  ``model`` holds the fp32 master
    weights; ``ema_params`` maps parameter names to the shadow.
    ``placement`` (``parallel/sharding.py`` ``place_state``) is how the
    state lies over a mesh; None on one card."""

    step: int
    model: nn.Module
    opt_state: Dict[str, Any]
    ema_params: Dict[str, torch.Tensor]
    ema_decay: float
    generator: torch.Generator
    placement: Optional[Any] = None

    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())


def init_train_state(model: nn.Module, cfg: TrainConfig, seed: int = 0,
                     tx: Optional[AdamWClip] = None
                     ) -> Tuple[TrainState, AdamWClip]:
    """Fresh state: step 0, zero moments, the EMA a copy of the params, a
    generator on the params' device seeded with ``seed``."""
    tx = tx if tx is not None else make_optimizer(cfg)
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    gen = torch.Generator(device=device).manual_seed(seed)
    state = TrainState(step=0, model=model,
                       opt_state=tx.init(list(params.values())),
                       ema_params=ema_init(params),
                       ema_decay=float(cfg.ema_decay), generator=gen)
    return state, tx
