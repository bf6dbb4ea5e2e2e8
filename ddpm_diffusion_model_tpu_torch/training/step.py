"""The training step: loss, grads, accumulation, clip, update, EMA.

Counterpart of ``ddpm_diffusion_model_tpu/training/step.py``, run eagerly:
bf16 forward and backward (the model's compute dtype) against fp32 master
params, the loss in fp32, gradient accumulation as a loop over
microbatches that sums fp32 grads, the pre-clip global grad norm, the
optimizer of ``state.py`` and the EMA lerp, all in place on the
:class:`~.state.TrainState`.

The random draws are split from the step body: :func:`draw_step_inputs`
draws t ~ U{1..T-1}, the noise and, for a class-conditional model, the
mask of labels replaced by the NULL token (``cond_dropout``,
classifier-free guidance training) and, for super-resolution training
with ``cond_aug > 0``, the conditioning augmentation's sigma and noise
from the state's generator, which then also feeds the dropout masks;
``train_step(state, batch, draws)`` steps on given draws, so a test can
inject (t, noise, drop, sigma, cond noise) and compare with the JAX step.
A conditional model takes ``(images, labels)`` batches.  An image-
conditional model (``cond_channels > 0``) trains with ``superres_factor``:
each micro-batch's loss builds ``x_cond`` from the batch's own low-res view
(``ops/superres.py``), as the JAX loss does.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import fused_update
from ..ops.diffusion import loss_simple, sample_timesteps
from ..ops.schedules import DiffusionSchedule
from ..ops.superres import aug_cond, build_cond
from ..utils.observe import span
from .ema import ema_update
from .state import AdamWClip, TrainConfig, TrainState, make_lr_schedule

__all__ = ["StepDraws", "draw_step_inputs", "draw_placed", "make_loss_fn", "resolve_weight_fn",
           "make_train_step", "make_eval_step", "make_probe_fn"]

Metrics = Dict[str, object]
Params = Optional[Mapping[str, torch.Tensor]]


@dataclasses.dataclass
class StepDraws:
    """The random inputs of one train step: timesteps (B,), noise shaped
    like the batch, the generator the dropout masks draw from (None:
    torch's default generator of the device), for a class-conditional
    model ``drop`` (B,) bool: the rows whose label becomes the NULL token,
    and for super-resolution training with ``cond_aug > 0`` the
    augmentation's ``cond_sigma`` (B,) ~ U[0, cond_aug] and ``cond_noise``
    (standard normal, shaped like the batch)."""

    t: torch.Tensor
    noise: torch.Tensor
    dropout_generator: Optional[torch.Generator] = None
    drop: Optional[torch.Tensor] = None
    cond_sigma: Optional[torch.Tensor] = None
    cond_noise: Optional[torch.Tensor] = None


def draw_step_inputs(generator: torch.Generator, shape: Sequence[int], T: int,
                     device, cond_dropout: Optional[float] = None,
                     cond_aug: float = 0.0) -> StepDraws:
    """t ~ U{1..T-1}, then standard-normal noise of ``shape``, then, given
    ``cond_dropout`` (a conditional model's), each row's label drop with
    that probability, then, given ``cond_aug > 0`` (super-resolution
    training's), the augmentation's sigma ~ U[0, cond_aug] per row and its
    noise, all from ``generator``, which also feeds the dropout of the
    step.  What a run does not use is not drawn, so the draws of every
    other run are those it always had (JAX draws the augmentation from a
    stream of its own, ``fold_in(key, 1729)``)."""
    t = sample_timesteps(shape[0], T, generator, device)
    noise = torch.randn(tuple(shape), generator=generator, device=device)
    drop = sigma = cond_noise = None
    if cond_dropout is not None:
        drop = torch.rand((shape[0],), generator=generator, device=device) < cond_dropout
    if cond_aug > 0.0:
        sigma = torch.rand((shape[0],), generator=generator, device=device) * cond_aug
        cond_noise = torch.randn(tuple(shape), generator=generator, device=device)
    return StepDraws(t, noise, generator, drop, sigma, cond_noise)


def _check_superres(mcfg, superres_factor: int) -> int:
    """The super-resolution knobs against the model config; returns the
    factor (0 = off).  A ``cond_channels`` model needs superres training
    (the loss builds x_cond) and superres training needs one."""
    f = int(superres_factor or 0)
    cond_ch = int(getattr(mcfg, "cond_channels", 0) or 0)
    if f and not cond_ch:
        raise ValueError(
            "TrainConfig.superres_factor set but the model has no "
            "cond_channels — use e.g. unet_256x256_config(cond_channels=3)")
    if cond_ch and not f:
        raise ValueError(
            "image-conditional model (cond_channels > 0) needs "
            "TrainConfig.superres_factor >= 2 so the loss can build x_cond")
    if f and cond_ch != int(getattr(mcfg, "in_channels", 3)):
        raise ValueError(
            f"superres training derives x_cond from the batch itself, so "
            f"cond_channels ({cond_ch}) must equal in_channels "
            f"({getattr(mcfg, 'in_channels', 3)})")
    return f


def _num_classes(model: nn.Module) -> int:
    return int(getattr(getattr(model, "config", None), "num_classes", 0) or 0)


def _moe_aux_weight(model: nn.Module) -> float:
    """The weight of the MoE load-balance loss in the train loss: the
    config's ``moe_aux_weight`` for a mixture-of-experts DiT, else 0."""
    cfg = getattr(model, "config", None)
    return float(getattr(cfg, "moe_aux_weight", 0.0)) if getattr(cfg, "num_experts", 0) else 0.0


def _split_batch(batch, conditional: bool):
    """``batch`` is images, or ``(images, labels)`` for conditional models
    (an unconditional model drops the labels)."""
    if conditional:
        if not (isinstance(batch, (tuple, list)) and len(batch) == 2) or batch[1] is None:
            raise ValueError(
                "conditional model (num_classes > 0) needs (images, labels) "
                "batches; this loader yields no labels (pass labels= / a "
                "labeled dataset to DeviceCacheLoader, or use DataLoader over "
                "a labeled dataset)")
        return batch[0], batch[1]
    if isinstance(batch, (tuple, list)):
        return batch[0], None
    return batch, None


def _as_labels(y, n: int, device) -> torch.Tensor:
    """(n,) integer labels (numpy, list or a tensor anywhere) as int64 on
    ``device``; a tensor already there is not copied through the host."""
    y = y if torch.is_tensor(y) else torch.from_numpy(np.asarray(y, dtype=np.int64))
    if y.shape != (n,) or y.is_floating_point():
        raise ValueError(f"expected ({n},) integer labels, got {tuple(y.shape)} {y.dtype}")
    return y.to(device=device, dtype=torch.long, non_blocking=True)


def _batch_on(batch, conditional: bool, device):
    """(images float32, labels int64 or None) of ``batch`` on ``device``."""
    x, y = _split_batch(batch, conditional)
    x = torch.as_tensor(x, dtype=torch.float32).to(device, non_blocking=True)
    if conditional:
        y = _as_labels(y, x.shape[0], device)
    return x, y


def _finish_update(state: TrainState, tx: AdamWClip, params, accum: int = 1,
                   sums: Sequence[torch.Tensor] = ()) -> Tuple[torch.Tensor, Tuple]:
    """The tail of every update, in place: the grads of ``params`` (divided
    by ``accum``), the optimizer step with its clip (one pass on the card,
    ``ops/fused_update.py``), the EMA lerp, the grads cleared and the step
    counted.  ``sums`` are 0-d metrics summed over the micro-batches.
    Returns (the pre-clip global grad norm, the metrics' means).  A placed
    state (``state.placement``, a mesh) reduces grads and metrics over the
    ranks first (``parallel/sharding.py``)."""
    if state.placement is not None:
        return state.placement.finish_update(state, tx, params, accum, sums)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    if accum > 1:
        torch._foreach_div_(grads, float(accum))
    grad_norm = fused_update.adamw_(tx, params, grads, state.opt_state)  # pre-clip
    ema_update(state.ema_params, dict(state.model.named_parameters()), state.ema_decay)
    for p in params:
        p.grad = None
    state.step += 1
    return grad_norm, tuple(s / accum for s in sums)


def _drop_labels(y: torch.Tensor, drop: Optional[torch.Tensor], cond_dropout: float,
                 num_classes: int) -> torch.Tensor:
    """Labels with the ``drop`` rows replaced by the NULL token.  Without a
    mask only the certain cases are defined: none dropped at 0, all at 1."""
    if cond_dropout <= 0.0:
        return y
    if drop is None:
        if cond_dropout < 1.0:
            raise ValueError(f"cond_dropout {cond_dropout} needs the drop mask "
                             "(StepDraws.drop)")
        return torch.full_like(y, num_classes)
    return torch.where(drop.to(y.device), torch.full_like(y, num_classes), y)


def resolve_weight_fn(name: Optional[str]):
    """Per-timestep loss weightings defined in eps space, converted to the
    network's native space ("v": * ab, "x0": * SNR, "flow": * ab/(a+b)^2):
    None / "uniform" (plain native-space MSE, not converted), "snr", "p2",
    "min_snr_5".  Returns None or ``fn(t, sched) -> (B,)``."""
    if name in (None, "uniform"):
        return None

    def ab_of(t, sched):
        return sched.alphas_cumprod[t.clamp(0, sched.T - 1)]

    def snr_of(t, sched):
        ab = ab_of(t, sched)
        return ab / (1.0 - ab)

    def native(w_eps):
        def fn(t, sched):
            w = w_eps(t, sched)
            kind = sched.prediction_type
            if kind == "v":
                return w * ab_of(t, sched)
            if kind == "x0":
                return w * snr_of(t, sched)
            if kind == "flow":
                ab = ab_of(t, sched)
                return w * ab / (torch.sqrt(ab) + torch.sqrt(1.0 - ab)).square()
            return w

        return fn

    if name == "snr":
        return native(snr_of)
    if name == "p2":
        return native(lambda t, sched: 1.0 / (1.0 + snr_of(t, sched)))
    if name == "min_snr_5":
        return native(lambda t, sched: torch.clamp(snr_of(t, sched), max=5.0)
                      / torch.clamp(snr_of(t, sched), min=1e-8))
    raise ValueError(f"unknown loss weighting {name!r}")


def make_loss_fn(model: nn.Module, sched: DiffusionSchedule, weight_fn=None,
                 superres_factor: int = 0, cond_dropout: float = 0.1,
                 cond_aug: float = 0.0) -> Callable[..., torch.Tensor]:
    """``loss_fn(batch, draws) -> L_simple`` of the model as it stands
    (train mode: dropout active), from the given t and noise; for a
    mixture-of-experts DiT plus ``moe_aux_weight`` times the layers'
    load-balance loss from the same forward: their mean for the switch
    router, as the JAX loss adds it, and their sum for the dropless one, each
    block's loss added as DiT-MoE's ``AddAuxiliaryLoss`` does.  ``batch`` is
    images, or ``(images, labels)`` for a class-conditional model, whose
    labels become the NULL token where ``draws.drop`` is set.  With
    ``superres_factor`` the model sees ``build_cond(images, factor)``,
    augmented by ``draws.cond_sigma``/``cond_noise`` when ``cond_aug > 0``."""
    sr_factor = _check_superres(model.config, superres_factor)
    num_classes = _num_classes(model)
    aux_weight = _moe_aux_weight(model)

    def loss_fn(batch, draws: StepDraws) -> torch.Tensor:
        x0, y = _split_batch(batch, bool(num_classes))
        if num_classes:
            y = _drop_labels(_as_labels(y, x0.shape[0], x0.device), draws.drop,
                             cond_dropout, num_classes)
        cond = None
        if sr_factor:
            cond = build_cond(x0, sr_factor)
            if cond_aug > 0.0:
                if draws.cond_sigma is None or draws.cond_noise is None:
                    raise ValueError(f"cond_aug {cond_aug} needs the augmentation's "
                                     "draws (StepDraws.cond_sigma, cond_noise)")
                cond = aug_cond(cond, cond_aug, draws.cond_sigma, draws.cond_noise)

        aux_box = []

        def eps_fn(x_t, t):
            if aux_weight:
                eps, aux = model(x_t, t, y, generator=draws.dropout_generator,
                                 x_cond=cond, return_aux=True)
                aux_box.append(aux)
                return eps
            return model(x_t, t, y, generator=draws.dropout_generator, x_cond=cond)

        weight = weight_fn(draws.t, sched) if weight_fn is not None else None
        loss = loss_simple(sched, eps_fn, x0, draws.t, draws.noise, weight=weight)
        if aux_weight:
            (aux,) = aux_box  # loss_simple calls eps_fn exactly once
            loss = loss + aux_weight * aux
        return loss

    return loss_fn


def _micro(draws: StepDraws, sl: slice) -> StepDraws:
    cut = lambda v: None if v is None else v[sl]  # noqa: E731
    return StepDraws(draws.t[sl], draws.noise[sl], draws.dropout_generator,
                     cut(draws.drop), cut(draws.cond_sigma), cut(draws.cond_noise))


def draw_placed(state: TrainState, shape: Sequence[int], T: int, device,
                cond_dropout: Optional[float] = None, cond_aug: float = 0.0) -> StepDraws:
    """The draws of this rank's ``shape`` rows: on one card
    :func:`draw_step_inputs`; under a mesh (``state.placement``) every rank
    draws the GLOBAL batch's t, noise, label drops and augmentation from the
    shared generator and takes its rows, and its dropout masks draw from
    the placement's rank generator."""
    placement = state.placement
    if placement is None:
        return draw_step_inputs(state.generator, shape, T, device, cond_dropout, cond_aug)
    n = shape[0] * placement.batch.shards
    d = draw_step_inputs(state.generator, (n, *shape[1:]), T, device, cond_dropout, cond_aug)
    d = _micro(d, placement.batch.rows(n))
    d.dropout_generator = placement.dropout_generator(state.generator)
    return d


def make_train_step(model: nn.Module, sched: DiffusionSchedule, tx: AdamWClip,
                    cfg: TrainConfig
                    ) -> Callable[..., Tuple[TrainState, Metrics]]:
    """``train_step(state, batch, draws=None) -> (state, metrics)``.

    ``batch`` is (B, H, W, C) float32 in [-1, 1] (moved to the model's
    device), or ``(images, labels)`` for a class-conditional model; with
    ``grad_accum_steps = k`` it is cut into k microbatches (B divisible by
    k) whose fp32 grads are summed and divided by k.  Without ``draws`` the
    step draws them from ``state.generator`` (:func:`draw_placed`).  Under
    a mesh (a placed state) ``batch`` is this rank's rows of the global
    batch, and the step equals the single-process step on the rank-major
    global batch.  ``metrics``: ``loss`` (the global batch's) and the
    pre-clip ``grad_norm`` as 0-d device tensors (no host sync), ``lr`` the
    rate of this update as a float.  Under a profiler the step's phases are
    the spans ``train.forward`` (the draws and each micro-batch's loss),
    ``train.backward`` (each micro-batch's backward) and ``train.update``
    (the rate, clip, optimizer and EMA)."""
    sr_factor = _check_superres(model.config, cfg.superres_factor)
    cond_aug = float(cfg.cond_aug) if sr_factor else 0.0
    loss_fn = make_loss_fn(model, sched, resolve_weight_fn(cfg.loss_weighting),
                           superres_factor=sr_factor, cond_dropout=cfg.cond_dropout,
                           cond_aug=cond_aug)
    conditional = bool(_num_classes(model))
    accum = max(1, int(cfg.grad_accum_steps))
    lr_schedule = make_lr_schedule(cfg)

    def train_step(state: TrainState, batch, draws: Optional[StepDraws] = None
                   ) -> Tuple[TrainState, Metrics]:
        params = state.params()
        device = params[0].device
        x, y = _batch_on(batch, conditional, device)
        B = x.shape[0]
        if B % accum:
            raise ValueError(f"batch {B} is not divisible by grad_accum_steps {accum}")
        model.train()
        for p in params:
            p.grad = None
        mb = B // accum
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            with span("train.forward"):
                if draws is None:  # the first micro-batch's forward draws
                    draws = draw_placed(state, x.shape, sched.T, device,
                                        cfg.cond_dropout if conditional else None, cond_aug)
                loss = loss_fn((x[sl], y[sl]) if conditional else x[sl], _micro(draws, sl))
            with span("train.backward"):
                loss.backward()
                loss_sum += loss.detach()
        with span("train.update"):
            lr = lr_schedule(state.step)
            grad_norm, (loss,) = _finish_update(state, tx, params, accum, (loss_sum,))
        return state, {"loss": loss, "grad_norm": grad_norm, "lr": lr}

    return train_step


@contextlib.contextmanager
def _eval_mode(model: nn.Module):
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was)


def _apply(model: nn.Module, params: Params, x_t, t, y=None, x_cond=None):
    """The model on (x_t, t[, y][, x_cond]) with its own weights, or with
    ``params`` (e.g. the EMA shadow) in their place."""
    if params is None:
        return model(x_t, t, y, x_cond=x_cond)
    return torch.func.functional_call(model, dict(params), (x_t, t, y),
                                      {"x_cond": x_cond})


def make_eval_step(model: nn.Module, sched: DiffusionSchedule,
                   superres_factor: int = 0):
    """``eval_step(params, batch, seed) -> L_simple`` in eval mode (no
    dropout, no grads), t and noise drawn from a generator seeded with
    ``seed`` (the JAX step's key), so a fixed seed gives the same draws
    every call; ``params`` None uses the model's weights, a name -> tensor
    map (the EMA shadow) replaces them.  ``batch`` is images, or
    ``(images, labels)`` for a conditional model: its real labels, none
    dropped (the conditional likelihood).  With ``superres_factor`` the
    model sees the batch's own low-res view, not augmented."""
    sr_factor = _check_superres(model.config, superres_factor)
    conditional = bool(_num_classes(model))

    def eval_step(params: Params, batch, seed: int) -> torch.Tensor:
        device = next(model.parameters()).device
        x, y = _split_batch(batch, conditional)
        x = torch.as_tensor(x, dtype=torch.float32).to(device)
        if conditional:
            y = _as_labels(y, x.shape[0], device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        with _eval_mode(model):
            d = draw_step_inputs(gen, x.shape, sched.T, device)
            cond = build_cond(x, sr_factor) if sr_factor else None
            return loss_simple(sched,
                               lambda x_t, t: _apply(model, params, x_t, t, y, cond),
                               x, d.t, d.noise)

    return eval_step


def make_probe_fn(model: nn.Module, sched: DiffusionSchedule,
                  superres_factor: int = 0):
    """``probe(params, x, taus, seed) -> (len(taus),)``: L_simple at each
    fixed timestep in ``taus`` on the batch ``x``, eval mode, fresh noise
    per timestep from a generator seeded with ``seed``.  A conditional
    model runs on its NULL token, as the JAX probe does; with
    ``superres_factor`` the model sees the batch's own low-res view, not
    augmented (a fixed cond keeps the probes comparable across epochs)."""
    sr_factor = _check_superres(model.config, superres_factor)

    def probe(params: Params, x, taus: Sequence[int], seed: int) -> torch.Tensor:
        device = next(model.parameters()).device
        x = torch.as_tensor(x, dtype=torch.float32).to(device)
        generator = torch.Generator(device=device).manual_seed(int(seed))
        losses = []
        with _eval_mode(model):
            cond = build_cond(x, sr_factor) if sr_factor else None
            for tau in taus:
                t = torch.full((x.shape[0],), int(tau), dtype=torch.long, device=device)
                noise = torch.randn(x.shape, generator=generator, device=device)
                losses.append(loss_simple(
                    sched, lambda x_t, tt: _apply(model, params, x_t, tt, x_cond=cond), x, t,
                    noise))
        return torch.stack(losses)

    return probe
