"""Consistency distillation: one- and few-step sampling by self-consistency.

Counterpart of ``ddpm_diffusion_model_tpu/training/consistency.py`` (Song
et al. 2023, with the Latent Consistency Models' discrete boundary
parameterization): a student f(z_t, t) maps any point of the teacher's
probability-flow trajectory to its origin x0,

    f(z_t, t) = c_skip(t) z_t + c_out(t) x0_hat(z_t, t),
    c_skip = sd^2 / ((s t)^2 + sd^2),  c_out = s t / sqrt((s t)^2 + sd^2),

so f(z_0, 0) = z_0 exactly.  One update pairs adjacent points (t, t') of an
(N+1)-point ladder: one eta=0 DDIM step of the teacher takes z_t to z_t',
and the student's f(z_t, t) is pulled toward the EMA's f(z_t', t') (the
EMA shadow is the target network) under the pseudo-Huber distance.

As in ``distill.py``: the teacher's step and the EMA target run under
``torch.no_grad`` on name -> tensor maps through
``torch.func.functional_call``, the student runs in eval mode (no dropout)
with autograd on, guidance is baked in through one doubled forward, and the
draws (the pair index, then the noise) come from ``state.generator`` or
are injected as a :class:`~.distill.DistillDraws`.  Sampling takes its x_T
and each refinement's noise from a generator seeded with ``seed``, or as
given; x_T is that generator's first draw, as the service draws a
request's init noise.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.diffusion import ddim_step, q_sample
from ..ops.schedules import DiffusionSchedule
from ..sampling.inference import _sampling
from ..utils.device import resolve_device
from .distill import (DistillDraws, Params, _cycle, _load_weights, _update, _weights,
                      draw_distill_inputs, make_teacher_eps, student_x0)
from .state import (AdamWClip, TrainConfig, TrainState, init_train_state, make_lr_schedule,
                    make_optimizer)
from .step import _apply, _batch_on, _num_classes

__all__ = [
    "SIGMA_DATA",
    "TIMESTEP_SCALING",
    "PSEUDO_HUBER_FACTOR",
    "consistency_ladder",
    "consistency_scalings",
    "consistency_fn",
    "make_consistency_step",
    "consistency_distill",
    "consistency_sample_loop",
    "cm_from_init",
]

SIGMA_DATA = 0.5  # images live in [-1, 1]
TIMESTEP_SCALING = 10.0  # LCM's s: sharpens c_skip's decay away from t=0
PSEUDO_HUBER_FACTOR = 0.00054  # iCT: c = 0.00054 * sqrt(D)


def consistency_ladder(T: int, num_steps: int) -> np.ndarray:
    """The (N+1)-point strictly descending ladder T-1 -> 0 of the training
    pairs and of multistep sampling."""
    N = int(num_steps)
    if N < 1:
        raise ValueError(f"num_steps must be >= 1, got {N}")
    if N + 1 > T:
        raise ValueError(f"{N + 1} ladder points do not fit in T={T}")
    ladder = np.round(np.linspace(T - 1, 0, N + 1)).astype(np.int32)
    if np.any(np.diff(ladder) >= 0):
        raise ValueError(f"ladder for N={N} at T={T} is not strictly descending")
    return ladder


def consistency_scalings(t: torch.Tensor, *, sigma_data: float = SIGMA_DATA,
                         timestep_scaling: float = TIMESTEP_SCALING
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c_skip, c_out), float32, with the t = 0 boundary exact: (1, 0)."""
    st = timestep_scaling * t.float()
    c_skip = sigma_data**2 / (st**2 + sigma_data**2)
    c_out = st * torch.rsqrt(st**2 + sigma_data**2)
    return c_skip, c_out


def consistency_fn(model: nn.Module, params: Optional[Params], sched: DiffusionSchedule,
                   z_t: torch.Tensor, t: torch.Tensor, *, y=None,
                   sigma_data: float = SIGMA_DATA,
                   timestep_scaling: float = TIMESTEP_SCALING) -> torch.Tensor:
    """f(z_t, t) in x0 space, float32, on the model's own weights or on
    ``params``; f(z_0, 0) == z_0 exactly."""
    out = _apply(model, params, z_t, t, y)
    x0_hat = student_x0(sched, out.float(), z_t, t)
    c_skip, c_out = consistency_scalings(t, sigma_data=sigma_data,
                                         timestep_scaling=timestep_scaling)
    shape = (-1,) + (1,) * (z_t.ndim - 1)
    return c_skip.reshape(shape) * z_t.float() + c_out.reshape(shape) * x0_hat


def _distance(pred: torch.Tensor, target: torch.Tensor, kind: str) -> torch.Tensor:
    """Per-sample distance over all non-batch axes."""
    d = (pred - target).float()
    sq = (d * d).sum(dim=tuple(range(1, d.ndim)))
    dim = float(np.prod(pred.shape[1:]))
    if kind == "l2":
        return sq / dim
    if kind == "pseudo_huber":
        c = PSEUDO_HUBER_FACTOR * np.sqrt(dim)
        return torch.sqrt(sq + c * c) - c
    raise ValueError(f"unknown consistency distance {kind!r}")


def make_consistency_step(model: nn.Module, sched: DiffusionSchedule, ladder: np.ndarray,
                          tx: AdamWClip, cfg: TrainConfig, *,
                          guidance: Optional[float] = None, distance: str = "pseudo_huber",
                          sigma_data: float = SIGMA_DATA,
                          timestep_scaling: float = TIMESTEP_SCALING
                          ) -> Callable[..., Tuple[TrainState, Dict[str, object]]]:
    """``consistency_step(state, teacher_params, batch, draws=None) ->
    (state, metrics)`` on the (N+1)-point ``ladder``: each row's pair (t,
    t') takes one eta=0 DDIM teacher step, and f(z_t, t) regresses onto
    the target f(z_t', t') of ``state.ema_params`` (taken before this
    update's EMA lerp; its decay is ``cfg.ema_decay``)."""
    ladder = np.asarray(ladder, dtype=np.int32)
    if ladder.ndim != 1 or len(ladder) < 2:
        raise ValueError("ladder must be an (N+1,)-point descending ladder")
    device = next(model.parameters()).device
    t_hi = torch.from_numpy(ladder[:-1].astype(np.int64)).to(device)
    t_lo = torch.from_numpy(ladder[1:].astype(np.int64)).to(device)
    n_pairs = len(ladder) - 1
    num_classes = _num_classes(model)
    lr_schedule = make_lr_schedule(cfg)
    teacher_eps = make_teacher_eps(model, sched, num_classes, guidance)
    kw = dict(sigma_data=sigma_data, timestep_scaling=timestep_scaling)

    def consistency_step(state: TrainState, teacher_params: Optional[Params], batch,
                         draws: Optional[DistillDraws] = None):
        x0, y = _batch_on(batch, bool(num_classes), device)
        if draws is None:
            draws = draw_distill_inputs(state.generator, x0.shape, n_pairs, device)
        i = draws.i.to(device, torch.long)
        t, tn = t_hi[i], t_lo[i]
        z_t = q_sample(sched, x0, t, draws.noise.to(device, torch.float32))

        def loss_fn():
            with torch.no_grad():
                efn = lambda x, tt: teacher_eps(teacher_params, x, tt, y)  # noqa: E731
                z_prev = ddim_step(sched, efn, z_t, t, tn, torch.zeros_like(z_t), eta=0.0)
                target = consistency_fn(model, state.ema_params, sched, z_prev, tn, y=y,
                                        **kw)
            pred = consistency_fn(model, None, sched, z_t, t, y=y, **kw)
            return _distance(pred, target, distance).mean()

        return _update(model, state, tx, loss_fn, lr_schedule(state.step))

    return consistency_step


def consistency_distill(model: nn.Module, sched: DiffusionSchedule,
                        teacher_params: Optional[Params],
                        make_batches: Callable[[], Iterable[Any]], *,
                        num_ladder_steps: int, updates: int, cfg: TrainConfig,
                        guidance: Optional[float] = None, distance: str = "pseudo_huber",
                        seed: int = 0, log: Optional[Callable[[str], None]] = print,
                        sigma_data: float = SIGMA_DATA,
                        timestep_scaling: float = TIMESTEP_SCALING
                        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """One-phase consistency distillation over a ``num_ladder_steps``-segment
    ladder from ``teacher_params`` (None: the model's own weights, which
    also seed the student).  Returns ``(params, info)``: the EMA
    student as a name -> tensor map and JAX's ``info``, with the
    ``sigma_data`` and ``timestep_scaling`` the student was trained
    under."""
    teacher = _weights(model, teacher_params)
    ladder = consistency_ladder(sched.T, num_ladder_steps)
    tx = make_optimizer(cfg)
    _load_weights(model, teacher)
    state, _ = init_train_state(model, cfg, seed=seed, tx=tx)
    step = make_consistency_step(model, sched, ladder, tx, cfg, guidance=guidance,
                                 distance=distance, sigma_data=sigma_data,
                                 timestep_scaling=timestep_scaling)
    losses = []
    for u, batch in enumerate(_cycle(make_batches, updates)):
        state, metrics = step(state, teacher, batch)
        losses.append(metrics["loss"])
        if log and (u == 0 or (u + 1) % max(1, updates // 4) == 0):
            log(f"[consistency] update {u + 1}/{updates} "
                f"loss {float(metrics['loss']):.5f}")
    info = {
        "steps": 1,  # a consistency model samples at any NFE from 1 up
        "ladder_steps": int(num_ladder_steps),
        "sigma_data": float(sigma_data),
        "timestep_scaling": float(timestep_scaling),
        "phases": [{
            "student_steps": 1,
            "updates": int(updates),
            "first_loss": float(losses[0]),
            "last_loss": float(losses[-1]),
        }],
    }
    return _weights(model, state.ema_params), info


def consistency_sample_loop(model: nn.Module, params: Optional[Params],
                            sched: DiffusionSchedule, shape: Sequence[int], *,
                            seed: Optional[int] = 0, steps: int = 1, y=None,
                            sigma_data: float = SIGMA_DATA,
                            timestep_scaling: float = TIMESTEP_SCALING,
                            x_init: Optional[torch.Tensor] = None,
                            noises: Optional[Sequence[torch.Tensor]] = None,
                            device="cuda") -> torch.Tensor:
    """Multistep consistency sampling (the CM paper's algorithm 1): f from
    x_T at t = T-1, then ``steps - 1`` refinements (re-noise to the next
    ladder point, f again); ``steps = 1`` is one forward.  x_T and each
    refinement's noise are the draws of a generator seeded with ``seed``
    (x_T first), or ``x_init`` and ``noises`` as given.  Eval mode, no
    grad; returns x in [-1, 1], float32."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    dev = resolve_device(device)
    ladder = consistency_ladder(sched.T, steps)
    gen = torch.Generator(device=dev).manual_seed(0 if seed is None else int(seed))
    shape = tuple(shape)
    z = (x_init.to(dev, torch.float32) if x_init is not None
         else torch.randn(shape, generator=gen, device=dev, dtype=torch.float32))
    if y is not None:
        y = torch.as_tensor(y).to(dev, torch.long)
    kw = dict(y=y, sigma_data=sigma_data, timestep_scaling=timestep_scaling)
    with _sampling(model):
        t0 = torch.full((shape[0],), int(ladder[0]), dtype=torch.long, device=dev)
        x = consistency_fn(model, params, sched, z, t0, **kw)
        for k, tm in enumerate(ladder[1:-1]):
            tvec = torch.full((shape[0],), int(tm), dtype=torch.long, device=dev)
            eps = (noises[k].to(dev, torch.float32) if noises is not None
                   else torch.randn(shape, generator=gen, device=dev, dtype=torch.float32))
            x = consistency_fn(model, params, sched, q_sample(sched, x, tvec, eps), tvec,
                               **kw)
        return torch.clamp(x, -1.0, 1.0)


def cm_from_init(model: nn.Module, params: Optional[Params], sched: DiffusionSchedule,
                 x_init: torch.Tensor, y=None, sigma_data: float = SIGMA_DATA,
                 timestep_scaling: float = TIMESTEP_SCALING) -> torch.Tensor:
    """One-forward consistency sampling from EXPLICIT init noise (the
    serving coalescer's kernel, JAX's ``_cm_from_init_jit``): row i depends
    only on row i of ``x_init`` and of ``y``, and equals
    :func:`consistency_sample_loop` at ``steps=1`` from the same x_T."""
    with _sampling(model):
        t0 = torch.full((x_init.shape[0],), int(sched.T) - 1, dtype=torch.long,
                        device=x_init.device)
        x = consistency_fn(model, params, sched, x_init, t0, y=y, sigma_data=sigma_data,
                           timestep_scaling=timestep_scaling)
        return torch.clamp(x, -1.0, 1.0)
