"""Progressive distillation: halve the sampling ladder, repeatedly.

Counterpart of ``ddpm_diffusion_model_tpu/training/distill.py`` (Salimans &
Ho 2022): a student learns to reproduce in ONE eta=0 DDIM step t -> t''
what the teacher does in two, t -> t' -> t''; after a phase the EMA
student becomes the next teacher and the ladder halves again.  The student
ladder of an N-step phase is ``build_ddim_schedule("linear", N)``, so a
student samples through the unchanged DDIM sampler.

Run eagerly, as the port's train step is:

- The teacher's two half-steps run under ``torch.no_grad`` on the
  teacher's weights, a name -> tensor map given to the model through
  ``torch.func.functional_call`` (``cfg_eps_fn(params=...)``), so the
  teacher is not the student's parameters and builds no graph.
- Neither teacher nor student runs dropout: the model is in eval mode with
  autograd on for the student's forward and backward, as the JAX student
  runs ``deterministic`` (distillation matches functions, not data).
- A guided teacher (``guidance=w`` on a class-conditional model with
  labelled batches) is the classifier-free combination in ONE forward of
  the doubled batch (``cfg_eps_fn``), combined in float32 before the
  conversion to eps, as JAX combines the native outputs.
- The update is JAX's: the whole batch in one loss, no warmup or
  accumulation, the optimizer of ``state.py`` (clip, AdamW) and the EMA
  lerp, in place on the :class:`~.state.TrainState`.
- The draws (the segment index i ~ U{0..N-1}, then the noise) come from
  ``state.generator`` in JAX's order, or are given as a
  :class:`DistillDraws`, so a test can feed JAX's values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.diffusion import ddim_step, q_sample
from ..ops.schedules import DiffusionSchedule, extract
from ..sampling.inference import cfg_eps_fn
from .state import (AdamWClip, TrainConfig, TrainState, init_train_state, make_lr_schedule,
                    make_optimizer)
from .step import _batch_on, _finish_update, _num_classes

__all__ = [
    "DistillDraws",
    "draw_distill_inputs",
    "distill_ladder",
    "student_timesteps",
    "onestep_target",
    "student_x0",
    "make_teacher_eps",
    "make_distill_step",
    "progressive_distill",
]

Params = Mapping[str, torch.Tensor]
Metrics = Dict[str, object]


@dataclasses.dataclass
class DistillDraws:
    """The random inputs of one distillation update: each row's ladder
    segment (progressive) or pair (consistency) index ``i`` (B,) and the
    noise of its z_t, shaped like the batch."""

    i: torch.Tensor
    noise: torch.Tensor


def draw_distill_inputs(generator: torch.Generator, shape: Sequence[int], n: int,
                        device) -> DistillDraws:
    """i ~ U{0..n-1} per row, then standard-normal noise of ``shape``, from
    ``generator`` (JAX's order: the index key, then the noise key)."""
    i = torch.randint(0, n, (shape[0],), generator=generator, device=device)
    noise = torch.randn(tuple(shape), generator=generator, device=device)
    return DistillDraws(i, noise)


def make_teacher_eps(teacher_model: nn.Module, sched: DiffusionSchedule, num_classes: int,
                     guidance: Optional[float]) -> Callable[..., torch.Tensor]:
    """``(teacher_params, x, t, y) -> eps`` for a distillation teacher.

    With ``guidance`` (other than 1) on a conditional model with labels the
    eps is ``e_u + w (e_c - e_u)`` from one doubled forward, the Meng et al.
    2023 stage-1 teacher that bakes guidance into the student; with labels
    alone the conditional forward; else the plain forward.  Shared by the
    progressive and the consistency step."""
    w = None if guidance is None else float(guidance)

    def teacher_eps(tp: Optional[Params], x: torch.Tensor, t: torch.Tensor, y):
        labelled = bool(num_classes) and y is not None
        g = w if (labelled and w is not None) else 1.0
        return cfg_eps_fn(teacher_model, sched, params=tp, y=y if labelled else None,
                          guidance=g)(x, t)

    return teacher_eps


def distill_ladder(T: int, num_student_steps: int) -> np.ndarray:
    """The (2N+1)-point descending teacher ladder for an N-step student;
    ``ladder[::2]`` equals ``build_ddim_schedule("linear", N, T)``."""
    N = int(num_student_steps)
    if N < 1:
        raise ValueError(f"num_student_steps must be >= 1, got {N}")
    if 2 * N + 1 > T:
        raise ValueError(
            f"2*{N}+1 teacher points do not fit in T={T} discrete steps")
    full = np.round(np.linspace(T - 1, 0, 2 * N + 1)).astype(np.int32)
    if np.any(np.diff(full) >= 0):
        raise ValueError(
            f"ladder for N={N} at T={T} is not strictly descending")
    return full


def student_timesteps(ladder: np.ndarray) -> np.ndarray:
    """The N-step student ladder embedded in a teacher ladder."""
    return np.asarray(ladder)[::2].astype(np.int32)


def onestep_target(sched: DiffusionSchedule, z_t: torch.Tensor, t: torch.Tensor,
                   t_next: torch.Tensor, z_next: torch.Tensor) -> torch.Tensor:
    """The x0 that ONE eta=0 DDIM step t -> t_next needs to land on
    ``z_next``: x~ = (z'' - r z_t) / (a'' - r a), r = s''/s (clipping
    aside)."""
    ab_t = extract(sched.alphas_cumprod, t, z_t.ndim)
    ab_n = extract(sched.alphas_cumprod, t_next, z_t.ndim)
    ratio = torch.sqrt((1.0 - ab_n) / (1.0 - ab_t + 1e-12))
    denom = torch.sqrt(ab_n) - ratio * torch.sqrt(ab_t)
    return (z_next - ratio * z_t) / torch.clamp(denom, min=1e-8)


def student_x0(sched: DiffusionSchedule, out: torch.Tensor, z_t: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
    """Network output in ``sched.prediction_type``'s native space -> the
    UNCLIPPED x0 estimate the distillation loss regresses."""
    kind = sched.prediction_type
    if kind == "x0":
        return out
    a = extract(sched.sqrt_alphas_cumprod, t, z_t.ndim)
    s = extract(sched.sqrt_one_minus_alphas_cumprod, t, z_t.ndim)
    if kind == "v":
        return a * z_t - s * out
    if kind == "epsilon":
        return (z_t - s * out) / (a + 1e-12)
    if kind == "flow":
        # u = eps - x0 and z_t = a x0 + s eps  =>  x0 = (z_t - s u)/(a + s)
        return (z_t - s * out) / (a + s)
    raise ValueError(f"unknown prediction_type {kind!r}")


def _distill_weight(sched: DiffusionSchedule, t: torch.Tensor, kind: str) -> torch.Tensor:
    ab = sched.alphas_cumprod[t.to(sched.alphas_cumprod.device).long().clamp(0, sched.T - 1)]
    snr = ab / (1.0 - ab)
    if kind == "truncated_snr":
        return torch.clamp(snr, min=1.0)  # the paper's Appendix G: max(SNR, 1)
    if kind == "snr":
        return snr
    if kind == "uniform":
        return torch.ones_like(snr)
    raise ValueError(f"unknown distill weighting {kind!r}")


def _update(model: nn.Module, state: TrainState, tx: AdamWClip, loss_fn, lr: float
            ) -> Tuple[TrainState, Metrics]:
    """Backward of ``loss_fn()`` with the student in eval mode (no
    dropout), then the train step's tail (clip, AdamW, EMA), in place; the
    metrics of JAX's step."""
    params = state.params()
    was = model.training
    model.eval()
    try:
        for p in params:
            p.grad = None
        loss = loss_fn()
        loss.backward()
    finally:
        model.train(was)
    grad_norm = _finish_update(state, tx, params)
    return state, {"loss": loss.detach(), "grad_norm": grad_norm, "lr": lr}


def make_distill_step(model: nn.Module, sched: DiffusionSchedule, ladder: np.ndarray,
                      tx: AdamWClip, cfg: TrainConfig, *, guidance: Optional[float] = None,
                      weighting: str = "truncated_snr"
                      ) -> Callable[..., Tuple[TrainState, Metrics]]:
    """``distill_step(state, teacher_params, batch, draws=None) -> (state,
    metrics)`` for one phase on the (2N+1)-point ``ladder``.

    ``batch`` is images, or ``(images, labels)`` for a conditional model.
    Each row takes its segment i, z_t = q_sample(x0, t_i), two eta=0 DDIM
    half-steps of the teacher, and regresses the student's x0 onto the
    inverted one-step target with ``weighting``.  ``teacher_params`` (a
    name -> tensor map, or None for the model's own weights) run on the
    student's module.  ``metrics``:
    ``loss`` and the pre-clip ``grad_norm`` as 0-d device tensors, ``lr``
    a float."""
    ladder = np.asarray(ladder, dtype=np.int32)
    if ladder.ndim != 1 or len(ladder) < 3 or (len(ladder) - 1) % 2:
        raise ValueError("ladder must be a (2N+1,)-point teacher ladder")
    n_seg = (len(ladder) - 1) // 2
    device = next(model.parameters()).device
    t_hi = torch.from_numpy(ladder[0:-2:2].astype(np.int64)).to(device)
    t_mid = torch.from_numpy(ladder[1:-1:2].astype(np.int64)).to(device)
    t_lo = torch.from_numpy(ladder[2::2].astype(np.int64)).to(device)
    num_classes = _num_classes(model)
    lr_schedule = make_lr_schedule(cfg)
    teacher_eps = make_teacher_eps(model, sched, num_classes, guidance)

    def distill_step(state: TrainState, teacher_params: Optional[Params], batch,
                     draws: Optional[DistillDraws] = None) -> Tuple[TrainState, Metrics]:
        x0, y = _batch_on(batch, bool(num_classes), device)
        if draws is None:
            draws = draw_distill_inputs(state.generator, x0.shape, n_seg, device)
        i = draws.i.to(device, torch.long)
        t, tm, tn = t_hi[i], t_mid[i], t_lo[i]
        z_t = q_sample(sched, x0, t, draws.noise.to(device, torch.float32))

        def loss_fn():
            with torch.no_grad():
                efn = lambda x, tt: teacher_eps(teacher_params, x, tt, y)  # noqa: E731
                zero = torch.zeros_like(z_t)
                z_mid = ddim_step(sched, efn, z_t, t, tm, zero, eta=0.0)
                z_next = ddim_step(sched, efn, z_mid, tm, tn, zero, eta=0.0)
                x_tilde = onestep_target(sched, z_t, t, tn, z_next)
            out = model(z_t, t, y)
            x_hat = student_x0(sched, out, z_t, t)
            diff = (x_tilde - x_hat).float()
            mse = (diff * diff).mean(dim=tuple(range(1, x0.ndim)))
            return (mse * _distill_weight(sched, t, weighting)).mean()

        return _update(model, state, tx, loss_fn, lr_schedule(state.step))

    return distill_step


def _weights(model: nn.Module, params: Optional[Params]) -> Dict[str, torch.Tensor]:
    """A detached copy of ``params`` (default: the model's own weights)."""
    src = dict(model.named_parameters()) if params is None else params
    return {k: v.detach().clone() for k, v in src.items()}


@torch.no_grad()
def _load_weights(model: nn.Module, params: Params) -> None:
    for name, p in model.named_parameters():
        p.copy_(params[name])


def _cycle(make_batches: Callable[[], Iterable[Any]], n: int):
    """``n`` batches, re-iterating ``make_batches()`` round-robin."""
    it = iter(make_batches())
    for _ in range(int(n)):
        try:
            yield next(it)
        except StopIteration:
            it = iter(make_batches())
            yield next(it)


def progressive_distill(model: nn.Module, sched: DiffusionSchedule,
                        teacher_params: Optional[Params],
                        make_batches: Callable[[], Iterable[Any]], *, start_steps: int,
                        end_steps: int, phase_updates: int, cfg: TrainConfig,
                        guidance: Optional[float] = None, weighting: str = "truncated_snr",
                        seed: int = 0, log: Optional[Callable[[str], None]] = print
                        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """The halving phases: a ``start_steps`` teacher distills to
    ``start_steps / 2``, the EMA student becomes the next teacher, down
    to ``end_steps``.

    ``teacher_params`` (None: the model's own weights) seed the first
    phase; every phase starts a fresh state from its teacher's weights
    (copied into ``model``: fresh moments, the EMA a copy, the generator
    seeded ``seed + phase``).  Guidance is baked into the first student
    only: later teachers already emit guided eps.  ``make_batches`` returns
    a fresh iterable per pass.  Returns ``(params, info)``: the final
    student's EMA weights as a name -> tensor map, and JAX's
    ``info`` (``phases`` with each phase's ``student_steps``, ``updates``,
    ``first_loss`` and ``last_loss``, and ``steps``).  ``model`` is left
    holding the last phase's raw student weights."""
    if start_steps < 2 * end_steps:
        raise ValueError(
            f"start_steps={start_steps} must be >= 2*end_steps={2 * end_steps}")
    teacher = _weights(model, teacher_params)
    phases = []
    N = int(start_steps) // 2
    while N >= int(end_steps):
        phases.append(N)
        N //= 2

    info: Dict[str, Any] = {"phases": [], "steps": phases[-1] if phases else start_steps}
    for phase_idx, N in enumerate(phases):
        ladder = distill_ladder(sched.T, N)
        tx = make_optimizer(cfg)
        _load_weights(model, teacher)
        state, _ = init_train_state(model, cfg, seed=seed + phase_idx, tx=tx)
        # later phases' teachers already emit guided eps: applying w again
        # would amplify guidance w-fold per halving
        phase_guidance = guidance if phase_idx == 0 else None
        step = make_distill_step(model, sched, ladder, tx, cfg, guidance=phase_guidance,
                                 weighting=weighting)
        losses = []
        for u, batch in enumerate(_cycle(make_batches, phase_updates)):
            state, metrics = step(state, teacher, batch)
            losses.append(metrics["loss"])
            if log and (u == 0 or (u + 1) % max(1, phase_updates // 4) == 0):
                log(f"[distill {2 * N}->{N}] update {u + 1}/{phase_updates} "
                    f"loss {float(metrics['loss']):.5f}")
        teacher = _weights(model, state.ema_params)
        info["phases"].append({
            "student_steps": N,
            "updates": int(phase_updates),
            "first_loss": float(losses[0]),
            "last_loss": float(losses[-1]),
        })
    return teacher, info
