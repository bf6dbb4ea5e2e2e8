"""DPM-Solver++(2M): the second-order multistep sampler, ODE and SDE.

Counterpart of ``ddpm_diffusion_model_tpu/sampling/solvers.py`` (Lu et al.
2022, arXiv:2211.01095, the data-prediction multistep variant): about 20
model evaluations reach DDIM-50 quality.  Each transition t_cur -> t_next
of a descending ladder, with lambda = log(alpha / sigma) and
h = lambda_next - lambda_cur > 0, is

    x_next = c_skip * x + c_lin * D (+ c_noise * z, SDE)
    D      = x0 + corr * (x0 - x0_prev)

with per-transition coefficients computed on the host in float64 from the
ladder and the schedule table and cast to float32, so each step is one
model evaluation and a three-term combination.  ``corr`` is 0 on the first
transition (the zeros placeholder for x0_prev never contributes) and, with
``lower_order_final``, on the last.

The JAX entry points that take the schedule as a jit argument build the
same coefficients in-graph in float32; the port always takes the float64
host route.  SDE noise comes from ``noises`` (one tensor per transition,
as the tests inject it) or else from ``generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.diffusion import EpsFn, predict_x0
from ..ops.schedules import DiffusionSchedule
from .loops import _noise
from .timesteps import build_ddim_schedule

__all__ = [
    "dpmpp2m_coefficients",
    "dpmpp2m_sample_loop",
    "dpmpp2m_sde_coefficients",
    "dpmpp2m_sde_sample_loop",
]


def _log_snr_steps(sched: DiffusionSchedule, ts) -> Tuple[np.ndarray, np.ndarray,
                                                          np.ndarray]:
    """alpha and sigma at every rung of ``ts`` and the log-SNR step h of
    every transition, in float64."""
    ts = np.asarray(ts, dtype=np.int64)
    if ts.ndim != 1 or len(ts) < 2:
        raise ValueError(f"ladder needs >=2 descending entries, got {ts}")
    ab = sched.alphas_cumprod.cpu().numpy().astype(np.float64)[ts]
    alpha = np.sqrt(ab)
    sigma = np.sqrt(1.0 - ab)
    lam = np.log(alpha) - np.log(sigma)
    return alpha, sigma, lam[1:] - lam[:-1]


def _correction(h: np.ndarray, lower_order_final: bool) -> np.ndarray:
    """The 2M correction h_i / (2 h_{i-1}); 0 on the first transition and,
    with ``lower_order_final``, on the last."""
    corr = np.zeros_like(h)
    if len(h) > 1:
        corr[1:] = h[1:] / (2.0 * h[:-1])
        if lower_order_final:
            corr[-1] = 0.0
    return corr


def dpmpp2m_coefficients(sched: DiffusionSchedule, ts, *, lower_order_final: bool = True
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(c_skip, c_lin, corr)`` of the ODE solver for the ladder ``ts``:
    c_skip = sigma_next / sigma_cur, c_lin = alpha_next (1 - e^-h), float32."""
    alpha, sigma, h = _log_snr_steps(sched, ts)
    c_skip = sigma[1:] / sigma[:-1]
    c_lin = alpha[1:] * (-np.expm1(-h))
    corr = _correction(h, lower_order_final)
    return (c_skip.astype(np.float32), c_lin.astype(np.float32),
            corr.astype(np.float32))


def dpmpp2m_sde_coefficients(sched: DiffusionSchedule, ts, *,
                             lower_order_final: bool = True
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(c_skip, c_lin, corr, c_noise)`` of SDE-DPM-Solver++(2M):
    c_skip = (sigma_next / sigma_cur) e^-h, c_lin = alpha_next (1 - e^-2h),
    c_noise = sigma_next sqrt(1 - e^-2h), float32.  They keep
    c_skip^2 sigma_cur^2 + c_noise^2 = sigma_next^2, so a delta data
    distribution is carried through its exact marginals."""
    alpha, sigma, h = _log_snr_steps(sched, ts)
    c_skip = (sigma[1:] / sigma[:-1]) * np.exp(-h)
    c_lin = alpha[1:] * (-np.expm1(-2.0 * h))
    c_noise = sigma[1:] * np.sqrt(-np.expm1(-2.0 * h))
    corr = _correction(h, lower_order_final)
    return (c_skip.astype(np.float32), c_lin.astype(np.float32),
            corr.astype(np.float32), c_noise.astype(np.float32))


def _ladder(sched: DiffusionSchedule, timesteps, schedule_kind: str,
            steps: int) -> np.ndarray:
    if timesteps is None:
        timesteps = build_ddim_schedule(
            schedule_kind, steps, sched.T,
            alphas_cumprod=sched.alphas_cumprod.cpu().numpy())
    return np.asarray(timesteps, dtype=np.int32)


def _x0(sched, eps_fn, x, t_scalar, clip_x0):
    t = torch.full((x.shape[0],), int(t_scalar), dtype=torch.long, device=x.device)
    x0 = predict_x0(sched, x, eps_fn(x, t), t)
    return torch.clamp(x0, -1.0, 1.0) if clip_x0 else x0


def dpmpp2m_sample_loop(
    sched: DiffusionSchedule,
    eps_fn: EpsFn,
    x_init: torch.Tensor,
    *,
    timesteps: Optional[np.ndarray] = None,
    schedule_kind: str = "t_linear",
    steps: int = 20,
    clip_x0: Optional[bool] = None,
    lower_order_final: bool = True,
) -> torch.Tensor:
    """Deterministic DPM-Solver++(2M) x_T -> x_0 over the ladder (the
    trailing 0 is a transition target, not a step): len(ladder) - 1 model
    evaluations.  The carry is (x, x0_prev), x0_prev starting at zeros."""
    if clip_x0 is None:
        clip_x0 = sched.clamp_x0
    ts = _ladder(sched, timesteps, schedule_kind, steps)
    c_skip, c_lin, corr = dpmpp2m_coefficients(sched, ts,
                                               lower_order_final=lower_order_final)
    x, x0_prev = x_init, torch.zeros_like(x_init)
    for i in range(len(ts) - 1):
        x0 = _x0(sched, eps_fn, x, ts[i], clip_x0)
        d = x0 + float(corr[i]) * (x0 - x0_prev)
        x = float(c_skip[i]) * x + float(c_lin[i]) * d
        x0_prev = x0
    return x


def dpmpp2m_sde_sample_loop(
    sched: DiffusionSchedule,
    eps_fn: EpsFn,
    x_init: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    noises: Optional[Sequence[torch.Tensor]] = None,
    timesteps: Optional[np.ndarray] = None,
    schedule_kind: str = "t_linear",
    steps: int = 20,
    clip_x0: Optional[bool] = None,
    lower_order_final: bool = True,
) -> torch.Tensor:
    """Stochastic SDE-DPM-Solver++(2M): the ODE loop plus c_noise * z per
    transition, z drawn after the model evaluation (``noises[i]``, or from
    ``generator``)."""
    if clip_x0 is None:
        clip_x0 = sched.clamp_x0
    ts = _ladder(sched, timesteps, schedule_kind, steps)
    c_skip, c_lin, corr, c_noise = dpmpp2m_sde_coefficients(
        sched, ts, lower_order_final=lower_order_final)
    x, x0_prev = x_init, torch.zeros_like(x_init)
    for i in range(len(ts) - 1):
        x0 = _x0(sched, eps_fn, x, ts[i], clip_x0)
        d = x0 + float(corr[i]) * (x0 - x0_prev)
        z = _noise(x, i, generator, noises)
        x = float(c_skip[i]) * x + float(c_lin[i]) * d + float(c_noise[i]) * z
        x0_prev = x0
    return x
