"""Encoder-cached fast DDIM sampling (Faster-Diffusion / DeepCache family).

Counterpart of ``ddpm_diffusion_model_tpu/sampling/fast.py``.  A U-Net's
encoder and bottleneck features vary slowly across adjacent timesteps, so
a "refresh" step runs the full forward and keeps ``(mid, skips)``, and the
"reuse" steps between refreshes run only the decoder and head on them with
the fresh time embedding (``UNetDenoiser(mode="decode")``).  JAX picks the
branch with ``lax.cond`` inside one scan; here the host-side refresh mask
picks it in a Python loop.  ``refresh_every=1`` is ``ddim_sample_loop``
step for step (the same ladder, draws and arithmetic).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.diffusion import ddim_step, model_output_to_eps
from ..ops.schedules import DiffusionSchedule
from ..utils.images import save_image_grid
from .inference import _alphas_cumprod, _init, _sampling, _unit_numpy
from .loops import _noise
from .timesteps import build_ddim_schedule

__all__ = ["ddim_sample_loop_cached", "ddim_sample_fast"]


def _apply(model: torch.nn.Module, params: Optional[Mapping[str, torch.Tensor]],
           x: torch.Tensor, t: torch.Tensor, **kw):
    if params is None:
        return model(x, t, **kw)
    return torch.func.functional_call(model, dict(params), (x, t), kw)


def ddim_sample_loop_cached(
    model: torch.nn.Module,
    params: Optional[Mapping[str, torch.Tensor]],
    sched: DiffusionSchedule,
    x_init: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    noises: Optional[Sequence[torch.Tensor]] = None,
    timesteps: Optional[np.ndarray] = None,
    schedule_kind: str = "t_linear",
    steps: int = 50,
    eta: float = 0.0,
    refresh_every: int = 2,
    clip_x0: Optional[bool] = None,
) -> torch.Tensor:
    """DDIM over the ladder's len - 1 transitions with a full forward on
    step 0 and every ``refresh_every``-th step and a decode forward on the
    rest.  ``params`` None runs the model's own weights, else a name ->
    tensor map through ``functional_call``.  At eta = 0 no noise is drawn;
    else step i's comes from ``noises[i]`` or ``generator``.  A ladder
    shorter than 2 returns ``x_init``."""
    if timesteps is None:
        timesteps = build_ddim_schedule(
            schedule_kind, steps, sched.T,
            alphas_cumprod=_alphas_cumprod(sched))
    ts = np.asarray(timesteps, dtype=np.int32)
    if len(ts) < 2:
        return x_init
    refresh = np.zeros(len(ts) - 1, dtype=bool)
    refresh[::max(1, int(refresh_every))] = True

    x, B, feats = x_init, x_init.shape[0], None
    zeros = torch.zeros_like(x) if eta == 0.0 and noises is None else None
    for i in range(len(ts) - 1):
        t = torch.full((B,), int(ts[i]), dtype=torch.long, device=x.device)
        tp = torch.full((B,), int(ts[i + 1]), dtype=torch.long, device=x.device)
        if refresh[i]:
            eps, feats = _apply(model, params, x, t, return_features=True)
        else:
            eps = _apply(model, params, x, t, mode="decode", cached=feats)
        if sched.prediction_type != "epsilon":
            eps = model_output_to_eps(sched, eps, x, t)
        noise = zeros if zeros is not None else _noise(x, i, generator, noises)
        x = ddim_step(sched, lambda *_, e=eps: e, x, t, tp, noise, eta=eta,
                      clip_x0=clip_x0)
    return x


def ddim_sample_fast(model: torch.nn.Module, params, sched: DiffusionSchedule, *,
                     n: int = 16, img_size: int = 64, ema_params=None,
                     save_path: Optional[str] = None, seed: int = 1234, steps: int = 50,
                     eta: float = 0.0, schedule_kind: str = "t_linear",
                     refresh_every: int = 2,
                     device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Grid sampler with encoder caching: ``ddim_sample``'s surface plus
    ``refresh_every``; x_T is the same seed's draw as ``ddim_sample``'s.
    Returns the (n, H, W, C) samples in [0, 1] as float32 numpy."""
    p = ema_params if ema_params is not None else params
    ts = build_ddim_schedule(schedule_kind, steps, sched.T,
                             alphas_cumprod=_alphas_cumprod(sched))
    gen, x = _init(model, n, img_size, seed, device)
    with _sampling(model):
        x = ddim_sample_loop_cached(model, p, sched, x, generator=gen, timesteps=ts,
                                    eta=eta, refresh_every=refresh_every, clip_x0=True)
    x01 = _unit_numpy(x)
    if save_path:
        save_image_grid(x01, save_path, nrow=int(n**0.5))
    return x01
