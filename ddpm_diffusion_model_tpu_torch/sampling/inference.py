"""Sampling entry points over a U-Net: grids, per-image saves, denoise
strips, and DDIM and DPM-Solver++ from explicit init noise (the serving
coalescer's kernels).

Counterpart of the unconditional part of
``ddpm_diffusion_model_tpu/sampling/inference.py``: ``cfg_eps_fn`` with
``y=None``, ``ddpm_sample``, ``ddim_sample``, ``ddpm_infer_sample``,
``ddim_infer_sample``, ``dpmpp_infer_sample``, ``render_denoise_strip``,
``render_denoise_strip_ddim``, ``_ddim_from_init_jit`` and
``_dpmpp_from_init_jit``.

Every entry point takes ``(model, params, sched, ...)`` as the JAX one
does: ``params`` None runs the model's own weights, a name -> tensor map
(the EMA shadow) runs those in their place through
``torch.func.functional_call``, so no weights are swapped into the model.
The model runs in eval mode (no dropout) under ``torch.inference_mode``,
and its mode is restored after.  x_T and every step's noise come from one
``torch.Generator`` seeded with ``seed`` on ``device`` (``None``: 0).
``class_id``/``guidance`` other than the defaults raise "not ported yet".
"""

from __future__ import annotations

import contextlib
import os
from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.diffusion import EpsFn, model_output_to_eps
from ..ops.schedules import DiffusionSchedule
from ..utils.device import resolve_device
from ..utils.images import grid_nrow, make_grid, save_image, save_image_grid
from .loops import ddim_sample_loop, ddpm_sample_loop, to_unit_interval
from .solvers import dpmpp2m_sample_loop, dpmpp2m_sde_sample_loop
from .timesteps import build_ddim_schedule

__all__ = ["cfg_eps_fn", "ddim_from_init", "dpmpp_from_init", "ddpm_sample",
           "ddim_sample", "ddpm_infer_sample", "ddim_infer_sample",
           "dpmpp_infer_sample", "render_denoise_strip", "render_denoise_strip_ddim"]

Params = Optional[Mapping[str, torch.Tensor]]
Device = Union[str, torch.device]


def cfg_eps_fn(model: torch.nn.Module, sched: Optional[DiffusionSchedule] = None,
               *, params: Params = None) -> EpsFn:
    """``eps_fn(x_t, t)`` of an unconditional model, on its own weights or
    on ``params``.  With ``sched`` and a non-eps ``prediction_type`` the
    native output is converted to eps."""
    convert = sched is not None and sched.prediction_type != "epsilon"

    def eps_fn(xt: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if params is None:
            out = model(xt, t)
        else:
            out = torch.func.functional_call(model, dict(params), (xt, t))
        return model_output_to_eps(sched, out, xt, t) if convert else out

    return eps_fn


@contextlib.contextmanager
def _sampling(model: torch.nn.Module):
    """Eval mode and inference mode for the duration; the model's mode is
    restored after."""
    was = model.training
    model.eval()
    try:
        with torch.inference_mode():
            yield
    finally:
        model.train(was)


def _not_ported(class_id, guidance) -> None:
    if class_id is not None or float(guidance) != 1.0:
        raise NotImplementedError(
            "class-conditional sampling (class_id/guidance) is not ported yet")


def _init(model: torch.nn.Module, n: int, img_size: int, seed: Optional[int],
          device: Device) -> Tuple[torch.Generator, torch.Tensor]:
    """The run's generator, seeded with ``seed``, and x_T, its first draw."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0 if seed is None else int(seed))
    shape = (n, img_size, img_size, model.config.in_channels)
    return gen, torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)


def _unit_numpy(x: torch.Tensor) -> np.ndarray:
    return to_unit_interval(x).float().cpu().numpy()


def _ddpm(model, params, sched, n, img_size, seed, device, steps=None,
          capture_steps=None):
    gen, x = _init(model, n, img_size, seed, device)
    with _sampling(model):
        return ddpm_sample_loop(sched, cfg_eps_fn(model, sched, params=params), x,
                                generator=gen, num_steps=steps,
                                capture_steps=capture_steps)


def _ddim(model, params, sched, n, img_size, seed, device, timesteps, eta,
          capture_steps=None):
    gen, x = _init(model, n, img_size, seed, device)
    with _sampling(model):
        return ddim_sample_loop(sched, cfg_eps_fn(model, sched, params=params), x,
                                generator=gen, timesteps=np.asarray(timesteps),
                                eta=eta, clip_x0=True, capture_steps=capture_steps)


def _alphas_cumprod(sched: DiffusionSchedule) -> np.ndarray:
    return sched.alphas_cumprod.cpu().numpy()


@torch.inference_mode()
def ddim_from_init(model: torch.nn.Module, sched: DiffusionSchedule,
                   x_init: torch.Tensor, timesteps: Sequence[int]) -> torch.Tensor:
    """Deterministic (eta = 0, clip_x0) DDIM from EXPLICIT init noise
    (NHWC, float32): row i of the result depends only on row i of
    ``x_init``, which is what lets the server concatenate requests."""
    out, _ = ddim_sample_loop(sched, cfg_eps_fn(model, sched), x_init,
                              timesteps=np.asarray(timesteps, dtype=np.int32),
                              eta=0.0, clip_x0=True)
    return out


@torch.inference_mode()
def dpmpp_from_init(model: torch.nn.Module, sched: DiffusionSchedule,
                    x_init: torch.Tensor, timesteps: Sequence[int]) -> torch.Tensor:
    """Deterministic DPM-Solver++(2M) (clip_x0) from EXPLICIT init noise:
    like :func:`ddim_from_init`, row i depends only on row i of
    ``x_init``."""
    return dpmpp2m_sample_loop(sched, cfg_eps_fn(model, sched), x_init,
                               timesteps=np.asarray(timesteps, dtype=np.int32),
                               clip_x0=True)


def ddpm_sample(model: torch.nn.Module, params: Params, sched: DiffusionSchedule,
                n: int, img_size: int = 64, *, steps: Optional[int] = None,
                seed: int = 1234, save_path: Optional[str] = None,
                return_grid: bool = True, class_id=None, guidance: float = 1.0,
                device: Device = "cuda") -> np.ndarray:
    """In-training DDPM grid sampler: the ancestral ladder (``steps``
    truncates it), a grid of int(sqrt(n)) images per row, or the (n, H, W,
    C) [0, 1] samples with ``return_grid=False``."""
    _not_ported(class_id, guidance)
    x, _ = _ddpm(model, params, sched, n, img_size, seed, device, steps=steps)
    x01 = _unit_numpy(x)
    grid = make_grid(x01, nrow=int(n**0.5))
    if save_path is not None:
        save_image(grid, save_path)
    return grid if return_grid else x01


def ddim_sample(model: torch.nn.Module, params: Params, sched: DiffusionSchedule, *,
                n: int = 16, img_size: int = 64, ema_params: Params = None,
                save_path: Optional[str] = None, seed: int = 1234, steps: int = 50,
                eta: float = 0.0, schedule: str = "karras",
                device: Device = "cuda") -> np.ndarray:
    """In-training DDIM sampler on the karras/cosine ladders.  Returns the
    (n, H, W, C) samples in [0, 1] as float32 numpy."""
    p = ema_params if ema_params is not None else params
    ts = build_ddim_schedule(schedule, steps, sched.T,
                             alphas_cumprod=_alphas_cumprod(sched))
    x, _ = _ddim(model, p, sched, n, img_size, seed, device, ts, eta)
    x01 = _unit_numpy(x)
    if save_path:
        save_image_grid(x01, save_path, nrow=int(n**0.5))
    return x01


def _save_outputs(x01: np.ndarray, out_path: str, save_individual: bool,
                  out_dir: str) -> np.ndarray:
    n = x01.shape[0]
    grid = make_grid(x01, nrow=grid_nrow(n))
    save_image(grid, out_path)
    if save_individual:
        os.makedirs(out_dir, exist_ok=True)
        for i in range(n):
            save_image(x01[i], os.path.join(out_dir, f"img_{i:03d}.png"))
    return grid


def ddpm_infer_sample(model: torch.nn.Module, params: Params,
                      sched: DiffusionSchedule, n: int = 36, img_size: int = 64, *,
                      ema_params: Params = None, out_path: str = "samples_ddpm.png",
                      save_individual: bool = False,
                      out_dir: str = "samples_individual", seed: Optional[int] = 1234,
                      class_id=None, guidance: float = 1.0,
                      device: Device = "cuda") -> np.ndarray:
    """Full-T ancestral grid inference; returns the grid written to
    ``out_path`` (and one PNG per image with ``save_individual``)."""
    _not_ported(class_id, guidance)
    p = ema_params if ema_params is not None else params
    x, _ = _ddpm(model, p, sched, n, img_size, seed, device)
    return _save_outputs(_unit_numpy(x), out_path, save_individual, out_dir)


def ddim_infer_sample(model: torch.nn.Module, params: Params,
                      sched: DiffusionSchedule, n: int = 36, img_size: int = 64, *,
                      ema_params: Params = None, out_path: str = "samples_ddim.png",
                      save_individual: bool = False,
                      out_dir: str = "samples_individual", seed: Optional[int] = 1234,
                      steps: int = 50, eta: float = 0.0,
                      schedule_kind: str = "t_linear",
                      schedule_idx: Optional[Sequence[int]] = None, class_id=None,
                      guidance: float = 1.0, device: Device = "cuda") -> np.ndarray:
    """Sub-sampled DDIM grid inference (``t_linear``, ``alpha_bar_cosine``
    or an explicit ladder); returns the grid written to ``out_path``."""
    _not_ported(class_id, guidance)
    p = ema_params if ema_params is not None else params
    ts = build_ddim_schedule(schedule_kind, steps, sched.T,
                             alphas_cumprod=_alphas_cumprod(sched), explicit=schedule_idx)
    x, _ = _ddim(model, p, sched, n, img_size, seed, device, ts, eta)
    return _save_outputs(_unit_numpy(x), out_path, save_individual, out_dir)


def dpmpp_infer_sample(model: torch.nn.Module, params: Params,
                       sched: DiffusionSchedule, n: int = 36, img_size: int = 64, *,
                       ema_params: Params = None, out_path: str = "samples_dpmpp.png",
                       save_individual: bool = False,
                       out_dir: str = "samples_individual", seed: Optional[int] = 1234,
                       steps: int = 20, schedule_kind: str = "t_linear",
                       schedule_idx: Optional[Sequence[int]] = None, class_id=None,
                       guidance: float = 1.0, sde: bool = False,
                       device: Device = "cuda") -> np.ndarray:
    """DPM-Solver++(2M) grid inference (``sde=True``: the stochastic
    variant, its per-step noise from the seed's generator after x_T).  x_T
    is the seed's first draw, as in :func:`ddim_infer_sample`, so one seed
    starts both samplers from the same noise.  Returns the grid written to
    ``out_path``."""
    _not_ported(class_id, guidance)
    p = ema_params if ema_params is not None else params
    ts = build_ddim_schedule(schedule_kind, steps, sched.T,
                             alphas_cumprod=_alphas_cumprod(sched), explicit=schedule_idx)
    gen, x = _init(model, n, img_size, seed, device)
    with _sampling(model):
        eps_fn = cfg_eps_fn(model, sched, params=p)
        if sde:
            x = dpmpp2m_sde_sample_loop(sched, eps_fn, x, generator=gen, timesteps=ts,
                                        clip_x0=True)
        else:
            x = dpmpp2m_sample_loop(sched, eps_fn, x, timesteps=ts, clip_x0=True)
    return _save_outputs(_unit_numpy(x), out_path, save_individual, out_dir)


def _strip(frames: torch.Tensor, out_path: str, pad: int) -> np.ndarray:
    frames = frames.cpu().numpy()
    grid = make_grid(frames, nrow=frames.shape[0], padding=pad)
    save_image(grid, out_path)
    return grid


def render_denoise_strip(model: torch.nn.Module, params: Params,
                         sched: DiffusionSchedule, *, img_size: int = 64,
                         ema_params: Params = None, seed: Optional[int] = 1234,
                         out_path: str = "denoise_strip.png",
                         capture_steps: Optional[Sequence[int]] = None, pad: int = 2,
                         device: Device = "cuda") -> np.ndarray:
    """DDPM T -> 0 trajectory of one sample, ~20 snapshots by default, as
    one row; returns the strip written to ``out_path``."""
    p = ema_params if ema_params is not None else params
    if capture_steps is None:
        capture_steps = [int(v) for v in np.round(np.linspace(sched.T - 1, 0, 20))]
    _, frames = _ddpm(model, p, sched, 1, img_size, seed, device,
                      capture_steps=sorted({int(t) for t in capture_steps}, reverse=True))
    return _strip(frames, out_path, pad)


def render_denoise_strip_ddim(model: torch.nn.Module, params: Params,
                              sched: DiffusionSchedule, *, img_size: int = 64,
                              ema_params: Params = None, seed: Optional[int] = 1234,
                              out_path: str = "denoise_strip_ddim.png",
                              capture_steps: Optional[Sequence[int]] = None,
                              pad: int = 2, steps: int = 50, eta: float = 0.0,
                              schedule_kind: str = "linear",
                              schedule_idx: Optional[Sequence[int]] = None,
                              device: Device = "cuda") -> np.ndarray:
    """DDIM trajectory of one sample, at most 17 frames by default: 'linear'
    is the steps-point t-linear ladder, 'cosine' its 0.5 (1 - cos) warp."""
    p = ema_params if ema_params is not None else params
    kind = "t_linear" if schedule_kind == "linear" else "t_cosine"
    ts = build_ddim_schedule(kind, steps, sched.T, alphas_cumprod=_alphas_cumprod(sched),
                             explicit=schedule_idx)
    if capture_steps is None:
        K = min(17, len(ts))
        pick = np.round(np.linspace(0, len(ts) - 1, K)).astype(int)
        capture_steps = [int(ts[i]) for i in pick]
    _, frames = _ddim(model, p, sched, 1, img_size, seed, device, ts, eta,
                      capture_steps=sorted({int(t) for t in capture_steps}, reverse=True))
    return _strip(frames, out_path, pad)
