"""Image editing: img2img (SDEdit) and inpainting (RePaint-style).

Counterpart of ``ddpm_diffusion_model_tpu/sampling/editing.py``, built from
``q_sample`` and the DDIM step:

- **img2img** (SDEdit, Meng et al. 2021): noise a real image to the first
  t of the TAIL of a DDIM ladder (``truncate_ladder`` keeps ``strength`` of
  it) and denoise along that tail.
- **inpaint** (replace method; RePaint, Lugmayr et al. 2022): before every
  model call the known (mask = 1) region is set to the forward-process state
  of the known image; ``resamples > 1`` re-noises t_prev -> t_cur between
  repeats of a step; a final paste keeps the known pixels bit for bit.

Every draw is injectable (``noise``/``noises``), else it comes from
``generator``: torch's generators never reproduce JAX's threefry bits, so
the tests feed both implementations the same values.  Class conditioning
is not ported yet.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.diffusion import EpsFn, ddim_step, q_sample
from ..ops.schedules import DiffusionSchedule, extract
from ..utils.device import resolve_device
from ..utils.images import grid_nrow, make_grid, save_image
from .inference import _alphas_cumprod, _not_ported, _sampling, _unit_numpy, cfg_eps_fn
from .loops import ddim_sample_loop
from .timesteps import build_ddim_schedule

__all__ = [
    "truncate_ladder",
    "img2img_sample_loop",
    "inpaint_sample_loop",
    "img2img_infer_sample",
    "inpaint_infer_sample",
    "box_mask",
]

Params = Optional[Mapping[str, torch.Tensor]]
Device = Union[str, torch.device]


def truncate_ladder(timesteps: np.ndarray, strength: float) -> np.ndarray:
    """Tail of a descending DDIM ladder covering ``strength`` in (0, 1] of
    its entries, at least two: the last entry is the t = 0 target the grid
    loop does not step, so a one-entry tail would run no model call."""
    s = float(strength)
    if not 0.0 < s <= 1.0:
        raise ValueError(f"strength must be in (0, 1], got {strength}")
    ts = np.asarray(timesteps, dtype=np.int32)
    n_keep = min(len(ts), max(2, int(round(s * len(ts)))))
    return ts[len(ts) - n_keep:]


def _draw(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)


def img2img_sample_loop(
    sched: DiffusionSchedule,
    eps_fn: EpsFn,
    init_x0: torch.Tensor,
    *,
    timesteps: np.ndarray,
    eta: float = 0.0,
    clip_x0: Optional[bool] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    noises: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """SDEdit: ``q_sample(init_x0, ts[0], noise)``, then the DDIM grid loop
    over the (already truncated) descending ``timesteps``.  ``noise`` is
    the q_sample draw, ``noises`` the loop's per-step draws (eta > 0)."""
    ts = np.asarray(timesteps, dtype=np.int32)
    t0 = torch.full((init_x0.shape[0],), int(ts[0]), dtype=torch.long,
                    device=init_x0.device)
    eps = _draw(init_x0, generator) if noise is None else noise.to(init_x0)
    x_t = q_sample(sched, init_x0, t0, eps)
    x, _ = ddim_sample_loop(sched, eps_fn, x_t, generator=generator, noises=noises,
                            timesteps=ts, eta=eta, clip_x0=clip_x0)
    return x


def inpaint_sample_loop(
    sched: DiffusionSchedule,
    eps_fn: EpsFn,
    known_x0: torch.Tensor,
    mask,
    x_init: torch.Tensor,
    *,
    timesteps: np.ndarray,
    eta: float = 0.0,
    resamples: int = 1,
    clip_x0: Optional[bool] = None,
    generator: Optional[torch.Generator] = None,
    noises=None,
) -> torch.Tensor:
    """Replace-method inpainting over a DDIM ladder.

    ``mask``: 1 = known (kept from ``known_x0``), 0 = generated; any shape
    that broadcasts to ``known_x0`` (e.g. (H, W, 1)).  Each step runs
    ``resamples`` times; a repeat pins the known region to
    ``q_sample(known_x0, t_cur, z_known)``, takes one DDIM step with
    ``z_ddim``, and, before the next repeat, re-noises t_prev -> t_cur with
    the clipped ab-ratio and ``z_back``.  ``noises[i][r]`` holds step i's
    repeat r's ``(z_known, z_ddim, z_back)``; without it the draws the
    repeat uses come from ``generator`` (z_ddim only at eta > 0, z_back only
    before another repeat).  Steps ts[i] -> ts[i+1] (one step to 0 for a
    one-entry ladder); the known pixels are pasted back exactly at the end."""
    if resamples < 1:
        raise ValueError(f"resamples must be >= 1, got {resamples}")
    ts = np.asarray(timesteps, dtype=np.int32)
    t_prev = np.concatenate([ts[1:], np.zeros((1,), np.int32)])
    n_iter = len(ts) - 1 if len(ts) > 1 else 1
    R = int(resamples)
    mask = torch.as_tensor(mask, dtype=x_init.dtype, device=x_init.device)
    x, B = x_init, x_init.shape[0]

    def draws(i, r):
        if noises is not None:
            return [None if z is None else z.to(x) for z in noises[i][r]]
        z_known = _draw(x, generator)
        z_ddim = _draw(x, generator) if eta != 0.0 else torch.zeros_like(x)
        z_back = _draw(x, generator) if r < R - 1 else None
        return z_known, z_ddim, z_back

    for i in range(n_iter):
        t = torch.full((B,), int(ts[i]), dtype=torch.long, device=x.device)
        tp = torch.full((B,), int(t_prev[i]), dtype=torch.long, device=x.device)
        for r in range(R):
            z_known, z_ddim, z_back = draws(i, r)
            x = mask * q_sample(sched, known_x0, t, z_known) + (1.0 - mask) * x
            x = ddim_step(sched, eps_fn, x, t, tp, z_ddim, eta=eta, clip_x0=clip_x0)
            if r < R - 1:
                ab_c = extract(sched.alphas_cumprod, t, x.ndim)
                ab_p = extract(sched.alphas_cumprod, tp, x.ndim)
                ratio = torch.clamp(ab_c / torch.clamp(ab_p, min=1e-12), 0.0, 1.0)
                x = torch.sqrt(ratio) * x + torch.sqrt(1.0 - ratio) * z_back
    return mask * known_x0 + (1.0 - mask) * x


def _as_batch(images, n: Optional[int], device: torch.device) -> torch.Tensor:
    """(H, W, C) or (B, H, W, C) in model space [-1, 1] -> (n, H, W, C)
    float32 on ``device``; one image is replicated n times."""
    arr = torch.as_tensor(np.asarray(images, np.float32), device=device)
    if arr.ndim == 3:
        arr = arr[None]
    if arr.ndim != 4:
        raise ValueError(f"expected (H,W,C) or (B,H,W,C), got {tuple(arr.shape)}")
    if n is not None and arr.shape[0] != n:
        if arr.shape[0] != 1:
            raise ValueError(
                f"got batch {arr.shape[0]} but n={n}; pass one image to "
                "replicate or a batch of exactly n")
        arr = arr.expand(n, *arr.shape[1:]).contiguous()
    return arr


def _finish(x: torch.Tensor, out_path: Optional[str]) -> np.ndarray:
    x01 = _unit_numpy(x)
    if out_path is not None:
        save_image(make_grid(x01, nrow=grid_nrow(x01.shape[0])), out_path)
    return x01


def _ladder(sched: DiffusionSchedule, schedule_kind: str, steps: int) -> np.ndarray:
    return build_ddim_schedule(schedule_kind, steps, sched.T,
                               alphas_cumprod=_alphas_cumprod(sched))


def img2img_infer_sample(model: torch.nn.Module, params: Params, sched: DiffusionSchedule,
                         init_images, *, n: Optional[int] = None, strength: float = 0.6,
                         steps: int = 50, eta: float = 0.0, schedule_kind: str = "t_linear",
                         seed: Optional[int] = 1234, ema_params: Params = None,
                         out_path: Optional[str] = "samples_img2img.png", class_id=None,
                         guidance: float = 1.0, device: Device = "cuda") -> np.ndarray:
    """SDEdit grid: edit ``init_images`` ([-1, 1], (H, W, C) or (B, H, W,
    C)) at ``strength``; one image with ``n`` set gives n variations, each
    row with its own noise.  Returns the [0, 1] batch (and writes its grid
    to ``out_path`` unless None)."""
    _not_ported(class_id, guidance)
    p = ema_params if ema_params is not None else params
    dev = resolve_device(device)
    init = _as_batch(init_images, n, dev)
    ts = truncate_ladder(_ladder(sched, schedule_kind, steps), strength)
    gen = torch.Generator(device=dev).manual_seed(0 if seed is None else int(seed))
    with _sampling(model):
        x = img2img_sample_loop(sched, cfg_eps_fn(model, sched, params=p), init,
                                timesteps=ts, eta=eta, clip_x0=True, generator=gen)
    return _finish(x, out_path)


def inpaint_infer_sample(model: torch.nn.Module, params: Params, sched: DiffusionSchedule,
                         known_images, mask, *, n: Optional[int] = None, steps: int = 50,
                         eta: float = 0.0, resamples: int = 1,
                         schedule_kind: str = "t_linear", seed: Optional[int] = 1234,
                         ema_params: Params = None,
                         out_path: Optional[str] = "samples_inpaint.png", class_id=None,
                         guidance: float = 1.0, device: Device = "cuda") -> np.ndarray:
    """Inpainting grid: regenerate the mask = 0 region of ``known_images``
    ([-1, 1]); mask = 1 pixels are kept exactly.  x_T is the seed's first
    draw.  Returns the [0, 1] batch."""
    _not_ported(class_id, guidance)
    p = ema_params if ema_params is not None else params
    dev = resolve_device(device)
    known = _as_batch(known_images, n, dev)
    gen = torch.Generator(device=dev).manual_seed(0 if seed is None else int(seed))
    x_init = _draw(known, gen)
    with _sampling(model):
        x = inpaint_sample_loop(sched, cfg_eps_fn(model, sched, params=p), known,
                                np.asarray(mask, np.float32), x_init,
                                timesteps=_ladder(sched, schedule_kind, steps), eta=eta,
                                resamples=resamples, clip_x0=True, generator=gen)
    return _finish(x, out_path)


def box_mask(img_size: int, box: Sequence[int], channels: int = 1) -> np.ndarray:
    """(H, W, channels) mask: 0 (generate) inside the half-open pixel box
    ``(x0, y0, x1, y1)``, 1 (keep) outside."""
    x0, y0, x1, y1 = (int(v) for v in box)
    if not (0 <= x0 < x1 <= img_size and 0 <= y0 < y1 <= img_size):
        raise ValueError(
            f"box {box} out of bounds for img_size={img_size} "
            "(need 0 <= x0 < x1 <= size, same for y)")
    m = np.ones((img_size, img_size, channels), dtype=np.float32)
    m[y0:y1, x0:x1, :] = 0.0
    return m
