"""Sampling of the port: timestep ladders, the DDPM and DDIM loops and the
entry points (counterparts of ``ddpm_diffusion_model_tpu/sampling/``)."""

from .inference import (cfg_eps_fn, ddim_from_init, ddim_infer_sample, ddim_sample,
                        ddpm_infer_sample, ddpm_sample, render_denoise_strip,
                        render_denoise_strip_ddim)
from .loops import ddim_sample_loop, ddpm_sample_loop, to_unit_interval
from .timesteps import build_ddim_schedule, ddpm_timesteps

__all__ = [
    "cfg_eps_fn", "ddim_from_init", "ddpm_sample", "ddim_sample",
    "ddpm_infer_sample", "ddim_infer_sample", "render_denoise_strip",
    "render_denoise_strip_ddim", "ddpm_sample_loop", "ddim_sample_loop",
    "to_unit_interval", "build_ddim_schedule", "ddpm_timesteps",
]
