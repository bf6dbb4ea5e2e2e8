"""Sampling of the port: timestep ladders, the DDPM, DDIM and DPM-Solver++
loops, encoder-cached DDIM, image editing and the entry points
(counterparts of ``ddpm_diffusion_model_tpu/sampling/``)."""

from .editing import (box_mask, img2img_infer_sample, img2img_sample_loop,
                      inpaint_infer_sample, inpaint_sample_loop, truncate_ladder)
from .fast import ddim_sample_fast, ddim_sample_loop_cached
from .inference import (cfg_eps_fn, ddim_from_init, ddim_infer_sample, ddim_sample,
                        ddpm_infer_sample, ddpm_sample, dpmpp_from_init,
                        dpmpp_infer_sample, render_denoise_strip,
                        render_denoise_strip_ddim)
from .loops import ddim_sample_loop, ddpm_sample_loop, to_unit_interval
from .solvers import (dpmpp2m_coefficients, dpmpp2m_sample_loop,
                      dpmpp2m_sde_coefficients, dpmpp2m_sde_sample_loop)
from .timesteps import build_ddim_schedule, ddpm_timesteps

__all__ = [
    "cfg_eps_fn", "ddim_from_init", "dpmpp_from_init", "ddpm_sample", "ddim_sample",
    "ddpm_infer_sample", "ddim_infer_sample", "dpmpp_infer_sample",
    "render_denoise_strip", "render_denoise_strip_ddim", "ddpm_sample_loop",
    "ddim_sample_loop", "to_unit_interval", "build_ddim_schedule", "ddpm_timesteps",
    "dpmpp2m_coefficients", "dpmpp2m_sample_loop", "dpmpp2m_sde_coefficients",
    "dpmpp2m_sde_sample_loop", "ddim_sample_loop_cached", "ddim_sample_fast",
    "truncate_ladder", "img2img_sample_loop", "inpaint_sample_loop",
    "img2img_infer_sample", "inpaint_infer_sample", "box_mask",
]
