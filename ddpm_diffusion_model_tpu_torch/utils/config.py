"""Experiment configs of the port: the typed bundle the CLI loads and the
checkpoints store.

Counterpart of ``ddpm_diffusion_model_tpu/utils/config.py``: one frozen
:class:`ExperimentConfig` (the model, the diffusion, the ``TrainConfig``
and the run settings) with the same ``to_dict`` / ``from_dict(legacy=)``
/ ``to_json`` / ``from_json``, the model's family dispatched on
``model.family`` (``"dit"``: a ``DiTConfig``, else a ``UNetConfig``), and
the ``celeba64_low``, ``celeba64_attn``, ``celebahq256``,
``celeba64_dit_s4``, ``celeba64_dit_moe``, ``sr64to256`` (the 64 -> 256
super-resolution upsampler of a cascade) and ``celeba64_latent`` (the
denoiser of 64 px latent diffusion, on ``vae_64x_config``'s 16x16x4
latents) presets field for field: every preset of the JAX package.  The
port adds ``imagenet256_dit_moe_xl2`` (DiT-MoE-XL/2-8E2A on 256-px
ImageNet's 32x32x4 latents), which the JAX package has no model for.
``remat`` also takes ``"masks"`` (``UNetDenoiser(remat=)``) and a DiT's
``"dots"`` and ``"attn"``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Union

from ..models.dit import DiTConfig, dit_moe_64_config, dit_moe_xl2_config, dit_s4_64_config
from ..models.unet import (UNetConfig, unet_64x64_config, unet_64x64_low_config,
                           unet_256x256_config, unet_latent16_config)
from ..ops.schedules import DiffusionConfig
from ..training.state import TrainConfig

__all__ = ["ExperimentConfig", "PRESETS", "PORT_PRESETS", "get_preset",
           "preset_from_experiment"]


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """An experiment's model (U-Net or DiT), diffusion and training settings
    plus the run settings, field for field the JAX ``ExperimentConfig``."""

    model: Union[UNetConfig, DiTConfig]
    diffusion: DiffusionConfig
    train: TrainConfig
    # run settings
    run_name: str = "ddpm"
    img_size: int = 64
    batch_size: int = 128
    epochs: int = 50
    sample_every: int = 5
    sample_n: int = 36
    save_every: int = 5
    log_every: int = 0
    seed: int = 0
    remat: Union[bool, str] = False

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["model"] = self.model.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any], *, legacy: bool = False) -> "ExperimentConfig":
        """``legacy=True`` only when loading a checkpoint meta (see
        ``TrainConfig.from_dict``).  ``model.family`` picks the model
        config: ``"dit"`` a ``DiTConfig``, absent a ``UNetConfig``."""
        d = dict(d)
        if d["model"].get("family", "unet") == "dit":
            d["model"] = DiTConfig.from_dict(d["model"])
        else:
            d["model"] = UNetConfig.from_dict(d["model"])
        d["diffusion"] = DiffusionConfig.from_dict(d["diffusion"])
        d["train"] = TrainConfig.from_dict(d["train"], legacy=legacy)
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return cls.from_dict(json.loads(s))


def _preset_low() -> ExperimentConfig:
    return ExperimentConfig(
        model=unet_64x64_low_config(),
        diffusion=DiffusionConfig(T=1000, schedule="linear", img_size=64),
        train=TrainConfig(base_lr=2e-4, warmup_steps=1000, grad_accum_steps=1,
                          ema_decay=0.9995),
        run_name="celeba64_low", img_size=64, batch_size=32, epochs=10)


def _preset_attn() -> ExperimentConfig:
    return ExperimentConfig(
        model=unet_64x64_config(),
        diffusion=DiffusionConfig(T=1000, schedule="linear", img_size=64,
                                  dynamic_threshold=0.95),
        train=TrainConfig(base_lr=2e-4, warmup_steps=1000, grad_accum_steps=1,
                          ema_decay=0.9997),
        run_name="celeba64_attn", img_size=64, batch_size=128, epochs=50)


def _preset_hq256() -> ExperimentConfig:
    return ExperimentConfig(
        model=unet_256x256_config(),
        diffusion=DiffusionConfig(T=1000, schedule="linear", img_size=256,
                                  dynamic_threshold=0.995),
        train=TrainConfig(base_lr=2e-4, warmup_steps=1000, grad_accum_steps=8,
                          ema_decay=0.9997),
        run_name="celebahq256", img_size=256, batch_size=64, epochs=50,
        remat=True)


def _preset_dit(model) -> ExperimentConfig:
    """A DiT preset: ``celeba64_attn``'s diffusion and training settings."""
    return ExperimentConfig(
        model=model,
        diffusion=DiffusionConfig(T=1000, schedule="linear", img_size=64,
                                  dynamic_threshold=0.95),
        train=TrainConfig(base_lr=2e-4, warmup_steps=1000, grad_accum_steps=1,
                          ema_decay=0.9997),
        run_name="celeba64_dit_moe" if model.num_experts else "celeba64_dit_s4",
        img_size=64, batch_size=128, epochs=50)


def _preset_dit_moe_xl2() -> ExperimentConfig:
    """DiT-MoE-XL/2-8E2A on 256-px ImageNet's SD-VAE latents (32x32x4) with
    DiT's recipe, which DiT-MoE follows: a constant 1e-4 without warmup,
    AdamW (0.9, 0.999) without weight decay or clipping, EMA 0.9999, a
    tenth of the labels dropped, the linear betas over 1,000 steps,
    epsilon-prediction, a global batch of 256; 80 epochs are DiT's 400K
    updates.  Unclamped: latents are unbounded."""
    return ExperimentConfig(
        model=dit_moe_xl2_config(),
        diffusion=DiffusionConfig(T=1000, schedule="linear", img_size=32, clamp_x0=False),
        train=TrainConfig(base_lr=1e-4, warmup_steps=0, weight_decay=0.0, grad_clip=None,
                          ema_decay=0.9999, cond_dropout=0.1),
        run_name="imagenet256_dit_moe_xl2", img_size=32, batch_size=256, epochs=80)


def _preset_sr64to256() -> ExperimentConfig:
    """The 64 -> 256 upsampler stage of a cascade: the 256-px U-Net with 3
    conditioning channels, trained on its own batches' low-res views."""
    return ExperimentConfig(
        model=unet_256x256_config(cond_channels=3),
        diffusion=DiffusionConfig(T=1000, schedule="linear", img_size=256,
                                  dynamic_threshold=0.995),
        train=TrainConfig(base_lr=2e-4, warmup_steps=1000, grad_accum_steps=8,
                          ema_decay=0.9997, superres_factor=4, cond_aug=0.1),
        run_name="sr64to256", img_size=256, batch_size=64, epochs=50,
        remat=True)


def _preset_latent() -> ExperimentConfig:
    """64 px latent diffusion: the denoiser on an f=4 KL-VAE's 16x16x4
    latents (``vae_64x_config``); train with ``train --preset
    celeba64_latent --latent-vae <vae_ckpt>`` after ``train-vae``, sample
    with ``sample-* --vae <vae_ckpt>``.  clamp_x0 is off: latents are
    unbounded (``sampling/latent.py`` ``check_latent_config``)."""
    return ExperimentConfig(
        model=unet_latent16_config(),
        diffusion=DiffusionConfig(T=1000, schedule="linear", img_size=16, clamp_x0=False),
        train=TrainConfig(base_lr=2e-4, warmup_steps=1000, grad_accum_steps=1,
                          ema_decay=0.9997),
        run_name="celeba64_latent", img_size=16, batch_size=128, epochs=50)


PRESETS = {
    "celeba64_low": _preset_low,
    "celeba64_attn": _preset_attn,
    "celebahq256": _preset_hq256,
    "celeba64_dit_s4": lambda: _preset_dit(dit_s4_64_config()),
    "celeba64_dit_moe": lambda: _preset_dit(dit_moe_64_config()),
    "sr64to256": _preset_sr64to256,
    "celeba64_latent": _preset_latent,
    "imagenet256_dit_moe_xl2": _preset_dit_moe_xl2,
}
#: the presets the JAX package does not have
PORT_PRESETS = ("imagenet256_dit_moe_xl2",)


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]()


def preset_from_experiment(exp: Dict[str, Any]) -> ExperimentConfig:
    """An :class:`ExperimentConfig` from an experiment dict as the JAX
    ``ExperimentConfig.to_dict`` writes it (``export-torch`` stores it
    under ``extra["experiment"]``), where the training part may be
    missing."""
    return ExperimentConfig.from_dict({"img_size": exp["model"]["img_resolution"],
                                       **exp, "train": exp.get("train") or {}})
