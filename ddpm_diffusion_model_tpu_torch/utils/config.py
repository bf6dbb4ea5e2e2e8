"""Presets of the port: model, diffusion and training settings.

Counterpart of the ``celeba64_low``, ``celeba64_attn`` and ``celebahq256``
presets of ``ddpm_diffusion_model_tpu/utils/config.py``: the U-Net, the
diffusion, the image size, the ``TrainConfig``, the batch size and
``remat`` (False, True or ``"masks"``, for ``UNetDenoiser(remat=)``); the
epoch and sampling cadence of the JAX ``ExperimentConfig`` are arguments
of ``train_ddpm``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Union

from ..models.unet import (UNetConfig, unet_64x64_config,
                           unet_64x64_low_config, unet_256x256_config)
from ..ops.schedules import DiffusionConfig
from ..training.state import TrainConfig

__all__ = ["Preset", "PRESETS", "get_preset", "preset_from_experiment"]


@dataclasses.dataclass(frozen=True)
class Preset:
    """An experiment's U-Net, diffusion, image size and training settings."""

    model: UNetConfig
    diffusion: DiffusionConfig
    img_size: int
    train: TrainConfig = TrainConfig()
    batch_size: int = 128
    remat: Union[bool, str] = False


PRESETS = {
    "celeba64_low": lambda: Preset(
        model=unet_64x64_low_config(),
        diffusion=DiffusionConfig(T=1000, schedule="linear", img_size=64),
        img_size=64,
        train=TrainConfig(base_lr=2e-4, warmup_steps=1000, grad_accum_steps=1,
                          ema_decay=0.9995),
        batch_size=32),
    "celeba64_attn": lambda: Preset(
        model=unet_64x64_config(),
        diffusion=DiffusionConfig(T=1000, schedule="linear", img_size=64,
                                  dynamic_threshold=0.95),
        img_size=64,
        train=TrainConfig(base_lr=2e-4, warmup_steps=1000, grad_accum_steps=1,
                          ema_decay=0.9997),
        batch_size=128),
    "celebahq256": lambda: Preset(
        model=unet_256x256_config(),
        diffusion=DiffusionConfig(T=1000, schedule="linear", img_size=256,
                                  dynamic_threshold=0.995),
        img_size=256,
        train=TrainConfig(base_lr=2e-4, warmup_steps=1000, grad_accum_steps=8,
                          ema_decay=0.9997),
        batch_size=64, remat=True),
}


def get_preset(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]()


def preset_from_experiment(exp: Dict[str, Any]) -> Preset:
    """A preset from an experiment dict, as the JAX
    ``ExperimentConfig.to_dict`` writes it (and ``export-torch`` stores it
    under ``extra["experiment"]``); the training part is optional.  Other
    families raise."""
    model = dict(exp["model"])
    if model.get("family", "unet") != "unet":
        raise NotImplementedError(
            f"model family {model['family']!r} is not ported yet")
    train = exp.get("train")
    return Preset(model=UNetConfig.from_dict(model),
                  diffusion=DiffusionConfig.from_dict(exp["diffusion"]),
                  img_size=int(exp.get("img_size", exp["model"]["img_resolution"])),
                  train=TrainConfig.from_dict(train) if train else TrainConfig(),
                  batch_size=int(exp.get("batch_size", 128)),
                  remat=exp.get("remat", False))
