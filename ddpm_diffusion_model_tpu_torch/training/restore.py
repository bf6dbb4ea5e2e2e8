"""Open a checkpoint directory of the port as a model ready to run.

A directory written by :func:`~.checkpoint.save_checkpoint` records the
experiment it was trained under in its meta (``configs.experiment``, read
with ``legacy=True`` as the JAX CLI reads it); :func:`load_run` builds that
experiment's model (bf16 compute, channels-last) and schedule, and loads
the checkpoint's train state into them.  The CLI and the service open
checkpoints through here.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch

from ..models import UNetDenoiser
from ..ops.schedules import make_schedule
from .checkpoint import load_checkpoint, read_meta
from .state import init_train_state

if TYPE_CHECKING:  # utils.config imports this package
    from ..utils.config import ExperimentConfig

__all__ = ["checkpoint_experiment", "build_model", "load_run"]


def checkpoint_experiment(path: str) -> Optional[ExperimentConfig]:
    """The experiment stored in checkpoint directory ``path``'s meta, or
    None when it holds none."""
    from ..utils.config import ExperimentConfig

    meta = read_meta(path) or {}
    exp = meta.get("configs", {}).get("experiment")
    return ExperimentConfig.from_dict(exp, legacy=True) if exp else None


def build_model(exp: ExperimentConfig, device):
    """``(model, sched)`` of ``exp``, the model's weights seeded from
    ``exp.seed`` (the init of a fresh run)."""
    torch.manual_seed(exp.seed)
    model = UNetDenoiser(exp.model, dtype=torch.bfloat16, device=device,
                         remat=exp.remat).to(memory_format=torch.channels_last)
    return model, make_schedule(exp.diffusion, device=device)


def load_run(path: str, exp: ExperimentConfig, device):
    """``(model, sched, state, meta)`` of the checkpoint directory ``path``
    trained under ``exp``."""
    model, sched = build_model(exp, device)
    template, _ = init_train_state(model, exp.train)
    state, meta = load_checkpoint(path, template)
    return model, sched, state, meta
