"""Training of the port: config, optimizer and state, EMA, the step, one
epoch, the whole run with checkpoints and preemption (counterparts of
``ddpm_diffusion_model_tpu/training/``)."""

from .checkpoint import (apply_resume_overrides, find_latest_checkpoint,
                         load_checkpoint, mirror_checkpoint, read_meta,
                         save_checkpoint, wait_for_checkpoints)
from .ema import ema_health, ema_init, ema_reinit_from_params, ema_update
from .loop import evaluate_loss, train_ddpm, train_one_epoch
from .preemption import PreemptionFlag, catch_preemption
from .state import (AdamWClip, TrainConfig, TrainState, init_train_state,
                    make_lr_schedule, make_optimizer)
from .step import (StepDraws, draw_step_inputs, make_eval_step, make_loss_fn,
                   make_probe_fn, make_train_step, resolve_weight_fn)

__all__ = [
    "TrainConfig", "TrainState", "AdamWClip", "make_lr_schedule",
    "make_optimizer", "init_train_state", "ema_init", "ema_update",
    "ema_health", "ema_reinit_from_params", "StepDraws", "draw_step_inputs",
    "make_loss_fn", "resolve_weight_fn", "make_train_step", "make_eval_step",
    "make_probe_fn", "train_one_epoch", "evaluate_loss", "train_ddpm",
    "save_checkpoint", "load_checkpoint", "read_meta", "wait_for_checkpoints",
    "apply_resume_overrides", "mirror_checkpoint", "find_latest_checkpoint",
    "PreemptionFlag", "catch_preemption",
]
