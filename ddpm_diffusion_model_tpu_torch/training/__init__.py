"""Training of the port: config, optimizer and state, EMA, the step, one
epoch, the whole run with checkpoints and preemption, and progressive and
consistency distillation (counterparts of
``ddpm_diffusion_model_tpu/training/``)."""

from .checkpoint import (apply_resume_overrides, find_latest_checkpoint,
                         load_checkpoint, mirror_checkpoint, read_meta,
                         save_checkpoint, wait_for_checkpoints)
from .consistency import (cm_from_init, consistency_distill, consistency_fn,
                          consistency_ladder, consistency_sample_loop,
                          consistency_scalings, make_consistency_step)
from .distill import (DistillDraws, distill_ladder, draw_distill_inputs,
                      make_distill_step, make_teacher_eps, onestep_target,
                      progressive_distill, student_timesteps, student_x0)
from .ema import ema_health, ema_init, ema_reinit_from_params, ema_update
from .loop import evaluate_loss, train_ddpm, train_one_epoch
from .preemption import PreemptionFlag, catch_preemption
from .restore import build_model, checkpoint_experiment, load_run
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
    "PreemptionFlag", "catch_preemption", "DistillDraws", "draw_distill_inputs",
    "distill_ladder", "student_timesteps", "onestep_target", "student_x0",
    "make_teacher_eps", "make_distill_step", "progressive_distill",
    "consistency_ladder", "consistency_scalings", "consistency_fn",
    "make_consistency_step", "consistency_distill", "consistency_sample_loop",
    "cm_from_init", "checkpoint_experiment", "build_model", "load_run",
]
