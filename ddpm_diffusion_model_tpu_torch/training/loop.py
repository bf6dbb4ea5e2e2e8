"""The training loop: one epoch, the evaluation pass and the whole run.

Counterpart of ``ddpm_diffusion_model_tpu/training/loop.py``: the same
batches protocol (bare arrays or ``(images, labels)`` tuples, NCHW
tolerated), the same ``max_batches`` / ``log_every`` / probe options, the
same in-epoch statistics table (step | lr | loss | dt(ms) | grad_norm |
probes) and, in :func:`train_ddpm`, the same run: resume (``"auto"``, the
overrides and the EMA repair), the header and epoch table, the eval pass
(raw, then EMA, on the same draws), the EMA-gated sample hook, the metrics
JSONL, periodic, ``_last`` and ``_preempt`` checkpoints with the
partial-epoch rule, and SIGTERM/SIGINT at batch boundaries.  The loss is
summed on the device and fetched once per epoch, or at a logged step.

One addition to the partial-epoch rule: a ``_preempt`` save of a partial
epoch records in its ``extra`` how many of that epoch's batches were
trained (``partial_batches``), and a resume from it skips them, so a
preempted and resumed run takes the uninterrupted run's steps, bit for
bit.  The meta's ``epoch`` is the JAX package's (the epoch before the
partial one), and a checkpoint without the key redoes the epoch whole, as
the JAX loop does.

The sample hook scores rFID against ``fid_reference`` (and FID through a
mounted ``fid_extractor``) when ``sample_fn`` returns the samples, as the
JAX loop does.  Batches reach the card through ``data/loader.py``
``device_prefetch``.  A class-conditional model (``num_classes > 0``)
trains on ``(images, labels)`` batches end to end, labels that live on the
card (``DeviceCacheLoader(labels=...)``) staying there.

``mesh`` (``parallel.make_mesh()``, one process per card) trains data
parallel, or fully sharded with ``fsdp``: the state is placed over the
mesh (``parallel/sharding.py``; again after a resume), each process cuts
its rows out of every global batch the loader yields (a loader that
yields a rank's rows already is taken as it is), the step reduces over
the ranks, and rank 0 alone prints, writes the metrics and writes the
checkpoints.  The eval pass and the sample hook run on every rank over the
whole batch or grid (the hook with the EMA gathered whole under FSDP), so
they print what one process would.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import (Any, Callable, Dict, Iterable, Literal, Mapping, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch
from torch import nn

from ..data.loader import device_prefetch
from ..ops.schedules import DiffusionSchedule
from ..utils.fid import _stats as fid_stats
from ..utils.fid import frechet_distance, load_torch_extractor, rfid
from ..data.loader import yields_rank_rows
from ..parallel import any_rank, place_state, rank, world_size
from .checkpoint import (apply_resume_overrides, find_latest_checkpoint,
                         load_checkpoint, read_meta, save_checkpoint,
                         wait_for_checkpoints)
from .diagnostics import StepTimer, device_mem_mb, fmt_hms, rule, span
from .ema import ema_health
from .preemption import PreemptionFlag, catch_preemption
from .state import (TrainConfig, TrainState, init_train_state, make_lr_schedule,
                    make_optimizer)
from .step import make_eval_step, make_probe_fn, make_train_step

__all__ = ["train_ddpm", "train_one_epoch", "evaluate_loss"]


def _as_batch_array(batch):
    """A loader item's images as contiguous NHWC float32: a numpy array,
    or a tensor where it lives (a device cache's batch stays on the card)."""
    if isinstance(batch, (tuple, list)):
        batch = batch[0]
    is_t = torch.is_tensor(batch)
    x = batch.float() if is_t else np.asarray(batch, dtype=np.float32)
    if x.ndim != 4:
        raise ValueError(f"expected batched images, got shape {tuple(x.shape)}")
    if x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3):  # tolerate NCHW sources
        x = x.permute(0, 2, 3, 1) if is_t else x.transpose(0, 2, 3, 1)
    return x.contiguous() if is_t else np.ascontiguousarray(x)


def _batch_labels(batch):
    """A loader item's labels as they come (None for a bare array): the
    step checks them, and labels on the card stay there."""
    return batch[1] if isinstance(batch, (tuple, list)) and len(batch) > 1 else None


def train_one_epoch(
    train_step,
    state: TrainState,
    dataloader: Iterable,
    *,
    labeled: bool = False,
    max_batches: Optional[int] = None,
    log_every: int = 0,
    probe_fn=None,
    probe_timesteps: Optional[Sequence[int]] = None,
    log_mem: bool = False,
    log_grad_norm: bool = False,
    epoch_header_printed: Optional[list] = None,
    stop_flag=None,
    skip_batches: int = 0,
    batch_sharding=None,
    log=print,
) -> Tuple[TrainState, float, int, int]:
    """One pass over the loader.  Returns (state, avg_loss, n_batches,
    n_images).  ``labeled=True`` (a conditional model) feeds each batch's
    labels to the step.  ``batch_sharding`` (``parallel.batch_sharding``)
    cuts this rank's rows (and labels) out of each global batch before the
    copy to the card; ``n_images`` counts the global batch's images under
    a placed state.  ``log`` prints (a no-op on ranks other than 0).

    Batches reach the model's device through :func:`device_prefetch`
    (``size=2``), as in the JAX loop.  The first ``skip_batches`` items are
    drawn from the loader and dropped before the prefetch, so they are never
    copied (the part of a preempted epoch done before).  ``stop_flag`` is
    read before each step, as in the JAX loop: once it trips, no further
    batch is trained (the prefetched ones are dropped; a resume draws them
    again from the loader's seeded order).  Several processes stop
    together: the flag counts when any rank's has tripped."""
    device = next(state.model.parameters()).device
    placement = getattr(state, "placement", None)
    shards = placement.batch.shards if placement is not None else 1
    n_batches, n_images = 0, 0
    loss_acc = None
    step0 = int(state.step)
    timer = StepTimer()  # wall since the last log line, over its updates
    logged_at = 0
    baseline_pending = bool(log_every and step0 == 0 and epoch_header_printed is not None
                            and not epoch_header_printed[0])
    title_printed = False

    def host_batches():
        for i, batch in enumerate(dataloader):
            if max_batches is not None and i >= max_batches:
                return
            if i >= skip_batches:
                x, y = _as_batch_array(batch), _batch_labels(batch)
                if batch_sharding is not None:
                    x = batch_sharding.local(x)
                    y = None if y is None else batch_sharding.local(y)
                yield (x, y) if labeled else x

    batches = device_prefetch(host_batches(), size=2, device=device)
    # no pull after the last of max_batches: each train.data_wait feeds a step
    while max_batches is None or n_batches < max_batches - skip_batches:
        with span("train.data_wait"):
            item = next(batches, None)
        if item is None:
            break
        x, y = item
        if any_rank(bool(stop_flag)):  # preemption: stop at a batch boundary
            break
        if baseline_pending:
            # the zero-predictor L_simple: mean(eps^2) of global-batch-shaped noise
            baseline_pending = False
            title_printed = True
            gen = torch.Generator(device=device).manual_seed(0)
            shape = (x.shape[0] * shards, *x.shape[1:])
            base = float(torch.randn(shape, generator=gen, device=device).square().mean())
            log("┆ In-epoch statistics")
            log(f"┆   (baseline)  eps-MSE ~ {base:.3f}  (expected ~1.0)")
        with span("train.step"):
            state, metrics = train_step(state, (x, y) if labeled else x)
        loss_acc = metrics["loss"] if loss_acc is None else loss_acc + metrics["loss"]
        n_batches += 1
        n_images += x.shape[0] * shards
        step_now = step0 + n_batches

        if log_every and step_now % log_every == 0:
            dt_ms = timer.mark(metrics["loss"]) / (n_batches - logged_at)
            loss_val = float(metrics["loss"])
            if epoch_header_printed is not None and not epoch_header_printed[0]:
                if not title_printed:
                    log("┆ In-epoch statistics")
                log("┆   {:>8} | {:>9} | {:>8} | {:>8} | {:>10}{}".format(
                    "step", "lr", "loss", "dt(ms)", "grad_norm",
                    " | probes[t]" if probe_timesteps else ""))
                log("┆   " + "─" * 72)
                epoch_header_printed[0] = True
            gn_str = f"{float(metrics['grad_norm']):.2e}" if log_grad_norm else "—"
            probe_msg = ""
            if probe_fn is not None and probe_timesteps:
                vals = probe_fn(None, x, tuple(int(t) for t in probe_timesteps),
                                step_now).cpu().numpy()
                probe_msg = " | " + " ".join(
                    f"t={tau}:{v:.3f}" for tau, v in zip(probe_timesteps, vals))
            mem_msg = ""
            if log_mem:
                used, peak = device_mem_mb(device)
                mem_msg = f" | mem={used:.0f}/{peak:.0f}MB"
            log("┆   {:8d} | {:9.2e} | {:8.4f} | {:8.1f} | {:>10}{}{}".format(
                step_now, float(metrics["lr"]), loss_val, dt_ms, gn_str, mem_msg,
                probe_msg))
            logged_at = n_batches
            timer.reset()

    avg_loss = float(loss_acc) / n_batches if n_batches else 0.0
    return state, avg_loss, n_batches, n_images


def evaluate_loss(eval_step, params, dataloader: Iterable, *, labeled: bool = False,
                  max_batches: Optional[int] = None, seed: int = 42) -> float:
    """Mean eval-mode L_simple over a loader.  Batch ``i`` draws its (t,
    noise) from the seed ``seed * 1_000_003 + i``, so repeated calls
    (across epochs, or raw against EMA ``params``) see the same draws and
    differ only through the weights.  ``labeled=True`` (a conditional
    model) feeds the loader's real labels to the eval step."""
    loss_acc, n = None, 0
    for i, batch in enumerate(dataloader):
        if max_batches is not None and i >= max_batches:
            break
        x = _as_batch_array(batch)
        loss = eval_step(params, (x, _batch_labels(batch)) if labeled else x,
                         seed * 1_000_003 + i)
        loss_acc = loss if loss_acc is None else loss_acc + loss
        n += 1
    return float(loss_acc) / n if n else float("nan")


def _saved_train_config(ckpt_path: str) -> Optional[TrainConfig]:
    """The TrainConfig a checkpoint was written with, from its
    ``meta.json``, legacy-defaulted; None when it holds none."""
    meta = read_meta(ckpt_path)
    if meta is None:
        return None
    configs = meta.get("configs") or {}
    tc = (configs.get("experiment") or {}).get("train") or configs.get("train")
    if not isinstance(tc, dict):
        return None
    try:
        return TrainConfig.from_dict(tc, legacy=True)
    except TypeError:
        return None


def _finite_or_none(rec: Dict[str, Any]) -> Dict[str, Any]:
    """Strict JSON: non-finite floats (a diverged loss) become null."""
    return {k: (None if isinstance(v, float) and not np.isfinite(v) else v)
            for k, v in rec.items()}


def train_ddpm(
    model: nn.Module,
    sched: DiffusionSchedule,
    train_loader: Iterable,
    *,
    train_config: Optional[TrainConfig] = None,
    init_params: Optional[Mapping[str, torch.Tensor]] = None,
    init_seed: int = 0,
    epochs: int = 50,
    max_batches: Optional[int] = None,
    # sampling hooks
    sample_every: int = 5,
    sample_n: int = 36,
    img_size: int = 64,
    sample_fn: Optional[Callable] = None,
    sample_seed: Optional[int] = 1234,
    fid_reference: Optional[np.ndarray] = None,
    fid_extractor: Optional[str] = None,
    # validation hooks
    eval_loader: Optional[Iterable] = None,
    eval_every: int = 1,
    eval_max_batches: Optional[int] = None,
    # checkpoint hooks
    ckpt_dir: str = "checkpoints",
    run_name: str = "ddpm",
    save_every: int = 5,
    save_last: bool = True,
    resume_path: Optional[str] = None,
    mirror_dir: Optional[str] = None,
    fixed_mirror_name: str = "latest_ddpm",
    # diagnostics
    log_every: int = 0,
    probe_timesteps: Optional[Sequence[int]] = None,
    log_mem: bool = False,
    log_grad_norm: bool = False,
    # resume-time control
    reset_optimizer_state: bool = False,
    override_lr: Optional[float] = None,
    override_weight_decay: Optional[float] = None,
    override_ema_decay: Optional[float] = None,
    repair_ema_on_resume: Union[bool, Literal["force"]] = False,
    ema_decay_after_repair: Optional[float] = None,
    resume_components: Optional[Sequence[str]] = None,
    configs_for_ckpt: Optional[Dict[str, Any]] = None,
    mesh=None,
    fsdp: bool = False,
    metrics_jsonl: Optional[str] = "auto",
    handle_preemption: Union[bool, PreemptionFlag] = True,
) -> Tuple[TrainState, Dict[str, Any]]:
    """Full training run on the model's device.  Returns (final_state,
    summary).

    ``model`` is a port denoiser, a ``UNetDenoiser`` or a ``DiTDenoiser``
    (its weights are the run's start unless ``init_params``, a name ->
    tensor map, replaces them);
    ``init_seed`` seeds the train generator.  ``sample_fn(model, params,
    sched, n=, img_size=, save_path=, seed=)`` is called with ``params``
    the EMA shadow (when it is healthy) or None (the live weights): the
    model's own parameters are never overwritten.  When it returns the (n,
    H, W, C) samples in [0, 1] and ``fid_reference`` (images in [-1, 1])
    is given, the epoch's rFID against it is scored (and FID through the
    mounted ``fid_extractor`` file).

    ``metrics_jsonl``: one JSON line per epoch, ``"auto"`` writes
    ``<ckpt_dir>/<run_name>_metrics.jsonl``, a path overrides, None
    disables.  ``eval_loader`` must be re-iterable (each eval epoch reads
    it twice: raw params, then EMA).  ``handle_preemption``: True catches
    SIGTERM/SIGINT at batch boundaries, saves ``<run_name>_preempt`` and
    returns with ``summary["preempted"] = True``; a :class:`PreemptionFlag`
    is a cooperative flag the caller trips (no handlers installed).
    ``resume_path="auto"`` picks the newest checkpoint of this run in
    ``ckpt_dir``.

    ``mesh``: a ``DeviceMesh`` (``parallel.make_mesh()``) over the
    processes of the run, one per card, turns it data parallel, or fully
    sharded with ``fsdp=True`` (see the module docstring); every process
    calls ``train_ddpm`` with the same arguments and loader."""
    if fsdp and mesh is None:
        raise ValueError("fsdp=True needs a mesh")
    cfg = train_config or TrainConfig()
    os.makedirs(ckpt_dir, exist_ok=True)
    log = print if rank() == 0 else (lambda *a, **k: None)

    # resolve the resume target first: the overrides are resume-time
    # semantics and must not apply to a fresh run
    if resume_path == "auto":
        resume_path = find_latest_checkpoint(ckpt_dir, run_name)
        log(f"[RESUME] auto -> {resume_path or 'none found (fresh start)'}")
    will_resume = bool(resume_path and os.path.exists(resume_path))
    if not will_resume and (
            any(v is not None for v in (override_lr, override_weight_decay,
                                        override_ema_decay))
            or reset_optimizer_state or repair_ema_on_resume):
        log("[RESUME] WARNING: resume-time overrides requested but no "
            "checkpoint to resume — ignoring them (fresh start)")
        override_lr = override_weight_decay = override_ema_decay = None
        reset_optimizer_state, repair_ema_on_resume = False, False

    # LR / weight-decay overrides are optimizer inputs: apply them to the
    # config before the optimizer is built
    if override_lr is not None:
        cfg = dataclasses.replace(cfg, base_lr=float(override_lr))
    if override_weight_decay is not None:
        cfg = dataclasses.replace(cfg, weight_decay=float(override_weight_decay))
    if will_resume:
        # flat_optimizer picks a JAX memory layout; the port's state has one
        # layout, but the run adopts the checkpoint's value as JAX does so
        # the config it writes again stays the one that wrote the state
        saved_tc = _saved_train_config(resume_path)
        if saved_tc is not None and saved_tc.flat_optimizer != cfg.flat_optimizer:
            log("[RESUME] adopting checkpoint optimizer layout:"
                f" flat_optimizer={saved_tc.flat_optimizer}")
            cfg = dataclasses.replace(cfg, flat_optimizer=saved_tc.flat_optimizer)

    if init_params is not None:
        model.load_state_dict(dict(init_params), strict=True)
    device = next(model.parameters()).device
    tx = make_optimizer(cfg)
    state, _ = init_train_state(model, cfg, seed=init_seed, tx=tx)
    train_step = make_train_step(model, sched, tx, cfg)
    # class-conditional model => batches are (images, labels) end to end
    conditional = bool(getattr(model.config, "num_classes", 0))
    sr_factor = int(getattr(cfg, "superres_factor", 0) or 0)
    probe_fn = (make_probe_fn(model, sched, superres_factor=sr_factor)
                if probe_timesteps else None)
    eval_fn = (make_eval_step(model, sched, superres_factor=sr_factor)
               if eval_loader is not None else None)
    lr_schedule = make_lr_schedule(cfg)

    global_step, start_epoch, skip_batches, resumed = 0, 0, 0, False
    if will_resume:
        template = state
        state, meta = load_checkpoint(resume_path, template, components=resume_components)
        global_step = int(meta.get("global_step", state.step))
        start_epoch = int(meta.get("epoch", 0)) + 1
        skip_batches = int((meta.get("extra") or {}).get("partial_batches", 0))
        log(f"[RESUME] loaded: {resume_path} | global_step={global_step}"
            f" | start_epoch={start_epoch}"
            + (f" | skipping its {skip_batches} trained batches" if skip_batches else ""))
        state = apply_resume_overrides(
            state, template, reset_optimizer_state=reset_optimizer_state,
            override_ema_decay=override_ema_decay, repair_ema=repair_ema_on_resume,
            ema_decay_after_repair=ema_decay_after_repair, log=log)
        if override_lr is not None:
            log(f"[RESUME] override_lr -> {override_lr:.3e}")
        if override_weight_decay is not None:
            log(f"[RESUME] override_weight_decay -> {override_weight_decay:.3e}")
        resumed = True
    batch_shd = None
    if mesh is not None:
        # placed after the resume, so a restored state is placed as a fresh one
        state = place_state(state, mesh, fsdp=fsdp)
        if not yields_rank_rows(train_loader):
            batch_shd = state.placement.batch
        elif (getattr(train_loader, "shard_hosts", False)
              and state.placement.batch.shards != world_size()):
            raise ValueError("a shard_hosts loader hands each rank its own rows, but the "
                             f"step's batch splits over {state.placement.batch.axes} only "
                             f"({state.placement.batch.shards} of {world_size()} ranks)")
        elif getattr(train_loader, "sharding", None) not in (None, state.placement.batch):
            raise ValueError("the loader's sharding hands this rank other rows than the "
                             "step takes: build it with parallel.step_batch_sharding(mesh)")

    log(rule())
    log(f"DDPM run: {run_name}")
    log(f"Backend: {device.type} | devices: {world_size()} | EMA: {state.ema_decay:.6f} |"
        f" epochs: {epochs} | base_lr: {cfg.base_lr:.2e} |"
        f" warmup_steps: {cfg.warmup_steps}")
    if resumed:
        log("Active resume overrides:", f"reset_opt={reset_optimizer_state}",
            f"override_lr={override_lr}", f"override_wd={override_weight_decay}",
            f"override_ema={override_ema_decay}")
    log(rule())
    log(f"{'ep':>3} | {'step':>8} | {'loss':>10} | {'lr':>9} | "
        f"{'batches':>8} | {'images':>8} | {'imgs/s':>7} | {'time':>8} | {'warmup':>6}")
    log(rule())

    total_time = 0.0
    header_flag = [False]
    fid_cache: Dict[str, Any] = {}
    summary: Dict[str, Any] = {"epochs": []}
    metrics_path = (os.path.join(ckpt_dir, f"{run_name}_metrics.jsonl")
                    if metrics_jsonl == "auto" else metrics_jsonl)
    if metrics_path is not None:
        summary["metrics_jsonl"] = metrics_path

    if isinstance(handle_preemption, PreemptionFlag):
        pctx, stop_flag = None, handle_preemption
    else:
        pctx = catch_preemption() if handle_preemption else None
        stop_flag = pctx.__enter__() if pctx is not None else PreemptionFlag()
    try:
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            if hasattr(train_loader, "set_epoch"):
                # the absolute epoch: a resumed run continues the
                # uninterrupted run's batch orders
                train_loader.set_epoch(epoch)
            skip = skip_batches if epoch == start_epoch else 0
            state, avg_loss, n_batches, n_images = train_one_epoch(
                train_step, state, train_loader, labeled=conditional,
                max_batches=max_batches,
                log_every=log_every, probe_fn=probe_fn, probe_timesteps=probe_timesteps,
                log_mem=log_mem, log_grad_norm=log_grad_norm,
                epoch_header_printed=header_flag, stop_flag=stop_flag,
                skip_batches=skip, batch_sharding=batch_shd, log=log)
            # tripped during the data pass: the pass was partial and is
            # finished on resume; tripped later (hooks): the epoch is done
            epoch_partial = any_rank(bool(stop_flag))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            sec = time.time() - t0
            total_time += sec
            ips = n_images / sec if sec > 0 else 0.0
            global_step = int(state.step)
            lr_now = float(lr_schedule(max(global_step - 1, 0)))
            warm = (0.0 if not cfg.warmup_steps
                    else min(1.0, global_step / float(cfg.warmup_steps)))
            log(f"{epoch:3d} | {global_step:8d} | {avg_loss:10.5f} | {lr_now:9.2e} | "
                f"{n_batches:8d} | {n_images:8d} | {ips:7.1f} | {fmt_hms(sec):>8} | "
                f"{int(100 * warm):3d}%")
            summary["epochs"].append(dict(epoch=epoch, loss=avg_loss, imgs_per_s=ips,
                                          seconds=sec))

            # the EMA whole (gathered from its shards under FSDP; a collective)
            # for the hooks that read it
            wants_eval = (eval_fn is not None and not epoch_partial
                          and eval_every > 0 and epoch % eval_every == 0)
            wants_sample = (sample_fn is not None and not epoch_partial and sample_every > 0
                            and (epoch % sample_every == 0 or epoch == epochs - 1))
            ema_whole = state.ema_params
            if state.placement is not None and (wants_eval or wants_sample):
                ema_whole = state.placement.full(state.ema_params)

            # validation: raw and EMA params on the same (t, noise) draws
            if wants_eval:
                if hasattr(eval_loader, "set_epoch"):
                    eval_loader.set_epoch(epoch)
                val = evaluate_loss(eval_fn, None, eval_loader, labeled=conditional,
                                    max_batches=eval_max_batches)
                if np.isfinite(val):
                    if hasattr(eval_loader, "set_epoch"):
                        eval_loader.set_epoch(epoch)
                    val_ema = evaluate_loss(eval_fn, ema_whole, eval_loader,
                                            labeled=conditional,
                                            max_batches=eval_max_batches)
                    summary["epochs"][-1]["val_loss"] = val
                    if np.isfinite(val_ema):
                        summary["epochs"][-1]["val_loss_ema"] = val_ema
                        log(f"└─ [EVAL]   val_loss={val:.5f} |"
                            f" val_loss_ema={val_ema:.5f}")
                    else:
                        log(f"└─ [EVAL]   val_loss={val:.5f} | WARNING:"
                            " EMA pass saw no batches — eval_loader must"
                            " be re-iterable (got a one-shot iterator?)")
                else:
                    log("└─ [EVAL]   no finite val loss (empty loader or"
                        " non-finite model output); skipping")

            # sampling hook: EMA-health-gated, fixed seed; skipped on a
            # partial epoch (the grace time goes to the save)
            if wants_sample:
                out_path = os.path.join(ckpt_dir, f"{run_name}_samples_e{epoch:03d}.png")
                ok, _, rel = ema_health(ema_whole, dict(model.named_parameters()),
                                        rel_tol=2.0)
                use_ema = bool(ok and rel <= 1.0)
                samples = sample_fn(model, ema_whole if use_ema else None, sched,
                                    n=sample_n, img_size=img_size, save_path=out_path,
                                    seed=sample_seed if sample_seed is not None else 0)
                fid_msg = ""
                if (fid_reference is not None and isinstance(samples, np.ndarray)
                        and samples.ndim == 4):
                    # rFID: the reference arrives in training range [-1, 1],
                    # the samples in [0, 1]
                    ref01 = (np.asarray(fid_reference, np.float32) + 1.0) / 2.0
                    score = rfid(ref01, samples, device=device)
                    summary["epochs"][-1]["rfid"] = score
                    fid_msg = f" | rFID={score:.3f}"
                    if fid_extractor:
                        # the mounted extractor and the reference's stats are
                        # built once for the run
                        if "ex" not in fid_cache:
                            fid_cache["ex"] = load_torch_extractor(fid_extractor, device)
                            fid_cache["ref"] = fid_stats(fid_cache["ex"](ref01))
                        fscore = frechet_distance(*fid_cache["ref"],
                                                  *fid_stats(fid_cache["ex"](samples)))
                        summary["epochs"][-1]["fid"] = fscore
                        fid_msg += f" | FID={fscore:.3f}"
                log(f"└─ [SAMPLE] grid -> {out_path} | EMA_used={use_ema}"
                    f" | rel={rel:.3f}{fid_msg}")

            if metrics_path is not None and rank() == 0:
                rec = dict(summary["epochs"][-1], global_step=global_step, lr=lr_now,
                           ts=time.time())
                if epoch_partial:
                    rec["partial"] = True  # finished after resume
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(_finite_or_none(rec)) + "\n")

            # periodic save: never for a partial epoch, whose meta would
            # claim the epoch completed and beat the preempt save
            if save_every and not epoch_partial and (
                    epoch % save_every == 0 or epoch == epochs - 1):
                ckpt_path = os.path.join(ckpt_dir, f"{run_name}_e{epoch:03d}")
                t_save = time.time()
                save_checkpoint(ckpt_path, state, epoch=epoch,
                                extra={"epoch": epoch, "global_step": global_step},
                                configs=configs_for_ckpt, block=False,
                                mirror_dir=mirror_dir,
                                fixed_mirror_name=fixed_mirror_name, log=log)
                log(f"└─ [CKPT]   saving (async) -> {ckpt_path}"
                    f" | dispatched in {1e3 * (time.time() - t_save):.0f} ms")

            if epoch_partial or any_rank(bool(stop_flag)):
                # a partial data pass stores epoch-1 (resume finishes the
                # epoch, skipping the batches trained) and a complete one
                # epoch; global_step is exact either way
                save_epoch = epoch - 1 if epoch_partial else epoch
                extra = {"epoch": save_epoch, "global_step": global_step}
                if epoch_partial:
                    extra["partial_batches"] = skip + n_batches
                ckpt_path = os.path.join(ckpt_dir, f"{run_name}_preempt")
                save_checkpoint(ckpt_path, state, epoch=save_epoch, extra=extra,
                                configs=configs_for_ckpt)
                log(f"└─ [PREEMPT] signal={stop_flag.signum}: saved -> "
                    f"{ckpt_path}; stopping cleanly")
                summary["preempted"] = True
                break
    finally:
        if pctx is not None:
            pctx.__exit__(None, None, None)

    if save_last and not summary.get("preempted"):
        # after a preemption the _preempt save is the truth; a _last would
        # claim epoch=epochs-1 and end auto-resume
        ckpt_path = os.path.join(ckpt_dir, f"{run_name}_last")
        save_checkpoint(ckpt_path, state, epoch=epochs - 1,
                        extra={"epoch": epochs - 1, "global_step": global_step},
                        configs=configs_for_ckpt, mirror_dir=mirror_dir,
                        fixed_mirror_name=fixed_mirror_name)
        log(f"└─ [CKPT]   saved -> {ckpt_path}")

    wait_for_checkpoints()  # every async save durable before we return
    log(rule())
    log(f"Training finished in {fmt_hms(total_time)}")
    log(rule())
    summary["total_seconds"] = total_time
    return state, summary
