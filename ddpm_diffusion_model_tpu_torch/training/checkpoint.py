"""Checkpoint save/load/resume for the port's train state.

Counterpart of ``ddpm_diffusion_model_tpu/training/checkpoint.py``.  A
checkpoint is a directory holding ``state.pt``, one ``torch.save`` file
with the entries

- ``step``;
- ``params``: the fp32 weights under the reference's parameter names (the
  model's ``named_parameters``, which ``utils/interop.py`` maps);
- ``opt_state``: ``count``, ``schedule_count``, and ``mu``/``nu`` keyed by
  parameter name;
- ``ema_params`` and ``ema_decay``;
- ``rng``: the train generator's ``get_state()``;

and, beside it, ``meta.json`` with exactly the JAX sidecar's keys
(``epoch``, ``global_step``, ``extra``, ``configs``), so :func:`read_meta`
and :func:`find_latest_checkpoint` behave as the JAX ones do.  The port
does not read Orbax directories; JAX-trained weights arrive through
``export-torch`` and ``utils/interop.py``.

A save writes a hidden temporary directory beside the target and renames
it into place, so a crash never leaves a half checkpoint that
:func:`find_latest_checkpoint` would pick.  ``block=False`` copies every
tensor to the host before it returns (the optimizer and the EMA update the
live tensors in place), then writes on a background thread;
:func:`wait_for_checkpoints` joins it and re-raises its failure.

The resume-time overrides (reset the optimizer, EMA decay, EMA repair)
are :func:`apply_resume_overrides`, with the reference's semantics.

Several processes (a mesh, ``parallel/``): a save gathers a sharded
state whole on every rank (a collective), rank 0 alone writes, and every
rank waits at a barrier until the directory is in place, so it is the one
a single process writes.  Such saves always block: a write on a
background thread would put its barrier among the step's collectives in
another order on each rank (JAX ``checkpoint.py`` explains the same).  A
load waits at a barrier before it reads.
"""

from __future__ import annotations

import dataclasses
import glob
import itertools
import json
import os
import shutil
import threading
from typing import Any, Dict, Literal, Optional, Sequence, Tuple, Union

import torch

from .ema import ema_health, ema_reinit_from_params
from .state import TrainState

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "read_meta",
    "wait_for_checkpoints",
    "apply_resume_overrides",
    "mirror_checkpoint",
    "find_latest_checkpoint",
]

STATE_FILE = "state.pt"
_COMPONENTS = ("params", "opt_state", "ema_params", "step", "ema_decay", "rng")

_pending: Optional[threading.Thread] = None
_pending_error: Optional[BaseException] = None
_tmp_ids = itertools.count()


def read_meta(path: str, *, strict: bool = False) -> Optional[Dict[str, Any]]:
    """Read a checkpoint directory's ``meta.json`` sidecar.  ``None`` when
    it is missing, or unreadable with ``strict=False``; ``strict=True``
    raises on a present but corrupt sidecar."""
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return None
    try:
        with open(meta_path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        if strict:
            raise
        return None


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy that later in-place updates of ``t`` cannot reach."""
    return t.detach().to("cpu", copy=True)


def _state_to_saveable(state: TrainState) -> Dict[str, Any]:
    names = [n for n, _ in state.model.named_parameters()]
    opt = state.opt_state
    return {
        "step": int(state.step),
        "params": {n: _host(p) for n, p in state.model.named_parameters()},
        "opt_state": {
            "count": int(opt["count"]),
            "schedule_count": int(opt.get("schedule_count", opt["count"])),
            "mu": {n: _host(m) for n, m in zip(names, opt["mu"])},
            "nu": {n: _host(v) for n, v in zip(names, opt["nu"])},
        },
        "ema_params": {n: _host(e) for n, e in state.ema_params.items()},
        "ema_decay": float(state.ema_decay),
        "rng": state.generator.get_state(),
    }


def _write(path: str, payload: Dict[str, Any], meta: Dict[str, Any],
           mirror_dir: Optional[str], fixed_mirror_name: str, log=None) -> None:
    """Write ``state.pt`` and ``meta.json`` into a hidden directory beside
    ``path``, rename it into place (an older ``path`` is moved aside first
    and removed after), then mirror."""
    parent, base = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    tag = f"{os.getpid()}-{next(_tmp_ids)}"
    tmp = os.path.join(parent, f".{base}.tmp-{tag}")
    old = os.path.join(parent, f".{base}.old-{tag}")
    os.makedirs(tmp)
    try:
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
        if os.path.exists(path):
            os.replace(path, old)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    shutil.rmtree(old, ignore_errors=True)
    if mirror_dir:
        dst = mirror_checkpoint(path, mirror_dir, fixed_mirror_name)
        if dst and log:
            log(f"└─ [MIRROR] copied -> {dst}")


def _write_guarded(*args) -> None:
    """Thread target: keep a failure for :func:`wait_for_checkpoints` to
    raise; a dead thread would otherwise turn a failed save into a silent
    success."""
    global _pending_error
    try:
        _write(*args)
    except BaseException as e:  # noqa: BLE001 -- re-raised by wait_for_checkpoints
        _pending_error = e


def save_checkpoint(
    path: str,
    state: TrainState,
    *,
    epoch: int = 0,
    extra: Optional[Dict[str, Any]] = None,
    configs: Optional[Dict[str, Any]] = None,
    block: bool = True,
    mirror_dir: Optional[str] = None,
    fixed_mirror_name: str = "latest_ddpm",
    log=None,
) -> str:
    """Write the checkpoint directory at ``path`` (replaced if it exists).

    ``extra`` mirrors the reference's extra dict; ``configs`` holds
    ``to_dict()``'d configs.  With ``block=False`` the call returns once
    every tensor is copied to the host; the disk write, the meta sidecar
    and the mirror copy run on a background thread (one process only; with
    several, every save blocks).  Call :func:`wait_for_checkpoints` (or any
    later save or load, which drain first) before reading the directory.
    A placed state (``state.placement``) is saved whole, as one process
    would save it."""
    global _pending
    from ..parallel import rank, unplace_state, world_size

    path = os.path.abspath(path)
    wait_for_checkpoints()
    multi = world_size() > 1
    state = unplace_state(state)  # a sharded state gathered whole: a collective
    if rank() == 0:
        payload = _state_to_saveable(state)
        meta = {
            "epoch": int(epoch),
            "global_step": int(state.step),
            "extra": extra or {},
            "configs": configs or {},
        }
        args = (path, payload, meta, mirror_dir, fixed_mirror_name, log)
        if block or multi:
            _write(*args)
        else:
            _pending = threading.Thread(target=_write_guarded, args=args, daemon=True)
            _pending.start()
    if multi:
        torch.distributed.barrier()
    return path


def wait_for_checkpoints() -> None:
    """Block until every save dispatched with ``block=False`` is on disk
    (renamed into place, meta written, mirrored).  Raises if one failed."""
    global _pending, _pending_error
    if _pending is not None:
        _pending.join()
        _pending = None
    if _pending_error is not None:
        err, _pending_error = _pending_error, None
        raise RuntimeError("async checkpoint write failed") from err


def _restore_into(name: str, saved: Dict[str, torch.Tensor],
                  like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``saved`` as new tensors on the devices, dtypes and memory layouts
    of ``like``, key for key (the fused update takes a weight's moments and
    shadow in its layout); raises on a missing or extra name or another
    shape."""
    if list(saved) != list(like):
        missing = sorted(set(like) - set(saved))
        unexpected = sorted(set(saved) - set(like))
        raise ValueError(f"checkpoint {name} do not match the model: missing "
                         f"{missing[:5]}, unexpected {unexpected[:5]}")
    out = {}
    for k, ref in like.items():
        if saved[k].shape != ref.shape:
            raise ValueError(f"checkpoint {name}[{k!r}] has shape "
                             f"{tuple(saved[k].shape)}, the model {tuple(ref.shape)}")
        out[k] = torch.empty_like(ref).copy_(saved[k])
    return out


def load_checkpoint(
    path: str,
    template: TrainState,
    components: Optional[Sequence[str]] = None,
) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore a state matching ``template`` (a fresh state of the same
    configs).  Returns ``(state, meta)``.

    ``components`` selects what to restore, the reference's
    restore-each-iff-passed semantics: ``("params", "ema_params")`` is a
    params-only fine-tuning load that keeps the template's fresh optimizer
    state, step and generator, and works whatever optimizer state the
    checkpoint holds.  ``None`` restores everything.  The params are
    copied into ``template.model`` in place; every other part of the
    returned state is new, so ``template``'s optimizer state stays fresh.
    A placed template (a mesh) is restored whole and placed again as it
    was; every rank calls the load."""
    from ..parallel import place_state, unplace_state, world_size

    placement = template.placement
    if placement is not None:  # restore whole, then place as the template was
        state, meta = load_checkpoint(path, unplace_state(template), components)
        return place_state(state, placement.mesh, placement.fsdp), meta
    path = os.path.abspath(path)
    wait_for_checkpoints()
    if world_size() > 1:
        torch.distributed.barrier()  # every rank's save is in place
    sel = _COMPONENTS if components is None else tuple(components)
    unknown = set(sel) - set(_COMPONENTS)
    if unknown:
        raise ValueError(f"unknown checkpoint components: {sorted(unknown)}")
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    named = dict(template.model.named_parameters())
    repl: Dict[str, Any] = {}
    if "params" in sel:
        params = _restore_into("params", saved["params"], named)
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(params[k])
    if "opt_state" in sel:
        opt, like = saved["opt_state"], template.opt_state
        mu = _restore_into("mu", opt["mu"], dict(zip(named, like["mu"])))
        nu = _restore_into("nu", opt["nu"], dict(zip(named, like["nu"])))
        repl["opt_state"] = {"count": int(opt["count"]),
                             "schedule_count": int(opt.get("schedule_count",
                                                           opt["count"])),
                             "mu": list(mu.values()), "nu": list(nu.values())}
    if "ema_params" in sel:
        repl["ema_params"] = _restore_into("ema_params", saved["ema_params"],
                                           template.ema_params)
    if "step" in sel:
        repl["step"] = int(saved["step"])
    if "ema_decay" in sel:
        repl["ema_decay"] = float(saved["ema_decay"])
    if "rng" in sel:
        gen = torch.Generator(device=template.generator.device)
        gen.set_state(saved["rng"])
        repl["generator"] = gen
    state = dataclasses.replace(template, **repl)
    meta = read_meta(path, strict=True) or {}
    return state, meta


def _fast_forward_schedule_count(opt_state: Dict[str, Any], step: int) -> Dict[str, Any]:
    """A copy of ``opt_state`` (a fresh template's: zero moments, Adam's
    count 0) with the schedule's clock set to ``step``, as JAX
    ``_fast_forward_schedule_counts``."""
    return {"count": int(opt_state["count"]), "schedule_count": int(step),
            "mu": [m.clone() for m in opt_state["mu"]],
            "nu": [v.clone() for v in opt_state["nu"]]}


def apply_resume_overrides(
    state: TrainState,
    template: TrainState,
    *,
    reset_optimizer_state: bool = False,
    override_ema_decay: Optional[float] = None,
    repair_ema: Union[bool, Literal["force"]] = False,
    ema_decay_after_repair: Optional[float] = None,
    ema_rel_tol: float = 5.0,
    log=print,
) -> TrainState:
    """Resume-time control knobs with the reference's semantics.  LR and
    weight-decay overrides rebuild the optimizer from an updated
    ``TrainConfig`` in ``train_ddpm``; they are not state."""
    if reset_optimizer_state:
        # fresh moments, but warmup keeps following the global step: a
        # mid-run reset must not ramp the learning rate again
        state = dataclasses.replace(
            state, opt_state=_fast_forward_schedule_count(template.opt_state, state.step))
        log("[RESUME] optimizer state reset (not loaded); warmup continues from global step.")
    if override_ema_decay is not None:
        state = dataclasses.replace(state, ema_decay=float(override_ema_decay))
        log(f"[RESUME] override_ema_decay -> {override_ema_decay:.6f}")
    if repair_ema:
        # True: repair only when the health check fails; "force": re-seed
        # from the model unconditionally (the recovery for a healthy but
        # lagging shadow)
        params = dict(state.model.named_parameters())
        if repair_ema == "force":
            ok, reason, rel = False, "forced", float("nan")
        else:
            ok, reason, rel = ema_health(state.ema_params, params, rel_tol=ema_rel_tol)
        if repair_ema == "force" or not ok:
            # precedence: ema_decay_after_repair > override_ema_decay > 0.9995
            decay_after = (
                ema_decay_after_repair if ema_decay_after_repair is not None
                else (override_ema_decay if override_ema_decay is not None
                      else 0.9995))
            state = dataclasses.replace(state, ema_params=ema_reinit_from_params(params),
                                        ema_decay=float(decay_after))
            why = "forced" if repair_ema == "force" else f"invalid ({reason}, rel={rel:.3f})"
            log(f"[RESUME][EMA][AUTO] checkpoint EMA {why}."
                f" Reinitialized | decay={decay_after:.6f}")
        else:
            log(f"[RESUME][EMA][AUTO] checkpoint EMA healthy (rel={rel:.3f}). Kept.")
    return state


def mirror_checkpoint(src_path: str, mirror_dir: str,
                      fixed_name: str = "latest_ddpm") -> Optional[str]:
    """Copy a checkpoint directory to ``mirror_dir/fixed_name``, replacing
    any earlier copy.  A failure is printed, never raised: a mirror must
    not kill training."""
    if not mirror_dir:
        return None
    try:
        os.makedirs(mirror_dir, exist_ok=True)
        dst = os.path.join(mirror_dir, fixed_name)
        if os.path.exists(dst):
            shutil.rmtree(dst)
        shutil.copytree(src_path, dst)
        return dst
    except Exception as e:  # noqa: BLE001 -- mirror failures must never kill training
        print(f"[MIRROR] copy failed: {e}")
        return None


def find_latest_checkpoint(ckpt_dir: str, run_name: str) -> Optional[str]:
    """The newest checkpoint of ``run_name`` under ``ckpt_dir`` by
    ``global_step`` in each ``meta.json`` (epoch breaks ties), among the
    periodic ``<run>_eNNN``, the final ``<run>_last`` and the emergency
    ``<run>_preempt`` saves; None when none is restorable."""
    best, best_key = None, (-1, -1)
    candidates = (
        glob.glob(os.path.join(ckpt_dir, f"{run_name}_e[0-9]*"))
        + [os.path.join(ckpt_dir, f"{run_name}_last"),
           os.path.join(ckpt_dir, f"{run_name}_preempt")]
    )
    for path in candidates:
        meta = read_meta(path)
        if meta is None:
            continue
        key = (int(meta.get("global_step", -1)), int(meta.get("epoch", -1)))
        if key > best_key:
            best, best_key = path, key
    return best
