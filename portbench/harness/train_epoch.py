"""The ``train_epoch`` traffic: ``train_one_epoch`` over the device cache
with ``make_train_step``'s step, as ``cli train --device-cache`` runs it.

Set-up builds one training state and drives it through the loop's own
call for ``warmup_updates`` updates (the first ``checked_updates`` of them
are the ones the reference follows), then the window drives the same state
through ``train_one_epoch`` until the clock runs out (a stop flag the loop
reads before each step).  ``train_images_per_s`` is every image the
updates consumed over the window's time, ending at a synchronize.  A
class-conditional configuration (``model.num_classes > 0``) gives every
corpus image a label drawn uniformly from its classes with the run's
``traffic`` sub-seed, fed through the loader to the step and to the
reference alike.

Mix parameters: ``batch`` (images an update), ``corpus_images`` (the
dataset's count of uint8 images, drawn on the card from the seed and
uploaded through ``DeviceCacheLoader(quantize=True)``), ``warmup_updates``,
``checked_updates``, ``trace_warmup`` and ``trace_updates`` (the traced
slice after the window), ``reference_row_block`` (rows per block of the
reference's batch; 0 for the whole batch).
"""

from __future__ import annotations

import contextlib
import functools
import math
import time
from typing import Dict, List

import numpy as np
import torch

from . import checks, seeded, trace
from .runtime import (Outcome, RunContext, build_program, exact_fp32, free_device, log,
                      load_reference_weights, reference_model)

__all__ = ["run"]


class _Deadline:
    """A stop flag that trips once the clock passes ``t``."""

    def __init__(self, t: float):
        self.t = t

    def __bool__(self) -> bool:
        return time.perf_counter() >= self.t


class _Recorder:
    """The step as the loop calls it, keeping each update's loss, the
    optimizer's view of the first gradient and the state after the checked
    updates; ``after`` (when set) runs after every update."""

    def __init__(self, step, checked: int, b1: float):
        self.step, self.checked, self.b1 = step, checked, b1
        self.losses: List[torch.Tensor] = []
        self.first_grad = None
        self.snapshot = None
        self.after = None

    def __call__(self, state, batch, *a, **kw):
        state, metrics = self.step(state, batch, *a, **kw)
        self.losses.append(metrics["loss"].detach().reshape(()))
        k = len(self.losses)
        if k == 1:
            self.first_grad = _first_grad_norms(state, self.b1)
        if k == self.checked:
            self.snapshot = {
                "params": {n: p.detach().to("cpu", copy=True)
                           for n, p in state.model.named_parameters()},
                "ema": {n: e.detach().to("cpu", copy=True) for n, e in state.ema_params.items()}}
        if self.after is not None:
            self.after()
        return state, metrics


def _first_grad_norms(state, b1: float) -> Dict[str, float]:
    """Each leaf's norm of the first update's clipped gradient, from Adam's
    first moment after one update (mu = (1 - b1) g)."""
    names = [n for n, _ in state.model.named_parameters()]
    norms = torch.stack(torch._foreach_norm([m.float() for m in state.opt_state["mu"]]))
    norms = norms.cpu().tolist()
    return {n: v / (1.0 - b1) for n, v in zip(names, norms)}


@contextlib.contextmanager
def _planted(mode: str):
    """Break the timed path while the block runs, for a fault reading:
    ``fault:frozen`` (the update leaves the state as it was),
    ``fault:half_batch`` (the loss is the mean over the first half of the
    rows, with their labels), ``fault:ema_decay0`` (the EMA update copies
    the parameters), ``fault:null_labels`` (the step sees every label as
    the NULL token)."""
    from ddpm_diffusion_model_tpu_torch.training import step as step_mod

    saved = (step_mod._finish_update, step_mod.loss_simple, step_mod.ema_update,
             step_mod._drop_labels)
    if mode == "fault:frozen":
        def finish(state, tx, params, accum=1, sums=()):
            for p in params:
                p.grad = None
            return torch.zeros((), device=params[0].device), tuple(s / accum for s in sums)

        step_mod._finish_update = finish
    elif mode == "fault:half_batch":
        orig, orig_drop = step_mod.loss_simple, step_mod._drop_labels

        def half(sched, eps_fn, x0, t, noise, weight=None):
            h = x0.shape[0] // 2
            return orig(sched, eps_fn, x0[:h], t[:h], noise[:h],
                        None if weight is None else weight[:h])

        def half_labels(y, drop, cond_dropout, num_classes):
            return orig_drop(y, drop, cond_dropout, num_classes)[:y.shape[0] // 2]

        step_mod.loss_simple, step_mod._drop_labels = half, half_labels
    elif mode == "fault:ema_decay0":
        orig_ema = step_mod.ema_update

        def copy(ema_params, params, decay):
            return orig_ema(ema_params, params, 0.0)

        step_mod.ema_update = copy
    elif mode == "fault:null_labels":
        def null(y, drop, cond_dropout, num_classes):
            return torch.full_like(y, num_classes)

        step_mod._drop_labels = null
    elif mode != "program":
        raise ValueError(f"unknown mode {mode!r} for train_epoch")
    try:
        yield
    finally:
        (step_mod._finish_update, step_mod.loss_simple, step_mod.ema_update,
         step_mod._drop_labels) = saved


def run(rc: RunContext) -> Outcome:
    mix, m = rc.mix, rc.config["experiment"]["model"]
    seeds = seeded.sub_seeds(rc.seed)
    hw, ch = m["img_resolution"], m["in_channels"]
    with rc.clock.part("corpus"):
        n = int(mix["corpus_images"])
        corpus = seeded.make_corpus(n, hw, ch, seeds["corpus"], rc.device)
        labels = (seeded.make_labels(n, m["num_classes"], seeds["traffic"], rc.device)
                  if m.get("num_classes", 0) else None)
    if rc.mode == "control":
        free_device()
        return _control(rc, corpus, labels, seeds)
    with _planted(rc.mode):
        return _program(rc, corpus, labels, seeds)


def _program(rc: RunContext, corpus, labels, seeds) -> Outcome:
    mix, B = rc.mix, int(rc.mix["batch"])
    exp, model, sched = build_program(rc)
    with rc.clock.part("import"):
        from ddpm_diffusion_model_tpu_torch.data.loader import DeviceCacheLoader
        from ddpm_diffusion_model_tpu_torch.training import loop
        from ddpm_diffusion_model_tpu_torch.training.state import init_train_state
        from ddpm_diffusion_model_tpu_torch.training.step import make_train_step
    train_one_epoch = functools.partial(loop.train_one_epoch, labeled=labels is not None)
    with rc.clock.part("corpus"):
        loader = DeviceCacheLoader(corpus, B, seed=seeds["loader"], quantize=True,
                                   labels=labels, device=rc.device)
    state, tx = init_train_state(model, exp.train, seed=seeds["step"])
    checked = int(mix["checked_updates"])
    rec = _Recorder(make_train_step(model, sched, tx, exp.train), checked,
                    float(exp.train.adam_b1))
    with rc.clock.part("warmup"):
        state, _, nb, _ = train_one_epoch(rec, state, loader,
                                          max_batches=max(checked, int(mix["warmup_updates"])))
        _sync(rc.device)
    setup_s = rc.clock.done()

    flag = _Deadline(time.perf_counter() + rc.seconds)
    first = len(rec.losses)
    t_start = time.perf_counter()
    images = 0
    while not flag:
        state, _, _, ni = train_one_epoch(rec, state, loader, stop_flag=flag)
        images += ni
    _sync(rc.device)
    window_s = time.perf_counter() - t_start
    updates = len(rec.losses) - first
    peak = torch.cuda.max_memory_allocated(rc.device) if rc.device.type == "cuda" else 0

    layer = {"window_s": window_s, "window_updates": updates, "batch": B * rc.chips}
    tr = None
    if rc.trace:
        warm, active = int(mix["trace_warmup"]), int(mix["trace_updates"])
        tr = trace.record(lambda tick, _name: _slice(rec, tick, train_one_epoch, state, loader,
                                                     warm + active), warm, active, rc.spans)
        layer["traced_updates"] = active
    losses = torch.stack(rec.losses).float().cpu()
    failed = int((~torch.isfinite(losses)).sum())
    prog = {"losses": losses[:checked].tolist(), "first_grad": rec.first_grad,
            **rec.snapshot}
    del state, model, loader, rec, tx
    free_device()

    numbers = _compare(rc, prog, corpus, labels, seeds)
    e2e = {"train_images_per_s": images / window_s,
           "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
    return Outcome(e2e, attempted=len(losses), failed=failed, numbers=numbers,
                   peak_bytes=peak, trace=tr, layer=layer)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _slice(rec, tick, train_one_epoch, state, loader, n):
    rec.after = tick
    try:
        train_one_epoch(rec, state, loader, max_batches=n)
    finally:
        rec.after = None


def _batches(rc: RunContext, corpus: np.ndarray, labels, seeds, n: int):
    """The loader's first ``n`` batches of its first epoch, worked out
    again from the corpus: ``default_rng(seed + 0)``'s permutation, the
    uint8 codes as u * f32(1 / 127.5) - 1 rounded once to float32, with
    the same rows' labels for a conditional model."""
    B = int(rc.mix["batch"])
    order = np.arange(corpus.shape[0])
    np.random.default_rng(seeds["loader"]).shuffle(order)
    r = float(np.float32(1.0 / 127.5))

    def get(i):
        def load():
            sel = order[i * B:(i + 1) * B]
            rows = torch.from_numpy(corpus[sel]).to(rc.device)
            x = (rows.double() * r - 1.0).float()
            if labels is None:
                return x
            return x, torch.from_numpy(labels[sel]).to(rc.device, torch.long)
        return load

    return [get(i) for i in range(n)]


def _reference(rc: RunContext, corpus, labels, seeds, precision):
    from ..reference.diffusion import Schedule, train_steps

    model = reference_model(rc, precision)
    p0 = load_reference_weights(model, rc.seed, rc.device)
    sched = Schedule(rc.config["experiment"]["diffusion"], rc.device)
    gen = torch.Generator(device=rc.device).manual_seed(seeds["step"])
    block = int(rc.mix.get("reference_row_block") or 0) or None
    exp = rc.config["experiment"]
    with exact_fp32():
        out = train_steps(model, sched, exp["train"],
                          _batches(rc, corpus, labels, seeds, int(rc.mix["checked_updates"])),
                          gen, row_block=block, num_classes=int(exp["model"].get("num_classes", 0)))
    del model
    return out, p0


def _compare(rc: RunContext, prog: dict, corpus, labels, seeds) -> Dict[str, float]:
    from ..reference.lowp import FP32

    t = time.perf_counter()
    ref, p0 = _reference(rc, corpus, labels, seeds, FP32)
    prog = dict(prog, params={k: v.to(rc.device) for k, v in prog["params"].items()},
                ema={k: v.to(rc.device) for k, v in prog["ema"].items()})
    numbers = checks.train_numbers(prog, ref, p0)
    log(f"[check] reference {time.perf_counter() - t:.1f} s; losses program "
        f"{prog['losses']} reference {ref['losses']}")
    return numbers


def _control(rc: RunContext, corpus, labels, seeds) -> Outcome:
    """The fp8 reference in the program's place, held to the same check."""
    from ..reference.lowp import FP8

    low, _ = _reference(rc, corpus, labels, seeds, FP8)
    prog = {"losses": low["losses"],
            "first_grad": {k: float(torch.linalg.vector_norm(g.double()))
                           for k, g in low["first_grad"].items()},
            "params": low["params"], "ema": low["ema"]}
    free_device()
    numbers = _compare(rc, prog, corpus, labels, seeds)
    bad = sum(1 for v in prog["losses"] if not math.isfinite(v))
    return Outcome({}, attempted=len(prog["losses"]), failed=bad, numbers=numbers,
                   peak_bytes=0)
