"""The plain float32 diffusion arithmetic the benchmark checks the port
against: the schedule, L_simple and its training steps (global-norm clip,
AdamW on a linear warmup, EMA).

These follow Ho et al. (2020) as the repository states them: betas linear in [beta_min, beta_max] over T steps, alpha-bar
their cumulative product in float32; x_t = sqrt(ab_t) x0 + sqrt(1 - ab_t)
eps with t ~ U{1..T-1} and eps ~ N(0, I) drawn in that order from the
step's generator, then for a class-conditional model each row's label drop
(``rand < cond_dropout``: the label becomes the NULL token ``num_classes``),
the generator then feeding the model's dropout; L_simple the mean over
the batch of each row's mean squared error, plus the model's auxiliary
loss where its forward returns one; optax's
``chain(clip_by_global_norm, adamw)`` with eps 1e-8 and bias corrections in
float32; EMA ``e <- d e + (1 - d) p``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["Schedule", "train_steps", "lr_at"]


class Schedule:
    """The (T,) float32 tables on ``device``."""

    def __init__(self, diffusion: dict, device):
        if diffusion["schedule"] != "linear":
            raise ValueError("the reference covers the linear beta schedule")
        T = int(diffusion["T"])
        betas = np.linspace(diffusion["beta_min"], diffusion["beta_max"], T,
                            dtype=np.float32)
        ab = np.cumprod(1.0 - betas, axis=0)
        as_t = lambda a: torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)  # noqa: E731
        self.T = T
        self.sqrt_ab = as_t(np.sqrt(ab))
        self.sqrt_omb = as_t(np.sqrt(1.0 - ab))

    def at(self, table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return table[t.clamp(0, self.T - 1)].reshape(-1, 1, 1, 1)


def lr_at(train: dict, count: int) -> float:
    """The learning rate of the update made at optimizer count ``count``."""
    base, warm = np.float32(train["base_lr"]), train.get("warmup_steps")
    if not warm or warm <= 0:
        return float(base)
    return float(base * np.minimum(np.float32(1.0), np.float32(count + 1) / np.float32(warm)))


def train_steps(model: torch.nn.Module, sched: Schedule, train: dict,
                batches: Sequence[Callable[[], object]], generator: torch.Generator,
                row_block: Optional[int] = None, num_classes: int = 0) -> Dict[str, object]:
    """``len(batches)`` updates of ``model``'s parameters from their values,
    each on the batch its callable returns (images, or ``(images, labels)``
    for a model of ``num_classes`` classes, called as ``model(x_t, t,
    generator, y=labels)``), t and noise drawn from ``generator``, then the
    label drop, then the dropout masks, in the forward.  A forward that
    returns ``(eps, aux)`` adds ``aux``, already weighted as the
    configuration's step weights it, to the update's L_simple.
    ``row_block`` splits a batch into blocks of rows whose gradients add up
    (a model with no random draws in its forward and no auxiliary loss
    only).  Returns the losses, the first update's clipped gradient by name,
    and the parameters and EMA after the last update by name."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    b1, b2, eps = float(train["adam_b1"]), float(train["adam_b2"]), 1e-8
    clip, wd = train.get("grad_clip"), float(train.get("weight_decay") or 0.0)
    decay = np.float32(train["ema_decay"])
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    ema = [p.detach().clone() for p in params]
    losses: List[float] = []
    first_grad = None
    for step, get_batch in enumerate(batches):
        batch = get_batch()
        x0, y = batch if isinstance(batch, tuple) else (batch, None)
        B = x0.shape[0]
        t = torch.randint(1, sched.T, (B,), generator=generator, device=x0.device)
        noise = torch.randn(x0.shape, generator=generator, device=x0.device)
        if y is not None:
            if num_classes <= 0:
                raise ValueError("labels given for a model of no classes")
            drop = torch.rand((B,), generator=generator, device=x0.device) < float(
                train["cond_dropout"])
            y = torch.where(drop, torch.full_like(y, num_classes), y)
        x_t = sched.at(sched.sqrt_ab, t) * x0 + sched.at(sched.sqrt_omb, t) * noise
        grads = [torch.zeros_like(p) for p in params]
        total = torch.zeros((), device=x0.device)
        for s in range(0, B, row_block or B):
            sl = slice(s, s + (row_block or B))
            out = model(x_t[sl], t[sl], generator, **({} if y is None else {"y": y[sl]}))
            pred, aux = out if isinstance(out, tuple) else (out, None)
            if aux is not None and x_t[sl].shape[0] < B:
                raise ValueError(f"an auxiliary loss is the whole batch's: row_block "
                                 f"{row_block} < batch {B}")
            rows = (noise[sl] - pred).square().mean(dim=(1, 2, 3))
            part = rows.sum() / B
            if aux is not None:
                part = part + aux
            for g, d in zip(grads, torch.autograd.grad(part, params)):
                g.add_(d)
            total += part.detach()
        losses.append(float(total))
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
            if clip is not None and float(norm) >= clip:
                grads = [g * (clip / norm) for g in grads]
            if first_grad is None:
                first_grad = {n: g.clone() for n, g in zip(names, grads)}
            count = step + 1
            bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
            bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
            lr = lr_at(train, step)
            for p, g, m, v, e in zip(params, grads, mu, nu, ema):
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                upd = (m / bc1) / ((v / bc2).sqrt() + eps)
                if wd:
                    upd = upd + wd * p
                p.add_(upd, alpha=-lr)
                e.mul_(float(decay)).add_(p, alpha=float(np.float32(1.0) - decay))
    return {"losses": losses, "first_grad": first_grad,
            "params": {n: p.detach().clone() for n, p in zip(names, params)},
            "ema": dict(zip(names, ema))}

