"""The numbers that decide ``correct``: what the timed path produced
against what the plain float32 reference gives on the same inputs, the
first three updates of the training state the window then drives:

- ``loss_gap``: the largest |loss - reference loss| / |reference loss| of
  the three updates;
- ``grad_gap``: over the leaves, the largest | ||g|| - ||g_ref|| | /
  max(||g_ref||, the median leaf's ||g_ref||), with g the first update's
  clipped gradient as the optimizer holds it (Adam's first moment after
  one update over 1 - b1);
- ``grad_gap_median``: the median leaf's gap instead of the worst (a
  steadier number: a leaf's norm moves by a few percent when the batch is
  cut in half, and the worst leaf's rounding swings from seed to seed);
- ``update_gap`` and ``update_gap_median``: the same of the parameters'
  change after three updates, leaving out the elements whose reference
  gradient in the first update is under a thousandth of the median leaf's
  RMS gradient (round-off alone moves them under Adam, as a key's bias
  under softmax);
- ``ema_gap``: over the leaves, the largest ||ema - ema_ref|| over the
  larger of the leaf's and the median leaf's ||p_ref - p0|| (the
  reference's change of the parameters), the EMA after three updates.  A
  sound EMA moves by (1 - decay) times the parameters' change, below the
  float32 spacing of the weights it holds, so both sides keep about p0 and
  differ by a rounding here and there; an update that copies the
  parameters, or takes the wrong tensor, reads about 1.  It is the norm
  of the difference, not a gap of two norms: each norm alone is rounding.

A number is checked against its limit (``limits/<workload>.json``); a
number that is not finite, or a run with no number, is not correct.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["train_numbers", "verdict"]


def _norms(tensors: Mapping[str, torch.Tensor], mask=None) -> Dict[str, float]:
    out = {}
    for k, v in tensors.items():
        v = v.double()
        if mask is not None:
            v = v[mask[k]]
        out[k] = float(torch.linalg.vector_norm(v))
    return out


def _gaps(prog: Mapping[str, float], ref: Mapping[str, float]) -> np.ndarray:
    """Each leaf's | ||prog|| - ||ref|| | over the larger of its ||ref|| and
    the median leaf's."""
    med = float(np.median(list(ref.values())))
    return np.array([abs(prog[k] - r) / max(r, med, 1e-300) for k, r in ref.items()])


def _worst(g: np.ndarray) -> float:
    return float(g.max()) if np.all(np.isfinite(g)) else float("inf")


def _median(g: np.ndarray) -> float:
    return float(np.median(g)) if np.all(np.isfinite(g)) else float("inf")


def train_numbers(prog: dict, ref: dict, p0: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses`` (3), ``first_grad`` (name -> norm
    for the program, name -> tensor for the reference), ``params`` and
    ``ema`` (name -> tensor after three updates); ``p0`` the weights both
    started from.  The rule that leaves elements out reads the reference's
    first gradient (clipped or not: the rule is relative, so the clip's one
    factor does not move it)."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(float("inf"))
    rms = {k: float(g.double().pow(2).mean().sqrt()) for k, g in ref["first_grad"].items()}
    floor = 1e-3 * float(np.median(list(rms.values())))
    mask = {k: g.abs() >= floor for k, g in ref["first_grad"].items()}
    ref_g = _norms(ref["first_grad"])
    ref_dp = _norms({k: ref["params"][k] - p0[k] for k in p0}, mask)
    prog_dp = _norms({k: prog["params"][k] - p0[k] for k in p0}, mask)
    g, dp = _gaps(prog["first_grad"], ref_g), _gaps(prog_dp, ref_dp)
    move = _norms({k: ref["params"][k] - p0[k] for k in p0})
    med = float(np.median(list(move.values())))
    ema = _norms({k: prog["ema"][k] - ref["ema"][k] for k in p0})
    e = np.array([ema[k] / max(move[k], med, 1e-300) for k in p0])
    return {"loss_gap": max(losses) if losses else float("inf"),
            "grad_gap": _worst(g), "grad_gap_median": _median(g),
            "update_gap": _worst(dp), "update_gap_median": _median(dp),
            "ema_gap": _worst(e)}


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]
            ) -> (bool, Dict[str, dict]):
    """(correct, {name: {"value", "limit"}}) over the limited numbers; the
    others are printed with a null limit."""
    checks, ok = {}, bool(limits)
    for name, value in numbers.items():
        lim: Optional[float] = limits.get(name)
        checks[name] = {"value": value, "limit": lim}
        if lim is not None and not (math.isfinite(value) and value <= lim):
            ok = False
    for name in limits:
        if name not in numbers:
            ok = False
            checks[name] = {"value": None, "limit": limits[name]}
    return ok, checks
