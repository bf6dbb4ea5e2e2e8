"""Exponential moving average of the parameters.

Counterpart of ``ddpm_diffusion_model_tpu/training/ema.py``.  The shadow is
a dict ``{parameter name: tensor}`` in the order of ``named_parameters()``;
samplers and the eval step take it directly (``torch.func.functional_call``),
so no weights are swapped.  :func:`ema_update` updates the shadow in place
(one lerp, no second copy of the weights: a kernel on the card,
``ops/fused_update.py`` ``ema_lerp_``) and returns it.

The health check keeps the JAX package's failure taxonomy: len_mismatch,
nan_or_inf_in_ema, ema_zero_norm, model_zero_norm, large_rel_diff, ok.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from ..ops import fused_update

__all__ = ["ema_init", "ema_update", "ema_health", "ema_reinit_from_params"]

Params = Mapping[str, torch.Tensor]


def ema_init(params: Params) -> Dict[str, torch.Tensor]:
    """The shadow starts as a copy of the params (a real copy, detached)."""
    return {k: p.detach().clone() for k, p in params.items()}


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor], params: Params,
               decay) -> Dict[str, torch.Tensor]:
    """shadow <- decay * shadow + (1 - decay) * params, in float32 (decay
    and 1 - decay rounded to float32 as the JAX update has them), in place.
    Returns ``ema_params``."""
    if list(ema_params) != list(params):
        raise ValueError("EMA shadow and params hold different names")
    shadow = list(ema_params.values())
    if any(e.dtype != torch.float32 for e in shadow):
        raise TypeError("the EMA shadow must be float32")
    fused_update.ema_lerp_(shadow, [p.detach() for p in params.values()], decay)
    return ema_params


def _global_norm(tensors) -> float:
    tensors = list(tensors)
    if not tensors:
        return 0.0
    return float(torch.sqrt(sum(t.detach().float().square().sum() for t in tensors)))


@torch.no_grad()
def ema_health(ema_params: Params, params: Params, rel_tol: float = 5.0
               ) -> Tuple[bool, str, float]:
    """(ok, reason, rel_diff) with the JAX package's failure taxonomy."""
    e_list, m_list = list(ema_params.values()), list(params.values())
    if len(e_list) != len(m_list) or any(e.shape != m.shape
                                         for e, m in zip(e_list, m_list)):
        return False, "len_mismatch", float("inf")
    if not all(bool(torch.isfinite(e).all()) for e in e_list):
        return False, "nan_or_inf_in_ema", float("inf")
    e_norm, m_norm = _global_norm(e_list), _global_norm(m_list)
    if e_norm < 1e-12:
        return False, "ema_zero_norm", float("inf")
    if m_norm < 1e-12:
        return False, "model_zero_norm", float("inf")
    rel = _global_norm(m.float() - e.float() for e, m in zip(e_list, m_list)) / (m_norm + 1e-8)
    if rel > rel_tol:
        return False, "large_rel_diff", rel
    return True, "ok", rel


def ema_reinit_from_params(params: Params) -> Dict[str, torch.Tensor]:
    """Repair: restart the shadow from the current params (a copy)."""
    return ema_init(params)
