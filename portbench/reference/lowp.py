"""The reference's operand rounding: exact float32, or the control's fp8.

Every conv, Linear and attention product of the reference models takes its
two operands through a :class:`Precision`.  ``Precision("fp32")`` leaves
them as they are (the reference); ``Precision("fp8")`` rounds each operand
to float8 e4m3 with a per-tensor scale (amax / 448) before the product and
accumulates in float32, as an fp8 matmul does.  That is the control of
``correct``: the configurations state bf16 compute, and fp8 is the next
precision below it.  The rounding passes the gradient straight through, so
a backward runs its products on the rounded operands autograd saved.
"""

from __future__ import annotations

import torch

__all__ = ["Precision", "FP32", "FP8"]

_E4M3_MAX = 448.0


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax()
        if not torch.isfinite(amax) or float(amax) == 0.0:
            return x.clone()
        scale = amax / _E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, dy):
        return dy


class Precision:
    """How the reference rounds the operands of its products."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {kind!r} (fp32 or fp8)")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.kind == "fp32" else _RoundFp8.apply(x)


FP32 = Precision("fp32")
FP8 = Precision("fp8")
