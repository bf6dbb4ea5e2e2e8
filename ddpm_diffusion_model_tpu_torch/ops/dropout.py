"""Dropout of the ResBlocks: packed (8 random bits per element) and exact.

Counterpart of ``ddpm_diffusion_model_tpu/ops/dropout.py`` (``"packed"``,
the default) and of flax ``nn.Dropout`` (``"flax"``, exact Bernoulli):

- packed: uint8 bits, drop iff ``bits < t`` with ``t = min(round(rate *
  256), 255)``, survivors scaled by ``1 / (1 - t/256)``.  The scale is cast
  to ``x.dtype`` before the multiply, as the JAX op does (in bf16 at rate
  0.1 it is 1.109375, not 256/230), so the same bits give the same result.
- flax: keep with probability ``1 - rate``, survivors ``x / (1 - rate)``.

Random bits come from an explicit ``torch.Generator`` (``None`` takes
torch's default generator of the tensor's device).  They never equal
JAX's: :func:`packed_dropout_bits` takes the bits as an argument, so a test
can feed the bits ``jax.random.bits`` drew.

:func:`dropout_replayed` is the ResBlock's dropout under ``remat="masks"``
(the JAX policy that saves everything but the named dropout bits): it
saves the generator's state, a few bytes, in place of the mask, and
draws the same bits again in the backward.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["packed_dropout", "packed_dropout_bits", "flax_dropout", "dropout",
           "dropout_replayed"]


def _threshold(rate: float) -> int:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return min(int(round(rate * 256.0)), 255)


def _packed_scale(rate: float, dtype: torch.dtype) -> float:
    """The survivors' scale ``1 / (1 - t/256)``, rounded to ``dtype``."""
    return float(torch.tensor(1.0 / (1.0 - _threshold(rate) / 256.0), dtype=dtype))


def _bits(like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """uint8 bits in ``like``'s shape and memory layout."""
    return torch.empty_like(like, dtype=torch.uint8).random_(0, 256, generator=generator)


def _uniform(like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """float32 U[0, 1) in ``like``'s shape and memory layout."""
    return torch.empty_like(like, dtype=torch.float32).uniform_(generator=generator)


def packed_dropout_bits(x: torch.Tensor, rate: float, bits: torch.Tensor
                        ) -> torch.Tensor:
    """Packed dropout of ``x`` with the given uint8 ``bits`` (same shape):
    ``where(bits >= t, x * scale, 0)`` with ``scale`` in ``x.dtype``."""
    t = _threshold(rate)
    if t == 0:
        return x
    if bits.dtype != torch.uint8 or bits.shape != x.shape:
        raise ValueError(f"bits must be uint8 of shape {tuple(x.shape)}, got "
                         f"{bits.dtype} {tuple(bits.shape)}")
    scale = _packed_scale(rate, x.dtype)
    return torch.where(bits >= t, x * scale, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


def packed_dropout(x: torch.Tensor, rate: float,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Packed dropout with bits drawn from ``generator``, in ``x``'s memory
    layout.  Identity (no bits drawn) when the quantized rate is 0."""
    if _threshold(rate) == 0:
        return x
    return packed_dropout_bits(x, rate, _bits(x, generator))


def flax_dropout(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Exact-Bernoulli dropout (flax ``nn.Dropout``): keep with probability
    ``1 - rate``, survivors ``x / (1 - rate)``."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    u = _uniform(x, generator)
    return torch.where(u < keep_prob, x / keep_prob,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, impl: str = "packed",
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The ResBlock's dropout by ``impl``: ``"packed"`` or ``"flax"``."""
    if impl == "packed":
        return packed_dropout(x, rate, generator)
    if impl == "flax":
        return flax_dropout(x, rate, generator)
    raise ValueError(f"unknown dropout_impl {impl!r} (packed or flax)")


def _default_generator(device: torch.device) -> torch.Generator:
    if device.type == "cuda":
        return torch.cuda.default_generators[
            device.index if device.index is not None else torch.cuda.current_device()]
    return torch.default_generator


class _ReplayedDropout(torch.autograd.Function):
    """Dropout whose backward draws the forward's bits again from the
    generator state saved before the draw, so no mask is kept."""

    @staticmethod
    def forward(ctx, x, rate, impl, generator):
        ctx.gen_state = generator.get_state()
        ctx.gen_device = generator.device
        ctx.layout = (x.shape, x.stride(), x.device)
        ctx.rate, ctx.impl = rate, impl
        return dropout(x, rate, impl, generator)

    @staticmethod
    def backward(ctx, dy):
        shape, stride, device = ctx.layout
        gen = torch.Generator(device=ctx.gen_device)
        gen.set_state(ctx.gen_state)
        like = torch.empty_strided(shape, stride, dtype=dy.dtype, device=device)
        zero = torch.zeros((), dtype=dy.dtype, device=device)
        # the ops autograd takes through the plain forward: where, then
        # the scale, so the gradient is bit-equal to it
        if ctx.impl == "packed":
            keep = _bits(like, gen) >= _threshold(ctx.rate)
            dx = torch.where(keep, dy, zero) * _packed_scale(ctx.rate, dy.dtype)
        else:
            keep_prob = 1.0 - ctx.rate
            dx = torch.where(_uniform(like, gen) < keep_prob, dy, zero) / keep_prob
        return dx, None, None, None


def dropout_replayed(x: torch.Tensor, rate: float, impl: str = "packed",
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """:func:`dropout`, same output and same draws from ``generator``, but
    the backward regenerates the mask from the generator's saved state
    instead of keeping it (``remat="masks"``).  Identity where the rate
    draws no bits."""
    if impl not in ("packed", "flax"):
        raise ValueError(f"unknown dropout_impl {impl!r} (packed or flax)")
    if (_threshold(rate) == 0 if impl == "packed" else rate == 0.0):
        return x
    gen = generator if generator is not None else _default_generator(x.device)
    return _ReplayedDropout.apply(x, rate, impl, gen)
