"""Everything a run makes from ``--seed``: the sub-seeds, the weights, the
image corpus and its class labels.

The weights are the benchmark's, not an initializer of the program's: one
standard-normal draw over every parameter element from a generator on the
card, then per leaf a matrix or conv kernel scaled to std 1/sqrt(fan-in), a
norm's scale 1 + 0.1 z and every other vector 0.1 z.  So the zero-started
heads of a fresh model (adaLN-Zero, the output projection) carry weight,
and the check sees every layer.  The same seed gives the same tensors to the
program and to the reference, by parameter name.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["sub_seeds", "make_weights", "make_corpus", "make_labels"]

_STREAMS = ("weights", "corpus", "step", "loader", "traffic", "sample")


def sub_seeds(seed: int) -> Dict[str, int]:
    """Independent 63-bit seeds for each stream of a run, from any whole
    number ``seed`` (negative or past 64 bits included)."""
    words = np.random.SeedSequence(abs(int(seed)) * 2 + (seed < 0)).generate_state(
        2 * len(_STREAMS), dtype=np.uint32)
    return {name: int((int(words[2 * i]) << 31) ^ int(words[2 * i + 1]))
            for i, name in enumerate(_STREAMS)}


@torch.no_grad()
def make_weights(specs: Sequence[Tuple[str, Sequence[int]]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor for each ``(name, shape)``, in one draw."""
    sizes = [int(np.prod(shape)) for _, shape in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for (name, shape), n in zip(specs, sizes):
        w = flat[off:off + n].view(*shape)
        off += n
        if len(shape) >= 2:
            w.mul_(float(np.prod(shape[1:])) ** -0.5)
        elif name.endswith("weight"):
            w.mul_(0.1).add_(1.0)
        else:
            w.mul_(0.1)
        out[name] = w
    return out


def make_corpus(n: int, hw: int, channels: int, seed: int, device) -> np.ndarray:
    """``n`` uint8 images (n, hw, hw, channels), drawn on the card in one
    call and brought to the host, where the loader takes its corpus."""
    gen = torch.Generator(device=device).manual_seed(seed)
    codes = torch.randint(0, 256, (n, hw, hw, channels), generator=gen, device=device,
                          dtype=torch.uint8)
    host = codes.cpu().numpy()
    del codes
    return host


def make_labels(n: int, num_classes: int, seed: int, device) -> np.ndarray:
    """``n`` int32 class labels, uniform in [0, num_classes), drawn on the
    card in one call and brought to the host beside the corpus."""
    gen = torch.Generator(device=device).manual_seed(seed)
    labels = torch.randint(0, num_classes, (n,), generator=gen, device=device,
                           dtype=torch.int32)
    return labels.cpu().numpy()


def param_specs(model: torch.nn.Module) -> List[Tuple[str, Tuple[int, ...]]]:
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]
