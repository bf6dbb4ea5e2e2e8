"""The JAX guard: no module of a run may be JAX, its libraries or the JAX
package the port was made from.  Names are compared by their top-level
part (before the first dot) as a whole, so ``ddpm_diffusion_model_tpu_torch``
(the port) passes and ``ddpm_diffusion_model_tpu.ops`` does not."""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

__all__ = ["FORBIDDEN", "forbidden_modules"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ddpm_diffusion_model_tpu"})


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the modules
    this process has loaded)."""
    names = list(sys.modules) if names is None else list(names)
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
