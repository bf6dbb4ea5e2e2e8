"""What every driver shares: the run's context, the set-up clock, the
program's objects built from a configuration, the reference's precision
switch and the release of the program's memory before the reference runs."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time
from typing import Dict, List, Set

import torch

from . import seeded

__all__ = ["RunContext", "SetupClock", "Outcome", "exact_fp32", "free_device",
           "build_program", "reference_model", "log"]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class SetupClock:
    """Seconds since the process started, and the set-up's parts.  A part
    named in ``apart`` is printed but not counted in the set-up's seconds:
    the kernels' one ``nvcc`` build in a checkout, which later runs load."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.parts: Dict[str, float] = {}
        self.apart: Set[str] = set()

    @contextlib.contextmanager
    def part(self, name: str):
        s = time.perf_counter()
        try:
            yield
        finally:
            self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - s

    def done(self) -> float:
        """The set-up's seconds: the first timed step starts now."""
        return time.perf_counter() - self.t0 - sum(self.parts[k] for k in self.apart)


@dataclasses.dataclass
class RunContext:
    config: dict           # the configuration file, as the JSON holds it
    mix: dict              # the traffic mix, as the JSON holds it
    seed: int
    seconds: float
    trace: bool
    spans: List[str]       # the spans the cell's per-layer metrics read
    chips: int
    clock: SetupClock
    device: torch.device
    mode: str = "program"  # "program", "control" (fp8 reference) or "fault:<name>"
    reference: object = None  # the configuration's reference module (Spec.reference)


@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    numbers: Dict[str, float]
    peak_bytes: int
    trace: object = None           # trace.Trace of the slice, with --trace 1
    layer: Dict[str, object] = dataclasses.field(default_factory=dict)


@contextlib.contextmanager
def exact_fp32():
    """float32 products in float32 (no TF32) while the reference runs."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def build_program(rc: RunContext):
    """The port's experiment, model (with the benchmark's weights) and
    schedule for ``rc``'s configuration, the kernels built or loaded (a
    build, which only a checkout's first run makes, is kept out of the
    set-up's seconds and printed as the part ``kernel_build``)."""
    with rc.clock.part("import"):
        from ddpm_diffusion_model_tpu_torch.training.restore import build_model
        from ddpm_diffusion_model_tpu_torch.utils.config import ExperimentConfig
    if rc.device.type == "cuda":
        from ddpm_diffusion_model_tpu_torch.ops import cuda_build

        started = time.time()
        with rc.clock.part("kernels"):
            built = cuda_build.build_all()
        if any(p.stat().st_mtime >= started for p in built.values()):
            rc.clock.parts["kernel_build"] = rc.clock.parts.pop("kernels")
            rc.clock.apart.add("kernel_build")
    exp = ExperimentConfig.from_dict(rc.config["experiment"])
    with rc.clock.part("model"):
        model, sched = build_model(exp, rc.device)
    with rc.clock.part("weights"):
        specs = sorted(seeded.param_specs(model))
        w = seeded.make_weights(specs, seeded.sub_seeds(rc.seed)["weights"], rc.device)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(w[name])
        del w
    return exp, model, sched


def reference_model(rc: RunContext, precision) -> torch.nn.Module:
    """The configuration's plain float32 model, its reference module's
    ``MODEL``, with the weights of the run's seed set by the caller
    (:func:`load_reference_weights`)."""
    with torch.device(rc.device):
        return rc.reference.MODEL(rc.config["experiment"]["model"], precision)


@torch.no_grad()
def load_reference_weights(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Set ``model``'s parameters to the run's weights; returns a copy of
    them (the starting point the updates are measured from)."""
    specs = sorted(seeded.param_specs(model))
    w = seeded.make_weights(specs, seeded.sub_seeds(seed)["weights"], device)
    for name, p in model.named_parameters():
        p.copy_(w[name])
    return {k: v.clone() for k, v in w.items()}
