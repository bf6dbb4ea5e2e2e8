"""One run of one cell: ``python3 portbench/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>``.

The run looks for the cards the cell asks for (and exits 2 with no result
without them), builds the cell's traffic driver from ``BENCHMARK.json``,
runs its set-up, window and check, and prints, as the last line of its
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each number compared, with its limit).
The set-up's parts go to standard error first, the checks last.  A run
that finds JAX or the JAX package loaded once the window has closed exits
3 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from typing import Dict, Optional

from . import guard
from .runtime import RunContext, SetupClock, log
from .spec import Spec

__all__ = ["main", "run_cell"]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def _finite(v):
    return v if (v is None or math.isfinite(v)) else None


def run_cell(spec: Spec, workload: str, seed: int, seconds: float, trace: bool, t0: float,
             device=None, mode: str = "program"):
    """Run one cell in this process; returns (outcome, the cell, the
    per-layer metric entries)."""
    import torch

    cell = spec.workload(workload)
    config = spec.config(cell["config"])
    mix = spec.mix(cell["traffic"])
    layers = spec.per_layer(workload) if trace else []
    readers = {m["name"]: spec.reader(m["name"]) for m in layers}
    span_names = sorted({s for r in readers.values() for s in getattr(r, "SPANS", ())})
    clock = SetupClock(t0)
    clock.parts["start"] = time.perf_counter() - t0  # interpreter, torch, the card's driver
    rc = RunContext(config=config, mix=mix, seed=seed, seconds=seconds,
                    trace=trace, spans=span_names, chips=int(cell["chips"]),
                    clock=clock, device=torch.device(device or "cuda"), mode=mode,
                    reference=spec.reference(config["reference"]))
    out = spec.driver(mix["kind"]).run(rc)
    values = {}
    for m in layers:
        ctx = _Ctx(rc, out)
        v = readers[m["name"]].read(ctx)
        if v is not None:
            values[m["name"]] = float(v)
    return out, cell, rc, values


class _Ctx:
    """What a per-layer reader sees: the configuration, the mix, the
    work arithmetic with the configuration's own counts, the traced slice
    and the window's counts."""

    def __init__(self, rc: RunContext, out):
        from . import work

        self.model = rc.config["experiment"]["model"]
        self.mix, self.chips = rc.mix, rc.chips
        self.work = work.with_counts(rc.reference)
        self.trace, self.layer = out.trace, out.layer


def main(argv=None, t0: float = 0.0, spec: Optional[Spec] = None,
         device: Optional[str] = None, mode: str = "program") -> int:
    """The command.  ``device`` other than None skips the look for cards
    and runs there, and ``mode`` puts the control or a fault in the
    program's place (the tests drive a CPU run so)."""
    args = _parser().parse_args(argv)
    spec = spec or Spec()
    cell = spec.workload(args.workload)
    chips = int(cell["chips"])
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"[portbench] {args.workload} needs {chips} CUDA card(s); "
                f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
    found = guard.forbidden_modules()
    if found:
        log(f"[portbench] JAX modules loaded before the run: {found}")
        return 3
    out, cell, rc, layer_values = run_cell(
        spec, args.workload, args.seed, args.seconds, bool(args.trace), t0,
        device=device, mode=mode)
    found = guard.forbidden_modules()
    if found:
        log(f"[portbench] JAX modules loaded by the run: {found}")
        return 3
    if device is None:
        log(f"[portbench] card: {_power_limit()}; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")
    from .checks import verdict

    limits = spec.limits(args.workload)
    ok, checks = verdict(out.numbers, limits)
    correct = ok and out.failed == 0 and out.attempted > 0
    log("[setup] " + ", ".join(f"{k} {v:.3f} s" + (" (not in setup_s)" if k in rc.clock.apart
                                                     else "")
                               for k, v in rc.clock.parts.items())
        + f"; setup_s {out.e2e.get('setup_s', math.nan):.3f}")
    units = {m["name"]: m["unit"] for m in spec.data["end_to_end"] + spec.data["per_layer"]}
    if args.trace:
        metrics = {k: {"value": v, "unit": units[k]} for k, v in layer_values.items()}
    else:
        metrics = {}
        for m in spec.end_to_end(args.workload):
            key = spec.base(m["name"], out.e2e)
            if key is None:
                if mode != "program":  # the control runs no window
                    continue
                log(f"[portbench] the driver measured no {m['name']}")
                return 4
            metrics[m["name"]] = {"value": _finite(out.e2e[key]), "unit": m["unit"]}
    device = {"platform": "gpu" if rc.device.type == "cuda" else rc.device.type,
              "kind": torch.cuda.get_device_name(0) if rc.device.type == "cuda" else "cpu",
              "count": chips, "memory_peak_bytes": int(out.peak_bytes)}
    result: Dict[str, object] = {"correct": bool(correct), "attempted": int(out.attempted),
                                 "failed": int(out.failed), "metrics": metrics,
                                 "device": device}
    if args.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        result["breakdown"] = {"device_ops": out.trace.top_ops(10),
                               "idle_gaps": out.trace.idle_gaps(10)}
    result["checks"] = {k: {"value": _finite(c["value"]) if c["value"] is not None else None,
                            "limit": c["limit"]} for k, c in checks.items()}
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    for k, c in checks.items():
        log(f"[check] {k} {c['value']!r} limit {c['limit']!r}")
    log(f"[check] correct {bool(correct)} (attempted {out.attempted}, failed {out.failed})")
    return 0
