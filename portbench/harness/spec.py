"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file
``configs/<config>.json`` holds the experiment as the port runs it, and a
traffic mix, whose file ``mixes/<traffic>.json`` holds the parameters its
``kind``'s driver (``harness/<kind>.py``) reads.  A per-layer metric
``<name>`` is read by ``metrics/<name>.py``, or by the reader whose name
begins its own (``mfu.train`` reads ``mfu.train_256`` too): its ``SPANS``
(the port's functions the traced slice wraps) and ``read(ctx)`` (the
value, or None where the slice holds nothing to read).  An end-to-end
metric is the driver's value of its name, or of the name it begins with
(``train_images_per_s`` for ``train_images_per_s_256``).  A cell's limits for ``correct``
are ``limits/<workload>.json``.  A configuration's ``reference`` names the
module ``reference/<reference>.py``: its plain model ``MODEL`` and, where
it defines them, its own work counts (``harness/work.py``).  Adding any of
them takes new files and entries only.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional

__all__ = ["Spec", "BENCH_DIR", "ROOT"]

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class Spec:
    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root, self.dir = Path(root), Path(bench_dir)
        with open(self.root / "BENCHMARK.json") as f:
            self.data = json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in self.data['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, traffic: str) -> dict:
        with open(self.dir / "mixes" / f"{traffic}.json") as f:
            return json.load(f)

    def limits(self, workload: str) -> Dict[str, float]:
        path = self.dir / "limits" / f"{workload}.json"
        with open(path) as f:
            return {k: float(v) for k, v in json.load(f)["limits"].items()}

    def end_to_end(self, workload: str) -> List[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.data["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]

    def per_layer(self, workload: str) -> List[dict]:
        """The per-layer metrics this cell reports: those listing it, and
        those listing no cells whose ``moves`` the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    @staticmethod
    def base(name: str, have: Iterable[str]) -> Optional[str]:
        """``name`` if ``have`` holds it, else the longest of ``have`` that
        begins ``name`` and ends where it goes on with ``.`` or ``_``
        (``mfu.train`` for ``mfu.train_256``); None where none does."""
        have = list(have)
        if name in have:
            return name
        found = [h for h in have if name.startswith(h) and name[len(h)] in "._"]
        return max(found, key=len) if found else None

    def reader(self, metric: str):
        """The module ``metrics/<metric>.py``, or the reader its name
        begins with (:meth:`base`): a metric of the same quantity in other
        cells takes the same reader."""
        stem = self.base(metric, (p.stem for p in (self.dir / "metrics").glob("*.py")))
        if stem is None:
            raise KeyError(f"no reader in {self.dir / 'metrics'} for {metric!r}")
        path = self.dir / "metrics" / f"{stem}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reference(self, name: str):
        """The module ``reference/<name>.py``, loaded from its file as a
        module of ``portbench.reference`` (so it may import its siblings
        relatively): ``MODEL``, built as ``MODEL(model_cfg, precision)``,
        and the counts ``fwd_flops``, ``attn_calls`` and ``gn_calls`` where
        it defines them."""
        path = self.dir / "reference" / f"{name}.py"
        if not name.isidentifier() or not path.is_file():
            raise FileNotFoundError(f"no reference module {path} for reference {name!r}")
        spec = importlib.util.spec_from_file_location(f"portbench.reference.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if not hasattr(mod, "MODEL"):
            raise AttributeError(f"the reference module {path} defines no MODEL")
        return mod

    def driver(self, kind: str):
        """The traffic driver ``harness/<kind>.py``."""
        if not kind.replace("_", "").isalnum():
            raise ValueError(f"bad mix kind {kind!r}")
        return importlib.import_module(f"portbench.harness.{kind}")
