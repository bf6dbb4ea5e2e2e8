"""On a card: one short run of each cell through the command's own code,
traced, correct, with every metric the cell lists (skips without a card)."""

import contextlib
import io
import json
import time

import pytest

from portbench.harness.cli import main
from portbench.harness.spec import Spec

SPEC = Spec()
CELLS = [w["name"] for w in SPEC.data["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_a_short_run(card, workload, traced):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--workload", workload, "--seed", "987654321987", "--seconds", "3",
                   "--trace", str(traced)], t0=time.perf_counter())
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    want = (SPEC.per_layer(workload) if traced else SPEC.end_to_end(workload))
    assert {m["name"] for m in want} <= set(res["metrics"]), res["metrics"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if traced:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"] * 1.05
        assert len(res["breakdown"]["device_ops"]) <= 10
