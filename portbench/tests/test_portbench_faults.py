"""The check fails what it must: each run skips the look for a card and
drives the rest of a run of the cell at a tiny size on the CPU, with the
timed path broken underneath or the control (the reference in fp8) in the
program's place, and reads ``correct`` from the result line."""

import contextlib
import io
import json
import shutil

import pytest

from portbench.harness.cli import main
from portbench.harness.spec import BENCH_DIR, ROOT, Spec

SIZES = {
    "celeba64_attn": dict(base_channels=32, channel_mults=[1, 2], attn_resolutions=[8],
                          time_embed_dim=64, num_heads=2, head_dim=16, img_resolution=16),
    "dit_s4_256": dict(img_resolution=16, hidden_size=32, depth=2, num_heads=2,
                       time_embed_dim=32),
}
#: the EMA's gap at these sizes: the program reads at most 6e-3 (seeds 11,
#: 12 and the one below), an EMA update that copies the parameters 1.0
EMA_LIMIT = 0.1
#: limits for the tiny sizes, between the program's readings and the
#: control's there (the cells' own limits are set at their own sizes)
LIMITS = {"train.celeba64_attn.b128": {"loss_gap": 2e-3, "grad_gap": 4e-2, "update_gap": 3e-2,
                                      "ema_gap": EMA_LIMIT},
          "train.dit_s4_256.b64": {"loss_gap": 1e-3, "grad_gap": 1e-2, "update_gap": 6e-3,
                                   "ema_gap": EMA_LIMIT}}
MIXES = {"train_celeba_b128": dict(batch=8, corpus_images=64),
         "train_celebahq_b64": dict(batch=4, corpus_images=32, reference_row_block=2)}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The benchmark with its configurations cut to a CPU's size (widths
    and depth), its mixes to a few rows and its limits to that size."""
    root = tmp_path_factory.mktemp("tiny")
    bench = root / "portbench"
    for d in ("metrics", "limits", "configs", "mixes", "reference"):
        shutil.copytree(BENCH_DIR / d, bench / d)
    for name, upd in SIZES.items():
        path = bench / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["experiment"]["model"].update(upd)
        cfg["experiment"]["diffusion"]["img_size"] = cfg["experiment"]["img_size"] = 16
        path.write_text(json.dumps(cfg))
    for name, upd in MIXES.items():
        path = bench / "mixes" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **upd}))
    for name, lim in LIMITS.items():
        (bench / "limits" / f"{name}.json").write_text(json.dumps({"limits": lim}))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return Spec(root, bench)


def _run(spec, workload, mode):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--workload", workload, "--seed", "2718281828459", "--seconds", "1.5",
                   "--trace", "0"], spec=spec, device="cpu", mode=mode)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


CASES = [(w, mode, mode == "program")
         for w in ("train.celeba64_attn.b128", "train.dit_s4_256.b64")
         for mode in ("program", "control", "fault:frozen", "fault:half_batch",
                      "fault:ema_decay0")]


@pytest.mark.parametrize("workload, mode, correct", CASES, ids=[f"{w}-{m}" for w, m, _ in CASES])
def test_correct(tiny, workload, mode, correct):
    res = _run(tiny, workload, mode)
    assert res["correct"] is correct, res["checks"]
    assert list(res)[-1] == "checks"
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
