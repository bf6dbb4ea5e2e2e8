"""A configuration that brings its own reference module, work counts and
class labels as new files and entries only: a tiny class-conditional DiT
(10 classes, a tenth of the labels dropped) beside the benchmark in a
temporary copy, driven through the command's own code on the CPU.  The
program reads correct, and the control and every fault, the dropped
labels' among them, read not correct."""

import contextlib
import io
import json
import shutil
import types

import pytest

from portbench.harness.cli import _Ctx, main
from portbench.harness.spec import BENCH_DIR, ROOT, Spec

WORKLOAD = "train.dit_cond10.b16"
#: the new reference module: the DiT reference, with counts of its own
REFERENCE = '''"""A class-conditional DiT checked against the DiT reference."""

from .dit import DiTRef

MODEL = DiTRef


def fwd_flops(m, batch):
    return 1000 * batch


def attn_calls(m, batch):
    return [(batch * m["num_heads"], 16, m["hidden_size"] // m["num_heads"])] * m["depth"]


def gn_calls(m, batch):
    return []
'''
MODEL = dict(img_resolution=16, hidden_size=32, depth=2, num_heads=2, time_embed_dim=32,
             num_classes=10)
MIX = {"kind": "train_epoch", "batch": 16, "corpus_images": 64, "warmup_updates": 4,
       "checked_updates": 3, "trace_warmup": 1, "trace_updates": 2, "reference_row_block": 0}
#: at this size, between the program's largest reading over seeds 1-12 and
#: 2718281828459 (loss 2.1e-4, grad 2.2e-3, update 2.5e-3) and the
#: control's smallest over seeds 1-6 (1.7e-3, 2.1e-2, 1.0e-2); ema_gap as
#: the other tiny cells have it (the program reads 1.9e-3)
LIMITS = {"loss_gap": 8e-4, "grad_gap": 8e-3, "update_gap": 6e-3, "ema_gap": 0.1}


@pytest.fixture(scope="module")
def cond(tmp_path_factory):
    """The benchmark copied whole, plus the new configuration's files and
    entries."""
    root = tmp_path_factory.mktemp("cond")
    bench = root / "portbench"
    for d in ("metrics", "limits", "configs", "mixes", "reference"):
        shutil.copytree(BENCH_DIR / d, bench / d)
    (bench / "reference" / "dit_cond.py").write_text(REFERENCE)
    cfg = json.loads((BENCH_DIR / "configs" / "dit_s4_256.json").read_text())
    cfg["reference"] = "dit_cond"
    cfg["experiment"]["model"].update(MODEL)
    cfg["experiment"]["train"]["cond_dropout"] = 0.1
    cfg["experiment"]["diffusion"]["img_size"] = cfg["experiment"]["img_size"] = 16
    (bench / "configs" / "dit_cond10.json").write_text(json.dumps(cfg))
    (bench / "mixes" / "train_cond_b16.json").write_text(json.dumps(MIX))
    (bench / "limits" / f"{WORKLOAD}.json").write_text(json.dumps({"limits": LIMITS}))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "dit_cond10", "source": "https://arxiv.org/abs/2212.09748",
                            "file": "portbench/configs/dit_cond10.json", "reduced": [],
                            "why": "class-conditional"})
    data["workloads"].append({"name": WORKLOAD, "config": "dit_cond10",
                              "traffic": "train_cond_b16", "chips": 1, "why": "labels"})
    for m in data["end_to_end"]:
        if m["name"] in ("train_images_per_s", "peak_mem_gib"):
            m["workloads"].append(WORKLOAD)
    data["per_layer"].append({"name": "mfu.train_cond", "unit": "%", "better": "higher",
                              "source": "host_clock", "layer": "the whole step",
                              "moves": "train_images_per_s", "workloads": [WORKLOAD]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    return Spec(root, bench)


MODES = [("program", True), ("control", False), ("fault:frozen", False),
         ("fault:half_batch", False), ("fault:ema_decay0", False), ("fault:null_labels", False)]


@pytest.mark.parametrize("mode, correct", MODES, ids=[m for m, _ in MODES])
def test_correct(cond, mode, correct):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--workload", WORKLOAD, "--seed", "2718281828459", "--seconds", "1.5",
                   "--trace", "0"], spec=cond, device="cpu", mode=mode)
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is correct, res["checks"]
    assert set(res["checks"]) >= set(LIMITS)


def test_the_readers_take_the_configurations_counts(cond):
    cfg = cond.config("dit_cond10")
    rc = types.SimpleNamespace(config=cfg, mix=MIX, chips=1,
                               reference=cond.reference(cfg["reference"]))
    layer = {"window_updates": 2, "window_s": 1.0, "batch": 16}
    ctx = _Ctx(rc, types.SimpleNamespace(trace=None, layer=layer))
    assert ctx.work.train_step_flops(ctx.model, 16) == 3 * 1000 * 16
    assert ctx.work.attn_calls(ctx.model, 16) == [(32, 16, 16)] * 2
    mfu = cond.reader("mfu.train_cond").read(ctx)
    assert mfu == pytest.approx(100.0 * 3 * 1000 * 16 * 2 / 989e12)
