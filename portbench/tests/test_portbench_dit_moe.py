"""The DiT-MoE configuration (``dit_moe_xl2_8e2a``: the dropless top-2
SwiGLU experts with a shared expert and the balance loss summed over the
blocks) at a tiny size on the CPU, in a temporary copy of the benchmark
with the configuration cut to a CPU's widths and its mix to a few rows:
the program reads correct, and the control (the reference in fp8) and
every fault, the dropped labels' among them, read not correct.  The
reference's work counts at the published widths match counts by hand."""

import contextlib
import io
import json
import shutil
import types

import pytest

from portbench.harness.cli import _Ctx, main
from portbench.harness.spec import BENCH_DIR, ROOT, Spec

WORKLOAD = "train.dit_moe_xl2.b128"
CONFIG = "dit_moe_xl2_8e2a"
#: a CPU's size: 8 experts of width 128, 2 a token, a shared one of 64, 16
#: tokens an image
SIZE = dict(img_resolution=8, patch_size=2, hidden_size=32, depth=2, num_heads=2,
            time_embed_dim=32, num_classes=10, shared_expert_dim=64)
MIX = dict(batch=16, corpus_images=64)
#: at this size, between the program's largest reading over seeds 1-12 and
#: 2718281828459 (loss 4.9e-4, grad 2.2e-2 and 7.7e-4 at the median leaf,
#: update 3.7e-4 at the median leaf) and the control's smallest over seeds
#: 1-8 (1.5e-3, 6.4e-2, 1.1e-2, 1.9e-3); the worst leaf's update gap is
#: left out (the program's 1.9e-2 passes the control's 1.2e-2: a token that
#: changes expert between bf16 and float32 moves two experts' few rows
#: here); ema_gap as the other tiny cells have it (the program reads 1.3e-4)
LIMITS = {"loss_gap": 1e-3, "grad_gap": 4e-2, "grad_gap_median": 3e-3,
          "update_gap_median": 1e-3, "ema_gap": 0.1}


def tiny_spec(root):
    """The benchmark copied whole under ``root``, the configuration, its mix
    and its limits cut to :data:`SIZE`, :data:`MIX` and :data:`LIMITS`."""
    bench = root / "portbench"
    for d in ("metrics", "limits", "configs", "mixes", "reference"):
        shutil.copytree(BENCH_DIR / d, bench / d)
    path = bench / "configs" / f"{CONFIG}.json"
    cfg = json.loads(path.read_text())
    cfg["experiment"]["model"].update(SIZE)
    cfg["experiment"]["diffusion"]["img_size"] = cfg["experiment"]["img_size"] = 8
    path.write_text(json.dumps(cfg))
    path = bench / "mixes" / "train_imagenet_latent32_b128.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **MIX}))
    (bench / "limits" / f"{WORKLOAD}.json").write_text(json.dumps({"limits": LIMITS}))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return Spec(root, bench)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_spec(tmp_path_factory.mktemp("dit_moe"))


def run(spec, mode, seed=2718281828459):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--workload", WORKLOAD, "--seed", str(seed), "--seconds", "1",
                   "--trace", "0"], spec=spec, device="cpu", mode=mode)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


MODES = [("program", True), ("control", False), ("fault:frozen", False),
         ("fault:half_batch", False), ("fault:ema_decay0", False), ("fault:null_labels", False)]


@pytest.mark.parametrize("mode, correct", MODES, ids=[m for m, _ in MODES])
def test_correct(tiny, mode, correct):
    res = run(tiny, mode)
    assert res["correct"] is correct, res["checks"]
    assert set(res["checks"]) >= set(LIMITS)


def _published():
    spec = Spec()
    cfg = spec.config(CONFIG)
    return spec, cfg, spec.reference(cfg["reference"])


def test_the_references_counts_match_hand_counts():
    spec, cfg, ref = _published()
    m = cfg["experiment"]["model"]
    assert (m["depth"], m["hidden_size"], m["num_heads"], m["num_experts"]) == (7, 1152, 16, 8)
    N, H, F, Fs, E = 256, 1152, 4608, 2304, 8
    block = (6 * N * H * H + 2 * N * H * H       # qkv, proj
             + 4 * N * N * H                     # QK^T and PV over the heads
             + 2 * N * H * E                     # the gate
             + 2 * (4 * N * H * F + 2 * N * H * F)   # 2 routed rows: gate+up, down
             + 4 * N * H * Fs + 2 * N * H * Fs   # the shared row
             + 2 * H * 6 * H)                    # the adaLN head
    image = 7 * block + 2 * N * 16 * H + 2 * (256 * H + H * H) + 2 * H * 2 * H + 2 * N * H * 16
    assert ref.fwd_flops(m, 1) == image
    assert round(image / 1e9, 1) == 164.0
    assert round(3 * ref.fwd_flops(m, 128) / 1e12, 2) == 62.98
    assert ref.attn_calls(m, 128) == [(128 * 16, 256, 72)] * 7


def test_the_expert_roofline_reads_the_routed_products():
    spec, cfg, ref = _published()
    reader = spec.reader("expert_roofline.train_256")
    m = cfg["experiment"]["model"]
    flops = reader.expert_train_flops(m, 128)
    assert flops == 7 * 18 * 2 * (128 * 256) * 1152 * 4608
    assert round(flops / 1e12, 1) == 43.8
    rc = types.SimpleNamespace(config=cfg, mix=spec.mix("train_imagenet_latent32_b128"),
                               chips=1, reference=ref)
    layer = {"window_updates": 4, "window_s": 2.0, "batch": 128}
    ctx = _Ctx(rc, types.SimpleNamespace(trace=None, layer=layer))
    assert ctx.work.train_step_flops(m, 128) == 3 * ref.fwd_flops(m, 128)
    assert spec.reader("mfu.train_256").read(ctx) == pytest.approx(
        100.0 * 3 * ref.fwd_flops(m, 128) * 4 / (2.0 * 989e12))
    for name in ("expert_roofline.train_256", "expert_device_ms.train_256",
                 "moe_route_fwd_ms.train_256"):
        assert spec.reader(name).read(ctx) is None  # no traced slice: nothing to read


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launched(ts, dur, corr, tid=1):
    """A launch at ``ts`` on thread ``tid`` and its kernel of ``dur`` us."""
    return [_ev("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid, corr=corr),
            _ev("kernel", f"k{corr}", ts + 2, dur, tid=9, corr=corr)]


def test_the_readers_of_the_layers_spans():
    """One update of a synthetic hosted pass: the layer's forward spans on
    the step's thread, the experts' backward span on the autograd engine's;
    each reader sums its spans' kernels per traced update."""
    from portbench.harness.trace import Trace

    spec, cfg, ref = _published()
    events = [_ev("user_annotation", "moe.route", 10, 10),
              _ev("user_annotation", "moe.dispatch", 20, 5),
              _ev("user_annotation", "moe.experts", 25, 20),
              _ev("user_annotation", "moe.shared", 45, 5),
              _ev("user_annotation", "moe.combine", 50, 5),
              _ev("user_annotation", "moe.experts.bwd", 80, 50, tid=2),
              *_launched(11, 4, 1), *_launched(21, 2, 2), *_launched(26, 30, 3),
              *_launched(30, 10, 4), *_launched(46, 7, 5), *_launched(51, 3, 6),
              *_launched(85, 60, 7, tid=2), *_launched(60, 9, 8)]
    trace = Trace(events, window_s=1e-3)
    layer = {"traced_updates": 2, "batch": 128}
    ctx = types.SimpleNamespace(trace=trace, layer=layer, model=cfg["experiment"]["model"],
                                chips=1, work=_Ctx(types.SimpleNamespace(
                                    config=cfg, mix={}, chips=1, reference=ref),
                                    types.SimpleNamespace(trace=None, layer={})).work)
    read = {n: spec.reader(f"{n}.train_256").read(ctx)
            for n in ("expert_device_ms", "moe_route_fwd_ms", "expert_roofline")}
    assert read["expert_device_ms"] == pytest.approx(1e3 * (30 + 10 + 60) * 1e-6 / 2)
    assert read["moe_route_fwd_ms"] == pytest.approx(1e3 * (4 + 2 + 3) * 1e-6 / 2)
    flops = spec.reader("expert_roofline.train_256").expert_train_flops(ctx.model, 128)
    assert read["expert_roofline"] == pytest.approx(100.0 * flops / 989e12 * 2 / 100e-6)
    # a program without the layer's spans, or a model without the dropless layer
    bare = Trace([e for e in events if not e["name"].startswith("moe.")], window_s=1e-3)
    assert all(spec.reader(f"{n}.train_256").read(types.SimpleNamespace(
        **{**vars(ctx), "trace": bare})) is None for n in read)
    dense = dict(ctx.model, moe_router="switch")
    assert spec.reader("expert_roofline.train_256").read(types.SimpleNamespace(
        **{**vars(ctx), "model": dense})) is None
