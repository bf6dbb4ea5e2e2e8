"""The benchmark's copy of the work arithmetic equals the program's
``utils/flops.py`` and ``chip_smoke.py``'s functions, for every
configuration the benchmark and the port's presets hold."""

import importlib.util
import json
import types

import pytest

from portbench.harness import work
from portbench.harness.spec import BENCH_DIR, ROOT

flops = pytest.importorskip("ddpm_diffusion_model_tpu_torch.utils.flops")
from ddpm_diffusion_model_tpu_torch.utils.config import PRESETS, get_preset  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke_copy", ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

BENCH_CONFIGS = sorted(p.stem for p in (BENCH_DIR / "configs").glob("*.json"))


def _bench_model(name):
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())["experiment"]["model"]


def _port_config(model_dict):
    from ddpm_diffusion_model_tpu_torch.utils.config import ExperimentConfig

    return ExperimentConfig.from_dict({**get_preset("celeba64_attn").to_dict(),
                                       "model": model_dict}).model


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("batch", [1, 7, 128])
def test_flops_equal_the_programs_for_every_preset(preset, batch):
    cfg = get_preset(preset).model
    m = cfg.to_dict()
    assert work.fwd_flops(m, batch) == flops.fwd_flops(cfg, batch)
    assert work.train_step_flops(m, batch) == flops.train_step_flops(cfg, batch)


@pytest.mark.parametrize("name", BENCH_CONFIGS)
def test_flops_equal_the_programs_for_the_benchmarks_configs(name):
    m = _bench_model(name)
    assert work.fwd_flops(m, 64) == flops.fwd_flops(_port_config(m), 64)


@pytest.mark.parametrize("shape, tb", [((128, 64, 64, 128), True), ((16, 8, 8, 256), False),
                                       ((3, 5, 7, 96), True)])
def test_gn_arithmetic_equals_chip_smoke(shape, tb):
    assert work.gn_bytes_flops(shape, 2, tb) == smoke.gn_bytes_flops(shape, 2, tb)
    for dtb in (False, True):
        assert (work.gn_bwd_bytes_flops(shape, 2, tb, dtb)
                == smoke.gn_bwd_bytes_flops(shape, 2, tb, dtb))


@pytest.mark.parametrize("shape", [(512, 256, 64), (384, 4096, 64), (3, 100, 40)])
def test_flash_arithmetic_and_bounds_equal_chip_smoke(shape):
    smoke.PEAK_FLOPS["bfloat16"] = work.PEAK_FLOPS["bfloat16"]
    for mine, theirs in ((work.flash_bytes_flops, smoke.flash_bytes_flops),
                         (work.flash_dq_bytes_flops, smoke.flash_dq_bytes_flops),
                         (work.flash_dkv_bytes_flops, smoke.flash_dkv_bytes_flops)):
        assert mine(shape, 2) == theirs(shape, 2)
        b, f = mine(shape, 2)
        assert work.bound_s(b, f) == pytest.approx(smoke.bounds(b, f, "bfloat16")["bound_ms"] / 1e3)
    assert work.HBM_BYTES_PER_S == smoke.HBM_BYTES_PER_S


def test_call_lists_match_the_models_launches():
    """45 GN+SiLU calls (22 with the time bias) and 5 attentions (2 at N =
    256, 3 at N = 64) a celeba64_attn forward; 12 at N = 4096 a DiT-S/4."""
    m = _bench_model("celeba64_attn")
    calls = work.gn_calls(m, 128)
    assert len(calls) == smoke.GN_LAUNCHES_PER_FORWARD
    assert sum(tb for _, tb in calls) == smoke.GN_DTB_LAUNCHES_PER_STEP
    assert sorted(n for _, n, _ in work.attn_calls(m, 2)) == [64, 64, 64, 256, 256]
    assert work.attn_calls(_bench_model("dit_s4_256"), 64) == [(384, 4096, 64)] * 12
    assert work.gn_calls(_bench_model("dit_s4_256"), 64) == []



#: the cells' counts at their own batches, as the family functions gave them
#: before a reference module could bring its own: (fwd_flops, attention
#: calls, GN calls, flash_bound_s with and without the backward,
#: gn_bound_s likewise)
COUNTS = {"celeba64_attn": (128, 5127100432384, 5, 45, 0.0002087370507462687,
                            5.551975164179104e-05, 0.00403771575402985,
                            0.0016142660011940302),
          "dit_s4_256": (64, 30944520044544, 12, 0, 0.09005100288155309,
                         0.020011333973678463, 0.0, 0.0)}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_a_reference_without_counts_keeps_the_family_counts(name):
    """The counts a per-layer reader gets for each configuration of the
    benchmark (its reference module defines none) are those it had."""
    from portbench.harness.spec import Spec

    spec = Spec()
    cfg = spec.config(name)
    ref = spec.reference(cfg["reference"])
    assert not any(hasattr(ref, k) for k in ("fwd_flops", "attn_calls", "gn_calls"))
    w, m = work.with_counts(ref), cfg["experiment"]["model"]
    B, fwd, n_attn, n_gn, fb, ff, gb, gf = COUNTS[name]
    assert w.fwd_flops(m, B) == fwd and w.train_step_flops(m, B) == 3 * fwd
    assert w.attn_calls(m, B) == work.attn_calls(m, B) and len(w.attn_calls(m, B)) == n_attn
    assert w.gn_calls(m, B) == work.gn_calls(m, B) and len(w.gn_calls(m, B)) == n_gn
    assert (w.flash_bound_s(m, B, backward=True), w.flash_bound_s(m, B, False)) == (fb, ff)
    assert (w.gn_bound_s(m, B, backward=True), w.gn_bound_s(m, B, False)) == (gb, gf)
    assert w.PEAK_FLOPS is work.PEAK_FLOPS and w.flash_bytes_flops is work.flash_bytes_flops


def test_a_reference_modules_own_counts_are_taken():
    own = types.SimpleNamespace(fwd_flops=lambda m, b: 7 * b,
                                attn_calls=lambda m, b: [(b, 256, 72)],
                                gn_calls=lambda m, b: [((b, 8, 8, 32), True)])
    w, m = work.with_counts(own), _bench_model("dit_s4_256")
    assert w.fwd_flops(m, 4) == 28 and w.train_step_flops(m, 4) == 84
    assert w.flash_bound_s(m, 4, backward=True) == sum(
        work.bound_s(*f((4, 256, 72), 2)) for f in (work.flash_bytes_flops,
                                                   work.flash_dq_bytes_flops,
                                                   work.flash_dkv_bytes_flops))
    assert w.gn_bound_s(m, 4, backward=False) == work.bound_s(
        *work.gn_bytes_flops((4, 8, 8, 32), 2, True))
    assert work.fwd_flops(m, 4) == work.dit_fwd_flops(m, 4)
