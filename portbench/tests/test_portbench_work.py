"""The benchmark's copy of the work arithmetic equals the program's
``utils/flops.py`` and ``chip_smoke.py``'s functions, for every
configuration the benchmark and the port's presets hold."""

import importlib.util
import json

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

