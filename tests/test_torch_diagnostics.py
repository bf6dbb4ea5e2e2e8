"""The port's last utilities against the JAX package: the FLOP counts
(``utils/flops.py``) for every preset, the finiteness checks and anomaly
mode (``utils/debugging.py``), ``profiler_trace``, the sample statistics
(``utils/sample_metrics.py``) and the parameter table
(``utils/summary.py``); and the public import surface: every public name
of each JAX subpackage ``__init__`` imports from the port's counterpart."""

import ast
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_diffusion_model_tpu.utils import config as jax_config
from ddpm_diffusion_model_tpu.utils import debugging as jax_debugging
from ddpm_diffusion_model_tpu.utils import flops as jax_flops
from ddpm_diffusion_model_tpu.utils import sample_metrics as jax_metrics
from ddpm_diffusion_model_tpu.utils import summary as jax_summary
from ddpm_diffusion_model_tpu_torch.training import profiler_trace
from ddpm_diffusion_model_tpu_torch.utils import (config, debugging, flops, sample_metrics,
                                                  summary)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ------------------------------------------------------------------ flops


@pytest.mark.parametrize("name", sorted(jax_config.PRESETS))
def test_flops_equal_jax_for_every_preset(name):
    assert sorted(set(config.PRESETS) - set(config.PORT_PRESETS)) == sorted(jax_config.PRESETS)
    ours, theirs = config.get_preset(name).model, jax_config.get_preset(name).model
    for batch in (1, 7, 128):
        for fn in ("fwd_flops", "train_step_flops"):
            got, want = getattr(flops, fn)(ours, batch), getattr(jax_flops, fn)(theirs, batch)
            assert type(got) is int and got == want, (fn, batch)
        assert flops.sampling_flops(ours, batch, steps=50) == \
            jax_flops.sampling_flops(theirs, batch, steps=50)
    family = "dit_fwd_flops" if hasattr(ours, "seq_len") else "unet_fwd_flops"
    assert getattr(flops, family)(ours, 3) == getattr(jax_flops, family)(theirs, 3)


def test_mfu_and_the_h100_peak():
    f = flops.train_step_flops(config.get_preset("celeba64_attn").model, 128)
    assert f == 15_381_301_297_152
    for peak in (312.0, 989.0, 197.0):
        assert flops.mfu(f, 0.0612, peak) == jax_flops.mfu(f, 0.0612, peak)
    assert flops.PEAK_TFLOPS == {"h100": 989.0, "a100": 312.0}
    assert flops.mfu(f, 0.0612) == flops.mfu(f, 0.0612, 989.0)  # the port's default


# -------------------------------------------------------------- debugging


def _trees():
    rng = np.random.default_rng(0)
    nan = rng.normal(size=(2, 3)).astype(np.float32)
    nan[1, 2] = np.nan
    return {
        "finite": {"w": rng.normal(size=(3,)), "b": [np.ones(2), (np.zeros(1), None)],
                   "k": 2.0, "i": np.arange(4)},
        "some": {"zeta": nan, "alpha": [np.ones(3), {"inf": np.array(np.inf), "ok": 1.0}],
                 "mid": (np.zeros(2), np.array([-np.inf, 0.0]))},
        "many": [np.full(2, np.nan) for _ in range(12)],
        "leaf": np.array([np.nan]),
        "empty": {},
    }


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree(v) for v in tree)
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


@pytest.mark.parametrize("case", sorted(_trees()))
def test_finiteness_checks_equal_jax(case):
    tree = _trees()[case]
    want = bool(jax_debugging.tree_all_finite(tree))
    for t in (tree, _torch_tree(tree)):
        got = debugging.tree_all_finite(t)
        assert torch.is_tensor(got) and got.dim() == 0 and got.dtype == torch.bool
        assert bool(got) == want
    try:
        jax_debugging.assert_tree_finite(tree, "params")
        jax_msg = None
    except AssertionError as e:
        jax_msg = str(e)
    for t in (tree, _torch_tree(tree)):
        if jax_msg is None:
            debugging.assert_tree_finite(t, "params")
        else:
            with pytest.raises(AssertionError) as e:
                debugging.assert_tree_finite(t, "params")
            assert str(e.value) == jax_msg


def test_nan_debugging_restores_the_previous_mode():
    try:
        for prev in ((False, True), (True, False), (True, True)):
            torch.autograd.set_detect_anomaly(prev[0], check_nan=prev[1])
            with debugging.nan_debugging():
                assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
            assert (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()) == prev
            with pytest.raises(KeyError):
                with debugging.nan_debugging():
                    raise KeyError("inside")
            assert (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()) == prev
        debugging.enable_nan_debugging(True)
        assert torch.is_anomaly_enabled()
        debugging.enable_nan_debugging(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)


def test_anomaly_mode_names_the_gn_kernels_function():
    """A tiny U-Net's loss and backward pass under ``nan_debugging`` with
    finite params and grads; a NaN put into the last GroupNorm's scale
    between the forward and the backward makes that layer's
    ``autograd.Function`` the first backward to return NaN, and the error
    names it."""
    from ddpm_diffusion_model_tpu_torch.models import UNetConfig, UNetDenoiser

    cfg = UNetConfig(in_channels=3, base_channels=16, channel_mults=(1, 2),
                     num_res_blocks=1, attn_resolutions=(8,), time_embed_dim=32,
                     num_heads=2, head_dim=8, img_resolution=16)
    torch.manual_seed(0)
    model = UNetDenoiser(cfg, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 16, 16, 3)).astype(np.float32))
    t = torch.tensor([3, 70])

    def loss():
        return (model(x, t) - x).square().mean()

    with debugging.nan_debugging():
        loss().backward()
        params = dict(model.named_parameters())
        debugging.assert_tree_finite(params, "params")
        debugging.assert_tree_finite({k: p.grad for k, p in params.items()}, "grads")
        assert bool(debugging.tree_all_finite(params))
        out = loss()
        model.out_norm.weight.data[0] = float("nan")
        with pytest.raises(RuntimeError, match="Function '_GNSiLUBackward' returned nan"):
            out.backward()
    assert not torch.is_anomaly_enabled()


# --------------------------------------------------------- profiler_trace


def _conv_forward():
    x = torch.randn(1, 3, 8, 8)
    return torch.nn.functional.conv2d(x, torch.randn(4, 3, 3, 3), padding=1).sum()


def test_profiler_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for off in (None, ""):
        with profiler_trace(off):
            _conv_forward()
    assert os.listdir(tmp_path) == []
    logdir = tmp_path / "trace"
    with profiler_trace(str(logdir)):
        _conv_forward()
    with pytest.raises(ValueError):
        with profiler_trace(str(logdir)):
            _conv_forward()
            raise ValueError("the block failed")
    files = sorted(os.listdir(logdir))
    assert len(files) == 2 and all(f.endswith(".json") for f in files)
    for f in files:
        events = json.loads((logdir / f).read_text())["traceEvents"]
        assert any(e.get("name") == "aten::convolution" for e in events)


# ------------------------------------------------------------ sample_metrics


def _batches():
    rng = np.random.default_rng(5)
    same = np.repeat(rng.random((1, 4, 4, 3)), 5, axis=0)
    return {"random": rng.random((8, 6, 5, 3)).astype(np.float32),
            "many": rng.random((13, 4, 4, 3)),
            "one": rng.random((1, 4, 4, 3)),
            "saturated": np.concatenate([np.zeros((3, 4, 4, 3)), np.ones((3, 4, 4, 3))]),
            "identical": same}


@pytest.mark.parametrize("case", sorted(_batches()))
def test_sample_metrics_equal_jax(case):
    x = _batches()[case]
    assert sample_metrics.sample_statistics(x) == jax_metrics.sample_statistics(x)
    for pairs in (3, 64):
        assert sample_metrics.pairwise_diversity(x, pairs) == \
            jax_metrics.pairwise_diversity(x, pairs)
    for bins in (16, 5):
        np.testing.assert_array_equal(sample_metrics.channel_histogram(x, bins),
                                      jax_metrics.channel_histogram(x, bins))
    if case == "identical":
        assert sample_metrics.pairwise_diversity(x) == 0.0


# ------------------------------------------------------------------ summary


def _jax_rows(model, r):
    tree = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, r, r, 3)),
                          jnp.zeros((1,)))
    return tree, jax_summary.param_table(tree)


@pytest.mark.parametrize("family", ["unet", "dit_moe"])
def test_param_table_pairs_with_jax(family):
    from ddpm_diffusion_model_tpu.models import DiTConfig as JaxDiTConfig
    from ddpm_diffusion_model_tpu.models import DiTDenoiser as JaxDiT
    from ddpm_diffusion_model_tpu.models import UNetConfig as JaxUNetConfig
    from ddpm_diffusion_model_tpu.models import UNetDenoiser as JaxUNet
    from ddpm_diffusion_model_tpu_torch.models import DiTConfig, UNetConfig, build_denoiser
    from ddpm_diffusion_model_tpu_torch.utils.interop import (dit_param_entries,
                                                              reference_param_entries)

    if family == "unet":
        kw = dict(in_channels=3, base_channels=16, channel_mults=(1, 2), num_res_blocks=1,
                  attn_resolutions=(8,), time_embed_dim=32, num_heads=2, head_dim=8,
                  img_resolution=16, num_classes=3)
        tree, rows = _jax_rows(JaxUNet(JaxUNetConfig(**kw)), 16)
        cfg = UNetConfig(**kw)
        paths = [(k, p) for k, p in reference_param_entries(cfg, tree["params"])]
    else:
        kw = dict(in_channels=3, img_resolution=16, patch_size=4, hidden_size=64, depth=2,
                  num_heads=2, time_embed_dim=32, num_experts=4, num_classes=3)
        tree, rows = _jax_rows(JaxDiT(JaxDiTConfig(**kw), scan_blocks=False), 16)
        cfg = DiTConfig(**kw)
        paths = [(k, p) for k, p, _layer, _tr in dit_param_entries(cfg, tree["params"])]
    ours = summary.param_table(build_denoiser(cfg, device="meta"))
    jax_count = {name: n for name, _shape, n in rows}
    assert len(ours) == len(rows) == len(paths)
    for (name, shape, n), (key, path) in zip(ours, paths):
        assert name == key
        assert n == jax_count["params/" + "/".join(path)] == int(np.prod(shape)), name
    assert sum(r[2] for r in ours) == sum(r[2] for r in rows)
    text, jax_text = summary.model_summary(build_denoiser(cfg, device="meta"), max_rows=3), \
        jax_summary.model_summary(tree, max_rows=3)
    lines, jax_lines = text.splitlines(), jax_text.splitlines()
    assert len(lines) == len(jax_lines) == 3 + 5
    for i in (0, 1, -3, -2, -1):  # header, rules, "... (N more)", total
        assert lines[i] == jax_lines[i]


def test_celeba64_attn_summary_total():
    from ddpm_diffusion_model_tpu_torch.models import build_denoiser

    model = build_denoiser(config.get_preset("celeba64_attn").model, device="meta")
    rows = summary.param_table(model)
    assert sum(r[2] for r in rows) == 31_312_131
    assert summary.model_summary(model).splitlines()[-1].endswith("31,312,131")
    assert rows[0] == ("time_mlp.net.0.weight", (512, 512), 262_144)


# ------------------------------------------------------- the import surface

SUBPACKAGES = ["", "models", "ops", "training", "utils", "data", "parallel", "sampling"]
#: flax-only or network-bound JAX names the port does not have (ROADMAP A)
NOT_PORTED = {"ops": {"PackedDropout"},
              "data": {"HFImageDataset", "build_hf_image_loader"}}


def _jax_public_names(sub):
    """Every public name a JAX ``__init__`` imports or defines."""
    path = os.path.join(REPO, "ddpm_diffusion_model_tpu", sub, "__init__.py")
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ImportFrom) and node.level:
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=[s or "top" for s in SUBPACKAGES])
def test_every_jax_public_name_imports_from_the_port(sub):
    names = _jax_public_names(sub)
    assert names, sub
    mod = importlib.import_module("ddpm_diffusion_model_tpu_torch" + (f".{sub}" if sub else ""))
    missing = sorted(n for n in names - NOT_PORTED.get(sub, set()) if not hasattr(mod, n))
    assert missing == [], missing
    assert NOT_PORTED.get(sub, set()) <= names  # each exception is a real JAX name
    for n in getattr(mod, "__all__", ()):
        assert hasattr(mod, n), n
