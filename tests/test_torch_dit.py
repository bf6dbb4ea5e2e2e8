"""The port's DiT against the JAX package on the same numpy inputs, at JAX's
TINY size (``tests/test_dit.py``: 16 px, patch 4, hidden 64, depth 2, 2
heads), weights carried by ``jax_params_to_state_dict``.

- the forward in float32 within 1e-4 (docs/PARITY.md), unconditional and
  with 3 classes (labels and the NULL token), from JAX's scanned and
  unrolled params; in bf16 within 2e-2 of JAX's bf16 forward;
- adaLN-Zero: a fresh model returns exactly 0;
- the U-Net-only paths refused with JAX's messages;
- dropout in training mode only, from the generator it is given;
- remat True, "attn" and "dots" bit-equal to no remat (loss, every grad,
  the generator's state after), with dropout on;
- the loss and every gradient leaf of one step on injected (t, noise)
  (1e-5 / 1e-4 relative) and one whole update against the JAX composition;
- DDIM (eta 0.5) from an injected x_T and injected step noise within 1e-4,
  and the guided eps of a 10-class model (guidance 3) within 1e-4;
- the presets and config round trips, and the four config functions'
  param counts and weight map at full width (shapes only).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddpm_diffusion_model_tpu.models import DiTConfig as JaxDiTConfig
from ddpm_diffusion_model_tpu.models import DiTDenoiser as JaxDiT
from ddpm_diffusion_model_tpu.models import build_denoiser as jax_build_denoiser
from ddpm_diffusion_model_tpu.models import dit as jax_dit
from ddpm_diffusion_model_tpu.ops import DiffusionConfig as JaxDiffusionConfig
from ddpm_diffusion_model_tpu.ops import diffusion as jd
from ddpm_diffusion_model_tpu.ops import make_schedule as jax_make_schedule
from ddpm_diffusion_model_tpu.sampling.inference import cfg_eps_fn as jax_cfg_eps_fn
from ddpm_diffusion_model_tpu.training import ema as jax_ema
from ddpm_diffusion_model_tpu.training import state as jax_state
from ddpm_diffusion_model_tpu.utils import config as jax_config
from ddpm_diffusion_model_tpu_torch.models import (DiTConfig, DiTDenoiser, UNetDenoiser,
                                                   build_denoiser, count_params)
from ddpm_diffusion_model_tpu_torch.models import dit as port_dit
from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
from ddpm_diffusion_model_tpu_torch.ops import diffusion as td
from ddpm_diffusion_model_tpu_torch.sampling import cfg_eps_fn
from ddpm_diffusion_model_tpu_torch.training import (StepDraws, TrainConfig,
                                                     init_train_state, make_loss_fn,
                                                     make_train_step)
from ddpm_diffusion_model_tpu_torch.utils import config as port_config
from ddpm_diffusion_model_tpu_torch.utils.interop import (dit_param_entries,
                                                          jax_params_to_state_dict)

torch.set_num_threads(2)

TINY = dict(img_resolution=16, patch_size=4, hidden_size=64, depth=2, num_heads=2,
            time_embed_dim=32)
T = 100


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _perturbed(params, seed=4, scale=0.05):
    """JAX params off the adaLN-Zero init, so every branch carries signal."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.normal(size=np.shape(a)).astype(np.float32),
        params)


def _pair(dtype=torch.float32, scan_blocks=True, **over):
    """(JAX model, its perturbed params, the port's model holding them)."""
    cfg = dict(TINY, **over)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = JaxDiT(JaxDiTConfig(**cfg), dtype=jdt, scan_blocks=scan_blocks)
    params = _perturbed(jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 16, 16, 3)),
                                         jnp.zeros((1,))))
    port = DiTDenoiser(DiTConfig(**cfg), dtype=dtype, device="cpu")
    port.load_state_dict(jax_params_to_state_dict(params, port.config), strict=True)
    return jm, params, port.eval()


def _x(seed, n=3):
    return np.random.default_rng(seed).normal(size=(n, 16, 16, 3)).astype(np.float32)


T3 = np.array([5.0, 60.0, 99.0], np.float32)


# ------------------------------------------------------------- the forward


@pytest.mark.parametrize("scan_blocks", [True, False])
@pytest.mark.parametrize("num_classes", [0, 3])
def test_forward_fp32_matches_jax(scan_blocks, num_classes):
    jm, params, port = _pair(scan_blocks=scan_blocks, num_classes=num_classes)
    x = _x(1)
    labels = [None] if not num_classes else [None, np.array([0, 2, 3], np.int32)]
    for y in labels:
        want = np.asarray(jm.apply(params, x, T3, y))
        with torch.no_grad():
            got = port(torch.from_numpy(x), torch.from_numpy(T3),
                       None if y is None else torch.from_numpy(y).long())
        assert got.dtype == torch.float32 and got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_forward_bf16_matches_jax_bf16():
    jm, params, port = _pair(dtype=torch.bfloat16, num_classes=3)
    x = _x(2)
    y = np.array([1, 3, 0], np.int32)
    want = np.asarray(jm.apply(params, x, T3, y))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(T3), torch.from_numpy(y).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


def test_adaln_zero_returns_exactly_zero():
    torch.manual_seed(0)
    port = DiTDenoiser(DiTConfig(**TINY, num_classes=3), dtype=torch.float32, device="cpu")
    zero = [port.final_ada, port.final_proj] + [b.ada for b in port.blocks]
    assert all(float(p.detach().abs().max()) == 0.0 for m in zero for p in m.parameters())
    with torch.no_grad():
        out = port(torch.from_numpy(_x(3)), torch.tensor([3.0, 99.0, 0.0]))
        assert out.shape == (3, 16, 16, 3) and float(out.abs().max()) == 0.0


def test_rejects_unet_only_paths_with_jax_messages():
    jm, params, port = _pair()
    x0 = np.zeros((1, 16, 16, 3), np.float32)
    t0 = np.zeros((1,), np.float32)

    def both(exc, fn_j, fn_t):
        with pytest.raises(exc) as ej:
            fn_j()
        with pytest.raises(exc) as et:
            fn_t()
        assert str(et.value) == str(ej.value)

    x, t = torch.from_numpy(x0), torch.from_numpy(t0)
    both(ValueError, lambda: jm.apply(params, x0, t0, mode="decode"),
         lambda: port(x, t, mode="decode"))
    both(ValueError, lambda: jm.apply(params, x0, t0, return_features=True),
         lambda: port(x, t, return_features=True))
    both(ValueError, lambda: jm.apply(params, np.zeros((1, 15, 15, 3), np.float32), t0),
         lambda: port(torch.zeros(1, 15, 15, 3), t))
    both(ValueError, lambda: jm.apply(params, x0, t0, np.zeros((1,), np.int32)),
         lambda: port(x, t, torch.zeros(1, dtype=torch.long)))
    both(TypeError, lambda: jax_build_denoiser(JaxDiTConfig(**TINY), fused_gn=True),
         lambda: build_denoiser(DiTConfig(**TINY), fused_gn=True, device="cpu"))
    both(TypeError, lambda: jax_build_denoiser(JaxDiTConfig(**TINY), dropout_impl="flax"),
         lambda: build_denoiser(DiTConfig(**TINY), dropout_impl="flax", device="cpu"))
    both(ValueError, lambda: jax_dit._posemb_2d_sincos(4, 4, 66),
         lambda: port_dit._posemb_2d_sincos(4, 4, 66))
    with pytest.raises(ValueError, match="U-Net-only"):
        port(x, t, x_cond=torch.zeros(1, 16, 16, 3))
    with pytest.raises(ValueError, match="remat"):
        DiTDenoiser(DiTConfig(**TINY), device="cpu", remat="masks")
    assert isinstance(build_denoiser(DiTConfig(**TINY), dtype=torch.float32, device="cpu",
                                     remat="dots", scan_blocks=False), DiTDenoiser)
    assert isinstance(build_denoiser(port_config.get_preset("celeba64_attn").model,
                                     device="meta"), UNetDenoiser)


@pytest.mark.parametrize("mean", [0.0, 100.0, 1000.0])
def test_layer_norm_stays_exact_at_large_means(mean):
    """The port's LayerNorm takes two passes (``F.layer_norm``); flax's
    computes E[x^2] - mean^2 in float32 (``use_fast_variance``), which
    cancels at large means.  Against float64 at (4, 256, 384) the port stays
    within 2e-4; JAX drifts (1e-2 at mean 100, 1 at 1000): a divergence kept
    on purpose (ROADMAP.md C), as GN's."""
    import flax.linen as fnn

    x = (np.random.default_rng(0).normal(size=(4, 256, 384)) + mean).astype(np.float32)
    x64 = x.astype(np.float64)
    want = (x64 - x64.mean(-1, keepdims=True)) / np.sqrt(x64.var(-1, keepdims=True) + 1e-6)
    got = port_dit._layer_norm(torch.from_numpy(x)).numpy()
    jax_ln = fnn.LayerNorm(use_bias=False, use_scale=False, epsilon=1e-6, dtype=jnp.float32)
    jax_err = float(np.abs(np.asarray(jax_ln.apply({}, x)) - want).max())
    assert float(np.abs(got - want).max()) <= 2e-4
    assert jax_err <= 1e-5 if mean == 0.0 else jax_err > 1e-3


def test_posemb_matches_jax():
    np.testing.assert_array_equal(port_dit._posemb_2d_sincos(4, 8, 64),
                                  jax_dit._posemb_2d_sincos(4, 8, 64))


def test_dropout_in_training_only_and_from_the_generator():
    _, _, port = _pair(dropout=0.5)
    x, t = torch.from_numpy(_x(4)), torch.from_numpy(T3)
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    port.train()
    with torch.no_grad():
        d1, d1b, d2 = port(x, t, None, gen(1)), port(x, t, None, gen(1)), port(x, t, None, gen(2))
        port.eval()
        e1, e2 = port(x, t, None, gen(1)), port(x, t, None, gen(2))
    assert torch.equal(d1, d1b) and not torch.equal(d1, d2)
    assert torch.equal(e1, e2) and not torch.equal(e1, d1)


@pytest.mark.parametrize("remat", [True, "attn", "dots"])
@pytest.mark.parametrize("num_experts", [0, 4])
def test_remat_modes_equal_no_remat(remat, num_experts):
    """Loss, every gradient and the generator's state after, bit-equal to
    no remat, with dropout drawing from an explicit generator."""
    over = dict(dropout=0.2, num_experts=num_experts, num_classes=3)
    _, _, port = _pair(**over)
    x, t = torch.from_numpy(_x(5)), torch.from_numpy(T3)
    y = torch.tensor([0, 1, 3])
    res = []
    for mode in (False, remat):
        m = DiTDenoiser(port.config, dtype=torch.float32, device="cpu", remat=mode)
        m.load_state_dict(port.state_dict())
        m.train()
        gen = torch.Generator().manual_seed(7)
        out, aux = m(x, t, y, gen, return_aux=True)
        loss = out.square().mean() + aux
        loss.backward()
        res.append((loss.detach(), [p.grad for p in m.parameters()], gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = res
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert sum(float(g.abs().sum()) for g in g0) > 0.0


# ----------------------------------------------------------------- training


def _scheds():
    return (jax_make_schedule(JaxDiffusionConfig(T=T, img_size=16)),
            make_schedule(DiffusionConfig(T=T, img_size=16), device="cpu"))


def _draws(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, size=(n, 16, 16, 3)).astype(np.float32),
            rng.integers(1, T, size=(n,)).astype(np.int32),
            rng.normal(size=(n, 16, 16, 3)).astype(np.float32))


def test_loss_and_every_grad_leaf_match_jax():
    jm, params, port = _pair()
    sched_j, sched = _scheds()
    x, t, noise = _draws()
    loss_j, g_j = jax.jit(jax.value_and_grad(lambda p: jd.loss_simple(
        sched_j, lambda xt, tt: jm.apply(p, xt, tt), x, t, noise)))(params)
    port.train()
    loss = make_loss_fn(port, sched)(torch.from_numpy(x),
                                     StepDraws(torch.from_numpy(t).long(),
                                               torch.from_numpy(noise)))
    loss.backward()
    assert abs(float(loss) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, g_j), port.config)
    got = dict(port.named_parameters())
    assert list(want) == list(got)
    for name, g in want.items():
        assert _rel(got[name].grad.numpy(), g.numpy()) <= 1e-4, name


def test_whole_update_matches_jax_composition():
    """make_train_step on injected draws against value_and_grad + optax +
    the EMA lerp of the JAX package: loss, grad norm and the moved params."""
    jm, params, port = _pair(num_classes=3)
    sched_j, sched = _scheds()
    x, t, noise = _draws(1)
    y = np.array([0, 1, 2, 1], np.int32)
    kw = dict(base_lr=1e-3, warmup_steps=3, grad_clip=1.0, ema_decay=0.9)
    cfg_j = jax_state.TrainConfig(**kw)
    tx_j = jax_state.make_optimizer(cfg_j)
    loss_j, g_j = jax.jit(jax.value_and_grad(lambda p: jd.loss_simple(
        sched_j, lambda xt, tt: jm.apply(p, xt, tt, y), x, t, noise)))(params)
    upd, _ = tx_j.update(g_j, tx_j.init(params), params)
    params_j = optax.apply_updates(params, upd)
    ema_j = jax_ema.ema_update(jax_ema.ema_init(params), params_j, cfg_j.ema_decay)

    cfg = TrainConfig(**kw, cond_dropout=0.0)
    state, tx = init_train_state(port, cfg)
    state, m = make_train_step(port, sched, tx, cfg)(
        state, (x, y), StepDraws(torch.from_numpy(t).long(), torch.from_numpy(noise)))
    assert abs(float(m["loss"]) - float(loss_j)) <= 1e-5 * float(loss_j)
    gn_j = float(optax.global_norm(g_j))
    assert abs(float(m["grad_norm"]) - gn_j) <= 1e-4 * gn_j
    start = jax_params_to_state_dict(params, port.config)
    grads = jax_params_to_state_dict(jax.tree.map(np.asarray, g_j), port.config)
    H = TINY["hidden_size"]
    keep = {}
    for name, g in grads.items():
        keep[name] = np.ones(g.shape, bool)
        if name.endswith("qkv.bias"):
            # the key bias adds q.b to every logit of a row, which the
            # softmax removes: its gradient is 0 up to rounding, and Adam's
            # first step turns that rounding into +-lr either way
            keep[name][H:2 * H] = False
            assert float(g[H:2 * H].norm()) <= 1e-5 * float(g.norm()), name
    for tree, got in ((params_j, dict(port.named_parameters())), (ema_j, state.ema_params)):
        want = jax_params_to_state_dict(jax.tree.map(np.asarray, tree), port.config)
        for name, w in want.items():
            k = keep[name]
            g = np.asarray(got[name].detach(), np.float64)[k]
            w, s = np.asarray(w, np.float64)[k], np.asarray(start[name], np.float64)[k]
            rounding = np.finfo(np.float32).eps * np.linalg.norm(w)
            assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w - s) + rounding, name


# ----------------------------------------------------------------- sampling


def test_ddim_with_injected_noise_matches_jax():
    """DDIM at eta 0.5 over an 8-step ladder from an injected x_T, with the
    same injected noise at every step, through each package's ddim_step."""
    jm, params, port = _pair(num_classes=3)
    sched_j, sched = _scheds()
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 16, 16, 3)).astype(np.float32)
    ladder = [99, 85, 70, 55, 40, 25, 10, 0]
    noise = rng.normal(size=(len(ladder), 3, 16, 16, 3)).astype(np.float32)
    y = np.array([2, 0, 3], np.int32)
    eps_j = jax.jit(lambda xt, tt: jm.apply(params, xt, tt, y))
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    yt = torch.from_numpy(y).long()
    for i, (a, b) in enumerate(zip(ladder, ladder[1:] + [-1])):
        tj, pj = jnp.full((3,), a, jnp.int32), jnp.full((3,), b, jnp.int32)
        xj = jd.ddim_step(sched_j, eps_j, xj, tj, pj, jnp.asarray(noise[i]), eta=0.5)
        with torch.no_grad():
            xt = td.ddim_step(sched, lambda z, tt: port(z, tt, yt), xt,
                              torch.full((3,), a), torch.full((3,), b),
                              torch.from_numpy(noise[i]), eta=0.5)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-4)


def test_guided_eps_of_a_10_class_dit_matches_jax():
    jm, params, port = _pair(num_classes=10)
    sched_j, sched = _scheds()
    x = _x(12, n=4)
    t = np.array([3, 40, 77, 99], np.int32)
    y = np.array([9, 0, 4, 9], np.int32)
    for guidance in (1.0, 3.0):
        want = jax_cfg_eps_fn(jm, params, jnp.asarray(y), guidance, sched=sched_j)(x, t)
        with torch.no_grad():
            got = cfg_eps_fn(port, sched, y=y, guidance=guidance)(
                torch.from_numpy(x), torch.from_numpy(t).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ configuration


@pytest.mark.parametrize("name", ["celeba64_dit_s4", "celeba64_dit_moe"])
def test_dit_presets_equal_jax_and_round_trip(name):
    exp = port_config.get_preset(name)
    assert isinstance(exp.model, DiTConfig)
    d = exp.to_dict()
    assert d == jax_config.get_preset(name).to_dict()
    assert d["model"]["family"] == "dit"
    assert json.loads(exp.to_json()) == json.loads(jax_config.get_preset(name).to_json())
    for legacy in (False, True):
        back = port_config.ExperimentConfig.from_dict(json.loads(exp.to_json()), legacy=legacy)
        assert back == exp
    assert port_config.preset_from_experiment(d) == exp
    assert exp.model.seq_len == 256
    with pytest.raises(ValueError, match="not a DiT config"):
        DiTConfig.from_dict({**d["model"], "family": "unet"})


def test_unet_presets_carry_no_family_and_latent_still_raises():
    # the latent preset is ported too (tests/test_torch_latent.py): a U-Net
    # preset like the others, JAX's field for field
    for name in ("celeba64_low", "celeba64_attn", "celebahq256", "sr64to256",
                 "celeba64_latent"):
        assert "family" not in port_config.get_preset(name).to_dict()["model"]
    assert (port_config.get_preset("celeba64_latent").to_dict()
            == jax_config.get_preset("celeba64_latent").to_dict())


CONFIG_FNS = ["dit_s4_64_config", "dit_b4_64_config", "dit_moe_64_config",
              "dit_s4_256_config"]
PARAMS = {"dit_s4_64_config": 32_499_120, "dit_b4_64_config": 129_583_920,
          "dit_moe_64_config": 131_787_792, "dit_s4_256_config": 32_499_120}


@pytest.mark.parametrize("fn", CONFIG_FNS)
def test_full_width_param_counts_and_weight_map_equal_jax(fn):
    """Shapes only: JAX's ``eval_shape`` init against the port built on the
    meta device; every JAX leaf mapped (a scanned leaf once per layer), each
    to a port parameter of its shape."""
    cfg_j, cfg = getattr(jax_dit, fn)(), getattr(port_dit, fn)()
    # the port's config is JAX's field for field, plus the dropless router's
    # fields, which to_dict leaves out at their switch values
    assert dataclasses.asdict(cfg_j) == {k: v for k, v in cfg.to_dict().items()
                                         if k != "family"}
    r = cfg.img_resolution
    tree = jax.eval_shape(JaxDiT(cfg_j).init, jax.random.key(0), jnp.zeros((1, r, r, 3)),
                          jnp.zeros((1,)))["params"]
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    jax_total = sum(int(np.prod(v.shape)) for _, v in leaves)
    model = build_denoiser(cfg, device="meta")
    assert count_params(model) == jax_total == PARAMS[fn]
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    entries = dit_param_entries(cfg, tree)
    assert [e[0] for e in entries] == list(shapes)
    used = set()
    for key, path, layer, transpose in entries:
        node = tree
        for k in path:
            node = node[k]
        shape = node.shape[1:] if layer is not None else node.shape
        assert (shape[::-1] if transpose else shape) == shapes[key], key
        used.add(path)
    assert used == {tuple(p.key for p in path) for path, _ in leaves}
    assert len(leaves) == (20 if not cfg.num_experts else 22)
