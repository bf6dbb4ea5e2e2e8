"""The port's sampling loops against the JAX package with carried weights
(float32): DDIM eta=0 from one x_T against ``_ddim_from_init_jit``, and
DDIM eta>0 / DDPM with the same per-step noise injected into both, plus
strip capture and the seeded ``ddim_sample``; the entry points (DDPM and
DDIM grids, the denoise strips) against JAX loops fed the port's x_T and
per-step noise, and the grids pixel-equal to the JAX ``make_grid``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_diffusion_model_tpu.models import UNetConfig as JaxUNetConfig
from ddpm_diffusion_model_tpu.models import UNetDenoiser as JaxUNet
from ddpm_diffusion_model_tpu.ops import diffusion as jd
from ddpm_diffusion_model_tpu.ops import schedules as js
from ddpm_diffusion_model_tpu.sampling import loops as jl
from ddpm_diffusion_model_tpu.sampling.inference import _ddim_from_init_jit
from ddpm_diffusion_model_tpu.utils import images as jimages
from ddpm_diffusion_model_tpu_torch.models import UNetConfig, UNetDenoiser
from ddpm_diffusion_model_tpu_torch.ops import schedules as ts
from ddpm_diffusion_model_tpu_torch.sampling import loops as tl
from ddpm_diffusion_model_tpu_torch.sampling.inference import (
    cfg_eps_fn, ddim_from_init, ddim_infer_sample, ddim_sample, ddpm_infer_sample,
    ddpm_sample, render_denoise_strip, render_denoise_strip_ddim)
from ddpm_diffusion_model_tpu_torch.sampling.timesteps import build_ddim_schedule
from ddpm_diffusion_model_tpu_torch.utils import images as timages
from ddpm_diffusion_model_tpu_torch.utils.interop import jax_params_to_state_dict

torch.set_num_threads(1)

SMALL = dict(base_channels=32, channel_mults=(1, 2), num_res_blocks=1,
             attn_resolutions=(8,), time_embed_dim=64, num_heads=2,
             head_dim=16, img_resolution=16)
DIFF = dict(T=100, dynamic_threshold=0.95, img_size=16)

# Every step's U-Net agrees to ~1e-5 (fp32, test_torch_unet.py holds 1e-4);
# the DDIM update multiplies that by coefficients of O(1..10) at high t and
# the threshold's divisor is piecewise, so after <= 10 steps the trajectories
# are held to 1e-4 absolute on O(1) values.
TRAJ_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = JaxUNet(JaxUNetConfig(**SMALL), dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.key(2), jnp.ones((1, 16, 16, 3)),
                              jnp.zeros((1,)))
    port = UNetDenoiser(UNetConfig(**SMALL), dtype=torch.float32, device="cpu")
    port.load_state_dict(jax_params_to_state_dict(params, port.config), strict=True)
    return jm, params, port.eval()


def _scheds():
    return (js.make_schedule(js.DiffusionConfig(**DIFF)),
            ts.make_schedule(ts.DiffusionConfig(**DIFF), device="cpu"))


def _x(seed, n=2):
    return np.random.default_rng(seed).normal(size=(n, 16, 16, 3)).astype(np.float32)


def test_ddim_eta0_matches_ddim_from_init_jit(models):
    jm, params, port = models
    jsched, tsched = _scheds()
    ladder = tuple(int(t) for t in build_ddim_schedule("t_linear", 10, 100))
    x = _x(0)
    want = _ddim_from_init_jit(jm, params, jsched, jnp.asarray(x), ladder)
    got = ddim_from_init(port, tsched, torch.from_numpy(x), ladder)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TRAJ_TOL)


def _jax_eps(jm, params):
    apply = jax.jit(jm.apply)
    return lambda xt, t: apply(params, xt, t)


def test_ddim_eta_positive_with_injected_noise(models):
    jm, params, port = models
    jsched, tsched = _scheds()
    ladder = build_ddim_schedule("karras", 6, 100)
    x = _x(1)
    noise = np.random.default_rng(2).normal(size=(len(ladder), *x.shape)).astype(np.float32)
    eps = _jax_eps(jm, params)
    xj = jnp.asarray(x)
    for i in range(len(ladder) - 1):
        t = jnp.full((2,), int(ladder[i]), jnp.int32)
        tp = jnp.full((2,), int(ladder[i + 1]), jnp.int32)
        xj = jd.ddim_step(jsched, eps, xj, t, tp, jnp.asarray(noise[i]), eta=0.5,
                          clip_x0=True)
    with torch.inference_mode():
        got, frames = tl.ddim_sample_loop(
            tsched, cfg_eps_fn(port, tsched), torch.from_numpy(x),
            timesteps=ladder, eta=0.5, clip_x0=True,
            noises=torch.from_numpy(noise))
    assert frames is None
    np.testing.assert_allclose(got.numpy(), np.asarray(xj), atol=TRAJ_TOL)


def test_ddpm_loop_with_injected_noise(models):
    jm, params, port = models
    jsched, tsched = _scheds()
    x = _x(3)
    steps = 6
    noise = np.random.default_rng(4).normal(size=(steps, *x.shape)).astype(np.float32)
    eps = _jax_eps(jm, params)
    xj = jnp.asarray(x)
    for i, t in enumerate(range(steps - 1, -1, -1)):  # the ladder 5..0
        xj = jd.p_sample_step(jsched, eps, xj, jnp.full((2,), t, jnp.int32),
                              jnp.asarray(noise[i]))
    with torch.inference_mode():
        got, frames = tl.ddpm_sample_loop(
            tsched, cfg_eps_fn(port, tsched), torch.from_numpy(x),
            num_steps=steps, noises=torch.from_numpy(noise), capture_steps=[4, 0])
    np.testing.assert_allclose(got.numpy(), np.asarray(xj), atol=TRAJ_TOL)
    assert frames.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(frames[1].numpy(),
                               tl.to_unit_interval(got[0]).numpy(), atol=1e-7)


@pytest.mark.parametrize("caps", [None, [999, 500, 0], [999, 3, 12345]])
def test_capture_slots_match_jax(caps):
    ladder = build_ddim_schedule("t_linear", 50, 1000)
    np.testing.assert_array_equal(tl._capture_slots(ladder, caps)[0],
                                  jl._capture_slots(ladder, caps)[0])
    assert tl._capture_slots(ladder, caps)[1] == jl._capture_slots(ladder, caps)[1]
    with pytest.raises(ValueError, match="no overlap"):
        tl._capture_slots(ladder, [1])


def test_ddim_strip_capture_takes_the_closing_step(models):
    _jm, _p, port = models
    _j, tsched = _scheds()
    ladder = build_ddim_schedule("t_linear", 4, 100)
    with torch.inference_mode():
        x, frames = tl.ddim_sample_loop(tsched, cfg_eps_fn(port), torch.from_numpy(_x(5, 1)),
                                        timesteps=ladder, capture_steps=list(ladder))
    assert frames.shape == (len(ladder), 16, 16, 3)
    np.testing.assert_allclose(frames[-1].numpy(), tl.to_unit_interval(x[0]).numpy())


def test_ddim_sample_seeded_and_saved(models, tmp_path):
    _jm, _p, port = models
    _j, tsched = _scheds()
    kw = dict(n=4, img_size=16, steps=3, eta=0.5, schedule="karras", device="cpu")
    a = ddim_sample(port, None, tsched, seed=1, save_path=str(tmp_path / "g.png"), **kw)
    b = ddim_sample(port, None, tsched, seed=1, **kw)
    c = ddim_sample(port, None, tsched, seed=2, **kw)
    assert a.shape == (4, 16, 16, 3) and a.dtype == np.float32
    assert 0.0 <= a.min() and a.max() <= 1.0
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-3
    assert (tmp_path / "g.png").stat().st_size > 0


# ---------------------------------------------------------------- entry points


def _port_draws(seed, shape, steps):
    """x_T and ``steps`` per-step noises, in the order the entry points
    draw them from their generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen)
    return x.numpy(), [torch.randn(shape, generator=gen).numpy() for _ in range(steps)]


def _jax_ddpm(jm, params, jsched, x, noises, capture=()):
    """The JAX ancestral ladder T-1..0 with the given per-step noise; the
    first sample's [0, 1] frames after the captured steps."""
    eps = _jax_eps(jm, params)
    xj, frames = jnp.asarray(x), []
    B = x.shape[0]
    for i, t in enumerate(range(len(noises) - 1, -1, -1)):
        xj = jd.p_sample_step(jsched, eps, xj, jnp.full((B,), t, jnp.int32),
                              jnp.asarray(noises[i]))
        if t in capture:
            frames.append(np.asarray(jl.to_unit_interval(xj[0])))
    return np.asarray(jl.to_unit_interval(xj)), frames


def test_ddpm_infer_sample_matches_jax_with_the_ports_noise(models, tmp_path):
    jm, params, port = models
    jsched, tsched = _scheds()
    n, seed = 4, 7
    x, noises = _port_draws(seed, (n, 16, 16, 3), 100)
    want, _ = _jax_ddpm(jm, params, jsched, x, noises)
    out = str(tmp_path / "ddpm.png")
    grid = ddpm_infer_sample(port, None, tsched, n=n, img_size=16, seed=seed,
                             out_path=out, save_individual=True,
                             out_dir=str(tmp_path / "ind"), device="cpu")
    np.testing.assert_allclose(grid, jimages.make_grid(want, nrow=jimages.grid_nrow(n)),
                               atol=TRAJ_TOL)
    assert os.path.getsize(out) > 0 and len(os.listdir(tmp_path / "ind")) == n
    # the in-training grid: a truncated ladder, int(sqrt(n)) per row
    x01 = ddpm_sample(port, None, tsched, n, 16, steps=5, seed=seed, return_grid=False,
                      device="cpu")
    want5, _ = _jax_ddpm(jm, params, jsched, x, noises[:5])
    np.testing.assert_allclose(x01, want5, atol=TRAJ_TOL)


def test_ddim_infer_sample_matches_jax_and_params_replace_weights(models, tmp_path):
    jm, params, port = models
    jsched, tsched = _scheds()
    n, seed = 3, 8
    x, _ = _port_draws(seed, (n, 16, 16, 3), 0)
    ladder = build_ddim_schedule("alpha_bar_cosine", 10, 100,
                                 alphas_cumprod=tsched.alphas_cumprod.numpy())
    want = jl.to_unit_interval(_ddim_from_init_jit(
        jm, params, jsched, jnp.asarray(x), tuple(int(t) for t in ladder)))
    kw = dict(n=n, img_size=16, seed=seed, steps=10, schedule_kind="alpha_bar_cosine",
              device="cpu")
    grid = ddim_infer_sample(port, None, tsched, out_path=str(tmp_path / "a.png"), **kw)
    np.testing.assert_allclose(grid, jimages.make_grid(np.asarray(want), nrow=2),
                               atol=TRAJ_TOL)
    # ema_params stand in for the model's weights, which stay untouched
    before = {k: v.clone() for k, v in port.state_dict().items()}
    shadow = {k: v * 0.5 for k, v in port.named_parameters()}
    other = ddim_infer_sample(port, None, tsched, ema_params=shadow,
                              out_path=str(tmp_path / "b.png"), **kw)
    assert np.abs(other - grid).max() > 1e-3
    assert all(torch.equal(before[k], v) for k, v in port.state_dict().items())
    again = ddim_infer_sample(port, shadow, tsched, out_path=str(tmp_path / "c.png"), **kw)
    np.testing.assert_array_equal(other, again)


def test_denoise_strips_match_jax(models, tmp_path):
    jm, params, port = models
    jsched, tsched = _scheds()
    seed = 9
    x, noises = _port_draws(seed, (1, 16, 16, 3), 100)
    caps = [int(v) for v in np.round(np.linspace(99, 0, 20))]
    _, frames = _jax_ddpm(jm, params, jsched, x, noises, capture=set(caps))
    strip = render_denoise_strip(port, None, tsched, img_size=16, seed=seed,
                                 out_path=str(tmp_path / "s.png"), device="cpu")
    np.testing.assert_allclose(strip, jimages.make_grid(np.stack(frames), nrow=20, padding=2),
                               atol=TRAJ_TOL)
    # DDIM: eta=0 draws no noise, so the JAX loop runs on the port's x_T as is
    ts = build_ddim_schedule("t_cosine", 10, 100)
    pick = np.round(np.linspace(0, len(ts) - 1, min(17, len(ts)))).astype(int)
    _, jframes = jl.ddim_sample_loop(
        jsched, _jax_eps(jm, params), jnp.asarray(x), jax.random.key(0), timesteps=ts,
        eta=0.0, clip_x0=True, capture_steps=[int(ts[i]) for i in pick])
    strip = render_denoise_strip_ddim(port, None, tsched, img_size=16, seed=seed, steps=10,
                                      schedule_kind="cosine", pad=1,
                                      out_path=str(tmp_path / "d.png"), device="cpu")
    np.testing.assert_allclose(
        strip, jimages.make_grid(np.asarray(jframes), nrow=len(pick), padding=1),
        atol=TRAJ_TOL)
    assert os.path.getsize(tmp_path / "d.png") > 0


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 9, 16, 17, 36, 64])
@pytest.mark.parametrize("padding", [0, 2, 5])
def test_grid_nrow_and_make_grid_pixel_equal_to_jax(n, padding):
    assert timages.grid_nrow(n) == jimages.grid_nrow(n)
    imgs = np.random.default_rng(n).uniform(size=(n, 5, 4, 3)).astype(np.float32)
    for nrow in (None, timages.grid_nrow(n), int(n ** 0.5), n):
        np.testing.assert_array_equal(
            timages.make_grid(imgs, nrow=nrow, padding=padding, pad_value=0.5),
            jimages.make_grid(imgs, nrow=nrow, padding=padding, pad_value=0.5))


def test_class_conditional_sampling_is_not_ported(models, tmp_path):
    _jm, _p, port = models
    _j, tsched = _scheds()
    for kw in (dict(class_id=1), dict(guidance=2.0)):
        with pytest.raises(NotImplementedError, match="not ported"):
            ddpm_infer_sample(port, None, tsched, n=1, img_size=16, device="cpu",
                              out_path=str(tmp_path / "x.png"), **kw)
        with pytest.raises(NotImplementedError, match="not ported"):
            ddim_infer_sample(port, None, tsched, n=1, img_size=16, device="cpu",
                              out_path=str(tmp_path / "x.png"), **kw)
