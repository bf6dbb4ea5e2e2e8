"""The port's encoder-cached DDIM (``sampling/fast.py``) against the JAX
package on the same inputs (a float32 U-Net with carried weights, numpy
inputs from a seed):

- ``refresh_every=1`` bit-equal to ``ddim_sample_loop``, at eta 0 and with
  the same generator at eta > 0;
- ``refresh_every`` 2 and 3 against JAX's ``ddim_sample_loop_cached`` at
  eta = 0, on an eps- and a v-predicting schedule, and at eta = 0.5 fed
  JAX's own draws (``fold_in(key, t_cur)``);
- the forwards by mode (full on refresh steps, decode between);
- ``ddim_sample_fast`` from the same x_T as ``ddim_sample``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_diffusion_model_tpu.models import UNetConfig as JaxUNetConfig
from ddpm_diffusion_model_tpu.models import UNetDenoiser as JaxUNet
from ddpm_diffusion_model_tpu.ops import schedules as js
from ddpm_diffusion_model_tpu.sampling import fast as jfast
from ddpm_diffusion_model_tpu_torch.models import UNetConfig, UNetDenoiser
from ddpm_diffusion_model_tpu_torch.ops import schedules as ts
from ddpm_diffusion_model_tpu_torch.sampling import (build_ddim_schedule, cfg_eps_fn,
                                                     ddim_sample, ddim_sample_fast,
                                                     ddim_sample_loop,
                                                     ddim_sample_loop_cached)
from ddpm_diffusion_model_tpu_torch.utils.interop import jax_params_to_state_dict

torch.set_num_threads(1)

T = 100
RES = 16
SMALL = dict(base_channels=32, channel_mults=(1, 2), num_res_blocks=1,
             attn_resolutions=(8,), time_embed_dim=64, num_heads=2,
             head_dim=16, img_resolution=RES)
# every forward (full or decode) agrees to ~1e-5 (test_torch_unet.py holds
# 1e-4); over <= 8 DDIM steps the states stay within 1e-4 on O(1) values
TRAJ_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = JaxUNet(JaxUNetConfig(**SMALL), dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.key(8), jnp.ones((1, RES, RES, 3)),
                              jnp.zeros((1,)))
    port = UNetDenoiser(UNetConfig(**SMALL), dtype=torch.float32, device="cpu")
    port.load_state_dict(jax_params_to_state_dict(params, port.config), strict=True)
    return jm, params, port.eval()


def _scheds(prediction_type="epsilon"):
    cfg = dict(T=T, img_size=RES, prediction_type=prediction_type)
    return (js.make_schedule(js.DiffusionConfig(**cfg)),
            ts.make_schedule(ts.DiffusionConfig(**cfg), device="cpu"))


def _x(seed, n=2):
    return np.random.default_rng(seed).normal(size=(n, RES, RES, 3)).astype(np.float32)


def _modes(model):
    """Count the model's forwards by mode; returns the counter and the
    hook's handle."""
    seen = {"full": 0, "decode": 0}

    def hook(_m, _args, kwargs):
        seen[kwargs.get("mode", "full")] += 1

    return seen, model.register_forward_pre_hook(hook, with_kwargs=True)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_refresh_every_1_is_ddim_sample_loop_bit_for_bit(models, eta):
    _jm, _p, port = models
    _j, tsched = _scheds()
    lad = build_ddim_schedule("t_linear", 8, T)
    x = torch.from_numpy(_x(1))
    with torch.inference_mode():
        got = ddim_sample_loop_cached(port, None, tsched, x, timesteps=lad, eta=eta,
                                      refresh_every=1, clip_x0=True,
                                      generator=torch.Generator().manual_seed(3))
        want, _ = ddim_sample_loop(tsched, cfg_eps_fn(port, tsched), x, timesteps=lad,
                                   eta=eta, clip_x0=True,
                                   generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, want)


@pytest.mark.parametrize("refresh", [2, 3])
@pytest.mark.parametrize("pred", ["epsilon", "v"])
def test_cached_matches_jax_at_eta0(models, refresh, pred):
    jm, params, port = models
    jsched, tsched = _scheds(pred)
    lad = build_ddim_schedule("t_linear", 8, T)
    x = _x(2)
    want = jfast.ddim_sample_loop_cached(jm, params, jsched, jnp.asarray(x),
                                         jax.random.key(0), timesteps=lad, eta=0.0,
                                         refresh_every=refresh, clip_x0=True)
    seen, handle = _modes(port)
    try:
        with torch.inference_mode():
            got = ddim_sample_loop_cached(port, None, tsched, torch.from_numpy(x),
                                          timesteps=lad, refresh_every=refresh,
                                          clip_x0=True)
    finally:
        handle.remove()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TRAJ_TOL)
    n_steps = len(lad) - 1
    full = len(range(0, n_steps, refresh))
    assert seen == {"full": full, "decode": n_steps - full}
    with torch.inference_mode():
        exact, _ = ddim_sample_loop(tsched, cfg_eps_fn(port, tsched), torch.from_numpy(x),
                                    timesteps=lad, clip_x0=True)
    # reuse steps change the result, and stay near the exact trajectory
    assert 1e-6 < float((got - exact).abs().max()) < 0.5


def test_cached_eta_positive_with_jaxs_draws(models):
    jm, params, port = models
    jsched, tsched = _scheds()
    lad = build_ddim_schedule("karras", 6, T)
    x = _x(3)
    key = jax.random.key(7)
    want = jfast.ddim_sample_loop_cached(jm, params, jsched, jnp.asarray(x), key,
                                         timesteps=lad, eta=0.5, refresh_every=2,
                                         clip_x0=True)
    noises = [torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key, int(t)), x.shape, dtype=jnp.float32))) for t in lad[:-1]]
    with torch.inference_mode():
        got = ddim_sample_loop_cached(port, None, tsched, torch.from_numpy(x),
                                      timesteps=lad, eta=0.5, refresh_every=2,
                                      clip_x0=True, noises=noises)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TRAJ_TOL)


def test_short_ladder_returns_x_init(models):
    _jm, _p, port = models
    _j, tsched = _scheds()
    x = torch.from_numpy(_x(4))
    seen, handle = _modes(port)
    try:
        out = ddim_sample_loop_cached(port, None, tsched, x, timesteps=np.array([40]))
    finally:
        handle.remove()
    assert out is x and seen == {"full": 0, "decode": 0}


def test_ddim_sample_fast_starts_from_ddim_samples_x_t(models, tmp_path):
    """refresh_every=1 is ``ddim_sample`` exactly (same seed, same x_T);
    refresh_every=2 stays close; ``ema_params`` run in place of the
    model's weights; the grid goes to ``save_path``."""
    _jm, _p, port = models
    _j, tsched = _scheds()
    kw = dict(n=4, img_size=RES, seed=5, steps=8, schedule_kind="t_linear", device="cpu")
    plain = ddim_sample(port, None, tsched, n=4, img_size=RES, seed=5, steps=8,
                        schedule="t_linear", device="cpu")
    one = ddim_sample_fast(port, None, tsched, refresh_every=1, **kw)
    np.testing.assert_array_equal(one, plain)
    two = ddim_sample_fast(port, None, tsched, refresh_every=2,
                           save_path=str(tmp_path / "f.png"), **kw)
    assert two.shape == (4, RES, RES, 3) and 0.0 <= two.min() and two.max() <= 1.0
    assert 0.0 < np.abs(two - plain).max() < 0.25
    assert (tmp_path / "f.png").stat().st_size > 0
    shadow = {k: v * 0.5 for k, v in port.named_parameters()}
    ema = ddim_sample_fast(port, None, tsched, refresh_every=2, ema_params=shadow, **kw)
    np.testing.assert_array_equal(
        ema, ddim_sample_fast(port, shadow, tsched, refresh_every=2, **kw))
    assert np.abs(ema - two).max() > 1e-3
