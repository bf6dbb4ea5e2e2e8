"""The port's image editing (``sampling/editing.py``) against the JAX
package on the same inputs: a float32 U-Net with carried weights, numpy
images from a seed, and every random draw JAX's own (its keys rebuilt here
and the values injected into the port):

- ``truncate_ladder`` and ``box_mask`` equal JAX's, errors included;
- img2img (eta 0 and 0.5) and inpaint (``resamples`` 1 and 2, eta 0 and
  0.5) against ``img2img_sample_loop`` / ``inpaint_sample_loop``;
- inpaint's known region equal to the input bit for bit; an all-known mask
  is the identity; an all-generated mask is plain DDIM;
- the entry points against the loops fed the seed's draws, in the order
  the entry points take them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_diffusion_model_tpu.models import UNetConfig as JaxUNetConfig
from ddpm_diffusion_model_tpu.models import UNetDenoiser as JaxUNet
from ddpm_diffusion_model_tpu.ops import schedules as js
from ddpm_diffusion_model_tpu.sampling import editing as jed
from ddpm_diffusion_model_tpu.utils import images as jimages
from ddpm_diffusion_model_tpu_torch.models import UNetConfig, UNetDenoiser
from ddpm_diffusion_model_tpu_torch.ops import schedules as ts
from ddpm_diffusion_model_tpu_torch.sampling import (build_ddim_schedule, cfg_eps_fn,
                                                     ddim_sample_loop, to_unit_interval)
from ddpm_diffusion_model_tpu_torch.sampling import editing as ted
from ddpm_diffusion_model_tpu_torch.utils.interop import jax_params_to_state_dict

torch.set_num_threads(1)

T = 100
RES = 16
SMALL = dict(base_channels=32, channel_mults=(1, 2), num_res_blocks=1,
             attn_resolutions=(8,), time_embed_dim=64, num_heads=2,
             head_dim=16, img_resolution=RES)
# every U-Net forward agrees to ~1e-5 (test_torch_unet.py holds 1e-4); over
# <= 6 steps (12 forwards with a repeat) the DDIM and re-noising
# coefficients keep the states within 1e-4 absolute on O(1) values
TRAJ_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = JaxUNet(JaxUNetConfig(**SMALL), dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.key(6), jnp.ones((1, RES, RES, 3)),
                              jnp.zeros((1,)))
    port = UNetDenoiser(UNetConfig(**SMALL), dtype=torch.float32, device="cpu")
    port.load_state_dict(jax_params_to_state_dict(params, port.config), strict=True)
    apply = jax.jit(jm.apply)
    return (lambda xt, t: apply(params, xt, t)), port.eval()


@pytest.fixture(scope="module")
def scheds():
    cfg = dict(T=T, img_size=RES)
    return (js.make_schedule(js.DiffusionConfig(**cfg)),
            ts.make_schedule(ts.DiffusionConfig(**cfg), device="cpu"))


def _images(seed, n=2):
    return np.tanh(np.random.default_rng(seed).normal(size=(n, RES, RES, 3))
                   ).astype(np.float32)


def _normal(key, shape):
    return np.array(jax.random.normal(key, shape, dtype=jnp.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mask():
    m = np.ones((RES, RES, 1), np.float32)
    m[4:11, 3:13] = 0.0
    return m


# ---------------------------------------------------------- ladders and masks


@pytest.mark.parametrize("steps", [5, 20, 50])
@pytest.mark.parametrize("strength", [0.001, 0.05, 0.3, 0.5, 0.6, 0.95, 1.0])
def test_truncate_ladder_equals_jax(steps, strength):
    lad = build_ddim_schedule("t_linear", steps, T)
    got = ted.truncate_ladder(lad, strength)
    np.testing.assert_array_equal(got, jed.truncate_ladder(lad, strength))
    assert len(got) >= 2 and got[-1] == lad[-1]


@pytest.mark.parametrize("bad", [0.0, -0.3, 1.5])
def test_truncate_ladder_rejects_bad_strength(bad):
    with pytest.raises(ValueError, match="strength"):
        ted.truncate_ladder(build_ddim_schedule("t_linear", 10, T), bad)


@pytest.mark.parametrize("box", [(0, 0, 16, 16), (4, 2, 9, 15), (15, 15, 16, 16)])
@pytest.mark.parametrize("channels", [1, 3])
def test_box_mask_equals_jax(box, channels):
    np.testing.assert_array_equal(ted.box_mask(RES, box, channels),
                                  jed.box_mask(RES, box, channels))


@pytest.mark.parametrize("box", [(4, 4, 4, 8), (0, 0, 17, 8), (-1, 0, 4, 4), (8, 9, 4, 10)])
def test_box_mask_rejects_bad_boxes(box):
    with pytest.raises(ValueError, match="out of bounds"):
        ted.box_mask(RES, box)
    with pytest.raises(ValueError, match="out of bounds"):
        jed.box_mask(RES, box)


# ---------------------------------------------------------- loops against JAX


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_img2img_matches_jax_with_jaxs_draws(models, scheds, eta):
    """JAX splits the key into the q_sample draw and the loop's key, whose
    step i noise is fold_in(k_loop, ts[i])."""
    jeps, port = models
    jsched, tsched = scheds
    lad = ted.truncate_ladder(build_ddim_schedule("t_linear", 10, T), 0.6)
    x0 = _images(1)
    key = jax.random.key(3)
    want = jed.img2img_sample_loop(jsched, jeps, jnp.asarray(x0), key,
                                   timesteps=lad, eta=eta, clip_x0=True)
    k_noise, k_loop = jax.random.split(key)
    noise = _normal(k_noise, x0.shape)
    noises = [_t(_normal(jax.random.fold_in(k_loop, int(t)), x0.shape)) for t in lad]
    with torch.inference_mode():
        got = ted.img2img_sample_loop(tsched, cfg_eps_fn(port, tsched), _t(x0),
                                      timesteps=lad, eta=eta, clip_x0=True,
                                      noise=_t(noise), noises=noises)
    assert len(lad) == 6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TRAJ_TOL)


def _jax_inpaint_draws(key, ladder, R, shape):
    """JAX's draws per (step, repeat): split(fold_in(fold_in(key, t_cur), r),
    3) -> (z_known, z_ddim, z_back)."""
    n_iter = len(ladder) - 1 if len(ladder) > 1 else 1
    out = []
    for i in range(n_iter):
        k_step = jax.random.fold_in(key, int(ladder[i]))
        out.append([[_t(_normal(k, shape)) for k in
                     jax.random.split(jax.random.fold_in(k_step, r), 3)] for r in range(R)])
    return out


@pytest.mark.parametrize("resamples,eta", [(1, 0.0), (2, 0.0), (2, 0.5)])
def test_inpaint_matches_jax_with_jaxs_draws(models, scheds, resamples, eta):
    jeps, port = models
    jsched, tsched = scheds
    lad = build_ddim_schedule("t_linear", 5, T)
    known, mask = _images(2), _mask()
    x_init = np.random.default_rng(3).normal(size=known.shape).astype(np.float32)
    key = jax.random.key(5)
    want = np.asarray(jed.inpaint_sample_loop(
        jsched, jeps, jnp.asarray(known), jnp.asarray(mask), jnp.asarray(x_init), key,
        timesteps=lad, eta=eta, resamples=resamples, clip_x0=True))
    with torch.inference_mode():
        got = ted.inpaint_sample_loop(
            tsched, cfg_eps_fn(port, tsched), _t(known), mask, _t(x_init),
            timesteps=lad, eta=eta, resamples=resamples, clip_x0=True,
            noises=_jax_inpaint_draws(key, lad, resamples, known.shape)).numpy()
    np.testing.assert_allclose(got, want, atol=TRAJ_TOL)
    keep = np.broadcast_to(mask, known.shape) == 1.0
    # the final paste keeps the known pixels bit for bit, on both sides
    np.testing.assert_array_equal(got[keep], known[keep])
    np.testing.assert_array_equal(want[keep], known[keep])
    assert np.abs(got[~keep] - known[~keep]).max() > 1e-2


@pytest.mark.parametrize("resamples", [1, 2])
def test_inpaint_all_known_is_the_identity(models, scheds, resamples):
    _jeps, port = models
    _j, tsched = scheds
    known = _images(4)
    with torch.inference_mode():
        got = ted.inpaint_sample_loop(
            tsched, cfg_eps_fn(port, tsched), _t(known), np.ones((RES, RES, 1), np.float32),
            torch.randn(known.shape, generator=torch.Generator().manual_seed(1)),
            timesteps=build_ddim_schedule("t_linear", 4, T), resamples=resamples,
            generator=torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(got.numpy(), known)


def test_inpaint_nothing_known_is_plain_ddim(models, scheds):
    """mask = 0 everywhere: 0 * x_known + 1 * x is x, so every step is the
    DDIM grid loop's, and the paste returns x: bit-equal at eta = 0."""
    _jeps, port = models
    _j, tsched = scheds
    known, lad = _images(5), build_ddim_schedule("t_linear", 5, T)
    x_init = torch.randn(known.shape, generator=torch.Generator().manual_seed(3))
    eps_fn = cfg_eps_fn(port, tsched)
    with torch.inference_mode():
        got = ted.inpaint_sample_loop(tsched, eps_fn, _t(known),
                                      np.zeros((RES, RES, 1), np.float32), x_init,
                                      timesteps=lad, clip_x0=True,
                                      generator=torch.Generator().manual_seed(4))
        want, _ = ddim_sample_loop(tsched, eps_fn, x_init, timesteps=lad, clip_x0=True)
    assert torch.equal(got, want)


def test_inpaint_rejects_bad_resamples(models, scheds):
    _jeps, port = models
    _j, tsched = scheds
    x = torch.zeros(1, RES, RES, 3)
    with pytest.raises(ValueError, match="resamples"):
        ted.inpaint_sample_loop(tsched, cfg_eps_fn(port), x, np.ones((RES, RES, 1)), x,
                                timesteps=np.array([50, 0]), resamples=0)


# ---------------------------------------------------------- the entry points


def test_img2img_infer_sample_draws_from_the_seed(models, scheds, tmp_path):
    """One image and n = 3: three rows, each its own noise; the q_sample
    draw comes first from the seed's generator (eta = 0 draws nothing
    else); the grid goes to ``out_path``."""
    _jeps, port = models
    _j, tsched = scheds
    init = _images(6, n=1)[0]
    lad = ted.truncate_ladder(build_ddim_schedule("t_linear", 8, T), 0.5)
    out = tmp_path / "i.png"
    got = ted.img2img_infer_sample(port, None, tsched, init, n=3, strength=0.5, steps=8,
                                   seed=9, out_path=str(out), device="cpu")
    gen = torch.Generator().manual_seed(9)
    batch = _t(np.broadcast_to(init, (3, RES, RES, 3)))
    noise = torch.randn(batch.shape, generator=gen)
    with torch.inference_mode():
        want = ted.img2img_sample_loop(tsched, cfg_eps_fn(port, tsched), batch,
                                       timesteps=lad, clip_x0=True, noise=noise)
    np.testing.assert_array_equal(got, to_unit_interval(want).numpy())
    assert got.shape == (3, RES, RES, 3) and np.abs(got[0] - got[1]).max() > 1e-3
    from PIL import Image

    assert np.asarray(Image.open(out)).shape == jimages.make_grid(got, nrow=2).shape
    with pytest.raises(ValueError, match="batch 2 but n=3"):
        ted.img2img_infer_sample(port, None, tsched, _images(7), n=3, device="cpu",
                                 out_path=None)


def test_inpaint_infer_sample_draws_from_the_seed(models, scheds):
    """x_T is the seed's first draw, then each repeat's z_known and (before
    another repeat) z_back, in that order at eta = 0."""
    _jeps, port = models
    _j, tsched = scheds
    known, mask = _images(8), _mask()
    lad = build_ddim_schedule("t_linear", 4, T)
    got = ted.inpaint_infer_sample(port, None, tsched, known, mask, steps=4, resamples=2,
                                   seed=10, out_path=None, device="cpu")
    gen = torch.Generator().manual_seed(10)
    x_init = torch.randn(known.shape, generator=gen)
    draws = []
    for _ in range(len(lad) - 1):
        z_known0 = torch.randn(known.shape, generator=gen)
        z_back = torch.randn(known.shape, generator=gen)
        z_known1 = torch.randn(known.shape, generator=gen)
        zero = torch.zeros(known.shape)
        draws.append([(z_known0, zero, z_back), (z_known1, zero, None)])
    with torch.inference_mode():
        want = ted.inpaint_sample_loop(tsched, cfg_eps_fn(port, tsched), _t(known), mask,
                                       x_init, timesteps=lad, resamples=2, clip_x0=True,
                                       noises=draws)
    np.testing.assert_array_equal(got, to_unit_interval(want).numpy())


def test_class_conditional_editing_is_not_ported(models, scheds):
    _jeps, port = models
    _j, tsched = scheds
    for kw in (dict(class_id=1), dict(guidance=2.0)):
        with pytest.raises(NotImplementedError, match="not ported"):
            ted.img2img_infer_sample(port, None, tsched, _images(1), device="cpu",
                                     out_path=None, **kw)
        with pytest.raises(NotImplementedError, match="not ported"):
            ted.inpaint_infer_sample(port, None, tsched, _images(1), _mask(), device="cpu",
                                     out_path=None, **kw)
