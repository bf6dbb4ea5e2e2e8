"""The port's DPM-Solver++(2M) (``sampling/solvers.py``) and its entry
points against the JAX package on the same inputs (float32 U-Net with
carried weights, numpy inputs from a seed):

- the ODE and SDE coefficients against ``dpmpp2m_coefficients`` /
  ``dpmpp2m_sde_coefficients`` and their invariants;
- the ODE loop against JAX's loop on a concrete schedule (the float64 host
  route of the coefficients) with an analytic ``eps_fn``;
- ``dpmpp_from_init`` against ``_dpmpp_from_init_jit``, which takes the
  schedule as a jit argument and so builds the coefficients in-graph in
  float32;
- the SDE loop fed JAX's own per-step draws (``fold_in(key, i)``);
- the two-point ladder against one DDIM eta = 0 step;
- ``dpmpp_infer_sample`` against the JAX loop started from the port's x_T.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_diffusion_model_tpu.models import UNetConfig as JaxUNetConfig
from ddpm_diffusion_model_tpu.models import UNetDenoiser as JaxUNet
from ddpm_diffusion_model_tpu.ops import schedules as js
from ddpm_diffusion_model_tpu.sampling import loops as jl
from ddpm_diffusion_model_tpu.sampling import solvers as jsolv
from ddpm_diffusion_model_tpu.sampling.inference import _dpmpp_from_init_jit
from ddpm_diffusion_model_tpu.utils import images as jimages
from ddpm_diffusion_model_tpu_torch.models import UNetConfig, UNetDenoiser
from ddpm_diffusion_model_tpu_torch.ops import diffusion as td
from ddpm_diffusion_model_tpu_torch.ops import schedules as ts
from ddpm_diffusion_model_tpu_torch.sampling import (build_ddim_schedule, cfg_eps_fn,
                                                     dpmpp_from_init, dpmpp_infer_sample,
                                                     to_unit_interval)
from ddpm_diffusion_model_tpu_torch.sampling import solvers as tsolv
from ddpm_diffusion_model_tpu_torch.utils.interop import jax_params_to_state_dict

torch.set_num_threads(1)

T = 100
SMALL = dict(base_channels=32, channel_mults=(1, 2), num_res_blocks=1,
             attn_resolutions=(8,), time_embed_dim=64, num_heads=2,
             head_dim=16, img_resolution=16)
# U-Net trajectories: every forward agrees to ~1e-5 (test_torch_unet.py
# holds 1e-4); over <= 10 steps the solvers' O(1..10) coefficients keep
# the states within 1e-4 absolute on O(1) values
TRAJ_TOL = 1e-4
# analytic eps_fn: the same float32 arithmetic in both frameworks, so only
# the last-ulp rounding of the step's fused combinations differs
ANALYTIC_TOL = 1e-5

LADDERS = {
    "t_linear_10": lambda: build_ddim_schedule("t_linear", 10, T),
    "karras_7": lambda: build_ddim_schedule("karras", 7, T),
    "two_point": lambda: np.array([60, 20], np.int32),
    "three_point": lambda: np.array([99, 50, 0], np.int32),
}


def _scheds(**kw):
    cfg = dict(T=T, img_size=16, **kw)
    return (js.make_schedule(js.DiffusionConfig(**cfg)),
            ts.make_schedule(ts.DiffusionConfig(**cfg), device="cpu"))


@pytest.fixture(scope="module")
def models():
    jm = JaxUNet(JaxUNetConfig(**SMALL), dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.key(4), jnp.ones((1, 16, 16, 3)),
                              jnp.zeros((1,)))
    port = UNetDenoiser(UNetConfig(**SMALL), dtype=torch.float32, device="cpu")
    port.load_state_dict(jax_params_to_state_dict(params, port.config), strict=True)
    return jm, params, port.eval()


def _x(seed, n=2):
    return np.random.default_rng(seed).normal(size=(n, 16, 16, 3)).astype(np.float32)


def _gaussian_eps(sched_table, lib, s=0.5):
    """The exact noise predictor of x0 ~ N(0, s^2 I), in ``lib`` (jnp or
    torch) over the schedule's float32 alphas_cumprod."""
    def eps_fn(x, t):
        ab_t = sched_table[t].reshape(-1, *([1] * (x.ndim - 1)))
        return lib.sqrt(1.0 - ab_t) * x / (ab_t * s**2 + 1.0 - ab_t)

    return eps_fn


# ---------------------------------------------------------------- coefficients


@pytest.mark.parametrize("ladder", sorted(LADDERS))
@pytest.mark.parametrize("lof", [True, False], ids=["lof", "no_lof"])
def test_coefficients_equal_jax(ladder, lof):
    """Both sides evaluate the same float64 numpy expressions on the same
    float32 table: equal bit for bit."""
    jsched, tsched = _scheds()
    lad = LADDERS[ladder]()
    for ours, theirs in ((tsolv.dpmpp2m_coefficients(tsched, lad, lower_order_final=lof),
                          jsolv.dpmpp2m_coefficients(jsched, lad, lower_order_final=lof)),
                         (tsolv.dpmpp2m_sde_coefficients(tsched, lad, lower_order_final=lof),
                          jsolv.dpmpp2m_sde_coefficients(jsched, lad,
                                                         lower_order_final=lof))):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert a.dtype == np.float32 and a.shape == (len(lad) - 1,)
            np.testing.assert_array_equal(a, b)


def test_coefficient_invariants_and_degenerate_ladders():
    _j, tsched = _scheds()
    lad = build_ddim_schedule("t_linear", 20, T)
    ab = tsched.alphas_cumprod.numpy().astype(np.float64)[lad]
    sigma = np.sqrt(1.0 - ab)
    c_skip, c_lin, corr = tsolv.dpmpp2m_coefficients(tsched, lad)
    assert corr[0] == 0.0 and corr[-1] == 0.0 and (corr[1:-1] > 0).all()
    assert (c_skip > 0).all() and (c_lin > 0).all()
    s_skip, s_lin, s_corr, s_noise = tsolv.dpmpp2m_sde_coefficients(tsched, lad)
    np.testing.assert_array_equal(s_corr, corr)
    # the SDE keeps the marginal variance: c_skip^2 sigma_cur^2 + c_noise^2 =
    # sigma_next^2, to float32 rounding of the coefficients
    np.testing.assert_allclose(s_skip.astype(np.float64) ** 2 * sigma[:-1] ** 2
                               + s_noise.astype(np.float64) ** 2, sigma[1:] ** 2,
                               rtol=1e-6)
    for bad in (np.array([50]), np.zeros((2, 2), np.int32)):
        with pytest.raises(ValueError, match=">=2 descending"):
            tsolv.dpmpp2m_coefficients(tsched, bad)
        with pytest.raises(ValueError, match=">=2 descending"):
            tsolv.dpmpp2m_sde_coefficients(tsched, bad)


# ---------------------------------------------------------------- the loops


@pytest.mark.parametrize("ladder", sorted(LADDERS))
@pytest.mark.parametrize("clamp", [True, False], ids=["clamp", "free"])
def test_ode_loop_matches_jax_host_route(ladder, clamp):
    """The JAX loop on a concrete schedule takes the float64 host
    coefficients, as the port always does."""
    jsched, tsched = _scheds(clamp_x0=clamp)
    lad = LADDERS[ladder]()
    x = _x(1) * 1.5
    want = jsolv.dpmpp2m_sample_loop(
        jsched, _gaussian_eps(jnp.asarray(jsched.alphas_cumprod), jnp), jnp.asarray(x),
        timesteps=lad)
    got = tsolv.dpmpp2m_sample_loop(
        tsched, _gaussian_eps(tsched.alphas_cumprod, torch), torch.from_numpy(x),
        timesteps=lad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ANALYTIC_TOL)


def test_two_point_ladder_equals_one_ddim_step():
    """First-order consistency: alpha_next e^-h = sigma_next alpha_cur /
    sigma_cur, so one DPM-Solver++ step with D = x0 is one DDIM eta=0
    step."""
    _j, tsched = _scheds()
    x = torch.from_numpy(_x(2))
    eps = _gaussian_eps(tsched.alphas_cumprod, torch)
    for lad in ([60, 20], [99, 0], [30, 29]):
        got = tsolv.dpmpp2m_sample_loop(tsched, eps, x, timesteps=np.array(lad))
        t = torch.full((2,), lad[0])
        tp = torch.full((2,), lad[1])
        want = td.ddim_step(tsched, eps, x, t, tp, torch.zeros_like(x), eta=0.0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ANALYTIC_TOL)


@pytest.mark.parametrize("ladder", ["t_linear_10", "karras_7"])
def test_sde_loop_with_jaxs_draws_matches_jax(ladder):
    """JAX draws step i's noise from fold_in(key, i); fed those values the
    port's SDE loop follows JAX's."""
    jsched, tsched = _scheds()
    lad = LADDERS[ladder]()
    x = _x(3)
    key = jax.random.key(11)
    want = jsolv.dpmpp2m_sde_sample_loop(
        jsched, _gaussian_eps(jnp.asarray(jsched.alphas_cumprod), jnp), jnp.asarray(x),
        key, timesteps=lad)
    noises = [torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key, jnp.uint32(i)), x.shape, dtype=jnp.float32)))
        for i in range(len(lad) - 1)]
    got = tsolv.dpmpp2m_sde_sample_loop(
        tsched, _gaussian_eps(tsched.alphas_cumprod, torch), torch.from_numpy(x),
        noises=noises, timesteps=lad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ANALYTIC_TOL)


def test_sde_draws_from_the_generator_after_each_evaluation():
    """Without ``noises`` transition i draws its z from ``generator``, in
    order: the same values injected give the same bits; another seed
    another result."""
    _j, tsched = _scheds()
    lad = build_ddim_schedule("t_linear", 6, T)
    x = torch.from_numpy(_x(4))
    eps = _gaussian_eps(tsched.alphas_cumprod, torch)
    a = tsolv.dpmpp2m_sde_sample_loop(tsched, eps, x, timesteps=lad,
                                      generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    noises = [torch.randn(x.shape, generator=gen) for _ in range(len(lad) - 1)]
    b = tsolv.dpmpp2m_sde_sample_loop(tsched, eps, x, timesteps=lad, noises=noises)
    assert torch.equal(a, b)
    c = tsolv.dpmpp2m_sde_sample_loop(tsched, eps, x, timesteps=lad,
                                      generator=torch.Generator().manual_seed(6))
    assert (a - c).abs().max() > 1e-3


# ------------------------------------------------------- the U-Net entry points


@pytest.mark.parametrize("kind,steps", [("t_linear", 10), ("karras", 6)])
def test_dpmpp_from_init_matches_jax_in_graph_route(models, kind, steps):
    """``_dpmpp_from_init_jit`` passes the schedule as a jit argument, so
    its coefficients are built in float32 in-graph; the port's are the
    float64 host values cast to float32.  Both differ from each other by
    float32 rounding of O(1) coefficients, well inside TRAJ_TOL."""
    jm, params, port = models
    jsched, tsched = _scheds()
    lad = build_ddim_schedule(kind, steps, T, alphas_cumprod=tsched.alphas_cumprod.numpy())
    x = _x(6, n=3)
    want = _dpmpp_from_init_jit(jm, params, jsched, jnp.asarray(x),
                                tuple(int(t) for t in lad))
    got = dpmpp_from_init(port, tsched, torch.from_numpy(x), lad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TRAJ_TOL)
    # row i depends on row i only: what lets the server coalesce requests;
    # the batch changes only the convs' summation order (last ulps)
    solo = dpmpp_from_init(port, tsched, torch.from_numpy(x[1:2]), lad)
    np.testing.assert_allclose(solo.numpy(), got[1:2].numpy(), atol=1e-5)


def test_dpmpp_infer_sample_matches_jax_from_the_ports_x_t(models, tmp_path):
    """The grid entry point draws x_T as ``ddim_infer_sample`` does (the
    seed's first draw); the JAX loop started from it gives the same grid."""
    jm, params, port = models
    jsched, tsched = _scheds()
    n, seed, steps = 4, 7, 8
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, 16, 16, 3), generator=gen).numpy()
    lad = build_ddim_schedule("t_linear", steps, T)
    apply = jax.jit(jm.apply)
    want = jsolv.dpmpp2m_sample_loop(jsched, lambda xt, t: apply(params, xt, t),
                                     jnp.asarray(x), timesteps=lad, clip_x0=True)
    grid = dpmpp_infer_sample(port, None, tsched, n=n, img_size=16, seed=seed, steps=steps,
                              out_path=str(tmp_path / "d.png"), save_individual=True,
                              out_dir=str(tmp_path / "ind"), device="cpu")
    np.testing.assert_allclose(
        grid, jimages.make_grid(np.asarray(jl.to_unit_interval(want)),
                                nrow=jimages.grid_nrow(n)), atol=TRAJ_TOL)
    assert (tmp_path / "d.png").stat().st_size > 0
    assert len(list((tmp_path / "ind").iterdir())) == n


def test_dpmpp_infer_sample_sde_draws_after_x_t(models, tmp_path):
    """``sde=True`` takes x_T and then one draw per transition from the
    seed's generator, in that order."""
    _jm, _p, port = models
    _j, tsched = _scheds()
    n, seed, steps = 2, 3, 5
    lad = build_ddim_schedule("t_linear", steps, T)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, 16, 16, 3), generator=gen)
    noises = [torch.randn(x.shape, generator=gen) for _ in range(len(lad) - 1)]
    with torch.inference_mode():
        want = tsolv.dpmpp2m_sde_sample_loop(tsched, cfg_eps_fn(port, tsched), x,
                                             noises=noises, timesteps=lad, clip_x0=True)
    grid = dpmpp_infer_sample(port, None, tsched, n=n, img_size=16, seed=seed, steps=steps,
                              sde=True, out_path=str(tmp_path / "s.png"), device="cpu")
    np.testing.assert_array_equal(
        grid, jimages.make_grid(to_unit_interval(want).numpy(), nrow=2))
    ode = dpmpp_infer_sample(port, None, tsched, n=n, img_size=16, seed=seed, steps=steps,
                             out_path=str(tmp_path / "o.png"), device="cpu")
    assert np.abs(ode - grid).max() > 1e-3


def test_class_conditional_dpmpp_is_not_ported(models, tmp_path):
    _jm, _p, port = models
    _j, tsched = _scheds()
    for kw in (dict(class_id=1), dict(guidance=2.0)):
        with pytest.raises(NotImplementedError, match="not ported"):
            dpmpp_infer_sample(port, None, tsched, n=1, img_size=16, device="cpu",
                               out_path=str(tmp_path / "x.png"), **kw)
