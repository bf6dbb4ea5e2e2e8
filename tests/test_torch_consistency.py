"""The port's consistency distillation (``training/consistency.py``) against
the JAX package's on the same numpy inputs, float32, weights carried by
``jax_params_to_state_dict`` (the tiny U-Nets of
``tests/test_torch_distill.py``):

- the ladder and its errors, message for message; ``consistency_scalings``
  and ``_distance`` (pseudo-Huber and L2) within 1e-6 relative;
- ``consistency_fn`` at the U-Net bar of 1e-4, and f(z_0, 0) == z_0 bit for
  bit;
- one update on JAX's own draws: loss 1e-5 and grad norm 1e-4 relative,
  params and EMA by ``_assert_adam_moves_close`` over the whole parameter
  vector, unconditional (both distances) and conditional with guidance;
  the EMA is the target network;
- ``consistency_sample_loop`` at steps 1 and 3 fed JAX's splits of the
  key (1e-4), ``cm_from_init`` equal to the loop at one step and row by row
  independent of its batch;
- ``consistency_distill``'s ``info`` with JAX's keys (JAX's own
  ``consistency_distill`` on a stub step)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_distill import (LABELS, RES, STEP_KW, T, Carried, _rel, _scheds,
                                _stub_jax_step, _x, check_update_equals_jax)

from ddpm_diffusion_model_tpu.training import consistency as jcm
from ddpm_diffusion_model_tpu.training import state as jax_state
from ddpm_diffusion_model_tpu_torch.training import consistency as tcm
from ddpm_diffusion_model_tpu_torch.training import TrainConfig, init_train_state

torch.set_num_threads(2)

K = 3


@pytest.fixture(scope="module")
def uncond():
    return Carried(0)


@pytest.fixture(scope="module")
def cond():
    return Carried(K)


def test_constants_equal_jax():
    assert (tcm.SIGMA_DATA, tcm.TIMESTEP_SCALING, tcm.PSEUDO_HUBER_FACTOR) == \
        (jcm.SIGMA_DATA, jcm.TIMESTEP_SCALING, jcm.PSEUDO_HUBER_FACTOR)


@pytest.mark.parametrize("T_,N", [(100, 1), (100, 3), (100, 32), (1000, 32), (20, 19),
                                  (0, 1), (100, 0), (10, 10)])
def test_ladder_and_errors_equal_jax(T_, N):
    try:
        want = jcm.consistency_ladder(T_, N)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tcm.consistency_ladder(T_, N)
        assert str(got.value) == str(e)
        return
    got = tcm.consistency_ladder(T_, N)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sd,s", [(tcm.SIGMA_DATA, tcm.TIMESTEP_SCALING), (0.3, 2.5)])
def test_scalings_equal_jax_and_pin_the_boundary(sd, s):
    t = np.array([0, 1, 2, 5, 10, 50, 99, 999], np.int32)
    cs_j, co_j = jcm.consistency_scalings(jnp.asarray(t), sigma_data=sd, timestep_scaling=s)
    cs, co = tcm.consistency_scalings(torch.from_numpy(t), sigma_data=sd,
                                      timestep_scaling=s)
    assert cs.dtype == co.dtype == torch.float32
    assert _rel(cs.numpy(), cs_j) <= 1e-6 and _rel(co.numpy(), co_j) <= 1e-6
    assert float(cs[0]) == 1.0 and float(co[0]) == 0.0


@pytest.mark.parametrize("kind", ["pseudo_huber", "l2"])
def test_distance_equals_jax(kind):
    rng = np.random.default_rng(4)
    a, b = (rng.normal(size=(5, RES, RES, 3)).astype(np.float32) for _ in range(2))
    b[0] = a[0] + 1e-4  # a near-zero distance: the pseudo-Huber's quadratic part
    want = np.asarray(jcm._distance(jnp.asarray(a), jnp.asarray(b), kind))
    got = tcm._distance(torch.from_numpy(a), torch.from_numpy(b), kind).numpy()
    assert got.shape == (5,) and _rel(got, want) <= 1e-6
    assert abs(got[0] - want[0]) <= 1e-6 * abs(want[0])
    with pytest.raises(ValueError, match="unknown consistency distance"):
        tcm._distance(torch.from_numpy(a), torch.from_numpy(b), "l1")


@pytest.mark.parametrize("case", ["unconditional", "conditional"])
def test_consistency_fn_equals_jax_and_the_boundary_is_exact(case, uncond, cond):
    c = uncond if case == "unconditional" else cond
    sj, st = _scheds()
    z = np.random.default_rng(5).normal(size=(4, RES, RES, 3)).astype(np.float32)
    t = np.array([99, 50, 3, 0], np.int32)
    y = None if case == "unconditional" else LABELS
    want = np.asarray(jax.jit(lambda p, z, t, y: jcm.consistency_fn(c.jm, p, sj, z, t, y=y))(
        c.teacher, z, t, None if y is None else jnp.asarray(y)))
    port = c.reset().eval()
    with torch.no_grad():
        yt = None if y is None else torch.from_numpy(y).long()
        got = tcm.consistency_fn(port, c.teacher_t, st, torch.from_numpy(z),
                                 torch.from_numpy(t).long(), y=yt)
        zero = tcm.consistency_fn(port, None, st, torch.from_numpy(z),
                                  torch.zeros(4, dtype=torch.long), y=yt)
    assert got.dtype == torch.float32 and _rel(got.numpy(), want) <= 1e-4
    assert torch.equal(got[3], torch.from_numpy(z[3]))  # t = 0: f(z_0, 0) = z_0
    assert torch.equal(zero, torch.from_numpy(z))


@pytest.mark.parametrize("case,distance", [("unconditional", "pseudo_huber"),
                                           ("unconditional", "l2"),
                                           ("guided", "pseudo_huber")])
def test_consistency_step_equals_jax(case, distance, uncond, cond):
    c, guidance = (uncond, None) if case == "unconditional" else (cond, 3.0)
    ladder = jcm.consistency_ladder(T, 8)
    m = check_update_equals_jax(c, jcm.make_consistency_step, tcm.make_consistency_step,
                                ladder, 8, guidance, distance=distance)
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) > 0


def test_the_ema_is_the_target_network(uncond):
    """The target is f on ``state.ema_params``: at t' = 0 it is z_t' exactly,
    whatever the EMA holds, so shifting the EMA leaves the loss as it was;
    at t' = 40 it runs the EMA's network, so the shift moves the loss."""
    _, st = _scheds()
    port = uncond.reset()
    cfg = TrainConfig(**STEP_KW)
    state, tx = init_train_state(port, cfg, seed=2)
    # a one-segment ladder 1 -> 0: the target is f(z', 0) = z' exactly, so
    # the loss is the distance of the student's f at t = 1 from the teacher's
    # DDIM landing point; shifting the EMA cannot move it
    step = tcm.make_consistency_step(port, st, np.array([1, 0]), tx, cfg)
    d = tcm.DistillDraws(torch.zeros(4, dtype=torch.long),
                         torch.from_numpy(np.random.default_rng(9).normal(
                             size=(4, RES, RES, 3)).astype(np.float32)))
    loss1 = float(step(state, uncond.teacher_t, _x(3), d)[1]["loss"])
    port = uncond.reset()
    state, tx = init_train_state(port, cfg, seed=2)
    for v in state.ema_params.values():
        v.add_(0.05)
    step = tcm.make_consistency_step(port, st, np.array([1, 0]), tx, cfg)
    assert float(step(state, uncond.teacher_t, _x(3), d)[1]["loss"]) == loss1
    # on a two-point ladder from t = 50, the target runs the EMA's network
    losses = []
    for shift in (0.0, 0.05):
        port = uncond.reset()
        state, tx = init_train_state(port, cfg, seed=2)
        for v in state.ema_params.values():
            v.add_(shift)
        step = tcm.make_consistency_step(port, st, np.array([50, 40]), tx, cfg)
        losses.append(float(step(state, uncond.teacher_t, _x(3), d)[1]["loss"]))
    assert losses[0] != losses[1]


# ----------------------------------------------------------------- sampling


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("case", ["unconditional", "conditional"])
def test_sample_loop_equals_jax_on_its_draws(case, steps, uncond, cond):
    """JAX's loop splits its key: x_T from the first half, then one
    normal per refinement from the chain of the second; fed those draws the
    port's loop gives JAX's samples."""
    c = uncond if case == "unconditional" else cond
    sj, st = _scheds()
    shape = (4, RES, RES, 3)
    key = jax.random.key(13)
    y = None if case == "unconditional" else jnp.asarray(LABELS)
    want = np.asarray(jcm.consistency_sample_loop(c.jm, c.teacher, sj, shape, key,
                                                  steps=steps, y=y))
    k0, k = jax.random.split(key)
    x_init = np.array(jax.random.normal(k0, shape, dtype=jnp.float32))
    noises = []
    for _ in range(steps - 1):
        k, kn = jax.random.split(k)
        noises.append(torch.from_numpy(np.array(jax.random.normal(kn, shape,
                                                                  dtype=jnp.float32))))
    got = tcm.consistency_sample_loop(
        c.reset(), c.teacher_t, st, shape, steps=steps,
        y=None if y is None else LABELS, x_init=torch.from_numpy(x_init), noises=noises,
        device="cpu")
    assert got.shape == shape and float(got.abs().max()) <= 1.0
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4


def test_cm_from_init_is_the_one_step_loop_row_by_row(cond):
    _, st = _scheds()
    port = cond.reset()
    shape = (4, RES, RES, 3)
    gen = torch.Generator().manual_seed(21)
    x_init = torch.randn(shape, generator=gen)
    y = torch.from_numpy(LABELS).long()
    loop = tcm.consistency_sample_loop(port, None, st, shape, seed=21, steps=1, y=LABELS,
                                       device="cpu")
    one = tcm.cm_from_init(port, None, st, x_init, y=y)
    assert torch.equal(loop, one)  # x_T is the seed's first draw
    pair = tcm.cm_from_init(port, None, st, torch.cat([x_init[:2], x_init]),
                            y=torch.cat([y[:2], y]))
    assert float((pair[2:] - one).abs().max()) <= 1e-5


def test_sample_loop_refuses_zero_steps(uncond):
    with pytest.raises(ValueError, match="steps must be >= 1, got 0"):
        tcm.consistency_sample_loop(uncond.port, None, _scheds()[1], (1, RES, RES, 3),
                                    steps=0, device="cpu")


def test_consistency_distill_info_equals_jax_keys(uncond, monkeypatch):
    seen_j = []
    monkeypatch.setattr(jcm, "make_consistency_step", _stub_jax_step(seen_j))
    cfg_j = jax_state.TrainConfig(base_lr=1e-3, warmup_steps=0, flat_optimizer=False)
    _p, info_j = jcm.consistency_distill(
        uncond.jm, _scheds()[0], uncond.teacher, make_batches=lambda: [jnp.asarray(_x(0))],
        num_ladder_steps=8, updates=3, cfg=cfg_j, log=None)
    port = uncond.reset()
    params, info = tcm.consistency_distill(
        port, _scheds()[1], uncond.teacher_t, make_batches=lambda: [_x(0), _x(1)],
        num_ladder_steps=8, updates=3, cfg=TrainConfig(base_lr=1e-3, warmup_steps=0),
        log=None)
    assert info.keys() == info_j.keys()
    for k in ("steps", "ladder_steps", "sigma_data", "timestep_scaling"):
        assert info[k] == info_j[k], k
    assert [p.keys() for p in info["phases"]] == [p.keys() for p in info_j["phases"]]
    p, q = info["phases"][0], info_j["phases"][0]
    assert (p["student_steps"], p["updates"]) == (q["student_steps"], q["updates"])
    assert np.isfinite(p["first_loss"]) and np.isfinite(p["last_loss"])
    assert list(params) == [k for k, _ in port.named_parameters()]
