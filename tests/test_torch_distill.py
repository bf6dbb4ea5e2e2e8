"""The port's progressive distillation (``training/distill.py``) against the
JAX package's on the same numpy inputs, float32, weights carried by
``jax_params_to_state_dict``, at a tiny width (64, so every GroupNorm group
holds two channels and no gradient leaf is zero in exact arithmetic):

- the ladders and their errors, message for message;
- ``onestep_target``, ``student_x0`` (4 kinds) and ``_distill_weight`` (3
  kinds) within 1e-6 relative;
- the teacher's eps (unconditional, conditional, guided at w = 3, and a
  v-prediction teacher guided) at the U-Net bar of 1e-4;
- one update on JAX's own draws (its key splits reproduced and injected):
  loss 1e-5 and grad norm 1e-4 relative, params and EMA by
  ``_assert_adam_moves_close`` over the whole parameter vector,
  unconditional and conditional with guidance baked in;
- ``progressive_distill``: the phases, guidance baked into the first only,
  and ``info`` with JAX's keys (JAX's ``progressive_distill`` run on a stub
  step, so no XLA program is compiled for it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_training import _assert_adam_moves_close

from ddpm_diffusion_model_tpu import training as jax_training
from ddpm_diffusion_model_tpu.models import UNetConfig as JaxUNetConfig
from ddpm_diffusion_model_tpu.models import UNetDenoiser as JaxUNet
from ddpm_diffusion_model_tpu.ops import schedules as js
from ddpm_diffusion_model_tpu.training import distill as jd
from ddpm_diffusion_model_tpu.training import state as jax_state
from ddpm_diffusion_model_tpu_torch.models import UNetConfig, UNetDenoiser
from ddpm_diffusion_model_tpu_torch.ops import schedules as ts
from ddpm_diffusion_model_tpu_torch.training import distill as td
from ddpm_diffusion_model_tpu_torch.training import (DistillDraws, TrainConfig,
                                                     init_train_state)
from ddpm_diffusion_model_tpu_torch.utils.interop import jax_params_to_state_dict

torch.set_num_threads(2)

K = 3
T = 100
RES = 16
B = 4
SMALL = dict(base_channels=64, channel_mults=(1, 2), num_res_blocks=1,
             attn_resolutions=(8,), time_embed_dim=64, num_heads=2,
             head_dim=16, img_resolution=RES, dropout=0.0)
LABELS = np.array([0, 2, 1, 0], np.int32)
# the optimizer of one update: clipped (the grads' norm is above 1) AdamW
STEP_KW = dict(base_lr=1e-3, warmup_steps=0, ema_decay=0.9, grad_clip=1.0)


def _jax_params(jm, seed):
    """Seeded JAX params with perturbed GroupNorm affines and class table."""
    params = jax.jit(jm.init)(jax.random.key(seed), jnp.ones((1, RES, RES, 3)),
                              jnp.zeros((1,)))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name == "scale":
            return leaf + 0.1 * rng.normal(size=leaf.shape).astype(np.float32)
        if name == "bias":
            return 0.1 * rng.normal(size=leaf.shape).astype(np.float32)
        if name == "embedding":
            return leaf + 0.5 * rng.normal(size=leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, params)


class Carried:
    """A JAX U-Net, a student's and a teacher's params, and the port's U-Net
    holding the student's (``reset()`` puts them back)."""

    def __init__(self, classes):
        self.jm = JaxUNet(JaxUNetConfig(**SMALL, num_classes=classes), dtype=jnp.float32)
        self.student, self.teacher = _jax_params(self.jm, 3), _jax_params(self.jm, 4)
        self.port = UNetDenoiser(UNetConfig(**SMALL, num_classes=classes),
                                 dtype=torch.float32, device="cpu")
        self.port = self.port.to(memory_format=torch.channels_last)
        self.teacher_t = self.state_dict(self.teacher)
        self.reset()

    def state_dict(self, params):
        return {k: torch.as_tensor(np.array(v)) for k, v in
                jax_params_to_state_dict(jax.tree.map(np.asarray, params),
                                         self.port.config).items()}

    def reset(self):
        self.port.load_state_dict(self.state_dict(self.student), strict=True)
        return self.port


@pytest.fixture(scope="module")
def uncond():
    return Carried(0)


@pytest.fixture(scope="module")
def cond():
    return Carried(K)


def _scheds(prediction_type="epsilon"):
    kw = dict(T=T, img_size=RES, prediction_type=prediction_type)
    return (js.make_schedule(js.DiffusionConfig(**kw)),
            ts.make_schedule(ts.DiffusionConfig(**kw), device="cpu"))


def _x(seed, n=B):
    return np.random.default_rng(seed).uniform(-1, 1, size=(n, RES, RES, 3)).astype(
        np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------ the ladders


@pytest.mark.parametrize("T_,N", [(100, 1), (100, 2), (100, 32), (1000, 32), (1000, 4),
                                  (20, 4), (9, 4)])
def test_ladders_equal_jax(T_, N):
    ladder = td.distill_ladder(T_, N)
    want = jd.distill_ladder(T_, N)
    assert ladder.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(ladder, want)
    np.testing.assert_array_equal(td.student_timesteps(ladder), jd.student_timesteps(want))
    assert td.student_timesteps(ladder).dtype == np.int32


@pytest.mark.parametrize("T_,N", [(100, 0), (100, -3), (8, 4), (100, 60)])
def test_ladder_errors_equal_jax(T_, N):
    with pytest.raises(ValueError) as want:
        jd.distill_ladder(T_, N)
    with pytest.raises(ValueError) as got:
        td.distill_ladder(T_, N)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ the algebra


def test_onestep_target_equals_jax():
    sj, st = _scheds()
    rng = np.random.default_rng(1)
    z_t, z_n = (rng.normal(size=(8, RES, RES, 3)).astype(np.float32) for _ in range(2))
    t = np.array([99, 74, 50, 25, 10, 5, 2, 1], np.int32)
    tn = np.array([74, 50, 25, 0, 5, 2, 1, 0], np.int32)
    want = np.asarray(jd.onestep_target(sj, z_t, jnp.asarray(t), jnp.asarray(tn), z_n))
    got = td.onestep_target(st, torch.from_numpy(z_t), torch.from_numpy(t).long(),
                            torch.from_numpy(tn).long(), torch.from_numpy(z_n)).numpy()
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("kind", ["epsilon", "v", "x0", "flow"])
def test_student_x0_equals_jax(kind):
    sj, st = _scheds(kind)
    rng = np.random.default_rng(2)
    out, z = (rng.normal(size=(6, RES, RES, 3)).astype(np.float32) for _ in range(2))
    t = np.array([0, 1, 10, 50, 98, 99], np.int32)
    want = np.asarray(jd.student_x0(sj, jnp.asarray(out), jnp.asarray(z), jnp.asarray(t)))
    got = td.student_x0(st, torch.from_numpy(out), torch.from_numpy(z),
                        torch.from_numpy(t).long()).numpy()
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("kind", ["truncated_snr", "snr", "uniform"])
def test_distill_weight_equals_jax(kind):
    sj, st = _scheds()
    t = np.array([0, 1, 5, 25, 50, 75, 99, 120, -3], np.int32)  # clipped to [0, T-1]
    want = np.asarray(jd._distill_weight(sj, jnp.asarray(t), kind))
    got = td._distill_weight(st, torch.from_numpy(t).long(), kind).numpy()
    assert got.dtype == np.float32 and _rel(got, want) <= 1e-6
    with pytest.raises(ValueError, match="unknown distill weighting"):
        td._distill_weight(st, torch.from_numpy(t).long(), "p2")


# ------------------------------------------------------- the teacher's eps


@pytest.mark.parametrize("case", ["unconditional", "conditional", "guided", "v_guided"])
def test_teacher_eps_equals_jax(case, uncond, cond):
    c = uncond if case == "unconditional" else cond
    sj, st = _scheds("v" if case == "v_guided" else "epsilon")
    classes = 0 if case == "unconditional" else K
    w = 3.0 if case in ("guided", "v_guided") else None
    y = None if case == "unconditional" else LABELS
    x = np.random.default_rng(3).normal(size=(B, RES, RES, 3)).astype(np.float32)
    t = np.array([99, 60, 20, 1], np.int32)
    teps_j = jd.make_teacher_eps(c.jm, sj, classes, w)
    want = np.asarray(jax.jit(teps_j)(c.teacher, x, t, None if y is None else jnp.asarray(y)))
    teps = td.make_teacher_eps(c.reset(), st, classes, w)
    with torch.no_grad():
        got = teps(c.teacher_t, torch.from_numpy(x), torch.from_numpy(t).long(),
                   None if y is None else torch.from_numpy(y).long()).numpy()
    assert _rel(got, want) <= 1e-4
    if w is not None:  # the guidance is really applied
        with torch.no_grad():
            plain = td.make_teacher_eps(c.port, st, classes, None)(
                c.teacher_t, torch.from_numpy(x), torch.from_numpy(t).long(),
                torch.from_numpy(y).long()).numpy()
        assert _rel(plain, want) > 1e-2


# -------------------------------------------------------------- the update


def _jax_draws(state, n, shape):
    """JAX's draws of a step from ``state.rng``: (i, eps)."""
    _rng_next, k_step = jax.random.split(state.rng)
    ki, kn = jax.random.split(k_step)
    return (np.asarray(jax.random.randint(ki, (shape[0],), 0, n)),
            np.asarray(jax.random.normal(kn, shape, dtype=jnp.float32)))


def check_update_equals_jax(c, make_jax_step, make_port_step, ladder, n, guidance, **kw):
    """One update of JAX's step and the port's from the same state, teacher
    and batch, the port fed JAX's draws: loss, grad norm, lr, params, EMA."""
    sj, st = _scheds()
    x = _x(5)
    conditional = c.port.config.num_classes > 0
    batch_j = (jnp.asarray(x), jnp.asarray(LABELS)) if conditional else jnp.asarray(x)
    cfg_j = jax_state.TrainConfig(**STEP_KW)
    tx_j = jax_state.make_optimizer(cfg_j)
    state_j, _ = jax_state.init_train_state(c.student, cfg_j, seed=7, tx=tx_j)
    i, eps = _jax_draws(state_j, n, x.shape)
    i, eps = i.copy(), eps.copy()  # writable, for torch.from_numpy
    step_j = make_jax_step(c.jm, sj, ladder, tx_j, cfg_j, guidance=guidance, **kw)
    new_j, m_j = step_j(state_j, c.teacher, batch_j)

    port = c.reset()
    cfg = TrainConfig(**STEP_KW)
    state, tx = init_train_state(port, cfg, seed=7)
    step = make_port_step(port, st, ladder, tx, cfg, guidance=guidance, **kw)
    batch = (x, LABELS) if conditional else x
    state, m = step(state, c.teacher_t, batch,
                    DistillDraws(torch.from_numpy(i).long(), torch.from_numpy(eps)))
    assert state.step == 1 and state.opt_state["count"] == 1
    assert abs(float(m["loss"]) - float(m_j["loss"])) <= 1e-5 * abs(float(m_j["loss"]))
    assert abs(float(m["grad_norm"]) - float(m_j["grad_norm"])) <= \
        1e-4 * float(m_j["grad_norm"])
    assert m["lr"] == float(m_j["lr"])
    # the moves over the whole parameter vector: a leaf may hold an element
    # whose gradient is within float32 summation noise of 0, which Adam's
    # first step turns into a move anywhere in (-lr, lr)
    start = c.state_dict(c.student)
    flat = lambda d: np.concatenate([np.asarray(d[k], np.float64).ravel()  # noqa: E731
                                     for k in start])
    got = {k: v.detach() for k, v in port.named_parameters()}
    _assert_adam_moves_close(flat(got), flat(c.state_dict(new_j.params)), flat(start))
    _assert_adam_moves_close(flat(state.ema_params), flat(c.state_dict(new_j.ema_params)),
                             flat(start))
    return m


@pytest.mark.parametrize("case", ["unconditional", "guided"])
def test_distill_step_equals_jax(case, uncond, cond):
    c, guidance = (uncond, None) if case == "unconditional" else (cond, 3.0)
    ladder = jd.distill_ladder(T, 4)
    m = check_update_equals_jax(c, jd.make_distill_step, td.make_distill_step, ladder, 4,
                                guidance)
    assert float(m["grad_norm"]) > STEP_KW["grad_clip"]  # the clip acted


def test_distill_step_runs_no_dropout_and_builds_no_teacher_graph(cond):
    """A student with dropout 0.5 gives the same update twice (eval mode),
    and the teacher's weights get no grad."""
    port = UNetDenoiser(UNetConfig(**dict(SMALL, dropout=0.5), num_classes=K),
                        dtype=torch.float32, device="cpu")
    _, st = _scheds()
    teacher = {k: v.clone().requires_grad_() for k, v in cond.teacher_t.items()}
    base = {k: v.clone() for k, v in cond.state_dict(cond.student).items()}
    d = DistillDraws(torch.tensor([0, 1, 2, 3]), torch.from_numpy(
        np.random.default_rng(6).normal(size=(B, RES, RES, 3)).astype(np.float32)))
    outs = []
    for _ in range(2):
        port.load_state_dict(base)
        port.train()
        state, tx = init_train_state(port, TrainConfig(**STEP_KW), seed=1)
        step = td.make_distill_step(port, st, td.distill_ladder(T, 4), tx,
                                    TrainConfig(**STEP_KW), guidance=2.0)
        state, m = step(state, teacher, (_x(7), LABELS), d)
        outs.append((float(m["loss"]), torch.cat([p.detach().flatten()
                                                  for p in port.parameters()])))
        assert port.training  # the mode is restored
    assert outs[0][0] == outs[1][0] and torch.equal(outs[0][1], outs[1][1])
    assert all(v.grad is None for v in teacher.values())


def test_distill_step_rejects_a_bad_ladder(uncond):
    _, st = _scheds()
    port = uncond.reset()
    state, tx = init_train_state(port, TrainConfig())
    for ladder in (np.array([99, 50]), np.array([99, 60, 30, 0])):
        with pytest.raises(ValueError, match="ladder must be a"):
            td.make_distill_step(port, st, ladder, tx, TrainConfig())


def test_draws_come_from_the_state_generator_in_order(uncond):
    """Without draws the step takes (i, then the noise) from the state's
    generator: the same as drawing them first and injecting them."""
    _, st = _scheds()
    ladder = td.distill_ladder(T, 4)
    losses = []
    for inject in (False, True):
        port = uncond.reset()
        state, tx = init_train_state(port, TrainConfig(**STEP_KW), seed=11)
        d = None
        if inject:
            gen = torch.Generator().manual_seed(11)
            d = td.draw_distill_inputs(gen, (B, RES, RES, 3), 4, "cpu")
            assert d.i.min() >= 0 and d.i.max() < 4
        step = td.make_distill_step(port, st, ladder, tx, TrainConfig(**STEP_KW))
        losses.append(float(step(state, uncond.teacher_t, _x(8), d)[1]["loss"]))
    assert losses[0] == losses[1]


# ---------------------------------------------------------------- the phases


def _stub_jax_step(seen):
    """JAX's step factory replaced: records the guidance, steps nothing."""

    def make(*args, **kw):
        seen.append(kw.get("guidance"))
        return lambda state, teacher, batch: (state, {"loss": jnp.float32(0.5)})

    return make


def test_progressive_distill_phases_guidance_and_info_keys(cond, monkeypatch):
    """8 -> 4 -> 2 in two phases; guidance baked into the first phase only,
    as JAX's ``progressive_distill`` does it; ``info`` with JAX's keys and
    values."""
    seen_j, seen = [], []
    monkeypatch.setattr(jd, "make_distill_step", _stub_jax_step(seen_j))
    cfg_j = jax_state.TrainConfig(base_lr=1e-3, warmup_steps=0, flat_optimizer=False)
    _params, info_j = jd.progressive_distill(
        cond.jm, _scheds()[0], cond.teacher,
        make_batches=lambda: [(jnp.asarray(_x(0)), jnp.asarray(LABELS))],
        start_steps=8, end_steps=2, phase_updates=3, cfg=cfg_j, guidance=2.0, log=None)
    real = td.make_distill_step

    def spy(*args, **kw):
        seen.append(kw.get("guidance"))
        return real(*args, **kw)

    monkeypatch.setattr(td, "make_distill_step", spy)
    port = cond.reset()
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    batches = [(_x(0), LABELS), (_x(1), LABELS)]
    params, info = td.progressive_distill(
        port, _scheds()[1], cond.teacher_t, make_batches=lambda: batches,
        start_steps=8, end_steps=2, phase_updates=3,
        cfg=TrainConfig(base_lr=1e-3, warmup_steps=0), guidance=2.0, log=None)
    assert seen == seen_j == [2.0, None]
    assert info.keys() == info_j.keys() and info["steps"] == info_j["steps"] == 2
    assert [p.keys() for p in info["phases"]] == [p.keys() for p in info_j["phases"]]
    for p, q in zip(info["phases"], info_j["phases"]):
        assert (p["student_steps"], p["updates"]) == (q["student_steps"], q["updates"])
        assert np.isfinite(p["first_loss"]) and np.isfinite(p["last_loss"])
    assert [p["student_steps"] for p in info["phases"]] == [4, 2]
    assert list(params) == list(before)
    assert any(not torch.equal(params[k], before[k]) for k in params)
    # the teacher map is copied, never trained
    assert all(torch.equal(v, cond.state_dict(cond.teacher)[k])
               for k, v in cond.teacher_t.items())


def test_progressive_distill_rejects_a_short_start(uncond):
    for lib, model in ((jd, uncond.jm), (td, uncond.reset())):
        with pytest.raises(ValueError, match="start_steps=4 must be >= 2\\*end_steps=8"):
            lib.progressive_distill(model, _scheds()[lib is td], None, lambda: [],
                                    start_steps=4, end_steps=4, phase_updates=1,
                                    cfg=(TrainConfig() if lib is td
                                         else jax_state.TrainConfig()))


def test_exports_match_the_jax_training_package():
    from ddpm_diffusion_model_tpu_torch import training

    for name in ("distill_ladder", "make_distill_step", "onestep_target",
                 "progressive_distill", "student_timesteps", "student_x0",
                 "consistency_distill", "consistency_fn", "consistency_ladder",
                 "consistency_sample_loop", "consistency_scalings",
                 "make_consistency_step"):
        assert hasattr(jax_training, name) and hasattr(training, name), name
