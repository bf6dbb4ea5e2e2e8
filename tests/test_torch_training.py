"""The port's training path against the JAX package on the same numpy inputs:
dropout with JAX's own bits (exact), the tiny U-Net's loss (1e-5
relative) and every gradient leaf carried by ``jax_params_to_state_dict``
(1e-3 relative to the leaf's norm) with injected (t, noise), the optimizer
and EMA from the same grads against optax (flat and tree; 1e-6), the LR
schedule, the whole step against the JAX composition of its pieces, grad
accumulation, the loss weightings, ``train_one_epoch``, eval and probes,
and the options that are not ported yet."""

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddpm_diffusion_model_tpu.models import UNetConfig as JaxUNetConfig
from ddpm_diffusion_model_tpu.models import UNetDenoiser as JaxUNet
from ddpm_diffusion_model_tpu.ops import DiffusionConfig as JaxDiffusionConfig
from ddpm_diffusion_model_tpu.ops import make_schedule as jax_make_schedule
from ddpm_diffusion_model_tpu.ops.diffusion import loss_simple as jax_loss_simple
from ddpm_diffusion_model_tpu.ops.dropout import packed_dropout as jax_packed_dropout
from ddpm_diffusion_model_tpu.training import ema as jax_ema
from ddpm_diffusion_model_tpu.training import state as jax_state
from ddpm_diffusion_model_tpu.training.step import resolve_weight_fn as jax_weight_fn
from ddpm_diffusion_model_tpu_torch.data import blob_faces_array
from ddpm_diffusion_model_tpu_torch.models import UNetConfig, UNetDenoiser
from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
from ddpm_diffusion_model_tpu_torch.ops.diffusion import loss_simple, sample_timesteps
from ddpm_diffusion_model_tpu_torch.ops.dropout import (dropout, flax_dropout,
                                                        packed_dropout,
                                                        packed_dropout_bits)
from ddpm_diffusion_model_tpu_torch.training import (
    StepDraws, TrainConfig, ema_health, ema_init, ema_reinit_from_params,
    ema_update, evaluate_loss, init_train_state, make_eval_step,
    make_lr_schedule, make_optimizer, make_probe_fn, make_train_step,
    resolve_weight_fn, train_one_epoch)
from ddpm_diffusion_model_tpu_torch.utils.interop import jax_params_to_state_dict

torch.set_num_threads(1)

# width 64: two channels per GroupNorm group everywhere, so no parameter
# has a gradient that is zero in exact arithmetic (at width 32 the biases
# feeding a one-channel group would carry only rounding noise)
SMALL = dict(base_channels=64, channel_mults=(1, 2), num_res_blocks=1,
             attn_resolutions=(8,), time_embed_dim=64, num_heads=2,
             head_dim=16, img_resolution=16, dropout=0.0)
T = 100


def _carried(seed=3):
    """A JAX float32 U-Net with perturbed GroupNorm affines and the port's
    U-Net holding the same weights."""
    jm = JaxUNet(JaxUNetConfig(**SMALL), dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.key(seed), jnp.ones((1, 16, 16, 3)),
                              jnp.zeros((1,)))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        if path[-1].key == "scale":
            return leaf + 0.1 * rng.normal(size=leaf.shape).astype(np.float32)
        if path[-1].key == "bias":
            return 0.1 * rng.normal(size=leaf.shape).astype(np.float32)
        return leaf

    params = jax.tree_util.tree_map_with_path(perturb, params)
    port = UNetDenoiser(UNetConfig(**SMALL), dtype=torch.float32, device="cpu")
    port.load_state_dict(jax_params_to_state_dict(params, port.config), strict=True)
    return jm, params, port.to(memory_format=torch.channels_last)


def _draws(B=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(B, 16, 16, 3)).astype(np.float32)
    t = rng.integers(1, T, size=(B,)).astype(np.int32)
    noise = rng.normal(size=(B, 16, 16, 3)).astype(np.float32)
    return x, t, noise


def _scheds():
    return (jax_make_schedule(JaxDiffusionConfig(T=T, img_size=16)),
            make_schedule(DiffusionConfig(T=T, img_size=16), device="cpu"))


def _jax_value_and_grad(jm, sched_j):
    """jit of value_and_grad of the JAX L_simple in (params, x, t, noise)."""
    def loss_fn(p, x, t, noise):
        return jax_loss_simple(sched_j, lambda xt, tt: jm.apply(p, xt, tt), x, t, noise)

    return jax.jit(jax.value_and_grad(loss_fn))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------- dropout


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.999])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_dropout_with_jax_bits_is_exact(rate, dtype):
    """Fed the bits ``jax.random.bits`` drew, the port gives exactly JAX's
    ``packed_dropout`` (in bf16 too: the scale is cast to bf16 first)."""
    key = jax.random.key(7)
    x = np.random.default_rng(1).normal(size=(2, 6, 5, 8)).astype(np.float32)
    xj = jnp.asarray(x, jnp.dtype(dtype))
    want = np.asarray(jax_packed_dropout(xj, rate, key).astype(jnp.float32))
    bits = np.array(jax.random.bits(key, x.shape, jnp.uint8))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = packed_dropout_bits(xt, rate, torch.from_numpy(bits))
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_packed_dropout_bf16_scale_and_zero_rate():
    x = torch.ones(4, 4, dtype=torch.bfloat16)
    bits = torch.full((4, 4), 200, dtype=torch.uint8)
    assert float(packed_dropout_bits(x, 0.1, bits)[0, 0]) == 1.109375  # not 256/230
    assert packed_dropout(x, 0.001) is x  # round(0.256) = 0: no bits drawn
    with pytest.raises(ValueError):
        packed_dropout(x, 1.0)


@pytest.mark.parametrize("impl", ["packed", "flax"])
def test_dropout_statistics_and_generator(impl):
    x = torch.ones(200_000)
    y1 = dropout(x, 0.1, impl, torch.Generator().manual_seed(3))
    y2 = dropout(x, 0.1, impl, torch.Generator().manual_seed(3))
    assert torch.equal(y1, y2)
    drop = float((y1 == 0).float().mean())
    want = 26 / 256 if impl == "packed" else 0.1
    assert abs(drop - want) < 3e-3
    kept = y1[y1 != 0]
    scale = 256 / 230 if impl == "packed" else 1 / 0.9
    torch.testing.assert_close(kept, torch.full_like(kept, scale))
    with pytest.raises(ValueError):
        dropout(x, 0.1, "bernoulli")
    assert flax_dropout(x, 0.0) is x


def test_resblock_dropout_runs_in_training_only():
    cfg = UNetConfig(**dict(SMALL, dropout=0.3))
    torch.manual_seed(0)
    model = UNetDenoiser(cfg, dtype=torch.float32, device="cpu")
    x, t, _ = _draws(2)
    x, t = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        e1, e2 = model.eval()(x, t), model(x, t, generator=torch.Generator().manual_seed(1))
        a = model.train()(x, t, generator=torch.Generator().manual_seed(1))
        b = model(x, t, generator=torch.Generator().manual_seed(1))
        c = model(x, t, generator=torch.Generator().manual_seed(2))
    assert torch.equal(e1, e2) and torch.equal(a, b)
    assert not torch.allclose(a, e1) and not torch.allclose(a, c)


# ---------------------------------------------------------------- loss and grads


def test_sample_timesteps_range():
    t = sample_timesteps(10_000, 20, torch.Generator().manual_seed(0))
    assert t.dtype == torch.int64 and int(t.min()) == 1 and int(t.max()) == 19


def test_loss_and_every_grad_leaf_match_jax_fp32():
    jm, params, port = _carried()
    sched_j, sched_t = _scheds()
    x, t, noise = _draws()
    loss_j, grads_j = _jax_value_and_grad(jm, sched_j)(params, x, t, noise)
    port.train()
    loss = loss_simple(sched_t, port, torch.from_numpy(x), torch.from_numpy(t).long(),
                       torch.from_numpy(noise))
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    # the interop transposes are linear, so they carry a gradient pytree too
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, grads_j), port.config)
    got = dict(port.named_parameters())
    assert list(want) == list(got)
    for name, g in want.items():
        assert got[name].grad.dtype == torch.float32
        assert _rel(got[name].grad.numpy(), g.numpy()) <= 1e-3, name


@pytest.mark.parametrize("name", ["uniform", "snr", "p2", "min_snr_5"])
@pytest.mark.parametrize("kind", ["epsilon", "v", "x0", "flow"])
def test_loss_weightings_match_jax(name, kind):
    sched_j = jax_make_schedule(JaxDiffusionConfig(T=T, prediction_type=kind))
    sched_t = make_schedule(DiffusionConfig(T=T, prediction_type=kind), device="cpu")
    t = np.array([1, 5, 50, 99], dtype=np.int32)
    fj, ft = jax_weight_fn(name), resolve_weight_fn(name)
    if name == "uniform":
        assert fj is None and ft is None
        return
    np.testing.assert_allclose(ft(torch.from_numpy(t).long(), sched_t).numpy(),
                               np.asarray(fj(jnp.asarray(t), sched_j)), rtol=1e-5)


def test_weighted_loss_simple_matches_jax():
    sched_j, sched_t = _scheds()
    x, t, noise = _draws()
    w = np.array([0.5, 1.0, 2.0, 0.1], np.float32)
    eps_j = lambda xt, tt: 0.3 * xt  # noqa: E731
    want = jax_loss_simple(sched_j, eps_j, jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(noise), weight=jnp.asarray(w))
    got = loss_simple(sched_t, lambda xt, tt: 0.3 * xt, torch.from_numpy(x),
                      torch.from_numpy(t).long(), torch.from_numpy(noise),
                      weight=torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------- optimizer, EMA


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "c": rng.normal(size=(2, 3, 2)).astype(np.float32)}


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "tree"])
@pytest.mark.parametrize("cfg_kw", [
    dict(grad_clip=1.0),                        # clip triggers (||g|| ~ 4)
    dict(grad_clip=100.0, weight_decay=0.01),   # clip does not trigger
    dict(grad_clip=None, warmup_steps=None),
    dict(grad_clip=1.0, moment_dtype="bfloat16"),
], ids=["clip", "noclip_wd", "noclip_nowarmup", "bf16_mu"])
def test_optimizer_and_ema_match_optax(flat, cfg_kw):
    """1 and 3 steps from the same grads: params, moments and EMA to 1e-6."""
    kw = dict(dict(base_lr=1e-2, warmup_steps=4, ema_decay=0.9, flat_optimizer=flat),
              **cfg_kw)
    cfg_j, cfg_t = jax_state.TrainConfig(**kw), TrainConfig(**kw)
    p0 = _tree(0)
    tx_j = jax_state.make_optimizer(cfg_j)
    update_j = jax.jit(tx_j.update)  # as in the JAX train step
    params_j = jax.tree.map(jnp.asarray, p0)
    opt_j, ema_j = tx_j.init(params_j), jax_ema.ema_init(params_j)
    model = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                    for k, v in p0.items()})
    tx = make_optimizer(cfg_t)
    params = list(model.values())
    opt, ema = tx.init(params), ema_init(dict(model.named_parameters()))
    for step in range(3):
        g = _tree(10 + step)
        upd, opt_j = update_j(jax.tree.map(jnp.asarray, g), opt_j, params_j)
        params_j = optax.apply_updates(params_j, upd)
        ema_j = jax_ema.ema_update(ema_j, params_j, cfg_j.ema_decay)
        tx.step(params, [torch.from_numpy(g[k].copy()) for k in model], opt)
        ema_update(ema, dict(model.named_parameters()), cfg_t.ema_decay)
        if step in (0, 2):
            for k in p0:
                np.testing.assert_allclose(model[k].detach().numpy(),
                                           np.asarray(params_j[k]), atol=1e-6, rtol=1e-6)
                np.testing.assert_allclose(ema[k].numpy(), np.asarray(ema_j[k]),
                                           atol=1e-6, rtol=1e-6)
    assert opt["count"] == 3


def test_lr_schedule_matches_jax():
    for warmup in (1000, 7, None):
        kw = dict(base_lr=2e-4, warmup_steps=warmup)
        fj = jax_state.make_lr_schedule(jax_state.TrainConfig(**kw))
        ft = make_lr_schedule(TrainConfig(**kw))
        for count in (0, 1, 5, 6, 999, 1000, 5000):
            assert ft(count) == float(np.float32(fj(jnp.asarray(count, jnp.int32))))


def test_train_config_round_trip_and_legacy():
    d = jax_state.TrainConfig(ema_decay=0.9997, moment_dtype="bfloat16").to_dict()
    assert TrainConfig.from_dict(d).to_dict() == d
    legacy = {"base_lr": 1e-4}
    assert (TrainConfig.from_dict(legacy, legacy=True).to_dict()
            == jax_state.TrainConfig.from_dict(legacy, legacy=True).to_dict())
    names = [f.name for f in dataclasses.fields(TrainConfig)]
    assert names == [f.name for f in dataclasses.fields(jax_state.TrainConfig)]


def test_ema_health_taxonomy_matches_jax():
    p = {k: torch.from_numpy(v) for k, v in _tree(0).items()}
    pj = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    cases = [
        (ema_init(p), jax_ema.ema_init(pj)),
        ({k: v * 0 for k, v in p.items()}, {k: v * 0 for k, v in pj.items()}),
        ({k: v * 100 for k, v in p.items()}, {k: v * 100 for k, v in pj.items()}),
        ({k: v * float("nan") for k, v in p.items()}, {k: v * jnp.nan for k, v in pj.items()}),
        ({"a": p["a"]}, {"a": pj["a"]}),
    ]
    for e, ej in cases:
        ok, reason, rel = ema_health(e, p)
        okj, reasonj, relj = jax_ema.ema_health(ej, pj)
        assert (ok, reason) == (okj, reasonj)
        assert rel == pytest.approx(relj, rel=1e-5)
    assert ema_health({k: v * 0 for k, v in p.items()}, p)[1] == "ema_zero_norm"
    fresh = ema_reinit_from_params(p)
    assert all(torch.equal(fresh[k], p[k]) and fresh[k] is not p[k] for k in p)


# ---------------------------------------------------------------- the step


def _jax_step(jm, params, x, t, noise, cfg_j, steps):
    """The JAX train step's body, composed from its pieces and jitted as
    the JAX step is, on injected draws: value_and_grad of L_simple,
    pre-clip global norm, optax update, EMA lerp."""
    sched_j, _ = _scheds()
    tx = jax_state.make_optimizer(cfg_j)

    @jax.jit
    def body(params, opt, ema, x, t, noise):
        loss, grads = jax.value_and_grad(lambda p: jax_loss_simple(
            sched_j, lambda xt, tt: jm.apply(p, xt, tt), x, t, noise))(params)
        upd, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, upd)
        ema = jax_ema.ema_update(ema, params, cfg_j.ema_decay)
        return params, opt, ema, loss, optax.global_norm(grads)

    opt, ema = tx.init(params), jax_ema.ema_init(params)
    out = []
    for i in range(steps):
        params, opt, ema, loss, gnorm = body(params, opt, ema, x[i], t[i], noise[i])
        out.append((float(loss), float(gnorm)))
    return out, params, ema


def test_whole_step_matches_jax_composition():
    jm, params, port = _carried()
    _, sched_t = _scheds()
    kw = dict(base_lr=1e-3, warmup_steps=3, grad_clip=1.0, ema_decay=0.9)
    draws = [_draws(seed=s) for s in range(2)]
    xs, ts, ns = zip(*draws)
    metrics_j, params_j, ema_j = _jax_step(jm, params, xs, ts, ns,
                                           jax_state.TrainConfig(**kw), 2)
    cfg = TrainConfig(**kw)
    state, tx = init_train_state(port, cfg)
    step = make_train_step(port, sched_t, tx, cfg)
    lr = make_lr_schedule(cfg)
    for i, (x, t, n) in enumerate(draws):
        state, m = step(state, x, StepDraws(torch.from_numpy(t).long(), torch.from_numpy(n)))
        loss_j, gn_j = metrics_j[i]
        assert abs(float(m["loss"]) - loss_j) <= 1e-5 * loss_j
        assert abs(float(m["grad_norm"]) - gn_j) <= 1e-4 * gn_j
        assert m["lr"] == lr(i)
    assert state.step == 2
    want_p = jax_params_to_state_dict(jax.tree.map(np.asarray, params_j), port.config)
    want_e = jax_params_to_state_dict(jax.tree.map(np.asarray, ema_j), port.config)
    start = jax_params_to_state_dict(jax.tree.map(np.asarray, params), port.config)
    got = dict(port.named_parameters())
    for name in want_p:
        _assert_adam_moves_close(got[name].detach(), want_p[name], start[name])
        _assert_adam_moves_close(state.ema_params[name], want_e[name], start[name])


def _assert_adam_moves_close(got, want, start):
    """Two Adam trajectories from ``start`` agree: their moves to 1e-3
    relative to the move's norm (the bar of the gradients they follow) plus
    one float32 rounding of the result.  The bar is on the norm, not per
    element: Adam's update is lr * m / (sqrt(v) + 1e-8), so an element
    whose gradient is near 1e-8 moves by a fraction of lr that float
    summation order alone can shift."""
    got, want, start = (np.asarray(a, np.float64) for a in (got, want, start))
    rounding = np.finfo(np.float32).eps * np.linalg.norm(want)
    assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want - start) + rounding


def test_grad_accum_2_equals_1():
    """Same batch and draws: two microbatches of 4 give the loss, grad norm
    and update of one batch of 8, up to float summation order."""
    x, t, n = _draws(B=8)
    d = StepDraws(torch.from_numpy(t).long(), torch.from_numpy(n))
    base = {k: v.clone() for k, v in _carried()[2].state_dict().items()}
    start = torch.cat([v.flatten() for v in base.values()])
    out = []
    for accum in (1, 2):
        port = UNetDenoiser(UNetConfig(**SMALL), dtype=torch.float32, device="cpu")
        port.load_state_dict(base, strict=True)
        port = port.to(memory_format=torch.channels_last)
        cfg = TrainConfig(base_lr=1e-3, warmup_steps=None, grad_clip=None,
                          grad_accum_steps=accum)
        state, tx = init_train_state(port, cfg)
        state, m = make_train_step(port, _scheds()[1], tx, cfg)(state, x, d)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    torch.cat([p.detach().flatten() for p in port.parameters()])))
        assert state.step == 1 and state.opt_state["count"] == 1
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    assert out[0][1] == pytest.approx(out[1][1], rel=1e-5)
    _assert_adam_moves_close(out[1][2], out[0][2], start)


def test_train_one_epoch_on_blob_faces_prints_the_table(capsys):
    cfg_m = UNetConfig(**dict(SMALL, dropout=0.1))
    torch.manual_seed(0)
    model = UNetDenoiser(cfg_m, dtype=torch.bfloat16, device="cpu")
    model = model.to(memory_format=torch.channels_last)
    cfg = TrainConfig(base_lr=1e-3, warmup_steps=4)
    state, tx = init_train_state(model, cfg, seed=1)
    sched = _scheds()[1]
    step = make_train_step(model, sched, tx, cfg)
    data = blob_faces_array(12, img_size=16, seed=0)
    loader = [(data[i:i + 4], np.zeros(4)) for i in range(0, 12, 4)]
    header = [False]
    state, avg, nb, ni = train_one_epoch(
        step, state, loader, log_every=1, log_grad_norm=True, log_mem=True,
        probe_fn=make_probe_fn(model, sched), probe_timesteps=(10, 90),
        epoch_header_printed=header, max_batches=2)
    out = capsys.readouterr().out
    assert (state.step, nb, ni) == (2, 2, 8) and np.isfinite(avg) and header[0]
    assert "(baseline)  eps-MSE" in out and "grad_norm" in out and "probes[t]" in out
    assert "t=10:" in out and "2.50e-04" in out  # lr of the first update: 1e-3 / 4
    for p in model.parameters():
        assert p.dtype == torch.float32 and p.grad is None


PHASES = ("train.forward", "train.backward", "train.update")


@functools.lru_cache(maxsize=None)
def _two_updates(accum: int, profiled: bool):
    """Two updates of the tiny bf16 U-Net (dropout on) through
    ``train_one_epoch`` over a loader of three batches; returns the losses,
    the parameters and, under a CPU profiler, the (name, thread, start,
    end) of every range the port opened."""
    torch.manual_seed(0)
    model = UNetDenoiser(UNetConfig(**dict(SMALL, dropout=0.1)), dtype=torch.bfloat16,
                         device="cpu").to(memory_format=torch.channels_last)
    cfg = TrainConfig(base_lr=1e-3, warmup_steps=4, grad_accum_steps=accum)
    state, tx = init_train_state(model, cfg, seed=1)
    step = make_train_step(model, _scheds()[1], tx, cfg)
    losses = []

    def recorded(state, batch):
        state, m = step(state, batch)
        losses.append(m["loss"].clone())
        return state, m

    data = blob_faces_array(12, img_size=16, seed=0)
    loader = [data[i:i + 4] for i in range(0, 12, 4)]
    ranges = []
    if profiled:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            train_one_epoch(recorded, state, loader, max_batches=2)
        ranges = [(e.name, e.thread, e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name.startswith("train.")]
    else:
        train_one_epoch(recorded, state, loader, max_batches=2)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return torch.stack(losses), params, ranges


@pytest.mark.parametrize("all_threads", [False, True])
@pytest.mark.parametrize("name", ("train.data_wait", "train.step") + PHASES)
def test_a_span_is_one_shared_null_context_with_the_profiler_off(name, all_threads):
    """Off: the same no-op object every call.  On, also under a profiler
    of every thread (as the benchmark's hosted pass runs): one range."""
    from torch._C._profiler import _ExperimentalConfig

    from ddpm_diffusion_model_tpu_torch.training.diagnostics import span

    assert span(name) is span("other")
    with span(name) as inside:
        assert inside is None
    extra = ({"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
             if all_threads else {})
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                **extra) as prof:
        with span(name):
            pass
    assert span(name) is span("other")
    assert [e.name for e in prof.events()] == [name]


@pytest.mark.parametrize("accum", [1, 2])
def test_each_update_opens_its_spans(accum):
    """data_wait, step and update once an update, forward and backward once
    a micro-batch; each phase inside a step, on the step's thread."""
    ranges = _two_updates(accum, True)[2]
    count = collections.Counter(name for name, *_ in ranges)
    assert count == {"train.data_wait": 2, "train.step": 2, "train.update": 2,
                     "train.forward": 2 * accum, "train.backward": 2 * accum}
    steps = [r for r in ranges if r[0] == "train.step"]
    for name, thread, s, t in ranges:
        if name in PHASES:
            assert any(th == thread and a <= s <= t <= b for _, th, a, b in steps), name


@pytest.mark.parametrize("accum", [1, 2])
def test_the_spans_leave_the_update_bit_equal(accum):
    off, on = _two_updates(accum, False), _two_updates(accum, True)
    assert torch.equal(off[0], on[0]) and off[0].shape == (2,)
    for n, p in off[1].items():
        assert torch.equal(p, on[1][n]), n


def test_log_line_dt_is_the_mean_wall_per_update_since_the_last(monkeypatch, capsys):
    """dt(ms) is the timer's mark over the updates since the previous log
    line, the timer restarted at each line."""
    from ddpm_diffusion_model_tpu_torch.training import loop

    class Timer:
        resets = 0

        def reset(self):
            Timer.resets += 1

        def mark(self, result=None):
            return 90.0

    monkeypatch.setattr(loop, "StepTimer", Timer)
    model = UNetDenoiser(UNetConfig(**SMALL), dtype=torch.float32, device="cpu")
    cfg = TrainConfig(base_lr=1e-3)
    state, tx = init_train_state(model, cfg, seed=1)
    step = make_train_step(model, _scheds()[1], tx, cfg)
    data = blob_faces_array(12, img_size=16, seed=0)
    train_one_epoch(step, state, [data[i:i + 2] for i in range(0, 12, 2)], log_every=3,
                    epoch_header_printed=[True])
    rows = [line.split("|") for line in capsys.readouterr().out.splitlines()
            if line.startswith("┆") and "|" in line]
    assert [(int(r[0].strip("┆ ")), r[3].strip()) for r in rows] == [(3, "30.0"), (6, "30.0")]
    assert Timer.resets == 2


def test_blob_faces_equal_the_jax_package_data():
    from ddpm_diffusion_model_tpu.data.synthetic import BlobFacesDataset as JaxBlobFaces
    from ddpm_diffusion_model_tpu.data.synthetic import blob_faces_array as jax_blob_faces
    from ddpm_diffusion_model_tpu_torch.data import BlobFacesDataset

    np.testing.assert_array_equal(blob_faces_array(3, 16, seed=4), jax_blob_faces(3, 16, seed=4))
    img, y = BlobFacesDataset(8, 16, seed=1, num_classes=3)[5]
    img_j, y_j = JaxBlobFaces(8, 16, seed=1, num_classes=3)[5]
    np.testing.assert_array_equal(img, img_j)
    assert y == y_j == 2


def test_eval_step_probe_and_evaluate_loss_are_seeded():
    _, _, port = _carried()
    sched = _scheds()[1]
    x, _, _ = _draws()
    ev = make_eval_step(port, sched)
    a, b = float(ev(None, x, 5)), float(ev(None, x, 5))
    assert a == b and a != float(ev(None, x, 6))
    # the EMA shadow through functional_call = a model holding those weights
    shadow = {k: v + 0.01 for k, v in ema_init(dict(port.named_parameters())).items()}
    other = UNetDenoiser(port.config, dtype=torch.float32, device="cpu")
    other.load_state_dict(shadow)
    assert float(ev(shadow, x, 5)) == pytest.approx(float(make_eval_step(other, sched)(None, x, 5)),
                                                    rel=1e-6)
    probe = make_probe_fn(port, sched)
    v = probe(None, x, (5, 50, 95), 3)
    assert v.shape == (3,) and torch.isfinite(v).all() and torch.equal(v, probe(None, x, (5, 50, 95), 3))
    assert port.training  # restored after eval
    loader = [x[:2], x[2:]]
    assert evaluate_loss(ev, None, loader) == evaluate_loss(ev, None, loader)


def test_not_ported_options_raise():
    cfg = UNetConfig(**dict(SMALL, attn_p_drop=0.1))
    model = UNetDenoiser(cfg, dtype=torch.float32, device="cpu")
    x, t, _ = _draws(1)
    x, t = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        ev = model.eval()(x, t)  # identity in eval
        # attention-weight dropout is ported (tests/test_torch_tp.py): in
        # training its masks come from the generator the forward is given
        runs = [model.train()(x, t, generator=torch.Generator().manual_seed(s))
                for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2]) and not torch.equal(runs[0], ev)
    # remat is ported (tests/test_torch_remat.py); an unknown value raises
    with pytest.raises(ValueError, match="remat"):
        UNetDenoiser(UNetConfig(**SMALL), device="cpu", remat="always")
    # SR training is ported (tests/test_torch_superres.py): a factor on a
    # model without cond_channels raises the JAX package's ValueError
    with pytest.raises(ValueError, match="superres_factor set but the model has no "
                                         "cond_channels"):
        make_train_step(model, _scheds()[1], make_optimizer(TrainConfig()),
                        TrainConfig(superres_factor=2))
    with pytest.raises(ValueError, match="moment_dtype"):
        make_optimizer(TrainConfig(moment_dtype="float16"))
