"""The port's checkpoints (``training/checkpoint.py``): the round trip of
the whole train state, the selected components, async saves (host copies
taken before the call returns, failures raised by the next wait), the
rename into place, the mirror, and, against the JAX package on the same
inputs, ``read_meta`` / ``find_latest_checkpoint`` on the same ``meta.json``
files, ``apply_resume_overrides``' decisions, and the first update after
``reset_optimizer_state`` against optax's fast-forwarded schedule count."""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddpm_diffusion_model_tpu.training import checkpoint as jax_ckpt
from ddpm_diffusion_model_tpu.training import state as jax_state
from ddpm_diffusion_model_tpu_torch.models import UNetConfig, UNetDenoiser
from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
from ddpm_diffusion_model_tpu_torch.training import (
    PreemptionFlag, TrainConfig, apply_resume_overrides, catch_preemption,
    find_latest_checkpoint, init_train_state, load_checkpoint, make_optimizer,
    make_train_step, mirror_checkpoint, read_meta, save_checkpoint,
    wait_for_checkpoints)
from ddpm_diffusion_model_tpu_torch.training import checkpoint as ckpt_mod

torch.set_num_threads(1)

TINY = dict(base_channels=16, channel_mults=(1, 2), num_res_blocks=1,
            attn_resolutions=(), time_embed_dim=16, num_heads=1, head_dim=8,
            img_resolution=8, dropout=0.1)


def _model(seed=0):
    torch.manual_seed(seed)
    return UNetDenoiser(UNetConfig(**TINY), dtype=torch.float32,
                        device="cpu").to(memory_format=torch.channels_last)


def _step_for(model, cfg):
    """The train step of ``model`` (the step closes over its model)."""
    sched = make_schedule(DiffusionConfig(T=20, img_size=8), device="cpu")
    return make_train_step(model, sched, make_optimizer(cfg), cfg)


def _trained(cfg, steps=3):
    model = _model()
    state, _ = init_train_state(model, cfg, seed=4)
    step = _step_for(model, cfg)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(4, 8, 8, 3))
                         .astype(np.float32) * 0.3)
    for _ in range(steps):
        state, _ = step(state, x)
    return state, step, x


def _fresh(cfg, seed=0):
    return init_train_state(_model(seed + 100), cfg)[0]


def _assert_states_equal(a, b):
    assert a.step == b.step and a.ema_decay == b.ema_decay
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k
    for key in ("count", "schedule_count"):
        assert a.opt_state[key] == b.opt_state[key], key
    for m, n in zip(a.opt_state["mu"] + a.opt_state["nu"],
                    b.opt_state["mu"] + b.opt_state["nu"]):
        assert m.dtype == n.dtype and torch.equal(m, n)
    assert all(torch.equal(a.ema_params[k], b.ema_params[k]) for k in a.ema_params)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_checkpoint_roundtrip_and_overrides(tmp_path):
    cfg = TrainConfig(grad_accum_steps=1, warmup_steps=None)
    state, step, x = _trained(cfg)
    p = str(tmp_path / "ckpt_e000")
    save_checkpoint(p, state, epoch=0, extra={"note": "x"},
                    configs={"train": cfg.to_dict()})
    assert sorted(os.listdir(p)) == ["meta.json", "state.pt"]
    assert os.listdir(tmp_path) == ["ckpt_e000"]  # no temporary left behind
    meta = read_meta(p)
    assert set(meta) == {"epoch", "global_step", "extra", "configs"}
    assert meta["epoch"] == 0 and meta["global_step"] == 3
    assert meta["configs"]["train"]["base_lr"] == cfg.base_lr

    restored, meta2 = load_checkpoint(p, _fresh(cfg))
    assert meta2 == meta
    _assert_states_equal(restored, state)
    # the restored state continues exactly as the saved one (same draws)
    _, m_a = step(state, x)
    _, m_b = _step_for(restored.model, cfg)(restored, x)
    assert float(m_a["loss"]) == float(m_b["loss"])
    _assert_states_equal(restored, state)

    template = _fresh(cfg)
    restored, _ = load_checkpoint(p, template)
    out = apply_resume_overrides(restored, template, reset_optimizer_state=True,
                                 override_ema_decay=0.5, log=lambda *_: None)
    assert out.ema_decay == 0.5
    assert out.opt_state["count"] == 0 and out.opt_state["schedule_count"] == 3
    assert all(not bool(m.any()) for m in out.opt_state["mu"] + out.opt_state["nu"])

    # EMA repair: poison the shadow, ask for repair
    poisoned = {k: v * 0.0 for k, v in restored.ema_params.items()}
    import dataclasses
    repaired = apply_resume_overrides(
        dataclasses.replace(restored, ema_params=poisoned), template, repair_ema=True,
        ema_decay_after_repair=0.123, log=lambda *_: None)
    assert repaired.ema_decay == 0.123
    for k, p_ in restored.model.named_parameters():
        assert torch.equal(repaired.ema_params[k], p_)


def test_partial_checkpoint_restore_with_other_moment_dtype(tmp_path):
    """A params-only load keeps the template's fresh optimizer state, step
    and generator, and works when the checkpoint's moments have another
    dtype (bf16 mu) than the template's."""
    state, _, _ = _trained(TrainConfig(grad_accum_steps=1, warmup_steps=None,
                                       moment_dtype="bfloat16"), steps=2)
    assert state.opt_state["mu"][0].dtype == torch.bfloat16
    p = str(tmp_path / "ckpt_partial")
    save_checkpoint(p, state, epoch=0)
    template = _fresh(TrainConfig(grad_accum_steps=1, warmup_steps=None))
    fresh_gen = template.generator.get_state()
    restored, _ = load_checkpoint(p, template, components=("params", "ema_params"))
    assert restored.step == 0 and restored.opt_state is template.opt_state
    assert restored.opt_state["mu"][0].dtype == torch.float32
    assert torch.equal(restored.generator.get_state(), fresh_gen)
    for (k, a), b in zip(restored.model.named_parameters(), state.model.parameters()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="unknown checkpoint components"):
        load_checkpoint(p, template, components=("params", "bogus"))


def test_load_refuses_another_model(tmp_path):
    state, _, _ = _trained(TrainConfig(warmup_steps=None), steps=1)
    p = str(tmp_path / "c")
    save_checkpoint(p, state)
    other = UNetDenoiser(UNetConfig(**dict(TINY, base_channels=8)), dtype=torch.float32,
                         device="cpu")
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(p, init_train_state(other, TrainConfig())[0])


def test_async_checkpoint_save(tmp_path):
    cfg = TrainConfig(grad_accum_steps=1, warmup_steps=None)
    state, _, _ = _trained(cfg, steps=1)
    mirror = str(tmp_path / "mirror")
    p = str(tmp_path / "ckpt_async")
    save_checkpoint(p, state, epoch=1, block=False, mirror_dir=mirror,
                    fixed_mirror_name="latest")
    wait_for_checkpoints()
    assert os.path.exists(os.path.join(p, "meta.json"))
    assert sorted(os.listdir(os.path.join(mirror, "latest"))) == ["meta.json", "state.pt"]
    restored, meta = load_checkpoint(p, _fresh(cfg))
    assert meta["epoch"] == 1
    _assert_states_equal(restored, state)


def test_async_save_copies_before_it_returns(tmp_path, monkeypatch):
    """The disk write runs late (a slow disk); the live tensors change in
    place as soon as the call returns; the checkpoint holds the values of
    the call."""
    import threading
    import time

    cfg = TrainConfig(warmup_steps=None)
    state, step, x = _trained(cfg, steps=1)
    want = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    want_mu = [m.clone() for m in state.opt_state["mu"]]
    gate = threading.Event()
    real = ckpt_mod._write

    def slow(*args):
        gate.wait(10)
        time.sleep(0.05)
        real(*args)

    monkeypatch.setattr(ckpt_mod, "_write", slow)
    p = str(tmp_path / "late")
    save_checkpoint(p, state, block=False)
    step(state, x)  # updates params, moments and EMA in place
    gate.set()
    wait_for_checkpoints()
    restored, meta = load_checkpoint(p, _fresh(cfg))
    assert meta["global_step"] == 1 and restored.step == 1
    for k, a in restored.model.named_parameters():
        assert torch.equal(a, want[k]), k
    assert all(torch.equal(a, b) for a, b in zip(restored.opt_state["mu"], want_mu))


def test_async_failure_is_raised_by_the_next_wait(tmp_path, monkeypatch):
    state, _, _ = _trained(TrainConfig(warmup_steps=None), steps=1)

    def broken(*_args):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "_write", broken)
    save_checkpoint(str(tmp_path / "x"), state, block=False)
    with pytest.raises(RuntimeError, match="async checkpoint") as ei:
        wait_for_checkpoints()
    assert isinstance(ei.value.__cause__, OSError)
    wait_for_checkpoints()  # raised once, then clear


def test_a_failed_write_leaves_the_old_checkpoint(tmp_path, monkeypatch):
    """The write goes to a temporary directory renamed into place: a crash
    in the middle leaves the older checkpoint whole and no half one for
    find_latest_checkpoint to pick."""
    cfg = TrainConfig(warmup_steps=None)
    state, step, x = _trained(cfg, steps=1)
    p = str(tmp_path / "r_last")
    save_checkpoint(p, state, epoch=0)
    step(state, x)

    def crash(*_a, **_k):
        raise OSError("killed mid-write")

    monkeypatch.setattr(ckpt_mod.torch, "save", crash)
    with pytest.raises(OSError):
        save_checkpoint(p, state, epoch=1)
    monkeypatch.undo()
    assert os.listdir(tmp_path) == ["r_last"]
    assert read_meta(p)["global_step"] == 1
    assert find_latest_checkpoint(str(tmp_path), "r") == p
    restored, _ = load_checkpoint(p, _fresh(cfg))
    assert restored.step == 1


def test_mirror_checkpoint(tmp_path):
    src = tmp_path / "ckpt_e000"
    os.makedirs(src / "sub")
    (src / "data.bin").write_bytes(b"abc")
    (src / "sub" / "x").write_text("y")
    dst = mirror_checkpoint(str(src), str(tmp_path / "mirror"), "latest")
    assert dst and os.path.exists(os.path.join(dst, "data.bin"))
    (src / "data.bin").write_bytes(b"abcd")  # replace semantics
    dst2 = mirror_checkpoint(str(src), str(tmp_path / "mirror"), "latest")
    with open(os.path.join(dst2, "data.bin"), "rb") as f:
        assert f.read() == b"abcd"
    assert mirror_checkpoint(str(src), "", "x") is None  # never raises


# ------------------------------------------------ against the JAX package


def _fake(ckpt_dir, name, meta):
    d = os.path.join(ckpt_dir, name)
    os.makedirs(d)
    with open(os.path.join(d, "meta.json"), "w") as f:
        f.write(meta if isinstance(meta, str) else json.dumps(meta))


def test_find_latest_and_read_meta_match_jax(tmp_path):
    d = str(tmp_path)

    def both():
        want = jax_ckpt.find_latest_checkpoint(d, "r")
        assert find_latest_checkpoint(d, "r") == want
        return want

    assert both() is None
    _fake(d, "r_e000", {"global_step": 10, "epoch": 0})
    _fake(d, "r_e001", {"global_step": 20, "epoch": 1})
    _fake(d, "r_preempt", {"global_step": 25, "epoch": 0, "extra": {"partial_batches": 2}})
    _fake(d, "other_e005", {"global_step": 99, "epoch": 5})  # another run
    assert both().endswith("r_preempt")
    _fake(d, "r_last", {"global_step": 25, "epoch": 2})  # step ties: epoch decides
    assert both().endswith("r_last")
    _fake(d, "r_e002", "{broken")  # a corrupt meta is skipped
    _fake(d, "r_e003", {"epoch": 3})  # no step: -1
    assert both().endswith("r_last")
    for name in ("r_e000", "r_e002", "r_e003", "r_preempt"):
        p = os.path.join(d, name)
        assert read_meta(p) == jax_ckpt.read_meta(p)
    os.makedirs(os.path.join(d, "empty"))
    assert read_meta(os.path.join(d, "empty"), strict=True) is None
    with pytest.raises(json.JSONDecodeError):
        read_meta(os.path.join(d, "r_e002"), strict=True)
    with pytest.raises(json.JSONDecodeError):
        jax_ckpt.read_meta(os.path.join(d, "r_e002"), strict=True)


def _param_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}


def _both_states(cfg_kw, ema_scale=1.0, ema_nan=False):
    """The same params and EMA shadow as a JAX and a port TrainState."""
    p0 = _param_tree(0)
    ema = {k: v * ema_scale for k, v in p0.items()}
    if ema_nan:
        ema["a"] = ema["a"].copy()
        ema["a"][0, 0] = np.nan
    cfg_j, cfg_t = jax_state.TrainConfig(**cfg_kw), TrainConfig(**cfg_kw)
    sj, txj = jax_state.init_train_state(jax.tree.map(jnp.asarray, p0), cfg_j)
    sj = sj.replace(ema_params=jax.tree.map(jnp.asarray, ema))
    model = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                    for k, v in p0.items()})
    st, txt = init_train_state(model, cfg_t)
    st.ema_params = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
    return (sj, txj), (st, txt)


@pytest.mark.parametrize("kw", [
    dict(repair_ema=True),                                     # healthy: kept
    dict(repair_ema=True, ema_rel_tol=0.1),                    # lagging: repaired
    dict(repair_ema="force", override_ema_decay=0.98),
    dict(repair_ema="force", override_ema_decay=0.98, ema_decay_after_repair=0.5),
    dict(override_ema_decay=0.7),
    dict(repair_ema=True, nan=True),
], ids=["healthy", "lagging", "force_override", "force_after", "override", "nan"])
def test_apply_resume_overrides_decides_as_jax(kw):
    kw = dict(kw)
    nan = kw.pop("nan", False)
    (sj, _), (st, _) = _both_states(dict(ema_decay=0.999), ema_scale=1.2, ema_nan=nan)
    logs_j, logs_t = [], []
    oj = jax_ckpt.apply_resume_overrides(sj, sj, log=logs_j.append, **kw)
    ot = apply_resume_overrides(st, st, log=logs_t.append, **kw)
    assert logs_t == logs_j
    assert ot.ema_decay == pytest.approx(float(oj.ema_decay), abs=1e-7)
    for k in ot.ema_params:
        np.testing.assert_array_equal(ot.ema_params[k].numpy(),
                                      np.asarray(oj.ema_params[k]))


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "tree"])
def test_first_update_after_reset_matches_optax_fast_forward(flat):
    """Three updates, a reset (fresh moments, Adam's count 0, the
    schedule's clock at the global step), one more update: params to
    1e-6 of optax's, so warmup does not restart and bias correction does."""
    kw = dict(base_lr=1e-2, warmup_steps=10, grad_clip=1.0, flat_optimizer=flat)
    (sj, txj), (st, txt) = _both_states(kw)
    (tj, _), (tt, _) = _both_states(kw)  # fresh templates
    update = jax.jit(txj.update)
    params = list(st.model.parameters())
    for i in range(4):
        if i == 3:
            sj = jax_ckpt.apply_resume_overrides(sj, tj, reset_optimizer_state=True,
                                                 log=lambda *_: None)
            st = apply_resume_overrides(st, tt, reset_optimizer_state=True,
                                        log=lambda *_: None)
            assert (st.opt_state["count"], st.opt_state["schedule_count"]) == (0, 3)
        g = _param_tree(10 + i)
        upd, opt = update(jax.tree.map(jnp.asarray, g), sj.opt_state, sj.params)
        sj = sj.replace(params=optax.apply_updates(sj.params, upd), opt_state=opt,
                        step=sj.step + 1)
        txt.step(params, [torch.from_numpy(g[k].copy()) for k in st.model], st.opt_state)
        st.step += 1
    for k, p in st.model.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(sj.params[k]),
                                   atol=1e-6, rtol=1e-6)
    # had the reset restarted the warmup, the last update would be 4x smaller
    assert st.opt_state["schedule_count"] == 4 and st.opt_state["count"] == 1


def test_state_without_schedule_count_runs_the_schedule_on_count():
    """An optimizer state from before the schedule clock existed (and a
    checkpoint of one) still steps, on its Adam count."""
    tx = make_optimizer(TrainConfig(base_lr=1.0, warmup_steps=4, grad_clip=None))
    a = [torch.ones(3)]
    b = [torch.ones(3)]
    sa = tx.init(a)
    sb = {k: v for k, v in tx.init(b).items() if k != "schedule_count"}
    for _ in range(2):
        g = torch.full((3,), 0.5)
        tx.step(a, [g.clone()], sa)
        tx.step(b, [g.clone()], sb)
    assert torch.equal(a[0], b[0]) and sb["schedule_count"] == 2


def test_catch_preemption_trips_and_restores():
    before = signal.getsignal(signal.SIGTERM)
    with catch_preemption() as flag:
        assert not flag
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(1000):
            if flag:
                break
        assert flag and flag.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is before


def test_preemption_flag_manual():
    flag = PreemptionFlag()
    assert not flag
    flag()
    assert flag and flag.signum is None
