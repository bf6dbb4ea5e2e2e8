"""The port's whole training run, ``train_ddpm``: the run end to end with
its table, probes, sample hook and checkpoints; a preempted run resumed
with ``resume_path="auto"`` equal bit for bit to the uninterrupted one;
the sample hook leaving the live weights untouched; the eval pass, the
metrics JSONL, the resume-time overrides and the options not ported yet.
Against the JAX package's ``train_ddpm`` on the same numpy data: the
files a run leaves, their ``meta.json``, the epoch table's header and
rows' step and lr columns, the metrics JSONL's keys and the warnings."""

import functools
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint  # noqa: F401 -- the JAX checkpoints' library, imported once here
import pytest
import torch

from ddpm_diffusion_model_tpu.models import UNetConfig as JaxUNetConfig
from ddpm_diffusion_model_tpu.models import UNetDenoiser as JaxUNet
from ddpm_diffusion_model_tpu.ops import DiffusionConfig as JaxDiffusionConfig
from ddpm_diffusion_model_tpu.ops import make_schedule as jax_make_schedule
from ddpm_diffusion_model_tpu.training import TrainConfig as JaxTrainConfig
from ddpm_diffusion_model_tpu.training import train_ddpm as jax_train_ddpm
from ddpm_diffusion_model_tpu_torch.models import UNetConfig, UNetDenoiser
from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
from ddpm_diffusion_model_tpu_torch.sampling import ddim_sample
from ddpm_diffusion_model_tpu_torch.training import (PreemptionFlag, TrainConfig,
                                                     load_checkpoint, init_train_state,
                                                     read_meta, train_ddpm)

torch.set_num_threads(1)

RES = 8
TINY = dict(base_channels=16, channel_mults=(1, 2), num_res_blocks=1,
            attn_resolutions=(4,), time_embed_dim=16, num_heads=1, head_dim=8,
            img_resolution=RES)


def _sched():
    return make_schedule(DiffusionConfig(T=20, img_size=RES), device="cpu")


@pytest.fixture(scope="module")
def init():
    torch.manual_seed(0)
    return UNetDenoiser(UNetConfig(**TINY, dropout=0.1), dtype=torch.float32,
                        device="cpu").state_dict()


def _model(dropout=0.1, remat=False):
    return UNetDenoiser(UNetConfig(**TINY, dropout=dropout), dtype=torch.float32,
                        device="cpu", remat=remat).to(memory_format=torch.channels_last)


def _data(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(4, RES, RES, 3)).astype(np.float32) * 0.3 for _ in range(n)]


class _Loader:
    """A re-iterable loader with ``set_epoch`` that shuffles its batches by
    epoch, and trips ``flag`` when batch ``trip[1]`` of epoch ``trip[0]``
    is drawn."""

    def __init__(self, data, flag=None, trip=(1, 2)):
        self.data, self.flag, self.trip, self.epoch = data, flag, trip, None
        self.epochs_set = []

    def set_epoch(self, epoch):
        self.epoch = epoch
        self.epochs_set.append(epoch)

    def __iter__(self):
        order = np.random.default_rng(self.epoch).permutation(len(self.data))
        for i, j in enumerate(order):
            if self.flag is not None and (self.epoch, i) == self.trip:
                self.flag()
            yield self.data[j]


def _assert_states_equal(a, b):
    assert a.step == b.step and a.ema_decay == b.ema_decay
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k
    assert (a.opt_state["count"], a.opt_state["schedule_count"]) == \
        (b.opt_state["count"], b.opt_state["schedule_count"])
    for m, n in zip(a.opt_state["mu"] + a.opt_state["nu"],
                    b.opt_state["mu"] + b.opt_state["nu"]):
        assert torch.equal(m, n)
    assert all(torch.equal(a.ema_params[k], b.ema_params[k]) for k in a.ema_params)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


CFG = TrainConfig(base_lr=1e-3, warmup_steps=5, grad_accum_steps=2, ema_decay=0.9)
SAMPLE = functools.partial(ddim_sample, steps=2, device="cpu")


def _run(init, ckpt_dir, loader, remat=False, **kw):
    kw = dict(dict(train_config=CFG, init_params=init, epochs=3, img_size=RES,
                   ckpt_dir=ckpt_dir, run_name="r", save_every=1, sample_every=1,
                   sample_n=4, sample_fn=SAMPLE, handle_preemption=False), **kw)
    return train_ddpm(_model(remat=remat), _sched(), loader, **kw)


def test_train_ddpm_end_to_end_with_resume(init, tmp_path, capsys):
    calls = []

    def sample_fn(model_, params_, sched_, *, n, img_size, save_path, seed):
        calls.append((params_ is not None, save_path, seed))

    ckpt_dir = str(tmp_path / "ck")
    state, summary = train_ddpm(
        _model(), _sched(), _data(), train_config=CFG, init_params=init, epochs=2,
        sample_every=1, sample_n=1, img_size=RES, sample_fn=sample_fn,
        ckpt_dir=ckpt_dir, run_name="t", save_every=1, log_every=1,
        probe_timesteps=[5, 15], log_grad_norm=True,
        configs_for_ckpt={"train": CFG.to_dict()})
    out = capsys.readouterr().out
    assert "DDPM run: t" in out and "imgs/s" in out and "t=5:" in out
    base = float([ln for ln in out.splitlines() if "(baseline)" in ln][0].split("~")[1].split()[0])
    assert abs(base - 1.0) < 0.25
    assert [c[2] for c in calls] == [1234, 1234] and all(c[0] for c in calls)
    assert state.step == 6 and len(summary["epochs"]) == 2
    assert sorted(os.listdir(ckpt_dir)) == ["t_e000", "t_e001", "t_last", "t_metrics.jsonl"]
    assert read_meta(os.path.join(ckpt_dir, "t_last"))["configs"]["train"]["base_lr"] == 1e-3

    state2, _ = train_ddpm(
        _model(), _sched(), _data(), train_config=CFG, init_params=init, epochs=2,
        sample_every=10, img_size=RES, ckpt_dir=ckpt_dir, run_name="t2", save_every=10,
        save_last=False, resume_path=os.path.join(ckpt_dir, "t_e000"),
        override_lr=5e-4, repair_ema_on_resume=True)
    out2 = capsys.readouterr().out
    assert "[RESUME] loaded" in out2 and "override_lr" in out2
    assert "start_epoch=1" in out2 and state2.step == 6


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_preempted_and_resumed_run_equals_the_uninterrupted_one(init, tmp_path, capsys,
                                                                remat):
    """(a) three epochs; (b) the same, a PreemptionFlag tripped when the
    third batch of epoch 1 is drawn; (c) resume_path="auto": the _preempt
    save (meta epoch 0), the rest of epoch 1, epoch 2.  (c) equals (a) bit
    for bit: params, EMA, moments, both counts, step, generator."""
    data = _data()
    a, _ = _run(init, str(tmp_path / "a"), _Loader(data), remat=remat)
    flag = PreemptionFlag()
    b, sum_b = _run(init, str(tmp_path / "b"), _Loader(data, flag), remat=remat,
                    handle_preemption=flag)
    assert sum_b["preempted"] and b.step == 5
    ck = str(tmp_path / "b")
    assert sorted(os.listdir(ck)) == ["r_e000", "r_metrics.jsonl", "r_preempt",
                                      "r_samples_e000.png"]
    meta = read_meta(os.path.join(ck, "r_preempt"))
    assert (meta["epoch"], meta["global_step"]) == (0, 5)
    assert meta["extra"]["partial_batches"] == 2
    with open(os.path.join(ck, "r_metrics.jsonl")) as f:
        assert json.loads(f.readlines()[-1])["partial"] is True
    capsys.readouterr()
    loader = _Loader(data)
    c, sum_c = _run(init, ck, loader, remat=remat, resume_path="auto")
    out = capsys.readouterr().out
    assert "r_preempt" in out and "start_epoch=1" in out
    assert loader.epochs_set == [1, 2]
    assert [e["epoch"] for e in sum_c["epochs"]] == [1, 2]
    _assert_states_equal(c, a)
    restored, _ = load_checkpoint(os.path.join(ck, "r_last"),
                                  init_train_state(_model(), CFG)[0])
    _assert_states_equal(restored, a)


def test_a_signal_preempts_and_auto_resume_finishes(init, tmp_path, capsys):
    """SIGTERM during epoch 0: the handler installed by the run trips, the
    run stops at the batch boundary, saves _preempt and no _last; the
    relaunch finishes the run."""

    class SignalingLoader:
        fired = False

        def __iter__(self):
            for i, x in enumerate(_data(6)):
                if i == 2 and not SignalingLoader.fired:
                    SignalingLoader.fired = True
                    os.kill(os.getpid(), signal.SIGTERM)
                yield x

    before = signal.getsignal(signal.SIGTERM)
    ckpt_dir = str(tmp_path / "ck")
    kw = dict(train_config=TrainConfig(base_lr=1e-3, warmup_steps=5), init_params=init,
              epochs=3, sample_every=10, img_size=RES, ckpt_dir=ckpt_dir,
              run_name="pre", save_every=10)
    state, summary = train_ddpm(_model(), _sched(), SignalingLoader(), **kw)
    assert signal.getsignal(signal.SIGTERM) is before
    out = capsys.readouterr().out
    assert summary["preempted"] is True and "[PREEMPT] signal=" in out
    assert state.step == 2
    assert not os.path.exists(os.path.join(ckpt_dir, "pre_last"))
    meta = read_meta(os.path.join(ckpt_dir, "pre_preempt"))
    assert (meta["epoch"], meta["global_step"]) == (-1, 2)
    state2, summary2 = train_ddpm(_model(), _sched(), SignalingLoader(),
                                  resume_path="auto", **kw)
    out2 = capsys.readouterr().out
    assert "[RESUME] auto ->" in out2 and "pre_preempt" in out2
    assert "preempted" not in summary2 and len(summary2["epochs"]) == 3
    assert state2.step == 18  # the 4 untrained batches of epoch 0, then 2 x 6
    assert os.path.isdir(os.path.join(ckpt_dir, "pre_last"))


def test_cooperative_flag_after_complete_epoch(init, tmp_path, capsys):
    """A flag tripped in the epoch-0 sample hook: the epoch is complete, so
    the _preempt save records it and the resume goes on with epoch 1."""
    flag = PreemptionFlag()

    def tripping_sample_fn(model_, params_, sched_, *, n, img_size, save_path, seed):
        flag()

    ckpt_dir = str(tmp_path / "ck")
    kw = dict(train_config=TrainConfig(base_lr=1e-3, warmup_steps=5), init_params=init,
              epochs=3, img_size=RES, ckpt_dir=ckpt_dir, run_name="coop", save_every=10)
    state, summary = train_ddpm(_model(), _sched(), _data(), sample_every=1,
                                sample_fn=tripping_sample_fn, handle_preemption=flag, **kw)
    assert summary["preempted"] is True and state.step == 3
    meta = read_meta(os.path.join(ckpt_dir, "coop_preempt"))
    assert meta["epoch"] == 0 and "partial_batches" not in meta["extra"]
    capsys.readouterr()
    state2, summary2 = train_ddpm(_model(), _sched(), _data(), sample_every=10,
                                  resume_path="auto", **kw)
    assert "start_epoch=1" in capsys.readouterr().out
    assert len(summary2["epochs"]) == 2 and state2.step == 9


def test_handle_preemption_off_leaves_handlers(init, tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    sentinel = lambda s, f: None  # noqa: E731
    signal.signal(signal.SIGTERM, sentinel)
    try:
        train_ddpm(_model(), _sched(), _data(1), train_config=CFG, init_params=init,
                   epochs=1, sample_every=10, img_size=RES, ckpt_dir=str(tmp_path),
                   run_name="np", save_every=10, save_last=False, handle_preemption=False)
        assert signal.getsignal(signal.SIGTERM) is sentinel
    finally:
        signal.signal(signal.SIGTERM, before)


def test_sample_hook_leaves_the_params_bit_equal(init, tmp_path):
    """The hook samples with the EMA shadow through functional_call: the
    live weights, and so the training after it, do not change."""
    seen = []

    def hook(model_, params_, sched_, **kw):
        before = {k: v.detach().clone() for k, v in model_.named_parameters()}
        grid = ddim_sample(model_, params_, sched_, steps=2, device="cpu", **kw)
        after = dict(model_.named_parameters())
        seen.append((params_ is not None, all(torch.equal(before[k], after[k])
                                              for k in before), model_.training))
        return grid

    a, _ = _run(init, str(tmp_path / "a"), _data(), sample_fn=hook, epochs=2)
    b, _ = _run(init, str(tmp_path / "b"), _data(), sample_fn=None, epochs=2)
    assert seen == [(True, True, True), (True, True, True)]
    _assert_states_equal(a, b)
    assert os.path.getsize(tmp_path / "a" / "r_samples_e001.png") > 0


def test_eval_pass_and_metrics_jsonl(init, tmp_path, monkeypatch):
    val = _data(2, seed=1)
    state, summary = _run(init, str(tmp_path / "ck"), _data(2), epochs=2, sample_fn=None,
                          eval_loader=val, save_every=0, save_last=False)
    for e in summary["epochs"]:
        assert np.isfinite(e["val_loss"]) and np.isfinite(e["val_loss_ema"])
    with open(summary["metrics_jsonl"]) as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["global_step"] for r in recs] == [2, 4]
    assert all({"epoch", "loss", "imgs_per_s", "seconds", "lr", "ts", "val_loss",
                "val_loss_ema"} <= set(r) for r in recs)
    custom = str(tmp_path / "m.jsonl")
    _s, summ2 = _run(init, str(tmp_path / "ck2"), _data(1), epochs=1, sample_fn=None,
                     save_every=0, save_last=False, metrics_jsonl=custom)
    assert os.path.exists(custom) and summ2["metrics_jsonl"] == custom
    _s, summ3 = _run(init, str(tmp_path / "ck3"), _data(1), epochs=1, sample_fn=None,
                     save_every=0, save_last=False, metrics_jsonl=None)
    assert "metrics_jsonl" not in summ3 and os.listdir(tmp_path / "ck3") == []
    # a diverged loss is written as null, strict JSON
    from ddpm_diffusion_model_tpu_torch.training import loop

    real = loop.train_one_epoch
    monkeypatch.setattr(loop, "train_one_epoch",
                        lambda *a, **k: (lambda r: (r[0], float("nan"), r[2], r[3]))(
                            real(*a, **k)))
    _s, summ4 = _run(init, str(tmp_path / "ck4"), _data(1), epochs=1, sample_fn=None,
                     save_every=0, save_last=False)
    with open(summ4["metrics_jsonl"]) as f:
        line = f.read()
    assert "NaN" not in line and json.loads(line)["loss"] is None


def test_resume_overrides_ignored_on_fresh_start(init, tmp_path, capsys):
    for kw in (dict(resume_path="auto", override_lr=5e-4, repair_ema_on_resume="force",
                    reset_optimizer_state=True),
               dict(override_lr=0.0)):  # falsy but passed
        _run(init, str(tmp_path / "empty"), _data(1), epochs=1, sample_fn=None,
             save_every=0, save_last=False, run_name="fresh", **kw)
        out = capsys.readouterr().out
        assert "WARNING: resume-time overrides requested" in out
        assert "base_lr: 1.00e-03" in out and "Reinitialized" not in out


def test_resume_adopts_checkpoint_optimizer_layout(init, tmp_path, capsys):
    cfg_tree = TrainConfig(base_lr=1e-3, warmup_steps=2, flat_optimizer=False)
    legacy_tc = {k: v for k, v in cfg_tree.to_dict().items()
                 if k not in ("flat_optimizer", "dropout_rng_impl")}
    ckpt_dir = str(tmp_path / "ck")
    _run(init, ckpt_dir, _data(2), train_config=cfg_tree, epochs=1, sample_fn=None,
         save_every=10, run_name="r1", configs_for_ckpt={"train": legacy_tc})
    capsys.readouterr()
    state, _ = _run(init, ckpt_dir, _data(2), train_config=TrainConfig(base_lr=1e-3,
                                                                       warmup_steps=2),
                    epochs=2, sample_fn=None, save_every=10, save_last=False,
                    run_name="r1b", resume_path=os.path.join(ckpt_dir, "r1_last"))
    out = capsys.readouterr().out
    assert "adopting checkpoint optimizer layout: flat_optimizer=False" in out
    assert state.step == 4


def test_options_not_ported_raise(init, tmp_path):
    for kw in (dict(mesh=object()), dict(fsdp=True),
               dict(fid_reference=np.zeros((4, RES, RES, 3), np.float32))):
        with pytest.raises(NotImplementedError, match="not ported"):
            _run(init, str(tmp_path), _data(1), epochs=1, **kw)


# ------------------------------------------------ against the JAX package


def test_run_leaves_what_the_jax_run_leaves(tmp_path, capsys):
    """The same numpy data, configs and cadence through both packages'
    train_ddpm: the same files, the same meta.json but for the configs'
    contents, the same table header and step/lr/batches/images columns,
    the same metrics JSONL keys and steps."""
    data = _data(2)
    cfg_kw = dict(base_lr=1e-3, warmup_steps=3, grad_accum_steps=1, ema_decay=0.9,
                  flat_optimizer=False)  # the quicker JAX compile
    kw = dict(epochs=2, sample_every=10, img_size=RES, run_name="p", save_every=1,
              log_every=0, handle_preemption=False, max_batches=1)
    small = dict(TINY, base_channels=8, attn_resolutions=())  # a quick JAX compile
    jm = JaxUNet(JaxUNetConfig(**small), dtype=jnp.float32)
    # weights play no part in what is compared: fill the param shapes from
    # numpy (no compile of init)
    rng = np.random.default_rng(1)
    jparams = jax.tree.map(
        lambda s: jnp.asarray(0.1 * rng.normal(size=s.shape), s.dtype),
        jax.eval_shape(jm.init, jax.random.key(0), jnp.ones((1, RES, RES, 3)),
                       jnp.zeros((1,))))
    jax_train_ddpm(jm, jax_make_schedule(JaxDiffusionConfig(T=20, img_size=RES)), data,
                   train_config=JaxTrainConfig(**cfg_kw), ckpt_dir=str(tmp_path / "j"),
                   init_params=jparams, **kw)
    out_j = capsys.readouterr().out
    model = UNetDenoiser(UNetConfig(**small), dtype=torch.float32, device="cpu")
    train_ddpm(model, _sched(), data, train_config=TrainConfig(**cfg_kw),
               ckpt_dir=str(tmp_path / "t"), **kw)
    out_t = capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for name in ("p_e000", "p_e001", "p_last"):
        mj, mt = (read_meta(str(tmp_path / side / name)) for side in ("j", "t"))
        assert mt == mj

    def table(out):  # the header, then (ep, step, lr, batches, images) of each row
        lines = out.splitlines()
        head = [ln for ln in lines if ln.startswith(" ep |")]
        rows = [[c.strip() for c in ln.split("|")] for ln in lines
                if ln[:3].strip().isdigit() and "|" in ln]
        return head, [(r[0], r[1], r[3], r[4], r[5]) for r in rows]

    assert table(out_t) == table(out_j)
    for side_out in (out_t, out_j):
        assert "DDPM run: p" in side_out and "Training finished in" in side_out

    def recs(side):
        with open(tmp_path / side / "p_metrics.jsonl") as f:
            return [json.loads(ln) for ln in f]

    rj, rt = recs("j"), recs("t")
    assert [set(r) for r in rt] == [set(r) for r in rj]
    assert [(r["epoch"], r["global_step"], r["lr"]) for r in rt] == \
        [(r["epoch"], r["global_step"], pytest.approx(r["lr"], rel=1e-6)) for r in rj]
