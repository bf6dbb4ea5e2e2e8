"""The fused update's host side on the CPU (``ops/fused_update.py``): the
kernels' tables cover every element of every tensor once, the plain
versions are the former calls bit for bit, and the train step computes the
global norm once and makes its EMA step through its own ``ema_update``.
The kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from ddpm_diffusion_model_tpu_torch.ops import fused_update as tfu
from ddpm_diffusion_model_tpu_torch.training import (TrainConfig, ema_init, ema_update,
                                                     make_optimizer)
from ddpm_diffusion_model_tpu_torch.training import state as state_mod
from ddpm_diffusion_model_tpu_torch.training.state import global_norm

CHUNK = tfu.CHUNK


def _tensors(shapes, seed=0):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for shape in shapes:
        t = torch.randn(*shape, generator=gen)
        if len(shape) == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        out.append(t)
    return out


def _cover(table, nchunks):
    """Each tensor's elements as the kernel's blocks visit them: block c
    takes the last record whose first chunk (the last column) is at most c,
    and elements [(c - first) * CHUNK, +CHUNK) of it, cut at its size (the
    column before)."""
    sizes, firsts = table[:, -2], table[:, -1]
    seen = [np.zeros(n, dtype=np.int64) for n in sizes]
    for c in range(nchunks):
        r = int(np.searchsorted(firsts, c, side="right")) - 1
        start = (c - firsts[r]) * CHUNK
        seen[r][start:min(start + CHUNK, sizes[r])] += 1
    return seen


F32 = torch.float32


def _update_table(ps, mu=None, mu_dtype=F32):
    """The update kernel's table for weights ``ps``: grads, moments as the
    weights (the first moment ``mu`` where given)."""
    mu = [torch.zeros_like(p) for p in ps] if mu is None else mu
    return tfu.records((ps, [torch.zeros_like(p) for p in ps], mu,
                        [torch.zeros_like(p) for p in ps]),
                       (F32, F32, mu_dtype, F32), ("param", "grad", "mu", "nu"))


@pytest.mark.parametrize("shapes", [
    [(1,), (3,), (4 * 1001 + 1,)],
    [(CHUNK,), (CHUNK + 1,), (3 * CHUNK - 1,), (0,), (2,)],
    [(64, 32, 3, 3), (5,), (8, 3, 1, 1), (2 * CHUNK + 3,)],
], ids=["odd", "chunk_edges", "channels_last"])
@pytest.mark.parametrize("kind", ["update", "ema"])
def test_the_table_covers_every_element_once(shapes, kind):
    """The update's table (weight, grad, moments) and the EMA's (shadow,
    weight): one row per non-empty tensor, its pointers, size and first
    chunk, and every element in exactly one block."""
    ps = _tensors(shapes)
    lists = [ps] + [[torch.randn_like(p) for p in ps] for _ in range(3 if kind == "update" else 1)]
    if kind == "ema":
        lists = lists[::-1]  # the shadow first
    table, nchunks = tfu.records(lists, [F32] * len(lists), [f"l{j}" for j in range(len(lists))])
    nonempty = [i for i, p in enumerate(ps) if p.numel()]
    assert table.shape == (len(nonempty), len(lists) + 2)
    assert nchunks == sum(-(-ps[i].numel() // CHUNK) for i in nonempty)
    for row, i in zip(table, nonempty):
        assert list(row[:len(lists)]) == [ts[i].data_ptr() for ts in lists]
        assert row[len(lists)] == ps[i].numel()
    assert all((s == 1).all() for s in _cover(table, nchunks))


def test_the_table_refuses_what_the_kernel_cannot_take_flat():
    w = _tensors([(8, 4, 3, 3)])[0]

    def rec(p, mu=None, mu_dtype=F32):
        return _update_table([p], None if mu is None else [mu], mu_dtype)

    with pytest.raises(ValueError, match="strides"):
        rec(w, mu=torch.zeros(w.shape))  # NCHW moment, NHWC weight
    with pytest.raises(ValueError, match="not dense"):
        rec(torch.randn(8, 6)[:, :4])
    with pytest.raises(ValueError, match="float64"):
        rec(torch.randn(5, dtype=torch.float64))
    with pytest.raises(ValueError, match="bfloat16"):
        rec(torch.randn(5), mu_dtype=torch.bfloat16)
    rec(torch.randn(5), mu=torch.zeros(5, dtype=torch.bfloat16), mu_dtype=torch.bfloat16)
    # a 1x1 conv weight: a dimension of size 1 may carry any stride
    w1 = torch.empty_strided((96, 64, 1, 1), (64, 1, 64, 64)).normal_()  # as .to(channels_last)
    rec(w1, mu=torch.zeros(96, 64, 1, 1))
    with pytest.raises(ValueError, match="strides"):  # the EMA's: an NCHW shadow
        tfu.records(([torch.zeros(w.shape)], [w]), (F32, F32), ("ema", "param"))
    with pytest.raises(ValueError, match="2 ema, 1 param"):
        tfu.records(([w, w], [w]), (F32, F32), ("ema", "param"))


# the configurations of test_optimizer_and_ema_match_optax (test_torch_training.py)
CFGS = {"clip": dict(grad_clip=1.0),
        "noclip_wd": dict(grad_clip=100.0, weight_decay=0.01),
        "noclip_nowarmup": dict(grad_clip=None, warmup_steps=None),
        "bf16_mu": dict(grad_clip=1.0, moment_dtype="bfloat16")}
SHAPES = [(3, 4), (5,), (2, 3, 2), (4, 3, 2, 2)]


def _state(cfg_kw):
    cfg = TrainConfig(**dict(dict(base_lr=1e-2, warmup_steps=4, ema_decay=0.9), **cfg_kw))
    named = {f"p{i}": torch.nn.Parameter(t) for i, t in enumerate(_tensors(SHAPES))}
    tx = make_optimizer(cfg)
    return cfg, named, tx, tx.init(list(named.values())), ema_init(named)


def _former_ema(ema, named, decay):
    """The EMA step as ``ema_update`` made it before the kernel: two
    multi-tensor ops."""
    d = np.float32(decay)
    shadow = list(ema.values())
    torch._foreach_mul_(shadow, float(d))
    torch._foreach_add_(shadow, [p.detach() for p in named.values()],
                        alpha=float(np.float32(1.0) - d))


@pytest.mark.parametrize("fn", ["adamw_", "adamw_reference"])
@pytest.mark.parametrize("cfg", list(CFGS))
def test_the_plain_version_is_the_former_sequence_bit_for_bit(cfg, fn):
    """Three updates: the op (on CPU tensors, its plain version) and
    ``ema_update`` (its plain lerp) against ``global_norm``,
    ``AdamWClip.step`` and the former EMA step as the train step called
    them, each computing its own norm."""
    runs = []
    for way in ("former", fn):
        c, named, tx, opt, ema = _state(CFGS[cfg])
        norms = []
        for step in range(3):
            grads = [4 * g for g in _tensors(SHAPES, seed=10 + step)]
            if way == "former":
                norms.append(global_norm(grads))
                tx.step(list(named.values()), grads, opt)
                _former_ema(ema, named, c.ema_decay)
            else:
                norms.append(getattr(tfu, fn)(tx, list(named.values()), grads, opt))
                ema_update(ema, named, c.ema_decay)
        runs.append((norms, [p.detach().clone() for p in named.values()],
                     opt["mu"] + opt["nu"], list(ema.values()), opt["count"],
                     opt["schedule_count"]))
    (n0, p0, m0, e0, c0, s0), (n1, p1, m1, e1, c1, s1) = runs
    assert (c0, s0) == (c1, s1) == (3, 3)
    for a, b in zip(n0 + p0 + m0 + e0, n1 + p1 + m1 + e1):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_the_plain_version_takes_a_given_norm():
    """A given norm is the one the clip divides by and the one returned."""
    c, named, tx, opt, ema = _state(CFGS["clip"])
    grads = _tensors(SHAPES, seed=10)
    norm = torch.tensor(123.0)
    out = tfu.adamw_(tx, list(named.values()), [g.clone() for g in grads], opt, grad_norm=norm)
    assert out is norm
    c2, named2, tx2, opt2, _ = _state(CFGS["clip"])
    tx2.step(list(named2.values()), [g.clone() for g in grads], opt2, grad_norm=norm)
    for a, b in zip(named.values(), named2.values()):
        assert torch.equal(a, b)


def test_the_train_step_computes_the_global_norm_once(monkeypatch):
    """One update of a tiny U-Net with the clip on: the plain norm runs
    once (the op's), where the step and the optimizer each ran it."""
    from ddpm_diffusion_model_tpu_torch.models import UNetConfig, UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
    from ddpm_diffusion_model_tpu_torch.training import init_train_state, make_train_step

    calls = []

    def counted(tensors):
        calls.append(len(tensors))
        return global_norm(tensors)

    monkeypatch.setattr(state_mod, "global_norm", counted)
    torch.manual_seed(0)
    model = UNetDenoiser(UNetConfig(base_channels=16, channel_mults=(1, 2), num_res_blocks=1,
                                    attn_resolutions=(4,), time_embed_dim=32, num_heads=2,
                                    head_dim=8, img_resolution=8),
                         dtype=torch.float32, device="cpu")
    cfg = TrainConfig(base_lr=1e-3, warmup_steps=None, grad_clip=1.0)
    state, tx = init_train_state(model, cfg)
    sched = make_schedule(DiffusionConfig(T=10, img_size=8), device="cpu")
    step = make_train_step(model, sched, tx, cfg)
    state, m = step(state, torch.rand(2, 8, 8, 3) * 2 - 1)
    assert calls == [len(list(model.parameters()))]
    assert state.opt_state["count"] == 1 and torch.isfinite(m["grad_norm"])


def test_the_train_step_takes_its_ema_step_by_its_own_name(monkeypatch):
    """The update's EMA step is the one the step module binds as
    ``ema_update`` (a benchmark's fault replaces it there), called once an
    update with the state's decay, after the optimizer step."""
    from ddpm_diffusion_model_tpu_torch.training import step as step_mod

    c, named, tx, opt, ema = _state(CFGS["clip"])
    model = torch.nn.Module()
    for k, p in named.items():
        model.register_parameter(k, p)
    state = state_mod.TrainState(step=0, model=model, opt_state=opt, ema_params=ema,
                                 ema_decay=c.ema_decay, generator=torch.Generator())
    seen = []

    def record(e, p, d):
        seen.append((e is ema, list(p), d, opt["count"]))

    monkeypatch.setattr(step_mod, "ema_update", record)
    for p, g in zip(named.values(), _tensors(SHAPES, seed=10)):
        p.grad = g
    step_mod._finish_update(state, tx, list(named.values()))
    assert seen == [(True, list(named), c.ema_decay, 1)]
    assert state.step == 1 and all(p.grad is None for p in named.values())


def test_a_restored_state_takes_the_template_layout(tmp_path):
    """Moments and shadow saved in NCHW order come back laid out as the
    template's (channels_last) weights, with the same values."""
    from ddpm_diffusion_model_tpu_torch.training import (TrainState, load_checkpoint,
                                                         save_checkpoint)

    def make(fmt):
        model = torch.nn.Conv2d(3, 8, 3).to(memory_format=fmt)
        cfg = TrainConfig()
        tx = make_optimizer(cfg)
        named = dict(model.named_parameters())
        return TrainState(step=0, model=model, opt_state=tx.init(list(named.values())),
                          ema_params=ema_init(named), ema_decay=0.9,
                          generator=torch.Generator().manual_seed(0))

    saved = make(torch.contiguous_format)
    for m in saved.opt_state["mu"]:
        m.normal_()
    save_checkpoint(str(tmp_path / "ck"), saved)
    template = make(torch.channels_last)
    state, _ = load_checkpoint(str(tmp_path / "ck"), template)
    w = dict(template.model.named_parameters())["weight"]
    assert not w.is_contiguous()
    mu = state.opt_state["mu"][0]
    assert mu.stride() == w.stride() == state.ema_params["weight"].stride()
    assert torch.equal(mu, saved.opt_state["mu"][0])
