"""``remat`` in the port's U-Net: ``True`` (the ResBlock recomputed under
non-reentrant ``torch.utils.checkpoint``) and ``"masks"`` (only the dropout
bits drawn again in the backward) give the loss and every gradient of
``remat=False`` bit for bit, with dropout 0.1 drawn from an explicit
generator, and leave that generator where a run without remat leaves it.
The JAX counterpart (``tests/test_dropout.py``'s masks test) holds the
same property to reassociation tolerance; here the recompute runs the same
eager ops, so the bar is equality.  The JAX model's ``remat`` runs too, as
a check that both packages agree the option changes no numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_diffusion_model_tpu.models import UNetConfig as JaxUNetConfig
from ddpm_diffusion_model_tpu.models import UNetDenoiser as JaxUNet
from ddpm_diffusion_model_tpu_torch.models import UNetConfig, UNetDenoiser
from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
from ddpm_diffusion_model_tpu_torch.ops.dropout import dropout, dropout_replayed
from ddpm_diffusion_model_tpu_torch.training import (TrainConfig, init_train_state,
                                                     make_train_step)
from ddpm_diffusion_model_tpu_torch.utils.interop import jax_params_to_state_dict

torch.set_num_threads(1)

SMALL = dict(base_channels=32, channel_mults=(1, 2), num_res_blocks=1,
             attn_resolutions=(8,), time_embed_dim=32, num_heads=2,
             head_dim=16, img_resolution=16, dropout=0.1)


def _models(impl="packed", dtype=torch.float32):
    """Three U-Nets with the same weights: remat False, True and "masks"."""
    torch.manual_seed(0)
    base = UNetDenoiser(UNetConfig(**SMALL), dtype=dtype, device="cpu",
                        dropout_impl=impl)
    sd = base.state_dict()
    out = {}
    for remat in (False, True, "masks"):
        m = UNetDenoiser(UNetConfig(**SMALL), dtype=dtype, device="cpu",
                         dropout_impl=impl, remat=remat)
        m.load_state_dict(sd, strict=True)
        out[remat] = m.to(memory_format=torch.channels_last).train()
    return out


def _inputs(B=2, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, 16, 16, 3)).astype(np.float32))
    t = torch.from_numpy(rng.integers(1, 100, size=(B,)))
    return x, t


def _grads(model, x, t, seed=7):
    gen = torch.Generator().manual_seed(seed)
    loss = model(x, t, generator=gen).float().square().mean()
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads, gen.get_state()


@pytest.mark.parametrize("impl", ["packed", "flax"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_remat_grads_bit_equal_to_no_remat(impl, dtype):
    models = _models(impl, dtype)
    x, t = _inputs()
    l0, g0, s0 = _grads(models[False], x, t)
    for remat in (True, "masks"):
        l1, g1, s1 = _grads(models[remat], x, t)
        assert torch.equal(l0, l1), remat
        for k in g0:
            assert torch.equal(g0[k], g1[k]), (remat, k)
        # the generator ends where the run without remat leaves it
        assert torch.equal(s0, s1), remat


@pytest.mark.parametrize("remat", [False, True, "masks"])
def test_remat_recomputes_the_resblocks_gn_only_under_true(remat, monkeypatch):
    """GN+SiLU forwards per forward and backward: 2 per ResBlock and the
    head's one, plus 2 per ResBlock again under remat=True (the recompute);
    the backwards once each."""
    from ddpm_diffusion_model_tpu_torch.models.blocks import ResBlock
    from ddpm_diffusion_model_tpu_torch.ops import fused_norm

    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("gn_silu_fwd", "fwd"), ("gn_silu_bwd", "bwd")):
        def counted(*a, _f=getattr(fused_norm, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(fused_norm, name, counted)
    model = _models()[remat]
    n_res = sum(isinstance(m, ResBlock) for m in model.modules())
    x, t = _inputs()
    _grads(model, x, t)
    assert n_res == 8
    assert calls == {"fwd": 2 * n_res + 1 + (2 * n_res if remat is True else 0),
                     "bwd": 2 * n_res + 1}


def test_remat_dropout_is_active_and_depends_on_the_generator():
    """The equality above is not the trivial one: the dropout changes the
    output, and another seed gives other grads under remat too."""
    models = _models()
    x, t = _inputs()
    _, ga, _ = _grads(models[True], x, t, seed=1)
    _, gb, _ = _grads(models[True], x, t, seed=2)
    assert any(not torch.equal(ga[k], gb[k]) for k in ga)
    with torch.no_grad():
        y_eval = models[True].eval()(x, t)
        y_a = models[True].train()(x, t, generator=torch.Generator().manual_seed(1))
    assert not torch.equal(y_eval, y_a)


def test_remat_train_step_bit_equal():
    """A whole train step (draws from the state's generator, two micro-
    batches): updated params, EMA, moments and the generator equal."""
    cfg = TrainConfig(base_lr=1e-3, warmup_steps=2, grad_accum_steps=2, ema_decay=0.9)
    sched = make_schedule(DiffusionConfig(T=100, img_size=16), device="cpu")
    x, _ = _inputs(B=4, seed=3)
    finals = {}
    for remat, model in _models().items():
        state, tx = init_train_state(model, cfg, seed=11)
        step = make_train_step(model, sched, tx, cfg)
        for _ in range(2):
            state, m = step(state, x)
        finals[remat] = (state, float(m["grad_norm"]))
    s0, n0 = finals[False]
    for remat in (True, "masks"):
        s1, n1 = finals[remat]
        assert n0 == n1
        for (k, a), b in zip(s0.model.named_parameters(), s1.model.parameters()):
            assert torch.equal(a, b), k
        for a, b in zip(s0.opt_state["mu"] + s0.opt_state["nu"],
                        s1.opt_state["mu"] + s1.opt_state["nu"]):
            assert torch.equal(a, b)
        assert all(torch.equal(s0.ema_params[k], s1.ema_params[k]) for k in s0.ema_params)
        assert torch.equal(s0.generator.get_state(), s1.generator.get_state())


@pytest.mark.parametrize("impl", ["packed", "flax"])
def test_dropout_replayed_equals_dropout(impl):
    """Same output and same draws as :func:`dropout`; its backward, drawn
    again from the saved state, equals autograd's through :func:`dropout`."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 8, 4, 4)).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last)
    dy = torch.from_numpy(rng.normal(size=(2, 8, 4, 4)).astype(np.float32))
    outs = []
    for fn in (dropout, dropout_replayed):
        xi = x.clone().requires_grad_()
        gen = torch.Generator().manual_seed(5)
        y = fn(xi, 0.3, impl, gen)
        y.backward(dy)
        outs.append((y.detach(), xi.grad, gen.get_state()))
    (y0, g0, s0), (y1, g1, s1) = outs
    assert torch.equal(y0, y1) and torch.equal(g0, g1) and torch.equal(s0, s1)
    assert bool((y0 == 0).any())
    assert dropout_replayed(x, 0.0, impl) is x


def test_unknown_remat_raises():
    with pytest.raises(ValueError, match="remat"):
        UNetDenoiser(UNetConfig(**SMALL), device="cpu", remat="bogus")


def test_remat_eval_forward_equals_jax_remat():
    """Carried weights, eval mode: the port's remat=True forward equals the
    JAX model's remat=True forward (remat changes neither)."""
    cfg = dict(SMALL, dropout=0.0)
    jm = JaxUNet(JaxUNetConfig(**cfg), dtype=jnp.float32, remat=True)
    x, t = _inputs()
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x.numpy()),
                              jnp.asarray(t.numpy(), jnp.float32))
    port = UNetDenoiser(UNetConfig(**cfg), dtype=torch.float32, device="cpu", remat=True)
    port.load_state_dict(jax_params_to_state_dict(params, port.config), strict=True)
    port = port.to(memory_format=torch.channels_last).eval()
    want = np.asarray(jm.apply(params, jnp.asarray(x.numpy()),
                               jnp.asarray(t.numpy(), jnp.float32)))
    with torch.no_grad():
        got = port(x, t).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
