"""The port's dropless mixture of experts (DiT-MoE's layer: top-2 of 8
bias-free SwiGLU experts with no capacity, a shared expert, the balance
loss summed over the blocks) on the CPU, float32:

- the layer and a small DiT-MoE (hidden 32, 8 experts, top-2, shared width
  64, 4 blocks, 10 classes) against the benchmark's plain reference
  (``portbench/reference/dit_moe.py``) on the same seeded random weights:
  the forward and the aux within 1e-5, the loss within 1e-6 relative and
  every parameter's gradient within 1e-4 of its norm (float32 products in
  another order: a few ulps, which the reference's fp8 control misses by
  far more, as a case here shows);
- the grouped path against a loop over the experts, with one expert given
  no rows and with every row given to one expert (float32: 1e-5);
- the balance loss on a hand-built routing;
- the spans of the layer in a profiled update and its launch counters;
- the configuration: its fields, the preset at the published widths, its
  parameter count, and the normal training path.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ddpm_diffusion_model_tpu_torch.models import DiTConfig, DiTDenoiser, build_denoiser
from ddpm_diffusion_model_tpu_torch.models import moe
from ddpm_diffusion_model_tpu_torch.models.dit import dit_moe_xl2_config
from ddpm_diffusion_model_tpu_torch.models.moe import (DroplessMoE, grouped_swiglu_bwd,
                                                       grouped_swiglu_fwd)
from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
from ddpm_diffusion_model_tpu_torch.training import StepDraws, make_loss_fn
from ddpm_diffusion_model_tpu_torch.utils import config as port_config
from portbench.harness.seeded import make_weights
from portbench.reference.dit_moe import DiTMoERef
from portbench.reference.lowp import FP8, FP32

torch.set_num_threads(2)

SMALL = dict(in_channels=4, img_resolution=8, patch_size=2, hidden_size=32, depth=4,
             num_heads=2, mlp_ratio=4.0, time_embed_dim=32, num_experts=8, num_classes=10,
             moe_router="dropless", experts_per_token=2, shared_expert_dim=64)


def _seeded(model, seed):
    """Every parameter drawn as the benchmark draws it (matrices at
    1/sqrt(fan-in), the zero-started heads included)."""
    specs = sorted((n, tuple(p.shape)) for n, p in model.named_parameters())
    w = make_weights(specs, seed, "cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    return w


def _pair(seed=5):
    cfg = DiTConfig(**SMALL)
    port = DiTDenoiser(cfg, dtype=torch.float32, device="cpu")
    w = _seeded(port, seed)
    ref = DiTMoERef(cfg.to_dict(), FP32)
    ref.load_state_dict(w)
    return cfg, port, ref


def _inputs(seed=0, B=4):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, 8, 8, 4, generator=g)
    t = torch.randint(1, 1000, (B,), generator=g)
    y = torch.randint(0, 11, (B,), generator=g)  # 10 is the NULL token
    return x, t, y


def test_the_parameters_carry_the_published_names_as_matrices():
    _, port, ref = _pair()
    names = dict(port.named_parameters())
    assert names.keys() == dict(ref.named_parameters()).keys()
    layer = {n[len("blocks.0.moe."):]: tuple(p.shape) for n, p in names.items()
             if n.startswith("blocks.0.moe.")}
    want = {"gate.weight": (8, 32)}
    for i in range(8):
        want.update({f"experts.{i}.gate_proj.weight": (128, 32),
                     f"experts.{i}.up_proj.weight": (128, 32),
                     f"experts.{i}.down_proj.weight": (32, 128)})
    want.update({"shared_experts.gate_proj.weight": (64, 32),
                 "shared_experts.up_proj.weight": (64, 32),
                 "shared_experts.down_proj.weight": (32, 64)})
    assert layer == want


@pytest.mark.parametrize("precision, close", [(FP32, True), (FP8, False)], ids=["fp32", "fp8"])
def test_forward_and_aux_match_the_reference(precision, close):
    cfg, port, ref = _pair()
    ref.p = precision
    x, t, y = _inputs()
    with torch.no_grad():
        eps, aux = port(x, t, y, return_aux=True)
        eps_ref, aux_ref = ref(x, t, y=y)
    err = float((eps - eps_ref).abs().max()) / float(eps_ref.abs().max())
    assert (err <= 1e-5) is close, err
    if close:
        # the model sums the blocks' losses; the reference weights the sum
        assert float(cfg.moe_aux_weight * aux) == pytest.approx(float(aux_ref), rel=1e-6)
        assert float(aux) > cfg.depth * 0.99  # each block's loss is about 1 or more


def _loss_and_grads(model, loss):
    params = [p for _, p in model.named_parameters()]
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), dict(zip([n for n, _ in model.named_parameters()], grads))


@pytest.mark.parametrize("seed", [5, 6])
def test_loss_and_every_gradient_match_the_reference(seed):
    cfg, port, ref = _pair(seed)
    x0, t, y = _inputs(seed)
    y = y.clamp(max=9)
    g = torch.Generator().manual_seed(seed)
    noise = torch.randn(x0.shape, generator=g)
    drop = torch.tensor([False, True, False, False])
    sched = make_schedule(DiffusionConfig(T=1000, schedule="linear", img_size=8,
                                          clamp_x0=False), device="cpu")
    loss_fn = make_loss_fn(port, sched, cond_dropout=0.1)
    got, grads = _loss_and_grads(port, loss_fn((x0, y), StepDraws(t, noise, drop=drop)))

    ab = sched.alphas_cumprod[t].reshape(-1, 1, 1, 1)
    x_t = ab.sqrt() * x0 + (1.0 - ab).sqrt() * noise
    eps, aux = ref(x_t, t, y=torch.where(drop, torch.full_like(y, 10), y))
    want, grads_ref = _loss_and_grads(ref, (noise - eps).square().mean() + aux)
    assert got == pytest.approx(want, rel=1e-6)
    for n, gr in grads_ref.items():
        scale = max(float(gr.norm()), 1e-6)
        assert float((grads[n] - gr).norm()) <= 1e-4 * scale, n
    assert float(grads["blocks.3.moe.gate.weight"].norm()) > 0
    assert float(grads["blocks.0.moe.shared_experts.down_proj.weight"].norm()) > 0


def _loop(xs, w13, w2, counts):
    out, s = [], 0
    for e, c in enumerate(counts):
        g, u = (xs[s:s + c] @ w13[e].t()).chunk(2, dim=-1)
        out.append((F.silu(g) * u) @ w2[e].t())
        s += c
    return torch.cat(out)


@pytest.mark.parametrize("counts", [[5, 3, 7, 1, 4, 6, 2, 4], [5, 3, 0, 1, 4, 6, 9, 4],
                                    [0, 0, 0, 32, 0, 0, 0, 0]],
                         ids=["spread", "one_empty", "all_to_one"])
def test_the_grouped_path_matches_a_loop_over_the_experts(counts):
    E, H, F_, R = 8, 16, 24, sum(counts)
    g = torch.Generator().manual_seed(R)
    xs, w13, w2, dy = (torch.randn(*s, generator=g) for s in
                       ((R, H), (E, 2 * F_, H), (E, H, F_), (R, H)))
    offs = torch.tensor(counts).cumsum(0).to(torch.int32)
    n, nb = moe.grouped_mm_launches, moe.grouped_mm_bwd_launches
    y, gu = grouped_swiglu_fwd(xs, w13, w2, offs)
    dxs, dw13, dw2 = grouped_swiglu_bwd(dy, xs, w13, w2, offs, gu)
    assert (moe.grouped_mm_launches - n, moe.grouped_mm_bwd_launches - nb) == (6, 4)
    leaves = [t.clone().requires_grad_(True) for t in (xs, w13, w2)]
    want = _loop(*leaves, counts)
    want.backward(dy)
    for got, ref in zip((y, dxs, dw13, dw2), (want, *(t.grad for t in leaves))):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    empty = [e for e, c in enumerate(counts) if c == 0]
    assert not dw13[empty].any() and not dw2[empty].any()


def test_the_balance_loss_on_a_hand_built_routing():
    """Four experts, two a token; the gate is the identity, so a token's
    logits are its first four features.  The routing and the counts are
    written down by hand, P from the softmax in float64."""
    layer = DroplessMoE(8, 16, 4, 2, 0, dtype=torch.float32)
    with torch.no_grad():
        layer.gate.weight.copy_(torch.eye(4, 8))
    logits = [[3, 2, 0, 0], [2, 3, 0, 0], [0, 0, 2, 3], [3, 0, 2, 0], [1, 0, 0, 2]]
    x = torch.zeros(1, 5, 8)
    x[0, :, :4] = torch.tensor(logits, dtype=torch.float32)
    y, aux = layer(x)
    # (0, 1), (1, 0), (3, 2), (0, 2), (3, 0): counts 4, 2, 2, 2 over 10 pairs
    f = 4 * np.array([4, 2, 2, 2]) / 10
    s = np.exp(np.array(logits, np.float64))
    P = (s / s.sum(1, keepdims=True)).mean(0)
    assert float(aux) == pytest.approx(float((P * f).sum()), rel=1e-6)
    assert y.shape == x.shape and torch.isfinite(y).all()


def test_the_layers_spans_and_counters_in_a_profiled_update():
    from ddpm_diffusion_model_tpu_torch.training import init_train_state, make_train_step
    from ddpm_diffusion_model_tpu_torch.training.state import TrainConfig

    cfg = DiTConfig(**{**SMALL, "depth": 2})
    model = DiTDenoiser(cfg, dtype=torch.float32, device="cpu")
    sched = make_schedule(DiffusionConfig(T=1000, img_size=8, clamp_x0=False), device="cpu")
    tc = TrainConfig(warmup_steps=0, grad_clip=None)
    state, tx = init_train_state(model, tc, seed=0)
    step = make_train_step(model, sched, tx, tc)
    batch = (torch.rand(4, 8, 8, 4) * 2 - 1, torch.arange(4))
    n, nb = moe.grouped_mm_launches, moe.grouped_mm_bwd_launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, batch)
    names = {e.name for e in prof.events()}
    assert {"moe.route", "moe.dispatch", "moe.experts", "moe.experts.bwd", "moe.shared",
            "moe.combine"} <= names
    assert (moe.grouped_mm_launches - n, moe.grouped_mm_bwd_launches - nb) == (12, 8)
    step(state, batch)  # no profiler: no span, the counters advance all the same
    assert moe.grouped_mm_launches - n == 24


def test_the_config_fields_and_the_preset():
    assert "moe_router" not in DiTConfig().to_dict()  # the JAX config's keys at the switch
    for bad in (dict(experts_per_token=2), dict(shared_expert_dim=8),
                dict(moe_router="dropless"), dict(moe_router="top2", num_experts=8)):
        with pytest.raises(ValueError):
            DiTConfig(**bad)
    exp = port_config.get_preset("imagenet256_dit_moe_xl2")
    assert port_config.ExperimentConfig.from_dict(exp.to_dict()) == exp
    m = exp.model
    assert (m.depth, m.hidden_size, m.num_heads, m.patch_size, m.in_channels, m.seq_len,
            m.num_experts, m.experts_per_token, int(m.hidden_size * m.mlp_ratio),
            m.shared_expert_dim, m.num_classes, m.moe_aux_weight) == \
        (28, 1152, 16, 2, 4, 256, 8, 2, 4608, 2304, 1000, 0.01)
    tr, d = exp.train, exp.diffusion
    assert (tr.base_lr, tr.warmup_steps, tr.weight_decay, tr.adam_b1, tr.adam_b2,
            tr.grad_clip, tr.ema_decay, tr.cond_dropout) == (1e-4, 0, 0.0, 0.9, 0.999, None,
                                                             0.9999, 0.1)
    assert (d.T, d.schedule, d.beta_min, d.beta_max, d.prediction_type, d.clamp_x0) == \
        (1000, "linear", 1e-4, 0.02, "epsilon", False)
    assert m == dit_moe_xl2_config()
    full = build_denoiser(m, device="meta")
    assert sum(p.numel() for p in full.parameters()) == 4_167_850_768
    stage = build_denoiser(dataclasses.replace(m, depth=7), device="meta")
    assert sum(p.numel() for p in stage.parameters()) == 1_046_066_704


def test_expert_parallelism_refuses_the_dropless_layer():
    from ddpm_diffusion_model_tpu_torch.parallel import VirtualMesh
    from ddpm_diffusion_model_tpu_torch.parallel.ep import expert_parallel_mesh

    layer = DroplessMoE(8, 16, 4, 2, 0, dtype=torch.float32)
    with expert_parallel_mesh(VirtualMesh((2,), ("expert",)), "expert"):
        with pytest.raises(ValueError, match="no expert-parallel form"):
            layer(torch.zeros(1, 3, 8))


def test_the_preset_trains_through_the_normal_path():
    """``ExperimentConfig.from_dict`` -> ``build_model`` -> ``train_one_epoch``
    over the device cache with labels, the preset cut to a CPU's widths."""
    from ddpm_diffusion_model_tpu_torch.data.loader import DeviceCacheLoader
    from ddpm_diffusion_model_tpu_torch.training import (build_model, init_train_state,
                                                         make_train_step, train_one_epoch)

    d = port_config.get_preset("imagenet256_dit_moe_xl2").to_dict()
    d["model"].update(img_resolution=8, hidden_size=32, depth=2, num_heads=2,
                      time_embed_dim=32, num_classes=10, shared_expert_dim=64)
    d["diffusion"]["img_size"] = d["img_size"] = 8
    exp = port_config.ExperimentConfig.from_dict(d)
    model, sched = build_model(exp, "cpu")
    rng = np.random.default_rng(0)
    corpus = rng.integers(0, 256, (32, 8, 8, 4), dtype=np.uint8)
    loader = DeviceCacheLoader(corpus, 8, seed=1, quantize=True,
                               labels=rng.integers(0, 10, 32).astype(np.int32), device="cpu")
    state, tx = init_train_state(model, exp.train, seed=2)
    step = make_train_step(model, sched, tx, exp.train)
    n = moe.grouped_mm_launches
    state, loss, nb, ni = train_one_epoch(step, state, loader, labeled=True, log=lambda *a: None)
    assert (nb, ni, state.step) == (4, 32, 4) and np.isfinite(loss)
    assert moe.grouped_mm_launches - n == 4 * 2 * 6
