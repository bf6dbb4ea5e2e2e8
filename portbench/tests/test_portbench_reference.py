"""The benchmark's plain reference against the port's plain path (the
port's models in float32 on the CPU, where they run their plain
versions) at a tiny size: the forward with and without dropout and
labels, three training updates, and an auxiliary loss in the updates."""

import numpy as np
import pytest
import torch

from portbench.harness import checks, seeded
from portbench.reference.diffusion import Schedule, train_steps
from portbench.reference.dit import DiTRef
from portbench.reference.unet import UNetRef

from ddpm_diffusion_model_tpu_torch.models.dit import DiTConfig, DiTDenoiser  # noqa: E402
from ddpm_diffusion_model_tpu_torch.models.unet import UNetConfig, UNetDenoiser  # noqa: E402
from ddpm_diffusion_model_tpu_torch.ops.schedules import DiffusionConfig, make_schedule  # noqa: E402

UNET = dict(in_channels=3, base_channels=32, channel_mults=[1, 2], num_res_blocks=1,
            attn_resolutions=[8], time_embed_dim=64, dropout=0.1, attn_p_drop=0.0,
            num_heads=2, head_dim=16, img_resolution=16, num_classes=0, cond_channels=0)
DIT = dict(in_channels=3, img_resolution=16, patch_size=4, hidden_size=32, depth=2,
           num_heads=2, mlp_ratio=4.0, dropout=0.0, time_embed_dim=32, num_experts=0,
           capacity_factor=1.25, moe_aux_weight=0.01, num_classes=0)
DIFF = dict(T=1000, schedule="linear", beta_min=1e-4, beta_max=0.02, cosine_s=0.008,
            clamp_x0=True, dynamic_threshold=0.95, img_size=16, prediction_type="epsilon")
TRAIN = dict(base_lr=2e-4, warmup_steps=1000, weight_decay=0.0, adam_b1=0.9, adam_b2=0.999,
             grad_clip=1.0, grad_accum_steps=1, ema_decay=0.9997)


DIT_COND = dict(DIT, num_classes=10)


def _pair(kind):
    if kind == "unet":
        port = UNetDenoiser(UNetConfig.from_dict(UNET), dtype=torch.float32, device="cpu")
        ref = UNetRef(UNET)
    else:
        cfg = DIT_COND if kind == "dit_cond" else DIT
        port = DiTDenoiser(DiTConfig.from_dict(cfg), dtype=torch.float32, device="cpu")
        ref = DiTRef(cfg)
    specs = sorted(seeded.param_specs(ref))
    assert specs == sorted(seeded.param_specs(port))
    w = seeded.make_weights(specs, 5, "cpu")
    with torch.no_grad():
        for model in (port, ref):
            for n, p in model.named_parameters():
                p.copy_(w[n])
    return port, ref


def _close(a, b, tol):
    err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
    assert err < tol, err


@pytest.mark.parametrize("kind", ["unet", "dit", "dit_cond"])
def test_forward(kind):
    port, ref = _pair(kind)
    x = torch.randn(3, 16, 16, 3)
    t = torch.tensor([1, 500, 999])
    port.eval()
    with torch.no_grad():
        if kind == "dit_cond":
            y = torch.tensor([0, 9, 10])  # 10: the NULL token
            _close(port(x, t, y), ref(x, t, y=y), 1e-4)
        else:
            _close(port(x, t), ref(x, t), 1e-4)


def test_dropout_masks_are_the_programs():
    port, ref = _pair("unet")
    port.train()
    x, t = torch.randn(2, 16, 16, 3), torch.tensor([3, 700])
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    with torch.no_grad():
        _close(port(x, t, generator=g1), ref(x, t, g2), 1e-4)
    assert torch.equal(g1.get_state(), g2.get_state())


@pytest.mark.parametrize("kind, block", [("unet", None), ("dit", 2), ("dit_cond", None)])
def test_three_updates(kind, block):
    """For the conditional DiT each label is dropped with probability 1/2
    (drawn after t and the noise, as the port's step draws them)."""
    from ddpm_diffusion_model_tpu_torch.training.state import TrainConfig, init_train_state
    from ddpm_diffusion_model_tpu_torch.training.step import make_train_step

    port, ref = _pair(kind)
    sched = make_schedule(DiffusionConfig.from_dict(DIFF), device="cpu")
    train = dict(TRAIN, cond_dropout=0.5)
    cfg = TrainConfig(**train)
    state, tx = init_train_state(port, cfg, seed=21)
    step = make_train_step(port, sched, tx, cfg)
    batches = [torch.rand(4, 16, 16, 3) * 2 - 1 for _ in range(3)]
    if kind == "dit_cond":
        batches = [(b, torch.tensor([1, 4, 9, 4])) for b in batches]
    p0 = {n: p.detach().clone() for n, p in port.named_parameters()}
    losses, first = [], None
    for b in batches:
        losses.append(float(step(state, b)[1]["loss"]))
        if first is None:
            first = {n: float(m.norm()) / 0.1 for (n, _), m in
                     zip(port.named_parameters(), state.opt_state["mu"])}
    out = train_steps(ref, Schedule(DIFF, "cpu"), train, [lambda b=b: b for b in batches],
                      torch.Generator().manual_seed(21), row_block=block,
                      num_classes=DIT_COND["num_classes"])
    np.testing.assert_allclose(out["losses"], losses, rtol=1e-4)
    prog = {"losses": losses, "first_grad": first,
            "params": {n: p.detach() for n, p in port.named_parameters()},
            "ema": dict(state.ema_params)}
    numbers = checks.train_numbers(prog, out, p0)
    assert numbers["loss_gap"] < 1e-4 and numbers["grad_gap"] < 1e-4, numbers
    assert numbers["update_gap"] < 1e-3 and numbers["ema_gap"] < 1e-2, numbers
    for n in p0:
        _close(out["ema"][n], state.ema_params[n], 1e-6)


class _WithAux(torch.nn.Module):
    """The DiT reference returning ``(eps, aux)``, aux a weighted term of
    the parameters and the input, as a configuration's own reference may."""

    def __init__(self):
        super().__init__()
        self.dit = DiTRef(DIT)

    def forward(self, x, t, generator=None):
        eps = self.dit(x, t, generator)
        return eps, 0.05 * (self.dit.final_proj.weight.square().mean() + x.mean().abs())


def test_an_auxiliary_loss_joins_each_update():
    """The first gradient is autograd's of L_simple + aux on the same draws,
    and a row block below the batch is refused (the aux is the batch's)."""
    model = _WithAux()
    w = seeded.make_weights(sorted(seeded.param_specs(model)), 3, "cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    x0 = torch.rand(4, 16, 16, 3) * 2 - 1
    sched = Schedule(DIFF, "cpu")
    train = dict(TRAIN, grad_clip=None)
    gen = torch.Generator().manual_seed(8)
    t = torch.randint(1, sched.T, (4,), generator=gen)
    noise = torch.randn(x0.shape, generator=gen)
    x_t = sched.at(sched.sqrt_ab, t) * x0 + sched.at(sched.sqrt_omb, t) * noise
    eps, aux = model(x_t, t)
    loss = (noise - eps).square().mean(dim=(1, 2, 3)).mean() + aux
    params = dict(model.named_parameters())
    want = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    out = train_steps(model, sched, train, [lambda: x0], torch.Generator().manual_seed(8))
    np.testing.assert_allclose(out["losses"], [float(loss.detach())], rtol=1e-6)
    for n, g in want.items():
        torch.testing.assert_close(out["first_grad"][n], g, rtol=1e-5, atol=1e-8)
    with pytest.raises(ValueError, match="row_block 2 < batch 4"):
        train_steps(model, sched, train, [lambda: x0], torch.Generator().manual_seed(8),
                    row_block=2)
