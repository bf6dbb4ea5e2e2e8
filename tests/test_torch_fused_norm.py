"""The port's GN+SiLU(+time bias): its plain version (the CPU route of
``gn_silu_fwd``) against the JAX reference and the Pallas kernels in
interpret mode (2e-5 fp32, 2e-2 bf16, as tests/test_fused_norm.py), the
saved statistics, a large-mean input and the wrapper's checks.  The CUDA
kernel is held against the plain version on a card in
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ddpm_diffusion_model_tpu.ops import fused_norm as jfn
from ddpm_diffusion_model_tpu_torch.ops import fused_norm as tfn

torch.set_num_threads(1)


def _inputs(shape, groups, seed, with_tb=True, mean=0.0):
    rng = np.random.default_rng(seed)
    B, H, W, C = shape
    x = (rng.normal(size=shape) * 2.0 + mean).astype(np.float32)
    s = (1.0 + 0.1 * rng.normal(size=C)).astype(np.float32)
    b = (0.1 * rng.normal(size=C)).astype(np.float32)
    tb = rng.normal(size=(B, C)).astype(np.float32) if with_tb else None
    return x, s, b, groups, tb


def _port(x, s, b, g, tb, dtype=torch.float32):
    return tfn.gn_silu_fwd(torch.from_numpy(x).to(dtype), torch.from_numpy(s),
                           torch.from_numpy(b), g,
                           time_bias=None if tb is None else torch.from_numpy(tb))


@pytest.mark.parametrize("shape,groups", [
    ((2, 16, 16, 96), 32),   # low preset width
    ((1, 8, 8, 128), 32),
    ((2, 4, 4, 64), 32),
    ((1, 8, 8, 48), 16),
    ((2, 8, 4, 384), 32),    # attn preset decoder concat width
])
@pytest.mark.parametrize("with_tb", [False, True])
def test_matches_jax_reference_and_interpret_kernel(shape, groups, with_tb):
    x, s, b, g, tb = _inputs(shape, groups, seed=sum(shape), with_tb=with_tb)
    y, _, _ = _port(x, s, b, g, tb)
    ref = jfn.gn_silu_reference(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                g, time_bias=None if tb is None else jnp.asarray(tb))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=2e-5)
    with pltpu.force_tpu_interpret_mode():
        if with_tb:
            k = jfn.gn_silu_bias(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                 jnp.asarray(tb), g)
        else:
            k = jfn.gn_silu(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), g)
    np.testing.assert_allclose(y.numpy(), np.asarray(k), atol=2e-5)


def test_saved_statistics_match_tiled_forward():
    """mean/rstd per (b, c) are what the TPU forward saves for its backward."""
    x, s, b, g, tb = _inputs((2, 8, 8, 128), 32, seed=7)
    y, mu, rstd = _port(x, s, b, g, tb)
    yj, muj, rstdj = jfn._forward_tiled(jnp.asarray(x), jnp.asarray(s),
                                        jnp.asarray(b), jnp.asarray(tb), g, 1e-6,
                                        interpret=True)
    assert mu.shape == rstd.shape == (2, 128) and mu.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=2e-5)
    np.testing.assert_allclose(mu.numpy(), np.asarray(muj), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rstdj), rtol=1e-4)


def test_bf16_io():
    x, s, b, g, tb = _inputs((2, 8, 8, 64), 32, seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y, _, _ = _port(x, s, b, g, tb, dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    ref = jfn.gn_silu_reference(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                                jnp.asarray(s), jnp.asarray(b), g,
                                time_bias=jnp.asarray(tb))
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ref, np.float32),
                               atol=2e-2)


def test_large_mean_two_pass_variance():
    """mean 1000, std 2: the two-pass variance stays accurate in fp32 where
    E[u^2] - mu^2 would cancel."""
    x, s, b, g, tb = _inputs((2, 8, 8, 64), 32, seed=5, mean=1000.0)
    y, _, rstd = _port(x, s, b, g, tb)
    xd = x.astype(np.float64) + tb[:, None, None, :]
    xg = xd.reshape(2, 64, 32, 2)
    var = xg.var(axis=(1, 3))
    np.testing.assert_allclose(rstd.numpy()[:, ::2], 1 / np.sqrt(var + 1e-6),
                               rtol=1e-3)
    z = ((xg - xg.mean(axis=(1, 3), keepdims=True)) /
         np.sqrt(var[:, None, :, None] + 1e-6)).reshape(2, 8, 8, 64) * s + b
    np.testing.assert_allclose(y.numpy(), z / (1 + np.exp(-z)), atol=1e-3)


def test_wrapper_checks_and_cpu_route_counts_nothing():
    x, s, b, g, tb = _inputs((2, 4, 4, 64), 32, seed=9)
    xt, st, bt, tbt = (torch.from_numpy(a) for a in (x, s, b, tb))
    before = tfn.launches
    tfn.gn_silu_fwd(xt, st, bt, g, time_bias=tbt)
    assert tfn.launches == before  # the plain version launched nothing
    with pytest.raises(ValueError, match="contiguous"):
        tfn.gn_silu_fwd(xt.permute(0, 2, 1, 3), st, bt, g)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfn.gn_silu_fwd(xt.half(), st, bt, g)
    with pytest.raises(ValueError, match="divisible"):
        tfn.gn_silu_fwd(xt, st, bt, 24)
    with pytest.raises(ValueError, match="time_bias"):
        tfn.gn_silu_fwd(xt, st, bt, g, time_bias=tbt[:1])
    with pytest.raises(ValueError, match="scale"):
        tfn.gn_silu_fwd(xt, st.double(), bt, g)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfn.gn_silu_fwd(xt.to("meta"), st.to("meta"), bt.to("meta"), g)


# ------------------------------------------- the CUDA kernel's plan and sums

def _forward_gn_shapes(preset):
    """(H, W, C, groups) of every GN+SiLU call of one forward of ``preset``,
    recorded from a batch-1 forward on the meta device (shapes only)."""
    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.ops import flash_attention as tfa
    from ddpm_diffusion_model_tpu_torch.utils.config import get_preset

    calls = []

    def gn(x, scale, bias, groups, eps=1e-6, time_bias=None):
        calls.append((*x.shape[1:], groups))
        stat = x.new_empty(x.shape[0], x.shape[3], dtype=torch.float32)
        return torch.empty_like(x), stat, stat

    def flash(q, k, v, *args, **kw):
        return torch.empty_like(q), q.new_empty(q.shape[:2], dtype=torch.float32)

    p = get_preset(preset)
    saved = tfn.gn_silu_fwd, tfa.flash_attn_fwd
    tfn.gn_silu_fwd, tfa.flash_attn_fwd = gn, flash
    try:
        model = UNetDenoiser(p.model, device="meta").eval()
        with torch.inference_mode():
            model(torch.zeros(1, p.img_size, p.img_size, 3, device="meta"),
                  torch.zeros(1, dtype=torch.long, device="meta"))
    finally:
        tfn.gn_silu_fwd, tfa.flash_attn_fwd = saved
    return calls


_NARROW = [(2, 8, 8, 64, 32), (1, 8, 8, 128, 32), (2, 4, 4, 256, 32), (2, 16, 16, 96, 32),
           (2, 5, 3, 48, 16), (1, 3, 7, 30, 30), (2, 4, 4, 8192, 16), (65535, 1, 1, 32, 32)]


def test_gn_fwd_plan_covers_every_shape():
    """Every GN shape of a forward of the three presets at batch 128 and 16
    (fp32 and bf16), and the narrow test shapes, get a cluster of at most 16
    whose chunks cover H*W, split no finer than the plan's least chunk, and
    a shared-memory layout a block can have; the chunk stays resident
    exactly on grids of at most one block per two SMs where it fits a block;
    a bf16 celeba64_attn forward at batch 128, 16 and 8 splits its 45
    launches by route as chip_smoke.py holds the card's run to."""
    from chip_smoke import GN_FWD_SMEM_PER_FORWARD

    shapes = {name: _forward_gn_shapes(name)
              for name in ("celeba64_low", "celeba64_attn", "celebahq256")}
    assert {k: len(v) for k, v in shapes.items()} == {
        "celeba64_low": 29, "celeba64_attn": 45, "celebahq256": 55}
    cases = [(B, h, w, c, g) for B in (128, 16) for calls in shapes.values()
             for h, w, c, g in calls] + _NARROW
    for dtype in (torch.float32, torch.bfloat16):
        item = torch.tensor([], dtype=dtype).element_size()
        for B, H, W, C, G in cases:
            cluster, chunk, resident = tfn._gn_fwd_plan(B, H * W, C, G, dtype)
            assert cluster in (1, 2, 4, 8, 16) and chunk >= 1
            assert chunk * cluster >= H * W and (chunk - 1) * cluster < H * W
            tile, stages, nbytes = tfn._gn_fwd_smem(C, G, chunk, resident, item)
            assert 1 <= tile <= chunk and nbytes <= tfn._SMEM_MAX
            if cluster > 1:  # each halving left chunks of at least the least chunk
                assert H * W * C * item // cluster >= tfn._FWD_MIN_CHUNK_BYTES
                assert B * cluster // 2 < 198
            fits = tfn._gn_fwd_smem(C, G, chunk, True, item)[2] <= tfn._SMEM_MAX
            assert resident == (B * cluster <= 66 and fits)
            if resident:
                assert tile * stages >= chunk
            else:
                assert stages >= 2
    for B, smem in GN_FWD_SMEM_PER_FORWARD.items():
        routes = [tfn._gn_fwd_plan(B, h * w, c, g, torch.bfloat16)[2]
                  for h, w, c, g in shapes["celeba64_attn"]]
        assert sum(routes) == smem


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_gn_plans_cover_celebahq256_at_its_micro_batch(dtype):
    """celebahq256 trains at micro-batch 8 (batch 64, 8 accumulation
    steps): images of up to 256x256x256, 16-32 MB, 5-10x the largest the
    64-pixel presets give.  Both plans pick a legal cluster, chunk and
    shared-memory layout at each of its 55 GN shapes, and the kernels'
    32-bit element offsets hold the whole tensor."""
    item = torch.tensor([], dtype=dtype).element_size()
    shapes = _forward_gn_shapes("celebahq256")
    assert {(h, c) for h, _w, c, _g in shapes} >= {(256, 128), (256, 256), (16, 1024)}
    for H, W, C, G in shapes:
        assert 8 * H * W * C < 2 ** 31
        for plan_fn, smem_fn, cap in ((tfn._gn_fwd_plan, tfn._gn_fwd_smem, tfn._SMEM_MAX),
                                      (tfn._gn_bwd_plan, tfn._gn_bwd_smem,
                                       tfn._SMEM_PER_BLOCK)):
            cluster, chunk, resident = plan_fn(8, H * W, C, G, dtype)
            assert cluster in (1, 2, 4, 8, 16) and chunk * cluster >= H * W
            assert (chunk - 1) * cluster < H * W
            tile, stages, nbytes = smem_fn(C, G, chunk, resident, item)
            assert 1 <= tile <= chunk and nbytes <= tfn._SMEM_MAX
            assert tile * stages >= chunk if resident else stages >= 2
            if resident:
                assert nbytes <= cap
        if H == 256:  # a full wave of 16-block clusters, re-read
            assert tfn._gn_fwd_plan(8, H * W, C, G, dtype) == (16, H * W // 16, False)


def _kernel_order_fwd(x, s, b, groups, eps, tb, plan, itemsize=4):
    """A plain model of the CUDA forward's arithmetic and order of
    summation: d = x + (tb - K_c) with K_c the channel's first value of the
    image; per channel, each pixel lane's running sums of d and d^2 over its
    pixels of each tile of a chunk (fp32); then in fp64 the lanes in order,
    then the cluster's chunks (ranks) in order, each such sum rounded to
    fp32; then per group, channel by channel in fp64, sum u = S1 + HW K_c
    and sum u^2 = S2 + K_c (2 S1 + HW K_c); mu = sum u / n, var = sum u^2 /
    n - mu^2, mu and rstd rounded to fp32.  x (B, H, W, C) fp32 holding
    values of an ``itemsize``-byte type, 16-byte columns (16 / itemsize
    channels) where C allows.  The route does not change the order, only
    where sweep 2 reads x from."""
    cluster, chunk, resident = plan
    B, H, W, C = x.shape
    HW, cg = H * W, C // groups
    V = 16 // itemsize if C * itemsize % 16 == 0 else 1
    cw = min(C // V, 256)
    ppi = 256 // cw
    tile = tfn._gn_fwd_smem(C, groups, chunk, resident, itemsize)[0]
    tbf = tb if tb is not None else torch.zeros(B, C)
    xf = x.reshape(B, HW, C)
    K = xf[:, 0] + tbf                                # (B, C): each channel's shift
    d = xf + (tbf - K)[:, None]
    f64 = torch.float64
    s1, s2 = torch.zeros(B, C, dtype=f64), torch.zeros(B, C, dtype=f64)
    for r in range(cluster):
        p0, npx = r * chunk, max(0, min(chunk, HW - r * chunk))
        part1, part2 = torch.zeros(B, C, dtype=f64), torch.zeros(B, C, dtype=f64)
        for lane in range(ppi):
            a1, a2 = torch.zeros(B, C), torch.zeros(B, C)
            for t0 in range(0, npx, tile):
                for p in range(t0 + lane, min(t0 + tile, npx), ppi):
                    v = d[:, p0 + p]
                    a1 = a1 + v
                    a2 = a2 + v * v
            part1, part2 = part1 + a1.double(), part2 + a2.double()
        s1, s2 = s1 + part1.float().double(), s2 + part2.float().double()
    s1, s2 = s1.float().double(), s2.float().double()
    k = K.double()
    u1, u2 = s1 + HW * k, s2 + k * (2.0 * s1 + HW * k)
    g1, g2 = torch.zeros(B, groups, dtype=f64), torch.zeros(B, groups, dtype=f64)
    for c in range(cg):
        g1, g2 = g1 + u1[:, c::cg], g2 + u2[:, c::cg]
    m = g1 / (HW * cg)
    var = torch.clamp(g2 / (HW * cg) - m * m, min=0.0)
    mu = m.float().repeat_interleave(cg, -1)
    rstd = (1.0 / torch.sqrt(var + eps)).float().repeat_interleave(cg, -1)
    z = (xf - (mu - tbf)[:, None]) * (s * rstd)[:, None] + b
    return (z * torch.sigmoid(z)).reshape(x.shape), mu, rstd


@pytest.mark.parametrize("shape,groups,cluster,itemsize", [
    ((2, 16, 16, 64), 32, 1, 4), ((2, 16, 16, 64), 32, 4, 4), ((2, 16, 16, 64), 32, 16, 4),
    ((2, 6, 6, 96), 32, 2, 4), ((1, 3, 7, 30), 30, 4, 4), ((2, 8, 8, 384), 32, 8, 4),
    ((1, 4, 4, 2048), 16, 2, 4), ((1, 64, 64, 384), 32, 2, 4),
    ((2, 16, 16, 64), 32, 4, 2), ((2, 8, 8, 384), 32, 8, 2), ((1, 64, 64, 128), 32, 2, 2),
])
@pytest.mark.parametrize("mean", [0.3, 1000.0])
def test_kernel_statistics_order_matches_the_forward(shape, groups, cluster, itemsize, mean):
    """The kernel's one-pass shifted statistics, in its order of sums and
    precisions: within the JAX suite's 2e-5 of the JAX ``gn_silu_reference``
    and, for mean and rstd, of float64 (rstd at chip_smoke.py's bar, the
    mean at 2e-6) at mean 0.3; within 1e-3 of float64 at mean 1000, std 2, where E[u^2] - mu^2
    would lose the variance.  ``itemsize`` 2: bf16 values in the bf16
    kernel's layout (8-channel columns, larger tiles)."""
    x, s, b, g, tb = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                      for a in _inputs(shape, groups, seed=sum(shape) + cluster, mean=mean))
    if itemsize == 2:
        x = x.bfloat16().float()
    HW = shape[1] * shape[2]
    plan = (cluster, -(-HW // cluster), True)
    y, mu, rstd = _kernel_order_fwd(x, s, b, g, 1e-6, tb, plan, itemsize)
    if mean < 1:
        ref = jfn.gn_silu_reference(jnp.asarray(x.numpy()), jnp.asarray(s.numpy()),
                                    jnp.asarray(b.numpy()), g,
                                    time_bias=jnp.asarray(tb.numpy()))
        np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=2e-5)
        # against float64 (the fp32 plain version's own sums drift by more at
        # 4,096 pixels): rstd at chip_smoke.py's bar, the mean at a fifth of
        # it, as the card's run holds thousands of groups to that bar
        _, mu64, rstd64 = tfn.gn_silu_reference(x.double(), s.double(), b.double(), g,
                                                1e-6, tb.double())
        torch.testing.assert_close(mu.double(), mu64, atol=2e-6, rtol=2e-6)
        torch.testing.assert_close(rstd.double(), rstd64, atol=1e-5, rtol=1e-4)
    else:
        y64, mu64, rstd64 = tfn.gn_silu_reference(x.double(), s.double(), b.double(), g,
                                                  1e-6, tb.double())
        torch.testing.assert_close(y.double(), y64, atol=1e-3, rtol=1e-3)
        torch.testing.assert_close(rstd.double(), rstd64, atol=0.0, rtol=1e-3)
