"""The port's GN+SiLU(+time bias) backward: its plain version (the CPU
route of ``gn_silu_bwd``, reached through the autograd Function) against
the JAX custom VJPs ``gn_silu_bias`` / ``gn_silu`` (Pallas backward kernels
in interpret mode, as tests/test_fused_norm.py runs them) and against
``jax.vjp`` of ``gn_silu_reference``: fp32 at 2e-4, the JAX suite's bar;
bf16 at 2e-2.  Also float64 autograd of the plain forward (1e-10), the
``want_dtb`` split, the saved-nothing inference route and the wrapper's
checks.  The CUDA kernel is held against the plain version on a card in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ddpm_diffusion_model_tpu.ops import fused_norm as jfn
from ddpm_diffusion_model_tpu_torch.ops import fused_norm as tfn

torch.set_num_threads(1)


def _inputs(shape, groups, seed, with_tb=True):
    rng = np.random.default_rng(seed)
    B, H, W, C = shape
    x = (rng.normal(size=shape) * 2.0 + 0.3).astype(np.float32)
    s = (1.0 + 0.1 * rng.normal(size=C)).astype(np.float32)
    b = (0.1 * rng.normal(size=C)).astype(np.float32)
    tb = (0.5 * rng.normal(size=(B, C))).astype(np.float32) if with_tb else None
    dy = rng.normal(size=shape).astype(np.float32)
    return x, s, b, groups, tb, dy


def _port_grads(x, s, b, g, tb, dy, dtype=torch.float32):
    """Grads of <gn_silu(x, s, b, tb), dy> through the port's autograd
    Function (CPU tensors: the plain forward and backward)."""
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    st = torch.from_numpy(s).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    tbt = None if tb is None else torch.from_numpy(tb).requires_grad_()
    y = tfn.gn_silu(xt, st, bt, g, 1e-6, tbt)
    assert y.dtype == dtype
    y.backward(torch.from_numpy(dy).to(dtype))
    out = [xt.grad, st.grad, bt.grad] + ([] if tbt is None else [tbt.grad])
    return [t.float().numpy() for t in out], xt.grad.dtype


def _jax_vjp(fn, x, s, b, tb, dy):
    args = (x, s, b) if tb is None else (x, s, b, tb)
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return [np.asarray(t, np.float32) for t in vjp(jnp.asarray(dy))]


@pytest.mark.parametrize("shape,groups", [
    ((2, 8, 8, 64), 32),
    ((1, 8, 8, 128), 32),
    ((2, 4, 4, 256), 32),
])
@pytest.mark.parametrize("with_tb", [False, True])
def test_matches_jax_custom_vjp_and_reference_vjp(shape, groups, with_tb):
    x, s, b, g, tb, dy = _inputs(shape, groups, seed=sum(shape) + with_tb,
                                 with_tb=with_tb)
    got, dx_dtype = _port_grads(x, s, b, g, tb, dy)
    assert dx_dtype == torch.float32 and len(got) == 3 + with_tb
    if with_tb:
        kernel = lambda x, s, b, tb: jfn.gn_silu_bias(x, s, b, tb, g)  # noqa: E731
        ref = lambda x, s, b, tb: jfn.gn_silu_reference(x, s, b, g, time_bias=tb)  # noqa: E731
    else:
        kernel = lambda x, s, b: jfn.gn_silu(x, s, b, g)  # noqa: E731
        ref = lambda x, s, b: jfn.gn_silu_reference(x, s, b, g)  # noqa: E731
    # the context wraps the VJP call: the backward kernels run inside it
    with pltpu.force_tpu_interpret_mode():
        want_k = _jax_vjp(kernel, x, s, b, tb, dy)
    want_r = _jax_vjp(ref, x, s, b, tb, dy)
    for a, wk, wr in zip(got, want_k, want_r):
        np.testing.assert_allclose(a, wk, atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(a, wr, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("with_tb", [False, True])
def test_c96_against_reference_vjp(with_tb):
    """C = 96 (the low preset's width): against the reference VJP only."""
    x, s, b, g, tb, dy = _inputs((2, 6, 6, 96), 32, seed=96, with_tb=with_tb)
    got, _ = _port_grads(x, s, b, g, tb, dy)
    if with_tb:
        ref = lambda x, s, b, tb: jfn.gn_silu_reference(x, s, b, g, time_bias=tb)  # noqa: E731
    else:
        ref = lambda x, s, b: jfn.gn_silu_reference(x, s, b, g)  # noqa: E731
    for a, w in zip(got, _jax_vjp(ref, x, s, b, tb, dy)):
        np.testing.assert_allclose(a, w, atol=2e-4, rtol=2e-4)


def test_bf16_grads_close_to_jax_bf16_vjp():
    """bf16 x and dy: dx comes back in bf16, the rest fp32, within the bf16
    bar of the JAX suite (2e-2) of the JAX reference's bf16 VJP."""
    x, s, b, g, tb, dy = _inputs((2, 8, 8, 64), 32, seed=5)
    xb = torch.from_numpy(x).bfloat16()
    dyb = torch.from_numpy(dy).bfloat16()
    got, dx_dtype = _port_grads(xb.float().numpy(), s, b, g, tb,
                                dyb.float().numpy(), dtype=torch.bfloat16)
    assert dx_dtype == torch.bfloat16
    ref = lambda x, s, b, tb: jfn.gn_silu_reference(x, s, b, g, time_bias=tb)  # noqa: E731
    _, vjp = jax.vjp(ref, jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(s),
                     jnp.asarray(b), jnp.asarray(tb))
    want = vjp(jnp.asarray(dyb.float().numpy(), jnp.bfloat16))
    for a, w in zip(got, want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(a, w, atol=2e-2 * max(1.0, np.abs(w).max()), rtol=2e-2)


@pytest.mark.parametrize("shape,groups", [((2, 5, 3, 48), 16), ((1, 4, 4, 64), 32)])
def test_plain_backward_is_autograd_of_plain_forward_float64(shape, groups):
    """The plain backward is the exact derivative of the plain forward:
    float64 autograd of ``gn_silu_reference`` to 1e-10."""
    x, s, b, g, tb, dy = (torch.from_numpy(a).double() if isinstance(a, np.ndarray) else a
                          for a in _inputs(shape, groups, seed=1))
    leaves = [t.clone().requires_grad_() for t in (x, s, b, tb)]
    y, mean, rstd = tfn.gn_silu_reference(leaves[0], leaves[1], leaves[2], g, 1e-6,
                                          leaves[3])
    want = torch.autograd.grad(y, leaves, dy)
    got = tfn.gn_silu_bwd_reference(x, s, b, mean.detach(), rstd.detach(), dy, g, tb)
    assert got[0].dtype == torch.float64
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-10, rtol=1e-10)


def test_want_dtb_split_and_no_time_bias_grad():
    x, s, b, g, tb, dy = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                          for a in _inputs((1, 4, 4, 64), 32, seed=2))
    _, mean, rstd = tfn.gn_silu_fwd(x, s, b, g, time_bias=tb)
    full = tfn.gn_silu_bwd(x, s, b, mean, rstd, dy, g, tb)
    no_dtb = tfn.gn_silu_bwd(x, s, b, mean, rstd, dy, g, tb, want_dtb=False)
    assert full[3].shape == (1, 64) and full[3].dtype == torch.float32
    assert no_dtb[3] is None
    for a, w in zip(no_dtb[:3], full[:3]):
        assert torch.equal(a, w)
    # a time bias that needs no grad gets none, and dx is unchanged
    xt = x.clone().requires_grad_()
    tfn.gn_silu(xt, s, b, g, 1e-6, tb).backward(dy)
    torch.testing.assert_close(xt.grad, full[0])


def test_no_grad_routes_save_nothing():
    x, s, b, g, tb, _ = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                         for a in _inputs((1, 4, 4, 64), 32, seed=4))
    sp = s.clone().requires_grad_()
    with torch.inference_mode():
        y = tfn.gn_silu(x, sp, b, g, 1e-6, tb)
    assert y.grad_fn is None
    y = tfn.gn_silu(x, s, b, g, 1e-6, tb)  # nothing requires grad
    assert y.grad_fn is None
    assert tfn.gn_silu(x, sp, b, g, 1e-6, tb).grad_fn is not None


def test_backward_asks_for_the_layout_and_counts_copies():
    """A non-contiguous dy is copied into NHWC once and counted; the
    wrapper itself refuses non-contiguous dy and malformed statistics."""
    x, s, b, g, tb, dy = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                          for a in _inputs((2, 4, 4, 64), 32, seed=6))
    xt = x.clone().requires_grad_()
    y = tfn.gn_silu(xt, s, b, g, 1e-6, tb)
    before = tfn.bwd_layout_copies
    # dy built in NCHW memory and viewed as NHWC: not contiguous
    dy_strided = dy.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not dy_strided.is_contiguous()
    y.backward(dy_strided)
    assert tfn.bwd_layout_copies == before + 1
    _, mean, rstd = tfn.gn_silu_fwd(x, s, b, g, time_bias=tb)
    torch.testing.assert_close(xt.grad, tfn.gn_silu_bwd(x, s, b, mean, rstd, dy, g, tb)[0])
    with pytest.raises(ValueError, match="contiguous"):
        tfn.gn_silu_bwd(x, s, b, mean, rstd, dy_strided, g, tb)
    with pytest.raises(ValueError, match="mean"):
        tfn.gn_silu_bwd(x, s, b, mean[:, :32], rstd, dy, g, tb)
    with pytest.raises(ValueError, match="dy"):
        tfn.gn_silu_bwd(x, s, b, mean, rstd, dy.bfloat16(), g, tb)


# ------------------------------------------- the CUDA kernel's plan and sums

def _step_gn_shapes():
    """(H, W, C, groups) of the 45 GN+SiLU calls of one celeba64_attn
    forward (its backward has the same), recorded from a batch-1 forward
    on the CPU."""
    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.utils.config import get_preset

    calls = []
    fwd = tfn.gn_silu_fwd

    def rec(x, scale, bias, groups, *args, **kw):
        calls.append((*x.shape[1:], groups))
        return fwd(x, scale, bias, groups, *args, **kw)

    torch.manual_seed(0)
    model = UNetDenoiser(get_preset("celeba64_attn").model, device="cpu").eval()
    tfn.gn_silu_fwd = rec
    try:
        with torch.inference_mode():
            model(torch.zeros(1, 64, 64, 3), torch.tensor([3]))
    finally:
        tfn.gn_silu_fwd = fwd
    return calls


_NARROW = [(2, 8, 8, 64, 32), (1, 8, 8, 128, 32), (2, 4, 4, 256, 32), (2, 6, 6, 96, 32),
           (4, 16, 16, 96, 32), (2, 5, 3, 48, 16), (1, 3, 7, 30, 30), (2, 4, 4, 8192, 16)]


def test_gn_bwd_plan_covers_every_shape():
    """Every GN shape of a celeba64_attn train step at batch 128 (fp32 and
    bf16) and the narrow test shapes get a route, a cluster of at most 16
    whose chunks cover H*W, and a shared-memory layout a block can have;
    a bf16 step's 45 launches split 13 in shared memory, 32 re-read (the
    counts chip_smoke.py holds the card's run to)."""
    from chip_smoke import GN_BWD_REREAD_PER_STEP, GN_BWD_SMEM_PER_STEP

    step = _step_gn_shapes()
    assert len(step) == 45
    cases = [(128, h, w, c, g) for h, w, c, g in step] + _NARROW
    for dtype in (torch.float32, torch.bfloat16):
        item = torch.tensor([], dtype=dtype).element_size()
        in_smem = 0
        for B, H, W, C, G in cases:
            cluster, chunk, smem = tfn._gn_bwd_plan(B, H * W, C, G, dtype)
            assert cluster in (1, 2, 4, 8, 16) and chunk >= 1
            assert chunk * cluster >= H * W and (chunk - 1) * cluster < H * W
            tile, stages, nbytes = tfn._gn_bwd_smem(C, G, chunk, smem, item)
            assert 1 <= tile <= chunk and stages >= (1 if smem else 2) and nbytes <= 232_448
            if smem:
                assert tile * stages >= chunk and nbytes <= 232_448 // 3
            in_smem += smem and B == 128
        if dtype == torch.bfloat16:
            assert (in_smem, 45 - in_smem) == (GN_BWD_SMEM_PER_STEP, GN_BWD_REREAD_PER_STEP)


def _kernel_order_bwd(x, s, b, mean, rstd, dy, groups, tb, plan, want_dtb):
    """A plain model of the CUDA backward's fp32 arithmetic and order of
    summation: per channel, each pixel lane's running sum over its pixels
    of a chunk, the lanes in order, then the cluster's chunks (ranks) in
    order; gamma * S summed per group channel by channel; dtb the same as
    S1.  x (B, H, W, C) fp32, 4 channels per thread where C allows."""
    cluster, chunk, _ = plan
    B, H, W, C = x.shape
    HW, cg = H * W, C // groups
    V = 4 if C % 4 == 0 else 1
    ppi = 256 // min(C // V, 256)
    xf, dyf = x.reshape(B, HW, C), dy.reshape(B, HW, C)
    d = (tb if tb is not None else torch.zeros(B, C)) - mean
    sh, za = d * rstd, s * rstd
    zc = d * za + b
    xh = xf * rstd[:, None] + sh[:, None]
    z = xf * za[:, None] + zc[:, None]
    sg = torch.sigmoid(z)
    dz = dyf * (sg + z * (sg - sg * sg))

    def ordered_sum(v):  # (B, HW, C) -> (B, C): lanes within chunks, then ranks
        total = torch.zeros(B, C)
        for r in range(cluster):
            part = torch.zeros(B, C)
            rows = v[:, r * chunk:min((r + 1) * chunk, HW)]
            for lane in range(ppi):
                acc = torch.zeros(B, C)
                for p in range(lane, rows.shape[1], ppi):
                    acc = acc + rows[:, p]
                part = part + acc
            total = total + part
        return total

    s1, s2 = ordered_sum(dz), ordered_sum(dz * xh)
    m1 = torch.zeros(B, groups)
    m2 = torch.zeros(B, groups)
    for c in range(cg):
        m1 = m1 + (s * s1)[:, c::cg]
        m2 = m2 + (s * s2)[:, c::cg]
    inv_n = 1.0 / (HW * cg)
    m1r = (m1 * inv_n).repeat_interleave(cg, -1) * rstd
    m2r = (m2 * inv_n).repeat_interleave(cg, -1) * rstd
    du = dz * za[:, None] - xh * m2r[:, None] - m1r[:, None]
    dtb = ordered_sum(du) if want_dtb else None
    return du.reshape(x.shape), s2.sum(0), s1.sum(0), dtb


@pytest.mark.parametrize("shape,groups,mean", [
    ((2, 16, 16, 64), 32, 0.3), ((2, 6, 6, 96), 32, 0.3), ((1, 3, 7, 30), 30, 0.3),
    ((2, 16, 16, 64), 32, 1000.0),
])
def test_kernel_summation_order_matches_the_backward(shape, groups, mean):
    """Per-chunk per-channel partials summed across ranks in a fixed order,
    then per group: in fp32 within chip_smoke.py's fp32 bar (1e-4 of the
    largest |value|) of the plain backward and, at mean 1000, of the
    float64 backward from the same statistics."""
    from chip_smoke import BWD_TOL

    x, s, b, g, tb, dy = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                          for a in _inputs(shape, groups, seed=7))
    x = x - 0.3 + mean
    _, mu, rs = tfn.gn_silu_reference(x, s, b, g, 1e-6, tb)
    plan = tfn._gn_bwd_plan(shape[0], shape[1] * shape[2], shape[3], g, torch.float32)
    got = _kernel_order_bwd(x, s, b, mu, rs, dy, g, tb, plan, True)
    wants = [tfn.gn_silu_bwd_reference(x, s, b, mu, rs, dy, g, tb)]
    if mean > 1:
        wants.append(tfn.gn_silu_bwd_reference(x.double(), s.double(), b.double(), mu, rs,
                                               dy.double(), g, tb.double()))
    for want in wants:
        for a, w in zip(got, want):
            err = float((a.double() - w.double()).abs().max())
            assert err <= BWD_TOL["float32"] * max(float(w.abs().max()), 1.0)
