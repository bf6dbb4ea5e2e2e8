"""The port's flash-attention backward: its plain versions (the CPU route
of ``flash_attn_bwd_dq`` / ``flash_attn_bwd_dkv``, reached through the
autograd Function) against the JAX ``flash_attention`` VJP (the Pallas
``_dq_kernel`` / ``_dkv_kernel`` under ``force_tpu_interpret_mode``) and
against ``attention_xla``'s VJP: outputs at 1e-4, grads at 1e-3 relative
(1e-4 absolute), as tests/test_flash_attention.py.  Also float64 autograd
of the plain forward at a ragged N = 100 (1e-10: the LSE is in natural
log and P = exp(s * scale - LSE)), the saved-nothing inference route and
the wrapper's checks.  The CUDA kernels are held against the plain
versions on a card in tests/test_torch_cuda.py; here a plain-torch model of
the bf16 tensor-core kernels' roundings is held against the plain versions
at chip_smoke.py's bf16 bars (dQ, dK, dV and the forward), so the bar is
known to hold before the card sees the kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ddpm_diffusion_model_tpu.ops.attention import attention_xla
from ddpm_diffusion_model_tpu.ops.flash_attention import flash_attention as jax_flash
from ddpm_diffusion_model_tpu_torch.ops import flash_attention as tfa
from chip_smoke import BWD_TOL
from ddpm_diffusion_model_tpu_torch.ops.attention import multi_head_attention

torch.set_num_threads(1)


def _qkv_do(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(4))


def _port(q, k, v, do):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = multi_head_attention(*leaves)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax_vjp(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("shape", [
    (2, 2, 64, 32),    # 8x8 map, low preset
    (1, 2, 256, 64),   # 16x16 map, attn preset
])
def test_matches_pallas_vjp_and_xla_vjp(shape):
    q, k, v, do = _qkv_do(shape, seed=shape[2])
    out, grads = _port(q, k, v, do)
    with pltpu.force_tpu_interpret_mode():
        out_k, grads_k = _jax_vjp(jax_flash, q, k, v, do)
    out_x, grads_x = _jax_vjp(attention_xla, q, k, v, do)
    for want in (out_k, out_x):
        np.testing.assert_allclose(out, want, atol=1e-4, rtol=1e-4)
    for want in (grads_k, grads_x):
        for a, w in zip(grads, want):
            np.testing.assert_allclose(a, w, atol=1e-4, rtol=1e-3)


def test_ragged_n100_matches_xla_vjp():
    """N = 100 (a 10x10 map): not a multiple of the 64-row tile."""
    q, k, v, do = _qkv_do((1, 3, 100, 16), seed=100)
    out, grads = _port(q, k, v, do)
    out_x, grads_x = _jax_vjp(attention_xla, q, k, v, do)
    np.testing.assert_allclose(out, out_x, atol=1e-4, rtol=1e-4)
    for a, w in zip(grads, grads_x):
        np.testing.assert_allclose(a, w, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("n", [100, 64, 1])
def test_plain_backward_is_autograd_of_plain_forward_float64(n):
    """dQ, dK, dV from the saved natural-log LSE and delta = rowsum(dO * O)
    equal float64 autograd of the plain forward (1e-10)."""
    rng = np.random.default_rng(n)
    q, k, v = (torch.from_numpy(rng.normal(size=(3, n, 16)) * 1.5).requires_grad_()
               for _ in range(3))
    o, lse = tfa.flash_attn_reference(q, k, v)
    do = torch.from_numpy(rng.normal(size=(3, n, 16)))
    want = torch.autograd.grad(o, (q, k, v), do)
    qd, kd, vd, od, ld = (t.detach() for t in (q, k, v, o, lse))
    delta = (do * od).sum(-1)
    got = (tfa.flash_attn_bwd_dq_reference(qd, kd, vd, do, ld, delta),
           *tfa.flash_attn_bwd_dkv_reference(qd, kd, vd, do, ld, delta))
    for a, w in zip(got, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, w, atol=1e-10, rtol=1e-10)


def test_bf16_grads_come_back_in_bf16_close_to_fp32():
    q, k, v, do = _qkv_do((1, 2, 64, 32), seed=3)
    leaves = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    multi_head_attention(*leaves).backward(torch.from_numpy(do).bfloat16())
    _, want = _port(*(torch.from_numpy(a).bfloat16().float().numpy() for a in (q, k, v, do)))
    for t, w in zip(leaves, want):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(), w,
                                   atol=3e-2 * np.abs(w).max(), rtol=3e-2)


def test_no_grad_routes_save_nothing_and_copies_are_counted():
    q, k, v, do = (torch.from_numpy(a) for a in _qkv_do((1, 2, 64, 16), seed=4))
    qg = q.clone().requires_grad_()
    with torch.inference_mode():
        assert tfa.flash_attention(qg, k, v).grad_fn is None
    assert tfa.flash_attention(q, k, v).grad_fn is None
    out = tfa.flash_attention(qg, k, v)
    before = tfa.bwd_layout_copies
    do_strided = do.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not do_strided.is_contiguous()
    out.backward(do_strided)
    assert tfa.bwd_layout_copies == before + 1
    o, lse = tfa.flash_attn_fwd(*(t.reshape(2, 64, 16) for t in (q, k, v)))
    dq, _, _ = tfa.flash_attn_bwd(*(t.reshape(2, 64, 16) for t in (q, k, v)), o, lse,
                                  do.reshape(2, 64, 16))
    torch.testing.assert_close(qg.grad, dq.reshape(1, 2, 64, 16))


@pytest.mark.parametrize("dtype,N,d,aligned,want", [
    (torch.bfloat16, 4096, 64, True, "wgmma"),  # the DiT at 256 px
    (torch.bfloat16, tfa.WGMMA_MIN_N, 64, True, "wgmma"),
    (torch.bfloat16, tfa.WGMMA_MIN_N - 1, 64, True, "tc"),
    (torch.bfloat16, 256, 64, True, "tc"),  # the U-Nets and the 64-px DiT
    (torch.bfloat16, 64, 64, True, "tc"),
    (torch.bfloat16, 4096, 64, False, "tc"),  # an operand not 16-byte aligned
    (torch.bfloat16, 4096, 128, True, "tc"),  # head dims the wgmma kernels do not take
    (torch.bfloat16, 4096, 32, True, "tc"),
    (torch.bfloat16, 4096, 72, True, "tc"),
    (torch.bfloat16, 256, 72, True, "tc"),  # DiT-MoE-XL/2's attention
    (torch.float32, 4096, 64, True, "fma"),
    (torch.float32, 64, 64, True, "fma"),
])
def test_dkv_route_by_shape(dtype, N, d, aligned, want):
    """The dQ and the dK/dV kernel a CUDA call takes, from what its inputs
    show: the two wrappers share one route (their wgmma kernels cross over
    at the same lengths)."""
    assert tfa._dkv_route(dtype, N, d, aligned) == want


def test_dq_wgmma_launches_is_exported_and_cpu_calls_leave_it():
    """``bwd_dq_wgmma_launches`` is public and counts kernel launches only:
    a bf16 call on CPU tensors at a length the wgmma route takes runs the
    plain version."""
    assert "bwd_dq_wgmma_launches" in tfa.__all__
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _qkv_do((1, 1, tfa.WGMMA_MIN_N, 64), seed=24))
    q, k, v, do = (t.reshape(1, tfa.WGMMA_MIN_N, 64) for t in (q, k, v, do))
    o, lse = tfa.flash_attn_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    before = (tfa.bwd_dq_wgmma_launches, tfa.bwd_dq_launches)
    dq = tfa.flash_attn_bwd_dq(q, k, v, do, lse, delta)
    assert (tfa.bwd_dq_wgmma_launches, tfa.bwd_dq_launches) == before
    torch.testing.assert_close(dq, tfa.flash_attn_bwd_dq_reference(q, k, v, do, lse, delta))


def test_wrappers_refuse_malformed_inputs():
    q, k, v, do = (torch.from_numpy(a[0]) for a in _qkv_do((1, 2, 64, 16), seed=5))
    o, lse = tfa.flash_attn_fwd(q, k, v)
    delta = (do * o).sum(-1)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attn_bwd_dq(q, k, v, do, lse.double(), delta)
    with pytest.raises(ValueError, match="delta"):
        tfa.flash_attn_bwd_dkv(q, k, v, do, lse, delta[:, :10])
    with pytest.raises(ValueError, match="dO must be contiguous"):
        tfa.flash_attn_bwd_dq(q, k, v, do.transpose(0, 1).contiguous().transpose(0, 1),
                              lse, delta)
    with pytest.raises(ValueError, match="dO"):
        tfa.flash_attn_bwd_dkv(q, k, v, do.bfloat16(), lse, delta)


# ---------------------------------------------------- bf16 tensor-core model

LOG2E = 1.4426950408889634


def _tc_forward_model(q, k, v, tile=64):
    """The bf16 tensor-core forward's roundings: fp32 scores and online
    softmax in log2 units over 64-key tiles, each tile's P rounded to bf16
    before P V (fp32 sums), O = acc / l with l the fp32 sum of the unrounded
    P, O rounded to bf16; LSE = (m + log2 l) ln 2."""
    qs = LOG2E / q.shape[-1] ** 0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * qs
    m = torch.full(s.shape[:-1], -torch.inf)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(q.shape)
    for j in range(0, s.shape[-1], tile):
        sj = s[..., j:j + tile]
        m_new = torch.maximum(m, sj.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sj - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(p.bfloat16().float(),
                                                    v[..., j:j + tile, :].float())
        m = m_new
    return (acc / l[..., None]).bfloat16(), (m + torch.log2(l)) / LOG2E


def _tc_dkv_model(q, k, v, do, lse, delta):
    """The bf16 tensor-core dK/dV's roundings: fp32 P^T and dP^T, P^T
    rounded to bf16 before dV = P^T dO and dS^T before dK = dS^T Q (fp32
    sums), dK and dV rounded to bf16."""
    scale = 1.0 / q.shape[-1] ** 0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    dv = torch.matmul(p.bfloat16().float().transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    dk = torch.matmul(ds.bfloat16().float().transpose(-1, -2), qf) * scale
    return dk.bfloat16(), dv.bfloat16()


def _tc_dq_model(q, k, v, do, lse, delta):
    """The bf16 tensor-core dQ's roundings: fp32 S and dP, dS rounded to
    bf16 before dQ = dS K (fp32 sums), dQ rounded to bf16."""
    scale = 1.0 / q.shape[-1] ** 0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    return (torch.matmul(ds.bfloat16().float(), kf) * scale).bfloat16()


def _scaled_err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1.0)


@pytest.mark.parametrize("shape", [(8, 256, 64), (8, 64, 64)])
def test_tensor_core_roundings_meet_the_bf16_bars(shape):
    """P (forward and dV) and dS (dQ and dK) rounded to bf16 keep O, dQ, dK
    and dV within BWD_TOL["bfloat16"] x max(max |value|, 1) of the plain
    versions, and the LSE within phase 3's 1e-4 abs + 1e-5 rel."""
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _qkv_do(shape, seed=shape[1] + 1))
    tol = BWD_TOL["bfloat16"]
    o0, lse0 = tfa.flash_attn_reference(q, k, v)
    o, lse = _tc_forward_model(q, k, v)
    assert 0 < _scaled_err(o, o0) <= tol
    torch.testing.assert_close(lse, lse0, atol=1e-4, rtol=1e-5)
    delta = (do.float() * o0.float()).sum(-1)
    want = (tfa.flash_attn_bwd_dq_reference(q, k, v, do, lse0, delta),
            *tfa.flash_attn_bwd_dkv_reference(q, k, v, do, lse0, delta))
    got = (_tc_dq_model(q, k, v, do, lse0, delta), *_tc_dkv_model(q, k, v, do, lse0, delta))
    for got, w in zip(got, want):
        assert got.dtype == torch.bfloat16
        assert 0 < _scaled_err(got, w) <= tol
