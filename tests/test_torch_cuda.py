"""Tests of the port that need an NVIDIA GPU: each CUDA kernel (forward
and backward) against its plain PyTorch version on the card, the wrappers'
refusals, a small U-Net forward and train step on the kernels against the
plain versions with the launches per step, the decoder-only forward and
a 4-step DPM-Solver++ run on the kernels against the plain versions, a
the GN kernels at the KL-VAE's shapes and a VAE train step on the kernels
against the plain versions, a
guided (CFG) forward and a class-conditional train step on the kernels
against the plain versions, a guided progressive and a consistency
distillation update on the kernels against the plain versions, a
super-resolution train step and the
upsampler's DDIM on the kernels against the plain versions, the wgmma
dQ and dK/dV kernels for long sequences against the plain versions and
bit for bit against mma.sync, the flash
kernels at the DiT-S/4 256-px attention (48 x 4096 x 64), a small DiT's
forward and an MoE DiT's train step on the kernels against the plain
versions, the flash kernels at DiT-MoE-XL/2's attention (2048 x 256 x 72)
and its dropless expert layer (no host sync; the grouped products against
a loop over the experts), the service on the card,
``remat`` on the kernels, a checkpoint round trip of CUDA state, the
device cache and ``device_prefetch`` on the card, the mounted FID
extractor there, and ring attention's hop code on the kernels and its
world-1 NCCL ring, the virtual tensor, expert and pipeline
parallel forms on the kernels, ``profiler_trace`` and
``nan_debugging`` over the kernels, and the fused update (clip and AdamW
in one kernel, the EMA in another) against the multi-tensor sequence, on
the whole state and on an FSDP rank's shards.  Every test here carries the ``cuda`` marker and skips without a card.  The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import contextlib
from collections import Counter

import numpy as np
import pytest
import torch

from ddpm_diffusion_model_tpu_torch.models import UNetConfig, UNetDenoiser
from ddpm_diffusion_model_tpu_torch.ops import flash_attention as tfa
from ddpm_diffusion_model_tpu_torch.ops import fused_norm as tfn
from ddpm_diffusion_model_tpu_torch.ops import fused_update as tfu
from ddpm_diffusion_model_tpu_torch.utils.observe import launch_counts, op_total

pytestmark = pytest.mark.cuda


def _since(before, *names):
    """Launches since ``before`` (a snapshot of the launch table) of each of
    ``names``: an op's on all its routes, a count without a route
    (``gn_silu_bwd_dtb``) as it is."""
    grown = launch_counts - before
    return tuple(op_total(n, grown) or grown[n] for n in names)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = True


def _gn_args(shape, groups, with_tb, dtype, dev, seed=11, mean=0.0):
    rng = np.random.default_rng(seed)
    B, H, W, C = shape
    x = torch.from_numpy((rng.normal(size=shape) * 2 + mean).astype(np.float32))
    s = torch.from_numpy((1 + 0.1 * rng.normal(size=C)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=C)).astype(np.float32))
    tb = torch.from_numpy(rng.normal(size=(B, C)).astype(np.float32))
    return (x.to(dev, dtype), s.to(dev), b.to(dev), groups, 1e-6,
            tb.to(dev) if with_tb else None)


# fp32: the two differ only in summation order; bf16: by one output rounding
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("with_tb", [False, True], ids=["plain", "tb"])
@pytest.mark.parametrize("shape,groups", [
    ((16, 64, 64, 128), 32), ((16, 64, 64, 384), 32), ((16, 8, 8, 512), 32),
    ((4, 16, 16, 96), 32), ((4, 8, 8, 192), 32), ((2, 5, 5, 48), 16),
    ((1, 3, 7, 30), 30),
    # celebahq256's largest image and widest channels
    ((2, 256, 256, 256), 32), ((2, 16, 16, 1024), 32),
])
def test_gn_silu_kernel_matches_plain(card, shape, groups, with_tb, dtype):
    args = _gn_args(shape, groups, with_tb, dtype, card)
    _gn_fwd_matches_plain(args)


def _gn_fwd_matches_plain(args, plan=None, want=None, tol=None):
    """The forward kernel (on ``plan``, else the wrapper's) against the
    plain version (or ``want``): one launch on the plan's route, within the
    bars, and bit-equal on a second identical call."""
    x = args[0]
    B, H, W, C = x.shape
    route = plan or tfn._gn_fwd_plan(B, H * W, C, args[3], x.dtype)

    def run():
        if plan is None:
            return tfn.gn_silu_fwd(*args)
        return tfn._gn_fwd_launch(*args, plan)

    before = Counter(launch_counts)
    y, mu, rstd = run()
    torch.cuda.synchronize()
    assert launch_counts - before == {"gn_silu_fwd." + ("smem" if route[2] else "reread"): 1}
    y0, mu0, rstd0 = want or tfn.gn_silu_reference(*args)
    atol, rtol = tol or TOL[x.dtype]
    assert y.dtype == x.dtype and y.shape == x.shape
    torch.testing.assert_close(y.double(), y0.double(), atol=atol, rtol=rtol)
    torch.testing.assert_close(mu.double(), mu0.double(), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd.double(), rstd0.double(), atol=1e-5, rtol=1e-4)
    # no atomics: the same call gives the same bits
    assert all(torch.equal(a, c) for a, c in zip(run(), (y, mu, rstd)))


def _float64_reference(args):
    x, s, b, g, eps, tb = args
    return tfn.gn_silu_reference(x.double(), s.double(), b.double(), g, eps,
                                 None if tb is None else tb.double())


def test_gn_silu_kernel_large_mean_against_float64(card):
    args = _gn_args((4, 16, 16, 256), 32, True, torch.float32, card, mean=1000.0)
    _gn_fwd_matches_plain(args, want=_float64_reference(args), tol=(1e-3, 1e-3))


# mean 1000 at 64x64x384 against float64 on both routes: bf16 resident and
# re-read at a cluster of 16 (fp32's chunk does not fit a block there), fp32
# re-read
@pytest.mark.parametrize("dtype,resident", [(torch.bfloat16, True), (torch.bfloat16, False),
                                            (torch.float32, False)],
                         ids=["bf16-resident", "bf16-reread", "fp32-reread"])
def test_gn_silu_fwd_large_mean_on_both_routes(card, dtype, resident):
    args = _gn_args((2, 64, 64, 384), 32, True, dtype, card, mean=1000.0)
    tol = (1e-3, 1e-3) if dtype == torch.float32 else TOL[dtype]
    _gn_fwd_matches_plain(args, (16, 256, resident), _float64_reference(args), tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("resident", [True, False], ids=["resident", "reread"])
def test_gn_silu_fwd_every_plan_matches_plain(card, cluster, resident, dtype):
    """Every cluster size on both routes (the chunk of (4, 16, 16, 128)
    fits a block resident at every cluster size)."""
    args = _gn_args((4, 16, 16, 128), 32, True, dtype, card)
    _gn_fwd_matches_plain(args, (cluster, -(-256 // cluster), resident))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,groups", [((16, 16, 16, 64), 32), ((2, 8, 8, 384), 32)])
def test_gn_silu_fwd_unaligned_operands(card, shape, groups, dtype):
    """A contiguous x not 16-byte aligned takes the element copies."""
    x, *rest = _gn_args(shape, groups, True, dtype, card)
    x = _unaligned(x)
    assert x.data_ptr() % 16
    _gn_fwd_matches_plain((x, *rest))


# the main path's shapes (train step at batch 128 and serving forward at
# batch 16 of celeba64_attn: 4 heads of 64), ragged N at d = 64, 40 (not a
# multiple of 16), 32, 128 and 80, d not a multiple of 8 (2-byte copies);
# the bf16 forward takes 128-row blocks at (512, 256, 64) and the 300s
FLASH_SHAPES = [(512, 256, 64), (512, 64, 64), (64, 256, 64), (64, 64, 64), (8, 100, 64),
                (8, 100, 40), (4, 64, 32), (2, 130, 128), (3, 1, 16), (2, 65, 80),
                (3, 37, 20), (300, 100, 64), (300, 200, 40), (300, 130, 32)]


def _variant_delta(before, dtype, fwd, dq, dkv, bwd_route="tc"):
    """The launches of the forward, dQ and dK/dV since ``before`` (a
    snapshot of the launch table), and as they must be: bf16 on the tensor
    cores (the backward on ``bwd_route``), fp32 on FMA."""
    tc = dtype == torch.bfloat16
    want = Counter({"flash_attn_fwd." + ("tc" if tc else "fma"): fwd,
                    "flash_attn_bwd_dq." + (bwd_route if tc else "fma"): dq,
                    "flash_attn_bwd_dkv." + (bwd_route if tc else "fma"): dkv})
    return launch_counts - before, +want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernel_matches_plain(card, shape, dtype):
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(card, dtype)
               for _ in range(3))
    before = Counter(launch_counts)
    o, lse = tfa.flash_attn_fwd(q, k, v)
    torch.cuda.synchronize()
    got, want = _variant_delta(before, dtype, 1, 0, 0)
    assert got == want
    o0, lse0 = tfa.flash_attn_reference(q, k, v)
    atol, rtol = TOL[dtype]
    assert o.dtype == dtype and lse.shape == shape[:2]
    torch.testing.assert_close(o.float(), o0.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, lse0, atol=1e-4, rtol=1e-5)


def _scaled_err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1.0)


# backward outputs as a share of the output's largest |value| (at least 1)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _unaligned(t):
    """A contiguous copy of ``t`` whose data pointer is not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


# the train step's shapes at smaller batches (both routes of the plan,
# clusters of 4 to 16), C = 96 with G = 32, odd C (scalar accesses), C =
# 8192 (four channel passes), a large mean (against float64 from the same
# statistics) and operands that are not 16-byte aligned (scalar accesses)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("with_tb", [False, True], ids=["plain", "tb"])
@pytest.mark.parametrize("shape,groups,case", [
    ((16, 64, 64, 128), 32, ""), ((16, 32, 32, 384), 32, ""), ((16, 8, 8, 512), 32, ""),
    ((4, 16, 16, 96), 32, ""), ((2, 5, 5, 48), 16, ""), ((1, 3, 7, 30), 30, ""),
    ((2, 4, 4, 8192), 16, ""), ((8, 64, 64, 384), 32, ""), ((8, 16, 16, 256), 32, ""),
    ((4, 32, 32, 256), 32, "mean1000"), ((4, 16, 16, 64), 32, "unaligned"),
    ((2, 256, 256, 256), 32, ""), ((2, 16, 16, 1024), 32, ""),  # celebahq256
])
def test_gn_silu_bwd_kernel_matches_plain(card, shape, groups, case, with_tb, dtype):
    x, s, b, g, eps, tb = _gn_args(shape, groups, with_tb, dtype, card,
                                   mean=1000.0 if case == "mean1000" else 0.0)
    _, mean, rstd = tfn.gn_silu_reference(x, s, b, g, eps, tb)
    dy = torch.randn(shape, generator=torch.Generator(card).manual_seed(3),
                     device=card).to(dtype)
    if case == "unaligned":
        x, dy = _unaligned(x), _unaligned(dy)
        assert x.data_ptr() % 16 and dy.data_ptr() % 16
    plan = tfn._gn_bwd_plan(shape[0], shape[1] * shape[2], shape[3], groups, dtype)

    before = Counter(launch_counts)
    got = tfn.gn_silu_bwd(x, s, b, mean, rstd, dy, g, tb)
    torch.cuda.synchronize()
    assert launch_counts - before == +Counter({
        "gn_silu_bwd." + ("smem" if plan[2] else "reread"): 1, "gn_silu_bwd_dtb": int(with_tb)})
    if case == "mean1000":
        want = tfn.gn_silu_bwd_reference(x.double(), s.double(), b.double(), mean, rstd,
                                         dy.double(), g, None if tb is None else tb.double())
    else:
        want = tfn.gn_silu_bwd_reference(x, s, b, mean, rstd, dy, g, tb)
    assert got[0].dtype == dtype and (got[3] is None) == (not with_tb)
    for i, (a, w) in enumerate(zip(got, want)):
        if w is not None:
            assert a.dtype == (dtype if i == 0 else torch.float32)
            assert _scaled_err(a, w) <= BWD_TOL[dtype if i == 0 else torch.float32], i
    # no atomics: the same call gives the same bits
    again = tfn.gn_silu_bwd(x, s, b, mean, rstd, dy, g, tb)
    assert all(a is None and c is None or torch.equal(a, c) for a, c in zip(again, got))
    if with_tb:  # without dtb: the same dx, dgamma, dbeta
        no = tfn.gn_silu_bwd(x, s, b, mean, rstd, dy, g, tb, want_dtb=False)
        assert no[3] is None and all(torch.equal(a, c) for a, c in zip(no[:3], got[:3]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_bwd_kernels_match_plain(card, shape, dtype):
    rng = np.random.default_rng(6)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(card, dtype)
                   for _ in range(4))
    o, lse = tfa.flash_attn_reference(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    before = Counter(launch_counts)
    dq = tfa.flash_attn_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = tfa.flash_attn_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    got, want = _variant_delta(before, dtype, 0, 1, 1)
    assert got == want
    want = (tfa.flash_attn_bwd_dq_reference(q, k, v, do, lse, delta),
            *tfa.flash_attn_bwd_dkv_reference(q, k, v, do, lse, delta))
    for a, w in zip((dq, dk, dv), want):
        assert a.dtype == dtype and a.shape == shape
        assert _scaled_err(a, w) <= BWD_TOL[dtype]


# the wgmma dK/dV route: the DiT's attention at 256 px (8 x 6 heads), a
# ragged N past the threshold and the smallest N the route takes
WGMMA_SHAPES = [(48, 4096, 64), (6, 4100, 64), (4, tfa.WGMMA_MIN_N, 64)]


@pytest.mark.parametrize("shape", WGMMA_SHAPES)
def test_flash_dkv_wgmma_route_matches_plain_and_mma_sync(card, shape, monkeypatch):
    """Long bf16 sequences take the wgmma dK/dV kernel (counted under
    ``flash_attn_bwd_dkv.wgmma``): within BWD_TOL of the
    plain version and of the mma.sync kernel on the same inputs, and the
    same bits on a second call (no atomics)."""
    gen = torch.Generator(card).manual_seed(9)
    q, k, v, do = (torch.randn(shape, generator=gen, device=card).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = tfa.flash_attn_reference(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    before = Counter(launch_counts)
    dk, dv = tfa.flash_attn_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert launch_counts - before == {"flash_attn_bwd_dkv.wgmma": 1}
    for a, w in zip((dk, dv), tfa.flash_attn_bwd_dkv_reference(q, k, v, do, lse, delta)):
        assert a.dtype == torch.bfloat16 and a.shape == shape
        assert _scaled_err(a, w) <= BWD_TOL[torch.bfloat16]
    again = tfa.flash_attn_bwd_dkv(q, k, v, do, lse, delta)
    assert torch.equal(again[0], dk) and torch.equal(again[1], dv)
    monkeypatch.setattr(tfa, "_route", lambda *args: "tc")
    mma_sync = tfa.flash_attn_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert launch_counts - before == {"flash_attn_bwd_dkv.wgmma": 2,
                                      "flash_attn_bwd_dkv.tc": 1}
    for a, w in zip((dk, dv), mma_sync):
        assert _scaled_err(a, w) <= BWD_TOL[torch.bfloat16]


@pytest.mark.parametrize("shape,case", [((512, 256, 64), ""), ((2, 512, 64), "unaligned")])
def test_flash_dkv_wgmma_route_leaves_short_and_unaligned_calls(card, shape, case):
    """The U-Net's N = 256 and an unaligned long call stay on mma.sync."""
    gen = torch.Generator(card).manual_seed(10)
    q, k, v, do = (torch.randn(shape, generator=gen, device=card).to(torch.bfloat16)
                   for _ in range(4))
    if case == "unaligned":
        q, k, v, do = (_unaligned(t) for t in (q, k, v, do))
    o, lse = tfa.flash_attn_reference(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    before = Counter(launch_counts)
    dk, dv = tfa.flash_attn_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert launch_counts - before == {"flash_attn_bwd_dkv.tc": 1}
    for a, w in zip((dk, dv), tfa.flash_attn_bwd_dkv_reference(q, k, v, do, lse, delta)):
        assert _scaled_err(a, w) <= BWD_TOL[torch.bfloat16]


# the wgmma dQ route: the DiT's attention at 256 px (8 x 6 heads), the
# threshold's length at a large batch and two ragged N past it
DQ_WGMMA_SHAPES = [(48, 4096, 64), (384, tfa.WGMMA_MIN_N, 64), (6, 4100, 64), (8, 600, 64)]


@pytest.mark.parametrize("shape", DQ_WGMMA_SHAPES)
def test_flash_dq_wgmma_route_matches_plain_and_mma_sync(card, shape, monkeypatch):
    """Long bf16 sequences take the wgmma dQ kernel (counted under
    ``flash_attn_bwd_dq.wgmma``): within BWD_TOL of the
    plain version, bit-equal to the mma.sync kernel on the same inputs (the
    same products in the same order, the same roundings) and to a second
    call (no atomics)."""
    gen = torch.Generator(card).manual_seed(24)
    q, k, v, do = (torch.randn(shape, generator=gen, device=card).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = tfa.flash_attn_reference(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    before = Counter(launch_counts)
    dq = tfa.flash_attn_bwd_dq(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert launch_counts - before == {"flash_attn_bwd_dq.wgmma": 1}
    assert dq.dtype == torch.bfloat16 and dq.shape == shape
    assert _scaled_err(dq, tfa.flash_attn_bwd_dq_reference(q, k, v, do, lse, delta)) \
        <= BWD_TOL[torch.bfloat16]
    assert torch.equal(tfa.flash_attn_bwd_dq(q, k, v, do, lse, delta), dq)
    monkeypatch.setattr(tfa, "_route", lambda *args: "tc")
    mma_sync = tfa.flash_attn_bwd_dq(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert launch_counts - before == {"flash_attn_bwd_dq.wgmma": 2, "flash_attn_bwd_dq.tc": 1}
    assert torch.equal(mma_sync, dq)


@pytest.mark.parametrize("shape,case", [((512, 256, 64), ""), ((2, 512, 64), "unaligned"),
                                        ((8, 1024, 72), ""), ((8, 1024, 128), ""),
                                        ((8, 1024, 32), "")])
def test_flash_dq_wgmma_route_leaves_short_other_dims_and_unaligned_calls(card, shape, case):
    """The U-Net's N = 256, head dims other than 64 (DiT-MoE-XL/2's 72
    among them) and an unaligned long call stay on mma.sync."""
    gen = torch.Generator(card).manual_seed(25)
    q, k, v, do = (torch.randn(shape, generator=gen, device=card).to(torch.bfloat16)
                   for _ in range(4))
    if case == "unaligned":
        q, k, v, do = (_unaligned(t) for t in (q, k, v, do))
    o, lse = tfa.flash_attn_reference(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    before = Counter(launch_counts)
    dq = tfa.flash_attn_bwd_dq(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert launch_counts - before == {"flash_attn_bwd_dq.tc": 1}
    assert _scaled_err(dq, tfa.flash_attn_bwd_dq_reference(q, k, v, do, lse, delta)) \
        <= BWD_TOL[torch.bfloat16]


def test_flash_tensor_core_kernels_take_unaligned_operands(card):
    """bf16 operands that are contiguous but not 16-byte aligned take the
    tensor-core kernels' 2-byte copies (forward, dQ and dK/dV)."""
    shape = (4, 100, 64)
    rng = np.random.default_rng(8)
    q, k, v, do = (_unaligned(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                              .to(card, torch.bfloat16)) for _ in range(4))
    assert all(t.is_contiguous() and t.data_ptr() % 16 for t in (q, k, v, do))
    before = Counter(launch_counts)
    o, lse = tfa.flash_attn_fwd(q, k, v)
    o0, lse0 = tfa.flash_attn_reference(q, k, v)
    delta = (do.float() * o0.float()).sum(-1)
    dq = tfa.flash_attn_bwd_dq(q, k, v, do, lse0, delta)
    dk, dv = tfa.flash_attn_bwd_dkv(q, k, v, do, lse0, delta)
    torch.cuda.synchronize()
    got, want = _variant_delta(before, torch.bfloat16, 1, 1, 1)
    assert got == want
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(o.float(), o0.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, lse0, atol=1e-4, rtol=1e-5)
    want = (tfa.flash_attn_bwd_dq_reference(q, k, v, do, lse0, delta),
            *tfa.flash_attn_bwd_dkv_reference(q, k, v, do, lse0, delta))
    for a, w in zip((dq, dk, dv), want):
        assert _scaled_err(a, w) <= BWD_TOL[torch.bfloat16]


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    """No fallback: a CUDA tensor the kernel cannot take raises."""
    x = torch.zeros(2, 4, 4, 64, device=card)
    s = torch.ones(64, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        tfn.gn_silu_fwd(x.permute(0, 2, 1, 3), s, s, 32)
    with pytest.raises(TypeError):
        tfn.gn_silu_fwd(x.half(), s, s, 32)
    with pytest.raises(ValueError, match="contiguous on"):
        tfn.gn_silu_fwd(x, s.cpu(), s, 32)
    q = torch.zeros(2, 16, 160, device=card)
    with pytest.raises(ValueError, match="d <= 128"):
        tfa.flash_attn_fwd(q, q, q)
    mean = torch.zeros(2, 64, device=card)
    with pytest.raises(ValueError, match="dy must be contiguous"):
        tfn.gn_silu_bwd(x, s, s, mean, mean, x.permute(0, 2, 1, 3), 32)
    with pytest.raises(ValueError, match="rstd"):
        tfn.gn_silu_bwd(x, s, s, mean, mean.double(), x, 32)
    q = torch.zeros(2, 16, 64, device=card)
    lse = torch.zeros(2, 16, device=card)
    with pytest.raises(ValueError, match="dO must be contiguous"):
        tfa.flash_attn_bwd_dq(q, q, q, q.transpose(0, 1).contiguous().transpose(0, 1),
                              lse, lse)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attn_bwd_dkv(q, q, q, q, lse.cpu(), lse)


_WRAPPERS = ((tfn, "gn_silu_fwd", tfn.gn_silu_reference),
             (tfn, "gn_silu_bwd", tfn.gn_silu_bwd_reference),
             (tfa, "flash_attn_fwd", tfa.flash_attn_reference),
             (tfa, "flash_attn_bwd_dq", tfa.flash_attn_bwd_dq_reference),
             (tfa, "flash_attn_bwd_dkv", tfa.flash_attn_bwd_dkv_reference),
             (tfu, "adamw_", tfu.adamw_reference),
             (tfu, "ema_lerp_", tfu.ema_lerp_reference))


@contextlib.contextmanager
def _plain_path():
    """The differentiable ops look their wrappers up when called: rebinding
    the module names routes forward and backward to the plain versions."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in _WRAPPERS]
    for mod, name, plain in _WRAPPERS:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)


SMALL = dict(base_channels=32, channel_mults=(1, 2, 2), num_res_blocks=1,
             attn_resolutions=(5,), time_embed_dim=64, num_heads=2, head_dim=16,
             img_resolution=10)


# the KL-VAE's GroupNorm shapes at train-vae's default batch (vae_64x_config):
# no time bias and 32 groups, so C = 64 holds two channels a group
VAE_GN_SHAPES = [(64, 64, 64, 64), (64, 64, 64, 128), (64, 32, 32, 64), (64, 32, 32, 128),
                 (64, 32, 32, 256), (64, 16, 16, 128), (64, 16, 16, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", VAE_GN_SHAPES)
def test_gn_silu_kernels_at_the_vae_shapes(card, shape, dtype):
    """Both GN kernels at a VAE shape against their plain versions, on the
    routes their plans name: the forward as every forward case here, the
    backward without the time bias (dx, dgamma, dbeta)."""
    args = _gn_args(shape, 32, False, dtype, card, seed=13)
    _gn_fwd_matches_plain(args)
    x, s, b, g, eps, _tb = args
    _, mean, rstd = tfn.gn_silu_reference(*args)
    dy = torch.randn(shape, generator=torch.Generator(card).manual_seed(14),
                     device=card).to(dtype)
    plan = tfn._gn_bwd_plan(shape[0], shape[1] * shape[2], shape[3], g, dtype)
    before = Counter(launch_counts)
    got = tfn.gn_silu_bwd(x, s, b, mean, rstd, dy, g)
    torch.cuda.synchronize()
    assert launch_counts - before == {"gn_silu_bwd." + ("smem" if plan[2] else "reread"): 1}
    want = tfn.gn_silu_bwd_reference(x, s, b, mean, rstd, dy, g)
    assert got[3] is None and want[3] is None
    for i, (a, w) in enumerate(zip(got[:3], want[:3])):
        assert _scaled_err(a, w) <= BWD_TOL[dtype if i == 0 else torch.float32], i


def test_vae_train_step_on_kernels_matches_plain_and_counts_launches(card):
    """One fp32 KL-VAE step (vae_16x_config at width 64: two channels a GN
    group) from the same weights and injected eps: kernels vs plain differ
    only in summation order; 5 GN calls an encode and 5 a decode, each once
    forward and once backward, none with the time bias, no attention."""
    import dataclasses

    from ddpm_diffusion_model_tpu_torch.models import AutoEncoderKL, vae_16x_config
    from ddpm_diffusion_model_tpu_torch.training import (TrainConfig, init_train_state,
                                                         make_vae_train_step)

    acfg = dataclasses.replace(vae_16x_config(), base_channels=64)
    torch.manual_seed(15)
    base = AutoEncoderKL(acfg, dtype=torch.float32, device=card).state_dict()
    gen = torch.Generator(card).manual_seed(16)
    x = torch.rand(4, 16, 16, 3, generator=gen, device=card) * 2 - 1
    eps = torch.randn(4, 8, 8, 4, generator=gen, device=card)
    cfg = TrainConfig(base_lr=1e-3, warmup_steps=None)
    out = []
    for ctx in (contextlib.nullcontext, _plain_path):
        model = AutoEncoderKL(acfg, dtype=torch.float32, device=card)
        model.load_state_dict(base)
        state, tx = init_train_state(model, cfg)
        c0 = Counter(launch_counts)
        with ctx():
            state, m = make_vae_train_step(model, tx, cfg, kl_weight=1e-2)(state, x, eps=eps)
        torch.cuda.synchronize()
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    torch.cat([p.detach().flatten() for p in model.parameters()]),
                    _since(c0, "gn_silu_fwd", "gn_silu_bwd", "gn_silu_bwd_dtb",
                               "flash_attn_fwd")))
    assert out[0][3] == (10, 10, 0, 0) and out[1][3] == (0,) * 4
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-5)
    assert out[0][1] == pytest.approx(out[1][1], rel=1e-4)
    move = out[1][2] - torch.cat([p.flatten() for p in base.values()]).to(card)
    assert float((out[0][2] - out[1][2]).norm()) <= 1e-2 * float(move.norm())


def test_unet_forward_on_kernels_matches_plain(card):
    torch.manual_seed(0)
    model = UNetDenoiser(UNetConfig(**SMALL), dtype=torch.float32, device=card)
    model = model.to(memory_format=torch.channels_last).eval()
    x = torch.randn(3, 10, 10, 3, device=card)
    t = torch.tensor([1, 500, 999], device=card)
    c0 = Counter(launch_counts)
    with torch.inference_mode():
        a = model(x, t)
        with _plain_path():
            b = model(x, t)
    torch.cuda.synchronize()
    # 3 encoder + 2 mid + 3 x 2 decoder ResBlocks, 2 norms each, + the head;
    # attention only at 5x5 (one block)
    assert _since(c0, "gn_silu_fwd", "flash_attn_fwd") == (23, 1)
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_service_on_the_card_counts_launches(card):
    from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
    from ddpm_diffusion_model_tpu_torch.serving import SamplerService

    torch.manual_seed(1)
    model = UNetDenoiser(UNetConfig(**SMALL), device=card)
    svc = SamplerService(model, make_schedule(DiffusionConfig(T=20), device=card),
                         10, device=card)
    forwards = [0]
    svc.model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    c0 = Counter(launch_counts)
    x, used = svc.sample(n=3, steps=5, seed=7)
    assert x.shape == (3, 10, 10, 3) and np.isfinite(x).all()
    assert 0.0 <= x.min() and x.max() <= 1.0 and used["steps"] == 5
    assert _since(c0, "gn_silu_fwd", "flash_attn_fwd") == (23 * forwards[0], forwards[0])
    assert forwards[0] > 0
    y, _ = svc.sample(n=3, steps=5, seed=7, eta=0.5)
    assert y.shape == x.shape and not np.array_equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_decode_forward_on_kernels_matches_plain(deterministic, dtype):
    """The decoder-only forward (encoder-cached sampling's reuse step) on
    the kernels against the plain versions, fed the same cached features:
    6 decoder ResBlocks x 2 + the head = 13 GN launches and no attention.
    Decoding a forward's own features at its t gives that forward's bits."""
    card = deterministic
    torch.manual_seed(2)
    model = UNetDenoiser(UNetConfig(**SMALL), dtype=dtype, device=card)
    model = model.to(memory_format=torch.channels_last).eval()
    x = torch.randn(3, 10, 10, 3, device=card)
    t = torch.tensor([1, 500, 999], device=card)
    t2 = torch.tensor([0, 450, 900], device=card)
    with torch.inference_mode():
        full, feats = model(x, t, return_features=True)
        c0 = Counter(launch_counts)
        a = model(x, t2, mode="decode", cached=feats)
        assert _since(c0, "gn_silu_fwd", "flash_attn_fwd") == (13, 0)
        with _plain_path():
            b = model(x, t2, mode="decode", cached=feats)
        own = model(x, t, mode="decode", cached=feats)
    torch.cuda.synchronize()
    assert all(f.dtype == dtype for f in (feats[0], *feats[1]))
    assert torch.equal(own, full)
    if dtype == torch.float32:
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    else:
        # one bf16 rounding of each GN output, carried through 6 ResBlocks
        assert float((a - b).norm() / b.norm()) < 1e-2


def test_dpmpp_on_kernels_matches_plain(card):
    """Four DPM-Solver++(2M) steps from one x_T on the kernels and on the
    plain versions (fp32: summation order only), 23 GN and 1 flash launch
    per forward."""
    from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
    from ddpm_diffusion_model_tpu_torch.sampling import dpmpp_from_init

    torch.manual_seed(3)
    model = UNetDenoiser(UNetConfig(**SMALL), dtype=torch.float32, device=card)
    model = model.to(memory_format=torch.channels_last).eval()
    sched = make_schedule(DiffusionConfig(T=100), device=card)
    x = torch.randn(4, 10, 10, 3, device=card)
    ladder = [99, 70, 40, 10, 0]
    c0 = Counter(launch_counts)
    a = dpmpp_from_init(model, sched, x, ladder)
    assert _since(c0, "gn_silu_fwd", "flash_attn_fwd") == (23 * 4, 4)
    with _plain_path():
        b = dpmpp_from_init(model, sched, x, ladder)
    torch.cuda.synchronize()
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_train_step_on_kernels_matches_plain_and_counts_launches(card):
    """One fp32 train step from the same weights and injected (t, noise),
    dropout off: kernels vs plain differ only in summation order; the
    step launches every kernel once per call site."""
    from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
    from ddpm_diffusion_model_tpu_torch.training import (StepDraws, TrainConfig,
                                                         init_train_state, make_train_step)

    torch.manual_seed(2)
    base = UNetDenoiser(UNetConfig(**SMALL), dtype=torch.float32, device=card).state_dict()
    sched = make_schedule(DiffusionConfig(T=100, img_size=10), device=card)
    gen = torch.Generator(card).manual_seed(4)
    x = torch.rand(4, 10, 10, 3, generator=gen, device=card) * 2 - 1
    draws = StepDraws(torch.randint(1, 100, (4,), generator=gen, device=card),
                      torch.randn(x.shape, generator=gen, device=card))
    cfg = TrainConfig(base_lr=1e-3, warmup_steps=None)
    out = []
    for ctx in (contextlib.nullcontext, _plain_path):
        model = UNetDenoiser(UNetConfig(**SMALL), dtype=torch.float32, device=card)
        model.load_state_dict(base)
        model = model.to(memory_format=torch.channels_last)
        state, tx = init_train_state(model, cfg)
        c0 = Counter(launch_counts)
        with ctx():
            state, m = make_train_step(model, sched, tx, cfg)(state, x, draws)
        torch.cuda.synchronize()
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    torch.cat([p.detach().flatten() for p in model.parameters()]),
                    _since(c0, "gn_silu_fwd", "gn_silu_bwd", "gn_silu_bwd_dtb",
                               "flash_attn_fwd", "flash_attn_bwd_dq",
                               "flash_attn_bwd_dkv")))
    # 11 ResBlocks (one time bias each) + the head; attention at 5x5 once
    assert out[0][3] == (23, 23, 11, 1, 1, 1) and out[1][3] == (0,) * 6
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-5)
    assert out[0][1] == pytest.approx(out[1][1], rel=1e-4)
    move = out[1][2] - torch.cat([p.flatten() for p in base.values()]).to(card)
    assert float((out[0][2] - out[1][2]).norm()) <= 1e-2 * float(move.norm())


def test_guided_forward_on_kernels_matches_plain(card):
    """Classifier-free guidance at w = 3 on a conditional U-Net (3 classes):
    ONE forward of the doubled batch, 23 GN and 1 flash launch, on the
    kernels against the plain versions (fp32: summation order only)."""
    from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
    from ddpm_diffusion_model_tpu_torch.sampling import cfg_eps_fn

    torch.manual_seed(5)
    model = UNetDenoiser(UNetConfig(**SMALL, num_classes=3), dtype=torch.float32,
                         device=card)
    model = model.to(memory_format=torch.channels_last).eval()
    sched = make_schedule(DiffusionConfig(T=100, img_size=10), device=card)
    x = torch.randn(4, 10, 10, 3, device=card)
    t = torch.tensor([1, 30, 60, 99], device=card)
    y = torch.tensor([0, 2, 1, 3], device=card)  # 3 is the NULL token
    eps = cfg_eps_fn(model, sched, y=y, guidance=3.0)
    c0 = Counter(launch_counts)
    with torch.inference_mode():
        a = eps(x, t)
        assert _since(c0, "gn_silu_fwd", "flash_attn_fwd") == (23, 1)
        with _plain_path():
            b = eps(x, t)
    torch.cuda.synchronize()
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_conditional_train_step_on_kernels_matches_plain(card):
    """One fp32 conditional train step from the same weights and injected
    (t, noise, drop): kernels vs plain differ only in summation order,
    the class table included; the launches of an unconditional step."""
    from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
    from ddpm_diffusion_model_tpu_torch.training import (StepDraws, TrainConfig,
                                                         init_train_state, make_train_step)

    cfg_m = UNetConfig(**SMALL, num_classes=3)
    torch.manual_seed(6)
    base = UNetDenoiser(cfg_m, dtype=torch.float32, device=card).state_dict()
    sched = make_schedule(DiffusionConfig(T=100, img_size=10), device=card)
    gen = torch.Generator(card).manual_seed(7)
    x = torch.rand(4, 10, 10, 3, generator=gen, device=card) * 2 - 1
    y = torch.tensor([0, 1, 2, 0], device=card)
    draws = StepDraws(torch.randint(1, 100, (4,), generator=gen, device=card),
                      torch.randn(x.shape, generator=gen, device=card), None,
                      torch.tensor([False, True, False, False], device=card))
    cfg = TrainConfig(base_lr=1e-3, warmup_steps=None, cond_dropout=0.5)
    out = []
    for ctx in (contextlib.nullcontext, _plain_path):
        model = UNetDenoiser(cfg_m, dtype=torch.float32, device=card)
        model.load_state_dict(base)
        model = model.to(memory_format=torch.channels_last)
        state, tx = init_train_state(model, cfg)
        c0 = Counter(launch_counts)
        with ctx():
            state, m = make_train_step(model, sched, tx, cfg)(state, (x, y), draws)
        torch.cuda.synchronize()
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    torch.cat([p.detach().flatten() for p in model.parameters()]),
                    _since(c0, "gn_silu_fwd", "gn_silu_bwd", "flash_attn_fwd",
                               "flash_attn_bwd_dq"),
                    model.class_emb.weight.detach().clone()))
    assert out[0][3] == (23, 23, 1, 1) and out[1][3] == (0,) * 4
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-5)
    assert out[0][1] == pytest.approx(out[1][1], rel=1e-4)
    move = out[1][2] - torch.cat([p.flatten() for p in base.values()]).to(card)
    assert float((out[0][2] - out[1][2]).norm()) <= 1e-2 * float(move.norm())
    table_move = out[1][4] - base["class_emb.weight"]
    assert float((out[0][4] - out[1][4]).norm()) <= 1e-2 * float(table_move.norm())


@pytest.mark.parametrize("kind", ["progressive", "consistency"])
def test_guided_distill_update_on_kernels_matches_plain(card, kind):
    """One fp32 distillation update of a conditional student with guidance
    3 baked in, from the same weights, teacher and injected draws: kernels
    vs plain differ only in summation order.  Three forwards an update (a
    progressive update's two guided teacher half-steps, one doubled forward
    each, or a consistency update's teacher step and EMA target; then the
    student's), the student's backward once."""
    from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
    from ddpm_diffusion_model_tpu_torch.training import (DistillDraws, TrainConfig,
                                                         consistency_ladder,
                                                         distill_ladder,
                                                         init_train_state,
                                                         make_consistency_step,
                                                         make_distill_step)

    cfg_m = UNetConfig(**SMALL, num_classes=3, dropout=0.1)
    torch.manual_seed(8)
    base = UNetDenoiser(cfg_m, dtype=torch.float32, device=card).state_dict()
    torch.manual_seed(9)
    teacher = dict(UNetDenoiser(cfg_m, dtype=torch.float32, device=card).named_parameters())
    teacher = {k: v.detach() for k, v in teacher.items()}
    sched = make_schedule(DiffusionConfig(T=100, img_size=10), device=card)
    gen = torch.Generator(card).manual_seed(10)
    x = torch.rand(4, 10, 10, 3, generator=gen, device=card) * 2 - 1
    y = torch.tensor([0, 1, 2, 0], device=card)
    draws = DistillDraws(torch.tensor([0, 1, 2, 3], device=card),
                         torch.randn(x.shape, generator=gen, device=card))
    cfg = TrainConfig(base_lr=1e-3, warmup_steps=0, ema_decay=0.9)
    make, ladder = ((make_distill_step, distill_ladder(100, 4)) if kind == "progressive"
                    else (make_consistency_step, consistency_ladder(100, 4)))
    out = []
    for ctx in (contextlib.nullcontext, _plain_path):
        model = UNetDenoiser(cfg_m, dtype=torch.float32, device=card)
        model.load_state_dict(base)
        model = model.to(memory_format=torch.channels_last)
        state, tx = init_train_state(model, cfg)
        c0 = Counter(launch_counts)
        with ctx():
            step = make(model, sched, ladder, tx, cfg, guidance=3.0)
            state, m = step(state, teacher, (x, y), draws)
        torch.cuda.synchronize()
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    torch.cat([p.detach().flatten() for p in model.parameters()]),
                    _since(c0, "gn_silu_fwd", "gn_silu_bwd", "flash_attn_fwd",
                               "flash_attn_bwd_dq", "flash_attn_bwd_dkv")))
    assert out[0][3] == (3 * 23, 23, 3, 1, 1) and out[1][3] == (0,) * 5
    assert np.isfinite(out[0][0]) and out[0][0] > 0
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-5)
    assert out[0][1] == pytest.approx(out[1][1], rel=1e-4)
    move = out[1][2] - torch.cat([p.flatten() for p in base.values()]).to(card)
    assert float((out[0][2] - out[1][2]).norm()) <= 1e-2 * float(move.norm())


def test_sr_train_step_on_kernels_matches_plain(card):
    """One fp32 super-resolution train step (cond_channels 3, factor 2,
    cond_aug 0.1, remat, 2 micro-batches) from the same weights and
    injected (t, noise, sigma, cond noise): kernels vs plain differ only in
    summation order, the stem's cond slice moves; the launches of a remat
    step: per micro-batch 23 GN forwards + 22 recomputed, 23 backward (11
    with the time bias), 1 of each flash kernel."""
    from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
    from ddpm_diffusion_model_tpu_torch.training import (StepDraws, TrainConfig,
                                                         init_train_state, make_train_step)

    cfg_m = UNetConfig(**SMALL, cond_channels=3)
    torch.manual_seed(8)
    base = UNetDenoiser(cfg_m, dtype=torch.float32, device=card).state_dict()
    sched = make_schedule(DiffusionConfig(T=100, img_size=10), device=card)
    gen = torch.Generator(card).manual_seed(9)
    x = torch.rand(4, 10, 10, 3, generator=gen, device=card) * 2 - 1
    draws = StepDraws(torch.randint(1, 100, (4,), generator=gen, device=card),
                      torch.randn(x.shape, generator=gen, device=card), None, None,
                      torch.rand((4,), generator=gen, device=card) * 0.1,
                      torch.randn(x.shape, generator=gen, device=card))
    cfg = TrainConfig(base_lr=1e-3, warmup_steps=None, superres_factor=2, cond_aug=0.1,
                      grad_accum_steps=2)
    out = []
    for ctx in (contextlib.nullcontext, _plain_path):
        model = UNetDenoiser(cfg_m, dtype=torch.float32, device=card, remat=True)
        model.load_state_dict(base)
        model = model.to(memory_format=torch.channels_last)
        state, tx = init_train_state(model, cfg)
        c0 = Counter(launch_counts)
        with ctx():
            state, m = make_train_step(model, sched, tx, cfg)(state, x, draws)
        torch.cuda.synchronize()
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    torch.cat([p.detach().flatten() for p in model.parameters()]),
                    _since(c0, "gn_silu_fwd", "gn_silu_bwd", "gn_silu_bwd_dtb",
                               "flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"),
                    model.in_conv.weight.detach().clone()))
    assert out[0][3] == (2 * 45, 2 * 23, 2 * 11, 2, 2, 2) and out[1][3] == (0,) * 6
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-5)
    assert out[0][1] == pytest.approx(out[1][1], rel=1e-4)
    move = out[1][2] - torch.cat([p.flatten() for p in base.values()]).to(card)
    assert float((out[0][2] - out[1][2]).norm()) <= 1e-2 * float(move.norm())
    assert float((out[0][4] - base["in_conv.weight"])[:, 3:].abs().max()) > 0


@pytest.mark.parametrize("guidance", [1.0, 3.0])
def test_upsample_on_kernels_matches_plain_and_counts_launches(card, guidance):
    """Four DDIM steps of the upsampler (a class-conditional SR U-Net, the
    cond doubled under guidance) from one x_T on the kernels and on the
    plain versions (fp32: summation order only): 23 GN and 1 flash launch
    per forward, one forward per step at either guidance."""
    from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
    from ddpm_diffusion_model_tpu_torch.sampling import upsample_from_init
    from ddpm_diffusion_model_tpu_torch.sampling.superres import _cond_from_low

    torch.manual_seed(10)
    model = UNetDenoiser(UNetConfig(**SMALL, cond_channels=3, num_classes=3),
                         dtype=torch.float32, device=card)
    model = model.to(memory_format=torch.channels_last).eval()
    sched = make_schedule(DiffusionConfig(T=100, img_size=10), device=card)
    low = np.random.default_rng(3).uniform(-1, 1, size=(5, 5, 3)).astype(np.float32)
    cond = _cond_from_low(model, low, 4, card)
    x = torch.randn(4, 10, 10, 3, device=card)
    ladder = [99, 70, 40, 10, 0]
    y = torch.tensor([0, 1, 2, 0], device=card)
    c0 = Counter(launch_counts)
    a = upsample_from_init(model, sched, cond, x, ladder, y=y, guidance=guidance)
    assert _since(c0, "gn_silu_fwd", "flash_attn_fwd") == (23 * 4, 4)
    with _plain_path():
        b = upsample_from_init(model, sched, cond, x, ladder, y=y, guidance=guidance)
    torch.cuda.synchronize()
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------- the DiT


def test_flash_kernels_at_the_dit_moe_xl2_shape(card):
    """The flash forward, dQ and dK/dV at DiT-MoE-XL/2's attention in the
    benchmark's cell: batch 128 x 16 heads, N = 256, d = 72 (the padded
    head-dim path, dQ and dK/dV on mma.sync), bf16, against the plain
    versions."""
    shape = (2048, 256, 72)
    gen = torch.Generator(card).manual_seed(72)
    q, k, v, do = (torch.randn(shape, generator=gen, device=card).to(torch.bfloat16)
                   for _ in range(4))
    before = Counter(launch_counts)
    o, lse = tfa.flash_attn_fwd(q, k, v)
    o0, lse0 = tfa.flash_attn_reference(q, k, v)
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(o.float(), o0.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, lse0, atol=1e-4, rtol=1e-5)
    delta = (do.float() * o0.float()).sum(-1)
    dq = tfa.flash_attn_bwd_dq(q, k, v, do, lse0, delta)
    dk, dv = tfa.flash_attn_bwd_dkv(q, k, v, do, lse0, delta)
    torch.cuda.synchronize()
    got, want = _variant_delta(before, torch.bfloat16, 1, 1, 1)
    assert got == want
    assert _scaled_err(dq, tfa.flash_attn_bwd_dq_reference(q, k, v, do, lse0, delta)) \
        <= BWD_TOL[torch.bfloat16]
    for a, w in zip((dk, dv), tfa.flash_attn_bwd_dkv_reference(q, k, v, do, lse0, delta)):
        assert _scaled_err(a, w) <= BWD_TOL[torch.bfloat16]


def _dropless_layer(card, H=1152, F=4608, shared=2304):
    from ddpm_diffusion_model_tpu_torch.models.moe import DroplessMoE

    torch.manual_seed(23)
    return DroplessMoE(H, F, 8, 2, shared).to(card)


def test_dropless_moe_runs_without_a_host_sync(card):
    """DiT-MoE-XL/2's expert layer at its published widths (8 SwiGLU experts
    of 4,608, 2 a token, a shared one of 2,304) over 8 x 256 tokens: the
    routing, the grouped products, the combine and the backward of all of
    them, with every synchronizing call an error."""
    layer = _dropless_layer(card)
    x = torch.randn(8, 256, 1152, device=card, dtype=torch.bfloat16, requires_grad=True)

    def step():
        y, aux = layer(x)
        (y.float().square().mean() + aux).backward()

    step()  # the libraries' first-call set-up
    torch.cuda.synchronize()
    before = Counter(launch_counts)
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert _since(before, "grouped_mm.fwd", "grouped_mm.bwd") == (2, 4)
    assert all(torch.isfinite(p.grad).all() for p in layer.parameters())


@pytest.mark.parametrize("rows", ["spread", "one_empty", "all_to_one"])
def test_grouped_swiglu_matches_a_loop_over_the_experts_on_the_card(card, rows):
    """The grouped forward and backward at the published widths against a
    plain loop of bf16 products over the experts' rows, with one expert
    given no rows and with every row given to one expert."""
    from ddpm_diffusion_model_tpu_torch.models.moe import grouped_swiglu_bwd, grouped_swiglu_fwd

    E, H, F, R = 8, 1152, 4608, 4096
    counts = {"spread": [700, 300, 512, 488, 600, 400, 96, 1000],
              "one_empty": [700, 300, 0, 488, 600, 400, 608, 1000],
              "all_to_one": [0, 0, 0, R, 0, 0, 0, 0]}[rows]
    offs = torch.tensor(counts, device=card).cumsum(0).to(torch.int32)
    gen = torch.Generator(card).manual_seed(4608)
    bf = dict(device=card, dtype=torch.bfloat16)
    xs = torch.randn(R, H, generator=gen, **bf)
    w13 = (torch.randn(E, 2 * F, H, generator=gen, **bf) * H ** -0.5).to(torch.bfloat16)
    w2 = (torch.randn(E, H, F, generator=gen, **bf) * F ** -0.5).to(torch.bfloat16)
    dy = torch.randn(R, H, generator=gen, **bf)
    y, gu = grouped_swiglu_fwd(xs, w13, w2, offs)
    dxs, dw13, dw2 = grouped_swiglu_bwd(dy, xs, w13, w2, offs, gu)
    leaves = [t.clone().requires_grad_(True) for t in (xs, w13, w2)]
    ys, s = [], 0
    for e, c in enumerate(counts):
        rows_e = leaves[0][s:s + c]
        g, u = (rows_e @ leaves[1][e].t()).chunk(2, dim=-1)
        ys.append((torch.nn.functional.silu(g) * u) @ leaves[2][e].t())
        s += c
    want = torch.cat(ys)
    want.backward(dy)
    for got, ref in zip((y, dxs, dw13, dw2), (want, *(t.grad for t in leaves))):
        assert _scaled_err(got, ref) <= 1e-2
    empty = [e for e, c in enumerate(counts) if c == 0]
    assert not dw13[empty].any() and not dw2[empty].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_kernels_at_the_dit_256_length(card, dtype):
    """The flash forward, dQ and dK/dV at dit_s4_256_config's attention:
    batch 8 x 6 heads, N = 4096, d = 64, against the plain versions."""
    shape = (48, 4096, 64)
    gen = torch.Generator(card).manual_seed(8)
    q, k, v, do = (torch.randn(shape, generator=gen, device=card).to(dtype)
                   for _ in range(4))
    before = Counter(launch_counts)
    o, lse = tfa.flash_attn_fwd(q, k, v)
    o0, lse0 = tfa.flash_attn_reference(q, k, v)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(o.float(), o0.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, lse0, atol=1e-4, rtol=1e-5)
    del o
    delta = (do.float() * o0.float()).sum(-1)
    dq = tfa.flash_attn_bwd_dq(q, k, v, do, lse0, delta)
    dk, dv = tfa.flash_attn_bwd_dkv(q, k, v, do, lse0, delta)
    torch.cuda.synchronize()
    got, want = _variant_delta(before, dtype, 1, 1, 1, bwd_route="wgmma")  # bf16 dQ, dK/dV
    assert got == want
    assert _scaled_err(dq, tfa.flash_attn_bwd_dq_reference(q, k, v, do, lse0, delta)) \
        <= BWD_TOL[dtype]
    for a, w in zip((dk, dv), tfa.flash_attn_bwd_dkv_reference(q, k, v, do, lse0, delta)):
        assert _scaled_err(a, w) <= BWD_TOL[dtype]


@pytest.mark.parametrize("family", ["dit_s4_256", "celeba64_attn"])
def test_a_bf16_step_takes_the_wgmma_dkv_route_by_length(card, family):
    """One bf16 forward and backward at batch 1 of the two benchmarked
    models: DiT-S/4 at 256 px (12 attention calls at N = 4096) takes the
    wgmma dK/dV and dQ kernels on every call, the 64-px U-Net (5 calls at
    N = 256 and 64) on none."""
    from ddpm_diffusion_model_tpu_torch.models import (DiTDenoiser, dit_s4_256_config,
                                                       unet_64x64_config)

    torch.manual_seed(11)
    if family == "dit_s4_256":
        model, size, calls, route = (DiTDenoiser(dit_s4_256_config(), dtype=torch.bfloat16,
                                                 device=card), 256, 12, "wgmma")
    else:
        model, size, calls, route = (UNetDenoiser(unet_64x64_config(dropout=0.0),
                                                  dtype=torch.bfloat16, device=card),
                                     64, 5, "tc")
    model = model.to(memory_format=torch.channels_last)
    x = torch.randn(1, size, size, 3, device=card)
    t = torch.tensor([500], device=card)

    before = Counter(launch_counts)
    model(x, t).float().square().mean().backward()
    torch.cuda.synchronize()
    bwd = {k: n for k, n in (launch_counts - before).items() if k.startswith("flash_attn_bwd")}
    assert bwd == {f"flash_attn_bwd_dq.{route}": calls, f"flash_attn_bwd_dkv.{route}": calls}
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)


DIT_SMALL = dict(img_resolution=16, patch_size=4, hidden_size=64, depth=2, num_heads=2,
                 time_embed_dim=32)


def _dit(card, **over):
    """A small DiT on the card, off the adaLN-Zero init (seeded)."""
    from ddpm_diffusion_model_tpu_torch.models import DiTConfig, DiTDenoiser

    torch.manual_seed(6)
    model = DiTDenoiser(DiTConfig(**DIT_SMALL, **over), dtype=torch.float32, device=card)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model


@pytest.mark.parametrize("num_experts", [0, 4])
def test_dit_forward_on_kernels_matches_plain(card, num_experts):
    model = _dit(card, num_experts=num_experts, num_classes=3).eval()
    x = torch.randn(3, 16, 16, 3, device=card)
    t = torch.tensor([1, 500, 999], device=card)
    y = torch.tensor([0, 3, 2], device=card)
    c0 = Counter(launch_counts)
    with torch.inference_mode():
        a = model(x, t, y)
        with _plain_path():
            b = model(x, t, y)
    torch.cuda.synchronize()
    # no GroupNorm; one attention per block
    assert _since(c0, "gn_silu_fwd", "flash_attn_fwd") == (0, 2)
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_moe_dit_train_step_on_kernels_matches_plain(card):
    """One fp32 MoE DiT step from the same weights and injected (t, noise):
    the loss (with the aux term), grad norm and update on the kernels
    against the plain versions; one flash forward, dQ and dK/dV per block."""
    from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
    from ddpm_diffusion_model_tpu_torch.training import (StepDraws, TrainConfig,
                                                         init_train_state, make_train_step)

    base = _dit(card, num_experts=4).state_dict()
    sched = make_schedule(DiffusionConfig(T=100, img_size=16), device=card)
    gen = torch.Generator(card).manual_seed(4)
    x = torch.rand(4, 16, 16, 3, generator=gen, device=card) * 2 - 1
    draws = StepDraws(torch.randint(1, 100, (4,), generator=gen, device=card),
                      torch.randn(x.shape, generator=gen, device=card))
    cfg = TrainConfig(base_lr=1e-3, warmup_steps=None)
    out = []
    for ctx in (contextlib.nullcontext, _plain_path):
        model = _dit(card, num_experts=4)
        model.load_state_dict(base)
        state, tx = init_train_state(model, cfg)
        c0 = Counter(launch_counts)
        with ctx():
            state, m = make_train_step(model, sched, tx, cfg)(state, x, draws)
        torch.cuda.synchronize()
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    torch.cat([p.detach().flatten() for p in model.parameters()]),
                    _since(c0, "gn_silu_fwd", "flash_attn_fwd", "flash_attn_bwd_dq",
                               "flash_attn_bwd_dkv")))
    assert out[0][3] == (0, 2, 2, 2) and out[1][3] == (0,) * 4
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-5)
    assert out[0][1] == pytest.approx(out[1][1], rel=1e-4)
    move = out[1][2] - torch.cat([p.flatten() for p in base.values()]).to(card)
    assert float((out[0][2] - out[1][2]).norm()) <= 1e-2 * float(move.norm())


@pytest.fixture
def deterministic(card):
    """cuDNN's deterministic algorithms: the same step gives the same bits."""
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield card
    torch.backends.cudnn.deterministic = False


def _grads(model, x, t, seed):
    gen = torch.Generator(x.device).manual_seed(seed)
    loss = model(x, t, generator=gen).float().square().mean()
    loss.backward()
    grads = [p.grad.clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads, gen.get_state()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_remat_grads_equal_no_remat_on_the_kernels(deterministic, dtype):
    """Dropout 0.1 from an explicit CUDA generator: remat=True (the
    ResBlocks recomputed, their GN kernels launched again) and "masks" give
    no-remat's loss and grads bit for bit and leave the generator where it
    would be."""
    card = deterministic
    torch.manual_seed(5)
    cfg = UNetConfig(**dict(SMALL, dropout=0.1))
    base = UNetDenoiser(cfg, dtype=dtype, device=card).state_dict()
    x = torch.randn(4, 10, 10, 3, generator=torch.Generator(card).manual_seed(1),
                    device=card)
    t = torch.tensor([1, 40, 500, 999], device=card)
    out = {}
    for remat in (False, True, "masks"):
        model = UNetDenoiser(cfg, dtype=dtype, device=card, remat=remat)
        model.load_state_dict(base)
        model = model.to(memory_format=torch.channels_last).train()
        c0 = Counter(launch_counts)
        out[remat] = _grads(model, x, t, seed=3)
        torch.cuda.synchronize()
        # 11 ResBlocks x 2 norms + the head; again for the recompute
        assert _since(c0, "gn_silu_fwd") == (23 + (22 if remat is True else 0),)
    l0, g0, s0 = out[False]
    for remat in (True, "masks"):
        l1, g1, s1 = out[remat]
        assert torch.equal(l0, l1) and torch.equal(s0, s1), remat
        assert all(torch.equal(a, b) for a, b in zip(g0, g1)), remat


def test_checkpoint_round_trip_of_cuda_state(deterministic, tmp_path):
    """Save a CUDA train state (params, moments, EMA, the CUDA generator's
    state), load it into a fresh state on the card: equal, and one more
    step from each gives the same bits."""
    from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
    from ddpm_diffusion_model_tpu_torch.training import (TrainConfig, init_train_state,
                                                         load_checkpoint, make_optimizer,
                                                         make_train_step, save_checkpoint)

    card = deterministic
    cfg = TrainConfig(base_lr=1e-3, warmup_steps=3, moment_dtype="bfloat16")
    sched = make_schedule(DiffusionConfig(T=100, img_size=10), device=card)
    x = torch.rand(4, 10, 10, 3, generator=torch.Generator(card).manual_seed(2),
                   device=card) * 2 - 1

    def fresh(seed):
        torch.manual_seed(seed)
        model = UNetDenoiser(UNetConfig(**dict(SMALL, dropout=0.1)), device=card)
        return init_train_state(model.to(memory_format=torch.channels_last), cfg, seed=9)[0]

    state = fresh(0)
    assert state.generator.device.type == "cuda"
    step = make_train_step(state.model, sched, make_optimizer(cfg), cfg)
    for _ in range(2):
        state, _ = step(state, x)
    path = str(tmp_path / "c")
    save_checkpoint(path, state, epoch=0, block=False)
    restored, meta = load_checkpoint(path, fresh(1))
    assert meta["global_step"] == 2 and restored.generator.device.type == "cuda"
    assert torch.equal(restored.generator.get_state(), state.generator.get_state())
    assert restored.opt_state["mu"][0].dtype == torch.bfloat16
    assert all(p.is_cuda for p in restored.model.parameters())
    state, m_a = step(state, x)
    restored, m_b = make_train_step(restored.model, sched, make_optimizer(cfg),
                                    cfg)(restored, x)
    assert torch.equal(m_a["loss"], m_b["loss"])
    for p, q in zip(state.model.parameters(), restored.model.parameters()):
        assert torch.equal(p, q)
    assert all(torch.equal(state.ema_params[k], restored.ema_params[k])
               for k in state.ema_params)


# ------------------------------------------------- the data path on the card


@pytest.mark.parametrize("mode", ["quantize", "fp32", "labels"])
def test_device_cache_on_the_card_equals_the_cpu_cache(card, mode):
    """Upload through pinned chunks (several chunks: a small chunk size),
    the per-epoch order on the card and the gather there, bit-equal to the
    same cache on the CPU."""
    from ddpm_diffusion_model_tpu_torch.data import loader

    arr = np.random.default_rng(0).uniform(-1, 1, (301, 8, 8, 3)).astype(np.float32)
    kw = dict(batch_size=32, seed=3, quantize=mode != "fp32",
              labels=np.arange(301) % 7 if mode == "labels" else None)
    on_card = loader.DeviceCacheLoader(arr, device=card, **kw)
    on_cpu = loader.DeviceCacheLoader(arr, device="cpu", **kw)
    assert on_card.corpus.is_cuda and on_card.corpus_bytes == on_cpu.corpus_bytes
    assert torch.equal(on_card.corpus.cpu(), on_cpu.corpus)
    small = loader._upload(on_cpu.corpus, card, chunk_bytes=1000)
    assert torch.equal(small.cpu(), on_cpu.corpus)
    for _ in range(2):
        for (xa, ya), (xb, yb) in zip(on_card, on_cpu):
            assert xa.is_cuda and xa.dtype == torch.float32
            assert torch.equal(xa.cpu(), xb)
            assert (ya is None and yb is None) or torch.equal(ya.cpu(), yb)


def test_device_prefetch_equals_the_synchronous_copy(card):
    """Every prefetched batch bit-equal to a synchronous copy, while the
    consumer works on the card and the producer hands over one host buffer
    that it rewrites after each yield (a staging buffer reused too early,
    or a copy not waited on, would show)."""
    from ddpm_diffusion_model_tpu_torch.data import loader

    rng = np.random.default_rng(1)
    batches = [rng.normal(size=(64, 32, 32, 3)).astype(np.float32) for _ in range(12)]
    host = np.empty_like(batches[0])

    def producer():
        for b in batches:
            host[...] = b
            yield host, None
            host[...] = np.nan  # the caller has the batch; the buffer is reused

    w = torch.randn(3, 3, device=card)
    got = []
    for x, y in loader.device_prefetch(producer(), size=2, device=card):
        assert x.is_cuda and y is None
        for _ in range(20):  # keep the consumer stream busy
            w = torch.tanh(w @ w)
        got.append((x * 1.0).cpu())
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        assert torch.equal(g, torch.from_numpy(b))
    t = torch.ones(3, device=card)
    (x, _), = loader.device_prefetch([t], device=card)
    assert x is t  # on the card already: untouched


def test_mounted_fid_extractor_runs_on_the_card(card, tmp_path):
    """``load_torch_extractor`` on the card: the mounted network's
    parameters sit there, and its features and ``fid`` equal the CPU
    mount's on the same images (float32 convs, TF32 off)."""
    from ddpm_diffusion_model_tpu_torch.utils import fid

    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, stride=2, padding=1),
                              torch.nn.LeakyReLU(0.2), torch.nn.AdaptiveAvgPool2d(1),
                              torch.nn.Flatten())
    path = str(tmp_path / "ex.pt")
    torch.jit.save(torch.jit.script(net), path)
    ex = fid.load_torch_extractor(path, device=card)
    params = list(ex.module.parameters())
    assert params and all(p.is_cuda for p in params)
    ex_cpu = fid.load_torch_extractor(path, device="cpu")
    assert not any(p.is_cuda for p in ex_cpu.module.parameters())
    rng = np.random.default_rng(2)
    a, b = (rng.random((24, 16, 16, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(ex(a), ex_cpu(a), rtol=1e-5, atol=1e-6)
    assert fid.fid(a, b, extractor_path=path, device=card) == pytest.approx(
        fid.fid(a, b, extractor_path=path, device="cpu"), rel=1e-4)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_virtual_ring_on_the_kernels_matches_one_flash_call(card, dtype, S):
    """The ring's hop code over S blocks (ops/ring_attention.py) on the
    flash kernels against one flash call on the same operands, S^2 launches
    of each kernel."""
    from ddpm_diffusion_model_tpu_torch.ops.ring_attention import (virtual_ring_attention,
                                                                   virtual_ring_attention_bwd)

    g = torch.Generator(device=card).manual_seed(5)
    q, k, v, do = (torch.randn(8, 512, 64, generator=g, device=card).to(dtype)
                   for _ in range(4))
    o1, lse1 = tfa.flash_attn_fwd(q, k, v)
    want = tfa.flash_attn_bwd(q, k, v, o1, lse1, do)
    before = Counter(launch_counts)
    o, lse = virtual_ring_attention(q, k, v, S)
    got = virtual_ring_attention_bwd(q, k, v, o, lse, do, S)
    torch.cuda.synchronize()
    assert _since(before, "flash_attn_fwd", "flash_attn_bwd_dq",
                  "flash_attn_bwd_dkv") == (S * S,) * 3
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(o.float(), o1.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, lse1, atol=1e-4, rtol=1e-5)
    for a, b in zip(got, want):
        scale = max(float(b.float().abs().max()), 1.0)
        assert float((a.float() - b.float()).abs().max()) <= atol * scale


def test_ring_attention_at_world_1_on_nccl_is_the_flash_call(card, tmp_path):
    """A one-rank NCCL group: ring_attention_sharded bit-equal to
    flash_attention, forward and grads."""
    import torch.distributed as dist

    from ddpm_diffusion_model_tpu_torch.ops.ring_attention import ring_attention_sharded
    from ddpm_diffusion_model_tpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed("cuda", init_method=f"file://{tmp_path}/store", rank=0,
                           world_size=1)
    try:
        mesh = make_mesh((1,), ("cp",), device="cuda")
        g = torch.Generator(device=card).manual_seed(6)
        q, k, v, w = (torch.randn(2, 4, 256, 64, generator=g, device=card).bfloat16()
                      for _ in range(4))
        outs = []
        for fn in (lambda a, b, c: ring_attention_sharded(a, b, c, mesh, "cp"),
                   tfa.flash_attention):
            a, b, c = (t.clone().requires_grad_() for t in (q, k, v))
            o = fn(a, b, c)
            (o.float() * w.float()).sum().backward()
            outs.append((o.detach(), a.grad, b.grad, c.grad))
        assert all(torch.equal(x, y) for x, y in zip(*outs))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------ tensor, expert, pipeline parallelism


def _virtual_against_plain(card, model, ctx, wrap=None, x_shape=(4, 16, 16, 3)):
    """The model's fp32 forward and the grads of sum(out^2) under ``ctx``
    (or through ``wrap(model)``) on the kernels, against the plain path
    without it; returns the flash forward launches of the parallel run."""
    g = torch.Generator(device=card).manual_seed(9)
    x = torch.randn(*x_shape, generator=g, device=card)
    t = torch.randint(1, 100, (x_shape[0],), generator=g, device=card)
    out = []
    for parallel in (True, False):
        model.zero_grad()
        c0 = Counter(launch_counts)
        with (ctx() if parallel and ctx else contextlib.nullcontext()), \
                (contextlib.nullcontext() if parallel else _plain_path()):
            y = (wrap(model) if parallel and wrap else model)(x, t)
            y.square().sum().backward()
        torch.cuda.synchronize()
        out.append((y.detach(), [p.grad.clone() for p in model.parameters()],
                    _since(c0, "flash_attn_fwd")[0]))
    torch.testing.assert_close(out[0][0], out[1][0], atol=1e-4, rtol=1e-4)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=1e-4 * max(float(b.abs().max()), 1.0),
                                   rtol=1e-3)
    return out[0][2]


@pytest.mark.parametrize("R", [1, 2])
def test_virtual_tp_on_the_kernels_matches_plain(card, R):
    """A small DiT with its heads over a virtual R-rank ``model`` axis: R
    flash calls per block at (B * heads / R, N, d), equal to the plain path
    without TP."""
    from ddpm_diffusion_model_tpu_torch.parallel import VirtualMesh, tensor_parallel_mesh

    launches = _virtual_against_plain(
        card, _dit(card), lambda: tensor_parallel_mesh(VirtualMesh((R,), ("model",))))
    assert launches == 2 * R  # 2 blocks


@pytest.mark.parametrize("R", [2, 4])
def test_virtual_ep_on_the_kernels_matches_plain(card, R):
    from ddpm_diffusion_model_tpu_torch.parallel import VirtualMesh, expert_parallel_mesh

    launches = _virtual_against_plain(
        card, _dit(card, num_experts=4),
        lambda: expert_parallel_mesh(VirtualMesh((R,), ("expert",))))
    assert launches == 2


@pytest.mark.parametrize("S,M", [(2, 2), (2, 4)])
def test_virtual_pp_on_the_kernels_matches_plain(card, S, M):
    """A small DiT's two blocks over S virtual stages, M microbatches: one
    flash forward per block and microbatch."""
    from ddpm_diffusion_model_tpu_torch.parallel import PipelinedDiT, VirtualMesh

    launches = _virtual_against_plain(
        card, _dit(card), None,
        wrap=lambda m: PipelinedDiT(m, VirtualMesh((S,), ("pp",)), microbatches=M))
    assert launches == 2 * M


def _trace_kernel_events(path):
    """(GN+SiLU forward, flash forward) kernel events of a Chrome trace."""
    import json

    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    return (sum("gn_silu_fwd_kernel" in n for n in names),
            sum("flash_fwd" in n for n in names))


def test_profiler_trace_of_a_forward_counts_the_kernels(card, tmp_path):
    """``profiler_trace`` over one bf16 ``celeba64_attn`` forward at 16: the
    trace holds 45 GN+SiLU and 5 flash forward kernels.  CUPTI now and then
    drops a trace's device events, so up to 4 traces are taken; none may
    hold more."""
    import os

    from ddpm_diffusion_model_tpu_torch.training import profiler_trace
    from ddpm_diffusion_model_tpu_torch.utils.config import get_preset

    torch.manual_seed(0)
    model = UNetDenoiser(get_preset("celeba64_attn").model, device=card)
    model = model.to(memory_format=torch.channels_last).eval()
    x = torch.randn(16, 64, 64, 3, device=card)
    t = torch.randint(0, 1000, (16,), device=card)
    with torch.inference_mode():
        model(x, t)  # warm: the kernels' first build and load stay out of the trace
        seen = []
        for i in range(4):
            logdir = tmp_path / f"trace{i}"
            with profiler_trace(str(logdir)):
                model(x, t)
            (name,) = os.listdir(logdir)
            seen.append(_trace_kernel_events(logdir / name))
            assert seen[-1][0] <= 45 and seen[-1][1] <= 5, seen
            if seen[-1] == (45, 5):
                break
    assert seen[-1] == (45, 5), seen


def test_nan_debugging_over_the_kernels(card):
    """A bf16 train step at batch 8 under ``nan_debugging`` finishes with
    finite params and grads; with a NaN put into the head's GroupNorm scale
    after the forward, the backward raises naming the GN kernel's
    ``autograd.Function``."""
    from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
    from ddpm_diffusion_model_tpu_torch.training import (TrainConfig, init_train_state,
                                                         make_train_step)
    from ddpm_diffusion_model_tpu_torch.utils.debugging import (assert_tree_finite,
                                                                nan_debugging)

    torch.manual_seed(3)
    model = UNetDenoiser(UNetConfig(**SMALL), device=card).to(memory_format=torch.channels_last)
    sched = make_schedule(DiffusionConfig(T=100, img_size=10), device=card)
    cfg = TrainConfig(base_lr=1e-3, warmup_steps=None)
    state, tx = init_train_state(model, cfg)
    step = make_train_step(model, sched, tx, cfg)
    x = torch.rand(8, 10, 10, 3, device=card) * 2 - 1
    prev = torch.is_anomaly_enabled()
    with nan_debugging():
        state, m = step(state, x)
        torch.cuda.synchronize()
        params = dict(model.named_parameters())
        assert_tree_finite(params, "params")
        assert_tree_finite({k: p.grad for k, p in params.items()}, "grads")
        assert np.isfinite(float(m["loss"]))

        def poison(*_):
            model.out_norm.weight.data[0] = float("nan")

        hook = model.register_forward_hook(poison)
        try:
            with pytest.raises(RuntimeError, match="Function '_GNSiLUBackward' returned nan"):
                step(state, x)
        finally:
            hook.remove()
    assert torch.is_anomaly_enabled() == prev


# --------------------------------------------- the fused update (adamw_ema.cu)

# the configurations of test_optimizer_and_ema_match_optax (test_torch_training.py)
UPDATE_CFGS = {"clip": dict(grad_clip=1.0),
               "noclip_wd": dict(grad_clip=100.0, weight_decay=0.01),
               "noclip_nowarmup": dict(grad_clip=None, warmup_steps=None),
               "bf16_mu": dict(grad_clip=1.0, moment_dtype="bfloat16")}
UPDATE_OPS = ("adamw", "grad_norm", "ema_lerp")


def _update_params(dev):
    """Sizes 1, 3 and 4k+1, a channels_last conv weight, and one tensor of
    more than 2**26 elements (many chunks, a ragged last one)."""
    gen = torch.Generator(dev).manual_seed(21)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    named = {"one": rand(1), "three": rand(3), "odd": rand(4 * 1001 + 1),
             "conv": rand(64, 32, 3, 3).contiguous(memory_format=torch.channels_last),
             "big": rand(2**26 + 5)}
    return {k: torch.nn.Parameter(v) for k, v in named.items()}


def _fused_run(cfg_kw, dev, plain, given=False, norms_in=None, updates=3):
    """``updates`` updates by the fused ops (or, ``plain``, their plain
    versions) from the same start and grads, each clipping by the grads'
    own norm, or by the multi-tensor norm (``given``), or by
    ``norms_in[step]``; returns (params, mu, nu, shadow, norms, launches
    per update of UPDATE_OPS)."""
    from ddpm_diffusion_model_tpu_torch.training import TrainConfig, ema_init, make_optimizer
    from ddpm_diffusion_model_tpu_torch.training.state import global_norm

    adamw = tfu.adamw_reference if plain else tfu.adamw_
    lerp = tfu.ema_lerp_reference if plain else tfu.ema_lerp_
    cfg = TrainConfig(**dict(dict(base_lr=1e-2, warmup_steps=4, ema_decay=0.9), **cfg_kw))
    named = _update_params(dev)
    params = list(named.values())
    tx = make_optimizer(cfg)
    opt, ema = tx.init(params), ema_init(named)
    norms, launches = [], []
    for step in range(updates):
        gen = torch.Generator(dev).manual_seed(100 + step)
        grads = [3 * torch.randn(p.shape, generator=gen, device=dev).contiguous(
            memory_format=torch.channels_last if p.dim() == 4 else torch.contiguous_format)
            for p in params]
        before = Counter(launch_counts)
        norm = global_norm(grads) if given else None
        if norms_in is not None:
            norm = torch.tensor(norms_in[step], dtype=torch.float32, device=dev)
        norms.append(float(adamw(tx, params, grads, opt, grad_norm=norm)))
        lerp(list(ema.values()), [p.detach() for p in params], cfg.ema_decay)
        launches.append(_since(before, *UPDATE_OPS))
    torch.cuda.synchronize()
    assert opt["count"] == opt["schedule_count"] == updates
    return ({k: p.detach().clone() for k, p in named.items()}, [m.clone() for m in opt["mu"]],
            [v.clone() for v in opt["nu"]], {k: e.clone() for k, e in ema.items()}, norms,
            launches)


@pytest.mark.parametrize("given", [False, True], ids=["own_norm", "norm_given"])
@pytest.mark.parametrize("cfg", list(UPDATE_CFGS))
def test_fused_update_matches_the_multi_tensor_sequence(card, cfg, given):
    """Three updates on the kernels against the plain multi-tensor sequence
    on the card: params, moments and shadow bit-equal where both clip by
    one norm; the norm the kernel sums itself within 1e-6 relative of the
    multi-tensor one; one update and one EMA launch per update, and the
    norm pass only where the clip needs it."""
    kw = UPDATE_CFGS[cfg]
    plain = _fused_run(kw, card, True, given)
    fused = _fused_run(kw, card, False, given)
    assert all(lc == (0, 0, 0) for lc in plain[5])
    norm_pass = int(kw["grad_clip"] is not None and not given)
    assert fused[5] == [(1, norm_pass, 1)] * 3
    np.testing.assert_allclose(fused[4], plain[4], rtol=1e-6)
    if norm_pass:
        # the clip divides by the kernel's own norm, whose last bits differ
        # from the multi-tensor one's (a bf16 moment may then round the
        # other way): the plain sequence clipped by the kernel's norms
        plain = _fused_run(kw, card, True, norms_in=fused[4])
    for a, b in zip(_flat_state(fused), _flat_state(plain)):
        assert torch.equal(a, b)


def _flat_state(run):
    params, mu, nu, shadow = run[:4]
    return ([params[k] for k in params] + [m.float() for m in mu] + list(nu)
            + [shadow[k] for k in shadow])


def test_fused_update_refuses_a_layout_it_does_not_take(card):
    """Moments or a shadow in another memory format than their weight, a
    strided view, a float64 weight: each raises before a launch."""
    from ddpm_diffusion_model_tpu_torch.training import TrainConfig, make_optimizer

    tx = make_optimizer(TrainConfig(grad_clip=1.0))

    def call(params, opt=None):
        opt = opt or tx.init(params)
        tfu.adamw_(tx, params, [torch.ones_like(p) for p in params], opt)

    w = torch.randn(8, 4, 3, 3, device=card).contiguous(memory_format=torch.channels_last)
    before = Counter(launch_counts)
    with pytest.raises(ValueError, match="strides"):
        call([w], opt=tx.init([w.contiguous()]))  # NCHW moments for an NHWC weight
    with pytest.raises(ValueError, match="not dense"):
        call([torch.randn(8, 6, device=card)[:, :4]])
    with pytest.raises(ValueError, match="float64"):
        call([torch.randn(8, device=card, dtype=torch.float64)])
    with pytest.raises(ValueError, match="strides"):
        tfu.ema_lerp_([w.contiguous()], [w], 0.9)  # an NCHW shadow
    assert _since(before, *UPDATE_OPS) == (0, 0, 0)


def test_a_train_update_on_the_card_makes_no_multi_tensor_op(card):
    """A train step of a small U-Net at grad_accum_steps 1: its update (the
    ``train.update`` span) makes one ``adamw`` launch, the norm pass its
    clip needs and one ``ema_lerp`` launch, and no ``_foreach`` op."""
    from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
    from ddpm_diffusion_model_tpu_torch.training import (TrainConfig, init_train_state,
                                                         make_train_step)

    torch.manual_seed(3)
    model = UNetDenoiser(UNetConfig(**SMALL), device=card).to(memory_format=torch.channels_last)
    sched = make_schedule(DiffusionConfig(T=100, img_size=10), device=card)
    cfg = TrainConfig(base_lr=1e-3, warmup_steps=None, grad_clip=1.0)
    state, tx = init_train_state(model, cfg)
    step = make_train_step(model, sched, tx, cfg)
    x = torch.rand(8, 10, 10, 3, device=card) * 2 - 1
    step(state, x)  # first-call set-up
    torch.cuda.synchronize()
    before = Counter(launch_counts)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, x)
        torch.cuda.synchronize()
    assert _since(before, *UPDATE_OPS) == (1, 1, 1)
    events = prof.events()
    (upd,) = [e for e in events if e.name == "train.update"]
    inside = [e.name for e in events if e.time_range.start >= upd.time_range.start
              and e.time_range.end <= upd.time_range.end]
    assert not [n for n in inside if "_foreach" in n], inside


class _TwoRankFsdp:
    """The collectives of rank 0 of a two-rank ``fsdp`` axis, played in one
    process whose twin rank holds the same gradients and metrics: an
    all-reduce doubles, the reduce-scatter hands this rank block 0 of twice
    the buffer, and the all-gather repeats this rank's blocks for the
    twin's."""

    @staticmethod
    def all_reduce(t, group=None):
        t.mul_(2)

    @staticmethod
    def reduce_scatter_tensor(out, buf, group=None):
        out.copy_(buf[:out.numel()] * 2)

    @staticmethod
    def all_gather_into_tensor(out, flat, group=None):
        out.copy_(flat.repeat(out.numel() // flat.numel()))


class _FsdpMesh:
    mesh_dim_names = ("fsdp",)
    device_type = "cuda"

    @staticmethod
    def size(dim):
        return 2

    @staticmethod
    def get_coordinate():
        return [0]

    @staticmethod
    def get_group(axis):
        return None


def _fsdp_run(dev, cfg_kw, plain, monkeypatch):
    """Three updates of a small U-Net's state placed as rank 0 of a
    two-rank FSDP axis (``parallel/sharding.py`` ``finish_update``'s
    sharded branch, over :class:`_TwoRankFsdp`), by the fused ops or
    (``plain``) their plain versions; returns (the model's weights, this
    rank's moment and shadow shards, the norms, launches per update)."""
    from ddpm_diffusion_model_tpu_torch.parallel import sharding
    from ddpm_diffusion_model_tpu_torch.training import TrainConfig, init_train_state
    from ddpm_diffusion_model_tpu_torch.training.step import _finish_update

    monkeypatch.setattr(sharding, "dist", _TwoRankFsdp)
    monkeypatch.setattr(sharding, "world_size", lambda: 2)
    torch.manual_seed(5)
    model = UNetDenoiser(UNetConfig(**SMALL), device=dev).to(memory_format=torch.channels_last)
    cfg = TrainConfig(**dict(dict(base_lr=1e-2, warmup_steps=None, ema_decay=0.9), **cfg_kw))
    state, tx = init_train_state(model, cfg)
    named = dict(model.named_parameters())
    mesh = _FsdpMesh()
    specs = {n: sharding._sharded_dim(sharding.fsdp_leaf_spec(p, mesh)) for n, p in named.items()}
    assert sum(d is not None for d in specs.values()) > len(specs) // 2
    placement = sharding.StatePlacement(mesh=mesh, fsdp=True, specs=specs,
                                        shapes={n: p.shape for n, p in named.items()},
                                        batch=None)

    def cut(n, t):
        return t if specs[n] is None else sharding._local_shard(t, specs[n], 2, 0)

    names = list(named)
    state.opt_state["mu"] = [cut(n, m) for n, m in zip(names, state.opt_state["mu"])]
    state.opt_state["nu"] = [cut(n, v) for n, v in zip(names, state.opt_state["nu"])]
    state.ema_params = {n: cut(n, e) for n, e in state.ema_params.items()}
    state.placement = placement
    norms, launches = [], []
    with (_plain_path() if plain else contextlib.nullcontext()):
        for step in range(3):
            gen = torch.Generator(dev).manual_seed(200 + step)
            for p in named.values():
                p.grad = torch.randn(p.shape, generator=gen, device=dev).contiguous(
                    memory_format=torch.channels_last if p.dim() == 4
                    else torch.contiguous_format)
            before = Counter(launch_counts)
            norm, _ = _finish_update(state, tx, list(named.values()))
            norms.append(float(norm))
            launches.append(_since(before, *UPDATE_OPS))
    torch.cuda.synchronize()
    return ([p.detach().clone() for p in named.values()],
            [t.float() for t in state.opt_state["mu"] + state.opt_state["nu"]]
            + list(state.ema_params.values()), norms, launches)


@pytest.mark.parametrize("cfg", ["clip", "noclip_wd", "bf16_mu"])
def test_fused_update_on_fsdp_shards_matches_the_multi_tensor_sequence(card, cfg, monkeypatch):
    """The FSDP branch of the placed update on the card: the norm given
    from the shards, the kernels on the dense copies of this rank's blocks
    (channels_last conv weights cut along their largest dimension), the
    copies gathered into the model.  Weights, moment and shadow shards
    bit-equal to the same branch on the plain sequence, the norms equal;
    one update and one EMA launch per update and no norm pass."""
    kw = UPDATE_CFGS[cfg]
    plain = _fsdp_run(card, kw, True, monkeypatch)
    fused = _fsdp_run(card, kw, False, monkeypatch)
    assert plain[3] == [(0, 0, 0)] * 3 and fused[3] == [(1, 0, 1)] * 3
    assert fused[2] == plain[2]
    for a, b in zip(fused[0] + fused[1], plain[0] + plain[1]):
        assert torch.equal(a, b)
