"""The port's U-Net against the JAX ``UNetDenoiser(dtype=float32)`` with
carried weights (tolerance 1e-4, docs/PARITY.md), the resize branch, the
embeddings and the three presets' parameter counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_diffusion_model_tpu.models import UNetConfig as JaxUNetConfig
from ddpm_diffusion_model_tpu.models import UNetDenoiser as JaxUNet
from ddpm_diffusion_model_tpu.models import unet as jax_unet
from ddpm_diffusion_model_tpu.models.embeddings import (
    sinusoidal_time_embedding as jax_sinusoidal)
from ddpm_diffusion_model_tpu_torch.models import (
    UNetConfig, UNetDenoiser, count_params, sinusoidal_time_embedding,
    unet_64x64_config, unet_64x64_low_config, unet_256x256_config)
from ddpm_diffusion_model_tpu_torch.models.blocks import _gn_groups
from ddpm_diffusion_model_tpu_torch.utils.interop import jax_params_to_state_dict

torch.set_num_threads(1)

SMALL = dict(base_channels=32, channel_mults=(1, 2), num_res_blocks=1,
             attn_resolutions=(8,), time_embed_dim=64, num_heads=2,
             head_dim=16, img_resolution=16)


def _carried(kw, seed):
    """A JAX float32 U-Net with GroupNorm/bias params perturbed away from
    their init, and the port's U-Net holding the same weights."""
    jm = JaxUNet(JaxUNetConfig(**kw), dtype=jnp.float32)
    img = kw["img_resolution"]
    params = jax.jit(jm.init)(jax.random.key(seed),
                              jnp.ones((1, img, img, 3)), jnp.zeros((1,)))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name == "scale":
            return leaf + 0.1 * rng.normal(size=leaf.shape).astype(np.float32)
        if name == "bias":
            return 0.1 * rng.normal(size=leaf.shape).astype(np.float32)
        return leaf

    params = jax.tree_util.tree_map_with_path(perturb, params)
    port = UNetDenoiser(UNetConfig(**kw), dtype=torch.float32, device="cpu")
    port.load_state_dict(jax_params_to_state_dict(params, port.config),
                         strict=True)
    return jm, params, port.eval()


@pytest.mark.parametrize("kw", [
    SMALL,
    # img 10, mults (1,2,2): levels 10 -> 5 -> 2, so the decoder's x2
    # upsample of 2 lands on 4 and is nearest-resized to the 5x5 skip;
    # attention at 5x5 gives a ragged N = 25
    dict(SMALL, channel_mults=(1, 2, 2), attn_resolutions=(5,),
         img_resolution=10),
], ids=["img16", "img10_resize"])
def test_forward_matches_jax_fp32(kw):
    jm, params, port = _carried(kw, seed=3)
    img = kw["img_resolution"]
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, img, img, 3)).astype(np.float32)
    t = np.array([5, 77], dtype=np.int32)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_bf16_forward_close_to_fp32():
    """The bf16 compute path (fp32 params cast per call) stays near fp32:
    bf16 keeps ~3 significant digits, so 5e-2 on O(1) outputs."""
    _jm, _params, port32 = _carried(SMALL, seed=4)
    port16 = UNetDenoiser(port32.config, dtype=torch.bfloat16, device="cpu")
    port16.load_state_dict(port32.state_dict(), strict=True)
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(2, 16, 16, 3)).astype(np.float32))
    t = torch.tensor([10, 90])
    with torch.inference_mode():
        a = port32(x, t)
        b = port16.eval()(x, t)
    assert b.dtype == torch.float32 and torch.isfinite(b).all()
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=5e-2)


@pytest.mark.parametrize("make,jax_make,count", [
    (unet_64x64_config, jax_unet.unet_64x64_config, 31_312_131),
    (unet_64x64_low_config, jax_unet.unet_64x64_low_config, 12_143_427),
    (unet_256x256_config, jax_unet.unet_256x256_config, 63_100_675),
], ids=["celeba64_attn", "celeba64_low", "celebahq256"])
def test_preset_param_counts(make, jax_make, count):
    assert make().to_dict() == jax_make().to_dict()
    model = UNetDenoiser(make(), device="meta")
    assert count_params(model) == count


@pytest.mark.parametrize("dim", [64, 33])
def test_sinusoidal_embedding_matches_jax(dim):
    t = np.array([0, 1, 17, 999], dtype=np.int32)
    want = np.asarray(jax_sinusoidal(jnp.asarray(t), dim))
    got = sinusoidal_time_embedding(torch.from_numpy(t), dim).numpy()
    assert got.shape == (4, dim)
    # phases reach ~1e3 rad; one fp32 ulp there is ~6e-5, and the two
    # frameworks' exp/sin may round the last bit differently
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("channels", [96, 128, 192, 384, 48, 30])
def test_gn_groups_matches_jax(channels):
    from ddpm_diffusion_model_tpu.models.blocks import _gn_groups as jax_groups

    assert _gn_groups(channels) == jax_groups(channels)


def test_unported_configs_and_missing_card_raise():
    with pytest.raises(NotImplementedError, match="not ported"):
        UNetDenoiser(UNetConfig(**SMALL, num_classes=10), device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            UNetDenoiser(UNetConfig(**SMALL))  # default device is the card


def test_forward_keeps_channels_last_for_the_fused_norm():
    """Every GN+SiLU input reaches the fused op as contiguous NHWC (the
    wrapper raises otherwise), including after concat and resize."""
    cfg = UNetConfig(**dict(SMALL, channel_mults=(1, 2, 2),
                            attn_resolutions=(5,), img_resolution=10))
    port = UNetDenoiser(cfg, dtype=torch.float32, device="cpu").eval()
    x = torch.zeros(1, 10, 10, 3)
    with torch.inference_mode():
        out = port(x, torch.tensor([3]))
    assert out.shape == (1, 10, 10, 3) and out.is_contiguous()


# ------------------------------------------------ the encoder-cached forward


def _nhwc(f):
    """A port feature (NCHW, channels_last) as JAX's NHWC numpy array."""
    return f.permute(0, 2, 3, 1).numpy()


def _jax_features(feats):
    mid, skips = feats
    return np.array(mid), [np.array(s) for s in skips]


@pytest.mark.parametrize("kw", [
    SMALL, dict(SMALL, channel_mults=(1, 2, 2), attn_resolutions=(5,), img_resolution=10),
], ids=["img16", "img10_resize"])
def test_return_features_and_decode_match_jax_fp32(kw):
    """``return_features`` gives JAX's eps and (mid, skips) to 1e-4 (the
    features NHWC <-> NCHW); the decode forward fed JAX's features at a
    fresh t gives JAX's decode to 1e-4."""
    jm, params, port = _carried(kw, seed=5)
    img = kw["img_resolution"]
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, img, img, 3)).astype(np.float32)
    t = np.array([40, 91], dtype=np.int32)
    t2 = np.array([33, 80], dtype=np.int32)
    j_eps, j_feats = jax.jit(lambda p, x, t: jm.apply(p, x, t, return_features=True))(
        params, jnp.asarray(x), jnp.asarray(t))
    with torch.inference_mode():
        eps, (mid, skips) = port(torch.from_numpy(x), torch.from_numpy(t),
                                 return_features=True)
    j_mid, j_skips = _jax_features(j_feats)
    np.testing.assert_allclose(eps.numpy(), np.asarray(j_eps), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_nhwc(mid), j_mid, atol=1e-4, rtol=1e-4)
    assert len(skips) == len(j_skips) == len(kw["channel_mults"])
    for s, js_ in zip(skips, j_skips):
        assert s.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(_nhwc(s), js_, atol=1e-4, rtol=1e-4)

    want = jax.jit(lambda p, x, t, f: jm.apply(p, x, t, mode="decode", cached=f))(
        params, jnp.asarray(x), jnp.asarray(t2), j_feats)
    cached = (torch.from_numpy(j_mid).permute(0, 3, 1, 2),
              tuple(torch.from_numpy(s).permute(0, 3, 1, 2) for s in j_skips))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(t2), mode="decode", cached=cached)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_decode_with_its_own_features_equals_full(dtype):
    """Features of (x, t) decoded at the same t run the same ops on the same
    bits as the full forward: equal exactly.  The cache holds the compute
    dtype, and the decode forward returns the features it was given."""
    _jm, _p, port32 = _carried(SMALL, seed=6)
    port = UNetDenoiser(port32.config, dtype=dtype, device="cpu")
    port.load_state_dict(port32.state_dict(), strict=True)
    port = port.to(memory_format=torch.channels_last).eval()
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(size=(2, 16, 16, 3)).astype(np.float32))
    t = torch.tensor([7, 60])
    with torch.inference_mode():
        full = port(x, t)
        eps, feats = port(x, t, return_features=True)
        dec, feats2 = port(x, t, mode="decode", cached=feats, return_features=True)
    assert torch.equal(eps, full) and torch.equal(dec, full)
    assert feats[0].dtype == dtype and all(s.dtype == dtype for s in feats[1])
    assert torch.equal(feats2[0], feats[0])
    assert all(torch.equal(a, b) for a, b in zip(feats2[1], feats[1]))


def test_decode_casts_float32_features_to_the_compute_dtype():
    _jm, _p, port32 = _carried(SMALL, seed=7)
    port = UNetDenoiser(port32.config, dtype=torch.bfloat16, device="cpu")
    port.load_state_dict(port32.state_dict(), strict=True)
    port.eval()
    x = torch.from_numpy(np.random.default_rng(15).normal(size=(1, 16, 16, 3))
                         .astype(np.float32))
    t = torch.tensor([30])
    with torch.inference_mode():
        full, (mid, skips) = port(x, t, return_features=True)
        as32 = (mid.float(), tuple(s.float() for s in skips))
        dec = port(x, t, mode="decode", cached=as32)
    assert torch.equal(dec, full)


def test_bad_modes_raise():
    _jm, _p, port = _carried(SMALL, seed=8)
    x, t = torch.zeros(1, 16, 16, 3), torch.tensor([3])
    with torch.inference_mode():
        with pytest.raises(ValueError, match="requires cached"):
            port(x, t, mode="decode")
        with pytest.raises(ValueError, match="unknown mode 'encode'"):
            port(x, t, mode="encode")
