"""The port's image grid and PNG encoding, presets and device resolution
against the JAX package."""

import io

import numpy as np
import pytest
import torch

from ddpm_diffusion_model_tpu.utils import config as jax_config
from ddpm_diffusion_model_tpu.utils import images as jax_images
from ddpm_diffusion_model_tpu_torch.utils import config, images
from ddpm_diffusion_model_tpu_torch.utils.device import resolve_device


@pytest.mark.parametrize("n,nrow,padding", [(1, None, 2), (4, None, 2), (5, None, 0),
                                            (9, 3, 2), (7, 2, 1)])
def test_make_grid_matches_jax(n, nrow, padding):
    x = np.random.default_rng(n).random((n, 6, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(images.make_grid(x, nrow=nrow, padding=padding),
                                  jax_images.make_grid(x, nrow=nrow, padding=padding))


def test_png_encoding_matches_jax_save_image(tmp_path):
    from PIL import Image

    grid = images.make_grid(np.random.default_rng(0).random((4, 8, 8, 3)))
    jax_images.save_image(grid, str(tmp_path / "jax.png"))
    ours = np.asarray(Image.open(io.BytesIO(images.encode_png(grid))))
    np.testing.assert_array_equal(ours, np.asarray(Image.open(tmp_path / "jax.png")))
    images.save_image_grid(np.zeros((2, 4, 4, 1)), str(tmp_path / "sub" / "g.png"))
    assert (tmp_path / "sub" / "g.png").exists()


@pytest.mark.parametrize("name", ["celeba64_low", "celeba64_attn", "celebahq256"])
def test_presets_match_jax(name):
    ours, theirs = config.get_preset(name), jax_config.get_preset(name)
    assert ours.model.to_dict() == theirs.model.to_dict()
    assert ours.diffusion.to_dict() == theirs.diffusion.to_dict()
    assert ours.img_size == theirs.img_size
    assert ours.train.to_dict() == theirs.train.to_dict()
    assert (ours.batch_size, ours.remat) == (theirs.batch_size, theirs.remat)
    back = config.preset_from_experiment(theirs.to_dict())
    assert back == ours


def test_unknown_preset_and_unported_family():
    with pytest.raises(KeyError, match="unknown preset"):
        config.get_preset("celeba64_nope")
    with pytest.raises(NotImplementedError, match="family dit"):
        config.get_preset("celeba64_dit_s4")
    exp = jax_config.get_preset("celeba64_dit_s4").to_dict()
    with pytest.raises(NotImplementedError, match="not ported"):
        config.preset_from_experiment(exp)


def test_resolve_device_never_falls_back():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device("meta").type == "meta"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()


@pytest.mark.parametrize("size", [None, 16, 7])
@pytest.mark.parametrize("grayscale", [False, True], ids=["rgb", "gray"])
@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
def test_load_image_equals_jax(tmp_path, size, grayscale, fmt):
    """``load_image`` (the CLI's ``--init``/``--mask`` and ``/edit``'s
    decoder): center crop, bilinear resize, [0, 1] float32, C = 1 for masks;
    from a path and from a file-like object, equal to JAX's bit for bit."""
    from PIL import Image

    arr = (np.random.default_rng(3).random((21, 30, 3)) * 255).astype(np.uint8)
    path = tmp_path / f"x.{fmt.lower()}"
    Image.fromarray(arr).save(path, format=fmt)
    got = images.load_image(str(path), size=size, grayscale=grayscale)
    want = jax_images.load_image(str(path), size=size, grayscale=grayscale)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[-1] == (1 if grayscale else 3)
    np.testing.assert_array_equal(got, want)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(
            images.load_image(io.BytesIO(f.read()), size=size, grayscale=grayscale), want)
