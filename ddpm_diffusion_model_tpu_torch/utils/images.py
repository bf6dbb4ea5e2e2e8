"""Image-grid utilities (host-side, numpy + PIL).

The port's own copy of the parts of ``ddpm_diffusion_model_tpu/utils/images.py``
that sampling, editing and serving need (``grid_nrow``, ``make_grid`` with
its ``padding``, ``save_image``, ``save_image_grid``, ``load_image``), plus
:func:`encode_png` for the server.
Arrays are NHWC float in [0, 1].
"""

from __future__ import annotations

import io
import os
from typing import Optional

import numpy as np

__all__ = ["make_grid", "save_image", "save_image_grid", "encode_png",
           "grid_nrow", "load_image"]


def grid_nrow(n: int) -> int:
    """Images per row of an n-image grid: ceil(sqrt(n)) (the reference's
    int(sqrt(n)) for perfect squares, ceil otherwise)."""
    return int(np.ceil(np.sqrt(max(1, int(n)))))


def load_image(path, size: Optional[int] = None, *, grayscale: bool = False) -> np.ndarray:
    """Read a PNG/JPEG (path or file-like object) into an (H, W, C) float32
    array in [0, 1].  ``size``: center-crop to a square, then a bilinear
    resize to (size, size), the data transforms' geometry.  ``grayscale``
    gives C = 1 (masks)."""
    from PIL import Image

    img = Image.open(path)
    img = img.convert("L" if grayscale else "RGB")
    if size is not None:
        w, h = img.size
        side = min(w, h)
        left, top = (w - side) // 2, (h - side) // 2
        img = img.crop((left, top, left + side, top + side))
        img = img.resize((int(size), int(size)), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def make_grid(images: np.ndarray, nrow: Optional[int] = None,
              padding: int = 2, pad_value: float = 0.0) -> np.ndarray:
    """Tile (N, H, W, C) images into one (H', W', C) grid, torchvision
    style; ``nrow`` images per row, default ceil(sqrt(N))."""
    x = np.asarray(images, dtype=np.float32)
    if x.ndim != 4:
        raise ValueError(f"expected (N,H,W,C), got {x.shape}")
    n, h, w, c = x.shape
    if nrow is None:
        r = int(np.sqrt(n))
        nrow = r if r * r == n else int(np.ceil(np.sqrt(n)))
    nrow = max(1, int(nrow))
    ncol = int(np.ceil(n / nrow))

    grid = np.full(
        (ncol * h + (ncol + 1) * padding, nrow * w + (nrow + 1) * padding, c),
        pad_value, dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y0 = padding + r * (h + padding)
        x0 = padding + col * (w + padding)
        grid[y0:y0 + h, x0:x0 + w] = x[i]
    return grid


def _to_uint8(image: np.ndarray) -> np.ndarray:
    arr = np.clip(np.asarray(image) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    return arr


def encode_png(image: np.ndarray) -> bytes:
    """One (H, W, C) or (H, W) float [0, 1] array as PNG bytes."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(_to_uint8(image)).save(buf, format="PNG")
    return buf.getvalue()


def save_image(image: np.ndarray, path: str) -> None:
    """Write one (H, W, C) or (H, W) float [0, 1] array as PNG."""
    dirpath = os.path.dirname(path)
    if dirpath:
        os.makedirs(dirpath, exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(image))


def save_image_grid(images: np.ndarray, path: str, nrow: Optional[int] = None,
                    padding: int = 2) -> np.ndarray:
    """Grid + save in one call."""
    grid = make_grid(images, nrow=nrow, padding=padding)
    save_image(grid, path)
    return grid
