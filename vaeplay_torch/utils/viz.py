"""Image-grid writer -- the port's own copy of vaeplay_tpu/utils/viz.py
(replaces the reference's torchvision.utils.save_image with a PIL writer)."""

import os

import numpy as np
from PIL import Image


def makedirs(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)


def save_image_grid(
    images: np.ndarray,  # (N, H, W, C) floats in [0, 1], C in {1, 3}
    path: str,
    nrow: int = 8,
    padding: int = 2,
    pad_value: float = 1.0,
) -> None:
    """vutils.save_image-compatible grid layout (nrow = images per row)."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    if c == 1:
        images = np.repeat(images, 3, axis=-1)
        c = 3
    ncol = (n + nrow - 1) // nrow
    grid = np.full(
        (ncol * (h + padding) + padding, nrow * (w + padding) + padding, c),
        pad_value, dtype=np.float32,
    )
    for idx in range(n):
        r, col = divmod(idx, nrow)
        y0 = r * (h + padding) + padding
        x0 = col * (w + padding) + padding
        grid[y0 : y0 + h, x0 : x0 + w] = images[idx]
    makedirs(os.path.dirname(path) or ".")
    Image.fromarray(to_uint8(grid)).save(path)
