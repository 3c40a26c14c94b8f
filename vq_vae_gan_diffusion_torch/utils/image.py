"""Image artifact helpers (counterpart of the JAX ``utils/image.py``): numpy and PIL."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def to_uint8(img: np.ndarray, mean: Sequence[float] | None = None,
             std: Sequence[float] | None = None) -> np.ndarray:
    """float NHWC/HWC (normalized) -> uint8, denormalizing when mean/std are given."""
    img = np.asarray(img, np.float32)
    if mean is not None and std is not None:
        c = img.shape[-1]
        m = np.asarray(mean, np.float32).reshape(1, 1, -1)[..., :c]
        s = np.asarray(std, np.float32).reshape(1, 1, -1)[..., :c]
        img = img * s + m
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2,
              pad_value: int = 0) -> np.ndarray:
    """[N, H, W, C] uint8 -> one grid image (torchvision ``make_grid`` layout)."""
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.full((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c),
                   pad_value, np.uint8)
    for i in range(n):
        r, col = divmod(i, ncol)
        y = r * (h + pad) + pad
        x = col * (w + pad) + pad
        grid[y:y + h, x:x + w] = images[i]
    return grid


def save_image(img: np.ndarray, path: str) -> None:
    """Write an HWC uint8 image; the format follows the file extension."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if img.shape[-1] == 1:
        img = img[..., 0]
    Image.fromarray(img).save(path)
