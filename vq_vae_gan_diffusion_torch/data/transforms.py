"""Image transforms with torchvision's semantics, PIL-backed (the port's own
copy of the JAX package's ``data/transforms.py``).

MNIST: Resize -> Grayscale -> ToTensor -> Normalize((0.5,), (0.5,)). Resizes
go through PIL bilinear, as torchvision's do. Outputs are float32 HWC in
normalised space. The folder datasets' flips and rotation come with their
readers (ROADMAP.md, A5).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from PIL import Image


def resize(img: np.ndarray, size: int) -> np.ndarray:
    """PIL bilinear resize to (size, size); no-op when already that size."""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    squeeze = img.ndim == 3 and img.shape[2] == 1
    pil = Image.fromarray(img[..., 0] if squeeze else img)
    out = np.asarray(pil.resize((size, size), Image.BILINEAR))
    return out[..., None] if squeeze else out


def to_float(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC in [0, 1] (ToTensor without the CHW permute)."""
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def normalize(img: np.ndarray, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    mean = np.asarray(mean, np.float32).reshape(1, 1, -1)
    std = np.asarray(std, np.float32).reshape(1, 1, -1)
    return (img - mean) / std


class Preprocessor:
    """A sample's transform: resize -> [grayscale] -> to_float -> normalize."""

    def __init__(self, img_size: int, mean: Sequence[float], std: Sequence[float],
                 grayscale: bool = False):
        self.img_size = img_size
        self.mean = tuple(mean)
        self.std = tuple(std)
        self.grayscale = grayscale

    def __call__(self, img: np.ndarray) -> np.ndarray:
        img = resize(img, self.img_size)
        if self.grayscale and img.shape[-1] != 1:
            # ITU-R 601-2 luma, as torchvision's Grayscale
            img = (img @ np.array([0.299, 0.587, 0.114], np.float32))[..., None].astype(img.dtype)
        img = to_float(img)
        mean, std = self.mean, self.std
        if len(mean) != img.shape[-1]:
            mean = (mean[0],) * img.shape[-1]
            std = (std[0],) * img.shape[-1]
        return normalize(img, mean, std)
