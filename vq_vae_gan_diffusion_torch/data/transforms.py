"""Image transforms with torchvision's semantics, PIL-backed (the port's own
copy of the JAX package's ``data/transforms.py``).

- MNIST: Resize -> Grayscale -> ToTensor -> Normalize((0.5,), (0.5,));
- CIFAR-10: Resize -> ToTensor -> Normalize((0.1307,), (0.3081,));
- the folder datasets (Oxford102, InterHand26M), train split: Resize ->
  HFlip(0.2) -> VFlip(0.2) -> RandomApply(rotation within 25 degrees, 0.3)
  -> ToTensor -> Normalize(the config's mean and std).

Resizes and rotations go through PIL bilinear, as torchvision's do. Outputs
are float32 HWC in normalised space.
"""

from __future__ import annotations

from typing import Optional, Sequence

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


def random_flips_and_rotation(img: np.ndarray, rng: np.random.Generator,
                              p_hflip: float = 0.2, p_vflip: float = 0.2,
                              p_rot: float = 0.3, max_deg: float = 25.0) -> np.ndarray:
    """The folder datasets' train-time augmentation, its draws from ``rng`` in
    this order: a horizontal flip, a vertical flip, then a bilinear rotation
    by U(-max_deg, max_deg) degrees (the angle drawn only when it applies)."""
    if rng.random() < p_hflip:
        img = img[:, ::-1]
    if rng.random() < p_vflip:
        img = img[::-1]
    if rng.random() < p_rot:
        deg = rng.uniform(-max_deg, max_deg)
        pil = Image.fromarray(np.ascontiguousarray(img))
        img = np.asarray(pil.rotate(deg, resample=Image.BILINEAR))
    return np.ascontiguousarray(img)


class Preprocessor:
    """A sample's transform: resize -> [grayscale] -> [augment] -> to_float
    -> normalize. The augmentation runs only when ``augment`` is set and the
    call is given a generator."""

    def __init__(self, img_size: int, mean: Sequence[float], std: Sequence[float],
                 augment: bool = False, grayscale: bool = False):
        self.img_size = img_size
        self.mean = tuple(mean)
        self.std = tuple(std)
        self.augment = augment
        self.grayscale = grayscale

    def __call__(self, img: np.ndarray, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        img = resize(img, self.img_size)
        if self.grayscale and img.shape[-1] != 1:
            # ITU-R 601-2 luma, as torchvision's Grayscale
            img = (img @ np.array([0.299, 0.587, 0.114], np.float32))[..., None].astype(img.dtype)
        if self.augment and rng is not None:
            img = random_flips_and_rotation(img, rng)
        img = to_float(img)
        mean, std = self.mean, self.std
        if len(mean) != img.shape[-1]:
            mean = (mean[0],) * img.shape[-1]
            std = (std[0],) * img.shape[-1]
        return normalize(img, mean, std)
