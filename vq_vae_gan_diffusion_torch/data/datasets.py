"""Dataset readers (the port's own copy of the JAX package's
``data/datasets.py``, the readers the MNIST config needs).

- :class:`MNISTDataset`: IDX(.gz) files on disk, in the layout torchvision
  caches under ``MNIST/raw``;
- :class:`SyntheticDataset`: deterministic procedural images, what runs
  where no data is on disk (the same images as the JAX package's).

Readers return HWC uint8 images; transforms and normalisation live in
:mod:`.transforms`. The CIFAR-10, Oxford102 and InterHand26M readers are
not ported yet (ROADMAP.md, A5).
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Sequence

import numpy as np


class ArrayDataset:
    """Base: images as HWC uint8 arrays plus optional integer labels."""

    def __len__(self) -> int:
        raise NotImplementedError

    def get_image(self, idx: int) -> np.ndarray:
        raise NotImplementedError

    def get_label(self, idx: int) -> int:
        return 0


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    zero, dtype_code, ndim = struct.unpack(">HBB", data[:4])
    if zero != 0:
        raise ValueError(f"{path}: not an IDX file")
    dims = struct.unpack(">" + "I" * ndim, data[4:4 + 4 * ndim])
    dtype = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16, 0x0C: np.int32,
             0x0D: np.float32, 0x0E: np.float64}[dtype_code]
    arr = np.frombuffer(data, dtype=np.dtype(dtype).newbyteorder(">"), offset=4 + 4 * ndim)
    return arr.reshape(dims).astype(dtype)


def _find_idx_file(root: str, names: Sequence[str]) -> Optional[str]:
    for sub in ("", "MNIST/raw", "mnist", "raw"):
        for name in names:
            for suffix in ("", ".gz"):
                p = os.path.join(root, sub, name + suffix)
                if os.path.exists(p):
                    return p
    return None


class MNISTDataset(ArrayDataset):
    def __init__(self, root: str = "data", train: bool = True):
        img_name = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
        lbl_name = "train-labels-idx1-ubyte" if train else "t10k-labels-idx1-ubyte"
        img_path = _find_idx_file(root, [img_name])
        lbl_path = _find_idx_file(root, [lbl_name])
        if img_path is None:
            raise FileNotFoundError(
                f"MNIST IDX files not found under {root!r}; place "
                f"{img_name}[.gz] there (torchvision's MNIST/raw layout works)")
        self.images = _read_idx(img_path)  # [N, 28, 28] uint8
        self.labels = (_read_idx(lbl_path) if lbl_path
                       else np.zeros(len(self.images), np.int64))

    def __len__(self) -> int:
        return len(self.images)

    def get_image(self, idx: int) -> np.ndarray:
        return self.images[idx][..., None]  # HW1

    def get_label(self, idx: int) -> int:
        return int(self.labels[idx])


class SyntheticDataset(ArrayDataset):
    """Deterministic procedural images: three gaussian blobs and a gradient
    an image, from a numpy generator seeded by (seed, index)."""

    def __init__(self, num_samples: int = 256, img_size: int = 32, channels: int = 3,
                 seed: int = 0):
        self.n = num_samples
        self.size = img_size
        self.channels = channels
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def get_image(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        s, c = self.size, self.channels
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        img = np.zeros((s, s, c), np.float32)
        for _ in range(3):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            sig = rng.uniform(0.05, 0.25)
            blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sig ** 2))
            col = rng.uniform(0.2, 1.0, c).astype(np.float32)
            img += blob[..., None] * col
        img += 0.2 * (xx + yy)[..., None]
        img = np.clip(img / img.max(), 0, 1)
        return (img * 255).astype(np.uint8)

    def get_label(self, idx: int) -> int:
        return idx % 10
