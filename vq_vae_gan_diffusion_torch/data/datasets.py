"""Dataset readers (the port's own copy of the JAX package's
``data/datasets.py``).

- :class:`MNISTDataset`: IDX(.gz) files on disk, in the layout torchvision
  caches under ``MNIST/raw``;
- :class:`CIFAR10Dataset`: the python pickle batches of
  ``cifar-10-batches-py``;
- :class:`OxfordFlowersDataset`: ``root/<split>/<class>/*.jpg`` class
  folders, or a flat folder of images;
- :class:`InterHand26MDataset`: COCO-annotated hand crops (the bbox with a
  15 px margin, zero-padded to a square; a sample that fails to load is
  replaced by the next index's);
- :class:`SyntheticDataset`: deterministic procedural images, what runs
  where no data is on disk (the same images as the JAX package's).

Readers return HWC uint8 images; transforms and normalisation live in
:mod:`.transforms`. Images are decoded with PIL (``convert("RGB")``); the
JAX package decodes InterHand26M with OpenCV, which gives the same arrays
for PNG files.
"""

from __future__ import annotations

import gzip
import json
import logging
import os
import pickle
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp")


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


class CIFAR10Dataset(ArrayDataset):
    """The five ``data_batch_<i>`` files (train) or ``test_batch`` (val) under
    ``root/cifar-10-batches-py``, ``root`` or ``root/cifar10``."""

    def __init__(self, root: str = "data", train: bool = True):
        base = None
        for sub in ("cifar-10-batches-py", "", "cifar10"):
            p = os.path.join(root, sub)
            if os.path.exists(os.path.join(p, "data_batch_1")) or \
                    os.path.exists(os.path.join(p, "test_batch")):
                base = p
                break
        if base is None:
            raise FileNotFoundError(f"cifar-10-batches-py not found under {root!r}")
        files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        imgs, labels = [], []
        for fname in files:
            with open(os.path.join(base, fname), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            imgs.append(d[b"data"])
            labels.extend(d[b"labels"])
        data = np.concatenate(imgs).reshape(-1, 3, 32, 32)
        self.images = np.transpose(data, (0, 2, 3, 1)).astype(np.uint8)  # NHWC
        self.labels = np.asarray(labels, np.int64)

    def __len__(self) -> int:
        return len(self.images)

    def get_image(self, idx: int) -> np.ndarray:
        return self.images[idx]

    def get_label(self, idx: int) -> int:
        return int(self.labels[idx])


def _read_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class OxfordFlowersDataset(ArrayDataset):
    """``root/split/<class_name>/*`` (classes sorted, files sorted, only image
    extensions), or a flat folder of images (``root/split`` or ``root``)."""

    def __init__(self, root: str, split: str = "train"):
        split_dir = os.path.join(root, split)
        if not os.path.isdir(split_dir):
            split_dir = root
        if not os.path.isdir(split_dir):
            raise FileNotFoundError(f"dataset dir {split_dir!r} does not exist")
        self.classes = sorted(d for d in os.listdir(split_dir)
                              if os.path.isdir(os.path.join(split_dir, d)))
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[str, int]] = []
        if self.classes:
            for c in self.classes:
                cdir = os.path.join(split_dir, c)
                for fname in sorted(os.listdir(cdir)):
                    if fname.lower().endswith(IMG_EXTENSIONS):
                        self.samples.append((os.path.join(cdir, fname), self.class_to_idx[c]))
        else:
            for fname in sorted(os.listdir(split_dir)):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(split_dir, fname), 0))

    def __len__(self) -> int:
        return len(self.samples)

    def get_image(self, idx: int) -> np.ndarray:
        return _read_rgb(self.samples[idx][0])

    def get_label(self, idx: int) -> int:
        return self.samples[idx][1]


class InterHand26MDataset(ArrayDataset):
    """One sample a COCO annotation with a ``bbox``: the image cropped to the
    bbox widened by ``MARGIN`` px (clipped to the image), centred on a
    zero-padded square. A sample that fails to load logs a warning and
    gives the next index's image instead."""

    MARGIN = 15

    def __init__(self, root: str, split: str = "train", annotation_file: Optional[str] = None):
        ann = annotation_file
        if ann is None:
            for cand in (os.path.join(root, "annotations", split,
                                      f"InterHand2.6M_{split}_data.json"),
                         os.path.join(root, "annotations", f"{split}.json"),
                         os.path.join(root, f"{split}.json")):
                if os.path.exists(cand):
                    ann = cand
                    break
        if ann is None or not os.path.exists(ann):
            raise FileNotFoundError(f"InterHand26M annotations not found under {root!r}")
        with open(ann) as f:
            coco = json.load(f)
        images_by_id = {im["id"]: im for im in coco.get("images", [])}
        self.root, self.split = root, split
        self.entries: List[Tuple[str, Tuple[float, float, float, float]]] = []
        for a in coco.get("annotations", []):
            im = images_by_id.get(a.get("image_id"))
            if im is None or "bbox" not in a:
                continue
            self.entries.append((im["file_name"], tuple(a["bbox"])))

    def __len__(self) -> int:
        return len(self.entries)

    def _load(self, idx: int) -> np.ndarray:
        fname, (x, y, w, h) = self.entries[idx]
        for base in (os.path.join(self.root, "images", self.split),
                     os.path.join(self.root, "images"), self.root):
            path = os.path.join(base, fname)
            if os.path.exists(path):
                break
        img = _read_rgb(path)
        H, W = img.shape[:2]
        m = self.MARGIN
        x0, y0 = max(int(x) - m, 0), max(int(y) - m, 0)
        x1, y1 = min(int(x + w) + m, W), min(int(y + h) + m, H)
        crop = img[y0:y1, x0:x1]
        ch, cw = crop.shape[:2]
        side = max(ch, cw)
        out = np.zeros((side, side, 3), np.uint8)
        out[(side - ch) // 2:(side - ch) // 2 + ch, (side - cw) // 2:(side - cw) // 2 + cw] = crop
        return out

    def get_image(self, idx: int) -> np.ndarray:
        try:
            return self._load(idx)
        except Exception as e:  # a sample that does not load: the next one instead
            log.warning("InterHand26M sample %d failed (%s); resampling", idx, e)
            return self._load((idx + 1) % len(self))


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
