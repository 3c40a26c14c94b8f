"""Host data pipeline (the port's own copy of the JAX package's
``data/pipeline.py``): ``load_dataloader(name, split, logger, config)``
returns a :class:`DataLoader` of float32 NHWC numpy batches.

As the JAX package's:

- the batch size from the ``batch_size[model][dataset]`` table;
- MNIST: 4000 train / 1000 val samples, the train split shuffled with its
  last short batch dropped;
- CIFAR-10, Oxford102 and InterHand26M: with ``dataset.subset``, 10 x batch
  train / 4 x batch val samples; the folder datasets' train split
  augmented (flips and rotation), each sample from a numpy generator
  seeded by (seed, epoch, index), the epoch counted from 1;
- where the dataset is not on disk, a warning and :class:`SyntheticDataset`
  of 64 (train) or 16 (val) x max(1, batch // 8) images, or the config's
  ``max_{train,val}_samples``.

With ``dataset.use_native_loader``, the split is decoded once into a sample
store under ``dataset.cache_dir`` (default ``cache``) and served by the C++
prefetcher of :mod:`.native_loader` (the folder datasets' train split with
the same flips and rotation, drawn in C++). Unlike the JAX package, which
falls back to the Python loader with a warning on any error there, the port
raises: once the key is set, the native loader serves or nothing does.

There is no device prefetch and no device-resident dataset cache: the
training loop copies each batch to the device as it takes it.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from ..config import Config, resolve_batch_size, resolve_img_channels, resolve_img_size
from .datasets import (ArrayDataset, CIFAR10Dataset, InterHand26MDataset, MNISTDataset,
                       OxfordFlowersDataset, SyntheticDataset)
from .transforms import Preprocessor

log = logging.getLogger(__name__)


class DataLoader:
    """Epoch iterator over an ArrayDataset: each pass shuffles with a fresh
    per-epoch seed (when ``shuffle``), decodes samples on a thread pool and
    yields float32 NHWC batches."""

    def __init__(self, dataset: ArrayDataset, batch_size: int, preprocess: Preprocessor,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                 num_threads: int = 4, max_samples: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.preprocess = preprocess
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = max(1, num_threads)
        n = len(dataset)
        self.n = min(n, max_samples) if max_samples else n
        self._epoch = 0

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[np.ndarray]:
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1

        def fetch(i: int) -> np.ndarray:
            rng = np.random.default_rng((self.seed, self._epoch, int(i)))
            return self.preprocess(self.dataset.get_image(int(i)), rng)

        with ThreadPoolExecutor(self.num_threads) as pool:
            for start in range(0, self.n, self.batch_size):
                idxs = order[start:start + self.batch_size]
                if len(idxs) < self.batch_size and self.drop_last:
                    break
                yield np.stack(list(pool.map(fetch, idxs)))


def load_dataloader(name: Optional[str] = None, split: str = "train",
                    logger: Optional[logging.Logger] = None,
                    config: Optional[Config] = None, seed: int = 0):
    """(DataLoader, dataset) for ``split`` of dataset ``name`` (default: the
    config's)."""
    if config is None:
        raise ValueError("load_dataloader needs a config")
    logger = logger or log
    name = name or config.dataset.dataset_name
    img_size = resolve_img_size(config)
    channels = resolve_img_channels(config)
    batch_size = resolve_batch_size(config)
    num_threads = int(config.trainer.get("num_workers", 4) or 1)
    mean, std = list(config.dataset.mean), list(config.dataset.std)
    subset = bool(config.dataset.get("subset", False))
    train = split == "train"
    root = config.dataset.get("data_root", "data")

    max_samples = None
    try:
        if name == "mnist":
            dataset = MNISTDataset(root, train=train)
            prep = Preprocessor(img_size, (0.5,), (0.5,), grayscale=True)
            max_samples = 4000 if train else 1000
        elif name == "cifar10":
            dataset = CIFAR10Dataset(root, train=train)
            prep = Preprocessor(img_size, (0.1307,), (0.3081,))
        elif name in ("Oxford102Flower", "InterHand26M"):
            reader = OxfordFlowersDataset if name == "Oxford102Flower" else InterHand26MDataset
            dataset = reader(root, split)
            prep = Preprocessor(img_size, mean, std, augment=train)
        elif name == "synthetic":
            raise FileNotFoundError("synthetic requested explicitly")
        else:
            raise ValueError(f"unknown dataset {name!r}")
        if subset and name != "mnist":
            max_samples = 10 * batch_size if train else 4 * batch_size
    except FileNotFoundError as e:
        if name != "synthetic":
            logger.warning("dataset %s unavailable (%s); using synthetic fallback", name, e)
        n = 64 * max(1, batch_size // 8) if train else 16 * max(1, batch_size // 8)
        ms = config.dataset.get("max_train_samples" if train else "max_val_samples")
        if isinstance(ms, (int, float)) and np.isfinite(ms):
            n = int(ms)
        dataset = SyntheticDataset(num_samples=max(n, batch_size), img_size=img_size,
                                   channels=channels, seed=seed)
        prep = Preprocessor(img_size, mean[:channels] or [0.5], std[:channels] or [0.5],
                            grayscale=channels == 1)

    cfg_max = config.dataset.get("max_train_samples" if train else "max_val_samples")
    if isinstance(cfg_max, (int, float)) and np.isfinite(cfg_max):
        max_samples = min(int(cfg_max), max_samples or int(cfg_max))
    shuffle = bool(config.dataset.get("train_shuffle", True)) if train else False
    if bool(config.dataset.get("use_native_loader", False)):
        return _native_loader(config, name, split, dataset, prep, batch_size, shuffle, train,
                              seed, max_samples, logger), dataset
    loader = DataLoader(dataset, batch_size, prep, shuffle=shuffle, drop_last=train, seed=seed,
                        num_threads=num_threads, max_samples=max_samples)
    logger.info("Number of %s samples: %d (batch %d, %d batches)",
                split, loader.n, batch_size, len(loader))
    return loader, dataset


def _native_loader(config: Config, name: str, split: str, dataset: ArrayDataset,
                   prep: Preprocessor, batch_size: int, shuffle: bool, train: bool, seed: int,
                   max_samples: Optional[int], logger: logging.Logger):
    """The JAX package's native route: the store
    ``{cache_dir}/{name}_{split}_{img_size}{_g}_n{len}.sdb``, built where it
    is missing (its name holds the dataset's length, so a store of another
    instantiation is never reused), and a :class:`.native_loader.NativeDataLoader`
    over it with the Python loader's recipe, shuffle, ``drop_last`` and
    ``max_samples``."""
    from .native_loader import NativeDataLoader, build_sample_store

    g = "_g" if prep.grayscale else ""
    cache = os.path.join(str(config.dataset.get("cache_dir", "cache")),
                         f"{name}_{split}_{prep.img_size}{g}_n{len(dataset)}.sdb")
    if not os.path.exists(cache):
        logger.info("building native sample store %s", cache)
        build_sample_store(dataset, cache, img_size=prep.img_size, grayscale=prep.grayscale)
    # transforms.random_flips_and_rotation's defaults
    aug = dict(p_hflip=0.2, p_vflip=0.2, p_rot=0.3, max_deg=25.0) if prep.augment else {}
    loader = NativeDataLoader(cache, batch_size, mean=prep.mean, std=prep.std, shuffle=shuffle,
                              drop_last=train, seed=seed, max_samples=max_samples, **aug)
    logger.info("native loader: %d %s samples (%d batches)%s", loader.n, split, len(loader),
                " [native augmentation]" if prep.augment else "")
    return loader
