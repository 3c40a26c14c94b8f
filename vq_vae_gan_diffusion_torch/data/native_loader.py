"""The native sample-store loader (the port's copy of the JAX package's
``data/native_loader.py``), a ``ctypes`` binding of ``csrc/sampledb.cpp``.

The data is decoded once into a memory-mapped uint8 store; C++ threads then
gather each batch's samples, flip and rotate them where the split augments,
and normalise them to float32, so Python only hands whole NHWC batches on::

    path = build_sample_store(dataset, "cache/mnist_train.sdb", img_size=28)
    loader = NativeDataLoader(path, batch_size=200, mean=(0.5,), std=(0.5,))
    for batch in loader:          # float32 [B, H, W, C]
        ...

The library is built from ``csrc/sampledb.cpp`` with the host compiler at
first use (``ops/_build.host_library``); a failed build raises. Batches are
bit for bit those of the JAX package's ``NativeDataLoader`` on the same store
and seed, handed out in batch order with any number of threads.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
from typing import Optional, Sequence, Tuple

import numpy as np

from ..parallel.mesh import batch_rows

_MAGIC = 0x53444231334C4456

_U64P = ctypes.POINTER(ctypes.c_uint64)
_F32P = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/sampledb.cpp``'s library, built at first use, with every
    function's argument and result types set."""
    from ..ops._build import host_library

    lib = host_library("sampledb")
    f32, u64, i32, vp = ctypes.c_float, ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p
    signatures = {
        "sdb_open": (vp, [ctypes.c_char_p]),
        "sdb_close": (None, [vp]),
        "sdb_shape": (None, [vp, _U64P]),
        "sdb_gather": (None, [vp, _U64P, u64, _F32P, _F32P, u64, f32, f32, f32, f32, u64,
                              _F32P]),
        "sdb_prefetcher_create": (vp, [vp, u64, _F32P, _F32P, u64, f32, f32, f32, f32, u64,
                                       i32, i32, i32, u64]),
        "sdb_prefetcher_reset": (u64, [vp, i32]),
        "sdb_prefetcher_next": (i32, [vp, _F32P, u64]),
        "sdb_prefetcher_destroy": (None, [vp]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def build_sample_store(dataset, path: str, img_size: Optional[int] = None,
                       grayscale: bool = False) -> str:
    """Decode ``dataset`` once into the store at ``path`` (uint8 HWC samples
    after a header of magic, n, h, w, c), resized to ``img_size`` by the
    port's ``transforms.resize``; ``grayscale`` takes multi-channel images to
    the ITU-R 601-2 luma, as ``Preprocessor`` does. The file is written under
    a temporary name and moved into place, so an interrupted build leaves no
    store behind. Returns ``path``."""
    from .transforms import resize

    def prepare(img: np.ndarray) -> np.ndarray:
        if img_size is not None:
            img = resize(img, img_size)
        if grayscale and img.shape[-1] != 1:
            img = (img @ np.array([0.299, 0.587, 0.114], np.float32))
            img = np.clip(img, 0, 255)[..., None].astype(np.uint8)
        return img

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h, w, c = prepare(dataset.get_image(0)).shape
    n = len(dataset)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<5Q", _MAGIC, n, h, w, c))
        for i in range(n):
            f.write(np.ascontiguousarray(prepare(dataset.get_image(i)), np.uint8).tobytes())
    os.replace(tmp, path)
    return path


def _stats(vals: Sequence[float]):
    return (ctypes.c_float * max(len(vals), 1))(*[float(v) for v in vals]), len(vals)


class SampleStore:
    """An open store: ``n`` samples of ``h`` x ``w`` x ``c``."""

    def __init__(self, path: str):
        self.lib = _lib()
        self.handle = self.lib.sdb_open(path.encode())
        if not self.handle:
            raise OSError(f"failed to open sample store {path!r}")
        shape = (ctypes.c_uint64 * 4)()
        self.lib.sdb_shape(self.handle, shape)
        self.n, self.h, self.w, self.c = (int(shape[i]) for i in range(4))

    def gather(self, indices: np.ndarray, mean=(0.5,), std=(0.5,),
               p_hflip: float = 0.0, p_vflip: float = 0.0,
               p_rot: float = 0.0, max_deg: float = 0.0,
               seed: int = 0) -> np.ndarray:
        """The samples at ``indices``, augmented from ``seed`` and normalised:
        float32 [len(indices), h, w, c]."""
        idx = np.ascontiguousarray(indices, np.uint64)
        out = np.empty((len(idx), self.h, self.w, self.c), np.float32)
        m, cm = _stats(mean)
        s, _ = _stats(std)
        self.lib.sdb_gather(self.handle, idx.ctypes.data_as(_U64P), len(idx), m, s, cm,
                            p_hflip, p_vflip, p_rot, max_deg, seed, out.ctypes.data_as(_F32P))
        return out

    def close(self) -> None:
        if self.handle:
            self.lib.sdb_close(self.handle)
            self.handle = None


class NativeDataLoader:
    """An epoch iterator over a store, backed by the C++ prefetcher: each
    pass starts the next epoch (counted from 0), shuffled from ``seed`` and
    the epoch where ``shuffle``, over the first ``max_samples`` samples when
    given, the last short batch dropped where ``drop_last`` (else padded by
    repeating its last sample). ``num_threads`` 0 takes one a core.
    ``shard`` (r, D) yields data rank r's rows of each batch (the whole
    batch is gathered, then sliced)."""

    def __init__(self, store_path: str, batch_size: int, mean=(0.5,),
                 std=(0.5,), p_hflip: float = 0.0, p_vflip: float = 0.0,
                 p_rot: float = 0.0, max_deg: float = 0.0,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                 num_threads: int = 0, max_samples: Optional[int] = None,
                 shard: Tuple[int, int] = (0, 1)):
        self.lib = _lib()
        self.shard = shard
        self.store = SampleStore(store_path)
        self.batch_size = batch_size
        m, cm = _stats(mean)
        s, _ = _stats(std)
        limit = int(max_samples) if max_samples else 0
        self.pf = self.lib.sdb_prefetcher_create(
            self.store.handle, batch_size, m, s, cm, p_hflip, p_vflip, p_rot, max_deg, seed,
            int(shuffle), int(drop_last), num_threads, limit)
        self._epoch = 0
        self.n = min(self.store.n, limit) if limit else self.store.n
        self.drop_last = drop_last

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        nb = self.lib.sdb_prefetcher_reset(self.pf, self._epoch)
        self._epoch += 1
        st = self.store
        shape = (self.batch_size, st.h, st.w, st.c)
        for _ in range(nb):
            out = np.empty(shape, np.float32)
            if self.lib.sdb_prefetcher_next(self.pf, out.ctypes.data_as(_F32P), out.size) != 0:
                break
            yield out[batch_rows(len(out), *self.shard)] if self.shard[1] > 1 else out

    def close(self) -> None:
        if getattr(self, "pf", None):
            self.lib.sdb_prefetcher_destroy(self.pf)
            self.pf = None
        if getattr(self, "store", None) is not None:
            self.store.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
