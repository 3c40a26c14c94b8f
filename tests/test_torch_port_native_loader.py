"""The port's native sample-store loader (``data/native_loader.py`` over
``csrc/sampledb.cpp``) and ``load_dataloader``'s ``use_native_loader`` route
against the JAX package's, on the CPU.

The JAX side's library is built from ``native/sampledb.cpp`` into a temporary
directory with ``native/Makefile``'s flags and bound there by patching its
``_lib_path``, so nothing is written under ``native/``. The port builds its
own copy at first use.

Every comparison of batches is exact, float32 bit for bit. The JAX
prefetcher hands a batch out when it is finished, so with several threads
its order varies between runs; the JAX side runs one thread, where that order
is the batch order, and the port, which keeps batch order with any number of
threads, runs its default (one a core) and one. ``gather`` lies within 1e-6
of both packages' ``Preprocessor``, as in ``tests/test_native_loader.py``.
"""

import struct
import subprocess
import sys

import numpy as np
import pytest

from test_torch_port_readers import _configs, _write_flowers
from vq_vae_gan_diffusion_torch.data import datasets as tds
from vq_vae_gan_diffusion_torch.data import load_dataloader as t_load_dataloader
from vq_vae_gan_diffusion_torch.data import native_loader as tnl
from vq_vae_gan_diffusion_torch.data.transforms import Preprocessor as TPrep
from vq_vae_gan_diffusion_torch.ops import _build
from vq_vae_gan_diffusion_tpu.data import datasets as jds
from vq_vae_gan_diffusion_tpu.data import load_dataloader as j_load_dataloader
from vq_vae_gan_diffusion_tpu.data import native_loader as jnl
from vq_vae_gan_diffusion_tpu.data.transforms import Preprocessor as JPrep

MAKEFILE_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread", "-shared"]
AUGMENT = dict(p_hflip=0.2, p_vflip=0.2, p_rot=0.3, max_deg=25.0)
STATS = dict(mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native_loader bound to a library built from
    native/sampledb.cpp in a temporary directory."""
    lib = tmp_path_factory.mktemp("jaxlib") / "libsampledb.so"
    subprocess.run([_build.host_compiler(), *MAKEFILE_FLAGS, "-o", str(lib),
                    "native/sampledb.cpp"], check=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnl, "_lib_path", lambda: str(lib))
        mp.setattr(jnl, "_LIB", None)
        assert jnl.is_available()
        yield jnl


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """A 64-sample store of 20² x 3 synthetic images resized to 16², written
    by the port, with its dataset."""
    root = tmp_path_factory.mktemp("stores")
    ds = tds.SyntheticDataset(64, 20, 3, seed=3)
    return tnl.build_sample_store(ds, str(root / "rgb.sdb"), img_size=16), ds


@pytest.mark.parametrize("grayscale", [False, True])
def test_store_is_the_jax_store(jax_native, tmp_path, grayscale):
    """The port's store file equals the JAX package's byte for byte: the same
    resize, and the grayscale store's luma."""
    got = tnl.build_sample_store(tds.SyntheticDataset(12, 20, 3, seed=5),
                                 str(tmp_path / "port.sdb"), img_size=16, grayscale=grayscale)
    want = jax_native.build_sample_store(jds.SyntheticDataset(12, 20, 3, seed=5),
                                         str(tmp_path / "jax.sdb"), img_size=16,
                                         grayscale=grayscale)
    data = open(got, "rb").read()
    assert data == open(want, "rb").read()
    assert struct.unpack("<5Q", data[:40])[1:] == (12, 16, 16, 1 if grayscale else 3)


@pytest.mark.parametrize("grayscale", [False, True])
def test_gather_matches_both_preprocessors(tmp_path, grayscale):
    """``gather`` without augmentation: within 1e-6 of the port's and the JAX
    package's ``Preprocessor`` on the dataset's images."""
    ds = tds.SyntheticDataset(8, 20, 3, seed=7)
    store = tnl.SampleStore(tnl.build_sample_store(ds, str(tmp_path / "s.sdb"), img_size=16,
                                                   grayscale=grayscale))
    c = 1 if grayscale else 3
    mean, std = (0.485, 0.456, 0.406)[:c], (0.229, 0.224, 0.225)[:c]
    assert (store.n, store.h, store.w, store.c) == (8, 16, 16, c)
    out = store.gather(np.array([5, 0, 3]), mean=mean, std=std)
    store.close()
    for prep in (TPrep(16, mean, std, grayscale=grayscale),
                 JPrep(16, mean, std, grayscale=grayscale)):
        want = np.stack([prep(ds.get_image(i)) for i in (5, 0, 3)])
        np.testing.assert_allclose(out, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("threads", [0, 1])
@pytest.mark.parametrize("seed", [1, 6])
@pytest.mark.parametrize("augment", [False, True])
def test_batches_equal_jax(jax_native, stores, augment, seed, threads):
    """Two epochs of the port's loader equal the JAX loader's bit for bit:
    shuffled from (seed, epoch) with the epoch counted from 0, augmented by
    each sample's generator; two epochs differ."""
    path, _ = stores
    kw = dict(STATS, seed=seed, **(AUGMENT if augment else {}))
    got = tnl.NativeDataLoader(path, 8, num_threads=threads, **kw)
    want = jax_native.NativeDataLoader(path, 8, num_threads=1, **kw)
    assert len(got) == len(want) == 8
    a = [b for _ in range(2) for b in got]
    b = [b for _ in range(2) for b in want]
    got.close()
    want.close()
    assert len(a) == len(b) == 16 and a[0].shape == (8, 16, 16, 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], a[8])


@pytest.mark.parametrize("drop_last", [True, False])
def test_max_samples_equal_jax(jax_native, stores, drop_last):
    """``max_samples`` cuts the epoch to the store's first samples, with the
    last short batch dropped or padded with its last sample, as JAX's."""
    path, _ = stores
    kw = dict(STATS, seed=2, max_samples=27, drop_last=drop_last, **AUGMENT)
    got = tnl.NativeDataLoader(path, 8, **kw)
    want = jax_native.NativeDataLoader(path, 8, num_threads=1, **kw)
    assert got.n == 27 and len(got) == len(want) == (3 if drop_last else 4)
    for x, y in zip([b for _ in range(2) for b in got], [b for _ in range(2) for b in want]):
        np.testing.assert_array_equal(x, y)
    got.close()
    want.close()


def test_truncated_store_rejected(tmp_path):
    """A store shorter than its header says, or than a header, does not
    open."""
    short = tmp_path / "trunc.sdb"
    short.write_bytes(struct.pack("<5Q", tnl._MAGIC, 64, 16, 16, 3) + b"\x00" * 10)
    tiny = tmp_path / "tiny.sdb"
    tiny.write_bytes(b"\x01\x02")
    for path in (short, tiny):
        with pytest.raises(OSError):
            tnl.SampleStore(str(path))


def test_abandoned_epoch_not_served_stale(stores):
    """An epoch left after its first batch, with the threads still filling
    the queue, never hands its batches to the next epoch."""
    path, _ = stores
    loader = tnl.NativeDataLoader(path, 4, shuffle=False, seed=5, **STATS)
    store = tnl.SampleStore(path)
    first = store.gather(np.arange(4), **STATS)
    store.close()
    for _ in range(10):
        it = iter(loader)
        next(it)
        np.testing.assert_array_equal(next(iter(loader)), first)
    loader.close()


def _native(cfg, cache):
    return (cfg.replace_path("dataset.use_native_loader", True)
            .replace_path("dataset.cache_dir", str(cache)))


def _as_one_thread(jax_native, mp):
    """The JAX route's loader at one thread, whose order is the batch order."""
    class OneThread(jax_native.NativeDataLoader):
        def __init__(self, *args, **kw):
            super().__init__(*args, num_threads=1, **kw)
    mp.setattr(jax_native, "NativeDataLoader", OneThread)


@pytest.mark.parametrize("case", ["synthetic", "flowers"])
def test_load_dataloader_route_equals_jax(jax_native, tiny_config, tmp_path, case):
    """``use_native_loader: true``: both packages' ``load_dataloader`` build
    the same store under ``dataset.cache_dir`` and give the same batches over
    two epochs: the synthetic fallback's train (shuffled, ``max_samples``)
    and val splits; Oxford102's train split, augmented in C++, and its val
    split."""
    if case == "flowers":
        for split in ("train", "val"):
            _write_flowers(str(tmp_path / "data"), n=5, split=split)
        jcfg, tcfg = _configs(tiny_config, "Oxford102Flower", tmp_path / "data", batch=2)
        name, split_n = "Oxford102Flower", {"train": 5, "val": 5}
    else:
        jcfg, tcfg = _configs(tiny_config, "synthetic", tmp_path / "none", batch=8)
        jcfg = jcfg.replace_path("dataset.max_train_samples", 40)
        tcfg = tcfg.replace_path("dataset.max_train_samples", 40)
        name, split_n = "synthetic", {"train": 5, "val": 2}
    with pytest.MonkeyPatch.context() as mp:
        _as_one_thread(jax_native, mp)
        for split, n in split_n.items():
            got, _ = t_load_dataloader(name, split, config=_native(tcfg, tmp_path / "tc"),
                                       seed=3)
            want, _ = j_load_dataloader(name, split, config=_native(jcfg, tmp_path / "jc"),
                                        seed=3)
            assert isinstance(got, tnl.NativeDataLoader)
            assert isinstance(want, jax_native.NativeDataLoader)
            a = [b for _ in range(2) for b in got]
            b = [b for _ in range(2) for b in want]
            assert len(a) == len(b) == 2 * n
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            if case == "flowers" and split == "train":
                assert not all(np.array_equal(x, y) for x, y in zip(a[:n], a[n:]))
    stores = sorted(p.name for p in (tmp_path / "tc").iterdir())
    assert stores == sorted(p.name for p in (tmp_path / "jc").iterdir()) and len(stores) == 2


def test_failed_build_raises_without_fallback(tiny_config, tmp_path, monkeypatch):
    """A compiler that fails: the library's build raises with its log, and
    ``load_dataloader`` with the key set raises too instead of serving the
    Python loader."""
    fail = tmp_path / "failing-c++"
    fail.write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 1\n")
    fail.chmod(0o755)
    monkeypatch.setenv("CXX", str(fail))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    tnl._lib.cache_clear()
    _build.host_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no compiler here"):
            tnl.NativeDataLoader("unused.sdb", 8)
        _, tcfg = _configs(tiny_config, "synthetic", tmp_path / "none", batch=8)
        with pytest.raises(RuntimeError, match="failing-c"):
            t_load_dataloader("synthetic", "train", config=_native(tcfg, tmp_path / "c"))
    finally:
        tnl._lib.cache_clear()
        _build.host_library.cache_clear()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_importing_builds_nothing():
    """Importing the loader and the pipeline builds and loads no library;
    ``build_all`` stays the CUDA sources' (the sample store is no kernel)."""
    assert "sampledb" not in _build.sources()
    code = ("import vq_vae_gan_diffusion_torch.data.pipeline\n"
            "from vq_vae_gan_diffusion_torch.data import native_loader as n\n"
            "from vq_vae_gan_diffusion_torch.ops import _build as b\n"
            "assert n._lib.cache_info().currsize == b.host_library.cache_info().currsize == 0\n")
    subprocess.run([sys.executable, "-c", code], check=True)
