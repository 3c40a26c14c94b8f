"""The port's CIFAR-10, Oxford102 and InterHand26M readers, the folder
datasets' augmentation and ``load_dataloader``'s branches against the JAX
package's, on fixture files in the formats the readers parse (CIFAR pickle
batches, class folders of PNG and JPEG files, COCO JSON with PNG images).

Every comparison is exact: readers give the same uint8 arrays, loaders the
same float32 batches bit for bit (augmented ones included, over two
epochs), and where the data is not on disk both fall back to the same
synthetic batches.
"""

import json
import os
import pickle

import numpy as np
import pytest
from PIL import Image

from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.data import datasets as tds
from vq_vae_gan_diffusion_torch.data import load_dataloader as t_load_dataloader
from vq_vae_gan_diffusion_torch.data import transforms as ttr
from vq_vae_gan_diffusion_tpu.data import datasets as jds
from vq_vae_gan_diffusion_tpu.data import load_dataloader as j_load_dataloader
from vq_vae_gan_diffusion_tpu.data import transforms as jtr

NAMES = ("cifar10", "Oxford102Flower", "InterHand26M")


def _configs(tiny_config, name: str, root, size: int = 16, batch: int = 2, subset: bool = False):
    """The tiny config on dataset ``name`` at ``size``² x 3, batch ``batch``,
    reading under ``root``; the JAX config and the port's."""
    cfg = tiny_config
    for path, value in (("dataset.dataset_name", name), ("dataset.data_root", str(root)),
                        ("dataset.img_size", {name: size}), ("dataset.img_channels", {name: 3}),
                        ("dataset.batch_size", {"vqvae": {name: batch}}),
                        ("dataset.mean", [0.485, 0.456, 0.406]),
                        ("dataset.std", [0.229, 0.224, 0.225]),
                        ("dataset.max_train_samples", float("inf")),
                        ("dataset.max_val_samples", float("inf")),
                        ("dataset.subset", subset)):
        cfg = cfg.replace_path(path, value)
    return cfg, t_config_from_dict(cfg.to_dict())


def _batches(name, split, jcfg, tcfg, seed=3, epochs=1):
    """Both loaders' batches over ``epochs`` passes: (port, JAX)."""
    got, _ = t_load_dataloader(name, split, config=tcfg, seed=seed)
    want, _ = j_load_dataloader(name, split, config=jcfg, seed=seed)
    return ([b for _ in range(epochs) for b in got], [b for _ in range(epochs) for b in want])


def _assert_equal_batches(got, want, shape):
    assert len(got) == len(want) > 0 and got[0].shape == shape
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _write_cifar(root, n_each: int = 4) -> None:
    rs = np.random.RandomState(1)
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    for fname in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        data = rs.randint(0, 256, (n_each, 3 * 32 * 32)).astype(np.uint8)
        with open(os.path.join(base, fname), "wb") as f:
            pickle.dump({b"data": data, b"labels": rs.randint(0, 10, n_each).tolist()}, f)


def _write_flowers(root, classes=("daisy", "rose"), n=3, split="train") -> None:
    """Class folders of PNG and JPEG images of several sizes and a stray
    text file; the JPEGs decode through the same PIL on both sides."""
    rs = np.random.RandomState(2)
    for c in classes:
        d = os.path.join(root, split, c)
        os.makedirs(d)
        for i in range(n):
            img = rs.randint(0, 256, (20 + 3 * i, 24, 3)).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(d, f"img{i}.{'png' if i % 2 else 'jpg'}"))
        with open(os.path.join(d, "notes.txt"), "w") as f:
            f.write("x")


def _write_interhand(root, split="train") -> None:
    """Three annotated PNG images (one bbox at the image's edge, one image
    missing on disk, one annotation without a bbox)."""
    rs = np.random.RandomState(3)
    img_dir = os.path.join(root, "images", split)
    os.makedirs(img_dir)
    for name in ("a.png", "b.png"):
        Image.fromarray(rs.randint(0, 256, (48, 40, 3)).astype(np.uint8)).save(
            os.path.join(img_dir, name))
    ann = {"images": [{"id": 1, "file_name": "a.png"}, {"id": 2, "file_name": "b.png"},
                      {"id": 3, "file_name": "missing.png"}],
           "annotations": [{"image_id": 1, "bbox": [10, 12, 8, 20]},
                           {"image_id": 3, "bbox": [0, 0, 5, 5]},
                           {"image_id": 2, "bbox": [0.5, 30.7, 30, 17]},
                           {"image_id": 2},
                           {"image_id": 1, "bbox": [25, 2, 14.2, 6]}]}
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    with open(os.path.join(root, "annotations", f"{split}.json"), "w") as f:
        json.dump(ann, f)


def test_cifar10_reader_matches_jax(tmp_path):
    """Train (five batches) and val (the test batch): the same NHWC uint8
    images and labels; no files: FileNotFoundError on both sides."""
    _write_cifar(str(tmp_path))
    for train in (True, False):
        got, want = tds.CIFAR10Dataset(str(tmp_path), train), jds.CIFAR10Dataset(str(tmp_path),
                                                                                 train)
        assert len(got) == len(want) == (20 if train else 4)
        for i in range(len(got)):
            np.testing.assert_array_equal(got.get_image(i), want.get_image(i))
            assert got.get_image(i).shape == (32, 32, 3) and got.get_image(i).dtype == np.uint8
            assert got.get_label(i) == want.get_label(i)
    with pytest.raises(FileNotFoundError, match="cifar-10-batches-py"):
        tds.CIFAR10Dataset(str(tmp_path / "none"))


@pytest.mark.parametrize("layout", ["classes", "flat"])
def test_oxford_reader_matches_jax(tmp_path, layout):
    """Class folders (sorted classes, extension filter) or a flat folder of
    images: the same samples, labels and RGB arrays."""
    if layout == "classes":
        _write_flowers(str(tmp_path))
    else:
        os.makedirs(tmp_path / "train")
        for i in range(3):
            Image.fromarray(np.full((8, 9), 40 * i, np.uint8)).save(tmp_path / "train" / f"{i}.png")
    got, want = tds.OxfordFlowersDataset(str(tmp_path)), jds.OxfordFlowersDataset(str(tmp_path))
    assert got.classes == want.classes and len(got) == len(want) == (6 if layout == "classes"
                                                                     else 3)
    for i in range(len(got)):
        assert got.samples[i] == want.samples[i]
        np.testing.assert_array_equal(got.get_image(i), want.get_image(i))
        assert got.get_image(i).shape[-1] == 3 and got.get_label(i) == want.get_label(i)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        tds.OxfordFlowersDataset(str(tmp_path / "none"))


def test_interhand_reader_matches_jax(tmp_path):
    """The COCO reader on PNG files (PIL here, OpenCV in JAX): the same
    crops, padded squares, the bbox clipped at the image's edge, and the
    missing image's sample replaced by the next index's."""
    _write_interhand(str(tmp_path))
    got, want = tds.InterHand26MDataset(str(tmp_path)), jds.InterHand26MDataset(str(tmp_path))
    assert got.entries == want.entries and len(got) == 4
    for i in range(len(got)):
        a, b = got.get_image(i), want.get_image(i)
        assert a.shape[0] == a.shape[1] and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.get_image(1), got.get_image(2))
    with pytest.raises(FileNotFoundError, match="annotations"):
        tds.InterHand26MDataset(str(tmp_path / "none"))


def test_flips_and_rotation_match_jax():
    """The augmentation's draws and PIL's rotation: the same image for 64
    generators (flips alone, rotations alone and both occur)."""
    img = np.random.RandomState(4).randint(0, 256, (17, 17, 3)).astype(np.uint8)
    kinds = set()
    for seed in range(64):
        got = ttr.random_flips_and_rotation(img, np.random.default_rng(seed))
        want = jtr.random_flips_and_rotation(img, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
        kinds.add(not np.array_equal(got, img))
    assert kinds == {True, False}
    prep = (ttr.Preprocessor(16, (0.5,) * 3, (0.2,) * 3, augment=True),
            jtr.Preprocessor(16, (0.5,) * 3, (0.2,) * 3, augment=True))
    for seed in range(8):
        np.testing.assert_array_equal(prep[0](img, np.random.default_rng(seed)),
                                      prep[1](img, np.random.default_rng(seed)))
    np.testing.assert_array_equal(prep[0](img), prep[1](img))


@pytest.mark.parametrize("subset", [False, True])
def test_cifar10_loader_matches_jax(tmp_path, tiny_config, subset):
    """cifar10 batches (resized to 16², normalised by (0.1307, 0.3081))
    equal to JAX's, train shuffled and val; with ``subset`` 10 x batch
    train and 4 x batch val samples."""
    _write_cifar(str(tmp_path))
    jcfg, tcfg = _configs(tiny_config, "cifar10", tmp_path, batch=1, subset=subset)
    for split, n in (("train", 10 if subset else 20), ("val", 4)):
        got, want = _batches("cifar10", split, jcfg, tcfg)
        assert len(got) == n
        _assert_equal_batches(got, want, (1, 16, 16, 3))


@pytest.mark.parametrize("name", ["Oxford102Flower", "InterHand26M"])
def test_folder_loaders_augment_as_jax(tmp_path, tiny_config, name):
    """The train split augmented from (seed, epoch, index): equal to JAX's
    batches bit for bit over two epochs, which differ; the val split is not
    augmented."""
    for split in ("train", "val"):
        (_write_flowers if name == "Oxford102Flower" else _write_interhand)(str(tmp_path),
                                                                            split=split)
    jcfg, tcfg = _configs(tiny_config, name, tmp_path)
    got, want = _batches(name, "train", jcfg, tcfg, epochs=2)
    _assert_equal_batches(got, want, (2, 16, 16, 3))
    half = len(got) // 2
    assert not all(np.array_equal(a, b) for a, b in zip(got[:half], got[half:]))
    got, want = _batches(name, "val", jcfg, tcfg, epochs=2)
    _assert_equal_batches(got, want, (2, 16, 16, 3))


@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_synthetic_fallback_matches_jax(tmp_path, tiny_config, name, subset):
    """No data on disk: a warning and the synthetic dataset, the same batches
    as JAX's bit for bit, train and val (``subset`` does not cut the
    fallback)."""
    jcfg, tcfg = _configs(tiny_config, name, tmp_path / "none", batch=8, subset=subset)
    for split in ("train", "val"):
        got, want = _batches(name, split, jcfg, tcfg)
        _assert_equal_batches(got, want, (8, 16, 16, 3))
        assert len(got) == (64 if split == "train" else 16) // 8


def test_small_config_trains_on_the_fallback(tmp_path):
    """configs/training_config_small.yml (vqvae on Oxford102Flower), its
    widths cut to a tiny VQVAE at 32²: ``train --debug --device cpu`` runs
    on the synthetic fallback, where the port refused the reader before."""
    import yaml

    from vq_vae_gan_diffusion_torch.train import cli

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "training_config_small.yml")) as f:
        data = yaml.safe_load(f)
    data["architecture"]["vqvae"].update(latent_channels=8, latent_size=8,
                                         intermediate_channels=[8, 8, 16],
                                         attention_resolution=[8], num_codebook_vectors=16)
    data["dataset"].update(data_root=str(tmp_path / "none"),
                           img_size={**data["dataset"]["img_size"], "Oxford102Flower": 32})
    data["trainer"]["log_dir"] = str(tmp_path / "zlog")
    path = tmp_path / "small.yml"
    path.write_text(yaml.safe_dump(data))
    out = cli.run(["--config", str(path), "--debug", "--device", "cpu"])
    assert out["worker"].global_step == 2 and np.isfinite(out["metrics"]["vq_loss"])
    assert os.path.exists(os.path.join(out["run_dir"], "val_recon_epoch0.jpg"))
