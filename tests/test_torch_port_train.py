"""The port's stage-1 training around the step: gradient accumulation and
the InterHand26M hand mask against the JAX worker, remat against no remat,
``lambda_mode: off``, ``train_multi_step``, the MNIST IDX reader and the
synthetic dataset against the JAX package's readers and pipeline, and the
``train`` CLI on the CPU (debug run, checkpoint, resume, then ``generate``'s reconstruction
grid from the checkpoint).

Tolerances: metrics within 1e-4 relative and parameters as in
tests/test_torch_port_vqgan.py; remat against no remat within 1e-6 (the
same ops recomputed); images and batches from the readers equal.
"""

import gzip
import json
import os
import struct
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_vqgan import (METRICS, assert_params_close, jax_gradients, live_leaves,
                                   port_worker)
from vq_vae_gan_diffusion_torch import generate
from vq_vae_gan_diffusion_torch import weights as W
from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.data import datasets as tds
from vq_vae_gan_diffusion_torch.data import load_dataloader as t_load_dataloader
from vq_vae_gan_diffusion_torch.train import cli
from vq_vae_gan_diffusion_torch.train.vqgan_worker import VQGANVQVAEWorker as TorchWorker
from vq_vae_gan_diffusion_tpu.data import datasets as jds
from vq_vae_gan_diffusion_tpu.data import load_dataloader as j_load_dataloader
from vq_vae_gan_diffusion_tpu.train.vqgan_worker import VQGANVQVAEWorker as JaxWorker


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: at these sizes torch gains nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _interhand(cfg):
    """The tiny config on an InterHand26M-named dataset with the hand mask."""
    for path, value in (("dataset.dataset_name", "InterHand26M"),
                        ("dataset.img_size", {"InterHand26M": 32}),
                        ("dataset.img_channels", {"InterHand26M": 3}),
                        ("dataset.mean", [0.485, 0.456, 0.406]),
                        ("dataset.std", [0.229, 0.224, 0.225]),
                        ("dataset.get_hand_mask", True)):
        cfg = cfg.replace_path(path, value)
    return cfg


def test_accumulation_and_hand_mask_match_jax(tiny_config):
    """gradient_accumulate_every 2 (optax.MultiSteps in JAX) with the hand
    mask on: after the first step nothing has moved on either side; after
    the second both apply the mean gradient; metrics of both steps within
    1e-4. The batches darken part of each image below the mask's 20/255."""
    cfg = _interhand(tiny_config.replace_path("architecture.model_name", "vqgan")
                     .replace_path("trainer.descriminator.disc_start", 1)
                     .replace_path("trainer.vqvae.gradient_accumulate_every", 2))
    jw = JaxWorker(cfg, tempfile.mkdtemp())
    js = jw.init_state()
    tw = port_worker(jw, cfg, js)
    ts = tw.state
    start = {k: v.clone() for k, v in ts.vqvae.state_dict().items()}
    rs = np.random.RandomState(1)
    batches = [rs.uniform(-2.5, 2.5, (4, 32, 32, 3)).astype(np.float32) for _ in range(2)]
    live = {k[len("vqvae."):] for k in live_leaves(jax_gradients(
        jw, cfg, js.replace(step=jnp.ones((), jnp.int32)), batches[0])) if k.startswith("vqvae.")}
    mask = tw._hand_mask(torch.from_numpy(batches[0]))
    assert 0.05 < float(mask.mean()) < 0.95
    for i, b in enumerate(batches):
        js, jm = jw.train_step(js, jnp.asarray(b), jax.random.PRNGKey(0))
        ts, tm = tw.train_step(ts, torch.from_numpy(b))
        for k in METRICS:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        if i == 0:
            assert all(torch.equal(v, start[k]) for k, v in ts.vqvae.state_dict().items())
            assert ts.opt_g.mini_step == ts.opt_d.mini_step == 1
    assert ts.opt_g.mini_step == 0 and ts.step == 2
    js = jax.device_get(js)
    tc = t_config_from_dict(cfg.to_dict())
    assert_params_close(ts.vqvae.state_dict(), W.vqvae_state_from_jax(js.vqvae_params, tc), 1,
                        live)
    moved = sum(float((v - start[k]).abs().max()) > 0 for k, v in ts.vqvae.state_dict().items())
    assert moved > len(start) // 2


def test_remat_equals_no_remat_and_lambda_off(tiny_config):
    """architecture.vqvae.remat recomputes the VQVAE forward in backward:
    the same step, within 1e-6. lambda_mode off pins λ to 1."""
    cfg = t_config_from_dict(tiny_config.replace_path("architecture.model_name", "vqgan")
                             .replace_path("trainer.descriminator.disc_start", 0).to_dict())
    batch = torch.from_numpy(np.random.RandomState(2).uniform(-1, 1, (4, 32, 32, 3))
                             .astype(np.float32))
    out = []
    for path, value in (("architecture.vqvae.remat", False), ("architecture.vqvae.remat", True),
                        ("trainer.vqvae.lambda_mode", "off")):
        w = TorchWorker(cfg.replace_path(path, value), tempfile.mkdtemp(), device="cpu")
        state, metrics = w.train_step(w.init_state(), batch)
        out.append((metrics, state.vqvae.state_dict()))
    (m0, p0), (m1, p1), (m2, _) = out
    for k in METRICS:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-6, err_msg=k)
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], rtol=0, atol=1e-6, msg=k)
    assert float(m2["lambda"]) == 1.0 and float(m0["lambda"]) != 1.0
    assert float(m2["gan_loss"]) > 0 and float(m2["disc_factor"]) == 1.0


def test_train_multi_step_is_a_loop_of_steps(tiny_config):
    """train_multi_step over [K, B, ...] batches: the state and last metrics
    of K train_step calls (vqvae mode; the same seeded weights)."""
    cfg = t_config_from_dict(tiny_config.to_dict())
    batches = torch.from_numpy(np.random.RandomState(7).uniform(-1, 1, (2, 4, 32, 32, 3))
                               .astype(np.float32))
    a = TorchWorker(cfg, tempfile.mkdtemp(), device="cpu")
    b = TorchWorker(cfg, tempfile.mkdtemp(), device="cpu")
    sa, ma = a.train_multi_step(a.init_state(), batches)
    sb = b.init_state()
    for batch in batches:
        sb, mb = b.train_step(sb, batch)
    assert sa.step == sb.step == 2
    assert all(torch.equal(ma[k], mb[k]) for k in METRICS)
    pa, pb = sa.vqvae.state_dict(), sb.vqvae.state_dict()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)


def _write_idx(path, arr: np.ndarray, gz: bool) -> None:
    code = {np.uint8: 0x08, np.int32: 0x0C}[arr.dtype.type]
    data = (struct.pack(">HBB", 0, code, arr.ndim) + struct.pack(">" + "I" * arr.ndim, *arr.shape)
            + arr.astype(arr.dtype.newbyteorder(">")).tobytes())
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(data)


def _configs(tiny_config, **paths):
    cfg = tiny_config
    for path, value in paths.items():
        cfg = cfg.replace_path(path.replace("__", "."), value)
    return cfg, t_config_from_dict(cfg.to_dict())


def test_mnist_idx_reader(tmp_path, tiny_config):
    """Tiny IDX files in torchvision's MNIST/raw layout (images gzipped,
    labels not): the port reads what was written, as the JAX reader does;
    load_dataloader's batches (shuffled, last short batch dropped) equal
    the JAX pipeline's."""
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    rs = np.random.RandomState(3)
    images = rs.randint(0, 256, (7, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, 7).astype(np.uint8)
    _write_idx(raw / "train-images-idx3-ubyte.gz", images, gz=True)
    _write_idx(raw / "train-labels-idx1-ubyte", labels, gz=False)
    ds, ref = tds.MNISTDataset(str(tmp_path)), jds.MNISTDataset(str(tmp_path))
    assert len(ds) == len(ref) == 7
    for i in range(7):
        np.testing.assert_array_equal(ds.get_image(i), images[i][..., None])
        np.testing.assert_array_equal(ds.get_image(i), ref.get_image(i))
        assert ds.get_label(i) == ref.get_label(i) == labels[i]
    with pytest.raises(FileNotFoundError, match="MNIST IDX"):
        tds.MNISTDataset(str(tmp_path), train=False)
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x01\x00\x08\x01" + b"\x00" * 8)
    with pytest.raises(ValueError, match="not an IDX"):
        tds._read_idx(str(bad))
    jcfg, tcfg = _configs(tiny_config, dataset__dataset_name="mnist",
                          dataset__data_root=str(tmp_path), dataset__max_train_samples="inf")
    got, _ = t_load_dataloader("mnist", "train", config=tcfg, seed=5)
    want, _ = j_load_dataloader("mnist", "train", config=jcfg, seed=5)
    assert len(got) == len(want) == 0  # 7 images, batch 8, the short batch dropped
    jcfg, tcfg = _configs(tiny_config, dataset__dataset_name="mnist",
                          dataset__data_root=str(tmp_path),
                          dataset__batch_size__vqvae__mnist=3)
    got, _ = t_load_dataloader("mnist", "train", config=tcfg, seed=5)
    want, _ = j_load_dataloader("mnist", "train", config=jcfg, seed=5)
    batches = list(got)
    assert len(batches) == len(want) == 2 and batches[0].shape == (3, 28, 28, 1)
    for a, b in zip(batches, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("channels", [1, 3])
def test_synthetic_dataset_matches_jax(tiny_config, channels):
    """The same images as the JAX package's SyntheticDataset, and the same
    normalised batches through the fallback of load_dataloader."""
    ds, ref = tds.SyntheticDataset(8, 28, channels, seed=4), jds.SyntheticDataset(8, 28, channels,
                                                                                  seed=4)
    for i in range(8):
        np.testing.assert_array_equal(ds.get_image(i), ref.get_image(i))
        assert ds.get_label(i) == ref.get_label(i)
    jcfg, tcfg = _configs(tiny_config, dataset__img_channels={"synthetic": channels})
    for split in ("train", "val"):
        got, _ = t_load_dataloader(None, split, config=tcfg, seed=6)
        want, _ = j_load_dataloader(None, split, config=jcfg, seed=6)
        got, want = list(got), list(want)
        assert len(got) == len(want) > 0 and got[0].shape == (8, 32, 32, channels)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _cli_config(tmp_path, tiny_config) -> str:
    data = tiny_config.replace_path("architecture.model_name", "vqgan") \
        .replace_path("trainer.log_dir", str(tmp_path / "zlog")).to_dict()
    path = tmp_path / "tiny_vqgan.yml"
    path.write_text(yaml.safe_dump(data))
    return str(path)


def _metric_rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_debug_checkpoint_resume_and_generate(tmp_path, tiny_config):
    """--debug on the CPU: two steps of one epoch, metrics.jsonl (each step's
    metrics, then the epoch's time), a checkpoint, the reconstruction GIF
    and the val grid. Resuming from the checkpoint goes on at step 3; then
    ``generate`` on the vqgan config reconstructs the val split with the
    checkpoint's VQVAE."""
    config = _cli_config(tmp_path, tiny_config)
    first = cli.run(["--config", config, "--debug", "--device", "cpu"])
    rows = _metric_rows(first["run_dir"])
    assert [r["step"] for r in rows] == [1, 2, 2]
    assert all(set(METRICS) <= set(r) for r in rows[:2])
    assert {"epoch_time_s", "images_per_sec", "loader_s", "artifact_s", "step_s"} <= set(rows[2])
    assert rows[2]["steps"] == 2 and rows[2]["loader_s"] > 0 and rows[2]["artifact_s"] > 0
    assert rows[2]["loader_s"] + rows[2]["artifact_s"] + rows[2]["step_s"] == pytest.approx(
        rows[2]["epoch_time_s"])
    ckpt = os.path.join(first["run_dir"], "ckpt", "step_00000002.pth")
    for name in ("val_recon_epoch0.jpg", "reconstruction.gif", "info.log"):
        assert os.path.exists(os.path.join(first["run_dir"], name)), name
    tree = torch.load(ckpt, weights_only=True)
    assert tree["step"] == 2 and tree["epoch"] == 0 and tree["state"]["step"] == 2

    second = cli.run(["--config", config, "--debug", "--device", "cpu"],
                     overrides={"architecture.vqvae.resume_path": ckpt})
    assert second["worker"].global_step == 4 and second["worker"].state.step == 4
    assert [r["step"] for r in _metric_rows(second["run_dir"])] == [3, 4, 4]
    ckpt2 = os.path.join(second["run_dir"], "ckpt", "step_00000004.pth")

    out = generate.run(["--config", config, "--device", "cpu", "--ckpt", ckpt2,
                        "--n-samples", "4"])
    assert os.path.exists(out["path"]) and out["path"].endswith("val_recon_epoch0.jpg")
    assert tuple(out["images"].shape) == (4, 32, 32, 3)
    saved = torch.load(ckpt2, weights_only=True)["state"]["vqvae"]
    want = second["worker"].state.vqvae.state_dict()
    assert all(torch.equal(saved[k], want[k]) for k in want)


def test_train_cli_refusals(tmp_path, tiny_config, monkeypatch):
    """No GPU and no --device cpu: raises. A family or a reader the port
    does not train yet: NotImplementedError naming the ROADMAP item."""
    config = _cli_config(tmp_path, tiny_config)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.run(["--config", config, "--debug"])
    for name, model, diffusion_type, item in (
            ("pixel.yml", "gaussiandiffusion3d", "gaussiandiffusion3d", "A3"),
            ("vqofficial.yml", "vqdiffusion", "VQ_Official", "A4")):
        path = tmp_path / name
        path.write_text(yaml.safe_dump(
            tiny_config.replace_path("architecture.model_name", model)
            .replace_path("architecture.vqdiffusion.diffusion_type", diffusion_type).to_dict()))
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md, {item}"):
            cli.run(["--config", str(path), "--device", "cpu"])
    _, tcfg = _configs(tiny_config, dataset__dataset_name="cifar10")
    with pytest.raises(NotImplementedError, match="cifar10 reader"):
        t_load_dataloader(None, "train", config=tcfg)
