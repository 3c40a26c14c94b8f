"""The port's CLIs and training loop against the root CLIs and the JAX
loop, at tests/conftest.py::tiny_config.

- ``--fused-sampler`` / ``--fused-posterior`` on both port CLIs write the
  config keys the root ``train.py`` and ``generate.py`` write (the root's
  lines are copied below as ``_root_fused_overrides`` and run on the JAX
  config);
- a val split that does not load: a warning and no val loader;
- ``train_diffusion`` keeps the newest 3 checkpoints, as the root CLI's
  Orbax manager (``max_to_keep=3``) does;
- ``generate`` serves the reference's own VAE file, ``{"vae_state_dict",
  "optimizer_state_dict"}``;
- the loop's extras (``train/base.py``, ``utils/experiment.py``,
  ``utils/profiling.py``): ``--profile``'s trace, the SIGTERM checkpoint,
  TensorBoard events, and ``trainer.steps_per_dispatch`` K against K = 1
  and the JAX loop's metric cadence.
"""

import glob
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_ckpt import _draw
from test_torch_port_vae import _geometry, _port_vae, _vae_config
from vq_vae_gan_diffusion_torch import data as t_data
from vq_vae_gan_diffusion_torch import generate
from vq_vae_gan_diffusion_torch import train_diffusion as tdiff
from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.data import load_dataloader as t_load_dataloader
from vq_vae_gan_diffusion_torch.data.datasets import SyntheticDataset
from vq_vae_gan_diffusion_torch.data.pipeline import DataLoader
from vq_vae_gan_diffusion_torch.data.transforms import Preprocessor
from vq_vae_gan_diffusion_torch.train import VQDiffusionWorker, cli
from vq_vae_gan_diffusion_torch.train.vqgan_worker import VQGANVQVAEWorker
from vq_vae_gan_diffusion_tpu.models.vae import VAE as JaxVAE
from vq_vae_gan_diffusion_tpu.utils.torch_export import export_vae

# (path, present) of every key either override may write
FUSED_KEYS = ("trainer.gaussiandiffusion3d.fused_sampler", "trainer.vqdiffusion.fused_sampler",
              "architecture.vqdiffusion.fused_sampler",
              "architecture.vqdiffusion.fused_posterior")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _root_fused_overrides(config, fused_sampler, fused_posterior):
    """The root train.py's lines (:74-90), which generate.py repeats."""
    if fused_sampler is not None:
        val = {"on": True, "off": False}.get(fused_sampler, fused_sampler)
        for fam in ("gaussiandiffusion3d", "vqdiffusion"):
            if fam in config.trainer:
                config = config.replace_path(f"trainer.{fam}.fused_sampler", val)
        if "vqdiffusion" in config.architecture:
            config = config.replace_path("architecture.vqdiffusion.fused_sampler", val)
    if fused_posterior is not None:
        val = {"on": True, "off": False}.get(fused_posterior, fused_posterior)
        if "vqdiffusion" in config.architecture:
            config = config.replace_path("architecture.vqdiffusion.fused_posterior", val)
    return config


def _lookup(cfg, path):
    node = cfg
    for key in path.split("."):
        if key not in node:
            return ("absent",)
        node = node[key]
    return ("present", node)


def _tiny_vqd(tiny_config, tmp_path, drop_pixel: bool):
    cfg = (tiny_config.replace_path("architecture.model_name", "vqdiffusion")
           .replace_path("trainer.log_dir", str(tmp_path / "zlog")))
    data = cfg.to_dict()
    if drop_pixel:
        del data["trainer"]["gaussiandiffusion3d"]
    path = tmp_path / "vqd.yml"
    path.write_text(yaml.safe_dump(data))
    return str(path), data


@pytest.mark.parametrize("flag,value,drop_pixel",
                         [("sampler", v, False) for v in ("on", "off", "pallas", "packed")]
                         + [("posterior", v, False) for v in ("on", "off", "interpret", "prng")]
                         + [("sampler", "pallas", True), ("posterior", "off", True)])
def test_fused_flags_write_the_root_keys(tmp_path, tiny_config, monkeypatch, flag, value,
                                         drop_pixel):
    """Each value of the root CLIs' choices, through ``train.run`` and
    ``generate.run``: the config the worker gets has the fused keys (present
    or absent, and their values) that the root's lines give the same YAML;
    also on a config without the ``trainer.gaussiandiffusion3d`` section."""
    from vq_vae_gan_diffusion_tpu.config import config_from_dict as j_config_from_dict

    seen = []

    def fake_train(self, loader, epochs, val_loader=None):
        seen.append(self.config)
        return {}

    def fake_generate(self, val_loader=None, n_samples=16, epoch=0):
        seen.append(self.config)
        return {}
    monkeypatch.setattr(VQDiffusionWorker, "train", fake_train)
    monkeypatch.setattr(VQDiffusionWorker, "generate_images", fake_generate)
    path, data = _tiny_vqd(tiny_config, tmp_path, drop_pixel)
    argv = ["--config", path, "--device", "cpu", f"--fused-{flag}", value]
    cli.run(argv + ["--debug"])
    generate.run(argv)
    want = _root_fused_overrides(j_config_from_dict(data),
                                 value if flag == "sampler" else None,
                                 value if flag == "posterior" else None)
    assert len(seen) == 2
    for got in seen:
        for key in FUSED_KEYS:
            assert _lookup(got, key) == _lookup(want, key), key


def test_missing_val_split_warns_and_trains(tmp_path, tiny_config, monkeypatch, caplog):
    """When the val split raises, the train CLI logs a warning and trains
    with no val loader (no validation grid), as the root train.py does."""
    calls = []

    def loader(name=None, split="train", logger=None, config=None, seed=0):
        calls.append(split)
        if len(calls) > 1:
            raise FileNotFoundError(f"no {split} split")
        return t_load_dataloader(name, split, logger, config, seed)
    monkeypatch.setattr(t_data, "load_dataloader", loader)
    cfg = (tiny_config.replace_path("architecture.model_name", "vqgan")
           .replace_path("trainer.log_dir", str(tmp_path / "zlog")))
    path = tmp_path / "vqgan.yml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    out = cli.run(["--config", str(path), "--debug", "--device", "cpu"])
    assert calls == ["val", "val"] and out["worker"].global_step == 2
    assert any("no val split" in r.getMessage() for r in caplog.records)
    assert not os.path.exists(os.path.join(out["run_dir"], "val_recon_epoch0.jpg"))


def test_train_diffusion_keeps_the_newest_three(tmp_path):
    """Four epochs (``--debug`` stops after one, in the root CLI too, so the
    run is cut by its batch, sampling steps and image size instead): the
    newest 3 checkpoints stay, no ``.tmp`` file, and the newest holds the
    final state."""
    out = tdiff.run(["--device", "cpu", "--epochs", "4", "--batch-size", "16", "--dim", "8",
                     "--img-size", "16", "--sampling-timesteps", "2", "--dataset", "synthetic",
                     "--log-dir", str(tmp_path / "a")])
    ckpt = os.path.join(out["save_dir"], "ckpt")
    names = sorted(os.listdir(ckpt))
    assert names == [f"step_{s:08d}.pth" for s in (8, 12, 16)], names
    assert not glob.glob(os.path.join(ckpt, "*.tmp"))
    tree = torch.load(os.path.join(ckpt, names[-1]), weights_only=True)
    assert tree["epoch"] == 3 and tree["step"] == 16 == out["state"].step


def test_generate_serves_the_reference_vae_file(tmp_path, tiny_config):
    """The reference's VAE worker saves ``{"vae_state_dict",
    "optimizer_state_dict"}``; ``generate`` reads the VAE from it and
    leaves the optimizer out, as tools/import_torch_checkpoint.py does."""
    cfg = _vae_config(tiny_config)
    path = tmp_path / "vae.yml"
    path.write_text(yaml.safe_dump(cfg.replace_path("trainer.log_dir", str(tmp_path / "zlog"))
                                   .to_dict()))
    # the weights drawn with numpy on the init's shapes: no init to run
    params = _draw(jax.eval_shape(lambda: JaxVAE.from_config(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jax.random.PRNGKey(1)))["params"], 4)
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             export_vae(params, **_geometry(cfg)).items()}
    ref = str(tmp_path / "reference_vae.pth")
    torch.save({"vae_state_dict": state,
                "optimizer_state_dict": {"state": {}, "param_groups": [{"lr": 1e-4}]}}, ref)
    out = generate.run(["--config", str(path), "--device", "cpu", "--ckpt", ref,
                        "--n-samples", "2"])
    tc = t_config_from_dict(cfg.to_dict())
    val, _ = t_load_dataloader(None, "val", config=tc, seed=42)
    imgs = torch.from_numpy(next(iter(val))[:2])
    with torch.no_grad():
        want = _port_vae(params, cfg)(imgs, generator=torch.Generator().manual_seed(0))[0]
    torch.testing.assert_close(out["reconstructions"], want, rtol=0, atol=0)


# -- the loop's extras -----------------------------------------------------------------------

def _vq_config(tiny_config, tmp_path, model="vqvae", **paths):
    cfg = (tiny_config.replace_path("architecture.model_name", model)
           .replace_path("trainer.log_dir", str(tmp_path / "zlog")))
    for path, value in paths.items():
        cfg = cfg.replace_path(path, value)
    path = tmp_path / f"{model}.yml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    return cfg, str(path)


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_profile_writes_a_chrome_trace(tmp_path, tiny_config):
    """--profile: the first epoch under torch.profiler, its Chrome trace at
    <run_dir>/profile/trace.json with the steps' operator events."""
    _, path = _vq_config(tiny_config, tmp_path)
    out = cli.run(["--config", path, "--debug", "--device", "cpu", "--profile"])
    with open(os.path.join(out["run_dir"], "profile", "trace.json")) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and n.startswith("aten::conv") for n in names)
    assert out["worker"].global_step == 2


def test_tensorboard_events_unless_opted_out(tmp_path, tiny_config, monkeypatch, caplog):
    """tb/ holds an event file when tensorboardX imports; VQGD_NO_TB=1 leaves
    jsonl only. Each writer says which at info level."""
    import logging
    caplog.set_level(logging.INFO, logger="vqgd_torch")
    _, path = _vq_config(tiny_config, tmp_path)
    on = cli.run(["--config", path, "--debug", "--device", "cpu"])
    assert glob.glob(os.path.join(on["run_dir"], "tb", "events.out.tfevents.*"))
    monkeypatch.setenv("VQGD_NO_TB", "1")
    off = cli.run(["--config", path, "--debug", "--device", "cpu"])
    assert not os.path.exists(os.path.join(off["run_dir"], "tb"))
    assert len(_rows(off["run_dir"])) == 3
    said = [r.getMessage() for r in caplog.records if "TensorBoard" in r.getMessage()]
    assert len(said) == 2 and "VQGD_NO_TB" in said[1]


def _loader(n_batches: int = 5):
    """``n_batches`` batches of 8 synthetic 32^2 images, in order."""
    ds = SyntheticDataset(8 * n_batches, 32, 3)
    return DataLoader(ds, 8, Preprocessor(32, (0.5,) * 3, (0.5,) * 3), shuffle=False,
                      drop_last=True, seed=0)


def _worker(cfg, run_dir):
    return VQGANVQVAEWorker(t_config_from_dict(cfg.to_dict()), str(run_dir), device="cpu")


def test_sigterm_saves_at_the_step_boundary_and_exits_143(tmp_path, tiny_config, monkeypatch):
    """SIGTERM sent from inside the third step: the step finishes, its
    metrics row is written, a checkpoint at step 3 is saved, SystemExit(143);
    the handler in place before is back; the checkpoint resumes at step 3."""
    cfg, _ = _vq_config(tiny_config, tmp_path)
    step = VQGANVQVAEWorker.train_step
    handler = signal.getsignal(signal.SIGTERM)

    def killing_step(self, state, batch, generator=None):
        out = step(self, state, batch, generator)
        if state.step == 3:
            assert signal.getsignal(signal.SIGTERM) not in (handler, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)
        return out
    monkeypatch.setattr(VQGANVQVAEWorker, "train_step", killing_step)
    w = _worker(cfg, tmp_path / "run")
    with pytest.raises(SystemExit) as exit_:
        w.train(_loader(), 1)
    assert exit_.value.code == 143 and w.global_step == 3
    assert signal.getsignal(signal.SIGTERM) is handler
    assert [r["step"] for r in _rows(tmp_path / "run")] == [1, 2, 3]
    ckpt = tmp_path / "run" / "ckpt" / "step_00000003.pth"
    assert sorted(os.listdir(tmp_path / "run" / "ckpt")) == [ckpt.name]
    monkeypatch.setattr(VQGANVQVAEWorker, "train_step", step)
    resumed = _worker(cfg.replace_path("architecture.vqvae.resume_path", str(ckpt)),
                      tmp_path / "again")
    resumed.init_state()
    assert resumed.global_step == 3 and resumed.state.step == 3
    want = w.state.vqvae.state_dict()
    assert all(torch.equal(resumed.state.vqvae.state_dict()[k], v) for k, v in want.items())


@pytest.mark.parametrize("hook", ["log_artifacts", "save"])
def test_sigterm_in_a_profile_epoch_exits_with_its_trace(tmp_path, tiny_config, monkeypatch,
                                                          hook):
    """--profile --epochs 2 in --debug, SIGTERM sent from the profiled
    epoch's first ``hook`` call: during its artifacts (taken after step 2,
    inside the profiled call) or after its checkpoint (taken by the second
    call before its first step). Either way: exit 143 at step 2, a
    checkpoint at step 2, the trace written, the handler restored."""
    _, path = _vq_config(tiny_config, tmp_path)
    original = getattr(VQGANVQVAEWorker, hook)
    handler = signal.getsignal(signal.SIGTERM)
    calls = []

    def killing_hook(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        calls.append(self.global_step)
        if len(calls) == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return out
    monkeypatch.setattr(VQGANVQVAEWorker, hook, killing_hook)
    with pytest.raises(SystemExit) as exit_:
        cli.run(["--config", path, "--debug", "--device", "cpu", "--profile", "--epochs", "2"])
    assert exit_.value.code == 143
    assert signal.getsignal(signal.SIGTERM) is handler
    (run_dir,) = glob.glob(str(tmp_path / "zlog" / "*" / "*" / "run_*"))
    assert sorted(os.listdir(os.path.join(run_dir, "ckpt"))) == ["step_00000002.pth"]
    with open(os.path.join(run_dir, "profile", "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    steps = [r["step"] for r in _rows(run_dir)]
    assert steps == ([1, 2, 2] if hook == "save" else [1, 2])


def test_steps_per_dispatch_matches_one_step_a_dispatch(tmp_path, tiny_config):
    """K = 2 over 5 batches (two dispatches and a tail of one): the
    parameters after the epoch equal K = 1's, and the metric rows fall where
    the JAX loop writes them (tests/test_mesh_training.py's loop): at K = 2
    every max(K, save_step // 5) = 2 steps from the first dispatch, none in
    the tail; at K = 1 every step; then the epoch row."""
    runs = {}
    for k in (1, 2):
        cfg, _ = _vq_config(tiny_config, tmp_path, **{"trainer.steps_per_dispatch": k})
        w = _worker(cfg, tmp_path / f"k{k}")
        metrics = w.train(_loader(), 1)
        assert w.global_step == 5 and np.isfinite(metrics["vq_loss"])
        runs[k] = (w, [r["step"] for r in _rows(tmp_path / f"k{k}")])
    assert runs[2][1] == [2, 4, 5] and runs[1][1] == [1, 2, 3, 4, 5, 5]
    want = runs[1][0].state.vqvae.state_dict()
    got = runs[2][0].state.vqvae.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())
