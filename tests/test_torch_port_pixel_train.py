"""The port's pixel-space gaussian3d worker (``gaussiandiffusion3d``) against
the JAX package's ``GaussianDiffusion3DWorker``, its init redraw against
``torch_like_reinit``, and its CLIs on the CPU.

Geometry: tests/conftest.py::tiny_config (32x32x3 synthetic images, the
U-Net at base 16 with the worker's mults (2, 4), 8 diffusion steps, EMA
every 2 steps), batch 4. The port takes the JAX worker's weights
transplanted, and the JAX step's draws (t and the noise) are computed from
its key and handed in.

Tolerances: the loss within 1e-5 relative; the OneCycle lr and beta1 and
the EMA decay equal; a 3-step trajectory by tests/test_torch_port_vqd_train.py's
rule (every parameter within 2 lr a step, in each live leaf 99% within
lr / 10), its running statistics within 1e-4 + 0.1 lr k (k - 1) after k
steps (test_trajectory_matches_jax says why).
"""

import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_shuffle import numpy_variables
from test_torch_port_vqd_train import ROUNDING, _jax_t_noise, _unet_state, assert_params_close
from vq_vae_gan_diffusion_torch import generate
from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.models.unet_shuffle import ShuffleUNet as TorchUNet
from vq_vae_gan_diffusion_torch.train import cli
from vq_vae_gan_diffusion_torch.train.gaussian_diffusion_workers import (
    GaussianDiffusion3DWorker as TorchWorker)
from vq_vae_gan_diffusion_torch.utils.ema import adjusted_decay
from vq_vae_gan_diffusion_torch.utils.init_utils import torch_like_reinit as t_reinit
from vq_vae_gan_diffusion_tpu.models.unet_shuffle import ShuffleUNet as JaxUNet
from vq_vae_gan_diffusion_tpu.train.gaussian_diffusion_workers import (
    GaussianDiffusion3DWorker as JaxWorker)
from vq_vae_gan_diffusion_tpu.utils.init_utils import torch_like_reinit as j_reinit
from vq_vae_gan_diffusion_tpu.utils.schedules import torch_onecycle_schedules as j_onecycle

STEPS, BATCH, ITERS = 3, 4, 5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: at these sizes torch gains nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(tiny_config, **paths):
    cfg = tiny_config.replace_path("architecture.model_name", "gaussiandiffusion3d")
    for path, value in paths.items():
        cfg = cfg.replace_path(path, value)
    return cfg


# -- the init redraw -------------------------------------------------------------------

def test_torch_like_reinit_bounds_and_skips():
    """Both redraws change the same leaves (every convolution's and linear
    layer's weight and bias) and keep the same ones (BatchNorm parameters
    and statistics, the time embedding); each redrawn leaf lies within
    1/sqrt(fan_in) of the port module's fan_in on both sides and fills most
    of that interval."""
    unet = JaxUNet(timesteps=8, time_embedding_dim=32, in_channels=3, out_channels=3,
                   base_dim=16, dim_mults=(2, 4))
    x, t = jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32)
    variables = numpy_variables(unet, 0, x, None, t)
    before = _unet_state(variables["params"], variables["batch_stats"])
    redrawn = j_reinit(jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                       jax.random.PRNGKey(1))
    jax_after = _unet_state(redrawn, variables["batch_stats"])
    port = TorchUNet(8, 32, 3, 3, 16, (2, 4))
    port.load_state_dict(before, strict=True)
    t_reinit(port, torch.Generator().manual_seed(1))
    port_after = port.state_dict()
    jax_changed = {k for k in before if not torch.equal(jax_after[k], before[k])}
    port_changed = {k for k in before if not torch.equal(port_after[k], before[k])}
    assert jax_changed == port_changed
    assert not any("running" in k or "time_embedding" in k for k in port_changed)
    modules = dict(port.named_modules())
    redrawn_modules = {name for name, m in modules.items()
                       if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))}
    assert port_changed == {f"{m}.{p}" for m in redrawn_modules for p in ("weight", "bias")}
    for k in port_changed:
        bound = 1 / np.sqrt(modules[k.rsplit(".", 1)[0]].weight[0].numel())
        for side in (jax_after, port_after):
            top = float(side[k].abs().max())
            assert top <= bound * (1 + 1e-6), k
            assert side[k].numel() < 8 or top > 0.5 * bound, k


# -- the worker ------------------------------------------------------------------------

def port_worker(jax_worker, cfg, state) -> TorchWorker:
    """A port worker on the CPU carrying the JAX worker's U-Net and EMA copy,
    with a fresh optimizer."""
    tw = TorchWorker(t_config_from_dict(cfg.to_dict()), tempfile.mkdtemp(), device="cpu",
                     num_iters_per_epoch=ITERS)
    ts = tw.init_state()
    state = jax.device_get(state)
    ts.unet.load_state_dict(_unet_state(state.params, state.batch_stats), strict=True)
    ts.ema.load_state_dict(_unet_state(state.ema_params, state.ema_batch_stats), strict=True)
    return tw


@pytest.fixture(scope="module")
def runs(tiny_config):
    """Both workers through the same three steps (JAX keys 0, 1, 2): each
    step's loss, U-Net and EMA states; the port's first-step gradients."""
    cfg = _config(tiny_config)
    jw = JaxWorker(cfg, tempfile.mkdtemp(), num_iters_per_epoch=ITERS)
    js = jw.init_state()
    tw = port_worker(jw, cfg, js)
    ts = tw.state
    rs = np.random.RandomState(0)
    out = {"jax": [], "port": [], "grads": None}
    for i in range(STEPS):
        b, key = rs.uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32), jax.random.PRNGKey(i)
        js, jm = jw.train_step(js, jnp.asarray(b), key)
        host = jax.device_get(js)
        out["jax"].append((float(jm["loss"]), _unet_state(host.params, host.batch_stats),
                           _unet_state(host.ema_params, host.ema_batch_stats)))
        t, noise = _jax_t_noise(key, b.shape, jw.process.timesteps)
        ts, tm = tw.train_step(ts, torch.from_numpy(b), t=t, noise=noise)
        if i == 0:
            out["grads"] = {k: p.grad.clone() for k, p in ts.unet.named_parameters()}
        out["port"].append((float(tm["loss"]),
                            {k: v.clone() for k, v in ts.unet.state_dict().items()},
                            {k: v.clone() for k, v in ts.ema.state_dict().items()}))
    top = max(float(g.abs().max()) for g in out["grads"].values())
    out["live"] = {k for k, g in out["grads"].items() if float(g.abs().max()) > ROUNDING * top}
    out["lr"] = max(tw.lr_fn(i) for i in range(STEPS))
    out["hyper"] = {k: float(v) for k, v in jax.device_get(js.opt_state.hyperparams).items()}
    out["port_worker"], out["jax_worker"] = tw, jw
    return out


def test_worker_builds_the_jax_unet(runs):
    """The U-Net of the worker: mults (2, 4) over the images' channels, the
    same leaves as the JAX worker's."""
    tw, jw = runs["port_worker"], runs["jax_worker"]
    unet = tw.state.unet
    assert [b.conv1.branch1[2].module[0].out_channels * 2 for b in unet.encoder_blocks] \
        == [32, 64]
    assert unet.init_conv.module[0].in_channels == unet.final_conv.out_channels == 3
    assert set(unet.state_dict()) == set(runs["jax"][0][1])
    assert (jw.unet.base_dim, tuple(jw.unet.dim_mults)) == (16, (2, 4))


def test_worker_loss_matches_jax(runs):
    for i in range(STEPS):
        np.testing.assert_allclose(runs["port"][i][0], runs["jax"][i][0], rtol=1e-5,
                                   err_msg=f"step {i}")


def test_worker_schedule_matches_jax(runs):
    """OneCycle over max(epochs x iters, 10) = 10 updates: the port's lr and
    beta1 equal the JAX schedule's at every step and 10 past it; the last
    update's equal the JAX optimizer's within one float32 ulp (there the
    schedule runs inside the jitted step, whose cosine rounds its own way);
    AdamW's beta2 0.999 and weight decay 0.01."""
    tw, hyper = runs["port_worker"], runs["hyper"]
    assert tw.total_steps == 10 and tw.state.updates == STEPS
    j_lr, j_b1 = j_onecycle(10, 1e-3)
    group = tw.state.opt.param_groups[0]
    assert group["lr"] == float(j_lr(STEPS - 1))
    assert group["betas"] == (float(j_b1(STEPS - 1)), 0.999)
    for got, key in ((group["lr"], "learning_rate"), (group["betas"][0], "b1")):
        np.testing.assert_array_max_ulp(np.float32(got), np.float32(hyper[key]), maxulp=1)
    assert group["weight_decay"] == 0.01 and np.float32(hyper["weight_decay"]) == np.float32(0.01)
    for i in range(20):
        assert tw.lr_fn(i) == float(j_lr(i)) and tw.b1_fn(i) == float(j_b1(i))


@pytest.mark.parametrize("decay,epochs", [(0.995, 1), (0.9999999, 100)])
def test_ema_decay_is_the_jax_workers_line(tiny_config, decay, epochs):
    """The worker's decay is the JAX worker's own unclamped line, not
    utils/ema.adjusted_decay, which clamps at 0.999999 (the second case)."""
    cfg = _config(tiny_config, **{"trainer.gaussiandiffusion3d.model_ema_decay": decay,
                                  "trainer.num_epochs": epochs})
    jw = JaxWorker(cfg, tempfile.mkdtemp())
    tw = TorchWorker(t_config_from_dict(cfg.to_dict()), tempfile.mkdtemp(), device="cpu")
    assert tw.ema_decay == jw.ema_decay == 1.0 - min(1.0, (1.0 - decay) * 8 * 2 / epochs)
    clamped = adjusted_decay(decay, 8, 0, 2, epochs)
    assert (clamped == tw.ema_decay) == (decay < 0.9999)


def test_trajectory_matches_jax(runs):
    """Three steps: U-Net parameters and running statistics, and the EMA's,
    which moves at steps 0 and 2 (every model_ema_steps = 2). The running
    means carry the gap of the conv biases ahead of their BatchNorms: those
    have a zero gradient but for rounding, so Adam moves each by about lr
    with each side's own sign, up to 2 lr s apart after s updates, and the
    batch mean of step k (momentum 0.1) sees the biases after k - 1: the
    running means may lie 1e-4 + 0.1 lr k (k - 1) apart after k steps (at
    this worker's lr of 1e-3; the vqdiffusion worker's 1e-4 keeps that
    within its 1e-4)."""
    lr = runs["lr"]
    for i in range(STEPS):
        (_, ju, je), (_, tu, te) = runs["jax"][i], runs["port"][i]
        stats = 1e-4 + 0.1 * lr * (i + 1) * i
        assert_params_close(tu, ju, i + 1, runs["live"], lr, stats)
        assert_params_close(te, je, i + 1, runs["live"], lr, stats)


def test_ema_statistics_copied_on_ema_steps(runs):
    """The EMA's batch statistics equal the live ones after steps 0 and 2
    and keep step 0's after step 1; its parameters stay put at step 1."""
    for i in range(STEPS):
        _, tu, te = runs["port"][i]
        stats = [k for k in tu if "running" in k]
        same = all(torch.equal(te[k], tu[k]) for k in stats)
        assert same == (i != 1), f"step {i}: EMA statistics copied: {same}"
    (_, u0, e0), (_, _, e1) = runs["port"][0], runs["port"][1]
    assert all(torch.equal(e1[k], e0[k]) for k in e0)
    assert any(not torch.equal(e0[k], u0[k]) for k in runs["live"])


# -- the CLIs on the CPU ---------------------------------------------------------------

def _write(tmp_path, name: str, data: dict) -> str:
    path = tmp_path / name
    path.write_text(yaml.safe_dump(data))
    return str(path)


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_debug_resume_and_generate(tmp_path, tiny_config):
    """--debug on the CPU: two steps, metrics.jsonl, a checkpoint with the
    EMA and no VQVAE, the EMA's 4 samples. Resuming from the checkpoint goes
    on at step 3 with the schedule's count; ``generate --ckpt`` on it
    samples the EMA U-Net, and on a bare U-Net state_dict (the export
    tool's form) samples that U-Net."""
    data = _config(tiny_config, **{"trainer.log_dir": str(tmp_path / "zlog"),
                                   "architecture.gaussiandiffusion3d.diffusion_steps": 3,
                                   "architecture.gaussiandiffusion3d.sampling_steps": 3
                                   }).to_dict()
    config = _write(tmp_path, "pixel.yml", data)
    first = cli.run(["--config", config, "--debug", "--device", "cpu"])
    rows = _rows(first["run_dir"])
    assert [r["step"] for r in rows] == [1, 2, 2]
    assert all(np.isfinite(r["loss"]) for r in rows[:2])
    assert os.path.exists(os.path.join(first["run_dir"], "samples_epoch0.jpg"))
    ckpt = os.path.join(first["run_dir"], "ckpt", "step_00000002.pth")
    tree = torch.load(ckpt, weights_only=True)
    assert tree["step"] == 2 and tree["state"]["step"] == 2 and tree["state"]["updates"] == 2
    assert set(tree["state"]) == {"unet", "ema", "opt", "step", "updates"}
    assert any(not torch.equal(tree["state"]["ema"][k], v)
               for k, v in tree["state"]["unet"].items() if "running" not in k)

    second = cli.run(["--config", config, "--debug", "--device", "cpu"],
                     overrides={"architecture.gaussiandiffusion3d.resume_path": ckpt})
    state = second["worker"].state
    assert second["worker"].global_step == 4 and state.step == 4 and state.updates == 4
    assert [r["step"] for r in _rows(second["run_dir"])] == [3, 4, 4]

    want = TorchWorker(t_config_from_dict(data), str(tmp_path), seed=3, device="cpu")
    want.init_state()
    ema = want.build_unet()
    ema.load_state_dict(tree["state"]["ema"], strict=True)
    bare = str(tmp_path / "unet.pth")
    torch.save(tree["state"]["unet"], bare)
    live = want.build_unet()
    live.load_state_dict(tree["state"]["unet"], strict=True)
    for path, unet in ((ckpt, ema), (bare, live)):
        out = generate.run(["--config", config, "--device", "cpu", "--ckpt", path,
                            "--n-samples", "2", "--seed", "3"])
        images = want.sample(2, generator=torch.Generator().manual_seed(3), unet=unet)
        assert tuple(out["images"].shape) == (2, 32, 32, 3)
        assert torch.equal(out["images"], images), path
        assert os.path.exists(out["path"])


def test_cli_refuses_without_gpu(tmp_path, tiny_config, monkeypatch):
    """No GPU and no --device cpu: training and generation raise."""
    data = _config(tiny_config, **{"trainer.log_dir": str(tmp_path / "zlog")}).to_dict()
    config = _write(tmp_path, "pixel.yml", data)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (cli.run, generate.run):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(["--config", config])


def test_pixel_config_is_the_mnist_config_with_one_change():
    def load(path):
        with open(path) as f:
            return yaml.safe_load(f)
    got, base = load("configs/training_config_pixel3d.yml"), load(
        "configs/training_config_mnist.yml")
    base["architecture"]["model_name"] = "gaussiandiffusion3d"
    assert got == base
    assert got["dataset"]["batch_size"]["gaussiandiffusion3d"] == {"mnist": 500}
