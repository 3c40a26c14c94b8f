"""The port's gaussian3d VQ-diffusion prior training (``vqdiffusion``,
``diffusion_type: gaussiandiffusion3d``) against the JAX package's
``VQDiffusionWorker`` and its pieces, and its CLI on the CPU.

Geometry: tests/conftest.py::tiny_config (latent 8 -> 64 tokens, vocab 64,
gaussian_dim 16, 8 diffusion steps, EMA every 2 steps) with the U-Net cut
to base 16, mults (1, 2), batch 4. The port takes the JAX worker's weights
transplanted, and the JAX step's draws (t and the noise) are computed from
its key and handed in.

Tolerances:

- the U-Net in train mode: output within 1e-4 of flax's
  ``mutable=["batch_stats"]`` call, the updated running statistics within
  1e-5 (flax's running variance is E[x^2] - E[x]^2, the port's the mean
  squared deviation: the same biased variance, other rounding);
- the losses (noise MSE, ELBO, the VQ wrapper's with ``indices_recon``)
  within 1e-5 relative, the argmax indices of the recon term identical;
- the OneCycle lr and beta1 equal at every step of a 40-step schedule and
  10 steps past it; within one float32 ulp over a 1000-step schedule (the
  two cosines differ in rounding at 2 of its 1010 steps);
- the filmstrip's indices identical;
- a 3-step trajectory: metrics within 1e-5 relative; U-Net and EMA
  parameters by tests/test_torch_port_vqgan.py's rule (every entry within
  2 lr a step, in each live leaf 99% within lr / 10, lr the schedule's
  largest over the steps); running statistics and the EMA's within 1e-4,
  PR 11's rule for them: the conv bias ahead of each BatchNorm has a zero
  gradient but for rounding, so Adam moves it by about lr with each side's
  own sign, and the batch means the statistics follow carry that.
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

from test_torch_port_diffusion import _jax_noise
from test_torch_port_gpt_train import stage1_checkpoint
from test_torch_port_shuffle import numpy_variables
from vq_vae_gan_diffusion_torch import generate
from vq_vae_gan_diffusion_torch import weights as W
from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.diffusion import gaussian3d as tg3
from vq_vae_gan_diffusion_torch.models.unet_shuffle import ShuffleUNet as TorchUNet
from vq_vae_gan_diffusion_torch.train import cli
from vq_vae_gan_diffusion_torch.train.vq_diffusion_worker import VQDiffusionWorker as TorchWorker
from vq_vae_gan_diffusion_torch.utils.ema import adjusted_decay as t_adjusted_decay
from vq_vae_gan_diffusion_torch.utils.schedules import torch_onecycle_schedules as t_onecycle
from vq_vae_gan_diffusion_tpu.diffusion import gaussian3d as jg3
from vq_vae_gan_diffusion_tpu.models.unet_shuffle import ShuffleUNet as JaxUNet
from vq_vae_gan_diffusion_tpu.train.vq_diffusion_worker import VQDiffusionWorker as JaxWorker
from vq_vae_gan_diffusion_tpu.utils.ema import adjusted_decay as j_adjusted_decay
from vq_vae_gan_diffusion_tpu.utils.schedules import torch_onecycle_schedules as j_onecycle

STEPS, BATCH, ITERS = 3, 4, 5
ROUNDING = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: at these sizes torch gains nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(tiny_config, **paths):
    cfg = tiny_config.replace_path("architecture.model_name", "vqdiffusion")
    for path, value in {"architecture.vqdiffusion.unet_base_dim": 16,
                        "architecture.vqdiffusion.unet_dim_mults": [1, 2], **paths}.items():
        cfg = cfg.replace_path(path, value)
    return cfg


def _unet_state(params, stats) -> dict:
    return W.shuffle_unet_state_from_jax(jax.device_get(params), jax.device_get(stats))


def _jax_model(x, self_cond, t):
    return 0.5 * jnp.tanh(x) + 0.01 * t[:, None, None, None].astype(jnp.float32)


def _torch_model(x, self_cond, t):
    return 0.5 * torch.tanh(x) + 0.01 * t[:, None, None, None].float()


def _jax_t_noise(rng, shape, timesteps):
    """The t and noise a JAX loss draws from ``rng``."""
    rng_t, rng_n = jax.random.split(rng)
    t = jax.random.randint(rng_t, (shape[0],), 0, timesteps)
    noise = jax.random.normal(rng_n, shape, jnp.float32)
    return torch.from_numpy(np.array(t)).long(), torch.from_numpy(np.array(noise))


# -- the pieces ----------------------------------------------------------------------

def test_unet_train_mode_matches_flax():
    """One train-mode forward: the output and the moved running statistics
    of every BatchNorm, from non-trivial starting statistics."""
    unet = JaxUNet(timesteps=10, time_embedding_dim=32, in_channels=1, out_channels=1,
                   base_dim=16, dim_mults=(1, 2))
    x = np.random.RandomState(0).standard_normal((3, 32, 16, 1)).astype(np.float32)
    t = np.array([3, 7, 0], np.int32)
    variables = numpy_variables(unet, 1, jnp.asarray(x), None, jnp.asarray(t))
    want, upd = jax.jit(lambda v, x, t: unet.apply(v, x, None, t, train=True,
                                                   mutable=["batch_stats"]))(
        variables, jnp.asarray(x), jnp.asarray(t))
    port = TorchUNet(10, 32, 1, 1, 16, (1, 2))
    port.load_state_dict(_unet_state(variables["params"], variables["batch_stats"]), strict=True)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    got = port.train()(torch.from_numpy(x), None, torch.from_numpy(t).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    moved = _unet_state(variables["params"], upd["batch_stats"])
    stats = [k for k in moved if "running" in k]
    assert len(stats) > 100
    for k in stats:
        torch.testing.assert_close(port.state_dict()[k], moved[k], rtol=0, atol=1e-5, msg=k)
        assert not torch.equal(port.state_dict()[k], before[k]), k
    assert all(torch.equal(port.state_dict()[k], before[k]) for k in moved
               if "num_batches" in k)


@pytest.mark.parametrize("timesteps", [4, 50])
@pytest.mark.parametrize("loss_fn", ["noise_mse", "elbo"])
def test_gaussian3d_loss_matches_jax(loss_fn, timesteps):
    """GaussianDiffusion3D.loss on the same x0 with the JAX draws of three
    keys injected; over 4 steps they draw t = 0 too (the ELBO's clipped
    posterior variance)."""
    kw = dict(image_sizes=(16, 8), in_channels=1, timesteps=timesteps,
              sampling_timesteps=timesteps, loss_fn=loss_fn)
    jd = jg3.GaussianDiffusion3D(model_fn=_jax_model, **kw)
    td = tg3.GaussianDiffusion3D(model_fn=_torch_model, **kw)
    x0 = np.random.RandomState(1).uniform(-1, 1, (6, 16, 8, 1)).astype(np.float32)
    loss = jax.jit(jd.loss)
    drawn = set()
    for seed in range(3):
        rng = jax.random.PRNGKey(seed)
        want = float(loss(jnp.asarray(x0), rng))
        t, noise = _jax_t_noise(rng, x0.shape, timesteps)
        drawn |= set(t.tolist())
        got = float(td.loss(torch.from_numpy(x0), t=t, noise=noise))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"seed {seed}")
    assert timesteps > 4 or drawn == {0, 1, 2, 3}


def test_vq_gaussian3d_loss_matches_jax():
    """The VQ wrapper's loss with indices_recon: the value, the metrics, and
    the recon term absent from the gradient."""
    kw = dict(seq_length=16, timesteps=20, sampling_timesteps=20, vocab_size=64,
              gaussian_dim=8, compute_indices_recon_loss=True)
    jp = jg3.VQGaussianDiffusion3D(model_fn=_jax_model, **kw)
    tp = tg3.VQGaussianDiffusion3D(model_fn=None, **kw)
    scale = torch.ones((), requires_grad=True)
    tp.diffusion.model_fn = lambda x, s, t: scale * _torch_model(x, s, t)
    idx = np.random.RandomState(3).randint(0, 64, (4, 16))
    rng = jax.random.PRNGKey(7)
    loss, metrics = jax.jit(jp.loss)(jnp.asarray(idx), rng)
    t, noise = _jax_t_noise(rng, (4, 16, 8, 1), 20)
    got, got_metrics = tp.loss(torch.from_numpy(idx), t=t, noise=noise)
    assert set(got_metrics) == set(metrics) == {"noise_mse", "indices_recon", "loss"}
    for k in metrics:
        np.testing.assert_allclose(float(got_metrics[k].detach()), float(metrics[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(metrics["indices_recon"]) > 0
    total, = torch.autograd.grad(got, scale)
    mse, = torch.autograd.grad(tp.loss(torch.from_numpy(idx), t=t, noise=noise)[1]["noise_mse"],
                               scale)
    assert torch.equal(total, mse)


def test_onecycle_matches_jax():
    """lr and beta1 at every step of a 40-step schedule and 10 past it, the
    clamp holding the last value; the same refusal at pct_start * total <= 1."""
    for total, ulps in ((40, 0), (1000, 1)):
        t_lr, t_b1 = t_onecycle(total, 1e-4)
        j_lr, j_b1 = j_onecycle(total, 1e-4)
        steps = jnp.arange(total + 10)
        for got_fn, want_fn in ((t_lr, j_lr), (t_b1, j_b1)):
            want = np.asarray(jax.vmap(want_fn)(steps))
            got = np.array([got_fn(int(s)) for s in steps], np.float32)
            if ulps:
                np.testing.assert_array_max_ulp(got, want, maxulp=ulps)
            else:
                np.testing.assert_array_equal(got, want)
        assert t_lr(total + 9) == t_lr(total - 1)
    for total in (4, 3):
        with pytest.raises(ValueError, match="too small") as got:
            t_onecycle(total, 1e-3)
        with pytest.raises(ValueError, match="too small") as want:
            j_onecycle(total, 1e-3)
        assert str(got.value) == str(want.value)


def test_adjusted_decay_matches_jax():
    for args in ((0.995, 8, 100, 10, 60), (0.995, 200, 1, 10, 1), (0.9999, 1, 1, 1, 0)):
        assert t_adjusted_decay(*args) == j_adjusted_decay(*args)


@pytest.mark.parametrize("method,steps", [("ddpm", 48), ("ddim", 49)])
def test_filmstrip_matches_jax(method, steps):
    """return_all_timestamps: every steps // 24-th state counted back from
    the last, decoded to [B, F, N] indices identical to JAX's with its noise
    injected; the last frame is the sample."""
    kw = dict(seq_length=16, timesteps=steps, sampling_timesteps=steps, vocab_size=64,
              gaussian_dim=8, sample_method=method, return_all_timestamps=True,
              clipped_reverse_diffusion=True)
    jp = jg3.VQGaussianDiffusion3D(model_fn=_jax_model, **kw)
    tp = tg3.VQGaussianDiffusion3D(model_fn=_torch_model, **kw)
    rng = jax.random.PRNGKey(11)
    want = np.asarray(jax.jit(lambda r: jp.sample(r, 2))(rng))
    n_steps = steps if method == "ddpm" else len(tp.diffusion.ddim_times()) - 1
    x_t, noise = _jax_noise(rng, (2, 16, 8, 1), n_steps)
    got = tp.sample(2, x_T=x_t, step_noise=noise)
    assert got.shape == want.shape == (2, 24, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    tp.return_all_timestamps = False
    np.testing.assert_array_equal(tp.sample(2, x_T=x_t, step_noise=noise).numpy(), want[:, -1])


# -- the worker ------------------------------------------------------------------------

def _jax_step_draws(jax_worker, rng):
    c = jax_worker.composite
    return _jax_t_noise(rng, (BATCH, c.seq_len, c.gaussian_dim, 1), c.timesteps)


def port_worker(jax_worker, cfg, state) -> TorchWorker:
    """A port worker on the CPU carrying the JAX worker's VQVAE, U-Net and
    EMA copy, with a fresh optimizer."""
    tc = t_config_from_dict(cfg.to_dict())
    tw = TorchWorker(tc, tempfile.mkdtemp(), device="cpu", num_iters_per_epoch=ITERS)
    ts = tw.init_state()
    state = jax.device_get(state)
    tw.composite.vqvae.load_state_dict(W.vqvae_state_from_jax(state.vq_params, tc), strict=True)
    ts.unet.load_state_dict(_unet_state(state.unet_params, state.unet_batch_stats), strict=True)
    ts.ema.load_state_dict(_unet_state(state.ema_params, state.ema_batch_stats), strict=True)
    return tw


def assert_params_close(got: dict, want: dict, steps: int, live: set, lr: float,
                        stats_atol: float = 1e-4, stats_rtol: float = 0.0) -> None:
    params = [k for k in want if "running" not in k and "num_batches" not in k]
    diffs = {k: (got[k].double() - want[k].double()).abs() for k in params}
    worst = max(diffs, key=lambda k: diffs[k].max())
    assert diffs[worst].max() <= 2 * lr * steps + 1e-6, worst
    for k in live:
        near = (diffs[k] <= lr / 10).double().mean()
        assert near >= 0.99, f"{k}: {100 * float(near):.2f}% within lr / 10"
    for k in want:
        if "running" in k:
            torch.testing.assert_close(got[k], want[k], rtol=0, msg=k,
                                       atol=stats_atol + stats_rtol * float(want[k].abs().max()))


@pytest.fixture(scope="module")
def runs(tiny_config):
    """Both workers through the same three steps (JAX keys 0, 1, 2): each
    step's metrics, U-Net and EMA states; the port's first-step gradients."""
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
        out["jax"].append(({k: float(v) for k, v in jm.items()},
                           _unet_state(host.unet_params, host.unet_batch_stats),
                           _unet_state(host.ema_params, host.ema_batch_stats)))
        t, noise = _jax_step_draws(jw, key)
        ts, tm = tw.train_step(ts, torch.from_numpy(b), t=t, noise=noise)
        if i == 0:
            out["grads"] = {k: p.grad.clone() for k, p in ts.unet.named_parameters()}
        out["port"].append(({k: float(v) for k, v in tm.items()},
                            {k: v.clone() for k, v in ts.unet.state_dict().items()},
                            {k: v.clone() for k, v in ts.ema.state_dict().items()}))
    top = max(float(g.abs().max()) for g in out["grads"].values())
    out["live"] = {k for k, g in out["grads"].items() if float(g.abs().max()) > ROUNDING * top}
    out["lr"] = max(tw.lr_fn(i) for i in range(STEPS))
    out["port_worker"], out["jax_worker"] = tw, jw
    return out


def test_worker_schedule_and_ema_decay_match_jax(runs):
    tw, jw = runs["port_worker"], runs["jax_worker"]
    assert tw.total_steps == 10 and tw.ema_decay == jw.ema_decay
    assert tw.state.updates == STEPS
    group = tw.state.opt.param_groups[0]
    assert group["lr"] == tw.lr_fn(STEPS - 1) and group["betas"] == (tw.b1_fn(STEPS - 1), 0.95)
    assert group["weight_decay"] == 0.01


def test_trajectory_matches_jax(runs):
    """Three steps: metrics, U-Net parameters and running statistics, and
    the EMA's, which moves at steps 0 and 2 (every model_ema_steps = 2) and
    copies the live statistics there."""
    for i in range(STEPS):
        (jm, ju, je), (tm, tu, te) = runs["jax"][i], runs["port"][i]
        assert set(tm) == set(jm) == {"noise_mse", "indices_recon", "loss"}
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=f"step {i} {k}")
        assert_params_close(tu, ju, i + 1, runs["live"], runs["lr"])
        assert_params_close(te, je, i + 1, runs["live"], runs["lr"])
        stats = [k for k in tu if "running" in k]
        same = all(torch.equal(te[k], tu[k]) for k in stats)
        assert same == (i != 1), f"step {i}: EMA statistics copied: {same}"
    (_, u0, e0), (_, u1, e1) = runs["port"][0], runs["port"][1]
    assert all(torch.equal(e1[k], e0[k]) for k in e0)
    assert any(not torch.equal(e0[k], u0[k]) for k in runs["live"])


# -- the CLI on the CPU ----------------------------------------------------------------

def _write(tmp_path, name: str, data: dict) -> str:
    path = tmp_path / name
    path.write_text(yaml.safe_dump(data))
    return str(path)


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_debug_resume_and_generate(tmp_path, tiny_config):
    """--debug on the CPU over a stage-1 checkpoint, with the filmstrip on:
    two steps, metrics.jsonl, a checkpoint with the EMA, the recon grid, the
    EMA's samples and filmstrip. Resuming from the diffusion checkpoint
    goes on at step 3 with the schedule's count; ``generate --ckpt`` on it
    samples the EMA U-Net with the EMA statistics."""
    stage1 = stage1_checkpoint(tmp_path, tiny_config)
    data = _config(tiny_config, **{"trainer.log_dir": str(tmp_path / "zlog"),
                                   "architecture.vqvae.resume_path": stage1,
                                   "architecture.vqdiffusion.diffusion_steps": 3,
                                   "architecture.vqdiffusion.return_all_timestamps": True
                                   }).to_dict()
    config = _write(tmp_path, "vqd.yml", data)
    first = cli.run(["--config", config, "--debug", "--device", "cpu"])
    rows = _rows(first["run_dir"])
    assert [r["step"] for r in rows] == [1, 2, 2]
    assert all({"noise_mse", "indices_recon", "loss"} <= set(r) for r in rows[:2])
    for name in ("recon_epoch0_0.jpg", "samples_epoch0.jpg", "filmstrip_epoch0.jpg"):
        assert os.path.exists(os.path.join(first["run_dir"], name)), name
    ckpt = os.path.join(first["run_dir"], "ckpt", "step_00000002.pth")
    tree = torch.load(ckpt, weights_only=True)
    assert tree["step"] == 2 and tree["state"]["step"] == 2 and tree["state"]["updates"] == 2
    assert {"vqvae", "unet", "ema", "opt"} <= set(tree["state"])
    frozen = torch.load(stage1, weights_only=True)["state"]["vqvae"]
    assert all(torch.equal(tree["state"]["vqvae"][k], v) for k, v in frozen.items())
    assert any(not torch.equal(tree["state"]["ema"][k], v)
               for k, v in tree["state"]["unet"].items() if "running" not in k)

    second = cli.run(["--config", config, "--debug", "--device", "cpu"],
                     overrides={"architecture.vqdiffusion.resume_path": ckpt})
    state = second["worker"].state
    assert second["worker"].global_step == 4 and state.step == 4 and state.updates == 4
    assert [r["step"] for r in _rows(second["run_dir"])] == [3, 4, 4]

    data["architecture"]["vqdiffusion"]["return_all_timestamps"] = False
    config = _write(tmp_path, "vqd_serve.yml", data)
    out = generate.run(["--config", config, "--device", "cpu", "--ckpt", ckpt,
                        "--n-samples", "2", "--seed", "3"])
    want = TorchWorker(t_config_from_dict(data), str(tmp_path), seed=3, device="cpu")
    want.init_state()
    ema = TorchUNet(3, 256, 1, 1, 16, (1, 2))
    ema.load_state_dict(tree["state"]["ema"], strict=True)
    indices = want.composite.sample(2, generator=torch.Generator().manual_seed(3), unet=ema)
    assert torch.equal(out["indices"], indices)
    assert torch.equal(out["images"], want.composite.z_to_image(indices))


def test_train_cli_refuses_without_gpu(tmp_path, tiny_config, monkeypatch):
    """No GPU and no --device cpu: the diffusion prior's training raises."""
    data = _config(tiny_config, **{"trainer.log_dir": str(tmp_path / "zlog")}).to_dict()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.run(["--config", _write(tmp_path, "vqd.yml", data), "--debug"])
