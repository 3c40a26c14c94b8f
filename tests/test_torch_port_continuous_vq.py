"""The port's continuous VQ-diffusion priors (``c_vqdiffusion``,
``v_vqdiffusion``: ``models/continuous_vq.py``,
``train/continuous_vq_worker.py``) against the JAX package's, and their
CLIs on the CPU.

Geometry: tests/conftest.py::tiny_config (32x32x3 synthetic images, latent
8 -> 64 positions, 64 codes of width 32, 8 linear-schedule steps, all 8
sampled) with the Conv1d U-Net at base 8, mults (1, 2): C's 8 rows or V's
32 codebook channels over the 64 positions, a zeros condition ahead of
them. The JAX U-Net's params and VQVAE are transplanted; the JAX draws
are computed from their keys and injected.

Tolerances: the loss within 1e-5 relative; the sampled indices identical;
a 3-step worker trajectory by tests/test_torch_port_vqd_train.py's rule
(the loss within 1e-5 relative, every parameter within 2 lr a step, in
each live leaf 99% within lr / 10; the EMA the same, moving every step).
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

from test_torch_port_vqd_train import ROUNDING, assert_params_close
from vq_vae_gan_diffusion_torch import generate
from vq_vae_gan_diffusion_torch import weights as W
from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.models import continuous_vq as tcv
from vq_vae_gan_diffusion_torch.train import cli
from vq_vae_gan_diffusion_torch.train.continuous_vq_worker import (
    ContinuousVQDiffusionWorker as TorchWorker)
from vq_vae_gan_diffusion_tpu.models import continuous_vq as jcv
from vq_vae_gan_diffusion_tpu.train.continuous_vq_worker import (
    ContinuousVQDiffusionWorker as JaxWorker)

MODELS = ("c_vqdiffusion", "v_vqdiffusion")
STEPS, BATCH = 3, 4


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: at these sizes torch gains nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _config(tiny_config, model: str, log_dir=None, **paths):
    cfg = tiny_config.replace_path("architecture.model_name", model)
    for path, value in {"architecture.vqdiffusion.unet_base_dim": 8,
                        "architecture.vqdiffusion.unet_dim_mults": [1, 2],
                        **({"trainer.log_dir": str(log_dir)} if log_dir else {}),
                        **paths}.items():
        cfg = cfg.replace_path(path, value)
    return cfg


def _classes(model: str):
    return ((jcv.V_VQDiffusion, tcv.V_VQDiffusion) if model.startswith("v_")
            else (jcv.C_VQDiffusion, tcv.C_VQDiffusion))


@pytest.fixture(scope="module", params=MODELS)
def priors(request, tiny_config):
    """Both priors of one model with the same VQVAE and U-Net."""
    cfg = _config(tiny_config, request.param)
    j_cls, t_cls = _classes(request.param)
    jp, tcfg = j_cls(cfg), t_config_from_dict(cfg.to_dict())
    tp = t_cls(tcfg)
    ch = tp.channels
    params = jax.device_get(jp.unet.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, ch)), None,
                                         jnp.zeros((1,), jnp.int32))["params"])
    vq = jax.device_get(jp.vqvae.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"])
    tp.vqvae.load_state_dict(W.vqvae_state_from_jax(vq, tcfg), strict=True)
    tp.unet.load_state_dict(W.unet1d_state_from_jax(params), strict=True)
    return request.param, jp, tp, params, vq


def test_prior_builds_the_jax_unet(priors):
    """C: indices_width 8 rows; V: the codebook's 32 channels; both with a
    condition input of the same width, over latent_size^2 = 64 positions,
    the linear schedule of 8 steps."""
    model, jp, tp, _, _ = priors
    ch = 32 if model.startswith("v_") else 8
    assert tp.channels == jp.unet.channels == ch and jp.unet.condition
    assert tp.unet.init_conv.in_channels == 2 * ch and tp.unet.final_conv.out_channels == ch
    assert (tp.seq_length, tp.embedding_dim, tp.codebook_size) == (64, 32, 64)
    assert (tp.timesteps, tp.sampling_timesteps) == (8, 8)
    np.testing.assert_array_equal(tp.sched.betas.numpy(), np.asarray(jp.sched.betas))


def test_latent_keys_override_the_defaults(tiny_config):
    """``num_latent_vec`` / ``latent_vec_dim`` replace latent_size^2 /
    latent_channels where the config has them, on both sides."""
    cfg = _config(tiny_config, "v_vqdiffusion", **{"architecture.vqvae.num_latent_vec": 48,
                                                   "architecture.vqvae.latent_vec_dim": 24})
    jp, tp = jcv.V_VQDiffusion(cfg), tcv.V_VQDiffusion(t_config_from_dict(cfg.to_dict()))
    assert (tp.seq_length, tp.embedding_dim) == (jp.seq_length, jp.embedding_dim) == (48, 24)
    assert tp.unet.init_conv.in_channels == 48


def test_loss_matches_jax(priors):
    model, jp, tp, params, vq = priors
    x = np.random.RandomState(9).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    want = jax.jit(jp.loss)(params, vq, jnp.asarray(x), rng)
    rng_t, rng_n = jax.random.split(rng)
    t = _t(jax.random.randint(rng_t, (3,), 0, 8)).long()
    noise = _t(jax.random.normal(rng_n, (3, tp.channels, 64)))
    got = tp.loss(_t(x), t=t, noise=noise)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)


def test_sample_matches_jax(priors):
    """Indices identical with the JAX draws injected: x_T and each DDIM
    step's noise (eta 0: it draws, and adds nothing)."""
    model, jp, tp, params, vq = priors
    rng = jax.random.PRNGKey(12)
    want = np.asarray(jax.jit(lambda p, v, r: jp.sample(p, v, r, 2))(params, vq, rng))
    rng_i, rng_s = jax.random.split(rng)
    x_T = _t(jax.random.normal(rng_i, (2, tp.channels, 64)))
    noise = []
    for _ in range(8):
        rng_s, sub = jax.random.split(rng_s)
        noise.append(_t(jax.random.normal(sub, (2, tp.channels, 64))))
    got = tp.sample(2, x_T=x_T, step_noise=noise)
    assert tuple(got.shape) == (2, 64) and got.dtype == torch.int64
    assert 0 <= int(got.min()) and int(got.max()) < 64
    np.testing.assert_array_equal(got.numpy(), want)


def test_scalar_decode_truncates_as_jax():
    """C's decode: the row mean x K, clipped to [0, K - 1], truncated."""
    cfg = tcv.C_VQDiffusion.__new__(tcv.C_VQDiffusion)
    cfg.codebook_size = 10
    rows = torch.tensor([[[0.05, 0.399, -0.2, 1.5, 0.9999]], [[0.05, 0.401, -0.2, 1.5, 0.9]]])
    got = tcv.C_VQDiffusion.to_indices(cfg, rows.expand(-1, 3, -1))
    assert got.tolist() == [[0, 3, 0, 9, 9], [0, 4, 0, 9, 8]]


@pytest.fixture(scope="module", params=MODELS)
def runs(request, tiny_config):
    """Both workers of one model through three steps (JAX keys 0, 1, 2)."""
    cfg = _config(tiny_config, request.param)
    jw = JaxWorker(cfg, tempfile.mkdtemp())
    js = jax.device_get(jw.init_state())
    tcfg = t_config_from_dict(cfg.to_dict())
    tw = TorchWorker(tcfg, tempfile.mkdtemp(), device="cpu")
    ts = tw.init_state()
    tw.composite.vqvae.load_state_dict(W.vqvae_state_from_jax(js.vq_params, tcfg), strict=True)
    ts.unet.load_state_dict(W.unet1d_state_from_jax(js.unet_params), strict=True)
    ts.ema.load_state_dict(W.unet1d_state_from_jax(js.ema_params), strict=True)
    rs = np.random.RandomState(0)
    out = {"jax": [], "port": [], "grads": None}
    for i in range(STEPS):
        b, key = rs.uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32), jax.random.PRNGKey(i)
        js, jm = jw.train_step(js, jnp.asarray(b), key)
        host = jax.device_get(js)
        out["jax"].append((float(jm["loss"]), W.unet1d_state_from_jax(host.unet_params),
                           W.unet1d_state_from_jax(host.ema_params)))
        rng_t, rng_n = jax.random.split(key)
        t = _t(jax.random.randint(rng_t, (BATCH,), 0, 8)).long()
        noise = _t(jax.random.normal(rng_n, (BATCH, tw.composite.channels, 64)))
        ts, tm = tw.train_step(ts, torch.from_numpy(b), t=t, noise=noise)
        if i == 0:
            out["grads"] = {k: p.grad.clone() for k, p in ts.unet.named_parameters()}
        out["port"].append((float(tm["loss"]),
                            {k: v.clone() for k, v in ts.unet.state_dict().items()},
                            {k: v.clone() for k, v in ts.ema.state_dict().items()}))
    top = max(float(g.abs().max()) for g in out["grads"].values())
    out["live"] = {k for k, g in out["grads"].items() if float(g.abs().max()) > ROUNDING * top}
    out["port_worker"] = tw
    return out


def test_trajectory_matches_jax(runs):
    """Three steps of Adam (trainer.vqdiffusion's lr 1e-4 and betas (0.65,
    0.95)) and the EMA at 0.999 every step."""
    tw = runs["port_worker"]
    group = tw.state.opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"]) == (1e-4, (0.65, 0.95), 1e-8)
    for i in range(STEPS):
        (jl, ju, je), (tl, tu, te) = runs["jax"][i], runs["port"][i]
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"step {i}")
        assert_params_close(tu, ju, i + 1, runs["live"], 1e-4)
        assert_params_close(te, je, i + 1, runs["live"], 1e-4)
        if i:
            assert all(not torch.equal(te[k], runs["port"][i - 1][2][k]) for k in runs["live"])
    assert tw.state.step == STEPS


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("model", MODELS)
def test_train_cli_debug_resume_and_generate(tmp_path, tiny_config, model):
    """--debug on the CPU: two steps, a checkpoint with the frozen VQVAE and
    the EMA, the EMA's samples; resuming goes on at step 3; ``generate
    --ckpt`` on the checkpoint samples the EMA U-Net."""
    data = _config(tiny_config, model, tmp_path / "zlog",
                   **{"architecture.vqdiffusion.diffusion_steps": 3,
                      "architecture.vqdiffusion.sampling_steps": 3}).to_dict()
    config = tmp_path / f"{model}.yml"
    config.write_text(yaml.safe_dump(data))
    first = cli.run(["--config", str(config), "--debug", "--device", "cpu"])
    assert [r["step"] for r in _rows(first["run_dir"])] == [1, 2, 2]
    assert os.path.exists(os.path.join(first["run_dir"], "samples_epoch0.jpg"))
    ckpt = os.path.join(first["run_dir"], "ckpt", "step_00000002.pth")
    tree = torch.load(ckpt, weights_only=True)
    assert set(tree["state"]) == {"vqvae", "unet", "ema", "opt", "step", "updates"}
    second = cli.run(["--config", str(config), "--debug", "--device", "cpu"],
                     overrides={"architecture.vqdiffusion.resume_path": ckpt})
    assert second["worker"].global_step == 4 and second["worker"].state.step == 4
    out = generate.run(["--config", str(config), "--device", "cpu", "--ckpt", ckpt,
                        "--n-samples", "2", "--seed", "3"])
    want = TorchWorker(t_config_from_dict(data), str(tmp_path), seed=3, device="cpu")
    want.init_state()
    want.load(ckpt)
    indices = want.composite.sample(2, torch.Generator().manual_seed(3), want.state.ema)
    assert torch.equal(out["indices"], indices)
    assert tuple(out["images"].shape) == (2, 32, 32, 3)


def test_cli_refuses_without_gpu(tmp_path, tiny_config, monkeypatch):
    config = tmp_path / "cvq.yml"
    config.write_text(yaml.safe_dump(_config(tiny_config, "c_vqdiffusion",
                                             tmp_path / "zlog").to_dict()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (cli.run, generate.run):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(["--config", str(config)])


@pytest.mark.parametrize("name,model", [("cvq", "c_vqdiffusion"), ("vvq", "v_vqdiffusion")])
def test_config_is_the_vqdiffusion_config_with_the_model(name, model):
    """training_config_{cvq,vvq}.yml: training_config_vqdiffusion.yml (the
    full widths of training_config_small.yml on synthetic 256x256x3) with
    the model name and a batch of 20; the diffusion keys come from
    architecture.vqdiffusion."""
    def load(path):
        with open(path) as f:
            return yaml.safe_load(f)
    got, base = load(f"configs/training_config_{name}.yml"), load(
        "configs/training_config_vqdiffusion.yml")
    base["architecture"]["model_name"] = model
    base["dataset"]["batch_size"][model] = {"synthetic": 20}
    assert got == base
    assert model not in got["architecture"]
