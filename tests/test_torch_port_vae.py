"""The port's VAE family (``models/vae.py``, ``train/vae_worker.py``) against
the JAX package's: the weight map against ``export_vae``, the forward and
the decoder with ε injected, the loss, a 3-step trajectory, gradient
accumulation, the train CLI, resume and ``generate``.

Geometry: the tiny config's VAE at 32² x 3 (channels 16, 32, 32, latent
32 channels on an 8² grid, batch 4), and a copy whose ``latent_size`` is
16, twice the real latent, with attention at 16 (the mismatch of
``configs/training_config_large.yml``: the decoder's attention placed by
the nominal size, samples at ``latent_size`` decoding to 64²). The JAX
params are transplanted; each step's ε is the JAX step's draw from its key.

Tolerances: the forward and the decoder within 1e-4 (f32 sum order through
two dozen convolutions); the loss, the reconstruction term and the KLD
within 1e-5 relative; one step's gradients within GRAD_TOL (1e-4, as the
stage-1 step's: the two sides' gradients agree to about 1.2e-5) of each
live leaf's largest entry; the trajectory by the stage-1 rule (ROADMAP.md §C): every
metric within 1e-4 relative, parameters within 2 lr a step and at least
99% of each live leaf within lr / 10.
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

from vq_vae_gan_diffusion_torch import generate
from vq_vae_gan_diffusion_torch import weights as W
from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.data import load_dataloader as t_load_dataloader
from vq_vae_gan_diffusion_torch.models.vae import VAE as TorchVAE
from vq_vae_gan_diffusion_torch.train import cli
from vq_vae_gan_diffusion_torch.train.vae_worker import VAEWorker as TorchWorker
from vq_vae_gan_diffusion_tpu.models.vae import VAE as JaxVAE
from vq_vae_gan_diffusion_tpu.train.vae_worker import VAEWorker as JaxWorker
from vq_vae_gan_diffusion_tpu.utils.torch_export import export_vae

METRICS = ("recon_loss", "kld", "vae_loss")
BATCH, STEPS = 4, 3
GRAD_TOL, ROUNDING = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: at these sizes torch gains nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _vae_config(tiny_config, mismatch: bool = False):
    cfg = tiny_config.replace_path("architecture.model_name", "vae")
    if mismatch:
        cfg = cfg.replace_path("architecture.vae.latent_size", 16) \
            .replace_path("architecture.vae.attention_resolution", [16])
    return cfg


def _geometry(cfg) -> dict:
    vae = cfg.architecture.vae
    return dict(img_size=32, latent_size=int(vae.latent_size),
                intermediate_channels=list(vae.intermediate_channels),
                n_res_encoder=int(vae.num_residual_blocks_encoder),
                n_res_decoder=int(vae.num_residual_blocks_decoder),
                attn_res=list(vae.attention_resolution))


def _batches(seed: int = 0, n: int = STEPS):
    rs = np.random.RandomState(seed)
    return [rs.uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32) for _ in range(n)]


def _eps(key, real: int = 8) -> torch.Tensor:
    """The ε the JAX VAE draws from ``key`` for a batch's latent."""
    return torch.from_numpy(np.array(jax.random.normal(key, (BATCH, real, real, 32),
                                                        jnp.float32)))


def _port_vae(params, cfg) -> TorchVAE:
    tc = t_config_from_dict(cfg.to_dict())
    vae = TorchVAE.from_config(tc)
    vae.load_state_dict(W.vae_state_from_jax(params, tc), strict=True)
    return vae.eval()


def _jax_params(cfg, seed: int = 0):
    model = JaxVAE.from_config(cfg)
    x = jnp.zeros((1, 32, 32, 3))
    return model, jax.device_get(model.init(jax.random.PRNGKey(seed), x,
                                            jax.random.PRNGKey(1))["params"])


@pytest.mark.parametrize("mismatch", [False, True])
def test_vae_state_matches_export(tiny_config, mismatch):
    """vae_state_from_jax against export_vae, key for key and value for
    value; the port's state_dict has exactly these keys and shapes. At both
    geometries the decoder places attention in its middle and its stages 0
    and 1, by the nominal size (with the mismatched latent, on 8² grids,
    where the real latent's size would place it at stage 2 on 16²)."""
    cfg = _vae_config(tiny_config, mismatch)
    _, params = _jax_params(cfg)
    got = W.vae_state_from_jax(params, t_config_from_dict(cfg.to_dict()))
    want = export_vae(params, **_geometry(cfg))
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k
    port = TorchVAE.from_config(t_config_from_dict(cfg.to_dict())).state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == {k: v.shape for k, v in want.items()}
    n_attn = sum(k.endswith("project_out.weight") for k in want if k.startswith("decoder"))
    assert n_attn == 3


@pytest.mark.parametrize("mismatch", [False, True])
def test_vae_forward_matches_flax(tiny_config, mismatch):
    """The same params, input and ε: decoded images, µ and logσ² within
    1e-4; the decoder on a draw at ``latent_size`` within 1e-4, which at
    the mismatched geometry decodes to 64² images."""
    cfg = _vae_config(tiny_config, mismatch)
    model, params = _jax_params(cfg)
    x = _batches(5, 1)[0]
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda p, x, r: model.apply({"params": p}, x, r))(params, x, key)
    port = _port_vae(params, cfg)
    with torch.no_grad():
        got = port(torch.from_numpy(x), eps=_eps(key))
    for g, w, name in zip(got, want, ("decoded", "mu", "logvar")):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4, err_msg=name)
    g = int(cfg.architecture.vae.latent_size)
    z = np.random.RandomState(8).standard_normal((2, g, g, 32)).astype(np.float32)
    want = jax.jit(lambda p, z: model.apply({"params": p}, z, method=JaxVAE.decode))(params, z)
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z))
    assert tuple(got.shape) == (2, 4 * g, 4 * g, 3) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_vae_init_weights_is_flax_style(tiny_config):
    """init_weights: zero biases, GroupNorm scales of one, kernels within two
    lecun-normal deviations; the same seed draws the same weights."""
    tc = t_config_from_dict(_vae_config(tiny_config).to_dict())
    a, b = TorchVAE.from_config(tc), TorchVAE.from_config(tc)
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert not p.any(), name
        elif "group_norm" in name:
            assert torch.equal(p, torch.ones_like(p)), name
        else:
            std = (1.0 / p[0].numel()) ** 0.5 / 0.87962566103423978
            assert float(p.abs().max()) <= 2 * std * (1 + 1e-6), name


def _port_worker(cfg, params) -> TorchWorker:
    tw = TorchWorker(t_config_from_dict(cfg.to_dict()), tempfile.mkdtemp(), device="cpu")
    tw.init_state()
    tw.state.vae.load_state_dict(_port_vae(params, cfg).state_dict(), strict=True)
    return tw


def test_vae_loss_and_gradients_match_jax(tiny_config):
    """One step from the same weights, batch and ε: the loss, the
    reconstruction term and the KLD (the latent's sum over the image's
    element count) within 1e-5 relative, every gradient within GRAD_TOL of
    its leaf's largest entry where the leaf is live, of the step's largest
    where it is rounding (the conv biases ahead of a GroupNorm, which
    removes them: about 1e-8 on both sides)."""
    cfg = _vae_config(tiny_config)
    jw = JaxWorker(cfg, tempfile.mkdtemp())
    params = jax.device_get(jw.init_state().params)
    x, key = _batches(1, 1)[0], jax.random.PRNGKey(3)
    model, kldw, recf = jw.model, jw.kld_weight, jw.rec_loss_factor

    def loss_fn(p):
        decoded, mu, logvar = model.apply({"params": p}, x, key)
        recon = jnp.mean((decoded - x) ** 2)
        kld = -0.5 * jnp.sum(1 + logvar - mu ** 2 - jnp.exp(logvar)) / x.size
        return recf * recon + kldw * kld, dict(recon_loss=recon, kld=kld)
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tw = _port_worker(cfg, params)
    vae = tw.state.vae
    got, metrics = tw.loss(vae, torch.from_numpy(x), eps=_eps(key))
    got.backward()
    want = dict(aux, vae_loss=loss)
    for k in METRICS:
        np.testing.assert_allclose(float(metrics[k].detach()), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    jgrads = W.vae_state_from_jax(jax.device_get(grads), tw.config)
    top = max(float(g.abs().max()) for g in jgrads.values())
    live = _live({k: p.grad for k, p in vae.named_parameters()})
    assert len(live) > len(jgrads) // 2
    for k, p in vae.named_parameters():
        g, w = p.grad.numpy(), jgrads[k].numpy()
        scale = np.abs(w).max() if k in live else top
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * scale, err_msg=k)


def _live(grads: dict) -> set:
    """The leaves whose largest gradient entry is above ROUNDING of the
    step's largest."""
    top = max(float(g.abs().max()) for g in grads.values())
    return {k for k, g in grads.items() if float(g.abs().max()) > ROUNDING * top}


def _trajectory(cfg, accumulate: int = 1):
    """Both workers through STEPS steps on the same batches and ε: each
    step's metrics and the port's parameters after it, the leaves live at
    the first step, and the JAX worker's final parameters by the port's
    names."""
    if accumulate > 1:
        cfg = cfg.replace_path("trainer.vae.gradient_accumulate_every", accumulate)
    jw = JaxWorker(cfg, tempfile.mkdtemp())
    js = jw.init_state()
    start = jax.device_get(js.params)
    tw = _port_worker(cfg, start)
    ts = tw.state
    first = {k: v.clone() for k, v in ts.vae.state_dict().items()}
    rows = []
    for i, b in enumerate(_batches(2)):
        key = jax.random.PRNGKey(10 + i)
        js, jm = jw.train_step(js, jnp.asarray(b), key)
        ts, tm = tw.train_step(ts, torch.from_numpy(b), eps=_eps(key))
        rows.append(({k: float(v) for k, v in jm.items()}, {k: float(v) for k, v in tm.items()},
                     {k: v.clone() for k, v in ts.vae.state_dict().items()}))
        if i == 0:
            live = _live({k: p.grad for k, p in ts.vae.named_parameters()})
    final = W.vae_state_from_jax(jax.device_get(js.params), tw.config)
    return tw, first, rows, final, live


def _assert_params_close(got: dict, want: dict, lr: float, steps: int, live: set) -> None:
    diffs = {k: (got[k].double() - want[k].double()).abs() for k in want}
    worst = max(diffs, key=lambda k: diffs[k].max())
    assert diffs[worst].max() <= 2 * lr * steps + 1e-6, worst
    for k in live:
        near = (diffs[k] <= lr / 10).double().mean()
        assert near >= 0.99, f"{k}: {100 * float(near):.2f}% within lr / 10"


def test_vae_trajectory_matches_jax(tiny_config):
    """Three Adam steps (β (0.5, 0.9) from trainer.vqvae, eps 1e-8): every
    metric within 1e-4 relative at each step, the parameters by the stage-1
    rule (the live leaves those of the first step); every parameter moved."""
    tw, first, rows, final, live = _trajectory(_vae_config(tiny_config))
    assert tw.betas == (0.5, 0.9) and tw.lr == 1e-4
    for i, (jm, tm, _) in enumerate(rows):
        for k in METRICS:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=f"step {i} {k}")
    last = rows[-1][2]
    _assert_params_close(last, final, tw.lr, STEPS, live)
    assert all(not torch.equal(last[k], first[k]) for k in first)


def test_vae_accumulation_matches_jax(tiny_config):
    """gradient_accumulate_every 2 (optax.MultiSteps in JAX): nothing moves
    at the first step, both apply the mean gradient at the second; metrics
    and parameters as the trajectory's."""
    tw, first, rows, final, live = _trajectory(_vae_config(tiny_config), accumulate=2)
    assert all(torch.equal(rows[0][2][k], first[k]) for k in first)
    assert not all(torch.equal(rows[1][2][k], first[k]) for k in first)
    for i, (jm, tm, _) in enumerate(rows):
        for k in METRICS:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=f"step {i} {k}")
    _assert_params_close(rows[-1][2], final, tw.lr, 2, live)


def _write(tmp_path, cfg, name="vae.yml") -> str:
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg.replace_path("trainer.log_dir", str(tmp_path / "zlog"))
                                   .to_dict()))
    return str(path)


def test_vae_cli_debug_resume_and_generate(tmp_path, tiny_config):
    """--debug on the CPU: two steps, metrics.jsonl, the reconstruction GIF,
    the samples and val grids, a checkpoint; resuming from it goes on at
    step 3; ``generate`` with the export tool's ``{"vae_state_dict": ...}``
    file serves those weights (the val reconstructions equal the VAE's
    with ε from a generator seeded 0) and draws ``--n-samples`` samples at
    ``latent_size``."""
    cfg = _vae_config(tiny_config, mismatch=True)
    config = _write(tmp_path, cfg)
    first = cli.run(["--config", config, "--debug", "--device", "cpu"])
    with open(os.path.join(first["run_dir"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2, 2] and set(METRICS) <= set(rows[1])
    for name in ("reconstruction.gif", "samples_epoch0.jpg", "val_recon_epoch0.jpg"):
        assert os.path.exists(os.path.join(first["run_dir"], name)), name
    ckpt = os.path.join(first["run_dir"], "ckpt", "step_00000002.pth")
    tree = torch.load(ckpt, weights_only=True)
    assert tree["step"] == 2 and tree["state"]["step"] == 2 and "vae" in tree["state"]
    second = cli.run(["--config", config, "--debug", "--device", "cpu"],
                     overrides={"architecture.vae.resume_path": ckpt})
    assert second["worker"].global_step == 4 and second["worker"].state.step == 4

    _, params = _jax_params(cfg, seed=4)
    export = str(tmp_path / "vae_export.pth")
    torch.save({"vae_state_dict": {k: torch.from_numpy(np.array(v)) for k, v in
                                   export_vae(params, **_geometry(cfg)).items()}}, export)
    out = generate.run(["--config", config, "--device", "cpu", "--ckpt", export,
                        "--n-samples", "3"])
    assert tuple(out["images"].shape) == (3, 64, 64, 3) and torch.isfinite(out["images"]).all()
    assert os.path.exists(out["path"]) and os.path.exists(out["recon_path"])
    tc = t_config_from_dict(cfg.to_dict())
    val, _ = t_load_dataloader(None, "val", config=tc, seed=42)
    imgs = torch.from_numpy(next(iter(val))[:3])
    with torch.no_grad():
        want = _port_vae(params, cfg)(imgs, generator=torch.Generator().manual_seed(0))[0]
    torch.testing.assert_close(out["reconstructions"], want, rtol=0, atol=0)
