"""The port's ``GaussianDiffusion2D`` (``diffusion/gaussian2d.py``), its
lookup table, and the two VQ-diffusion priors that run the Conv1d U-Net
(``gaussiandiffusion2d``, and VQ_Official with ``unet_dim: 2``) against the
JAX package's, through the composite, the worker and the CLIs on the CPU.

Geometry: the process alone on [3, 6, 5] states over 6 steps with a fixed
elementwise denoiser; the gaussian2d prior on tests/conftest.py::tiny_config
(latent 8 -> 64 tokens, vocab 64, gaussian_dim 16: the U-Net's 64 channels
over length 16), the VQ_Official prior on K 32 classes over 16 tokens
(latent 4x4, 10 steps, 3 sampled), both U-Nets at base 8, mults (1, 2),
batch 3 (the worker 4). The JAX U-Net's params and the VQVAE are
transplanted; the JAX draws are computed from their keys and injected.

Tolerances: the lookup table bit for bit; the process's loss within 1e-6
and its chains within 1e-5 (indices identical); the composites' losses
within 1e-5 relative and their sampled indices identical; a 3-step worker
trajectory by tests/test_torch_port_vqd_train.py's rule (metrics within
1e-5 relative, every parameter within 2 lr a step, in each live leaf 99%
within lr / 10; VQ_Official's by tests/test_torch_port_discrete_train.py's
rule for its prior, test_trajectory_matches_jax says why).
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

from test_torch_port_discrete import _jax_noise, _vqofficial
from test_torch_port_discrete_train import assert_params_explained, jax_draws
from test_torch_port_vqd_train import ROUNDING, assert_params_close
from vq_vae_gan_diffusion_torch import generate
from vq_vae_gan_diffusion_torch import weights as W
from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.diffusion import gaussian2d as tg2
from vq_vae_gan_diffusion_torch.models.unet1d import Unet1D as TorchUnet1D
from vq_vae_gan_diffusion_torch.models.vq_diffusion_composite import (
    VQDiffusionComposite as TorchComposite)
from vq_vae_gan_diffusion_torch.train import cli
from vq_vae_gan_diffusion_torch.train.vq_diffusion_worker import VQDiffusionWorker as TorchWorker
from vq_vae_gan_diffusion_tpu.diffusion import discrete as jd
from vq_vae_gan_diffusion_tpu.diffusion import gaussian2d as jg2
from vq_vae_gan_diffusion_tpu.models.vq_diffusion_composite import (
    VQDiffusionComposite as JaxComposite)
from vq_vae_gan_diffusion_tpu.train.vq_diffusion_worker import VQDiffusionWorker as JaxWorker
from vq_vae_gan_diffusion_tpu.utils.torch_export import export_unet1d

PRIORS = ("gaussian2d", "vqofficial1d")
STEPS, BATCH, ITERS = 3, 4, 5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: at these sizes torch gains nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# -- the lookup table ---------------------------------------------------------------------

@pytest.mark.parametrize("seed,shape", [(0, (1024, 96)), (0, (64, 16)), (0, (5, 7)),
                                        (7, (33, 3))])
def test_lookup_table_is_jax_draw_bit_for_bit(seed, shape):
    """jax_uniform is jax.random.uniform(PRNGKey(seed), shape) bit for bit,
    at the shipped configs' [1024, 96], the tiny config's [64, 16] and odd
    shapes; the process's table is the seed-0 draw."""
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, jnp.float32))
    got = tg2.jax_uniform(seed, shape)
    assert got.dtype == np.float32 and got.shape == tuple(shape)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if seed == 0:
        cfg = tg2.GaussianDiffusion2DConfig(vocab_size=shape[0], gaussian_dim=shape[1])
        table = tg2.GaussianDiffusion2D(cfg).lookup_table
        np.testing.assert_array_equal(table.numpy().view(np.uint32), want.view(np.uint32))
        jtable = jg2.GaussianDiffusion2D(jg2.GaussianDiffusion2DConfig(
            vocab_size=shape[0], gaussian_dim=shape[1]), None).lookup_table
        np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))


def _process_cfg(**kw):
    base = dict(seq_length=6, timesteps=6, sampling_timesteps=6, vocab_size=40, gaussian_dim=5)
    base.update(kw)
    return base


@pytest.mark.parametrize("to_dist", ["lookup_table", "one_hot"])
@pytest.mark.parametrize("distribute_dim", [-1, 1])
def test_index_maps_round_trip_as_jax(to_dist, distribute_dim):
    """to_continuous of indices equals JAX's, and to_indices takes it back to
    the same indices; to_indices of a noisy state picks JAX's rows."""
    kw = _process_cfg(indices_to_dist_fn=to_dist, distribute_dim=distribute_dim)
    jp = jg2.GaussianDiffusion2D(jg2.GaussianDiffusion2DConfig(**kw), None)
    tp = tg2.GaussianDiffusion2D(tg2.GaussianDiffusion2DConfig(**kw))
    idx = np.random.RandomState(0).randint(0, 40, (3, 6)).astype(np.int32)
    cont = tp.to_continuous(_t(idx))
    np.testing.assert_array_equal(cont.numpy(), np.asarray(jp.to_continuous(jnp.asarray(idx))))
    np.testing.assert_array_equal(tp.to_indices(cont).numpy(), idx)
    noisy = cont.numpy() + 0.3 * np.random.RandomState(1).standard_normal(cont.shape).astype(
        np.float32)
    np.testing.assert_array_equal(tp.to_indices(_t(noisy)).numpy(),
                                  np.asarray(jp.to_indices(jnp.asarray(noisy))))


# -- the process ---------------------------------------------------------------------------

def _jax_model(x, sc, t):
    out = 0.5 * jnp.tanh(x) + 0.01 * t[:, None, None].astype(jnp.float32)
    return out if sc is None else out + 0.1 * sc


def _torch_model(x, sc, t):
    out = 0.5 * torch.tanh(x) + 0.01 * t[:, None, None].float()
    return out if sc is None else out + 0.1 * sc


def _coin_key(want: bool) -> jax.Array:
    """The first key whose self-conditioning coin (the loss's fourth split)
    comes out ``want``."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        if bool(jax.random.bernoulli(jax.random.split(key, 4)[3], 0.5)) == want:
            return key
    raise AssertionError("no key")


@pytest.mark.parametrize("self_condition,coin", [(False, None), (True, True), (True, False)])
def test_process_loss_matches_jax(self_condition, coin):
    """The noise MSE of indices, with the self-conditioning forward on or off
    by the JAX coin; t and the noise from the JAX key."""
    kw = _process_cfg(self_condition=self_condition)
    jp = jg2.GaussianDiffusion2D(jg2.GaussianDiffusion2DConfig(**kw), _jax_model)
    tp = tg2.GaussianDiffusion2D(tg2.GaussianDiffusion2DConfig(**kw), _torch_model)
    idx = np.random.RandomState(2).randint(0, 40, (3, 6)).astype(np.int32)
    key = _coin_key(bool(coin)) if self_condition else jax.random.PRNGKey(3)
    want = jax.jit(jp.loss)(jnp.asarray(idx), key)
    rng_t, rng_n, _, _ = jax.random.split(key, 4)
    t = jax.random.randint(rng_t, (3,), 0, 6)
    noise = jax.random.normal(rng_n, (3, 6, 5), jnp.float32)
    got = tp.loss(_t(idx), t=_t(t).long(), noise=_t(noise), use_sc=coin)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _chain_noise(rng, b: int, shape, steps: int):
    """The draws of jg2.GaussianDiffusion2D.ddim_sample / p_sample_loop from
    ``rng``: the chain's initial indices, then one normal tensor a step."""
    rng_init, rng_loop = jax.random.split(rng)
    idx = jax.random.randint(rng_init, (b, shape[0]), 0, 40)
    noise = []
    for _ in range(steps):
        rng_loop, sub = jax.random.split(rng_loop)
        noise.append(_t(jax.random.normal(sub, (b, *shape), jnp.float32)))
    return _t(idx).long(), noise


@pytest.mark.parametrize("sampler", ["ddim_sample", "p_sample_loop"])
def test_process_chains_match_jax(sampler):
    """DDIM (eta 1, so noise enters) and the DDPM loop from random indices
    back to indices, the JAX draws injected: identical indices, and the
    states before the decode within 1e-5."""
    kw = _process_cfg(ddim_sampling_eta=1.0)
    jp = jg2.GaussianDiffusion2D(jg2.GaussianDiffusion2DConfig(**kw), _jax_model)
    tp = tg2.GaussianDiffusion2D(tg2.GaussianDiffusion2DConfig(**kw), _torch_model)
    rng = jax.random.PRNGKey(4)
    want = np.asarray(jax.jit(lambda r: getattr(jp, sampler)(r, 3))(rng))
    init, noise = _chain_noise(rng, 3, (6, 5), 6)
    got = getattr(tp, sampler)(3, init_indices=init, step_noise=noise)
    np.testing.assert_array_equal(got.numpy(), want)
    jp.to_indices = tp.to_indices = lambda x: x
    want_x = np.asarray(jax.jit(lambda r: getattr(jp, sampler)(r, 3))(rng))
    got_x = getattr(tp, sampler)(3, init_indices=init, step_noise=noise)
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=1e-5, atol=1e-5)


def test_raw_sequences_and_interpolate_match_jax():
    """gaussiandiffusion2d mode: sample from the caller's xt (no table), and
    interpolate two sequences from t = 4."""
    kw = _process_cfg(diffusion_type="gaussiandiffusion2d")
    jp = jg2.GaussianDiffusion2D(jg2.GaussianDiffusion2DConfig(**kw), _jax_model)
    tp = tg2.GaussianDiffusion2D(tg2.GaussianDiffusion2DConfig(**kw), _torch_model)
    assert tp.lookup_table is None
    rs = np.random.RandomState(5)
    xt = rs.uniform(size=(3, 6, 5)).astype(np.float32)
    rng = jax.random.PRNGKey(6)
    want = jax.jit(lambda r, x: jp.sample(r, 3, xt=x))(rng, xt)
    noise = _chain_noise(rng, 3, (6, 5), 6)[1]
    got = tp.sample(3, _t(xt), step_noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    x1, x2 = (rs.uniform(-1, 1, (3, 6, 5)).astype(np.float32) for _ in range(2))
    want = jax.jit(lambda r: jp.interpolate(r, jnp.asarray(x1), jnp.asarray(x2), 4, 0.3))(rng)
    n1, n2, loop = jax.random.split(rng, 3)
    step = []
    for _ in range(4):
        loop, sub = jax.random.split(loop)
        step.append(_t(jax.random.normal(sub, (3, 6, 5), jnp.float32)))
    got = tp.interpolate(_t(x1), _t(x2), 4, 0.3,
                         noise1=_t(jax.random.normal(n1, (3, 6, 5))),
                         noise2=_t(jax.random.normal(n2, (3, 6, 5))), step_noise=step)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# -- the composite priors ------------------------------------------------------------------

def _prior(tiny_config, kind: str, log_dir=None) -> dict:
    """tiny_config with the gaussian2d prior, or the VQ_Official prior on its
    Conv1d U-Net; both U-Nets at base 8, mults (1, 2)."""
    unet = {"unet_base_dim": 8, "unet_dim_mults": [1, 2]}
    if kind == "vqofficial1d":
        return _vqofficial(tiny_config, log_dir, unet_dim=2, **unet)
    data = tiny_config.to_dict()
    data["architecture"]["model_name"] = "vqdiffusion"
    data["architecture"]["vqdiffusion"].update({"diffusion_type": "gaussiandiffusion2d",
                                                "diffusion_steps": 3, "sampling_steps": 3,
                                                **unet})
    if log_dir is not None:
        data["trainer"]["log_dir"] = str(log_dir)
    return data


def _unet_input(jc) -> jnp.ndarray:
    """The JAX worker's init input of the U-Net (flax's [1, L, C])."""
    if jc.diffusion_type == "VQ_Official":
        return jnp.zeros((1, jc.seq_len, jc.codebook_size))
    return jnp.zeros((1, jc.gaussian_dim, jc.seq_len))


@pytest.fixture(scope="module", params=PRIORS)
def composites(request, tiny_config):
    """Both composites of one prior with the same VQVAE and U-Net."""
    data = _prior(tiny_config, request.param)
    jc, tcfg = JaxComposite(tiny_config.__class__(data)), t_config_from_dict(data)
    tc = TorchComposite(tcfg)
    params = jax.device_get(jc.unet.init(jax.random.PRNGKey(1), _unet_input(jc), None,
                                         jnp.zeros((1,), jnp.int32))["params"])
    vq = jax.device_get(jc.vqvae.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"])
    tc.vqvae.load_state_dict(W.vqvae_state_from_jax(vq, tcfg), strict=True)
    tc.unet.load_state_dict(W.unet1d_state_from_jax(params), strict=True)
    return request.param, jc, tc.eval(), params, vq


def test_composite_builds_the_jax_unet(composites):
    """gaussian2d: N = 64 channels over D = 16; VQ_Official: K = 32 channels
    in, K - 1 out, over the 16 positions."""
    kind, jc, tc, _, _ = composites
    unet = tc.unet
    assert isinstance(unet, TorchUnet1D)
    want = (64, 64) if kind == "gaussian2d" else (32, 31)
    assert (unet.init_conv.in_channels, unet.final_conv.out_channels) == want
    assert (jc.unet.channels, jc.unet.out_dim) == want
    assert not list(unet.buffers())


def test_composite_loss_matches_jax(composites):
    kind, jc, tc, params, vq = composites
    x = np.random.RandomState(9).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    lt = jd.LtState.init(jc.timesteps) if kind == "vqofficial1d" else None
    want, want_metrics, _, _ = jax.jit(jc.loss)(params, vq, {}, lt, jnp.asarray(x), rng)
    if kind == "vqofficial1d":
        t, noise = jax_draws(jc.prior, rng, 3, lt)
        got, metrics, _ = tc.loss(_t(x), t=t, noise=noise, lt=tc.init_lt_state())
    else:
        rng_t, rng_n, _, _ = jax.random.split(rng, 4)
        t = _t(jax.random.randint(rng_t, (3,), 0, jc.timesteps)).long()
        noise = _t(jax.random.normal(rng_n, (3, jc.seq_len, jc.gaussian_dim), jnp.float32))
        got, metrics, _ = tc.loss(_t(x), t=t, noise=noise)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert set(metrics) == set(want_metrics)
    for k in want_metrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(want_metrics[k]), rtol=1e-5,
                                   err_msg=k)


def test_composite_sample_matches_jax(composites):
    """Indices identical with the JAX noise injected: gaussian2d's initial
    indices and DDIM noise; VQ_Official's chain-init uniform and Gumbel
    noise, through the plain posterior."""
    kind, jc, tc, params, _ = composites
    rng = jax.random.PRNGKey(12)
    want = np.asarray(jax.jit(lambda p, r: jc.sample(p, {}, r, 2))(params, rng))
    if kind == "vqofficial1d":
        u, gumbel = _jax_noise(rng, (2, jc.seq_len, jc.codebook_size), jc.sampling_timesteps)
        got = tc.sample(2, init_uniform=u, step_gumbel=gumbel)
    else:
        rng_init, rng_loop = jax.random.split(rng)
        init = _t(jax.random.randint(rng_init, (2, jc.seq_len), 0, jc.codebook_size)).long()
        noise = []
        for _ in range(jc.sampling_timesteps):
            rng_loop, sub = jax.random.split(rng_loop)
            noise.append(_t(jax.random.normal(sub, (2, jc.seq_len, jc.gaussian_dim))))
        got = tc.sample(2, init_indices=init, step_noise=noise)
    assert tuple(got.shape) == (2, jc.seq_len)
    np.testing.assert_array_equal(got.numpy(), want)


# -- the worker ----------------------------------------------------------------------------

def _step_draws(jw, key, lt):
    c = jw.composite
    if c.diffusion_type == "VQ_Official":
        return jax_draws(c.prior, key, BATCH, lt)
    rng_t, rng_n, _, _ = jax.random.split(key, 4)
    return (_t(jax.random.randint(rng_t, (BATCH,), 0, c.timesteps)).long(),
            _t(jax.random.normal(rng_n, (BATCH, c.seq_len, c.gaussian_dim), jnp.float32)))


@pytest.fixture(scope="module", params=PRIORS)
def runs(request, tiny_config):
    """Both workers of one prior through three steps (JAX keys 0, 1, 2): each
    step's metrics, U-Net and EMA states; the port's first-step gradients."""
    cfg = tiny_config.__class__(_prior(tiny_config, request.param))
    jw = JaxWorker(cfg, tempfile.mkdtemp(), num_iters_per_epoch=ITERS)
    js = jax.device_get(jw.init_state())
    tcfg = t_config_from_dict(cfg.to_dict())
    tw = TorchWorker(tcfg, tempfile.mkdtemp(), device="cpu", num_iters_per_epoch=ITERS)
    ts = tw.init_state()
    tw.composite.vqvae.load_state_dict(W.vqvae_state_from_jax(js.vq_params, tcfg), strict=True)
    ts.unet.load_state_dict(W.unet1d_state_from_jax(js.unet_params), strict=True)
    ts.ema.load_state_dict(W.unet1d_state_from_jax(js.ema_params), strict=True)
    rs = np.random.RandomState(0)
    out = {"jax": [], "port": [], "grads": []}
    for i in range(STEPS):
        b, key = rs.uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32), jax.random.PRNGKey(i)
        t, noise = _step_draws(jw, key, js.lt_state)
        js, jm = jw.train_step(js, jnp.asarray(b), key)
        host = jax.device_get(js)
        out["jax"].append(({k: float(v) for k, v in jm.items()},
                           W.unet1d_state_from_jax(host.unet_params),
                           W.unet1d_state_from_jax(host.ema_params)))
        ts, tm = tw.train_step(ts, torch.from_numpy(b), t=t, noise=noise)
        out["grads"].append({k: p.grad.clone() for k, p in ts.unet.named_parameters()})
        out["port"].append(({k: float(v) for k, v in tm.items()},
                            {k: v.clone() for k, v in ts.unet.state_dict().items()},
                            {k: v.clone() for k, v in ts.ema.state_dict().items()}))
    top = max(float(g.abs().max()) for g in out["grads"][0].values())
    out["live"] = {k for k, g in out["grads"][0].items() if float(g.abs().max()) > ROUNDING * top}
    out["lr"] = max(tw.lr_fn(i) for i in range(STEPS))
    out["kind"], out["port_worker"] = request.param, tw
    return out


def test_trajectory_matches_jax(runs):
    """Three steps: the metrics, then the U-Net's and the EMA's parameters
    (the EMA moves at steps 0 and 2: every model_ema_steps = 2; no
    statistics, the U-Net has no BatchNorm). VQ_Official's U-Net reads the
    log-onehot input's -69 entries as the ShuffleNet branch does, and its
    parameters are held by tests/test_torch_port_discrete_train.py's rule
    for that branch: an entry of a live leaf more than lr / 10 from JAX's
    had, at one of the steps, an f32 gradient within 1e-2 of its leaf's
    largest entry from zero, where Adam moves it by about lr with the sign
    each side's rounding gives it."""
    want_keys = {"loss"} if runs["kind"] == "gaussian2d" else {"vb_loss", "kl", "decoder_nll",
                                                                "loss"}
    for i in range(STEPS):
        (jm, ju, je), (tm, tu, te) = runs["jax"][i], runs["port"][i]
        assert set(tm) == set(jm) == want_keys
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=f"step {i} {k}")
        if runs["kind"] == "gaussian2d":
            assert_params_close(tu, ju, i + 1, runs["live"], runs["lr"])
            assert_params_close(te, je, i + 1, runs["live"], runs["lr"])
        else:
            assert_params_explained(tu, ju, i + 1, runs["grads"], runs["lr"])
            assert_params_explained(te, je, i + 1, runs["grads"], runs["lr"])
    (_, u0, e0), (_, _, e1) = runs["port"][0], runs["port"][1]
    assert all(torch.equal(e1[k], e0[k]) for k in e0)
    assert any(not torch.equal(e0[k], u0[k]) for k in runs["live"])
    assert runs["port_worker"].state.updates == STEPS


# -- the CLIs on the CPU -------------------------------------------------------------------

def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("kind", PRIORS)
def test_train_cli_debug_resume_and_generate(tmp_path, tiny_config, kind):
    """--debug on the CPU: two steps, a checkpoint, the recon grid and the
    EMA's samples; resuming goes on at step 3; ``generate --ckpt`` on the
    checkpoint samples the EMA U-Net, and on the export tool's bare
    ``export_unet1d`` state_dict of a JAX U-Net samples that U-Net."""
    data = _prior(tiny_config, kind, tmp_path / "zlog")
    config = tmp_path / f"{kind}.yml"
    config.write_text(yaml.safe_dump(data))
    first = cli.run(["--config", str(config), "--debug", "--device", "cpu"])
    assert [r["step"] for r in _rows(first["run_dir"])] == [1, 2, 2]
    for name in ("recon_epoch0_0.jpg", "samples_epoch0.jpg"):
        assert os.path.exists(os.path.join(first["run_dir"], name)), name
    ckpt = os.path.join(first["run_dir"], "ckpt", "step_00000002.pth")
    second = cli.run(["--config", str(config), "--debug", "--device", "cpu"],
                     overrides={"architecture.vqdiffusion.resume_path": ckpt})
    assert second["worker"].global_step == 4 and second["worker"].state.updates == 4

    jc = JaxComposite(tiny_config.__class__(data))
    params = jax.device_get(jc.unet.init(jax.random.PRNGKey(5), _unet_input(jc), None,
                                         jnp.zeros((1,), jnp.int32))["params"])
    bare = str(tmp_path / "unet1d.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in export_unet1d(params).items()}, bare)
    want = TorchWorker(t_config_from_dict(data), str(tmp_path), seed=3, device="cpu")
    want.init_state()
    want.load(ckpt)
    exported = TorchUnet1D(**_unet_kwargs(jc))
    exported.load_state_dict(W.unet1d_state_from_jax(params), strict=True)
    for path, unet in ((ckpt, want.state.ema), (bare, exported)):
        out = generate.run(["--config", str(config), "--device", "cpu", "--ckpt", path,
                            "--n-samples", "2", "--seed", "3"])
        indices = want.composite.sample(2, generator=torch.Generator().manual_seed(3), unet=unet)
        assert torch.equal(out["indices"], indices), path
        assert tuple(out["images"].shape) == (2, 32, 32, 3)


def _unet_kwargs(jc) -> dict:
    u = jc.unet
    return dict(dim=u.dim, dim_mults=tuple(u.dim_mults), channels=u.channels, out_dim=u.out_dim)


def test_cli_refuses_without_gpu(tmp_path, tiny_config, monkeypatch):
    config = tmp_path / "g2.yml"
    config.write_text(yaml.safe_dump(_prior(tiny_config, "gaussian2d", tmp_path / "zlog")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (cli.run, generate.run):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(["--config", str(config)])


def _load(path):
    with open(path) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("name,base,change", [
    ("inference_config_gaussian2d", "inference_config_vqdiffusion",
     {"diffusion_type": "gaussiandiffusion2d"}),
    ("inference_config_vqofficial1d", "inference_config_vqofficial", {"unet_dim": 2}),
    ("training_config_gaussian2d", "training_config_vqdiffusion",
     {"diffusion_type": "gaussiandiffusion2d"}),
    ("training_config_vqofficial1d", "training_config_vqdiffusion",
     {"diffusion_type": "VQ_Official", "unet_dim": 2, "fused_posterior": True}),
])
def test_configs_are_their_bases_with_the_prior_changed(name, base, change):
    """Each new config is its base with the prior's keys changed: the full
    widths of training_config_small.yml (latent 16^2, K 1024, gaussian_dim
    96, U-Net base 64, mults (1, 2, 4, 8) by default)."""
    got, want = _load(f"configs/{name}.yml"), _load(f"configs/{base}.yml")
    want["architecture"]["vqdiffusion"].update(change)
    assert got == want
    vq = got["architecture"]["vqdiffusion"]
    assert "unet_base_dim" not in vq and "unet_dim_mults" not in vq
    assert got["architecture"]["vqvae"]["latent_size"] == 16


# -- the pixel-space gaussiandiffusion2d worker --------------------------------------------

def _pixel(tiny_config, log_dir=None, **paths):
    """tiny_config's gaussiandiffusion2d: 32x32 synthetic images, whose first
    channel's rows are the U-Net's 32 channels over 32 columns, the U-Net at
    base 8, mults (1, 2), 8 steps."""
    cfg = tiny_config.replace_path("architecture.model_name", "gaussiandiffusion2d")
    for path, value in {"architecture.gaussiandiffusion2d.unet_base_dim": 8,
                        "architecture.gaussiandiffusion2d.unet_dim_mults": [1, 2],
                        **({"trainer.log_dir": str(log_dir)} if log_dir else {}),
                        **paths}.items():
        cfg = cfg.replace_path(path, value)
    return cfg


@pytest.mark.parametrize("scale", [0.01, 100.0])
def test_clip_by_global_norm_is_optax(scale):
    """ClipByGlobalNorm hands its optimizer optax's clipped gradients: as
    they are below a global norm of 1, g / norm above it (the norm over
    every leaf)."""
    import optax

    from vq_vae_gan_diffusion_torch.train.base import ClipByGlobalNorm
    rs = np.random.RandomState(3)
    grads = [(scale * rs.standard_normal(s)).astype(np.float32) for s in ((4, 3), (7,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    seen = []

    class Keep(torch.optim.SGD):
        def step(self, closure=None):
            seen.extend(p.grad.clone() for p in params)

    opt = ClipByGlobalNorm(Keep(params, lr=1.0), 1.0)
    for p, g in zip(params, grads):
        p.grad = _t(g)
    opt.step()
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads))
    assert (norm > 1) == (scale > 1)
    for got, w, g in zip(seen, want, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6, atol=0)
        if scale < 1:
            np.testing.assert_array_equal(got.numpy(), g)


@pytest.fixture(scope="module")
def pixel_runs(tiny_config):
    """Both pixel workers through three steps (JAX keys 0, 1, 2) on the same
    weights; the JAX worker's EMA samples with its key 7."""
    from vq_vae_gan_diffusion_torch.train.gaussian_diffusion_workers import (
        GaussianDiffusion2DWorker as TorchPixel)
    from vq_vae_gan_diffusion_tpu.train.gaussian_diffusion_workers import (
        GaussianDiffusion2DWorker as JaxPixel)
    cfg = _pixel(tiny_config)
    jw = JaxPixel(cfg, tempfile.mkdtemp())
    js = jw.init_state()
    tw = TorchPixel(t_config_from_dict(cfg.to_dict()), tempfile.mkdtemp(), device="cpu")
    ts = tw.init_state()
    host = jax.device_get(js)
    ts.unet.load_state_dict(W.unet1d_state_from_jax(host.params), strict=True)
    ts.ema.load_state_dict(W.unet1d_state_from_jax(host.ema_params), strict=True)
    rs = np.random.RandomState(0)
    out = {"jax": [], "port": [], "grads": []}
    for i in range(STEPS):
        b, key = rs.uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32), jax.random.PRNGKey(i)
        js, jm = jw.train_step(js, jnp.asarray(b), key)
        host = jax.device_get(js)
        out["jax"].append((float(jm["loss"]), W.unet1d_state_from_jax(host.params),
                           W.unet1d_state_from_jax(host.ema_params)))
        rng_t, rng_n, _, _ = jax.random.split(key, 4)
        t = _t(jax.random.randint(rng_t, (BATCH,), 0, 8)).long()
        noise = _t(jax.random.normal(rng_n, (BATCH, 32, 32), jnp.float32))
        ts, tm = tw.train_step(ts, torch.from_numpy(b), t=t, noise=noise)
        out["grads"].append({k: p.grad.clone() for k, p in ts.unet.named_parameters()})
        out["port"].append((float(tm["loss"]),
                            {k: v.clone() for k, v in ts.unet.state_dict().items()},
                            {k: v.clone() for k, v in ts.ema.state_dict().items()}))
    rng = jax.random.PRNGKey(7)
    out["samples"] = np.asarray(jw._sample(js.ema_params, rng))
    rng_init, rng_loop = jax.random.split(rng)
    out["xt"] = _t(jax.random.uniform(rng_init, (4, 32, 32)))
    out["step_noise"] = _chain_noise(rng_loop, 4, (32, 32), 8)[1]
    out["jax_worker"], out["port_worker"] = jw, tw
    return out


def test_pixel_worker_builds_the_jax_unet(pixel_runs):
    tw, jw = pixel_runs["port_worker"], pixel_runs["jax_worker"]
    assert tw.unet_kwargs == dict(dim=8, dim_mults=(1, 2), channels=32, out_dim=32)
    assert (jw.unet.dim, tuple(jw.unet.dim_mults), jw.unet.channels) == (8, (1, 2), 32)
    assert set(tw.state.unet.state_dict()) == set(pixel_runs["jax"][0][1])


def test_pixel_trajectory_matches_jax(pixel_runs):
    """Three steps: the loss within 1e-5 relative, the U-Net's and the EMA's
    parameters by tests/test_torch_port_vqd_train.py's rule (lr 1.5e-4,
    clipped steps: the first step's gradient norm is above 1)."""
    lr = pixel_runs["port_worker"].lr
    top = max(float(g.abs().max()) for g in pixel_runs["grads"][0].values())
    live = {k for k, g in pixel_runs["grads"][0].items() if float(g.abs().max()) > ROUNDING * top}
    for i in range(STEPS):
        (jl, ju, je), (tl, tu, te) = pixel_runs["jax"][i], pixel_runs["port"][i]
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"step {i}")
        assert_params_close(tu, ju, i + 1, live, lr)
        assert_params_close(te, je, i + 1, live, lr)
    norm = float(torch.sqrt(sum(torch.sum(g * g) for g in pixel_runs["grads"][0].values())))
    assert norm <= 1.0 + 1e-6   # the grads the optimizer saw: clipped


def test_pixel_optimizer_is_the_jax_workers(tiny_config):
    """Adam at the config's lr: the tiny config's adam_betas string
    "(0.65, 0.95)" loads as a tuple on both sides, so both workers take
    (0.65, 0.95); a string that does not parse takes (0.9, 0.99), as the
    JAX worker's fallback."""
    from vq_vae_gan_diffusion_torch.train.gaussian_diffusion_workers import (
        GaussianDiffusion2DWorker as TorchPixel)
    for betas, want in (("(0.65, 0.95)", (0.65, 0.95)), ("fast", (0.9, 0.99))):
        cfg = _pixel(tiny_config, **{"trainer.gaussiandiffusion2d.adam_betas": betas})
        tw = TorchPixel(t_config_from_dict(cfg.to_dict()), tempfile.mkdtemp(), device="cpu")
        assert tw.betas == want and tw.lr == 1.5e-4
        state = tw.init_state()
        inner = state.opt.opt
        assert isinstance(inner, torch.optim.Adam) and inner.param_groups[0]["betas"] == want
        assert inner.param_groups[0]["eps"] == 1e-8 and inner.param_groups[0]["weight_decay"] == 0


def test_pixel_ema_cadence(pixel_runs):
    """The EMA moves by 0.9999 at steps 0 and 10 (the step count before the
    step a multiple of 10) and holds in between."""
    tw = pixel_runs["port_worker"]
    state = tw.state
    ema = [{k: v.clone() for k, v in state.ema.state_dict().items()}]
    b = torch.rand(2, 32, 32, 3)
    for _ in range(8):
        state, _ = tw.train_step(state, b, torch.Generator().manual_seed(0))
        ema.append({k: v.clone() for k, v in state.ema.state_dict().items()})
    assert state.step == STEPS + 8
    for i in range(1, len(ema)):
        moved = any(not torch.equal(ema[i][k], ema[i - 1][k]) for k in ema[i])
        assert moved == (STEPS + i - 1 == 10), f"step {STEPS + i - 1}"
    unet = dict(state.unet.named_parameters())
    before = pixel_runs["port"][-1][2]
    k = next(iter(unet))
    torch.testing.assert_close(ema[-1][k], ema[-2][k])
    assert not torch.equal(ema[-1][k], before[k]) or torch.equal(unet[k], before[k])


def test_pixel_samples_match_jax(pixel_runs):
    """The JAX EMA's 4 DDIM samples from uniform noise through the port's
    sampler, the JAX draws injected, within 1e-4: the first step, at t = 7
    of 8 cosine steps, takes x0 as sqrt(1 / ac) x - 163 pred_noise, which
    turns the U-Net's f32 rounding (about 1e-7) into about 2e-5."""
    tw = pixel_runs["port_worker"]
    ema = tw.build_unet()
    ema.load_state_dict(pixel_runs["jax"][-1][2], strict=True)
    got = tw.sample(unet=ema, xt=pixel_runs["xt"], step_noise=pixel_runs["step_noise"])
    assert tuple(got.shape) == (4, 32, 32)
    np.testing.assert_allclose(got.numpy(), pixel_runs["samples"], rtol=0, atol=1e-4)


def test_pixel_cli_debug_resume_and_generate(tmp_path, tiny_config):
    """--debug on the CPU: two steps, a checkpoint with the EMA and no
    VQVAE, the EMA's 4 samples; resume goes on at step 3; ``generate
    --ckpt`` on the checkpoint samples its EMA U-Net, and on a bare
    ``export_unet1d`` state_dict of a JAX U-Net samples that U-Net."""
    from vq_vae_gan_diffusion_torch.train.gaussian_diffusion_workers import (
        GaussianDiffusion2DWorker as TorchPixel)
    from vq_vae_gan_diffusion_tpu.models.unet1d import Unet1D as JaxUnet1D
    data = _pixel(tiny_config, tmp_path / "zlog",
                  **{"architecture.gaussiandiffusion2d.diffusion_steps": 3,
                     "architecture.gaussiandiffusion2d.sampling_steps": 3}).to_dict()
    config = tmp_path / "pixel2d.yml"
    config.write_text(yaml.safe_dump(data))
    first = cli.run(["--config", str(config), "--debug", "--device", "cpu"])
    assert [r["step"] for r in _rows(first["run_dir"])] == [1, 2, 2]
    assert os.path.exists(os.path.join(first["run_dir"], "Generating_epoch000.jpg"))
    ckpt = os.path.join(first["run_dir"], "ckpt", "step_00000002.pth")
    tree = torch.load(ckpt, weights_only=True)
    assert set(tree["state"]) == {"unet", "ema", "opt", "step", "updates"}
    second = cli.run(["--config", str(config), "--debug", "--device", "cpu"],
                     overrides={"architecture.gaussiandiffusion2d.resume_path": ckpt})
    assert second["worker"].global_step == 4 and second["worker"].state.step == 4

    ju = JaxUnet1D(dim=8, dim_mults=(1, 2), channels=32, out_dim=32)
    params = jax.device_get(ju.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32)), None,
                                    jnp.zeros((1,), jnp.int32))["params"])
    bare = str(tmp_path / "unet1d.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in export_unet1d(params).items()}, bare)
    want = TorchPixel(t_config_from_dict(data), str(tmp_path), seed=3, device="cpu")
    want.init_state()
    ema = want.build_unet()
    ema.load_state_dict(tree["state"]["ema"], strict=True)
    exported = want.build_unet()
    exported.load_state_dict(W.unet1d_state_from_jax(params), strict=True)
    for path, unet in ((ckpt, ema), (bare, exported)):
        out = generate.run(["--config", str(config), "--device", "cpu", "--ckpt", path,
                            "--seed", "3"])
        images = want.sample(torch.Generator().manual_seed(3), unet)
        assert torch.equal(out["images"], images), path
        assert os.path.exists(out["path"])


def test_pixel_config_is_the_mnist_config_with_its_changes():
    """training_config_pixel2d.yml: training_config_mnist.yml with the model
    name and the U-Net's mults (1, 2, 4), the deepest that 28 columns take
    (the JAX U-Net at (1, 2, 4, 8) raises at 28, checked here); batch 500."""
    from vq_vae_gan_diffusion_tpu.models.unet1d import Unet1D as JaxUnet1D
    got, base = _load("configs/training_config_pixel2d.yml"), _load(
        "configs/training_config_mnist.yml")
    base["architecture"]["model_name"] = "gaussiandiffusion2d"
    base["architecture"]["gaussiandiffusion2d"]["unet_dim_mults"] = [1, 2, 4]
    assert got == base
    assert got["dataset"]["batch_size"]["gaussiandiffusion2d"] == {"mnist": 500}
    with pytest.raises(TypeError, match="concatenate"):
        JaxUnet1D(dim=8, dim_mults=(1, 2, 4, 8), channels=28).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 28, 28)), None, jnp.zeros((1,), jnp.int32))
    with torch.no_grad():
        out = TorchUnet1D(8, dim_mults=(1, 2, 4), channels=28)(
            torch.zeros(1, 28, 28), None, torch.zeros(1, dtype=torch.long))
    assert tuple(out.shape) == (1, 28, 28)
