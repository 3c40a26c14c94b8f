"""The port's conv blocks, encoder, decoder, codebook and VQVAE against the
JAX package's, at tests/conftest.py::tiny_config widths.

Inputs are NHWC numpy arrays from a seed; the port's modules run NCHW inside
and are compared after a permute. f32 throughout; tolerance 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_vae_gan_diffusion_torch import weights as W
from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.models import blocks as tb
from vq_vae_gan_diffusion_torch.models.codebook import quantize as t_quantize
from vq_vae_gan_diffusion_torch.models.vqvae import VQVAE as TorchVQVAE
from vq_vae_gan_diffusion_tpu.models import blocks as jb
from vq_vae_gan_diffusion_tpu.models.codebook import quantize as j_quantize
from vq_vae_gan_diffusion_tpu.models.vqvae import VQVAE as JaxVQVAE
from vq_vae_gan_diffusion_tpu.utils.torch_export import export_vqvae

TOL = dict(rtol=1e-4, atol=1e-4)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).detach().numpy()


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _perturb(params):
    """Non-trivial affines and biases (flax initializes them to 1 and 0)."""
    return jax.device_get(jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.sin(jnp.arange(p.size, dtype=jnp.float32)).reshape(p.shape),
        params))


def _load(module, mapper, params):
    state = {}
    mapper(state, "m", params)
    module.load_state_dict({k[2:]: v for k, v in state.items()}, strict=True)
    return module.eval()


def _run_block(jmod, tmod, mapper, shape, seed=0):
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    params = _perturb(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(_load(tmod, mapper, params)(_nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("channels", [16, 40, 48])
def test_group_norm(channels):
    """32 groups, or the largest divisor <= 32 (40 -> 20, 48 -> 24); eps 1e-6."""
    _run_block(jb.GroupNorm(), tb.GroupNorm(channels), W._gn, (2, 8, 8, channels))


@pytest.mark.parametrize("cin,cout", [(16, 32), (32, 32)])
def test_residual_block(cin, cout):
    _run_block(jb.ResidualBlock(cout), tb.ResidualBlock(cin, cout), W._res_block,
               (2, 8, 8, cin))


def test_downsample_block_asymmetric_pad():
    _run_block(jb.DownsampleBlock(), tb.DownsampleBlock(16),
               lambda out, p, sub: W._conv(out, f"{p}.conv", sub["conv"]), (2, 9, 8, 16))


def test_upsample_block():
    _run_block(jb.UpsampleBlock(), tb.UpsampleBlock(16),
               lambda out, p, sub: W._conv(out, f"{p}.conv", sub["conv"]), (2, 4, 4, 16))


def test_nonlocal_block_normalized_residual():
    _run_block(jb.NonLocalBlock(), tb.NonLocalBlock(32), W._attn_block, (2, 8, 8, 32))


@pytest.fixture(scope="module")
def vqvaes(tiny_config):
    cfg = t_config_from_dict(tiny_config.to_dict())
    jv = JaxVQVAE.from_config(tiny_config)
    x = np.random.RandomState(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    params = _perturb(jax.jit(jv.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    tv = TorchVQVAE.from_config(cfg)
    tv.load_state_dict(W.vqvae_state_from_jax(params, cfg), strict=True)
    return jv, params, tv.eval(), x, tiny_config


def test_vqvae_state_matches_torch_export(vqvaes):
    _, params, _, _, cfg = vqvaes
    vq = cfg.architecture.vqvae
    ours = W.vqvae_state_from_jax(params, t_config_from_dict(cfg.to_dict()))
    ref = export_vqvae(params, img_size=32, latent_size=int(vq.latent_size),
                       intermediate_channels=list(vq.intermediate_channels),
                       n_res_encoder=int(vq.num_residual_blocks_encoder),
                       n_res_decoder=int(vq.num_residual_blocks_decoder),
                       attn_res=list(vq.attention_resolution))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)


def test_encoder_matches_jax(vqvaes):
    jv, params, tv, x, _ = vqvaes
    want = jv.apply({"params": params}, jnp.asarray(x), method=lambda m, v: m.encoder(v))
    with torch.no_grad():
        got = _nhwc(tv.encoder(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_decoder_matches_jax(vqvaes):
    jv, params, tv, _, _ = vqvaes
    z = np.random.RandomState(1).standard_normal((2, 8, 8, 32)).astype(np.float32)
    want = jv.apply({"params": params}, jnp.asarray(z), method=lambda m, v: m.decoder(v))
    with torch.no_grad():
        got = _nhwc(tv.decoder(_nchw(z)))
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_encode_indices_exact(vqvaes):
    jv, params, tv, x, _ = vqvaes
    jz, jidx, jloss = jv.apply({"params": params}, jnp.asarray(x), method=JaxVQVAE.encode)
    with torch.no_grad():
        tz, tidx, tloss = tv.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)


def test_decode_indices_matches_jax(vqvaes):
    jv, params, tv, _, _ = vqvaes
    idx = np.random.RandomState(2).randint(0, 64, (2, 64)).astype(np.int32)
    want = jv.apply({"params": params}, jnp.asarray(idx), method=JaxVQVAE.decode_indices)
    with torch.no_grad():
        got = tv.decode_indices(torch.from_numpy(idx).long())
    assert tuple(got.shape) == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("precision", ["exact", "bf16"])
def test_quantize_matches_jax(precision):
    rs = np.random.RandomState(4)
    z = rs.standard_normal((2, 8, 8, 32)).astype(np.float32)
    cb = rs.standard_normal((64, 32)).astype(np.float32)
    jz, jidx, jloss = j_quantize(jnp.asarray(z), jnp.asarray(cb), 0.25, precision)
    tz, tidx, tloss = t_quantize(torch.from_numpy(z), torch.from_numpy(cb), 0.25, precision)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)


def test_quantize_straight_through_gradient():
    z = torch.randn(1, 2, 2, 4, generator=torch.Generator().manual_seed(0), requires_grad=True)
    cb = torch.randn(8, 4, generator=torch.Generator().manual_seed(1))
    z_q, _, _ = t_quantize(z, cb)
    z_q.sum().backward()
    torch.testing.assert_close(z.grad, torch.ones_like(z))
