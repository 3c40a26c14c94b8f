"""The port's GPT prior and its weight mapping against the JAX package.

Weights are transplanted from JAX with vq_vae_gan_diffusion_torch.weights and
checked key for key against the JAX package's own exporter
(utils/torch_export.py); the same numpy inputs then go through both models.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_vae_gan_diffusion_torch.models.mingpt import GPT as TorchGPT
from vq_vae_gan_diffusion_torch.models.mingpt import sample_tokens as t_sample_tokens
from vq_vae_gan_diffusion_torch.models.mingpt import top_k_filter as t_top_k_filter
from vq_vae_gan_diffusion_torch.weights import gpt_state_from_jax
from vq_vae_gan_diffusion_tpu.models.mingpt import GPT as JaxGPT
from vq_vae_gan_diffusion_tpu.models.mingpt import sample_tokens as j_sample_tokens
from vq_vae_gan_diffusion_tpu.models.mingpt import top_k_filter as j_top_k_filter
from vq_vae_gan_diffusion_tpu.utils.torch_export import export_gpt

B, T, L, H, C, V = 3, 32, 2, 4, 32, 64


@pytest.fixture(scope="module")
def gpts():
    jgpt = JaxGPT(vocab_size=V, block_size=T, n_layer=L, n_head=H, n_embd=C)
    params = jgpt.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(
        lambda p: p + 0.02 * jnp.sin(jnp.arange(p.size, dtype=jnp.float32)).reshape(p.shape),
        params)
    # a wide logit spread, so near-ties cannot decide quasi-greedy sampling
    params["head"]["kernel"] = params["head"]["kernel"] * 50.0
    params = jax.device_get(params)
    tgpt = TorchGPT(vocab_size=V, block_size=T, n_layer=L, n_head=H, n_embd=C)
    tgpt.load_state_dict(gpt_state_from_jax(params), strict=True)
    return jgpt, params, tgpt.eval()


def test_gpt_state_matches_torch_export(gpts):
    _, params, _ = gpts
    ours, ref = gpt_state_from_jax(params), export_gpt(params)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)


def test_forward_logits_match_jax(gpts):
    jgpt, params, tgpt = gpts
    idx = np.random.RandomState(0).randint(0, V, (B, T)).astype(np.int32)
    want = jgpt.apply({"params": params}, jnp.asarray(idx))
    with torch.no_grad():
        got = tgpt(torch.from_numpy(idx).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_decode_step_matches_jax(gpts):
    """The module route's KV-cached decode_step, six positions."""
    jgpt, params, tgpt = gpts
    tokens = np.random.RandomState(1).randint(0, V, (6, B))
    jcache = jgpt.apply({"params": params}, B, 8, method=JaxGPT.init_cache)
    tcache = tgpt.init_cache(B, 8)
    for t in range(6):
        want, jcache = jgpt.apply({"params": params}, jnp.asarray(tokens[t]), t, jcache,
                                  method=JaxGPT.decode_step)
        with torch.no_grad():
            got = tgpt.decode_step(torch.from_numpy(tokens[t]).long(), t, tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k", [1, 3, 64, 100])
def test_top_k_filter_matches_jax_ties(k):
    """Values tied with the k-th largest are all kept, as in JAX."""
    logits = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, -1.0], [0.5, 0.5, 0.5, 0.5, 2.0, 1.0]],
                      np.float32)
    want = np.asarray(j_top_k_filter(jnp.asarray(logits), k))
    got = t_top_k_filter(torch.from_numpy(logits), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fused", [True, False])
def test_sampler_matches_jax_sampler(gpts, fused):
    """Quasi-greedy sampling through a 6-token teacher-forced prefix picks the
    JAX XLA sampler's tokens, on both of the port's routes."""
    jgpt, params, tgpt = gpts
    rs = np.random.RandomState(3)
    prefix = np.concatenate([np.zeros((B, 1), np.int32),
                             rs.randint(0, V, (B, 5)).astype(np.int32)], 1)
    kw = dict(prefix_len=6, steps=10, temperature=1e-4, top_k=10)
    want = j_sample_tokens(jgpt, params, jax.random.PRNGKey(7), jnp.asarray(prefix),
                           fused=False, **kw)
    got = t_sample_tokens(tgpt, torch.from_numpy(prefix).long(), fused=fused,
                          generator=torch.Generator().manual_seed(7), **kw)
    assert got.shape == (B, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampler_rejects_quant_and_bf16_module_route(gpts):
    """An unknown quant mode raises, as in the JAX package; so does bf16 on
    the module route."""
    _, _, tgpt = gpts
    prefix = torch.zeros(B, 1, dtype=torch.long)
    with pytest.raises(ValueError, match="unsupported quant mode 'int3'"):
        t_sample_tokens(tgpt, prefix, 1, 4, quant="int3")
    with pytest.raises(ValueError, match="float32"):
        t_sample_tokens(tgpt, prefix, 1, 4, fused=False, dtype=torch.bfloat16)


def test_bf16_fused_route_samples_valid_tokens(gpts):
    """bf16 weights and cache on the fused route: valid tokens, and at
    quasi-greedy temperature mostly the f32 route's choices."""
    _, _, tgpt = gpts
    prefix = torch.zeros(B, 1, dtype=torch.long)
    kw = dict(temperature=1e-4, top_k=10)
    f32 = t_sample_tokens(tgpt, prefix, 1, 12, generator=torch.Generator().manual_seed(0), **kw)
    bf16 = t_sample_tokens(tgpt, prefix, 1, 12, dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0), **kw)
    assert bf16.shape == (B, 12) and int(bf16.min()) >= 0 and int(bf16.max()) < V
    assert (f32 == bf16).float().mean().item() >= 0.75
