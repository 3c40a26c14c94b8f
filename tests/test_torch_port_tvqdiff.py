"""The port's transformer-predictor VQ-diffusion prior against the JAX
package's: the weight map, the TransformerPredictor's logits on
transplanted weights, and both samplers with the JAX package's noise
injected. Geometry: tests/conftest.py's codebook (64 codes, so K = 65) over
64 tokens, width 32, 2 blocks of 4 heads; 3 reverse steps a chain.

Tolerances: logits within 1e-4 (the same f32 products summed in other
orders through two blocks); sampled indices identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_discrete import _jax_noise
from vq_vae_gan_diffusion_torch.models.transformer_vq_diffusion import (
    TransformerVQDiffusion as TorchTVQ)
from vq_vae_gan_diffusion_torch.weights import transformer_predictor_state_from_jax
from vq_vae_gan_diffusion_tpu.models.transformer_vq_diffusion import (
    TransformerVQDiffusion as JaxTVQ)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: at these sizes torch gains nothing from more,
    and with every core busy (several test workers) a full thread pool makes
    each small op many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


GEOMETRY = dict(codebook_size=64, seq_len=64, embedding_dim=32, num_layers=2, num_heads=4)


def _numpy_params(model: JaxTVQ, seed: int):
    """Predictor params drawn with numpy: kernels N(0, 1/fan_in), LayerNorm
    scales 1 + N(0, 0.1^2), every other leaf N(0, 0.1^2)."""
    shapes = jax.eval_shape(lambda: model.predictor.init(
        jax.random.PRNGKey(0), jnp.zeros((1, model.seq_len), jnp.int32),
        jnp.zeros((1,), jnp.int32)))["params"]
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fan = np.prod(shape[:2]) if path[-2].key == "out" else shape[0]
            v = rs.standard_normal(shape) / np.sqrt(fan)
        elif name == "embedding":
            v = rs.standard_normal(shape) / np.sqrt(shape[-1])
        elif name == "scale":
            v = 1.0 + 0.1 * rs.standard_normal(shape)
        elif name == "positional_encoding":
            v = rs.standard_normal(shape)
        else:
            v = 0.1 * rs.standard_normal(shape)
        return jnp.asarray(v.astype(np.float32))
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(diffusion_steps: int, seed: int):
    jm = JaxTVQ(diffusion_steps=diffusion_steps, **GEOMETRY)
    params = _numpy_params(jm, seed)
    tm = TorchTVQ(diffusion_steps=diffusion_steps, **GEOMETRY)
    tm.predictor.load_state_dict(transformer_predictor_state_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return jm, params, tm.eval()


def test_predictor_logits_match_jax():
    jm, params, tm = _pair(10, 0)
    assert set(transformer_predictor_state_from_jax(
        jax.tree_util.tree_map(np.asarray, params))) == set(tm.predictor.state_dict())
    rs = np.random.RandomState(1)
    idx = rs.randint(0, 65, (3, 64)).astype(np.int32)
    t = np.array([0, 4, 9], np.int32)
    want = np.asarray(jax.jit(jm.predictor.apply)({"params": params}, idx, t))
    with torch.no_grad():
        got = tm.predictor(torch.from_numpy(idx), torch.from_numpy(t))
    assert tuple(got.shape) == (3, 64, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("method,diffusion_steps", [("sample", 3), ("fast_sample", 9)])
def test_samplers_match_jax(method, diffusion_steps):
    """sample runs t = 2, 1, 0; fast_sample (skip 4, top-r 0.86) t = 8, 4, 0.
    Both port routes, plain ops and the fused kernel's plain version, give
    the JAX XLA path's [B, 8, 8] indices with its noise injected."""
    jm, params, tm = _pair(diffusion_steps, 2)
    rng = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(lambda p, r: getattr(jm, method)(p, r, 2))(params, rng))
    _, gumbel = _jax_noise(rng, (2, 64, 65), 3, init=False)
    for fused in (False, True):
        tm.diffusion.fused_posterior = fused
        got = getattr(tm, method)(2, step_gumbel=gumbel)
        assert tuple(got.shape) == (2, 8, 8) and int(got.max()) <= 63
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"fused_posterior={fused}")


def test_prng_route_runs_on_cpu():
    """fused_posterior 'prng' through both samplers: the CPU wrapper draws
    the kernel's Philox noise from per-row seeds of the generator."""
    tm = TorchTVQ(diffusion_steps=5, fused_posterior="prng", **GEOMETRY)
    tm.predictor.init_weights(torch.Generator().manual_seed(0))
    for method in ("sample", "fast_sample"):
        a = getattr(tm, method)(2, generator=torch.Generator().manual_seed(1))
        b = getattr(tm, method)(2, generator=torch.Generator().manual_seed(1))
        assert torch.equal(a, b) and 0 <= int(a.min()) and int(a.max()) <= 63


def test_text_condition_not_ported():
    """The cross-attention is built (tests/test_torch_port_xattn.py holds it
    to JAX); the CLIP text encoder is not in the repository, so
    ``encode_text`` raises."""
    tm = TorchTVQ(use_text_condition=True, **GEOMETRY)
    with pytest.raises(NotImplementedError, match="CLIP"):
        tm.encode_text(["a cat"])
