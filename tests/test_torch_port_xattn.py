"""The transformer prior's cross-attention on a given ``cond_emb`` against
the JAX package's (``models/transformer_vq_diffusion.py``,
``AdaLNTransformerBlock.norm_cross`` / ``.cross_attention``): the weight
map, the predictor's logits, the training loss with the JAX draws injected,
both samplers with the JAX noise injected, and ``cond_emb=None``.

Geometry: 16 codes (K = 17) over 16 positions, width 32, 2 blocks of 4
heads, a ``cond_emb`` [B, 5, 24] (D_c = 24, so the key and value project
from another width than the query).

Tolerances: logits within 1e-4 (f32 sums in other orders through two
blocks), the loss and its metrics within 1e-5 relative (dropout off, as
the JAX denoiser bound without a dropout key), sampled indices identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_discrete import _jax_noise
from test_torch_port_discrete_train import assert_lt_close, jax_draws, lt_to_jax
from vq_vae_gan_diffusion_torch import vq_diffusion
from vq_vae_gan_diffusion_torch.diffusion import discrete as td
from vq_vae_gan_diffusion_torch.models import transformer_vq_diffusion as t_tvq_mod
from vq_vae_gan_diffusion_torch.models.transformer_vq_diffusion import (
    TransformerVQDiffusion as TorchTVQ)
from vq_vae_gan_diffusion_torch.weights import transformer_predictor_state_from_jax
from vq_vae_gan_diffusion_tpu.models.transformer_vq_diffusion import (
    TransformerVQDiffusion as JaxTVQ)

GEOMETRY = dict(codebook_size=16, seq_len=16, embedding_dim=32, num_layers=2, num_heads=4)
D_C, S, B = 24, 5, 3


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _params(jm: JaxTVQ, seed: int):
    """Predictor params with the cross layers, drawn with numpy: kernels
    N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.1^2), the rest N(0, 0.1^2)."""
    shapes = jax.eval_shape(lambda: jm.predictor.init(
        jax.random.PRNGKey(0), jnp.zeros((1, jm.seq_len), jnp.int32),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, S, D_C))))["params"]
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


def _pair(diffusion_steps: int, seed: int, monkeypatch=None):
    """(JAX model, its params, the port model with them) with text
    conditioning on; dropout off on the port side when ``monkeypatch``."""
    if monkeypatch is not None:
        monkeypatch.setattr(t_tvq_mod, "DROPOUT", 0.0)
    jm = JaxTVQ(diffusion_steps=diffusion_steps, use_text_condition=True, **GEOMETRY)
    params = _params(jm, seed)
    tm = TorchTVQ(diffusion_steps=diffusion_steps, use_text_condition=True, cond_dim=D_C,
                  **GEOMETRY)
    tm.predictor.load_state_dict(transformer_predictor_state_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return jm, params, tm


def _cond(seed: int, b: int = B) -> np.ndarray:
    return np.random.RandomState(seed).standard_normal((b, S, D_C)).astype(np.float32)


def test_weight_map_covers_the_flax_tree():
    """Every flax leaf, the cross layers' included, maps to one port key,
    and the port's predictor has no other; key and value project from
    D_c."""
    jm, params, tm = _pair(4, 0)
    mapped = transformer_predictor_state_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert set(mapped) == set(tm.predictor.state_dict())
    assert len(mapped) == len(jax.tree_util.tree_leaves(params))
    for i in range(2):
        blk = params[f"block{i}"]
        assert {"norm_cross", "cross_attention"} <= set(blk)
        assert tuple(mapped[f"block{i}.cross_attention.key.weight"].shape) == (32, D_C)
        assert tuple(mapped[f"block{i}.cross_attention.value.weight"].shape) == (32, D_C)
        assert tuple(mapped[f"block{i}.cross_attention.query.weight"].shape) == (32, 32)
        np.testing.assert_array_equal(
            mapped[f"block{i}.cross_attention.key.weight"].numpy(),
            np.asarray(blk["cross_attention"]["key"]["kernel"]).reshape(D_C, 32).T)
        np.testing.assert_array_equal(mapped[f"block{i}.norm_cross.weight"].numpy(),
                                      np.asarray(blk["norm_cross"]["scale"]))


def test_logits_match_flax():
    jm, params, tm = _pair(10, 1)
    rs = np.random.RandomState(2)
    idx = rs.randint(0, 17, (B, 16)).astype(np.int32)
    t = np.array([0, 4, 9], np.int32)
    cond = _cond(3)
    want = np.asarray(jax.jit(jm.predictor.apply)({"params": params}, idx, t, cond))
    with torch.no_grad():
        got = tm.eval().predictor(torch.from_numpy(idx), torch.from_numpy(t),
                                  torch.from_numpy(cond))
    assert tuple(got.shape) == (B, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_cond_emb_none_skips_the_cross_layers():
    """With the cross layers built and ``cond_emb`` None, the logits equal
    the model without them on the same other weights, and flax's with the
    same params and no ``cond_emb`` (the JAX block's ``if``)."""
    jm, params, tm = _pair(10, 4)
    plain = TorchTVQ(diffusion_steps=10, **GEOMETRY)
    state = tm.predictor.state_dict()
    plain.predictor.load_state_dict({k: v for k, v in state.items() if "cross" not in k},
                                    strict=True)
    idx = np.random.RandomState(5).randint(0, 17, (B, 16)).astype(np.int32)
    t = np.array([1, 5, 8], np.int32)
    with torch.no_grad():
        got = tm.eval().predictor(torch.from_numpy(idx), torch.from_numpy(t))
        bare = plain.eval().predictor(torch.from_numpy(idx), torch.from_numpy(t))
    assert torch.equal(got, bare)
    want = np.asarray(jax.jit(jm.predictor.apply)({"params": params}, idx, t))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_loss_matches_jax(monkeypatch):
    """The training loss with ``cond_emb`` (dropout off), its metrics and
    LtState, with the JAX draws injected."""
    jm, params, tm = _pair(8, 6, monkeypatch)
    x0 = np.random.RandomState(7).randint(0, 16, (B, 16))
    cond = _cond(8)
    lt = td.LtState.init(8)
    rng = jax.random.PRNGKey(9)

    @jax.jit
    def ref(params, x0, rng, cond):
        jm.diffusion.model_fn = jm._bind(params, cond)
        return jm.diffusion.train_loss(rng, x0, lt_to_jax(lt))
    want, want_metrics, want_lt = ref(params, jnp.asarray(x0), rng, jnp.asarray(cond))
    t, gumbel = jax_draws(jm.diffusion, rng, B, lt_to_jax(lt))
    got, got_metrics, got_lt = tm.loss(torch.from_numpy(x0).long(), lt, t=t, gumbel=gumbel,
                                       cond_emb=torch.from_numpy(cond))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for name in want_metrics:
        np.testing.assert_allclose(float(got_metrics[name]), float(want_metrics[name]),
                                   rtol=1e-5, err_msg=name)
    assert_lt_close(got_lt, want_lt)


@pytest.mark.parametrize("method,diffusion_steps", [("sample", 3), ("fast_sample", 9)])
def test_samplers_match_jax(method, diffusion_steps):
    """Both samplers on a ``cond_emb``, through plain ops and the fused
    kernel's plain version, give the JAX indices with its noise injected."""
    jm, params, tm = _pair(diffusion_steps, 10)
    cond = _cond(11, 2)
    rng = jax.random.PRNGKey(12)
    want = np.asarray(jax.jit(
        lambda p, r, c: getattr(jm, method)(p, r, 2, cond_emb=c))(params, rng, cond))
    _, gumbel = _jax_noise(rng, (2, 16, 17), 3, init=False)
    for fused in (False, True):
        tm.diffusion.fused_posterior = fused
        got = getattr(tm, method)(2, step_gumbel=gumbel, cond_emb=torch.from_numpy(cond))
        assert tuple(got.shape) == (2, 4, 4)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"fused_posterior={fused}")


def test_encode_text_refuses_and_the_demo_with_it():
    """No CLIP weights in the repository: ``encode_text`` raises and names
    them; without text conditioning it gives None; the demo's
    ``--use-text-condition`` raises from it."""
    tm = TorchTVQ(diffusion_steps=4, use_text_condition=True, **GEOMETRY)
    assert tm.predictor.block0.cross_attention.key.in_features == 512
    with pytest.raises(NotImplementedError, match="clip-vit-base-patch32"):
        tm.encode_text(["a cat"])
    assert TorchTVQ(diffusion_steps=4, **GEOMETRY).encode_text(["a cat"]) is None
    with pytest.raises(NotImplementedError, match="CLIP"):
        vq_diffusion.run(["--steps", "1", "--device", "cpu", "--use-text-condition"])
