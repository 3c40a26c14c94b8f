"""The port's Conv1d U-Net (``models/unet1d.py``), its weight map and the
Gaussian diffusion functions of ``diffusion/gaussian.py`` against the JAX
package's.

Geometry: the U-Net at base 8, mults (1, 2), 6 channels over length 16,
batch 2; the Gaussian functions on [3, 5, 12] states with a fixed
elementwise denoiser (the same float32 arithmetic on both sides), over 6
and 50 steps. The JAX U-Net's params are transplanted, never redrawn; the
JAX chains' draws are computed from their keys and injected.

Tolerances: the U-Net within 1e-5 (absolute and relative: f32 sum order
over convolutions and attention); the weight map key for key and value
for value; the schedules equal; ``q_sample``, ``q_posterior``, the three
objectives' ``model_predictions`` and ``diffusion_loss`` within 1e-6;
``ddim_times`` equal; the DDPM and DDIM chains within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_vae_gan_diffusion_torch.diffusion import gaussian as tg
from vq_vae_gan_diffusion_torch.models import unet1d as tu
from vq_vae_gan_diffusion_torch.weights import unet1d_state_from_jax
from vq_vae_gan_diffusion_tpu.diffusion import gaussian as jg
from vq_vae_gan_diffusion_tpu.models.unet1d import RMSNorm as JaxRMSNorm
from vq_vae_gan_diffusion_tpu.models.unet1d import Unet1D as JaxUnet1D
from vq_vae_gan_diffusion_tpu.utils.torch_export import export_unet1d

UNET = dict(dim=8, dim_mults=(1, 2), channels=6)
VARIANTS = {
    "plain": {},
    "condition": {"condition": True},
    "learned_sinusoid": {"learned_sinusoidal_cond": True},
    "random_fourier": {"random_fourier_features": True},
    "out_dim": {"out_dim": 5},
}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: at these sizes torch gains nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def jax_unet(seed: int = 1, **kw):
    """A flax Unet1D, its params as numpy, an input [2, 16, 6] (flax's
    channels-last) and t."""
    unet = JaxUnet1D(**UNET, **kw)
    x = np.random.RandomState(0).standard_normal((2, 16, 6)).astype(np.float32)
    t = np.array([3, 7], np.int32)
    params = jax.device_get(unet.init(jax.random.PRNGKey(seed), jnp.asarray(x), None,
                                      jnp.asarray(t))["params"])
    return unet, params, x, t


def port_unet(params, **kw) -> tu.Unet1D:
    unet = tu.Unet1D(**UNET, **kw)
    unet.load_state_dict(unet1d_state_from_jax(params), strict=True)
    return unet.eval()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_unet1d_matches_flax(variant):
    """The same params and input: flax on [B, L, C], the port on [B, C, L]
    as the JAX callers swap the torch layout, with a condition input where
    the variant takes one."""
    kw = VARIANTS[variant]
    unet, params, x, t = jax_unet(**kw)
    cond = np.random.RandomState(2).standard_normal(x.shape).astype(np.float32) \
        if kw.get("condition") else None
    want = np.asarray(jax.jit(lambda p, x, c, t: unet.apply({"params": p}, x, c, t))(
        params, x, cond, t))
    port = port_unet(params, **kw)
    with torch.no_grad():
        got = port(_t(x).transpose(1, 2),
                   None if cond is None else _t(cond).transpose(1, 2), _t(t).long())
    assert tuple(got.shape) == (2, kw.get("out_dim", 6), 16)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, rtol=1e-5, atol=1e-5)
    if kw.get("condition"):
        with torch.no_grad():
            zeros = port(_t(x).transpose(1, 2), torch.zeros(2, 6, 16), _t(t).long())
            none = port(_t(x).transpose(1, 2), None, _t(t).long())
        assert torch.equal(zeros, none)


def test_unet1d_state_matches_export():
    """unet1d_state_from_jax against the JAX package's export_unet1d, key for
    key and value for value, including the attention modules flax adopts
    into the U-Net's scope (``LinearAttention1D_{n}`` over the downs then
    the ups) and the last up stage's bare conv at ``ups.{i}.3``; the port's
    state_dict has exactly these keys and shapes."""
    _, params, _, _ = jax_unet()
    got, want = unet1d_state_from_jax(params), export_unet1d(params)
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k
    assert "ups.1.3.weight" in got and "ups.0.3.1.weight" in got and "downs.1.3.weight" in got
    port = tu.Unet1D(**UNET).state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == {k: v.shape for k, v in want.items()}


def test_unet1d_state_carries_the_learned_sinusoid():
    """A learned sinusoid's weights, which export_unet1d leaves out, go to
    ``time_mlp.0.weights``; a random one's stay out of the gradient."""
    _, params, _, _ = jax_unet(learned_sinusoidal_cond=True)
    got = unet1d_state_from_jax(params)
    assert set(got) - set(export_unet1d(params)) == {"time_mlp.0.weights"}
    np.testing.assert_array_equal(got["time_mlp.0.weights"].numpy(), params["sinu"]["weights"])
    assert not tu.Unet1D(**UNET, random_fourier_features=True).time_mlp[0].weights.requires_grad


def test_init_weights_is_flax_style():
    """init_weights: zero biases, unit gains, every kernel within two
    lecun-normal standard deviations (1 / sqrt(fan_in) / 0.8796) and its
    spread about one such deviation; the same generator seed draws the same
    weights."""
    unet = tu.Unet1D(**UNET, learned_sinusoidal_cond=True)
    unet.init_weights(torch.Generator().manual_seed(3))
    for name, p in unet.state_dict().items():
        if name.endswith(".bias"):
            assert not p.any(), name
        elif name.endswith(".g"):
            assert torch.equal(p, torch.ones_like(p)), name
        elif name.endswith("weights"):
            assert 0.5 < float(p.std()) < 1.5
        else:
            std = (1.0 / p[0].numel()) ** 0.5 / 0.87962566103423978
            assert float(p.abs().max()) <= 2 * std * (1 + 1e-6), name
            if p.numel() >= 512:
                assert 0.7 * std < float(p.std()) < 1.1 * std, name
    again = tu.Unet1D(**UNET, learned_sinusoidal_cond=True)
    again.init_weights(torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(unet.state_dict().values(),
                                                 again.state_dict().values()))


def test_rmsnorm_is_not_f_normalize():
    """RMSNorm divides by sqrt(sum x^2 + 1e-12), not max(|x|, eps): a zero
    column stays zero and a tiny one is scaled up, as in JAX."""
    x = torch.tensor([[[0.0, 1e-9, 3.0], [0.0, 0.0, 4.0]]])
    got = tu.RMSNorm(2)(x)
    want = JaxRMSNorm().apply({"params": {"g": jnp.ones((2,))}},
                              jnp.asarray(x.transpose(1, 2).numpy()))
    np.testing.assert_allclose(got.detach().transpose(1, 2).numpy(), np.asarray(want),
                               rtol=1e-6, atol=0)


# -- the Gaussian functions -------------------------------------------------------------

SHAPE = (3, 5, 12)
OBJECTIVES = ("pred_noise", "pred_x0", "pred_v")


def _jax_model(x, cond, t):
    return 0.5 * jnp.tanh(x) + 0.01 * t[:, None, None].astype(jnp.float32)


def _torch_model(x, cond, t):
    return 0.5 * torch.tanh(x) + 0.01 * t[:, None, None].float()


def _states(seed: int = 0):
    rs = np.random.RandomState(seed)
    x0 = rs.uniform(-1, 1, SHAPE).astype(np.float32)
    x_t = rs.standard_normal(SHAPE).astype(np.float32)
    noise = rs.standard_normal(SHAPE).astype(np.float32)
    t = np.array([0, 2, 5], np.int32)
    return x0, x_t, noise, t


@pytest.mark.parametrize("name", ["linear", "cosine"])
def test_schedule_matches_jax(name):
    want, got = jg.make_schedule(50, name), tg.make_schedule(50, name)
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)


def test_q_sample_and_posterior_match_jax():
    js, ts = jg.make_schedule(6), tg.make_schedule(6)
    x0, x_t, noise, t = _states()
    np.testing.assert_allclose(tg.q_sample(ts, _t(x0), _t(t).long(), _t(noise)).numpy(),
                               np.asarray(jg.q_sample(js, x0, t, noise)), rtol=1e-6, atol=1e-6)
    for got, want in zip(tg.q_posterior(ts, _t(x0), _t(x_t), _t(t).long()),
                         jg.q_posterior(js, jnp.asarray(x0), jnp.asarray(x_t), jnp.asarray(t))):
        np.testing.assert_allclose(got.numpy(), np.broadcast_to(np.asarray(want), got.shape),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_model_predictions_and_loss_match_jax(objective):
    """model_predictions clipped and not, and diffusion_loss with its x_t."""
    js, ts = jg.make_schedule(6), tg.make_schedule(6)
    x0, x_t, noise, t = _states(1)
    for clip in (False, True):
        want = jg.model_predictions(js, _jax_model, jnp.asarray(x_t), None, jnp.asarray(t),
                                    objective, clip)
        got = tg.model_predictions(ts, _torch_model, _t(x_t), None, _t(t).long(), objective,
                                   clip)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    (want_loss, want_xt) = jg.diffusion_loss(js, _jax_model, jnp.asarray(x0), None,
                                             jnp.asarray(t), jnp.asarray(noise), objective)
    got_loss, got_xt = tg.diffusion_loss(ts, _torch_model, _t(x0), None, _t(t).long(),
                                         _t(noise), objective)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(got_xt.numpy(), np.asarray(want_xt), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("total,sampling", [(1000, 1000), (1000, 500), (1000, 250),
                                            (50, 7), (6, 6), (10, 3)])
def test_ddim_times_match_jax(total, sampling):
    np.testing.assert_array_equal(tg.ddim_times(total, sampling), jg.ddim_times(total, sampling))


def _jax_step_noise(rng, n: int):
    """The noise of the n steps of jg.ddpm_sample / ddim_sample from ``rng``."""
    out = []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        out.append(_t(jax.random.normal(sub, SHAPE, jnp.float32)))
    return out


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_ddpm_chain_matches_jax(objective):
    js, ts = jg.make_schedule(6, "cosine"), tg.make_schedule(6, "cosine")
    _, x_t, _, _ = _states(2)
    rng = jax.random.PRNGKey(4)
    want, want_all = jax.jit(lambda x: jg.ddpm_sample(js, _jax_model, rng, x, None, objective,
                                                      True, return_all=True))(x_t)
    got, got_all = tg.ddpm_sample(ts, _torch_model, _t(x_t), None, objective, True, True,
                                  step_noise=_jax_step_noise(rng, 6))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_all.numpy(), np.asarray(want_all), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("eta,sampling", [(0.0, 50), (1.0, 7)])
def test_ddim_chain_matches_jax(eta, sampling):
    """DDIM over 50 steps: eta 0 over all of them, eta 1 over 7 (noise
    entering every step but the last, which takes x_start)."""
    js, ts = jg.make_schedule(50), tg.make_schedule(50)
    _, x_t, _, _ = _states(3)
    rng = jax.random.PRNGKey(5)
    want = jax.jit(lambda x: jg.ddim_sample(js, _jax_model, rng, x, None, eta, sampling,
                                            clip_x_start=True))(x_t)
    got = tg.ddim_sample(ts, _torch_model, _t(x_t), None, eta, sampling, clip_x_start=True,
                         step_noise=_jax_step_noise(rng, sampling))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_chains_draw_from_the_generator():
    """Without injected noise the chains draw from the generator: the same
    seed gives the same chain, another seed another."""
    ts = tg.make_schedule(6)
    x = torch.randn(SHAPE, generator=torch.Generator().manual_seed(0))

    def run(seed, fn):
        return fn(ts, _torch_model, x, generator=torch.Generator().manual_seed(seed))
    for fn in (tg.ddpm_sample, lambda *a, **k: tg.ddim_sample(*a, eta=1.0, **k)):
        assert torch.equal(run(1, fn), run(1, fn))
        assert not torch.equal(run(1, fn), run(2, fn))
