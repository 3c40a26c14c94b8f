"""The port's gaussian3d diffusion pieces (``diffusion/``) against the JAX
package's: schedules, the positional-encoding table, DDPM and DDIM reverse
steps with the JAX package's noise injected, and the cosine-argmax decode.

Both sides get the same deterministic denoiser, so the comparison is of the
samplers alone. Tolerances: schedules and the table are the same float64
numpy computation cast to float32, so they are equal; a few reverse steps
sum float32 terms in the same order, 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_vae_gan_diffusion_torch.diffusion import gaussian3d as tg3
from vq_vae_gan_diffusion_torch.diffusion.gaussian import make_schedule as t_make_schedule
from vq_vae_gan_diffusion_torch.diffusion.schedules import (cosine_betas, get_betas,
                                                            linear_betas)
from vq_vae_gan_diffusion_tpu.diffusion import gaussian3d as jg3
from vq_vae_gan_diffusion_tpu.diffusion import schedules as js
from vq_vae_gan_diffusion_tpu.diffusion.gaussian import make_schedule as j_make_schedule


def _jax_model(x, self_cond, t):
    return 0.5 * jnp.tanh(x) + 0.01 * t[:, None, None, None].astype(jnp.float32)


def _torch_model(x, self_cond, t):
    return 0.5 * torch.tanh(x) + 0.01 * t[:, None, None, None].float()


def _pair(timesteps, sampling_timesteps, method, eta=0.0):
    kw = dict(image_sizes=(16, 8), in_channels=1, timesteps=timesteps,
              sampling_timesteps=sampling_timesteps, sample_method=method,
              ddim_sampling_eta=eta)
    return (jg3.GaussianDiffusion3D(model_fn=_jax_model, **kw),
            tg3.GaussianDiffusion3D(model_fn=_torch_model, **kw))


def _jax_noise(rng, shape, steps):
    """The noise the JAX samplers draw from ``rng``: x_T, then one tensor a step."""
    rng, sub = jax.random.split(rng)
    x_t = jax.random.normal(sub, shape)
    noise = []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        noise.append(jax.random.normal(sub, shape, jnp.float32))
    return torch.from_numpy(np.array(x_t)), [torch.from_numpy(np.array(n)) for n in noise]


@pytest.mark.parametrize("timesteps", [1, 10, 1000])
def test_schedules_match_jax(timesteps):
    np.testing.assert_array_equal(linear_betas(timesteps), js.linear_betas(timesteps))
    np.testing.assert_array_equal(cosine_betas(timesteps), js.cosine_betas(timesteps))
    for name in ("linear", "cosine"):
        np.testing.assert_array_equal(get_betas(name, timesteps), js.get_betas(name, timesteps))
        got, want = t_make_schedule(timesteps, name), j_make_schedule(timesteps, name)
        for field in want._fields:
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)), err_msg=field)
    with pytest.raises(ValueError, match="unknown schedule"):
        get_betas("quadratic", timesteps)


@pytest.mark.parametrize("dim,n", [(96, 1024), (15, 7)])
def test_positional_encoding_table_matches_jax(dim, n):
    got = tg3.positional_encoding_table(dim, n)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jg3.positional_encoding_table(dim, n))


def test_cosine_schedule_always():
    """GaussianDiffusion3D ignores any configured schedule: it is cosine."""
    _, port = _pair(50, 50, "ddpm")
    np.testing.assert_array_equal(port.sched.betas.numpy(),
                                  cosine_betas(50).astype(np.float32))


@pytest.mark.parametrize("clipped", [True, False])
@pytest.mark.parametrize("t", [0, 1, 500, 999])
def test_ddpm_step_matches_jax(t, clipped):
    jax_d, port = _pair(1000, 1000, "ddpm")
    rs = np.random.RandomState(t)
    x = rs.standard_normal((2, 16, 8, 1)).astype(np.float32)
    noise = rs.standard_normal((2, 16, 8, 1)).astype(np.float32)
    want = jax_d._reverse_step(jnp.asarray(x), t, jnp.asarray(noise), clipped)
    got = port._reverse_step(torch.from_numpy(x), t, torch.from_numpy(noise), clipped)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ddpm_chain_matches_jax_with_injected_noise():
    jax_d, port = _pair(3, 3, "ddpm")
    rng = jax.random.PRNGKey(4)
    want = jax_d.ddpm_sample(rng, 2)
    x_t, noise = _jax_noise(rng, (2, 16, 8, 1), 3)
    got = port.ddpm_sample(2, x_T=x_t, step_noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_steps_match_jax_with_injected_noise(eta):
    """T=10, S=3: the grid linspace(-1, 9, 3) -> times 9, 4, -1, so the second
    step takes the time_next < 0 branch."""
    jax_d, port = _pair(10, 3, "ddim", eta)
    np.testing.assert_array_equal(port.ddim_times(), [9, 4, -1])
    rng = jax.random.PRNGKey(5)
    want = jax_d.ddim_sample(rng, 2)
    x_t, noise = _jax_noise(rng, (2, 16, 8, 1), 2)
    got = port.sampling(2, x_T=x_t, step_noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_predict_start_from_noise_matches_jax():
    jax_d, port = _pair(1000, 1000, "ddpm")
    rs = np.random.RandomState(6)
    x = rs.standard_normal((3, 16, 8, 1)).astype(np.float32)
    eps = rs.standard_normal((3, 16, 8, 1)).astype(np.float32)
    t = np.array([0, 17, 999])
    want = jax_d.predict_start_from_noise(jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps))
    got = port.predict_start_from_noise(torch.from_numpy(x), torch.from_numpy(t),
                                        torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_gaussian_to_indices_matches_jax():
    kw = dict(seq_length=16, timesteps=4, sampling_timesteps=4, vocab_size=64, gaussian_dim=16)
    jax_p, port = jg3.VQGaussianDiffusion3D(**kw), tg3.VQGaussianDiffusion3D(**kw)
    g = np.random.RandomState(7).standard_normal((2, 16, 16, 1)).astype(np.float32)
    want = np.asarray(jax_p.gaussian_to_indices(jnp.asarray(g)))
    got = port.gaussian_to_indices(torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), want)
    # a table row decodes to its own index
    idx = np.random.RandomState(8).randint(0, 64, (2, 16))
    emb = port.indices_to_gaussian(torch.from_numpy(idx))
    np.testing.assert_array_equal(emb.numpy(),
                                  np.asarray(jax_p.indices_to_gaussian(jnp.asarray(idx))))
    np.testing.assert_array_equal(port.gaussian_to_indices(emb[..., None]).numpy(), idx)
