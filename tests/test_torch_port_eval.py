"""The port's eval metrics (``utils/eval_metrics.py``, ``utils/image.psnr``)
against the JAX package's, on the same arrays.

``psnr`` and ``ssim`` are float64 numpy on both sides: within 1e-12.
``feature_fid`` runs the LPIPS VGG in f32 on each side (the JAX
``load_lpips_params()`` transplanted by ``weights.lpips_state_from_jax``),
then the same float64 statistics: within 1e-4 relative.
"""

import jax
import numpy as np
import pytest
import torch

from vq_vae_gan_diffusion_torch.models.lpips import LPIPS
from vq_vae_gan_diffusion_torch.utils import eval_metrics as tm
from vq_vae_gan_diffusion_torch.utils.image import psnr as t_image_psnr
from vq_vae_gan_diffusion_torch.weights import lpips_state_from_jax
from vq_vae_gan_diffusion_tpu.models.lpips import load_lpips_params
from vq_vae_gan_diffusion_tpu.utils import eval_metrics as jm
from vq_vae_gan_diffusion_tpu.utils.image import psnr as j_image_psnr


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lpips_pair():
    """(JAX LPIPS params, the port's LPIPS with them)."""
    params = jax.tree_util.tree_map(np.asarray, load_lpips_params())
    model = LPIPS()
    model.load_state_dict(lpips_state_from_jax(params), strict=True)
    return params, model.eval().requires_grad_(False)


@pytest.mark.parametrize("shape", [(4, 16, 16, 3), (3, 9, 7, 1)])
def test_psnr_ssim_match_jax(shape):
    rs = np.random.RandomState(0)
    a = rs.random_sample(shape).astype(np.float32)
    b = np.clip(a + 0.05 * rs.standard_normal(shape), 0, 1).astype(np.float32)
    for port, ref in ((tm.psnr, jm.psnr), (t_image_psnr, j_image_psnr), (tm.ssim, jm.ssim)):
        got, want = port(a, b), ref(a, b)
        assert isinstance(got, float) and abs(got - want) <= 1e-12 * abs(want), port
        assert port(a, b, data_range=2.0) == pytest.approx(ref(a, b, data_range=2.0),
                                                           rel=1e-12)
    assert tm.psnr(a, a) == t_image_psnr(a, a) == float("inf")
    assert tm.ssim(a, a) == pytest.approx(1.0, abs=1e-12)


@pytest.mark.parametrize("channels", [3, 1])
def test_feature_fid_matches_jax(lpips_pair, channels):
    """2 x 24 images at 32^2: the port on the CPU against the JAX function
    with the same VGG weights."""
    params, model = lpips_pair
    rs = np.random.RandomState(channels)
    real = rs.random_sample((24, 32, 32, channels)).astype(np.float32)
    fake = (rs.random_sample((24, 32, 32, channels)) ** 2).astype(np.float32)
    want = jm.feature_fid(real, fake, params)
    got = tm.feature_fid(real, fake, model, device="cpu")
    assert isinstance(got, float) and np.isfinite(got) and want > 0
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)


def test_feature_fid_orders(lpips_pair):
    """A light perturbation of the real set is closer than another
    distribution (the JAX tests/test_eval_and_convergence.py property)."""
    _, model = lpips_pair
    rng = np.random.default_rng(0)
    real = rng.random((32, 32, 32, 3)).astype(np.float32)
    close = np.clip(real + 0.02 * rng.standard_normal(real.shape), 0, 1).astype(np.float32)
    far = rng.random((32, 32, 32, 3)).astype(np.float32) ** 4
    assert (tm.feature_fid(real, close, model, device="cpu")
            < tm.feature_fid(real, far, model, device="cpu"))


def test_feature_fid_batches_and_refuses_without_gpu(lpips_pair, monkeypatch):
    """The features do not depend on the batch; with no GPU and no device
    named, it raises as every entry point does."""
    _, model = lpips_pair
    imgs = np.random.RandomState(5).random_sample((7, 32, 32, 3)).astype(np.float32)
    dev = torch.device("cpu")
    np.testing.assert_allclose(tm.vgg_features(imgs, model, dev, batch=3),
                               tm.vgg_features(imgs, model, dev, batch=64), rtol=1e-5,
                               atol=1e-6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.feature_fid(imgs, imgs, model)
