"""Reconstruction and sample-quality metrics (counterpart of the JAX
``utils/eval_metrics.py``).

- :func:`psnr` and :func:`ssim`: over [0, 1] images in float64, SSIM over
  one global window;
- :func:`feature_fid`: the Fréchet distance between Gaussians of the LPIPS
  VGG's pooled deepest tap. With lpips-0.1.4 weights it is a VGG-FID; with
  the seeded random VGG a random-feature FID. There is no Inception-FID:
  its weights would have to be downloaded.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .image import psnr

__all__ = ["psnr", "ssim", "feature_fid"]


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Global (one-window) SSIM of two [N, H, W, C] batches, in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = a.mean(), b.mean()
    var_a, var_b = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return float(((2 * mu_a * mu_b + c1) * (2 * cov + c2)) /
                 ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)))


@torch.no_grad()
def vgg_features(images: np.ndarray, model, device: torch.device,
                 batch: int = 64) -> np.ndarray:
    """The VGG trunk's deepest tap averaged over space, [N, 512] float64, for
    [N, H, W, C] images in [0, 1]: mapped to [-1, 1], grey repeated to RGB,
    ``batch`` images a call on ``device``."""
    out = []
    for i in range(0, len(images), batch):
        x = torch.as_tensor(np.asarray(images[i:i + batch], np.float32), device=device)
        x = x.permute(0, 3, 1, 2)
        if x.shape[1] == 1:
            x = x.expand(-1, 3, -1, -1)
        out.append(model._taps(x * 2.0 - 1.0)[-1].mean((2, 3)).double().cpu().numpy())
    return np.concatenate(out)


def feature_fid(real: np.ndarray, fake: np.ndarray, model=None,
                device: Optional[str] = None, batch: int = 64) -> float:
    """Fréchet distance between the feature Gaussians of ``real`` and
    ``fake`` [N, H, W, C] in [0, 1]: covariances ridged by 1e-6, the real
    part of ``scipy.linalg.sqrtm``. ``model`` is an LPIPS
    (``models/lpips.load_lpips()`` when None); it runs on ``device`` (CUDA
    unless the caller names another; raises without a GPU)."""
    import scipy.linalg

    from ..models.lpips import load_lpips
    from .device import resolve_device

    dev = resolve_device(device)
    model = (model if model is not None else load_lpips()).to(dev)
    fr = vgg_features(real, model, dev, batch)
    ff = vgg_features(fake, model, dev, batch)
    mu_r, mu_f = fr.mean(0), ff.mean(0)
    cov_r = np.cov(fr, rowvar=False) + 1e-6 * np.eye(fr.shape[1])
    cov_f = np.cov(ff, rowvar=False) + 1e-6 * np.eye(ff.shape[1])
    covmean = scipy.linalg.sqrtm(cov_r @ cov_f)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    diff = mu_r - mu_f
    return float(diff @ diff + np.trace(cov_r + cov_f - 2 * covmean))
