"""Gaussian diffusion schedule buffers (PyTorch counterpart of the JAX
``diffusion/gaussian.py``: ``GaussianSchedule``, ``make_schedule`` and
``_extract``).

The schedule is computed in float64 with numpy, then held as float32 CPU
tensors, as the JAX package holds float32 arrays. The pixel-space
``GaussianDiffusion`` class comes with the pixel-diffusion slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .schedules import get_betas


class GaussianSchedule(NamedTuple):
    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def make_schedule(timesteps: int, name: str = "linear", beta_start: float = 1e-4,
                  beta_end: float = 0.02) -> GaussianSchedule:
    if name == "linear":
        betas = np.linspace(beta_start, beta_end, timesteps, dtype=np.float64)
    else:
        betas = get_betas(name, timesteps)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.concatenate(([1.0], ac[:-1]))
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)

    def f32(x) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x, np.float32))

    return GaussianSchedule(
        betas=f32(betas), alphas=f32(alphas), alphas_cumprod=f32(ac),
        alphas_cumprod_prev=f32(ac_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(ac)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1 - ac)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1 / ac)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1 / ac - 1)),
        posterior_variance=f32(post_var),
        posterior_log_variance_clipped=f32(np.log(np.clip(post_var, 1e-20, None))),
        posterior_mean_coef1=f32(betas * np.sqrt(ac_prev) / (1.0 - ac)),
        posterior_mean_coef2=f32((1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac)),
    )


def _extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-batch schedule values on t's device, shaped to broadcast."""
    return arr.to(t.device)[t].reshape(t.shape[0], *([1] * (ndim - 1)))
