"""The gaussian3d prior's diffusion (the reference repository's
``GaussianDiffusion3D`` under ``VQ_GaussianDiffusion3D``), float32:

- the cosine schedule (s = 0.008, betas clipped to 0.999), whatever the
  configuration's ``noise_schedule`` says, as the reference does;
- tokens embedded by the sinusoidal table [K, D] (sin on even, cos on odd
  columns, 10000^(-2i/D)); a state read back as the row of greatest cosine
  similarity;
- the DDPM reverse step with the clipped x0: x0 = sqrt(1/ac) x_t -
  sqrt(1/ac - 1) eps, clipped to [-1, 1], then the posterior mean and the
  step's noise times sqrt(beta (1 - ac_prev) / (1 - ac)); at t = 0 the
  mean beta / (1 - ac) x0 and no noise;
- the loss: the mean squared error of the predicted noise at a uniform t.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch


def cosine_schedule(steps: int) -> dict:
    """The schedule's float32 scalars as CPU tensors of [steps]."""
    s = 0.008
    t = np.linspace(0, steps, steps + 1, dtype=np.float64) / steps
    ac = np.cos((t + s) / (1 + s) * math.pi * 0.5) ** 2
    betas = np.clip(1 - ac[1:] / ac[:-1], 0, 0.999)
    alphas = 1 - betas
    acp = np.cumprod(alphas)
    prev = np.concatenate(([1.0], acp[:-1]))
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))   # noqa: E731
    return {"betas": f32(betas), "alphas": f32(alphas), "ac": f32(acp), "ac_prev": f32(prev),
            "sqrt_ac": f32(np.sqrt(acp)), "sqrt_1m_ac": f32(np.sqrt(1 - acp))}


def lookup_table(dim: int, k: int) -> torch.Tensor:
    """The sinusoidal table [k, dim], float32."""
    pos = torch.arange(k, dtype=torch.float64)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float64) * -(math.log(10000.0) / dim))
    table = torch.zeros(k, dim, dtype=torch.float64)
    table[:, 0::2] = torch.sin(pos * div)
    table[:, 1::2] = torch.cos(pos * div)[:, :table[:, 1::2].shape[1]]
    return table.float()


def cosine_scores(state: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """State [B, N, D, 1] (in [-1, 1]) -> cosine similarity to each table row
    [B, N, K]."""
    x = state[..., 0]
    x = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    t = table / table.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return x @ t.T


def reverse_step(model: Callable, sched: dict, x: torch.Tensor, t: int,
                 noise: torch.Tensor) -> torch.Tensor:
    eps = model(x, torch.full((x.shape[0],), t, dtype=torch.long, device=x.device))
    beta, alpha, ac, prev = (sched[k][t] for k in ("betas", "alphas", "ac", "ac_prev"))
    x0 = torch.clip(torch.sqrt(1.0 / ac) * x - torch.sqrt(1.0 / ac - 1.0) * eps, -1.0, 1.0)
    if t == 0:
        return (beta / (1 - ac)) * x0
    mean = (beta * torch.sqrt(prev) / (1 - ac)) * x0 + ((1 - prev) * torch.sqrt(alpha) / (1 - ac)) * x
    return mean + torch.sqrt(beta * (1 - prev) / (1 - ac)) * noise


@torch.no_grad()
def ddpm_chain(model: Callable, sched: dict, x_T: torch.Tensor,
               step_noise: Sequence[torch.Tensor]) -> torch.Tensor:
    """All reverse steps from x_T; step i (t = T-1-i) takes step_noise[i].
    Returns the final state x_0."""
    x = x_T
    steps = len(sched["betas"])
    for i, t in enumerate(range(steps - 1, -1, -1)):
        x = reverse_step(model, sched, x, t, step_noise[i])
    return x


def noise_mse(model: Callable, sched: dict, x0: torch.Tensor, t: torch.Tensor,
              noise: torch.Tensor) -> torch.Tensor:
    """The noise MSE at steps t [B] of x0 [B, N, D, 1]."""
    shape = (-1, 1, 1, 1)
    x_t = (sched["sqrt_ac"].to(x0.device)[t].view(shape) * x0 +
           sched["sqrt_1m_ac"].to(x0.device)[t].view(shape) * noise)
    return torch.mean((model(x_t, t) - noise) ** 2)
