"""Diffusion noise schedules (the port's copy of the JAX ``diffusion/schedules.py``).

Plain numpy in float64:

- ``linear_betas``: linspace(1e-4, 0.02, T);
- ``cosine_betas``: the cosine schedule, clipped to 0.999.

``discrete_alpha_schedule`` (the discrete VQ-diffusion priors) comes with
their slice.
"""

from __future__ import annotations

import math

import numpy as np


def linear_betas(timesteps: int, beta_start: float = 1e-4,
                 beta_end: float = 0.02) -> np.ndarray:
    return np.linspace(beta_start, beta_end, timesteps, dtype=np.float64)


def cosine_betas(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    t = np.linspace(0, timesteps, steps, dtype=np.float64) / timesteps
    alphas_cumprod = np.cos((t + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def get_betas(name: str, timesteps: int) -> np.ndarray:
    if name == "linear":
        return linear_betas(timesteps)
    if name == "cosine":
        return cosine_betas(timesteps)
    raise ValueError(f"unknown schedule {name!r}")
