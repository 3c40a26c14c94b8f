"""Diffusion noise schedules (the port's copy of the JAX ``diffusion/schedules.py``).

Plain numpy in float64:

- ``linear_betas``: linspace(1e-4, 0.02, T);
- ``cosine_betas``: the cosine schedule, clipped to 0.999;
- ``discrete_alpha_schedule``: the mask-and-replace (at, bt, ct) keep /
  uniform-replace / mask schedule of the discrete VQ-diffusion priors.
"""

from __future__ import annotations

import math
from typing import Tuple

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


def discrete_alpha_schedule(time_step: int, N: int = 100, att_1: float = 0.99999,
                            att_T: float = 0.000009, ctt_1: float = 0.000009,
                            ctt_T: float = 0.99999) -> Tuple[np.ndarray, ...]:
    """Per-step and cumulative keep / uniform-replace / mask probabilities
    (at, bt, ct, att, btt, ctt) of the mask-and-replace process. N is the
    number of non-mask classes. The per-step arrays have ``time_step``
    entries; the cumulative ones ``time_step + 1``, the last being the
    padding entry (att 1, ctt 0) that index T (and t - 1 = -1 wrapped) reads."""
    att = np.arange(0, time_step) / (time_step - 1) * (att_T - att_1) + att_1
    att = np.concatenate(([1.0], att))
    at = att[1:] / att[:-1]
    ctt = np.arange(0, time_step) / (time_step - 1) * (ctt_T - ctt_1) + ctt_1
    ctt = np.concatenate(([0.0], ctt))
    one_minus_ctt = 1 - ctt
    one_minus_ct = one_minus_ctt[1:] / one_minus_ctt[:-1]
    ct = 1 - one_minus_ct
    bt = (1 - at - ct) / N
    att = np.concatenate((att[1:], [1.0]))
    ctt = np.concatenate((ctt[1:], [0.0]))
    btt = (1 - att - ctt) / N
    return at, bt, ct, att, btt, ctt
