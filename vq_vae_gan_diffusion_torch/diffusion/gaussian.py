"""Gaussian diffusion core (PyTorch counterpart of the JAX
``diffusion/gaussian.py``): the schedule buffers, q-sampling, the
prediction conversions of the pred_noise / pred_x0 / pred_v objectives, the
MSE loss and the DDPM and DDIM reverse chains.

The schedule is computed in float64 with numpy, then held as float32 CPU
tensors, as the JAX package holds float32 arrays; a reverse step reads its
scalars from them, so the step's arithmetic is float32 as in JAX.

Noise comes from an explicit ``torch.Generator`` on the state's device, or
is injected (``step_noise``, one tensor a reverse step), as the parity
tests inject the JAX package's draws. These functions are the whole of the
JAX module, which has no class: the pixel-space DDPM
(``train_diffusion.py``) calls ``make_schedule``, ``diffusion_loss`` and
``ddim_sample``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

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


ModelFn = Callable[[torch.Tensor, Optional[torch.Tensor], torch.Tensor], torch.Tensor]
# model_fn(x_t, condition_or_self_cond, t) -> prediction


def _randn(shape, generator: Optional[torch.Generator],
           device: Optional[torch.device]) -> torch.Tensor:
    """N(0, I) of ``shape`` from ``generator`` (on its device), else from
    torch's global generator on ``device``."""
    if generator is not None:
        device = generator.device
    return torch.randn(shape, generator=generator, device=device)


def q_posterior(sched: GaussianSchedule, x0: torch.Tensor, x_t: torch.Tensor,
                t: torch.Tensor):
    """q(x_{t-1} | x_t, x_0) -> (mean, variance, log_variance_clipped)."""
    n = x_t.dim()
    mean = (_extract(sched.posterior_mean_coef1, t, n) * x0 +
            _extract(sched.posterior_mean_coef2, t, n) * x_t)
    return (mean, _extract(sched.posterior_variance, t, n),
            _extract(sched.posterior_log_variance_clipped, t, n))


def q_sample(sched: GaussianSchedule, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion x0 -> x_t."""
    return (_extract(sched.sqrt_alphas_cumprod, t, x0.dim()) * x0 +
            _extract(sched.sqrt_one_minus_alphas_cumprod, t, x0.dim()) * noise)


def predict_start_from_noise(sched, x_t, t, noise):
    return (_extract(sched.sqrt_recip_alphas_cumprod, t, x_t.dim()) * x_t -
            _extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.dim()) * noise)


def predict_noise_from_start(sched, x_t, t, x0):
    return ((_extract(sched.sqrt_recip_alphas_cumprod, t, x_t.dim()) * x_t - x0) /
            _extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.dim()))


def predict_v(sched, x0, t, noise):
    return (_extract(sched.sqrt_alphas_cumprod, t, x0.dim()) * noise -
            _extract(sched.sqrt_one_minus_alphas_cumprod, t, x0.dim()) * x0)


def predict_start_from_v(sched, x_t, t, v):
    return (_extract(sched.sqrt_alphas_cumprod, t, x_t.dim()) * x_t -
            _extract(sched.sqrt_one_minus_alphas_cumprod, t, x_t.dim()) * v)


def model_predictions(sched: GaussianSchedule, model_fn: ModelFn, x_t, condition, t,
                      objective: str = "pred_noise", clip_x_start: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (pred_noise, pred_x0) by the objective, x0 clipped to [-1, 1] when
    ``clip_x_start``."""
    out = model_fn(x_t, condition, t)

    def clip(v):
        return torch.clamp(v, -1.0, 1.0) if clip_x_start else v

    if objective == "pred_noise":
        return out, clip(predict_start_from_noise(sched, x_t, t, out))
    if objective == "pred_x0":
        x0 = clip(out)
    elif objective == "pred_v":
        x0 = clip(predict_start_from_v(sched, x_t, t, out))
    else:
        raise ValueError(objective)
    return predict_noise_from_start(sched, x_t, t, x0), x0


def diffusion_loss(sched: GaussianSchedule, model_fn: ModelFn, x0, condition, t, noise,
                   objective: str = "pred_noise") -> Tuple[torch.Tensor, torch.Tensor]:
    """The MSE training loss against the objective's target -> (loss, x_t)."""
    x_t = q_sample(sched, x0, t, noise)
    out = model_fn(x_t, condition, t)
    if objective == "pred_noise":
        target = noise
    elif objective == "pred_x0":
        target = x0
    elif objective == "pred_v":
        target = predict_v(sched, x0, t, noise)
    else:
        raise ValueError(objective)
    dtype = torch.promote_types(torch.promote_types(out.dtype, target.dtype), torch.float32)
    return torch.mean((out.to(dtype) - target.to(dtype)) ** 2), x_t


def _step_noise(i: int, x: torch.Tensor, generator: Optional[torch.Generator],
                step_noise: Optional[Sequence[torch.Tensor]]) -> torch.Tensor:
    if step_noise is not None:
        return step_noise[i].to(x.device)
    return _randn(x.shape, generator, x.device)


def ddpm_sample(sched: GaussianSchedule, model_fn: ModelFn, x_t: torch.Tensor,
                condition=None, objective: str = "pred_noise", clip_x_start: bool = False,
                return_all: bool = False, *, generator: Optional[torch.Generator] = None,
                step_noise: Optional[Sequence[torch.Tensor]] = None):
    """The full reverse DDPM chain from ``x_t``, t = T-1 .. 0; ``step_noise[i]``
    is the i-th step's noise (no noise enters at t = 0). With ``return_all``
    also every step's state [T, ...]."""
    x, states = x_t, []
    for i, t in enumerate(range(sched.num_timesteps - 1, -1, -1)):
        z = _step_noise(i, x, generator, step_noise)
        tb = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        pred_noise, _ = model_predictions(sched, model_fn, x, condition, tb, objective,
                                          clip_x_start)
        alpha_t, hat_alpha_t = sched.alphas[t], sched.alphas_cumprod[t]
        x = (1.0 / torch.sqrt(alpha_t)) * (
            x - (1 - alpha_t) / torch.sqrt(1 - hat_alpha_t) * pred_noise)
        if t > 0:
            x = x + torch.sqrt(sched.betas[t]) * z
        states.append(x)
    return (x, torch.stack(states)) if return_all else x


def ddim_times(total_timesteps: int, sampling_timesteps: int) -> np.ndarray:
    """torch.linspace(-1, T-1, S+1).int(), descending."""
    times = np.linspace(-1, total_timesteps - 1, sampling_timesteps + 1)
    return np.asarray(list(reversed(times.astype(int).tolist())), np.int32)


def ddim_sample(sched: GaussianSchedule, model_fn: ModelFn, x_t: torch.Tensor,
                condition=None, eta: float = 0.0, sampling_timesteps: Optional[int] = None,
                objective: str = "pred_noise", clip_x_start: bool = False,
                return_all: bool = False, *, generator: Optional[torch.Generator] = None,
                step_noise: Optional[Sequence[torch.Tensor]] = None):
    """The DDIM reverse chain over :func:`ddim_times`: ``at1`` read at
    max(time_next, 0), the last step (time_next = -1) takes x_start.
    ``step_noise[i]`` is the i-th step's noise; with ``return_all`` also
    every step's state."""
    times = ddim_times(sched.num_timesteps, sampling_timesteps or sched.num_timesteps)
    x, states = x_t, []
    for i, (time, time_next) in enumerate(zip(times[:-1].tolist(), times[1:].tolist())):
        noise = _step_noise(i, x, generator, step_noise)
        tb = torch.full((x.shape[0],), time, dtype=torch.long, device=x.device)
        pred_noise, x_start = model_predictions(sched, model_fn, x, condition, tb, objective,
                                                clip_x_start)
        if time_next < 0:
            x = x_start
        else:
            at, at1 = sched.alphas_cumprod[time], sched.alphas_cumprod[time_next]
            sigma = eta * torch.sqrt((1 - at / at1) * (1 - at1) / (1 - at))
            c = torch.sqrt(torch.clamp(1 - at1 - sigma ** 2, min=0.0))
            x = x_start * torch.sqrt(at1) + c * pred_noise + sigma * noise
        states.append(x)
    return (x, torch.stack(states)) if return_all else x
