"""Gaussian diffusion over a [seq_len x gaussian_dim] "image" of per-token
embeddings, and its VQ wrapper (PyTorch counterpart of the JAX
``diffusion/gaussian3d.py``, sampling side).

Kept exactly as in the JAX package:

- ``GaussianDiffusion3D`` always uses the cosine schedule; a config's
  ``noise_schedule`` is never read;
- the reverse step's ``t == 0`` cases (no noise; the clipped mean's
  ``beta / (1 - ac)`` form);
- the samplers return ``(x + 1) / 2`` and ``VQGaussianDiffusion3D.sample``
  maps it back with ``* 2 - 1`` before the cosine argmax;
- DDIM's time grid ``linspace(-1, T - 1, S)``, truncated to ints.

Noise comes from an explicit ``torch.Generator`` on the state's device, or
is injected: ``x_T`` and one tensor per reverse step (the parity tests hand
in the JAX package's noise). The filmstrip (``return_all_timestamps``) and
the training loss come with the training half of the slice.

Layout: the diffusion state is [B, seq_len, gaussian_dim, 1] (NHWC).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .gaussian import _extract, make_schedule

ModelFn = Callable[[torch.Tensor, Optional[torch.Tensor], torch.Tensor], torch.Tensor]


def positional_encoding_table(dim: int, num_vectors: int) -> np.ndarray:
    """Sinusoidal lookup table [num_vectors, dim], float32."""
    position = np.arange(num_vectors)[:, None]
    div_term = np.exp(np.arange(0, dim, 2) * -(math.log(10000.0) / dim))
    pe = np.zeros((num_vectors, dim), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)[:, : pe[:, 1::2].shape[1]]
    return pe


def _filmstrip_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "return_all_timestamps (the sampling filmstrip) is not ported yet: see "
        "ROADMAP.md, slice 4 (gaussian3d prior, training half)")


def _randn(shape, generator: Optional[torch.Generator],
           device: Optional[torch.device]) -> torch.Tensor:
    if generator is not None:
        device = generator.device
    return torch.randn(shape, generator=generator, device=device)


class GaussianDiffusion3D:
    """Embedding-space DDPM/DDIM sampler around ``model_fn(x, self_cond, t)``."""

    def __init__(self, image_sizes: Tuple[int, int], in_channels: int,
                 timesteps: int = 1000, sampling_timesteps: int = 500,
                 model_fn: Optional[ModelFn] = None, sample_method: str = "ddim",
                 ddim_sampling_eta: float = 0.0):
        if sample_method not in ("ddim", "ddpm"):
            raise ValueError(f"sample_method must be 'ddim' or 'ddpm', got {sample_method!r}")
        self.image_sizes = tuple(image_sizes)
        self.in_channels = in_channels
        self.timesteps = timesteps
        self.sampling_timesteps = sampling_timesteps
        self.model_fn = model_fn
        self.sample_method = sample_method
        self.ddim_sampling_eta = ddim_sampling_eta
        self.sched = make_schedule(timesteps, "cosine")

    def predict_start_from_noise(self, x_t: torch.Tensor, t: torch.Tensor,
                                 pred_noise: torch.Tensor) -> torch.Tensor:
        s = self.sched
        return (_extract(s.sqrt_recip_alphas_cumprod, t, x_t.dim()) * x_t -
                _extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.dim()) * pred_noise)

    def _reverse_step(self, x_t: torch.Tensor, t: int, noise: torch.Tensor,
                      clipped: bool) -> torch.Tensor:
        """One reverse step at the Python int ``t``. The schedule scalars are
        float32 CPU tensors, so they are computed in float32 as in JAX."""
        s = self.sched
        tb = torch.full((x_t.shape[0],), t, dtype=torch.long, device=x_t.device)
        pred = self.model_fn(x_t, None, tb)
        alpha_t, ac, beta_t = s.alphas[t], s.alphas_cumprod[t], s.betas[t]
        ac_prev = s.alphas_cumprod_prev[t]
        std = torch.sqrt(beta_t * (1 - ac_prev) / (1 - ac)) if t > 0 else 0.0
        if not clipped:
            som = s.sqrt_one_minus_alphas_cumprod[t]
            mean = (1.0 / torch.sqrt(alpha_t)) * (x_t - ((1 - alpha_t) / som) * pred)
        else:
            x0 = torch.sqrt(1.0 / ac) * x_t - torch.sqrt(1.0 / ac - 1.0) * pred
            x0 = torch.clip(x0, -1.0, 1.0)
            if t > 0:
                mean = ((beta_t * torch.sqrt(ac_prev) / (1 - ac)) * x0 +
                        ((1 - ac_prev) * torch.sqrt(alpha_t) / (1 - ac)) * x_t)
            else:
                mean = (beta_t / (1 - ac)) * x0
        return mean + std * noise

    def ddpm_sample(self, n_samples: int, *, generator: Optional[torch.Generator] = None,
                    device: Optional[torch.device] = None,
                    x_T: Optional[torch.Tensor] = None,
                    step_noise: Optional[Sequence[torch.Tensor]] = None,
                    return_all_timestamps: bool = False,
                    clipped_reverse_diffusion: bool = True) -> torch.Tensor:
        """T reverse steps from x_T ~ N(0, I); returns (x_0 + 1) / 2.
        ``step_noise[i]`` is the noise of the i-th step (t = T-1-i)."""
        if return_all_timestamps:
            raise _filmstrip_not_ported()
        h, w = self.image_sizes
        x = x_T if x_T is not None else _randn((n_samples, h, w, self.in_channels),
                                               generator, device)
        for i, t in enumerate(range(self.timesteps - 1, -1, -1)):
            noise = (step_noise[i] if step_noise is not None
                     else _randn(x.shape, generator, x.device))
            x = self._reverse_step(x, t, noise, clipped_reverse_diffusion)
        return (x + 1.0) / 2.0

    def ddim_times(self) -> np.ndarray:
        """The DDIM time grid, descending: linspace(-1, T-1, S) as ints."""
        times = np.linspace(-1, self.timesteps - 1, self.sampling_timesteps)
        return np.asarray(list(reversed(times.astype(int).tolist())), np.int64)

    def ddim_sample(self, n_samples: int, *, generator: Optional[torch.Generator] = None,
                    device: Optional[torch.device] = None,
                    x_T: Optional[torch.Tensor] = None,
                    step_noise: Optional[Sequence[torch.Tensor]] = None,
                    return_all_timestamps: bool = False,
                    clipped_reverse_diffusion: bool = True) -> torch.Tensor:
        """S-1 DDIM steps over :meth:`ddim_times`; returns (x_0 + 1) / 2."""
        if return_all_timestamps:
            raise _filmstrip_not_ported()
        h, w = self.image_sizes
        x = x_T if x_T is not None else _randn((n_samples, h, w, self.in_channels),
                                               generator, device)
        times = self.ddim_times()
        eta = self.ddim_sampling_eta
        ac_all = self.sched.alphas_cumprod
        for i, (time, time_next) in enumerate(zip(times[:-1], times[1:])):
            time, time_next = int(time), int(time_next)
            tb = torch.full((n_samples,), time, dtype=torch.long, device=x.device)
            pred_noise = self.model_fn(x, None, tb)
            x_start = self.predict_start_from_noise(x, tb, pred_noise)
            if clipped_reverse_diffusion:
                x_start = torch.clip(x_start, -1.0, 1.0)
            at, at1 = ac_all[time], ac_all[max(time_next, 0)]
            sigma = eta * torch.sqrt((1 - at / at1) * (1 - at1) / (1 - at))
            c = torch.sqrt(torch.clamp(1 - at1 - sigma ** 2, min=0.0))
            noise = (step_noise[i] if step_noise is not None
                     else _randn(x.shape, generator, x.device))
            if time_next < 0:
                x = x_start
            else:
                x = x_start * torch.sqrt(at1) + c * pred_noise + sigma * noise
        return (x + 1.0) / 2.0

    def sampling(self, n_samples: int, **kwargs) -> torch.Tensor:
        fn = self.ddim_sample if self.sample_method == "ddim" else self.ddpm_sample
        return fn(n_samples, **kwargs)


class VQGaussianDiffusion3D(nn.Module):
    """The gaussian3d prior over codebook indices: tokens are embedded by a
    sinusoidal lookup table, and a sampled state decodes to the index of
    the table row nearest in cosine distance."""

    def __init__(self, seq_length: int = 256, timesteps: int = 1000,
                 sampling_timesteps: int = 500, vocab_size: int = 1024,
                 gaussian_dim: int = 512, model_fn: Optional[ModelFn] = None,
                 sample_method: str = "ddim", return_all_timestamps: bool = False,
                 clipped_reverse_diffusion: bool = False):
        super().__init__()
        self.seq_length = seq_length
        self.vocab_size = vocab_size
        self.gaussian_dim = gaussian_dim
        self.return_all_timestamps = return_all_timestamps
        self.clipped_reverse_diffusion = clipped_reverse_diffusion
        self.diffusion = GaussianDiffusion3D((seq_length, gaussian_dim), 1, timesteps,
                                             sampling_timesteps, model_fn, sample_method)
        table = torch.from_numpy(positional_encoding_table(gaussian_dim, vocab_size))
        norm = torch.linalg.vector_norm(table, dim=-1, keepdim=True)
        self.register_buffer("lookup_table", table, persistent=False)
        self.register_buffer("lookup_normed", table / torch.clamp(norm, min=1e-12),
                             persistent=False)

    def indices_to_gaussian(self, indices: torch.Tensor) -> torch.Tensor:
        return self.lookup_table[indices]

    def gaussian_to_indices(self, gaussian: torch.Tensor) -> torch.Tensor:
        """Cosine-distance argmin decode on normalized copies -> [B, N]."""
        if gaussian.dim() == 4:
            gaussian = gaussian[..., 0] if gaussian.shape[-1] == 1 else gaussian.squeeze(1)
        b, n, d = gaussian.shape
        flat = gaussian.reshape(-1, d).float()
        flat = flat / torch.clamp(torch.linalg.vector_norm(flat, dim=-1, keepdim=True),
                                  min=1e-12)
        sim = flat @ self.lookup_normed.T
        return torch.argmax(sim, dim=-1).reshape(b, n)

    @torch.no_grad()
    def sample(self, batch_size: int = 16, **noise) -> torch.Tensor:
        """Run the reverse chain and decode it to indices [B, seq_len].
        ``noise``: ``generator`` / ``device``, or injected ``x_T`` and
        ``step_noise``, as :meth:`GaussianDiffusion3D.ddpm_sample` takes."""
        if self.return_all_timestamps:
            raise _filmstrip_not_ported()
        out = self.diffusion.sampling(
            batch_size, clipped_reverse_diffusion=self.clipped_reverse_diffusion, **noise)
        return self.gaussian_to_indices(out * 2.0 - 1.0)
