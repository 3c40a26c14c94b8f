"""Gaussian diffusion over a [seq_len x gaussian_dim] "image" of per-token
embeddings, and its VQ wrapper (PyTorch counterpart of the JAX
``diffusion/gaussian3d.py``).

Kept exactly as in the JAX package:

- ``GaussianDiffusion3D`` always uses the cosine schedule; a config's
  ``noise_schedule`` is never read;
- the reverse step's ``t == 0`` cases (no noise; the clipped mean's
  ``beta / (1 - ac)`` form);
- the samplers return ``(x + 1) / 2`` and ``VQGaussianDiffusion3D.sample``
  maps it back with ``* 2 - 1`` before the cosine argmax;
- DDIM's time grid ``linspace(-1, T - 1, S)``, truncated to ints.

- the losses: ``noise_mse`` and the reference's ELBO (its posterior mean in
  the DDPM-update form, with x0 where the predicted noise goes), and the VQ
  wrapper's loss, which is the noise MSE whatever ``loss_fn`` says, plus
  ``BELTA`` (0.01) times the MSE of the argmax indices of the predicted
  x0, a term of the value and not of the gradient;
- the filmstrip (``return_all_timestamps``): the state after every
  ``steps // 24``-th reverse step, counted back from the last, decoded to
  indices [B, F, N].

Noise comes from an explicit ``torch.Generator`` on the state's device, or
is injected: ``x_T`` and one tensor per reverse step for the samplers, ``t``
and ``noise`` for the losses (the parity tests hand in the JAX package's
draws).

Layout: the diffusion state is [B, seq_len, gaussian_dim, 1] (NHWC).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import draw_rows
from ..utils import tracing
from .gaussian import _extract, _randn, make_schedule

ModelFn = Callable[[torch.Tensor, Optional[torch.Tensor], torch.Tensor], torch.Tensor]


def positional_encoding_table(dim: int, num_vectors: int) -> np.ndarray:
    """Sinusoidal lookup table [num_vectors, dim], float32."""
    position = np.arange(num_vectors)[:, None]
    div_term = np.exp(np.arange(0, dim, 2) * -(math.log(10000.0) / dim))
    pe = np.zeros((num_vectors, dim), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)[:, : pe[:, 1::2].shape[1]]
    return pe


def _draw_t_noise(x0: torch.Tensor, timesteps: int, generator: Optional[torch.Generator],
                  t: Optional[torch.Tensor], noise: Optional[torch.Tensor]):
    """A loss's draws: t [B] uniform over the steps and noise ~ N(0, I) of
    x0's shape, each from ``generator`` unless given (under data
    parallelism, this rank's rows of the global batch's draws:
    :func:`..parallel.draw_rows`)."""
    b, rest = x0.shape[0], tuple(x0.shape[1:])
    if t is None:
        t = draw_rows(lambda n: torch.randint(0, timesteps, (n,), generator=generator,
                                              device=x0.device), b)
    if noise is None:
        noise = draw_rows(lambda n: _randn((n, *rest), generator, x0.device), b)
    return t.to(x0.device), noise.to(x0.device)


def film_frames(n_steps: int, every: int) -> list:
    """The reverse steps (0-based, in order) of a chain of ``n_steps`` whose
    states make the filmstrip: every ``every``-th, counted back from the last."""
    return list(range(n_steps - 1, -1, -every))[::-1]


class GaussianDiffusion3D:
    """Embedding-space DDPM/DDIM around ``model_fn(x, self_cond, t)``."""

    NUM_TIMESTAMPS = 24  # filmstrip frames

    def __init__(self, image_sizes: Tuple[int, int], in_channels: int,
                 timesteps: int = 1000, sampling_timesteps: int = 500,
                 model_fn: Optional[ModelFn] = None, loss_fn: str = "noise_mse",
                 sample_method: str = "ddim", ddim_sampling_eta: float = 0.0):
        if sample_method not in ("ddim", "ddpm"):
            raise ValueError(f"sample_method must be 'ddim' or 'ddpm', got {sample_method!r}")
        if loss_fn not in ("noise_mse", "elbo"):
            raise ValueError(f"loss_fn must be 'noise_mse' or 'elbo', got {loss_fn!r}")
        self.image_sizes = tuple(image_sizes)
        self.in_channels = in_channels
        self.timesteps = timesteps
        self.sampling_timesteps = sampling_timesteps
        self.model_fn = model_fn
        self.loss_fn = loss_fn
        self.sample_method = sample_method
        self.ddim_sampling_eta = ddim_sampling_eta
        self.sched = make_schedule(timesteps, "cosine")

    def _film_every(self, steps: int) -> int:
        return max(steps // self.NUM_TIMESTAMPS, 1)

    def forward_diffusion(self, x0: torch.Tensor, t: torch.Tensor,
                          noise: torch.Tensor) -> torch.Tensor:
        s = self.sched
        return (_extract(s.sqrt_alphas_cumprod, t, x0.dim()) * x0 +
                _extract(s.sqrt_one_minus_alphas_cumprod, t, x0.dim()) * noise)

    def predict_start_from_noise(self, x_t: torch.Tensor, t: torch.Tensor,
                                 pred_noise: torch.Tensor) -> torch.Tensor:
        s = self.sched
        return (_extract(s.sqrt_recip_alphas_cumprod, t, x_t.dim()) * x_t -
                _extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.dim()) * pred_noise)

    def _q_posterior_ref(self, x0: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor):
        """The reference's q_posterior, kept for the ELBO: its mean is the
        DDPM update with x0 in place of the predicted noise, its "variance"
        the step's standard deviation, floored at 1e-20."""
        s, n = self.sched, x_t.dim()
        alpha_t = _extract(s.alphas, t, n)
        som = _extract(s.sqrt_one_minus_alphas_cumprod, t, n)
        mean = (1.0 / torch.sqrt(alpha_t)) * (x_t - ((1 - alpha_t) / som) * x0)
        beta_t, ac = _extract(s.betas, t, n), _extract(s.alphas_cumprod, t, n)
        ac_prev = _extract(s.alphas_cumprod_prev, t, n)
        var = torch.sqrt(beta_t * (1 - ac_prev) / (1 - ac))
        logvar = _extract(s.posterior_log_variance_clipped, t, n)
        return mean, torch.clamp(var, min=1e-20), logvar

    def loss(self, x0: torch.Tensor, generator: Optional[torch.Generator] = None, *,
             t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``loss_fn`` of x0 [B, H, W, C]: the noise MSE, or the ELBO (the
        batch's mean over samples of the KL and the NLL, each summed over a
        sample). ``t`` and ``noise`` come from ``generator`` unless given."""
        t, noise = _draw_t_noise(x0, self.timesteps, generator, t, noise)
        x_t = self.forward_diffusion(x0, t, noise)
        pred = self.model_fn(x_t, None, t)
        if self.loss_fn == "noise_mse":
            return torch.mean((pred - noise) ** 2)
        post_mean, post_var, post_logvar = self._q_posterior_ref(x0, x_t, t)
        pred_x0 = self.predict_start_from_noise(x_t, t, pred)
        model_mean, model_var, _ = self._q_posterior_ref(pred_x0, x_t, t)
        kl = 0.5 * (torch.log(model_var) - torch.log(post_var) +
                    (post_var + (post_mean - model_mean) ** 2) / model_var - 1)
        nll = 0.5 * torch.exp(-post_logvar) * (x_t - post_mean) ** 2 + 0.5 * post_logvar
        return kl.flatten(1).sum(1).mean() + nll.flatten(1).sum(1).mean()

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
        """T reverse steps from x_T ~ N(0, I); returns (x_0 + 1) / 2, and
        with ``return_all_timestamps`` also the filmstrip's states
        [F, B, H, W, C] mapped the same way (:func:`film_frames`).
        ``step_noise[i]`` is the noise of the i-th step (t = T-1-i)."""
        h, w = self.image_sizes
        with tracing.span("gaussian3d.chain"):
            x = x_T if x_T is not None else _randn((n_samples, h, w, self.in_channels),
                                                   generator, device)
            keep = set(film_frames(self.timesteps, self._film_every(self.timesteps))) \
                if return_all_timestamps else set()
            frames = []
            for i, t in enumerate(range(self.timesteps - 1, -1, -1)):
                with tracing.span("gaussian3d.step"):
                    noise = (step_noise[i] if step_noise is not None
                             else _randn(x.shape, generator, x.device))
                    x = self._reverse_step(x, t, noise, clipped_reverse_diffusion)
                    if i in keep:
                        frames.append(x)
            return _with_frames(x, frames, return_all_timestamps)

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
        """S-1 DDIM steps over :meth:`ddim_times`; returns (x_0 + 1) / 2, and
        the filmstrip as :meth:`ddpm_sample` does, its frames counted over
        the S-1 steps by ``sampling_timesteps // 24``."""
        h, w = self.image_sizes
        times = self.ddim_times()
        eta = self.ddim_sampling_eta
        ac_all = self.sched.alphas_cumprod
        keep = set(film_frames(len(times) - 1, self._film_every(self.sampling_timesteps))) \
            if return_all_timestamps else set()
        with tracing.span("gaussian3d.chain"):
            x = x_T if x_T is not None else _randn((n_samples, h, w, self.in_channels),
                                                   generator, device)
            frames = []
            for i, (time, time_next) in enumerate(zip(times[:-1], times[1:])):
                with tracing.span("gaussian3d.step"):
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
                    if i in keep:
                        frames.append(x)
            return _with_frames(x, frames, return_all_timestamps)

    def sampling(self, n_samples: int, **kwargs):
        fn = self.ddim_sample if self.sample_method == "ddim" else self.ddpm_sample
        return fn(n_samples, **kwargs)


def _with_frames(x: torch.Tensor, frames: list, return_all_timestamps: bool):
    if return_all_timestamps:
        return (x + 1.0) / 2.0, (torch.stack(frames) + 1.0) / 2.0
    return (x + 1.0) / 2.0


class VQGaussianDiffusion3D(nn.Module):
    """The gaussian3d prior over codebook indices: tokens are embedded by a
    sinusoidal lookup table, and a sampled state decodes to the index of
    the table row nearest in cosine distance."""

    BELTA = 0.01  # the indices-recon term's weight, the reference's spelling

    def __init__(self, seq_length: int = 256, timesteps: int = 1000,
                 sampling_timesteps: int = 500, vocab_size: int = 1024,
                 gaussian_dim: int = 512, model_fn: Optional[ModelFn] = None,
                 sample_method: str = "ddim", loss_fn: str = "noise_mse",
                 return_all_timestamps: bool = False,
                 clipped_reverse_diffusion: bool = False,
                 compute_indices_recon_loss: bool = False):
        super().__init__()
        self.seq_length = seq_length
        self.vocab_size = vocab_size
        self.gaussian_dim = gaussian_dim
        self.return_all_timestamps = return_all_timestamps
        self.clipped_reverse_diffusion = clipped_reverse_diffusion
        self.compute_indices_recon_loss = compute_indices_recon_loss
        self.diffusion = GaussianDiffusion3D((seq_length, gaussian_dim), 1, timesteps,
                                             sampling_timesteps, model_fn, loss_fn,
                                             sample_method)
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
        with tracing.span("gaussian3d.readout"):
            flat = gaussian.reshape(-1, d).to(self.lookup_normed.dtype)
            flat = flat / torch.clamp(torch.linalg.vector_norm(flat, dim=-1, keepdim=True),
                                      min=1e-12)
            sim = flat @ self.lookup_normed.T
            return torch.argmax(sim, dim=-1).reshape(b, n)

    def loss(self, indices_x0: torch.Tensor, generator: Optional[torch.Generator] = None, *,
             t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        """The training loss of indices [B, seq_len] -> (loss, metrics): the
        noise MSE (whatever ``loss_fn`` says, as in the JAX package) and,
        with ``compute_indices_recon_loss``, ``BELTA`` times the MSE between
        the argmax indices of the predicted x0 and the true ones, which adds
        to the value and not to the gradient. ``t`` and ``noise`` come from
        ``generator`` unless given."""
        x0 = self.indices_to_gaussian(indices_x0)[..., None]        # [B, N, D, 1]
        t, noise = _draw_t_noise(x0, self.diffusion.timesteps, generator, t, noise)
        x_t = self.diffusion.forward_diffusion(x0, t, noise)
        pred = self.diffusion.model_fn(x_t, None, t)
        loss = torch.mean((pred - noise) ** 2)
        metrics = {"noise_mse": loss}
        if self.compute_indices_recon_loss:
            with torch.no_grad():
                pred_idx = self.gaussian_to_indices(
                    self.diffusion.predict_start_from_noise(x_t, t, pred))
                recon = torch.mean((pred_idx.float() - indices_x0.float()) ** 2)
            loss = loss + self.BELTA * recon
            metrics["indices_recon"] = recon
        metrics["loss"] = loss
        return loss, metrics

    @torch.no_grad()
    def sample(self, batch_size: int = 16, **noise) -> torch.Tensor:
        """Run the reverse chain and decode it to indices [B, seq_len], or
        with ``return_all_timestamps`` each filmstrip frame's [B, F, N].
        ``noise``: ``generator`` / ``device``, or injected ``x_T`` and
        ``step_noise``, as :meth:`GaussianDiffusion3D.ddpm_sample` takes."""
        out = self.diffusion.sampling(
            batch_size, return_all_timestamps=self.return_all_timestamps,
            clipped_reverse_diffusion=self.clipped_reverse_diffusion, **noise)
        if self.return_all_timestamps:
            frames = out[1]                                           # [F, B, N, D, 1]
            idx = self.gaussian_to_indices(frames.flatten(0, 1) * 2.0 - 1.0)
            return idx.reshape(frames.shape[0], frames.shape[1], -1).transpose(0, 1)
        return self.gaussian_to_indices(out * 2.0 - 1.0)
