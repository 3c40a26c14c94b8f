"""Continuous VQ-diffusion priors (PyTorch counterpart of the JAX
``models/continuous_vq.py``; the reference ``network/continous_vq_diffusion/``).

Both diffuse a continuous stand-in for the frozen VQVAE's indices with the
linear-schedule Gaussian process of ``diffusion/gaussian.py`` and the
Conv1d U-Net (``models/unet1d.py``, ``condition=True``: a zeros condition
is concatenated ahead of the state), and sample by DDIM over
``min(sampling_steps, 500)`` steps with eta 0:

- ``V_VQDiffusion``: the codebook rows of the indices, [B, D, N] (D the
  embedding width as channels over the N positions); a sample decodes to
  the nearest codebook row of each position (an explicit L2 argmin in
  float32);
- ``C_VQDiffusion``: the scalar baseline, indices / K tiled to
  ``indices_width`` rows [B, W, N]; a sample decodes as the mean over the
  rows times K, clipped to [0, K - 1] and truncated to an integer.

The diffusion keys come from ``architecture.<model>`` or else
``architecture.vqdiffusion``; ``architecture.vqvae.num_latent_vec`` /
``latent_vec_dim`` default to latent_size^2 / latent_channels. Noise comes
from an explicit ``torch.Generator`` or is injected (``t`` and ``noise``
for the loss, ``x_T`` and ``step_noise`` for the sampler).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..config import Config
from ..diffusion.gaussian import _randn, ddim_sample, diffusion_loss, make_schedule
from ..diffusion.gaussian3d import _draw_t_noise
from ..utils.device import compute_autocast
from .unet1d import Unet1D
from .vqvae import VQVAE


class _ContinuousVQBase(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.vqvae = VQVAE.from_config(cfg)
        vq = cfg.architecture.vqvae
        self.seq_length = int(vq.get("num_latent_vec", self.vqvae.latent_size ** 2))
        self.embedding_dim = int(vq.get("latent_vec_dim", vq.latent_channels))
        self.codebook_size = int(vq.num_codebook_vectors)
        dcfg = self.diffusion_config(cfg)
        self.timesteps = int(dcfg.get("diffusion_steps", 1000))
        self.sampling_timesteps = int(dcfg.get("sampling_steps", 500))
        self.objective = str(dcfg.get("objective", "pred_noise"))
        self.sched = make_schedule(self.timesteps, "linear")
        self.channels = channels = self._channels(dcfg)
        self.unet = Unet1D(int(dcfg.get("unet_base_dim", 64)),
                           dim_mults=tuple(dcfg.get("unet_dim_mults", (1, 2, 4, 8))),
                           channels=channels, condition=True)

    @staticmethod
    def diffusion_config(cfg: Config) -> Config:
        arch = cfg.architecture
        return arch.get(arch.model_name, arch.get("vqdiffusion"))

    @torch.no_grad()
    def encode_to_z(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] -> the frozen VQVAE's indices [B, h*w]."""
        return self.vqvae.encode(x)[1].reshape(x.shape[0], -1)

    @torch.no_grad()
    def z_to_image(self, indices: torch.Tensor) -> torch.Tensor:
        return self.vqvae.decode_indices(indices)

    def _channels(self, dcfg: Config) -> int:
        """The U-Net's channels: the width of the diffused state."""
        raise NotImplementedError

    def _device(self) -> torch.device:
        return next(self.unet.parameters()).device

    def to_state(self, indices: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def to_indices(self, state: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def loss(self, x: torch.Tensor, generator: Optional[torch.Generator] = None, *,
             t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The MSE loss of the objective on images x [B, H, W, C], the U-Net
        in train mode; ``t`` and ``noise`` come from ``generator`` unless
        given."""
        x0 = self.to_state(self.encode_to_z(x))
        t, noise = _draw_t_noise(x0, self.timesteps, generator, t, noise)
        unet = self.unet.train()
        return diffusion_loss(self.sched, lambda x_t, cond, tt: unet(x_t, cond, tt), x0, None,
                              t, noise, self.objective)[0]

    @torch.no_grad()
    def sample(self, batch_size: int = 1, generator: Optional[torch.Generator] = None,
               unet: Optional[Unet1D] = None, *, x_T: Optional[torch.Tensor] = None,
               step_noise: Optional[Sequence[torch.Tensor]] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Indices [batch_size, seq_length] from the DDIM chain of ``unet``
        (default the composite's own, in eval mode, at compute type
        ``dtype``) from x_T ~ N(0, I)."""
        unet = (self.unet if unet is None else unet).eval()
        if x_T is None:
            x_T = _randn((batch_size, self.channels, self.seq_length), generator, self._device())

        def fwd(x, cond, t):
            with compute_autocast(x.device, dtype):
                return unet(x, cond, t)
        state = ddim_sample(self.sched, fwd, x_T, None, 0.0,
                            min(self.sampling_timesteps, 500), self.objective,
                            generator=generator, step_noise=step_noise)
        return self.to_indices(state)


class V_VQDiffusion(_ContinuousVQBase):
    """Diffusion over the codebook rows [B, D, N] of the indices."""

    def _channels(self, dcfg: Config) -> int:
        return self.embedding_dim

    def _codebook(self) -> torch.Tensor:
        return self.vqvae.codebook.codebook.weight

    def to_state(self, indices: torch.Tensor) -> torch.Tensor:
        return self._codebook()[indices].transpose(1, 2)

    def to_indices(self, state: torch.Tensor) -> torch.Tensor:
        emb, codebook = state.transpose(1, 2).float(), self._codebook().float()
        with torch.autocast(emb.device.type, enabled=False):
            d = (torch.sum(emb ** 2, -1, keepdim=True) + torch.sum(codebook ** 2, -1)
                 - 2 * torch.einsum("bnd,kd->bnk", emb, codebook))
        return torch.argmin(d, dim=-1)


class C_VQDiffusion(_ContinuousVQBase):
    """Diffusion over the indices / K, tiled to ``indices_width`` rows."""

    def _channels(self, dcfg: Config) -> int:
        self.indices_width = int(dcfg.get("indices_width", 8))
        return self.indices_width

    def to_state(self, indices: torch.Tensor) -> torch.Tensor:
        rows = indices[:, None, :].float().expand(-1, self.indices_width, -1)
        return rows / self.codebook_size

    def to_indices(self, state: torch.Tensor) -> torch.Tensor:
        vals = torch.mean(state, dim=1) * self.codebook_size
        return torch.clamp(vals, 0, self.codebook_size - 1).to(torch.int32).long()
