"""VQ-Diffusion composite: a frozen VQVAE and a diffusion prior over its
codebook indices (PyTorch counterpart of the JAX
``models/vq_diffusion_composite.py``, sampling side).

The ``gaussiandiffusion3d`` prior is ported: a ShuffleNet U-Net denoises a
[B, seq_len, gaussian_dim, 1] state, and the sample decodes to indices by
cosine argmax against a sinusoidal table. ``fused_sampler`` selects the
BN-folded CUDA-kernel forward (``models/shuffle_infer.py``, any truthy
value) or the unfused module (falsy). ``unet_base_dim`` /
``unet_dim_mults`` / ``base_dim`` shrink the U-Net as in the JAX package.
The discrete (``VQ_Official``) and ``gaussiandiffusion2d`` priors, and the
training loss, come with later slices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..config import Config
from ..diffusion.gaussian3d import VQGaussianDiffusion3D
from .shuffle_infer import apply_folded, fold_unet, resolve_sampler_mode
from .unet_shuffle import ShuffleUNet
from .vqvae import VQVAE

_LATER = {"VQ_Official": "slice 5 (discrete VQ-diffusion priors)",
          "gaussiandiffusion2d": "slice 7 (other families)"}


class VQDiffusionComposite(nn.Module):
    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        model_name = cfg.architecture.model_name
        dcfg = cfg.architecture[model_name if model_name in cfg.architecture
                                else "vqdiffusion"]
        self.diffusion_type = str(dcfg.diffusion_type)
        if self.diffusion_type in _LATER:
            raise NotImplementedError(
                f"diffusion_type {self.diffusion_type!r} is not ported yet: see ROADMAP.md, "
                f"{_LATER[self.diffusion_type]}")
        if self.diffusion_type != "gaussiandiffusion3d":
            raise ValueError(f"diffusion_type {self.diffusion_type!r} not supported")
        if int(dcfg.distribute_dim) != -1:
            raise ValueError("gaussiandiffusion3d needs distribute_dim -1")
        self.vqvae = VQVAE.from_config(cfg)
        self.seq_len = self.vqvae.latent_size ** 2
        self.codebook_size = int(cfg.architecture.vqvae.num_codebook_vectors)
        self.timesteps = int(dcfg.diffusion_steps)
        self.gaussian_dim = int(dcfg.gaussian_dim)
        self.dtype = dtype
        self.fused_sampler = dcfg.get("fused_sampler", True)
        ubase = int(dcfg.get("unet_base_dim", 64))
        umults = tuple(dcfg.get("unet_dim_mults", (1, 2, 4, 8)))
        self.unet = ShuffleUNet(self.timesteps, 256, 1, 1, int(dcfg.get("base_dim", ubase)),
                                umults)
        self.prior = VQGaussianDiffusion3D(
            seq_length=self.seq_len, timesteps=self.timesteps,
            sampling_timesteps=int(dcfg.sampling_steps), vocab_size=self.codebook_size,
            gaussian_dim=self.gaussian_dim, sample_method=str(dcfg.get("sample_method", "ddpm")),
            return_all_timestamps=bool(dcfg.get("return_all_timestamps", False)),
            clipped_reverse_diffusion=bool(dcfg.get("clipped_reverse_diffusion", True)))

    def model_fn(self):
        """The denoiser ``fn(x, self_cond, t)`` for one chain. The kernel route
        folds the BatchNorms here, once."""
        if resolve_sampler_mode(self.fused_sampler):
            folded = fold_unet(self.unet, self.dtype)
            return lambda x, self_cond, t: apply_folded(folded, x, t).to(x.dtype)
        return lambda x, self_cond, t: self.unet(x, None, t)

    @torch.no_grad()
    def sample(self, batch_size: int = 1, generator: Optional[torch.Generator] = None,
               x_T: Optional[torch.Tensor] = None,
               step_noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Indices [batch_size, seq_len] from the reverse chain. Noise comes from
        ``generator`` (on the U-Net's device) or is injected as ``x_T`` and
        ``step_noise``."""
        self.prior.diffusion.model_fn = self.model_fn()
        device = self.prior.lookup_table.device
        return self.prior.sample(batch_size, generator=generator, device=device, x_T=x_T,
                                 step_noise=step_noise)

    @torch.no_grad()
    def z_to_image(self, indices: torch.Tensor) -> torch.Tensor:
        """indices [B, h*w] -> images [B, H, W, C]."""
        return self.vqvae.decode_indices(indices)
