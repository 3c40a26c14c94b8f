"""VQ-Diffusion composite: a frozen VQVAE and a diffusion prior over its
codebook indices (PyTorch counterpart of the JAX
``models/vq_diffusion_composite.py``).

Two priors are ported:

- ``gaussiandiffusion3d``: a ShuffleNet U-Net denoises a
  [B, seq_len, gaussian_dim, 1] state, and the sample decodes to indices by
  cosine argmax against a sinusoidal table. ``unet_base_dim`` /
  ``unet_dim_mults`` / ``base_dim`` shrink the U-Net as in the JAX package.
- ``VQ_Official`` with ``unet_dim != 2``: the discrete mask-and-replace
  prior (``diffusion/discrete.py``) over K = codebook_size classes, the last
  (index K-1) the mask class. Its denoiser is the ShuffleNet U-Net on the
  [B, K, N, 1] log-onehot "image", always base 64 with mults (1, 2, 4, 8)
  (the JAX branch ignores ``unet_base_dim`` / ``unet_dim_mults`` too); its
  output's last row is dropped, giving logits [B, N, K-1].
  ``fused_posterior`` (on when the config does not say and the U-Net lies
  on the card, as the JAX package turns it on for its accelerator) routes
  each structured reverse step through the fused posterior-and-sample
  kernel.

``fused_sampler`` selects the BN-folded CUDA-kernel forward of the U-Net
(``models/shuffle_infer.py``, any truthy value) or the unfused module
(falsy) for sampling. ``sample`` runs the chain of the U-Net it is given
(the trainer's EMA copy), or of ``unet``.

Training (``loss``): the frozen VQVAE's indices, then the prior's loss
through the U-Net module in train mode (batch statistics, running
statistics moved): gaussian3d's noise MSE, or VQ_Official's
``DiscreteDiffusion.train_loss`` with its importance-sampling history. The
VQ_Official Unet1D branch (``unet_dim: 2``) and the ``gaussiandiffusion2d``
prior come with a later ROADMAP item (slice 7).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import Config
from ..diffusion.discrete import DiscreteDiffusion, LtState
from ..diffusion.gaussian3d import VQGaussianDiffusion3D
from .shuffle_infer import eval_forward
from .unet_shuffle import ShuffleUNet
from .vqvae import VQVAE

_LATER = {"gaussiandiffusion2d": "slice 7 (other families)"}


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
        if self.diffusion_type == "VQ_Official" and int(dcfg.get("unet_dim", 3)) == 2:
            raise NotImplementedError(
                "the VQ_Official Unet1D branch (unet_dim: 2) is not ported yet: see "
                "ROADMAP.md, slice 7 (other families)")
        if self.diffusion_type not in ("gaussiandiffusion3d", "VQ_Official"):
            raise ValueError(f"diffusion_type {self.diffusion_type!r} not supported")
        self.vqvae = VQVAE.from_config(cfg)
        self.seq_len = self.vqvae.latent_size ** 2
        self.codebook_size = int(cfg.architecture.vqvae.num_codebook_vectors)
        self.timesteps = int(dcfg.diffusion_steps)
        self.dtype = dtype
        self.fused_sampler = dcfg.get("fused_sampler", True)
        sampling_steps = int(dcfg.sampling_steps)
        if self.diffusion_type == "VQ_Official":
            self.unet = ShuffleUNet(self.timesteps, 256, 1, 1, 64, (1, 2, 4, 8))
            self.prior = DiscreteDiffusion(num_classes=self.codebook_size, seq_len=self.seq_len,
                                           timesteps=self.timesteps,
                                           sampling_timesteps=sampling_steps)
            self.fused_posterior = dcfg.get("fused_posterior")
            return
        if int(dcfg.distribute_dim) != -1:
            raise ValueError("gaussiandiffusion3d needs distribute_dim -1")
        self.gaussian_dim = int(dcfg.gaussian_dim)
        ubase = int(dcfg.get("unet_base_dim", 64))
        umults = tuple(dcfg.get("unet_dim_mults", (1, 2, 4, 8)))
        self.unet = ShuffleUNet(self.timesteps, 256, 1, 1, int(dcfg.get("base_dim", ubase)),
                                umults)
        self.prior = VQGaussianDiffusion3D(
            seq_length=self.seq_len, timesteps=self.timesteps,
            sampling_timesteps=sampling_steps, vocab_size=self.codebook_size,
            gaussian_dim=self.gaussian_dim, sample_method=str(dcfg.get("sample_method", "ddpm")),
            loss_fn=str(dcfg.get("loss_fn", "noise_mse")),
            return_all_timestamps=bool(dcfg.get("return_all_timestamps", False)),
            clipped_reverse_diffusion=bool(dcfg.get("clipped_reverse_diffusion", True)),
            compute_indices_recon_loss=bool(dcfg.get("compute_indices_recon_loss", False)))

    def bind(self, unet: Optional[ShuffleUNet] = None):
        """The prior with this chain's denoiser bound (``unet``, default the
        composite's own): ``fn(x, self_cond, t)`` for gaussian3d; for
        VQ_Official ``fn(log_x_t [B, N, K], t)`` -> logits [B, N, K-1]
        through the U-Net on [B, K, N, 1], and ``fused_posterior`` resolved
        for the U-Net's device."""
        fwd = eval_forward(self.unet if unet is None else unet, self.fused_sampler, self.dtype)
        if self.diffusion_type != "VQ_Official":
            self.prior.diffusion.model_fn = lambda x, self_cond, t: fwd(x, t)
            return self.prior
        self.prior.model_fn = self._discrete_model_fn(fwd)
        mode = self.fused_posterior
        self.prior.fused_posterior = self._device().type == "cuda" if mode is None else mode
        return self.prior

    @staticmethod
    def _discrete_model_fn(fwd):
        """VQ_Official's denoiser around the U-Net forward ``fwd(x, t)``:
        log_x_t [B, N, K] as the [B, K, N, 1] image, the output's last row
        dropped -> logits [B, N, K-1]."""
        def model_fn(log_x_t, t):
            out = fwd(log_x_t.transpose(1, 2)[..., None], t)[..., 0]       # [B, K, N]
            return out[:, :-1, :].transpose(1, 2).contiguous()
        return model_fn

    def _device(self) -> torch.device:
        return next(self.unet.parameters()).device

    def init_lt_state(self) -> LtState:
        """VQ_Official's empty importance-sampling history, on the U-Net's
        device."""
        return LtState.init(self.timesteps, device=self._device())

    @torch.no_grad()
    def sample(self, batch_size: int = 1, generator: Optional[torch.Generator] = None,
               unet: Optional[ShuffleUNet] = None, **noise) -> torch.Tensor:
        """Indices [batch_size, seq_len] from the reverse chain of ``unet``
        (default the composite's own), or the filmstrip's [B, F, N] under
        gaussian3d's ``return_all_timestamps``. Noise comes from
        ``generator`` (on the U-Net's device) or is injected: ``x_T`` and
        ``step_noise`` for gaussian3d, ``init_uniform`` and ``step_gumbel``
        for VQ_Official."""
        prior = self.bind(unet)
        return prior.sample(batch_size, generator=generator, device=self._device(), **noise)

    @torch.no_grad()
    def encode_to_z(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] -> the frozen VQVAE's indices [B, h*w]."""
        return self.vqvae.encode(x)[1].reshape(x.shape[0], -1)

    def loss(self, x: torch.Tensor, generator: Optional[torch.Generator] = None, *,
             t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             lt=None):
        """The prior's training loss on images x [B, H, W, C] -> (loss,
        metrics, the new importance-sampling history), the U-Net in train
        mode: its BatchNorms run on batch statistics and move their running
        ones. ``t`` and ``noise`` (gaussian3d: the Gaussian noise;
        VQ_Official: the Gumbel noise of q(x_t | x_0)) come from
        ``generator`` unless given. VQ_Official's loss moves the history
        ``lt``; gaussian3d returns it as it came (None)."""
        indices = self.encode_to_z(x)
        unet = self.unet.train()
        if self.diffusion_type == "VQ_Official":
            self.prior.model_fn = self._discrete_model_fn(lambda x_t, tt: unet(x_t, None, tt))
            return self.prior.train_loss(indices, lt, generator, t=t, gumbel=noise)
        self.prior.diffusion.model_fn = lambda x_t, self_cond, tt: unet(x_t, None, tt)
        loss, metrics = self.prior.loss(indices, generator, t=t, noise=noise)
        return loss, metrics, lt

    @torch.no_grad()
    def log_images(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The first 4 images of x and the frozen VQVAE's reconstructions."""
        x = x[:4]
        return {"input": x, "rec": self.z_to_image(self.encode_to_z(x))}

    @torch.no_grad()
    def z_to_image(self, indices: torch.Tensor) -> torch.Tensor:
        """indices [B, h*w] -> images [B, H, W, C]."""
        return self.vqvae.decode_indices(indices)
