"""VQ-Diffusion composite: a frozen VQVAE and a diffusion prior over its
codebook indices (PyTorch counterpart of the JAX
``models/vq_diffusion_composite.py``).

Three priors are ported:

- ``gaussiandiffusion3d``: a ShuffleNet U-Net denoises a
  [B, seq_len, gaussian_dim, 1] state, and the sample decodes to indices by
  cosine argmax against a sinusoidal table. ``unet_base_dim`` /
  ``unet_dim_mults`` / ``base_dim`` shrink the U-Net as in the JAX package.
- ``gaussiandiffusion2d``: the Conv1d U-Net (``models/unet1d.py``)
  denoises the per-index embeddings (``diffusion/gaussian2d.py``): with the
  lookup table and ``distribute_dim`` -1 the state [B, N, D] enters it as
  N channels over length D (one-hot: K long; ``distribute_dim`` 1 swaps
  them); DDIM samples decode by the nearest table row.
- ``VQ_Official``: the discrete mask-and-replace prior
  (``diffusion/discrete.py``) over K = codebook_size classes, the last
  (index K-1) the mask class. With ``unet_dim`` 2 its denoiser is the
  Conv1d U-Net on log_x_t as K channels over the N positions, K-1 out
  (``unet_base_dim`` / ``unet_dim_mults`` as the config says); otherwise
  the ShuffleNet U-Net on the [B, K, N, 1] log-onehot "image", always base
  64 with mults (1, 2, 4, 8) (the JAX branch ignores ``unet_base_dim`` /
  ``unet_dim_mults`` too), its output's last row dropped. Either gives
  logits [B, N, K-1]. ``fused_posterior`` (on when the config does not say
  and the U-Net lies on the card, as the JAX package turns it on for its
  accelerator) routes each structured reverse step through the fused
  posterior-and-sample kernel.

``fused_sampler`` selects the BN-folded CUDA-kernel forward of the
ShuffleNet U-Net (``models/shuffle_infer.py``, any truthy value) or the
unfused module (falsy) for sampling; the Conv1d U-Net has no folded form
and runs as its module. ``sample`` runs the chain of the U-Net it is given
(the trainer's EMA copy), or of ``unet``.

Training (``loss``): the frozen VQVAE's indices, then the prior's loss
through the U-Net module in train mode (the ShuffleNet's BatchNorms on
batch statistics, their running ones moved): gaussian3d's noise MSE,
gaussian2d's, or VQ_Official's ``DiscreteDiffusion.train_loss`` with its
importance-sampling history.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import Config
from ..diffusion.discrete import DiscreteDiffusion, LtState
from ..diffusion.gaussian2d import GaussianDiffusion2D, GaussianDiffusion2DConfig
from ..diffusion.gaussian3d import VQGaussianDiffusion3D
from ..utils.device import compute_autocast
from .shuffle_infer import eval_forward
from .unet1d import Unet1D
from .unet_shuffle import ShuffleUNet
from .vqvae import VQVAE


class VQDiffusionComposite(nn.Module):
    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        model_name = cfg.architecture.model_name
        dcfg = cfg.architecture[model_name if model_name in cfg.architecture
                                else "vqdiffusion"]
        self.diffusion_type = str(dcfg.diffusion_type)
        if self.diffusion_type not in ("gaussiandiffusion3d", "gaussiandiffusion2d",
                                       "VQ_Official"):
            raise ValueError(f"diffusion_type {self.diffusion_type!r} not supported")
        self.vqvae = VQVAE.from_config(cfg)
        self.seq_len = self.vqvae.latent_size ** 2
        self.codebook_size = int(cfg.architecture.vqvae.num_codebook_vectors)
        self.timesteps = int(dcfg.diffusion_steps)
        self.dtype = dtype
        self.fused_sampler = dcfg.get("fused_sampler", True)
        sampling_steps = int(dcfg.sampling_steps)
        K, N = self.codebook_size, self.seq_len
        ubase = int(dcfg.get("unet_base_dim", 64))
        umults = tuple(dcfg.get("unet_dim_mults", (1, 2, 4, 8)))
        self.gaussian_dim = int(dcfg.gaussian_dim)
        if self.diffusion_type == "VQ_Official":
            self.unet = (Unet1D(ubase, dim_mults=umults, channels=K, out_dim=K - 1)
                         if int(dcfg.get("unet_dim", 3)) == 2
                         else ShuffleUNet(self.timesteps, 256, 1, 1, 64, (1, 2, 4, 8)))
            self.prior = DiscreteDiffusion(num_classes=K, seq_len=N, timesteps=self.timesteps,
                                           sampling_timesteps=sampling_steps)
            self.fused_posterior = dcfg.get("fused_posterior")
            return
        distribute_dim, to_dist = int(dcfg.distribute_dim), str(dcfg.indices_to_dist_fn)
        if self.diffusion_type == "gaussiandiffusion2d":
            width = K if to_dist == "one_hot" else self.gaussian_dim
            ch = width if distribute_dim == 1 else N
            self.unet = Unet1D(ubase, dim_mults=umults, channels=ch, out_dim=ch)
            self.prior = GaussianDiffusion2D(GaussianDiffusion2DConfig(
                seq_length=N, timesteps=self.timesteps, sampling_timesteps=sampling_steps,
                vocab_size=K, distribute_dim=distribute_dim, gaussian_dim=self.gaussian_dim,
                indices_to_dist_fn=to_dist, diffusion_type="vqdiffusion"))
            return
        if distribute_dim != -1:
            raise ValueError("gaussiandiffusion3d needs distribute_dim -1")
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

    def bind(self, unet: Optional[nn.Module] = None):
        """The prior with this chain's denoiser bound (``unet``, default the
        composite's own, in eval mode): ``fn(x, self_cond, t)`` for the
        Gaussian priors; for VQ_Official ``fn(log_x_t [B, N, K], t)`` ->
        logits [B, N, K-1], and ``fused_posterior`` resolved for the
        U-Net's device."""
        unet = self.unet if unet is None else unet
        if isinstance(unet, Unet1D):
            unet.eval()

            def fwd(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
                with compute_autocast(x.device, self.dtype):      # flax's dtype: out in it
                    return unet(x, None, t)
            return self._bind(fwd)
        return self._bind(eval_forward(unet, self.fused_sampler, self.dtype))

    def _bind(self, fwd):
        """The prior with the U-Net forward ``fwd(x, t)`` bound (no Gaussian
        prior of the composite self-conditions)."""
        if self.diffusion_type != "VQ_Official":
            model_fn = lambda x, self_cond, t: fwd(x, t)              # noqa: E731
            if self.diffusion_type == "gaussiandiffusion3d":
                self.prior.diffusion.model_fn = model_fn
            else:
                self.prior.model_fn = model_fn
            return self.prior
        self.prior.model_fn = self._discrete_model_fn(fwd, isinstance(self.unet, Unet1D))
        mode = self.fused_posterior
        self.prior.fused_posterior = self._device().type == "cuda" if mode is None else mode
        return self.prior

    @staticmethod
    def _discrete_model_fn(fwd, conv1d: bool):
        """VQ_Official's denoiser around the U-Net forward ``fwd(x, t)``:
        log_x_t [B, N, K] as K channels over N (the Conv1d U-Net, K-1 out)
        or as the [B, K, N, 1] image (the ShuffleNet, the output's last row
        dropped) -> logits [B, N, K-1]."""
        def model_fn(log_x_t, t):
            if conv1d:
                return fwd(log_x_t.transpose(1, 2), t).transpose(1, 2).contiguous()
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
               unet: Optional[nn.Module] = None, **noise) -> torch.Tensor:
        """Indices [batch_size, seq_len] from the reverse chain of ``unet``
        (default the composite's own), or the filmstrip's [B, F, N] under
        gaussian3d's ``return_all_timestamps``. Noise comes from
        ``generator`` (on the U-Net's device) or is injected: ``x_T`` and
        ``step_noise`` for gaussian3d, ``init_indices`` and ``step_noise``
        for gaussian2d, ``init_uniform`` and ``step_gumbel`` for
        VQ_Official."""
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
        mode: the ShuffleNet's BatchNorms run on batch statistics and move
        their running ones. ``t`` and ``noise`` (the Gaussian priors: the
        Gaussian noise; VQ_Official: the Gumbel noise of q(x_t | x_0)) come
        from ``generator`` unless given. VQ_Official's loss moves the
        history ``lt``; the Gaussian priors return it as it came (None)."""
        indices = self.encode_to_z(x)
        unet = self.unet.train()
        prior = self._bind(lambda x_t, tt: unet(x_t, None, tt))
        if self.diffusion_type == "VQ_Official":
            return prior.train_loss(indices, lt, generator, t=t, gumbel=noise)
        if self.diffusion_type == "gaussiandiffusion2d":
            loss = prior.loss(indices, generator, t=t, noise=noise)
            return loss, {"loss": loss}, lt
        loss, metrics = prior.loss(indices, generator, t=t, noise=noise)
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
