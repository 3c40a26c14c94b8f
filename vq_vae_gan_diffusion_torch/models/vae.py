"""Plain VAE: the shared encoder and decoder with 1x1 ``fc_mu`` /
``fc_logvar`` heads (PyTorch counterpart of the JAX ``models/vae.py``).

``encode`` gives (µ, logσ²) from the encoder's output, ``reparameterize``
draws ``z = µ + ε · exp(½ logσ²)`` in float32, ``decode`` runs the decoder.
The public functions take and return NHWC tensors, as the JAX package's
do; the convolutions run in NCHW. ε comes from an explicit
``torch.Generator``, or is given (``eps``), as the parity tests give the
JAX draw.

The decoder places its attention by the nominal ``latent_size``, not by
the encoder's real output size, as the JAX decoder does: a config whose
``latent_size`` is twice the real latent (``training_config_large.yml``:
32 against 256 / 2^4 = 16) runs attention in the decoder's first two
stages, and its samples, drawn at ``latent_size``, decode to twice the
image size.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import Config, resolve_img_channels, resolve_img_size
from ..parallel.mesh import draw_rows
from .decoder import Decoder
from .encoder import Encoder
from .vqvae import _nchw, _nhwc, flax_conv_init_


class VAE(nn.Module):
    def __init__(self, img_size: int = 256, img_channels: int = 3,
                 latent_channels: int = 256, latent_size: int = 16,
                 intermediate_channels: Tuple[int, ...] = (128, 128, 256, 256, 512),
                 num_residual_blocks_encoder: int = 2,
                 num_residual_blocks_decoder: int = 3, dropout: float = 0.0,
                 attention_resolution: Tuple[int, ...] = (32,)):
        super().__init__()
        self.img_size = img_size
        self.img_channels = img_channels
        self.latent_channels = latent_channels
        self.latent_size = latent_size
        self.encoder = Encoder(img_channels, img_size, latent_channels, intermediate_channels,
                               num_residual_blocks_encoder, dropout, attention_resolution)
        self.decoder = Decoder(img_channels, latent_channels, latent_size, intermediate_channels,
                               num_residual_blocks_decoder, dropout, attention_resolution)
        self.fc_mu = nn.Conv2d(latent_channels, latent_channels, 1)
        self.fc_logvar = nn.Conv2d(latent_channels, latent_channels, 1)

    @classmethod
    def from_config(cls, cfg: Config) -> "VAE":
        """``architecture.vae``, or else ``architecture.vqvae``, with the JAX
        package's defaults for the keys it leaves out."""
        vae = cfg.architecture.get("vae", cfg.architecture.get("vqvae"))
        return cls(
            img_size=resolve_img_size(cfg),
            img_channels=resolve_img_channels(cfg),
            latent_channels=int(vae.get("latent_channels", 256)),
            latent_size=int(vae.get("latent_size", 16)),
            intermediate_channels=tuple(vae.get("intermediate_channels",
                                                (128, 128, 256, 256, 512))),
            num_residual_blocks_encoder=int(vae.get("num_residual_blocks_encoder", 2)),
            num_residual_blocks_decoder=int(vae.get("num_residual_blocks_decoder", 3)),
            dropout=float(vae.get("dropout", 0.0)),
            attention_resolution=tuple(vae.get("attention_resolution", (32,))),
        )

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init, drawn from ``generator``: lecun-normal
        (truncated) conv kernels and zero biases, GroupNorm scales of one."""
        flax_conv_init_(self, generator)

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """x [B, H, W, C] -> (decoded [B, H, W, C], µ, logσ² [B, h, w, D])."""
        mu, logvar = self.encode(x)
        z = self.reparameterize(mu, logvar, eps, generator)
        return self.decode(z), mu, logvar

    def encode(self, x: torch.Tensor):
        """x [B, H, W, C] -> (µ, logσ²), each [B, h, w, D]."""
        h = self.encoder(_nchw(x))
        return _nhwc(self.fc_mu(h)), _nhwc(self.fc_logvar(h))

    @staticmethod
    def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                       eps: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """µ + ε · exp(½ logσ²) in float32 at least, ε ~ N(0, I) from
        ``generator`` (on its device) unless given; under data parallelism,
        this rank's rows of the global batch's ε (:func:`..parallel.draw_rows`)."""
        dtype = torch.promote_types(mu.dtype, torch.float32)
        std = torch.exp(0.5 * logvar.to(dtype))
        if eps is None:
            dev = generator.device if generator is not None else mu.device
            eps = draw_rows(lambda n: torch.randn((n, *std.shape[1:]), generator=generator,
                                                  dtype=dtype, device=dev), std.shape[0])
        return (mu.to(dtype) + eps.to(mu.device, dtype) * std).to(mu.dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, h, w, D] -> images [B, 2^n h, 2^n w, C]."""
        return _nhwc(self.decoder(_nchw(z)))
