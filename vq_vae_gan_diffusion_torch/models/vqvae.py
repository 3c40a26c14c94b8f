"""VQ-VAE: encoder -> quant conv -> codebook -> post-quant conv -> decoder
(PyTorch counterpart of the JAX ``models/vqvae.py``).

The public functions (``forward``, ``encode``, ``decode``, ``decode_indices``)
take and return NHWC tensors, as the JAX package's do; the convolutions run
in NCHW. ``adopt_weight`` is the discriminator's warm-up gate.

Dropout follows ``module.training`` here; the JAX package applies none
while it trains (its step calls the VQVAE with ``deterministic=True``), so
the port's training step keeps the VQVAE in eval mode.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from ..config import Config, resolve_img_channels, resolve_img_size
from .codebook import CodeBook
from .decoder import Decoder
from .encoder import Encoder


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class VQVAE(nn.Module):
    def __init__(self, img_size: int = 256, img_channels: int = 3,
                 latent_channels: int = 256, latent_size: int = 16,
                 intermediate_channels: Tuple[int, ...] = (128, 128, 256, 256, 512),
                 num_residual_blocks_encoder: int = 2,
                 num_residual_blocks_decoder: int = 3, dropout: float = 0.0,
                 attention_resolution: Tuple[int, ...] = (16,),
                 num_codebook_vectors: int = 1024, beta: float = 0.25,
                 codebook_precision: str = "exact"):
        super().__init__()
        self.img_size = img_size
        self.img_channels = img_channels
        self.latent_size = latent_size
        self.encoder = Encoder(img_channels, img_size, latent_channels,
                               intermediate_channels, num_residual_blocks_encoder,
                               dropout, attention_resolution)
        self.decoder = Decoder(img_channels, latent_channels, latent_size,
                               intermediate_channels, num_residual_blocks_decoder,
                               dropout, attention_resolution)
        self.codebook = CodeBook(num_codebook_vectors, latent_channels, beta,
                                 codebook_precision)
        self.quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)

    @classmethod
    def from_config(cls, cfg: Config) -> "VQVAE":
        vq = cfg.architecture.vqvae
        return cls(
            img_size=resolve_img_size(cfg),
            img_channels=resolve_img_channels(cfg),
            latent_channels=int(vq.latent_channels),
            latent_size=int(vq.latent_size),
            intermediate_channels=tuple(vq.intermediate_channels),
            num_residual_blocks_encoder=int(vq.num_residual_blocks_encoder),
            num_residual_blocks_decoder=int(vq.num_residual_blocks_decoder),
            dropout=float(vq.dropout),
            attention_resolution=tuple(vq.attention_resolution),
            num_codebook_vectors=int(vq.num_codebook_vectors),
            codebook_precision=str(vq.get("codebook_precision", "exact")),
        )

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init, drawn from ``generator``: lecun-normal
        (truncated) conv kernels and zero biases; the codebook U(-1/K, 1/K)."""
        flax_conv_init_(self, generator)
        k = self.codebook.codebook.num_embeddings
        nn.init.uniform_(self.codebook.codebook.weight, -1.0 / k, 1.0 / k,
                         generator=generator)

    def forward(self, x: torch.Tensor):
        """x [B, H, W, C] -> (decoded [B, H, W, C], indices [B, h, w], vq loss)."""
        z_q, indices, q_loss = self.encode(x)
        return self.decode(z_q), indices, q_loss

    def encode(self, x: torch.Tensor):
        """x [B, H, W, C] -> (z_q [B, h, w, D], indices [B, h, w], vq loss)."""
        h = self.quant_conv(self.encoder(_nchw(x)))
        return self.codebook(_nhwc(h))

    def decode(self, z_q: torch.Tensor) -> torch.Tensor:
        """z_q [B, h, w, D] -> images [B, H, W, C]."""
        return _nhwc(self.decoder(self.post_quant_conv(_nchw(z_q))))

    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """Token indices [B, h, w] or [B, h*w] -> images [B, H, W, C]."""
        b, grid = indices.shape[0], self.latent_size
        return self.decode(self.codebook.lookup(indices.reshape(b, grid, grid)))


@torch.no_grad()
def flax_conv_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default init of ``module``'s convolutions and GroupNorms, drawn
    from ``generator`` in module order: lecun-normal (truncated) kernels,
    zero biases, GroupNorm scales of one."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.GroupNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def adopt_weight(disc_factor: float, step: int, threshold: int) -> float:
    """The discriminator's warm-up gate: 0 before step ``threshold``,
    ``disc_factor`` from it on."""
    return 0.0 if step < threshold else disc_factor
