"""Vector-quantization codebook (PyTorch counterpart of the JAX ``models/codebook.py``).

Nearest-neighbour search by the matmul expansion ``||e||^2 - 2 z.e^T`` (the
``||z||^2`` term is constant in k). ``precision='exact'`` keeps true f32
scores, as the JAX package does at ``Precision.HIGHEST``: on CUDA that needs
TF32 matmuls off, which :func:`..utils.device.resolve_device` ensures.
``'bf16'`` rounds both operands to bf16 and accumulates in f32.

Loss: ``mean((sg(z_q) - z)^2) + beta * mean((z_q - sg(z))^2)`` -- the commitment
term carries weight 1 and the codebook term beta, as in the reference. The
quantized latents pass gradients straight through to ``z``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


def nearest_codebook_indices(z_flat: torch.Tensor, codebook: torch.Tensor,
                             precision: str = "exact") -> torch.Tensor:
    """argmin_k ||z - e_k||^2. [N, D] x [K, D] -> [N] int64. The distances are
    f32 under any autocast, as the JAX package casts both operands to f32."""
    zf, cb = z_flat.float(), codebook.float()
    if precision == "bf16":
        zf, cb = zf.bfloat16().float(), cb.bfloat16().float()
    elif precision != "exact":
        raise ValueError(f"unknown codebook precision {precision!r}")
    with torch.autocast(z_flat.device.type, enabled=False):
        dist = -2.0 * (zf @ cb.T) + (codebook.float() ** 2).sum(1)[None, :]
    return dist.argmin(1)


def quantize(z: torch.Tensor, codebook: torch.Tensor, beta: float = 0.25,
             precision: str = "exact"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """z [B, H, W, D] (NHWC) -> (straight-through z_q [B, H, W, D],
    indices [B, H, W], scalar f32 loss)."""
    b, h, w, d = z.shape
    indices = nearest_codebook_indices(z.reshape(-1, d), codebook, precision)
    z_q = codebook[indices].reshape(b, h, w, d).to(z.dtype)
    zf, zqf = z.float(), z_q.float()
    commit = ((zqf.detach() - zf) ** 2).mean()
    codebook_term = ((zqf - zf.detach()) ** 2).mean()
    loss = commit + beta * codebook_term
    z_q = z + (z_q - z).detach()
    return z_q, indices.reshape(b, h, w), loss


class CodeBook(nn.Module):
    def __init__(self, num_codebook_vectors: int = 1024, latent_dim: int = 256,
                 beta: float = 0.25, precision: str = "exact"):
        super().__init__()
        self.beta = beta
        self.precision = precision
        self.codebook = nn.Embedding(num_codebook_vectors, latent_dim)

    def forward(self, z: torch.Tensor):
        return quantize(z, self.codebook.weight, self.beta, self.precision)

    def lookup(self, indices: torch.Tensor) -> torch.Tensor:
        """indices [...] -> embeddings [..., D]."""
        return self.codebook.weight[indices]
