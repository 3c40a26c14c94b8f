"""The stage-1 VQGAN of the reference repository (Oxford102Flower settings):
encoder, nearest-code quantizer and decoder, NCHW inside, NHWC at the
public functions, float32.

Layer equations (hongrui16/VQ-VAE-GAN-Diffusion ``network/vqvae``):

- GroupNorm of 32 groups (or the largest divisor of C not above 32), eps
  1e-6; Swish x * sigmoid(x);
- ResidualBlock: GN, Swish, 3x3 conv, GN, Swish, 3x3 conv, plus a 1x1
  shortcut where the width changes;
- Downsample: zero pad right and bottom by one, stride-2 3x3 conv;
  Upsample: 2x nearest, 3x3 conv;
- NonLocalBlock: single-head attention over the H*W grid, scores scaled by
  C^-0.5, the residual added to the normalised input;
- quantizer: argmin_k ||z - e_k||^2, computed as ||e_k||^2 - 2 z.e_k.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class GroupNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        groups = 32
        while channels % groups:
            groups -= 1
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6)

    def forward(self, x):
        return self.group_norm(x)


def swish(x):
    return x * torch.sigmoid(x)


class Swish(nn.Module):
    def forward(self, x):
        return swish(x)


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.block = nn.Sequential(GroupNorm(cin), Swish(), conv3x3(cin, cout), GroupNorm(cout),
                                   Swish(), nn.Identity(), conv3x3(cout, cout))
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.block(x)
        return (self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x) + h


class DownsampleBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class UpsampleBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = conv3x3(c, c)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class NonLocalBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = GroupNorm(c)
        self.q, self.k, self.v = (nn.Conv2d(c, c, 1) for _ in range(3))
        self.project_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        xn = self.norm(x)
        q = self.q(xn).reshape(b, c, h * w).transpose(1, 2)
        k = self.k(xn).reshape(b, c, h * w)
        v = self.v(xn).reshape(b, c, h * w).transpose(1, 2)
        att = torch.softmax(torch.bmm(q, k) * c ** -0.5, dim=-1)
        return xn + self.project_out(torch.bmm(att, v).transpose(1, 2).reshape(b, c, h, w))


class Encoder(nn.Module):
    def __init__(self, img_channels: int, image_size: int, latent_channels: int,
                 channels: Sequence[int], n_res: int, attn: Sequence[int]):
        super().__init__()
        ch = [channels[0], *channels]
        layers = [conv3x3(img_channels, ch[0])]
        size = image_size
        for n in range(len(ch) - 1):
            cin = ch[n]
            for _ in range(n_res):
                layers.append(ResidualBlock(cin, ch[n + 1]))
                cin = ch[n + 1]
                if size in attn:
                    layers.append(NonLocalBlock(cin))
            if n != len(ch) - 2:
                layers.append(DownsampleBlock(cin))
                size //= 2
        c = ch[-1]
        layers += [ResidualBlock(c, c), NonLocalBlock(c), ResidualBlock(c, c), GroupNorm(c),
                   Swish(), conv3x3(c, latent_channels)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


class Decoder(nn.Module):
    def __init__(self, img_channels: int, latent_channels: int, latent_size: int,
                 channels: Sequence[int], n_res: int, attn: Sequence[int]):
        super().__init__()
        ch = list(channels)[::-1]
        c0 = ch[0]
        layers = [conv3x3(latent_channels, c0), ResidualBlock(c0, c0), NonLocalBlock(c0),
                  ResidualBlock(c0, c0)]
        size, cin = latent_size, c0
        for n, c in enumerate(ch):
            for _ in range(n_res):
                layers.append(ResidualBlock(cin, c))
                cin = c
                if size in attn:
                    layers.append(NonLocalBlock(c))
            if n:
                layers.append(UpsampleBlock(c))
                size *= 2
        layers += [GroupNorm(cin), Swish(), conv3x3(cin, img_channels)]
        self.model = nn.Sequential(*layers)

    def forward(self, z):
        return self.model(z)


class CodeBook(nn.Module):
    def __init__(self, k: int, d: int):
        super().__init__()
        self.codebook = nn.Embedding(k, d)


class VQGAN(nn.Module):
    """Weights under the port's names: ``encoder.model.*``, ``decoder.model.*``,
    ``codebook.codebook.weight``, ``quant_conv``, ``post_quant_conv``."""

    def __init__(self, img_size: int, img_channels: int, latent_channels: int,
                 latent_size: int, channels: Sequence[int], n_res_enc: int, n_res_dec: int,
                 attn: Sequence[int], codes: int):
        super().__init__()
        self.latent_size = latent_size
        self.encoder = Encoder(img_channels, img_size, latent_channels, channels, n_res_enc,
                               set(attn))
        self.decoder = Decoder(img_channels, latent_channels, latent_size, channels, n_res_dec,
                               set(attn))
        self.codebook = CodeBook(codes, latent_channels)
        self.quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)

    @classmethod
    def from_sizes(cls, vq: dict, img_size: int, img_channels: int) -> "VQGAN":
        return cls(img_size, img_channels, vq["latent_channels"], vq["latent_size"],
                   vq["intermediate_channels"], vq["num_residual_blocks_encoder"],
                   vq["num_residual_blocks_decoder"], vq["attention_resolution"],
                   vq["num_codebook_vectors"])

    @torch.no_grad()
    def indices(self, x: torch.Tensor) -> torch.Tensor:
        """Images [B, H, W, C] -> the nearest codes [B, h*w]."""
        z = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        e = self.codebook.codebook.weight
        dist = (e * e).sum(1)[None, :] - 2.0 * z.reshape(-1, z.shape[-1]) @ e.T
        return dist.argmin(1).reshape(x.shape[0], -1)

    @torch.no_grad()
    def decode_indices(self, idx: torch.Tensor) -> torch.Tensor:
        """Codes [B, h*w] -> images [B, H, W, C]."""
        g = self.latent_size
        z = self.codebook.codebook.weight[idx.reshape(-1, g, g)].permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)
