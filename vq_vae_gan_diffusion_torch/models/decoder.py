"""Mirror convolutional decoder (PyTorch counterpart of the JAX ``models/decoder.py``).

NCHW in, NCHW out; ``state_dict`` keys are ``decoder.model.{i}...``:

- reversed channel plan, e.g. [512, 256, 256, 128, 128];
- 3x3 conv from the latent, then ResBlock -> NonLocal -> ResBlock;
- one stage per channel entry of ``num_residual_blocks`` ResidualBlocks, each
  followed by a NonLocalBlock while the spatial size is in
  ``attention_resolution``, and an UpsampleBlock after every stage but the
  first;
- GroupNorm -> Swish -> 3x3 conv to the image channels.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import (GroupNorm, NonLocalBlock, ResidualBlock, Swish,
                     UpsampleBlock, conv3x3)


class Decoder(nn.Module):
    def __init__(self, img_channels: int = 3, latent_channels: int = 256,
                 latent_size: int = 16,
                 intermediate_channels: Sequence[int] = (128, 128, 256, 256, 512),
                 num_residual_blocks: int = 3, dropout: float = 0.0,
                 attention_resolution: Sequence[int] = (16,)):
        super().__init__()
        channels = list(intermediate_channels)[::-1]
        attn_res = set(attention_resolution)
        c0 = channels[0]
        layers: list[nn.Module] = [
            conv3x3(latent_channels, c0), ResidualBlock(c0, c0, dropout),
            NonLocalBlock(c0), ResidualBlock(c0, c0, dropout)]
        size = latent_size
        cin = c0
        for n, c in enumerate(channels):
            for _ in range(num_residual_blocks):
                layers.append(ResidualBlock(cin, c, dropout))
                cin = c
                if size in attn_res:
                    layers.append(NonLocalBlock(c))
            if n != 0:
                layers.append(UpsampleBlock(c))
                size *= 2
        layers += [GroupNorm(cin), Swish(), conv3x3(cin, img_channels)]
        self.model = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.model(z)
