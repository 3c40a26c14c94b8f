"""Convolutional encoder (PyTorch counterpart of the JAX ``models/encoder.py``).

NCHW in, NCHW out. The modules sit in one ``nn.Sequential`` named ``model`` in
the reference's order, so the ``state_dict`` keys are ``encoder.model.{i}...``:

- channel plan ``[c0, *intermediate_channels]`` (the reference duplicates the
  first entry), ``num_residual_blocks`` ResidualBlocks per stage, each
  followed by a NonLocalBlock while the spatial size is in
  ``attention_resolution``, and a DownsampleBlock after every stage but the
  last;
- bottleneck ResBlock -> NonLocal -> ResBlock -> GroupNorm -> Swish -> 3x3
  conv to ``latent_channels``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import (DownsampleBlock, GroupNorm, NonLocalBlock, ResidualBlock,
                     Swish, conv3x3)


class Encoder(nn.Module):
    def __init__(self, img_channels: int = 3, image_size: int = 256,
                 latent_channels: int = 256,
                 intermediate_channels: Sequence[int] = (128, 128, 256, 256, 512),
                 num_residual_blocks: int = 2, dropout: float = 0.0,
                 attention_resolution: Sequence[int] = (16,)):
        super().__init__()
        channels = [intermediate_channels[0], *intermediate_channels]
        attn_res = set(attention_resolution)
        layers: list[nn.Module] = [conv3x3(img_channels, channels[0])]
        size = image_size
        for n in range(len(channels) - 1):
            cin = channels[n]
            for _ in range(num_residual_blocks):
                layers.append(ResidualBlock(cin, channels[n + 1], dropout))
                cin = channels[n + 1]
                if size in attn_res:
                    layers.append(NonLocalBlock(cin))
            if n != len(channels) - 2:
                layers.append(DownsampleBlock(cin))
                size //= 2
        c = channels[-1]
        layers += [ResidualBlock(c, c, dropout), NonLocalBlock(c),
                   ResidualBlock(c, c, dropout), GroupNorm(c), Swish(),
                   conv3x3(c, latent_channels)]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)
