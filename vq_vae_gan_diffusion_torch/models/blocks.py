"""Shared conv building blocks (PyTorch counterpart of the JAX ``models/blocks.py``).

Modules work in NCHW inside; the public VQVAE functions convert from and to
the JAX package's NHWC. Module and attribute names reproduce the reference
``state_dict`` keys (``block.0/2/3/6``, ``conv_shortcut``, ``q/k/v/project_out``,
``group_norm.weight``), so transplanted weights load with ``strict=True``.

Parity notes (JAX ``blocks.py``):

- GroupNorm: 32 groups, or the largest divisor of C that is <= 32; eps 1e-6.
- DownsampleBlock: asymmetric zero pad (left 0, right 1, top 0, bottom 1)
  before the stride-2 VALID 3x3 conv.
- UpsampleBlock: 2x nearest-neighbour (an exact repeat) then a 3x3 conv.
- NonLocalBlock: the residual adds to the *normalized* input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class Swish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swish(x)


class GroupNorm(nn.Module):
    """32-group GroupNorm (or the largest divisor of C that is <= 32), eps 1e-6."""

    def __init__(self, channels: int):
        super().__init__()
        num_groups = 32
        while channels % num_groups != 0:
            num_groups -= 1
        self.group_norm = nn.GroupNorm(num_groups, channels, eps=1e-6, affine=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.group_norm(x)


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResidualBlock(nn.Module):
    """GN -> Swish -> 3x3 conv -> GN -> Swish -> dropout -> 3x3 conv, plus a 1x1
    shortcut when the channel count changes."""

    def __init__(self, in_channels: int, out_channels: int, dropout: float = 0.0):
        super().__init__()
        self.block = nn.Sequential(
            GroupNorm(in_channels), Swish(), conv3x3(in_channels, out_channels),
            GroupNorm(out_channels), Swish(), nn.Dropout(dropout),
            conv3x3(out_channels, out_channels))
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.block(x)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class DownsampleBlock(nn.Module):
    """Zero pad (0, 1, 0, 1) then a stride-2 VALID 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class UpsampleBlock(nn.Module):
    """2x nearest-neighbour upsample then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class NonLocalBlock(nn.Module):
    """Single-head self-attention over the flattened H*W grid, scores scaled
    by C^-0.5, residual on the normalized input."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.project_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        xn = self.norm(x)
        q = self.q(xn).reshape(b, c, h * w).transpose(1, 2)       # [B, HW, C]
        k = self.k(xn).reshape(b, c, h * w)                       # [B, C, HW]
        v = self.v(xn).reshape(b, c, h * w).transpose(1, 2)       # [B, HW, C]
        weights = torch.softmax(torch.bmm(q, k) * c ** -0.5, dim=-1)
        attn = torch.bmm(weights, v).transpose(1, 2).reshape(b, c, h, w)
        return xn + self.project_out(attn)
