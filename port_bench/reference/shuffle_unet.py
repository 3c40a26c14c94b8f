"""The gaussian3d prior's denoiser: the reference repository's ShuffleNet-v2
U-Net (``Unet3D``) without attention, float32, NCHW inside and NHWC at
``forward``.

- ConvBnSiLu: conv, BatchNorm (eps 1e-5), SiLU;
- bottleneck unit: split the channels in halves; branch 1 depthwise 3x3 +
  BN, then a pointwise ConvBnSiLu; branch 2 pointwise ConvBnSiLu,
  depthwise 3x3 + BN, pointwise ConvBnSiLu; concatenate, shuffle the
  channels in two groups;
- downsample unit: no split, both branches at stride 2;
- encoder block: 3 bottlenecks, a bottleneck to half the output width,
  SiLU(x + MLP(t_emb)), a downsample (H, W rounded up); the skip is taken
  before the time MLP;
- decoder block: bilinear resize to the skip (half-pixel centres),
  concatenate the skip, 3 bottlenecks, a bottleneck to half, the time MLP,
  a bottleneck to half the output width;
- BatchNorm in train mode normalises by the batch's statistics and moves
  the running ones by 0.1 of the batch's biased variance (flax's momentum
  0.9); in eval mode it uses the running ones.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x):
        shape = (1, -1, 1, 1)
        if self.training:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + 1e-5)
        return y * self.weight.view(shape) + self.bias.view(shape)


class ConvBnSiLu(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, pad: int = 0):
        super().__init__()
        self.module = nn.Sequential(nn.Conv2d(cin, cout, k, stride, pad), BatchNorm(cout),
                                    nn.SiLU())

    def forward(self, x):
        return self.module(x)


def depthwise(c: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(c, c, 3, stride, 1, groups=c)


def shuffle(x):
    b, c, h, w = x.shape
    return x.reshape(b, 2, c // 2, h, w).transpose(1, 2).reshape(b, c, h, w)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        ch, co2 = cin // 2, cout // 2
        self.branch1 = nn.Sequential(depthwise(ch, 1), BatchNorm(ch), ConvBnSiLu(ch, co2, 1))
        self.branch2 = nn.Sequential(ConvBnSiLu(ch, ch, 1), depthwise(ch, 1), BatchNorm(ch),
                                     ConvBnSiLu(ch, co2, 1))

    def forward(self, x):
        x1, x2 = x.chunk(2, dim=1)
        return shuffle(torch.cat([self.branch1(x1), self.branch2(x2)], 1))


class Downsample(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        co2 = cout // 2
        self.branch1 = nn.Sequential(depthwise(cin, 2), BatchNorm(cin), ConvBnSiLu(cin, co2, 1))
        self.branch2 = nn.Sequential(ConvBnSiLu(cin, co2, 1), depthwise(co2, 2), BatchNorm(co2),
                                     ConvBnSiLu(co2, co2, 1))

    def forward(self, x):
        return shuffle(torch.cat([self.branch1(x), self.branch2(x)], 1))


class TimeMLP(nn.Module):
    def __init__(self, emb: int, hidden: int, out: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(emb, hidden), nn.SiLU(), nn.Linear(hidden, out))

    def forward(self, x, t_emb):
        return F.silu(x + self.mlp(t_emb)[:, :, None, None])


class EncoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, emb: int):
        super().__init__()
        self.conv0 = nn.Sequential(*[Bottleneck(cin, cin) for _ in range(3)],
                                   Bottleneck(cin, cout // 2))
        self.time_mlp = TimeMLP(emb, cout, cout // 2)
        self.conv1 = Downsample(cout // 2, cout)

    def forward(self, x, t_emb):
        skip = self.conv0(x)
        return self.conv1(self.time_mlp(skip, t_emb)), skip


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, emb: int):
        super().__init__()
        self.conv0 = nn.Sequential(*[Bottleneck(cin, cin) for _ in range(3)],
                                   Bottleneck(cin, cin // 2))
        self.time_mlp = TimeMLP(emb, cin, cin // 2)
        self.conv1 = Bottleneck(cin // 2, cout // 2)

    def forward(self, x, skip, t_emb):
        x = F.interpolate(x, size=skip.shape[2:], mode="bilinear", align_corners=False)
        x = self.conv0(torch.cat([x, skip], 1))
        return self.conv1(self.time_mlp(x, t_emb))


class ShuffleUNet(nn.Module):
    """Weights under the port's names (``init_conv.module.{0,1}``,
    ``time_embedding``, ``encoder_blocks.{i}.conv0.{j}.branch{1,2}``, ...)."""

    def __init__(self, timesteps: int, emb: int, cin: int, cout: int, base: int,
                 mults: Sequence[int]):
        super().__init__()
        dims = [base] + [base * m for m in mults]
        pairs = list(zip(dims[:-1], dims[1:]))
        self.init_conv = ConvBnSiLu(cin, base, 3, 1, 1)
        self.time_embedding = nn.Embedding(timesteps, emb)
        self.encoder_blocks = nn.ModuleList(EncoderBlock(a, b, emb) for a, b in pairs)
        mid = pairs[-1][1]
        self.mid_block = nn.Sequential(Bottleneck(mid, mid), Bottleneck(mid, mid),
                                       Bottleneck(mid, mid // 2))
        self.decoder_blocks = nn.ModuleList(DecoderBlock(b, a, emb) for a, b in pairs[::-1])
        self.final_conv = nn.Conv2d(pairs[0][0] // 2, cout, 1)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, cin], t [B] -> [B, H, W, cout]."""
        x = self.init_conv(x.permute(0, 3, 1, 2))
        t_emb = self.time_embedding(t)
        skips = []
        for blk in self.encoder_blocks:
            x, skip = blk(x, t_emb)
            skips.append(skip)
        x = self.mid_block(x)
        for blk in self.decoder_blocks:
            x = blk(x, skips.pop(), t_emb)
        return self.final_conv(x).permute(0, 2, 3, 1)
