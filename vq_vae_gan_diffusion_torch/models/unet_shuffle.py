"""ShuffleNet-v2 style U-Net, the gaussian3d prior's denoiser (PyTorch
counterpart of the JAX ``models/unet_shuffle.py``).

Modules and ``state_dict`` keys follow the reference layout that the JAX
package's ``utils/torch_export.py::export_shuffle_unet`` emits:
``init_conv.module.{0,1}``, ``time_embedding``,
``encoder_blocks.i.conv0.k.branch{1,2}.*``, ``.time_mlp.mlp.{0,2}``,
``.conv1``, ``mid_block.i``, ``decoder_blocks.i.*``, ``final_conv``.
BatchNorm (:class:`BatchNorm2d`) uses eps 1e-5. In eval mode it normalises
with the running statistics. In train mode it runs as flax's
``train=True`` call with ``mutable=["batch_stats"]``: it normalises with the
batch statistics, and the running ones move with flax's momentum 0.9
(torch's 0.1) by the *biased* batch variance, where ``nn.BatchNorm2d``
would take the unbiased one.

``ShuffleUNet.forward`` takes and returns NHWC, as the JAX module does, and
runs NCHW inside. In eval mode it is the sampler's ``fused_sampler: False``
route; the BN-folded kernel route is ``models/shuffle_infer.py``. Training
runs it in train mode.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import at_least_f32


def channel_shuffle(x: torch.Tensor, groups: int = 2, dim: int = -1) -> torch.Tensor:
    """The groups-transpose permutation of the channels on axis ``dim``:
    with 2 groups, out[2i] = in[i] and out[2i+1] = in[C/2 + i]."""
    dim = dim % x.dim()
    c = x.shape[dim]
    return x.unflatten(dim, (groups, c // groups)).transpose(dim, dim + 1).flatten(dim, dim + 1)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode is flax's: batch statistics, and
    the running ones moved by ``momentum`` (0.1 here, flax's 0.9) with the
    biased batch variance. ``num_batches_tracked`` stays as it is."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = at_least_f32(x)                 # f32 statistics and arithmetic, as flax's
        if not self.training:
            return super().forward(xf).to(x.dtype)
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(1 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1 - self.momentum).add_(var, alpha=self.momentum)
        return F.batch_norm(xf, None, None, self.weight, self.bias, training=True,
                            eps=self.eps).to(x.dtype)


class ConvBnSiLu(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.module = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, kernel, stride, padding),
            BatchNorm2d(out_channels, eps=1e-5, momentum=0.1),
            nn.SiLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.module(x)


def _depthwise(c: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(c, c, 3, stride, 1, groups=c)


class ResidualBottleneck(nn.Module):
    """The ShuffleNet-v2 basic unit: split, [dw3x3+BN -> pw] and
    [pw -> dw3x3+BN -> pw], concat, channel shuffle (NCHW)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        ch, co2 = in_channels // 2, out_channels // 2
        self.branch1 = nn.Sequential(_depthwise(ch, 1), BatchNorm2d(ch),
                                     ConvBnSiLu(ch, co2, 1))
        self.branch2 = nn.Sequential(ConvBnSiLu(ch, ch, 1), _depthwise(ch, 1),
                                     BatchNorm2d(ch), ConvBnSiLu(ch, co2, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = x.chunk(2, dim=1)
        return channel_shuffle(torch.cat([self.branch1(x1), self.branch2(x2)], 1), dim=1)


class ResidualDownsample(nn.Module):
    """The ShuffleNet-v2 stride-2 unit: no split; both branches halve H, W."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        co2 = out_channels // 2
        self.branch1 = nn.Sequential(_depthwise(in_channels, 2), BatchNorm2d(in_channels),
                                     ConvBnSiLu(in_channels, co2, 1))
        self.branch2 = nn.Sequential(ConvBnSiLu(in_channels, co2, 1), _depthwise(co2, 2),
                                     BatchNorm2d(co2), ConvBnSiLu(co2, co2, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return channel_shuffle(torch.cat([self.branch1(x), self.branch2(x)], 1), dim=1)


class TimeMLP(nn.Module):
    """silu(x + mlp(t_emb)) with the vector broadcast over H, W."""

    def __init__(self, embedding_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(embedding_dim, hidden_dim), nn.SiLU(),
                                 nn.Linear(hidden_dim, out_dim))

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        return F.silu(x + self.mlp(t_emb)[:, :, None, None])


class EncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, time_embedding_dim: int):
        super().__init__()
        self.conv0 = nn.Sequential(
            *[ResidualBottleneck(in_channels, in_channels) for _ in range(3)],
            ResidualBottleneck(in_channels, out_channels // 2))
        self.time_mlp = TimeMLP(time_embedding_dim, out_channels, out_channels // 2)
        self.conv1 = ResidualDownsample(out_channels // 2, out_channels)

    def forward(self, x, t_emb=None):
        shortcut = self.conv0(x)
        x = shortcut if t_emb is None else self.time_mlp(shortcut, t_emb)
        return self.conv1(x), shortcut


def upsample_to(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to the spatial ``size`` (half-pixel
    centres, edge clamp): equals the JAX package's ``jax.image.resize(...,
    "bilinear")`` for the decoder's upsampling."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


class DecoderBlock(nn.Module):
    """Upsample to the skip's size, concat the skip, bottlenecks. ``in_channels``
    is the width after the concat."""

    def __init__(self, in_channels: int, out_channels: int, time_embedding_dim: int):
        super().__init__()
        self.conv0 = nn.Sequential(
            *[ResidualBottleneck(in_channels, in_channels) for _ in range(3)],
            ResidualBottleneck(in_channels, in_channels // 2))
        self.time_mlp = TimeMLP(time_embedding_dim, in_channels, in_channels // 2)
        self.conv1 = ResidualBottleneck(in_channels // 2, out_channels // 2)

    def forward(self, x, shortcut, t_emb=None):
        x = torch.cat([upsample_to(x, shortcut.shape[2:]), shortcut], 1)
        x = self.conv0(x)
        if t_emb is not None:
            x = self.time_mlp(x, t_emb)
        return self.conv1(x)


class ShuffleUNet(nn.Module):
    """The reference Unet3D: a ShuffleNet U-Net without attention."""

    def __init__(self, timesteps: int, time_embedding_dim: int = 256, in_channels: int = 3,
                 out_channels: int = 2, base_dim: int = 64,
                 dim_mults: Sequence[int] = (1, 2, 4, 8)):
        super().__init__()
        dims = [base_dim] + [base_dim * m for m in dim_mults]
        channels = list(zip(dims[:-1], dims[1:]))
        self.init_conv = ConvBnSiLu(in_channels, base_dim, 3, 1, 1)
        self.time_embedding = nn.Embedding(timesteps, time_embedding_dim)
        self.encoder_blocks = nn.ModuleList(
            [EncoderBlock(c_in, c_out, time_embedding_dim) for c_in, c_out in channels])
        mid = channels[-1][1]
        self.mid_block = nn.Sequential(ResidualBottleneck(mid, mid), ResidualBottleneck(mid, mid),
                                       ResidualBottleneck(mid, mid // 2))
        self.decoder_blocks = nn.ModuleList(
            [DecoderBlock(c_out, c_in, time_embedding_dim) for c_in, c_out in channels[::-1]])
        self.final_conv = nn.Conv2d(channels[0][0] // 2, out_channels, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's (flax default) init, drawn from ``generator``:
        lecun-normal (truncated) conv and dense kernels with zero biases,
        N(0, 1/dim) time embeddings, BatchNorm gamma 1, beta 0, mean 0, var 1."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, 0.0, m.embedding_dim ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor, x_self_cond: Optional[torch.Tensor] = None,
                t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, H, W, in_channels] NHWC, t [B] int -> [B, H, W, out_channels]."""
        x = self.init_conv(x.permute(0, 3, 1, 2))
        t_emb = None if t is None else self.time_embedding(t)
        shortcuts = []
        for blk in self.encoder_blocks:
            x, sc = blk(x, t_emb)
            shortcuts.append(sc)
        x = self.mid_block(x)
        for blk in self.decoder_blocks:
            x = blk(x, shortcuts.pop(), t_emb)
        return self.final_conv(x).permute(0, 2, 3, 1)
