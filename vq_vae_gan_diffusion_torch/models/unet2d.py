"""Conv2d DDPM U-Nets for pixel-space diffusion (PyTorch counterpart of the
JAX ``models/unet2d.py``; "Unet3D" in the reference's rank-based naming).

:class:`Unet2DPixel` is the JAX module's network in the reference's NCHW
layout: it takes x [B, channels, H, W] and returns [B, out_dim, H, W].

- RMSNorm over channels: ``x * rsqrt(sum(x^2) + 1e-12) * g * sqrt(C)``;
- the sinusoidal time embedding (or the learned / random Fourier one of
  :mod:`.unet1d`), then a time MLP of width 4 * dim with exact GELU;
- ResnetBlock with FiLM scale-shift ``x * (scale + 1) + shift`` in its
  first block, dropout after its first block's SiLU;
- linear attention (softmax of q over its features, then the scale, of k
  over positions; ``to_out`` then an RMSNorm) in every stage but those
  ``full_attn`` names (by default the innermost), full attention there and
  in the middle; each attention block normalises its input and prepends 4
  learned memory keys and values a head;
- down stages of two ResnetBlocks and attention, then space-to-depth (2x2
  patches to channels in (c, p1, p2) order) and a 1x1 conv (the innermost
  stage a 3x3 conv); up stages with two skip concatenations each, then
  nearest x2 and a 3x3 conv (the outermost a bare 3x3 conv); the init
  conv's output concatenated before the final block.

With ``self_condition`` a second input of x's shape (zeros when not given)
is concatenated ahead of x. :class:`SimpleUNet` is the minimal
DoubleConv / max-pool / 2x2 transposed-conv U-Net with a time MLP added
after each down stage's convolutions.

RMSNorm and the softmaxes compute in float32 at least. The parameter names
follow the reference's module layout (``downs.{i}.{0..3}``, ``mid_block1``,
``mid_attn``, ``ups.{i}.{0..3}``, ``final_res_block``, ``final_conv``);
``weights.unet2d_state_from_jax`` and ``simple_unet_state_from_jax`` map
the JAX params onto them (the JAX export tool has no family for these
nets).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import at_least_f32
from .unet1d import (RandomOrLearnedSinusoidalPosEmb, RMSNorm, SinusoidalPosEmb,
                     flax_init_)


class RMSNorm2D(RMSNorm):
    def __init__(self, dim: int):
        super().__init__(dim, spatial_dims=2)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """b c (h p1) (w p2) -> b (c p1 p2) h w."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, c * 4, h // 2, w // 2)


class Downsample(nn.Module):
    """Space-to-depth, then a 1x1 conv."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.conv = nn.Conv2d(dim * 4, dim_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(space_to_depth(x))


class Upsample(nn.Sequential):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"),
                         nn.Conv2d(dim, dim_out, 3, padding=1))


class ConvBlock2D(nn.Module):
    def __init__(self, dim: int, dim_out: int, dropout: float = 0.0):
        super().__init__()
        self.proj = nn.Conv2d(dim, dim_out, 3, padding=1)
        self.norm = RMSNorm2D(dim_out)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else nn.Identity()

    def forward(self, x: torch.Tensor, scale_shift=None) -> torch.Tensor:
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return self.dropout(F.silu(x))


class ResnetBlock2D(nn.Module):
    def __init__(self, dim: int, dim_out: int, time_emb_dim: Optional[int] = None,
                 dropout: float = 0.0):
        super().__init__()
        self.mlp = (nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim, dim_out * 2))
                    if time_emb_dim is not None else None)
        self.block1 = ConvBlock2D(dim, dim_out, dropout)
        self.block2 = ConvBlock2D(dim_out, dim_out)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x: torch.Tensor, t_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        scale_shift = None
        if self.mlp is not None and t_emb is not None:
            scale_shift = self.mlp(t_emb)[:, :, None, None].chunk(2, dim=1)
        h = self.block2(self.block1(x, scale_shift))
        return h + self.res_conv(x)


class _Attention(nn.Module):
    """The two attentions' common part: the input's RMSNorm, the 1x1 qkv
    projection and the memory keys and values."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, num_mem_kv: int = 4):
        super().__init__()
        self.heads, self.scale = heads, dim_head ** -0.5
        hidden = heads * dim_head
        self.norm = RMSNorm2D(dim)
        self.mem_kv = nn.Parameter(torch.randn(2, heads, num_mem_kv, dim_head))
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)

    def qkv(self, x: torch.Tensor):
        """q, k, v as [B, heads, dim_head, n]; k and v with the memory slots
        ahead of the positions."""
        b, _, h, w = x.shape
        q, k, v = (t.reshape(b, self.heads, -1, h * w)
                   for t in self.to_qkv(self.norm(x)).chunk(3, dim=1))
        mk, mv = (m.transpose(1, 2).unsqueeze(0).expand(b, -1, -1, -1).to(k.dtype)
                  for m in self.mem_kv)
        return q, torch.cat([mk, k], dim=3), torch.cat([mv, v], dim=3)


class LinearAttention2D(_Attention):
    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, num_mem_kv: int = 4):
        super().__init__(dim, heads, dim_head, num_mem_kv)
        self.to_out = nn.Sequential(nn.Conv2d(heads * dim_head, dim, 1), RMSNorm2D(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        q, k, v = self.qkv(x)
        q = torch.softmax(at_least_f32(q), dim=2).to(x.dtype) * self.scale
        k = torch.softmax(at_least_f32(k), dim=3).to(x.dtype)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q).reshape(b, -1, h, w)
        return self.to_out(out)


class Attention2D(_Attention):
    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, num_mem_kv: int = 4):
        super().__init__(dim, heads, dim_head, num_mem_kv)
        self.to_out = nn.Conv2d(heads * dim_head, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        q, k, v = self.qkv(x)
        sim = torch.einsum("bhdi,bhdj->bhij", q * self.scale, k)
        attn = torch.softmax(at_least_f32(sim), dim=-1).to(x.dtype)
        out = torch.einsum("bhij,bhdj->bhdi", attn, v).reshape(b, -1, h, w)
        return self.to_out(out)


class Unet2DPixel(nn.Module):
    """x [B, channels, H, W], optional ``x_self_cond`` of x's shape, t [B] ->
    [B, out_dim, H, W]."""

    def __init__(self, dim: int = 64, init_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, dim_mults: Sequence[int] = (1, 2, 4, 8),
                 channels: int = 3, self_condition: bool = False,
                 learned_variance: bool = False, learned_sinusoidal_cond: bool = False,
                 random_fourier_features: bool = False, learned_sinusoidal_dim: int = 16,
                 dropout: float = 0.0, attn_dim_head: int = 32, attn_heads: int = 4,
                 full_attn: Optional[Tuple[bool, ...]] = None):
        super().__init__()
        self.channels = channels
        self.self_condition = self_condition
        init_dim = init_dim or dim
        self.init_conv = nn.Conv2d(channels * (2 if self_condition else 1), init_dim, 7,
                                   padding=3)
        time_dim = dim * 4
        if learned_sinusoidal_cond or random_fourier_features:
            pos_emb = RandomOrLearnedSinusoidalPosEmb(learned_sinusoidal_dim,
                                                      random_fourier_features)
            fourier_dim = learned_sinusoidal_dim + 1
        else:
            pos_emb, fourier_dim = SinusoidalPosEmb(dim), dim
        self.time_mlp = nn.Sequential(pos_emb, nn.Linear(fourier_dim, time_dim),
                                      nn.GELU(approximate="none"),
                                      nn.Linear(time_dim, time_dim))

        dims = [init_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        n_stage = len(in_out)
        full_attn = tuple(full_attn or [False] * (n_stage - 1) + [True])

        def res(d_in, d_out):
            return ResnetBlock2D(d_in, d_out, time_dim, dropout)

        def attn(d, full):
            return (Attention2D if full else LinearAttention2D)(d, attn_heads, attn_dim_head)

        self.downs = nn.ModuleList()
        for ind, ((d_in, d_out), full) in enumerate(zip(in_out, full_attn)):
            last = ind == n_stage - 1
            self.downs.append(nn.ModuleList([
                res(d_in, d_in), res(d_in, d_in), attn(d_in, full),
                nn.Conv2d(d_in, d_out, 3, padding=1) if last else Downsample(d_in, d_out)]))
        mid = dims[-1]
        self.mid_block1 = res(mid, mid)
        self.mid_attn = Attention2D(mid, attn_heads, attn_dim_head)
        self.mid_block2 = res(mid, mid)
        self.ups = nn.ModuleList()
        for ind, ((d_in, d_out), full) in enumerate(zip(reversed(in_out), reversed(full_attn))):
            last = ind == n_stage - 1
            self.ups.append(nn.ModuleList([
                res(d_out + d_in, d_out), res(d_out + d_in, d_out), attn(d_out, full),
                nn.Conv2d(d_out, d_in, 3, padding=1) if last else Upsample(d_out, d_in)]))
        self.out_dim = out_dim or channels * (2 if learned_variance else 1)
        self.final_res_block = res(init_dim * 2, init_dim)
        self.final_conv = nn.Conv2d(init_dim, self.out_dim, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's (flax default) init, drawn from ``generator``
        (:func:`.unet1d.flax_init_`), then the attentions' memory keys and
        values N(0, 1)."""
        flax_init_(self, generator)
        for m in self.modules():
            if isinstance(m, _Attention):
                m.mem_kv.normal_(0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor, x_self_cond: Optional[torch.Tensor] = None,
                time: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.self_condition:
            x = torch.cat([torch.zeros_like(x) if x_self_cond is None else x_self_cond, x],
                          dim=1)
        x = self.init_conv(x)
        r = x
        # the time embedding in the MLP's dtype, float32 at least
        dtype = torch.promote_types(self.time_mlp[1].weight.dtype, torch.float32)
        t = self.time_mlp[1:](self.time_mlp[0](time, dtype).to(self.time_mlp[1].weight.dtype))
        hs = []
        for block1, block2, attn, down in self.downs:
            x = block1(x, t)
            hs.append(x)
            x = block2(x, t)
            x = attn(x) + x
            hs.append(x)
            x = down(x)
        x = self.mid_block1(x, t)
        x = self.mid_attn(x) + x
        x = self.mid_block2(x, t)
        for block1, block2, attn, up in self.ups:
            x = block1(torch.cat([x, hs.pop()], dim=1), t)
            x = block2(torch.cat([x, hs.pop()], dim=1), t)
            x = attn(x) + x
            x = up(x)
        x = self.final_res_block(torch.cat([x, r], dim=1), t)
        return self.final_conv(x)


class DoubleConv(nn.Sequential):
    """3x3 conv, ReLU, 3x3 conv, ReLU."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__(nn.Conv2d(dim, dim_out, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(dim_out, dim_out, 3, padding=1), nn.ReLU())


class SimpleUNet(nn.Module):
    """The minimal classic U-Net with a time MLP: x [B, in_channels, H, W],
    t [B] -> [B, out_channels, H, W]; ``x_self_cond`` is taken and unused,
    as in the JAX module."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, time_dim: int = 32,
                 features: Sequence[int] = (64, 128, 256)):
        super().__init__()
        self.pos_emb = SinusoidalPosEmb(time_dim)
        self.time_fc = nn.Linear(time_dim, time_dim)
        self.downs = nn.ModuleList()
        self.time_to = nn.ModuleList()
        dim = in_channels
        for f in features:
            self.downs.append(DoubleConv(dim, f))
            self.time_to.append(nn.Linear(time_dim, f))
            dim = f
        self.bottleneck = DoubleConv(features[-1], features[-1] * 2)
        self.ups_t = nn.ModuleList()
        self.ups = nn.ModuleList()
        dim = features[-1] * 2
        for f in reversed(features):
            self.ups_t.append(nn.ConvTranspose2d(dim, f, 2, stride=2))
            self.ups.append(DoubleConv(f * 2, f))
            dim = f
        self.out = nn.Conv2d(features[0], out_channels, 1)

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's (flax default) init, drawn from ``generator``."""
        flax_init_(self, generator)

    def forward(self, x: torch.Tensor, x_self_cond: Optional[torch.Tensor] = None,
                time: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = torch.promote_types(self.time_fc.weight.dtype, torch.float32)
        t = F.relu(self.time_fc(self.pos_emb(time, dtype).to(self.time_fc.weight.dtype)))
        skips = []
        for down, time_to in zip(self.downs, self.time_to):
            x = down(x) + time_to(t)[:, :, None, None]
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = self.bottleneck(x)
        for up_t, up in zip(self.ups_t, self.ups):
            x = up(torch.cat([up_t(x), skips.pop()], dim=1))
        return self.out(x)
