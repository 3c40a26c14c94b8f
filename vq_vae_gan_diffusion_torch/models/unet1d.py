"""Conv1d U-Net over sequences (PyTorch counterpart of the JAX
``models/unet1d.py``; "Unet2D" in the reference's rank-based naming).

The same network as the JAX module, in the reference's NCL layout: it
takes x [B, channels, L] and returns [B, out_dim, L], so its callers hand
over their [B, C, L] tensors as they are.

- RMSNorm over channels: ``x * rsqrt(sum(x^2) + 1e-12) * g * sqrt(C)``;
- sinusoidal time embedding (frequencies over ``half - 1``), or the learned
  / random Fourier one, then a time MLP of width 4 * dim with exact GELU;
- ResnetBlock with FiLM scale-shift ``x * (scale + 1) + shift`` in its first
  block;
- linear attention (softmax of q over its features, of k over positions) in
  every stage, full attention at the bottleneck;
- four down stages (two ResnetBlocks, attention, a kernel-4 stride-2 conv;
  the last stage a 3-wide conv), a middle, four up stages with two skip
  concatenations each (nearest x2 and a 3-wide conv; the last stage a bare
  3-wide conv), the input of the U-Net concatenated before the final block.

With ``self_condition`` or ``condition`` a second input of x's shape (zeros
when not given) is concatenated ahead of x. RMSNorm and the softmaxes
compute in float32 at least (float64 stays float64, so a float64 forward
is float64 throughout).

The parameter names are the reference ``state_dict``'s, as
``utils/torch_export.py::export_unet1d`` of the JAX package writes them
(``weights.unet1d_state_from_jax`` maps the JAX params onto them).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import at_least_f32


class RMSNorm(nn.Module):
    """Over the channels of [B, C, *spatial] (``spatial_dims`` of them)."""

    def __init__(self, dim: int, spatial_dims: int = 1):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, *([1] * spatial_dims)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = at_least_f32(x)
        normed = x32 * torch.rsqrt(torch.sum(x32 * x32, dim=1, keepdim=True) + 1e-12)
        return (normed * self.g * math.sqrt(x.shape[1])).to(x.dtype)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int, theta: float = 10000.0):
        super().__init__()
        self.dim, self.theta = dim, theta

    def forward(self, t: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        half = self.dim // 2
        freqs = torch.exp(torch.arange(half, device=t.device, dtype=dtype)
                          * (-math.log(self.theta) / (half - 1)))
        args = t.to(dtype)[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class RandomOrLearnedSinusoidalPosEmb(nn.Module):
    """[t, sin(2 pi t w), cos(2 pi t w)] with w learned, or fixed when
    ``is_random``."""

    def __init__(self, dim: int, is_random: bool = False):
        super().__init__()
        self.weights = nn.Parameter(torch.randn(dim // 2), requires_grad=not is_random)

    def forward(self, t: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        t = t.to(dtype)[:, None]
        freqs = t * self.weights[None, :].to(dtype) * 2 * math.pi
        return torch.cat([t, torch.sin(freqs), torch.cos(freqs)], dim=-1)


class ConvBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, dropout: float = 0.0):
        super().__init__()
        self.proj = nn.Conv1d(dim, dim_out, 3, padding=1)
        self.norm = RMSNorm(dim_out)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else nn.Identity()

    def forward(self, x: torch.Tensor, scale_shift=None) -> torch.Tensor:
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return self.dropout(F.silu(x))


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, time_emb_dim: Optional[int] = None,
                 dropout: float = 0.0):
        super().__init__()
        self.mlp = (nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim, dim_out * 2))
                    if time_emb_dim is not None else None)
        self.block1 = ConvBlock(dim, dim_out, dropout)
        self.block2 = ConvBlock(dim_out, dim_out)
        self.res_conv = nn.Conv1d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x: torch.Tensor, t_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        scale_shift = None
        if self.mlp is not None and t_emb is not None:
            scale_shift = self.mlp(t_emb)[:, :, None].chunk(2, dim=1)
        h = self.block2(self.block1(x, scale_shift))
        return h + self.res_conv(x)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, heads * d, L] -> [B, heads, d, L]."""
    return t.reshape(t.shape[0], heads, -1, t.shape[-1])


class LinearAttention1D(nn.Module):
    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.scale = heads, dim_head ** -0.5
        hidden = heads * dim_head
        self.to_qkv = nn.Conv1d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(nn.Conv1d(hidden, dim, 1), RMSNorm(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, n = x.shape
        q, k, v = (_heads(t, self.heads) for t in self.to_qkv(x).chunk(3, dim=1))
        q = torch.softmax(at_least_f32(q), dim=2).to(x.dtype) * self.scale
        k = torch.softmax(at_least_f32(k), dim=3).to(x.dtype)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q).reshape(b, -1, n)
        return self.to_out(out)


class Attention1D(nn.Module):
    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.scale = heads, dim_head ** -0.5
        hidden = heads * dim_head
        self.to_qkv = nn.Conv1d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv1d(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, n = x.shape
        q, k, v = (_heads(t, self.heads) for t in self.to_qkv(x).chunk(3, dim=1))
        sim = torch.einsum("bhdi,bhdj->bhij", q * self.scale, k)
        attn = torch.softmax(at_least_f32(sim), dim=-1).to(x.dtype)
        out = torch.einsum("bhij,bhdj->bhdi", attn, v).reshape(b, -1, n)
        return self.to_out(out)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn, self.norm = fn, RMSNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x) + x


class Upsample(nn.Sequential):
    """Nearest x2, then a 3-wide conv."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"),
                         nn.Conv1d(dim, dim_out, 3, padding=1))


class Unet1D(nn.Module):
    """x [B, channels, L], optional ``x_self_cond`` of x's shape, t [B] ->
    [B, out_dim, L]."""

    def __init__(self, dim: int, init_dim: Optional[int] = None, out_dim: Optional[int] = None,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), channels: int = 3,
                 dropout: float = 0.0, self_condition: bool = False, condition: bool = False,
                 learned_variance: bool = False, learned_sinusoidal_cond: bool = False,
                 random_fourier_features: bool = False, learned_sinusoidal_dim: int = 16,
                 attn_dim_head: int = 32, attn_heads: int = 4):
        super().__init__()
        self.channels = channels
        self.two_inputs = self_condition or condition
        init_dim = init_dim or dim
        self.init_conv = nn.Conv1d(channels * (2 if self.two_inputs else 1), init_dim, 7,
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

        def res(d_in, d_out):
            return ResnetBlock(d_in, d_out, time_dim, dropout)

        def lin_attn(d):
            return Residual(PreNorm(d, LinearAttention1D(d, attn_heads, attn_dim_head)))

        dims = [init_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.downs = nn.ModuleList()
        for ind, (d_in, d_out) in enumerate(in_out):
            last = ind == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                res(d_in, d_in), res(d_in, d_in), lin_attn(d_in),
                nn.Conv1d(d_in, d_out, 3, padding=1) if last
                else nn.Conv1d(d_in, d_out, 4, stride=2, padding=1)]))
        mid = dims[-1]
        self.mid_block1 = res(mid, mid)
        self.mid_attn = Residual(PreNorm(mid, Attention1D(mid, attn_heads, attn_dim_head)))
        self.mid_block2 = res(mid, mid)
        self.ups = nn.ModuleList()
        for ind, (d_in, d_out) in enumerate(reversed(in_out)):
            last = ind == len(in_out) - 1
            self.ups.append(nn.ModuleList([
                res(d_out + d_in, d_out), res(d_out + d_in, d_out), lin_attn(d_out),
                nn.Conv1d(d_out, d_in, 3, padding=1) if last else Upsample(d_out, d_in)]))
        self.out_dim = out_dim or channels * (2 if learned_variance else 1)
        self.final_res_block = res(init_dim * 2, init_dim)
        self.final_conv = nn.Conv1d(init_dim, self.out_dim, 1)

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's (flax default) init, drawn from ``generator``
        (:func:`flax_init_`)."""
        flax_init_(self, generator)

    def forward(self, x: torch.Tensor, x_self_cond: Optional[torch.Tensor] = None,
                time: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.two_inputs:
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
            x = attn(block2(x, t))
            hs.append(x)
            x = down(x)
        x = self.mid_block2(self.mid_attn(self.mid_block1(x, t)), t)
        for block1, block2, attn, up in self.ups:
            x = block1(torch.cat([x, hs.pop()], dim=1), t)
            x = block2(torch.cat([x, hs.pop()], dim=1), t)
            x = up(attn(x))
        x = self.final_res_block(torch.cat([x, r], dim=1), t)
        return self.final_conv(x)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default init of ``module``'s layers, drawn from ``generator`` in
    module order: lecun-normal (truncated) kernels of convolutions,
    transposed convolutions and dense layers (fan-in: input channels times
    the window) with zero biases, RMSNorm gains of one, a learned
    sinusoid's weights N(0, 1)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            fan_in = w.shape[0] * w[0, 0].numel() if isinstance(m, nn.ConvTranspose2d) \
                else w[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, RMSNorm):
            nn.init.ones_(m.g)
        elif isinstance(m, RandomOrLearnedSinusoidalPosEmb):
            m.weights.normal_(0.0, 1.0, generator=generator)


# the reference's name ("2D" = the rank of its [B, C, L] input)
Unet2D = Unet1D
