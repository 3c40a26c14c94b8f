"""BN-folded inference forward of :class:`.unet_shuffle.ShuffleUNet` through
the hand-written CUDA units (PyTorch counterpart of the JAX
``models/shuffle_infer.py``).

The DDPM chain calls the U-Net once per reverse step. :func:`fold_unet`
folds every BatchNorm into its convolution once per chain, and
:func:`apply_folded` runs the forward in NHWC (the kernels want channels
contiguous):

- every ResidualBottleneck -> ``ops.shuffle.fused_bottleneck`` (one launch);
- every ResidualDownsample -> ``ops.shuffle.fused_downsample`` (one launch),
  odd grids included (the JAX package keeps plain ops there; the kernel
  computes the same ceil(H/2) x ceil(W/2) output);
- the init conv, time embedding and TimeMLP, bilinear resize, concat and
  final 1x1 conv are plain torch ops.

The wrappers launch the kernels for CUDA tensors and run their plain
versions for CPU tensors, so the same forward serves the CPU tests.

``fused_sampler`` values: every truthy value (``True``, ``"on"``,
``"pallas"``, ``"packed"``) selects this kernel route and every falsy one
the unfused ``ShuffleUNet`` module. This differs from the JAX package in
one place: there ``True`` resolves to the plain folded XLA path unless the
caller passes ``default_tpu_mode``. The port has no mode that runs the plain
folded version on the card: ``pallas`` (v1 unit) and ``packed`` (lane-packed
TPU unit) compute the same function, which is one CUDA kernel here.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.shuffle import (bn_affine, fold_bottleneck_params, fold_downsample_params,
                           fused_bottleneck, fused_downsample)
from .unet_shuffle import ShuffleUNet, upsample_to

_OFF = ("off", "false", "none", "0", "")


def resolve_sampler_mode(mode: Any) -> bool:
    """A config's ``fused_sampler`` -> True (the kernel route) or False (the
    unfused module)."""
    m = str(mode).lower()
    if m in _OFF:
        return False
    if m == "chain" or m.startswith("auto"):
        raise ValueError(f"fused_sampler={mode!r} was removed from the JAX package in "
                         "round 4; use 'packed', 'pallas', True or False")
    return True


@torch.no_grad()
def _fold_time_mlp(mlp, dtype) -> List[torch.Tensor]:
    fc1, fc2 = mlp.mlp[0], mlp.mlp[2]
    return [v.to(dtype) for v in (fc1.weight.T, fc1.bias, fc2.weight.T, fc2.bias)]


@torch.no_grad()
def fold_unet(unet: ShuffleUNet, dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Fold every BatchNorm of ``unet`` (eval statistics) into its conv, once,
    on ``unet``'s device, in ``dtype``."""
    conv, bn = unet.init_conv.module[0], unet.init_conv.module[1]
    s, t = bn_affine(bn)
    return {
        "dtype": dtype,
        "init": ((conv.weight * s[:, None, None, None]).to(dtype),
                 (conv.bias * s + t).to(dtype)),
        "temb": unet.time_embedding.weight.to(dtype),
        "enc": [{"units": [fold_bottleneck_params(u, dtype) for u in blk.conv0],
                 "time": _fold_time_mlp(blk.time_mlp, dtype),
                 "down": fold_downsample_params(blk.conv1, dtype)}
                for blk in unet.encoder_blocks],
        "mid": [fold_bottleneck_params(u, dtype) for u in unet.mid_block],
        "dec": [{"units": [fold_bottleneck_params(u, dtype) for u in blk.conv0],
                 "time": _fold_time_mlp(blk.time_mlp, dtype),
                 "last": fold_bottleneck_params(blk.conv1, dtype)}
                for blk in unet.decoder_blocks],
        "final": (unet.final_conv.weight[:, :, 0, 0].T.to(dtype).contiguous(),
                  unet.final_conv.bias.to(dtype)),
    }


def unet_unit_shapes(h: int, w: int, base: int = 64,
                     mults: Tuple[int, ...] = (1, 2, 4, 8)) -> List[Tuple[str, int, int, int, int]]:
    """(kernel, H, W, C_in, C_out) of every ShuffleNet unit of one forward of a
    ``ShuffleUNet`` on an [B, h, w, C] input, in order: each encoder block 4
    bottlenecks ("K1") and a downsample ("K2", which halves H and W,
    rounding up), 3 mid bottlenecks, each decoder block 5 bottlenecks on the
    upsampled input concatenated with its skip."""
    dims = [base] + [base * m for m in mults]
    pairs = list(zip(dims[:-1], dims[1:]))
    units, skips, c = [], [], base
    for _, c_out in pairs:
        units += [("K1", h, w, c, c)] * 3 + [("K1", h, w, c, c_out // 2),
                                             ("K2", h, w, c_out // 2, c_out)]
        skips.append((h, w, c_out // 2))
        h, w, c = (h + 1) // 2, (w + 1) // 2, c_out
    units += [("K1", h, w, c, c)] * 2 + [("K1", h, w, c, c // 2)]
    c //= 2
    for c_in, _ in reversed(pairs):
        h, w, skip = skips.pop()
        c += skip
        units += [("K1", h, w, c, c)] * 3 + [("K1", h, w, c, c // 2),
                                             ("K1", h, w, c // 2, c_in // 2)]
        c = c_in // 2
    return units


def _time_mlp(x: torch.Tensor, t_emb: torch.Tensor, p: List[torch.Tensor]) -> torch.Tensor:
    w1, b1, w2, b2 = p
    h = F.silu(t_emb @ w1 + b1) @ w2 + b2
    return F.silu(x + h[:, None, None, :])


def _chain(x: torch.Tensor, units) -> torch.Tensor:
    for u in units:
        x = fused_bottleneck(x, u)
    return x


@torch.no_grad()
def apply_folded(folded: Dict[str, Any], x: torch.Tensor,
                 t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward of ``ShuffleUNet`` in eval mode: x [B, H, W, Cin] NHWC,
    t [B] int -> [B, H, W, Cout], in the folded dtype."""
    ki, bi = folded["init"]
    x = x.to(folded["dtype"])
    x = F.silu(F.conv2d(x.permute(0, 3, 1, 2), ki, bi, padding=1))
    x = x.permute(0, 2, 3, 1).contiguous()
    t_emb = None if t is None else folded["temb"][t]

    shortcuts = []
    for blk in folded["enc"]:
        x = _chain(x, blk["units"])
        shortcuts.append(x)
        if t_emb is not None:
            x = _time_mlp(x, t_emb, blk["time"])
        x = fused_downsample(x, blk["down"])
    x = _chain(x, folded["mid"])
    for blk in folded["dec"]:
        sc = shortcuts.pop()
        up = upsample_to(x.permute(0, 3, 1, 2), sc.shape[1:3]).permute(0, 2, 3, 1)
        x = _chain(torch.cat([up, sc], -1), blk["units"])
        if t_emb is not None:
            x = _time_mlp(x, t_emb, blk["time"])
        x = fused_bottleneck(x, blk["last"])
    wf, bf = folded["final"]
    return x @ wf + bf
