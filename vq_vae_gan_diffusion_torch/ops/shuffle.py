"""ShuffleNet-v2 units of the diffusion prior's U-Net, BatchNorm folded.

The PyTorch counterpart of the JAX ``ops/shuffle_pallas.py``:

- :func:`bn_affine`, :func:`fold_bottleneck_params` and
  :func:`fold_downsample_params` fold each unit's BatchNorms into its
  convolutions once, before a sampling chain;
- :func:`reference_bottleneck` and :func:`reference_downsample` are the
  plain PyTorch versions of the two units;
- :func:`fused_bottleneck` and :func:`fused_downsample` launch the
  hand-written CUDA kernels of ``csrc/shuffle_units.cu`` for CUDA tensors
  and run the plain versions for CPU tensors.

Tensors are NHWC, channels contiguous, as in the JAX package. A folded unit
is a dict of tensors in the activations' dtype::

    k1 [3, 3, C1]  b1 [C1]    branch-1 depthwise (+BN)
    w1 [C1, co2]   c1 [co2]   branch-1 pointwise (+BN, SiLU after)
    w2 [C2, M]     c2 [M]     branch-2 pointwise 1 (+BN, SiLU after)
    k2 [3, 3, M]   b2 [M]     branch-2 depthwise (+BN)
    w3 [M, co2]    c3 [co2]   branch-2 pointwise 2 (+BN, SiLU after)

For a bottleneck of input width 2ch, C1 = C2 = M = ch and the unit splits
its input into halves; for a downsample of input width C, C1 = C2 = C,
M = co2 and the depthwise convolutions have stride 2. Both units write the
channel-shuffled output ``out[..., 2i] = branch1[i]``,
``out[..., 2i+1] = branch2[i]``.

Not ported: ``pick_group``, ``pack_images``, ``unpack_images`` and the
packed folds. They pack G images into the 128 lanes of a TPU vector
register, which a GPU does not have; the CUDA kernels take plain NHWC
tensors, and the next unit reads the shuffled output's halves as its
x1 / x2 with no layout op between units.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ._build import library

Folded = Dict[str, torch.Tensor]
_ORDER = ("k1", "b1", "w1", "c1", "w2", "c2", "k2", "b2", "w3", "c3")


@torch.no_grad()
def bn_affine(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm as (scale, shift): y = x * scale + shift."""
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return scale, bn.bias - bn.running_mean * scale


@torch.no_grad()
def _fold_dw(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    s, t = bn_affine(bn)
    k = conv.weight[:, 0].permute(1, 2, 0)                     # [C, 1, 3, 3] -> [3, 3, C]
    return k * s, conv.bias * s + t


@torch.no_grad()
def _fold_pw(cbs) -> Tuple[torch.Tensor, torch.Tensor]:
    conv, bn = cbs.module[0], cbs.module[1]
    s, t = bn_affine(bn)
    return conv.weight[:, :, 0, 0].T * s, conv.bias * s + t    # [Cin, Cout]


@torch.no_grad()
def fold_bottleneck_params(unit, dtype: Optional[torch.dtype] = None) -> Folded:
    """A ``models.unet_shuffle`` ResidualBottleneck (or ResidualDownsample,
    whose modules have the same names) -> the kernels' folded dict."""
    k1, b1 = _fold_dw(unit.branch1[0], unit.branch1[1])
    w1, c1 = _fold_pw(unit.branch1[2])
    w2, c2 = _fold_pw(unit.branch2[0])
    k2, b2 = _fold_dw(unit.branch2[1], unit.branch2[2])
    w3, c3 = _fold_pw(unit.branch2[3])
    out = dict(k1=k1, b1=b1, w1=w1, c1=c1, w2=w2, c2=c2, k2=k2, b2=b2, w3=w3, c3=c3)
    return {k: v.to(dtype or v.dtype).contiguous() for k, v in out.items()}


fold_downsample_params = fold_bottleneck_params


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and held in f32: an operand or a result in
    ``dtype``."""
    return x.to(dtype).float()


def _dw(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """Depthwise 3x3, zero padding 1, on NHWC f32: nine shifted products."""
    h, w = (x.shape[1] - 1) // stride + 1, (x.shape[2] - 1) // stride + 1
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = sum(xp[:, dy:dy + stride * h:stride, dx:dx + stride * w:stride, :] * k[dy, dx]
              for dy in range(3) for dx in range(3))
    return acc + b


def _unit(x1: torch.Tensor, x2: torch.Tensor, p: Folded, stride: int,
          dtype: torch.dtype) -> torch.Tensor:
    f = {k: v.float() for k, v in p.items()}
    u1 = _round(_dw(x1, f["k1"], f["b1"], stride), dtype)
    y1 = _round(_silu(u1 @ f["w1"] + f["c1"]), dtype)
    t2 = _round(_silu(x2 @ f["w2"] + f["c2"]), dtype)
    u2 = _round(_dw(t2, f["k2"], f["b2"], stride), dtype)
    y2 = _round(_silu(u2 @ f["w3"] + f["c3"]), dtype)
    return torch.stack([y1, y2], -1).flatten(-2).to(dtype)


@torch.no_grad()
def reference_bottleneck(x: torch.Tensor, p: Folded) -> torch.Tensor:
    """The plain PyTorch bottleneck; same contract as :func:`fused_bottleneck`."""
    ch = x.shape[-1] // 2
    xf = x.float()
    return _unit(xf[..., :ch], xf[..., ch:], p, 1, x.dtype)


@torch.no_grad()
def reference_downsample(x: torch.Tensor, p: Folded,
                         t_vec: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch downsample; same contract as :func:`fused_downsample`."""
    xf = x.float()
    if t_vec is not None:
        xf = _round(_silu(xf + t_vec.float()[:, None, None, :]), x.dtype)
    return _unit(xf, xf, p, 2, x.dtype)


def _check_cuda_args(x: torch.Tensor, p: Folded, shapes: Dict[str, tuple],
                     extra: Dict[str, torch.Tensor]) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for key, shape in shapes.items():
        t = p[key]
        if tuple(t.shape) != shape or t.dtype != x.dtype:
            raise ValueError(f"folded[{key!r}] must be {x.dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in [("x", x)] + [(k, p[k]) for k in _ORDER] + list(extra.items()):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(fn, name: str, *args) -> None:
    err = fn(*args)
    if err == -1:
        raise ValueError(f"{name}: a row of this shape needs more shared memory than a block has")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _params(p: Folded):
    return (ctypes.c_void_p * len(_ORDER))(*[p[k].data_ptr() for k in _ORDER])


def fused_bottleneck(x: torch.Tensor, folded: Folded) -> torch.Tensor:
    """One ResidualBottleneck at inference.

    Args:
      x: [B, H, W, 2ch] NHWC, f32 or bf16; x[..., :ch] feeds branch 1 and
        x[..., ch:] branch 2.
      folded: from :func:`fold_bottleneck_params`, in x's dtype.

    Returns [B, H, W, 2co2] in x's dtype, channel-shuffled.

    CUDA tensors go through the CUDA kernel, which adds one to
    ``fused_bottleneck.launches`` per call; CPU tensors go through
    :func:`reference_bottleneck`. Any other device raises.
    """
    if x.device.type == "cpu":
        return reference_bottleneck(x, folded)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck runs on cuda or cpu, not {x.device}")
    if x.dim() != 4 or x.shape[-1] % 2:
        raise ValueError(f"x must be [B, H, W, 2ch], got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    ch, co2 = cin // 2, folded["w1"].shape[-1]
    _check_cuda_args(x, folded, {
        "k1": (3, 3, ch), "b1": (ch,), "w1": (ch, co2), "c1": (co2,), "w2": (ch, ch),
        "c2": (ch,), "k2": (3, 3, ch), "b2": (ch,), "w3": (ch, co2), "c3": (co2,)}, {})
    out = torch.empty((b, h, w, 2 * co2), dtype=x.dtype, device=x.device)
    lib = _bind()
    fn = lib.shuffle_bottleneck_f32 if x.dtype == torch.float32 else lib.shuffle_bottleneck_bf16
    _launch(fn, "shuffle_bottleneck", x.data_ptr(), out.data_ptr(), _params(folded), b, h, w,
            ch, co2, torch.cuda.current_stream(x.device).cuda_stream)
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0


def fused_downsample(x: torch.Tensor, folded: Folded,
                     t_vec: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One stride-2 ResidualDownsample at inference.

    Args:
      x: [B, H, W, C] NHWC, f32 or bf16.
      folded: from :func:`fold_downsample_params`, in x's dtype.
      t_vec: optional [B, C] in x's dtype: the unit then reads
        silu(x + t_vec[:, None, None, :]), with its zero padding kept (the
        JAX packed kernel's TimeMLP prologue).

    Returns [B, ceil(H/2), ceil(W/2), 2co2] in x's dtype, channel-shuffled
    (a stride-2 3x3 convolution with padding 1, odd grids included).

    CUDA tensors go through the CUDA kernel, which adds one to
    ``fused_downsample.launches`` per call; CPU tensors go through
    :func:`reference_downsample`. Any other device raises.
    """
    if x.device.type == "cpu":
        return reference_downsample(x, folded, t_vec)
    if x.device.type != "cuda":
        raise ValueError(f"fused_downsample runs on cuda or cpu, not {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    co2 = folded["w1"].shape[-1]
    extra = {}
    if t_vec is not None:
        if tuple(t_vec.shape) != (b, c) or t_vec.dtype != x.dtype:
            raise ValueError(f"t_vec must be {x.dtype} [{b}, {c}], got "
                             f"{t_vec.dtype} {tuple(t_vec.shape)}")
        extra["t_vec"] = t_vec
    _check_cuda_args(x, folded, {
        "k1": (3, 3, c), "b1": (c,), "w1": (c, co2), "c1": (co2,), "w2": (c, co2),
        "c2": (co2,), "k2": (3, 3, co2), "b2": (co2,), "w3": (co2, co2), "c3": (co2,)}, extra)
    out = torch.empty((b, (h + 1) // 2, (w + 1) // 2, 2 * co2), dtype=x.dtype, device=x.device)
    lib = _bind()
    fn = lib.shuffle_downsample_f32 if x.dtype == torch.float32 else lib.shuffle_downsample_bf16
    _launch(fn, "shuffle_downsample", x.data_ptr(),
            None if t_vec is None else t_vec.data_ptr(), out.data_ptr(), _params(folded),
            b, h, w, c, co2, torch.cuda.current_stream(x.device).cuda_stream)
    fused_downsample.launches += 1
    return out


fused_downsample.launches = 0


def _bind() -> ctypes.CDLL:
    """The kernel library with its C signatures declared."""
    lib = library("shuffle_units")
    if not getattr(lib, "_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.shuffle_bottleneck_f32, lib.shuffle_bottleneck_bf16):
            fn.argtypes = [ptr, ptr, ptr] + [i32] * 5 + [ptr]
            fn.restype = i32
        for fn in (lib.shuffle_downsample_f32, lib.shuffle_downsample_bf16):
            fn.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 5 + [ptr]
            fn.restype = i32
        lib._bound = True
    return lib
