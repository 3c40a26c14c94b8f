"""ShuffleNet-v2 units of the diffusion prior's U-Net, BatchNorm folded.

The PyTorch counterpart of the JAX ``ops/shuffle_pallas.py``:

- :func:`bn_affine`, :func:`fold_bottleneck_params` and
  :func:`fold_downsample_params` fold each unit's BatchNorms into its
  convolutions once, before a sampling chain;
- :func:`reference_bottleneck` and :func:`reference_downsample` are the
  plain PyTorch versions of the two units;
- :func:`fused_bottleneck` and :func:`fused_downsample` launch the
  hand-written CUDA kernels of ``csrc/shuffle_units.cu`` for CUDA tensors
  and run the plain versions for CPU tensors;
- :func:`bottleneck_plan` and :func:`downsample_plan` choose each kernel's
  tile of output pixels and its shared memory, the only place a tile is
  chosen; both rank tiles by one rule (:func:`_tile_plan`).

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
import functools
from typing import Dict, NamedTuple, Optional, Tuple

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


# Shared with csrc/shuffle_units.cu (kSmemLimit, kTargetBlocks, kStageBytes,
# kNBlock), which tests/test_torch_port_shuffle_plan.py holds to these values.
SMEM_LIMIT = 232_448        # bytes of shared memory a block may use on sm_90
TWO_BLOCKS_SMEM = 115_712   # the most that leaves room for two blocks on an SM
                            # (228 KB an SM, 1 KB of it reserved for each block)
TARGET_BLOCKS = 264         # two blocks on each of the H100's 132 SMs
HALO_AIMS = (1.5, 2.0)      # halo factors (TilePlan.halo) aimed at
MAX_HALO = HALO_AIMS[-1]
MAX_TILE = (32, 64)         # the largest th and tw tried
ROW_GRANULE = 32            # pixel rows of a warp's tile in the pointwise products
STAGE_BYTES = 16_384        # the pointwise products' k-chunk buffers of weights
N_BLOCK = 256               # columns of one pass of a pointwise product (8 warps x 32)


def pad_ld(c: int) -> int:
    """The kernel's row stride in floats for c channels: the smallest value
    >= c that is 4 modulo 8 (``pad_ld`` in csrc/shuffle_units.cu)."""
    c4 = -(-c // 4) * 4
    return c4 if c4 % 8 == 4 else c4 + 4


def bottleneck_smem(th: int, tw: int, ch: int, co2: int) -> int:
    """Bytes of shared memory a bottleneck block of a th x tw tile needs
    (``bottleneck_smem`` in csrc/shuffle_units.cu computes the same): the
    weights' k-chunk buffers, x2 and then t2 over the halo tile
    (th + 2) x (tw + 2), and u2 and then y2 over the tile, all f32 in rows
    of :func:`pad_ld` floats. A branch wider than ``N_BLOCK`` runs its
    products in passes that must not overwrite their input, so its block
    holds x2 and t2 apart over the halo tile, u2 over x2's, and y2 apart
    over the tile."""
    halo, tile = (th + 2) * (tw + 2), th * tw
    if max(ch, co2) > N_BLOCK:
        return STAGE_BYTES + 4 * (2 * halo * pad_ld(ch) + tile * pad_ld(co2))
    return STAGE_BYTES + 4 * (halo * pad_ld(ch) + tile * pad_ld(max(ch, co2)))


def downsample_smem(th: int, tw: int, c: int, co2: int) -> int:
    """Bytes of shared memory a downsample block of a th x tw tile of output
    pixels needs (``downsample_smem`` in csrc/shuffle_units.cu computes the
    same): the weights' k-chunk buffers, x and then t2 over the input halo
    tile (2th + 1) x (2tw + 1) in rows of ``pad_ld(max(c, co2))``, u1 over
    the tile at ``pad_ld(c)``, and u2 and then y2 over the tile at
    ``pad_ld(co2)``, all f32. A branch wider than ``N_BLOCK`` runs its
    products in passes that must not overwrite their input, so its block
    holds x (then u2) and t2 (then y2) apart over the halo tile, and u1 over
    the tile."""
    halo, tile, ld = (2 * th + 1) * (2 * tw + 1), th * tw, pad_ld(max(c, co2))
    if max(c, co2) > N_BLOCK:
        return STAGE_BYTES + 4 * (2 * halo * ld + tile * pad_ld(c))
    return STAGE_BYTES + 4 * (halo * ld + tile * (pad_ld(c) + pad_ld(co2)))


class TilePlan(NamedTuple):
    """A launch of one unit kernel: block (i, b) computes image b's output
    pixels [r0, r0 + th) x [c0, c0 + tw), clipped to the output grid, with
    all their channels, where (r0, c0) = ``tile(i)``; it reads the input
    pixels of its halo tile, ``halo_rows`` x ``halo_cols`` from
    (stride r0 - 1, stride c0 - 1), which a 3x3 depthwise convolution of
    padding 1 and this stride needs (1: the bottleneck, 2: the downsample)."""
    th: int
    tw: int
    tiles_h: int
    tiles_w: int
    smem: int
    blocks: int
    stride: int

    @property
    def halo_rows(self) -> int:
        return self.stride * self.th + 3 - self.stride

    @property
    def halo_cols(self) -> int:
        return self.stride * self.tw + 3 - self.stride

    @property
    def halo(self) -> float:
        """Branch 2's first pointwise product runs on the halo tile's
        pixels to give stride² th tw pixels' worth of outputs: this ratio."""
        return self.halo_rows * self.halo_cols / (self.stride ** 2 * self.th * self.tw)

    def tile(self, i: int) -> Tuple[int, int]:
        """(r0, c0) of tile i, as the kernel decodes blockIdx.x."""
        return (i // self.tiles_w) * self.th, (i % self.tiles_w) * self.tw

    def __str__(self) -> str:
        return (f"tile {self.th}x{self.tw} (halo {self.halo:.3f}), {self.smem} B, "
                f"{self.blocks} blocks")


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _tile_plan(b: int, ho: int, wo: int, stride: int, smem_of, what: str) -> TilePlan:
    """The tile rule of both kernels, on an output grid ho x wo; smem_of(th,
    tw) gives a block's bytes, ``what`` names the kernel in the error. Of
    every tile up to ``MAX_TILE`` that fits a block:

    1. rank them in tiers: those that leave room for two blocks on an SM
       with a halo factor of at most 1.5, then with at most 2
       (``HALO_AIMS``), then those of at most 2 that fit a block, then all;
    2. keep the tiles of at least ``TARGET_BLOCKS`` blocks of the first
       tier within the halo limit that has any; if none has, the first tier
       that is not empty;
    3. take the one whose pointwise products run the fewest pixel rows over
       the grid, counted in warp tiles of ``ROW_GRANULE`` rows (the halo
       tile once, the tile twice), ragged last tiles included; then the
       larger tile, then the wider.

    The kernels hold every intermediate in f32, so the tile is the same for
    f32 and bf16 activations. Raises ValueError when not even a 1 x 1 tile
    fits a block.
    """
    cands = []
    for th in range(1, min(ho, MAX_TILE[0]) + 1):
        for tw in range(1, min(wo, MAX_TILE[1]) + 1):
            smem = smem_of(th, tw)
            if smem <= SMEM_LIMIT:
                tiles_h, tiles_w = _ceil(ho, th), _ceil(wo, tw)
                cands.append(TilePlan(th, tw, tiles_h, tiles_w, smem, b * tiles_h * tiles_w,
                                      stride))
    if not cands:
        raise ValueError(f"no tile of {what} fits a block's shared memory")
    tiers = [[c for c in cands if c.smem <= TWO_BLOCKS_SMEM and c.halo <= aim]
             for aim in HALO_AIMS] + [[c for c in cands if c.halo <= MAX_HALO], cands]
    many = [[c for c in t if c.blocks >= TARGET_BLOCKS] for t in tiers[:-1]]
    pool = next((t for t in many if t), None) or next(t for t in tiers if t)

    def rows(c: TilePlan) -> int:
        g = ROW_GRANULE
        return c.blocks * (_ceil(c.halo_rows * c.halo_cols, g) + 2 * _ceil(c.th * c.tw, g)) * g
    return min(pool, key=lambda c: (rows(c), -c.th * c.tw, -c.tw))


@functools.lru_cache(maxsize=None)
def bottleneck_plan(b: int, h: int, w: int, ch: int, co2: int) -> TilePlan:
    """The bottleneck kernel's tile for x [b, h, w, 2ch] -> [b, h, w, 2co2]:
    :func:`_tile_plan` with :func:`bottleneck_smem`, halo (th + 2) x
    (tw + 2). The f32 kernel gets the two blocks an SM planned for; the bf16
    one, and any branch wider than ``N_BLOCK``, need more registers and get
    one (both are off every path). Raises ValueError when not even a 1 x 1
    tile fits a block (branches of about 2,800 channels)."""
    return _tile_plan(b, h, w, 1, lambda th, tw: bottleneck_smem(th, tw, ch, co2),
                      f"the bottleneck kernel at {ch} -> {co2} channels a branch")


@functools.lru_cache(maxsize=None)
def downsample_plan(b: int, h: int, w: int, c: int, co2: int) -> TilePlan:
    """The downsample kernel's tile for x [b, h, w, c] -> [b, ceil(h/2),
    ceil(w/2), 2co2]: :func:`_tile_plan` on the output grid with
    :func:`downsample_smem`, halo (2th + 1) x (2tw + 1), halo factor
    (2th + 1)(2tw + 1) / (4 th tw). Registers and blocks an SM as
    :func:`bottleneck_plan`'s. Raises ValueError when not even a 1 x 1 tile
    fits a block."""
    return _tile_plan(b, _ceil(h, 2), _ceil(w, 2), 2,
                      lambda th, tw: downsample_smem(th, tw, c, co2),
                      f"the downsample kernel at {c} -> {co2} channels")


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
        raise ValueError(f"{name}: this shape's tile needs more shared memory than a block "
                         "has, or than the bytes given")
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

    CUDA tensors go through the CUDA kernel, on the tile of
    :func:`bottleneck_plan`, which adds one to ``fused_bottleneck.launches``
    per call (and, in bf16, to ``.bf16_launches``); CPU tensors go through :func:`reference_bottleneck`. Any other
    device raises.
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
    plan = bottleneck_plan(b, h, w, ch, co2)
    out = torch.empty((b, h, w, 2 * co2), dtype=x.dtype, device=x.device)
    lib = _bind()
    fn = lib.shuffle_bottleneck_f32 if x.dtype == torch.float32 else lib.shuffle_bottleneck_bf16
    _launch(fn, "shuffle_bottleneck", x.data_ptr(), out.data_ptr(), _params(folded), b, h, w,
            ch, co2, plan.th, plan.tw, plan.smem, torch.cuda.current_stream(x.device).cuda_stream)
    fused_bottleneck.launches += 1
    fused_bottleneck.bf16_launches += x.dtype == torch.bfloat16
    return out


fused_bottleneck.launches = 0
fused_bottleneck.bf16_launches = 0        # the launches of the bf16 instantiation


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

    CUDA tensors go through the CUDA kernel, on the tile of
    :func:`downsample_plan`, which adds one to ``fused_downsample.launches``
    per call (and, in bf16, to ``.bf16_launches``); CPU tensors go through :func:`reference_downsample`. Any other
    device raises.
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
    plan = downsample_plan(b, h, w, c, co2)
    out = torch.empty((b, (h + 1) // 2, (w + 1) // 2, 2 * co2), dtype=x.dtype, device=x.device)
    lib = _bind()
    fn = lib.shuffle_downsample_f32 if x.dtype == torch.float32 else lib.shuffle_downsample_bf16
    _launch(fn, "shuffle_downsample", x.data_ptr(),
            None if t_vec is None else t_vec.data_ptr(), out.data_ptr(), _params(folded),
            b, h, w, c, co2, plan.th, plan.tw, plan.smem,
            torch.cuda.current_stream(x.device).cuda_stream)
    fused_downsample.launches += 1
    fused_downsample.bf16_launches += x.dtype == torch.bfloat16
    return out


fused_downsample.launches = 0
fused_downsample.bf16_launches = 0        # the launches of the bf16 instantiation


def _bind() -> ctypes.CDLL:
    """The kernel library with its C signatures declared."""
    lib = library("shuffle_units")
    if not getattr(lib, "_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.shuffle_bottleneck_f32, lib.shuffle_bottleneck_bf16):
            fn.argtypes = [ptr, ptr, ptr] + [i32] * 8 + [ptr]
            fn.restype = i32
        for fn in (lib.shuffle_downsample_f32, lib.shuffle_downsample_bf16):
            fn.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 8 + [ptr]
            fn.restype = i32
        lib._bound = True
    return lib
