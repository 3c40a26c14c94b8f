"""The least time of one call of kernel B6, the fused posterior-and-sample
step of the discrete chain, with its noise read from memory and no top-r
cut: the byte and operation counts of the port's
``utils/profiling.posterior_bound``, kept with the benchmark."""

from __future__ import annotations

from typing import Tuple

from .yardstick import F32_PEAK_FLOPS, hbm_bytes_per_s

_BYTES = {"float32": 4, "bfloat16": 2}
# f32 operations a class of a row: the two max and two sum-exp passes, the
# clamps, the two log-add-exps and the selects, the score and the argmax
POSTERIOR_OPS = 30
# transcendentals a class (three expf, one log1pf), on the SFU, which issues
# 16 a clock an SM against the 128 f32 lanes that F32_PEAK_FLOPS counts twice
POSTERIOR_SFU = 4
SFU_PEAK_PER_S = F32_PEAK_FLOPS / 2 / 8


def posterior_bound(b: int, n: int, km1: int, dtype: str, name: str) -> Tuple[float, float]:
    """(ms by bytes, ms by operations) of one call on [b, n] rows of
    K = km1 + 1 classes: the logits in ``dtype`` and the f32 Gumbel noise
    [b, n, K] read once, the int64 carry read and the int64 indices written
    once, the [b, 10] f32 coefficients read once, over the memory rate of
    the card ``name``; POSTERIOR_OPS a class over the f32 peak, or
    POSTERIOR_SFU over the SFU's rate, the longer (the two pipes issue side
    by side)."""
    k, rows = km1 + 1, b * n
    bytes_ = rows * (km1 * _BYTES[dtype] + 16) + b * 40 + rows * k * 4
    ops, sfu = rows * k * POSTERIOR_OPS, rows * k * POSTERIOR_SFU
    return 1e3 * bytes_ / hbm_bytes_per_s(name), 1e3 * max(ops / F32_PEAK_FLOPS,
                                                           sfu / SFU_PEAK_PER_S)
