"""The posterior kernels' (B6/B7, ``csrc/discrete_posterior.cu``) algorithms,
checked on the CPU where the kernel cannot run:

- the top-r select by 8-bit digits, written here as a plain mirror of the
  kernel's (torch on uint32 keys held in int64), gives the key of
  ``torch.topk(ev, k).values[..., -1]`` and of the JAX kernel's
  ``_kth_largest_key`` (32 one-bit passes), ties, clamped rows and -0.0
  included;
- Philox4x32-10 computed once a block, its four words spread over columns
  4j..4j+3 by the kernel's lane layout, equals ``philox_bits`` bit for bit;
- the widest row the wrappers pass is the widest the kernel takes, which
  the .cu holds to a block's shared memory by a ``static_assert`` (the
  launch itself, 4 rows a block and the span copy, is the kernel's alone
  and is checked on the card at unaligned and partial-block shapes);
- ``utils.profiling.posterior_bound`` at the paths' shapes.

One ``jax.jit`` per JAX reference, at the shapes below (at most 1025
classes and a few dozen rows).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_vae_gan_diffusion_torch.ops import discrete_posterior as tp
from vq_vae_gan_diffusion_torch.utils.profiling import (F32_PEAK_FLOPS, SFU_PEAK_PER_S,
                                                        posterior_bound)
from vq_vae_gan_diffusion_tpu.ops import discrete_posterior_pallas as jp

_U32 = 0xFFFFFFFF
SRC = Path(tp.__file__).resolve().parent.parent / "csrc" / "discrete_posterior.cu"
H100 = "NVIDIA H100 80GB HBM3"


def monotone_key(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving uint32 key of f32 values, in int64;
    -0.0 takes +0.0's key."""
    u = torch.where(x == 0, torch.zeros_like(x), x).view(torch.int32).to(torch.int64) & _U32
    return torch.where(u >> 31 == 1, ~u & _U32, u | 0x80000000)


def digit_select(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest key of each row of ``keys`` [R, K] (uint32 in int64)
    as the kernel finds it: four passes of 8-bit digits, most significant
    first, each a 256-bin histogram of the keys matching the digits chosen
    so far, then the digit where the count from the top reaches k."""
    rows = keys.shape[0]
    prefix = torch.zeros(rows, dtype=torch.int64)
    kk = torch.full((rows,), k, dtype=torch.int64)
    for shift in (24, 16, 8, 0):
        above = 0 if shift == 24 else (_U32 << (shift + 8)) & _U32
        cand = ((keys ^ prefix[:, None]) & above) == 0
        digit = (keys >> shift) & 255
        hist = torch.zeros(rows, 256, dtype=torch.int64).scatter_add_(1, digit, cand.long())
        from_top = hist.flip(1).cumsum(1)                # keys with digit >= 255 - j
        j = (from_top >= kk[:, None]).long().argmax(1)
        chosen = 255 - j
        kk = kk - (from_top.gather(1, j[:, None])[:, 0] - hist.gather(1, chosen[:, None])[:, 0])
        prefix = prefix | (chosen << shift)
    return prefix


def _rows(k: int) -> torch.Tensor:
    """ev-like rows [6, K] in [-70, 0]: random with clamped entries and
    repeats, every class tied at -70, -0.0 against +0.0, all tied at 0."""
    rs = np.random.RandomState(k)
    ev = np.clip(rs.standard_normal((6, k)).astype(np.float32) * 30 - 20, -70, 0)
    ev[1] = np.round(ev[1] / 4) * 4                        # many ties
    ev[2] = -70.0
    ev[3, ::2], ev[3, 1::2] = -0.0, 0.0
    ev[4] = 0.0
    ev[5, : k // 2] = -3.5
    return torch.from_numpy(ev)


@pytest.fixture(scope="module")
def jax_kth():
    """JAX's radix select under one jit per (K, k)."""
    fn = jax.jit(lambda nm, last, k: jp._kth_largest_key(nm, last, k), static_argnums=2)

    def run(ev: np.ndarray, k: int) -> np.ndarray:
        nm = jp._monotone_key(jnp.asarray(ev[:, :-1]))
        last = jp._monotone_key(jnp.asarray(ev[:, -1:]))
        return np.asarray(fn(nm, last, k))[:, 0].astype(np.int64)
    return run


# (K, trunc_k): k in {1, 2, 881, K-1, K} where it is a top-r of K classes, up
# to the widest row the kernel takes
SELECT_CASES = sorted({(kc, k) for kc in (2, 17, 1024, 1025, tp.MAX_CLASSES)
                       for k in (1, 2, 881, kc - 1, kc) if 1 <= k <= kc})


@pytest.mark.parametrize("k_classes,k", SELECT_CASES)
def test_digit_select_is_the_kth_largest_key(k_classes, k, jax_kth):
    ev = _rows(k_classes)
    got = digit_select(monotone_key(ev), k)
    want = monotone_key(torch.topk(ev, k, dim=-1).values[:, -1])
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), jax_kth(ev.numpy(), k))
    # the mask rule keeps k classes or more, ties at the threshold included
    kept = (monotone_key(ev) >= got[:, None]).sum(-1)
    assert bool((kept >= k).all())


def test_digit_select_ties_at_zero():
    """-0.0 and +0.0 share one key, so a row of both is one tie."""
    ev = torch.tensor([[-0.0, 0.0, -1.0, -0.0, 0.0]])
    key0 = int(monotone_key(torch.tensor([0.0]))[0])
    for k in range(1, 5):
        assert int(digit_select(monotone_key(ev), k)[0]) == key0
    assert int(digit_select(monotone_key(ev), 5)[0]) == int(monotone_key(torch.tensor([-1.0]))[0])


def test_key_decodes_to_its_value():
    """The kernel reads ev back from its key (key_float): every value but
    -0.0 round-trips exactly, -0.0 comes back as +0.0."""
    ev = _rows(1025).flatten()
    key = monotone_key(ev)
    u = torch.where(key >> 31 == 1, key & 0x7FFFFFFF, ~key & _U32)
    back = u.to(torch.int32).view(torch.float32)
    assert torch.equal(back, torch.where(ev == 0, torch.zeros_like(ev), ev))


@pytest.mark.parametrize("k", [2, 5, 1024, 1025, 2048])
def test_philox_once_a_block_matches_the_stream(k):
    """Lane l computes Philox blocks l, l + 32, ... once each and takes
    columns 4g..4g+3 of block g: the bits equal ``philox_bits``, and every
    column is drawn exactly once."""
    seeds = torch.tensor([[123, -7], [2 ** 31 - 1, -2 ** 31]], dtype=torch.int32)
    n = 3
    want = tp.philox_bits(seeds, n, k)
    key = seeds.to(torch.int64) & _U32
    got = torch.full((2, n, k), -1, dtype=torch.int64)
    drawn = torch.zeros(k, dtype=torch.int64)
    for lane in range(32):
        for g in range(lane, (k + 3) // 4, 32):
            words = tp.philox4x32((torch.tensor(g), torch.arange(n)[None, :], torch.tensor(0),
                                   torch.tensor(0)), (key[:, 0, None], key[:, 1, None]))
            for j, w in enumerate(words):
                if 4 * g + j < k:
                    got[:, :, 4 * g + j] = torch.broadcast_to(w, (2, n))
                    drawn[4 * g + j] += 1
    assert bool((drawn == 1).all())
    assert torch.equal(got, want)


def test_cuda_source_takes_the_widest_row_the_wrappers_pass():
    """The wrappers refuse rows wider than ``MAX_CLASSES``; the kernel takes
    every row up to its ``kMaxClasses`` and asserts at compile time that a
    block of those rows fits its shared memory."""
    src = SRC.read_text()
    assert int(re.search(r"constexpr int kMaxClasses = (\d+);", src).group(1)) == tp.MAX_CLASSES
    assert "static_assert(posterior_smem(kMaxClasses, 4, false, true) <= kSmemLimit" in src


@pytest.mark.parametrize("km1,dtype,prng,trunc_k,by_bytes,by_ops", [
    (1023, torch.float32, False, 0, 0.0100311116, 0.0040064993),
    (1023, torch.float32, False, 881, 0.0100311116, 0.0040064993),
    (1023, torch.bfloat16, False, 0, 0.0075294949, 0.0040064993),
    (1024, torch.float32, True, 0, 0.0050279164, 0.0060156179),
    (1024, torch.float32, True, 881, 0.0050279164, 0.0060156179),
    (1024, torch.float32, False, 881, 0.0100408931, 0.0040104119),
])
def test_posterior_bound_at_the_path_shapes(km1, dtype, prng, trunc_k, by_bytes, by_ops):
    """[16, 256] rows: B6 at VQ_Official's 1023 logits is bound by bytes,
    B7 at the transformer's 1024 by the SFU's transcendentals; the select's
    operations stay below either."""
    got = posterior_bound(16, 256, km1, dtype, prng, trunc_k, H100)
    assert got == pytest.approx((by_bytes, by_ops), rel=1e-7)   # the values to 10 places
    rows, k = 16 * 256, km1 + 1
    es = 4 if dtype == torch.float32 else 2
    bytes_ = rows * (km1 * es + 16) + 16 * 40 + (16 * 8 if prng else rows * k * 4)
    sfu = rows * k * (4 + (2 if prng else 0))
    ops = rows * k * (30 + (15 if prng else 0) + (19 if trunc_k else 0))
    assert got[0] == pytest.approx(1e3 * bytes_ / 3.35e12)
    assert got[1] == pytest.approx(1e3 * max(sfu / SFU_PEAK_PER_S, ops / F32_PEAK_FLOPS))
    assert SFU_PEAK_PER_S == pytest.approx(F32_PEAK_FLOPS / 16)
