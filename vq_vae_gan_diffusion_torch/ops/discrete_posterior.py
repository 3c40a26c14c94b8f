"""One reverse step of the discrete VQ-diffusion sampler, fused: raw denoiser
logits -> log_softmax and clamp -> q-posterior on the one-hot carry ->
Gumbel-argmax sample (PyTorch counterpart of the JAX
``ops/discrete_posterior_pallas.py``).

- :func:`gather_posterior_coefs` gathers the ten per-row schedule scalars
  on the device (no host sync);
- :func:`posterior_log_probs`, :func:`posterior_scores` and
  :func:`reference_posterior_sample` are the plain PyTorch version of the
  kernel body (``_posterior_body``), truncated top-r branch included;
- :func:`philox4x32` (Philox4x32-10 in int64 arithmetic) and
  :func:`gumbel_from_bits` define the in-kernel noise of the ``prng``
  variant, and :func:`reference_posterior_sample_prng` draws the same bits
  as the kernel before it runs the plain body;
- :func:`fused_posterior_sample` and :func:`fused_posterior_sample_prng`
  launch the hand-written CUDA kernel of ``csrc/discrete_posterior.cu`` for
  CUDA tensors and run the plain versions for CPU tensors.

Shapes: logits [B, N, K-1] f32 or bf16 (computed in f32); x_t [B, N]
integer, the carry, where K-1 is the mask class; coefs [B, 10] f32; gumbel
[B, N, K] f32 or seeds [B, 2] int32; the result is [B, N] int64.

The ``prng`` stream: for batch row b, position n and column c, the 32 bits
are word ``c % 4`` of Philox4x32-10 with counter (c // 4, n, 0, 0) and key
(seeds[b, 0], seeds[b, 1]) as uint32; the uniform is ``(bits >> 8) *
2**-24``. The JAX package draws its ``prng`` noise from the TPU's own
generator, so the two agree in distribution only.

Not ported, by design: ``fits_vmem`` and the 16-column coefficient padding.
They budget the TPU's VMEM and SMEM; the CUDA kernel gives each (b, n) row
to one warp and takes any N, and any K up to 2048.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ._build import library

LOG_EPS = -70.0
LOG_ZERO = float(np.log(1e-30))     # _LZ of the kernel: log(1e-30) rounded to f32 when used
MASKED = -3e38                      # the score of a class cut by the top-r threshold
MAX_CLASSES = 2048                  # the widest row (K) the CUDA kernel takes

_U32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def gather_posterior_coefs(sched: NamedTuple, t_post: torch.Tensor,
                           num_timesteps: int) -> torch.Tensor:
    """[B] timesteps -> [B, 10] f32 per-row schedule scalars: at t_post
    log ᾱ, log β̄, log γ̄, log α, log β, log γ; at t_post - 1, with the
    (t + T + 1) mod (T + 1) wraparound (t_post 0 reads the padding entry T),
    log ᾱ, log β̄, log γ̄, log(1 - γ̄). ``sched`` lies on t_post's device."""
    s = sched
    tm1 = (t_post - 1 + num_timesteps + 1) % (num_timesteps + 1)
    return torch.stack([
        s.log_cumprod_at[t_post], s.log_cumprod_bt[t_post], s.log_cumprod_ct[t_post],
        s.log_at[t_post], s.log_bt[t_post], s.log_ct[t_post],
        s.log_cumprod_at[tm1], s.log_cumprod_bt[tm1], s.log_cumprod_ct[tm1],
        s.log_1_min_cumprod_ct[tm1]], dim=1).float()


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms: ``-log(-log(u + 1e-30) + 1e-30)``, the one
    definition every sampling route uses (the routes sample the same indices
    from the same uniforms only through it)."""
    return -torch.log(-torch.log(u + 1e-30) + 1e-30)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 random bits (in an int64 tensor) -> Gumbel noise, through a
    24-bit uniform ``(bits >> 8) * 2**-24`` on [0, 1)."""
    return gumbel_from_uniform((bits >> 8).to(torch.float32) * 2.0 ** -24)


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product a * m, for a in
    [0, 2^32) held in int64: m is split at bit 16 so that no partial product
    leaves int64."""
    p1, p0 = a * (m >> 16), a * (m & 0xFFFF)
    t = ((p1 & 0xFFFF) << 16) + p0
    return (p1 >> 16) + (t >> 32), t & _U32


def philox4x32(counter, key) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 (Salmon et al., SC'11; the Random123 definition).
    ``counter`` is four and ``key`` two int64 tensors (broadcastable) of
    values in [0, 2^32); returns the four output words the same way."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_bits(seeds: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The kernel's random bits [B, N, K] (int64 holding uint32) for
    ``seeds`` [B, 2]: word c % 4 of Philox4x32-10 at counter (c // 4, n, 0,
    0) and key (seeds[b, 0], seeds[b, 1])."""
    dev = seeds.device
    key = seeds.to(torch.int64) & _U32
    k0, k1 = key[:, 0, None, None], key[:, 1, None, None]
    groups = torch.arange((k + 3) // 4, dtype=torch.int64, device=dev)[None, None, :]
    pos = torch.arange(n, dtype=torch.int64, device=dev)[None, :, None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    words = philox4x32((groups, pos, zero, zero), (k0, k1))
    words = torch.broadcast_tensors(*words)
    return torch.stack(words, dim=-1).flatten(-2)[..., :k]


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``max + log1p(exp(-|a - b|))``, the form of ``jnp.logaddexp`` and of
    the kernel."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


@torch.no_grad()
def posterior_log_probs(logits: torch.Tensor, x_t: torch.Tensor,
                        coefs: torch.Tensor) -> torch.Tensor:
    """The kernel body up to the sample: log p(x_{t-1} | x_t) [B, N, K] f32,
    clamped to [-70, 0], from raw logits [B, N, K-1], the carry [B, N] and
    ``coefs`` [B, 10]."""
    lf = logits.float()
    km1 = lf.shape[-1]
    dev = lf.device
    lz = torch.tensor(LOG_ZERO, dtype=torch.float32, device=dev)
    m = lf.amax(-1, keepdim=True)
    lse_m = m + torch.log(torch.exp(lf - m).sum(-1, keepdim=True))
    log_x0 = (lf - lse_m).clamp(LOG_EPS, 0.0)

    xt = x_t.to(torch.int64)[..., None]                           # [B, N, 1]
    is_mask = xt == km1
    at_col = (torch.arange(km1, device=dev) == xt) & ~is_mask      # [B, N, K-1]
    c = [coefs[:, i, None, None].float() for i in range(10)]
    log_att, log_btt, log_ctt, log_at, log_bt, log_ct = c[:6]
    log_att_m1, log_btt_m1, log_ctt_m1, log_1mctt_m1 = c[6:]
    log_att_btt = logaddexp(log_att, log_btt)
    log_at_bt = logaddexp(log_at, log_bt)

    # q_pred(onehot x_t, t)[..., :-1]; masked rows := log γ̄
    log_qt = torch.where(at_col, log_att_btt, torch.where(is_mask, log_ctt, log_btt))
    q_nm = log_x0 - log_qt
    # logsumexp over [q_nm | log 1e-30]
    m2 = torch.maximum(q_nm.amax(-1, keepdim=True), lz)
    s = torch.exp(q_nm - m2).sum(-1, keepdim=True) + torch.exp(lz - m2)
    q_lse = m2 + torch.log(s)
    qn, qn_last = q_nm - q_lse, lz - q_lse

    # q_pred(qn, t - 1)
    qp_nm = logaddexp(qn + log_att_m1, log_btt_m1)
    qp_last = logaddexp(qn_last + log_1mctt_m1, log_ctt_m1)
    # q_pred_one_timestep(onehot x_t, t): last column log 1e-30, masked rows
    # [log γ, ..., log γ, 0]
    qt1_nm = torch.where(at_col, log_at_bt, torch.where(is_mask, log_ct, log_bt))
    qt1_last = torch.where(is_mask, torch.zeros((), device=dev), lz)
    ev_nm = (qp_nm + qt1_nm + q_lse).clamp(LOG_EPS, 0.0)
    ev_last = (qp_last + qt1_last + q_lse).clamp(LOG_EPS, 0.0)
    return torch.cat([ev_nm, ev_last], dim=-1)


@torch.no_grad()
def posterior_scores(logits: torch.Tensor, x_t: torch.Tensor, coefs: torch.Tensor,
                     gumbel: torch.Tensor, trunc_k: int = 0) -> torch.Tensor:
    """The scores [B, N, K] the kernel takes the argmax of: posterior
    log-probs plus Gumbel noise. ``trunc_k > 0`` keeps the trunc_k largest
    posterior log-probs of each row, ties at the threshold included, and
    gives the rest the score -3e38."""
    ev = posterior_log_probs(logits, x_t, coefs)
    score = ev + gumbel.float()
    if trunc_k:
        kth = torch.topk(ev, trunc_k, dim=-1).values[..., -1:]
        score = torch.where(ev >= kth, score, MASKED)
    return score


@torch.no_grad()
def reference_posterior_sample(logits: torch.Tensor, x_t: torch.Tensor, coefs: torch.Tensor,
                               gumbel: torch.Tensor, trunc_k: int = 0) -> torch.Tensor:
    """The plain PyTorch version of the kernel; same contract as
    :func:`fused_posterior_sample`. The argmax of :func:`posterior_scores`
    takes the first maximum, so the mask class (the last column) wins only
    when strictly greater."""
    return posterior_scores(logits, x_t, coefs, gumbel, trunc_k).argmax(-1)


@torch.no_grad()
def reference_posterior_sample_prng(logits: torch.Tensor, x_t: torch.Tensor,
                                    coefs: torch.Tensor, seeds: torch.Tensor,
                                    trunc_k: int = 0) -> torch.Tensor:
    """The plain version of :func:`fused_posterior_sample_prng`: the kernel's
    Philox bits for ``seeds``, then :func:`reference_posterior_sample`."""
    b, n, km1 = logits.shape
    gumbel = gumbel_from_bits(philox_bits(seeds, n, km1 + 1))
    return reference_posterior_sample(logits, x_t, coefs, gumbel, trunc_k)


def _check(logits: torch.Tensor, x_t: torch.Tensor, coefs: torch.Tensor,
           noise: torch.Tensor, noise_name: str, noise_shape: tuple, noise_dtype: torch.dtype,
           trunc_k: int) -> torch.Tensor:
    """Check the kernel's arguments and return x_t as contiguous int64."""
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits must be float32 or bfloat16, got {logits.dtype}")
    if logits.dim() != 3:
        raise ValueError(f"logits must be [B, N, K-1], got {tuple(logits.shape)}")
    b, n, km1 = logits.shape
    if km1 + 1 > MAX_CLASSES:
        raise ValueError(f"the kernel takes at most {MAX_CLASSES} classes, got {km1 + 1}")
    if not 0 <= trunc_k <= km1 + 1:
        raise ValueError(f"trunc_k must be in [0, {km1 + 1}], got {trunc_k}")
    if tuple(x_t.shape) != (b, n) or x_t.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"x_t must be integer [{b}, {n}], got {x_t.dtype} {tuple(x_t.shape)}")
    if tuple(coefs.shape) != (b, 10) or coefs.dtype != torch.float32:
        raise ValueError(f"coefs must be float32 [{b}, 10], got {coefs.dtype} "
                         f"{tuple(coefs.shape)}")
    if tuple(noise.shape) != noise_shape or noise.dtype != noise_dtype:
        raise ValueError(f"{noise_name} must be {noise_dtype} {list(noise_shape)}, got "
                         f"{noise.dtype} {tuple(noise.shape)}")
    for name, t in (("logits", logits), ("x_t", x_t), ("coefs", coefs), (noise_name, noise)):
        if t.device != logits.device:
            raise ValueError(f"{name} is on {t.device}, logits on {logits.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return x_t.to(torch.int64).contiguous()


def _launch(fn, name: str, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def fused_posterior_sample(logits: torch.Tensor, x_t: torch.Tensor, coefs: torch.Tensor,
                           gumbel: torch.Tensor, trunc_k: int = 0) -> torch.Tensor:
    """One reverse step: raw logits [B, N, K-1], carry [B, N], coefs from
    :func:`gather_posterior_coefs`, gumbel [B, N, K] f32 -> sampled indices
    [B, N] int64. ``trunc_k > 0`` samples among the trunc_k most probable
    classes of each row (truncated top-r).

    CUDA tensors go through the CUDA kernel, which adds one to
    ``fused_posterior_sample.launches`` per call; CPU tensors go through
    :func:`reference_posterior_sample`. Any other device raises.
    """
    if logits.device.type == "cpu":
        return reference_posterior_sample(logits, x_t, coefs, gumbel, trunc_k)
    if logits.device.type != "cuda":
        raise ValueError(f"fused_posterior_sample runs on cuda or cpu, not {logits.device}")
    b, n, km1 = logits.shape
    x_t = _check(logits, x_t, coefs, gumbel, "gumbel", (b, n, km1 + 1), torch.float32, trunc_k)
    out = torch.empty((b, n), dtype=torch.int64, device=logits.device)
    lib = _bind()
    fn = lib.discrete_posterior_f32 if logits.dtype == torch.float32 else lib.discrete_posterior_bf16
    _launch(fn, "discrete_posterior", logits.data_ptr(), x_t.data_ptr(), coefs.data_ptr(),
            gumbel.data_ptr(), out.data_ptr(), b, n, km1 + 1, int(trunc_k),
            torch.cuda.current_stream(logits.device).cuda_stream)
    fused_posterior_sample.launches += 1
    return out


fused_posterior_sample.launches = 0


def fused_posterior_sample_prng(logits: torch.Tensor, x_t: torch.Tensor, coefs: torch.Tensor,
                                seeds: torch.Tensor, trunc_k: int = 0) -> torch.Tensor:
    """:func:`fused_posterior_sample` with the Gumbel noise drawn in the
    kernel from ``seeds`` [B, 2] int32 (one fresh pair a batch row and step)
    by the module's Philox stream, so no [B, N, K] noise tensor is written
    or read.

    CUDA tensors go through the CUDA kernel, which adds one to
    ``fused_posterior_sample_prng.launches`` per call; CPU tensors go
    through :func:`reference_posterior_sample_prng`. Any other device raises.
    """
    if logits.device.type == "cpu":
        return reference_posterior_sample_prng(logits, x_t, coefs, seeds, trunc_k)
    if logits.device.type != "cuda":
        raise ValueError(f"fused_posterior_sample_prng runs on cuda or cpu, not {logits.device}")
    b, n, km1 = logits.shape
    x_t = _check(logits, x_t, coefs, seeds, "seeds", (b, 2), torch.int32, trunc_k)
    out = torch.empty((b, n), dtype=torch.int64, device=logits.device)
    lib = _bind()
    fn = (lib.discrete_posterior_prng_f32 if logits.dtype == torch.float32
          else lib.discrete_posterior_prng_bf16)
    _launch(fn, "discrete_posterior_prng", logits.data_ptr(), x_t.data_ptr(), coefs.data_ptr(),
            seeds.data_ptr(), out.data_ptr(), b, n, km1 + 1, int(trunc_k),
            torch.cuda.current_stream(logits.device).cuda_stream)
    fused_posterior_sample_prng.launches += 1
    return out


fused_posterior_sample_prng.launches = 0


def _bind() -> ctypes.CDLL:
    """The kernel library with its C signatures declared."""
    lib = library("discrete_posterior")
    if not getattr(lib, "_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.discrete_posterior_f32, lib.discrete_posterior_bf16,
                   lib.discrete_posterior_prng_f32, lib.discrete_posterior_prng_bf16):
            fn.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
            fn.restype = i32
        lib._bound = True
    return lib
