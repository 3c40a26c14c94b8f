"""Discrete mask-and-replace VQ-diffusion in log space, sampling side
(PyTorch counterpart of the JAX ``diffusion/discrete.py``).

Kept exactly as in the JAX package:

- the (at, bt, ct) schedule in float64 numpy, then log-space float32
  tensors with the [1]/[0] padding entry at index T of the cumulative
  arrays;
- ``q_pred``'s (t + T + 1) mod (T + 1) wraparound, so t - 1 = -1 reads the
  padding entry;
- ``predict_start``'s mask-pad column (``mask_logit_pad``) and every clamp
  to [-70, 0];
- two log-add-exp forms: :func:`log_add_exp` (``m + log(e^(a-m) +
  e^(b-m))``) in ``q_pred``, ``max + log1p(exp(-|a-b|))`` in
  ``q_posterior_idx`` and in the fused kernel;
- ``sample``'s dense first step on the chain-init noise, then structured
  one-hot steps; ``sample_fast``'s ``t_post``;
- ``_chain_init("prior")`` reads index -1 of the cumulative arrays, which is
  the padding entry (btt 0, ctt 0): the init is flat at log(1e-30), not
  q(x_T) (ROADMAP.md §C);
- the Gumbel transform has one definition
  (``ops.discrete_posterior.gumbel_from_uniform``).

Noise comes from an explicit ``torch.Generator`` on the device, or is
injected (``init_uniform`` and one Gumbel tensor a step) for the parity
tests. ``fused_posterior`` routes each structured step: truthy (``True``,
``"on"``, ``"interpret"``) to the fused kernel with Gumbel noise read from
memory, ``"prng"`` to the kernel that draws it, falsy to plain ops.

The training loss, ``LtState``, ``sample_time`` and the filmstrip
(``return_all_timesteps``) come with the training half of the slice.

Layout: class-last [B, N, K]; K includes the mask class, the last.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops.discrete_posterior import (LOG_ZERO, fused_posterior_sample,
                                      fused_posterior_sample_prng, gather_posterior_coefs,
                                      gumbel_from_uniform, logaddexp)
from .schedules import discrete_alpha_schedule

LOG_EPS = -70.0
_OFF = ("off", "false", "none", "0", "")


def index_to_log_onehot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """int [B, N] -> log-onehot [B, N, K] f32 (zeros as log 1e-30)."""
    oh = torch.nn.functional.one_hot(x.long(), num_classes).float()
    return torch.log(oh.clamp(min=1e-30))


def log_onehot_to_index(log_x: torch.Tensor) -> torch.Tensor:
    return log_x.argmax(-1)


def log_add_exp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def log_1_min_a(a: torch.Tensor) -> torch.Tensor:
    return torch.log(1 - torch.exp(a) + 1e-40)


class DiscreteSchedule(NamedTuple):
    log_at: torch.Tensor
    log_bt: torch.Tensor
    log_ct: torch.Tensor
    log_cumprod_at: torch.Tensor
    log_cumprod_bt: torch.Tensor
    log_cumprod_ct: torch.Tensor
    log_1_min_ct: torch.Tensor
    log_1_min_cumprod_ct: torch.Tensor

    def to(self, device) -> "DiscreteSchedule":
        return DiscreteSchedule(*(x.to(device) for x in self))


def make_discrete_schedule(timesteps: int, num_classes: int,
                           ctt_T: float = 0.99999) -> DiscreteSchedule:
    """Log-space float32 schedule on the CPU; N = num_classes - 1 non-mask
    classes."""
    at, bt, ct, att, btt, ctt = discrete_alpha_schedule(timesteps, N=num_classes - 1,
                                                        ctt_T=ctt_T)

    def f(x):
        return torch.from_numpy(np.log(np.clip(x, 1e-30, None)).astype(np.float32))
    log_ct, log_cumprod_ct = f(ct), f(ctt)
    return DiscreteSchedule(
        log_at=f(at), log_bt=f(bt), log_ct=log_ct,
        log_cumprod_at=f(att), log_cumprod_bt=f(btt), log_cumprod_ct=log_cumprod_ct,
        log_1_min_ct=log_1_min_a(log_ct), log_1_min_cumprod_ct=log_1_min_a(log_cumprod_ct))


def _ex(arr: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[T] gathered at t [B] -> [B, 1, 1]."""
    return arr[t][:, None, None]


def posterior_mode(mode) -> object:
    """A config's ``fused_posterior`` -> False (plain ops), ``"prng"`` (the
    kernel that draws its noise) or True (the kernel that reads it)."""
    m = str(mode).lower()
    if m in _OFF:
        return False
    return "prng" if m == "prng" else True


def _filmstrip_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "return_all_timesteps (the sampling filmstrip) is not ported yet: see ROADMAP.md, "
        "slice 5 (discrete VQ-diffusion priors, training half)")


class DiscreteDiffusion:
    """Diffusion_VQ_Official's sampler around ``model_fn(log_x_t [B, N, K],
    t [B]) -> logits [B, N, K-1]``, or ``model_fn_idx(x_idx [B, N], t)`` when
    the denoiser embeds indices."""

    def __init__(self, num_classes: int, seq_len: int, timesteps: int = 100,
                 sampling_timesteps: Optional[int] = None, ctt_T: float = 0.99999,
                 mask_logit_pad: float = LOG_EPS, chain_init: str = "uniform_rand",
                 truncation_rate: Optional[float] = None):
        self.num_classes = num_classes          # includes the mask class (last)
        self.seq_len = seq_len
        self.num_timesteps = timesteps
        self.sampling_timesteps = sampling_timesteps or timesteps
        self.model_fn: Optional[Callable] = None
        self.model_fn_idx: Optional[Callable] = None
        self.fused_posterior = False
        self.mask_logit_pad = mask_logit_pad
        self.chain_init = chain_init              # "uniform_rand" | "prior"
        self.truncation_rate = truncation_rate
        self.sched = make_discrete_schedule(timesteps, num_classes, ctt_T)
        self._on = {}

    def _s(self, device: torch.device) -> DiscreteSchedule:
        """The schedule on ``device``, moved there once."""
        key = str(device)
        if key not in self._on:
            self._on[key] = self.sched.to(device)
        return self._on[key]

    # -- forward process ------------------------------------------------------
    def q_pred_one_timestep(self, log_x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        s = self._s(log_x_t.device)
        probs_nonmask = log_add_exp(log_x_t[..., :-1] + _ex(s.log_at, t), _ex(s.log_bt, t))
        probs_mask = log_add_exp(log_x_t[..., -1:] + _ex(s.log_1_min_ct, t), _ex(s.log_ct, t))
        return torch.cat([probs_nonmask, probs_mask], dim=-1)

    def q_pred(self, log_x_start: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        s = self._s(log_x_start.device)
        t = (t + self.num_timesteps + 1) % (self.num_timesteps + 1)
        probs_nonmask = log_add_exp(log_x_start[..., :-1] + _ex(s.log_cumprod_at, t),
                                    _ex(s.log_cumprod_bt, t))
        probs_mask = log_add_exp(log_x_start[..., -1:] + _ex(s.log_1_min_cumprod_ct, t),
                                 _ex(s.log_cumprod_ct, t))
        return torch.cat([probs_nonmask, probs_mask], dim=-1)

    # -- model wrapper ----------------------------------------------------------
    def _log_pred_from_logits(self, out: torch.Tensor) -> torch.Tensor:
        """logits [B, N, K-1] -> clamped log-probs [B, N, K] with the mask pad."""
        log_pred = torch.log_softmax(out.float(), dim=-1)
        pad = torch.full(log_pred.shape[:-1] + (1,), self.mask_logit_pad,
                         dtype=torch.float32, device=out.device)
        return torch.cat([log_pred, pad], dim=-1).clamp(LOG_EPS, 0.0)

    def predict_start(self, log_x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self._log_pred_from_logits(self.model_fn(log_x_t, t))

    def predict_start_idx(self, x_idx: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self._log_pred_from_logits(self._raw_logits_idx(x_idx, t))

    def q_posterior(self, log_x_start: torch.Tensor, log_x_t: torch.Tensor,
                    t: torch.Tensor) -> torch.Tensor:
        """The dense posterior, for any log_x_t (the chain-init step)."""
        s = self._s(log_x_start.device)
        b, n, k = log_x_start.shape
        dev = log_x_start.device
        mask = (log_onehot_to_index(log_x_t) == self.num_classes - 1)[..., None]
        log_zero = torch.full((b, n, 1), LOG_ZERO, dtype=torch.float32, device=dev)

        log_qt = self.q_pred(log_x_t, t)[..., :-1]
        log_qt = torch.where(mask, _ex(s.log_cumprod_ct, t).expand(b, n, k - 1), log_qt)

        log_qt_one = self.q_pred_one_timestep(log_x_t, t)
        log_qt_one = torch.cat([log_qt_one[..., :-1], log_zero], dim=-1)
        ct_vec = torch.cat([_ex(s.log_ct, t).expand(b, n, k - 1),
                            torch.zeros((b, n, 1), device=dev)], dim=-1)
        log_qt_one = torch.where(mask, ct_vec, log_qt_one)

        q = torch.cat([log_x_start[..., :-1] - log_qt, log_zero], dim=-1)
        q_log_sum_exp = torch.logsumexp(q, dim=-1, keepdim=True)
        q = q - q_log_sum_exp
        log_ev = self.q_pred(q, t - 1) + log_qt_one + q_log_sum_exp
        return log_ev.clamp(LOG_EPS, 0.0)

    def q_posterior_idx(self, log_x_start: torch.Tensor, x_t_idx: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
        """:meth:`q_posterior` on a one-hot carry given by indices: the dense
        log-add-exp chains collapse to per-row scalars and a column
        correction at x_t."""
        s = self._s(log_x_start.device)
        b, n = x_t_idx.shape
        k = self.num_classes
        dev = log_x_start.device
        xt = x_t_idx.long()[..., None]
        mask = xt == k - 1
        at_col = (torch.arange(k - 1, device=dev) == xt) & ~mask

        log_att, log_btt = _ex(s.log_cumprod_at, t), _ex(s.log_cumprod_bt, t)
        log_ctt = _ex(s.log_cumprod_ct, t)
        log_at, log_bt, log_ct = _ex(s.log_at, t), _ex(s.log_bt, t), _ex(s.log_ct, t)
        log_att_btt = logaddexp(log_att, log_btt)
        log_at_bt = logaddexp(log_at, log_bt)

        log_qt = torch.where(at_col, log_att_btt, torch.where(mask, log_ctt, log_btt))
        log_zero = torch.full((b, n, 1), LOG_ZERO, dtype=torch.float32, device=dev)
        q = torch.cat([log_x_start[..., :-1] - log_qt, log_zero], dim=-1)
        q_log_sum_exp = torch.logsumexp(q, dim=-1, keepdim=True)
        q = q - q_log_sum_exp

        nonmask = torch.where(at_col, log_at_bt, torch.where(mask, log_ct, log_bt))
        last = torch.where(mask, torch.zeros((), device=dev), log_zero)
        log_qt_one = torch.cat([nonmask, last], dim=-1)

        log_ev = self.q_pred(q, t - 1) + log_qt_one + q_log_sum_exp
        return log_ev.clamp(LOG_EPS, 0.0)

    def p_pred(self, log_x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.q_posterior(self.predict_start(log_x, t), log_x, t)

    def p_pred_idx(self, x_idx: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.q_posterior_idx(self.predict_start_idx(x_idx, t), x_idx, t)

    def _raw_logits_idx(self, x_idx: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Denoiser logits [B, N, K-1] from an index carry."""
        if self.model_fn_idx is not None:
            return self.model_fn_idx(x_idx, t)
        return self.model_fn(index_to_log_onehot(x_idx, self.num_classes), t)

    def posterior_route(self):
        """False (plain ops), True (kernel reading Gumbel noise) or "prng"."""
        return posterior_mode(self.fused_posterior)

    def _trunc_k(self) -> int:
        return max(int(self.num_classes * (self.truncation_rate or 0.86)), 1)

    def _step_idx(self, z_idx: torch.Tensor, t: torch.Tensor, t_post: torch.Tensor,
                  noise: torch.Tensor, truncated: bool = False) -> torch.Tensor:
        """One structured reverse step: p_pred at t, posterior at t_post,
        categorical sample (top-r when ``truncated``). ``noise`` is Gumbel
        [B, N, K], or seeds [B, 2] int32 under ``fused_posterior: prng``."""
        mode = self.posterior_route()
        if mode:
            trunc_k = self._trunc_k() if truncated else 0
            logits = self._raw_logits_idx(z_idx, t)
            coefs = gather_posterior_coefs(self._s(logits.device), t_post, self.num_timesteps)
            fn = fused_posterior_sample_prng if mode == "prng" else fused_posterior_sample
            return fn(logits, z_idx, coefs, noise, trunc_k=trunc_k)
        prob = self.q_posterior_idx(self.predict_start_idx(z_idx, t), z_idx, t_post)
        if truncated:
            return self.sample_categorical_truncated_idx(prob, noise)
        return self.sample_categorical_idx(prob, noise)

    # -- sampling helpers ---------------------------------------------------------
    @staticmethod
    def _gumbel(u: torch.Tensor) -> torch.Tensor:
        """Gumbel noise from uniforms; the single definition."""
        return gumbel_from_uniform(u)

    @staticmethod
    def sample_categorical_idx(logits: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
        """Gumbel-argmax sample as indices (first maximum)."""
        return (gumbel + logits).argmax(-1)

    def sample_categorical_truncated_idx(self, logits: torch.Tensor,
                                         gumbel: torch.Tensor) -> torch.Tensor:
        """Truncated (top-r) Gumbel sampling."""
        kth = torch.topk(logits, self._trunc_k(), dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
        return (gumbel + logits).argmax(-1)

    # -- sampling -------------------------------------------------------------------
    def _chain_init(self, batch_size: int, u: Optional[torch.Tensor],
                    device: torch.device) -> torch.Tensor:
        if self.chain_init == "prior":
            # index -1 is the padding entry (btt 0, ctt 0), as in the JAX package
            s = self._s(device)
            log_x = s.log_cumprod_bt[-1].expand(batch_size, self.seq_len,
                                                self.num_classes).clone()
            log_x[..., -1] = s.log_cumprod_ct[-1]
            return log_x.clamp(LOG_EPS, 0.0)
        return torch.log(u)

    def _noise(self, i: int, shape, step_gumbel: Optional[Sequence[torch.Tensor]],
               generator: Optional[torch.Generator], device: torch.device,
               seeds: bool = False) -> torch.Tensor:
        """The noise of the i-th step: injected, drawn Gumbel, or (seeds) a
        [B, 2] int32 seed pair a batch row for the ``prng`` kernel."""
        if seeds:
            if step_gumbel is not None:
                raise ValueError("fused_posterior 'prng' draws its own noise; "
                                 "injected Gumbel noise needs another route")
            return torch.randint(-2 ** 31, 2 ** 31, (shape[0], 2), dtype=torch.int32,
                                 generator=generator, device=device)
        if step_gumbel is not None:
            return step_gumbel[i].to(device)
        return self._gumbel(torch.rand(shape, generator=generator, device=device))

    def _start(self, batch_size: int, generator, device, init_uniform) -> tuple:
        device = torch.device(generator.device if generator is not None else device or "cpu")
        shape = (batch_size, self.seq_len, self.num_classes)
        if self.chain_init != "prior" and init_uniform is None:
            init_uniform = torch.rand(shape, generator=generator, device=device)
        u = None if init_uniform is None else init_uniform.to(device)
        return device, shape, self._chain_init(batch_size, u, device)

    @torch.no_grad()
    def sample(self, batch_size: int = 16, generator: Optional[torch.Generator] = None,
               device=None, init_uniform: Optional[torch.Tensor] = None,
               step_gumbel: Optional[Sequence[torch.Tensor]] = None,
               return_all_timesteps: bool = False) -> torch.Tensor:
        """Indices [B, N] after ``sampling_timesteps`` reverse steps. Noise
        comes from ``generator`` (drawn on its device) or is injected:
        ``init_uniform`` [B, N, K] and ``step_gumbel[i]`` [B, N, K] for the
        i-th step (t = start - 1 - i)."""
        if return_all_timesteps:
            raise _filmstrip_not_ported()
        device, shape, log_z = self._start(batch_size, generator, device, init_uniform)
        start = self.sampling_timesteps
        seeds = self.posterior_route() == "prng"

        # the dense first step on the chain-init noise (not a one-hot)
        t0 = torch.full((batch_size,), start - 1, dtype=torch.long, device=device)
        z_idx = self.sample_categorical_idx(
            self.p_pred(log_z, t0), self._noise(0, shape, step_gumbel, generator, device))
        for i, step in enumerate(range(start - 2, -1, -1), start=1):
            t = torch.full((batch_size,), step, dtype=torch.long, device=device)
            z_idx = self._step_idx(z_idx, t, t, self._noise(i, shape, step_gumbel, generator,
                                                            device, seeds))
        return z_idx

    @torch.no_grad()
    def sample_fast(self, batch_size: int = 16, skip_step: int = 1,
                    generator: Optional[torch.Generator] = None, device=None,
                    init_uniform: Optional[torch.Tensor] = None,
                    step_gumbel: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Skip-step sampling over t = start-1, start-2-skip, ..., 0, each
        step's posterior taken at t - skip (t when t <= skip). Noise as in
        :meth:`sample`."""
        device, shape, log_z = self._start(batch_size, generator, device, init_uniform)
        start = self.sampling_timesteps
        steps = list(range(start - 1, -1, -1 - skip_step))
        if steps[-1] != 0:
            steps.append(0)
        seeds = self.posterior_route() == "prng"

        def times(i: int):
            t = torch.full((batch_size,), i, dtype=torch.long, device=device)
            return t, (t - skip_step if i > skip_step else t)

        t, t_post = times(steps[0])
        prob = self.q_posterior(self.predict_start(log_z, t), log_z, t_post)
        z_idx = self.sample_categorical_idx(
            prob, self._noise(0, shape, step_gumbel, generator, device))
        for i, step in enumerate(steps[1:], start=1):
            t, t_post = times(step)
            z_idx = self._step_idx(z_idx, t, t_post, self._noise(i, shape, step_gumbel,
                                                                 generator, device, seeds))
        return z_idx
