"""Discrete mask-and-replace VQ-diffusion in log space (PyTorch counterpart
of the JAX ``diffusion/discrete.py``): sampling and the training loss.

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
  (``ops.discrete_posterior.gumbel_from_uniform``);
- the training loss: t uniform until every ``Lt_count`` passes 10, then
  drawn in proportion to sqrt(Lt_history) with pt[0] = pt[1] (unless
  ``use_importance_sampling`` is off); x_t a Gumbel sample of q(x_t | x_0);
  the KL of the posteriors weighted by ``mask_weight`` at masked and
  unmasked positions, the decoder NLL at t = 0, the auxiliary x0-KL
  (weighted (1 - t/T) + 1 under ``adaptive_auxiliary_loss``), each over pt,
  summed over the batch's B x N positions; the history, counts and the
  accuracy EMAs scattered at t, the last of equal t's winning (as the JAX
  scatter on the CPU; here the same on the card).

Noise comes from an explicit ``torch.Generator`` on the device, or is
injected for the parity tests: ``init_uniform`` and one Gumbel tensor a
step for the samplers, ``t`` and the Gumbel noise of q(x_t | x_0) for the
loss. ``fused_posterior`` routes each structured step: truthy (``True``,
``"on"``, ``"interpret"``) to the fused kernel with Gumbel noise read from
memory, ``"prng"`` to the kernel that draws it, falsy to plain ops.

Layout: class-last [B, N, K]; K includes the mask class, the last.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.discrete_posterior import (LOG_ZERO, fits_kernel_route, fused_posterior_sample,
                                      fused_posterior_sample_prng, gather_posterior_coefs,
                                      gumbel_from_uniform, logaddexp,
                                      reference_posterior_sample_prng)
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


class LtState(NamedTuple):
    """The importance-sampling history of the training loss, [T] each: the
    EMA of each t's squared loss and its count, and the EMAs of the x0
    accuracy and the kept share at each t (telemetry)."""
    Lt_history: torch.Tensor
    Lt_count: torch.Tensor
    acc_ema: torch.Tensor
    keep_ema: torch.Tensor

    @classmethod
    def init(cls, timesteps: int, device=None) -> "LtState":
        return cls(*(torch.zeros(timesteps, device=device) for _ in range(4)))


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


def _scatter_set(arr: torch.Tensor, t: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """A copy of ``arr`` with ``values[i]`` at ``t[i]``; of equal t's the last
    wins, on any device."""
    i = torch.arange(t.shape[0], device=t.device)
    later = ((t[:, None] == t[None, :]) & (i[None, :] > i[:, None])).any(1)
    out = arr.clone()
    out[t[~later]] = values[~later]
    return out


class DiscreteDiffusion:
    """Diffusion_VQ_Official around ``model_fn(log_x_t [B, N, K], t [B]) ->
    logits [B, N, K-1]``, or ``model_fn_idx(x_idx [B, N], t)`` when the
    denoiser embeds indices."""

    def __init__(self, num_classes: int, seq_len: int, timesteps: int = 100,
                 sampling_timesteps: Optional[int] = None,
                 auxiliary_loss_weight: float = 0.0, adaptive_auxiliary_loss: bool = False,
                 mask_weight: Tuple[float, float] = (1.0, 1.0), ctt_T: float = 0.99999,
                 mask_logit_pad: float = LOG_EPS, chain_init: str = "uniform_rand",
                 use_importance_sampling: bool = True,
                 truncation_rate: Optional[float] = None):
        self.num_classes = num_classes          # includes the mask class (last)
        self.seq_len = seq_len
        self.num_timesteps = timesteps
        self.sampling_timesteps = sampling_timesteps or timesteps
        self.model_fn: Optional[Callable] = None
        self.model_fn_idx: Optional[Callable] = None
        self.fused_posterior = False
        self.auxiliary_loss_weight = auxiliary_loss_weight
        self.adaptive_auxiliary_loss = adaptive_auxiliary_loss
        self.mask_weight = mask_weight
        self.use_importance_sampling = use_importance_sampling
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
        [B, N, K], or seeds [B, 2] int32 under ``fused_posterior: prng``.

        Shapes past :func:`fits_kernel_route` (the JAX package's
        ``fits_vmem``) take plain ops, chosen here on the static N and K as
        the JAX sampler chooses: under ``prng`` the plain version of the
        kernel on the seeds (the same Philox stream), else the plain
        posterior on the Gumbel noise."""
        mode = self.posterior_route()
        fits = fits_kernel_route(z_idx.shape[1], self.num_classes)
        if mode and not fits and mode != "prng":
            mode = False
        if mode:
            trunc_k = self._trunc_k() if truncated else 0
            logits = self._raw_logits_idx(z_idx, t)
            coefs = gather_posterior_coefs(self._s(logits.device), t_post, self.num_timesteps)
            if mode == "prng":
                fn = fused_posterior_sample_prng if fits else reference_posterior_sample_prng
            else:
                fn = fused_posterior_sample
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

    def q_sample(self, log_x_start: torch.Tensor, t: torch.Tensor,
                 gumbel: torch.Tensor) -> torch.Tensor:
        """A log-onehot sample of q(x_t | x_0) with the Gumbel noise given."""
        idx = self.sample_categorical_idx(self.q_pred(log_x_start, t), gumbel)
        return index_to_log_onehot(idx, self.num_classes)

    # -- training loss ------------------------------------------------------------
    def sample_time(self, b: int, lt: LtState, generator: Optional[torch.Generator] = None,
                    t: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """t [b] and its probability pt [b]: uniform until every count of
        ``lt`` passes 10, then drawn in proportion to sqrt(Lt_history), with
        pt[0] = pt[1]. Both draws come from ``generator`` on ``lt``'s device
        and the warm test picks one on the device (no host sync); a given
        ``t`` replaces them and gets the pt of the same rule."""
        dev = lt.Lt_history.device
        T = self.num_timesteps
        drawn = t is None
        t = torch.randint(0, T, (b,), generator=generator, device=dev) if drawn else t.to(dev)
        pt_uniform = torch.full((b,), 1.0 / T, device=dev)
        if not self.use_importance_sampling:
            return t, pt_uniform
        lt_sqrt = torch.sqrt(lt.Lt_history + 1e-10) + 1e-4
        lt_sqrt = torch.cat([lt_sqrt[1:2], lt_sqrt[1:]])
        pt_all = lt_sqrt / lt_sqrt.sum()
        warm = (lt.Lt_count > 10).all()
        if drawn:
            t_imp = torch.multinomial(pt_all, b, replacement=True, generator=generator)
            t = torch.where(warm, t_imp, t)
        return t, torch.where(warm, pt_all[t], pt_uniform)

    def train_loss(self, x0: torch.Tensor, lt: LtState,
                   generator: Optional[torch.Generator] = None, *,
                   t: Optional[torch.Tensor] = None, gumbel: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], LtState]:
        """The training loss of indices x0 [B, N] -> (loss, metrics {vb_loss,
        kl, decoder_nll}, the new ``LtState``). ``t`` (then its pt by
        :meth:`sample_time`'s rule) and ``gumbel`` [B, N, K], the noise of
        q(x_t | x_0), come from ``generator`` unless given."""
        b, n = x0.shape
        k = self.num_classes
        t, pt = self.sample_time(b, lt, generator, t)
        log_x_start = index_to_log_onehot(x0, k)
        if gumbel is None:
            gumbel = self._gumbel(torch.rand((b, n, k), generator=generator, device=x0.device))
        xt = self.sample_categorical_idx(self.q_pred(log_x_start, t), gumbel.to(x0.device))

        log_x0_recon = self.predict_start_idx(xt, t)
        log_model_prob = self.q_posterior_idx(log_x0_recon, xt, t)

        with torch.no_grad():
            same0 = (log_onehot_to_index(log_x0_recon) == x0).float().mean(1)
            samek = (log_onehot_to_index(log_model_prob) == xt).float().mean(1)
            acc_ema = _scatter_set(lt.acc_ema, t, 0.1 * same0 + 0.9 * lt.acc_ema[t])
            keep_ema = _scatter_set(lt.keep_ema, t, 0.1 * samek + 0.9 * lt.keep_ema[t])

        log_true_prob = self.q_posterior_idx(log_x_start, xt, t)
        kl = (log_true_prob.exp() * (log_true_prob - log_model_prob)).sum(-1)       # [B, N]
        mask_region = (xt == k - 1).float()
        mask_w = mask_region * self.mask_weight[0] + (1 - mask_region) * self.mask_weight[1]
        kl = (kl * mask_w).sum(1)                                                   # [B]
        decoder_nll = -(log_x_start.exp() * log_model_prob).sum(-1).sum(1)

        is_t0 = (t == 0).float()
        kl_loss = is_t0 * decoder_nll + (1 - is_t0) * kl
        with torch.no_grad():
            history = _scatter_set(lt.Lt_history, t,
                                   0.1 * kl_loss ** 2 + 0.9 * lt.Lt_history[t])
            count = lt.Lt_count.index_add(0, t, torch.ones_like(pt))

        vb_loss = kl_loss / pt
        if self.auxiliary_loss_weight != 0:
            kl_aux = (log_x_start[..., :-1].exp()
                      * (log_x_start[..., :-1] - log_x0_recon[..., :-1])).sum(-1)
            kl_aux_loss = is_t0 * decoder_nll + (1 - is_t0) * (kl_aux * mask_w).sum(1)
            add_w = (1 - t.float() / self.num_timesteps) + 1.0 \
                if self.adaptive_auxiliary_loss else 1.0
            vb_loss = vb_loss + add_w * self.auxiliary_loss_weight * kl_aux_loss / pt
        loss = vb_loss.sum() / (b * n)
        metrics = {"vb_loss": loss, "kl": kl.mean(), "decoder_nll": decoder_nll.mean()}
        return loss, metrics, LtState(history, count, acc_ema, keep_ema)

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
        """Indices [B, N] after ``sampling_timesteps`` reverse steps; with
        ``return_all_timesteps`` also the filmstrip [B, F, N], the indices
        after each of the F = ``sampling_timesteps`` steps. Noise comes from
        ``generator`` (drawn on its device) or is injected: ``init_uniform``
        [B, N, K] and ``step_gumbel[i]`` [B, N, K] for the i-th step (t =
        start - 1 - i)."""
        device, shape, log_z = self._start(batch_size, generator, device, init_uniform)
        start = self.sampling_timesteps
        seeds = self.posterior_route() == "prng"

        # the dense first step on the chain-init noise (not a one-hot)
        t0 = torch.full((batch_size,), start - 1, dtype=torch.long, device=device)
        z_idx = self.sample_categorical_idx(
            self.p_pred(log_z, t0), self._noise(0, shape, step_gumbel, generator, device))
        frames = [z_idx]
        for i, step in enumerate(range(start - 2, -1, -1), start=1):
            t = torch.full((batch_size,), step, dtype=torch.long, device=device)
            z_idx = self._step_idx(z_idx, t, t, self._noise(i, shape, step_gumbel, generator,
                                                            device, seeds))
            if return_all_timesteps:
                frames.append(z_idx)
        return (z_idx, torch.stack(frames, 1)) if return_all_timesteps else z_idx

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
