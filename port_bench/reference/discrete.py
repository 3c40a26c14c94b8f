"""The VQ_Official prior's discrete mask-and-replace diffusion (Gu et al.,
"Vector Quantized Diffusion Model for Text-to-Image Synthesis", CVPR 2022;
the reference repository's ``Diffusion_VQ_Official`` in
``network/vqDiffusion/submodule/diffusion_vq_official.py``), float32, in
that file's layout: log-probabilities [B, K, N], the K classes on dim 1,
the last of them (K - 1) the mask.

- :func:`alpha_schedule` (:65-78): ᾱ_t falls linearly from 0.99999 to
  0.000009 and γ̄_t rises from 0.000009 to 0.99999 over the T steps; the
  per-step α_t, γ_t from their ratios, β_t = (1 - α_t - γ_t) / (K - 1), and
  β̄_t likewise; the cumulative arrays end in a padding entry (ᾱ 1, γ̄ 0),
  which index T, and t - 1 = -1 wrapped, read;
- :func:`schedule` (:135-164): the logs taken in float64, log(1 - e^a) as
  log(1 - e^a + 1e-40), then every buffer cast to float32; the padding
  entry's log β̄ and log γ̄ are -inf;
- :func:`q_pred` (q(x_t | x_0), with the (t + T + 1) mod (T + 1)
  wraparound) and :func:`q_pred_one_timestep` (q(x_t | x_{t-1})), each by
  ``log_add_exp`` = m + log(e^(a-m) + e^(b-m));
- :func:`predict_start` (:210-246): the denoiser's K - 1 logits, the
  log-softmax over the classes, a row of -70 for the mask class, the clamp
  to [-70, 0];
- :func:`q_posterior` (:248-280): q(x_{t-1} | x_t, x̂_0) summed over x̂_0,
  the mask positions of x_t (its argmax at K - 1) taking γ̄_t and γ_t;
- :func:`gumbel` and :func:`pick` (:299-304): -log(-log(u + 1e-30) +
  1e-30), then the argmax of the log-probabilities plus the noise;
- the denoiser: the ShuffleNet U-Net of :mod:`.shuffle_unet` on the
  [B, K, N, 1] image of log_x_t, its output's last row dropped.

Departures: the log-softmax runs in float32 where the published file
takes it in float64 (the port keeps float32, as the JAX package does for
the accelerator); the mask selects by ``torch.where`` where the published
file multiplies by the mask (the same values, every operand being finite);
the published chain's bookkeeping (accuracy lists, autocast, the
conditional embedding, which VQ_Official leaves empty) is left out.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .shuffle_unet import ShuffleUNet

LOG_EPS = -70.0


def alpha_schedule(steps: int, n: int, att_1: float = 0.99999, att_T: float = 0.000009,
                   ctt_1: float = 0.000009, ctt_T: float = 0.99999) -> Tuple[np.ndarray, ...]:
    """(α, β, γ, ᾱ, β̄, γ̄) in float64 for ``steps`` steps over ``n`` non-mask
    classes; the cumulative arrays have ``steps + 1`` entries."""
    att = np.arange(0, steps) / (steps - 1) * (att_T - att_1) + att_1
    att = np.concatenate(([1], att))
    at = att[1:] / att[:-1]
    ctt = np.arange(0, steps) / (steps - 1) * (ctt_T - ctt_1) + ctt_1
    ctt = np.concatenate(([0], ctt))
    one_minus_ctt = 1 - ctt
    one_minus_ct = one_minus_ctt[1:] / one_minus_ctt[:-1]
    ct = 1 - one_minus_ct
    bt = (1 - at - ct) / n
    att = np.concatenate((att[1:], [1]))
    ctt = np.concatenate((ctt[1:], [0]))
    btt = (1 - att - ctt) / n
    return at, bt, ct, att, btt, ctt


def log_1_min_a(a: torch.Tensor) -> torch.Tensor:
    return torch.log(1 - a.exp() + 1e-40)


def log_add_exp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.max(a, b)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def schedule(steps: int, num_classes: int) -> Dict[str, torch.Tensor]:
    """The float32 log-space buffers of a process over ``num_classes``
    classes (the mask included), as CPU tensors."""
    at, bt, ct, att, btt, ctt = (torch.tensor(x.astype("float64"))
                                 for x in alpha_schedule(steps, num_classes - 1))
    logs = {"log_at": at.log(), "log_bt": bt.log(), "log_ct": ct.log(),
            "log_cumprod_at": att.log(), "log_cumprod_bt": btt.log(),
            "log_cumprod_ct": ctt.log()}
    logs["log_1_min_ct"] = log_1_min_a(logs["log_ct"])
    logs["log_1_min_cumprod_ct"] = log_1_min_a(logs["log_cumprod_ct"])
    return {k: v.float() for k, v in logs.items()}


def _at(sched: Dict[str, torch.Tensor], name: str, t: torch.Tensor) -> torch.Tensor:
    """The buffer ``name`` at t [B], as [B, 1, 1] on t's device."""
    return sched[name].to(t.device)[t][:, None, None]


def q_pred(sched: Dict[str, torch.Tensor], log_x_start: torch.Tensor,
           t: torch.Tensor) -> torch.Tensor:
    """log q(x_t | x_0) [B, K, N]."""
    steps = sched["log_at"].shape[0]
    t = (t + (steps + 1)) % (steps + 1)
    return torch.cat([
        log_add_exp(log_x_start[:, :-1] + _at(sched, "log_cumprod_at", t),
                    _at(sched, "log_cumprod_bt", t)),
        log_add_exp(log_x_start[:, -1:] + _at(sched, "log_1_min_cumprod_ct", t),
                    _at(sched, "log_cumprod_ct", t))], dim=1)


def q_pred_one_timestep(sched: Dict[str, torch.Tensor], log_x_t: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
    """log q(x_t | x_{t-1}) [B, K, N]."""
    return torch.cat([
        log_add_exp(log_x_t[:, :-1] + _at(sched, "log_at", t), _at(sched, "log_bt", t)),
        log_add_exp(log_x_t[:, -1:] + _at(sched, "log_1_min_ct", t),
                    _at(sched, "log_ct", t))], dim=1)


def predict_start(unet: ShuffleUNet, log_x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """log p(x̂_0 | x_t) [B, K, N], clamped to [-70, 0]: the U-Net on the
    [B, K, N, 1] image of log_x_t, its output's last row dropped."""
    logits = unet(log_x_t[..., None], t)[..., 0][:, :-1]
    log_pred = torch.log_softmax(logits.float(), dim=1)
    pad = torch.full_like(log_pred[:, :1], LOG_EPS)
    return torch.cat([log_pred, pad], dim=1).clamp(LOG_EPS, 0)


def index_to_log_onehot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Indices [B, N] -> log-onehot [B, K, N], zeros as log 1e-30."""
    onehot = torch.nn.functional.one_hot(x.long(), num_classes).permute(0, 2, 1)
    return torch.log(onehot.float().clamp(min=1e-30))


def q_posterior(sched: Dict[str, torch.Tensor], log_x_start: torch.Tensor,
                log_x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """log p(x_{t-1} | x_t) = log Σ_x̂0 q(x_{t-1} | x_t, x̂_0) p(x̂_0 | x_t)
    [B, K, N], clamped to [-70, 0]; t in [0, T - 1]."""
    b, k, n = log_x_start.shape
    mask = (log_x_t.argmax(1) == k - 1)[:, None]
    log_zero = torch.log(torch.zeros(b, 1, n, device=log_x_t.device) + 1.0e-30)

    log_qt = q_pred(sched, log_x_t, t)[:, :-1]
    log_qt = torch.where(mask, _at(sched, "log_cumprod_ct", t).expand(-1, k - 1, n), log_qt)

    log_qt_one = q_pred_one_timestep(sched, log_x_t, t)
    log_qt_one = torch.cat([log_qt_one[:, :-1], log_zero], dim=1)
    ct_vector = torch.cat([_at(sched, "log_ct", t).expand(-1, k - 1, n),
                           torch.zeros(b, 1, n, device=log_x_t.device)], dim=1)
    log_qt_one = torch.where(mask, ct_vector, log_qt_one)

    q = torch.cat([log_x_start[:, :-1] - log_qt, log_zero], dim=1)
    q_log_sum_exp = torch.logsumexp(q, dim=1, keepdim=True)
    q = q - q_log_sum_exp
    log_ev = q_pred(sched, q, t - 1) + log_qt_one + q_log_sum_exp
    return log_ev.clamp(LOG_EPS, 0)


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms in [0, 1)."""
    return -torch.log(-torch.log(u + 1e-30) + 1e-30)


def pick(log_probs: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The Gumbel-max sample [B, N] of log-probabilities [B, K, N]."""
    return (noise + log_probs).argmax(1)
