"""The optimisers of the two training steps, float32:

- AdamW as torch defines it: p <- p (1 - lr wd), then the bias-corrected
  Adam step lr m_hat / (sqrt(v_hat) + eps), the bias corrections taken with
  the step's own beta1 and beta2;
- torch's ``OneCycleLR(total_steps, max_lr, pct_start 0.25, cos)`` as two
  functions of the update count: the lr from max_lr / 25 up to max_lr and
  down to max_lr / 25e4, and beta1 from 0.95 to 0.85 and back (its default
  ``cycle_momentum``), in float32;
- the EMA ema <- decay ema + (1 - decay) p, with the BatchNorm statistics
  copied.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

_F = np.float32


class AdamW:
    def __init__(self, groups: List[Dict], lr: float, betas: Tuple[float, float],
                 eps: float = 1e-8):
        self.groups = [dict(g) for g in groups]
        self.lr, self.betas, self.eps = lr, betas, eps
        self.state: Dict[int, Dict[str, torch.Tensor]] = {}
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for g in self.groups:
            for p in g["params"]:
                st = self.state.setdefault(id(p), {"m": torch.zeros_like(p),
                                                   "v": torch.zeros_like(p)})
                p.mul_(1 - self.lr * g["weight_decay"])
                st["m"].mul_(b1).add_(p.grad, alpha=1 - b1)
                st["v"].mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
                denom = st["v"].sqrt() / math.sqrt(c2) + self.eps
                p.addcdiv_(st["m"], denom, value=-self.lr / c1)


def _cos(start: float, end: float, pct) -> float:
    return float(_F(end) + _F((start - end) / 2.0) *
                 (_F(np.cos(np.float64(_F(math.pi) * pct))) + _F(1.0)))


def onecycle(total: int, max_lr: float, step: int) -> Tuple[float, float]:
    """(lr, beta1) of update ``step`` (0-based)."""
    up_end = float(0.25 * total) - 1.0
    down = max(float(total - 1) - up_end, 1e-6)
    s = _F(step)
    if s <= _F(up_end):
        pct = np.clip(s / _F(up_end), _F(0), _F(1))
        return _cos(max_lr / 25, max_lr, pct), _cos(0.95, 0.85, pct)
    pct = np.clip((s - _F(up_end)) / _F(down), _F(0), _F(1))
    return _cos(max_lr, max_lr / 25 / 1e4, pct), _cos(0.85, 0.95, pct)


@torch.no_grad()
def ema_update(ema: Iterable[torch.Tensor], params: Iterable[torch.Tensor],
               decay: float) -> None:
    for e, p in zip(ema, params):
        e.mul_(decay).add_(p, alpha=1 - decay)
