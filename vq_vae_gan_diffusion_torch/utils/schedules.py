"""torch's ``OneCycleLR`` learning rate and momentum as functions of the step
(PyTorch counterpart of the JAX ``utils/schedules.py``).

The reference pairs AdamW with ``OneCycleLR(opt, lr, total_steps,
pct_start=0.25, anneal_strategy='cos')`` in its diffusion workers. Its
default ``cycle_momentum=True`` drives Adam's beta1 from 0.95 to 0.85 and
back, inverse to the lr, and so overrides the beta1 the config gives.

This is a copy of the JAX function's float32 arithmetic, not
``torch.optim.lr_scheduler.OneCycleLR``: that class raises once it steps
past ``total_steps`` (``--epochs`` above ``trainer.num_epochs``), where
these functions hold the last value, as the JAX package's do. The caller
sets each param group's ``lr`` and ``betas[0]`` to the values of the
update's count before each optimizer update (update k reads step k, as
torch's ``scheduler.step()`` after ``optimizer.step()`` gives it).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np

_F = np.float32


def _annealing_cos(start: float, end: float, pct: np.float32) -> np.float32:
    """Cosine from ``start`` to ``end`` as ``pct`` goes 0 -> 1, in float32.
    The cosine is float64's rounded to float32, which XLA's float32 cosine
    equals far more often than numpy's or torch's float32 one does."""
    cos_out = _F(np.cos(np.float64(_F(math.pi) * pct))) + _F(1.0)
    return _F(end) + _F((start - end) / 2.0) * cos_out


def torch_onecycle_schedules(
    total_steps: int,
    peak_lr: float,
    pct_start: float = 0.25,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
    base_momentum: float = 0.85,
    max_momentum: float = 0.95,
) -> Tuple[Callable[[int], float], Callable[[int], float]]:
    """(lr_fn, beta1_fn), each step -> value. Raises where ``pct_start *
    total_steps <= 1``: torch would put every step in the annealing phase
    there, and the warm-up's clamp would hold step 0 at the initial lr."""
    total_steps = int(total_steps)
    if pct_start * total_steps <= 1.0:
        raise ValueError(
            f"total_steps={total_steps} too small for pct_start={pct_start}: "
            "torch-exactness needs pct_start*total_steps > 1")
    initial_lr = peak_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up_end = float(pct_start * total_steps) - 1.0
    down_len = max(float(total_steps - 1) - up_end, 1e-6)

    def interp(step: int, start_a: float, end_a: float, start_b: float, end_b: float) -> float:
        s = _F(step)
        if s <= _F(up_end):
            return float(_annealing_cos(start_a, end_a, np.clip(s / _F(up_end), _F(0), _F(1))))
        pct = np.clip((s - _F(up_end)) / _F(down_len), _F(0), _F(1))
        return float(_annealing_cos(start_b, end_b, pct))

    def lr_fn(step: int) -> float:
        return interp(step, initial_lr, peak_lr, peak_lr, min_lr)

    def b1_fn(step: int) -> float:
        return interp(step, max_momentum, base_momentum, base_momentum, max_momentum)

    return lr_fn, b1_fn
