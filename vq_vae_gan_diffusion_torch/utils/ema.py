"""Exponential moving averages of a module's parameters (PyTorch counterpart
of the JAX ``utils/ema.py``): ``ema = decay * ema + (1 - decay) * params``,
and the reference's batch-adjusted decay."""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def ema_update(ema: nn.Module, module: nn.Module, decay: float) -> None:
    """Move ``ema``'s parameters toward ``module``'s, in place."""
    ema_params = [p for p in ema.parameters()]
    params = [p.detach() for p in module.parameters()]
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, params, alpha=1.0 - decay)


def adjusted_decay(base_decay: float, batch_size: int, num_samples: int,
                   ema_steps: int, epochs: int) -> float:
    """The reference gaussian3d worker's batch-adjusted decay: ``adjust =
    batch_size * ema_steps / epochs``, ``decay = 1 - (1 - base_decay) *
    adjust``, clamped to [0, 0.999999]. ``num_samples`` is unused, as in the
    JAX function."""
    adjust = batch_size * ema_steps / max(epochs, 1)
    d = 1.0 - (1.0 - base_decay) * adjust
    return min(max(d, 0.0), 0.999999)
