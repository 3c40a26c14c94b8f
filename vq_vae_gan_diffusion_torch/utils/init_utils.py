"""Parameter-init helpers (PyTorch counterpart of the JAX
``utils/init_utils.py``)."""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def torch_like_reinit(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every convolution's and linear layer's weight and bias from
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch's own default init for both
    (kaiming_uniform with a = sqrt(5) reduces to that bound), drawn from
    ``generator`` in module order. ``fan_in`` is a weight's size over its
    output axis: in_channels / groups x the window for a convolution,
    in_features for a linear layer, as the JAX function counts a flax
    kernel's. BatchNorm parameters and statistics, embeddings and every
    other leaf keep their init. Returns ``module``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)):
            bound = 1.0 / math.sqrt(max(m.weight[0].numel(), 1))
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
    return module
