"""Sequence parallelism for the GPT prior (the port's counterpart of the JAX
``GPT.act_sharding``, ``models/mingpt.py``).

In JAX the [B, T, C] activation entering every block is constrained to
``P('data', 'model', None)`` and GSPMD inserts the gathers. Here
``GPT(act_sharding=mesh)`` keeps model rank r's tokens ``[r T / mp,
(r + 1) T / mp)`` through the embedding, LayerNorm, residual and MLP
regions, and two explicit gathers over ``model`` stand for GSPMD's:

- :func:`gather_tokens`, each attention's keys and values: every rank uses
  the gathered tensor differently, so its backward is a reduce-scatter
  (the sum over ``model``, then the rank's own slice);
- :func:`gather_logits`, the logits: every rank feeds them to the same
  loss, so its backward is the rank's own slice, with no sum.

Each rank's parameter gradients then hold its own tokens' part:
:func:`reduce_sequence_gradients` sums them over ``model`` and averages
them over ``data``. The two gathers count their collectives in ``.calls``
(and, for the backward's, ``.grad_calls``), as the kernel wrappers count
their launches (:func:`..utils.tracing.counts` reads them).
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

from .mesh import MODEL_AXIS, all_reduce_mean, all_reduce_sum


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        gather_tokens.calls += 1
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        gather_tokens.grad_calls += 1
        n = dist.get_world_size(ctx.group)
        parts = torch.stack(grad.chunk(n, dim=ctx.dim))        # [n, ...], rank-major
        out = parts.new_empty(parts[0].numel())
        dist.reduce_scatter_tensor(out, parts.reshape(-1), group=ctx.group)
        return out.view(parts.shape[1:]), None, None


class _GatherLogits(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        gather_logits.calls += 1
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        own = grad.chunk(dist.get_world_size(ctx.group), dim=ctx.dim)[dist.get_rank(ctx.group)]
        return own.contiguous(), None, None


def gather_tokens(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x``, this rank's tokens along ``dim``, gathered over ``group`` in
    rank order; the backward reduce-scatters."""
    return _GatherTokens.apply(x, group, dim)


def gather_logits(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x`` gathered over ``group`` along ``dim``; the backward keeps the
    rank's own slice of the gradient."""
    return _GatherLogits.apply(x, group, dim)


gather_tokens.calls = gather_tokens.grad_calls = 0
gather_logits.calls = 0


@torch.no_grad()
def reduce_sequence_gradients(params: Iterable[torch.Tensor], mesh) -> None:
    """The gradients of ``params`` after a backward through a
    sequence-parallel forward made whole: summed over ``model`` (each rank
    saw its own tokens), then averaged over ``data``. A tensor-parallel
    parameter's (a ``DTensor``'s) gradient is whole over ``model`` already
    and is only averaged. Nothing where ``mesh`` is None."""
    if mesh is None:
        return
    from torch.distributed.tensor import DTensor

    grads = [p.grad for p in params if p.grad is not None]
    plain = [g for g in grads if not isinstance(g, DTensor)]
    if plain:
        all_reduce_sum(plain, mesh.get_group(MODEL_AXIS))
    all_reduce_mean(grads, mesh)
