"""Process groups, the ``('data', 'model')`` mesh and the collectives of data
parallelism (the port's counterpart of the JAX ``parallel/mesh.py``).

The JAX package shards each batch over the mesh's ``data`` axis and lets
XLA sum the gradients, take BatchNorm's statistics over the whole batch and
scatter VQ_Official's history in global row order. Here each of those is
an explicit collective over the data ranks:

- :func:`init_distributed` joins the process group ``torchrun`` describes
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``): NCCL on ``cuda:LOCAL_RANK``,
  gloo only on the CPU. Without those variables there is no group and
  every path runs as a single process;
- :func:`create_mesh` builds the ``DeviceMesh`` of shape (W / mp, mp);
- :func:`shard_batch` keeps a data rank's rows of the global batch, and
  :func:`draw_rows` (inside :func:`data_rows`) makes each random draw of a
  training step the global batch's draw, of which a rank keeps its rows;
- :func:`all_reduce_mean` (gradients, metrics), :func:`all_gather_rows`
  (VQ_Official's history) and :func:`sync_batch_stats` (train-mode
  BatchNorm) are the collectives; each adds one to its ``calls`` a call,
  as the kernel wrappers count their launches (the statistics' backward
  all-reduces to ``sync_batch_stats.grad_calls``).

The config's batch is the global batch: a step over N data ranks gives what
a single process gives on the whole batch, up to the order of reductions.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"

_MESHES: dict = {}                      # model_parallel -> the DeviceMesh of create_mesh
_HOST: list = []                         # the gloo group of the host-side control collectives
_ROWS: Optional[Tuple[int, int]] = None  # (data rank, data size) inside data_rows


def init_distributed(device: Optional[str] = None) -> torch.device:
    """The device of this process, joining the process group ``torchrun``
    describes where ``RANK`` and ``WORLD_SIZE`` are set: NCCL on
    ``cuda:LOCAL_RANK``, gloo under ``device="cpu"``. A group already up
    (a caller's) is kept. Without the variables: no group, the device of
    :func:`..utils.resolve_device`. A failed join raises: no rank goes on
    alone."""
    from ..utils import resolve_device

    dev = resolve_device(device)
    if dist.is_initialized():
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev)
    else:
        dist.init_process_group("gloo")
    return dev


def create_mesh(model_parallel: int = 1):
    """The ``DeviceMesh`` of shape (W / mp, mp) named ``("data", "model")``
    over the process group's W ranks, or None without a group. Raises where
    mp does not divide W, as the JAX package. The mesh is built once a
    process and ``model_parallel``."""
    if not dist.is_initialized():
        return None
    n, mp = dist.get_world_size(), int(model_parallel)
    if n % mp != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={mp}")
    if mp not in _MESHES:
        from torch.distributed.device_mesh import init_device_mesh

        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        _MESHES[mp] = init_device_mesh(kind, (n // mp, mp),
                                       mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
        if not _HOST:
            _HOST.append(dist.new_group(backend="gloo") if kind == "cuda" else dist.group.WORLD)
    return _MESHES[mp]


def _host_group():
    """The gloo group over every rank that carries the host's control
    collectives (flags, objects, generator states, barriers), so none of
    them waits on the device."""
    return _HOST[0] if _HOST else dist.group.WORLD


def data_group():
    """The process group of this rank's data ranks (the mesh's ``data``
    axis; the whole world where no mesh was built), or None without a
    group."""
    if not dist.is_initialized():
        return None
    if _MESHES:
        return next(iter(_MESHES.values())).get_group(DATA_AXIS)
    return dist.group.WORLD


def data_shape(mesh) -> Tuple[int, int]:
    """(this rank's data index, the data size) of ``mesh``; (0, 1) for None."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(DATA_AXIS), mesh.size(0)


def batch_rows(batch_size: int, rank: int, size: int) -> slice:
    """The rows of a global batch of ``batch_size`` that data rank ``rank``
    of ``size`` holds: ``[r B / D, (r + 1) B / D)``. Raises where D does
    not divide B."""
    if batch_size % size != 0:
        raise ValueError(f"batch of {batch_size} not divisible by {size} data ranks")
    n = batch_size // size
    return slice(rank * n, (rank + 1) * n)


def shard_batch(batch, mesh):
    """This rank's rows of the global ``batch`` (a tensor or array, rows
    first): data rank r of D keeps ``[r B / D, (r + 1) B / D)``; ranks on
    one data index (model parallel) hold the same rows. ``batch`` itself
    where ``mesh`` is None."""
    if mesh is None:
        return batch
    return batch[batch_rows(batch.shape[0], *data_shape(mesh))]


def pad_to_multiple(batch, multiple: int):
    """(``batch`` with its rows padded up to a multiple of ``multiple`` by
    repeating the last row, the real count), as the JAX package's."""
    b = batch.shape[0]
    rem = (-b) % multiple
    if rem:
        if isinstance(batch, torch.Tensor):
            batch = torch.cat([batch, batch[-1:].expand(rem, *batch.shape[1:])])
        else:
            batch = np.concatenate([batch, np.repeat(batch[-1:], rem, axis=0)])
    return batch, b


def _tensors(module_or_tensors) -> List[torch.Tensor]:
    if isinstance(module_or_tensors, nn.Module):
        return [*module_or_tensors.parameters(), *module_or_tensors.buffers()]
    return list(module_or_tensors)


@torch.no_grad()
def replicate(module_or_tensors: Union[nn.Module, Iterable[torch.Tensor]], mesh) -> None:
    """Broadcast every parameter and buffer (or tensor) from rank 0, in
    place, so every rank starts from rank 0's state. Sharded parameters
    (``DTensor``) are left as they are. Nothing where ``mesh`` is None."""
    if mesh is None:
        return
    from torch.distributed.tensor import DTensor

    for t in _tensors(module_or_tensors):
        if not isinstance(t, DTensor):
            dist.broadcast(t.data, src=0)


def broadcast_object(obj: Any, mesh) -> Any:
    """Rank 0's ``obj`` on every rank (``obj`` itself where ``mesh`` is
    None)."""
    if mesh is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_host_group())
    return box[0]


def broadcast_generator(generator: torch.Generator, mesh) -> None:
    """Rank 0's state of ``generator`` on every rank: rank 0's sampling
    hooks draw from it, the other ranks' draws must stay in step."""
    if mesh is None:
        return
    state = generator.get_state()
    dist.broadcast(state, src=0, group=_host_group())
    generator.set_state(state)


@torch.no_grad()
def all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> None:
    """Replace each of ``tensors`` (one dtype) by its sum over ``group``, in
    place, in one all-reduce of their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


@torch.no_grad()
def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh) -> None:
    """Replace each of ``tensors`` by its mean over the data ranks, in place,
    in one all-reduce of their concatenation (one a dtype). A ``DTensor`` contributes its
    local shard (its model ranks hold the rest). Nothing where ``mesh`` is
    None or ``tensors`` is empty."""
    if mesh is None or not tensors:
        return
    from torch.distributed.tensor import DTensor

    local = [t.to_local() if isinstance(t, DTensor) else t for t in tensors]
    for dtype in dict.fromkeys(t.dtype for t in local):     # one call a dtype, in order
        part = [t for t in local if t.dtype == dtype]
        all_reduce_mean.calls += 1
        all_reduce_sum(part, mesh.get_group(DATA_AXIS))
        for t in part:
            t /= mesh.size(0)


all_reduce_mean.calls = 0


def reduce_gradients(params: Iterable[torch.Tensor], mesh) -> None:
    """The gradients of ``params`` (those that have one) averaged over the
    data ranks: the single-process gradient of the global batch's mean
    loss. Called after ``backward()`` and before the optimizer, so
    accumulation and clipping see the global gradient."""
    all_reduce_mean([p.grad for p in params if p.grad is not None], mesh)


def all_gather_rows(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each of ``tensors`` [b, ...] gathered over the data ranks in global
    row order ([D b, ...]), inside :func:`data_rows`; the tensors
    themselves outside it."""
    if _ROWS is None:
        return list(tensors)
    group = data_group()
    out = []
    for t in tensors:
        all_gather_rows.calls += 1
        parts = [torch.empty_like(t) for _ in range(_ROWS[1])]
        dist.all_gather(parts, t.contiguous(), group=group)
        out.append(torch.cat(parts))
    return out


all_gather_rows.calls = 0


class _AllReduceSum(torch.autograd.Function):
    """A sum over the data ranks whose backward is the sum of the gradients
    over them: each rank's input gradient is then the gradient of the sum
    of every rank's loss."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        sync_batch_stats.grad_calls += 1
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sync_batch_stats(x: torch.Tensor) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The per-channel mean and biased variance of ``x`` [B, C, H, W] over
    every data rank's rows, differentiable, or None without a process
    group. One all-reduce of the count, sum and sum of squares (world size
    1 included); the variance is ``E[x²] - mean²`` clamped at 0, as flax
    computes it."""
    group = data_group()
    if group is None:
        return None
    sync_batch_stats.calls += 1
    c = x.shape[1]
    count = torch.full((1,), x.numel() / c, dtype=x.dtype, device=x.device)
    local = torch.cat([count, x.sum((0, 2, 3)), (x * x).sum((0, 2, 3))])
    total = _AllReduceSum.apply(local, group)
    n = total[0]
    mean, ex2 = total[1:c + 1] / n, total[c + 1:] / n
    return mean, torch.clamp(ex2 - mean * mean, min=0.0)


sync_batch_stats.calls = 0
sync_batch_stats.grad_calls = 0       # the all-reduces of the statistics' gradients


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d, momentum: Optional[float]
                     ) -> torch.Tensor:
    """Train-mode BatchNorm of ``x`` [B, C, H, W] (f32) on the batch's
    statistics, the global batch's under a process group
    (:func:`sync_batch_stats`); where ``momentum`` is given, ``bn``'s
    running statistics move by it (``running += momentum * (batch -
    running)``) with the biased variance. Without a group, the
    single-process path the workers always ran."""
    stats = sync_batch_stats(x)
    if stats is None:
        if momentum is not None:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
                bn.running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
                bn.running_var.mul_(1 - momentum).add_(var, alpha=momentum)
        return F.batch_norm(x, None, None, bn.weight, bn.bias, training=True, eps=bn.eps)
    mean, var = stats
    if momentum is not None:
        with torch.no_grad():
            bn.running_mean.mul_(1 - momentum).add_(mean.detach(), alpha=momentum)
            bn.running_var.mul_(1 - momentum).add_(var.detach(), alpha=momentum)
    shape = (1, -1, 1, 1)
    y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + bn.eps)
    return y * bn.weight.view(shape) + bn.bias.view(shape)


@contextlib.contextmanager
def data_rows(mesh):
    """Inside: :func:`draw_rows` draws the global batch and keeps this
    rank's rows, and :func:`all_gather_rows` gathers. The training step
    runs inside it; the sampling hooks, which draw their own batch, run
    outside. Nothing changes where ``mesh`` is None."""
    global _ROWS
    before = _ROWS
    _ROWS = None if mesh is None else data_shape(mesh)
    try:
        yield
    finally:
        _ROWS = before


def draw_rows(draw: Callable[[int], torch.Tensor], n: int) -> torch.Tensor:
    """``draw(n)``, a random draw of ``n`` rows; inside :func:`data_rows`,
    this rank's ``n`` rows of ``draw(n * D)``, the draw a single process
    makes for the global batch. Every rank's generator is seeded alike and
    draws the same, so the noise is the single-process noise and the
    generators stay in step."""
    if _ROWS is None:
        return draw(n)
    rank, size = _ROWS
    return draw(n * size)[rank * n:(rank + 1) * n]


def is_rank0() -> bool:
    """True in a single process and on global rank 0."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(mesh) -> None:
    """Every rank waits for the others; nothing where ``mesh`` is None."""
    if mesh is not None:
        dist.barrier(group=_host_group())


def any_rank(flag: bool, mesh) -> bool:
    """``flag`` of any rank (an all-reduce of the max): every rank takes the
    same branch. ``flag`` itself where ``mesh`` is None."""
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group())
    return bool(t.item())
