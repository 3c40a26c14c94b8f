"""GPipe pipeline parallelism for the GPT prior (the port's counterpart of the
JAX ``parallel/pipeline.py``).

The block stack is split into S contiguous stages over the ``pipe`` axis of
a ``('data', 'pipe')`` mesh; microbatches stream through the stages, a
point-to-point hop carrying each stage's output to its right-hand
neighbour. The names are the JAX package's:

- :func:`stack_block_params` turns the GPT's ``state_dict`` into block
  leaves of shape [S, L/S, ...] (stage-major, layer-minor) and the rest
  (embeddings, ``ln_f``, ``head``); :func:`shard_stacked` builds a rank's
  stage, an ``nn.ModuleList`` of its L/S blocks. In PyTorch a stage is a
  module a rank holds, not the slice of one sharded array;
- :func:`pipeline_apply` is JAX's tick loop: ``n_micro + S - 1`` ticks, in
  each stage 0 takes microbatch ``min(t, n_micro - 1)`` (``torch.where`` on
  the stage index, so every received carry stays in every rank's autograd
  graph), every stage applies its blocks and hops the result right. The
  final tick's hop is skipped on every rank alike. The last stage's
  outputs are summed over ``pipe`` with zeros from the other stages (JAX's
  ``psum``), so the code after the pipeline is ordinary replicated code;
- it is differentiable: ``loss.backward()`` runs the hops in reverse, the
  all-forward-then-all-backward GPipe schedule that ``jax.grad`` gives.
  The broadcast's backward hands each rank its own gradient back, without
  a sum over ``pipe``: every rank computes the same loss on the same
  logits, so a sum would make the stack's gradients S times too large;
- :func:`make_pipeline_train_step`: the next-token cross-entropy step. The
  optimizer is built over the rank's stage and ``rest`` only, so the
  stack's moments live on their stage. The embeddings' gradients, which
  only stage 0's injected microbatches produce, are summed over ``pipe``;
  ``ln_f``'s and ``head``'s, which every pipe rank has whole, are not.
  Then every gradient is averaged over ``data``.

The hop posts the send and the receive in one ``dist.batch_isend_irecv``.
Its transport is chosen from the group's backend before the call
(:func:`hop_transport`): NCCL carries the tensor on the device; gloo, a
host transport, through host memory. A one-stage pipeline does no hop:
JAX's ``ppermute`` from 0 to 0 is the identity, and gloo cannot send to
its own rank. Without a process group the mesh is None and the pipeline
has one stage.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .mesh import DATA_AXIS, all_reduce_mean, all_reduce_sum, shard_batch

PIPE_AXIS = "pipe"
Tensors = Dict[str, torch.Tensor]

_MESHES: dict = {}              # n_stages -> the DeviceMesh of create_pipeline_mesh
_EMBEDDINGS = ("tok_emb.weight", "pos_emb")


def create_pipeline_mesh(n_stages: int):
    """The ``DeviceMesh`` of shape (W / S, S) named ``("data", "pipe")`` over
    the process group's W ranks: rank r at data index r // S and stage
    r % S, as JAX's ``reshape(n // S, S)``. Raises where S does not divide
    W; None without a group. Built once a process and S."""
    if not dist.is_initialized():
        return None
    n, s = dist.get_world_size(), int(n_stages)
    if n % s != 0:
        raise ValueError(f"{n} devices not divisible by n_stages={s}")
    if s not in _MESHES:
        from torch.distributed.device_mesh import init_device_mesh

        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        _MESHES[s] = init_device_mesh(kind, (n // s, s), mesh_dim_names=(DATA_AXIS, PIPE_AXIS))
    return _MESHES[s]


def pipe_shape(mesh) -> Tuple[int, int]:
    """(this rank's stage, the number of stages) of ``mesh``; (0, 1) for None."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(PIPE_AXIS), mesh.size(1)


def hop_transport(mesh) -> str:
    """How a hop over ``mesh``'s ``pipe`` group moves its tensor, from the
    group's backend: ``"device"`` under NCCL, ``"host"`` under gloo (a copy
    through host memory, a no-op for CPU tensors); ``"none"`` for one
    stage."""
    if pipe_shape(mesh)[1] == 1:
        return "none"
    return "device" if dist.get_backend(mesh.get_group(PIPE_AXIS)) == "nccl" else "host"


# -- stacking the block leaves ---------------------------------------------------------------

def stack_block_params(state: Tensors, n_layer: int, n_stages: int) -> Tuple[Tensors, Tensors]:
    """The port GPT's ``state_dict`` -> (stacked, rest): every
    ``blocks.{i}.<leaf>`` becomes ``stacked[<leaf>]`` of shape
    [S, L/S, ...], stage-major and layer-minor; ``rest`` holds
    ``tok_emb``, ``pos_emb``, ``ln_f`` and ``head``, copied. Raises where S
    does not divide L."""
    if n_layer % n_stages != 0:
        raise ValueError(f"n_layer={n_layer} not divisible by n_stages={n_stages}")
    per = n_layer // n_stages
    leaves = [k[len("blocks.0."):] for k in state if k.startswith("blocks.0.")]
    stacked = {leaf: torch.stack([state[f"blocks.{i}.{leaf}"] for i in range(n_layer)])
               .reshape(n_stages, per, *state[f"blocks.0.{leaf}"].shape) for leaf in leaves}
    rest = {k: v.detach().clone() for k, v in state.items() if not k.startswith("blocks.")}
    return stacked, rest


def unstack_block_params(stacked: Tensors, rest: Tensors) -> Tensors:
    """Inverse of :func:`stack_block_params`: a ``state_dict`` a ``GPT``
    loads."""
    s, per = next(iter(stacked.values())).shape[:2]
    state = dict(rest)
    for i in range(s * per):
        for leaf, t in stacked.items():
            state[f"blocks.{i}.{leaf}"] = t[i // per, i % per]
    return state


def shard_stacked(stacked: Tensors, mesh, n_head: int) -> nn.ModuleList:
    """This rank's stage: an ``nn.ModuleList`` of its L/S ``Block``s loaded
    from ``stacked[stage]``, on the stacked leaves' device."""
    from ..models.mingpt import Block

    stage, s = pipe_shape(mesh)
    ln1 = stacked["ln1.weight"]
    if ln1.shape[0] != s:
        raise ValueError(f"stacked for {ln1.shape[0]} stages on a pipe of {s}")
    per, c = ln1.shape[1], ln1.shape[2]
    with torch.device("meta"):
        blocks = nn.ModuleList(Block(n_head, c, stacked["attn.mask"].shape[-1])
                               for _ in range(per))
    blocks = blocks.to_empty(device=ln1.device)
    blocks.load_state_dict({f"{j}.{leaf}": t[stage, j] for leaf, t in stacked.items()
                            for j in range(per)})
    return blocks


def gather_stacked(stage: nn.ModuleList, mesh) -> Tensors:
    """Every rank's stage gathered over ``pipe``: the stacked leaves
    [S, L/S, ...] of :func:`stack_block_params`, on every rank of the
    pipe."""
    states = [b.state_dict() for b in stage]
    local = {leaf: torch.stack([st[leaf] for st in states]) for leaf in states[0]}
    _, s = pipe_shape(mesh)
    if s == 1:
        return {leaf: t[None] for leaf, t in local.items()}
    group = mesh.get_group(PIPE_AXIS)
    out = {}
    for leaf, t in local.items():
        parts = [torch.empty_like(t) for _ in range(s)]
        dist.all_gather(parts, t.contiguous(), group=group)
        out[leaf] = torch.stack(parts)
    return out


# -- the schedule ----------------------------------------------------------------------------

def _exchange(x: torch.Tensor, to: int, frm: int, group, host: bool) -> torch.Tensor:
    """Send ``x`` to global rank ``to`` and receive its like from ``frm``,
    both posted at once."""
    send = (x.cpu() if host else x).contiguous()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, to, group),
                                       dist.P2POp(dist.irecv, recv, frm, group)]):
        req.wait()
    return recv.to(x.device)


class _Hop(torch.autograd.Function):
    """The right-hand shift over ``pipe`` (JAX's ``ppermute`` i -> i + 1 mod
    S); its backward shifts the gradient left."""

    @staticmethod
    def forward(ctx, x, group, right, left, host):
        ctx.peers = group, right, left, host
        hop.calls += 1
        return _exchange(x, right, left, group, host)

    @staticmethod
    def backward(ctx, grad):
        group, right, left, host = ctx.peers
        hop.grad_calls += 1
        return _exchange(grad, left, right, group, host), None, None, None, None


def hop(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` of stage i arrives at stage i + 1 (mod S), differentiably.
    Counts ``hop.calls``, and ``hop.grad_calls`` in the backward."""
    stage, s = pipe_shape(mesh)
    group = mesh.get_group(PIPE_AXIS)
    right = dist.get_global_rank(group, (stage + 1) % s)
    left = dist.get_global_rank(group, (stage - 1) % s)
    return _Hop.apply(x, group, right, left, hop_transport(mesh) == "host")


hop.calls = 0
hop.grad_calls = 0


class _FromLast(torch.autograd.Function):
    """The sum over ``pipe`` of the last stage's outputs and the other
    stages' zeros; the backward is each rank's own gradient, unsummed."""

    @staticmethod
    def forward(ctx, y, group):
        out = y.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def pipeline_apply(gpt: nn.Module, stage: nn.ModuleList, x: torch.Tensor, mesh,
                   n_micro: int) -> torch.Tensor:
    """The block stack over ``x`` [b, T, C], this data rank's rows, by the
    GPipe schedule; returns the stack's output [b, T, C] on every pipe rank.
    Raises where ``n_micro`` does not divide b. ``gpt.remat`` recomputes
    each stage's activations in the backward."""
    idx, s = pipe_shape(mesh)
    b = x.shape[0]
    if b % n_micro != 0 or b < n_micro:
        raise ValueError(f"per-data-shard batch {b} (over |data|="
                         f"{1 if mesh is None else mesh.size(0)}) must be a multiple of "
                         f"n_micro={n_micro}")
    micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    first = torch.tensor(idx == 0, device=x.device)
    remat = getattr(gpt, "remat", False) and torch.is_grad_enabled()

    def apply_stage(h):
        for block in stage:
            h = checkpoint(block, h, use_reentrant=False) if remat else block(h)
        return h

    ticks = n_micro + s - 1
    carry = torch.zeros_like(micro[0])
    ys = []
    for t in range(ticks):
        out = apply_stage(torch.where(first, micro[min(t, n_micro - 1)], carry))
        if t >= s - 1:
            ys.append(out)
        if t < ticks - 1 and s > 1:
            carry = hop(out, mesh)
    y = torch.stack(ys)
    if s == 1:
        return y.reshape(x.shape)
    # the other stages' zeros keep their outputs, and so every hop, in the
    # graph of the loss: their backward reaches each hop as the last stage's
    y = torch.where(torch.tensor(idx == s - 1, device=x.device), y, torch.zeros_like(y))
    return _FromLast.apply(y, mesh.get_group(PIPE_AXIS)).reshape(x.shape)


def pipelined_gpt_logits(gpt: nn.Module, stage: nn.ModuleList, rest: Tensors,
                         idx: torch.Tensor, mesh, n_micro: int) -> torch.Tensor:
    """The GPT's logits [b, T, vocab] of this data rank's rows of the global
    ``idx`` [B, T], the stack pipelined: the embeddings, then
    :func:`pipeline_apply`, then ``ln_f`` (eps 1e-5) and the bias-free head,
    on every pipe rank."""
    idx = shard_batch(idx, mesh)
    t = idx.shape[1]
    x = F.embedding(idx, rest["tok_emb.weight"]) + rest["pos_emb"][:, :t]
    x = pipeline_apply(gpt, stage, x, mesh, n_micro)
    x = F.layer_norm(x, (x.shape[-1],), rest["ln_f.weight"], rest["ln_f.bias"], eps=1e-5)
    return F.linear(x, rest["head.weight"])


@torch.no_grad()
def reduce_pipeline_gradients(stage: nn.ModuleList, rest: Tensors, mesh) -> None:
    """The gradients of a pipelined step made whole: the embeddings' summed
    over ``pipe`` (only stage 0 has them), then every gradient averaged over
    ``data``. Nothing where ``mesh`` is None."""
    if mesh is None:
        return
    if mesh.size(1) > 1:
        all_reduce_sum([rest[k].grad for k in _EMBEDDINGS], mesh.get_group(PIPE_AXIS))
    all_reduce_mean([p.grad for p in [*stage.parameters(), *rest.values()]
                     if p.grad is not None], mesh)


def make_pipeline_train_step(gpt: nn.Module, opt_factory: Callable, mesh, n_micro: int):
    """The next-token cross-entropy step over pipeline parameters:
    ``step(params, opt, idx, targets) -> (params, opt, loss)`` with
    ``params = (stage, rest)`` updated in place, the global ``idx`` and
    ``targets`` [B, T] and the loss the global batch's mean. ``opt`` None
    builds the optimizer, ``opt_factory(parameters)``, over the stage and
    ``rest`` (whose tensors become leaves that require grad), so the
    stack's moments live only on their stage. The gradients stay in
    ``.grad`` after the step."""

    def step(params, opt, idx: torch.Tensor, targets: torch.Tensor):
        stage, rest = params
        if opt is None:
            for v in rest.values():
                v.requires_grad_(True)
            opt = opt_factory([*stage.parameters(), *rest.values()])
        opt.zero_grad(set_to_none=True)
        logits = pipelined_gpt_logits(gpt, stage, rest, idx, mesh, n_micro)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               shard_batch(targets, mesh).reshape(-1))
        loss.backward()
        reduce_pipeline_gradients(stage, rest, mesh)
        opt.step()
        loss = loss.detach().reshape(1)
        all_reduce_mean([loss], mesh)
        return params, opt, loss[0]

    return step
