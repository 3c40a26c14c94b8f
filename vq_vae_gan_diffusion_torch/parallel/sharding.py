"""The GPT prior's parameter sharding over the ``('data', 'model')`` mesh
(the port's counterpart of the JAX ``parallel/mesh.py`` rules and
``train/vq_transformer_worker.py``'s ``place_on_mesh``).

``trainer.<model>.param_sharding`` takes:

- ``replicated`` (``none``, ``""``): every rank holds every parameter, the
  gradients averaged by :func:`.mesh.reduce_gradients`;
- ``tp``: Megatron's split over ``model`` through
  ``torch.distributed.tensor.parallel``. ``query``, ``key``, ``value``,
  ``mlp.0`` (JAX's fc1) and the vocab ``head`` are column-parallel, ``proj``
  and ``mlp.2`` (fc2) row-parallel. JAX's ``P(None, 'model')`` on an [in,
  out] kernel is ``Shard(0)`` of torch's [out, in] weight; the attention
  runs on ``n_head / mp`` local heads. Unlike the JAX rule, which leaves
  every bias replicated and lets GSPMD slice it, a column-parallel layer's
  bias is sharded with its outputs (``ColwiseParallel``); the head's
  logits are gathered whole;
- ``fsdp``: FSDP2 ``fully_shard`` over ``data``, each ``Block`` and then the
  root, on the dimension JAX's rule picks (the largest that ``data``
  divides and that holds at least two rows a rank, not the one ``tp``
  took). JAX keeps a leaf under 2^14 elements replicated; FSDP2 shards every
  parameter of a module it wraps, so such a leaf is sharded on dim 0;
- ``tp_fsdp`` (``fsdp_tp``): both, on the 2-D mesh.

On a GPT whose ``act_sharding`` is set (sequence parallelism), ``tp`` is
Megatron-SP, as the JAX module's ``act_sharding`` constraint over ``tp``
parameters: the LayerNorms take ``SequenceParallel()``, the
column-parallel layers gather the sequence (``input_layouts=Shard(1)``),
the row-parallel layers reduce-scatter onto it (``output_layouts=
Shard(1)``), and the head gathers it and returns whole logits; the GPT's
forward then runs none of its own gathers.

AdamW is built after the sharding, so its moments are sharded like their
parameters. Anything else raises ``ValueError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

from torch import nn

from .mesh import DATA_AXIS, MODEL_AXIS

FSDP_MIN_SIZE = 2 ** 14
_COLUMN_PARALLEL = ("attn.query", "attn.key", "attn.value", "mlp.0")
_ROW_PARALLEL = ("attn.proj", "mlp.2")


class ShardingPlan(NamedTuple):
    """Which of tensor parallelism (over ``model``) and FSDP (over
    ``data``) a mode turns on."""

    tp: bool
    fsdp: bool


def resolve_sharding_rules(mode: Optional[str]) -> Optional[ShardingPlan]:
    """A config's ``param_sharding`` -> None (replicated) or the
    :class:`ShardingPlan` of ``tp``, ``fsdp`` or ``tp_fsdp`` / ``fsdp_tp``;
    anything else raises ``ValueError``, as the JAX package's (which also
    takes the mesh: here :func:`shard_gpt` does)."""
    mode = (mode or "replicated").lower()
    if mode in ("replicated", "none", ""):
        return None
    plans = {"tp": ShardingPlan(True, False), "fsdp": ShardingPlan(False, True),
             "tp_fsdp": ShardingPlan(True, True), "fsdp_tp": ShardingPlan(True, True)}
    if mode not in plans:
        raise ValueError(f"unknown param_sharding mode {mode!r}")
    return plans[mode]


def gpt_param_sharding_rules(name: str, shape: Sequence[int]) -> Optional[int]:
    """The dimension of the port GPT's parameter ``name`` that tensor
    parallelism shards over ``model``: 0 for a column-parallel weight (and
    its bias), 1 for a row-parallel weight; None for the rest (replicated,
    a row-parallel bias included)."""
    module, _, leaf = name.rpartition(".")
    if module == "head" or any(module.endswith(m) for m in _COLUMN_PARALLEL):
        return 0
    if leaf == "weight" and len(shape) == 2 and any(module.endswith(m) for m in _ROW_PARALLEL):
        return 1
    return None


def fsdp_dim(shape: Sequence[int], n: int, taken: Optional[int] = None,
             min_size: int = FSDP_MIN_SIZE) -> Optional[int]:
    """JAX's FSDP rule: the largest dimension that ``n`` data ranks divide,
    with at least two rows a rank, and that tensor parallelism did not take
    (``taken``); None for a leaf under ``min_size`` elements, or where no
    dimension fits (JAX then keeps it replicated)."""
    numel = 1
    for s in shape:
        numel *= int(s)
    if n <= 1 or numel < min_size:
        return None
    for d in sorted(range(len(shape)), key=lambda d: shape[d], reverse=True):
        if d != taken and shape[d] % n == 0 and shape[d] >= 2 * n:
            return d
    return None


def shard_gpt(gpt: nn.Module, mesh, plan: ShardingPlan) -> nn.Module:
    """Shard ``gpt`` (a :class:`..models.mingpt.GPT` on its device) in place
    by ``plan`` over ``mesh``; returns it. The attention's head count
    becomes the local one under tensor parallelism."""
    from torch.distributed.tensor import Replicate, Shard

    mp = mesh.size(1)
    if plan.tp:
        from torch.distributed.tensor.parallel import (ColwiseParallel, RowwiseParallel,
                                                       parallelize_module)

        if gpt.n_head % mp:
            raise ValueError(f"n_head {gpt.n_head} not divisible by model_parallel={mp}")
        if gpt.act_sharding is not None:       # Megatron-SP
            from torch.distributed.tensor.parallel import SequenceParallel

            layers = {**{m: ColwiseParallel(input_layouts=Shard(1)) for m in _COLUMN_PARALLEL},
                      **{m: RowwiseParallel(output_layouts=Shard(1)) for m in _ROW_PARALLEL},
                      "ln1": SequenceParallel(), "ln2": SequenceParallel()}
            top = {"ln_f": SequenceParallel(),
                   "head": ColwiseParallel(input_layouts=Shard(1), output_layouts=Replicate())}
        else:
            layers = {**{m: ColwiseParallel() for m in _COLUMN_PARALLEL},
                      **{m: RowwiseParallel() for m in _ROW_PARALLEL}}
            top = {"head": ColwiseParallel(output_layouts=Replicate())}
        for block in gpt.blocks:
            parallelize_module(block, mesh[MODEL_AXIS], layers)
            block.attn.n_head //= mp
        parallelize_module(gpt, mesh[MODEL_AXIS], top)
    if plan.fsdp:
        from torch.distributed.fsdp import fully_shard

        names = {id(p): n for n, p in gpt.named_parameters()}
        n = mesh.size(0)

        def placement(p) -> Shard:
            name, shape = names[id(p)], tuple(p.shape)
            taken = gpt_param_sharding_rules(name, shape) if plan.tp else None
            if len(shape) == 2 and name != "tok_emb.weight":     # JAX's [in, out] kernel
                d = fsdp_dim(shape[::-1], n, None if taken is None else 1 - taken)
                d = None if d is None else 1 - d
            else:
                d = fsdp_dim(shape, n, taken)
            return Shard(0 if d is None else d)
        for block in gpt.blocks:
            fully_shard(block, mesh=mesh[DATA_AXIS], shard_placement_fn=placement)
        fully_shard(gpt, mesh=mesh[DATA_AXIS], shard_placement_fn=placement)
    return gpt
