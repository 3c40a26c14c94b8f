"""Data parallelism and the GPT prior's parameter sharding over a
``('data', 'model')`` mesh (:mod:`.mesh`)."""

from .mesh import (DATA_AXIS, MODEL_AXIS, all_gather_rows, all_reduce_mean, any_rank, barrier,
                   batch_norm_train, batch_rows, broadcast_generator, broadcast_object,
                   create_mesh, data_group, data_rows, data_shape, draw_rows, init_distributed,
                   is_rank0, pad_to_multiple, reduce_gradients, replicate, shard_batch,
                   sync_batch_stats)
from .sharding import (ShardingPlan, fsdp_dim, gpt_param_sharding_rules, resolve_sharding_rules,
                       shard_gpt)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "all_gather_rows", "all_reduce_mean", "any_rank",
           "barrier", "batch_norm_train", "batch_rows", "broadcast_generator",
           "broadcast_object", "create_mesh", "data_group", "data_rows", "data_shape",
           "draw_rows", "init_distributed", "is_rank0", "pad_to_multiple", "reduce_gradients",
           "replicate", "resolve_sharding_rules", "shard_batch", "shard_gpt", "ShardingPlan",
           "fsdp_dim", "gpt_param_sharding_rules", "sync_batch_stats"]
