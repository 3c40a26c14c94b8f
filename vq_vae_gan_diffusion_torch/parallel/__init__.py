"""Data parallelism and the GPT prior's parameter sharding over a
``('data', 'model')`` mesh (:mod:`.mesh`, :mod:`.sharding`), its pipeline
parallelism over a ``('data', 'pipe')`` mesh (:mod:`.pipeline`) and its
sequence parallelism (:mod:`.sequence`)."""

from .mesh import (DATA_AXIS, MODEL_AXIS, all_gather_rows, all_reduce_mean, all_reduce_sum,
                   any_rank, barrier, batch_norm_train, batch_rows, broadcast_generator,
                   broadcast_object, create_mesh, data_group, data_rows, data_shape, draw_rows,
                   init_distributed, is_rank0, pad_to_multiple, reduce_gradients, replicate,
                   shard_batch, sync_batch_stats)
from .pipeline import (PIPE_AXIS, create_pipeline_mesh, gather_stacked, hop, hop_transport,
                       make_pipeline_train_step, pipe_shape, pipeline_apply,
                       pipelined_gpt_logits, reduce_pipeline_gradients, shard_stacked,
                       stack_block_params, unstack_block_params)
from .sequence import gather_logits, gather_tokens, reduce_sequence_gradients
from .sharding import (ShardingPlan, fsdp_dim, gpt_param_sharding_rules, resolve_sharding_rules,
                       shard_gpt)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "PIPE_AXIS", "all_gather_rows", "all_reduce_mean",
           "all_reduce_sum", "any_rank", "barrier", "batch_norm_train", "batch_rows",
           "broadcast_generator", "broadcast_object", "create_mesh", "create_pipeline_mesh",
           "data_group", "data_rows", "data_shape", "draw_rows", "gather_logits",
           "gather_stacked", "gather_tokens", "hop", "hop_transport", "init_distributed",
           "is_rank0", "make_pipeline_train_step", "pad_to_multiple", "pipe_shape",
           "pipeline_apply", "pipelined_gpt_logits", "reduce_gradients",
           "reduce_pipeline_gradients", "reduce_sequence_gradients", "replicate",
           "resolve_sharding_rules", "shard_batch", "shard_gpt", "shard_stacked", "ShardingPlan",
           "fsdp_dim", "gpt_param_sharding_rules", "stack_block_params", "sync_batch_stats",
           "unstack_block_params"]
