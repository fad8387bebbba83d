"""Distribution in the port: the nnz-balanced partitioner of sharded staged
execution (``partition``, a copy of ``repro.distributed.partition``), the
sharding rules over a device mesh (``sharding``: ``param_specs``,
``make_shardings`` and the rest, with DTensor placements) and the
activation-sharding context the model's use sites read (``ctx``)."""
from .partition import (
    ShardPlan,
    VBRShard,
    block_row_nnz,
    load_shard_plan,
    make_shard_plan,
    partition_nnz_balanced,
    save_shard_plan,
    shard_vbr,
)
from .sharding import (
    NamedSharding,
    P,
    ParallelConfig,
    batch_specs,
    cache_specs,
    distribute,
    make_shardings,
    opt_state_specs,
    param_specs,
    slice_shardings,
)

__all__ = [
    "NamedSharding",
    "P",
    "ParallelConfig",
    "ShardPlan",
    "VBRShard",
    "batch_specs",
    "block_row_nnz",
    "cache_specs",
    "distribute",
    "load_shard_plan",
    "make_shard_plan",
    "make_shardings",
    "opt_state_specs",
    "param_specs",
    "partition_nnz_balanced",
    "save_shard_plan",
    "shard_vbr",
    "slice_shardings",
]
