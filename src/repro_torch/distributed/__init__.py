"""Distribution in the port: the nnz-balanced partitioner of sharded staged
execution (``partition``, a copy of ``repro.distributed.partition``) and
the parallel configuration training reads. The sharding rules over a device
mesh (``param_specs``, ``make_shardings`` and the rest) come with the
model-sharding slice."""
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
from .sharding import ParallelConfig

__all__ = [
    "ParallelConfig",
    "ShardPlan",
    "VBRShard",
    "block_row_nnz",
    "load_shard_plan",
    "make_shard_plan",
    "partition_nnz_balanced",
    "save_shard_plan",
    "shard_vbr",
]
