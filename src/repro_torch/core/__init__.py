"""SABLE core (PyTorch port): VBR format, staged DSL, Stage-0/1 compiler."""
from .vbr import VBR, BlockTask, from_dense, structure_hash, synthesize, synthesize_paper
from .dsl import ArrayVal, ConcreteArrayVal, RepRange, isDense, loopgen, stage_op
from .ops_dsl import ArrayView, spmm_op, spmv_op
from .backends import BlockMatmul, match_block_matmul, run_reference
from .uniformize import TiledPattern, row_ptr_from_ids, uniformize
from .staging import (
    StagedKernel,
    StagingOptions,
    cache_info,
    clear_cache,
    stage_spmm,
    stage_spmv,
)
