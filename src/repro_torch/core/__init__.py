"""SABLE core (PyTorch port): VBR format, staged DSL, Stage-0/1 compiler,
the tuner with its plan cache and cost model, and structure inspection."""
from .vbr import VBR, BlockTask, from_dense, structure_hash, synthesize, synthesize_paper
from .dsl import ArrayVal, ConcreteArrayVal, RepRange, isDense, loopgen, stage_op
from .ops_dsl import ArrayView, spmm_op, spmv_op
from .backends import BlockMatmul, match_block_matmul, run_reference, run_vectorized
from .uniformize import TiledPattern, row_ptr_from_ids, uniformize
from .staging import (
    StagedKernel,
    StagingOptions,
    cache_info,
    clear_cache,
    partition_block_rows,
    stage_block_op,
    stage_spmm,
    stage_spmv,
)
from .cache import PlanCache, TuningPlan, default_cache, plan_key, set_default_cache
# NB: the bare `autotune` function is NOT re-exported: it would shadow the
# `repro_torch.core.autotune` submodule; use
# `from repro_torch.core.autotune import autotune`.
from .autotune import (
    autotune_stage,
    autotune_stats,
    candidate_options,
    reset_autotune_stats,
    tune_num_workers,
)
from .cost_model import CostModel, cost_model_stats, load_or_fit, reset_cost_model_stats
# NB: `inspect` and `reblock` stay addressable as submodules
# (`repro_torch.core.inspect`, `repro_torch.core.reblock`).
from .inspect import StructureInfo, detect_pattern, detect_structure
from .reblock import (
    ReblockSpec,
    apply_reblock,
    propose_reblockings,
    reblock_stats,
    reset_reblock_stats,
    stage_reblocked,
)
