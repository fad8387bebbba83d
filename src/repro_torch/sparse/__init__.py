"""NN integration of SABLE block-sparse weights: inspection-free fixed-block
matrices (``BlockMatrix``) and static block patterns as layer weights
(``linear``)."""
from .block_csr import BlockMatrix, mask_from_dense, topology_from_mask
from .linear import (
    BlockPattern,
    choose_matmul_strategy,
    pack_dense,
    pattern_hash,
    prune_dense,
    random_pattern,
    sparse_matmul,
    sparse_matmul_auto,
    sparse_matmul_cuda,
    warm_matmul_plans,
)
