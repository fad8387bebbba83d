"""Inspection-free fixed-block sparse matrices (``BlockMatrix``)."""
from .block_csr import BlockMatrix, mask_from_dense, topology_from_mask

__all__ = ["BlockMatrix", "mask_from_dense", "topology_from_mask"]
