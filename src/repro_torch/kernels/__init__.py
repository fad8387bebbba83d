"""Hand-written CUDA kernels for the SABLE hot spots, with their plain
PyTorch versions (``ref``)."""
from . import ops, ref
from .ops import bsr_sdd, bsr_spmm, bsr_spmv, launches, reset_launches
