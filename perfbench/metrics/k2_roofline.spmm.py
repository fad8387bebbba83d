"""K2's share of its roofline in the staged SpMM (``work.sparse_roofline``:
2 x stored x n operations, the stored values, X and Y each moved once, over
K2's device time, its combine included)."""
from perfbench import work


def read(m):
    return work.sparse_roofline(m, ("bsr_spmm", "combine_kernel"))
