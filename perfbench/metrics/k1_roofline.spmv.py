"""K1's share of its roofline in the staged SpMV (``work.sparse_roofline``:
2 x stored x n operations, the stored values, x and y each moved once, over
K1's device time, its combine included)."""
from perfbench import work


def read(m):
    return work.sparse_roofline(m, ("bsr_spmv", "combine_kernel"))
