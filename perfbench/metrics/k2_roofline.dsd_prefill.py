"""K2's share of its roofline in the prefills' dsd, the w2 projection of
every MoE layer (``work.moe_roofline``: the router's counts, each expert hit
read once), over K2's device time under the prefill spans."""
from perfbench import work


def read(m):
    return work.moe_roofline(m, ("bsr_spmm", "combine_kernel"), projections=1)
