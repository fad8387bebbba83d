"""K3's share of its roofline in the prefills: the w1 and w3 projections of
every MoE layer (``work.moe_roofline``: the router's counts, each expert hit
read once), over K3's device time under the prefill spans."""
from perfbench import work


def read(m):
    return work.moe_roofline(m, ("bsr_sdd",), projections=2)
