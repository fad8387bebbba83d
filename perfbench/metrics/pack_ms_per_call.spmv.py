"""Device time per staged SpMV call of everything but K1: the gather that
packs the new values into tiles, and the operand and result gathers."""


def read(m):
    tr = m.trace
    if tr is None:
        return None
    return tr.ms_per(~tr.matching("bsr_spmv", "combine_kernel") & tr.under("call"), "call")
