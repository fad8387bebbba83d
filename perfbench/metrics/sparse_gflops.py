"""Operations of the staged calls completed in the window per second:
2 x stored values of the VBR x right-hand columns, per call."""
from perfbench import work


def read(m):
    r = m.rec
    return work.sparse_ops(r["stored"], r["n_cols"]) * r["calls"] / r["window_s"] / 1e9
