"""The user-level ops of the paper, written in the SABLE DSL (PyTorch port;
a copy of ``repro.core.ops_dsl``).

These are verbatim ports of Section IV-B (SpMV) and IV-C (SpMM): the user
has fine-grained control over loop order via the nesting of ``loopgen``
calls; SABLE does no auto-reordering (paper Section IV-B).
"""
from __future__ import annotations

from .dsl import ArrayVal, LinExpr, RepRange, loopgen

__all__ = ["ArrayView", "spmv_op", "spmm_op"]


class ArrayView(ArrayVal):
    """A view of an array at a static offset (the block's slice of ``val``).

    The paper passes ``val[indx[count]]`` as the block's base; we keep the
    global array and bake the offset into every index (Listing 2 indexes
    ``val[69722 + ...]``)."""

    def __init__(self, base: ArrayVal, offset: int):
        super().__init__(base.name)
        self.base = base
        self.offset = int(offset)

    def __getitem__(self, idx):
        return self.base[LinExpr.of(idx) + self.offset]

    def __setitem__(self, idx, value):
        self.base[LinExpr.of(idx) + self.offset] = value


def spmv_op(
    row_idxs: RepRange,
    col_idxs: RepRange,
    col_maj_val: ArrayVal,  # dense block from vbr
    x: ArrayVal,  # dense vector to multiply
    y: ArrayVal,  # output
):
    """Paper Section IV-B.  Loop order: j outer, i inner (vectorizable)."""

    def op(j, i):
        row = i - row_idxs.start
        col = j - col_idxs.start
        m_val = col_maj_val[col * len(row_idxs) + row]
        y[i] += m_val * x[j]

    return loopgen(col_idxs, lambda j: loopgen(row_idxs, lambda i: op(j, i)))


def spmm_op(
    row_idxs: RepRange,
    col_idxs: RepRange,
    dense_idxs: RepRange,
    col_maj_val: ArrayVal,  # dense block from vbr
    x: ArrayVal,  # dense matrix to multiply (row-major, col_width columns)
    y: ArrayVal,  # output (row-major, col_width columns)
):
    """Paper Section IV-C.  j innermost so the compiler vectorizes over the
    dense columns."""
    col_width = len(dense_idxs)

    def op(i, k, j):
        row = i - row_idxs.start
        col = k - col_idxs.start
        m_val = col_maj_val[col * len(row_idxs) + row]
        y[i * col_width + j] += m_val * x[k * col_width + j]

    return loopgen(
        row_idxs,
        lambda i: loopgen(
            col_idxs, lambda k: loopgen(dense_idxs, lambda j: op(i, k, j))
        ),
    )
