"""Plain PyTorch versions of the block-sparse kernels.

They compute what ``csrc/bsr_spmv.cu``, ``csrc/bsr_spmm.cu`` and
``csrc/bsr_sdd.cu`` compute, in float32 and written back in the inputs'
dtype, on whatever device the tensors lie on. The CPU device runs them in
place of the kernels; on the card they are what the kernels are held
against, and nothing on the CUDA path calls them. Row tiles that no tile
visits come out as zeros.
"""
from __future__ import annotations

import torch

__all__ = ["bsr_sdd_ref", "bsr_spmm_ref", "bsr_spmv_ref"]


def bsr_spmv_ref(tiles, row_ids, col_ids, x, m_pad: int) -> torch.Tensor:
    """y[row*tm:(row+1)*tm] += tile @ x[col*tk:(col+1)*tk]."""
    nb, tm, tk = tiles.shape
    xs = x.reshape(-1, tk).index_select(0, col_ids.long()).float()  # (nb, tk)
    part = (tiles.float() * xs[:, None, :]).sum(dim=2)  # (nb, tm)
    y = torch.zeros((m_pad // tm, tm), dtype=torch.float32, device=tiles.device)
    y.index_add_(0, row_ids.long(), part)
    return y.reshape(m_pad).to(x.dtype)


def bsr_spmm_ref(tiles, row_ids, col_ids, x, m_pad: int) -> torch.Tensor:
    """y[row*tm:(row+1)*tm, :] += tile @ x[col*tk:(col+1)*tk, :]."""
    nb, tm, tk = tiles.shape
    n = x.shape[1]
    xs = x.reshape(-1, tk, n).index_select(0, col_ids.long()).float()  # (nb, tk, n)
    part = torch.bmm(tiles.float(), xs)  # (nb, tm, n)
    y = torch.zeros((m_pad // tm, tm, n), dtype=torch.float32, device=tiles.device)
    y.index_add_(0, row_ids.long(), part)
    return y.reshape(m_pad, n).to(x.dtype)


def bsr_sdd_ref(a, b, rows, cols, bm: int, bn: int) -> torch.Tensor:
    """out[i] = a[rows[i]*bm:+bm, :] @ b[:, cols[i]*bn:+bn], (nnz, bm, bn).

    ``b`` is (K, N) or its block-column view (K, N // bn, bn); coordinates
    must be in bounds (``bsr_ops.sdd`` clamps them, as the reference does
    before ``_sdd_pallas``)."""
    K = a.shape[1]
    b3 = b.reshape(K, -1, bn) if b.dim() == 2 else b
    ag = a.reshape(-1, bm, K).index_select(0, rows.long()).float()  # (nnz, bm, K)
    bg = b3.permute(1, 0, 2).index_select(0, cols.long()).float()  # (nnz, K, bn)
    return torch.bmm(ag, bg).to(a.dtype)
