"""Plain PyTorch versions of the block-sparse kernels.

They compute what ``csrc/bsr_spmv.cu`` and ``csrc/bsr_spmm.cu`` compute, in
float32 and written back in x's dtype, on whatever device the tensors lie
on. The CPU device runs them in place of the kernels; on the card they are
what the kernels are held against, and nothing on the CUDA path calls them.
Row tiles that no tile visits come out as zeros.
"""
from __future__ import annotations

import torch

__all__ = ["bsr_spmv_ref", "bsr_spmm_ref"]


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
