"""Plain PyTorch versions of the block-sparse kernels.

They compute what ``csrc/bsr_spmv.cu``, ``csrc/bsr_spmm.cu`` and
``csrc/bsr_sdd.cu`` compute, in float32 and written back in the inputs'
dtype, on whatever device the tensors lie on. The CPU device runs them in
place of the kernels; on the card they are what the kernels are held
against, and nothing on the CUDA path calls them. Row tiles that no tile
visits come out as zeros. Padding is dropped as the kernels drop it: a tile
whose row tile lies past ``m_pad // tm`` (K1 and K2 walk row offsets that end
before it), and an sdd slot whose row block lies past ``a`` (K3 writes it as
zeros without reading ``a`` or ``b``).
"""
from __future__ import annotations

import torch

__all__ = ["bsr_sdd_ref", "bsr_spmm_ref", "bsr_spmv_ref"]


def bsr_spmv_ref(tiles, row_ids, col_ids, x, m_pad: int) -> torch.Tensor:
    """y[row*tm:(row+1)*tm] += tile @ x[col*tk:(col+1)*tk]."""
    nb, tm, tk = tiles.shape
    xs = x.reshape(-1, tk).index_select(0, col_ids.long()).float()  # (nb, tk)
    part = (tiles.float() * xs[:, None, :]).sum(dim=2)  # (nb, tm)
    return _add_rows(part, row_ids, m_pad).to(x.dtype)


def _add_rows(part, row_ids, m_pad: int) -> torch.Tensor:
    """Sum the (nb, tm, ...) parts into their row tiles: (m_pad, ...) float32.
    Parts whose row tile lies past m_pad // tm land on a dropped extra one."""
    R, tm = m_pad // part.shape[1], part.shape[1]
    y = torch.zeros((R + 1,) + tuple(part.shape[1:]), dtype=torch.float32, device=part.device)
    y.index_add_(0, row_ids.long().clamp(max=R), part)
    return y[:R].reshape((R * tm,) + tuple(part.shape[2:]))


def bsr_spmm_ref(tiles, row_ids, col_ids, x, m_pad: int) -> torch.Tensor:
    """y[row*tm:(row+1)*tm, :] += tile @ x[col*tk:(col+1)*tk, :]."""
    nb, tm, tk = tiles.shape
    n = x.shape[1]
    xs = x.reshape(-1, tk, n).index_select(0, col_ids.long()).float()  # (nb, tk, n)
    part = torch.bmm(tiles.float(), xs)  # (nb, tm, n)
    return _add_rows(part, row_ids, m_pad).to(x.dtype)


def bsr_sdd_ref(a, b, rows, cols, bm: int, bn: int) -> torch.Tensor:
    """out[i] = a[rows[i]*bm:+bm, :] @ b[:, cols[i]*bn:+bn], (nnz, bm, bn).

    ``b`` is (K, N) or its block-column view (K, N // bn, bn). A slot with
    ``rows[i] >= a.shape[0] // bm`` is padding: its block is zero, whatever
    ``cols[i]`` holds."""
    K = a.shape[1]
    R = a.shape[0] // bm
    b3 = b.reshape(K, -1, bn) if b.dim() == 2 else b
    valid = rows.long() < R
    if R == 0:
        return torch.zeros((rows.shape[0], bm, bn), dtype=a.dtype, device=a.device)
    rc, cc = torch.where(valid, rows.long(), 0), torch.where(valid, cols.long(), 0)
    ag = a.reshape(R, bm, K).index_select(0, rc).float()  # (nnz, bm, K)
    bg = b3.permute(1, 0, 2).index_select(0, cc).float()  # (nnz, K, bn)
    return torch.where(valid[:, None, None], torch.bmm(ag, bg), 0).to(a.dtype)
