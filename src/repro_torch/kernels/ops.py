"""Public wrappers for the block-sparse kernels (port of ``repro.kernels.ops``).

``bsr_spmv`` and ``bsr_spmm`` take the reference's arguments, minus
``interpret`` and plus ``device`` (``None`` means the CUDA card). Inputs may
be numpy arrays or tensors; tensors must already lie on ``device``. On a CUDA
device the wrapper checks dtype, shape and contiguity, allocates the output
with ``torch.empty`` and launches the hand-written kernel on the current
stream: there is no fallback, and what the kernel does not take raises. On
the CPU it runs the plain PyTorch version in ``ref.py``. ``bsr_sdd`` wraps
the reference's ``bsr_ops._sdd_pallas`` in the same way.

``launches`` counts the kernel launches of each wrapper, so a caller can show
that a path went through the kernels.
"""
from __future__ import annotations

import torch

from ..device import on_device as _on, resolve_device
from . import ref

__all__ = ["bsr_sdd", "bsr_spmm", "bsr_spmv", "launches", "reset_launches", "row_ptr_from_ids"]

launches = {"bsr_spmv": 0, "bsr_spmm": 0, "bsr_sdd": 0}

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def row_ptr_from_ids(row_ids: torch.Tensor, n_row_tiles: int) -> torch.Tensor:
    """CSR offsets (n_row_tiles + 1,) int32 over sorted ``row_ids``."""
    bounds = torch.arange(n_row_tiles + 1, dtype=torch.int32, device=row_ids.device)
    return torch.searchsorted(row_ids, bounds, out_int32=True)


def _prepare(tiles, row_ids, col_ids, x, row_ptr, m_pad, device, x_dim):
    dev = resolve_device(device)
    tiles, x = _on(tiles, dev), _on(x, dev)
    row_ids = _on(row_ids, dev, torch.int32)
    col_ids = _on(col_ids, dev, torch.int32)
    if tiles.dim() != 3:
        raise ValueError(f"tiles must be (nb, tm, tk), got {tuple(tiles.shape)}")
    nb, tm, tk = tiles.shape
    if tiles.dtype not in _DTYPES or x.dtype != tiles.dtype:
        raise TypeError(f"tiles and x must share float32 or bfloat16, got {tiles.dtype}, {x.dtype}")
    if row_ids.shape != (nb,) or col_ids.shape != (nb,):
        raise ValueError("row_ids and col_ids must be (nb,)")
    if x.dim() != x_dim or x.shape[0] % tk:
        raise ValueError(f"x must be {x_dim}-D with a leading dim divisible by tk={tk}")
    if m_pad % tm:
        raise ValueError(f"m_pad={m_pad} must be a multiple of tm={tm}")
    if not (tiles.is_contiguous() and x.is_contiguous()):
        raise ValueError("tiles and x must be contiguous")
    if dev.type == "cuda":
        if row_ptr is None:
            row_ptr = row_ptr_from_ids(row_ids, m_pad // tm)
        row_ptr = _on(row_ptr, dev, torch.int32)
        if row_ptr.shape != (m_pad // tm + 1,):
            raise ValueError(f"row_ptr must be ({m_pad // tm + 1},)")
    return dev, tiles, row_ids, col_ids, x, row_ptr


def bsr_spmv(tiles, row_ids, col_ids, x, *, m_pad, row_ptr=None, device=None):
    """Block-sparse SpMV: y (m_pad,) from uniform tiles + tables.

    ``row_ids`` must be sorted; ``row_ptr`` (from ``TiledPattern.row_ptr``)
    spares the CUDA path a search over them.
    """
    dev, tiles, row_ids, col_ids, x, row_ptr = _prepare(
        tiles, row_ids, col_ids, x, row_ptr, m_pad, device, x_dim=1
    )
    if dev.type == "cpu":
        return ref.bsr_spmv_ref(tiles, row_ids, col_ids, x, m_pad)
    y = torch.empty((m_pad,), dtype=x.dtype, device=dev)
    if m_pad:
        from ._build import load_kernels

        load_kernels().bsr_spmv(tiles, row_ptr, col_ids, x, y)
        launches["bsr_spmv"] += 1
    return y


def bsr_spmm(tiles, row_ids, col_ids, x, *, m_pad, bn=128, row_ptr=None, device=None):
    """Block-sparse SpMM: y (m_pad, n) from uniform tiles + tables.

    ``bn`` is the reference's column block of its Pallas grid: it shapes
    that schedule, not the result, and is taken for the reference's
    signature only. The CUDA kernel works its column block out from ``n``
    in both dtypes and masks columns past ``n``. Tiles whose row tile lies past
    ``m_pad // tm`` are never visited (the CUDA path's row offsets end
    before them): ``bsr_ops.dsd`` leaves its padding slots there.
    """
    dev, tiles, row_ids, col_ids, x, row_ptr = _prepare(
        tiles, row_ids, col_ids, x, row_ptr, m_pad, device, x_dim=2
    )
    if dev.type == "cpu":
        return ref.bsr_spmm_ref(tiles, row_ids, col_ids, x, m_pad)
    n = x.shape[1]
    y = torch.empty((m_pad, n), dtype=x.dtype, device=dev)
    if m_pad and n:
        from ._build import load_kernels

        load_kernels().bsr_spmm(tiles, row_ptr, col_ids, x, y)
        launches["bsr_spmm"] += 1
    return y


def bsr_sdd(a, b, rows, cols, *, bm, bn, device=None):
    """Sampled dense-dense product: (nnz, bm, bn) blocks of ``a @ b``,
    ``out[i] = a[rows[i]*bm:+bm, :] @ b[:, cols[i]*bn:+bn]``.

    ``a`` is (M, K) and contiguous. ``b`` is (K, N), contiguous, or its
    block-column view (K, N // bn, bn) with any strides but a unit last one:
    a stack of per-column-block weights ``w (Cb, K, bn)`` is passed as
    ``w.permute(1, 0, 2)``, the stacked (K, Cb * bn) matrix without a copy.
    A slot with ``rows[i] >= M // bm`` is padding: its block is written as
    zeros and neither ``a`` nor ``b`` is read for it, so its ``cols[i]`` may
    hold anything; every other slot's coordinates must be in bounds.
    """
    dev = resolve_device(device)
    a, b = _on(a, dev), _on(b, dev)
    rows = _on(rows, dev, torch.int32)
    cols = _on(cols, dev, torch.int32)
    if a.dim() != 2 or a.shape[0] % bm or a.shape[1] < 1:
        raise ValueError(f"a must be (M, K) with M % bm == 0 and K >= 1, got {tuple(a.shape)}")
    K = a.shape[1]
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a and b must share float32 or bfloat16, got {a.dtype}, {b.dtype}")
    if b.dim() == 2 and b.shape[0] == K and b.shape[1] % bn == 0 and b.is_contiguous():
        b = b.view(K, -1, bn)
    elif not (b.dim() == 3 and b.shape[0] == K and b.shape[2] == bn and b.stride(2) == 1):
        raise ValueError(
            f"b must be contiguous (K={K}, N) with N % bn == 0, or a (K, N // bn, bn={bn}) "
            f"view with unit last stride; got {tuple(b.shape)} strides {b.stride()}"
        )
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    nnz = rows.shape[0]
    if rows.shape != (nnz,) or cols.shape != (nnz,):
        raise ValueError("rows and cols must be (nnz,)")
    if dev.type == "cpu":
        return ref.bsr_sdd_ref(a, b, rows, cols, bm, bn)
    out = torch.empty((nnz, bm, bn), dtype=a.dtype, device=dev)
    if nnz:
        from ._build import load_kernels

        load_kernels().bsr_sdd(a, b, rows, cols, out)
        launches["bsr_sdd"] += 1
    return out
