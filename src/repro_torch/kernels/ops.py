"""Public wrappers for the block-sparse kernels (port of ``repro.kernels.ops``).

``bsr_spmv`` and ``bsr_spmm`` take the reference's arguments, minus
``interpret`` and plus ``device`` (``None`` means the CUDA card). Inputs may
be numpy arrays or tensors; tensors must already lie on ``device``. On a CUDA
device the wrapper checks dtype, shape and contiguity, allocates the output
with ``torch.empty`` and launches the hand-written kernel on the current
stream: there is no fallback, and what the kernel does not take raises. On
the CPU it runs the plain PyTorch version in ``ref.py``. ``bsr_sdd`` wraps
the reference's ``bsr_ops._sdd_pallas`` in the same way; ``sdd_body`` is the
rule that picks the body its kernel runs.

K1 and K2's float32 body split the sorted tile table evenly over one wave
of workers sized to the card, ``tile_schedule``. The split depends on the
row offsets (and the kernel, tile shape and dtype) alone, so a caller that
runs one structure many times builds it once with ``bsr_schedule`` and
passes it as ``schedule``, as it passes ``row_ptr``; without one, the
wrapper builds it on the device at each call.

``launches`` counts the kernel launches of each wrapper, so a caller can show
that a path went through the kernels.
"""
from __future__ import annotations

import torch

from ..device import on_device as _on, resolve_device
from . import ref

__all__ = [
    "bsr_schedule", "bsr_sdd", "bsr_spmm", "bsr_spmv", "launches", "reset_launches",
    "row_ptr_from_ids", "sdd_body", "tile_schedule",
]

launches = {"bsr_spmv": 0, "bsr_spmm": 0, "bsr_sdd": 0}

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def row_ptr_from_ids(row_ids: torch.Tensor, n_row_tiles: int) -> torch.Tensor:
    """CSR offsets (n_row_tiles + 1,) int32 over sorted ``row_ids``."""
    bounds = torch.arange(n_row_tiles + 1, dtype=torch.int32, device=row_ids.device)
    return torch.searchsorted(row_ids, bounds, out_int32=True)


def tile_schedule(row_ptr: torch.Tensor, n_workers: int) -> torch.Tensor:
    """The split of the tile table over ``n_workers`` workers that K1 and
    K2's float32 body walk (``csrc/schedule.cuh``): int32 (n_workers, 5),
    one row ``(t0, t1, r0, r1, flags)`` a worker, on row_ptr's device and
    without a host sync.

    Worker w takes the tiles [t0, t1), an equal share of
    ``row_ptr[0]..row_ptr[R]`` (lengths differ by at most one), and the row
    tiles [r0, r1): the one holding t0 (or the first starting at t0, empty
    ones included) up to the last starting before t1; the last worker also
    takes the empty row tiles at the end, and a worker with no tiles takes
    none but for that. ``flags`` marks the row tiles the split cuts: bit 0
    (head) when r0 began before t0, bit 1 (tail) when r1 - 1 goes on past t1
    and is not that head row tile.
    """
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    rp = row_ptr.to(torch.int64)
    R = rp.shape[0] - 1
    w = torch.arange(n_workers + 1, device=rp.device)
    t = rp[0] + w * (rp[R] - rp[0]) // n_workers
    t0, t1 = t[:-1], t[1:]
    # the row tile holding t0, or the first that starts at t0
    r0 = torch.minimum(torch.searchsorted(rp, t0),
                       torch.searchsorted(rp, t0, right=True) - 1)
    last = w[:-1] == n_workers - 1
    r1 = torch.where(last, R, torch.searchsorted(rp, t1))
    walks = (t0 < t1) | last
    r0 = torch.where(walks, r0, r1)
    head = walks & (rp[r0] < t0)
    tail = walks & (r1 > r0) & (rp[r1] > t1) & ~(head & (r0 == r1 - 1))
    flags = head.to(torch.int64) + 2 * tail.to(torch.int64)
    return torch.stack([t0, t1, r0, r1, flags], dim=1).to(torch.int32)


def bsr_schedule(kind: str, row_ptr: torch.Tensor, tm: int, tk: int, n: int = 1,
                 dtype: torch.dtype = torch.float32):
    """``tile_schedule`` for the kernel of ``kind`` ("spmv": K1; "spmm": K2, n
    columns) in ``dtype`` on row_ptr's CUDA device, with the kernel's own
    number of workers for the card; None for K2 in bfloat16, whose body
    walks row_ptr alone."""
    if kind not in ("spmv", "spmm"):
        raise ValueError(f"kind must be 'spmv' or 'spmm', got {kind!r}")
    if kind == "spmm" and dtype == torch.bfloat16:
        return None
    from ._build import load_kernels

    ext, dev = load_kernels(), row_ptr.device.index or 0
    if kind == "spmv":
        n_workers = ext.spmv_workers(tm, tk, dtype == torch.bfloat16, dev)
    else:
        n_workers = ext.spmm_workers(tm, n, dev)
    return tile_schedule(row_ptr, n_workers)


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


def _scratch(kind, row_ptr, schedule, tm, tk, n, dtype, dev):
    """The schedule (built here when None) and its float32 scratch."""
    if schedule is None:
        schedule = bsr_schedule(kind, row_ptr, tm, tk, n, dtype)
    schedule = _on(schedule, dev, torch.int32)
    if schedule.dim() != 2 or schedule.shape[1] != 5 or schedule.shape[0] < 1:
        raise ValueError(f"schedule must be (n_workers, 5), got {tuple(schedule.shape)}")
    partial = torch.empty((2 * schedule.shape[0], tm * n), dtype=torch.float32, device=dev)
    return schedule, partial


def bsr_spmv(tiles, row_ids, col_ids, x, *, m_pad, row_ptr=None, schedule=None, device=None):
    """Block-sparse SpMV: y (m_pad,) from uniform tiles + tables.

    ``row_ids`` must be sorted; ``row_ptr`` (from ``TiledPattern.row_ptr``)
    spares the CUDA path a search over them, and ``schedule`` (from
    ``bsr_schedule("spmv", row_ptr, tm, tk, dtype=x.dtype)``) the split of
    the table.
    """
    dev, tiles, row_ids, col_ids, x, row_ptr = _prepare(
        tiles, row_ids, col_ids, x, row_ptr, m_pad, device, x_dim=1
    )
    if dev.type == "cpu":
        return ref.bsr_spmv_ref(tiles, row_ids, col_ids, x, m_pad)
    y = torch.empty((m_pad,), dtype=x.dtype, device=dev)
    if m_pad:
        from ._build import load_kernels

        _, tm, tk = tiles.shape
        scratch = _scratch("spmv", row_ptr, schedule, tm, tk, 1, x.dtype, dev)
        load_kernels().bsr_spmv(tiles, row_ptr, col_ids, x, y, *scratch)
        launches["bsr_spmv"] += 1
    return y


def bsr_spmm(tiles, row_ids, col_ids, x, *, m_pad, bn=128, row_ptr=None, schedule=None,
             device=None):
    """Block-sparse SpMM: y (m_pad, n) from uniform tiles + tables.

    ``bn`` is the reference's column block of its Pallas grid: it shapes
    that schedule, not the result, and is taken for the reference's
    signature only. The CUDA kernel takes 128 columns a CTA in both dtypes
    and masks columns past ``n``. Tiles whose row tile lies past
    ``m_pad // tm`` are never visited (the CUDA path's row offsets end
    before them): ``bsr_ops.dsd`` leaves its padding slots there.
    ``schedule`` (from ``bsr_schedule("spmm", row_ptr, tm, tk, n)``) is the
    float32 body's split of the table; the bfloat16 body walks ``row_ptr``
    alone and takes none.
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

        _, tm, tk = tiles.shape
        if x.dtype == torch.float32:
            scratch = _scratch("spmm", row_ptr, schedule, tm, tk, n, x.dtype, dev)
        else:  # the bfloat16 body walks row_ptr alone
            scratch = (torch.empty(0, device=dev),) * 2
        load_kernels().bsr_spmm(tiles, row_ptr, col_ids, x, y, *scratch)
        launches["bsr_spmm"] += 1
    return y


def sdd_body(a: torch.Tensor, b: torch.Tensor) -> str:
    """The body of K3 for ``a`` (M, K) and ``b``'s block-column view (K, N //
    bn, bn): "cp.async" where both start on 16-byte boundaries and K, bn and
    b's two outer strides are whole 16-byte vectors (8 bfloat16 or 4 float32
    values), so that every row the kernel copies or writes is too (the output
    comes from ``torch.empty``, which aligns it); else "scalar". A function
    of the operands' dtype, shapes, strides and addresses alone."""
    v = 16 // a.element_size()
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    whole = all(n % v == 0 for n in (a.shape[1], b.shape[2], b.stride(0), b.stride(1)))
    return "cp.async" if aligned and whole else "scalar"


def bsr_sdd(a, b, rows, cols, *, bm, bn, device=None):
    """Sampled dense-dense product: (nnz, bm, bn) blocks of ``a @ b``,
    ``out[i] = a[rows[i]*bm:+bm, :] @ b[:, cols[i]*bn:+bn]``.

    ``a`` is (M, K) and contiguous. ``b`` is (K, N), contiguous, or its
    block-column view (K, N // bn, bn) with any strides but a unit last one:
    a stack of per-column-block weights ``w (Cb, K, bn)`` is passed as
    ``w.permute(1, 0, 2)``, the stacked (K, Cb * bn) matrix without a copy.
    A slot with ``rows[i] >= M // bm`` is padding: its block is written as
    zeros and neither ``a`` nor ``b`` is read for it, so its ``cols[i]`` may
    hold anything; every other slot's coordinates must be in bounds. The
    kernel's body is ``sdd_body``'s choice.
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

        load_kernels().bsr_sdd(a, b, rows, cols, out, sdd_body(a, b) == "cp.async")
        launches["bsr_sdd"] += 1
    return out
