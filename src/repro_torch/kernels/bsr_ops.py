"""The fixed-block sparse product family over ``BlockMatrix``: dsd/dds/sdd
(port of ``repro.kernels.bsr_ops``).

For structures that change every call (per-batch MoE topologies): no
inspection, no staging, no plan cache. The ops take the blocked-CSR-COO
arrays as data on the device::

  dsd(S, x)      dense (M,N)  = sparse (M,K) @ dense (K,N)
  dds(x, S)      dense (M,N)  = dense (M,K)  @ sparse (K,N)
  sdd(a, b, T)   sparse       = dense (M,K)  @ dense (K,N), computed
                 only at T's block topology (sparse *output*)

Backends: ``grouped`` (gather + batched block matmul + scatter-add, in plain
PyTorch), ``cuda`` (the hand-written kernels: ``dsd`` on K2 ``bsr_spmm``,
``dds`` through ``dsd`` on the transpose, ``sdd`` on K3 ``bsr_sdd``) and
``auto``, which is ``cuda`` for tensors on the card and ``grouped`` on the
CPU. On the CPU the ``cuda`` backend's wrappers run their kernels' plain
versions, so the CPU tests reach its glue too.

Every op is a ``torch.autograd.Function`` whose backward passes are members
of the family on the same backend, as the reference's ``custom_vjp``s::

  d dsd(S, x) / dx    = dsd(S^T, g)         d/dS    = sdd(g, x^T, S)
  d dds(x, S) / dx    = dds(g, S^T)         d/dS    = sdd(x^T, g, S)
  d sdd(a, b, T) / da = dsd(g_T, b^T)       d/db    = dds(a^T, g_T)

so a dropless MoE trains on K2 and K3 alone. The index tensors take no
gradient. On the card ``d/db`` comes back from K2 as the transpose of its
(N, K) output, in ``b``'s own shape and strides, and the transposed
operands K2 and K3 take row-major (``b^T`` of ``d/da``, ``x^T`` of dsd's
``d/dS``) are copied once each.

Padding slots (``row == n_block_rows``) ride along as zero blocks, and get
zero gradient blocks. The ``grouped`` backend scatters them into a dropped
extra row and gathers at clamped coordinates; the kernels never touch them
(K2's row offsets end before them, K3 writes their blocks as zeros without
reading its operands).
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..sparse.block_csr import BlockMatrix
from . import ops

__all__ = ["dds", "dsd", "sdd"]

_BACKENDS = ("grouped", "cuda")


def _resolve(backend: str, device: torch.device) -> str:
    if backend == "auto":
        backend = "cuda" if device.type == "cuda" else "grouped"
    if backend not in _BACKENDS:
        raise ValueError(f"unknown bsr_ops backend {backend!r}; use 'auto' or one of {_BACKENDS}")
    return backend


# ---------------------------------------------------------------------- #
# the products, without autograd
# ---------------------------------------------------------------------- #
def _dsd(sp: BlockMatrix, x: torch.Tensor, backend: str) -> torch.Tensor:
    (M, K), (bm, bk) = sp.shape, sp.block
    Rb, Kb = M // bm, K // bk
    N = x.shape[1]
    if backend == "cuda":
        # padding slots (row == Rb) sort after every real row, past the row
        # offsets of the Rb real row tiles, so K2 never visits them; it writes
        # the row tiles that no slot visits as zeros.
        return ops.bsr_spmm(
            sp.data.contiguous(), sp.row_indices, sp.column_indices, x.contiguous(),
            m_pad=M, device=x.device,
        )
    cols = sp.column_indices.clamp(max=Kb - 1)
    xg = x.reshape(Kb, bk, N)[cols.long()]  # (nnz, bk, N)
    part = torch.bmm(sp.data, xg)
    y = torch.zeros((Rb + 1, bm, N), dtype=part.dtype, device=x.device)
    y.index_add_(0, sp.row_indices.long(), part)
    return y[:Rb].reshape(M, N)


def _dds(x: torch.Tensor, sp: BlockMatrix, backend: str) -> torch.Tensor:
    """x @ S; on the card the transpose of K2's (N, M) output, a view."""
    if backend == "cuda":
        # x @ S == (S^T @ x^T)^T: the dsd schedule on the transpose
        return _dsd(sp.transpose(), x.T, backend).T
    (K, N), (bm, bn) = sp.shape, sp.block
    Kb, Nb = K // bm, N // bn
    M = x.shape[0]
    xg = x.reshape(M, Kb, bm)[:, sp.row_indices.clamp(max=Kb - 1).long()]  # (M, nnz, bm)
    part = torch.einsum("mbt,btk->mbk", xg, sp.data)
    # invalid slots scatter zeros into block-col 0: harmless
    y = torch.zeros((M, Nb, bn), dtype=part.dtype, device=x.device)
    y.index_add_(1, sp.column_indices.long(), part)
    return y.reshape(M, N)


def _sdd(a: torch.Tensor, b: torch.Tensor, topo: BlockMatrix, backend: str) -> torch.Tensor:
    """The (nnz, bm, bn) blocks of a @ b at ``topo``; ``b`` is (K, N) or its
    block-column view (K, N // bn, bn), with any strides."""
    (M, N), (bm, bn) = topo.shape, topo.block
    Rb, Cb = M // bm, N // bn
    K = a.shape[1]
    if backend == "cuda":
        # K3 writes a padding slot (row == Rb) as zeros without reading a or b.
        # b keeps its strides (an expert stack's permuted view), but K3 reads
        # unit-stride columns only: strided ones (x^T in dsd's backward) get
        # a row-major copy, which measured ~5x faster than reading them in
        # place (PERF.md, phase 13a)
        b = b.unflatten(1, (Cb, bn)) if b.dim() == 2 else b
        b = b.contiguous() if b.stride(2) != 1 else b
        return ops.bsr_sdd(a.contiguous(), b, topo.row_indices, topo.column_indices,
                           bm=bm, bn=bn, device=a.device)
    rc = topo.row_indices.clamp(max=Rb - 1)
    cc = topo.column_indices.clamp(max=Cb - 1)
    ag = a.reshape(Rb, bm, K)[rc.long()]  # (nnz, bm, K)
    bg = b.reshape(K, Cb, bn).permute(1, 0, 2)[cc.long()]  # (nnz, K, bn)
    return torch.where(topo.valid[:, None, None], torch.bmm(ag, bg), 0)


# ---------------------------------------------------------------------- #
# the autograd Functions: backward passes inside the family
# ---------------------------------------------------------------------- #
class _DsdFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, meta, data, rows, cols, offsets, x):
        ctx.meta = meta
        ctx.save_for_backward(data, rows, cols, offsets, x)
        return _dsd(BlockMatrix(*meta[:2], data, rows, cols, offsets), x, meta[2])

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        data, rows, cols, offsets, x = ctx.saved_tensors
        shape, block, backend = ctx.meta
        sp = BlockMatrix(shape, block, data, rows, cols, offsets)
        d_data = dx = None
        if ctx.needs_input_grad[5]:
            dx = _dsd(sp.transpose(), g, backend).to(x.dtype)
        if ctx.needs_input_grad[1]:
            d_data = _sdd(g, x.T, sp, backend).to(data.dtype)
        return None, d_data, None, None, None, dx


class _DdsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, meta, x, data, rows, cols, offsets):
        ctx.meta = meta
        ctx.save_for_backward(x, data, rows, cols, offsets)
        return _dds(x, BlockMatrix(*meta[:2], data, rows, cols, offsets), meta[2]).contiguous()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, data, rows, cols, offsets = ctx.saved_tensors
        shape, block, backend = ctx.meta
        sp = BlockMatrix(shape, block, data, rows, cols, offsets)
        dx = d_data = None
        if ctx.needs_input_grad[1]:
            # g @ S^T; on the card (S @ g^T)^T, the same product on S's own
            # tables, which spares two transposes of the topology
            dx = (_dsd(sp, g.T, backend).T if backend == "cuda"
                  else _dds(g, sp.transpose(), backend)).to(x.dtype)
        if ctx.needs_input_grad[2]:
            d_data = _sdd(x.T, g, sp, backend).to(data.dtype)
        return None, dx, d_data, None, None, None


class _SddFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, meta, a, b, rows, cols, offsets):
        ctx.meta = meta
        ctx.save_for_backward(a, b, rows, cols, offsets)
        return _sdd(a, b, BlockMatrix(*meta[:2], None, rows, cols, offsets), meta[2])

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, b, rows, cols, offsets = ctx.saved_tensors
        (M, N), block, backend = ctx.meta
        # the gradient as a BlockMatrix at the topology: zero at padding slots
        g = torch.where((rows < M // block[0])[:, None, None], g, 0)
        g_sp = BlockMatrix((M, N), block, g, rows, cols, offsets)
        K, (Cb, bn) = a.shape[1], (N // block[1], block[1])
        da = db = None
        if ctx.needs_input_grad[1]:
            bt = b.T if b.dim() == 2 else b.permute(1, 2, 0).reshape(N, K)  # (N, K)
            da = _dsd(g_sp, bt, backend).to(a.dtype)
        if ctx.needs_input_grad[2]:
            if backend == "cuda":
                # K2's (N, K) output, read back as b's transpose: no copy
                dbt = _dsd(g_sp.transpose(), a, backend)
                db = dbt.T if b.dim() == 2 else dbt.view(Cb, bn, K).permute(2, 0, 1)
            else:
                db = _dds(a.T, g_sp, backend).reshape(b.shape)
            db = db.to(b.dtype)
        return None, da, db, None, None, None


# ---------------------------------------------------------------------- #
# the ops
# ---------------------------------------------------------------------- #
def dsd(sp: BlockMatrix, x: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """dense (M, N) = sparse (M, K) @ dense (K, N)."""
    if x.dim() != 2 or x.shape[0] != sp.shape[1]:
        raise ValueError(f"dsd: x {tuple(x.shape)} does not match sparse {sp.shape}")
    meta = (tuple(sp.shape), tuple(sp.block), _resolve(backend, x.device))
    return _DsdFn.apply(meta, sp.data, sp.row_indices, sp.column_indices, sp.offsets, x)


def dds(x: torch.Tensor, sp: BlockMatrix, *, backend: str = "auto") -> torch.Tensor:
    """dense (M, N) = dense (M, K) @ sparse (K, N)."""
    if x.dim() != 2 or x.shape[1] != sp.shape[0]:
        raise ValueError(f"dds: x {tuple(x.shape)} does not match sparse {sp.shape}")
    meta = (tuple(sp.shape), tuple(sp.block), _resolve(backend, x.device))
    return _DdsFn.apply(meta, x, sp.data, sp.row_indices, sp.column_indices, sp.offsets)


def sdd(a: torch.Tensor, b: torch.Tensor, topo: BlockMatrix, *,
        backend: str = "auto") -> BlockMatrix:
    """sparse (M, N) = dense (M, K) @ dense (K, N), computed only at
    ``topo``'s blocks. Returns a BlockMatrix sharing ``topo``'s structure
    tensors (same slot order, so elementwise ops on ``.data`` stay aligned
    across same-topology products).

    ``b`` may also be given as its block-column view (K, N // bn, bn), with
    any strides: the dropless MoE passes its expert stack ``w1 (E, d, f)`` as
    ``w1.permute(1, 0, 2)``, the stacked (d, E*f) weight read in place. Its
    gradient comes back in the view's shape, and reaches ``w1`` through the
    permute.
    """
    (M, N), (bm, bn) = topo.shape, topo.block
    Cb = N // bn
    K = a.shape[1] if a.dim() == 2 else -1
    b_shape = (K, Cb, bn) if b.dim() == 3 else (K, N)
    if a.dim() != 2 or a.shape[0] != M or tuple(b.shape) != b_shape:
        raise ValueError(
            f"sdd: {tuple(a.shape)} @ {tuple(b.shape)} does not give topology {topo.shape} "
            f"in blocks {topo.block}"
        )
    meta = (tuple(topo.shape), tuple(topo.block), _resolve(backend, a.device))
    data = _SddFn.apply(meta, a, b, topo.row_indices, topo.column_indices, topo.offsets)
    return BlockMatrix(
        tuple(topo.shape), tuple(topo.block), data,
        topo.row_indices, topo.column_indices, topo.offsets,
    )
