"""The fixed-block sparse product family over ``BlockMatrix``: dsd/dds/sdd
(port of the forward of ``repro.kernels.bsr_ops``).

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

Padding slots (``row == n_block_rows``) ride along as zero blocks. The
``grouped`` backend scatters them into a dropped extra row and gathers at
clamped coordinates; the kernels never touch them (K2's row offsets end
before them, K3 writes their blocks as zeros without reading its operands).

Only the forward is ported. The reference's ``custom_vjp``s, whose backward
passes stay inside the family (d dsd/dx = dsd(S^T, g), d/dS = sdd(g, x^T, S)
and so on), come with the training slice; until then an input that requires
a gradient raises, so that autograd never differentiates the kernels' glue
into a silently wrong gradient.
"""
from __future__ import annotations

import torch

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


def _forward_only(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the backward of the dsd/dds/sdd family is not ported yet (it comes "
            "with the training slice); call it under torch.no_grad() or on tensors that "
            "do not require grad"
        )


# ---------------------------------------------------------------------- #
# dsd: dense = sparse @ dense
# ---------------------------------------------------------------------- #
def dsd(sp: BlockMatrix, x: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """dense (M, N) = sparse (M, K) @ dense (K, N)."""
    if x.dim() != 2 or x.shape[0] != sp.shape[1]:
        raise ValueError(f"dsd: x {tuple(x.shape)} does not match sparse {sp.shape}")
    _forward_only("dsd", sp.data, x)
    backend = _resolve(backend, x.device)
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


# ---------------------------------------------------------------------- #
# dds: dense = dense @ sparse
# ---------------------------------------------------------------------- #
def dds(x: torch.Tensor, sp: BlockMatrix, *, backend: str = "auto") -> torch.Tensor:
    """dense (M, N) = dense (M, K) @ sparse (K, N)."""
    if x.dim() != 2 or x.shape[1] != sp.shape[0]:
        raise ValueError(f"dds: x {tuple(x.shape)} does not match sparse {sp.shape}")
    _forward_only("dds", x, sp.data)
    backend = _resolve(backend, x.device)
    if backend == "cuda":
        # x @ S == (S^T @ x^T)^T: the dsd schedule on the transpose
        return dsd(sp.transpose(), x.T.contiguous(), backend=backend).T.contiguous()
    (K, N), (bm, bn) = sp.shape, sp.block
    Kb, Nb = K // bm, N // bn
    M = x.shape[0]
    xg = x.reshape(M, Kb, bm)[:, sp.row_indices.clamp(max=Kb - 1).long()]  # (M, nnz, bm)
    part = torch.einsum("mbt,btk->mbk", xg, sp.data)
    # invalid slots scatter zeros into block-col 0: harmless
    y = torch.zeros((M, Nb, bn), dtype=part.dtype, device=x.device)
    y.index_add_(1, sp.column_indices.long(), part)
    return y.reshape(M, N)


# ---------------------------------------------------------------------- #
# sdd: sparse output = dense @ dense under a topology mask
# ---------------------------------------------------------------------- #
def sdd(a: torch.Tensor, b: torch.Tensor, topo: BlockMatrix, *,
        backend: str = "auto") -> BlockMatrix:
    """sparse (M, N) = dense (M, K) @ dense (K, N), computed only at
    ``topo``'s blocks. Returns a BlockMatrix sharing ``topo``'s structure
    tensors (same slot order, so elementwise ops on ``.data`` stay aligned
    across same-topology products).

    ``b`` may also be given as its block-column view (K, N // bn, bn), with
    any strides: the dropless MoE passes its expert stack ``w1 (E, d, f)`` as
    ``w1.permute(1, 0, 2)``, the stacked (d, E*f) weight read in place.
    """
    (M, N), (bm, bn) = topo.shape, topo.block
    Rb, Cb = M // bm, N // bn
    K = a.shape[1] if a.dim() == 2 else -1
    b_shape = (K, Cb, bn) if b.dim() == 3 else (K, N)
    if a.dim() != 2 or a.shape[0] != M or tuple(b.shape) != b_shape:
        raise ValueError(
            f"sdd: {tuple(a.shape)} @ {tuple(b.shape)} does not give topology {topo.shape} "
            f"in blocks {topo.block}"
        )
    _forward_only("sdd", a, b)
    backend = _resolve(backend, a.device)
    if backend == "cuda":
        # K3 writes a padding slot (row == Rb) as zeros without reading a or b
        b = b.contiguous() if b.dim() == 2 else b  # a 3-D view keeps its strides
        data = ops.bsr_sdd(a.contiguous(), b, topo.row_indices, topo.column_indices,
                           bm=bm, bn=bn, device=a.device)
    else:
        rc = topo.row_indices.clamp(max=Rb - 1)
        cc = topo.column_indices.clamp(max=Cb - 1)
        ag = a.reshape(Rb, bm, K)[rc.long()]  # (nnz, bm, K)
        bg = b.reshape(K, Cb, bn).permute(1, 0, 2)[cc.long()]  # (nnz, K, bn)
        data = torch.where(topo.valid[:, None, None], torch.bmm(ag, bg), 0)
    return BlockMatrix(
        tuple(topo.shape), tuple(topo.block), data,
        topo.row_indices, topo.column_indices, topo.offsets,
    )
