"""Fixed-block blocked-CSR-COO matrices (port of ``repro.sparse.block_csr``).

For structures that change every call (MoE routing emits a new topology per
batch), where host-side inspection would sit on the critical path. A
:class:`BlockMatrix` uses a *fixed* block size and a hybrid blocked-CSR-COO
encoding: per-block row indices (COO, sorted) for the kernels' output
schedule, column indices for the gather, and CSR row offsets for row lookup.
Everything is derived on the device from a routing mask with cumulative sums
and a scatter: no host sync and no data-dependent shapes.

Shapes are static through padding to ``nnz_max`` block slots: padded slots
carry ``row == n_block_rows`` (an out-of-range sentinel that sorts after
every real row), ``col == 0`` and all-zero data, so every consumer can drop
them or let them accumulate zeros. Every constructor keeps the invariant
"invalid slots hold zero data".

Arrays are tensors on one device. A constructor's ``device`` (``None``
means the CUDA card, as everywhere in the port) is where it builds them;
tensors it is given must already lie there. The compute family over this
format is ``repro_torch.kernels.bsr_ops`` (``dsd`` / ``dds`` / ``sdd``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import on_device, resolve_device

__all__ = ["BlockMatrix", "mask_from_dense", "topology_from_mask"]


def _nonzero_padded(mask: torch.Tensor, size: int):
    """``jnp.nonzero(mask, size=size, fill_value=(R, 0))`` for a 2-D mask:
    the first ``size`` True cells in row-major order, then the (R, 0)
    sentinel. ``torch.nonzero`` neither truncates nor pads, and its shape
    depends on the data (a host sync on the card); this does neither."""
    R, C = mask.shape
    flat = mask.reshape(-1)
    rank = torch.cumsum(flat, 0) - 1  # row-major rank of each True cell
    dest = torch.where(flat & (rank < size), rank, size)  # the rest: a dump slot
    idx = torch.full((size + 1,), R * C, dtype=torch.int64, device=mask.device)
    idx.scatter_(0, dest, torch.arange(R * C, device=mask.device))
    idx = idx[:size]  # R * C (the fill) maps to the sentinel (R, 0)
    return (idx // C).to(torch.int32), (idx % C).to(torch.int32)


def _zero_invalid(valid: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return torch.where(valid[:, None, None], data, 0)


@dataclasses.dataclass(frozen=True)
class BlockMatrix:
    """A (M, N) matrix stored as ``nnz_max`` fixed (bm, bn) blocks.

    Fields (tensors on one device; shape and block are Python tuples):
      data            (nnz_max, bm, bn)  block values, zero at invalid slots
      row_indices     (nnz_max,) int32   block-row per slot, SORTED ascending;
                                         invalid slots == n_block_rows
      column_indices  (nnz_max,) int32   block-col per slot; invalid == 0
      offsets         (n_block_rows+1,) int32  CSR offsets over valid blocks
    """

    shape: tuple
    block: tuple
    data: torch.Tensor
    row_indices: torch.Tensor
    column_indices: torch.Tensor
    offsets: torch.Tensor

    @property
    def n_block_rows(self) -> int:
        return self.shape[0] // self.block[0]

    @property
    def n_block_cols(self) -> int:
        return self.shape[1] // self.block[1]

    @property
    def nnz_max(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def valid(self) -> torch.Tensor:
        """(nnz_max,) bool — which slots hold a real block."""
        return self.row_indices < self.n_block_rows

    @property
    def n_blocks(self) -> torch.Tensor:
        """Count of valid blocks (== offsets[-1]), as a 0-d tensor."""
        return self.offsets[-1]

    def topology(self) -> "BlockMatrix":
        """Same structure, all-ones data — the ``sdd`` output template."""
        return dataclasses.replace(
            self, data=_zero_invalid(self.valid, torch.ones_like(self.data))
        )

    def with_data(self, data: torch.Tensor) -> "BlockMatrix":
        """Replace block values (e.g. after an elementwise activation on
        ``.data``); invalid slots are re-zeroed to keep the invariant."""
        return dataclasses.replace(self, data=_zero_invalid(self.valid, data))

    # -------------------------------------------------------------- #
    # constructors
    # -------------------------------------------------------------- #
    @classmethod
    def from_mask(cls, mask, block: tuple, data=None, nnz_max: int = None,
                  dtype=torch.float32, device=None) -> "BlockMatrix":
        """Inspection-free construction from an (R, C) block-topology mask.

        ``nnz_max`` bounds the number of slots (defaults to the full grid,
        at least 1). Valid blocks come out row-major sorted; True cells past
        ``nnz_max`` are cut off (the offsets still count them, as the
        reference's do); padding fills with the (n_block_rows, 0) sentinel.
        """
        dev = resolve_device(device)
        mask = on_device(mask, dev, torch.bool)
        R, C = mask.shape
        bm, bn = block
        nnz_max = int(R * C if nnz_max is None else nnz_max)
        nnz_max = max(nnz_max, 1)  # a zero-size grid has no launch; pad 1 slot
        rows, cols = _nonzero_padded(mask, nnz_max)
        offsets = torch.cat([
            torch.zeros((1,), dtype=torch.int32, device=dev),
            torch.cumsum(mask.sum(dim=1), 0).to(torch.int32),
        ])
        if data is None:
            data = torch.zeros((nnz_max, bm, bn), dtype=dtype, device=dev)
        else:
            data = _zero_invalid(rows < R, on_device(data, dev))
        return cls((R * bm, C * bn), (bm, bn), data, rows, cols, offsets)

    @classmethod
    def from_coo(cls, shape: tuple, block: tuple, data, rows, cols,
                 device=None) -> "BlockMatrix":
        """Assemble from already-sorted COO block coordinates (invalid
        slots marked with ``rows == n_block_rows``); recomputes offsets."""
        dev = resolve_device(device)
        data = on_device(data, dev)
        rows = on_device(rows, dev, torch.int32)
        cols = on_device(cols, dev, torch.int32)
        R = shape[0] // block[0]
        valid = rows < R
        counts = torch.bincount(torch.where(valid, rows, R).long(), minlength=R + 1)[:R]
        offsets = torch.cat([
            torch.zeros((1,), dtype=torch.int32, device=dev),
            torch.cumsum(counts, 0).to(torch.int32),
        ])
        return cls(tuple(shape), tuple(block), _zero_invalid(valid, data), rows, cols, offsets)

    @classmethod
    def from_pattern(cls, pattern, tiles, device=None) -> "BlockMatrix":
        """From a static ``sparse.linear.BlockPattern`` (host-side tile
        coordinates, already row-major sorted): no padding slots, so
        ``tiles`` maps 1:1 onto ``data``, which is kept as given. The
        offsets come from the host coordinates, so nothing waits for the
        device (``from_coo`` counts rows on it)."""
        dev = resolve_device(device)
        R = pattern.d_in // pattern.tm
        rows = np.asarray(pattern.rows, dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=R))])
        return cls(
            (pattern.d_in, pattern.d_out), (pattern.tm, pattern.tk), on_device(tiles, dev),
            torch.as_tensor(rows, dtype=torch.int32, device=dev),
            torch.as_tensor(np.asarray(pattern.cols), dtype=torch.int32, device=dev),
            torch.as_tensor(offsets, dtype=torch.int32, device=dev),
        )

    @classmethod
    def from_dense(cls, x, block: tuple, nnz_max: int = None, device=None) -> "BlockMatrix":
        """Blockify a dense matrix, keeping blocks with any nonzero
        (``nnz_max`` defaults to the full grid)."""
        dev = resolve_device(device)
        x = on_device(x, dev)
        M, N = x.shape
        bm, bn = block
        if M % bm or N % bn:
            raise ValueError(f"dims {tuple(x.shape)} must be multiples of the block {block}")
        blocks = x.reshape(M // bm, bm, N // bn, bn).permute(0, 2, 1, 3)
        mask = (blocks != 0).any(dim=3).any(dim=2)
        sp = cls.from_mask(mask, block, nnz_max=nnz_max, dtype=x.dtype, device=dev)
        rc = sp.row_indices.clamp(max=M // bm - 1).long()
        cc = sp.column_indices.clamp(max=N // bn - 1).long()
        return sp.with_data(blocks[rc, cc])

    # -------------------------------------------------------------- #
    def transpose(self) -> "BlockMatrix":
        """(N, M) matrix: swap block coordinates, restore row-sorted order
        (a stable sort keeps column order within a row)."""
        C = self.n_block_cols
        valid = self.valid
        new_rows = torch.where(valid, self.column_indices, C)
        new_cols = torch.where(valid, self.row_indices, 0)
        order = torch.sort(new_rows, stable=True).indices
        return BlockMatrix.from_coo(
            (self.shape[1], self.shape[0]),
            (self.block[1], self.block[0]),
            self.data.transpose(1, 2)[order],
            new_rows[order],
            new_cols[order],
            device=self.device,
        )

    def _grid_index(self):
        """(row, col) slot coordinates as int64, invalid slots on the extra
        block row ``n_block_rows`` that callers slice off."""
        return self.row_indices.long(), self.column_indices.long()

    def to_dense(self) -> torch.Tensor:
        """Scatter blocks back to (M, N); invalid slots drop."""
        R, C = self.n_block_rows, self.n_block_cols
        bm, bn = self.block
        grid = torch.zeros((R + 1, C, bm, bn), dtype=self.data.dtype, device=self.device)
        grid.index_put_(self._grid_index(), self.data, accumulate=True)
        return grid[:R].permute(0, 2, 1, 3).reshape(self.shape)

    def block_mask(self) -> torch.Tensor:
        """(R, C) bool topology mask (the ``from_mask`` inverse)."""
        R, C = self.n_block_rows, self.n_block_cols
        m = torch.zeros((R + 1, C), dtype=torch.bool, device=self.device)
        m[self._grid_index()] = True
        return m[:R]

    def density(self) -> torch.Tensor:
        return self.n_blocks / max(self.n_block_rows * self.n_block_cols, 1)


def mask_from_dense(x: torch.Tensor, block: tuple) -> torch.Tensor:
    """(R, C) bool mask of blocks with any nonzero entry."""
    M, N = x.shape
    bm, bn = block
    blocks = x.reshape(M // bm, bm, N // bn, bn)
    return (blocks != 0).any(dim=3).any(dim=1)


def topology_from_mask(mask, block, nnz_max=None, device=None) -> BlockMatrix:
    """Shorthand for a data-less topology (the ``sdd`` third argument)."""
    return BlockMatrix.from_mask(mask, block, nnz_max=nnz_max, device=device)
