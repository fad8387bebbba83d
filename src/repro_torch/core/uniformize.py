"""Tile uniformization: variable VBR blocks -> fixed uniform tiles (PyTorch
port of ``repro.core.uniformize``).

The paper's Stage-1 emits one C loop nest per variable-size block; the
block-sparse kernels want ONE regular schedule over uniform tiles.  At
staging time we:

  1. lay the block rows/columns out in a *padded* coordinate space where
     every block row/column is rounded up to the tile size,
  2. split every stored VBR block into (tm x tk) tiles, recording for each
     tile its padded-space row/col tile index and a gather map back into
     the runtime ``val`` array (sentinel index -> 0 for padding),
  3. add zero 'coverage' tiles so every padded output row-tile is visited
     at least once (kept so the tables equal the reference's; the CUDA
     kernels write an empty row tile as zeros anyway),
  4. sort tiles row-major and record ``row_ptr``, the CSR offsets of each
     output row tile's run of tiles, which the CUDA kernels walk.

Padding entries are literally 'computing over some zeros' — the paper's
trade applied a second time at the tile level.  All arrays produced here
are structure (static); only ``val`` stays runtime.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .backends import BlockMatmul

__all__ = ["TiledPattern", "row_ptr_from_ids", "uniformize"]


@dataclasses.dataclass
class TiledPattern:
    """Static tile tables for the block-sparse kernels + pack/unpack maps."""

    tm: int
    tk: int
    n_tiles: int
    # (n_tiles,) padded-space tile coordinates, sorted by (row, col)
    row_ids: np.ndarray
    col_ids: np.ndarray
    # (n_tiles, tm*tk) gather map into val (+1 shifted; 0 means padding zero)
    val_gather: np.ndarray
    # padded sizes and scatter/gather maps between real and padded coords
    m_pad: int
    k_pad: int
    x_src: np.ndarray  # (k_pad,) index into x (+1 shifted; 0 -> zero)
    y_src: np.ndarray  # (m,) index into padded y
    m: int
    k: int
    # (m_pad // tm + 1,) CSR offsets: row tile r owns tiles row_ptr[r]:row_ptr[r+1]
    row_ptr: np.ndarray

    @property
    def padded_fraction(self) -> float:
        """Fraction of tile entries that are padding (wasted kernel work)."""
        return float((self.val_gather == 0).mean())


def _ceil_to(x: int, t: int) -> int:
    return -(-x // t) * t


def uniformize(
    descs: list[BlockMatmul],
    m: int,
    k: int,
    row_splits: np.ndarray,
    col_splits: np.ndarray,
    tm: int,
    tk: int,
) -> TiledPattern:
    """Stage-0 tile packing.  ``descs`` are the matched per-block matmuls;
    ``row_splits``/``col_splits`` are rpntr/cpntr of the VBR structure."""
    row_splits = np.asarray(row_splits)
    col_splits = np.asarray(col_splits)
    R = len(row_splits) - 1
    C = len(col_splits) - 1

    # padded offsets per block row / block col
    row_pad_off = np.zeros(R + 1, dtype=np.int64)
    for a in range(R):
        h = int(row_splits[a + 1] - row_splits[a])
        row_pad_off[a + 1] = row_pad_off[a] + _ceil_to(h, tm)
    col_pad_off = np.zeros(C + 1, dtype=np.int64)
    for b in range(C):
        w = int(col_splits[b + 1] - col_splits[b])
        col_pad_off[b + 1] = col_pad_off[b] + _ceil_to(w, tk)
    m_pad = int(row_pad_off[-1])
    k_pad = int(col_pad_off[-1])

    # x scatter map: padded coord -> source coord (+1; 0 = zero fill)
    x_src = np.zeros(k_pad, dtype=np.int64)
    for b in range(C):
        c0, c1 = int(col_splits[b]), int(col_splits[b + 1])
        p0 = int(col_pad_off[b])
        x_src[p0 : p0 + (c1 - c0)] = np.arange(c0, c1) + 1
    # y gather map: real row -> padded row
    y_src = np.zeros(m, dtype=np.int64)
    for a in range(R):
        r0, r1 = int(row_splits[a]), int(row_splits[a + 1])
        p0 = int(row_pad_off[a])
        y_src[r0:r1] = np.arange(p0, p0 + (r1 - r0))

    row_of = {int(row_splits[a]): a for a in range(R)}
    col_of = {int(col_splits[b]): b for b in range(C)}

    tiles: list[tuple[int, int, np.ndarray]] = []
    rr_idx = np.arange(tm)
    cc_idx = np.arange(tk)
    for d in descs:
        a = row_of[d.row_start]
        b = col_of[d.col_start]
        h, w = d.h, d.w
        n_ti = -(-h // tm)
        n_tj = -(-w // tk)
        base_rt = int(row_pad_off[a]) // tm
        base_ct = int(col_pad_off[b]) // tk
        for ti in range(n_ti):
            for tj in range(n_tj):
                rows = ti * tm + rr_idx  # intra-block row
                cols = tj * tk + cc_idx  # intra-block col
                valid = (rows[:, None] < h) & (cols[None, :] < w)
                # col-major inside the block: idx = col*h + row
                g = d.val_off + cols[None, :] * h + rows[:, None]
                g = np.where(valid, g + 1, 0)  # +1 shift; 0 => padding zero
                tiles.append((base_rt + ti, base_ct + tj, g.reshape(-1)))

    # coverage: every output row tile must be visited at least once
    covered = {t[0] for t in tiles}
    zero_g = np.zeros(tm * tk, dtype=np.int64)
    for rt in range(m_pad // tm):
        if rt not in covered:
            tiles.append((rt, 0, zero_g))

    tiles.sort(key=lambda t: (t[0], t[1]))
    row_ids = np.asarray([t[0] for t in tiles], dtype=np.int32)
    col_ids = np.asarray([t[1] for t in tiles], dtype=np.int32)
    val_gather = np.stack([t[2] for t in tiles]).astype(np.int64)
    return TiledPattern(
        tm=tm,
        tk=tk,
        n_tiles=len(tiles),
        row_ids=row_ids,
        col_ids=col_ids,
        val_gather=val_gather,
        m_pad=m_pad,
        k_pad=k_pad,
        x_src=x_src,
        y_src=y_src,
        m=m,
        k=k,
        row_ptr=row_ptr_from_ids(row_ids, m_pad // tm),
    )


def row_ptr_from_ids(row_ids: np.ndarray, n_row_tiles: int) -> np.ndarray:
    """CSR offsets over sorted ``row_ids``: (n_row_tiles + 1,) int32."""
    bounds = np.arange(n_row_tiles + 1)
    return np.searchsorted(np.asarray(row_ids), bounds, side="left").astype(np.int32)
