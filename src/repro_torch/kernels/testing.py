"""Run-structured tables for holding K2 (``bsr_spmm``) and K3 (``bsr_sdd``)
against their plain versions, shared by the card tests and ``chip_smoke.py``.

The dropless MoE's tables come in runs: consecutive entries with one column
block are one expert's capacity blocks. The kernels' bfloat16 schedule turns
each run into one pass over that weight chunk, so these tables hold runs of
every length from 1 to 9, in shuffled order so that some cross a CTA's
64-row panel or group, and padding entries past the last row. numpy only.
"""
from __future__ import annotations

import numpy as np

__all__ = ["run_slots", "run_tables"]


def run_tables(rng: np.random.Generator, n_col_tiles: int, pad: int):
    """K2 tile tables as the dropless MoE's dsd makes them: runs of 1-9
    consecutive row tiles with one tile each, all of one column tile, with
    empty row tiles between some runs; two more runs over rows that already
    have a tile, in another column tile (so that two runs add into one row
    tile); then ``pad`` padding tiles past the last row tile (row ==
    n_row_tiles, col 0), as BlockMatrix pads. Sorted by row, then column.
    Returns numpy (rows, cols, n_row_tiles)."""
    rows, cols, r = [], [], 0
    for length in rng.permutation(np.arange(1, 10)):
        rows += range(r, r + length)
        cols += [int(rng.integers(n_col_tiles))] * length
        r += length + int(rng.integers(0, 3))
    for start, length in ((rows[3], 4), (rows[20], 2)):
        rows += range(start, start + length)
        cols += [(cols[rows.index(start)] + 1) % n_col_tiles] * length
    order = np.lexsort((cols, rows))
    rows = np.concatenate([np.asarray(rows)[order], np.full(pad, r)]).astype(np.int32)
    cols = np.concatenate([np.asarray(cols)[order], np.zeros(pad)]).astype(np.int32)
    return rows, cols, r


def run_slots(rng: np.random.Generator, n_col_blocks: int, pad: int):
    """K3 slots as the dropless MoE's topology makes them: runs of 1-9 slots
    of one column block over consecutive row blocks, with a gap between
    some runs; then ``pad`` padding slots (row == n_row_blocks) whose column
    is out of range, since K3 must not read it. Returns numpy (rows, cols,
    n_row_blocks)."""
    rows, cols, r = [], [], 0
    for length in rng.permutation(np.arange(1, 10)):
        rows += range(r, r + length)
        cols += [int(rng.integers(n_col_blocks))] * length
        r += length + int(rng.integers(0, 2))
    rows = np.concatenate([rows, np.full(pad, r)]).astype(np.int32)
    cols = np.concatenate([cols, np.full(pad, n_col_blocks + 7)]).astype(np.int32)
    return rows, cols, r
