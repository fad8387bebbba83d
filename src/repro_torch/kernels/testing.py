"""Tables for holding the kernels against their plain versions, shared by
the tests and ``chip_smoke.py``. numpy only.

Run-structured tables for K2 (``bsr_spmm``) and K3 (``bsr_sdd``): the
dropless MoE's tables come in runs, consecutive entries with one column
block being one expert's capacity blocks. The kernels' bfloat16 schedule
turns each run into one pass over that weight chunk, so these tables hold
runs of every length from 1 to 9, in shuffled order so that some cross a
CTA's 64-row panel or group, and padding entries past the last row.

Skewed tables for K1 and K2's float32 body, which split the tile table
evenly over the card's workers (``ops.tile_schedule``): row tiles that hold
most of the tiles, or that few tiles spread over many workers, and long
stretches of empty row tiles.
"""
from __future__ import annotations

import numpy as np

__all__ = ["SKEWED", "run_slots", "run_tables", "skewed_tables"]

SKEWED = ("heavy", "few", "one", "gaps")


def skewed_tables(rng: np.random.Generator, kind: str, n_col_tiles: int):
    """Sorted tile tables (by row, then column) of one ``kind``:

    - "heavy": 600 tiles over 23 row tiles, 90% of them in row tile 7;
    - "few": 12 tiles over 40 row tiles, 5 of them in row tile 3: fewer
      tiles than a card has workers, so that row tile spans more workers
      than it has tiles, some of them with no tile at all;
    - "one": one tile, in row tile 3 of 9;
    - "gaps": 400 tiles in row tiles 0, 1, 150, 151 and 299 of 300, with
      long runs of empty row tiles between them.

    Returns numpy (rows, cols, n_row_tiles)."""
    if kind == "heavy":
        n_rows = 23
        rows = np.concatenate([np.full(540, 7), rng.integers(0, n_rows, 60)])
    elif kind == "few":
        n_rows = 40
        rows = np.concatenate([np.full(5, 3), rng.choice(np.delete(np.arange(n_rows), 3), 7,
                                                         replace=False)])
    elif kind == "one":
        n_rows, rows = 9, np.array([3])
    elif kind == "gaps":
        n_rows = 300
        rows = rng.choice([0, 1, 150, 151, 299], 400)
    else:
        raise ValueError(f"kind must be one of {SKEWED}, got {kind!r}")
    cols = rng.integers(0, n_col_tiles, len(rows))
    order = np.lexsort((cols, rows))
    return rows[order].astype(np.int32), cols[order].astype(np.int32), n_rows


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
