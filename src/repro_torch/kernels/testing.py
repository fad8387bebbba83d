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

A plain emulation of the products K3's float32 body runs on the tensor
cores: ``cvt.rna.tf32.f32`` (``tf32_rna``) and the 3xTF32 product
(``matmul_3xtf32``), which show why the body takes three products, and
restarts the tensor cores' accumulator at every step, to keep float32's
tolerance.
"""
from __future__ import annotations

import numpy as np

__all__ = ["SKEWED", "matmul_3xtf32", "run_slots", "run_tables", "skewed_tables", "tf32_rna"]

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


def tf32_rna(x) -> np.ndarray:
    """``cvt.rna.tf32.f32`` of float32 values, as float32: the mantissa
    rounded to TF32's 10 bits, to nearest with ties away from zero, and the
    13 bits below zeroed. The exponent keeps float32's range (large and
    subnormal values stay; a carry out of the mantissa moves the exponent),
    the sign stays (so +0 and -0 are kept), inf and nan pass through."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32)
    finite = (u & np.uint32(0x7F800000)) != np.uint32(0x7F800000)
    rounded = (u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)  # half a TF32 ulp, then cut
    return np.where(finite, rounded, u).astype(np.uint32).view(np.float32)


def _split(x):
    """hi = tf32(x) rounded, and lo = x - hi as the tensor cores read it:
    its top 19 bits, cut toward zero."""
    hi = tf32_rna(x)
    rest = (np.asarray(x, dtype=np.float32) - hi).view(np.uint32)
    return hi, (rest & np.uint32(0xFFFFE000)).view(np.float32)


def _round_toward_zero(x64):
    """float64 values as float32, rounded toward zero."""
    f = x64.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x64)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def matmul_3xtf32(a, b, step=16) -> np.ndarray:
    """``a @ b`` (2-D) as K3's float32 body forms it. Each operand is split
    into ``hi = tf32(x)`` and ``lo = x - hi``, which the tensor cores read as
    TF32 cut toward zero. Per 8-deep slice, ``lo @ hi``, ``hi @ lo`` and
    ``hi @ hi`` (each exact: a product of two TF32 values fits float32) are
    added into the tensor cores' accumulator rounded toward zero, their rule
    on the card; every ``step`` of depth the body adds that accumulator into
    its float32 one, rounded to nearest, and restarts it from zero.
    ``step=None`` keeps one tensor-core accumulator over all of K, whose
    truncations add up. The sums of each slice run in float64, not in the
    tensor cores' order: this emulates the precision, not the bits."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    acc = np.zeros((ah.shape[0], bh.shape[1]), np.float32)
    tc = np.zeros_like(acc)
    for k in range(0, ah.shape[1], 8):
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            part = x[:, k:k + 8].astype(np.float64) @ y[k:k + 8].astype(np.float64)
            tc = _round_toward_zero(tc.astype(np.float64) + part)
        if step and (k + 8) % step == 0:
            acc, tc = acc + tc, np.zeros_like(acc)
    return acc + tc
