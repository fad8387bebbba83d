"""Structure-class detection: what *kind* of sparsity is this? (PyTorch
port: a numpy copy of ``repro.core.inspect``.)

The autotuner (``core/autotune.py``) measures backend candidates over the
VBR blocking it is handed — but whole families of structures deserve
candidates the generic enumeration would never propose.  Fukaya et al.
(PAPERS.md, "Accelerating the SpMV kernel ... partially diagonal
structures") show banded / partially-diagonal matrices want their dense
diagonals stored as DIA vectors (contiguous, scatter-free) with only the
remainder going through the general path; Ahrens & Boman show the
blocking itself should be re-derived when it fits the pattern badly.

This module is the classifier both of those decisions key off.  It works
on the scalar *pattern* (never the values — an all-zero ``val``, e.g. a
structure skeleton rebuilt from the cache, treats every stored slot as a
pattern entry), so everything here is a staging-time constant and a
legitimate plan-cache ``meta`` field / cost-model feature.

Classes (``StructureInfo.structure_class``):

  * ``empty``               no pattern entries at all
  * ``arrow``               dense hub (first block row + column) + diagonal
  * ``banded``              every entry within a narrow scalar band
  * ``partially_diagonal``  a set of dense diagonals covers most entries
  * ``random_block``        none of the above — the generic VBR regime

Classification is a routing *hint*, not a promise: the detector gates
which extra candidates (``dia_hybrid``, reblocking proposals) enter the
measured autotune search, and measurement stays the arbiter.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import vbr as vbrlib

__all__ = [
    "StructureInfo",
    "coo_nonzeros",
    "coo_slots",
    "detect_structure",
    "detect_pattern",
    "BAND_FRAC",
    "DIA_OCCUPANCY",
    "DIA_TOTAL_OCCUPANCY",
    "MAX_DENSE_DIAGS",
    "ARROW_SCORE",
]

# detection knobs (overridable per call; see docs/inspection.md)
BAND_FRAC = 0.25            # bandwidth/max-dim below which a pattern is banded
DIA_OCCUPANCY = 0.5         # per-diagonal fill to count the diagonal as dense
DIA_TOTAL_OCCUPANCY = 0.35  # nnz fraction the dense diagonals must cover
MAX_DENSE_DIAGS = 64        # cap on DIA-hybrid diagonal storage
ARROW_SCORE = 0.85          # hub+diagonal nnz fraction to call it an arrow


@dataclasses.dataclass(frozen=True)
class StructureInfo:
    """Everything detection derives from one scalar sparsity pattern."""

    structure_class: str   # empty|arrow|banded|partially_diagonal|random_block
    nnz: int
    bandwidth: int         # max |col - row| over pattern entries
    bandwidth_frac: float  # bandwidth / max(shape) — scale-free
    diag_occupancy: float  # nnz fraction covered by the dense diagonals
    dense_offsets: tuple   # chosen DIA offsets (col - row), occupancy order
    arrow_score: float     # nnz fraction in hub row/col or diagonal blocks

    @property
    def wants_dia(self) -> bool:
        """Should ``dia_hybrid`` enter the candidate list?  True when the
        dense diagonals exist and cover enough of the pattern that
        scatter-free diagonal compute can plausibly pay for the split."""
        return bool(self.dense_offsets) and (
            self.diag_occupancy >= DIA_TOTAL_OCCUPANCY
        )


def coo_nonzeros(vbr: vbrlib.VBR):
    """Scalar (rows, cols, val_index) of every *pattern* entry.

    Pattern = non-zero stored values; a VBR whose ``val`` is all zeros (a
    structure skeleton from :meth:`~.cache.PlanCache.load_structure`)
    falls back to every stored slot, since the stored-block layout is the
    only pattern information it carries.  Use this for *detection*
    (classifying what the current values look like); anything that builds
    a value gather must use :func:`coo_slots` instead.
    """
    val = np.asarray(vbr.val)
    return _coo(vbr, use_all=val.size == 0 or not np.any(val))


def coo_slots(vbr: vbrlib.VBR):
    """Scalar (rows, cols, val_index) of every STORED slot, zeros included.

    The SABLE contract splits structure from values: a stored zero is a
    live parameter slot whose value may change under the fixed structure.
    Reblocking and DIA-hybrid gathers are *structure* — they must carry
    every slot, or a later value update into a stored-zero slot silently
    vanishes from the staged kernel's output.
    """
    return _coo(vbr, use_all=True)


def _coo(vbr: vbrlib.VBR, use_all: bool):
    rows, cols, vidx = [], [], []
    val = np.asarray(vbr.val)
    for t in vbr.blocks():
        h, w = t.height, t.width
        off = t.val_offset
        local = np.arange(h * w, dtype=np.int64)
        r = t.row_start + (local % h)  # column-major inside the block
        c = t.col_start + (local // h)
        if not use_all:
            keep = val[off : off + h * w] != 0
            local, r, c = local[keep], r[keep], c[keep]
        rows.append(r)
        cols.append(c)
        vidx.append(off + local)
    if not rows:
        z = np.zeros((0,), np.int64)
        return z, z.copy(), z.copy()
    return (
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vidx),
    )


def _dense_offsets(
    r: np.ndarray,
    c: np.ndarray,
    shape,
    occupancy: float,
    max_diags: int,
):
    """Diagonal offsets (col - row) whose fill exceeds ``occupancy``,
    ordered by entry count (descending) and capped at ``max_diags``."""
    m, k = shape
    d = c - r
    counts = np.bincount(d + (m - 1), minlength=m + k - 1)
    offsets = np.arange(-(m - 1), k, dtype=np.int64)
    # diagonal length: number of valid rows for each offset
    lengths = np.minimum(m, k - offsets) - np.maximum(0, -offsets)
    lengths = np.maximum(lengths, 1)
    occ = counts / lengths
    keep = np.nonzero((occ >= occupancy) & (counts > 0))[0]
    keep = keep[np.argsort(-counts[keep], kind="stable")][:max_diags]
    chosen = offsets[keep]
    covered = int(counts[keep].sum())
    return tuple(int(o) for o in chosen), covered


def detect_structure(
    vbr: vbrlib.VBR,
    *,
    band_frac: float = BAND_FRAC,
    dia_occupancy: float = DIA_OCCUPANCY,
    max_dense_diags: int = MAX_DENSE_DIAGS,
    arrow_score: float = ARROW_SCORE,
) -> StructureInfo:
    """Classify one VBR structure (pure numpy, O(nnz))."""
    r, c, _ = coo_nonzeros(vbr)
    nnz = len(r)
    m, k = vbr.shape
    if nnz == 0:
        return StructureInfo("empty", 0, 0, 0.0, 0.0, (), 0.0)
    bandwidth = int(np.abs(c - r).max())
    bandwidth_frac = bandwidth / max(m, k)
    offsets, covered = _dense_offsets(
        r, c, vbr.shape, dia_occupancy, max_dense_diags
    )
    diag_occ = covered / nnz

    # arrow: hub (first block row + first block column of the GIVEN
    # partition) plus the block diagonal
    h0 = int(vbr.rpntr[1]) if vbr.num_block_rows >= 1 else 0
    w0 = int(vbr.cpntr[1]) if vbr.num_block_cols >= 1 else 0
    br = np.searchsorted(vbr.rpntr, r, side="right") - 1
    bc = np.searchsorted(vbr.cpntr, c, side="right") - 1
    on_arrow = (r < h0) | (c < w0) | (br == bc)
    a_score = float(on_arrow.mean())
    hub = ((r < h0) & (c >= w0)) | ((c < w0) & (r >= h0))

    if (
        a_score >= arrow_score
        and hub.any()
        and min(vbr.num_block_rows, vbr.num_block_cols) >= 3
        and bandwidth_frac > band_frac
    ):
        cls = "arrow"
    elif bandwidth_frac <= band_frac:
        cls = "banded"
    elif diag_occ >= DIA_TOTAL_OCCUPANCY:
        cls = "partially_diagonal"
    else:
        cls = "random_block"
    return StructureInfo(
        structure_class=cls,
        nnz=nnz,
        bandwidth=bandwidth,
        bandwidth_frac=float(bandwidth_frac),
        diag_occupancy=float(diag_occ),
        dense_offsets=offsets,
        arrow_score=a_score,
    )


def detect_pattern(pattern) -> StructureInfo:
    """Classify a ``sparse.linear.BlockPattern`` at tile-grid granularity.

    Tiles live on an R x C grid; coordinates are normalized so rectangular
    grids still have a meaningful diagonal (tile (r, c) is diagonal-band
    when its normalized centers align within one tile pitch).  The
    ``dense_offsets`` field carries the *grid* offsets (only exact for
    square grids); ``wants_dia`` is what ``choose_matmul_strategy`` gates
    its ``dia_hybrid`` candidate on.
    """
    rows = np.asarray(pattern.rows, dtype=np.int64)
    cols = np.asarray(pattern.cols, dtype=np.int64)
    R = max(pattern.d_in // pattern.tm, 1)
    C = max(pattern.d_out // pattern.tk, 1)
    nnz = len(rows)
    if nnz == 0:
        return StructureInfo("empty", 0, 0, 0.0, 0.0, (), 0.0)
    # normalized positions in [0, 1): the scale-free band measure
    rn = (rows + 0.5) / R
    cn = (cols + 0.5) / C
    band = np.abs(cn - rn)
    bandwidth_frac = float(band.max())
    pitch = max(1.0 / R, 1.0 / C)
    on_diag = band <= pitch  # within one tile pitch of the diagonal
    diag_occ = float(on_diag.mean())
    if R == C:
        d = cols - rows
        counts = np.bincount(d + (R - 1), minlength=2 * R - 1)
        offs = np.arange(-(R - 1), R, dtype=np.int64)
        lengths = np.maximum(R - np.abs(offs), 1)
        keep = np.nonzero(counts / lengths >= DIA_OCCUPANCY)[0]
        keep = keep[np.argsort(-counts[keep], kind="stable")][:MAX_DENSE_DIAGS]
        offsets = tuple(int(o) for o in offs[keep])
    else:
        offsets = (0,) if on_diag.any() else ()
    on_arrow = (rows == 0) | (cols == 0) | on_diag
    a_score = float(on_arrow.mean())
    hub = ((rows == 0) & ~on_diag) | ((cols == 0) & ~on_diag)
    if a_score >= ARROW_SCORE and hub.any() and min(R, C) >= 3 and (
        bandwidth_frac > BAND_FRAC
    ):
        cls = "arrow"
    elif bandwidth_frac <= BAND_FRAC:
        cls = "banded"
    elif diag_occ >= DIA_TOTAL_OCCUPANCY:
        cls = "partially_diagonal"
    else:
        cls = "random_block"
    bandwidth = int(round(bandwidth_frac * max(pattern.d_in, pattern.d_out)))
    return StructureInfo(
        structure_class=cls,
        nnz=nnz,
        bandwidth=bandwidth,
        bandwidth_frac=bandwidth_frac,
        diag_occupancy=diag_occ,
        dense_offsets=offsets,
        arrow_score=a_score,
    )
