"""Variable Block Row (VBR) sparse matrix format (PyTorch port).

A numpy copy of ``repro.core.vbr``: the structure is host data known at
staging time, and ``structure_hash`` is byte-identical to the JAX package's,
so both key their caches alike.

The VBR format (Saad, SPARSKIT) partitions a matrix by row splits ``rpntr``
and column splits ``cpntr``; any block-row/block-column cell that contains at
least one non-zero is stored *densely* (column-major inside the block).  The
indirection arrays follow the paper (Fig. 3):

  val     values of stored blocks, column-major within each block
  indx    start offset of each stored block inside ``val`` (len = nblocks+1)
  bindx   block-column index of each stored block (row-major over block rows)
  rpntr   row-partition boundaries   (len = R+1)
  cpntr   column-partition boundaries(len = C+1)
  bpntrb  for each block row, start into ``bindx`` (-1 if the row is empty)
  bpntre  for each block row, end into ``bindx``

Everything except ``val`` is *structure*: it is known at staging time and is
partially evaluated away.  ``val`` is the only runtime input — the same staged
executable serves every matrix sharing the pattern.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterator, Sequence

import numpy as np

__all__ = [
    "VBR",
    "BlockTask",
    "from_dense",
    "synthesize",
    "synthesize_paper",
    "structure_hash",
]


@dataclasses.dataclass
class VBR:
    """A sparse matrix in Variable Block Row format."""

    shape: tuple[int, int]
    rpntr: np.ndarray  # (R+1,) int32
    cpntr: np.ndarray  # (C+1,) int32
    bindx: np.ndarray  # (nblocks,) int32
    bpntrb: np.ndarray  # (R,) int32, -1 for empty block rows
    bpntre: np.ndarray  # (R,) int32
    indx: np.ndarray  # (nblocks+1,) int64
    val: np.ndarray  # (nnz_stored,) — the ONLY runtime data

    # ------------------------------------------------------------------ #
    def __post_init__(self) -> None:
        self.rpntr = np.asarray(self.rpntr, dtype=np.int32)
        self.cpntr = np.asarray(self.cpntr, dtype=np.int32)
        self.bindx = np.asarray(self.bindx, dtype=np.int32)
        self.bpntrb = np.asarray(self.bpntrb, dtype=np.int32)
        self.bpntre = np.asarray(self.bpntre, dtype=np.int32)
        self.indx = np.asarray(self.indx, dtype=np.int64)

    @property
    def num_block_rows(self) -> int:
        return len(self.rpntr) - 1

    @property
    def num_block_cols(self) -> int:
        return len(self.cpntr) - 1

    @property
    def num_blocks(self) -> int:
        return len(self.bindx)

    @property
    def stored_nnz(self) -> int:
        return int(self.indx[-1])

    # ------------------------------------------------------------------ #
    def blocks(self) -> Iterator["BlockTask"]:
        """Stage-0 block iterator: yields one task per stored dense block.

        This is the paper's ``for block in vbr_matrix`` iterator: a pure
        Python traversal of the indirection arrays, fully evaluable at
        staging time.
        """
        count = 0
        for a in range(self.num_block_rows):
            if self.bpntrb[a] == -1:
                continue
            r0, r1 = int(self.rpntr[a]), int(self.rpntr[a + 1])
            for bi in range(int(self.bpntrb[a]), int(self.bpntre[a])):
                b = int(self.bindx[bi])
                c0, c1 = int(self.cpntr[b]), int(self.cpntr[b + 1])
                yield BlockTask(
                    block_row=a,
                    block_col=b,
                    row_start=r0,
                    row_end=r1,
                    col_start=c0,
                    col_end=c1,
                    val_offset=int(self.indx[count]),
                )
                count += 1

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.val.dtype)
        for t in self.blocks():
            h, w = t.row_end - t.row_start, t.col_end - t.col_start
            blk = self.val[t.val_offset : t.val_offset + h * w]
            # column-major inside the block, as in the paper
            out[t.row_start : t.row_end, t.col_start : t.col_end] = blk.reshape(
                w, h
            ).T
        return out

    def density(self) -> float:
        """Fraction of stored values that are non-zero (block fill ratio)."""
        if self.stored_nnz == 0:
            return 1.0
        return float(np.count_nonzero(self.val)) / float(self.stored_nnz)


@dataclasses.dataclass(frozen=True)
class BlockTask:
    """One stored dense block — the Stage-0 unit of work.

    All fields are Python ints known at staging time; the paper's Stage-1
    C code has them baked in as constants (Listing 2).  Here they are baked
    into the tile tables of the kernel backend.
    """

    block_row: int
    block_col: int
    row_start: int
    row_end: int
    col_start: int
    col_end: int
    val_offset: int

    @property
    def height(self) -> int:
        return self.row_end - self.row_start

    @property
    def width(self) -> int:
        return self.col_end - self.col_start

    @property
    def size(self) -> int:
        return self.height * self.width


# ---------------------------------------------------------------------- #
# Construction
# ---------------------------------------------------------------------- #
def from_dense(
    dense: np.ndarray,
    rpntr: Sequence[int],
    cpntr: Sequence[int],
) -> VBR:
    """Build a VBR matrix from a dense array and given partitions.

    A block is stored iff it contains at least one non-zero (mostly-dense
    blocks keep their explicit zeros — that is the point of the format).
    """
    dense = np.asarray(dense)
    rpntr = np.asarray(rpntr, dtype=np.int32)
    cpntr = np.asarray(cpntr, dtype=np.int32)
    R, C = len(rpntr) - 1, len(cpntr) - 1
    bindx: list[int] = []
    bpntrb: list[int] = []
    bpntre: list[int] = []
    indx: list[int] = [0]
    vals: list[np.ndarray] = []
    for a in range(R):
        r0, r1 = rpntr[a], rpntr[a + 1]
        row_blocks = []
        for b in range(C):
            c0, c1 = cpntr[b], cpntr[b + 1]
            blk = dense[r0:r1, c0:c1]
            if np.any(blk != 0):
                row_blocks.append(b)
                vals.append(np.asarray(blk.T, order="C").reshape(-1))  # col-major
                indx.append(indx[-1] + blk.size)
        if row_blocks:
            bpntrb.append(len(bindx))
            bindx.extend(row_blocks)
            bpntre.append(len(bindx))
        else:
            bpntrb.append(-1)
            bpntre.append(-1)
    val = (
        np.concatenate(vals)
        if vals
        else np.zeros((0,), dtype=dense.dtype)
    )
    return VBR(
        shape=dense.shape,
        rpntr=rpntr,
        cpntr=cpntr,
        bindx=np.asarray(bindx, dtype=np.int32),
        bpntrb=np.asarray(bpntrb, dtype=np.int32),
        bpntre=np.asarray(bpntre, dtype=np.int32),
        indx=np.asarray(indx, dtype=np.int64),
        val=val,
    )


def _split_points(n: int, parts: int, uniform: bool, rng: np.random.Generator):
    """Partition ``[0, n)`` into ``parts`` pieces (uniform or random sizes)."""
    if parts >= n:
        return np.arange(n + 1, dtype=np.int32)
    if uniform:
        pts = np.linspace(0, n, parts + 1).round().astype(np.int32)
    else:
        cuts = np.sort(rng.choice(np.arange(1, n), size=parts - 1, replace=False))
        pts = np.concatenate([[0], cuts, [n]]).astype(np.int32)
    return pts


def synthesize(
    rows: int,
    cols: int,
    row_splits: int,
    col_splits: int,
    num_blocks: int,
    block_sparsity: float = 0.0,
    uniform: bool = True,
    seed: int = 0,
    dtype=np.float32,
) -> VBR:
    """The paper's matrix generator (Section V, 'Generating Matrices').

    Overlay a ``row_splits x col_splits`` grid on a ``rows x cols`` matrix,
    pick ``num_blocks`` random grid cells to be (mostly) dense blocks, and
    fill each chosen block with values where a ``block_sparsity`` fraction
    of entries are zeroed (the zeros SABLE tolerates).
    """
    rng = np.random.default_rng(seed)
    rpntr = _split_points(rows, row_splits, uniform, rng)
    cpntr = _split_points(cols, col_splits, uniform, rng)
    R, C = len(rpntr) - 1, len(cpntr) - 1
    total_cells = R * C
    num_blocks = min(num_blocks, total_cells)
    chosen = rng.choice(total_cells, size=num_blocks, replace=False)
    chosen = np.sort(chosen)

    bindx: list[int] = []
    bpntrb: list[int] = []
    bpntre: list[int] = []
    indx: list[int] = [0]
    vals: list[np.ndarray] = []
    by_row: dict[int, list[int]] = {}
    for cell in chosen:
        by_row.setdefault(int(cell) // C, []).append(int(cell) % C)
    for a in range(R):
        h = int(rpntr[a + 1] - rpntr[a])
        row_blocks = by_row.get(a)
        if not row_blocks:
            bpntrb.append(-1)
            bpntre.append(-1)
            continue
        bpntrb.append(len(bindx))
        for b in row_blocks:
            w = int(cpntr[b + 1] - cpntr[b])
            blk = rng.standard_normal(h * w).astype(dtype)
            if block_sparsity > 0:
                mask = rng.random(h * w) < block_sparsity
                blk[mask] = 0
                if np.all(blk == 0) and h * w > 0:
                    blk[0] = 1.0  # keep the block non-empty
            vals.append(blk)
            bindx.append(b)
            indx.append(indx[-1] + h * w)
        bpntre.append(len(bindx))
    val = np.concatenate(vals) if vals else np.zeros((0,), dtype=dtype)
    return VBR(
        shape=(rows, cols),
        rpntr=rpntr,
        cpntr=cpntr,
        bindx=np.asarray(bindx, dtype=np.int32),
        bpntrb=np.asarray(bpntrb, dtype=np.int32),
        bpntre=np.asarray(bpntre, dtype=np.int32),
        indx=np.asarray(indx, dtype=np.int64),
        val=val,
    )


def synthesize_paper(
    row_splits: int,
    col_splits: int,
    num_blocks: int,
    zeros_pct: int = 0,
    uniform: bool = True,
    seed: int = 0,
    rows: int = 10_000,
    cols: int = 10_000,
) -> VBR:
    """Matrices named ``<row_splits, col_splits, num_blocks, u|nu>`` in
    Tables I-IV of the paper (10k x 10k, block sparsity in percent)."""
    return synthesize(
        rows,
        cols,
        row_splits,
        col_splits,
        num_blocks,
        block_sparsity=zeros_pct / 100.0,
        uniform=uniform,
        seed=seed,
    )


def structure_hash(vbr: VBR) -> str:
    """Hash of the sparsity *pattern* only (never the values).

    This is the compile-once/run-many key: two matrices with equal hashes
    share the staged executable (paper Section III — specialization 'is
    focused on the sparse structure of the matrix, not ... the actual
    values').
    """
    h = hashlib.sha256()
    for arr in (vbr.rpntr, vbr.cpntr, vbr.bindx, vbr.bpntrb, vbr.bpntre, vbr.indx):
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(str(vbr.shape).encode())
    return h.hexdigest()[:16]
