"""Structure-aware VBR partitioning for sharded staged execution (PyTorch
port of ``repro.distributed.partition``: a numpy copy, so the port's shard
plans equal the JAX package's, tie-breaking included, and a ``shards``
record written by either package loads in the other).

The paper parallelizes staged kernels by splitting block rows across
workers (Section IV-D); Ahrens & Boman's VBR partitioning work makes the
stronger point that the split should be chosen from the sparsity
*structure* ahead of time.  Block sizes are structure, so the load model
is exact at inspection time: this module cuts the block rows of a VBR
pattern into ``num_shards`` shards balanced by stored-nonzero count (not
row count — a shard of many empty rows costs nothing), and compacts each
shard into its own shard-local VBR whose block-size distribution is all a
device ever stages kernels for.

Everything here is structure-only and device-agnostic.  The indirection
arrays of each shard round-trip through the persistent structure cache
(:mod:`repro_torch.core.cache`) exactly like any other pattern; the partition
decision itself is recorded as a ``kind='shards'`` plan so a warm process
skips the partitioning step too. That record keeps the strategy in the
device slot, so its key (``shards-<hash>-<strategy>-x<N>``) carries no
device segment and is the same in both packages.

Strategies:
  'lpt'         greedy longest-processing-time bin packing over block
                rows (best balance; shard rows are scattered)
  'contiguous'  optimal-bottleneck contiguous split (chains-on-chains via
                binary search over the makespan; preserves row locality)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import vbr as vbrlib
from ..core.cache import PlanCache, TuningPlan, default_cache, plan_key
from ..core.staging import StagingOptions

__all__ = [
    "VBRShard",
    "ShardPlan",
    "block_row_nnz",
    "partition_nnz_balanced",
    "shard_vbr",
    "make_shard_plan",
    "save_shard_plan",
    "load_shard_plan",
]


def block_row_nnz(vbr: vbrlib.VBR) -> np.ndarray:
    """Stored nonzeros per block row — the exact inspection-time load model."""
    sizes = np.zeros(vbr.num_block_rows, dtype=np.int64)
    for t in vbr.blocks():
        sizes[t.block_row] += t.size
    return sizes


def _make_units(vbr: vbrlib.VBR, num_shards: int) -> list[tuple]:
    """Work units ``(block_row, r0, r1, nnz)`` with r0/r1 LOCAL row bounds.

    Every block in a block row spans its full height, so nnz is uniform
    per matrix row within a block row; a block row holding more than the
    per-shard mean is split into row spans so no single unit can dominate
    a shard (the 1.5x balance bound must hold even when one dense block
    row outweighs everything else)."""
    sizes = block_row_nnz(vbr)
    total = int(sizes.sum())
    cap = max(-(-total // num_shards), 1)  # ceil(mean)
    units: list[tuple] = []
    for a, sz in enumerate(sizes.tolist()):
        h = int(vbr.rpntr[a + 1] - vbr.rpntr[a])
        if sz > cap and h > 1:
            parts = min(-(-sz // cap), h)
            bounds = np.linspace(0, h, parts + 1).round().astype(np.int64)
            per_row = sz // h  # blocks span the full height => exact
            for i in range(parts):
                r0, r1 = int(bounds[i]), int(bounds[i + 1])
                if r1 > r0:
                    units.append((a, r0, r1, per_row * (r1 - r0)))
        else:
            units.append((a, 0, h, sz))
    return units


def _partition_lpt(units: list[tuple], num_shards: int) -> list[list[tuple]]:
    order = sorted(range(len(units)), key=lambda i: -units[i][3])
    bins: list[list[int]] = [[] for _ in range(num_shards)]
    loads = np.zeros(num_shards, dtype=np.int64)
    for i in order:
        w = int(np.argmin(loads))
        bins[w].append(i)
        loads[w] += units[i][3]
    return [[units[i] for i in sorted(b)] for b in bins]


def _partition_contiguous(units: list[tuple], num_shards: int) -> list[list[tuple]]:
    """Minimize the bottleneck over contiguous unit ranges: binary search
    the makespan, greedily packing units while under it."""
    U = len(units)
    sizes = np.asarray([u[3] for u in units], dtype=np.int64)
    prefix = np.concatenate([[0], np.cumsum(sizes)])
    total = int(prefix[-1])

    def fits(cap: int) -> list[int] | None:
        cuts, start = [0], 0
        for _ in range(num_shards):
            # furthest end with sum(sizes[start:end]) <= cap
            end = int(np.searchsorted(prefix, prefix[start] + cap, side="right")) - 1
            end = max(end, start + 1) if start < U else start
            cuts.append(min(end, U))
            start = cuts[-1]
        return cuts if cuts[-1] >= U else None

    lo, hi = int(sizes.max(initial=0)), max(total, 1)
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        c = fits(mid)
        if c is not None:
            best, hi = c, mid - 1
        else:
            lo = mid + 1
    if best is None:  # num_shards >= U: one unit per shard, rest empty
        best = list(range(U + 1)) + [U] * (num_shards - U)
    return [units[best[i] : best[i + 1]] for i in range(num_shards)]


def partition_nnz_balanced(
    vbr: vbrlib.VBR, num_shards: int, strategy: str = "lpt"
) -> list[list[tuple]]:
    """Cut the matrix into ``num_shards`` row-span lists balanced by
    stored nnz.  Each element is a unit ``(block_row, r0, r1, nnz)``
    (local row bounds within the block row); block rows larger than the
    per-shard mean are split across shards."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    units = _make_units(vbr, num_shards)
    if strategy == "lpt":
        return _partition_lpt(units, num_shards)
    if strategy == "contiguous":
        return _partition_contiguous(units, num_shards)
    raise ValueError(f"unknown partition strategy {strategy!r}")


# ---------------------------------------------------------------------- #
# shard-local structures
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class VBRShard:
    """One shard: a compacted VBR over a set of row spans, plus the
    indirection back into the global matrix.

    A span is ``(block_row, r0, r1)`` with r0/r1 local to the block row —
    usually the full height, but oversized block rows are split across
    shards.  ``vbr.val`` holds the shard's slice of the parent values so
    the shard is immediately stageable/benchmarkable; at runtime a fresh
    global ``val`` is resliced via ``val_index``.
    """

    shard_id: int
    num_shards: int
    spans: tuple  # ((block_row, r0, r1), ...) owned by this shard
    vbr: vbrlib.VBR  # shard-local structure (rows renumbered compactly)
    row_index: np.ndarray  # (local_m,) global row of each local row
    val_index: np.ndarray  # (local_nnz,) global val offset of each local val

    @property
    def block_rows(self) -> np.ndarray:
        """Global block rows this shard touches (possibly partially)."""
        return np.unique(np.asarray([s[0] for s in self.spans], dtype=np.int64))

    @property
    def nnz(self) -> int:
        return int(self.vbr.stored_nnz)

    @property
    def local_m(self) -> int:
        return int(self.vbr.shape[0])


def _norm_spans(vbr: vbrlib.VBR, spans) -> list[tuple]:
    out = []
    for s in spans:
        if np.isscalar(s):  # a bare block-row id = its full span
            a = int(s)
            out.append((a, 0, int(vbr.rpntr[a + 1] - vbr.rpntr[a])))
        else:
            a, r0, r1 = (int(x) for x in tuple(s)[:3])
            out.append((a, r0, r1))
    return sorted(out)


def shard_vbr(
    vbr: vbrlib.VBR, spans, shard_id: int = 0, num_shards: int = 1
) -> VBRShard:
    """Compact the selected row spans of ``vbr`` into a shard-local VBR.

    ``spans`` is a sequence of block-row ids and/or ``(block_row, r0, r1)``
    tuples.  Blocks are stored column-major, so the rows ``[r0, r1)`` of a
    height-``h`` block at offset ``off`` live at ``off + c*h + r`` — the
    per-value gather ``val_index`` keeps the global→shard reslice exact.
    """
    spans = _norm_spans(vbr, spans)
    by_row: dict[int, list] = {}
    for t in vbr.blocks():
        by_row.setdefault(t.block_row, []).append(t)

    rpntr = [0]
    row_index: list[np.ndarray] = []
    bindx: list[int] = []
    bpntrb: list[int] = []
    bpntre: list[int] = []
    indx = [0]
    val_chunks: list[np.ndarray] = []
    for a, r0, r1 in spans:
        ra0 = int(vbr.rpntr[a])
        h = int(vbr.rpntr[a + 1]) - ra0
        rcnt = r1 - r0
        row_index.append(np.arange(ra0 + r0, ra0 + r1, dtype=np.int64))
        rpntr.append(rpntr[-1] + rcnt)
        tasks = by_row.get(a)
        if not tasks or rcnt == 0:
            bpntrb.append(-1)
            bpntre.append(-1)
            continue
        bpntrb.append(len(bindx))
        for t in tasks:
            w = t.width
            bindx.append(t.block_col)
            g = (
                t.val_offset
                + np.arange(w, dtype=np.int64)[:, None] * h
                + r0
                + np.arange(rcnt, dtype=np.int64)[None, :]
            ).reshape(-1)
            val_chunks.append(g)
            indx.append(indx[-1] + w * rcnt)
        bpntre.append(len(bindx))
    val_index = (
        np.concatenate(val_chunks) if val_chunks else np.zeros(0, np.int64)
    )
    sub = vbrlib.VBR(
        shape=(rpntr[-1], vbr.shape[1]),
        rpntr=np.asarray(rpntr, dtype=np.int32),
        cpntr=vbr.cpntr.copy(),
        bindx=np.asarray(bindx, dtype=np.int32),
        bpntrb=np.asarray(bpntrb, dtype=np.int32),
        bpntre=np.asarray(bpntre, dtype=np.int32),
        indx=np.asarray(indx, dtype=np.int64),
        val=np.asarray(vbr.val)[val_index],
    )
    return VBRShard(
        shard_id=shard_id,
        num_shards=num_shards,
        spans=tuple(spans),
        vbr=sub,
        row_index=(
            np.concatenate(row_index) if row_index else np.zeros(0, np.int64)
        ),
        val_index=val_index,
    )


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """A full partition of one VBR pattern into per-device shards."""

    structure_hash: str  # parent pattern hash
    shape: tuple
    num_shards: int
    strategy: str
    shards: tuple

    def nnz_per_shard(self) -> np.ndarray:
        return np.asarray([s.nnz for s in self.shards], dtype=np.int64)

    def imbalance(self) -> float:
        """max shard nnz / mean shard nnz (1.0 = perfectly balanced)."""
        nnz = self.nnz_per_shard()
        mean = nnz.sum() / max(self.num_shards, 1)
        return float(nnz.max(initial=0) / mean) if mean > 0 else 1.0

    def shard_hashes(self) -> list[str]:
        return [vbrlib.structure_hash(s.vbr) for s in self.shards]


def make_shard_plan(
    vbr: vbrlib.VBR, num_shards: int, strategy: str = "lpt"
) -> ShardPlan:
    assignment = partition_nnz_balanced(vbr, num_shards, strategy)
    shards = tuple(
        shard_vbr(vbr, units, shard_id=i, num_shards=num_shards)
        for i, units in enumerate(assignment)
    )
    return ShardPlan(
        structure_hash=vbrlib.structure_hash(vbr),
        shape=tuple(vbr.shape),
        num_shards=num_shards,
        strategy=strategy,
        shards=shards,
    )


# ---------------------------------------------------------------------- #
# persistence (structure only — values never touch the cache)
# ---------------------------------------------------------------------- #
def _partition_key(structure_hash: str, num_shards: int, strategy: str) -> str:
    return plan_key("shards", structure_hash, strategy, num_shards=num_shards)


def save_shard_plan(plan: ShardPlan, cache: PlanCache | None = None) -> str:
    """Persist the partition decision + every shard's indirection arrays."""
    cache = cache if cache is not None else default_cache()
    for s in plan.shards:
        cache.store_structure(s.vbr)
    record = TuningPlan(
        kind="shards",
        structure_hash=plan.structure_hash,
        options=StagingOptions(),  # placeholder; partition is backend-free
        device=plan.strategy,  # device slot holds the (device-agnostic) strategy
        num_workers=plan.num_shards,
        meta={
            "shape": [int(d) for d in plan.shape],
            "num_shards": plan.num_shards,
            "strategy": plan.strategy,
            "spans": [[list(sp) for sp in s.spans] for s in plan.shards],
            "shard_hashes": plan.shard_hashes(),
            "nnz_per_shard": [int(n) for n in plan.nnz_per_shard()],
        },
        source="partition",
    )
    return cache.store_plan(
        _partition_key(plan.structure_hash, plan.num_shards, plan.strategy),
        record,
    )


def load_shard_plan(
    vbr: vbrlib.VBR,
    num_shards: int,
    strategy: str = "lpt",
    cache: PlanCache | None = None,
) -> ShardPlan | None:
    """Rebuild a persisted partition for ``vbr``; None on miss/mismatch."""
    cache = cache if cache is not None else default_cache()
    shash = vbrlib.structure_hash(vbr)
    record = cache.load_plan(_partition_key(shash, num_shards, strategy))
    if record is None or record.meta.get("num_shards") != num_shards:
        return None
    shards = tuple(
        shard_vbr(vbr, spans, shard_id=i, num_shards=num_shards)
        for i, spans in enumerate(record.meta["spans"])
    )
    plan = ShardPlan(
        structure_hash=shash,
        shape=tuple(vbr.shape),
        num_shards=num_shards,
        strategy=strategy,
        shards=shards,
    )
    if plan.shard_hashes() != record.meta.get("shard_hashes"):
        return None  # stale/corrupt record
    return plan
