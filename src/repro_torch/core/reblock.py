"""Cost-optimal VBR reblocking (Ahrens & Boman) — the partition is a choice.
(PyTorch port of ``repro.core.reblock``: the DP, the proposals and the
functions that build the gathers are its numpy, copied; ``ReblockedKernel``
is a torch gather.)

Everything downstream of inspection takes the VBR row/column partition as
given; this module makes the partition itself a tuned decision.  Ahrens &
Boman ("On Optimal Partitioning For Sparse Matrices In Variable Block Row
Format", PAPERS.md) model the cost of a blocking with a *linear* cost
function and show the optimal contiguous partition is a dynamic program.
We use their cost in the natural form for this codebase::

    cost(P) = alpha * num_stored_blocks(P) + stored_entries(P)

``stored_entries`` counts every slot of every stored block — explicit
zeros (fill-in) included, because that is exactly what the staged kernels
compute over.  ``alpha`` prices the per-block overhead a stored block
costs the grouped/bucketed/cuda backends (gather rows, block-table
entries, scatter targets) in stored-entry units.  Fewer, fuller blocks
and more, emptier blocks are now on one axis and the DP minimizes it.

Proposals (``propose_reblockings``) come in two strategies:

  * ``dp``       alternate row-then-column contiguous-partition DP.  Exact
                 over its split-point set; for large matrices the
                 *bounded-cost approximation* kicks in — split points are
                 restricted to the as-given partition boundaries and block
                 spans are bounded by ``max_span`` segments, keeping the
                 DP O(points x max_span x ortho_blocks).
  * ``aligned``  Sylos Labini-style 1-bounded blocking: uniform tiles of
                 the cuda backend's default tile (``StagingOptions.tile``,
                 32 x 32, where the reference aligns to the TPU's 8 x 128),
                 every block bounded by one tile of K1/K2.  Proposed on the
                 card, or anywhere it beats the as-given cost.

A proposal is carried as a :class:`ReblockSpec` — partitions, model cost,
fill ratio, and the *reblocked* structure hash — and is what a
:class:`~.cache.TuningPlan` records (``plan.reblock``) when a reblocked
candidate wins the autotune measurement.  ``apply_reblock`` turns the
original VBR into the reblocked one plus a ``val_gather`` map, so at
runtime the original value array is re-laid-out with one gather (sentinel
slot 0 = fill zero) and the staged kernel for the *reblocked* structure
does the rest (:class:`ReblockedKernel`).

Warm restarts re-derive nothing: the spec in the plan pins the partitions
(no DP), the reblocked structure is keyed in the cache by its own hash,
and ``reblock_stats()['dp_runs']`` staying 0 is the acceptance check.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import on_device, resolve_device
from . import vbr as vbrlib
from .inspect import coo_slots

__all__ = [
    "ReblockSpec",
    "ReblockedKernel",
    "partition_cost",
    "optimal_partition_1d",
    "propose_reblockings",
    "apply_reblock",
    "stage_reblocked",
    "reblock_stats",
    "reset_reblock_stats",
    "clear_reblock_cache",
    "RB_ALPHA",
    "MAX_DP_POINTS",
    "MAX_SPAN",
    "MIN_GAIN",
    "ALIGNED_TILE",
    "MAX_ALIGNED_FILL",
]

# cost-model / DP knobs (see docs/inspection.md for the derivation)
RB_ALPHA = 16.0        # per-stored-block overhead, in stored-entry units
MAX_DP_POINTS = 2048   # above this many rows/cols: bounded-cost approximation
MAX_SPAN = 12          # max segments a DP block may span (bounds the DP)
MIN_GAIN = 0.98        # dp proposal must beat as-given cost by >=2%
ALIGNED_TILE = (32, 32)  # 1-bounded blocking target: the cuda backend's default tile
MAX_ALIGNED_FILL = 8.0   # drop aligned proposals whose fill explodes

_STATS = {"dp_runs": 0, "proposals": 0, "applies": 0}


def reblock_stats() -> dict:
    return dict(_STATS)


def reset_reblock_stats() -> None:
    _STATS.update({k: 0 for k in _STATS})


@dataclasses.dataclass(frozen=True)
class ReblockSpec:
    """One reblocking proposal: partitions + Ahrens-Boman model cost.

    ``structure_hash`` is the hash of the REBLOCKED structure (the key the
    reblocked plan/structure are cached under); ``fill_ratio`` is stored
    entries of the reblocked layout / stored slots of the original — the
    cost-model feature ``reblock_fill``.
    """

    strategy: str          # "dp" | "aligned{tm}x{tk}"
    rpntr: tuple           # reblocked row partition
    cpntr: tuple           # reblocked column partition
    cost: float            # linear model cost of this blocking
    base_cost: float       # linear model cost of the as-given blocking
    fill_ratio: float      # stored entries / pattern nnz after reblocking
    structure_hash: str    # hash of the REBLOCKED structure
    alpha: float = RB_ALPHA

    def to_dict(self) -> dict:
        return {
            "strategy": self.strategy,
            "rpntr": [int(p) for p in self.rpntr],
            "cpntr": [int(p) for p in self.cpntr],
            "cost": float(self.cost),
            "base_cost": float(self.base_cost),
            "fill_ratio": float(self.fill_ratio),
            "structure_hash": self.structure_hash,
            "alpha": float(self.alpha),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ReblockSpec":
        return cls(
            strategy=d["strategy"],
            rpntr=tuple(int(p) for p in d["rpntr"]),
            cpntr=tuple(int(p) for p in d["cpntr"]),
            cost=float(d["cost"]),
            base_cost=float(d["base_cost"]),
            fill_ratio=float(d["fill_ratio"]),
            structure_hash=d["structure_hash"],
            alpha=float(d.get("alpha", RB_ALPHA)),
        )


# ---------------------------------------------------------------------- #
# the linear cost model
# ---------------------------------------------------------------------- #
def partition_cost(
    rows: np.ndarray,
    cols: np.ndarray,
    rpntr: Sequence[int],
    cpntr: Sequence[int],
    alpha: float = RB_ALPHA,
) -> tuple[float, int, int]:
    """Ahrens-Boman linear cost of blocking the pattern ``(rows, cols)``
    with partitions ``(rpntr, cpntr)``.

    Returns ``(cost, num_blocks, stored_entries)`` where
    ``cost = alpha * num_blocks + stored_entries`` and stored entries
    count full block areas (fill-in included).
    """
    rpntr = np.asarray(rpntr, dtype=np.int64)
    cpntr = np.asarray(cpntr, dtype=np.int64)
    if len(rows) == 0:
        return 0.0, 0, 0
    br = np.searchsorted(rpntr, rows, side="right") - 1
    bc = np.searchsorted(cpntr, cols, side="right") - 1
    C = len(cpntr) - 1
    ucell = np.unique(br * C + bc)
    h = rpntr[ucell // C + 1] - rpntr[ucell // C]
    w = cpntr[ucell % C + 1] - cpntr[ucell % C]
    stored = int((h * w).sum())
    nb = int(len(ucell))
    return alpha * nb + stored, nb, stored


# ---------------------------------------------------------------------- #
# the contiguous-partition DP (one axis, the other fixed)
# ---------------------------------------------------------------------- #
def optimal_partition_1d(
    coord: np.ndarray,
    ortho_block: np.ndarray,
    ortho_widths: np.ndarray,
    base_pts: np.ndarray,
    alpha: float = RB_ALPHA,
    max_span: int = MAX_SPAN,
) -> tuple[np.ndarray, float]:
    """Optimal contiguous partition along one axis, the other axis fixed.

    ``coord`` are pattern coordinates along the partitioned axis,
    ``ortho_block`` the pattern's block index along the FIXED axis (with
    ``ortho_widths`` that partition's block widths).  Split points are
    restricted to ``base_pts`` (ascending, containing 0 and the axis
    length) and a block may span at most ``max_span`` consecutive base
    segments — together these are the bounded-cost approximation that
    keeps the DP tractable on large matrices while staying *exact* when
    ``base_pts`` is every scalar index and ``max_span`` covers the axis.

    Returns ``(split_points, cost)`` where cost is the full linear cost of
    the 2-D blocking (this partition x the fixed ortho partition).
    """
    base_pts = np.asarray(base_pts, dtype=np.int64)
    S = len(base_pts) - 1
    C = len(ortho_widths)
    ortho_widths = np.asarray(ortho_widths, dtype=np.int64)
    _STATS["dp_runs"] += 1
    if S <= 0 or len(coord) == 0:
        return base_pts.astype(np.int32), 0.0
    seg = np.searchsorted(base_pts, coord, side="right") - 1
    hit = np.zeros((S, C), dtype=bool)  # which ortho blocks each segment hits
    hit[seg, ortho_block] = True
    best = np.full(S + 1, np.inf)
    best[0] = 0.0
    back = np.zeros(S + 1, dtype=np.int64)
    for j in range(1, S + 1):
        # grow the candidate block upward from split j, accumulating the
        # hit-set incrementally: nb/wsum only change when new ortho blocks
        # join, so each (i, j) transition is O(C) worst case, O(1) typical
        cur = np.zeros(C, dtype=bool)
        nb = 0
        wsum = 0
        lo = max(0, j - max_span)
        for i in range(j - 1, lo - 1, -1):
            new = hit[i] & ~cur
            if new.any():
                nb += int(new.sum())
                wsum += int(ortho_widths[new].sum())
                cur |= new
            h = int(base_pts[j] - base_pts[i])
            c = best[i] + alpha * nb + h * wsum
            if c < best[j]:
                best[j] = c
                back[j] = i
    pts = [S]
    while pts[-1] > 0:
        pts.append(int(back[pts[-1]]))
    return base_pts[np.asarray(pts[::-1])].astype(np.int32), float(best[S])


def _dp_base_points(n: int, given_pntr: np.ndarray, max_points: int) -> np.ndarray:
    """Scalar-resolution split points when the axis is small; the as-given
    partition boundaries (bounded-cost approximation) when it is not."""
    if n + 1 <= max_points:
        return np.arange(n + 1, dtype=np.int64)
    return np.asarray(given_pntr, dtype=np.int64)


# ---------------------------------------------------------------------- #
# building a VBR from a pattern + partitions (shared with dia_hybrid)
# ---------------------------------------------------------------------- #
def build_vbr_from_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vidx: np.ndarray,
    rpntr: Sequence[int],
    cpntr: Sequence[int],
    shape: tuple,
    val: Optional[np.ndarray] = None,
) -> tuple[vbrlib.VBR, np.ndarray]:
    """Block the pattern ``(rows, cols)`` with ``(rpntr, cpntr)``.

    Returns ``(vbr, val_gather)`` where ``val_gather`` maps every stored
    slot of the new layout to ``1 + original val index`` (0 = fill zero),
    i.e. ``new_val = concat([0], old_val)[val_gather]``.  ``val`` (the
    original value array) fills the returned VBR's values; omitted, the
    VBR carries the gather of a zero array (a pure structure skeleton).
    """
    rpntr = np.asarray(rpntr, dtype=np.int32)
    cpntr = np.asarray(cpntr, dtype=np.int32)
    R, C = len(rpntr) - 1, len(cpntr) - 1
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vidx = np.asarray(vidx, dtype=np.int64)
    br = np.searchsorted(rpntr, rows, side="right") - 1
    bc = np.searchsorted(cpntr, cols, side="right") - 1
    cell = br * C + bc
    ucell, inv = np.unique(cell, return_inverse=True)  # row-major block order
    ubr = ucell // C
    ubc = ucell % C
    h = (rpntr[ubr + 1] - rpntr[ubr]).astype(np.int64)
    w = (cpntr[ubc + 1] - cpntr[ubc]).astype(np.int64)
    indx = np.concatenate([[0], np.cumsum(h * w)]).astype(np.int64)
    row_starts = np.searchsorted(ubr, np.arange(R))
    row_ends = np.searchsorted(ubr, np.arange(R), side="right")
    nonempty = row_ends > row_starts
    bpntrb = np.where(nonempty, row_starts, -1).astype(np.int32)
    bpntre = np.where(nonempty, row_ends, -1).astype(np.int32)
    # per-entry slot: column-major inside the block
    lr = rows - rpntr[br]
    lc = cols - cpntr[bc]
    pos = indx[inv] + lc * h[inv] + lr
    val_gather = np.zeros(int(indx[-1]), dtype=np.int64)
    val_gather[pos] = vidx + 1
    if val is not None:
        val1 = np.concatenate([np.zeros((1,), dtype=val.dtype), val])
        new_val = val1[val_gather]
    else:
        new_val = np.zeros(int(indx[-1]), dtype=np.float32)
    out = vbrlib.VBR(
        shape=tuple(shape),
        rpntr=rpntr,
        cpntr=cpntr,
        bindx=ubc.astype(np.int32),
        bpntrb=bpntrb,
        bpntre=bpntre,
        indx=indx,
        val=new_val,
    )
    return out, val_gather


# ---------------------------------------------------------------------- #
# proposals
# ---------------------------------------------------------------------- #
def _make_spec(
    strategy: str,
    rows,
    cols,
    rpntr,
    cpntr,
    shape,
    base_cost: float,
    alpha: float,
) -> ReblockSpec:
    cost, _nb, stored = partition_cost(rows, cols, rpntr, cpntr, alpha)
    rvbr, _ = build_vbr_from_coo(rows, cols, np.zeros_like(rows), rpntr, cpntr, shape)
    return ReblockSpec(
        strategy=strategy,
        rpntr=tuple(int(p) for p in rpntr),
        cpntr=tuple(int(p) for p in cpntr),
        cost=float(cost),
        base_cost=float(base_cost),
        fill_ratio=float(stored) / max(len(rows), 1),
        structure_hash=vbrlib.structure_hash(rvbr),
    )


def propose_reblockings(
    vbr: vbrlib.VBR,
    *,
    device: Optional[str] = None,
    alpha: float = RB_ALPHA,
    max_span: int = MAX_SPAN,
    max_dp_points: int = MAX_DP_POINTS,
    min_gain: float = MIN_GAIN,
    include_aligned: Optional[bool] = None,
    tile: tuple = ALIGNED_TILE,
) -> list[ReblockSpec]:
    """Enumerate reblocking proposals for one structure (cold path only —
    warm restarts read the spec off the cached plan and never come here).

    The ``dp`` proposal is included only when its model cost beats the
    as-given blocking by at least ``1 - min_gain`` (a DP that re-derives
    the given partition would only duplicate existing candidates).  The
    ``aligned`` proposal targets the cuda backend and is included on a
    CUDA ``device`` (None = cuda), or anywhere its model cost already
    beats as-given.

    The pattern here is every STORED slot (``coo_slots``), not just the
    currently-nonzero entries: the reblocked layout is structure and must
    stay value-faithful when stored-zero slots are later written.
    """
    rows, cols, _ = coo_slots(vbr)
    if len(rows) == 0:
        return []
    m, k = vbr.shape
    if include_aligned is None:
        include_aligned = torch.device(device or "cuda").type == "cuda"
    base_cost, _, _ = partition_cost(rows, cols, vbr.rpntr, vbr.cpntr, alpha)
    out: list[ReblockSpec] = []

    # dp: alternate row-then-column contiguous-partition DP
    bc0 = np.searchsorted(np.asarray(vbr.cpntr, np.int64), cols, "right") - 1
    cw0 = np.diff(np.asarray(vbr.cpntr, np.int64))
    new_rpntr, _ = optimal_partition_1d(
        rows, bc0, cw0,
        _dp_base_points(m, vbr.rpntr, max_dp_points),
        alpha, max_span,
    )
    br1 = np.searchsorted(np.asarray(new_rpntr, np.int64), rows, "right") - 1
    rh1 = np.diff(np.asarray(new_rpntr, np.int64))
    new_cpntr, dp_cost = optimal_partition_1d(
        cols, br1, rh1,
        _dp_base_points(k, vbr.cpntr, max_dp_points),
        alpha, max_span,
    )
    same = (
        len(new_rpntr) == len(vbr.rpntr)
        and len(new_cpntr) == len(vbr.cpntr)
        and np.array_equal(new_rpntr, vbr.rpntr)
        and np.array_equal(new_cpntr, vbr.cpntr)
    )
    if not same and dp_cost < min_gain * base_cost:
        out.append(
            _make_spec("dp", rows, cols, new_rpntr, new_cpntr,
                       vbr.shape, base_cost, alpha)
        )

    # aligned: 1-bounded blocking (uniform tiles of the kernels)
    tm, tk = tile
    a_rpntr = np.unique(np.concatenate([np.arange(0, m, tm), [m]]))
    a_cpntr = np.unique(np.concatenate([np.arange(0, k, tk), [k]]))
    a_same = np.array_equal(a_rpntr, vbr.rpntr) and np.array_equal(
        a_cpntr, vbr.cpntr
    )
    if not a_same:
        spec = _make_spec(
            f"aligned{tm}x{tk}", rows, cols, a_rpntr, a_cpntr,
            vbr.shape, base_cost, alpha,
        )
        if spec.fill_ratio <= MAX_ALIGNED_FILL and (
            include_aligned or spec.cost < base_cost
        ):
            out.append(spec)
    _STATS["proposals"] += len(out)
    return out


def apply_reblock(
    vbr: vbrlib.VBR, spec: ReblockSpec
) -> tuple[vbrlib.VBR, np.ndarray]:
    """Re-lay-out ``vbr`` under ``spec``'s partitions.

    Returns ``(reblocked_vbr, val_gather)``; the gather re-derives the
    reblocked value array from the ORIGINAL one at runtime
    (``new_val = concat([0], val)[val_gather]``), so the original ``val``
    stays the only runtime input.  Pure numpy, O(nnz) — this is the warm
    path (no DP, no cost evaluation).
    """
    rows, cols, vidx = coo_slots(vbr)
    rvbr, gather = build_vbr_from_coo(
        rows, cols, vidx, spec.rpntr, spec.cpntr, vbr.shape, val=np.asarray(vbr.val)
    )
    if vbrlib.structure_hash(rvbr) != spec.structure_hash:
        raise ValueError(
            "reblock spec does not match this structure (stale plan?): "
            f"expected {spec.structure_hash}, got {vbrlib.structure_hash(rvbr)}"
        )
    _STATS["applies"] += 1
    return rvbr, gather


# ---------------------------------------------------------------------- #
# the staged wrapper
# ---------------------------------------------------------------------- #
class ReblockedKernel:
    """``fn(val, x) -> y`` over the ORIGINAL value layout: one gather
    re-lays the values out under the reblocked partitions (sentinel slot 0
    supplies the fill zeros), then the staged kernel for the reblocked
    structure runs.  The gather's index tensor is put on the inner
    kernel's device once, here.  Metadata mirrors
    :class:`~.staging.StagedKernel`."""

    def __init__(self, inner, val_gather: np.ndarray, spec: ReblockSpec, kind: str):
        self.inner = inner
        self.spec = spec
        self.kind = kind
        self.backend = inner.backend
        self.opts = inner.opts
        self.device = inner.device
        self.structure_hash = spec.structure_hash
        self._gather = torch.as_tensor(val_gather, dtype=torch.long, device=self.device)

    def __call__(self, val, x):
        val = on_device(val, self.device)
        val1 = torch.cat([val.new_zeros(1), val])
        return self.inner(val1[self._gather], x)

    @property
    def inspection_time(self) -> float:
        return self.inner.inspection_time


_KERNELS: dict[tuple, ReblockedKernel] = {}


def stage_reblocked(
    vbr: vbrlib.VBR,
    spec: ReblockSpec,
    opts,
    kind: str = "spmv",
    n_cols: Optional[int] = None,
    value_hints=None,
    device=None,
) -> ReblockedKernel:
    """Stage ``kind`` for ``vbr`` under ``spec``'s reblocked layout on
    ``device`` (None = cuda).

    The inner kernel is staged (and in-memory cached) against the
    REBLOCKED structure hash, so repeated staging of the same (structure,
    spec, options) reuses both the staged function and the wrapper.
    """
    from . import staging as staginglib

    dev = resolve_device(device)
    key = (
        vbrlib.structure_hash(vbr),
        spec.structure_hash,
        kind,
        n_cols,
        opts.key(),
        str(dev),
    )
    hit = _KERNELS.get(key)
    if hit is not None:
        return hit
    rvbr, gather = apply_reblock(vbr, spec)
    hints = None
    if opts.density_threshold > 0:
        # hints index the REBLOCKED layout: re-lay the caller's hints (or
        # the original values) out with the same gather the runtime uses
        src = np.asarray(value_hints if value_hints is not None else vbr.val)
        hints = np.concatenate([np.zeros((1,), src.dtype), src])[gather]
    inner = staginglib._cached(kind, rvbr, opts, hints, n_cols=n_cols, device=dev)
    kern = ReblockedKernel(inner, gather, spec, kind)
    _KERNELS[key] = kern
    return kern


def clear_reblock_cache() -> None:
    _KERNELS.clear()
