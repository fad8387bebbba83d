"""SABLE staging engine, PyTorch port of ``repro.core.staging``.

Stage 0  the block iterator walks the VBR indirection arrays (pure Python,
         everything concrete) and runs the user's DSL op once per block,
         recording a loop-nest IR that is matched into ``BlockMatmul``s.
Stage 1  the descriptors become a specialized PyTorch function. Backends:

           'unrolled'  one slice + matmul per block (paper-faithful codegen),
           'grouped'   blocks grouped by shape class; one gather + batched
                       einsum + index_add per class,
           'bucketed'  'grouped' over block shapes rounded up to buckets,
           'cuda'      tile-uniformized block tables run by the hand-written
                       CUDA kernels K1/K2 (``kernels/csrc``); the counterpart
                       of the reference's 'pallas'. On a CPU device the same
                       tables run through the kernels' plain versions.
           'gather'    generic vectorized evaluation of ANY DSL op (the
                       extensibility story of Section IV-A): each block's
                       program and index tensors are built at staging, the
                       call is gathers and scatter-adds,
           'dia_hybrid' dense diagonals DIA-style + staged remainder,
                       SpMV-only (``kernels/dia_hybrid.py``),
           'auto'      'cuda' on a CUDA device, 'grouped' on the CPU,
           'autotune'  measured choice: time the candidates via
                       ``core.autotune`` and persist the winner on disk
                       (``core.cache``) keyed by structure hash + device.

         With ``mesh=`` or ``shards=`` the block rows are split into
         nnz-balanced shards, each staged as its own kernel
         (``core/sharded.py``: a host loop, or a ``torch.distributed`` mesh).
Stage 2  PyTorch runs eagerly: there is no program to compile. The kernels
         are built at first use; ``compile()`` records that build and the
         first call. Staged functions are cached keyed by the *structure
         hash*: values are runtime inputs, so one staged function serves
         every matrix with the same pattern (compile-once / run-many).

The density-threshold hybrid (paper Listings 3/4) routes blocks whose fill
is below ``density_threshold`` to an unrolled COO tail instead of dense
loops, given staging-time ``value_hints``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..device import on_device, resolve_device
from ..kernels import ops as kops
from . import vbr as vbrlib
from .backends import BlockMatmul, match_block_matmul, vectorize
from .dsl import ArrayVal, RepRange, stage_op
from .ops_dsl import ArrayView, spmm_op, spmv_op
from .uniformize import TiledPattern, uniformize

__all__ = [
    "StagingOptions",
    "StagedKernel",
    "stage_spmv",
    "stage_spmm",
    "stage_block_op",
    "partition_block_rows",
    "clear_cache",
    "cache_info",
]

_BACKENDS = ("auto", "unrolled", "grouped", "bucketed", "cuda", "gather")


@dataclasses.dataclass(frozen=True)
class StagingOptions:
    backend: str = "auto"  # auto|autotune|unrolled|grouped|bucketed|cuda|gather|dia_hybrid
    density_threshold: float = 0.0  # blocks below -> COO tail (needs hints)
    # cuda (tm, tk): a 32-wide k slice is one 128-byte line per tile row in
    # float32 for K1, and 32 rows fill K2's 4 row groups x 8-row register block
    tile: tuple = (32, 32)
    spmm_bn: int = 128  # the reference's Pallas N-tile; K2's CUDA CTAs take 128 columns
    prepack: bool = False  # caller passes prepacked tiles to __call__
    dtype: object = None  # torch dtype to cast values and x to (None = keep)

    def key(self) -> tuple:
        return (
            self.backend,
            self.density_threshold,
            tuple(self.tile),
            self.spmm_bn,
            self.prepack,
            str(self.dtype),
        )


def _resolve_backend(backend: str, device: torch.device) -> str:
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {_BACKENDS}")
    if backend != "auto":
        return backend
    return "cuda" if device.type == "cuda" else "grouped"


# ---------------------------------------------------------------------- #
# Stage-0 inspection
# ---------------------------------------------------------------------- #
def _block_programs(vbr: vbrlib.VBR, op: Callable, arrays: tuple,
                    n_cols: Optional[int] = None) -> list:
    """Stage ``op(rows, cols, [dense cols,] block view of val, *arrays)``
    over every block (the paper's block iterator): one program a block."""
    val_av = ArrayVal("val")
    dense = () if n_cols is None else (RepRange(0, n_cols),)
    return [
        stage_op(op, RepRange(t.row_start, t.row_end), RepRange(t.col_start, t.col_end),
                 *dense, ArrayView(val_av, t.val_offset), *arrays)
        for t in vbr.blocks()
    ]


def _canonical_programs(vbr: vbrlib.VBR, kind: str, n_cols: Optional[int]) -> list:
    """The SpMV (x, y vectors) or SpMM (x, y row-major, n_cols wide) op
    over every block."""
    xy = (ArrayVal("x"), ArrayVal("y"))
    if kind == "spmv":
        return _block_programs(vbr, spmv_op, xy)
    return _block_programs(vbr, spmm_op, xy, n_cols)


def _inspect(vbr: vbrlib.VBR, kind: str, n_cols: Optional[int]) -> list[BlockMatmul]:
    """Run the DSL op over every block and pattern-match the recorded IR
    into BlockMatmul descriptors."""
    descs: list[BlockMatmul] = []
    for prog in _canonical_programs(vbr, kind, n_cols):
        d = match_block_matmul(prog)
        if d is None:  # the canonical ops always match
            raise RuntimeError("op did not match the block-matmul pattern")
        descs.append(d)
    return descs


def _split_by_density(
    descs: list[BlockMatmul],
    hints: Optional[np.ndarray],
    threshold: float,
) -> tuple[list[BlockMatmul], list[BlockMatmul]]:
    if threshold <= 0.0 or hints is None:
        return descs, []
    dense, sparse = [], []
    for d in descs:
        blk = hints[d.val_off : d.val_off + d.h * d.w]
        density = np.count_nonzero(blk) / max(blk.size, 1)
        (dense if density >= threshold else sparse).append(d)
    return dense, sparse


def _coo_from_hints(descs: list[BlockMatmul], hints: np.ndarray):
    """Unrolled (Listing 3/4) path: bake the nonzero coordinates of the
    low-density blocks at staging time."""
    rows, cols, vidx = [], [], []
    for d in descs:
        blk = hints[d.val_off : d.val_off + d.h * d.w]
        (nz,) = np.nonzero(blk)
        rows.append(d.row_start + (nz % d.h))
        cols.append(d.col_start + (nz // d.h))
        vidx.append(d.val_off + nz)
    if not rows:
        return None
    return (
        np.concatenate(rows).astype(np.int32),
        np.concatenate(cols).astype(np.int32),
        np.concatenate(vidx).astype(np.int32),
    )


# ---------------------------------------------------------------------- #
# Shape-class grouping (Stage-1 'grouped' backend)
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class _ShapeClass:
    h: int
    w: int
    vidx: np.ndarray  # (nb, h*w) int32 gather map into val (+1; 0=pad zero)
    xrow: np.ndarray  # (nb, w) int32 (+1; 0 = pad zero)
    yrow: np.ndarray  # (nb, h) int32 (invalid rows point past m => dropped)


def _next_bucket(n: int) -> int:
    """Round up to 1.25x-spaced buckets: 8,10,12,15,18,22,27,33,41,..."""
    b = 8
    while b < n:
        b += max(b // 4, 2)
    return b


def _group_by_shape(
    descs: list[BlockMatmul], m_rows: int, bucket: bool = False
) -> list[_ShapeClass]:
    """Group blocks into shape classes.  With ``bucket=True`` (the
    'bucketed' backend), block dims are rounded UP to a coarse bucket grid
    and padded with zeros, trading bounded compute over zeros for
    O(#buckets) classes instead of O(#shapes)."""
    groups: dict[tuple, list[BlockMatmul]] = {}
    for d in descs:
        key = (
            (_next_bucket(d.h), _next_bucket(d.w)) if bucket else (d.h, d.w)
        )
        groups.setdefault(key, []).append(d)
    out = []
    for (h, w), ds in sorted(groups.items()):
        nb = len(ds)
        vidx = np.zeros((nb, h * w), dtype=np.int64)
        xrow = np.zeros((nb, w), dtype=np.int64)
        yrow = np.full((nb, h), m_rows, dtype=np.int64)  # OOB => drop
        for i, d in enumerate(ds):
            # col-major block layout: idx = col*d.h + row (+1 sentinel shift)
            rr = np.arange(d.h)
            cc = np.arange(d.w)
            g = (d.val_off + cc[None, :] * d.h + rr[:, None] + 1)  # (dh, dw)
            v2 = vidx[i].reshape(w, h).T  # view as (h, w) row-major
            v2[: d.h, : d.w] = g
            vidx[i] = v2.T.reshape(-1)
            xrow[i, : d.w] = d.col_start + cc + 1
            yrow[i, : d.h] = d.row_start + rr
        out.append(
            _ShapeClass(
                h=h, w=w,
                vidx=vidx.astype(np.int32),
                xrow=xrow.astype(np.int32),
                yrow=yrow.astype(np.int32),
            )
        )
    return out


# ---------------------------------------------------------------------- #
# Staged kernel object
# ---------------------------------------------------------------------- #
class StagedKernel:
    """A pattern-specialized sparse kernel: ``fn(val, x) -> y`` on ``device``.

    ``val`` is the VBR value array (runtime), ``x`` the dense operand; numpy
    arrays are moved to ``device``, tensors must lie there. Metadata
    (Stage-0 time, #classes, padding fraction) is recorded as in the
    reference.
    """

    def __init__(self, kind, vbr, opts: StagingOptions, hints=None, n_cols=None,
                 device=None):
        t0 = time.perf_counter()
        self.kind = kind
        self.opts = opts
        self.device = resolve_device(device)
        self.backend = _resolve_backend(opts.backend, self.device)
        self.m, self.k = vbr.shape
        self.n_cols = n_cols
        self.structure_hash = vbrlib.structure_hash(vbr)
        descs = _inspect(vbr, kind, n_cols)
        self.num_blocks = len(descs)
        dense_descs, sparse_descs = _split_by_density(
            descs, hints, opts.density_threshold
        )
        self.coo = _coo_from_hints(sparse_descs, hints) if sparse_descs else None
        if self.coo is not None and opts.prepack:
            raise ValueError(
                "prepack passes tiles to the call, but the COO tail of "
                "density_threshold reads val: stage without one of them"
            )
        self.descs = dense_descs
        self.classes = None
        self.tiled: Optional[TiledPattern] = None
        self.schedules: dict = {}  # cuda backend on a card: dtype -> kernel schedule
        if self.backend in ("grouped", "bucketed"):
            self.classes = _group_by_shape(
                dense_descs, self.m, bucket=self.backend == "bucketed"
            )
        elif self.backend == "cuda":
            tm, tk = opts.tile
            self.tiled = uniformize(
                dense_descs, self.m, self.k, vbr.rpntr, vbr.cpntr, tm, tk
            )
            self._val_gather = self._tensor(self.tiled.val_gather.reshape(-1))
        elif self.backend == "gather":  # each block's program, lowered once
            self._runs = [vectorize(prog, self.device)
                          for prog in _canonical_programs(vbr, kind, n_cols)]
        self.stage0_time = time.perf_counter() - t0
        self.compile_time = 0.0
        self._fn = self._build()

    def _tensor(self, a, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _gather_tiles(self, val: torch.Tensor) -> torch.Tensor:
        t = self.tiled
        v1 = torch.cat([val.new_zeros(1), val])  # slot 0 = zero (tile padding)
        return v1[self._val_gather].reshape(t.n_tiles, t.tm, t.tk)

    # ------------------------------------------------------------------ #
    def _build(self) -> Callable:
        kind, backend, dev = self.kind, self.backend, self.device
        m = self.m
        coo = None if self.coo is None else tuple(self._tensor(a) for a in self.coo)

        def add_coo(y, val, x):
            if coo is None:
                return y
            rows, cols, vidx = coo
            v = val[vidx]
            if kind == "spmv":
                return y.index_add_(0, rows, v * x[cols])
            return y.index_add_(0, rows, v[:, None] * x[cols])

        def out_shape(x):
            return (m,) if kind == "spmv" else (m, x.shape[1])

        def with_zero_row(x):  # sentinel slot 0 = zero (padding reads)
            return torch.cat([x.new_zeros((1,) + tuple(x.shape[1:])), x])

        if backend == "unrolled":
            descs = self.descs

            def fn(val, x):
                y = torch.zeros(out_shape(x), dtype=x.dtype, device=dev)
                for d in descs:  # one slice + matmul per block (paper codegen)
                    blk = val[d.val_off : d.val_off + d.h * d.w]
                    a = blk.reshape(d.w, d.h).T
                    y[d.row_start : d.row_end] += a @ x[d.col_start : d.col_end]
                return add_coo(y, val, x)

            return fn

        if backend in ("grouped", "bucketed"):
            classes = [
                (c.h, c.w, self._tensor(c.vidx), self._tensor(c.xrow),
                 self._tensor(c.yrow).reshape(-1))
                for c in self.classes
            ]

            def fn(val, x):
                val1, x1 = with_zero_row(val), with_zero_row(x)
                # one spare output row takes the padding rows, then is dropped
                y = torch.zeros((m + 1,) + out_shape(x)[1:], dtype=x.dtype, device=dev)
                for h, w, vidx, xrow, yrow in classes:
                    a = val1[vidx].reshape(-1, w, h)  # col-major blocks
                    if kind == "spmv":
                        part = torch.einsum("bwh,bw->bh", a, x1[xrow])
                    else:
                        part = torch.einsum("bwh,bwn->bhn", a, x1[xrow])
                    y.index_add_(0, yrow, part.reshape((-1,) + y.shape[1:]))
                return add_coo(y[:m], val, x)

            return fn

        if backend == "cuda":
            t = self.tiled
            m_pad = t.m_pad
            x_src, y_src = self._tensor(t.x_src), self._tensor(t.y_src)
            row_ids = self._tensor(t.row_ids, torch.int32)
            col_ids = self._tensor(t.col_ids, torch.int32)
            row_ptr = self._tensor(t.row_ptr, torch.int32)
            prepack = self.opts.prepack
            bn = self.opts.spmm_bn
            # the kernels' split of the tile table: structure only, so once
            # for each dtype the call may see
            dtypes = ((self.opts.dtype,) if self.opts.dtype is not None
                      else (torch.float32, torch.bfloat16))
            self.schedules = schedules = {
                dt: kops.bsr_schedule(kind, row_ptr, t.tm, t.tk, self.n_cols or 1, dt)
                for dt in dtypes if dev.type == "cuda"
            }

            def fn(val, x):
                # with prepack the caller already packed via self.pack()
                tiles = val if prepack else self._gather_tiles(val)
                xp = with_zero_row(x)[x_src]
                if kind == "spmv":
                    yp = kops.bsr_spmv(tiles, row_ids, col_ids, xp, m_pad=m_pad,
                                       row_ptr=row_ptr, schedule=schedules.get(xp.dtype),
                                       device=dev)
                else:
                    yp = kops.bsr_spmm(tiles, row_ids, col_ids, xp, m_pad=m_pad, bn=bn,
                                       row_ptr=row_ptr, schedule=schedules.get(xp.dtype),
                                       device=dev)
                return add_coo(yp[y_src], val, x)

            return fn

        if backend == "gather":
            n_cols, runs = self.n_cols, self._runs

            def fn(val, x):
                # spmm on flattened row-major x and y (the paper's layout)
                y = torch.zeros(m * (n_cols or 1), dtype=x.dtype, device=dev)
                env = {"val": val, "x": x.reshape(-1), "y": y}
                for run in runs:
                    run(env)
                return y if kind == "spmv" else y.reshape(m, n_cols)

            return fn

        raise ValueError(f"unknown backend {backend}")

    # ------------------------------------------------------------------ #
    def _inputs(self, val, x):
        val, x = on_device(val, self.device), on_device(x, self.device)
        if self.opts.dtype is not None:
            val, x = val.to(self.opts.dtype), x.to(self.opts.dtype)
        return val.to(x.dtype), x

    def pack(self, val) -> torch.Tensor:
        """Prepack the runtime values into tiles (amortized across calls)."""
        if self.tiled is None:
            raise ValueError("pack() is for the cuda backend")
        val = on_device(val, self.device)
        if self.opts.dtype is not None:
            val = val.to(self.opts.dtype)
        return self._gather_tiles(val)

    def __call__(self, val, x):
        return self._fn(*self._inputs(val, x))

    def compile(self, val, x) -> "StagedKernel":
        """Build the kernels (first use) and run one call on example inputs,
        recording the time in place of the reference's AOT compile."""
        t0 = time.perf_counter()
        self(val, x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.compile_time = time.perf_counter() - t0
        return self

    @property
    def inspection_time(self) -> float:
        return self.stage0_time + self.compile_time


# ---------------------------------------------------------------------- #
# Public API + staged-function cache (compile once / run many)
# ---------------------------------------------------------------------- #
_CACHE: dict[tuple, StagedKernel] = {}
_CACHE_STATS = {"hits": 0, "misses": 0}


def _cached(kind, vbr, opts, hints, n_cols=None, device=None) -> StagedKernel:
    dev = resolve_device(device)
    key = (kind, vbrlib.structure_hash(vbr), n_cols, opts.key(), str(dev))
    hit = _CACHE.get(key)
    if hit is not None:
        _CACHE_STATS["hits"] += 1
        return hit
    _CACHE_STATS["misses"] += 1
    kern = StagedKernel(kind, vbr, opts, hints=hints, n_cols=n_cols, device=dev)
    _CACHE[key] = kern
    return kern


def _sharded(kind, vbr, opts, value_hints, n_cols, device, mesh, shards, shard_axis,
             model_axis, shard_strategy, overlap_gather):
    from .sharded import ShardedStagedKernel

    return ShardedStagedKernel(
        kind, vbr, opts, num_shards=shards, mesh=mesh, shard_axis=shard_axis,
        model_axis=model_axis, strategy=shard_strategy, hints=value_hints, n_cols=n_cols,
        overlap_gather=overlap_gather, device=device,
    )


def stage_spmv(
    vbr: vbrlib.VBR,
    opts: StagingOptions = StagingOptions(),
    value_hints: Optional[np.ndarray] = None,
    *,
    device=None,
    mesh=None,
    shards: Optional[int] = None,
    shard_axis: str = "shards",
    model_axis: str = "model",
    shard_strategy: str = "lpt",
    overlap_gather: bool = True,
):
    """Stage a pattern-specialized SpMV kernel on ``device`` (None = cuda).

    With ``mesh=`` (a ``DeviceMesh`` of ``launch.mesh.make_staging_mesh``)
    or ``shards=N``, the block rows are partitioned into nnz-balanced
    shards, each staged for its own block-size distribution, and the call
    runs across the mesh's ranks (``shards=`` alone: a host loop of the
    same split on ``device``). Returns a
    :class:`~repro_torch.core.sharded.ShardedStagedKernel` in that case.
    ``overlap_gather`` (default on) gathers the output over a send/recv
    ring instead of one all-gather.
    """
    if opts.backend == "dia_hybrid":
        if mesh is not None or shards is not None:
            raise ValueError(
                "backend='dia_hybrid' is unsharded (the diagonal gather "
                "spans the full row range); stage unsharded or pick "
                "another backend for the mesh path"
            )
        from ..kernels.dia_hybrid import stage_dia_hybrid

        return stage_dia_hybrid(vbr, opts=opts, device=device)
    if mesh is not None or shards is not None:
        return _sharded("spmv", vbr, opts, value_hints, None, device, mesh, shards,
                        shard_axis, model_axis, shard_strategy, overlap_gather)
    if opts.backend == "autotune":
        from .autotune import autotune_stage

        return autotune_stage(vbr, "spmv", value_hints=value_hints, base_opts=opts,
                              device=device)
    hints = vbr.val if (opts.density_threshold > 0 and value_hints is None) else value_hints
    return _cached("spmv", vbr, opts, hints, device=device)


def stage_spmm(
    vbr: vbrlib.VBR,
    n_cols: int,
    opts: StagingOptions = StagingOptions(),
    value_hints: Optional[np.ndarray] = None,
    *,
    device=None,
    mesh=None,
    shards: Optional[int] = None,
    shard_axis: str = "shards",
    model_axis: str = "model",
    shard_strategy: str = "lpt",
    overlap_gather: bool = True,
):
    """Stage a pattern-specialized SpMM kernel on ``device`` (None = cuda);
    ``mesh=``/``shards=`` as in :func:`stage_spmv`. On a 2-D (shards x
    model) mesh the RHS columns are partitioned over the model axis
    (``n_cols`` must divide evenly)."""
    if opts.backend == "dia_hybrid":
        raise ValueError("backend='dia_hybrid' is SpMV-only")
    if mesh is not None or shards is not None:
        return _sharded("spmm", vbr, opts, value_hints, n_cols, device, mesh, shards,
                        shard_axis, model_axis, shard_strategy, overlap_gather)
    if opts.backend == "autotune":
        from .autotune import autotune_stage

        return autotune_stage(vbr, "spmm", n_cols, value_hints=value_hints, base_opts=opts,
                              device=device)
    hints = vbr.val if (opts.density_threshold > 0 and value_hints is None) else value_hints
    return _cached("spmm", vbr, opts, hints, n_cols=n_cols, device=device)


def stage_block_op(vbr: vbrlib.VBR, user_op: Callable, extra_arrays=("x",), *,
                   device=None):
    """Extensibility hook (Section IV-A): stage an ARBITRARY user DSL op
    over every block with the generic vectorized backend.

    ``user_op(row_idxs, col_idxs, block_view, *arrays, out)`` is staged per
    block, and each block's index tensors are built now on ``device``
    (None = cuda); returns ``fn(val, *arrays, out0) -> out``, which leaves
    its arguments unwritten.
    """
    dev = resolve_device(device)
    arrays = (*(ArrayVal(n) for n in extra_arrays), ArrayVal("out"))
    runs = [vectorize(prog, dev) for prog in _block_programs(vbr, user_op, arrays)]

    def fn(val, *args):
        *extras, out0 = args
        env = {"val": on_device(val, dev), "out": on_device(out0, dev).clone()}
        env.update({n: on_device(a, dev) for n, a in zip(extra_arrays, extras)})
        for run in runs:
            run(env)
        return env["out"]

    return fn


def partition_block_rows(vbr: vbrlib.VBR, num_workers: int) -> list[list[int]]:
    """Paper Section IV-D load balancing: group block rows into tasks by
    total block size (greedy longest-processing-time bin packing)."""
    sizes = np.zeros(vbr.num_block_rows, dtype=np.int64)
    for t in vbr.blocks():
        sizes[t.block_row] += t.size
    order = np.argsort(-sizes)
    bins: list[list[int]] = [[] for _ in range(num_workers)]
    loads = np.zeros(num_workers, dtype=np.int64)
    for a in order:
        w = int(np.argmin(loads))
        bins[w].append(int(a))
        loads[w] += int(sizes[a])
    return bins


def clear_cache() -> None:
    import sys

    _CACHE.clear()
    _CACHE_STATS.update(hits=0, misses=0)
    # the reblock/dia wrappers keep their own kernel memos keyed the same
    # way: a "fresh process" simulation must drop those too
    for modname, fn in (
        ("repro_torch.core.reblock", "clear_reblock_cache"),
        ("repro_torch.kernels.dia_hybrid", "clear_dia_cache"),
    ):
        mod = sys.modules.get(modname)
        if mod is not None:
            getattr(mod, fn)()


def cache_info() -> dict:
    return dict(_CACHE_STATS, size=len(_CACHE))
