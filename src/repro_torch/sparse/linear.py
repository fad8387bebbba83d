"""Block-sparse linear layers: SABLE staged patterns as NN weights (port of
the forward of ``repro.sparse.linear``).

A weight matrix is stored as uniform (tm, tk) tiles plus a *static* pattern
(tile coordinates). The pattern is structure, fixed for the life of a model,
so everything derived from it (the kernel's tile tables, the measured
strategy) is built once per pattern; the tile values are the parameters.

Compute strategies mirror ``core.staging`` backends:
  * ``grouped``: grouped batched products + scatter-add (``bsr_ops.dds``);
  * ``cuda``: the hand-written K2 kernel (``kernels.ops.bsr_spmm``) over the
    transposed tile tables, the counterpart of the reference's
    ``sparse_matmul_pallas``;
  * ``fixed_block`` (``bsr_ops.dds`` on its auto backend) for patterns that
    churn, and ``dia_hybrid``, opt-in through structure detection.

``choose_matmul_strategy`` measures ``grouped`` against ``cuda`` on the card
(on the CPU only ``grouped`` is a candidate) and persists the winner through
``core.cache`` under the device segment ``cuda`` or ``torchcpu``, keyed by
``pattern_hash``, which is byte-identical to the reference's
``blockpattern-v2`` hash.

Every strategy takes gradients. ``cuda`` is an autograd Function whose
forward is K2 and whose backward is the reference's ``_pallas_matmul_bwd``,
a gather and two einsums in plain PyTorch (the reference, too, computes it
outside any kernel); ``grouped`` and ``fixed_block`` differentiate through
the ``bsr_ops`` family, ``dia_hybrid`` through its einsum and ``grouped``.
``shard=(i, n)`` keys a per-shard plan (``...-s{i}of{n}``); ``mesh=``
warms every shard's key of a mesh from one measured base and dispatches a
rank on its own shard's plan. Under model sharding a SABLE matrix whose
tile list is split over the tensor axis runs on ``sub_pattern``s, each
with its own plan key; ``out_model`` reduces their partial sums.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..device import resolve_device
from ..kernels import bsr_ops
from ..kernels import ops as kops
from .block_csr import BlockMatrix

__all__ = [
    "BlockPattern",
    "random_pattern",
    "pack_dense",
    "prune_dense",
    "pattern_hash",
    "sparse_matmul",
    "sparse_matmul_cuda",
    "sparse_matmul_auto",
    "sub_pattern",
    "choose_matmul_strategy",
    "warm_matmul_plans",
]


@dataclasses.dataclass(frozen=True)
class BlockPattern:
    """Static block-sparsity pattern of a (d_in, d_out) weight matrix."""

    d_in: int
    d_out: int
    tm: int  # tile rows (input dim)
    tk: int  # tile cols (output dim)
    rows: tuple  # (nt,) tile-row coordinates
    cols: tuple  # (nt,) tile-col coordinates

    def __hash__(self) -> int:
        # every sparse matmul looks its pattern up (plan registry, tables):
        # hash the 2 x n_tiles coordinates once, not at each lookup
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.d_in, self.d_out, self.tm, self.tk, self.rows, self.cols))
            object.__setattr__(self, "_hash", h)
        return h

    @property
    def n_tiles(self) -> int:
        return len(self.rows)

    @property
    def density(self) -> float:
        total = (self.d_in // self.tm) * (self.d_out // self.tk)
        return self.n_tiles / max(total, 1)

    def row_gather(self) -> np.ndarray:  # (nt, tm) input-dim indices
        r = np.asarray(self.rows)[:, None] * self.tm + np.arange(self.tm)[None, :]
        return r.astype(np.int32)

    def col_gather(self) -> np.ndarray:  # (nt, tk) output-dim indices
        c = np.asarray(self.cols)[:, None] * self.tk + np.arange(self.tk)[None, :]
        return c.astype(np.int32)


def random_pattern(
    d_in: int, d_out: int, tm: int, tk: int, density: float, seed: int = 0
) -> BlockPattern:
    """Random pattern with full row/col coverage (every input tile-row and
    output tile-col touched at least once, so no dead units)."""
    if d_in % tm or d_out % tk:
        raise ValueError("dims must be tile-aligned")
    R, C = d_in // tm, d_out // tk
    rng = np.random.default_rng(seed)
    n = max(int(round(density * R * C)), max(R, C))
    # coverage diagonal first
    diag = [(i % R, i % C) for i in range(max(R, C))]
    chosen = set(diag)
    all_cells = [(r, c) for r in range(R) for c in range(C)]
    rng.shuffle(all_cells)
    for cell in all_cells:
        if len(chosen) >= n:
            break
        chosen.add(cell)
    cells = sorted(chosen)
    rows = tuple(r for r, _ in cells)
    cols = tuple(c for _, c in cells)
    return BlockPattern(d_in, d_out, tm, tk, rows, cols)


def prune_dense(
    w: np.ndarray, tm: int, tk: int, density: float
) -> tuple[BlockPattern, np.ndarray]:
    """Magnitude-based block pruning of a dense numpy matrix -> (pattern,
    tiles): keeps the top ``density`` fraction of (tm, tk) blocks by
    Frobenius norm."""
    d_in, d_out = w.shape
    if d_in % tm or d_out % tk:
        raise ValueError("dims must be tile-aligned")
    R, C = d_in // tm, d_out // tk
    blocks = w.reshape(R, tm, C, tk).transpose(0, 2, 1, 3)  # (R, C, tm, tk)
    norms = np.sqrt((blocks**2).sum(axis=(2, 3)))
    n = max(int(round(density * R * C)), 1)
    thresh = np.partition(norms.reshape(-1), -n)[-n]
    keep = norms >= thresh
    rs, cs = np.nonzero(keep)
    order = np.lexsort((cs, rs))
    rs, cs = rs[order], cs[order]
    pattern = BlockPattern(d_in, d_out, tm, tk, tuple(rs.tolist()), tuple(cs.tolist()))
    tiles = blocks[rs, cs]  # (nt, tm, tk)
    return pattern, tiles


def pack_dense(w, pattern: BlockPattern) -> torch.Tensor:
    """Extract the pattern's tiles from a dense (d_in, d_out) matrix (a
    tensor, or a numpy array, which comes back as a CPU tensor)."""
    w = torch.as_tensor(w)
    R = pattern.d_in // pattern.tm
    C = pattern.d_out // pattern.tk
    blocks = w.reshape(R, pattern.tm, C, pattern.tk).permute(0, 2, 1, 3)
    rows = torch.as_tensor(pattern.rows, dtype=torch.long, device=w.device)
    cols = torch.as_tensor(pattern.cols, dtype=torch.long, device=w.device)
    return blocks[rows, cols]


# ---------------------------------------------------------------------- #
# per-pattern tables, built once on each device
# ---------------------------------------------------------------------- #
class _Tables:
    """What a pattern's products need on one device, built once: the
    ``BlockMatrix`` skeleton of the grouped and fixed-block strategies, and
    the ``cuda`` strategy's K2 tables over the transposed pattern (output
    tile-cols become K2's row tiles): ``order`` (the lexsort by (col, row)
    that gathers the tiles), ``row_ids`` = pattern cols, ``col_ids`` =
    pattern rows, ``row_ptr``, and K2's float32 split of the table for each
    column count; and the input and output gathers (nt, tm) and (nt, tk) of
    the ``cuda`` strategy's backward."""

    def __init__(self, pattern: BlockPattern, dev: torch.device):
        nt, tm, tk = pattern.n_tiles, pattern.tm, pattern.tk
        self.skeleton = BlockMatrix.from_pattern(
            pattern, torch.zeros((nt, 1, 1), device=dev).expand(nt, tm, tk), device=dev
        )
        rows, cols = np.asarray(pattern.rows), np.asarray(pattern.cols)
        order = np.lexsort((rows, cols))
        self.order = torch.as_tensor(order, dtype=torch.long, device=dev)
        self.row_ids = torch.as_tensor(cols[order], dtype=torch.int32, device=dev)
        self.col_ids = torch.as_tensor(rows[order], dtype=torch.int32, device=dev)
        self.row_ptr = kops.row_ptr_from_ids(self.row_ids, pattern.d_out // tk)
        self._k2_tile = (tk, tm)  # K2's (tm, tk): the transposed tiles
        self._schedules = {}
        self.row_gather = torch.as_tensor(pattern.row_gather(), dtype=torch.long, device=dev)
        self.col_gather = torch.as_tensor(pattern.col_gather(), dtype=torch.long, device=dev)

    def schedule(self, n: int, dtype: torch.dtype):
        """K2's split of the table for ``n`` columns in ``dtype`` on the
        card (None on the CPU, and for the bfloat16 body, which walks
        ``row_ptr`` alone)."""
        if self.row_ptr.device.type != "cuda":
            return None
        key = (n, dtype)
        if key not in self._schedules:
            self._schedules[key] = kops.bsr_schedule("spmm", self.row_ptr, *self._k2_tile, n,
                                                     dtype)
        return self._schedules[key]


_TABLES: dict = {}


def _tables(pattern: BlockPattern, dev: torch.device) -> _Tables:
    """The pattern's tables on ``dev``, built at the first call. Built
    outside inference mode whatever the caller's mode (a server's first
    forward runs under ``torch.inference_mode()``): the family's autograd
    Functions save the skeleton's index tensors for the backward, which an
    inference tensor cannot be."""
    key = (pattern_hash(pattern), str(dev))
    t = _TABLES.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _TABLES[key] = _Tables(pattern, dev)
    return t


def _as_block_matrix(tiles: torch.Tensor, pattern: BlockPattern) -> BlockMatrix:
    """View (pattern, tiles) as a fixed-block ``BlockMatrix`` (same row-major
    slot order, no padding): the pattern's cached skeleton with ``tiles`` as
    its data."""
    return dataclasses.replace(_tables(pattern, tiles.device).skeleton, data=tiles)


def sparse_matmul(x: torch.Tensor, tiles: torch.Tensor, pattern: BlockPattern):
    """y[..., d_out] = x[..., d_in] @ W_sparse: the ``dds`` member of the
    ``kernels.bsr_ops`` family with the grouped backend (gather input
    tile-rows, batched tile products, scatter-add output cols)."""
    lead = x.shape[:-1]
    y = bsr_ops.dds(x.reshape(-1, pattern.d_in), _as_block_matrix(tiles, pattern),
                    backend="grouped")
    return y.reshape(*lead, pattern.d_out)


class _CudaMatmulFn(torch.autograd.Function):
    """K2 forward; the reference's ``_pallas_matmul_bwd`` backward. The
    pattern's tables and gathers come from the ``_tables`` cache in both
    directions: only x and the tiles are saved."""

    @staticmethod
    def forward(ctx, pattern, x2, tiles):
        ctx.pattern = pattern
        ctx.save_for_backward(x2, tiles)
        t = _tables(pattern, x2.device)
        xt = x2.T.contiguous()  # (d_in, T)
        yt = kops.bsr_spmm(
            _transposed_tiles(tiles, t.order), t.row_ids, t.col_ids, xt, m_pad=pattern.d_out,
            row_ptr=t.row_ptr, schedule=t.schedule(xt.shape[1], xt.dtype), device=x2.device,
        )
        return yt.T

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x2, tiles = ctx.saved_tensors
        t = _tables(ctx.pattern, x2.device)
        rg, cg = t.row_gather, t.col_gather
        gg = g[:, cg]  # (T, nt, tk)
        dx = dtiles = None
        if ctx.needs_input_grad[1]:
            part = torch.einsum("bnk,nmk->bnm", gg, tiles)  # (T, nt, tm)
            dx = torch.zeros_like(x2).index_add_(1, rg.reshape(-1), part.reshape(len(x2), -1))
        if ctx.needs_input_grad[2]:
            dtiles = torch.einsum("bnm,bnk->nmk", x2[:, rg], gg).to(tiles.dtype)
        return None, dx, dtiles


def sparse_matmul_cuda(x: torch.Tensor, tiles: torch.Tensor, pattern: BlockPattern):
    """The card's hot path: K2 (``bsr_spmm``) over the pattern, x rows =
    tokens. K2 computes W^T x^T: x^T (d_in, T) is its dense operand and the
    tile tables are transposed, so that output tile-cols become its row
    tiles. The tables are built once per pattern; the tiles are gathered
    into that order and transposed to (nt, tk, tm) at every call, as the
    reference does. The result is a view of K2's (d_out, T) output, not
    row-major: the next call's x^T is then free; a caller that needs
    row-major strides makes it contiguous. On the CPU, K2's plain version
    runs. Its gradient is the reference's (``_pallas_matmul_bwd``): a gather
    and two einsums."""
    lead = x.shape[:-1]
    y = _CudaMatmulFn.apply(pattern, x.reshape(-1, pattern.d_in), tiles)
    return y.reshape(*lead, pattern.d_out)


def _transposed_tiles(tiles: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """(nt, tm, tk) tiles -> (nt, tk, tm) in K2's order, in one pass (the
    reference's per-call gather and transpose; index_select writes a
    contiguous result)."""
    return torch.index_select(tiles.transpose(1, 2), 0, order).contiguous()


# ---------------------------------------------------------------------- #
# plan-driven strategy selection (shares core.cache with the autotuner)
# ---------------------------------------------------------------------- #
def _fixed_block_matmul(x: torch.Tensor, tiles: torch.Tensor, pattern: BlockPattern):
    """Inspection-free strategy: the fixed-block op family (``bsr_ops.dds``,
    auto backend: K2 on the card). Used when the structure-change-rate
    arbiter decides the pattern churns too fast for plan caching."""
    lead = x.shape[:-1]
    y = bsr_ops.dds(x.reshape(-1, pattern.d_in), _as_block_matrix(tiles, pattern))
    return y.reshape(*lead, pattern.d_out)


def _dia_split(pattern: BlockPattern):
    """Split of a pattern's tiles into the diagonal band (each output
    tile-col used by at most one band tile, so the diagonal half of the
    product is scatter-free) and the remainder."""
    rows = np.asarray(pattern.rows)
    cols = np.asarray(pattern.cols)
    R = max(pattern.d_in // pattern.tm, 1)
    C = max(pattern.d_out // pattern.tk, 1)
    band = np.abs((cols + 0.5) / C - (rows + 0.5) / R) <= max(1.0 / R, 1.0 / C)
    diag_idx: list[int] = []
    used_cols: set[int] = set()
    for i in np.nonzero(band)[0]:
        if int(cols[i]) not in used_cols:
            used_cols.add(int(cols[i]))
            diag_idx.append(int(i))
    off_idx = sorted(set(range(len(rows))) - set(diag_idx))
    return np.asarray(diag_idx, np.int64), np.asarray(off_idx, np.int64)


@functools.lru_cache(maxsize=64)
def _dia_plan(pattern: BlockPattern):
    """The host side of ``_dia_hybrid_matmul``, once per pattern: band and
    remainder tile indices, the band tiles' input gather (nd, tm), the
    placement of their outputs (0 = the sentinel zero column) and the
    remainder's sub-pattern."""
    diag_idx, off_idx = _dia_split(pattern)
    rows, cols = np.asarray(pattern.rows), np.asarray(pattern.cols)
    tm, tk = pattern.tm, pattern.tk
    rg = rows[diag_idx][:, None] * tm + np.arange(tm)[None, :]
    place = np.zeros(pattern.d_out, np.int64)
    for j, t in enumerate(diag_idx):
        c0 = int(cols[t]) * tk
        place[c0:c0 + tk] = j * tk + np.arange(tk) + 1
    sub = BlockPattern(
        pattern.d_in, pattern.d_out, tm, tk,
        tuple(int(r) for r in rows[off_idx]), tuple(int(c) for c in cols[off_idx]),
    )
    return diag_idx, off_idx, rg, place, sub


def _dia_hybrid_matmul(x: torch.Tensor, tiles: torch.Tensor, pattern: BlockPattern):
    """DIA-hybrid strategy (``kernels/dia_hybrid.py``'s NN-path
    counterpart): the diagonal-band tiles place their outputs with a
    precomputed gather (sentinel 0 = untouched col) instead of a
    scatter-add; only the remainder tiles go through the grouped path."""
    lead = x.shape[:-1]
    diag_idx, off_idx, rg, place, sub = _dia_plan(pattern)
    dev = x.device
    xf = x.reshape(-1, pattern.d_in)
    T = xf.shape[0]
    y = torch.zeros((T, pattern.d_out), dtype=x.dtype, device=dev)
    if len(diag_idx):
        dt = torch.as_tensor(diag_idx, device=dev)
        part = torch.einsum("btm,tmk->btk", xf[:, torch.as_tensor(rg, device=dev)], tiles[dt])
        part1 = torch.cat([part.new_zeros((T, 1)), part.reshape(T, -1)], dim=1)
        y = part1[:, torch.as_tensor(place, device=dev)]
    if len(off_idx):
        y = y + sparse_matmul(xf, tiles[torch.as_tensor(off_idx, device=dev)], sub)
    return y.reshape(*lead, pattern.d_out)


_MATMUL_IMPLS = {
    "grouped": sparse_matmul,
    "cuda": sparse_matmul_cuda,
    "fixed_block": _fixed_block_matmul,
    "dia_hybrid": _dia_hybrid_matmul,
}
# "<pattern hash>@<device key>[@s{i}of{n}][@rb]" -> strategy name, resolved once per
# process; the device key is part of it, as it is of the on-disk plan key
_STRATEGY_REGISTRY: dict[str, str] = {}

# the reference's hash version: both packages key one structure alike
_PATTERN_HASH_VERSION = b"blockpattern-v2"


@functools.lru_cache(maxsize=256)
def pattern_hash(pattern: BlockPattern) -> str:
    """Structure hash of a BlockPattern (tile coords are the structure),
    byte-identical to the reference's: coordinates canonicalized to int64
    and hashed as raw bytes plus their shapes."""
    rows = np.asarray(pattern.rows, dtype=np.int64)
    cols = np.asarray(pattern.cols, dtype=np.int64)
    h = hashlib.sha256()
    h.update(_PATTERN_HASH_VERSION)
    h.update(
        np.asarray(
            [pattern.d_in, pattern.d_out, pattern.tm, pattern.tk, rows.size, cols.size],
            dtype=np.int64,
        ).tobytes()
    )
    h.update(rows.tobytes())
    h.update(cols.tobytes())
    return h.hexdigest()[:16]


def _registry_key(phash: str, dkey: str, shard) -> str:
    return f"{phash}@{dkey}" + ("" if shard is None else f"@s{shard[0]}of{shard[1]}")


def _shard_kw(shard) -> dict:
    return {} if shard is None else {"shard_id": shard[0], "num_shards": shard[1]}


def _pattern_meta(pattern: BlockPattern) -> dict:
    return {
        "d_in": pattern.d_in,
        "d_out": pattern.d_out,
        "tm": pattern.tm,
        "tk": pattern.tk,
        "n_tiles": pattern.n_tiles,
        "density": pattern.density,
    }


def choose_matmul_strategy(
    pattern: BlockPattern,
    batch: int = 8,
    cache=None,
    allow_bench: bool = True,
    warmup: int = 1,
    iters: int = 3,
    shard=None,
    family: str = None,
    mode: str = "measure",
    cost_model=None,
    include_dia: bool = False,
    device=None,
) -> str:
    """Measured (or cached) choice among the sparse-matmul strategies for
    one pattern on ``device`` (None = the card), persisted through the plan
    cache under ``plan_key("linear", pattern_hash, device_key)``.

    On the card the candidates are ``grouped`` and ``cuda`` (K2), timed at
    ``batch`` rows in float32 on numpy inputs from seed 0, as the reference
    times its own. On the CPU the candidate set is ``grouped`` alone: no
    benchmark runs and the plan is stored at once. A candidate that fails
    (a kernel that does not build or launch) fails the choice; nothing
    falls back to ``grouped`` behind it.

    ``family=`` lets the structure-change-rate arbiter
    (``core.autotune.choose_format``) see the pattern first: a family whose
    structure churns gets ``fixed_block`` at once, with no benchmark and no
    registry or plan-cache write. ``mode="predict"`` ranks the candidates
    with the cost model over the ``linear`` plan corpus before measuring
    (``cost_model=`` pins a loaded model). ``include_dia=True`` adds the
    ``dia_hybrid`` candidate where ``core.inspect.detect_pattern`` finds a
    diagonal band; its plans sit under the ``rb`` key segment.
    ``allow_bench=False`` takes the device's heuristic (the last candidate)
    without storing it, so a later call can still measure. ``shard=(i, n)``
    resolves the plan of shard ``i`` of ``n`` (registry key
    ``<hash>@<device>@s{i}of{n}``, plan key ``...-s{i}of{n}``).
    """
    if mode not in ("measure", "predict"):
        raise ValueError(f"unknown strategy mode {mode!r}")
    from ..core import cache as cachelib
    from ..core.staging import StagingOptions

    phash = pattern_hash(pattern)
    if family is not None:
        from ..core.autotune import choose_format

        if choose_format(family, phash) == "fixed_block":
            return "fixed_block"
    dev = resolve_device(device)
    dkey = cachelib.device_key(dev)
    reg_key = _registry_key(phash, dkey, shard) + ("@rb" if include_dia else "")
    found = _STRATEGY_REGISTRY.get(reg_key)
    if found is not None:
        return found
    key = cachelib.plan_key("linear", phash, dkey, **_shard_kw(shard), reblock=include_dia)
    store = cache if cache is not None else cachelib.default_cache()
    plan = store.load_plan(key)
    if plan is not None:
        _STRATEGY_REGISTRY[reg_key] = plan.options.backend
        return plan.options.backend

    candidates = ["grouped"] + (["cuda"] if dev.type == "cuda" else [])
    struct_meta: dict = {}
    if include_dia:
        from ..core.inspect import detect_pattern

        info = detect_pattern(pattern)
        struct_meta = {
            "structure_class": info.structure_class,
            "bandwidth_frac": info.bandwidth_frac,
            "diag_occupancy": info.diag_occupancy,
        }
        if info.wants_dia:
            candidates.append("dia_hybrid")
    meta = {**_pattern_meta(pattern), **struct_meta}
    opts = functools.partial(StagingOptions, tile=(pattern.tm, pattern.tk))

    if mode == "predict" and len(candidates) > 1:
        from ..core import cost_model as cmlib

        model = cost_model if cost_model is not None else cmlib.load_or_fit(store, dkey, "linear")
        if model is not None:
            feats = cmlib.pattern_features(pattern)
            ok, _why = model.confident(feats, candidates)
            if ok:
                preds = model.predict(feats, candidates)
                best = min(preds, key=preds.get)
                store.store_plan(key, cachelib.TuningPlan(
                    kind="linear", structure_hash=phash, options=opts(backend=best),
                    device=dkey, timings=preds,  # estimates, NOT measurements
                    meta=meta, source="predicted",
                ))
                _STRATEGY_REGISTRY[reg_key] = best
                cmlib._STATS["plans_predicted"] += 1
                return best
        cmlib._STATS["predict_fallbacks"] += 1

    timings: dict[str, float] = {}
    if len(candidates) > 1 and allow_bench:
        from ..core.autotune import measure

        rng = np.random.default_rng(0)
        x = torch.as_tensor(rng.standard_normal((batch, pattern.d_in)).astype(np.float32),
                            device=dev)
        tiles = torch.as_tensor(
            rng.standard_normal((pattern.n_tiles, pattern.tm, pattern.tk)).astype(np.float32),
            device=dev,
        )
        for name in candidates:
            fn = functools.partial(_MATMUL_IMPLS[name], pattern=pattern)
            timings[name] = measure(fn, x, tiles, warmup=warmup, iters=iters)
        best = min(timings, key=timings.get)
        source = "measured"
    else:
        best = candidates[-1] if not allow_bench else candidates[0]
        source = "heuristic"

    # a heuristic pick among several candidates is provisional: keep it out
    # of the persistent cache so a later warm_matmul_plans() can measure
    if source == "measured" or len(candidates) == 1:
        store.store_plan(key, cachelib.TuningPlan(
            kind="linear", structure_hash=phash, options=opts(backend=best), device=dkey,
            timings=timings, meta={**meta, **_shard_kw(shard)}, source=source,
        ))
        _STRATEGY_REGISTRY[reg_key] = best
    return best


def _seed_shard_strategy(pattern: BlockPattern, shard, strategy: str, cache=None,
                         device=None) -> str:
    """Record ``strategy`` under a per-shard plan key WITHOUT benchmarking
    (the device measured the full pattern once; a shard sees the same
    pattern, so the winner is inherited). A plan already stored under the
    shard key (e.g. measured on that device of a mixed pool) wins over the
    inherited default."""
    from ..core import cache as cachelib
    from ..core.staging import StagingOptions

    phash = pattern_hash(pattern)
    dkey = cachelib.device_key(resolve_device(device))
    reg_key = _registry_key(phash, dkey, shard)
    found = _STRATEGY_REGISTRY.get(reg_key)
    if found is not None:
        return found
    key = cachelib.plan_key("linear", phash, dkey, **_shard_kw(shard))
    store = cache if cache is not None else cachelib.default_cache()
    plan = store.load_plan(key)
    if plan is None:
        plan = cachelib.TuningPlan(
            kind="linear", structure_hash=phash,
            options=StagingOptions(backend=strategy, tile=(pattern.tm, pattern.tk)),
            device=dkey, meta=_shard_kw(shard), source="inherited",
        )
        store.store_plan(key, plan)
    _STRATEGY_REGISTRY[reg_key] = plan.options.backend
    return plan.options.backend


def pattern_plan_keys(pattern: BlockPattern, device, mesh=None) -> list:
    """Every plan-cache key a deployment of ``pattern`` on ``device``
    touches: the base key plus the per-shard keys when ``mesh`` has a shard
    axis (the keys ``warm_matmul_plans`` resolves; the engine and the
    scheduler check this set for a warm start)."""
    from ..core import cache as cachelib
    from ..core.sharded import shard_count

    h, dkey = pattern_hash(pattern), cachelib.device_key(resolve_device(device))
    n = 0 if mesh is None else shard_count(mesh)
    return [cachelib.plan_key("linear", h, dkey, **_shard_kw(s))
            for s in [None] + [(i, n) for i in range(n)]]


def warm_matmul_plans(patterns, batch: int = 8, cache=None, mesh=None,
                      mode: str = "measure", include_dia: bool = False,
                      device=None) -> dict:
    """Resolve strategies for many patterns before serving (the
    ``ServeEngine`` startup hook). Returns {hash: strategy}.

    With ``mesh=`` the per-shard plan keys of the mesh's shard axis are
    resolved too (``<hash>@s{i}of{n}``): the winner is measured ONCE per
    pattern and inherited by every shard (no per-shard benchmark); a
    per-shard plan already on disk overrides it.
    ``mode="predict"`` loads or fits the cost model once for all of them."""
    from ..core.sharded import shard_count

    n = 0 if mesh is None else shard_count(mesh)
    model = None
    if mode == "predict":
        from ..core import cache as cachelib
        from ..core import cost_model as cmlib

        store = cache if cache is not None else cachelib.default_cache()
        model = cmlib.load_or_fit(store, cachelib.device_key(resolve_device(device)), "linear")
    out = {}
    for p in patterns:
        base = choose_matmul_strategy(
            p, batch=batch, cache=cache, mode=mode, cost_model=model,
            include_dia=include_dia, device=device,
        )
        out[pattern_hash(p)] = base
        for i in range(n):
            out[f"{pattern_hash(p)}@s{i}of{n}"] = _seed_shard_strategy(
                p, (i, n), base, cache=cache, device=device)
    return out


@functools.lru_cache(maxsize=64)
def sub_pattern(pattern: BlockPattern, i: int, n: int) -> BlockPattern:
    """The pattern of tiles [i * nt / n, (i + 1) * nt / n): part ``i`` of
    ``n`` of the tile list, as a model-split SABLE matrix holds it (the
    same shape, its own structure hash and plan key)."""
    k = pattern.n_tiles // n
    return BlockPattern(pattern.d_in, pattern.d_out, pattern.tm, pattern.tk,
                        pattern.rows[i * k:(i + 1) * k], pattern.cols[i * k:(i + 1) * k])


def sparse_matmul_auto(x: torch.Tensor, tiles: torch.Tensor, pattern: BlockPattern,
                       shard=None, mesh=None, out_model: bool = False, family: str = None):
    """Plan-dispatched sparse matmul on x's device. A pattern with no plan
    yet is measured here (eagerly, as the reference measures outside
    ``jit``); ``warm_matmul_plans`` resolves a model's patterns ahead of
    serving, so that a forward never measures.

    ``shard=(i, n)`` dispatches on shard ``i``'s plan. With ``mesh=`` (and
    no ``shard``) this rank's shard of the mesh's shard axis picks the
    plan.

    ``out_model=True`` puts the output's last dim on the tensor axis, as
    the reference's constraint does. Under ``distributed.ctx``'s
    ``activation_sharding`` the tiles are this rank's part of a tile list
    split over "model" (``pattern`` its ``sub_pattern``), so the product is
    a partial sum: it is reduce-scattered into this rank's block of the
    last dim, or all-reduced whole where that dim does not divide. With an
    explicit ``mesh=`` that has a model axis, the whole product comes back
    as a DTensor split on its last dim over that axis. No-op otherwise."""
    if shard is None and mesh is not None:
        from ..core.sharded import resolve_shard_axis, shard_count

        n = shard_count(mesh)
        if n:
            axis = resolve_shard_axis(mesh)
            shard = (int(mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]), n)
    strategy = choose_matmul_strategy(pattern, family=family, device=x.device, shard=shard)
    y = _MATMUL_IMPLS[strategy](x, tiles, pattern)
    if not out_model:
        return y
    if mesh is None:
        from ..distributed.ctx import MODEL, constrain

        return constrain(y, *([None] * (y.dim() - 1)), MODEL, src="partial")
    from ..core.sharded import axis_size, resolve_model_axis

    maxis = resolve_model_axis(mesh)
    if maxis is None or y.shape[-1] % axis_size(mesh, maxis):
        return y
    from torch.distributed.tensor import DTensor, Replicate, Shard

    n = axis_size(mesh, maxis)
    i = int(mesh.get_local_rank(maxis))
    local = y.narrow(-1, i * (y.shape[-1] // n), y.shape[-1] // n)
    placements = [Shard(y.dim() - 1) if a == maxis else Replicate() for a in mesh.mesh_dim_names]
    return DTensor.from_local(local, mesh, placements)
