"""Inspection-time autotuner: measure candidate staged kernels, keep the best
(PyTorch port of ``repro.core.autotune``).

``backend='auto'`` in ``staging.py`` is a one-line heuristic (cuda on the
card, grouped on the CPU).  Ahrens & Boman show that format/partition choice for
blocked sparse formats is itself an optimization problem; SpComp argues the
compiler should make sparsity-structure-specific decisions.  This module is
that inspector: given a VBR *structure*, it stages every plausible
``StagingOptions`` candidate, micro-benchmarks each on representative
inputs, and records the measured winner as a :class:`~.cache.TuningPlan`.

The search is an inspection-time cost, paid once per structure: plans are
persisted through :mod:`repro_torch.core.cache` keyed by ``structure_hash``
and device (``cuda`` or ``torchcpu``, never a key of the JAX package), so a second process (or a restarted server) staging the same
pattern performs **zero** micro-benchmarks — it loads the plan and stages
the winner directly (compile-once / run-many, extended to tune-once /
run-forever).

Candidate space (gated by structure + device):

  * ``grouped``   always — the portable baseline (gather + einsum)
  * ``bucketed``  always — fewer shape classes on non-uniform splits
  * ``unrolled``  only for small block counts (one launch per block)
  * ``grouped`` + ``density_threshold`` hybrid — when block fill is low
  * ``cuda``      the hand-written kernels K1 (SpMV) and K2 (SpMM) over a
                  sweep of tiles, ``CUDA_TILES``, on the card only by default
                  (on the CPU the tables run through plain versions that
                  would never win); the reference sweeps ``pallas`` tiles
                  on a TPU
  * ``gather``    opt-in only — the extensibility fallback, never the fastest

plus the best ``partition_block_rows`` worker split (Section IV-D), chosen
analytically from the block-size histogram rather than timed.

``include_reblock=True`` extends the space with structure-derived
candidates (docs/inspection.md): ``dia_hybrid`` when the detector
(``core/inspect.py``) finds a diagonal-dominant pattern, and composite
``reblock[<strategy>]+<backend>`` candidates that re-partition the VBR
first (``core/reblock.py``, Ahrens-Boman DP / tiles aligned to the
cuda backend's) and
stage a backend over the reblocked layout.  A winning reblocked plan
records its :class:`~.reblock.ReblockSpec` (``plan.reblock``) and the
reblocked structure is cached under its own hash, so warm restarts apply
the recorded partitions directly — no detection, no DP, no benchmarks.
Extended-space plans live under a ``-rb`` key segment so they never
alias plans tuned over the base space.

At production cardinality even one measurement pass per structure is too
slow; ``autotune(mode="predict")`` ranks the candidates with the learned
cost model fit over the plan-cache corpus (``core/cost_model.py``) and
only measures when the model is uncertain — see that module and
docs/tuning.md for the calibration contract.

Timing on the card: ``measure`` synchronizes the device before the clock
starts and after each call, and the benchmark inputs are put on the device
once, before any candidate is timed, so that the search compares kernels
and not host-to-device copies. Only a candidate that refuses the structure
at staging (``ValueError``, ``NotImplementedError``, ``StagingError``)
drops out; any other error, such as a kernel that fails to build or
launch, propagates and fails the tune.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from . import staging as staginglib
from . import vbr as vbrlib
from .cache import PlanCache, TuningPlan, default_cache, device_key, plan_key
from .dsl import StagingError
from .staging import StagedKernel, StagingOptions

__all__ = [
    "autotune",
    "autotune_stage",
    "candidate_options",
    "measure",
    "tune_num_workers",
    "autotune_stats",
    "reset_autotune_stats",
    "StructureRateTracker",
    "structure_tracker",
    "observe_structure",
    "choose_format",
    "reset_structure_trackers",
]

# inspection-time knobs (overridable per call)
DEFAULT_WARMUP = 1
DEFAULT_ITERS = 3
MAX_UNROLLED_BLOCKS = 128
# (tm, tk) of the cuda candidates. Every tile row is whole 16-byte vectors
# in both dtypes (K1's vector loads and bulk copies, K2's cp.async; tk <= 128
# keeps K1 on its bulk path) and tk is a multiple of 16 (K2's float32 body
# takes 16-deep slices). K2's float32 body gives a row tile 32-row register
# blocks and its bfloat16 CTA owns 64 rows, so:
#   (32, 32)  the default: one register block, two row tiles a bfloat16 CTA;
#   (16, 64)  less row padding on random splits, half a register block;
#   (64, 32)  two register blocks a row tile, one row tile a bfloat16 CTA,
#             about half as many tiles;
#   (32, 64)  about half as many tiles, each tile row twice as long for K1.
CUDA_TILES = ((32, 32), (16, 64), (64, 32), (32, 64))
HYBRID_THRESHOLD = 0.5
WORKER_CANDIDATES = (1, 2, 4, 8, 16)
MIN_PARALLEL_EFFICIENCY = 0.75

_STATS = {
    "cache_hits": 0,
    "cache_misses": 0,
    "plans_tuned": 0,
    "benchmarks": 0,
    "plans_predicted": 0,
    "predict_fallbacks": 0,
}


def autotune_stats() -> dict:
    return dict(_STATS)


def reset_autotune_stats() -> None:
    _STATS.update({k: 0 for k in _STATS})


# ---------------------------------------------------------------------- #
# staged-VBR vs fixed-block arbitration (structure-change rate)
# ---------------------------------------------------------------------- #
# Staging + measured tuning pay an inspection cost that amortizes only if
# the SAME structure recurs; a structure that changes every call (per-batch
# MoE routing) must take the inspection-free fixed-block op family
# (kernels.bsr_ops) instead.  The tracker watches the stream of structure
# hashes one callsite ("family") produces and measures how often
# consecutive calls disagree — static patterns score ~0, per-batch
# topologies score ~1.
FIXED_BLOCK_CHANGE_RATE = 0.5
MIN_FORMAT_OBSERVATIONS = 4
TRACKER_WINDOW = 32


class StructureRateTracker:
    """Sliding-window observer of one callsite's structure-hash stream."""

    def __init__(self, window: int = TRACKER_WINDOW):
        from collections import deque

        self._hashes = deque(maxlen=int(window))

    def observe(self, structure_hash: str) -> None:
        self._hashes.append(structure_hash)

    @property
    def observations(self) -> int:
        return len(self._hashes)

    def change_rate(self) -> float:
        """Fraction of consecutive observation pairs whose hash changed."""
        hs = list(self._hashes)
        if len(hs) < 2:
            return 0.0
        return sum(a != b for a, b in zip(hs, hs[1:])) / (len(hs) - 1)


_STRUCTURE_TRACKERS: dict = {}


def structure_tracker(family: str, window: int = TRACKER_WINDOW):
    t = _STRUCTURE_TRACKERS.get(family)
    if t is None:
        t = _STRUCTURE_TRACKERS[family] = StructureRateTracker(window)
    return t


def observe_structure(family: str, structure_hash: str) -> None:
    structure_tracker(family).observe(structure_hash)


def reset_structure_trackers() -> None:
    _STRUCTURE_TRACKERS.clear()


def choose_format(
    family: str,
    structure_hash: str,
    *,
    threshold: float = FIXED_BLOCK_CHANGE_RATE,
    min_observations: int = MIN_FORMAT_OBSERVATIONS,
) -> str:
    """Observe ``structure_hash`` for ``family`` and arbitrate the format:

      * ``"staged"``       — structure recurs; keep the measured staged-VBR
                             path (plan cache, autotune, compile-once).
      * ``"fixed_block"``  — structure churns faster than ``threshold``;
                             take the inspection-free fixed-block op family
                             WITHOUT touching the plan cache (a plan per
                             throwaway topology would thrash it).

    The first ``min_observations`` calls stay staged: a one-shot pattern
    is indistinguishable from a static one, and the staged path's
    heuristic fallback is cheap until the rate signal is real.
    """
    t = structure_tracker(family)
    t.observe(structure_hash)
    if t.observations < min_observations:
        return "staged"
    return "fixed_block" if t.change_rate() > threshold else "staged"


# ---------------------------------------------------------------------- #
# candidate enumeration
# ---------------------------------------------------------------------- #
def candidate_options(
    vbr: vbrlib.VBR,
    *,
    device=None,
    include_cuda: Optional[bool] = None,
    include_gather: bool = False,
    max_unrolled_blocks: int = MAX_UNROLLED_BLOCKS,
) -> list[tuple[str, StagingOptions]]:
    """Enumerate (label, StagingOptions) candidates for one structure on
    ``device`` (None = cuda)."""
    if include_cuda is None:
        include_cuda = torch.device(device or "cuda").type == "cuda"
    cands: list[tuple[str, StagingOptions]] = [
        ("grouped", StagingOptions(backend="grouped")),
        ("bucketed", StagingOptions(backend="bucketed")),
    ]
    if vbr.num_blocks <= max_unrolled_blocks:
        cands.append(("unrolled", StagingOptions(backend="unrolled")))
    if vbr.density() < 0.95 and vbr.stored_nnz > 0:
        cands.append(
            (
                f"grouped+hybrid{HYBRID_THRESHOLD}",
                StagingOptions(
                    backend="grouped", density_threshold=HYBRID_THRESHOLD
                ),
            )
        )
    if include_cuda:
        for tm, tk in CUDA_TILES:
            cands.append(
                (f"cuda[{tm}x{tk}]", StagingOptions(backend="cuda", tile=(tm, tk)))
            )
    if include_gather:
        cands.append(("gather", StagingOptions(backend="gather")))
    return cands


# ---------------------------------------------------------------------- #
# worker-split tuning (paper Section IV-D)
# ---------------------------------------------------------------------- #
def tune_num_workers(
    vbr: vbrlib.VBR,
    candidates: tuple = WORKER_CANDIDATES,
    min_efficiency: float = MIN_PARALLEL_EFFICIENCY,
) -> int:
    """Largest worker count whose LPT partition keeps parallel efficiency
    (total work / (workers * makespan)) above ``min_efficiency``.

    Analytic — no timing needed: block sizes are structure, so the load
    model is exact at inspection time.
    """
    sizes = np.zeros(vbr.num_block_rows, dtype=np.int64)
    for t in vbr.blocks():
        sizes[t.block_row] += t.size
    total = int(sizes.sum())
    if total == 0:
        return 1
    best = 1
    for w in sorted(candidates):
        if w > max(int(np.count_nonzero(sizes)), 1):
            break
        bins = staginglib.partition_block_rows(vbr, w)
        makespan = max(int(sizes[list(b)].sum()) if b else 0 for b in bins)
        if makespan == 0:
            break
        if total / (w * makespan) >= min_efficiency:
            best = w
    return best


# ---------------------------------------------------------------------- #
# micro-benchmark
# ---------------------------------------------------------------------- #
def _synchronize(args) -> None:
    """Wait for the CUDA devices the tensors among ``args`` lie on."""
    for dev in {a.device for a in args if isinstance(a, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def measure(
    fn, *args, warmup: int = DEFAULT_WARMUP, iters: int = DEFAULT_ITERS
) -> float:
    """Median wall time of ``fn(*args)``, the device of the tensor
    arguments synchronized before the clock starts and after each call;
    every call counts toward ``autotune_stats()['benchmarks']`` (the
    warm-cache acceptance check keys off that counter)."""
    for _ in range(warmup):
        fn(*args)
    ts = []
    for _ in range(iters):
        _synchronize(args)
        t0 = time.perf_counter()
        fn(*args)
        _synchronize(args)
        ts.append(time.perf_counter() - t0)
    _STATS["benchmarks"] += 1
    return float(np.median(ts))


def _bench_inputs(vbr: vbrlib.VBR, kind: str, n_cols: Optional[int], device):
    """The reference's inputs (numpy, seed 0), put on ``device`` once."""
    rng = np.random.default_rng(0)
    val = np.asarray(vbr.val, dtype=np.float32)
    if val.size and not np.any(val):
        val = rng.standard_normal(val.shape).astype(np.float32)
    k = vbr.shape[1]
    if kind == "spmv":
        x = rng.standard_normal(k).astype(np.float32)
    else:
        x = rng.standard_normal((k, n_cols)).astype(np.float32)
    return torch.as_tensor(val, device=device), torch.as_tensor(x, device=device)


def _structure_meta(vbr: vbrlib.VBR) -> dict:
    """Structure summary recorded on every plan.  The block-size moments
    feed the cost model (core/cost_model.py) — they are what separates a
    few-large-blocks structure from a many-tiny-blocks one at equal nnz,
    which is exactly where backend winners diverge.  The structure-class
    fields (core/inspect.py) separate banded/diagonal patterns from
    random-block ones — where the ``dia_hybrid``/reblocked candidates
    diverge from the base backends."""
    from . import inspect as inspectlib

    sizes = np.asarray([t.size for t in vbr.blocks()], dtype=np.int64)
    mean = float(sizes.mean()) if sizes.size else 0.0
    info = inspectlib.detect_structure(vbr)
    return {
        "shape": [int(s) for s in vbr.shape],
        "num_blocks": int(vbr.num_blocks),
        "num_block_rows": int(vbr.num_block_rows),
        "num_block_cols": int(vbr.num_block_cols),
        "stored_nnz": int(vbr.stored_nnz),
        "density": float(vbr.density()),
        "block_size_mean": mean,
        "block_size_min": int(sizes.min()) if sizes.size else 0,
        "block_size_max": int(sizes.max()) if sizes.size else 0,
        "block_size_cv": float(sizes.std() / mean) if mean else 0.0,
        "structure_class": info.structure_class,
        "bandwidth": int(info.bandwidth),
        "bandwidth_frac": float(info.bandwidth_frac),
        "diag_occupancy": float(info.diag_occupancy),
    }


# ---------------------------------------------------------------------- #
# the tuner
# ---------------------------------------------------------------------- #
def autotune(
    vbr: vbrlib.VBR,
    kind: str = "spmv",
    n_cols: Optional[int] = None,
    *,
    device=None,
    mode: str = "measure",
    cost_model=None,
    predict_margin: Optional[float] = None,
    predict_max_distance: Optional[float] = None,
    value_hints: Optional[np.ndarray] = None,
    cache: Optional[PlanCache] = None,
    use_cache: bool = True,
    warmup: int = DEFAULT_WARMUP,
    iters: int = DEFAULT_ITERS,
    include_cuda: Optional[bool] = None,
    include_gather: bool = False,
    include_reblock: bool = False,
    max_unrolled_blocks: int = MAX_UNROLLED_BLOCKS,
) -> TuningPlan:
    """Return the best :class:`TuningPlan` for ``(kind, vbr)`` on
    ``device`` (None = cuda).

    Warm path: the plan is loaded from the persistent cache and **no**
    kernel is staged or benchmarked.  Cold path with ``mode="measure"``
    (default): every candidate from :func:`candidate_options` is staged
    and timed; the winner (and every candidate's timing, for later
    inspection) is persisted along with the structure's indirection
    arrays.

    ``mode="predict"`` consults the learned cost model fit over the
    plan-cache corpus (``core/cost_model.py``) first: when the model is
    confident — every candidate known, the feature vector in-corpus, and
    a clear predicted margin between the top two candidates — the plan is
    built from *predicted* timings (``source="predicted"``) with ZERO
    micro-benchmarks.  Otherwise it falls back to measurement (never
    guessing), and the measured plan lands back in the corpus so the
    model improves online.  ``cost_model=`` pins a pre-loaded model
    (batch warmers fit once, predict many).

    ``include_reblock=True`` additionally enumerates the structure-derived
    candidates (see module docstring) and keys the plan with the ``-rb``
    segment.  The detection + reblocking DP run only on this cold path —
    a cache hit (or a churny ``family=`` pattern, which never reaches the
    tuner) pays neither."""
    if kind not in ("spmv", "spmm"):
        raise ValueError(f"unknown kind {kind!r}")
    if kind == "spmm" and n_cols is None:
        raise ValueError("spmm autotune needs n_cols")
    if mode not in ("measure", "predict"):
        raise ValueError(f"unknown autotune mode {mode!r}")
    dev = resolve_device(device)
    device = device_key(dev)
    shash = vbrlib.structure_hash(vbr)
    key = plan_key(kind, shash, device, n_cols, reblock=include_reblock)
    cache = cache if cache is not None else default_cache()

    if use_cache:
        plan = cache.load_plan(key)
        if plan is not None:
            _STATS["cache_hits"] += 1
            return plan
        _STATS["cache_misses"] += 1

    cands = candidate_options(
        vbr,
        device=dev,
        include_cuda=include_cuda,
        include_gather=include_gather,
        max_unrolled_blocks=max_unrolled_blocks,
    )
    spec_by_label: dict = {}
    rvbr_by_label: dict = {}
    dia_offsets = None
    extra_meta: dict = {}
    if include_reblock:
        from . import inspect as inspectlib
        from . import reblock as rblib

        info = inspectlib.detect_structure(vbr)
        if kind == "spmv" and info.wants_dia:
            cands.append(("dia_hybrid", StagingOptions(backend="dia_hybrid")))
            dia_offsets = [int(d) for d in info.dense_offsets]
            extra_meta["dia_offsets"] = dia_offsets
        specs = rblib.propose_reblockings(vbr, device=dev)
        if specs:
            # the primary (DP-first) proposal's fill: deterministic from
            # structure alone, so predict-time features match training
            extra_meta["reblock_fill_ratio"] = float(specs[0].fill_ratio)
        for spec in specs:
            rvbr, _ = rblib.apply_reblock(vbr, spec)
            for lbl, opts in candidate_options(
                rvbr,
                device=dev,
                include_cuda=include_cuda,
                max_unrolled_blocks=max_unrolled_blocks,
            ):
                full = f"reblock[{spec.strategy}]+{lbl}"
                cands.append((full, opts))
                spec_by_label[full] = spec
                rvbr_by_label[full] = rvbr
            if use_cache:
                # key every proposed reblocked structure in the cache at
                # proposal time: whichever candidate any plan (measured
                # now, predicted later) ends up pinning, warm restarts
                # find the structure under spec.structure_hash and
                # re-derive nothing
                cache.store_structure(rvbr)

    if mode == "predict":
        from . import cost_model as cmlib

        model = (
            cost_model
            if cost_model is not None
            else cmlib.load_or_fit(cache, device, kind)
        )
        if model is not None:
            meta = {**_structure_meta(vbr), **extra_meta}
            feats = cmlib.meta_features(kind, meta, n_cols)
            labels = [lbl for lbl, _ in cands]
            ok, _why = model.confident(
                feats,
                labels,
                margin=(
                    cmlib.DEFAULT_MARGIN
                    if predict_margin is None
                    else predict_margin
                ),
                max_distance=(
                    cmlib.DEFAULT_MAX_DISTANCE
                    if predict_max_distance is None
                    else predict_max_distance
                ),
            )
            if ok:
                preds = model.predict(feats, labels)
                best_label = min(preds, key=preds.get)
                best_spec = spec_by_label.get(best_label)
                plan = TuningPlan(
                    kind=kind,
                    structure_hash=shash,
                    options=dict(cands)[best_label],
                    n_cols=n_cols,
                    device=device,
                    timings=preds,  # estimates, NOT measurements
                    num_workers=tune_num_workers(vbr),
                    meta=meta,
                    source="predicted",
                    reblock=None if best_spec is None else best_spec.to_dict(),
                )
                _STATS["plans_predicted"] += 1
                cmlib._STATS["plans_predicted"] += 1
                if use_cache:
                    cache.store_plan(key, plan)
                    cache.store_structure(vbr)
                    if best_label in rvbr_by_label:
                        cache.store_structure(rvbr_by_label[best_label])
                return plan
        _STATS["predict_fallbacks"] += 1
        cmlib._STATS["predict_fallbacks"] += 1

    hints = value_hints if value_hints is not None else vbr.val
    val, x = _bench_inputs(vbr, kind, n_cols, dev)
    timings: dict[str, float] = {}
    best_label, best_opts, best_t = None, None, float("inf")
    for label, opts in cands:
        try:
            spec = spec_by_label.get(label)
            if spec is not None:
                from . import reblock as rblib

                kern = rblib.stage_reblocked(
                    vbr, spec, opts, kind, n_cols=n_cols, value_hints=value_hints,
                    device=dev,
                )
            elif opts.backend == "dia_hybrid":
                from ..kernels.dia_hybrid import stage_dia_hybrid

                kern = stage_dia_hybrid(vbr, offsets=dia_offsets, opts=opts, device=dev)
            else:
                kern = staginglib._cached(kind, vbr, opts, hints, n_cols=n_cols, device=dev)
        except (ValueError, NotImplementedError, StagingError):
            continue  # a candidate that refuses the structure drops out
        t = measure(kern, val, x, warmup=warmup, iters=iters)
        timings[label] = t
        if t < best_t:
            best_label, best_opts, best_t = label, opts, t
    if best_opts is None:
        # every candidate failed (shouldn't happen) — fall back to heuristic
        best_opts = StagingOptions(
            backend=staginglib._resolve_backend("auto", dev)
        )
        source = "heuristic"
    else:
        source = "measured"
    _STATS["plans_tuned"] += 1

    best_spec = spec_by_label.get(best_label)
    if best_spec is not None:
        # the feature records the fill the plan actually pays
        extra_meta["reblock_fill_ratio"] = float(best_spec.fill_ratio)
    plan = TuningPlan(
        kind=kind,
        structure_hash=shash,
        options=best_opts,
        n_cols=n_cols,
        device=device,
        timings=timings,
        num_workers=tune_num_workers(vbr),
        meta={**_structure_meta(vbr), **extra_meta},
        source=source,
        reblock=None if best_spec is None else best_spec.to_dict(),
    )
    if use_cache:
        cache.store_plan(key, plan)
        cache.store_structure(vbr)
        if best_label in rvbr_by_label:
            # key the REBLOCKED structure too: a warm restart loads the
            # plan, applies the recorded partitions, and stages against
            # this hash without re-deriving anything
            cache.store_structure(rvbr_by_label[best_label])
    return plan


def autotune_stage(
    vbr: vbrlib.VBR,
    kind: str = "spmv",
    n_cols: Optional[int] = None,
    *,
    value_hints: Optional[np.ndarray] = None,
    cache: Optional[PlanCache] = None,
    base_opts: Optional[StagingOptions] = None,
    device=None,
    **tune_kwargs,
) -> StagedKernel:
    """Autotune (or load the cached plan) and return the staged winner on
    ``device`` (None = cuda).

    ``base_opts`` carries the caller's non-tuned field (``dtype``) onto
    the winning plan; the tuner owns ``backend``,
    ``tile``, ``spmm_bn`` and ``density_threshold``.  ``prepack`` is
    incompatible with autotuning (the packed-tile layout depends on the
    backend the tuner hasn't picked yet) and raises.

    On a cold tune the winning kernel was already staged for benchmarking
    and sits in the in-memory executable cache, so this performs no extra
    staging — unless ``base_opts`` modifies the winner.
    """
    if base_opts is not None and base_opts.prepack:
        raise ValueError(
            "prepack=True is incompatible with backend='autotune': the tile "
            "layout depends on the tuned backend; stage with the plan's "
            "options and call .pack() instead"
        )
    dev = resolve_device(device)
    plan = autotune(
        vbr, kind, n_cols, value_hints=value_hints, cache=cache, device=dev,
        **tune_kwargs,
    )
    opts = plan.options
    if base_opts is not None:
        opts = dataclasses.replace(opts, dtype=base_opts.dtype)
    if plan.reblock is not None:
        from . import reblock as rblib

        spec = rblib.ReblockSpec.from_dict(plan.reblock)
        return rblib.stage_reblocked(
            vbr, spec, opts, kind, n_cols=n_cols, value_hints=value_hints, device=dev
        )
    if opts.backend == "dia_hybrid":
        from ..kernels.dia_hybrid import stage_dia_hybrid

        return stage_dia_hybrid(
            vbr, offsets=plan.meta.get("dia_offsets"), opts=opts, device=dev
        )
    hints = value_hints if value_hints is not None else (
        vbr.val if opts.density_threshold > 0 else None
    )
    return staginglib._cached(kind, vbr, opts, hints, n_cols=n_cols, device=dev)
