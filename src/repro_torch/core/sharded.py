"""Sharded staged execution: per-shard staged kernels over a device mesh
(PyTorch port of ``repro.core.sharded``, on ``torch.distributed``).

A :class:`~repro_torch.distributed.partition.ShardPlan` cuts the VBR block
rows into nnz-balanced shards, and each shard is staged as its OWN kernel
for its local block-size distribution (shard-local staging; on the card,
each shard's own K1/K2 tile tables). Execution runs either:

  * the host loop (``shards=`` without ``mesh=``): the per-shard kernels
    run one after another on the caller's device and scatter their rows
    into the global output (``index_copy_``), the reference semantics;
  * the mesh path (``mesh=``, a ``DeviceMesh`` of ``launch.mesh``): every
    rank holds the global ``val`` and ``x``; rank ``(i, j)`` runs shard
    ``i``'s kernel on ``val[val_index]`` and, on a 2-D SpMM mesh, on the
    ``j``-th column slice of ``x``, staged for ``n_cols / model`` local
    columns. The padded per-shard outputs are gathered over the shard
    axis's process group, then assembled through ``y_src``.

The reference stages every shard on every device (``lax.switch`` picks the
branch inside one SPMD program); a rank here stages only its own shard.

Gather: ``overlap_gather=True`` (default) is the reference's ``ppermute``
ring, ``D-1`` hops of ``dist.batch_isend_irecv`` to the next rank of the
shard group, each hop forwarding the tile received last;
``overlap_gather=False`` is one ``all_gather_into_tensor``. A 1-D mesh
returns the full ``y`` on every rank. A 2-D SpMM mesh returns the
reference's model-sharded result: a ``DTensor`` with ``Shard(1)`` on the
model axis and ``Replicate()`` on the others, whose ``full_tensor()`` is
the global output.

Per-shard tuning plans (``backend='autotune'``) are persisted under
``(parent structure_hash, device, shard_id[, model_cols])`` via
``core.cache.plan_key``, so a restart stages every shard with zero
re-benchmarks. On a 2-D mesh the ranks of one shard's model group take
turns: column 0 tunes and stores, the others load, so each plan is written
once.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..device import on_device, resolve_device
from . import staging as staginglib
from . import vbr as vbrlib
from .cache import default_cache, device_key, plan_key
from .staging import StagingOptions

__all__ = ["ShardedStagedKernel", "axis_size", "resolve_model_axis", "resolve_shard_axis",
           "shard_count"]


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(
            "mesh must be a torch DeviceMesh with named axes "
            f"(launch.mesh.make_staging_mesh), not {type(mesh).__name__}"
        )
    return tuple(names)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along the named mesh axis."""
    return int(mesh.size(_axis_names(mesh).index(axis)))


def resolve_shard_axis(mesh, shard_axis: str = "shards") -> str:
    """Pick the mesh axis shards live on: ``shard_axis`` when present, the
    sole axis of a 1-D mesh otherwise."""
    names = _axis_names(mesh)
    if shard_axis in names:
        return shard_axis
    if len(names) == 1:
        return names[0]
    raise ValueError(
        f"mesh {names} has no {shard_axis!r} axis; build one with "
        "launch.mesh.make_staging_mesh or pass shard_axis="
    )


def shard_count(mesh, shard_axis: str = "shards") -> int:
    """The mesh's shard count, or 0 when it has no shard axis (a pure
    ("data", "model") mesh warms the base plans only)."""
    try:
        return axis_size(mesh, resolve_shard_axis(mesh, shard_axis))
    except ValueError:
        return 0


def resolve_model_axis(mesh, model_axis: str = "model") -> Optional[str]:
    """The mesh axis the dense operand's columns are partitioned over, or
    None when the mesh has no such axis (pure 1-D sharded staging)."""
    return model_axis if model_axis in _axis_names(mesh) else None


def _shard_options(kind, parent_hash, shard, base_opts: StagingOptions, n_cols,
                   device: torch.device, model_cols=None) -> StagingOptions:
    """Resolve the staging options for ONE shard. 'autotune' tunes (or
    loads) a per-shard plan keyed by the parent hash + shard id (+ the
    local column count on a 2-D mesh)."""
    if base_opts.backend != "autotune":
        return base_opts
    from .autotune import autotune

    key = plan_key(kind, parent_hash, device_key(device), n_cols, shard_id=shard.shard_id,
                   num_shards=shard.num_shards, model_cols=model_cols)
    store = default_cache()
    plan = store.load_plan(key)
    if plan is None:
        # tunes on the shard-local structure (also cached under the shard's
        # own sub-structure hash: two matrices sharing a shard pattern share
        # the plan)
        tune_cols = model_cols if model_cols is not None else n_cols
        plan = autotune(shard.vbr, kind, tune_cols, cache=store, device=device)
        plan = dataclasses.replace(plan, meta={
            **plan.meta,
            "parent_structure_hash": parent_hash,
            "shard_id": shard.shard_id,
            "num_shards": shard.num_shards,
            **({} if model_cols is None else {"model_cols": model_cols}),
        })
        store.store_plan(key, plan)
    return dataclasses.replace(plan.options, dtype=base_opts.dtype)


class ShardedStagedKernel:
    """Sharded counterpart of :class:`~repro_torch.core.staging.StagedKernel`:
    ``fn(val, x) -> y`` where ``val`` is the GLOBAL value array and ``y``
    the global output; the block-row split (and, on a 2-D mesh, the model
    column split) is internal. Runs on ``device`` (None = the card) for the
    host loop, on the mesh's device type for the mesh path."""

    def __init__(
        self,
        kind: str,
        vbr: vbrlib.VBR,
        opts: StagingOptions = StagingOptions(),
        *,
        num_shards: Optional[int] = None,
        mesh=None,
        shard_axis: str = "shards",
        model_axis: str = "model",
        strategy: str = "lpt",
        n_cols: Optional[int] = None,
        hints: Optional[np.ndarray] = None,
        overlap_gather: bool = True,
        device=None,
    ):
        from ..distributed.partition import load_shard_plan, make_shard_plan, save_shard_plan

        t0 = time.perf_counter()
        self.model_axis = None
        self.model_size = 1
        self.shard_index = self.col_index = None  # this rank's mesh coordinates
        if mesh is not None:
            self.axis = resolve_shard_axis(mesh, shard_axis)
            self.model_axis = resolve_model_axis(mesh, model_axis)
            if self.model_axis == self.axis:
                self.model_axis = None
            if self.model_axis is not None:
                self.model_size = axis_size(mesh, self.model_axis)
            mesh_n = axis_size(mesh, self.axis)
            if num_shards is None:
                num_shards = mesh_n
            elif num_shards != mesh_n:
                raise ValueError(f"shards={num_shards} != mesh axis {self.axis!r} size {mesh_n}")
            coord = mesh.get_coordinate()
            if coord is None:
                raise ValueError("this rank holds no place in the mesh")
            names = _axis_names(mesh)
            self.shard_index = int(coord[names.index(self.axis)])
            if self.model_axis is not None:
                self.col_index = int(coord[names.index(self.model_axis)])
            want = torch.device(mesh.device_type)
            if device is not None and torch.device(device).type != want.type:
                raise ValueError(f"device {device} is not the mesh's ({mesh.device_type})")
            device = want
        elif num_shards is None:
            raise ValueError("need mesh= or shards=")
        else:
            self.axis = shard_axis
        if opts.prepack:
            raise ValueError("prepack is not supported for sharded staging")
        self.device = resolve_device(device)

        # 2-D mesh: the model axis column-partitions the SpMM RHS, so each
        # shard stages (and autotunes) for its LOCAL column count
        self.local_cols = n_cols
        if kind == "spmm" and self.model_size > 1:
            if n_cols is None or n_cols % self.model_size != 0:
                raise ValueError(
                    f"n_cols={n_cols} must divide evenly over the "
                    f"{self.model_axis!r} axis (size {self.model_size})"
                )
            self.local_cols = n_cols // self.model_size

        self.kind = kind
        self.opts = opts
        self.mesh = mesh
        self.overlap_gather = overlap_gather
        self.m, self.k = vbr.shape
        self.n_cols = n_cols
        self.structure_hash = vbrlib.structure_hash(vbr)
        self.plan = load_shard_plan(vbr, num_shards, strategy)
        if self.plan is None:
            self.plan = make_shard_plan(vbr, num_shards, strategy)
            save_shard_plan(self.plan)
        self.num_shards = num_shards

        # shard-local staging: each shard's kernel serves only its own
        # block-size distribution (the staged-function cache keeps shards of
        # one structure on one kernel); a rank of the mesh stages its own
        model_cols = self.local_cols if self.model_size > 1 else None

        def stage(s):
            s_opts = _shard_options(kind, self.structure_hash, s, opts, n_cols, self.device,
                                    model_cols=model_cols)
            s_hints = hints[s.val_index] if hints is not None else None
            if s_opts.density_threshold > 0 and s_hints is None:
                s_hints = s.vbr.val
            return staginglib._cached(kind, s.vbr, s_opts, s_hints, n_cols=self.local_cols,
                                      device=self.device)

        # an empty shard runs nothing and is not staged (the 'cuda' tables
        # of no tile do not exist); its rows stay zero
        if mesh is None:
            self.kernels = [stage(s) if self._live(s) else None for s in self.plan.shards]
        else:
            self.kernels = [None] * num_shards
            mine = self.plan.shards[self.shard_index]
            if self._live(mine):
                self.kernels[self.shard_index] = self._stage_in_turn(stage, mine)
        self.num_blocks = sum(s.vbr.num_blocks for s in self.plan.shards)

        self._build_maps()
        self._fn = self._build_spmd() if mesh is not None else self._build_host()
        self.stage0_time = time.perf_counter() - t0
        self.compile_time = 0.0

    # ------------------------------------------------------------------ #
    def _stage_in_turn(self, stage, shard):
        """Stage this rank's shard. Autotuning on a 2-D mesh, the rank at
        model column 0 tunes and stores the plan before the others of its
        model group load it."""
        if self.opts.backend != "autotune" or self.model_size == 1:
            return stage(shard)
        import torch.distributed as dist

        group = self.mesh.get_group(self.model_axis)
        lead = self.col_index == 0
        if not lead:
            dist.barrier(group=group)
        kern = stage(shard)
        if lead:
            dist.barrier(group=group)
        return kern

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)

    def _build_maps(self) -> None:
        shards = self.plan.shards
        self.max_nnz = max((s.nnz for s in shards), default=0)
        self.max_rows = max((s.local_m for s in shards), default=0)
        # (m,) gather from the 1-shifted flattened padded outputs (0 = zero)
        ys = np.zeros((self.m,), dtype=np.int64)
        for s in shards:
            local = np.arange(s.local_m, dtype=np.int64)
            ys[s.row_index] = s.shard_id * max(self.max_rows, 1) + local + 1
        self.y_src = ys

    @staticmethod
    def _live(s) -> bool:
        return not (s.nnz == 0 and s.vbr.num_blocks == 0)

    def _out_dtype(self, x: torch.Tensor) -> torch.dtype:
        return self.opts.dtype if self.opts.dtype is not None else x.dtype

    # ------------------------------------------------------------------ #
    def _build_host(self):
        parts = [(kern, self._tensor(s.val_index), self._tensor(s.row_index))
                 for s, kern in zip(self.plan.shards, self.kernels) if kern is not None]
        m, kind, dev = self.m, self.kind, self.device

        def fn(val, x):
            val, x = on_device(val, dev), on_device(x, dev)
            dt = self._out_dtype(x)
            y = torch.zeros((m,) if kind == "spmv" else (m, x.shape[1]), dtype=dt, device=dev)
            for kern, vidx, ridx in parts:
                y.index_copy_(0, ridx, kern(val[vidx], x).to(dt))
            return y

        return fn

    def _build_spmd(self):
        import torch.distributed as dist

        mesh, dev = self.mesh, self.device
        i, D, max_rows = self.shard_index, self.num_shards, self.max_rows
        s, kern = self.plan.shards[i], self.kernels[i]
        vidx = self._tensor(s.val_index)
        y_src = self._tensor(self.y_src)
        group = mesh.get_group(self.axis)
        if dist.get_rank(group) != i:
            raise RuntimeError(f"rank {dist.get_rank(group)} of the {self.axis!r} group sits "
                               f"at mesh coordinate {i}")
        col_split = self.kind == "spmm" and self.model_size > 1
        cols = None
        if col_split:
            nloc = self.local_cols
            cols = slice(self.col_index * nloc, (self.col_index + 1) * nloc)
        overlap = self.overlap_gather and D > 1
        nxt, prv = (dist.get_global_rank(group, (i + k) % D) for k in (1, -1))

        def gather(local: torch.Tensor) -> torch.Tensor:
            """(max_rows, ...) on each rank -> (D * max_rows, ...), shard order."""
            if not overlap:
                out = local.new_empty((D * max_rows,) + tuple(local.shape[1:]))
                dist.all_gather_into_tensor(out, local, group=group)
                return out
            # the ppermute ring: shard i's tile reaches every rank in D-1 hops
            buf = local.new_empty((D,) + tuple(local.shape))
            buf[i] = local
            cur = local
            for t in range(1, D):
                got = torch.empty_like(cur)
                for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, cur, nxt, group),
                                                 dist.P2POp(dist.irecv, got, prv, group)]):
                    w.wait()
                buf[(i - t) % D] = got
                cur = got
            return buf.reshape((D * max_rows,) + tuple(local.shape[1:]))

        def fn(val, x):
            val, x = on_device(val, dev), on_device(x, dev)
            if cols is not None:
                x = x[:, cols].contiguous()
            dt = self._out_dtype(x)
            local = torch.zeros((max_rows,) + tuple(x.shape[1:]), dtype=dt, device=dev)
            if kern is not None:
                local[: s.local_m] = kern(val[vidx], x).to(dt)
            flat = gather(local)
            y = torch.cat([flat.new_zeros((1,) + tuple(flat.shape[1:])), flat])[y_src]
            if not col_split:
                return y
            from torch.distributed.tensor import DTensor, Replicate, Shard

            placements = tuple(Shard(1) if n == self.model_axis else Replicate()
                               for n in _axis_names(mesh))
            return DTensor.from_local(y, mesh, placements, run_check=False)

        return fn

    # ------------------------------------------------------------------ #
    def __call__(self, val, x):
        return self._fn(val, x)

    def compile(self, val=None, x=None) -> "ShardedStagedKernel":
        """No counterpart: PyTorch runs eagerly and the kernels are built at
        first use, so there is no ahead-of-time compile; records 0."""
        self.compile_time = 0.0
        return self

    @property
    def inspection_time(self) -> float:
        return self.stage0_time + self.compile_time

    def imbalance(self) -> float:
        return self.plan.imbalance()
