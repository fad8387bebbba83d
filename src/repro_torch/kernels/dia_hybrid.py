"""DIA-hybrid SpMV: dense diagonals + staged-VBR remainder (PyTorch port of
``repro.kernels.dia_hybrid``).

Fukaya et al. ("Accelerating the SpMV kernel ... partially diagonal
structures", PAPERS.md) split a partially-diagonal matrix into its dense
diagonals — stored DIA-style, one contiguous vector per offset — and a
remainder in a general format.  The diagonal half of the product is then
scatter-free: for each offset ``d``, ``y += w_d * x[row + d]`` is a
gather, a multiply, and a sum over offsets — no scatter-add congestion,
no block tables.

Here the split is *staging-time structure* (``core/inspect.py`` picks the
dense offsets; values never move the split), so it composes with the rest
of the stack unchanged:

  * the diagonal part is two gather tables built at staging time — one
    into the ORIGINAL VBR value array (sentinel +1 encoding, slot 0 = the
    absent-entry zero), one into ``x`` (offsets clipped at the edges;
    safe because the weight there is the sentinel zero) — put on the
    device once;
  * the remainder (off-diagonal entries) is re-blocked under the original
    partitions restricted to the blocks that still have entries, and
    staged through the port's ``StagedKernel`` (``grouped``, as in the
    reference), so it shares the staged-function cache;
  * the whole thing is an ``fn(val, x)`` over the original value layout,
    interchangeable with every other backend in the autotune candidate
    list (label ``"dia_hybrid"``).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import vbr as vbrlib
from ..core.inspect import coo_slots, detect_structure
from ..core.reblock import build_vbr_from_coo
from ..device import on_device, resolve_device

__all__ = ["DiaHybridKernel", "stage_dia_hybrid", "clear_dia_cache"]


class DiaHybridKernel:
    """``fn(val, x) -> y`` on ``device`` — dense diagonals DIA-style,
    remainder staged.

    ``offsets`` (col - row) defaults to the detector's dense set.  Both
    halves read the ORIGINAL ``val`` array; all indirection is baked at
    staging time.
    """

    def __init__(
        self,
        vbr: vbrlib.VBR,
        offsets: Optional[Sequence[int]] = None,
        opts=None,
        remainder_backend: str = "grouped",
        device=None,
    ):
        from ..core import staging as staginglib

        t0 = time.perf_counter()
        self.kind = "spmv"
        self.backend = "dia_hybrid"
        self.device = dev = resolve_device(device)
        self.opts = opts if opts is not None else staginglib.StagingOptions(
            backend="dia_hybrid"
        )
        self.structure_hash = vbrlib.structure_hash(vbr)
        m, k = vbr.shape
        if offsets is None:
            info = detect_structure(vbr)
            if not info.wants_dia:
                raise ValueError(
                    "dia_hybrid: structure is not partially diagonal "
                    f"(class={info.structure_class!r}, diagonal occupancy "
                    f"{info.diag_occupancy:.2f}); pass offsets= explicitly "
                    "to override"
                )
            offsets = info.dense_offsets
        self.offsets = tuple(int(d) for d in offsets)
        if not self.offsets:
            raise ValueError("dia_hybrid needs at least one dense diagonal")
        # every STORED slot (zeros included): gathers are structure and
        # must survive value updates into stored-zero slots
        rows, cols, vidx = coo_slots(vbr)
        d = cols - rows
        on = np.isin(d, np.asarray(self.offsets, dtype=np.int64))

        # diagonal gather tables: W[i, r] = val[gather-1] for offset i
        off_arr = np.asarray(self.offsets, dtype=np.int64)
        off_pos = {int(o): i for i, o in enumerate(off_arr)}
        G = np.zeros((len(off_arr), m), dtype=np.int64)
        di = np.asarray([off_pos[int(x)] for x in d[on]], dtype=np.int64)
        G[di, rows[on]] = vidx[on] + 1
        XI = np.clip(np.arange(m)[None, :] + off_arr[:, None], 0, k - 1)
        self.num_diagonals = len(off_arr)

        # remainder: off-diagonal entries under the original partitions
        # (restricted to blocks that still have entries)
        self._rem = None
        self._rem_gather = None
        if np.any(~on):
            rem_vbr, rem_gather = build_vbr_from_coo(
                rows[~on], cols[~on], vidx[~on],
                vbr.rpntr, vbr.cpntr, vbr.shape,
                val=np.asarray(vbr.val),
            )
            rem_opts = staginglib.StagingOptions(
                backend=remainder_backend, dtype=self.opts.dtype
            )
            self._rem = staginglib._cached("spmv", rem_vbr, rem_opts, None, device=dev)
            self._rem_gather = torch.as_tensor(rem_gather, device=dev)
        self.remainder_nnz = int(np.count_nonzero(~on))
        # (ndiag, m) each: 1 + val index (0 = absent), x index
        self.gather_tables = (torch.as_tensor(G, device=dev), torch.as_tensor(XI, device=dev))
        self.stage0_time = time.perf_counter() - t0
        self.compile_time = 0.0

    def __call__(self, val, x):
        val, x = on_device(val, self.device), on_device(x, self.device)
        if self.opts.dtype is not None:
            val, x = val.to(self.opts.dtype), x.to(self.opts.dtype)
        g, xi = self.gather_tables
        val1 = torch.cat([val.new_zeros(1), val])
        w = val1[g].to(x.dtype)  # 0 where absent
        y = (w * x[xi]).sum(dim=0)
        if self._rem is not None:
            y = y + self._rem(val1[self._rem_gather], x)
        return y

    @property
    def inspection_time(self) -> float:
        return self.stage0_time + self.compile_time


_KERNELS: dict[tuple, DiaHybridKernel] = {}


def stage_dia_hybrid(
    vbr: vbrlib.VBR,
    offsets: Optional[Sequence[int]] = None,
    opts=None,
    device=None,
) -> DiaHybridKernel:
    """Stage (or reuse) the DIA-hybrid SpMV kernel for one structure on
    ``device`` (None = cuda).

    ``offsets=None`` re-runs detection; a :class:`~.core.cache.TuningPlan`
    that chose this backend pins the offsets it was measured with in
    ``plan.meta['dia_offsets']`` so warm restarts stage byte-identically.
    """
    dev = resolve_device(device)
    h = vbrlib.structure_hash(vbr)
    okey = None if opts is None else opts.key()
    key = (h, None if offsets is None else tuple(int(d) for d in offsets), okey, str(dev))
    hit = _KERNELS.get(key)
    if hit is not None:
        return hit
    kern = DiaHybridKernel(vbr, offsets=offsets, opts=opts, device=dev)
    _KERNELS[key] = kern
    return kern


def clear_dia_cache() -> None:
    _KERNELS.clear()
