"""The paper's synthetic VBR matrices, made from the seed.

A frozen copy of the structure half of the synthesizer of *Staging Blocked
Evaluation over Structured Sparse Matrices* (Section V): a grid of
``row_splits x col_splits`` cells over the matrix, ``num_blocks`` of them
chosen at random and stored densely, column-major inside each block. The
structure is drawn by numpy from the seed exactly as the repository's
``synthesize_paper`` draws it, so a seed gives the same pattern. The values
are drawn on the device instead, in a few large calls: standard normals
with ``zeros_pct`` percent of the entries set to zero.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Matrix:
    """A VBR structure on the host; the values live on the device."""

    shape: tuple
    rpntr: np.ndarray
    cpntr: np.ndarray
    bindx: np.ndarray
    bpntrb: np.ndarray
    bpntre: np.ndarray
    indx: np.ndarray

    @property
    def stored(self) -> int:
        return int(self.indx[-1])


def _split_points(n: int, parts: int, uniform: bool, rng) -> np.ndarray:
    if parts >= n:
        return np.arange(n + 1, dtype=np.int32)
    if uniform:
        return np.linspace(0, n, parts + 1).round().astype(np.int32)
    cuts = np.sort(rng.choice(np.arange(1, n), size=parts - 1, replace=False))
    return np.concatenate([[0], cuts, [n]]).astype(np.int32)


def structure(c: dict, seed: int) -> Matrix:
    """The pattern of configuration ``c`` for ``seed``."""
    rng = np.random.default_rng(seed)
    rows, cols = c["rows"], c["cols"]
    uniform = c["uniform"]
    rpntr = _split_points(rows, c["row_splits"], uniform, rng)
    cpntr = _split_points(cols, c["col_splits"], uniform, rng)
    R, C = len(rpntr) - 1, len(cpntr) - 1
    chosen = np.sort(rng.choice(R * C, size=min(c["num_blocks"], R * C), replace=False))
    by_row: dict = {}
    for cell in chosen:
        by_row.setdefault(int(cell) // C, []).append(int(cell) % C)
    bindx, bpntrb, bpntre, indx = [], [], [], [0]
    for a in range(R):
        h = int(rpntr[a + 1] - rpntr[a])
        blocks = by_row.get(a)
        if not blocks:
            bpntrb.append(-1)
            bpntre.append(-1)
            continue
        bpntrb.append(len(bindx))
        for b in blocks:
            bindx.append(b)
            indx.append(indx[-1] + h * int(cpntr[b + 1] - cpntr[b]))
        bpntre.append(len(bindx))
    return Matrix((rows, cols), rpntr, cpntr, np.asarray(bindx, np.int32),
                  np.asarray(bpntrb, np.int32), np.asarray(bpntre, np.int32),
                  np.asarray(indx, np.int64))


def values(c: dict, m: Matrix, count: int, gen: torch.Generator, device) -> torch.Tensor:
    """``count`` value arrays for ``m`` (count, stored), in the
    configuration's dtype: standard normals, ``zeros_pct`` percent zeroed."""
    v = torch.randn((count, m.stored), generator=gen, device=device, dtype=torch.float32)
    zero = torch.rand((count, m.stored), generator=gen, device=device) < c["zeros_pct"] / 100
    v.masked_fill_(zero, 0.0)
    del zero
    return v.to(getattr(torch, c["dtype"]))


def program_vbr(m: Matrix, val: torch.Tensor):
    """The program's VBR object over the harness's arrays."""
    from repro_torch.core.vbr import VBR

    return VBR(shape=m.shape, rpntr=m.rpntr, cpntr=m.cpntr, bindx=m.bindx, bpntrb=m.bpntrb,
               bpntre=m.bpntre, indx=m.indx, val=val)
