"""PyTorch port, the split of the tile table that K1 (bsr_spmv) and K2's
float32 body (bsr_spmm) walk on the card (``ops.tile_schedule``): its
invariants on skewed and paper-shaped tables, and a plain walk that follows
it as the kernels do (parts of cut row tiles into scratch slots, then added
in worker order) against the port's plain versions and the JAX package's
numpy oracles.

The JAX package comes in through the ``jx`` fixture, so that on a GPU
machine without JAX the schedule checks still run."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch.core import StagingOptions, stage_spmv, synthesize_paper  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import testing as ttesting  # noqa: E402

HEAD, TAIL = 1, 2
WORKERS = [1, 3, 7, 64]


@pytest.fixture(scope="module")
def jx():
    """The reference's numpy oracles for the kernels."""
    pytest.importorskip("jax")
    from repro.kernels import ref

    return SimpleNamespace(ref=ref)


def _paper_tables(uniform):
    """The tile tables of <50,50,500,u> / <100,100,500,nu> (20% in-block
    zeros) cut from 10 000 to 2 000 rows and columns, at the 32 x 32 tile."""
    splits = 50 if uniform else 100
    v = synthesize_paper(splits, splits, 500, zeros_pct=20, uniform=uniform, seed=0,
                         rows=2000, cols=2000)
    t = stage_spmv(v, StagingOptions(backend="cuda"), device="cpu").tiled
    return np.asarray(t.row_ids), np.asarray(t.col_ids), t.m_pad // t.tm


def _tables(kind):
    """(rows, cols, n_row_tiles) numpy, sorted."""
    if kind in ttesting.SKEWED:
        return ttesting.skewed_tables(np.random.default_rng(1), kind, 9)
    if kind == "u":
        return _paper_tables(True)
    if kind == "nu":
        return _paper_tables(False)
    if kind == "empty":  # no tile at all
        return np.zeros(0, np.int32), np.zeros(0, np.int32), 6
    rng = np.random.default_rng(2)  # "random": every row tile but 4 has tiles
    live = rng.permutation(23)[4:]
    rows = np.sort(np.concatenate([live, rng.choice(live, 60 - len(live))]))
    return rows.astype(np.int32), rng.integers(0, 9, 60).astype(np.int32), 23


KINDS = [*ttesting.SKEWED, "random", "empty", "u", "nu"]


def _row_ptr(rows, n_rows):
    return tops.row_ptr_from_ids(torch.as_tensor(rows, dtype=torch.int32), n_rows)


def _walk(tiles, row_ptr, col_ids, x, sched):
    """What K1 / K2's float32 body do with the schedule, in plain PyTorch.
    Each worker sums its share of every row tile it walks (in table order);
    a row tile it holds whole goes into y, a cut one into its scratch slot
    (2w for the head, 2w + 1 for the tail); then the worker holding a cut
    row tile's tail adds the later workers' heads to it and writes y. Every
    row tile must be written exactly once."""
    nb, tm, tk = tiles.shape
    rp = row_ptr.tolist()
    R = len(rp) - 1
    rest = tuple(x.shape[1:])
    xs = x.reshape((-1, tk) + rest).float()
    y = torch.full((R, tm) + rest, float("nan"))
    partial = torch.full((2 * len(sched), tm) + rest, float("nan"))
    written = np.zeros(R, int)
    for w, (t0, t1, r0, r1, flags) in enumerate(sched.tolist()):
        for r in range(r0, r1):
            part = torch.zeros((tm,) + rest)
            for b in range(max(rp[r], t0), min(rp[r + 1], t1)):
                part += tiles[b].float() @ xs[col_ids[b]]
            if r == r0 and flags & HEAD:
                partial[2 * w] = part
            elif r == r1 - 1 and flags & TAIL:
                partial[2 * w + 1] = part
            else:
                y[r] = part
                written[r] += 1
    for w, (_, _, _, r1, flags) in enumerate(sched.tolist()):
        if flags & TAIL:
            r, acc = r1 - 1, partial[2 * w + 1].clone()
            for v in range(w + 1, len(sched)):
                if sched[v, 0] >= rp[r + 1]:
                    break
                if sched[v, 4] & HEAD:
                    acc += partial[2 * v]
            y[r] = acc
            written[r] += 1
    assert (written == 1).all(), f"row tiles written {written.tolist()} times"
    return y.reshape((R * tm,) + rest)


@pytest.mark.parametrize("n_workers", WORKERS)
@pytest.mark.parametrize("kind", KINDS)
def test_schedule_invariants(kind, n_workers):
    rows, _, n_rows = _tables(kind)
    rp = _row_ptr(rows, n_rows)
    sched = tops.tile_schedule(rp, n_workers)
    assert sched.dtype == torch.int32 and sched.shape == (n_workers, 5)
    t0, t1, r0, r1, flags = (c.numpy().astype(np.int64) for c in sched.unbind(1))
    rpn = rp.numpy().astype(np.int64)
    # the ranges tile [row_ptr[0], row_ptr[R]) in order, each tile once
    assert t0[0] == rpn[0] and t1[-1] == rpn[-1] and (t1[:-1] == t0[1:]).all()
    covered = np.concatenate([np.arange(a, b) for a, b in zip(t0, t1)])
    np.testing.assert_array_equal(covered, np.arange(rpn[0], rpn[-1]))
    lengths = t1 - t0
    assert lengths.max() - lengths.min() <= 1
    # every row tile is walked, and by one worker only unless the split cuts it
    walkers = np.zeros(n_rows, int)
    for a, b in zip(r0, r1):
        walkers[a:b] += 1
    assert (walkers >= 1).all()
    # the cut row tiles (a worker boundary strictly inside) are the marked ones
    inner = t0[1:]
    cut = {r for r in range(n_rows) if ((rpn[r] < inner) & (inner < rpn[r + 1])).any()}
    marked = {int(a) for a, f in zip(r0, flags) if f & HEAD}
    marked |= {int(b) - 1 for b, f in zip(r1, flags) if f & TAIL}
    assert marked == cut
    assert {r for r in range(n_rows) if walkers[r] > 1} <= cut


@pytest.mark.parametrize("n_workers", WORKERS)
@pytest.mark.parametrize("kind", KINDS)
def test_schedule_walk_matches_plain_versions(jx, kind, n_workers):
    rows, cols, n_rows = _tables(kind)
    rng = np.random.default_rng(3)
    tm, tk, n = 4, 3, 5
    n_col_tiles = int(cols.max(initial=8)) + 1
    tiles = rng.standard_normal((len(rows), tm, tk)).astype(np.float32)
    x = rng.standard_normal(n_col_tiles * tk).astype(np.float32)
    xm = rng.standard_normal((n_col_tiles * tk, n)).astype(np.float32)
    rp = _row_ptr(rows, n_rows)
    sched = tops.tile_schedule(rp, n_workers)
    t, r, c = (torch.as_tensor(a) for a in (tiles, rows, cols))
    m_pad = n_rows * tm
    for xv, plain, oracle in (
        (x, tref.bsr_spmv_ref, jx.ref.bsr_spmv_ref),
        (xm, tref.bsr_spmm_ref, jx.ref.bsr_spmm_ref),
    ):
        got = _walk(t, rp, c, torch.as_tensor(xv), sched)
        want = plain(t, r, c, torch.as_tensor(xv), m_pad)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got.numpy(), oracle(tiles, rows, cols, xv, m_pad),
                                   rtol=2e-5, atol=2e-5)


def test_schedule_ignores_padding_tiles_past_the_last_row_tile():
    """Tiles sorted after row_ptr[R] (BlockMatrix's padding) are in no
    worker's range: the split covers row_ptr[0]..row_ptr[R] only."""
    rows, _, n_rows = ttesting.run_tables(np.random.default_rng(4), 9, pad=5)
    rp = _row_ptr(rows, n_rows)
    assert int(rp[-1]) == len(rows) - 5
    sched = tops.tile_schedule(rp, 7)
    assert int(sched[:, 1].max()) == len(rows) - 5


def test_schedule_rejects_no_workers():
    with pytest.raises(ValueError):
        tops.tile_schedule(torch.zeros(3, dtype=torch.int32), 0)
