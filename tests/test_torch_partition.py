"""PyTorch port, the nnz-balanced partitioner (``repro_torch.distributed.
partition``) against the JAX package's on the same VBR structures: the plans
are held exactly (units, spans, gathers, shard hashes, imbalance), LPT's
tie-breaking included, and a ``shards`` record written by either package
loads in the other. Everything here is numpy: no tolerance is needed."""
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.core import vbr as tvbr  # noqa: E402
from repro_torch.core.cache import PlanCache  # noqa: E402
from repro_torch.distributed import partition as tpart  # noqa: E402

STRATEGIES = ["lpt", "contiguous"]


@pytest.fixture(scope="module")
def jx():
    """The reference's partitioner and VBR module (numpy; its package
    imports JAX, pinned to the CPU)."""
    pytest.importorskip("jax")
    from repro.core import cache, vbr
    from repro.distributed import partition

    return SimpleNamespace(part=partition, vbr=vbr, cache=cache)


def _ref(jx, v):
    return jx.vbr.VBR(**dataclasses.asdict(v))


def _mk(seed, uniform=False, rows=240, cols=200, rs=24, cs=20, nb=90, sp=0.25):
    return tvbr.synthesize(rows, cols, rs, cs, nb, sp, uniform, seed=seed)


def _dominant(seed=0):
    """One dense block row holding most of the nonzeros (it is split by
    matrix row across shards), beside equal small blocks (ties for LPT)."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((64, 48), np.float32)
    dense[8:24, :] = rng.standard_normal((16, 48))
    for r in range(32, 64, 4):
        dense[r:r + 4, 0:4] = 1.0 + rng.random((4, 4))
    splits_r = [0, 8, 24] + list(range(28, 65, 4))
    return tvbr.from_dense(dense, splits_r, list(range(0, 49, 4)))


def _assert_plans_equal(got, want):
    assert got.structure_hash == want.structure_hash
    assert tuple(got.shape) == tuple(want.shape)
    assert (got.num_shards, got.strategy) == (want.num_shards, want.strategy)
    assert got.shard_hashes() == want.shard_hashes()
    np.testing.assert_array_equal(got.nnz_per_shard(), want.nnz_per_shard())
    assert got.imbalance() == want.imbalance()
    for gs, ws in zip(got.shards, want.shards, strict=True):
        assert gs.shard_id == ws.shard_id and gs.num_shards == ws.num_shards
        assert [tuple(int(a) for a in sp) for sp in gs.spans] == [
            tuple(int(a) for a in sp) for sp in ws.spans]
        np.testing.assert_array_equal(gs.row_index, ws.row_index)
        np.testing.assert_array_equal(gs.val_index, ws.val_index)
        np.testing.assert_array_equal(gs.block_rows, ws.block_rows)
        assert (gs.nnz, gs.local_m) == (ws.nnz, ws.local_m)
        for f in ("rpntr", "cpntr", "bindx", "bpntrb", "bpntre", "indx", "val"):
            np.testing.assert_array_equal(getattr(gs.vbr, f), getattr(ws.vbr, f))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("num_shards", [1, 3, 8])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_shard_plan_matches_reference(jx, strategy, num_shards, seed):
    v = _mk(seed)
    got = tpart.make_shard_plan(v, num_shards, strategy)
    _assert_plans_equal(got, jx.part.make_shard_plan(_ref(jx, v), num_shards, strategy))
    rows = np.sort(np.concatenate([s.row_index for s in got.shards]))
    np.testing.assert_array_equal(rows, np.arange(v.shape[0]))
    assert int(got.nnz_per_shard().sum()) == v.stored_nnz


@pytest.mark.parametrize("num_shards", [3, 5])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_ties_and_split_block_rows_match_reference(jx, strategy, num_shards):
    """Equal units (LPT breaks ties by the first least-loaded bin, units in
    a stable order) and a block row split by matrix row across shards."""
    v = _dominant()
    units = tpart._make_units(v, num_shards)
    assert units == jx.part._make_units(_ref(jx, v), num_shards)
    assert len(units) > v.num_block_rows  # the dense block row was split
    assert tpart.partition_nnz_balanced(v, num_shards, strategy) == \
        jx.part.partition_nnz_balanced(_ref(jx, v), num_shards, strategy)
    _assert_plans_equal(tpart.make_shard_plan(v, num_shards, strategy),
                        jx.part.make_shard_plan(_ref(jx, v), num_shards, strategy))
    # uniform grids give many equal block rows
    u = _mk(4, uniform=True)
    _assert_plans_equal(tpart.make_shard_plan(u, num_shards, strategy),
                        jx.part.make_shard_plan(_ref(jx, u), num_shards, strategy))


def test_shard_vbr_and_block_row_nnz_match_reference(jx):
    v = _mk(5)
    np.testing.assert_array_equal(tpart.block_row_nnz(v), jx.part.block_row_nnz(_ref(jx, v)))
    spans = [3, (7, 0, 2), (1, 1, 4), 0]  # bare block rows and partial spans
    got = tpart.shard_vbr(v, spans, shard_id=1, num_shards=2)
    want = jx.part.shard_vbr(_ref(jx, v), spans, shard_id=1, num_shards=2)
    assert got.spans == want.spans
    np.testing.assert_array_equal(got.row_index, want.row_index)
    np.testing.assert_array_equal(got.val_index, want.val_index)
    assert tvbr.structure_hash(got.vbr) == jx.vbr.structure_hash(want.vbr)
    # the shard's dense rows are the parent's rows it owns
    np.testing.assert_array_equal(got.vbr.to_dense(), v.to_dense()[got.row_index])


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_shard_record_loads_in_the_other_package(jx, tmp_path, writer, strategy):
    v = _mk(6)
    n = 4
    if writer == "port":
        path = tpart.save_shard_plan(tpart.make_shard_plan(v, n, strategy),
                                     cache=PlanCache(str(tmp_path)))
        got = jx.part.load_shard_plan(_ref(jx, v), n, strategy,
                                      cache=jx.cache.PlanCache(str(tmp_path)))
        want = jx.part.make_shard_plan(_ref(jx, v), n, strategy)
    else:
        path = jx.part.save_shard_plan(jx.part.make_shard_plan(_ref(jx, v), n, strategy),
                                       cache=jx.cache.PlanCache(str(tmp_path)))
        got = tpart.load_shard_plan(v, n, strategy, cache=PlanCache(str(tmp_path)))
        want = tpart.make_shard_plan(v, n, strategy)
    assert got is not None
    _assert_plans_equal(got, want)
    name = f"shards-{tvbr.structure_hash(v)}-{strategy}-x{n}.json"
    assert path.endswith(name)
    assert sorted(p.name for p in (tmp_path / "plans").iterdir()) == [name]
    rec = json.loads((tmp_path / "plans" / name).read_text())
    assert rec["device"] == strategy and rec["source"] == "partition"
    assert rec["meta"]["shard_hashes"] == want.shard_hashes()
    # the shards' structures are stored beside the record, under their hashes
    stored = {p.stem for p in (tmp_path / "structures").iterdir()}
    assert set(want.shard_hashes()) <= stored


def test_stale_record_is_refused(tmp_path):
    v = _mk(7)
    store = PlanCache(str(tmp_path))
    tpart.save_shard_plan(tpart.make_shard_plan(v, 3, "lpt"), cache=store)
    assert tpart.load_shard_plan(v, 3, "lpt", cache=store) is not None
    assert tpart.load_shard_plan(v, 4, "lpt", cache=store) is None  # another count
    path = tmp_path / "plans" / f"shards-{tvbr.structure_hash(v)}-lpt-x3.json"
    rec = json.loads(path.read_text())
    rec["meta"]["shard_hashes"][0] = "0" * 16
    path.write_text(json.dumps(rec))
    assert tpart.load_shard_plan(v, 3, "lpt", cache=store) is None


def test_bad_arguments_raise_as_the_reference(jx):
    v = _mk(8)
    for mod, vv in ((tpart, v), (jx.part, _ref(jx, v))):
        with pytest.raises(ValueError, match="num_shards must be >= 1"):
            mod.partition_nnz_balanced(vv, 0)
        with pytest.raises(ValueError, match="unknown partition strategy"):
            mod.partition_nnz_balanced(vv, 2, "round_robin")
