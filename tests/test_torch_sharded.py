"""PyTorch port, sharded staged execution (``repro_torch.core.sharded``,
``launch.mesh``, the shard paths of ``sparse.linear`` and the serving
warmup) against the JAX package.

- The host loop (``shards=``) against the reference's host loop at the
  port's parity tolerance (``TOL``, as ``test_torch_staging.py``), and
  against the port's own unsharded kernel at 1e-5.
- The mesh path on a one-rank gloo group in this process, and on four
  gloo ranks (``python -c`` processes sharing a ``file://`` store under
  ``tmp_path``: no TCP port, so xdist workers cannot collide; each is
  waited on with a timeout and killed past it), 1-D mesh of 4 and
  ``(2, 2)``, SpMV and SpMM, overlap on and off, against the reference's
  ``shard_map`` results from one subprocess on 8 forced host devices.
- Per-shard plans: autotune's ``-s{i}of{n}`` and ``-mc{cols}`` keys,
  ``_seed_shard_strategy``, ``warm_matmul_plans(mesh=)`` and the engine's
  and scheduler's ``mesh=``, each with a warm restart that runs no benchmark.

Tests that launch the kernels carry ``requires_cuda``."""
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import vbr_from_arrays  # noqa: E402
from repro_torch.core import autotune as tautotune  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core import sharded as tsharded  # noqa: E402
from repro_torch.core import staging as tstaging  # noqa: E402
from repro_torch.core import vbr as tvbr  # noqa: E402
from repro_torch.core.staging import StagingOptions, stage_spmm, stage_spmv  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve.scheduler import ContinuousBatchingScheduler  # noqa: E402
from repro_torch.sparse import linear as tlin  # noqa: E402
from test_torch_linear import _sealed_reference_plans  # noqa: E402,F401 (autouse)

SRC = str(Path(__file__).resolve().parent.parent / "src")
TOL = 2e-4  # the port against the reference (tests/test_torch_staging.py)
SELF = 1e-5  # the port's sharded call against its own unsharded one
CPU = "cpu"
N_COLS = 8
RANKS = 4
requires_cuda = pytest.mark.requires_cuda


@pytest.fixture(autouse=True)
def _card(request):
    """Tests marked requires_cuda skip without a card: decided here, when the
    test runs, so that every worker collects the same tests."""
    if request.node.get_closest_marker("requires_cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the kernels")


@pytest.fixture(autouse=True)
def plans(tmp_path, monkeypatch):
    """Both packages' default plan caches in a fresh directory; empty
    staged-function caches and registries."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache"))
    tcache.set_default_cache(None)
    tstaging.clear_cache()
    tlin._STRATEGY_REGISTRY.clear()
    tautotune.reset_autotune_stats()
    yield tmp_path / "cache"
    tstaging.clear_cache()
    tcache.set_default_cache(None)
    tlin._STRATEGY_REGISTRY.clear()


@pytest.fixture(scope="module")
def jx():
    """The reference, on JAX's CPU device in full float32."""
    jax = pytest.importorskip("jax")
    from repro.core import cache, staging, vbr
    from repro.sparse import linear

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(jax=jax, jnp=jax.numpy, cache=cache, staging=staging, vbr=vbr,
                              lin=linear)


@pytest.fixture
def jplans(jx, plans):
    jx.cache.set_default_cache(None)
    yield plans
    jx.cache.set_default_cache(None)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo process group in this process (a ``file://`` store)."""
    import torch.distributed as dist

    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield dist
    dist.destroy_process_group()


class ShapeMesh:
    """A stand-in for a DeviceMesh where only names, sizes and this rank's
    coordinate are read (plan keys, argument checks): a mesh of several
    ranks without starting them."""

    device_type = "cpu"

    def __init__(self, names, shape, coord=None):
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(shape)
        self.coord = coord or [0] * len(shape)

    def size(self, dim):
        return self.shape[dim]

    def get_coordinate(self):
        return self.coord


def _mk(seed=7, rows=160, cols=140, rs=12, cs=10, nb=36, sp=0.25):
    return tvbr.synthesize(rows, cols, rs, cs, nb, sp, False, seed=seed)


def _inputs(v, seed=0, n=N_COLS):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(v.shape[1]).astype(np.float32),
            rng.standard_normal((v.shape[1], n)).astype(np.float32))


def _np(y):
    return y.float().numpy() if isinstance(y, torch.Tensor) else np.asarray(y, np.float32)


def _sparse_few_blocks():
    """Four 2x2 blocks in a 6x6 matrix: at 8 shards, four shards are empty."""
    d = np.zeros((6, 6), np.float32)
    d[0:2, 0:2] = [[1, 2], [3, 4]]
    d[2:4, 4:6] = [[5, 0], [6, 7]]
    d[4:6, 2:4] = [[8, 9], [0, 1]]
    d[4:6, 0:2] = [[2, 3], [4, 5]]
    return tvbr.from_dense(d, [0, 2, 4, 6], [0, 2, 4, 6])


# ---------------------------------------------------------------------- #
# the host loop
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("num_shards", [3, 8])
@pytest.mark.parametrize("strategy", ["lpt", "contiguous"])
@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_host_loop_matches_reference_host_loop(jx, jplans, kind, strategy, num_shards):
    v = _mk()
    rv = jx.vbr.VBR(**dataclasses.asdict(v))
    x, X = _inputs(v)
    kw = dict(shards=num_shards, shard_strategy=strategy)
    if kind == "spmv":
        kern, rk = stage_spmv(v, device=CPU, **kw), jx.staging.stage_spmv(rv, **kw)
        rhs, single = x, stage_spmv(v, device=CPU)
    else:
        kern = stage_spmm(v, N_COLS, device=CPU, **kw)
        rk = jx.staging.stage_spmm(rv, N_COLS, **kw)
        rhs, single = X, stage_spmm(v, N_COLS, device=CPU)
    got, want = kern(v.val, rhs), rk(jx.jnp.asarray(v.val), jx.jnp.asarray(rhs))
    assert isinstance(kern, tsharded.ShardedStagedKernel)
    assert (kern.num_shards, kern.num_blocks, kern.max_rows, kern.max_nnz) == (
        rk.num_shards, rk.num_blocks, rk.max_rows, rk.max_nnz)
    np.testing.assert_array_equal(kern.y_src, rk.y_src)
    assert kern.imbalance() == rk.imbalance() <= 1.5
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(got), _np(single(v.val, rhs)), rtol=SELF, atol=SELF)
    np.testing.assert_allclose(_np(got), v.to_dense() @ rhs, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("backend", ["unrolled", "grouped", "bucketed", "cuda", "gather"])
def test_host_loop_backends_match_unsharded(backend):
    """Every staging backend, with empty shards (not staged, rows zero)."""
    for v in (_mk(3), _sparse_few_blocks()):
        x, X = _inputs(v)
        opts = StagingOptions(backend=backend, tile=(8, 8))
        ks = stage_spmv(v, opts, device=CPU, shards=8)
        km = stage_spmm(v, N_COLS, opts, device=CPU, shards=8)
        np.testing.assert_allclose(_np(ks(v.val, x)), _np(stage_spmv(v, opts, device=CPU)(
            v.val, x)), rtol=SELF, atol=SELF)
        np.testing.assert_allclose(_np(km(v.val, X)), _np(stage_spmm(v, N_COLS, opts,
                                   device=CPU)(v.val, X)), rtol=SELF, atol=SELF)
        empty = [s.shard_id for s in ks.plan.shards if s.nnz == 0]
        assert all(ks.kernels[i] is None for i in empty)
    assert empty  # the small matrix leaves shards empty


def test_host_loop_runs_each_shard_on_its_own_tables(monkeypatch):
    """The 'cuda' backend: one K1/K2 call a non-empty shard a call, each on
    the tile table staged for that shard, not the parent's."""
    v = _mk(11)
    x, X = _inputs(v)
    seen = []
    for name in ("bsr_spmv", "bsr_spmm"):
        real = getattr(kops, name)

        def spy(tiles, *a, _real=real, _name=name, **kw):
            seen.append((_name, tiles.shape[0], kw["m_pad"]))
            return _real(tiles, *a, **kw)

        monkeypatch.setattr(kops, name, spy)
    opts = StagingOptions(backend="cuda")
    parent = stage_spmv(v, opts, device=CPU).tiled
    ks = stage_spmv(v, opts, device=CPU, shards=4)
    km = stage_spmm(v, N_COLS, opts, device=CPU, shards=4)
    seen.clear()
    for _ in range(2):
        ks(v.val, x)
        km(v.val, X)
    live = [k for k in ks.kernels if k is not None]
    want = [(k.tiled.n_tiles, k.tiled.m_pad) for k in live]
    assert len(live) == 4
    assert [s[1:] for s in seen if s[0] == "bsr_spmv"] == want * 2
    assert [s[1:] for s in seen if s[0] == "bsr_spmm"] == [
        (k.tiled.n_tiles, k.tiled.m_pad) for k in km.kernels] * 2
    assert all(m_pad < parent.m_pad for _, m_pad in want)
    assert sum(n for n, _ in want) >= parent.n_tiles  # cut spans tile again


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_loop_on_card_launches_k1_k2_once_a_shard(dtype):
    """On the card the 'cuda' backend's host loop launches K1 and K2 once a
    non-empty shard a call; y equals the grouped backend's on the card."""
    dt = getattr(torch, dtype)
    tol = 1e-5 if dt == torch.float32 else 2e-2
    v = _mk(14)
    x, X = _inputs(v, n=128)
    dev = torch.device("cuda")
    val, xs, Xs = (torch.as_tensor(a, device=dev) for a in (v.val, x, X))
    opts = StagingOptions(backend="cuda", dtype=dt)
    ks = stage_spmv(v, opts, shards=8)
    km = stage_spmm(v, 128, opts, shards=8)
    live = sum(k is not None for k in ks.kernels)
    kops.reset_launches()
    y, ym = ks(val, xs), km(val, Xs)
    torch.cuda.synchronize()
    assert kops.launches == {"bsr_spmv": live, "bsr_spmm": live, "bsr_sdd": 0}
    g = StagingOptions(backend="grouped")
    want = stage_spmv(v, g, device=dev)(val.to(dt).float(), xs.to(dt).float())
    wantm = stage_spmm(v, 128, g, device=dev)(val.to(dt).float(), Xs.to(dt).float())
    for got, ref in ((y, want), (ym, wantm)):
        err = (got.float() - ref).abs().max().item() / ref.abs().max().item()
        assert err <= tol, err


def test_shards_of_one_structure_share_one_kernel():
    """Two shards of the same structure (values apart) hit one staged
    kernel in the cache keyed by the structure hash."""
    d = np.zeros((16, 12), np.float32)
    rng = np.random.default_rng(0)
    for r0 in (0, 8):  # the same blocks in both halves, other values
        d[r0:r0 + 4, 0:4] = rng.standard_normal((4, 4))
        d[r0 + 4:r0 + 8, 4:12] = rng.standard_normal((4, 8))
    v = tvbr.from_dense(d, [0, 4, 8, 12, 16], [0, 4, 12])
    x = rng.standard_normal(12).astype(np.float32)
    kern = stage_spmv(v, StagingOptions(backend="grouped"), device=CPU, shards=2,
                      shard_strategy="contiguous")
    assert kern.plan.shard_hashes()[0] == kern.plan.shard_hashes()[1]
    assert kern.kernels[0] is kern.kernels[1]
    assert tstaging.cache_info() == {"hits": 1, "misses": 1, "size": 1}
    np.testing.assert_allclose(_np(kern(v.val, x)), d @ x, rtol=SELF, atol=SELF)


def test_autotune_writes_a_plan_a_shard_and_restarts_warm(plans):
    v = _mk(12)
    x, _ = _inputs(v)
    kern = stage_spmv(v, StagingOptions(backend="autotune"), device=CPU, shards=3)
    names = set(os.listdir(plans / "plans"))
    h = tvbr.structure_hash(v)
    shard_plans = sorted(n for n in names if n.startswith(f"spmv-{h}-torchcpu-s"))
    assert shard_plans == [f"spmv-{h}-torchcpu-s{i}of3.json" for i in range(3)]
    assert f"shards-{h}-lpt-x3.json" in names
    for i, n in enumerate(shard_plans):
        meta = json.loads((plans / "plans" / n).read_text())["meta"]
        assert (meta["parent_structure_hash"], meta["shard_id"], meta["num_shards"]) == (h, i, 3)
    assert tautotune.autotune_stats()["plans_tuned"] == 3
    want = _np(kern(v.val, x))
    np.testing.assert_allclose(want, v.to_dense() @ x, rtol=TOL, atol=TOL)
    tstaging.clear_cache()  # a restart: the plans on disk alone
    tautotune.reset_autotune_stats()
    again = stage_spmv(v, StagingOptions(backend="autotune"), device=CPU, shards=3)
    assert set(os.listdir(plans / "plans")) == names
    assert tautotune.autotune_stats()["plans_tuned"] == 0
    assert tautotune.autotune_stats()["benchmarks"] == 0
    np.testing.assert_allclose(_np(again(v.val, x)), want, rtol=SELF, atol=SELF)
    assert again.compile() is again and again.inspection_time == again.stage0_time


def test_sharded_arguments_are_checked():
    v = _mk()
    with pytest.raises(ValueError, match="prepack"):
        stage_spmv(v, StagingOptions(prepack=True), device=CPU, shards=2)
    with pytest.raises(ValueError, match="dia_hybrid"):
        stage_spmv(v, StagingOptions(backend="dia_hybrid"), device=CPU, shards=2)
    with pytest.raises(ValueError, match="SpMV-only"):
        stage_spmm(v, N_COLS, StagingOptions(backend="dia_hybrid"), device=CPU, shards=2)
    with pytest.raises(ValueError, match="need mesh= or shards="):
        tsharded.ShardedStagedKernel("spmv", v, device=CPU)
    mesh = ShapeMesh(("shards", "model"), (2, 3))
    with pytest.raises(ValueError, match="shards=4 != mesh axis 'shards' size 2"):
        stage_spmv(v, mesh=mesh, shards=4)
    with pytest.raises(ValueError, match="must divide evenly over the 'model' axis"):
        stage_spmm(v, N_COLS, mesh=mesh)
    with pytest.raises(ValueError, match="no 'shards' axis"):
        stage_spmv(v, mesh=ShapeMesh(("data", "model"), (2, 2)))
    with pytest.raises(ValueError, match="no place in the mesh"):
        stage_spmv(v, mesh=_Outside())
    with pytest.raises(ValueError, match="not the mesh's"):
        stage_spmv(v, mesh=ShapeMesh(("shards",), (1,)), device="cuda")
    # the production mesh needs a process group of 256 ranks (512 multi-pod)
    with pytest.raises((RuntimeError, ValueError), match="process group"):
        tmesh.make_production_mesh()


class _Outside(ShapeMesh):
    """A rank past the mesh: ``get_coordinate()`` is None."""

    def __init__(self):
        super().__init__(("shards",), (2,))

    def get_coordinate(self):
        return None


def test_a_mesh_needs_a_process_group(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_staging_mesh(1)
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_local_mesh()


# ---------------------------------------------------------------------- #
# the mesh path on a one-rank gloo group
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("spec", [1, (1, 1)], ids=["1", "1x1"])
@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_one_rank_mesh_matches_host_loop(one_rank, kind, spec, overlap):
    v = _mk(13)
    x, X = _inputs(v)
    mesh = tmesh.make_staging_mesh(spec)
    assert mesh.device_type == "cpu" and mesh.mesh_dim_names == (
        ("shards",) if spec == 1 else ("shards", "model"))
    if kind == "spmv":
        got = stage_spmv(v, mesh=mesh, overlap_gather=overlap)(v.val, x)
        want = stage_spmv(v, device=CPU, shards=1)(v.val, x)
    else:
        got = stage_spmm(v, N_COLS, mesh=mesh, overlap_gather=overlap)(v.val, X)
        want = stage_spmm(v, N_COLS, device=CPU, shards=1)(v.val, X)
    assert type(got) is torch.Tensor  # one model column: the full result, not a DTensor
    np.testing.assert_allclose(_np(got), _np(want), rtol=SELF, atol=SELF)


def test_mesh_builders_check_their_shapes(one_rank):
    with pytest.raises(ValueError, match="asked for 2 shards but only 1 devices"):
        tmesh.make_staging_mesh(2)
    with pytest.raises(ValueError, match=r"asked for 1x2 mesh but only 1 devices"):
        tmesh.make_staging_mesh(1, model=2)
    with pytest.raises(ValueError, match="either a"):
        tmesh.make_staging_mesh((1, 1), model=1)
    with pytest.raises(ValueError, match=r"\(2,\) != 1 devices"):
        tmesh.make_local_mesh(("data",), shape=(2,))
    m = tmesh.make_local_mesh(("data", "model"))
    assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (1, 1)
    assert tmesh.mesh_device_type() == "cpu"


# ---------------------------------------------------------------------- #
# per-shard plans of the sparse FFN, warmed by the engine and the scheduler
# ---------------------------------------------------------------------- #
def test_seed_shard_strategy_records_without_benchmark_and_disk_wins(jx, jplans):
    pat = tlin.random_pattern(64, 96, 8, 8, 0.4, seed=3)
    h = tlin.pattern_hash(pat)
    store = tcache.default_cache()
    disk = tcache.TuningPlan(kind="linear", structure_hash=h,
                             options=StagingOptions(backend="cuda", tile=(8, 8)),
                             device="torchcpu", source="measured")
    store.store_plan(tcache.plan_key("linear", h, "torchcpu", shard_id=1, num_shards=4), disk)
    assert tlin._seed_shard_strategy(pat, (1, 4), "grouped", device=CPU) == "cuda"
    assert tlin._seed_shard_strategy(pat, (0, 4), "grouped", device=CPU) == "grouped"
    assert tlin._STRATEGY_REGISTRY[f"{h}@torchcpu@s0of4"] == "grouped"
    assert tautotune.autotune_stats()["benchmarks"] == 0
    got = json.loads((jplans / "plans" / f"linear-{h}-torchcpu-s0of4.json").read_text())
    ref_pat = jx.lin.random_pattern(64, 96, 8, 8, 0.4, seed=3)
    assert jx.lin.pattern_hash(ref_pat) == h
    jx.lin._seed_shard_strategy(ref_pat, (0, 4), "grouped")
    want = json.loads((jplans / "plans" / f"linear-{h}-cpu-s0of4.json").read_text())
    for k in ("kind", "structure_hash", "n_cols", "meta", "source", "timings", "num_workers"):
        assert got[k] == want[k], k
    assert (got["options"]["backend"], got["options"]["tile"]) == (
        want["options"]["backend"], want["options"]["tile"])
    assert (got["device"], want["device"]) == ("torchcpu", "cpu")


def test_warm_matmul_plans_seed_every_shard_from_one_base(plans):
    pats = [tlin.random_pattern(64, 96, 8, 8, 0.4, seed=s) for s in (0, 1)]
    mesh = ShapeMesh(("shards", "model"), (4, 2), coord=[2, 1])
    out = tlin.warm_matmul_plans(pats, mesh=mesh, device=CPU)
    hs = [tlin.pattern_hash(p) for p in pats]
    assert out == {**{h: "grouped" for h in hs},
                   **{f"{h}@s{i}of4": "grouped" for h in hs for i in range(4)}}
    names = set(os.listdir(plans / "plans"))
    assert names == {f"linear-{h}-torchcpu{sfx}.json" for h in hs
                     for sfx in ["", *(f"-s{i}of4" for i in range(4))]}
    src = json.loads((plans / "plans" / f"linear-{hs[0]}-torchcpu-s3of4.json").read_text())
    assert src["source"] == "inherited" and src["meta"] == {"shard_id": 3, "num_shards": 4}
    # a mesh with no shard axis warms the base plans alone
    assert tlin.warm_matmul_plans(pats, mesh=ShapeMesh(("data", "model"), (2, 2)),
                                  device=CPU) == {h: "grouped" for h in hs}
    # a restart loads them all; this rank dispatches on its shard's plan
    tlin._STRATEGY_REGISTRY.clear()
    assert tlin.warm_matmul_plans(pats, mesh=mesh, device=CPU) == out
    assert set(os.listdir(plans / "plans")) == names
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((3, 64)).astype(np.float32))
    tiles = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (pats[0].n_tiles, 8, 8)).astype(np.float32))
    torch.testing.assert_close(tlin.sparse_matmul_auto(x, tiles, pats[0], mesh=mesh),
                               tlin.sparse_matmul(x, tiles, pats[0]))
    assert f"{hs[0]}@torchcpu@s2of4" in tlin._STRATEGY_REGISTRY


def _sable():
    cfg = tconfigs.get_config("llama3-8b-sable", reduced=True)
    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    return cfg, ttr.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)


def test_engine_mesh_warms_every_shard_and_restarts_with_no_benchmark(one_rank, plans):
    cfg, params = _sable()
    for mesh, n in ((ShapeMesh(("shards", "model"), (4, 2)), 4),
                    (tmesh.make_staging_mesh(1), 1)):
        tlin._STRATEGY_REGISTRY.clear()
        eng = tengine.ServeEngine(cfg, params, max_len=16, mesh=mesh, device=CPU)
        n_pat = len(eng.patterns)
        assert n_pat == 2
        staged = eng.warmup_stats["plans_staged"]
        assert staged == n_pat * n + (n_pat if n == 4 else 0)  # the base plans once
        keys = [k for p in eng.patterns for k in tlin.pattern_plan_keys(p, eng.device, mesh)]
        assert len(keys) == n_pat * (1 + n)
        assert all(tcache.default_cache().has_plan(k) for k in keys)
        tlin._STRATEGY_REGISTRY.clear()  # a restart
        tautotune.reset_autotune_stats()
        again = tengine.ServeEngine(cfg, params, max_len=16, mesh=mesh, device=CPU)
        assert again.warmup_stats["warm_start"] is True
        assert again.warmup_stats["plans_staged"] == 0
        assert tautotune.autotune_stats()["benchmarks"] == 0
        assert again.sparse_plans == eng.sparse_plans
        assert again.make_scheduler(page_size=4).mesh is mesh


def test_scheduler_mesh_stages_every_shard_key_once(plans):
    cfg, params = _sable()
    eng = tengine.ServeEngine(cfg, params, max_len=16, autotune_sparse=False, device=CPU)
    store = tcache.PlanCache(str(plans / "store"))
    pat = tlin.random_pattern(64, 64, 16, 16, 0.4, seed=5)
    mesh = ShapeMesh(("shards",), (3,))
    prompt = np.arange(4, dtype=np.int32)

    def serve_once():
        sched = eng.make_scheduler(page_size=4, max_batch=1, plan_cache=store, mesh=mesh)
        sched.submit(prompt, max_new_tokens=2, patterns=(pat,), rid="r0", arrival=0.0)
        return sched.run(), sched

    results, sched = serve_once()
    assert sched.mesh is mesh
    assert sched.stats["plans_staged"] == 4  # the base key and three shard keys
    h = tlin.pattern_hash(pat)
    assert sorted(os.listdir(plans / "store" / "plans")) == sorted(
        f"linear-{h}-torchcpu{sfx}.json" for sfx in ("", "-s0of3", "-s1of3", "-s2of3"))
    tlin._STRATEGY_REGISTRY.clear()
    results2, sched2 = serve_once()
    assert sched2.stats["plans_staged"] == 0
    np.testing.assert_array_equal(results["r0"]["tokens"], results2["r0"]["tokens"])
    assert isinstance(ContinuousBatchingScheduler(cfg, params, max_len=8, mesh=mesh,
                                                  device=CPU), ContinuousBatchingScheduler)


# ---------------------------------------------------------------------- #
# four gloo ranks against the reference's shard_map on 8 host devices
# ---------------------------------------------------------------------- #
CASES = [(kind, spec, ov) for spec in ("m4", "m2x2") for kind in ("spmv", "spmm")
         for ov in (1, 0)]

REFERENCE = """
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.core import vbr as vbrlib
    from repro.core.staging import stage_spmm, stage_spmv
    from repro.launch.mesh import make_staging_mesh

    d = np.load(sys.argv[1])
    v = vbrlib.VBR(shape=tuple(int(a) for a in d["shape"]),
                   **{k: d[k] for k in ("rpntr", "cpntr", "bindx", "bpntrb", "bpntre",
                                        "indx", "val")})
    val, x, X = (jnp.asarray(d[k]) for k in ("val", "x", "X"))
    out = {}
    with jax.default_matmul_precision("highest"):
        for spec, tag in ((4, "m4"), ((2, 2), "m2x2")):
            mesh = make_staging_mesh(spec)
            for ov in (1, 0):
                ks = stage_spmv(v, mesh=mesh, overlap_gather=bool(ov))
                km = stage_spmm(v, X.shape[1], mesh=mesh, overlap_gather=bool(ov))
                out[f"spmv-{tag}-{ov}"] = np.asarray(jax.device_get(ks(val, x)))
                out[f"spmm-{tag}-{ov}"] = np.asarray(jax.device_get(km(val, X)))
    np.savez(sys.argv[2], **out)
"""

RANK = """
    import datetime, json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world, store, inp, outdir = (int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        from torch.distributed.tensor import DTensor
        from repro_torch.convert import vbr_from_arrays
        from repro_torch.core import autotune, cache, staging
        from repro_torch.core.staging import StagingOptions, stage_spmm, stage_spmv
        from repro_torch.launch.mesh import make_staging_mesh

        d = np.load(inp)
        v = vbr_from_arrays(*(d[k] for k in ("shape", "rpntr", "cpntr", "bindx", "bpntrb",
                                             "bpntre", "indx", "val")))
        val, x, X = (torch.as_tensor(d[k]) for k in ("val", "x", "X"))
        n = X.shape[1]
        out, info = {}, {"layout": {}}
        for spec, tag in ((4, "m4"), ((2, 2), "m2x2")):
            mesh = make_staging_mesh(spec)
            info["coord_" + tag] = list(mesh.get_coordinate())
            for ov in (1, 0):
                ks = stage_spmv(v, mesh=mesh, overlap_gather=bool(ov))
                km = stage_spmm(v, n, mesh=mesh, overlap_gather=bool(ov))
                y, ym = ks(val, x), km(val, X)
                if isinstance(ym, DTensor):
                    info["layout"][f"{tag}-{ov}"] = [repr(p) for p in ym.placements]
                    out[f"local-{tag}-{ov}"] = ym.to_local().numpy()
                    ym = ym.full_tensor()
                out[f"spmv-{tag}-{ov}"], out[f"spmm-{tag}-{ov}"] = y.numpy(), ym.numpy()
                info["y_type_" + tag] = type(y).__name__

        # per-shard autotune on the 2-D mesh: plans keyed by the local columns
        stores = []
        real = cache.PlanCache.store_plan

        def counted(self, key, plan):
            stores.append(key)
            return real(self, key, plan)

        cache.PlanCache.store_plan = counted
        plans = os.path.join(os.environ["REPRO_CACHE_DIR"], "plans")
        opts = StagingOptions(backend="autotune")
        out["auto"] = stage_spmm(v, n, opts, mesh=make_staging_mesh((2, 2)))(
            val, X).full_tensor().numpy()
        dist.barrier()
        info["names"] = sorted(os.listdir(plans))
        dist.barrier()
        staging.clear_cache()  # a restart: the plans on disk alone
        autotune.reset_autotune_stats()
        out["auto_warm"] = stage_spmm(v, n, opts, mesh=make_staging_mesh((2, 2)))(
            val, X).full_tensor().numpy()
        dist.barrier()
        info["names_warm"] = sorted(os.listdir(plans))
        info["tuned_warm"] = autotune.autotune_stats()["plans_tuned"]
        info["mc_stores"] = [k for k in stores if "-mc" in k]
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
    finally:
        dist.destroy_process_group()
"""


def _wait_all(procs, timeout):
    """Wait for every process; kill them all past ``timeout`` seconds."""
    import time

    end = time.monotonic() + timeout
    outs = []
    try:
        for name, p in procs:
            out, err = p.communicate(timeout=max(end - time.monotonic(), 1))
            outs.append((name, p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for _, p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"ranks or the reference did not finish within {timeout} s")
    bad = [f"{n} rc={rc}\n{out}\n{err}" for n, rc, out, err in outs if rc != 0]
    assert not bad, "\n".join(bad)


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Run the reference's shard_map (8 forced host devices) and the port's
    four gloo ranks side by side on the same inputs; returns both outputs."""
    pytest.importorskip("jax")
    root = tmp_path_factory.mktemp("ranks")
    v = _mk()
    x, X = _inputs(v)
    inp = root / "in.npz"
    np.savez(inp, shape=np.asarray(v.shape), rpntr=v.rpntr, cpntr=v.cpntr, bindx=v.bindx,
             bpntrb=v.bpntrb, bpntre=v.bpntre, indx=v.indx, val=v.val, x=x, X=X)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    procs = [("reference", subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(inp), str(root / "ref.npz")],
        env={**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
             "REPRO_CACHE_DIR": str(root / "ref_cache")},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))]
    for r in range(RANKS):
        procs.append((f"rank {r}", subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(RANK), str(r), str(RANKS),
             str(root / "store"), str(inp), str(root)],
            env={**env, "REPRO_CACHE_DIR": str(root / "cache")},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    _wait_all(procs, timeout=420)
    with np.load(root / "ref.npz") as f:
        ref = {k: f[k] for k in f.files}
    ranks = []
    for r in range(RANKS):
        with np.load(root / f"rank{r}.npz") as f:
            out = {k: f[k] for k in f.files}
        ranks.append((out, json.loads((root / f"rank{r}.json").read_text())))
    return SimpleNamespace(v=v, x=x, X=X, ref=ref, ranks=ranks)


@pytest.mark.parametrize("kind,spec,overlap", CASES,
                         ids=[f"{k}-{s}-{'ring' if o else 'allgather'}" for k, s, o in CASES])
def test_four_gloo_ranks_match_reference_shard_map(gloo_run, kind, spec, overlap):
    key = f"{kind}-{spec}-{overlap}"
    want = gloo_run.ref[key]
    dense = gloo_run.v.to_dense() @ (gloo_run.x if kind == "spmv" else gloo_run.X)
    np.testing.assert_allclose(want, dense, rtol=TOL, atol=TOL)
    for out, _ in gloo_run.ranks:  # every rank holds the full result
        np.testing.assert_allclose(out[key], want, rtol=TOL, atol=TOL)


def test_four_gloo_ranks_two_d_spmm_is_model_sharded(gloo_run):
    coords = sorted(tuple(info["coord_m2x2"]) for _, info in gloo_run.ranks)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    half = N_COLS // 2
    for out, info in gloo_run.ranks:
        assert info["y_type_m4"] == info["y_type_m2x2"] == "Tensor"  # SpMV, 1-D: full
        j = info["coord_m2x2"][1]
        for ov in (1, 0):
            assert info["layout"][f"m2x2-{ov}"] == ["Replicate()", "Shard(dim=1)"]
            np.testing.assert_allclose(out[f"local-m2x2-{ov}"],
                                       gloo_run.ref[f"spmm-m2x2-{ov}"][:, j * half:(j + 1) * half],
                                       rtol=TOL, atol=TOL)
        assert "layout" in info and not any(k.startswith("m4") for k in info["layout"])


def test_four_gloo_ranks_tune_each_shard_once_and_restart_warm(gloo_run):
    h = tvbr.structure_hash(gloo_run.v)
    mc = sorted(k for _, info in gloo_run.ranks for k in info["mc_stores"])
    assert mc == [f"spmm-{h}-torchcpu-n{N_COLS}-s{i}of2-mc{N_COLS // 2}" for i in range(2)]
    names = gloo_run.ranks[0][1]["names"]
    assert [n for n in names if "-mc" in n] == [f"{k}.json" for k in mc]
    assert f"shards-{h}-lpt-x4.json" in names and f"shards-{h}-lpt-x2.json" in names
    for out, info in gloo_run.ranks:
        assert info["names_warm"] == info["names"] == names  # the restart wrote nothing
        assert info["tuned_warm"] == 0
        np.testing.assert_allclose(out["auto"], gloo_run.ref["spmm-m2x2-1"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out["auto_warm"], out["auto"], rtol=SELF, atol=SELF)
