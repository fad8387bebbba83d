"""PyTorch port, block-sparse linear layers: ``repro_torch.sparse.linear``
against the JAX package's ``repro.sparse.linear`` on the same numpy inputs.

Patterns, their hash, pruning and packing must agree exactly. Every
strategy of the port (``grouped``, ``cuda`` on K2's plain version,
``fixed_block``, ``dia_hybrid``) is held against the reference's grouped
result and its Pallas path in interpret mode (as tests/test_sparse_linear.py
runs it), at 2e-4. The card tests hold the ``cuda`` strategy (K2) against
``grouped`` and K2's plain version at one full-width llama3-8b FFN pattern.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch.core import autotune as tautotune  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.sparse import block_csr as tbc  # noqa: E402
from repro_torch.sparse import linear as tlin  # noqa: E402

CPU = "cpu"
TOL = dict(rtol=2e-4, atol=2e-4)
requires_cuda = pytest.mark.requires_cuda

# (d_in, d_out, tm, tk, density, seed): square and oblong tiles, the
# reduced llama3-8b-sable FFN patterns, and one full-width llama3-8b one
PATTERNS = {
    "oblong": (32, 64, 8, 16, 0.5, 2),
    "square": (48, 32, 8, 8, 0.3, 5),
    "reduced-in": (64, 128, 16, 16, 0.5, 0),
    "reduced-out": (128, 64, 16, 16, 0.5, 1),
    "llama3-8b-in": (4096, 14336, 128, 128, 0.25, 0),
}


@pytest.fixture(autouse=True)
def _card(request):
    """Tests marked requires_cuda skip without a card: decided here, when the
    test runs, so that every worker collects the same tests."""
    if request.node.get_closest_marker("requires_cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the kernels")


@pytest.fixture(scope="module", autouse=True)
def _sealed_reference_plans():
    """Leave the JAX package's process-wide plan state as this module found
    it: its strategy registry, its default plan cache, its format trackers
    and tuning counters. A reference run here (``jx``, a module-scoped JAX
    scheduler) fills the registry, and a reference test that later counts
    staged plans in a fresh cache on the same worker would find them warm.
    Module scope: an autouse fixture is set up before the other fixtures of
    its scope and torn down after them, so the snapshot precedes every
    module-scoped reference run and the restore follows its teardown. The
    port's other test files import it."""
    try:
        from repro.core import autotune as jautotune
        from repro.core import cache as jcache
        from repro.core import cost_model as jcost
        from repro.sparse import linear as jlin
    except ImportError:  # no JAX here: nothing of the reference can run
        yield
        return
    registry = dict(jlin._STRATEGY_REGISTRY)
    default, explicit = jcache._DEFAULT, jcache._DEFAULT_EXPLICIT
    yield
    jlin._STRATEGY_REGISTRY.clear()
    jlin._STRATEGY_REGISTRY.update(registry)
    jcache._DEFAULT, jcache._DEFAULT_EXPLICIT = default, explicit
    jautotune.reset_structure_trackers()
    jautotune.reset_autotune_stats()
    jcost.reset_cost_model_stats()


@pytest.fixture(scope="module")
def jx():
    """The reference's linear module, on JAX's CPU device in full float32."""
    jax = pytest.importorskip("jax")
    from repro.sparse import block_csr, linear

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(jax=jax, jnp=jax.numpy, lin=linear, bc=block_csr)


@pytest.fixture
def plan_dir(tmp_path, monkeypatch):
    """Both packages' default plan caches in a fresh directory, and empty
    in-process registries."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    tcache.set_default_cache(None)
    tlin._STRATEGY_REGISTRY.clear()
    tautotune.reset_structure_trackers()
    tautotune.reset_autotune_stats()
    yield tmp_path
    tcache.set_default_cache(None)
    tlin._STRATEGY_REGISTRY.clear()


def _inputs(pattern, lead=(2, 3), seed=0):
    rng = np.random.default_rng(seed)
    tiles = rng.standard_normal((pattern.n_tiles, pattern.tm, pattern.tk)).astype(np.float32)
    x = rng.standard_normal(lead + (pattern.d_in,)).astype(np.float32)
    return x, tiles


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_patterns_and_hash_match_jax(jx, name):
    """random_pattern gives the reference's coordinates, and pattern_hash
    its bytes (blockpattern-v2): both packages key one structure alike."""
    args = PATTERNS[name]
    want, got = jx.lin.random_pattern(*args), tlin.random_pattern(*args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tlin.pattern_hash(got) == jx.lin.pattern_hash(want)
    # ndarray-carrying and tuple-carrying patterns hash alike, as in the reference
    arr = dataclasses.replace(got, rows=np.asarray(got.rows), cols=np.asarray(got.cols))
    assert tlin.pattern_hash.__wrapped__(arr) == tlin.pattern_hash(got)
    # the pattern's cached hash is its fields' (equal patterns key one plan)
    again = tlin.random_pattern(*args)
    assert again == got and hash(again) == hash(got) == hash(dataclasses.astuple(got))


def test_prune_and_pack_dense_match_jax(jx):
    """prune_dense keeps the reference's blocks and tiles; pack_dense
    extracts the reference's tiles, from a tensor or a numpy array."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((32, 48)).astype(np.float32)
    w[8:16, 16:32] *= 40.0  # a dominant block
    want_p, want_t = jx.lin.prune_dense(w, 8, 16, 0.4)
    got_p, got_t = tlin.prune_dense(w, 8, 16, 0.4)
    assert dataclasses.asdict(got_p) == dataclasses.asdict(want_p)
    np.testing.assert_array_equal(got_t, want_t)
    assert (1, 1) in set(zip(got_p.rows, got_p.cols))
    for pat in (got_p, tlin.random_pattern(32, 48, 8, 16, 0.5, seed=3)):
        want = np.asarray(jx.lin.pack_dense(jx.jnp.asarray(w), pat))
        np.testing.assert_array_equal(tlin.pack_dense(w, pat).numpy(), want)
        np.testing.assert_array_equal(tlin.pack_dense(torch.as_tensor(w), pat).numpy(), want)
    with pytest.raises(ValueError, match="tile-aligned"):
        tlin.random_pattern(30, 48, 8, 16, 0.5)


def test_from_pattern_matches_jax(jx):
    """BlockMatrix.from_pattern: the reference's tables, tiles kept 1:1."""
    pat = tlin.random_pattern(*PATTERNS["oblong"])
    _, tiles = _inputs(pat)
    want = jx.bc.BlockMatrix.from_pattern(pat, jx.jnp.asarray(tiles))
    got = tbc.BlockMatrix.from_pattern(pat, torch.as_tensor(tiles), device=CPU)
    assert got.shape == tuple(want.shape) and got.block == tuple(want.block)
    for field in ("data", "row_indices", "column_indices", "offsets"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)


@pytest.mark.parametrize("strategy", ["grouped", "cuda", "fixed_block", "dia_hybrid"])
@pytest.mark.parametrize("name", ["oblong", "square"])
def test_strategies_match_jax(jx, name, strategy):
    """Each strategy of the port (``cuda`` on K2's plain version: the
    transposed tables, the per-call tile gather and transpose, x^T and y^T)
    against the reference's grouped product and its Pallas path in
    interpret mode; and against the dense product."""
    pat = tlin.random_pattern(*PATTERNS[name])
    x, tiles = _inputs(pat)
    jnp = jx.jnp
    want = np.asarray(jx.jax.jit(lambda x, t: jx.lin.sparse_matmul(x, t, pat))(
        jnp.asarray(x), jnp.asarray(tiles)))
    got = tlin._MATMUL_IMPLS[strategy](torch.as_tensor(x), torch.as_tensor(tiles), pat)
    assert got.shape == x.shape[:-1] + (pat.d_out,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    w = np.zeros((pat.d_in, pat.d_out), np.float64)
    for t, (r, c) in enumerate(zip(pat.rows, pat.cols)):
        w[r * pat.tm:(r + 1) * pat.tm, c * pat.tk:(c + 1) * pat.tk] = tiles[t]
    np.testing.assert_allclose(got.numpy(), x @ w, **TOL)
    if strategy == "cuda":
        pallas = jx.lin.sparse_matmul_pallas(jnp.asarray(x), jnp.asarray(tiles), pat,
                                             interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def test_cuda_tables_are_the_reference_transpose():
    """The cuda strategy's tables, built once per pattern and device: the
    reference's lexsort by (col, row), pattern cols as K2's rows, pattern
    rows as its cols, and row offsets over d_out // tk row tiles."""
    pat = tlin.random_pattern(*PATTERNS["oblong"])
    t = tlin._tables(pat, torch.device(CPU))
    assert tlin._tables(pat, torch.device(CPU)) is t
    order = np.lexsort((np.asarray(pat.rows), np.asarray(pat.cols)))
    np.testing.assert_array_equal(t.order.numpy(), order)
    np.testing.assert_array_equal(t.row_ids.numpy(), np.asarray(pat.cols)[order])
    np.testing.assert_array_equal(t.col_ids.numpy(), np.asarray(pat.rows)[order])
    counts = np.bincount(np.asarray(pat.cols), minlength=pat.d_out // pat.tk)
    np.testing.assert_array_equal(t.row_ptr.numpy(), np.concatenate([[0], np.cumsum(counts)]))
    assert t.schedule(8, torch.float32) is None  # the CPU runs K2's plain version


def test_choose_strategy_on_cpu_is_grouped_without_benchmark(plan_dir):
    """On the CPU the candidate set is grouped alone: no benchmark, the plan
    stored under the torchcpu segment (never the reference's cpu), the
    registry keyed by device; a warm call loads it."""
    pat = tlin.random_pattern(*PATTERNS["reduced-in"])
    h = tlin.pattern_hash(pat)
    assert tlin.choose_matmul_strategy(pat, device=CPU) == "grouped"
    assert tautotune.autotune_stats()["benchmarks"] == 0
    store = tcache.default_cache()
    plan = store.load_plan(tcache.plan_key("linear", h, "torchcpu"))
    assert plan.options.backend == "grouped" and plan.source == "heuristic"
    assert plan.device == "torchcpu" and plan.timings == {}
    assert plan.meta["n_tiles"] == pat.n_tiles and tuple(plan.options.tile) == (16, 16)
    assert not store.has_plan(tcache.plan_key("linear", h, "cpu"))
    assert tlin._STRATEGY_REGISTRY == {f"{h}@torchcpu": "grouped"}
    tlin._STRATEGY_REGISTRY.clear()
    assert tlin.warm_matmul_plans([pat], device=CPU) == {h: "grouped"}
    assert store.stats()["plans"] == 1
    with pytest.raises(ValueError, match="unknown strategy mode"):
        tlin.choose_matmul_strategy(pat, mode="guess", device=CPU)


def test_family_churn_takes_fixed_block_without_caching(plan_dir):
    """A family whose pattern changes every call gets fixed_block after the
    arbiter's first observations, with no plan and no registry entry; a
    static family keeps the staged path (tests/test_sparse_linear.py's
    case)."""
    pats = [tlin.random_pattern(32, 64, 8, 16, 0.5, seed=s) for s in range(8)]
    picks = [tlin.choose_matmul_strategy(p, family="churn", device=CPU) for p in pats]
    assert picks[-1] == "fixed_block"
    n_fixed = picks.count("fixed_block")
    assert tcache.default_cache().stats()["plans"] == len(pats) - n_fixed
    assert len(tlin._STRATEGY_REGISTRY) == len(pats) - n_fixed
    static = [tlin.choose_matmul_strategy(pats[0], family="static", device=CPU)
              for _ in range(8)]
    assert "fixed_block" not in static
    x, tiles = _inputs(pats[1])
    y = tlin.sparse_matmul_auto(torch.as_tensor(x), torch.as_tensor(tiles), pats[1],
                                family="churn")
    np.testing.assert_allclose(
        y.numpy(), tlin.sparse_matmul(torch.as_tensor(x), torch.as_tensor(tiles), pats[1]).numpy(),
        **TOL)


def test_left_out_parts_raise(plan_dir):
    """A mesh must be a named DeviceMesh (anything else is a TypeError); a
    shard's plan sits under its own key; the CUDA default raises without a
    card instead of running on the CPU."""
    pat = tlin.random_pattern(*PATTERNS["oblong"])
    x, tiles = (torch.as_tensor(a) for a in _inputs(pat))
    with pytest.raises(TypeError, match="DeviceMesh"):
        tlin.sparse_matmul_auto(x, tiles, pat, mesh=object())
    assert tlin.choose_matmul_strategy(pat, shard=(0, 2), device=CPU) == "grouped"
    h = tlin.pattern_hash(pat)
    assert (plan_dir / "plans" / f"linear-{h}-torchcpu-s0of2.json").exists()
    assert f"{h}@torchcpu@s0of2" in tlin._STRATEGY_REGISTRY
    with pytest.raises(TypeError, match="DeviceMesh"):
        tlin.warm_matmul_plans([pat], mesh=object(), device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no.*available|none is available"):
            tlin.choose_matmul_strategy(pat)


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #
@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [8, 512])
def test_cuda_strategy_on_card_at_full_width(T, dtype):
    """The cuda strategy (one K2 launch) against grouped and against K2's
    plain version on the same transposed tables, at llama3-8b's FFN `in`
    pattern (896 tiles of 128 x 128, 4096 -> 14336)."""
    dt = getattr(torch, dtype)
    pat = tlin.random_pattern(*PATTERNS["llama3-8b-in"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((T, pat.d_in), generator=gen, device="cuda").to(dt)
    tiles = (torch.randn((pat.n_tiles, pat.tm, pat.tk), generator=gen, device="cuda")
             / 64).to(dt)
    before = kops.launches["bsr_spmm"]
    y = tlin.sparse_matmul_cuda(x, tiles, pat)
    torch.cuda.synchronize()
    assert kops.launches["bsr_spmm"] == before + 1
    t = tlin._tables(pat, x.device)
    tiles_t = tiles.transpose(1, 2)[t.order].contiguous()
    plain = kref.bsr_spmm_ref(tiles_t, t.row_ids, t.col_ids, x.T.contiguous(), pat.d_out).T
    grouped = tlin.sparse_matmul(x.float(), tiles.float(), pat)
    tol = 1e-5 if dt == torch.float32 else 2e-2
    scale = plain.float().abs().max()
    assert (y.float() - plain.float()).abs().max() <= tol * scale
    assert (y.float() - grouped).abs().max() <= max(tol, 1e-5) * scale * (
        1 if dt == torch.float32 else 2)
