"""PyTorch port, kernels K1 (bsr_spmv) and K2 (bsr_spmm): the port's plain
versions against the JAX package's Pallas kernels in interpret mode on the
same tables, and the CUDA kernels against the plain versions on a card.

The JAX package comes in through the ``jx`` fixture, so that on a GPU
machine without JAX the CUDA tests run and the parity tests skip."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # keep deterministic cases running without hypothesis
    from _hypothesis_stub import given, settings, st

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import testing as ttesting  # noqa: E402

# as in tests/test_kernels.py: float32 sums in another order, bfloat16
# inputs (and the Pallas kernel's bfloat16 adds per tile)
TOL = {"float32": 2e-5, "bfloat16": 6e-2}
requires_cuda = pytest.mark.requires_cuda


@pytest.fixture(autouse=True)
def _card(request):
    """Tests marked requires_cuda skip without a card: decided here, when the
    test runs, so that every worker collects the same tests."""
    if request.node.get_closest_marker("requires_cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the kernel")


@pytest.fixture(scope="module")
def jx():
    """The reference: the JAX package's kernel wrappers and numpy oracles,
    run on JAX's CPU device in full float32 even where JAX also sees a GPU
    (whose default float32 dot is TF32)."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ops, ref

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(jnp=jax.numpy, ops=ops, ref=ref)


def _tables(nb, tm, tk, n_rows, n_cols, seed, empty_rows=0):
    """Random sorted tile tables; ``empty_rows`` row tiles get no tile."""
    rng = np.random.default_rng(seed)
    live = rng.permutation(n_rows)[empty_rows:]
    extra = rng.choice(live, max(nb - len(live), 0))
    rows = np.sort(np.concatenate([live, extra])).astype(np.int32)
    cols = rng.integers(0, n_cols, len(rows)).astype(np.int32)
    tiles = rng.standard_normal((len(rows), tm, tk)).astype(np.float32)
    return tiles, rows, cols


def _run_tables(tm, tk, n_cols, seed, pad):
    """``testing.run_tables`` (runs of 1-9 row tiles of one column tile,
    two runs into one row tile, ``pad`` padding tiles past the last row
    tile) with random tiles, the padding ones holding garbage. Returns
    (tiles, rows, cols, n_rows)."""
    rng = np.random.default_rng(seed)
    rows, cols, n_rows = ttesting.run_tables(rng, n_cols, pad)
    tiles = rng.standard_normal((len(rows), tm, tk)).astype(np.float32)
    return tiles, rows, cols, n_rows


def _as(jnp, a, dtype):
    """Both frameworks' view of one numpy array in ``dtype``."""
    j = jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return j, torch.as_tensor(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))


def _close(port, ref, dtype, rows=None):
    port = port.float().numpy()
    ref = np.asarray(ref).astype(np.float32)
    if rows is not None:
        port, ref = port[rows], ref[rows]
    np.testing.assert_allclose(port, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tm,tk", [(8, 8), (8, 16), (16, 8), (5, 3)])
def test_spmv_plain_matches_pallas(jx, tm, tk, dtype):
    n_rows, n_cols = 4, 3
    tiles, rows, cols = _tables(9, tm, tk, n_rows, n_cols, seed=tm + tk)
    x = np.random.default_rng(1).standard_normal(n_cols * tk).astype(np.float32)
    (jt, tt), (jxv, tx) = _as(jx.jnp, tiles, dtype), _as(jx.jnp, x, dtype)
    want = jx.ops.bsr_spmv(jt, rows, cols, jxv, m_pad=n_rows * tm, interpret=True)
    got = tops.bsr_spmv(tt, rows, cols, tx, m_pad=n_rows * tm, device="cpu")
    assert got.dtype == tx.dtype and got.shape == (n_rows * tm,)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tm,tk,n,bn", [(8, 8, 24, 8), (8, 16, 13, 8), (16, 8, 5, 128), (5, 3, 9, 4)])
def test_spmm_plain_matches_pallas(jx, tm, tk, n, bn, dtype):
    n_rows, n_cols = 4, 3
    tiles, rows, cols = _tables(9, tm, tk, n_rows, n_cols, seed=tm * tk)
    x = np.random.default_rng(2).standard_normal((n_cols * tk, n)).astype(np.float32)
    (jt, tt), (jxv, tx) = _as(jx.jnp, tiles, dtype), _as(jx.jnp, x, dtype)
    want = jx.ops.bsr_spmm(jt, rows, cols, jxv, m_pad=n_rows * tm, bn=bn, interpret=True)
    got = tops.bsr_spmm(tt, rows, cols, tx, m_pad=n_rows * tm, bn=bn, device="cpu")
    assert got.dtype == tx.dtype and got.shape == (n_rows * tm, n)
    _close(got, want, dtype)


@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_empty_row_tiles_are_zero(jx, kind):
    """The Pallas kernels leave a row tile they never visit unset; the port
    writes it as zeros. Visited rows match Pallas, all rows match the
    reference's zero-filled oracle."""
    tm, tk, n_rows, n_cols = 8, 16, 6, 3
    tiles, rows, cols = _tables(10, tm, tk, n_rows, n_cols, seed=3, empty_rows=2)
    visited = np.repeat(np.isin(np.arange(n_rows), rows), tm)
    assert not visited.all()
    rng = np.random.default_rng(4)
    if kind == "spmv":
        x = rng.standard_normal(n_cols * tk).astype(np.float32)
        got = tops.bsr_spmv(tiles, rows, cols, x, m_pad=n_rows * tm, device="cpu")
        pallas = jx.ops.bsr_spmv(tiles, rows, cols, x, m_pad=n_rows * tm, interpret=True)
        oracle = jx.ref.bsr_spmv_ref(tiles, rows, cols, x, n_rows * tm)
    else:
        x = rng.standard_normal((n_cols * tk, 11)).astype(np.float32)
        got = tops.bsr_spmm(tiles, rows, cols, x, m_pad=n_rows * tm, bn=8, device="cpu")
        pallas = jx.ops.bsr_spmm(tiles, rows, cols, x, m_pad=n_rows * tm, bn=8, interpret=True)
        oracle = jx.ref.bsr_spmm_ref(tiles, rows, cols, x, n_rows * tm)
    _close(got, pallas, "float32", rows=visited)
    _close(got, oracle, "float32")
    assert (got[~torch.as_tensor(visited)] == 0).all()


@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_padding_tiles_past_the_last_row_tile_are_dropped(jx, kind):
    """Tiles whose row tile lies past m_pad // tm (BlockMatrix's padding,
    here with garbage data) add nothing: the kernels' row offsets end before
    them. The reference's oracle gives the same rows with one more row tile
    for them, which dsd slices off."""
    tm, tk, n_cols = 8, 16, 4
    tiles, rows, cols, n_rows = _run_tables(tm, tk, n_cols, seed=8, pad=3)
    rng = np.random.default_rng(9)
    m_pad = n_rows * tm
    if kind == "spmv":
        x = rng.standard_normal(n_cols * tk).astype(np.float32)
        got = tops.bsr_spmv(tiles, rows, cols, x, m_pad=m_pad, device="cpu")
        want = jx.ref.bsr_spmv_ref(tiles, rows, cols, x, m_pad + tm)[:m_pad]
    else:
        x = rng.standard_normal((n_cols * tk, 11)).astype(np.float32)
        got = tops.bsr_spmm(tiles, rows, cols, x, m_pad=m_pad, bn=8, device="cpu")
        want = jx.ref.bsr_spmm_ref(tiles, rows, cols, x, m_pad + tm)[:m_pad]
    assert got.shape[0] == m_pad
    _close(got, want, "float32")


@settings(max_examples=10, deadline=None)
@given(
    nb=st.integers(1, 12),
    tm=st.integers(1, 16),
    tk=st.integers(1, 16),
    n_rows=st.integers(1, 5),
    n_cols=st.integers(1, 4),
    n=st.integers(1, 17),
    seed=st.integers(0, 99),
)
def test_plain_versions_match_reference_oracle(jx, nb, tm, tk, n_rows, n_cols, n, seed):
    tiles, rows, cols = _tables(nb, tm, tk, n_rows, n_cols, seed, empty_rows=seed % n_rows)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal(n_cols * tk).astype(np.float32)
    xm = rng.standard_normal((n_cols * tk, n)).astype(np.float32)
    m_pad = n_rows * tm
    _close(tops.bsr_spmv(tiles, rows, cols, x, m_pad=m_pad, device="cpu"),
           jx.ref.bsr_spmv_ref(tiles, rows, cols, x, m_pad), "float32")
    _close(tops.bsr_spmm(tiles, rows, cols, xm, m_pad=m_pad, device="cpu"),
           jx.ref.bsr_spmm_ref(tiles, rows, cols, xm, m_pad), "float32")


def test_wrappers_reject_what_the_kernels_do_not_take():
    tiles, rows, cols = _tables(4, 8, 8, 2, 2, seed=0)
    x = np.zeros(16, np.float32)
    with pytest.raises(TypeError):  # dtypes differ
        tops.bsr_spmv(tiles, rows, cols, x.astype(np.float64), m_pad=16, device="cpu")
    with pytest.raises(TypeError):  # float16 is not taken
        tops.bsr_spmv(tiles.astype(np.float16), rows, cols, x.astype(np.float16),
                      m_pad=16, device="cpu")
    with pytest.raises(ValueError):  # m_pad not a multiple of tm
        tops.bsr_spmv(tiles, rows, cols, x, m_pad=12, device="cpu")
    with pytest.raises(ValueError):  # x is not a whole number of k tiles
        tops.bsr_spmv(tiles, rows, cols, x[:15], m_pad=16, device="cpu")
    with pytest.raises(ValueError):  # col_ids of another length
        tops.bsr_spmv(tiles, rows, cols[:3], x, m_pad=16, device="cpu")
    with pytest.raises(ValueError):  # spmm wants a 2-D x
        tops.bsr_spmm(tiles, rows, cols, x, m_pad=16, device="cpu")
    with pytest.raises(ValueError):  # non-contiguous operand
        tops.bsr_spmm(tiles, rows, cols, torch.zeros(4, 16).T, m_pad=16, device="cpu")


def _cuda_case(dtype, seed):
    tiles, rows, cols = _tables(60, 16, 16, 23, 9, seed=seed, empty_rows=4)
    dev = torch.device("cuda")
    t = torch.as_tensor(tiles, device=dev).to(dtype)
    r, c = torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)
    return t, r, c, dev


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bsr_spmv_matches_plain(dtype):
    t, r, c, dev = _cuda_case(getattr(torch, dtype), seed=5)
    x = torch.randn(9 * 16, device=dev).to(t.dtype)
    before = tops.launches["bsr_spmv"]
    y = tops.bsr_spmv(t, r, c, x, m_pad=23 * 16, device=dev)
    torch.cuda.synchronize()
    assert tops.launches["bsr_spmv"] == before + 1
    ref = tref.bsr_spmv_ref(t, r, c, x, 23 * 16)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert ((y.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= tol


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bsr_spmm_matches_plain(dtype):
    t, r, c, dev = _cuda_case(getattr(torch, dtype), seed=6)
    x = torch.randn(9 * 16, 100, device=dev).to(t.dtype)  # n not a multiple of bn
    before = tops.launches["bsr_spmm"]
    y = tops.bsr_spmm(t, r, c, x, m_pad=23 * 16, bn=128, device=dev)
    torch.cuda.synchronize()
    assert tops.launches["bsr_spmm"] == before + 1
    ref = tref.bsr_spmm_ref(t, r, c, x, 23 * 16)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert ((y.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= tol


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tm,tk,n", [
    (8, 1536, 200),  # the MoE's dsd tiles; n past one 128-column chunk, ragged
    (8, 40, 136),
    (16, 24, 100),
    (32, 32, 128),  # the first path's tiles: a panel of 2 row tiles
    (5, 16, 72),  # 12 row tiles of 5 rows to a 64-row panel
    (5, 7, 33),  # nothing 16-byte aligned
    (40, 24, 100),  # one row tile of 40 rows to a CTA
    (100, 16, 72),  # two CTAs to a row tile, the second over its last 36 rows
])
def test_cuda_bsr_spmm_runs_match_plain(tm, tk, n, dtype):
    """K2 on run-structured tables (runs of 1-9 tiles of one column tile,
    runs across panels, two runs into one row tile, empty row tiles,
    padding tiles past the last row tile) against its plain version."""
    tiles, rows, cols, n_rows = _run_tables(tm, tk, 9, seed=tm * tk + n, pad=5)
    dev = torch.device("cuda")
    t = torch.as_tensor(tiles, device=dev).to(getattr(torch, dtype))
    r, c = torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)
    x = torch.randn(9 * tk, n, device=dev).to(t.dtype)
    before = tops.launches["bsr_spmm"]
    y = tops.bsr_spmm(t, r, c, x, m_pad=n_rows * tm, device=dev)
    torch.cuda.synchronize()
    assert tops.launches["bsr_spmm"] == before + 1
    ref = tref.bsr_spmm_ref(t, r, c, x, n_rows * tm)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert ((y.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= tol


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tm,tk", [(8, 1536), (8, 40), (16, 24), (32, 32), (5, 16), (5, 7),
                                   (40, 24), (100, 16)])
def test_cuda_bsr_spmv_runs_match_plain(tm, tk, dtype):
    """K1 on the run-structured tables of the K2 cases above: rows longer
    than one pass of the lanes (tk = 1536), rows that are not whole 16-byte
    vectors, tiles taller than a worker's rows, padding tiles past the last
    row tile."""
    tiles, rows, cols, n_rows = _run_tables(tm, tk, 9, seed=tm * tk + 1, pad=5)
    dev = torch.device("cuda")
    t = torch.as_tensor(tiles, device=dev).to(getattr(torch, dtype))
    r, c = torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)
    x = torch.randn(9 * tk, device=dev).to(t.dtype)
    y = tops.bsr_spmv(t, r, c, x, m_pad=n_rows * tm, device=dev)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert _rel_err(y, tref.bsr_spmv_ref(t, r, c, x, n_rows * tm)) <= tol


def _rel_err(y, ref):
    return ((y.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ttesting.SKEWED)
def test_cuda_skewed_tables_match_plain(kind, dtype):
    """K1 and K2 on tables that stress the card's even split of the tile
    table: a row tile with 90% of the tiles, fewer tiles than workers (a row
    tile spread over more workers than it has tiles), one tile, and long runs
    of empty row tiles."""
    rng = np.random.default_rng(11)
    rows, cols, n_rows = ttesting.skewed_tables(rng, kind, 9)
    dev = torch.device("cuda")
    tm, tk, n = 32, 32, 100
    t = torch.as_tensor(rng.standard_normal((len(rows), tm, tk)), device=dev)
    t = t.to(getattr(torch, dtype))
    r, c = torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)
    x = torch.randn(9 * tk, device=dev).to(t.dtype)
    xm = torch.randn(9 * tk, n, device=dev).to(t.dtype)
    y = tops.bsr_spmv(t, r, c, x, m_pad=n_rows * tm, device=dev)
    ym = tops.bsr_spmm(t, r, c, xm, m_pad=n_rows * tm, device=dev)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert _rel_err(y, tref.bsr_spmv_ref(t, r, c, x, n_rows * tm)) <= tol
    assert _rel_err(ym, tref.bsr_spmm_ref(t, r, c, xm, n_rows * tm)) <= tol


@requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["u", "nu"])
def test_cuda_paper_tables_match_plain(name, dtype):
    """K1 and K2 at the paper's matrices <50,50,500,u> and <100,100,500,nu>
    (10 000 x 10 000, 20% in-block zeros), tile 32 x 32, with the schedule
    the staged path builds once."""
    from repro_torch.core import StagingOptions, stage_spmv, synthesize_paper

    v = synthesize_paper(50 if name == "u" else 100, 50 if name == "u" else 100, 500,
                         zeros_pct=20, uniform=name == "u", seed=0)
    dev = torch.device("cuda")
    ks = stage_spmv(v, StagingOptions(backend="cuda", dtype=getattr(torch, dtype)), device=dev)
    t = ks.tiled
    tiles = ks.pack(torch.as_tensor(v.val, device=dev))
    r, c = torch.as_tensor(t.row_ids, device=dev), torch.as_tensor(t.col_ids, device=dev)
    rp = torch.as_tensor(t.row_ptr, device=dev)
    x = torch.randn(t.k_pad, device=dev).to(tiles.dtype)
    xm = torch.randn(t.k_pad, 128, device=dev).to(tiles.dtype)
    y = tops.bsr_spmv(tiles, r, c, x, m_pad=t.m_pad, row_ptr=rp,
                      schedule=tops.bsr_schedule("spmv", rp, t.tm, t.tk, dtype=tiles.dtype),
                      device=dev)
    ym = tops.bsr_spmm(tiles, r, c, xm, m_pad=t.m_pad, row_ptr=rp,
                       schedule=tops.bsr_schedule("spmm", rp, t.tm, t.tk, 128, tiles.dtype),
                       device=dev)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert _rel_err(y, tref.bsr_spmv_ref(tiles, r, c, x, t.m_pad)) <= tol
    assert _rel_err(ym, tref.bsr_spmm_ref(tiles, r, c, xm, t.m_pad)) <= tol


@requires_cuda
@pytest.mark.parametrize("kind", ["heavy", "few", "random"])
def test_cuda_float32_launches_are_bit_identical(kind):
    """Row tiles cut by the split are added in worker order, with no atomics:
    two launches on the same inputs give the same bits."""
    rng = np.random.default_rng(12)
    if kind == "random":
        tiles, rows, cols = _tables(60, 32, 32, 23, 9, seed=13, empty_rows=4)
        n_rows = 23
    else:
        rows, cols, n_rows = ttesting.skewed_tables(rng, kind, 9)
        tiles = rng.standard_normal((len(rows), 32, 32)).astype(np.float32)
    dev = torch.device("cuda")
    t = torch.as_tensor(tiles, device=dev)
    r, c = torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)
    x = torch.randn(9 * 32, device=dev)
    xm = torch.randn(9 * 32, 128, device=dev)
    m_pad = n_rows * 32
    ys = [tops.bsr_spmv(t, r, c, x, m_pad=m_pad, device=dev) for _ in range(2)]
    yms = [tops.bsr_spmm(t, r, c, xm, m_pad=m_pad, device=dev) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1]) and torch.equal(yms[0], yms[1])


# ---------------------------------------------------------------------- #
# K3 (bsr_sdd) in float32: 3xTF32 on the tensor cores
# ---------------------------------------------------------------------- #
def _sdd_case(bm, bn, K, seed, n_cb=7, pad=3):
    """K3's operands in float32 on the card: slots from ``testing.run_slots``
    (runs of 1-9 slots of one column block in shuffled order, so that some
    cross a CTA's group of 64 / bm slots; then ``pad`` padding slots whose
    column is out of range), a (Rb * bm, K) and the expert stack w (n_cb, K,
    bn) as its strided block-column view. Returns (a, b, rows, cols)."""
    rows, cols, n_rb = ttesting.run_slots(np.random.default_rng(seed), n_cb, pad)
    rng = np.random.default_rng(seed + 1)
    dev = torch.device("cuda")
    a = torch.as_tensor(rng.standard_normal((n_rb * bm, K), dtype=np.float32), device=dev)
    w = torch.as_tensor(rng.standard_normal((n_cb, K, bn), dtype=np.float32), device=dev)
    r, c = torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)
    return a, w.permute(1, 0, 2), r, c


def _shifted(a):
    """A copy of ``a`` that starts 4 bytes past a 16-byte boundary, which
    sends K3 to its scalar body."""
    return torch.cat([a.new_zeros(1), a.reshape(-1)])[1:].view(a.shape)


def _sdd_check(a, b, r, c, bm, bn, pad=3):
    """K3 against its plain version at 1e-5 of max|ref|; the padding blocks
    must be zeros. Returns K3's output."""
    before = tops.launches["bsr_sdd"]
    got = tops.bsr_sdd(a, b, r, c, bm=bm, bn=bn)
    torch.cuda.synchronize()
    assert tops.launches["bsr_sdd"] == before + 1
    assert _rel_err(got, tref.bsr_sdd_ref(a, b, r, c, bm, bn)) <= 1e-5
    assert not got[-pad:].any()
    return got


@requires_cuda
@pytest.mark.parametrize("bn,K", [(200, 44), (72, 12)])  # bn past 128, ragged; K not 32-deep
@pytest.mark.parametrize("bm", [1, 5, 8, 16, 24, 40, 100])
def test_cuda_sdd_float32_bodies_match_plain(bm, bn, K):
    """Both float32 bodies on run-structured slots, padding included: 64
    slots of one row to a CTA (bm = 1), groups of 12, 8, 4 and 2 slots, one
    slot of 40 rows to a CTA, and two CTAs to a slot of 100; the scalar body
    on the same values in a shifted copy of a."""
    a, b, r, c = _sdd_case(bm, bn, K, seed=bm * bn + K)
    for a_in, body in ((a, "cp.async"), (_shifted(a), "scalar")):
        assert tops.sdd_body(a_in, b) == body
        _sdd_check(a_in, b, r, c, bm, bn)


@requires_cuda
def test_cuda_sdd_float32_moe_depth_is_bit_identical():
    """The MoE's blocks (bm 8, bn 1536) at its depth K = 5120, where one TF32
    product would miss 1e-5, on the cp.async body; a second launch gives the
    same bits, and the stacked (K, N) layout the same values."""
    bm, bn, K = 8, 1536, 5120
    a, b, r, c = _sdd_case(bm, bn, K, seed=3)
    assert tops.sdd_body(a, b) == "cp.async"
    first = _sdd_check(a, b, r, c, bm, bn)
    assert torch.equal(first, tops.bsr_sdd(a, b, r, c, bm=bm, bn=bn))
    stacked = b.reshape(K, -1)  # a copy: the contiguous (K, 7 * bn) matrix
    assert _rel_err(tops.bsr_sdd(a, stacked, r, c, bm=bm, bn=bn), first) <= 1e-5


@requires_cuda
@pytest.mark.parametrize("case", ["K45", "a_shifted"])
def test_cuda_sdd_float32_unaligned_takes_scalar_body(case):
    """Operands the cp.async body cannot copy (K not whole 16-byte vectors,
    or a 4 bytes past a 16-byte boundary) take the scalar body, and the
    binding refuses the cp.async body for them."""
    from repro_torch.kernels._build import load_kernels

    bm, bn, K = 8, 200, 45 if case == "K45" else 64
    a, b, r, c = _sdd_case(bm, bn, K, seed=21)
    if case == "a_shifted":
        a = _shifted(a)
    assert tops.sdd_body(a, b) == "scalar"
    got = _sdd_check(a, b, r, c, bm, bn)
    with pytest.raises(RuntimeError, match="cp.async"):
        load_kernels().bsr_sdd(a, b, r, c, torch.empty_like(got), True)
