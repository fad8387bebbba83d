"""PyTorch port, structure inspection: ``detect_structure``/``detect_pattern``,
the reblocking proposals and gathers, ``stage_reblocked`` and the DIA-hybrid
SpMV against the JAX package on the same numpy inputs. The numpy results
are held exactly; staged products at rtol = atol = 2e-4 in float32."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch.core import inspect as tinspect  # noqa: E402
from repro_torch.core import reblock as treblock  # noqa: E402
from repro_torch.core import staging as tstaging  # noqa: E402
from repro_torch.core import vbr as tvbr  # noqa: E402
from repro_torch.core.staging import StagingOptions  # noqa: E402
from repro_torch.kernels import dia_hybrid as tdia  # noqa: E402

TOL = 2e-4
CPU = "cpu"


@pytest.fixture(scope="module")
def jx():
    """The reference, on JAX's CPU device in full float32."""
    jax = pytest.importorskip("jax")
    from repro.core import inspect, reblock, staging, vbr
    from repro.kernels import dia_hybrid

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(jnp=jax.numpy, inspect=inspect, reblock=reblock,
                              staging=staging, vbr=vbr, dia_hybrid=dia_hybrid)


@pytest.fixture(autouse=True)
def _fresh():
    tstaging.clear_cache()
    treblock.reset_reblock_stats()
    yield
    tstaging.clear_cache()


def _banded_dense(n, bw, seed):
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, n), np.float32)
    for i in range(n):
        lo, hi = max(0, i - bw), min(n, i + bw + 1)
        dense[i, lo:hi] = rng.standard_normal(hi - lo)
    return dense


def _arrow_dense(n=60, seed=1):
    rng = np.random.default_rng(seed)
    splits = [0, 12, 20, 28, 40, 48, 60]
    dense = np.zeros((n, n), np.float32)
    dense[:12, :] = rng.standard_normal((12, n))
    dense[:, :12] = rng.standard_normal((n, 12))
    for a, b in zip(splits[:-1], splits[1:]):
        dense[a:b, a:b] = rng.standard_normal((b - a, b - a))
    return dense, splits


def _partially_diagonal(n=64, seed=2):
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, n), np.float32)
    for off in (0, -1, 1, n // 8):
        idx = np.arange(max(0, -off), min(n, n - off))
        dense[idx, idx + off] = rng.standard_normal(len(idx))
    nz = rng.integers(0, n, (n // 2, 2))
    dense[nz[:, 0], nz[:, 1]] = rng.standard_normal(len(nz))
    return dense, list(range(0, n + 1, 8))


def _structures():
    """name -> (dense or None, rpntr, cpntr, or a synthesized VBR)."""
    band = _banded_dense(48, 3, 0)
    arrow, asplits = _arrow_dense()
    pdiag, psplits = _partially_diagonal()
    return {
        "misblocked_banded": (band, list(range(0, 49, 2))),
        "wide_band": (_banded_dense(64, 6, 4), list(range(0, 65, 4))),
        "arrow": (arrow, asplits),
        "partially_diagonal": (pdiag, psplits),
        "random_block": tvbr.synthesize(96, 80, 8, 6, 18, 0.3, False, seed=9),
    }


CASES = list(_structures())


def _pair(jx, case):
    s = _structures()[case]
    port = s if isinstance(s, tvbr.VBR) else tvbr.from_dense(s[0], s[1], s[1])
    return port, jx.vbr.VBR(**dataclasses.asdict(port))


@pytest.mark.parametrize("case", CASES)
def test_detect_structure_matches_reference(jx, case):
    port, ref = _pair(jx, case)
    got, want = tinspect.detect_structure(port), jx.inspect.detect_structure(ref)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.wants_dia == want.wants_dia
    for a, b in zip(tinspect.coo_slots(port), jx.inspect.coo_slots(ref)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("grid", ["square", "wide"])
def test_detect_pattern_matches_reference(jx, grid):
    rng = np.random.default_rng(5)
    R, C = (8, 8) if grid == "square" else (6, 10)
    cells = [(r, c) for r in range(R) for c in range(C) if abs(r - c) <= 1 or r == 0]
    cells += [tuple(rng.integers(0, (R, C))) for _ in range(4)]
    rows, cols = (np.asarray(a) for a in zip(*sorted(set(cells))))
    pattern = SimpleNamespace(rows=rows, cols=cols, d_in=R * 16, d_out=C * 8, tm=16, tk=8)
    assert (dataclasses.asdict(tinspect.detect_pattern(pattern))
            == dataclasses.asdict(jx.inspect.detect_pattern(pattern)))


@pytest.mark.parametrize("tile", [(8, 8), (4, 16)], ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", CASES)
def test_reblock_proposals_and_gathers_match_reference(jx, case, tile):
    port, ref = _pair(jx, case)
    got = treblock.propose_reblockings(port, device=CPU, include_aligned=True, tile=tile)
    want = jx.reblock.propose_reblockings(ref, device="cpu", include_aligned=True, tile=tile)
    assert [s.to_dict() for s in got] == [s.to_dict() for s in want]
    for spec, rspec in zip(got, want):
        rv, g = treblock.apply_reblock(port, spec)
        jrv, jg = jx.reblock.apply_reblock(ref, rspec)
        np.testing.assert_array_equal(g, jg)
        assert tvbr.structure_hash(rv) == jx.vbr.structure_hash(jrv) == spec.structure_hash
        np.testing.assert_array_equal(rv.val, jrv.val)


def test_aligned_proposal_is_proposed_on_the_card_at_the_cuda_tile():
    v = tvbr.from_dense(_banded_dense(96, 3, 1), list(range(0, 97, 2)),
                        list(range(0, 97, 2)))
    assert treblock.ALIGNED_TILE == tuple(StagingOptions().tile) == (32, 32)
    on_card = treblock.propose_reblockings(v, device="cuda")
    on_cpu = treblock.propose_reblockings(v, device=CPU)
    assert "aligned32x32" in [s.strategy for s in on_card]
    # the CPU keeps it only where it beats the as-given cost, as the reference
    aligned = [s for s in on_card if s.strategy == "aligned32x32"][0]
    assert ("aligned32x32" in [s.strategy for s in on_cpu]) == (aligned.cost < aligned.base_cost)


@pytest.mark.parametrize("backend", ["grouped", "cuda"])
@pytest.mark.parametrize("case", ["misblocked_banded", "arrow"])
def test_stage_reblocked_matches_reference(jx, case, backend):
    port, ref = _pair(jx, case)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(port.shape[1]).astype(np.float32)
    X = rng.standard_normal((port.shape[1], 5)).astype(np.float32)
    specs = treblock.propose_reblockings(port, device=CPU, include_aligned=True, tile=(8, 8))
    jspecs = jx.reblock.propose_reblockings(ref, device="cpu", include_aligned=True, tile=(8, 8))
    assert specs
    opts = StagingOptions(backend=backend, tile=(8, 8))
    jopts = jx.staging.StagingOptions(backend="grouped")
    dense = port.to_dense()
    for spec, jspec in zip(specs, jspecs):
        for kind, rhs, n in (("spmv", x, None), ("spmm", X, 5)):
            k = treblock.stage_reblocked(port, spec, opts, kind, n_cols=n, device=CPU)
            assert k.backend == backend and k.structure_hash == spec.structure_hash
            jk = jx.reblock.stage_reblocked(ref, jspec, jopts, kind, n_cols=n)
            got = k(port.val, rhs).numpy()
            np.testing.assert_allclose(got, np.asarray(jk(jx.jnp.asarray(ref.val),
                                                          jx.jnp.asarray(rhs))),
                                       rtol=TOL, atol=TOL)
            np.testing.assert_allclose(got, dense @ rhs, rtol=TOL, atol=TOL)
            assert treblock.stage_reblocked(port, spec, opts, kind, n_cols=n, device=CPU) is k


def _dia_table(jx, ref, offsets):
    """The DIA gather table built from the reference's stored slots."""
    rows, cols, vidx = jx.inspect.coo_slots(ref)
    G = np.zeros((len(offsets), ref.shape[0]), np.int64)
    for i, off in enumerate(offsets):
        on = cols - rows == off
        G[i, rows[on]] = vidx[on] + 1
    return G


@pytest.mark.parametrize("offsets", [None, (0, 1, -1)], ids=["detected", "given"])
@pytest.mark.parametrize("case", ["misblocked_banded", "wide_band", "partially_diagonal"])
def test_dia_hybrid_matches_reference(jx, case, offsets):
    port, ref = _pair(jx, case)
    x = np.random.default_rng(4).standard_normal(port.shape[1]).astype(np.float32)
    k = tdia.stage_dia_hybrid(port, offsets=offsets, device=CPU)
    jk = jx.dia_hybrid.stage_dia_hybrid(ref, offsets=offsets)
    assert k.offsets == jk.offsets
    assert (k.num_diagonals, k.remainder_nnz) == (jk.num_diagonals, jk.remainder_nnz)
    G, XI = k.gather_tables
    np.testing.assert_array_equal(G.numpy(), _dia_table(jx, ref, jk.offsets))
    np.testing.assert_array_equal(
        XI.numpy(), np.clip(np.arange(port.shape[0])[None, :] + np.asarray(jk.offsets)[:, None], 0,
                    port.shape[1] - 1))
    got = k(port.val, x).numpy()
    np.testing.assert_allclose(got, np.asarray(jk(jx.jnp.asarray(ref.val), jx.jnp.asarray(x))),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, port.to_dense() @ x, rtol=TOL, atol=TOL)
    if k.remainder_nnz:  # the remainder runs through a staged kernel on the device
        assert k._rem.backend == "grouped" and k._rem.device == torch.device(CPU)


def test_dia_hybrid_refuses_a_structure_without_dense_diagonals():
    v = tvbr.synthesize(96, 80, 8, 6, 18, 0.3, False, seed=9)
    with pytest.raises(ValueError, match="not partially diagonal"):
        tdia.stage_dia_hybrid(v, device=CPU)
    with pytest.raises(ValueError, match="not partially diagonal"):
        tstaging.stage_spmv(v, StagingOptions(backend="dia_hybrid"), device=CPU)


def test_clear_cache_drops_the_reblock_and_dia_memos():
    port = tvbr.from_dense(_banded_dense(48, 3, 0), list(range(0, 49, 2)),
                           list(range(0, 49, 2)))
    spec = treblock.propose_reblockings(port, device=CPU)[0]
    k = treblock.stage_reblocked(port, spec, StagingOptions(backend="grouped"), device=CPU)
    d = tstaging.stage_spmv(port, StagingOptions(backend="dia_hybrid"), device=CPU)
    assert tdia.stage_dia_hybrid(port, opts=StagingOptions(backend="dia_hybrid"),
                                 device=CPU) is d
    tstaging.clear_cache()
    assert treblock.stage_reblocked(port, spec, StagingOptions(backend="grouped"),
                                    device=CPU) is not k
    assert tstaging.stage_spmv(port, StagingOptions(backend="dia_hybrid"), device=CPU) is not d
