"""PyTorch port, the slice as a whole: stage_spmv / stage_spmm on the CPU
device against the JAX package's StagedKernel (Pallas in interpret mode) and
the fixtures' frozen outputs; backends, cache, COO tail, prepack.

The JAX package comes in through the ``jx`` fixture, so that on a GPU
machine without JAX the CUDA test runs and the parity tests skip."""
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch.convert import vbr_from_arrays  # noqa: E402
from repro_torch.core import staging as tstaging  # noqa: E402
from repro_torch.core import vbr as tvbr  # noqa: E402
from repro_torch.core.staging import StagingOptions, stage_spmm, stage_spmv  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "fixtures"
NAMES = ["banded", "arrow", "random_block"]
BACKENDS = ["unrolled", "grouped", "bucketed", "cuda"]
TOL = 2e-4
CPU = "cpu"
requires_cuda = pytest.mark.requires_cuda


@pytest.fixture(autouse=True)
def _card(request):
    """Tests marked requires_cuda skip without a card: decided here, when the
    test runs, so that every worker collects the same tests."""
    if request.node.get_closest_marker("requires_cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the kernels")


@pytest.fixture(scope="module")
def jx():
    """The reference: the JAX package's staging and VBR modules, run on
    JAX's CPU device in full float32 even where JAX also sees a GPU (whose
    default float32 dot is TF32)."""
    jax = pytest.importorskip("jax")
    from repro.core import staging, vbr

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(jnp=jax.numpy, staging=staging, vbr=vbr)


def _fixture(name):
    with np.load(FIXTURES / f"{name}.npz") as d:
        f = {k: d[k] for k in d.files}
    v = vbr_from_arrays(*(f[k] for k in ("shape", "rpntr", "cpntr", "bindx", "bpntrb",
                                         "bpntre", "indx", "val")))
    return v, f


def _jax_kernel(jx, kind, v, tile, n_cols=None):
    """The reference's pallas backend on the same structure (interpret mode)."""
    o = jx.staging.StagingOptions(backend="pallas", tile=tile, spmm_bn=8, interpret=True)
    return jx.staging.StagedKernel(kind, jx.vbr.VBR(**dataclasses.asdict(v)), o, n_cols=n_cols)


def _np(y):
    return y.float().numpy() if isinstance(y, torch.Tensor) else np.asarray(y, np.float32)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", NAMES)
def test_fixture_outputs_frozen(name, backend):
    v, f = _fixture(name)
    opts = StagingOptions(backend=backend, tile=(8, 16), spmm_bn=8)
    y = stage_spmv(v, opts, device=CPU)(f["val"], f["x"])
    ym = stage_spmm(v, f["X"].shape[1], opts, device=CPU)(f["val"], f["X"])
    np.testing.assert_allclose(_np(y), f["y_spmv"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(ym), f["y_spmm"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tile", [(8, 16), (16, 16)], ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_kernel_backend_matches_jax_pallas(jx, name, tile):
    v, f = _fixture(name)
    opts = StagingOptions(backend="cuda", tile=tile, spmm_bn=8)
    n = f["X"].shape[1]
    for kind, x, k in (("spmv", f["x"], stage_spmv(v, opts, device=CPU)),
                       ("spmm", f["X"], stage_spmm(v, n, opts, device=CPU))):
        jk = _jax_kernel(jx, kind, v, tile, n_cols=None if kind == "spmv" else n)
        want = jk(jx.jnp.asarray(v.val), jx.jnp.asarray(x))
        np.testing.assert_allclose(_np(k(v.val, x)), _np(want), rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(k.tiled.val_gather, jk.tiled.val_gather)


def test_paper_generator_slice_matches_jax_pallas(jx):
    """The slice end to end on a small <row,col,blocks,nu> paper matrix."""
    kw = dict(zeros_pct=20, uniform=False, seed=11, rows=128, cols=112)
    v = tvbr.synthesize_paper(12, 10, 40, **kw)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(v.shape[1]).astype(np.float32)
    X = rng.standard_normal((v.shape[1], 20)).astype(np.float32)
    opts = StagingOptions(backend="cuda", tile=(8, 16), spmm_bn=8)
    y = stage_spmv(v, opts, device=CPU)(v.val, x)
    ym = stage_spmm(v, 20, opts, device=CPU)(v.val, X)
    want = _jax_kernel(jx, "spmv", v, (8, 16))(jx.jnp.asarray(v.val), jx.jnp.asarray(x))
    want_m = _jax_kernel(jx, "spmm", v, (8, 16), n_cols=20)(jx.jnp.asarray(v.val),
                                                            jx.jnp.asarray(X))
    np.testing.assert_allclose(_np(y), _np(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(ym), _np(want_m), rtol=TOL, atol=TOL)
    dense = v.to_dense()
    np.testing.assert_allclose(_np(y), dense @ x, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(ym), dense @ X, rtol=TOL, atol=TOL)


def test_cache_hit_on_same_structure_with_new_values():
    tstaging.clear_cache()
    v, f = _fixture("arrow")
    k1 = stage_spmv(v, StagingOptions(backend="cuda", tile=(8, 16)), device=CPU)
    v2 = tvbr.VBR(**{**v.__dict__, "val": v.val * 5.0})
    k2 = stage_spmv(v2, StagingOptions(backend="cuda", tile=(8, 16)), device=CPU)
    assert k1 is k2
    assert tstaging.cache_info() == {"hits": 1, "misses": 1, "size": 1}
    np.testing.assert_allclose(_np(k2(v2.val, f["x"])), 5.0 * f["y_spmv"], rtol=1e-3, atol=1e-3)
    # another tile or kind is another staged function
    stage_spmv(v, StagingOptions(backend="cuda", tile=(4, 8)), device=CPU)
    stage_spmm(v, 3, StagingOptions(backend="cuda", tile=(8, 16)), device=CPU)
    assert tstaging.cache_info()["misses"] == 3
    tstaging.clear_cache()
    assert tstaging.cache_info() == {"hits": 0, "misses": 0, "size": 0}


@pytest.mark.parametrize("backend", ["grouped", "cuda"])
def test_coo_tail_matches_reference(jx, backend):
    v = tvbr.synthesize(96, 80, 8, 6, 18, block_sparsity=0.6, uniform=False, seed=9)
    x = np.random.default_rng(1).standard_normal(v.shape[1]).astype(np.float32)
    X = np.random.default_rng(2).standard_normal((v.shape[1], 5)).astype(np.float32)
    opts = StagingOptions(backend=backend, density_threshold=0.42, tile=(8, 16))
    ks = stage_spmv(v, opts, device=CPU)
    km = stage_spmm(v, 5, opts, device=CPU)
    assert ks.coo is not None and 0 < len(ks.descs) < ks.num_blocks
    jk = jx.staging.StagedKernel(
        "spmv", jx.vbr.VBR(**dataclasses.asdict(v)),
        jx.staging.StagingOptions(backend="grouped", density_threshold=0.42), hints=v.val,
    )
    for a, b in zip(ks.coo, jk.coo):
        np.testing.assert_array_equal(a, b)
    dense = v.to_dense()
    np.testing.assert_allclose(_np(ks(v.val, x)), dense @ x, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(km(v.val, X)), dense @ X, rtol=TOL, atol=TOL)


def test_prepack_matches_reference_pack(jx):
    v, f = _fixture("random_block")
    k = stage_spmv(v, StagingOptions(backend="cuda", tile=(8, 16), prepack=True), device=CPU)
    tiles = k.pack(f["val"])
    jk = _jax_kernel(jx, "spmv", v, (8, 16))
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jk.pack(jx.jnp.asarray(f["val"]))))
    np.testing.assert_allclose(_np(k(tiles, f["x"])), f["y_spmv"], rtol=TOL, atol=TOL)
    km = stage_spmm(v, 6, StagingOptions(backend="cuda", tile=(8, 16), prepack=True), device=CPU)
    np.testing.assert_allclose(_np(km(km.pack(f["val"]), f["X"])), f["y_spmm"], rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="pack"):
        stage_spmv(v, StagingOptions(backend="grouped"), device=CPU).pack(f["val"])


def test_bfloat16_option_and_compile():
    v, f = _fixture("banded")
    k = stage_spmm(v, 6, StagingOptions(backend="cuda", tile=(4, 8), dtype=torch.bfloat16),
                   device=CPU)
    assert k.compile(f["val"], f["X"]) is k and k.compile_time > 0
    assert k.inspection_time == k.stage0_time + k.compile_time
    y = k(f["val"], f["X"])
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y), f["y_spmm"], rtol=6e-2, atol=6e-2)


def test_auto_backend_is_grouped_on_cpu_and_tensors_stay_put():
    v, f = _fixture("banded")
    k = stage_spmv(v, StagingOptions(), device=CPU)
    assert k.backend == "grouped" and k.device == torch.device("cpu")
    y = k(torch.as_tensor(f["val"]), torch.as_tensor(f["x"]))
    np.testing.assert_allclose(_np(y), f["y_spmv"], rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="expected"):
        k(torch.as_tensor(f["val"], device="meta"), f["x"])


@pytest.mark.parametrize("kwargs", [
    dict(shards=2),
    dict(mesh=object()),
])
def test_later_slices_raise_not_implemented(kwargs, tmp_path, monkeypatch):
    """The sharded path is ported: shards= runs the host loop, equal to the
    unsharded call, and mesh= takes a named DeviceMesh alone."""
    from repro_torch.core import cache as tcache

    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))  # the shard plan's record
    monkeypatch.setattr(tcache, "_DEFAULT", None)
    monkeypatch.setattr(tcache, "_DEFAULT_EXPLICIT", False)
    v, f = _fixture("banded")
    if "mesh" in kwargs:
        with pytest.raises(TypeError, match="DeviceMesh"):
            stage_spmv(v, device=CPU, **kwargs)
        with pytest.raises(TypeError, match="DeviceMesh"):
            stage_spmm(v, 6, device=CPU, **kwargs)
        return
    X = f["X"]
    np.testing.assert_allclose(_np(stage_spmv(v, device=CPU, **kwargs)(f["val"], f["x"])),
                               _np(stage_spmv(v, device=CPU)(f["val"], f["x"])),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(stage_spmm(v, 6, device=CPU, **kwargs)(f["val"], X)),
                               _np(stage_spmm(v, 6, device=CPU)(f["val"], X)),
                               rtol=1e-5, atol=1e-5)


def test_unknown_backend_and_prepack_with_coo_tail_raise():
    v, _ = _fixture("banded")
    with pytest.raises(ValueError, match="unknown backend"):
        stage_spmv(v, StagingOptions(backend="pallas"), device=CPU)
    sparse = tvbr.synthesize(64, 64, 8, 8, 12, block_sparsity=0.7, seed=1)
    with pytest.raises(ValueError, match="prepack"):
        stage_spmv(sparse, StagingOptions(backend="cuda", prepack=True, density_threshold=0.5),
                   device=CPU)


@requires_cuda
def test_cuda_main_path_launches_both_kernels():
    from repro_torch.kernels import ops as tops

    v, f = _fixture("random_block")
    opts = StagingOptions(backend="cuda", tile=(8, 16))
    tops.reset_launches()
    y = stage_spmv(v, opts)(f["val"], f["x"])
    ym = stage_spmm(v, 6, opts)(f["val"], f["X"])
    assert tops.launches == {"bsr_spmv": 1, "bsr_spmm": 1, "bsr_sdd": 0}
    np.testing.assert_allclose(y.cpu().numpy(), f["y_spmv"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ym.cpu().numpy(), f["y_spmm"], rtol=TOL, atol=TOL)
