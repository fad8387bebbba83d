"""PyTorch port, the generic evaluation path: ``run_vectorized``, the
``gather`` staging backend, ``stage_block_op`` and ``partition_block_rows``
against the JAX package on the same numpy inputs (the JAX side on its CPU
device in full float32, the port on the CPU device)."""
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch.convert import vbr_from_arrays  # noqa: E402
from repro_torch.core import backends as tbackends  # noqa: E402
from repro_torch.core import dsl as tdsl  # noqa: E402
from repro_torch.core import ops_dsl as tops_dsl  # noqa: E402
from repro_torch.core import staging as tstaging  # noqa: E402
from repro_torch.core import vbr as tvbr  # noqa: E402
from repro_torch.core.staging import StagingOptions, stage_spmm, stage_spmv  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "fixtures"
NAMES = ["banded", "arrow", "random_block"]
TOL = 2e-4
CPU = "cpu"


@pytest.fixture(scope="module")
def jx():
    """The reference, on JAX's CPU device in full float32."""
    jax = pytest.importorskip("jax")
    from repro.core import backends, dsl, ops_dsl, staging, vbr

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(jax=jax, jnp=jax.numpy, backends=backends, dsl=dsl,
                              ops_dsl=ops_dsl, staging=staging, vbr=vbr)


def _fixture(name):
    with np.load(FIXTURES / f"{name}.npz") as d:
        f = {k: d[k] for k in d.files}
    v = vbr_from_arrays(*(f[k] for k in ("shape", "rpntr", "cpntr", "bindx", "bpntrb",
                                         "bpntre", "indx", "val")))
    return v, f


def _np(y):
    return y.float().numpy() if isinstance(y, torch.Tensor) else np.asarray(y, np.float32)


# ---------------------------------------------------------------------- #
# run_vectorized
# ---------------------------------------------------------------------- #
def _programs(d, o):
    """The same programs staged in one package's DSL ``d`` / ``o`` (ops_dsl):
    the SpMV and SpMM bodies of one block, and a user op with a plain store
    of an index-valued expression, a scatter-add with duplicate indices
    (i + j) and a division, in two nests."""
    val, x, y = d.ArrayVal("val"), d.ArrayVal("x"), d.ArrayVal("y")
    spmv = d.stage_op(o.spmv_op, d.RepRange(3, 9), d.RepRange(2, 7), o.ArrayView(val, 5), x, y)
    spmm = d.stage_op(o.spmm_op, d.RepRange(1, 6), d.RepRange(0, 4), d.RepRange(0, 3),
                      o.ArrayView(val, 2), x, y)

    def user_op(rr, cr, x, y):
        def anti(i, j):
            y[i + j] += x[j] * x[i] - 2

        def halve(j):
            y[j] += x[j] / 4

        d.loopgen(rr, lambda i: y.__setitem__(i, x[i] * 3 - i))
        d.loopgen(rr, lambda i: d.loopgen(cr, lambda j: anti(i, j)))
        d.loopgen(cr, halve)

    user = d.stage_op(user_op, d.RepRange(1, 5), d.RepRange(2, 6), x, y)
    return {"spmv": spmv, "spmm": spmm, "user": user}


@pytest.mark.parametrize("which", ["spmv", "spmm", "user"])
def test_run_vectorized_matches_reference(jx, which):
    rng = np.random.default_rng(3)
    env = {"val": rng.standard_normal(64).astype(np.float32),
           "x": rng.standard_normal(30).astype(np.float32),
           "y": rng.standard_normal(30).astype(np.float32)}
    port_prog = _programs(tdsl, tops_dsl)[which]
    ref_prog = _programs(jx.dsl, jx.ops_dsl)[which]
    got = tbackends.run_vectorized(port_prog, {k: torch.as_tensor(a) for k, a in env.items()})
    want = jx.backends.run_vectorized(ref_prog, {k: jx.jnp.asarray(a) for k, a in env.items()})
    np.testing.assert_allclose(got["y"].numpy(), np.asarray(want["y"]), rtol=TOL, atol=TOL)
    # functional, as the reference: the input environment is not written
    oracle = {k: a.astype(np.float64) for k, a in env.items()}
    tbackends.run_reference(port_prog, oracle)
    np.testing.assert_allclose(got["y"].numpy(), oracle["y"], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got["x"].numpy(), env["x"])


def test_run_vectorized_leaves_its_input_unwritten():
    y = torch.zeros(30)
    prog = _programs(tdsl, tops_dsl)["user"]
    out = tbackends.run_vectorized(prog, {"val": torch.zeros(1), "x": torch.ones(30), "y": y})
    assert torch.count_nonzero(y) == 0 and torch.count_nonzero(out["y"]) > 0


# ---------------------------------------------------------------------- #
# the gather backend
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", NAMES)
def test_gather_backend_matches_reference_gather(jx, name):
    v, f = _fixture(name)
    n = f["X"].shape[1]
    jv = jx.vbr.VBR(**dataclasses.asdict(v))
    jo = jx.staging.StagingOptions(backend="gather")
    opts = StagingOptions(backend="gather")
    ks, km = stage_spmv(v, opts, device=CPU), stage_spmm(v, n, opts, device=CPU)
    assert ks.backend == km.backend == "gather"
    want = jx.staging.StagedKernel("spmv", jv, jo)(jx.jnp.asarray(f["val"]), jx.jnp.asarray(f["x"]))
    want_m = jx.staging.StagedKernel("spmm", jv, jo, n_cols=n)(jx.jnp.asarray(f["val"]),
                                                               jx.jnp.asarray(f["X"]))
    np.testing.assert_allclose(_np(ks(f["val"], f["x"])), _np(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(km(f["val"], f["X"])), _np(want_m), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(km(f["val"], f["X"])), f["y_spmm"], rtol=TOL, atol=TOL)


def test_gather_backend_takes_bfloat16_and_new_values():
    v, f = _fixture("arrow")
    k = stage_spmv(v, StagingOptions(backend="gather", dtype=torch.bfloat16), device=CPU)
    y = k(f["val"], f["x"])
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y), f["y_spmv"], rtol=6e-2, atol=6e-2)
    k32 = stage_spmv(v, StagingOptions(backend="gather"), device=CPU)
    np.testing.assert_allclose(_np(k32(3 * f["val"], f["x"])), 3 * f["y_spmv"], rtol=1e-3,
                               atol=1e-3)


# ---------------------------------------------------------------------- #
# stage_block_op and partition_block_rows
# ---------------------------------------------------------------------- #
def _scale_rowsum(d):
    def scale_rowsum(r1, r2, blk, x, out):
        def body(i, j):
            out[i] += blk[(j - r2.start) * len(r1) + (i - r1.start)] * x[j]

        d.loopgen(r1, lambda i: d.loopgen(r2, lambda j: body(i, j)))

    return scale_rowsum


@pytest.mark.parametrize("seed", [7, 8])
def test_stage_block_op_scale_rowsum(jx, seed):
    v = tvbr.synthesize(48, 40, 5, 4, 10, 0.3, False, seed=seed)
    x = np.random.default_rng(seed).standard_normal(v.shape[1]).astype(np.float32)
    out0 = np.full(v.shape[0], 0.5, np.float32)
    fn = tstaging.stage_block_op(v, _scale_rowsum(tdsl), extra_arrays=("x",), device=CPU)
    got = fn(v.val, x, out0)
    # a numpy loop over the blocks, in float64
    want = out0.astype(np.float64)
    for t in v.blocks():
        blk = v.val[t.val_offset:t.val_offset + t.size].reshape(t.width, t.height).T
        want[t.row_start:t.row_end] += blk.astype(np.float64) @ x[t.col_start:t.col_end]
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(out0, 0.5)  # the output's start is not written
    jfn = jx.staging.stage_block_op(jx.vbr.VBR(**dataclasses.asdict(v)), _scale_rowsum(jx.dsl))
    ref = jfn(jx.jnp.asarray(v.val), jx.jnp.asarray(x), jx.jnp.asarray(out0))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("workers", [1, 3, 4, 16])
@pytest.mark.parametrize("seed", [6, 11])
def test_partition_block_rows_matches_reference(jx, workers, seed):
    v = tvbr.synthesize(200, 200, 20, 10, 80, 0.3, False, seed=seed)
    assert tstaging.partition_block_rows(v, workers) == jx.staging.partition_block_rows(
        jx.vbr.VBR(**dataclasses.asdict(v)), workers)


def test_dia_hybrid_is_spmv_only_and_unsharded():
    v, _ = _fixture("banded")
    with pytest.raises(ValueError, match="SpMV-only"):
        stage_spmm(v, 6, StagingOptions(backend="dia_hybrid"), device=CPU)
    with pytest.raises(ValueError, match="unsharded"):
        stage_spmv(v, StagingOptions(backend="dia_hybrid"), device=CPU, shards=2)
