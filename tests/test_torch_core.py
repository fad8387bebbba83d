"""PyTorch port, core: VBR, Stage 0 and the tile tables equal the JAX
package's on the same numpy inputs; the port's import and device rules."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro.core import staging as jstaging  # noqa: E402
from repro.core import vbr as jvbr  # noqa: E402
from repro.core.uniformize import uniformize as j_uniformize  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.convert import vbr_from_arrays  # noqa: E402
from repro_torch.core import staging as tstaging  # noqa: E402
from repro_torch.core import vbr as tvbr  # noqa: E402
from repro_torch.core.uniformize import uniformize as t_uniformize  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
STRUCTURE = ("rpntr", "cpntr", "bindx", "bpntrb", "bpntre", "indx")

# (rows, cols, row_splits, col_splits, num_blocks, block_sparsity, uniform, seed)
SYNTH = {
    "synth_nu": (67, 53, 6, 5, 14, 0.25, False, 0),
    "synth_u": (40, 40, 4, 4, 10, 0.0, True, 3),
    "synth_big": (128, 96, 9, 7, 20, 0.3, False, 5),
}
CASES = ["banded", "arrow", "random_block", *SYNTH]
TILES = [(8, 16), (4, 8), (16, 16)]


def _fixture(name):
    with np.load(FIXTURES / f"{name}.npz") as d:
        return {k: d[k] for k in d.files}


def _pair(case):
    """(reference VBR, port VBR) built independently from the same inputs."""
    if case in SYNTH:
        return jvbr.synthesize(*SYNTH[case]), tvbr.synthesize(*SYNTH[case])
    d = _fixture(case)
    fields = {k: d[k] for k in ("shape", *STRUCTURE, "val")}
    ref = jvbr.VBR(**{**fields, "shape": tuple(int(s) for s in d["shape"])})
    return ref, vbr_from_arrays(**fields)


@pytest.mark.parametrize("case", CASES)
def test_structure_and_hash_match_reference(case):
    ref, port = _pair(case)
    assert port.shape == ref.shape
    for f in (*STRUCTURE, "val"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
        assert getattr(port, f).dtype == getattr(ref, f).dtype
    assert tvbr.structure_hash(port) == jvbr.structure_hash(ref)
    if case not in SYNTH:  # the fixtures freeze the hash
        assert tvbr.structure_hash(port) == str(_fixture(case)["structure_hash"])
    np.testing.assert_array_equal(port.to_dense(), ref.to_dense())


@pytest.mark.parametrize("case", CASES)
def test_vbr_from_arrays_roundtrips_a_reference_vbr(case):
    ref, _ = _pair(case)
    port = vbr_from_arrays(**dataclasses.asdict(ref))
    assert tvbr.structure_hash(port) == jvbr.structure_hash(ref)
    np.testing.assert_array_equal(port.to_dense(), ref.to_dense())
    assert [dataclasses.astuple(t) for t in port.blocks()] == [
        dataclasses.astuple(t) for t in ref.blocks()
    ]


def test_paper_generator_matches_reference():
    kw = dict(zeros_pct=20, uniform=False, seed=7, rows=120, cols=100)
    ref, port = jvbr.synthesize_paper(6, 5, 12, **kw), tvbr.synthesize_paper(6, 5, 12, **kw)
    assert tvbr.structure_hash(port) == jvbr.structure_hash(ref)
    np.testing.assert_array_equal(port.val, ref.val)


@pytest.mark.parametrize("kind", ["spmv", "spmm"])
@pytest.mark.parametrize("case", CASES)
def test_inspect_block_matmuls_match_reference(case, kind):
    ref, port = _pair(case)
    n_cols = None if kind == "spmv" else 6
    jd = jstaging._inspect(ref, kind, n_cols)
    td = tstaging._inspect(port, kind, n_cols)
    assert [dataclasses.astuple(d) for d in td] == [dataclasses.astuple(d) for d in jd]


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", CASES)
def test_tiled_pattern_matches_reference(case, tile):
    ref, port = _pair(case)
    tm, tk = tile
    jt = j_uniformize(jstaging._inspect(ref, "spmv", None), *ref.shape,
                      ref.rpntr, ref.cpntr, tm, tk)
    tt = t_uniformize(tstaging._inspect(port, "spmv", None), *port.shape,
                      port.rpntr, port.cpntr, tm, tk)
    for f in ("tm", "tk", "n_tiles", "m_pad", "k_pad", "m", "k"):
        assert getattr(tt, f) == getattr(jt, f), f
    for f in ("row_ids", "col_ids", "val_gather", "x_src", "y_src"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f), err_msg=f)
    assert tt.padded_fraction == jt.padded_fraction

    # row_ptr is the CSR form of the sorted row_ids
    n_rt = tt.m_pad // tm
    assert tt.row_ptr.shape == (n_rt + 1,) and tt.row_ptr.dtype == np.int32
    assert tt.row_ptr[0] == 0 and tt.row_ptr[-1] == tt.n_tiles
    np.testing.assert_array_equal(np.diff(tt.row_ptr), np.bincount(tt.row_ids, minlength=n_rt))
    for r in range(n_rt):
        assert (tt.row_ids[tt.row_ptr[r] : tt.row_ptr[r + 1]] == r).all()
    # the torch form used when a caller passes no row_ptr agrees
    got = tops.row_ptr_from_ids(torch.as_tensor(tt.row_ids), n_rt)
    np.testing.assert_array_equal(got.numpy(), tt.row_ptr)


# ---------------------------------------------------------------------- #
# rules of the port
# ---------------------------------------------------------------------- #
def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    banned = {"jax", "jaxlib", "repro"}
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names if n.split(".")[0] in banned]
    assert not bad, bad


def test_device_none_means_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port = _pair("banded")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstaging.stage_spmv(port)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstaging.stage_spmm(port, 6)
    tiles = np.zeros((1, 8, 8), np.float32)
    ids = np.zeros(1, np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.bsr_spmv(tiles, ids, ids, np.zeros(8, np.float32), m_pad=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.bsr_spmm(tiles, ids, ids, np.zeros((8, 3), np.float32), m_pad=8)
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device("meta") == torch.device("meta")  # shapes alone (launch/specs.py)
    with pytest.raises(ValueError):
        resolve_device("mps")
