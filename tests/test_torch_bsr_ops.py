"""PyTorch port, the fixed-block family: ``BlockMatrix`` and dsd/dds/sdd
against the JAX package (``repro.sparse.block_csr``, ``repro.kernels.bsr_ops``)
and dense numpy on the same numpy inputs, the plain version of K3
(``bsr_sdd_ref``) against ``_sdd_pallas`` in interpret mode, and K3 against
its plain version on a card.

The JAX package comes in through the ``jx`` fixture, so that on a GPU
machine without JAX the CUDA tests run and the parity tests skip."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch.kernels import bsr_ops as tops  # noqa: E402
from repro_torch.kernels import ops as tkops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import testing as ttesting  # noqa: E402
from repro_torch.sparse import block_csr as tbc  # noqa: E402
from test_torch_linear import _sealed_reference_plans  # noqa: E402,F401 (autouse)

# float32 throughout, as tests/test_bsr_ops.py: the same products summed in
# another order agree to 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)
# bfloat16 inputs on the card: the outputs round to bfloat16 (8 bits of
# mantissa)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
CPU = "cpu"
requires_cuda = pytest.mark.requires_cuda


@pytest.fixture(autouse=True)
def _card(request):
    """Tests marked requires_cuda skip without a card: decided here, when the
    test runs, so that every worker collects the same tests."""
    if request.node.get_closest_marker("requires_cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the kernel")


def _summary(sp):
    """A BlockMatrix's arrays and what derives from them, in either package."""
    return (sp.data, sp.row_indices, sp.column_indices, sp.offsets, sp.valid, sp.n_blocks,
            sp.density(), sp.block_mask(), sp.to_dense(), sp.topology().data)


def _run_op(op, fn_pkg, sp, dense, **kw):
    if op == "dsd":
        return fn_pkg.dsd(sp, dense[0], **kw)
    if op == "dds":
        return fn_pkg.dds(dense[0], sp, **kw)
    return fn_pkg.sdd(dense[0], dense[1], sp.topology(), **kw).data


@pytest.fixture(scope="module")
def jx():
    """The reference: the JAX package's BlockMatrix and op family, run on
    JAX's CPU device in full float32 even where JAX also sees a GPU. Each
    reference computation is one jitted function, compiled once per shape
    (eager JAX compiles every primitive on its own and takes seconds)."""
    jax = pytest.importorskip("jax")
    from repro.kernels import bsr_ops
    from repro.sparse import block_csr

    BM = block_csr.BlockMatrix

    def from_mask(mask, data, block, nnz_max):
        sp = BM.from_mask(mask, block, data=data, nnz_max=nnz_max)
        return _summary(sp), _summary(sp.transpose())

    def from_dense(x, block, nnz_max, data, rows, cols):
        return (_summary(BM.from_dense(x, block, nnz_max=nnz_max)),
                block_csr.mask_from_dense(x, block),
                _summary(BM.from_coo(x.shape, block, data, rows, cols)))

    def op_grouped(op, mask, data, nnz_max, block, *dense):
        sp = BM.from_mask(mask, block, data=data, nnz_max=nnz_max)
        return _run_op(op, bsr_ops, sp, dense, backend="grouped")

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(
            jnp=jax.numpy, bc=block_csr, ops=bsr_ops,
            from_mask=jax.jit(from_mask, static_argnums=(2, 3)),
            from_dense=jax.jit(from_dense, static_argnums=(1, 2)),  # and from_coo
            op_grouped=jax.jit(op_grouped, static_argnums=(0, 3, 4)),
        )


def _mask_case(name):
    """(mask, nnz_max) for the named constructor case. All share one shape
    and one nnz_max, so the reference compiles once for them."""
    rng = np.random.default_rng(7)
    mask = {
        "padded": rng.random((4, 5)) < 0.45,  # 7 blocks in 12 slots
        "truncated": rng.random((4, 5)) < 0.8,  # 18 blocks: the last 6 cut off
        "empty": np.zeros((4, 5), bool),
        "single": np.eye(4, 5, 2, dtype=bool) & (np.arange(4) == 1)[:, None],
    }[name]
    return mask, 12


def _same(j, t):
    """Equal summaries; the index tensors are int32 as the reference's."""
    names = ("data", "row_indices", "column_indices", "offsets", "valid", "n_blocks",
             "density", "block_mask", "to_dense", "topology")
    for name, a, b in zip(names, j, t):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-7, atol=0,
                                   err_msg=name)
    assert t[1].dtype == t[2].dtype == t[3].dtype == torch.int32


def _both_from_mask(jx, case, block=(2, 3)):
    """The reference's summaries of from_mask and its transpose, and the
    port's BlockMatrix, from garbage data at padding slots (which from_mask
    must zero)."""
    mask, nnz_max = _mask_case(case)
    n_slots = max(int(mask.size if nnz_max is None else nnz_max), 1)
    data = np.random.default_rng(0).standard_normal((n_slots,) + block).astype(np.float32)
    j = jx.from_mask(jx.jnp.asarray(mask), jx.jnp.asarray(data), block, nnz_max)
    sp = tbc.BlockMatrix.from_mask(mask, block, data=data, nnz_max=nnz_max, device=CPU)
    return j, sp


@pytest.mark.parametrize("case", ["padded", "truncated", "empty", "single"])
def test_from_mask_matches_jax(jx, case):
    j, sp = _both_from_mask(jx, case)
    assert sp.shape == (sp.n_block_rows * 2, sp.n_block_cols * 3) and sp.block == (2, 3)
    _same(j[0], _summary(sp))
    new = np.full(tuple(sp.data.shape), 3.0, np.float32)
    np.testing.assert_array_equal(sp.with_data(torch.as_tensor(new)).data.numpy(),
                                  np.where(np.asarray(j[0][4])[:, None, None], new, 0.0))


@pytest.mark.parametrize("case", ["padded", "truncated", "empty", "single"])
def test_transpose_matches_jax(jx, case):
    """Slot order after the stable sort, offsets and data; the dense
    transpose; and back again to the same slots (the offsets of a truncated
    mask count its cut-off cells, those of a transpose only its slots)."""
    j, sp = _both_from_mask(jx, case)
    _same(j[1], _summary(sp.transpose()))
    np.testing.assert_array_equal(sp.transpose().to_dense().numpy(), sp.to_dense().numpy().T)
    back = sp.transpose().transpose()
    for f in ("data", "row_indices", "column_indices"):
        np.testing.assert_array_equal(getattr(back, f).numpy(), getattr(sp, f).numpy())


def test_from_dense_from_coo_and_masks_match_jax(jx):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 12)).astype(np.float32)
    x[0:2, :] = 0.0  # an empty block row
    x[4:6, 3:9] = 0.0  # two empty blocks
    # from_coo: sorted rows with two padding slots carrying garbage data
    rows = np.array([0, 0, 2, 3, 4, 4], np.int32)
    cols = np.array([1, 3, 0, 2, 0, 0], np.int32)
    data = rng.standard_normal((6, 2, 3)).astype(np.float32)
    # from_dense: 10 blocks in 12 slots
    j_dense, j_mask, j_coo = jx.from_dense(jx.jnp.asarray(x), (2, 3), 12, data, rows, cols)
    _same(j_dense, _summary(tbc.BlockMatrix.from_dense(x, (2, 3), nnz_max=12, device=CPU)))
    mask = tbc.mask_from_dense(torch.as_tensor(x), (2, 3))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    _same(j_coo, _summary(tbc.BlockMatrix.from_coo((8, 12), (2, 3), data, rows, cols,
                                                   device=CPU)))
    topo = tbc.topology_from_mask(mask, (2, 3), nnz_max=12, device=CPU)
    sp = tbc.BlockMatrix.from_mask(mask, (2, 3), nnz_max=12, device=CPU)
    for a, b in zip(_summary(topo), _summary(sp)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------- #
# the op family
# ---------------------------------------------------------------------- #
def _op_inputs(op, rng, mask, bm, bn, pad):
    """(sparse operand's data, dense operands) for ``op`` over ``mask``."""
    R, C = mask.shape
    n_slots = max(int(mask.sum()) + pad, 1)
    data = rng.standard_normal((n_slots, bm, bn)).astype(np.float32)
    if op == "dsd":
        dense = (rng.standard_normal((C * bn, 5)).astype(np.float32),)
    elif op == "dds":
        dense = (rng.standard_normal((5, R * bm)).astype(np.float32),)
    else:
        dense = (rng.standard_normal((R * bm, 6)).astype(np.float32),
                 rng.standard_normal((6, C * bn)).astype(np.float32))
    return data, n_slots, dense


def _dense_ref(op, sp_dense, dense, sp_t):
    """Dense numpy result: the product, or for sdd the product's blocks at
    the topology's valid slots (zero at padding)."""
    if op == "dsd":
        return sp_dense @ dense[0]
    if op == "dds":
        return dense[0] @ sp_dense
    full = dense[0] @ dense[1]
    bm, bn = sp_t.block
    out = np.zeros(tuple(sp_t.data.shape), np.float32)
    for i, (r, c) in enumerate(zip(sp_t.row_indices.tolist(), sp_t.column_indices.tolist())):
        if r < sp_t.n_block_rows:
            out[i] = full[r * bm:(r + 1) * bm, c * bn:(c + 1) * bn]
    return out


@pytest.mark.parametrize("backend", ["grouped", "cuda"])
@pytest.mark.parametrize("op", ["dsd", "dds", "sdd"])
def test_op_matches_jax_grouped_and_dense(jx, op, backend):
    """On the CPU the 'cuda' backend runs its glue (padding row, clamped
    coordinates, transpose for dds) around the kernels' plain versions."""
    rng = np.random.default_rng(11)
    mask = rng.random((3, 4)) < 0.5
    data, n_slots, dense = _op_inputs(op, rng, mask, 4, 8, pad=3)
    sp_t = tbc.BlockMatrix.from_mask(mask, (4, 8), data=data, nnz_max=n_slots, device=CPU)
    want = np.asarray(jx.op_grouped(op, mask, data, n_slots, (4, 8), *dense))
    got = _run_op(op, tops, sp_t, [torch.as_tensor(d) for d in dense], backend=backend)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), _dense_ref(op, sp_t.to_dense().numpy(), dense, sp_t),
                               **TOL)


@pytest.mark.parametrize("bm,bn,K", [
    (8, 16, 24),  # one K step
    (4, 8, 768),  # K tiled by 256 in the Pallas kernel: 3 steps
])
def test_sdd_plain_matches_pallas_interpret(jx, bm, bn, K):
    """bsr_sdd_ref against _sdd_pallas on a 4 x 4 block grid, padding slots
    included (clamped coordinates, as _sdd_impl passes them)."""
    rng = np.random.default_rng(bm + K)
    Rb = Cb = 4
    rows = np.array([0, 0, 1, 3, 3, 3, 3], np.int32)  # the last two: clamped padding
    cols = np.array([1, 2, 0, 0, 3, 0, 0], np.int32)
    a = rng.standard_normal((Rb * bm, K)).astype(np.float32)
    b = rng.standard_normal((K, Cb * bn)).astype(np.float32)
    want = np.asarray(jx.ops._sdd_pallas(jx.jnp.asarray(a), jx.jnp.asarray(b),
                                         jx.jnp.asarray(rows), jx.jnp.asarray(cols),
                                         bm=bm, bn=bn, interpret=True))
    got = tkops.bsr_sdd(torch.as_tensor(a), torch.as_tensor(b), rows, cols, bm=bm, bn=bn,
                        device=CPU)
    assert got.dtype == torch.float32 and tuple(got.shape) == (7, bm, bn)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("bm,bn,K", [(8, 16, 24), (4, 8, 768)])
def test_sdd_padding_slots_are_zero_blocks_unclamped(jx, bm, bn, K):
    """K3's padding contract: a slot whose row block lies past ``a``
    (row == Rb, as BlockMatrix pads) is a zero block whatever its column,
    without clamping. The reference clamps such slots, computes them with
    _sdd_pallas and zeroes them in _sdd_impl; the valid slots agree."""
    rng = np.random.default_rng(bm + K)
    Rb = Cb = 4
    rows = np.array([0, 0, 1, 3, 4, 4, 4], np.int32)  # the last three: padding
    cols = np.array([1, 2, 0, 0, 0, Cb + 9, -3], np.int32)  # never read for padding
    a = rng.standard_normal((Rb * bm, K)).astype(np.float32)
    b = rng.standard_normal((K, Cb * bn)).astype(np.float32)
    valid = rows < Rb
    want = np.asarray(jx.ops._sdd_pallas(
        jx.jnp.asarray(a), jx.jnp.asarray(b), jx.jnp.asarray(np.minimum(rows, Rb - 1)),
        jx.jnp.asarray(np.where(valid, cols, 0)), bm=bm, bn=bn, interpret=True))
    want = np.where(valid[:, None, None], want, 0.0)
    got = tkops.bsr_sdd(torch.as_tensor(a), torch.as_tensor(b), rows, cols, bm=bm, bn=bn,
                        device=CPU)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[~torch.as_tensor(valid)].any()


def test_dsd_cuda_glue_calls_k2_with_m_pad_m(jx):
    """dsd's cuda backend hands K2 the BlockMatrix's own tables with m_pad =
    M: the padding slots (row == Rb, here with garbage data) lie past the
    row offsets of the Rb real row tiles and add nothing. Held against the
    reference's dsd, which scatters them into an extra row it slices off."""
    rng = np.random.default_rng(11)
    mask = rng.random((3, 4)) < 0.5
    data, n_slots, dense = _op_inputs("dsd", rng, mask, 4, 8, pad=3)
    sp = tbc.BlockMatrix.from_mask(mask, (4, 8), data=data, nnz_max=n_slots, device=CPU)
    junk = torch.where(sp.valid[:, None, None], sp.data, 7.0)  # padding slots' data
    want = np.asarray(jx.op_grouped("dsd", mask, data, n_slots, (4, 8), *dense))
    got = tkops.bsr_spmm(junk, sp.row_indices, sp.column_indices, torch.as_tensor(dense[0]),
                         m_pad=sp.shape[0], device=CPU)
    assert tuple(got.shape) == want.shape == (12, 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(tops.dsd(sp, torch.as_tensor(dense[0]), backend="cuda").numpy(),
                               want, **TOL)


# ---------------------------------------------------------------------- #
# edge cases (dense numpy is the reference)
# ---------------------------------------------------------------------- #
EDGE_MASKS = {
    "empty_topology": np.zeros((3, 4), bool),
    "single_block": np.eye(1, 12, 6, dtype=bool).reshape(3, 4),
}


@pytest.mark.parametrize("backend", ["grouped", "cuda"])
@pytest.mark.parametrize("op", ["dsd", "dds", "sdd"])
@pytest.mark.parametrize("case", sorted(EDGE_MASKS))
def test_op_edge_topologies(case, op, backend):
    rng = np.random.default_rng(5)
    mask = EDGE_MASKS[case]
    data, n_slots, dense = _op_inputs(op, rng, mask, 2, 3, pad=2)
    sp = tbc.BlockMatrix.from_mask(mask, (2, 3), data=data, nnz_max=n_slots, device=CPU)
    got = _run_op(op, tops, sp, [torch.as_tensor(d) for d in dense], backend=backend)
    want = _dense_ref(op, sp.to_dense().numpy(), dense, sp)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if case == "empty_topology":
        assert not got.any()


@pytest.mark.parametrize("backend", ["grouped", "cuda"])
def test_dsd_zeroes_empty_block_rows(backend):
    """Block rows without a block come out as zeros (the reference's Pallas
    path masks them with ``covered``; the port's K2 writes them)."""
    mask = np.array([[1, 0, 1], [0, 0, 0], [0, 1, 0], [0, 0, 0]], bool)
    data = np.ones((4, 2, 2), np.float32)
    sp = tbc.BlockMatrix.from_mask(mask, (2, 2), data=data, nnz_max=4, device=CPU)
    y = tops.dsd(sp, torch.ones(6, 3), backend=backend).numpy()
    assert not y[2:4].any() and not y[6:8].any()
    np.testing.assert_allclose(y[0:2], 4.0)
    np.testing.assert_allclose(y[4:6], 2.0)


@pytest.mark.parametrize("op", ["dsd", "dds", "sdd"])
def test_requires_grad_raises(op):
    """Inputs that require grad get first-order gradients through the
    family's own backward passes (held here against the dense products:
    d(S x)/dx = S^T g, d/dS = g x^T at S's blocks, and so on), and a
    gradient of that gradient raises: nothing needs a double backward, so
    the Functions are once-differentiable."""
    rng = np.random.default_rng(0)
    mask = np.array([[1, 0], [1, 1]], bool)
    data, n_slots, dense = _op_inputs(op, rng, mask, 2, 2, pad=1)
    sp = tbc.BlockMatrix.from_mask(mask, (2, 2), data=data, nnz_max=n_slots, device=CPU)
    sp = tbc.BlockMatrix(sp.shape, sp.block, sp.data.clone().requires_grad_(), sp.row_indices,
                         sp.column_indices, sp.offsets)
    inputs = [torch.as_tensor(d).requires_grad_() for d in dense]
    out = _run_op(op, tops, sp, inputs)
    g = torch.as_tensor(rng.standard_normal(tuple(out.shape)).astype(np.float32))
    gc = g.clone().requires_grad_()  # a cotangent the gradients depend on
    grads = torch.autograd.grad(out, ([] if op == "sdd" else [sp.data]) + inputs, gc,
                                create_graph=True)
    S, ms = sp.to_dense().detach().numpy(), mask.repeat(2, 0).repeat(2, 1)
    gn = g.numpy()
    if op == "dsd":
        want = [gn @ dense[0].T * ms, S.T @ gn]
    elif op == "dds":
        want = [dense[0].T @ gn * ms, gn @ S.T]
    else:
        G = tbc.BlockMatrix(sp.shape, sp.block, g, sp.row_indices, sp.column_indices,
                            sp.offsets).to_dense().numpy()
        want = [G @ dense[1].T, dense[0].T @ G]
    if op != "sdd":  # the sparse operand's gradient, as a dense matrix at its blocks
        dS = tbc.BlockMatrix(sp.shape, sp.block, grads[0], sp.row_indices, sp.column_indices,
                             sp.offsets)
        grads = [dS.to_dense()] + list(grads[1:])
        assert not grads[0].detach().numpy()[~ms].any()
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.detach().numpy(), w, **TOL)
    with pytest.raises(RuntimeError, match="once_differentiable|twice"):
        grads[-1].sum().backward()


def test_sdd_block_view_and_input_checks():
    """``b`` as its strided block-column view (an expert stack permuted)
    gives the same blocks as the stacked matrix; malformed inputs raise."""
    rng = np.random.default_rng(2)
    E, K, bn, bm = 3, 10, 4, 2
    w = torch.as_tensor(rng.standard_normal((E, K, bn)).astype(np.float32))
    a = torch.as_tensor(rng.standard_normal((4 * bm, K)).astype(np.float32))
    rows, cols = np.array([0, 1, 3], np.int32), np.array([2, 0, 1], np.int32)
    stacked = w.permute(1, 0, 2).reshape(K, E * bn)  # the copy the reference makes
    view = tkops.bsr_sdd(a, w.permute(1, 0, 2), rows, cols, bm=bm, bn=bn, device=CPU)
    np.testing.assert_array_equal(
        view.numpy(), tkops.bsr_sdd(a, stacked, rows, cols, bm=bm, bn=bn, device=CPU).numpy())
    topo = tbc.topology_from_mask(np.eye(4, E, dtype=bool), (bm, bn), device=CPU)
    for backend in ("grouped", "cuda"):
        np.testing.assert_allclose(tops.sdd(a, w.permute(1, 0, 2), topo, backend=backend).data,
                                   tops.sdd(a, stacked, topo, backend=backend).data, **TOL)
    with pytest.raises(ValueError, match="unit last stride"):
        tkops.bsr_sdd(a, w.permute(1, 2, 0), rows, cols, bm=bm, bn=bn, device=CPU)
    with pytest.raises(ValueError, match="M % bm"):
        tkops.bsr_sdd(a[:-1], stacked, rows, cols, bm=bm, bn=bn, device=CPU)
    with pytest.raises(TypeError):
        tkops.bsr_sdd(a.double(), stacked.double(), rows, cols, bm=bm, bn=bn, device=CPU)
    with pytest.raises(ValueError, match="backend"):
        tops.sdd(a, stacked, topo, backend="pallas")
    with pytest.raises(ValueError, match="topology"):
        tops.sdd(a[:, :-1], stacked, topo)


# ---------------------------------------------------------------------- #
# on a card
# ---------------------------------------------------------------------- #
@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm,bn,K", [(8, 1536, 64), (8, 200, 45), (3, 7, 1), (20, 130, 33)])
def test_bsr_sdd_kernel_matches_plain(bm, bn, K, dtype):
    rng = np.random.default_rng(bm * bn + K)
    Rb, Cb, nnz = 6, 5, 17
    rows = np.sort(rng.integers(0, Rb, nnz)).astype(np.int32)
    cols = rng.integers(0, Cb, nnz).astype(np.int32)
    dev = torch.device("cuda")
    a = torch.as_tensor(rng.standard_normal((Rb * bm, K)), device=dev).to(dtype)
    w = torch.as_tensor(rng.standard_normal((Cb, K, bn)), device=dev).to(dtype)
    r, c = torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)
    want = tref.bsr_sdd_ref(a, w.permute(1, 0, 2), r, c, bm, bn).float()
    for b in (w.permute(1, 0, 2), w.permute(1, 0, 2).reshape(K, Cb * bn)):
        got = tkops.bsr_sdd(a, b, r, c, bm=bm, bn=bn)
        torch.cuda.synchronize()
        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL
        torch.testing.assert_close(got.float(), want, **tol)


def _run_slots(n_col_blocks, seed, pad):
    """Slots made of runs, as the dropless MoE's topology makes them: runs
    of 1-9 slots of one column block (in shuffled order, so some cross a
    CTA's group of slots) over consecutive row blocks, with a gap between
    some runs; then ``pad`` padding slots (row == n_row_blocks) with an
    out-of-range column. Returns (rows, cols, n_row_blocks)."""
    rng = np.random.default_rng(seed)
    rows, cols, r = [], [], 0
    for length in rng.permutation(np.arange(1, 10)):
        rows += range(r, r + length)
        cols += [int(rng.integers(n_col_blocks))] * length
        r += length + int(rng.integers(0, 2))
    rows = np.concatenate([rows, np.full(pad, r)]).astype(np.int32)
    cols = np.concatenate([cols, np.full(pad, n_col_blocks + 7)]).astype(np.int32)
    return rows, cols, r


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm,bn,K", [
    (8, 1536, 512),  # the MoE's blocks, at a shorter depth
    (8, 200, 45),  # bn past one 128-column chunk, ragged; K not a multiple of 8
    (16, 136, 96),
    (32, 130, 64),
    (5, 72, 40),  # 12 slots of 5 rows to a CTA
    (40, 136, 96),  # one slot of 40 rows to a CTA
    (100, 72, 40),  # two CTAs to a slot, the second over its last 36 rows
])
def test_bsr_sdd_runs_match_plain(bm, bn, K, dtype):
    """K3 on run-structured slots, padding included, against its plain version."""
    n_cb = 7
    rows, cols, Rb = ttesting.run_slots(np.random.default_rng(bm * bn + K), n_cb, pad=3)
    rng = np.random.default_rng(K)
    dev = torch.device("cuda")
    a = torch.as_tensor(rng.standard_normal((Rb * bm, K)), device=dev).to(dtype)
    w = torch.as_tensor(rng.standard_normal((n_cb, K, bn)), device=dev).to(dtype)
    r, c = torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)
    want = tref.bsr_sdd_ref(a, w.permute(1, 0, 2), r, c, bm, bn).float()
    before = tkops.launches["bsr_sdd"]
    got = tkops.bsr_sdd(a, w.permute(1, 0, 2), r, c, bm=bm, bn=bn)
    torch.cuda.synchronize()
    assert tkops.launches["bsr_sdd"] == before + 1
    # relative to the largest value, as chip_smoke.py checks: at K = 512 the
    # float32 sums in another order differ by ~5e-5 on values up to ~100
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert ((got.float() - want).abs().max() / want.abs().max()).item() <= tol
    assert not got[-3:].any()


@requires_cuda
@pytest.mark.parametrize("op", ["dsd", "dds", "sdd"])
def test_ops_cuda_backend_matches_grouped_on_card(op):
    """TF32 stays off: it is PyTorch's default for matmuls."""
    rng = np.random.default_rng(4)
    mask = rng.random((5, 6)) < 0.4
    data, n_slots, dense = _op_inputs(op, rng, mask, 8, 16, pad=3)
    sp = tbc.BlockMatrix.from_mask(mask, (8, 16), data=data, nnz_max=n_slots)
    args = [torch.as_tensor(d, device="cuda") for d in dense]
    got = _run_op(op, tops, sp, args, backend="cuda")
    want = _run_op(op, tops, sp, args, backend="grouped")
    torch.testing.assert_close(got, want, **TOL)
