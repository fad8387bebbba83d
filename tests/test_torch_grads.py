"""PyTorch port, gradients: the dsd/dds/sdd family's autograd Functions,
every ``sparse_matmul_auto`` strategy and both paths of ``moe_apply``,
against the JAX package's ``custom_vjp``s (``jax.grad``) on the same numpy
inputs, in float32 on the CPU to 1e-5.

The family runs on both backends: ``grouped``, and ``cuda``, whose glue
(transposed tables, strided ``x^T`` for K3, K2's transposed output read back
in ``b``'s layout) runs around the kernels' plain versions here. The
reference runs ``grouped`` (one case also Pallas in interpret mode, as
tests/test_bsr_ops.py runs it). The sparse matmul's strategies are held
against ``_pallas_matmul_ad``, the reference's AD-safe Pallas dispatch. The
card-only cases hold the ``cuda`` backend's gradients against ``grouped`` at
a transposed MoE table (K2 at tm = 1536, tk = 8) and K3's scalar body on a
transposed ``b`` against its plain version.

The JAX package comes in through the ``jx`` fixture; each reference gradient
is one jitted function, compiled once per shape.
"""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch.convert import params_from_arrays  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.kernels import bsr_ops as tops  # noqa: E402
from repro_torch.kernels import ops as tkops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.sparse import block_csr as tbc  # noqa: E402
from repro_torch.sparse import linear as tlin  # noqa: E402
from test_torch_linear import PATTERNS, _inputs  # noqa: E402
from test_torch_linear import _sealed_reference_plans  # noqa: E402,F401 (autouse)
from test_torch_moe import _params, _small  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = "cpu"
requires_cuda = pytest.mark.requires_cuda


@pytest.fixture(autouse=True)
def _card(request):
    """Tests marked requires_cuda skip without a card: decided here, when the
    test runs, so that every worker collects the same tests."""
    if request.node.get_closest_marker("requires_cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the kernels")


def _run(op, ops_mod, sp, dense, **kw):
    if op == "dsd":
        return ops_mod.dsd(sp, dense[0], **kw)
    if op == "dds":
        return ops_mod.dds(dense[0], sp, **kw)
    return ops_mod.sdd(dense[0], dense[1], sp.topology(), **kw).data


@pytest.fixture(scope="module")
def jx():
    """The reference's gradients on JAX's CPU device in full float32, each a
    jitted function compiled once per shape."""
    jax = pytest.importorskip("jax")
    from repro.kernels import bsr_ops
    from repro.models import moe
    from repro.sparse import block_csr, linear

    jnp = jax.numpy
    BM = block_csr.BlockMatrix

    def op_grads(op, backend, nnz_max, block, mask, data, cot, *dense):
        """Gradients of sum(op(...) * cot): w.r.t. the sparse operand's data
        (through from_mask, which zeroes padding) and the dense operands;
        sdd's sparse operand is a topology, without a gradient."""
        kw = dict(backend=backend, interpret=True if backend == "pallas" else None)

        def loss(data, *dense):
            sp = BM.from_mask(mask, block, data=data, nnz_max=nnz_max)
            return jnp.sum(_run(op, bsr_ops, sp, dense, **kw) * cot)

        first = 1 if op == "sdd" else 0
        return jax.grad(loss, argnums=tuple(range(first, 1 + len(dense))))(data, *dense)

    compiled = {}

    def matmul_grads(pattern, x, tiles, cot):
        if pattern not in compiled:
            def loss(x, tiles):
                return jnp.sum(linear._pallas_matmul_ad(pattern, x, tiles) * cot)

            compiled[pattern] = jax.jit(jax.grad(loss, argnums=(0, 1)))
        return compiled[pattern](x, tiles)

    def moe_grads(cfg, p, x, cot):
        key = ("moe", cfg)
        if key not in compiled:
            def loss(p, x):
                y, aux = moe.moe_apply(p, x, cfg)
                return jnp.sum(y * cot) + aux

            compiled[key] = jax.jit(jax.grad(loss, argnums=(0, 1)))
        return compiled[key](p, x)

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(
            jax=jax, jnp=jnp, lin=linear,
            op_grads=jax.jit(op_grads, static_argnums=(0, 1, 2, 3)),
            matmul_grads=matmul_grads, moe_grads=moe_grads,
        )


# ---------------------------------------------------------------------- #
# the family
# ---------------------------------------------------------------------- #
def _case(name):
    """(mask, block, padding slots) of a named topology: random with
    padding, and the edge topologies of test_torch_bsr_ops.py."""
    if name == "random":
        return np.random.default_rng(11).random((3, 4)) < 0.5, (4, 8), 3
    mask = {"empty_topology": np.zeros((3, 4), bool),
            "single_block": np.eye(1, 12, 6, dtype=bool).reshape(3, 4)}[name]
    return mask, (2, 3), 2


def _inputs_op(op, name, seed=5):
    """Data, nnz_max, dense operands and the cotangent for ``op`` over the
    named topology."""
    mask, (bm, bn), pad = _case(name)
    rng = np.random.default_rng(seed)
    R, C = mask.shape
    n_slots = max(int(mask.sum()) + pad, 1)
    data = rng.standard_normal((n_slots, bm, bn)).astype(np.float32)
    if op == "dsd":
        dense = (rng.standard_normal((C * bn, 5)).astype(np.float32),)
        out = (R * bm, 5)
    elif op == "dds":
        dense = (rng.standard_normal((5, R * bm)).astype(np.float32),)
        out = (5, C * bn)
    else:
        dense = (rng.standard_normal((R * bm, 6)).astype(np.float32),
                 rng.standard_normal((6, C * bn)).astype(np.float32))
        out = (n_slots, bm, bn)
    cot = rng.standard_normal(out).astype(np.float32)
    return mask, (bm, bn), data, n_slots, dense, cot


def _port_grads(op, backend, mask, block, data, n_slots, dense, cot):
    d = torch.as_tensor(data).requires_grad_()
    sp = tbc.BlockMatrix.from_mask(mask, block, data=d, nnz_max=n_slots, device=CPU)
    dt = [torch.as_tensor(x).requires_grad_() for x in dense]
    (_run(op, tops, sp, dt, backend=backend) * torch.as_tensor(cot)).sum().backward()
    return ([] if op == "sdd" else [d.grad]) + [t.grad for t in dt]


@pytest.mark.parametrize("backend", ["grouped", "cuda"])
@pytest.mark.parametrize("op", ["dsd", "dds", "sdd"])
@pytest.mark.parametrize("case", ["random", "empty_topology", "single_block"])
def test_family_grads_match_jax(jx, case, op, backend):
    mask, block, data, n_slots, dense, cot = _inputs_op(op, case)
    want = jx.op_grads(op, "grouped", n_slots, block, mask, data, cot, *dense)
    got = _port_grads(op, backend, mask, block, data, n_slots, dense, cot)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is not None and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if case == "empty_topology" and op != "sdd":
        assert not got[0].any()


@pytest.mark.parametrize("backend", ["grouped", "cuda"])
@pytest.mark.parametrize("op", ["dsd", "dds"])
def test_family_padding_slots_get_zero_gradient(op, backend):
    """The Function's own gradient of the sparse operand (not through
    from_mask's zeroing) is a zero block at every padding slot; the index
    tensors take none."""
    mask, block, data, n_slots, dense, cot = _inputs_op(op, "random")
    sp = tbc.BlockMatrix.from_mask(mask, block, data=data, nnz_max=n_slots, device=CPU)
    sp = dataclasses.replace(sp, data=sp.data.clone().requires_grad_())
    out = _run(op, tops, sp, [torch.as_tensor(x) for x in dense], backend=backend)
    (out * torch.as_tensor(cot)).sum().backward()
    assert not sp.data.grad[~sp.valid].any() and sp.data.grad[sp.valid].any()
    assert sp.row_indices.grad is None and sp.column_indices.grad is None


def test_sdd_grads_match_jax_pallas_interpret(jx):
    """The reference's Pallas kernels in interpret mode (its sdd and, in the
    backward, bsr_spmm for dsd and dds), against the port's cuda glue."""
    mask, block, data, n_slots, dense, cot = _inputs_op("sdd", "random")
    want = jx.op_grads("sdd", "pallas", n_slots, block, mask, data, cot, *dense)
    got = _port_grads("sdd", "cuda", mask, block, data, n_slots, dense, cot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("backend", ["grouped", "cuda"])
def test_sdd_block_view_grads_reach_the_expert_stack(jx, backend):
    """``b`` as the strided block-column view of an expert stack w (E, K,
    bn), as the dropless MoE passes it: the gradient comes back in the
    view's shape and reaches w, equal to the reference's gradient of the
    stacked (K, E*bn) matrix it copies."""
    rng = np.random.default_rng(2)
    E, K, bn, bm = 3, 10, 4, 2
    w = rng.standard_normal((E, K, bn)).astype(np.float32)
    a = rng.standard_normal((4 * bm, K)).astype(np.float32)
    mask = np.eye(4, E, dtype=bool) | np.eye(4, E, -1, dtype=bool)
    n_slots = int(mask.sum()) + 2
    cot = rng.standard_normal((n_slots, bm, bn)).astype(np.float32)
    stacked = w.transpose(1, 0, 2).reshape(K, E * bn)
    data = np.zeros((n_slots, bm, bn), np.float32)
    want = jx.op_grads("sdd", "grouped", n_slots, (bm, bn), mask, data, cot, a, stacked)
    wt, at = torch.as_tensor(w).requires_grad_(), torch.as_tensor(a).requires_grad_()
    topo = tbc.topology_from_mask(mask, (bm, bn), nnz_max=n_slots, device=CPU)
    out = tops.sdd(at, wt.permute(1, 0, 2), topo, backend=backend).data
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(),
                               np.asarray(want[1]).reshape(K, E, bn).transpose(1, 0, 2), **TOL)


# ---------------------------------------------------------------------- #
# sparse_matmul_auto, each strategy
# ---------------------------------------------------------------------- #
@pytest.fixture
def pinned(tmp_path, monkeypatch):
    """A fresh plan cache; ``pin(pattern, strategy)`` makes
    sparse_matmul_auto take that strategy on the CPU."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    tcache.set_default_cache(None)
    tlin._STRATEGY_REGISTRY.clear()
    dkey = tcache.device_key(torch.device(CPU))

    def pin(pattern, strategy):
        tlin._STRATEGY_REGISTRY[f"{tlin.pattern_hash(pattern)}@{dkey}"] = strategy

    yield pin
    tcache.set_default_cache(None)
    tlin._STRATEGY_REGISTRY.clear()


@pytest.mark.parametrize("strategy", ["grouped", "cuda", "fixed_block", "dia_hybrid"])
@pytest.mark.parametrize("name", ["oblong", "reduced-out"])
def test_sparse_matmul_grads_match_pallas_ad(jx, pinned, name, strategy):
    args = PATTERNS[name]
    pat = tlin.random_pattern(*args)
    x, tiles = _inputs(pat)
    cot = np.random.default_rng(9).standard_normal(x.shape[:-1] + (pat.d_out,)).astype(
        np.float32)
    want = jx.matmul_grads(jx.lin.random_pattern(*args), x, tiles, cot)
    pinned(pat, strategy)
    xt, tt = torch.as_tensor(x).requires_grad_(), torch.as_tensor(tiles).requires_grad_()
    y = tlin.sparse_matmul_auto(xt, tt, pat)
    (y * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want[1]), **TOL)


def test_cuda_strategy_backward_takes_the_cached_tables():
    """The cuda strategy saves x and the tiles for its backward, and takes
    the pattern's gathers from the per-pattern cache: no per-call tables."""
    pat = tlin.random_pattern(*PATTERNS["square"])
    x, tiles = (torch.as_tensor(a).requires_grad_() for a in _inputs(pat, lead=(6,)))
    y = tlin._CudaMatmulFn.apply(pat, x, tiles)
    assert len(y.grad_fn.saved_tensors) == 2
    t = tlin._tables(pat, x.device)
    assert t.row_gather.shape == (pat.n_tiles, pat.tm)
    assert t.col_gather.shape == (pat.n_tiles, pat.tk)
    y.sum().backward()
    assert x.grad.shape == x.shape and tiles.grad.shape == tiles.shape


@pytest.mark.parametrize("strategy", ["grouped", "fixed_block", "dia_hybrid"])
def test_tables_cached_by_a_server_take_gradients(pinned, strategy):
    """A pattern whose tables were first built under torch.inference_mode()
    (a server's forward) trains: the cached skeleton's index tensors are
    saved for the backward, which refuses inference tensors."""
    pat = tlin.random_pattern(*PATTERNS["square"])
    tlin._TABLES.pop((tlin.pattern_hash(pat), CPU), None)
    x, tiles = (torch.as_tensor(a) for a in _inputs(pat))
    pinned(pat, strategy)
    with torch.inference_mode():
        want = tlin.sparse_matmul_auto(x, tiles, pat)
    tiles = tiles.clone().requires_grad_()
    y = tlin.sparse_matmul_auto(x, tiles, pat)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want.numpy(), **TOL)
    assert tiles.grad is not None and tiles.grad.any()


# ---------------------------------------------------------------------- #
# moe_apply
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("path", ["dropless", "dropless-cuda", "capacity"])
def test_moe_grads_match_jax(jx, monkeypatch, path):
    """Gradients of sum(y * cot) + aux w.r.t. every param (router, experts,
    shared experts) and x. dropless-cuda runs the family's cuda glue (the
    plain versions of K3 and K2 here); capacity is the einsum path at a
    factor where tokens drop."""
    from repro.models import config as jconfig

    dropless = path != "capacity"
    cf = 16.0 if dropless else 1.0
    cfg_j, cfg_t = (_small(c, dropless=dropless, capacity_factor=cf) for c in (jconfig, tconfig))
    p = _params(cfg_t, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    want_p, want_x = jx.moe_grads(cfg_j, p, x, cot)
    if path == "dropless-cuda":
        monkeypatch.setattr(tmoe, "sdd", functools.partial(tops.sdd, backend="cuda"))
        monkeypatch.setattr(tmoe, "dsd", functools.partial(tops.dsd, backend="cuda"))
    tp = params_from_arrays(p, device=CPU)
    for v in tp.values():
        v.requires_grad_()
    xt = torch.as_tensor(x).requires_grad_()
    y, aux = tmoe.moe_apply(tp, xt, cfg_t)
    ((y * torch.as_tensor(cot)).sum() + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), **TOL)
    assert set(tp) == set(want_p)
    for k, v in tp.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(want_p[k]), **TOL, err_msg=k)


# ---------------------------------------------------------------------- #
# on a card
# ---------------------------------------------------------------------- #
def _moe_chain(a, w1, w2, topo, backend):
    """The dropless expert FFN's chain: sdd, an activation on the blocks,
    dsd against the stacked second weights."""
    E, f, d = w2.shape
    h = tops.sdd(a, w1.permute(1, 0, 2), topo, backend=backend)
    h = h.with_data(torch.nn.functional.silu(h.data))
    return tops.dsd(h, w2.reshape(E * f, d), backend=backend)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_family_backward_on_card_at_a_transposed_moe_table(dtype):
    """Autograd through sdd and dsd with the cuda backend (K3, K2; in the
    backward K2 at tm = 1536, tk = 8 and K3 on a transposed b) against
    grouped, the plain versions, on the card. TF32 stays off."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    E, d, f, bm, rows = 4, 64, 1536, 8, 12
    mask = torch.zeros((rows, E), dtype=torch.bool, device=dev)
    mask[torch.arange(rows, device=dev), torch.arange(rows, device=dev) % E] = True
    mask[rows - 2:] = False  # two empty row blocks
    topo = tbc.topology_from_mask(mask, (bm, f), nnz_max=rows + 3, device=dev)
    a = torch.randn((rows * bm, d), generator=gen, device=dev).to(dtype)
    w1 = (torch.randn((E, d, f), generator=gen, device=dev) / 8).to(dtype)
    w2 = (torch.randn((E, f, d), generator=gen, device=dev) / 40).to(dtype)
    cot = torch.randn((rows * bm, d), generator=gen, device=dev).to(dtype)
    grads = {}
    for backend in ("grouped", "cuda"):
        leaves = [t.detach().clone().requires_grad_() for t in (a, w1, w2)]
        (_moe_chain(*leaves, topo, backend).float() * cot.float()).sum().backward()
        grads[backend] = [t.grad.float() for t in leaves]
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for got, want in zip(grads["cuda"], grads["grouped"]):
        assert ((got - want).abs().max() / want.abs().max()).item() <= tol


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_at_tm1536_tk8_matches_plain_on_card(dtype):
    """K2 at the backward's new table (dW = dsd(S^T, g)): one expert's 1536
    rows a row tile, its tiles its 8-deep row slots."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    E, f, bm, n = 5, 1536, 8, 200
    slots = torch.tensor([3, 1, 0, 4, 2, 7, 1], device=dev)  # slots per expert; one empty
    slots = slots[:E]
    rows = torch.repeat_interleave(torch.arange(E, device=dev), slots).to(torch.int32)
    nb = int(slots.sum())
    cols = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    tiles = torch.randn((nb, f, bm), generator=gen, device=dev).to(dtype)
    x = torch.randn((nb * bm, n), generator=gen, device=dev).to(dtype)
    before = tkops.launches["bsr_spmm"]
    got = tkops.bsr_spmm(tiles, rows, cols, x, m_pad=E * f)
    torch.cuda.synchronize()
    assert tkops.launches["bsr_spmm"] == before + 1
    want = tref.bsr_spmm_ref(tiles, rows, cols, x, E * f).float()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert ((got.float() - want).abs().max() / want.abs().max()).item() <= tol
