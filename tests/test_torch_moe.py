"""PyTorch port, the MoE layer: ``repro_torch.models.moe.moe_apply`` against
the JAX package's ``moe_apply`` on the same params (carried across with
``convert.params_from_arrays``) and inputs, for the dropless path (on
the dsd/sdd family) and the capacity path, at prefill and decode shapes.

Params and inputs are numpy normals. The top-k choice of both frameworks
then agrees: a tie between two router probabilities, the one way the
frameworks could pick different experts, has probability ~0 with such
inputs.

The JAX package comes in through the ``jx`` fixture, so that on a GPU
machine without JAX the CUDA test runs and the parity tests skip."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch.configs import deepseek_v2_236b as tds  # noqa: E402
from repro_torch.convert import params_from_arrays  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from test_torch_linear import _sealed_reference_plans  # noqa: E402,F401 (autouse)

# float32, as tests/test_bsr_ops.py: the same sums in another order agree
# to 1e-5 (the aux loss to 1e-6 relative)
TOL = dict(rtol=1e-5, atol=1e-5)
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
    """The reference's moe_apply, jitted once per config (eager JAX compiles
    each primitive on its own, which takes seconds), on JAX's CPU device in
    full float32."""
    jax = pytest.importorskip("jax")
    from repro.models import moe

    compiled = {}

    def apply(cfg, p, x):
        if cfg not in compiled:
            compiled[cfg] = jax.jit(lambda p, x: moe.moe_apply(p, x, cfg))
        y, aux = compiled[cfg](p, x)
        return np.asarray(y), float(aux)

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(jax=jax, moe=moe, apply=apply)


def _small(config, ffn_type="swiglu", dropless=True, capacity_factor=16.0):
    """The config of tests/test_bsr_ops.py's dropless MoE tests, in either
    package's config module."""
    moe = config.MoEConfig(num_experts=4, top_k=2, d_ff=32, capacity_factor=capacity_factor,
                           dropless=dropless, dropless_block=8)
    return config.ModelConfig(
        name="t", family="moe", d_model=16, n_heads=2, n_kv_heads=2, head_dim=8, d_ff=32,
        vocab_size=64, groups=config.uniform_groups(1, config.LayerSpec(ffn="moe")),
        ffn_type=ffn_type, moe=moe,
    )


def _reduced(cfg, dropless):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dropless=dropless))


def _params(cfg, seed):
    """Params in the reference's layout, as numpy normals scaled as its
    dense_init does."""
    rng = np.random.default_rng(seed)
    mc = cfg.moe
    d, E, f = cfg.d_model, mc.num_experts, mc.d_ff

    def init(shape, scale=None):
        scale = scale or 1.0 / np.sqrt(shape[-2])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"router": init((d, E), 0.02), "w1": init((E, d, f)), "w2": init((E, f, d))}
    if cfg.ffn_type == "swiglu":
        p["w3"] = init((E, d, f))
    if mc.num_shared:
        sf = (mc.shared_d_ff or mc.d_ff) * mc.num_shared
        p["sw1"], p["sw2"] = init((d, sf)), init((sf, d))
        if cfg.ffn_type == "swiglu":
            p["sw3"] = init((d, sf))
    return p


def _both(jx, jcfg, tcfg, p, x):
    """(reference y, aux), (port y, aux) on numpy params and input."""
    want = jx.apply(jcfg, p, x)
    y, aux = tmoe.moe_apply(params_from_arrays(p, device=CPU), torch.as_tensor(x), tcfg)
    assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
    return want, (y.numpy(), float(aux))


def _check(want, got):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    assert got[1] == pytest.approx(want[1], rel=1e-6)


CASES = {  # name: (config, ffn_type, dropless, capacity_factor, input shape)
    "small-swiglu-dropless-prefill": ("small", "swiglu", True, 16.0, (2, 12)),
    "small-swiglu-capacity-prefill": ("small", "swiglu", False, 16.0, (2, 12)),
    "small-relu2-dropless-decode": ("small", "relu2", True, 16.0, (4, 1)),
    "small-relu2-capacity-drops-prefill": ("small", "relu2", False, 0.5, (2, 32)),
    "reduced-dropless-prefill": ("reduced", "swiglu", True, None, (2, 16)),
    "reduced-dropless-decode": ("reduced", "swiglu", True, None, (8, 1)),
    "reduced-capacity-decode": ("reduced", "swiglu", False, None, (8, 1)),
}


def _configs(jx, name, dropless=None):
    """(reference config, port config, input shape); ``dropless`` overrides
    the case's path."""
    kind, ffn_type, case_dropless, cf, shape = CASES[name]
    dropless = case_dropless if dropless is None else dropless
    from repro.configs import deepseek_v2_236b as jds
    from repro.models import config as jconfig

    if kind == "small":
        return (_small(jconfig, ffn_type, dropless, cf), _small(tconfig, ffn_type, dropless, cf),
                shape)
    return _reduced(jds.reduced(), dropless), _reduced(tds.reduced(), dropless), shape


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_apply_matches_jax(jx, name):
    """y and the aux loss. The capacity-0.5 case drops tokens (capacity 8
    against 16 assignments per expert and group on average) and is held
    against the reference's capacity path. The other capacity cases drop
    nothing, so they are held against the reference's dropless path on the
    same input, which the reference's own tests hold equal to its capacity
    path (tests/test_bsr_ops.py); that shares one compile of the reference
    with the dropless case of the same shape."""
    jcfg, tcfg, shape = _configs(jx, name)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    if "drops" not in name:
        jcfg = _configs(jx, name, dropless=True)[0]
    p = _params(tcfg, seed=sum(map(ord, name)))
    x = np.random.default_rng(1).standard_normal(shape + (tcfg.d_model,)).astype(np.float32)
    _check(*_both(jx, jcfg, tcfg, p, x))
    r = tmoe._route(params_from_arrays(p, device=CPU), torch.as_tensor(x), tcfg)
    assert bool(r.dropped.any()) == ("drops" in name)


def test_dropless_empty_experts_match_jax_and_capacity_path(jx):
    """A router biased so that experts 2 and 3 receive no token (as
    tests/test_bsr_ops.py does, here with positive inputs so that the bias
    always wins): their blocks are absent from the topology and contribute
    nothing; the port's dropless and capacity paths agree."""
    jcfg, tcfg, shape = _configs(jx, "small-swiglu-dropless-prefill")
    p = _params(tcfg, seed=3)
    p["router"][:, 2:] = -1e9
    x = np.abs(np.random.default_rng(3).standard_normal(shape + (16,))).astype(np.float32)
    want, got = _both(jx, jcfg, tcfg, p, x)
    _check(want, got)
    tp = params_from_arrays(p, device=CPU)
    r = tmoe._route(tp, torch.as_tensor(x), tcfg)
    assert r.counts[:, 2:].sum() == 0 and r.counts.sum() == 2 * 12 * 2
    y_cap, _ = tmoe.moe_apply(tp, torch.as_tensor(x), dataclasses.replace(
        tcfg, moe=dataclasses.replace(tcfg.moe, dropless=False)))
    np.testing.assert_allclose(got[0], y_cap.numpy(), **TOL)


def test_per_lane_decode_routes_each_lane_as_its_own_group(jx):
    """Sixteen lanes decoded together (the scheduler's lane step) with every
    token routed to experts 0 and 1 (positive inputs, router column e
    scaled by E - e): ``per_lane=True`` gives each lane the reference's
    single-lane result, where one group of 16 (C = 8) drops 8 assignments
    on each of the two; the dropless path keeps one group and drops
    nothing."""
    jcfg, tcfg, _ = _configs(jx, "reduced-capacity-decode")
    p = _params(tcfg, seed=9)
    E = p["router"].shape[1]
    p["router"][:] = (E - np.arange(E, dtype=np.float32)) * 0.5
    x = np.abs(np.random.default_rng(9).standard_normal((16, 1, tcfg.d_model))).astype(
        np.float32)
    want = np.concatenate([jx.apply(jcfg, p, x[i:i + 1])[0] for i in range(16)])
    tp, tx = params_from_arrays(p, device=CPU), torch.as_tensor(x)
    y, _ = tmoe.moe_apply(tp, tx, tcfg, per_lane=True)
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    assert int(tmoe._route(tp, tx, tcfg).dropped.sum()) == 16
    assert tmoe._route(tp, tx, tcfg, per_lane=True).G == 16
    assert not np.allclose(tmoe.moe_apply(tp, tx, tcfg)[0].numpy(), want, **TOL)
    dl = _reduced(tcfg, True)
    assert tmoe._route(tp, tx, dl, per_lane=True).G == 1
    np.testing.assert_allclose(tmoe.moe_apply(tp, tx, dl, per_lane=True)[0].numpy(), want,
                               **TOL)


def test_params_carry_jax_moe_init_layout(jx):
    """The reference's moe_init pytree (its shapes, traced without running)
    has the port's keys and shapes; the converter keeps them and follows
    the dtype and device it is given."""
    for cfg_name in ("small-swiglu-dropless-prefill", "small-relu2-dropless-decode",
                     "reduced-dropless-prefill"):
        jcfg, tcfg, _ = _configs(jx, cfg_name)
        shapes = jx.jax.eval_shape(lambda k: jx.moe.moe_init(k, jcfg), jx.jax.random.PRNGKey(0))
        tp = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg, device=CPU)
        assert {k: tuple(v.shape) for k, v in shapes.items()} == {
            k: tuple(v.shape) for k, v in tp.items()}
    p = _params(tcfg, seed=0)
    bf = params_from_arrays(p, device=CPU, dtype=torch.bfloat16)
    assert set(bf) == set(p)
    for k, v in bf.items():
        assert v.dtype == torch.bfloat16 and v.device.type == "cpu" and v.shape == p[k].shape
        np.testing.assert_allclose(v.float().numpy(), p[k], rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("which", ["full", "reduced"])
def test_deepseek_v2_configs_equal_jax(jx, which):
    from repro.configs import deepseek_v2_236b as jds
    from repro.models.config import param_count as jcount

    jcfg, tcfg = getattr(jds, which)(), getattr(tds, which)()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tconfig.param_count(tcfg) == jcount(jcfg)
    assert tconfig.param_count(tcfg, active=True) == jcount(jcfg, active=True)


def test_moe_init_and_capacity():
    """moe_init draws the reference's shapes from the generator it is
    given, repeatably; _capacity rounds as the reference does."""
    cfg = tds.reduced()
    p1 = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, device=CPU)
    p2 = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, device=CPU)
    assert {k: tuple(v.shape) for k, v in p1.items()} == {
        "router": (64, 8), "w1": (8, 64, 32), "w2": (8, 32, 64), "w3": (8, 64, 32),
        "sw1": (64, 64), "sw2": (64, 64), "sw3": (64, 64)}
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert float(p1["router"].std()) == pytest.approx(0.02, rel=0.2)
    dl = _reduced(cfg, True)
    assert [tmoe._capacity(t, dl) for t in (1, 8, 9, 512)] == [8, 8, 16, 512]
    assert [tmoe._capacity(t, cfg) for t in (1, 16, 512)] == [8, 8, 160]
    full = _reduced(tds.full(), True)
    assert tmoe._capacity(512, full) == 512 and tmoe._capacity(64, full) == 64


def test_dropless_requires_grad_raises():
    """The dropless path takes gradients through the family's backward
    passes: every param's and x's gradient of sum(y) + aux equals the
    capacity path's, where nothing drops (capacity_factor 16); a gradient of
    a gradient raises (the family's Functions are once-differentiable)."""
    grads = {}
    x0 = torch.randn(2, 12, 16, generator=torch.Generator().manual_seed(0))
    for dropless in (True, False):
        cfg = _small(tconfig, dropless=dropless)
        p = params_from_arrays(_params(cfg, seed=0), device=CPU)
        for v in p.values():
            v.requires_grad_()
        x = x0.clone().requires_grad_()
        y, aux = tmoe.moe_apply(p, x, cfg)
        leaves = [x] + [p[k] for k in sorted(p)]
        cot = torch.ones_like(y).requires_grad_()  # a cotangent the gradients depend on
        grads[dropless] = torch.autograd.grad((y * cot).sum() + aux, leaves,
                                              create_graph=dropless)
    for got, want in zip(grads[True], grads[False]):
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(), **TOL)
    with pytest.raises(RuntimeError, match="once_differentiable|twice"):
        grads[True][0].sum().backward()


@requires_cuda
@pytest.mark.parametrize("shape", [(2, 12), (4, 1)])
def test_dropless_on_card_matches_capacity_path(shape):
    """On the card the dropless path runs K3 (sdd) and K2 (dsd)."""
    from repro_torch.kernels import ops as kops

    cfg = _small(tconfig)
    p = params_from_arrays(_params(cfg, seed=5), device="cuda")
    x = torch.randn(shape + (16,), device="cuda")
    before = dict(kops.launches)
    y, aux = tmoe.moe_apply(p, x, cfg)
    assert kops.launches["bsr_sdd"] == before["bsr_sdd"] + 2
    assert kops.launches["bsr_spmm"] == before["bsr_spmm"] + 1
    y_cap, aux_cap = tmoe.moe_apply(p, x, _small(tconfig, dropless=False))
    torch.testing.assert_close(y, y_cap, **TOL)
    torch.testing.assert_close(aux, aux_cap)
