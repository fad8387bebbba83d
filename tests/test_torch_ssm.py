"""PyTorch port, the Mamba-2 mixer: ``repro_torch.models.ssm`` against the
JAX package's ``repro.models.ssm`` on the same numpy inputs.

``ssd_chunked`` is held to the reference with the sequence a multiple of
the chunk, not a multiple, and shorter than it, for one and two B/C groups
(repeated to the heads as ``jnp.repeat`` does), in float32 (1e-5 of
max|ref|) and bfloat16 (4e-2 of max|ref|, and no further from the float32
result than twice the reference's own bfloat16 error plus one bfloat16
step: both packages round every step of the chain to bfloat16, in different
orders). ``mamba_apply`` and ``mamba_decode`` run on the reference's
``mamba_init`` params, carried across with ``convert.params_from_arrays``,
for mamba2 (one group) and jamba (two groups, which ``.repeat`` in place of
``repeat_interleave`` would get wrong), float32 at 1e-5; the port's chunked
output matches its own recurrence at 2e-4 (the reference's test holds its
own at that). Each reference function is jitted once per shape.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_arrays  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

CPU = "cpu"
F32_REL, BF16_REL = 1e-5, 4e-2  # of max|ref|
MAMBA_ARCHS = ("mamba2-1.3b", "jamba-1.5-large-398b")
requires_cuda = pytest.mark.requires_cuda


@pytest.fixture(autouse=True)
def _card(request):
    """Tests marked requires_cuda skip without a card: decided here, when the
    test runs, so that every worker collects the same tests."""
    if request.node.get_closest_marker("requires_cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def jx():
    """The reference's ssm module on JAX's CPU device in full float32, with
    a jit of each function once per (name, static arguments)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import ssm

    compiled = {}

    def jit(name, fn, static=()):
        if (name,) + tuple(static) not in compiled:
            compiled[(name,) + tuple(static)] = jax.jit(fn)
        return compiled[(name,) + tuple(static)]

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(jax=jax, ssm=ssm, jit=jit, get_config=get_config)


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32", param_dtype="float32")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ssd_inputs(S, G, seed):
    """xs (B, S, H, P), dt > 0, A < 0 and per-head B/C from G groups."""
    rng = np.random.default_rng(seed)
    B, H, P, N = 2, 4, 8, 16
    xs = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1.0)).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(H)).astype(np.float32)
    Bg = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cg = rng.standard_normal((B, S, G, N)).astype(np.float32)
    return xs, dt, A, np.repeat(Bg, H // G, axis=2), np.repeat(Cg, H // G, axis=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("S", [32, 21, 5], ids=["multiple", "ragged", "short"])
def test_ssd_chunked_matches_jax(jx, S, G, dtype):
    jnp = jx.jax.numpy
    chunk = 16
    ins = _ssd_inputs(S, G, seed=10 * S + G)
    fn = jx.jit("ssd", lambda *a: jx.ssm.ssd_chunked(*a, chunk), (S, G, dtype))
    want = [np.asarray(t.astype(jnp.float32)) for t in fn(*(jnp.asarray(a).astype(dtype)
                                                          for a in ins))]
    td = getattr(torch, dtype)
    got = tssm.ssd_chunked(*(torch.as_tensor(a).to(td) for a in ins), chunk)
    assert got[0].dtype == got[1].dtype == td
    assert tuple(got[0].shape) == ins[0].shape and tuple(got[1].shape) == (2, 4, 16, 8)
    got = [t.float().numpy() for t in got]
    if dtype == "float32":
        for g, w in zip(got, want):
            assert _rel(g, w) <= F32_REL
        return
    exact = [np.asarray(t) for t in fn(*(jnp.asarray(a) for a in ins))]  # float32 jit
    for g, w, e in zip(got, want, exact):
        assert _rel(g, w) <= BF16_REL
        step = float(np.abs(e).max()) * 2.0 ** -8
        assert np.abs(g - e).max() <= 2 * np.abs(w - e).max() + step


def _layer(jx, arch, seed=3):
    """(reference config, port config, reference params (numpy), port params)."""
    jcfg = _f32(jx.get_config(arch, reduced=True))
    tcfg = _f32(tconfigs.get_config(arch, reduced=True))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp = jx.jax.tree.map(np.asarray, jx.ssm.mamba_init(jx.jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, jp, params_from_arrays(jp, device=CPU)


def _zero_cache(cfg, B):
    s = cfg.ssm
    ch = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
    return {"conv": np.zeros((B, s.d_conv - 1, ch), np.float32),
            "ssm": np.zeros((B, s.n_heads(cfg.d_model), s.d_state, s.head_dim), np.float32)}


@pytest.mark.parametrize("arch", MAMBA_ARCHS)
def test_mamba_apply_and_decode_match_jax(jx, arch):
    """mamba_apply (output and cache) on 20 tokens, ragged over the chunk of
    16, then 4 recurrent steps from that cache, against the reference."""
    jcfg, tcfg, jp, tp = _layer(jx, arch)
    B, S, n = 2, 20, 4
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S + n, jcfg.d_model)).astype(np.float32)
    japply = jx.jit(("apply", arch), lambda p, x: jx.ssm.mamba_apply(p, x, jcfg, True))
    jdec = jx.jit(("decode", arch), lambda p, x, c: jx.ssm.mamba_decode(p, x, jcfg, c))
    wy, wc = japply(jp, x[:, :S])
    gy, gc = tssm.mamba_apply(tp, torch.as_tensor(x[:, :S]), tcfg, return_cache=True)
    assert _rel(gy.numpy(), wy) <= F32_REL
    for k in ("conv", "ssm"):
        assert _rel(gc[k].numpy(), wc[k]) <= F32_REL, k
    for t in range(S, S + n):
        wy, wc = jdec(jp, x[:, t:t + 1], wc)
        gy, gc = tssm.mamba_decode(tp, torch.as_tensor(x[:, t:t + 1]), tcfg, gc)
        assert tuple(gy.shape) == (B, 1, jcfg.d_model)
        assert _rel(gy.numpy(), wy) <= F32_REL
        assert _rel(gc["ssm"].numpy(), wc["ssm"]) <= F32_REL
        np.testing.assert_allclose(gc["conv"].numpy(), np.asarray(wc["conv"]), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", MAMBA_ARCHS)
def test_chunked_matches_recurrent(jx, arch):
    """The port's chunked SSD equals its own token-by-token recurrence (the
    counterpart of tests/test_models.py's test_mamba_chunked_vs_recurrent),
    output and final state at 2e-4."""
    _, cfg, _, p = _layer(jx, arch, seed=4)
    B, S = 2, 20
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator().manual_seed(4))
    y_full, c_full = tssm.mamba_apply(p, x, cfg, return_cache=True)
    cache = {k: torch.as_tensor(v) for k, v in _zero_cache(cfg, B).items()}
    outs = []
    for t in range(S):
        o, cache = tssm.mamba_decode(p, x[:, t:t + 1], cfg, cache)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, dim=1), y_full, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(cache["ssm"], c_full["ssm"], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(cache["conv"], c_full["conv"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("S", [1, 2, 3])
def test_conv_cache_of_short_prompt_matches_jax(jx, S):
    """A prompt shorter than d_conv - 1 = 3 leaves its inputs at the conv
    cache's end, zeros before them, as the reference's does."""
    jcfg, tcfg, jp, tp = _layer(jx, "mamba2-1.3b")
    x = np.random.default_rng(S).standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    _, wc = jx.jit(("apply", "short", S), lambda p, x: jx.ssm.mamba_apply(p, x, jcfg, True))(
        jp, x)
    _, gc = tssm.mamba_apply(tp, torch.as_tensor(x), tcfg, return_cache=True)
    assert tuple(gc["conv"].shape) == np.asarray(wc["conv"]).shape
    np.testing.assert_allclose(gc["conv"].numpy(), np.asarray(wc["conv"]), rtol=1e-5,
                               atol=1e-5)
    assert not gc["conv"][:, :3 - S].any()
    assert _rel(gc["ssm"].numpy(), wc["ssm"]) <= F32_REL


def test_mamba_apply_bfloat16_matches_jax(jx):
    """jamba's layer in bfloat16 (params and activations), as a server runs
    it: the output within the bfloat16 bound of the reference's."""
    jnp = jx.jax.numpy
    jcfg, tcfg, jp, _ = _layer(jx, "jamba-1.5-large-398b")
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16", param_dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, compute_dtype="bfloat16", param_dtype="bfloat16")
    x = np.random.default_rng(9).standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    jpb = jx.jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    wy, _ = jx.jit(("apply", "bf16"), lambda p, x: jx.ssm.mamba_apply(p, x, jcfg))(
        jpb, jnp.asarray(x, jnp.bfloat16))
    gy, _ = tssm.mamba_apply(params_from_arrays(jp, device=CPU, dtype=torch.bfloat16),
                             torch.as_tensor(x).to(torch.bfloat16), tcfg)
    assert gy.dtype == torch.bfloat16
    assert _rel(gy.float().numpy(), np.asarray(wy.astype(jnp.float32))) <= BF16_REL


def test_mamba_init_layout_matches_jax(jx):
    """mamba_init draws the reference's keys, shapes and constants."""
    for arch in MAMBA_ARCHS:
        jcfg, tcfg, jp, _ = _layer(jx, arch)
        tp = tssm.mamba_init(torch.Generator().manual_seed(0), tcfg, device=CPU)
        assert {k: tuple(v.shape) for k, v in tp.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}
        for k in ("conv_b", "A_log", "D", "dt_bias", "norm"):
            np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=1e-6, err_msg=k)


@requires_cuda
@pytest.mark.parametrize("arch", MAMBA_ARCHS)
def test_mamba_on_the_card_matches_cpu(arch):
    """The layer on the card (cuDNN's depthwise conv, cuBLAS products) gives
    the CPU's output and cache in float32 with TF32 off."""
    cfg = _f32(tconfigs.get_config(arch, reduced=True))
    p = tssm.mamba_init(torch.Generator().manual_seed(0), cfg, device=CPU)
    x = torch.randn((2, 37, cfg.d_model), generator=torch.Generator().manual_seed(1))
    want, wc = tssm.mamba_apply(p, x, cfg, return_cache=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        pc = {k: v.cuda() for k, v in p.items()}
        got, gc = tssm.mamba_apply(pc, x.cuda(), cfg, return_cache=True)
        step, sc = tssm.mamba_decode(pc, x[:, :1].cuda(), cfg, gc)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gc["ssm"].cpu(), wc["ssm"], rtol=1e-4, atol=1e-4)
    ws, _ = tssm.mamba_decode(p, x[:, :1], cfg, wc)
    torch.testing.assert_close(step.cpu(), ws, rtol=1e-4, atol=1e-4)
