"""PyTorch port, the GQA transformer: ``repro_torch.models`` (layers,
attention, transformer) against the JAX package's on the same numpy inputs.

Params come from the reference's ``init_params`` (``jax.random`` streams
cannot be reproduced in torch) and are carried across with
``convert.params_from_arrays``. Compute runs in float32, as the reference's
golden tests override it (tests/test_golden.py), and the logits must agree
to 1e-4. The card tests run a 2-layer llama3-8b-sable at full width through
K2 and through ``grouped`` in float32, and count K2's launches per forward.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import llama3_8b as tl  # noqa: E402
from repro_torch.convert import params_from_arrays  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from test_torch_linear import _sealed_reference_plans  # noqa: E402,F401 (autouse)

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-4)
requires_cuda = pytest.mark.requires_cuda

# the configs this slice runs: (arch, reduced constructor or None for get_config)
MODELS = {
    "llama3-8b-sable": "reduced_sable",
    "llama3.2-3b": None,  # tied embeddings
    "chameleon-34b": None,  # qk-norm
}


@pytest.fixture(autouse=True)
def _card(request):
    """Tests marked requires_cuda skip without a card: decided here, when the
    test runs, so that every worker collects the same tests."""
    if request.node.get_closest_marker("requires_cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the kernels")


@pytest.fixture(scope="module")
def jx():
    """The reference's model modules on JAX's CPU device in full float32."""
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.models import attention, layers, transformer

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(jax=jax, jnp=jax.numpy, configs=configs, attn=attention,
                              layers=layers, tr=transformer)


@pytest.fixture
def plan_dir(tmp_path, monkeypatch):
    """Both packages' plan caches in a fresh directory (the SABLE FFN
    resolves its strategy through them)."""
    from repro_torch.core import cache as tcache
    from repro_torch.sparse import linear as tlin

    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    tcache.set_default_cache(None)
    tlin._STRATEGY_REGISTRY.clear()
    yield tmp_path
    tcache.set_default_cache(None)
    tlin._STRATEGY_REGISTRY.clear()


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32", param_dtype="float32")


def _configs(jx, arch):
    ctor = MODELS[arch]
    if ctor is None:
        return jx.configs.get_config(arch, reduced=True), tconfigs.get_config(arch, reduced=True)
    from repro.configs import llama3_8b as jl

    return getattr(jl, ctor)(), getattr(tl, ctor)()


def _gqa_cfg():
    return _f32(tconfigs.get_config("chameleon-34b", reduced=True))


# ---------------------------------------------------------------------- #
# configs
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["nemotron-4-15b", "llama3.2-3b", "granite-8b", "llama3-8b",
                                  "mamba2-1.3b", "jamba-1.5-large-398b", "deepseek-v2-236b",
                                  "llama4-scout-17b-a16e", "chameleon-34b",
                                  "seamless-m4t-large-v2"])
def test_configs_equal_jax(jx, arch):
    from repro.models.config import param_count as jcount

    for reduced in (False, True):
        want = jx.configs.get_config(arch, reduced=reduced)
        got = tconfigs.get_config(arch, reduced=reduced)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert tconfig.param_count(got) == jcount(want)
    for shape in jx.configs.SHAPES.values():
        assert tconfigs.shape_applicable(got, tconfigs.SHAPES[shape.name]) == \
            jx.configs.shape_applicable(want, shape)


def test_sable_configs_and_patterns_equal_jax(jx):
    """llama3-8b-sable by name; its FFN patterns are the reference's (896
    tiles of 128 x 128 a matrix at full width)."""
    from repro.configs import llama3_8b as jl

    for ctor, reduced in (("full_sable", False), ("reduced_sable", True)):
        want, got = getattr(jl, ctor)(), tconfigs.get_config("llama3-8b-sable", reduced=reduced)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    full = tconfigs.get_config("llama3-8b-sable")
    pats = tlayers.sable_patterns(full)
    assert [(p.n_tiles, p.tm, p.tk) for p in pats.values()] == [(896, 128, 128)] * 2
    jpats = jx.layers.sable_patterns(jl.full_sable())
    for k in ("in", "out"):
        assert dataclasses.asdict(pats[k]) == dataclasses.asdict(jpats[k])
    assert tconfigs.ARCH_IDS == jx.configs.ARCH_IDS
    for arch in tconfigs.ARCH_IDS:  # every arch of the pool is ported
        assert tconfigs.get_config(arch).name == arch
    for arch in ("mamba2-1.3b", "jamba-1.5-large-398b",  # ported with the Mamba slice
                 "seamless-m4t-large-v2"):  # ported with the encoder-decoder slice
        for reduced in (False, True):
            assert dataclasses.asdict(tconfigs.get_config(arch, reduced=reduced)) == \
                dataclasses.asdict(jx.configs.get_config(arch, reduced=reduced))
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-2")


# ---------------------------------------------------------------------- #
# layers and attention
# ---------------------------------------------------------------------- #
def test_rmsnorm_and_rope_match_jax(jx):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(jx.layers.rmsnorm(jx.jnp.asarray(x), jx.jnp.asarray(w), 1e-5))
    np.testing.assert_allclose(tlayers.rmsnorm(torch.as_tensor(x), torch.as_tensor(w)).numpy(),
                               want, rtol=1e-6, atol=1e-6)
    for pos in (np.arange(5), np.array([[3], [9]]) + np.zeros((2, 5), np.int64)):
        for theta in (10000.0, 500000.0):
            want = np.asarray(jx.layers.rope(jx.jnp.asarray(x), jx.jnp.asarray(pos), theta))
            got = tlayers.rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["no-cache", "prefill-cache", "decode-cache", "chunked"])
def test_gqa_apply_matches_jax(jx, case):
    """gqa_apply with qk-norm, without a cache, filling one at 0, decoding
    one token at position 6 of it, and through the chunked (flash) path."""
    cfg = _gqa_cfg()
    if case == "chunked":
        cfg = dataclasses.replace(cfg, attn_chunk=4)
    jcfg = _f32(jx.configs.get_config("chameleon-34b", reduced=True))
    jcfg = dataclasses.replace(jcfg, attn_chunk=cfg.attn_chunk)
    rng = np.random.default_rng(1)
    p = jx.jax.tree.map(np.asarray, jx.attn.gqa_init(jx.jax.random.PRNGKey(3), jcfg))
    p["qn"] = rng.standard_normal(p["qn"].shape).astype(np.float32)
    B, S, S_max = 2, (1 if case == "decode-cache" else 9), 12
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    kv = (B, S_max, cfg.n_kv_heads, cfg.head_dim)
    cache = None
    pos0 = 6 if case == "decode-cache" else 0
    if case != "no-cache":
        cache = {"k": rng.standard_normal(kv).astype(np.float32),
                 "v": rng.standard_normal(kv).astype(np.float32)}
    positions = pos0 + np.arange(S)

    def jfn(p, x, cache):
        return jx.attn.gqa_apply(p, x, jcfg, jx.jnp.asarray(positions), cache=cache,
                                 cache_pos=pos0 if cache is not None else None)

    want_o, want_c = jx.jax.jit(jfn)(p, x, cache)
    tc = None if cache is None else {k: torch.as_tensor(v.copy()) for k, v in cache.items()}
    got_o, got_c = tattn.gqa_apply(params_from_arrays(p, device=CPU), torch.as_tensor(x), cfg,
                                   torch.as_tensor(positions), cache=tc,
                                   cache_pos=pos0 if tc is not None else None)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    if cache is not None:
        assert got_c is tc  # written in place
        for k in ("k", "v"):
            np.testing.assert_allclose(got_c[k].numpy(), np.asarray(want_c[k]), **TOL)


@pytest.mark.parametrize("causal,q_offset,Sk", [(True, 0, 10), (True, 3, 13), (False, 0, 10)])
def test_sdpa_chunked_matches_sdpa(jx, causal, q_offset, Sk):
    """The streaming softmax against the materialized one (a last chunk cut
    short; queries past the first keys) and against the reference's."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 10, 2, 3, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, Sk, 2, 8)).astype(np.float32) for _ in range(2))
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    got = tattn._sdpa_chunked(tq, tk, tv, q_offset, causal, 4)
    mask = tattn.causal_mask(10, Sk, q_offset, CPU) if causal else None
    np.testing.assert_allclose(got.numpy(), tattn._sdpa(tq, tk, tv, mask).numpy(),
                               rtol=1e-5, atol=1e-5)
    want = jx.jax.jit(lambda q, k, v: jx.attn._sdpa_chunked(q, k, v, q_offset, causal, 4))(
        q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------- #
# the whole model
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", sorted(MODELS))
def test_prefill_and_decode_logits_match_jax(jx, plan_dir, arch):
    """prefill, then two decode steps, and a prefill in two chunks, on the
    reference's params: logits and the cache at 1e-4."""
    jcfg, tcfg = (_f32(c) for c in _configs(jx, arch))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    p = jx.jax.tree.map(np.asarray, jx.tr.init_params(jcfg, jx.jax.random.PRNGKey(0)))
    tp = params_from_arrays(p, device=CPU)
    B, P, S_max = 2, 7, 12
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, P)).astype(np.int32)
    nxt = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, B, 1)).astype(np.int32)

    jpre = jx.jax.jit(lambda p, t, c: jx.tr.prefill(p, jcfg, t, c))
    jdec = jx.jax.jit(lambda p, t, c, pos: jx.tr.decode_step(p, jcfg, t, c, pos))
    wl, wc = jpre(p, toks, jx.tr.init_cache(jcfg, B, S_max))
    want = [np.asarray(wl)]
    for i in range(2):
        wl, wc = jdec(p, nxt[i], wc, P + i)
        want.append(np.asarray(wl))

    cache = ttr.init_cache(tcfg, B, S_max, device=CPU)
    gl, cache = ttr.prefill(tp, tcfg, torch.as_tensor(toks).long(), cache)
    got = [gl.numpy()]
    for i in range(2):
        gl, cache = ttr.decode_step(tp, tcfg, torch.as_tensor(nxt[i]).long(), cache, P + i)
        got.append(gl.numpy())
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, 1, jcfg.vocab_size)
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(cache[0]["sub0"]["attn"]["k"].numpy(),
                               np.asarray(wc[0]["sub0"]["attn"]["k"]), **TOL)

    # the prompt in two chunks gives the one-shot prefill's logits and cache
    c2 = ttr.init_cache(tcfg, B, S_max, device=CPU)
    _, c2 = ttr.prefill_chunk(tp, tcfg, torch.as_tensor(toks[:, :4]).long(), c2, 0)
    l2, c2 = ttr.prefill_chunk(tp, tcfg, torch.as_tensor(toks[:, 4:]).long(), c2, 4)
    np.testing.assert_allclose(l2.numpy(), want[0], **TOL)


@pytest.mark.parametrize("S", [1, 5])
def test_sable_ffn_through_cuda_is_row_major(plan_dir, S):
    """The SABLE FFN through the cuda strategy (K2's plain version on the
    CPU) gives grouped's values in row-major strides: K2's transposed
    output, added to a (B, 1, d) residual stream, would send every later
    matmul through bmm."""
    from repro_torch.sparse import linear as tlin

    cfg = _f32(tconfigs.get_config("llama3-8b-sable", reduced=True))
    p = tlayers.ffn_init(torch.Generator().manual_seed(0), cfg, device=CPU)
    x = torch.randn((3, S, cfg.d_model), generator=torch.Generator().manual_seed(1))
    hashes = [tlin.pattern_hash(q) for q in tlayers.sable_patterns(cfg).values()]
    out = {}
    for strategy in ("grouped", "cuda"):
        for h in hashes:
            tlin._STRATEGY_REGISTRY[f"{h}@torchcpu"] = strategy
        out[strategy] = tlayers.ffn_apply(p, x, cfg)
    assert out["cuda"].stride() == out["grouped"].stride() == torch.empty_like(x).stride()
    torch.testing.assert_close(out["cuda"], out["grouped"], rtol=1e-5, atol=1e-5)


def test_init_params_layout_matches_jax(jx):
    """The port's init_params draws the reference's tree: the same keys and
    shapes, stacked (repeat, ...) per group, in the config's param dtype."""
    for arch in sorted(MODELS):
        jcfg, tcfg = _configs(jx, arch)
        shapes = jx.jax.eval_shape(lambda k: jx.tr.init_params(jcfg, k),
                                   jx.jax.random.PRNGKey(0))
        tp = ttr.init_params(tcfg, torch.Generator().manual_seed(0), device=CPU)
        want = jx.jax.tree.map(lambda a: tuple(a.shape), shapes)
        got = _shapes(tp)
        assert got == want, arch
        assert tp["embed"].dtype == torch.float32
    bf = ttr.init_params(dataclasses.replace(tcfg, param_dtype="bfloat16"),
                         torch.Generator().manual_seed(0), device=CPU)
    assert bf["groups"][0]["sub0"]["ffn"]["w1"].dtype == torch.bfloat16


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_left_out_parts_raise():
    """Sharding is a later slice: the sparse FFN's mesh= and shard= raise.
    Cross-attention and the encoder run (tests/test_torch_encdec.py): a
    cross-attention layer without the encoder's output outside a cached
    decode step is a ValueError."""
    from repro_torch.sparse import linear as tlin

    cfg = _f32(tconfigs.get_config("llama3-8b-sable", reduced=True))
    p = tlayers.ffn_init(torch.Generator().manual_seed(0), cfg, device=CPU)
    x = torch.zeros((1, 2, cfg.d_model))
    pat = tlayers.sable_patterns(cfg)["in"]
    for kw in ({"mesh": object()}, {"shard": object()}):
        with pytest.raises(NotImplementedError, match="sharding slice"):
            tlin.sparse_matmul_auto(x, p["w1"], pat, **kw)
    with pytest.raises(NotImplementedError, match="sharding slice"):
        tlin.warm_matmul_plans([pat], mesh=object())
    sm = _f32(tconfigs.get_config("seamless-m4t-large-v2", reduced=True))
    gen = torch.Generator().manual_seed(0)
    assert set(tattn.cross_init(gen, sm, device=CPU)) == {"wq", "wk", "wv", "wo"}
    params = ttr.init_params(sm, gen, device=CPU)
    cache = ttr.init_cache(sm, 1, 4, enc_len=3, device=CPU)
    with pytest.raises(ValueError, match="enc_out"):
        ttr.prefill(params, sm, torch.zeros((1, 2), dtype=torch.long), cache)


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #
def _two_layer_full_width():
    cfg = tconfigs.get_config("llama3-8b-sable")
    return dataclasses.replace(_f32(cfg), groups=tconfig.uniform_groups(
        2, tconfig.LayerSpec(mixer="gqa", ffn="dense")))


@requires_cuda
def test_full_width_prefill_cuda_matches_grouped_on_card(plan_dir):
    """A 2-layer llama3-8b-sable at full width in float32: the prefill
    logits through K2 (both FFN patterns pinned to cuda) agree with those
    through grouped to 1e-4 of max|logits|; one forward launches K2 3 times
    a layer."""
    from repro_torch.kernels import ops as kops
    from repro_torch.sparse import linear as tlin

    cfg = _two_layer_full_width()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = ttr.init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen, device="cuda")
    dev = toks.device
    hashes = [tlin.pattern_hash(p) for p in tlayers.sable_patterns(cfg).values()]
    logits = {}
    for strategy in ("grouped", "cuda"):
        for h in hashes:
            tlin._STRATEGY_REGISTRY[f"{h}@cuda"] = strategy
        before = kops.launches["bsr_spmm"]
        logits[strategy], _ = ttr.prefill(params, cfg, toks, ttr.init_cache(cfg, 2, 128))
        torch.cuda.synchronize(dev)
        launched = kops.launches["bsr_spmm"] - before
        assert launched == (3 * 2 if strategy == "cuda" else 0)
    scale = logits["grouped"].abs().max()
    assert (logits["cuda"] - logits["grouped"]).abs().max() <= 1e-4 * scale
