"""PyTorch port, MLA and the MoE models served: ``repro_torch.models.attention``
(``mla_apply``), the DeepSeek-V2 and llama4-scout models, the scheduler's
lane step on them and the paged cache's MLA leaves, against the JAX
package's on the same numpy inputs.

Params come from the reference's ``init_params`` (``jax.random`` streams
cannot be reproduced in torch) and are carried across with
``convert.params_from_arrays``. Compute runs in float32: attention outputs
and logits agree to 1e-4, as in tests/test_torch_models.py. Each reference
function is jitted once per config (module-scoped fixtures). The card tests
hold a 2-layer DeepSeek-V2 and a 1-layer llama4-scout at full width in
float32 to their capacity paths and their absorbed decode to a
materialized prefill.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_arrays  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve.paged_cache import PagedKVCache, flatten, unflatten  # noqa: E402
from test_torch_linear import _sealed_reference_plans  # noqa: E402,F401 (autouse)

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-4)
DS, L4 = "deepseek-v2-236b", "llama4-scout-17b-a16e"
requires_cuda = pytest.mark.requires_cuda


@pytest.fixture(autouse=True)
def _card(request):
    """Tests marked requires_cuda skip without a card: decided here, when the
    test runs, so that every worker collects the same tests."""
    if request.node.get_closest_marker("requires_cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the kernels")


def _f32(cfg, dropless=None):
    cfg = dataclasses.replace(cfg, compute_dtype="float32", param_dtype="float32")
    if dropless is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dropless=dropless))
    return cfg


@pytest.fixture(scope="module")
def jx():
    """The reference's modules on JAX's CPU device in full float32, and a
    jit of each function once per (name, config)."""
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.models import attention, transformer
    from repro.serve import engine, paged_cache

    compiled = {}

    def jit(name, cfg, fn):
        if (name, cfg) not in compiled:
            compiled[(name, cfg)] = jax.jit(fn)
        return compiled[(name, cfg)]

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(jax=jax, configs=configs, attn=attention, tr=transformer,
                              engine=engine, paged_cache=paged_cache, jit=jit)


def _configs(jx, arch, dropless=None):
    jcfg = _f32(jx.configs.get_config(arch, reduced=True), dropless)
    tcfg = _f32(tconfigs.get_config(arch, reduced=True), dropless)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models(jx):
    """The reference's params for each reduced arch, as numpy and carried
    across to the port."""
    out = {}
    for arch in (DS, L4):
        jcfg, _ = _configs(jx, arch)
        p = jx.jax.tree.map(np.asarray, jx.tr.init_params(jcfg, jx.jax.random.PRNGKey(0)))
        out[arch] = SimpleNamespace(p=p, tp=params_from_arrays(p, device=CPU))
    return out


# ---------------------------------------------------------------------- #
# mla_apply
# ---------------------------------------------------------------------- #
MLA_CASES = {  # name: (S, cache_pos or None for no cache)
    "no-cache": (9, None),
    "prefill-cache": (9, 0),
    "absorbed-decode": (1, 6),
    "chunked-prefill": (4, 5),  # a second chunk: the materialized path over the cache
}


def _mla_inputs(cfg, B, S, S_max, seed):
    rng = np.random.default_rng(seed)
    m = cfg.mla
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    cache = {"ckv": rng.standard_normal((B, S_max, m.kv_lora_rank)).astype(np.float32),
             "kr": rng.standard_normal((B, S_max, m.qk_rope_dim)).astype(np.float32)}
    return x, cache


@pytest.mark.parametrize("case", sorted(MLA_CASES))
def test_mla_apply_matches_jax(jx, case):
    """mla_apply without a cache, filling one at 0, decoding one token at
    position 6 (the absorbed formulation), and a chunk of four at 5 (the
    materialized one over the cache): the output and the cache written in
    place at 1e-4; the decode step's materialized formulation agrees with
    its absorbed one."""
    jcfg, cfg = _configs(jx, DS)
    S, pos0 = MLA_CASES[case]
    rng = np.random.default_rng(1)
    p = jx.jax.tree.map(np.asarray, jx.attn.mla_init(jx.jax.random.PRNGKey(3), jcfg))
    p["qln"] = (1 + 0.1 * rng.standard_normal(p["qln"].shape)).astype(np.float32)
    p["kvln"] = (1 + 0.1 * rng.standard_normal(p["kvln"].shape)).astype(np.float32)
    x, cache = _mla_inputs(cfg, 2, S, 12, seed=2)
    if pos0 is None:
        cache = None
    positions = (pos0 or 0) + np.arange(S)

    def jfn(p, x, cache):
        return jx.attn.mla_apply(p, x, jcfg, jx.jax.numpy.asarray(positions), cache=cache,
                                 cache_pos=pos0)

    want_o, want_c = jx.jax.jit(jfn)(p, x, cache)
    tp = params_from_arrays(p, device=CPU)
    tc = None if cache is None else {k: torch.as_tensor(v.copy()) for k, v in cache.items()}
    got_o, got_c = tattn.mla_apply(tp, torch.as_tensor(x), cfg, torch.as_tensor(positions),
                                   cache=tc, cache_pos=pos0)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    if cache is None:
        assert got_c is None and want_c is None
        return
    assert got_c is tc  # written in place
    for k in ("ckv", "kr"):
        np.testing.assert_allclose(got_c[k].numpy(), np.asarray(want_c[k]), **TOL)
    if case == "absorbed-decode":
        tc2 = {k: torch.as_tensor(v.copy()) for k, v in cache.items()}
        mat, _ = tattn.mla_apply(tp, torch.as_tensor(x), cfg, torch.as_tensor(positions),
                                 cache=tc2, cache_pos=pos0, absorb=False)
        np.testing.assert_allclose(mat.numpy(), got_o.numpy(), rtol=1e-5, atol=1e-5)


def test_mla_per_lane_cache_pos_equals_single_lane_calls():
    """A (B,) tensor cache_pos (the scheduler's lane step) writes each lane
    at its own position and masks each lane at its own: the same output and
    cache as B single-lane calls at int positions."""
    cfg = _f32(tconfigs.get_config(DS, reduced=True))
    p = tattn.mla_init(torch.Generator().manual_seed(0), cfg, device=CPU)
    x, cache = _mla_inputs(cfg, 3, 1, 12, seed=4)
    pos = [2, 9, 5]
    tc = {k: torch.as_tensor(v.copy()) for k, v in cache.items()}
    out, _ = tattn.mla_apply(p, torch.as_tensor(x), cfg, torch.as_tensor(pos)[:, None],
                             cache=tc, cache_pos=torch.as_tensor(pos))
    for b, pb in enumerate(pos):
        one = {k: torch.as_tensor(v[b:b + 1].copy()) for k, v in cache.items()}
        o1, _ = tattn.mla_apply(p, torch.as_tensor(x[b:b + 1]), cfg, torch.as_tensor([pb]),
                                cache=one, cache_pos=pb)
        torch.testing.assert_close(out[b:b + 1], o1, rtol=1e-5, atol=1e-5)
        for k in ("ckv", "kr"):
            torch.testing.assert_close(tc[k][b:b + 1], one[k], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------- #
# the models
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("path", ["dropless", "capacity"])
@pytest.mark.parametrize("arch", [DS, L4])
def test_prefill_decode_and_chunks_match_jax(jx, models, arch, path):
    """prefill, two decode steps, and a prefill in two chunks, on the
    reference's params: logits and the cache at 1e-4, through the dropless
    MoE (sdd/dsd) and through the capacity path."""
    jcfg, tcfg = _configs(jx, arch, dropless=path == "dropless")
    m = models[arch]
    B, P, S_max = 2, 7, 12
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, P)).astype(np.int32)
    nxt = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, B, 1)).astype(np.int32)

    jpre = jx.jit("prefill", jcfg, lambda p, t, c: jx.tr.prefill(p, jcfg, t, c))
    jdec = jx.jit("decode", jcfg, lambda p, t, c, pos: jx.tr.decode_step(p, jcfg, t, c, pos))
    wl, wc = jpre(m.p, toks, jx.tr.init_cache(jcfg, B, S_max))
    want = [np.asarray(wl)]
    for i in range(2):
        wl, wc = jdec(m.p, nxt[i], wc, P + i)
        want.append(np.asarray(wl))

    cache = ttr.init_cache(tcfg, B, S_max, device=CPU)
    gl, cache = ttr.prefill(m.tp, tcfg, torch.as_tensor(toks).long(), cache)
    got = [gl.numpy()]
    for i in range(2):
        gl, cache = ttr.decode_step(m.tp, tcfg, torch.as_tensor(nxt[i]).long(), cache, P + i)
        got.append(gl.numpy())
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, 1, jcfg.vocab_size)
        np.testing.assert_allclose(g, w, **TOL)
    got_c, want_c = flatten(cache)[0], flatten(jx.jax.tree.map(np.asarray, wc))[0]
    assert len(got_c) == len(want_c)
    for g, w in zip(got_c, want_c):
        np.testing.assert_allclose(g.numpy(), w, **TOL)

    # the prompt in two chunks gives the one-shot prefill's logits
    c2 = ttr.init_cache(tcfg, B, S_max, device=CPU)
    _, c2 = ttr.prefill_chunk(m.tp, tcfg, torch.as_tensor(toks[:, :4]).long(), c2, 0)
    l2, c2 = ttr.prefill_chunk(m.tp, tcfg, torch.as_tensor(toks[:, 4:]).long(), c2, 4)
    np.testing.assert_allclose(l2.numpy(), want[0], **TOL)


@pytest.mark.parametrize("arch", [DS, L4])
def test_init_params_layout_and_carry_match_jax(jx, models, arch):
    """The port's init_params draws the reference's tree (DeepSeek-V2's two
    groups of different specs, MLA's seven leaves, the MoE's shared
    experts), and params_from_arrays carries the reference's tree across
    leaf for leaf; both configs' param counts are the reference's."""
    from repro.models.config import param_count as jcount

    jcfg, tcfg = _configs(jx, arch)
    shapes = jx.jax.eval_shape(lambda k: jx.tr.init_params(jcfg, k), jx.jax.random.PRNGKey(0))
    tp = ttr.init_params(tcfg, torch.Generator().manual_seed(0), device=CPU)
    want = jx.jax.tree.map(lambda a: tuple(a.shape), shapes)
    assert _shapes(tp) == want
    assert _shapes(models[arch].tp) == want
    for got, ref in zip(flatten(models[arch].tp)[0], flatten(models[arch].p)[0]):
        np.testing.assert_array_equal(got.numpy(), ref)
    if arch == DS:
        assert sorted(tp["groups"][0]["sub0"]["mixer"]) == sorted(
            ["wdq", "qln", "wuq", "wdkv", "kvln", "wukv", "wo"])
        assert "ffn" in tp["groups"][0]["sub0"] and "moe" in tp["groups"][1]["sub0"]
    for full in (False, True):
        j, t = jx.configs.get_config(arch, reduced=not full), tconfigs.get_config(
            arch, reduced=not full)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert tconfig.param_count(t) == jcount(j)
        assert tconfig.param_count(t, active=True) == jcount(j, active=True)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


# ---------------------------------------------------------------------- #
# the paged cache's MLA leaves
# ---------------------------------------------------------------------- #
def test_mla_leaves_page_and_round_trip(jx):
    """The latent leaves ckv and kr (stacked (repeat, B, S, C)) page through
    the structural classifier as the reference's do (the same flags and
    arena shapes); write_prefill, gather, evict and resume give them back
    bit for bit, and the zero page stays zero."""
    jcfg, cfg = _configs(jx, DS)
    kv = PagedKVCache(cfg, num_pages=12, page_size=4, max_len=16, dtype=torch.float32,
                      device=CPU)
    jkv = jx.paged_cache.PagedKVCache(jcfg, num_pages=12, page_size=4, max_len=16)
    assert kv.paged == list(jkv.paged) == [True] * 4
    assert [tuple(a.shape) for a in kv._arenas] == [tuple(a.shape) for a in jkv._arenas]
    m = cfg.mla
    assert {tuple(a.shape[3:]) for a in kv._arenas} == {(m.kv_lora_rank,), (m.qk_rope_dim,)}
    rng = np.random.default_rng(6)
    n = 11
    leaves, spec = flatten(ttr.init_cache(cfg, 1, n, device=CPU))
    dense = [torch.as_tensor(rng.standard_normal(tuple(x.shape)).astype(np.float32))
             for x in leaves]
    assert kv.alloc_seq("a", n, zero=False)
    kv.write_prefill("a", unflatten(spec, dense), n)
    assert all(torch.equal(a, b) for a, b in zip(flatten(kv.read_dense("a"))[0], dense))
    view = flatten(kv.gather(["a", None]))[0]
    for v, d in zip(view, dense):
        assert torch.equal(v[:, :1, :n], d)
        assert not bool(v[:, :1, n:].any()) and not bool(v[:, 1].any())
    kv.evict("a")
    assert kv.allocator.num_held == 0
    assert kv.resume("a")
    assert all(torch.equal(a, b) for a, b in zip(flatten(kv.gather(["a", None]))[0], view))
    assert not any(bool(a[kv.zero_page].any()) for a in kv._arenas)


# ---------------------------------------------------------------------- #
# the scheduler on reduced DeepSeek-V2
# ---------------------------------------------------------------------- #
def _fake_clock(step=0.5):
    counter = iter(range(10**9))
    return lambda: next(counter) * step


def _forced_router(p):
    """Every MoE layer's router ranks expert 0 first and 1 second for any
    positive input (column e scaled by E - e), and every embedding row is
    shifted by +10, so the MoE inputs (rmsnorm of a residual stream the
    embedding dominates) are positive: every token routes to experts 0 and
    1, and 16 lanes in one group of the capacity path would drop 8 of them
    on each (C = 8)."""
    p = _tree_copy(p)
    p["embed"] = p["embed"] + 10.0
    for g in p["groups"]:
        for sub in g.values():
            if "moe" in sub:
                E = sub["moe"]["router"].shape[-1]
                col = (E - np.arange(E, dtype=np.float32)) * 0.5
                sub["moe"]["router"] = np.broadcast_to(
                    col, sub["moe"]["router"].shape).copy()
    return p


def _tree_copy(tree):
    """A params tree's dicts and lists copied (its arrays shared), so that
    replacing a leaf leaves the module fixture's tree as it was."""
    if isinstance(tree, dict):
        return {k: _tree_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_copy(v) for v in tree]
    return tree


SCHED_CASES = {  # name: (prompt lengths, new tokens, dropless, forced routing, serve kwargs)
    "evict-share-chunk": ([14, 15, 13, 15], [5, 4, 6, 3], True, False,
                          dict(page_size=4, max_batch=2, num_pages=7, prefix_sharing=True,
                               chunked_prefill=True, prefill_chunk=8)),
    "16-lanes-capacity": ([3 + i % 4 for i in range(16)], [3] * 16, False, True,
                          dict(page_size=4, max_batch=16)),
}


@pytest.mark.parametrize("name", sorted(SCHED_CASES))
def test_scheduler_matches_jax_scheduler_and_generate(jx, models, name):
    """Reduced DeepSeek-V2 through the port's scheduler and the JAX
    scheduler: the same transcript and stats, greedy tokens equal to the JAX
    scheduler's and to the port's generate on each request alone, every
    step's logits within 1e-4 of the JAX scheduler's. "evict-share-chunk":
    the dropless path (a capacity path's drops depend on how a prompt is
    chunked, so only a dropless one meets generate), prefix sharing and
    chunked prefill (the materialized MLA path over the gathered view) under
    page pressure, with evictions and resumes. "16-lanes-capacity": the
    config's capacity path, sixteen lanes decoding together with routing
    forced onto two experts, where one group of 16 would drop what the
    reference (a vmap of single-lane steps) keeps."""
    lengths, gens, dropless, forced, kw = SCHED_CASES[name]
    jcfg, tcfg = _configs(jx, DS, dropless=dropless)
    p = _forced_router(models[DS].p) if forced else models[DS].p
    tp = params_from_arrays(p, device=CPU)
    rng = np.random.default_rng(8)
    shared = rng.integers(0, jcfg.vocab_size, 8)
    prompts = [np.concatenate([shared, rng.integers(0, jcfg.vocab_size, n - 8)]).astype(
        np.int32) if kw.get("prefix_sharing") else rng.integers(0, jcfg.vocab_size, n).astype(
        np.int32) for n in lengths]
    reqs = [dict(prompt=q, max_new_tokens=g, rid=f"m{i}", arrival=float(i))
            for i, (q, g) in enumerate(zip(prompts, gens))]
    max_len = 24
    jeng = jx.engine.ServeEngine(jcfg, p, max_len=max_len)
    jres, jsched = jeng.serve(reqs, clock=_fake_clock(), record_logits=True, **kw)
    eng = tengine.ServeEngine(tcfg, tp, max_len=max_len, device=CPU)
    res, sched = eng.serve(reqs, clock=_fake_clock(), record_logits=True, **kw)
    assert sched.transcript == jsched.transcript and sched.stats == jsched.stats
    if name == "evict-share-chunk":
        assert sched.stats["evictions"] > 0 and sched.stats["resumes"] > 0
        assert sched.stats["prefix_hits"] >= 1 and sched.stats["prefill_chunks"] > len(reqs)
    else:
        assert max(len(ev["running"]) for ev in sched.transcript) == 16
    for r in reqs:
        rid = r["rid"]
        assert res[rid]["state"] == "FINISHED"
        np.testing.assert_array_equal(res[rid]["tokens"], np.asarray(jres[rid]["tokens"]))
        got, want = sched.requests[rid].logits, jsched.requests[rid].logits
        assert len(got) == len(want) == r["max_new_tokens"]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
    for r in reqs[:4]:
        out, _ = eng.generate(r["prompt"][None], r["max_new_tokens"])
        np.testing.assert_array_equal(res[r["rid"]]["tokens"], out[0].numpy())


# ---------------------------------------------------------------------- #
# on the card: the checks of chip_smoke phase 11.2 at full width
# ---------------------------------------------------------------------- #
def _full_width(arch, layers):
    """The arch at full width in float32, cut to ``layers`` layers (DeepSeek
    keeps its dense layer 0), dropless."""
    cfg = _f32(tconfigs.get_config(arch), dropless=True)
    if arch == DS:
        g0, g1 = cfg.groups
        groups = (g0, dataclasses.replace(g1, repeat=layers - 1))
    else:
        groups = tconfig.uniform_groups(layers, tconfig.LayerSpec(mixer="gqa", ffn="moe"))
    return dataclasses.replace(cfg, groups=groups)


@requires_cuda
@pytest.mark.parametrize("arch,layers", [(DS, 2), (L4, 1)])
def test_full_width_dropless_and_absorbed_decode_on_card(arch, layers):
    """At full width in float32 (TF32 off): the prefill logits through the
    dropless path (K3 twice and K2 once a MoE layer) match the capacity path
    with capacity_factor = E / top_k (nothing dropped) within 1e-4 of
    max|logits|; 4 greedy decode steps give the logits that a prefill over
    the longer sequence gives (for DeepSeek-V2, the absorbed MLA against the
    materialized one), and the same tokens."""
    from repro_torch.kernels import ops as kops

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _full_width(arch, layers)
    mc = cfg.moe
    cap = dataclasses.replace(cfg, moe=dataclasses.replace(
        mc, dropless=False, capacity_factor=mc.num_experts / mc.top_k))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = ttr.init_params(cfg, gen)
    B, P, steps = 2, 64, 4
    toks = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device="cuda")
    n_moe = sum(g.repeat for g in cfg.groups for s in g.layers if s.ffn == "moe")
    with torch.inference_mode():
        before = dict(kops.launches)
        lg, cache = ttr.prefill(params, cfg, toks, ttr.init_cache(cfg, B, P + steps))
        torch.cuda.synchronize()
        assert kops.launches["bsr_sdd"] - before["bsr_sdd"] == 2 * n_moe
        assert kops.launches["bsr_spmm"] - before["bsr_spmm"] == n_moe
        lc, _ = ttr.prefill(params, cap, toks, ttr.init_cache(cap, B, P))
        scale = lc.abs().max()
        assert (lg - lc).abs().max() <= 1e-4 * scale
        seq, rows = toks, []
        for i in range(steps):
            nxt = torch.argmax(lg[:, -1].float(), dim=-1, keepdim=True)
            seq = torch.cat([seq, nxt], dim=1)
            lg, cache = ttr.decode_step(params, cfg, nxt, cache, P + i)
            rows.append(lg[:, 0])
        for i, row in enumerate(rows):
            want, _ = ttr.prefill(params, cfg, seq[:, :P + i + 1],
                                  ttr.init_cache(cfg, B, P + i + 1))
            assert (row - want[:, 0]).abs().max() <= 1e-4 * want.abs().max()
            assert torch.equal(row.argmax(-1), want[:, 0].argmax(-1))
