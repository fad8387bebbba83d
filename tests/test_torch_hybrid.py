"""PyTorch port, the Mamba-2 models served: mamba2-1.3b (every cache leaf
per-sequence state) and jamba-1.5-large (Mamba and attention sub-layers in
one group, MoE on every second layer: paged KV and state leaves in one
cache), reduced, against the JAX package's on the same params and tokens.

Params come from the reference's ``init_params`` and are carried across
with ``convert.params_from_arrays``; compute runs in float32. Logits agree
to 1e-4 (as in tests/test_torch_models.py): prefill and each decode step
against the reference's ``prefill`` and ``decode_step``, and against its
``forward_train`` over the same tokens, teacher-forced. jamba's MoE runs at
capacity_factor 16, where no token drops whatever the routing groups, and
its dropless path (the plain versions of K3 and K2 behind the kernel
wrappers) gives the same logits. Greedy tokens equal the reference's
``ServeEngine.generate``; ``serve`` repeats the reference scheduler's
transcript, stats, tokens and logits under an eviction, whose state comes
back bit for bit. The paged cache keeps state leaves through random
operations as a dense reference does (a counterpart of
tests/test_paged_cache.py's mamba round trip, without its deadline). Each
reference function is jitted once per config (module-scoped fixtures).
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # keep deterministic sampling without hypothesis
    from _hypothesis_stub import given, settings, st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_arrays  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve.paged_cache import PagedKVCache, flatten, unflatten  # noqa: E402
from test_torch_linear import _sealed_reference_plans  # noqa: E402,F401 (autouse)
from test_torch_paged_cache import _DenseRef, _random_prefill_cache, _random_slices  # noqa: E402

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-4)
MAMBA2, JAMBA = "mamba2-1.3b", "jamba-1.5-large-398b"
ARCHS = (MAMBA2, JAMBA)
requires_cuda = pytest.mark.requires_cuda


@pytest.fixture(autouse=True)
def _card(request):
    """Tests marked requires_cuda skip without a card: decided here, when the
    test runs, so that every worker collects the same tests."""
    if request.node.get_closest_marker("requires_cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the kernels")


def _f32(cfg, dropless=None):
    """float32, and jamba's MoE at capacity_factor 16 (nothing drops) or
    dropless."""
    cfg = dataclasses.replace(cfg, compute_dtype="float32", param_dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0, dropless=bool(dropless)))
    return cfg


@pytest.fixture(scope="module")
def jx():
    """The reference's modules on JAX's CPU device in full float32, and a
    jit of each function once per (name, config)."""
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.models import transformer
    from repro.serve import engine

    compiled = {}

    def jit(name, cfg, fn):
        if (name, cfg) not in compiled:
            compiled[(name, cfg)] = jax.jit(fn)
        return compiled[(name, cfg)]

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(jax=jax, configs=configs, tr=transformer, engine=engine, jit=jit)


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
    for arch in ARCHS:
        jcfg, _ = _configs(jx, arch)
        p = jx.jax.tree.map(np.asarray, jx.tr.init_params(jcfg, jx.jax.random.PRNGKey(0)))
        out[arch] = SimpleNamespace(p=p, tp=params_from_arrays(p, device=CPU))
    return out


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _port_steps(tp, cfg, toks, nxt, s_max):
    """The port's prefill logits (B, 1, V), then one decode step per column
    of ``nxt``; and the cache after them."""
    cache = ttr.init_cache(cfg, toks.shape[0], s_max, device=CPU)
    gl, cache = ttr.prefill(tp, cfg, torch.as_tensor(toks).long(), cache)
    got = [gl.numpy()]
    P = toks.shape[1]
    for i in range(nxt.shape[1]):
        gl, cache = ttr.decode_step(tp, cfg, torch.as_tensor(nxt[:, i:i + 1]).long(), cache,
                                    P + i)
        got.append(gl.numpy())
    return got, cache


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(jx, models, arch):
    """A 21-token prompt (two SSD chunks of 16, the second ragged), then 3
    decode steps: logits and the state leaves against the reference's
    prefill and decode_step, and the logits against its forward_train over
    the whole sequence, teacher-forced."""
    jcfg, tcfg = _configs(jx, arch)
    p, tp = models[arch].p, models[arch].tp
    B, P, n = 2, 21, 3
    toks, nxt = _tokens(jcfg, (B, P), 4), _tokens(jcfg, (B, n), 5)
    jpre = jx.jit("prefill", jcfg, lambda p, t, c: jx.tr.prefill(p, jcfg, t, c))
    jdec = jx.jit("decode", jcfg, lambda p, t, c, pos: jx.tr.decode_step(p, jcfg, t, c, pos))
    wl, wc = jpre(p, toks, jx.tr.init_cache(jcfg, B, P + n))
    want = [np.asarray(wl)]
    for i in range(n):
        wl, wc = jdec(p, nxt[:, i:i + 1], wc, P + i)
        want.append(np.asarray(wl))
    got, cache = _port_steps(tp, tcfg, toks, nxt, P + n)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, 1, jcfg.vocab_size)
        np.testing.assert_allclose(g, w, **TOL)
    leaves, _ = flatten(cache)
    jleaves = jx.jax.tree_util.tree_leaves(wc)
    assert [tuple(a.shape) for a in leaves] == [tuple(a.shape) for a in jleaves]
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert any("ssm_cache" in sub for sub in cache[0].values())

    # teacher-forced: logits at positions P-1 .. P+n-1 of the whole sequence
    seq = np.concatenate([toks, nxt], axis=1)
    full, _ = jx.jit("train", jcfg, lambda p, t: jx.tr.forward_train(p, jcfg, {"tokens": t}))(
        p, seq)
    full = np.asarray(full)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g[:, 0], full[:, P - 1 + i], **TOL)


def test_jamba_dropless_matches_capacity(jx, models, monkeypatch):
    """jamba's dropless MoE through the kernel wrappers (the plain versions
    of K3 and K2 on the CPU) gives the capacity path's logits at prefill and
    decode."""
    _, cap = _configs(jx, JAMBA, dropless=False)
    _, drop = _configs(jx, JAMBA, dropless=True)
    tp = models[JAMBA].tp
    calls = {"sdd": 0, "dsd": 0}

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, backend="cuda", **k)
        return run

    toks, nxt = _tokens(cap, (2, 21), 6), _tokens(cap, (2, 2), 7)
    want, _ = _port_steps(tp, cap, toks, nxt, 23)
    monkeypatch.setattr(tmoe, "sdd", counted("sdd", tmoe.sdd))
    monkeypatch.setattr(tmoe, "dsd", counted("dsd", tmoe.dsd))
    got, _ = _port_steps(tp, drop, toks, nxt, 23)
    n_moe = sum(s.ffn == "moe" for g in drop.groups for s in g.layers) * 3  # 3 forwards
    assert calls == {"sdd": 2 * n_moe, "dsd": n_moe}
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_match_jax(jx, models, arch):
    """Greedy generate: the reference engine's tokens."""
    jcfg, tcfg = _configs(jx, arch)
    prompts = _tokens(jcfg, (2, 9), 8)
    jeng = jx.engine.ServeEngine(jcfg, models[arch].p, max_len=20)
    want, _ = jeng.generate(jx.jax.numpy.asarray(prompts), 8)
    eng = tengine.ServeEngine(tcfg, models[arch].tp, max_len=20, device=CPU)
    got, stats = eng.generate(prompts, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["tokens_per_s"] > 0


def _fake_clock(step=0.5):
    counter = iter(range(10**9))
    return lambda: next(counter) * step


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax_scheduler_and_generate_with_eviction(jx, models, arch):
    """Five requests on two lanes with pages short enough to park one: the
    port's serve repeats the reference scheduler's transcript, stats, tokens
    and logits (1e-4), equals the port's generate on each request alone
    (the counterpart of tests/test_serve.py's pure-state serve test), and
    gives back each parked sequence's state leaves bit for bit."""
    jcfg, tcfg = _configs(jx, arch)
    lengths, gens = (6, 9, 5, 7, 3), (6, 5, 7, 4, 6)
    reqs = [dict(prompt=_tokens(jcfg, n, 20 + i), max_new_tokens=g, rid=f"h{i}",
                 arrival=float(i)) for i, (n, g) in enumerate(zip(lengths, gens))]
    kw = dict(page_size=4, max_batch=2, num_pages=6)
    jeng = jx.engine.ServeEngine(jcfg, models[arch].p, max_len=16)
    jres, jsched = jeng.serve(reqs, clock=_fake_clock(), record_logits=True, **kw)
    eng = tengine.ServeEngine(tcfg, models[arch].tp, max_len=16, device=CPU)
    sched = eng.make_scheduler(clock=_fake_clock(), record_logits=True, **kw)
    kv, parked, restored = sched.kv, {}, []
    evict, resume = kv.evict, kv.resume

    def spy_evict(rid):
        parked[rid] = flatten(kv.read_dense(rid))[0]
        evict(rid)

    def spy_resume(rid):
        ok = resume(rid)
        if ok:
            back = flatten(kv.read_dense(rid))[0]
            restored.append(all(torch.equal(a, b) for a, b in zip(back, parked.pop(rid))))
        return ok

    kv.evict, kv.resume = spy_evict, spy_resume
    for r in reqs:
        sched.submit(**r)
    res = sched.run()
    assert sched.transcript == jsched.transcript and sched.stats == jsched.stats
    assert sched.stats["evictions"] >= 1 and restored and all(restored)
    assert any(not p for p in kv.paged)
    assert all(not p for p in kv.paged) == (arch == MAMBA2)
    for r in reqs:
        rid = r["rid"]
        np.testing.assert_array_equal(res[rid]["tokens"], np.asarray(jres[rid]["tokens"]))
        for a, b in zip(sched.requests[rid].logits, jsched.requests[rid].logits):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
        out, _ = eng.generate(r["prompt"][None], r["max_new_tokens"])
        np.testing.assert_array_equal(res[rid]["tokens"], out[0].numpy())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("feature", ["prefix_sharing", "chunked_prefill"])
def test_state_caches_refuse_sharing_and_chunking(arch, feature):
    cfg = _f32(tconfigs.get_config(arch, reduced=True))
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    eng = tengine.ServeEngine(cfg, params, max_len=16, device=CPU)
    with pytest.raises(ValueError, match="fully-paged"):
        eng.make_scheduler(**{feature: True})


@pytest.mark.parametrize("arch", ARCHS)
@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_state_leaves_roundtrip(arch, seed):
    """State leaves classify as state, and survive prefill, appends, gather
    and an evict/resume bit for bit beside paged leaves (jamba); the zero
    page stays zero."""
    cfg = _f32(tconfigs.get_config(arch, reduced=True))
    rng = np.random.default_rng(seed)
    kv = PagedKVCache(cfg, num_pages=8, page_size=4, max_len=16, device=CPU)
    assert any(not p for p in kv.paged), "mamba must have state leaves"
    ref = _DenseRef(kv)
    assert kv.alloc_seq("m0", 5)
    cache, flat = _random_prefill_cache(cfg, 5, rng)
    kv.write_prefill("m0", cache, 5)
    ref.prefill("m0", flat, 5)
    for posn in range(5, 9):
        sl = _random_slices(kv, rng)
        kv.append_token("m0", sl, posn)
        ref.append("m0", sl, posn)
    ref.check("m0")
    view = flatten(kv.gather(["m0", None]))[0]
    for i, v in enumerate(view):
        assert not v[:, 1].any()  # the empty lane
        if not kv.paged[i]:
            np.testing.assert_array_equal(v[:, :1].numpy(), ref.seqs["m0"]["leaves"][i])
    kv.evict("m0")
    assert kv.is_parked("m0") and kv.allocator.num_held == 0
    assert kv.resume("m0")
    ref.check("m0")
    assert not any(bool(a[kv.zero_page].any()) for a in kv._arenas if a is not None)
    kv.free_seq("m0")
    kv.allocator.check()


def test_state_leaves_keep_the_cache_dtype():
    """A float32 write into a bfloat16 cache stores bfloat16 state, as the
    paged leaves store it."""
    cfg = tconfigs.get_config(MAMBA2, reduced=True)  # compute dtype bfloat16
    kv = PagedKVCache(cfg, num_pages=4, page_size=4, max_len=8, device=CPU)
    leaves, spec = flatten(ttr.init_cache(cfg, 1, 3, dtype=torch.float32, device=CPU))
    assert kv.alloc_seq("a", 3)
    kv.write_prefill("a", unflatten(spec, [torch.randn(x.shape) for x in leaves]), 3)
    kv.append_token("a", [torch.randn(kv._state_shape[i]) for i in range(kv.num_leaves)], 3)
    assert {t.dtype for t in flatten(kv.read_dense("a"))[0]} == {torch.bfloat16}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("continuous", [False, True], ids=["generate", "continuous"])
def test_cli_runs_on_cpu(arch, continuous, capsys):
    from repro_torch.launch import serve as cli

    args = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
            "12", "--gen", "6"]
    if continuous:
        args += ["--continuous", "--requests", "4", "--max-batch", "2"]
    cli.main(args)
    out = capsys.readouterr().out
    assert ("served 4 requests" in out) if continuous else ("generated (2, 18)" in out)


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #
@requires_cuda
def test_jamba_dropless_on_card_launches_k3_k2_and_matches_cpu(models):
    """Reduced jamba, dropless, on the card in float32 (TF32 off): K3 twice
    and K2 once a MoE layer a forward, logits as on the CPU."""
    cfg = _f32(tconfigs.get_config(JAMBA, reduced=True), dropless=True)
    toks, nxt = _tokens(cfg, (2, 21), 6), _tokens(cfg, (2, 2), 7)
    want, _ = _port_steps(models[JAMBA].tp, cfg, toks, nxt, 23)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        tp = params_from_arrays(models[JAMBA].p, device="cuda")
        kops.reset_launches()
        cache = ttr.init_cache(cfg, 2, 23, device="cuda")
        gl, cache = ttr.prefill(tp, cfg, torch.as_tensor(toks).long().cuda(), cache)
        got = [gl.cpu().numpy()]
        for i in range(2):
            gl, cache = ttr.decode_step(tp, cfg, torch.as_tensor(nxt[:, i:i + 1]).long().cuda(),
                                        cache, 21 + i)
            got.append(gl.cpu().numpy())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    n_moe = sum(s.ffn == "moe" for g in cfg.groups for s in g.layers) * 3
    assert (kops.launches["bsr_sdd"], kops.launches["bsr_spmm"]) == (2 * n_moe, n_moe)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@requires_cuda
def test_mamba2_serve_on_card_equals_generate(models):
    """Reduced mamba2 on the card: serve with an eviction gives generate's
    greedy tokens on each request alone."""
    cfg = _f32(tconfigs.get_config(MAMBA2, reduced=True))
    tp = params_from_arrays(models[MAMBA2].p, device="cuda")
    eng = tengine.ServeEngine(cfg, tp, max_len=16, device="cuda")
    reqs = [dict(prompt=_tokens(cfg, n, 30 + i), max_new_tokens=g, rid=f"c{i}")
            for i, (n, g) in enumerate(zip((6, 9, 5), (6, 5, 7)))]
    res, sched = eng.serve(reqs, page_size=4, max_batch=2, num_pages=5)
    assert sched.stats["evictions"] >= 1
    for r in reqs:
        out, _ = eng.generate(r["prompt"][None], r["max_new_tokens"])
        np.testing.assert_array_equal(res[r["rid"]]["tokens"], out[0].cpu().numpy())

