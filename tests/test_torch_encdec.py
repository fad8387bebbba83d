"""PyTorch port, encoder-decoder models: cross-attention, ``encode``, the
seamless-m4t-large-v2 config served (``generate`` with ``src_embeds=``, the
``serve`` fallback) and trained (``make_train_step``, the training CLI,
checkpoints), against the JAX package on the same numpy inputs.

The reduced seamless config runs in float32; params come from the
reference's ``init_params`` and are carried across with
``convert.params_from_arrays``. Outputs agree to 1e-4 (greedy tokens and
checkpoint bytes exactly). Each reference function is jitted once per key
(module-scoped fixture).
"""
import dataclasses
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import manager as tckpt  # noqa: E402
from repro_torch.convert import opt_state_from_arrays, params_from_arrays  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve.paged_cache import PagedKVCache  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_linear import _sealed_reference_plans  # noqa: E402,F401 (autouse)

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "seamless-m4t-large-v2"
B, S, S_SRC, P = 2, 12, 8, 6  # batch, target tokens, source frames, prompt


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, compute_dtype="float32", param_dtype="float32", **kw)


@pytest.fixture(scope="module")
def jx():
    """The reference's modules on JAX's CPU device in full float32, and a
    jit of each function once per key."""
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.models import attention, transformer
    from repro.optim import adamw
    from repro.serve import engine
    from repro.train import step

    compiled = {}

    def jit(key, fn, **kw):
        if key not in compiled:
            compiled[key] = jax.jit(fn, **kw)
        return compiled[key]

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield SimpleNamespace(jax=jax, jnp=jax.numpy, configs=configs, attn=attention,
                              tr=transformer, adamw=adamw, engine=engine, step=step, jit=jit)


def _configs(jx, frontend_dim=None):
    """(reference config, port config) of the reduced seamless in float32,
    with ``frontend_dim`` replaced where given."""
    kw = {} if frontend_dim is None else {"frontend_dim": frontend_dim}
    jcfg = _f32(jx.configs.get_config(ARCH, reduced=True), **kw)
    tcfg = _f32(tconfigs.get_config(ARCH, reduced=True), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def model(jx):
    """Per frontend_dim: the reference's params (numpy), the port's, and the
    configs."""
    out = {}

    def get(frontend_dim=None):
        if frontend_dim not in out:
            jcfg, tcfg = _configs(jx, frontend_dim)
            p = jx.jax.tree.map(np.asarray, jx.tr.init_params(jcfg, jx.jax.random.PRNGKey(0)))
            out[frontend_dim] = SimpleNamespace(jcfg=jcfg, tcfg=tcfg, p=p,
                                                tp=params_from_arrays(p, device=CPU))
        return out[frontend_dim]

    return get


def _inputs(cfg, seed=0, b=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, S + 1)).astype(np.int32)
    src = rng.standard_normal((b, S_SRC, cfg.frontend_dim)).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "src_embeds": src}


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(t):
    return t.detach().float().numpy()


def _flat(tree, prefix=""):
    """(path, leaf) pairs, dict keys sorted, of either package's tree."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flat(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flat(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _close(got_tree, want_tree, **tol):
    got, want = _flat(got_tree), _flat(want_tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        g = _np(g) if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w, dtype=np.float32), err_msg=k,
                                   **(tol or TOL))


# ---------------------------------------------------------------------- #
# config and params
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_jax(jx, reduced):
    from repro.models.config import param_count as jcount
    from repro_torch.models.config import param_count

    want = jx.configs.get_config(ARCH, reduced=reduced)
    got = tconfigs.get_config(ARCH, reduced=reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.is_encdec and param_count(got) == jcount(want)


@pytest.mark.parametrize("frontend_dim", [None, 32])
def test_init_params_and_convert_carry_the_encoder(jx, model, frontend_dim):
    """init_params draws the reference's tree (enc_groups, enc_final_norm,
    frontend_proj where frontend_dim != d_model, each decoder layer's cross
    and ln_cross); params_from_arrays and opt_state_from_arrays carry it
    across leaf for leaf."""
    m = model(frontend_dim)
    shapes = jx.jax.eval_shape(lambda k: jx.tr.init_params(m.jcfg, k), jx.jax.random.PRNGKey(0))
    tp = ttr.init_params(m.tcfg, torch.Generator().manual_seed(0), device=CPU)
    want = [(k, tuple(v.shape)) for k, v in _flat(shapes)]
    assert [(k, tuple(v.shape)) for k, v in _flat(tp)] == want
    keys = set(tp)
    assert {"enc_groups", "enc_final_norm"} <= keys
    assert ("frontend_proj" in keys) == (frontend_dim == 32)
    assert {"cross", "ln_cross"} <= set(tp["groups"][0]["sub0"])
    _close(m.tp, m.p, rtol=0, atol=0)
    jopt = jx.adamw.adamw_init(m.p, jx.adamw.AdamWConfig())
    jopt = jx.jax.tree.map(lambda a: np.asarray(a) + 0.5, jopt)  # not all zeros
    topt = opt_state_from_arrays(jopt, device=CPU)
    _close({"mu": topt["mu"], "nu": topt["nu"]}, {"mu": jopt["mu"], "nu": jopt["nu"]},
           rtol=0, atol=0)


# ---------------------------------------------------------------------- #
# cross-attention and the encoder
# ---------------------------------------------------------------------- #
def test_cross_attention_matches_jax(jx, model):
    """cross_init's layout, cross_kv and cross_apply (no mask, no RoPE) on
    the reference's params; K/V in another dtype are cast to the query's."""
    m = model()
    cfg = m.tcfg
    p = m.p["groups"][0]["sub0"]["cross"]
    got_init = tattn.cross_init(torch.Generator().manual_seed(0), cfg, device=CPU)
    want_init = jx.attn.cross_init(jx.jax.random.PRNGKey(0), m.jcfg)
    assert {k: tuple(v.shape) for k, v in got_init.items()} == \
        {k: tuple(v.shape) for k, v in want_init.items()}
    layer = {k: v[0] for k, v in p.items()}
    rng = np.random.default_rng(1)
    enc = rng.standard_normal((B, S_SRC, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    jkv = jx.attn.cross_kv(layer, enc, m.jcfg)
    want = jx.attn.cross_apply(layer, x, jkv, m.jcfg)
    tl = params_from_arrays(layer, device=CPU)
    kv = tattn.cross_kv(tl, _t(enc), cfg)
    for k in ("k", "v"):
        assert tuple(kv[k].shape) == (B, S_SRC, cfg.n_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(_np(kv[k]), np.asarray(jkv[k]), **TOL)
    got = tattn.cross_apply(tl, _t(x), kv, cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    half = {k: v.to(torch.bfloat16) for k, v in kv.items()}
    mixed = tattn.cross_apply(tl, _t(x), half, cfg)
    assert mixed.dtype == torch.float32
    np.testing.assert_allclose(_np(mixed), np.asarray(want), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("frontend_dim", [None, 32])
def test_encode_matches_jax(jx, model, frontend_dim):
    """The encoder (bidirectional, RoPE at arange(S_src), enc_final_norm),
    at frontend_dim == d_model and through frontend_proj."""
    m = model(frontend_dim)
    src = _inputs(m.tcfg)["src_embeds"]
    want = jx.jit(("encode", frontend_dim), lambda p, s: jx.tr.encode(p, m.jcfg, s))(m.p, src)
    got = ttr.encode(m.tp, m.tcfg, _t(src))
    assert tuple(got.shape) == (B, S_SRC, m.tcfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_encoder_attends_both_ways_and_chunked(model):
    """The encoder is bidirectional: its first position's output moves with
    the last frame. Under attn_chunk (the streaming softmax) it gives the
    same output, unmasked."""
    m = model()
    src = _t(_inputs(m.tcfg)["src_embeds"])
    base = ttr.encode(m.tp, m.tcfg, src)
    moved = src.clone()
    moved[:, -1] += 1.0
    assert not torch.allclose(ttr.encode(m.tp, m.tcfg, moved)[:, 0], base[:, 0])
    chunked = dataclasses.replace(m.tcfg, attn_chunk=2)
    torch.testing.assert_close(ttr.encode(m.tp, chunked, src), base, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------- #
# the whole model
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ref_train(jx, model):
    """The reference's logits, loss and gradient of CE on one batch."""
    m = model()
    batch = _inputs(m.tcfg)

    def loss(p, b):
        logits, aux = jx.tr.forward_train(p, m.jcfg, b)
        return jx.step.cross_entropy(logits, b["labels"]) + aux, logits

    (val, logits), grads = jx.jax.jit(jx.jax.value_and_grad(loss, has_aux=True))(m.p, batch)
    return SimpleNamespace(batch=batch, loss=float(val), logits=np.asarray(logits), grads=grads)


def _jax_like(tree, attr):
    if isinstance(tree, dict):
        return {k: _jax_like(v, attr) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jax_like(v, attr) for v in tree]
    return getattr(tree, attr)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_forward_train_and_grads_match_jax(model, ref_train, remat):
    """forward_train with src_embeds (the encoder under the decoder's
    remat), the loss and every leaf's gradient, the encoder's among them."""
    m = model()
    cfg = dataclasses.replace(m.tcfg, remat=remat)
    tp = params_from_arrays(m.p, device=CPU)
    for v in tree_leaves(tp):
        v.requires_grad_()
    batch = tstep.batch_to_device(ref_train.batch, torch.device(CPU))
    logits, aux = ttr.forward_train(tp, cfg, batch)
    np.testing.assert_allclose(_np(logits), ref_train.logits, **TOL)
    loss = tstep.cross_entropy(logits, batch["labels"]) + aux
    np.testing.assert_allclose(float(loss.detach()), ref_train.loss, **TOL)
    loss.backward()
    _close(_jax_like(tp, "grad"), ref_train.grads)


def test_prefill_then_decode_reads_cached_cross_kv(jx, model):
    """prefill with enc_out writes each layer's cross K/V into the cache
    (equal to the reference's cache), and decode_step with enc_out=None
    reads them: its logits equal the reference's decode step's."""
    m = model()
    cfg = m.tcfg
    inp = _inputs(cfg)
    toks, src = inp["tokens"], inp["src_embeds"]
    jcache = jx.tr.init_cache(m.jcfg, B, S, enc_len=S_SRC, dtype=jx.jnp.float32)
    jenc = jx.tr.encode(m.p, m.jcfg, src)
    jpre = jx.jit("prefill", lambda p, t, c, e: jx.tr.prefill(p, m.jcfg, t, c, enc_out=e))
    jdec = jx.jit("decode", lambda p, t, c, pos: jx.tr.decode_step(p, m.jcfg, t, c, pos))
    jl, jcache = jpre(m.p, toks[:, :P], jcache, jenc)
    with torch.inference_mode():
        cache = ttr.init_cache(cfg, B, S, enc_len=S_SRC, device=CPU)
        enc = ttr.encode(m.tp, cfg, _t(src))
        tl, cache = ttr.prefill(m.tp, cfg, _t(toks[:, :P]).long(), cache, enc_out=enc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
        _close(cache, jcache)
        for t in range(P, S):
            jl, jcache = jdec(m.p, toks[:, t:t + 1], jcache, np.int32(t))
            tl, cache = ttr.decode_step(m.tp, cfg, _t(toks[:, t:t + 1]).long(), cache, t)
            np.testing.assert_allclose(_np(tl), np.asarray(jl), err_msg=str(t), **TOL)


def test_prefill_chunk_recomputes_cross_kv_and_cache_dtype(jx, model):
    """prefill_chunk recomputes cross K/V from enc_out at every chunk, as
    the reference's: two chunks give the one prefill's logits and cache. A
    bfloat16 cache holds the cross leaves in bfloat16 (the cache's dtype);
    its decode step's logits stay near the float32 cache's."""
    m = model()
    cfg = m.tcfg
    inp = _inputs(cfg, seed=3)
    toks, src = _t(inp["tokens"]).long(), _t(inp["src_embeds"])
    with torch.inference_mode():
        enc = ttr.encode(m.tp, cfg, src)
        whole = ttr.init_cache(cfg, B, S, enc_len=S_SRC, device=CPU)
        want, _ = ttr.prefill(m.tp, cfg, toks[:, :P], whole, enc_out=enc)
        parts = ttr.init_cache(cfg, B, S, enc_len=S_SRC, device=CPU)
        ttr.prefill_chunk(m.tp, cfg, toks[:, :2], parts, 0, enc_out=enc)
        got, _ = ttr.prefill_chunk(m.tp, cfg, toks[:, 2:P], parts, 2, enc_out=enc)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        _close(parts, whole, rtol=1e-5, atol=1e-5)
        half = ttr.init_cache(cfg, B, S, enc_len=S_SRC, dtype=torch.bfloat16, device=CPU)
        ttr.prefill(m.tp, cfg, toks[:, :P], half, enc_out=enc)
        cross = half[0]["sub0"]["cross"]
        assert cross["k"].dtype == torch.bfloat16
        torch.testing.assert_close(cross["k"].float(), whole[0]["sub0"]["cross"]["k"],
                                   rtol=1e-2, atol=1e-2)
        lw, _ = ttr.decode_step(m.tp, cfg, toks[:, P:P + 1], whole, P)
        lh, _ = ttr.decode_step(m.tp, cfg, toks[:, P:P + 1], half, P)
        torch.testing.assert_close(lh, lw, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("compress", [True, False])
def test_train_step_matches_jax(jx, model, compress):
    """One make_train_step step: loss, grad norm, the updated params (the
    encoder's among them) and AdamW's moments. AdamW's first update is lr *
    g / (|g| + eps): where a gradient is near zero, float32 rounding of g
    moves it by up to lr, so the step runs at lr 1e-3 (an encoder wq entry
    moved 1.2e-4 at lr 1e-2)."""
    from repro.distributed.sharding import ParallelConfig as JPC
    from repro_torch.distributed.sharding import ParallelConfig

    m = model()
    batch = _inputs(m.tcfg, seed=5)
    jopt_cfg, topt_cfg = jx.adamw.AdamWConfig(lr=1e-3), tadamw.AdamWConfig(lr=1e-3)
    jstep = jx.jit(("step", compress),
                   jx.step.make_train_step(m.jcfg, jopt_cfg, JPC(compress_grads=compress)))
    jp, jopt, jm = jstep(m.p, jx.adamw.adamw_init(m.p, jopt_cfg), batch, 0)
    step = tstep.make_train_step(m.tcfg, topt_cfg, ParallelConfig(compress_grads=compress))
    tp = params_from_arrays(m.p, device=CPU)
    tp, topt, tm = step(tp, tadamw.adamw_init(tp, topt_cfg), batch, 0)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **TOL)
    _close(tp, jp)
    _close({"mu": topt["mu"], "nu": topt["nu"]}, {"mu": jopt["mu"], "nu": jopt["nu"]})


def test_train_step_after_serving_the_same_params(model):
    """generate (under inference mode: the encoder, the cache's cross K/V,
    RoPE's tables) and then a train step on the same params in one process,
    as a server that trains: the step takes gradients, and generate's
    tokens after it run from the updated params."""
    m = model()
    params = params_from_arrays(m.p, device=CPU)
    eng = tengine.ServeEngine(m.tcfg, params, max_len=12, device=CPU)
    batch = _inputs(m.tcfg, seed=6)
    prompts, src = batch["tokens"][:, :4], batch["src_embeds"]
    before, _ = eng.generate(prompts, 4, src_embeds=src)
    step = tstep.make_train_step(m.tcfg, tadamw.AdamWConfig(lr=1e-2))
    wq = params["enc_groups"][0]["sub0"]["mixer"]["wq"]
    old = wq.detach().clone()
    _, _, metrics = step(params, tadamw.adamw_init(params, tadamw.AdamWConfig()), batch, 0)
    assert np.isfinite(float(metrics["loss"])) and not torch.equal(wq.detach(), old)
    after, _ = eng.generate(prompts, 4, src_embeds=src)
    assert tuple(after.shape) == tuple(before.shape)


# ---------------------------------------------------------------------- #
# serving
# ---------------------------------------------------------------------- #
def test_generate_greedy_tokens_match_jax_engine(jx, model):
    """ServeEngine.generate with src_embeds: greedy tokens equal the JAX
    engine's token for token; the encoder is timed on its own."""
    m = model()
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, m.tcfg.vocab_size, (B, 4)).astype(np.int32)
    src = rng.standard_normal((B, S_SRC, m.tcfg.frontend_dim)).astype(np.float32)
    want, _ = jx.engine.ServeEngine(m.jcfg, m.p, max_len=16).generate(
        jx.jnp.asarray(prompts), 8, src_embeds=jx.jnp.asarray(src))
    eng = tengine.ServeEngine(m.tcfg, m.tp, max_len=16, device=CPU)
    got, stats = eng.generate(prompts, 8, src_embeds=src)
    assert tuple(got.shape) == (B, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["encode_s"] > 0 and stats["tokens_per_s"] > 0
    with pytest.raises(ValueError, match="src_embeds"):
        eng.generate(prompts, 2)


def test_serve_falls_back_with_warning(model):
    """serve() on an enc-dec config takes the explicit fallback: a warning
    once per process, paged False, each request through generate with its
    own src_embeds ((S, d) or (1, S, d)), tokens equal generate's on it
    alone, metrics marked, no scheduler."""
    m = model()
    eng = tengine.ServeEngine(m.tcfg, m.tp, max_len=16, device=CPU)
    rng = np.random.default_rng(4)
    reqs = []
    for i, (n, s_src) in enumerate(((3, 8), (5, 6), (2, 9))):
        src = rng.standard_normal((s_src, m.tcfg.frontend_dim)).astype(np.float32)
        reqs.append({"prompt": rng.integers(0, m.tcfg.vocab_size, n).astype(np.int32),
                     "max_new_tokens": 5, "src_embeds": src[None] if i == 1 else src,
                     "rid": f"e{i}"})
    tengine._ENCDEC_FALLBACK_WARNED = False  # re-arm the once-guard
    with pytest.warns(UserWarning, match="paged"):
        results, sched = eng.serve(reqs)
    assert sched is None and eng.warmup_stats["paged"] is False
    for r in reqs:
        got = results[r["rid"]]
        assert got["state"] == "FINISHED" and got["prompt_len"] == len(r["prompt"])
        assert got["metrics"]["fallback"] == "generate"
        src = np.asarray(r["src_embeds"]).reshape(1, -1, m.tcfg.frontend_dim)
        ref, _ = eng.generate(r["prompt"][None], 5, src_embeds=src)
        np.testing.assert_array_equal(got["tokens"], ref[0].numpy())
    with warnings.catch_warnings(record=True) as caught:  # once per process
        warnings.simplefilter("always")
        eng.serve(reqs[:1])
    assert not caught


def test_paged_cache_and_scheduler_refuse_encdec(model):
    """The paged cache pages self-attention KV only: it refuses an enc-dec
    config with ValueError, and so does the engine's scheduler."""
    m = model()
    with pytest.raises(ValueError):
        PagedKVCache(m.tcfg, num_pages=4, page_size=4, max_len=8, device=CPU)
    eng = tengine.ServeEngine(m.tcfg, m.tp, max_len=16, device=CPU)
    with pytest.raises(ValueError):
        eng.make_scheduler(page_size=4, num_pages=8)


@pytest.mark.parametrize("continuous", [False, True])
def test_serve_cli_refuses_encdec_clearly(continuous):
    """The serve CLI makes no frame embeddings: for an enc-dec config it
    raises a ValueError naming src_embeds (the reference's asserts)."""
    from repro_torch.launch import serve as tlaunch

    argv = ["--arch", ARCH, "--reduced", "--device", CPU] + (["--continuous"] if continuous
                                                             else [])
    with pytest.raises(ValueError, match="src_embeds"):
        tlaunch.main(argv)


# ---------------------------------------------------------------------- #
# training CLI and checkpoints
# ---------------------------------------------------------------------- #
def test_checkpoint_round_trips_enc_groups(tmp_path, model):
    """A checkpoint of params and AdamW state with enc_groups (and
    frontend_proj) restores bit for bit, dtypes kept."""
    m = model(32)
    params = params_from_arrays(m.p, device=CPU)
    params["enc_final_norm"] = params["enc_final_norm"].to(torch.bfloat16)
    opt = tadamw.adamw_init(params, tadamw.AdamWConfig())
    for v in tree_leaves(opt["mu"]):
        v.normal_(generator=torch.Generator().manual_seed(1))
    tree = {"params": params, "opt": opt}
    tckpt.save_checkpoint(str(tmp_path), 3, tree, extra={"data": {"step": 3}})
    like = {"params": ttr.init_params(m.tcfg, torch.Generator().manual_seed(9), device=CPU),
            "opt": tadamw.adamw_init(params, tadamw.AdamWConfig())}
    like["params"]["enc_final_norm"] = like["params"]["enc_final_norm"].to(torch.bfloat16)
    back, step, extra = tckpt.restore_checkpoint(str(tmp_path), like)
    assert step == 3 and extra == {"data": {"step": 3}}
    got, want = _flat(back), _flat(tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert any(k.startswith("/params/enc_groups/") for k, _ in got)
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_train_cli_trains_and_resumes_seamless(tmp_path, capsys):
    """The training CLI on the reduced seamless config (SyntheticDataset
    with src_embeds), then --resume from its checkpoint."""
    from repro_torch.launch import train as tlaunch

    base = ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "32", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2", "--log-every", "1", "--device", CPU]
    assert tlaunch.main(base + ["--steps", "2"]) == 0
    assert tlaunch.main(base + ["--steps", "1", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed=True at step 2" in out and "@ step 3" in out
    assert tckpt.latest_step(str(tmp_path)) == 3
