"""PyTorch port, continuous batching: ``repro_torch.serve.scheduler`` (and
``ServeEngine.serve``/``make_scheduler``, ``launch.serve --continuous``)
against the JAX package's scheduler and against the port's own
``ServeEngine.generate``.

Params come from the reference's ``init_params`` and are carried across
with ``convert.params_from_arrays``; compute is float32. The JAX scheduler
runs once per scenario (a module-scoped fixture). Contracts:

- greedy tokens equal the live JAX scheduler's and the port's ``generate``
  on each request alone; logits within 1e-6 of the port's single-sequence
  path and of the JAX scheduler's;
- transcripts, page tables and stats depend on integer lengths only, so
  the port reproduces the JAX scheduler's and ``tests/fixtures/
  serving.json``'s exactly (not that fixture's ``tokens``: they disagree
  with a live JAX run);
- eviction and resume are lossless, under every feature combination.

Sampling: the batched lane step's logits are NOT bit-identical to a B = 1
``decode_step`` when more than one lane runs (the matmuls' row count
changes their rounding, ~3e-7 here), nor is the scheduler's prefill over a
P-wide cache to ``generate``'s over max_len; at one lane on the same cache
they are (checked). So greedy decoding is held against ``generate`` and the
JAX scheduler, and sampling port against port: the same seeds draw the same
tokens, and a request's generator makes exactly ``generate``'s draws,
rewound when a step's write is lost. ``jax.random`` draws cannot be
reproduced in torch.
"""
import dataclasses
import itertools
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import llama3_8b as tl  # noqa: E402
from repro_torch.convert import params_from_arrays  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core.cache import PlanCache  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve.paged_cache import PagesExhausted  # noqa: E402
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, lane_step  # noqa: E402
from repro_torch.sparse import linear as tlin  # noqa: E402
from test_torch_linear import _sealed_reference_plans  # noqa: E402,F401 (autouse)

CPU = "cpu"
LOGIT_TOL = 1e-6
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
requires_cuda = pytest.mark.requires_cuda

# scenario -> (model, prompt lengths (after a 12-token shared prefix where
# prefix_sharing is on), prompt seed, new tokens, serve kwargs), each run
# once through the JAX scheduler and compared with the port's
SCENARIOS = {
    "greedy": ("llama", [3, 7, 5], 7, [6, 4, 8],
               dict(page_size=4, max_batch=3, record_logits=True)),
    "evict": ("llama", [6, 6, 6], 23, [8, 8, 8], dict(page_size=4, max_batch=3, num_pages=9)),
    "fcfs": ("llama", [3, 5, 4, 6, 2, 4], 31, [3, 4, 5, 3, 4, 5],
             dict(page_size=4, max_batch=2)),
    "compose": ("llama", [2, 3, 2, 4], 17, [4, 4, 4, 4],
                dict(page_size=4, max_batch=4, num_pages=11, prefix_sharing=True,
                     chunked_prefill=True, prefill_chunk=8)),
    "sable": ("sable", [3, 7, 5], 7, [5, 4, 6],
              dict(page_size=4, max_batch=3, record_logits=True)),
}


@pytest.fixture(autouse=True)
def _card(request):
    """Tests marked requires_cuda skip without a card: decided here, when the
    test runs, so that every worker collects the same tests."""
    if request.node.get_closest_marker("requires_cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the kernels")


@pytest.fixture
def plan_dir(tmp_path, monkeypatch):
    """Both packages' plan caches in a fresh directory, the port's registry
    empty (a staged pattern found there would not be stored again)."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    tcache.set_default_cache(None)
    tlin._STRATEGY_REGISTRY.clear()
    yield tmp_path
    tcache.set_default_cache(None)
    tlin._STRATEGY_REGISTRY.clear()


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32", param_dtype="float32")


def _fake_clock(step=0.5):
    counter = itertools.count()
    return lambda: next(counter) * step


def _shared_prompts(vocab, suffixes, seed):
    """Prompts of a common 12-token prefix and random suffixes."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 12).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, vocab, k).astype(np.int32)])
            for k in suffixes]


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in lengths]


def _requests(name, vocab):
    _, lengths, seed, gens, kw = SCENARIOS[name]
    make = _shared_prompts if kw.get("prefix_sharing") else _prompts
    return [dict(prompt=p, max_new_tokens=g, rid=f"{name}{i}", arrival=float(i))
            for i, (p, g) in enumerate(zip(make(vocab, lengths, seed), gens))]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Reduced llama3.2-3b and llama3-8b-sable in float32: the JAX engine
    and the port's on the same params, in a plan cache of their own."""
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.configs import llama3_8b as jl
    from repro.core import cache as jcache
    from repro.models import transformer
    from repro.serve import engine

    out = {}
    with pytest.MonkeyPatch.context() as mp, jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        mp.setenv("REPRO_CACHE_DIR", str(tmp_path_factory.mktemp("plans")))
        jcache.set_default_cache(None)
        tcache.set_default_cache(None)
        for name, jcfg, tcfg in (
            ("llama", configs.get_config("llama3.2-3b", reduced=True),
             tconfigs.get_config("llama3.2-3b", reduced=True)),
            ("sable", jl.reduced_sable(), tl.reduced_sable()),
        ):
            jcfg, tcfg = _f32(jcfg), _f32(tcfg)
            p = transformer.init_params(jcfg, jax.random.PRNGKey(0))
            params = params_from_arrays(jax.tree.map(np.asarray, p), device=CPU)
            out[name] = SimpleNamespace(
                jcfg=jcfg, cfg=tcfg, jparams=p, params=params,
                jeng=engine.ServeEngine(jcfg, p, max_len=20),
                eng=tengine.ServeEngine(tcfg, params, max_len=20, device=CPU),
            )
        yield SimpleNamespace(jax=jax, **out)
        tcache.set_default_cache(None)


@pytest.fixture(scope="module")
def jax_runs(models):
    """Each scenario once through the JAX scheduler: (results, scheduler)."""
    jax = models.jax
    runs = {}
    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        for name, (model, *_rest, kw) in SCENARIOS.items():
            m = getattr(models, model)
            runs[name] = m.jeng.serve(_requests(name, m.cfg.vocab_size), clock=_fake_clock(),
                                      **kw)
    return runs


def _generate(m, prompt, max_new, **kw):
    out, _ = m.eng.generate(np.asarray(prompt)[None], max_new, **kw)
    return out[0].cpu().numpy()


def _single_sequence_logits(m, prompt, max_new):
    """The port's B = 1 path: prefill, then decode_step at int positions,
    greedy, on a cache max_len wide: float32 logits rows."""
    P = len(prompt)
    cache = ttr.init_cache(m.cfg, 1, m.eng.max_len, device=CPU)
    with torch.no_grad():
        lg, cache = ttr.prefill(m.params, m.cfg, torch.as_tensor(prompt)[None].long(), cache)
        rows = [lg[:, -1].float()[0]]
        for j in range(max_new - 1):
            nxt = torch.argmax(rows[-1])[None, None]
            lg, cache = ttr.decode_step(m.params, m.cfg, nxt, cache, P + j)
            rows.append(lg[:, 0].float()[0])
    return [r.numpy() for r in rows]


def _serve(m, name, **extra):
    kw = {**SCENARIOS[name][4], **extra}
    return m.eng.serve(_requests(name, m.cfg.vocab_size), clock=_fake_clock(), **kw)


# ---------------------------------------------------------------------- #
# against the JAX scheduler and the port's generate
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["greedy", "sable"])
def test_greedy_matches_jax_scheduler_and_generate_with_logits(models, jax_runs, name):
    """Mixed lengths on three lanes: tokens equal the JAX scheduler's and
    the port's generate on each request alone; every step's logits within
    1e-6 of the port's single-sequence path and of the JAX scheduler's;
    the transcript and stats equal the JAX scheduler's."""
    m = getattr(models, SCENARIOS[name][0])
    results, sched = _serve(m, name)
    jres, jsched = jax_runs[name]
    assert sched.transcript == jsched.transcript and sched.stats == jsched.stats
    for r in _requests(name, m.cfg.vocab_size):
        rid, g = r["rid"], r["max_new_tokens"]
        np.testing.assert_array_equal(results[rid]["tokens"], np.asarray(jres[rid]["tokens"]))
        np.testing.assert_array_equal(results[rid]["tokens"], _generate(m, r["prompt"], g))
        got = sched.requests[rid].logits
        want = _single_sequence_logits(m, r["prompt"], g)
        jwant = jsched.requests[rid].logits
        assert len(got) == len(want) == len(jwant) == g
        for a, b, c in zip(got, want, jwant):
            np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)
            np.testing.assert_allclose(a, np.asarray(c), atol=LOGIT_TOL, rtol=0)
    if name == "sable":
        assert m.eng.sparse_plans == {tlin.pattern_hash(q): "grouped" for q in m.eng.patterns}


def test_golden_serving_transcript_stats_and_layout(models):
    """tests/fixtures/serving.json's 3-request serve (a forced eviction and
    resume): the port reproduces its transcript, stats and paged-cache
    layout exactly, and its tokens equal a live JAX scheduler run's and the
    port's generate (the fixture's frozen tokens are not used)."""
    from repro.serve.scheduler import ContinuousBatchingScheduler as JScheduler

    with open(os.path.join(FIXTURES, "serving.json")) as f:
        doc = json.load(f)
    assert doc["config"] == "llama3.2-3b"
    m, jax = models.llama, models.jax

    def run(cls, cfg, params, **kw):
        sched = cls(cfg, params, clock=_fake_clock(1.0), **doc["scheduler"], **kw)
        for r in doc["requests"]:
            sched.submit(np.asarray(r["prompt"], np.int32), r["max_new_tokens"],
                         rid=r["rid"], arrival=r["arrival"])
        return sched.run(), sched

    results, sched = run(ContinuousBatchingScheduler, m.cfg, m.params, device=CPU)
    assert sched.transcript == doc["transcript"]
    assert {k: sched.stats[k] for k in doc["stats"]} == doc["stats"]
    frozen, kv = doc["paged_cache"], sched.kv
    assert (kv.view_pages, kv.zero_page, kv.num_leaves, list(kv.paged)) == (
        frozen["view_pages"], frozen["zero_page"], frozen["num_leaves"], frozen["paged"])
    assert [list(a.shape) for a in kv._arenas] == frozen["arena_shapes"]
    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        jres, _ = run(JScheduler, m.jcfg, m.jparams)
    for r in doc["requests"]:
        np.testing.assert_array_equal(results[r["rid"]]["tokens"],
                                      np.asarray(jres[r["rid"]]["tokens"]))
        np.testing.assert_array_equal(results[r["rid"]]["tokens"],
                                      _generate(m, r["prompt"], r["max_new_tokens"]))


@pytest.mark.parametrize("name", ["evict", "fcfs", "compose"])
def test_schedules_match_jax_scheduler_and_generate(models, jax_runs, name):
    """Eviction under page pressure (lossless resume), more requests than
    lanes, and prefix sharing with chunked prefill under page pressure: the
    port's transcript and stats equal the JAX scheduler's, and every
    request's tokens equal the JAX scheduler's and the port's generate."""
    m = models.llama
    results, sched = _serve(m, name)
    jres, jsched = jax_runs[name]
    assert sched.transcript == jsched.transcript and sched.stats == jsched.stats
    if name == "evict":
        assert sched.stats["evictions"] > 0 and sched.stats["resumes"] > 0
    if name == "compose":
        assert sched.stats["prefix_hits"] >= 1 and sched.stats["pages_shared"] >= 3
    for r in _requests(name, m.cfg.vocab_size):
        rid = r["rid"]
        assert results[rid]["state"] == "FINISHED"
        np.testing.assert_array_equal(results[rid]["tokens"], np.asarray(jres[rid]["tokens"]))
        np.testing.assert_array_equal(results[rid]["tokens"],
                                      _generate(m, r["prompt"], r["max_new_tokens"]))
    assert sched.kv.allocator.num_free == sched.kv.allocator.num_pages


# ---------------------------------------------------------------------- #
# the port's own contracts
# ---------------------------------------------------------------------- #
def test_lane_step_is_decode_step_and_sampling_is_reproducible(models):
    """At one lane the lane step is ``decode_step`` bit for bit on the same
    cache; at three lanes each lane's logits are within 1e-6 of it, not
    bit-identical (the matmuls' row count changes their rounding), and the
    prefill over a P-wide cache rounds apart from generate's max_len-wide
    one too. So sampling is held port against port: two serves with the
    same seeds draw the same tokens, and each request's generator makes
    exactly generate's draws (its state after the run is generate's)."""
    m = models.llama
    prompts = _prompts(m.cfg.vocab_size, [4, 6, 3], 11)
    sched = m.eng.make_scheduler(page_size=4, max_batch=3)
    for i, p in enumerate(prompts):
        sched.submit(p, 4, rid=f"l{i}")
    with torch.no_grad():
        sched._admit(0.0, {"admitted": []})  # prefill all three
        kv, reqs = sched.kv, sched.lanes
        tok = torch.tensor([[r.tokens[-1]] for r in reqs])
        pos = torch.tensor([r.prompt_len for r in reqs])
        _, rows, _ = lane_step(m.params, m.cfg, kv.paged, tok, kv.gather([r.rid for r in reqs]),
                               pos, [0.0] * 3, [None] * 3)
        for k, r in enumerate(reqs):
            _, row, _ = lane_step(m.params, m.cfg, kv.paged, tok[k:k + 1], kv.gather([r.rid]),
                                  pos[k:k + 1], [0.0], [None])
            lg, _ = ttr.decode_step(m.params, m.cfg, tok[k:k + 1],
                                    kv.read_dense(r.rid, s_max=kv.view_pages * 4), r.prompt_len)
            assert torch.equal(row[0], lg[0, 0].float())
            torch.testing.assert_close(rows[k], row[0], atol=LOGIT_TOL, rtol=0)

    reqs = [dict(prompt=p, max_new_tokens=6, temperature=0.8, seed=100 + i, rid=f"s{i}")
            for i, p in enumerate(prompts)]
    first, sched = m.eng.serve(reqs, page_size=4, max_batch=3)
    again, _ = m.eng.serve(reqs, page_size=4, max_batch=3)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(first[f"s{i}"]["tokens"], again[f"s{i}"]["tokens"])
        gen = torch.Generator().manual_seed(100 + i)
        _generate(m, p, 6, temperature=0.8, generator=gen)
        assert torch.equal(sched.requests[f"s{i}"].generator.get_state(), gen.get_state())


def test_pages_exhausted_mid_decode_evicts_and_rewinds(models, monkeypatch):
    """A PagesExhausted raised mid-append evicts per policy and keeps every
    sequence lossless; a lane that loses its step's write rewinds its
    generator (its state after the run is generate's), and a single lane
    with nothing to evict parks itself and redoes the step with the same
    draw."""
    m = models.llama
    prompts = _prompts(m.cfg.vocab_size, [5, 6], 77)
    sched = m.eng.make_scheduler(page_size=4, max_batch=2, num_pages=10, clock=_fake_clock())
    for i, p in enumerate(prompts):
        sched.submit(p, max_new_tokens=6, temperature=0.7 * i, seed=500 + i, rid=f"x{i}",
                     arrival=float(i))
    real, fired = sched.kv.append_token, {}

    def flaky(rid, slices, position):
        if rid == "x0" and position >= 7 and "x0" not in fired:
            fired["x0"] = True
            raise PagesExhausted("forced mid-decode exhaustion")
        return real(rid, slices, position)

    monkeypatch.setattr(sched.kv, "append_token", flaky)
    results = sched.run()
    assert fired and sched.stats["evictions"] >= 1 and sched.stats["resumes"] >= 1
    np.testing.assert_array_equal(results["x0"]["tokens"], _generate(m, prompts[0], 6))
    gen = torch.Generator().manual_seed(501)
    _generate(m, prompts[1], 6, temperature=0.7, generator=gen)
    # x1 (sampled) was the victim of x0's exhaustion: five draws, not six
    assert torch.equal(sched.requests["x1"].generator.get_state(), gen.get_state())

    sched2 = m.eng.make_scheduler(page_size=4, max_batch=1, num_pages=8, clock=_fake_clock())
    sched2.submit(prompts[0], max_new_tokens=6, temperature=0.7, seed=500, rid="solo")
    real2, fired2 = sched2.kv.append_token, {}

    def flaky2(rid, slices, position):
        if position >= 7 and not fired2:
            fired2["solo"] = True
            raise PagesExhausted("forced self-park")
        return real2(rid, slices, position)

    monkeypatch.setattr(sched2.kv, "append_token", flaky2)
    results2 = sched2.run()
    assert fired2 and sched2.stats["evictions"] >= 1
    gen = torch.Generator().manual_seed(500)
    np.testing.assert_array_equal(
        results2["solo"]["tokens"],
        _generate(m, prompts[0], 6, temperature=0.7, generator=gen))


def test_step_invariants_and_lengths_only_transcript(models):
    """Capacity never exceeded, no page leaked or double-booked, no request
    starved, fake-clock timestamps ordered; and two runs over different
    prompts of the same lengths give the same transcript."""
    m = models.llama
    sched = m.eng.make_scheduler(page_size=4, max_batch=2, num_pages=8, clock=_fake_clock())
    for i, p in enumerate(_prompts(m.cfg.vocab_size, [5, 3, 6, 4], 41)):
        sched.submit(p, max_new_tokens=5, rid=f"c{i}", arrival=float(i))
    kv, seen = sched.kv, set()
    while sched.pending():
        ev = sched.step()
        kv.allocator.check()
        assert sum(r is not None for r in sched.lanes) <= sched.max_batch
        assert sum(len(t) for t in kv.page_table.values()) == kv.allocator.num_held
        seen.update(ev["running"])
        assert sched.stats["steps"] < 500
    assert seen == {f"c{i}" for i in range(4)}
    assert kv.allocator.num_free == kv.allocator.num_pages
    for i in range(4):
        mt = sched.requests[f"c{i}"].metrics
        assert 0 <= mt["admitted_at"] <= mt["first_token_at"] <= mt["finished_at"]

    def transcript(seed):
        s = m.eng.make_scheduler(page_size=4, max_batch=2, num_pages=7, clock=_fake_clock())
        for i, p in enumerate(_prompts(m.cfg.vocab_size, [6, 6, 5], seed)):
            s.submit(p, max_new_tokens=[6, 5, 6][i], rid=f"t{i}", arrival=float(i))
        s.run()
        return s.transcript

    assert transcript(1) == transcript(2)


@pytest.mark.parametrize("path,gens,kw", [
    ("plain", [4, 3, 5], {}),
    ("chunked", [4, 1, 3], dict(chunked_prefill=True, prefill_chunk=4)),
    ("prefix_shared", [3, 1, 4], dict(prefix_sharing=True)),
    ("one_token", [1, 1, 2], {}),
])
def test_stamps_ordered_with_first_token_after_admission(models, path, gens, kw):
    """On the fake clock every request's stamps keep admitted_at <=
    prefill_at <= first_token_at <= finished_at, and the first token is
    stamped after the admitting step's reading (``admitted_at``): on the
    plain path, the chunked one, the prefix-shared one, and for requests
    done at admission (one token)."""
    m = models.llama
    make = _shared_prompts if kw.get("prefix_sharing") else _prompts
    prompts = make(m.cfg.vocab_size, [7, 5, 9] if path != "prefix_shared" else [2, 3, 4], 19)
    reqs = [dict(prompt=p, max_new_tokens=g, rid=f"s{i}", arrival=float(i))
            for i, (p, g) in enumerate(zip(prompts, gens))]
    results, _ = m.eng.serve(reqs, page_size=4, max_batch=2, clock=_fake_clock(), **kw)
    for r in reqs:
        mt = results[r["rid"]]["metrics"]
        assert len(results[r["rid"]]["tokens"]) == len(r["prompt"]) + r["max_new_tokens"]
        assert mt["admitted_at"] <= mt["prefill_at"] <= mt["first_token_at"] <= mt["finished_at"]
        assert mt["first_token_at"] > mt["admitted_at"]


def test_prefix_sharing_allocates_prefix_once_and_matches_generate(models):
    """Four requests with a common 12-token prefix: its 3 pages and 12
    tokens of prefill are paid once, the engine surfaces the counters, and
    tokens and logits equal the unshared serve's."""
    m = models.llama
    prompts = _shared_prompts(m.cfg.vocab_size, [2, 3, 4, 2], 5)
    reqs = [dict(prompt=p, max_new_tokens=4, rid=f"p{i}") for i, p in enumerate(prompts)]
    kw = dict(page_size=4, max_batch=4, record_logits=True)
    res_off, off = m.eng.serve(reqs, **kw)
    res_on, on = m.eng.serve(reqs, prefix_sharing=True, **kw)
    assert on.stats["prefix_hits"] == 3 and on.stats["pages_shared"] == 9
    assert on.kv.allocator.total_allocated == off.kv.allocator.total_allocated - 9
    assert on.stats["prefill_tokens"] == off.stats["prefill_tokens"] - 36
    assert m.eng.warmup_stats["paged"] is True
    assert (m.eng.warmup_stats["prefix_hits"], m.eng.warmup_stats["pages_shared"],
            m.eng.warmup_stats["cow_copies"]) == (3, 9, on.stats["cow_copies"])
    for i, p in enumerate(prompts):
        want = _generate(m, p, 4)
        np.testing.assert_array_equal(res_on[f"p{i}"]["tokens"], want)
        np.testing.assert_array_equal(res_off[f"p{i}"]["tokens"], want)
        for a, b in zip(on.requests[f"p{i}"].logits, off.requests[f"p{i}"].logits):
            np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)


def test_chunked_prefill_interleaves_with_decode_and_matches(models):
    m = models.llama
    prompts = _prompts(m.cfg.vocab_size, [14, 3, 4], 13)
    reqs = [dict(prompt=p, max_new_tokens=5, rid=f"c{i}", arrival=float(i))
            for i, p in enumerate(prompts)]
    results, sched = m.eng.serve(reqs, page_size=4, max_batch=3, chunked_prefill=True,
                                 prefill_chunk=4, clock=_fake_clock())
    assert sched.stats["prefill_chunks"] >= 4 + 1 + 1
    assert sched.stats["prefill_tokens"] == 14 + 3 + 4
    assert any(ev.get("prefill") and ev["running"] for ev in sched.transcript)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(results[f"c{i}"]["tokens"], _generate(m, p, 5))


# ---------------------------------------------------------------------- #
# plan-warm admission on the port's plan cache
# ---------------------------------------------------------------------- #
def test_cold_plans_staged_once_then_warm_restart_stages_zero(models, plan_dir):
    m = models.llama
    store = PlanCache(str(plan_dir / "store"))
    pats = tuple(tlin.random_pattern(64, 64, 16, 16, 0.4, seed=s) for s in (0, 1))
    prompts = _prompts(m.cfg.vocab_size, [4, 5], 51)

    def serve_once():
        sched = m.eng.make_scheduler(page_size=4, max_batch=2, plan_cache=store,
                                     cold_stage_budget=1, clock=_fake_clock())
        for i, p in enumerate(prompts):
            sched.submit(p, max_new_tokens=4, patterns=pats, rid=f"p{i}", arrival=float(i))
        return sched.run(), sched

    results, sched = serve_once()
    assert sched.stats["plans_staged"] == len(pats)
    assert all(r["state"] == "FINISHED" for r in results.values())
    assert all(len(ev["staged"]) <= 1 for ev in sched.transcript)  # the budget
    keys = [tcache.plan_key("linear", tlin.pattern_hash(p), "torchcpu") for p in pats]
    assert all(store.has_plan(k) for k in keys)
    tlin._STRATEGY_REGISTRY.clear()  # a restart's empty registry
    results2, sched2 = serve_once()
    assert sched2.stats["plans_staged"] == 0
    np.testing.assert_array_equal(results["p0"]["tokens"], results2["p0"]["tokens"])


def test_warm_first_policy_reorders_but_never_starves(models, plan_dir):
    m = models.llama
    store = PlanCache(str(plan_dir / "store"))
    cold = (tlin.random_pattern(64, 64, 16, 16, 0.4, seed=9),)
    prompts = _prompts(m.cfg.vocab_size, [4, 4, 4], 61)
    sched = m.eng.make_scheduler(page_size=4, max_batch=1, plan_cache=store,
                                 policy="warm_first", cold_stage_budget=0, max_skips=2,
                                 clock=_fake_clock())
    sched.submit(prompts[0], 4, patterns=cold, rid="cold", arrival=0.0)
    sched.submit(prompts[1], 4, rid="warm1", arrival=1.0)
    sched.submit(prompts[2], 4, rid="warm2", arrival=2.0)
    results = sched.run()
    assert all(r["state"] == "FINISHED" for r in results.values())
    assert sched.stats["plans_staged"] == 0
    at = {rid: sched.requests[rid].metrics["admitted_at"] for rid in results}
    assert at["warm1"] < at["cold"]
    np.testing.assert_array_equal(results["cold"]["tokens"], _generate(m, prompts[0], 4))
    with pytest.raises(ValueError, match="policy"):
        m.eng.make_scheduler(policy="best_effort")


def _seed_linear_corpus(store, n=10):
    """Measured ``linear`` plans on the port's CPU key with planted timings
    that grow with the tile count, so the cost model ranks patterns by it."""
    from repro_torch.core import cost_model as cmlib
    from repro_torch.core.staging import StagingOptions

    for i in range(n):
        p = tlin.random_pattern(64, 64, 8, 8, 0.15 + 0.08 * i, seed=300 + i)
        h, feats = tlin.pattern_hash(p), cmlib.pattern_features(p)
        store.store_plan(
            tcache.plan_key("linear", h, tcache.CPU_KEY),
            tcache.TuningPlan(
                kind="linear", structure_hash=h, device=tcache.CPU_KEY,
                options=StagingOptions(backend="grouped", tile=(8, 8)),
                timings={"grouped": float(np.exp(-10 + 0.9 * feats[2]))},
                meta={"d_in": p.d_in, "d_out": p.d_out, "tm": p.tm, "tk": p.tk,
                      "n_tiles": p.n_tiles, "density": p.density},
                source="measured",
            ),
        )


@pytest.mark.parametrize("scoring", [True, False], ids=["scored", "arrival-order"])
def test_cold_cost_scoring_orders_cold_admission(models, plan_dir, scoring):
    """With cold_cost_scoring an all-cold queue admits the cheapest
    predicted staging first; without it, in arrival order."""
    m = models.llama
    store = PlanCache(str(plan_dir / "store"))
    _seed_linear_corpus(store)
    expensive = (tlin.random_pattern(64, 64, 8, 8, 0.85, seed=401),)
    cheap = (tlin.random_pattern(64, 64, 8, 8, 0.2, seed=402),)
    prompts = _prompts(m.cfg.vocab_size, [4, 4], 71)
    sched = m.eng.make_scheduler(page_size=4, max_batch=1, plan_cache=store,
                                 policy="warm_first", cold_cost_scoring=scoring,
                                 cold_stage_budget=0, max_skips=10, clock=_fake_clock())
    sched.submit(prompts[0], 4, patterns=expensive, rid="slow", arrival=0.0)
    sched.submit(prompts[1], 4, patterns=cheap, rid="fast", arrival=1.0)
    results = sched.run()
    assert all(r["state"] == "FINISHED" for r in results.values())
    at = {rid: sched.requests[rid].metrics["admitted_at"] for rid in results}
    assert (at["fast"] < at["slow"]) is scoring
    np.testing.assert_array_equal(results["slow"]["tokens"], _generate(m, prompts[0], 4))


# ---------------------------------------------------------------------- #
# entry points
# ---------------------------------------------------------------------- #
def test_mesh_and_left_out_options_raise(models):
    m = models.llama
    with pytest.raises(TypeError, match="DeviceMesh"):
        ContinuousBatchingScheduler(m.cfg, m.params, max_len=16, mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="prefill_chunk"):
        m.eng.make_scheduler(prefill_chunk=0)
    sched = m.eng.make_scheduler(page_size=4)
    with pytest.raises(ValueError, match="max_len"):
        sched.submit(np.zeros(18, np.int32), 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        sched.submit(np.zeros(3, np.int32), 0)
    sched.submit(np.zeros(3, np.int32), 2, rid="dup")
    with pytest.raises(ValueError, match="duplicate"):
        sched.submit(np.zeros(3, np.int32), 2, rid="dup")


def test_cli_continuous_on_cpu(plan_dir, capsys):
    """``--continuous`` serves the reference's workload on the CPU when
    asked, with prefix sharing and chunked prefill."""
    results, sched = tlaunch.main([
        "--arch", "llama3-8b-sable", "--reduced", "--device", "cpu", "--continuous",
        "--requests", "3", "--max-batch", "2", "--page-size", "4", "--prompt-len", "6",
        "--gen", "4", "--shared-prefix", "8", "--prefix-sharing", "--chunked-prefill",
    ])
    assert sched.stats["finished"] == 3 and sched.device.type == "cpu"
    assert all(r["state"] == "FINISHED" for r in results.values())
    assert sched.stats["prefix_hits"] >= 1
    text = capsys.readouterr().out
    assert "served 3 requests on cpu" in text and "prefix sharing:" in text


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "llama4-scout-17b-a16e"])
def test_cli_continuous_serves_moe_models_on_cpu(plan_dir, capsys, arch):
    """``--continuous`` on the MoE configs (MLA's latent cache paged for
    DeepSeek-V2), with prefix sharing and chunked prefill."""
    results, sched = tlaunch.main([
        "--arch", arch, "--reduced", "--device", "cpu", "--continuous",
        "--requests", "3", "--max-batch", "2", "--page-size", "4", "--prompt-len", "6",
        "--gen", "4", "--shared-prefix", "8", "--prefix-sharing", "--chunked-prefill",
    ])
    assert sched.stats["finished"] == 3 and sched.device.type == "cpu"
    assert all(r["state"] == "FINISHED" for r in results.values())
    assert sched.stats["prefix_hits"] >= 1 and all(sched.kv.paged)
    assert "served 3 requests on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------- #
# on the card: the lane step through K2
# ---------------------------------------------------------------------- #
def _pin_cuda(patterns, dev):
    """Plans naming the ``cuda`` strategy (K2) for ``patterns`` in the
    default plan cache, and an empty registry, so the engine loads them."""
    from repro_torch.core.staging import StagingOptions

    for p in patterns:
        h = tlin.pattern_hash(p)
        tcache.default_cache().store_plan(
            tcache.plan_key("linear", h, tcache.device_key(dev)),
            tcache.TuningPlan(kind="linear", structure_hash=h, device=tcache.device_key(dev),
                              options=StagingOptions(backend="cuda", tile=(p.tm, p.tk)),
                              source="heuristic"))
    tlin._STRATEGY_REGISTRY.clear()


@requires_cuda
def test_scheduler_on_the_card_through_k2_matches_generate(plan_dir):
    """Reduced llama3-8b-sable in float32 on the card, both FFN patterns
    pinned to K2: continuous batching (with an eviction) launches K2 three
    times a layer each decode step and prefill, and its greedy tokens
    equal generate's on each request alone."""
    from repro_torch.models.layers import sable_patterns

    dev = torch.device("cuda")
    cfg = _f32(tl.reduced_sable())
    _pin_cuda(sable_patterns(cfg).values(), dev)
    params = ttr.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = tengine.ServeEngine(cfg, params, max_len=20, device=dev)
    assert set(eng.sparse_plans.values()) == {"cuda"}
    prompts = _prompts(cfg.vocab_size, [6, 6, 6], 23)
    reqs = [dict(prompt=p, max_new_tokens=8, rid=f"e{i}") for i, p in enumerate(prompts)]
    kops.reset_launches()
    results, sched = eng.serve(reqs, page_size=4, max_batch=3, num_pages=9)
    forwards = sched.stats["steps"] - sum(1 for ev in sched.transcript if not ev["running"])
    prefills = sched.stats["admissions"] - sched.stats["resumes"]
    assert sched.stats["evictions"] > 0
    assert kops.launches["bsr_spmm"] == 3 * cfg.n_layers * (forwards + prefills)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(results[f"e{i}"]["tokens"], _generate(
            SimpleNamespace(eng=eng), p, 8))
