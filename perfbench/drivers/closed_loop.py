"""A closed loop of clients through the program's continuous-batching
scheduler (``ServeEngine.make_scheduler`` -> ``submit`` / ``step``).

Each client sends its next request as soon as its last one finished;
client i sends its first at step ``i * stagger_steps``, so admissions
spread over the steps as they do in a running server. The window opens
after ``ramp_steps`` steps, the same count in every run, and closes on
the first step that ends ``--seconds`` after it opened. Every request is
greedy.

Mix parameters: ``clients``, ``max_batch``, ``page_size``, ``prompt`` and
``new_tokens`` (length distributions, ``traffic.py``), ``block``,
``stagger_steps``, ``ramp_steps``, ``warmup_decode_steps``, ``trace_s``,
``check_requests`` (finished requests compared with the reference, drawn
from the seed, the longest prompt among them).

A request's time to first token runs from its submission to the end of the
``step()`` after which its first token is on the host; one still waiting
when the window closes counts its wait so far.

The configuration's ``model_type`` names the model's family: its
``models/<type>.py`` gives the program's ``ModelConfig`` (``model_config``),
the weights (``make_weights``, ``weight_bytes``) and the layers a traced run
wraps in spans (``SPANS``); its ``reference/<type>.py`` gives the plain
forward (``logits_at``) and the control's precision (``CONTROL``, and a
``WITNESS`` where there is one).
"""
from __future__ import annotations

import contextlib
import importlib
import time

import numpy as np
import torch

from .. import traffic
from ..harness import family
from ..trace import Profile, span


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the reference's best, per row."""
    return logits.max(-1).values - logits.gather(-1, tokens.view(-1, 1)).view(-1)


@contextlib.contextmanager
def instrument(sched, prof, spans, routes: list, prefills: list):
    """Spans around the calls into each layer, where the callers look the
    callees up by name (``spans``: (module, attribute, span name)), and
    the router's counts of each MoE call while the profiler runs.
    Everything is put back on exit."""
    from repro_torch.models import moe as moe_mod

    phase = ["other"]
    saved = [(moe_mod, "_route", moe_mod._route)]
    saved += [(mod, attr, getattr(mod, attr))
              for mod, attr in ((importlib.import_module(m), a) for m, a, _ in spans)]

    def spanned(name, fn):
        def wrapped(*a, **k):
            with span(name, prof.active):
                return fn(*a, **k)
        return wrapped

    def route(p, x, cfg, per_lane=False):
        r = saved[0][2](p, x, cfg, per_lane)
        if prof.active:
            routes.append((phase[0], r.counts.detach().clone()))
        return r

    prefill = sched._prefill_request

    def prefill_request(req, now):
        phase[0] = "prefill"
        a = time.perf_counter()
        with span("prefill", prof.active):
            prefill(req, now)
        if prof.active:
            prefills.append((req.prompt_len, time.perf_counter() - a))

    decode = sched._decode_once

    def decode_once(active, ev):
        phase[0] = "decode"
        with span("decode", prof.active):
            decode(active, ev)

    for (mod, attr, fn), (_, _, name) in zip(saved[1:], spans):
        setattr(mod, attr, spanned(name, fn))
    moe_mod._route = route
    sched._prefill_request = prefill_request
    sched._decode_once = decode_once
    sched.kv.gather = spanned("kv_gather", sched.kv.gather)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        for name in ("_prefill_request", "_decode_once"):
            del sched.__dict__[name]
        del sched.kv.__dict__["gather"]


def _warmup(sched, mix, vocab, seed):
    """One request at the longest prompt, then a decode step or more with
    every lane full."""
    rng = np.random.default_rng([seed, 2])
    lo, hi = traffic.shortest(mix["prompt"]), traffic.longest(mix["prompt"])
    steps = mix["warmup_decode_steps"]
    sched.submit(rng.integers(0, vocab, size=hi).astype(np.int32), 2)
    for _ in range(mix["max_batch"] - 1):
        sched.submit(rng.integers(0, vocab, size=lo).astype(np.int32), steps + 1)
    sched.run()


def run(ctx) -> dict:
    c, mix, dev = ctx.cfg, ctx.mix, ctx.device
    from repro_torch.serve.engine import ServeEngine

    model, ref = family(c)

    t = time.perf_counter()
    cfg = model.model_config(c)
    weights = model.make_weights(c, ctx.seed, dev)
    ctx.sync()
    ctx.part("weights", time.perf_counter() - t)
    ctx.log(f"weights: {model.weight_bytes(weights) / 1e9:.3f} GB {c['served_dtype']}")

    t = time.perf_counter()
    max_len = traffic.longest(mix["prompt"]) + traffic.longest(mix["new_tokens"])
    engine = ServeEngine(cfg, weights, max_len=max_len, autotune_sparse=False, device=dev)
    sched = engine.make_scheduler(max_batch=mix["max_batch"], page_size=mix["page_size"])
    _warmup(sched, mix, c["vocab_size"], ctx.seed)
    ctx.sync()
    ctx.part("warmup", time.perf_counter() - t)

    stream = traffic.requests(mix, c["vocab_size"], ctx.seed)
    prof = Profile(dev) if ctx.trace else None
    routes, prefills = [], []
    seen, submit_t, first_t, done_t = {}, {}, {}, {}
    lanes = [None] * mix["clients"]
    window_tokens = steps = 0
    t_open = t_close = None
    before = dict(sched.stats)
    alloc = _allocator(dev)
    ctx.window_opens()
    with (instrument(sched, prof, model.SPANS, routes, prefills) if prof
          else contextlib.nullcontext()):
        while True:
            for ci, rid in enumerate(lanes):
                if rid is None and steps >= ci * mix["stagger_steps"]:
                    prompt, n_new = next(stream)
                    rid = sched.submit(prompt, n_new)
                    submit_t[rid], seen[rid], lanes[ci] = time.perf_counter(), 0, rid
            sched.step()
            now = time.perf_counter()
            for ci, rid in enumerate(lanes):
                if rid is None:
                    continue
                req = sched.requests[rid]
                n = len(req.tokens)
                if n > seen[rid]:
                    first_t.setdefault(rid, now)
                    if t_open is not None:
                        window_tokens += n - seen[rid]
                    seen[rid] = n
                if req.state == "FINISHED":
                    done_t[rid] = now
                    lanes[ci] = None
            steps += 1
            if steps == mix["ramp_steps"]:
                if prof:  # started before the window: its start-up is not the window's
                    prof.start()
                t_open = time.perf_counter()
            elif t_open is not None:
                if prof and prof.active and now - t_open >= min(mix["trace_s"], ctx.seconds):
                    prof.stop()
                if now - t_open >= ctx.seconds:
                    t_close = now
                    break
        if prof and prof.active:
            prof.stop()

    in_window = [r for r, s in submit_t.items() if s >= t_open]
    ttft = [(first_t[r] if r in first_t else t_close) - submit_t[r] for r in in_window]
    stats = {k: sched.stats[k] - before.get(k, 0) for k in
             ("steps", "admissions", "evictions", "prefill_tokens", "decode_tokens")}
    rec = {
        "window_s": t_close - t_open, "window_tokens": window_tokens, "ttft_s": ttft,
        "attempted": len(in_window), "trace": prof.trace if prof else None,
        "routes": [(ph, int(cn.sum()), int((cn.sum(0) > 0).sum())) for ph, cn in routes],
        "prefills": prefills, "memory_peak_bytes": ctx.memory_peak(),
    }
    ctx.log(f"closed loop: {len(in_window)} requests submitted in the window, "
            f"{window_tokens} tokens, {len(ttft)} ttft samples, scheduler {stats}, "
            f"allocator {_allocator(dev, alloc)}")

    # the sample compared with the reference: finished in the window
    finished = sorted(r for r, d in done_t.items() if d > t_open) or sorted(done_t)
    rng = np.random.default_rng([ctx.seed, 3])
    k = min(mix["check_requests"], len(finished))
    pick = set(rng.choice(len(finished), size=k, replace=False).tolist())
    pick.add(max(range(len(finished)), key=lambda i: sched.requests[finished[i]].prompt_len))
    reqs = [sched.requests[finished[i]] for i in sorted(pick)]
    served = [(np.asarray(r.prompt), list(r.tokens)) for r in reqs]
    del sched, engine, reqs
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    seqs = [torch.as_tensor(np.concatenate([p, np.asarray(t[:-1], np.int32)]), device=dev).long()
            for p, t in served]
    want = [torch.arange(len(p) - 1, len(p) - 1 + len(t), device=dev) for p, t in served]
    toks = torch.as_tensor(np.concatenate([t for _, t in served]), device=dev).long()
    t = time.perf_counter()
    logits = torch.cat(ref.logits_at(weights, c, seqs, want))
    g = gaps(logits, toks)
    rec["checks"] = {"mean_gap": {"value": float(g.mean()), "compared": len(g)}}
    index = torch.cat([torch.arange(len(t), device=dev) for _, t in served])
    ctx.log(f"reference: {time.perf_counter() - t:.3f} s over {len(seqs)} requests, "
            f"{len(toks)} tokens; gaps {_spread(g)}; first tokens {_spread(g[index == 0])}")
    if ctx.control:  # the token the lower precision puts first, at each served position
        low = gaps(logits, torch.cat(ref.logits_at(weights, c, seqs, want, ref.CONTROL))
                   .argmax(-1))
        rec["control_checks"] = {"mean_gap": {"value": float(low.mean()), "compared": len(low)}}
        ctx.log(f"control ({ref.CONTROL}) gaps {_spread(low)}")
        if getattr(ref, "WITNESS", None):
            wit = gaps(logits, torch.cat(ref.logits_at(weights, c, seqs, want, ref.WITNESS))
                       .argmax(-1))
            ctx.log(f"witness ({ref.WITNESS} reference) gaps {_spread(wit)}")
    return rec


def _allocator(dev, since: dict = None) -> dict:
    """The caching allocator's calls to the driver (each may wait for the
    device), counted since ``since``."""
    keys = ("num_device_alloc", "num_device_free", "num_alloc_retries")
    st = torch.cuda.memory_stats(dev) if dev.type == "cuda" else {}
    now = {k: st.get(k, 0) for k in keys}
    return now if since is None else {k: now[k] - since[k] for k in keys}


def _spread(g: torch.Tensor) -> str:
    if not len(g):
        return "none"
    q = torch.quantile(g.float().cpu(), torch.tensor([0.5, 0.9, 0.99, 1.0]))
    nz = float((g > 0).float().mean())
    return (f"mean {float(g.mean()):.5f}, p50/p90/p99/max {[round(float(v), 5) for v in q]}, "
            f"nonzero {nz:.3f}")
