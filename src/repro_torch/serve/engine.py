"""Serving engine (port of ``repro.serve.engine``).

  engine = ServeEngine(cfg, params, max_len=96)        # device=None: the card
  tokens, stats = engine.generate(prompts, max_new_tokens=32)
  results, sched = engine.serve([{"prompt": p, "max_new_tokens": 16}, ...])

``generate`` prefills once and decodes in lockstep on one preallocated dense
cache: the numeric reference path. ``serve`` is request-level continuous
batching over the paged KV cache (``scheduler.py``, ``paged_cache.py``),
whose greedy tokens equal ``generate`` on each request alone.

An encoder-decoder config serves through ``generate(..., src_embeds=)``:
the frames are encoded once, and the cache holds each decoder layer's cross
keys and values at the source length. ``serve`` cannot page such a cache
(the paged cache pages self-attention KV only), so for an enc-dec config it
runs the reference's explicit fallback: a once-per-process warning,
``warmup_stats["paged"] = False``, and each request through ``generate``
alone, with its own ``src_embeds``.

Startup warmup resolves the sparse-matmul plans of a SABLE model before the
first request and is restart-aware: when the persistent plan cache
(``core/cache.py``) already holds every plan for the device, the warmup only
loads them (``warmup_stats["plans_staged"] == 0``), so a forward never
measures.
"""
from __future__ import annotations

import itertools
import time
import warnings

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import decode_step, encode, init_cache, prefill
from ..tree import tree_paths

__all__ = ["ServeEngine"]

# warn-once flag for the enc-dec serve() fallback (tests reset it to see the
# warning again)
_ENCDEC_FALLBACK_WARNED = False
_FALLBACK_RID = itertools.count()


def _warn_encdec_fallback() -> None:
    global _ENCDEC_FALLBACK_WARNED
    if _ENCDEC_FALLBACK_WARNED:
        return
    _ENCDEC_FALLBACK_WARNED = True
    warnings.warn(
        "enc-dec config: the paged KV cache only pages self-attention KV "
        "(cross-attention KV is per-request static), so serve() is running the "
        "single-batch generate() fallback: no continuous batching, no paging "
        "(warmup_stats['paged'] = False)",
        UserWarning,
        stacklevel=3,
    )


def _has_sparse_ffn(params, patterns) -> bool:
    """True iff the FFN weights are actually tiled for one of the sable
    ``patterns``: some w1/w2/w3 leaf ends in (n_tiles, tm, tk). Layer
    stacking prepends a dim, so only trailing dims are matched. Dense-param
    engines thus skip the sparse-plan warmup even when cfg.sable is set."""
    want = {(p.n_tiles, p.tm, p.tk) for p in patterns.values()}
    return any(
        path.rsplit("/", 1)[-1] in ("w1", "w2", "w3")
        and tuple(getattr(leaf, "shape", ())[-3:]) in want
        for path, leaf in tree_paths(params)
    )


def _pattern_plan_keys(pattern, device: torch.device) -> list:
    """Every plan-cache key a deployment of ``pattern`` on ``device``
    touches (the base key; per-shard keys come with the sharding slice)."""
    from ..core import cache as cachelib
    from ..sparse.linear import pattern_hash

    return [cachelib.plan_key("linear", pattern_hash(pattern), cachelib.device_key(device))]


class ServeEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        max_len: int,
        autotune_sparse: bool = True,
        mesh=None,
        tune_mode: str = "measure",
        device=None,
    ):
        """``params`` lie on ``device`` (None = the card). ``tune_mode`` is
        the plan warmup's: "measure" or "predict" (the cost model)."""
        if tune_mode not in ("measure", "predict"):
            raise ValueError(f"unknown tune_mode {tune_mode!r}")
        if mesh is not None:
            raise NotImplementedError(
                "ServeEngine(mesh=) is not ported yet; it comes with the sharding slice"
            )
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.tune_mode = tune_mode
        self.device = resolve_device(device)
        self.sparse_plans = {}
        self.patterns = ()
        self.warmup_stats = {"warm_start": True, "plans_staged": 0}
        if autotune_sparse and getattr(cfg, "sable", None) is not None:
            from ..core import cache as cachelib
            from ..core import cost_model as cmlib
            from ..models.layers import sable_patterns
            from ..sparse.linear import warm_matmul_plans

            pats = sable_patterns(cfg)
            if _has_sparse_ffn(params, pats):
                self.patterns = tuple(pats.values())
                store = cachelib.default_cache()
                warm_start = all(
                    store.has_plan(k)
                    for p in self.patterns
                    for k in _pattern_plan_keys(p, self.device)
                )
                before = store.stats()["plans"]
                predicted_before = cmlib.cost_model_stats()["plans_predicted"]
                # a warm start LOADS every plan (no measuring); a cold one
                # measures once and persists for the next process, or, with
                # tune_mode="predict", resolves from the cost model where it
                # is confident
                self.sparse_plans = warm_matmul_plans(
                    self.patterns, mode=tune_mode, device=self.device
                )
                self.warmup_stats = {
                    "warm_start": warm_start,
                    "plans_staged": store.stats()["plans"] - before,
                    "plans_predicted": (
                        cmlib.cost_model_stats()["plans_predicted"] - predicted_before
                    ),
                }
                if warm_start and self.warmup_stats["plans_staged"]:
                    raise RuntimeError(
                        f"warm start staged {self.warmup_stats['plans_staged']} plans"
                    )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill(self, tokens, cache, enc_out=None):
        return prefill(self.params, self.cfg, tokens, cache, enc_out=enc_out)

    def _decode(self, tok, cache, pos: int, temperature: float, generator):
        """One decode step and the next token: greedy at temperature 0,
        else a draw from softmax(logits / temperature) with ``generator``."""
        logits, cache = decode_step(self.params, self.cfg, tok, cache, pos)
        logits = logits[:, 0].float()
        if temperature > 0:
            probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
            return torch.multinomial(probs, 1, generator=generator), cache
        return torch.argmax(logits, dim=-1, keepdim=True), cache

    # ------------------------------------------------------------------ #
    # request-level serving (continuous batching over the paged cache)
    # ------------------------------------------------------------------ #
    def make_scheduler(self, *, max_len=None, **kw):
        """A ContinuousBatchingScheduler on this engine's model and device.
        kwargs pass through (page_size, num_pages, max_batch, policy,
        clock, plan_cache, record_logits, prefix_sharing, chunked_prefill,
        prefill_chunk, ...)."""
        from .scheduler import ContinuousBatchingScheduler

        return ContinuousBatchingScheduler(
            self.cfg, self.params, max_len=self.max_len if max_len is None else max_len,
            device=self.device, **kw,
        )

    def serve(self, requests, *, max_steps: int = 100_000, **kw):
        """Submit ``requests`` (dicts of ``submit`` kwargs: prompt,
        max_new_tokens, temperature, generator or seed, patterns, rid,
        arrival) and run the scheduler to completion. Returns ``(results,
        scheduler)``, results mapping rid -> {tokens, prompt_len, metrics,
        state}.

        An enc-dec config takes the explicit fallback instead: a
        once-per-process warning, ``paged: False`` in ``warmup_stats``, each
        request through ``generate`` alone, and None for the scheduler. Its
        request dicts take a ``src_embeds`` entry ((S, d) or (1, S, d))."""
        if self.cfg.is_encdec:
            _warn_encdec_fallback()
            self.warmup_stats["paged"] = False
            return self._serve_fallback(requests), None
        self.warmup_stats["paged"] = True
        sched = self.make_scheduler(**kw)
        for r in requests:
            sched.submit(**r)
        results = sched.run(max_steps=max_steps)
        # page-sharing effectiveness beside the plan-warmup stats
        for k in ("prefix_hits", "pages_shared", "cow_copies"):
            self.warmup_stats[k] = sched.stats[k]
        return results, sched

    def _serve_fallback(self, requests) -> dict:
        """Each request through ``generate`` in turn, with scheduler-shaped
        results (rid -> {tokens, prompt_len, metrics, state}). A request
        samples from its ``generator``, else from one seeded ``seed``."""
        results = {}
        for r in requests:
            r = dict(r)
            rid = r.pop("rid", None) or f"req{next(_FALLBACK_RID)}"
            prompt = np.asarray(r.pop("prompt"), np.int32).reshape(-1)
            src = r.pop("src_embeds", None)
            if src is not None:
                src = torch.as_tensor(src, device=self.device)
                if src.dim() == 2:
                    src = src[None]
            generator, seed = r.pop("generator", None), r.pop("seed", None)
            if generator is None and seed is not None:
                generator = torch.Generator(device=self.device).manual_seed(int(seed))
            out, stats = self.generate(
                torch.as_tensor(prompt[None], device=self.device),
                r.pop("max_new_tokens"),
                temperature=r.pop("temperature", 0.0),
                src_embeds=src,
                generator=generator,
            )
            results[rid] = {
                "tokens": out[0].cpu().numpy().astype(np.int32),
                "prompt_len": int(prompt.shape[0]),
                "metrics": {**stats, "fallback": "generate"},
                "state": "FINISHED",
            }
        return results

    # ------------------------------------------------------------------ #
    # single-batch path (the numeric reference)
    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def generate(
        self,
        prompts,  # (B, P) integer token ids
        max_new_tokens: int,
        temperature: float = 0.0,
        src_embeds=None,
        generator: torch.Generator = None,
    ):
        """Prefill ``prompts`` and decode ``max_new_tokens`` tokens (the
        first one greedy from the prefill, as the reference does). Returns
        ((B, P + max_new_tokens) int64 tokens on the device, stats).

        Greedy decoding (``temperature=0``) gives the reference's tokens.
        Sampling draws from ``generator`` (default: seed 0 on the device)
        with ``torch.multinomial``, which cannot reproduce
        ``jax.random.categorical``'s draws.

        An enc-dec config needs ``src_embeds`` (B, S_src, frontend_dim):
        they are encoded once (``stats["encode_s"]``), the prefill writes
        every decoder layer's cross keys and values into the cache, and the
        decode steps read them there. A decoder-only config ignores
        ``src_embeds``, as the reference does.
        """
        cfg = self.cfg
        prompts = torch.as_tensor(prompts, device=self.device).long()
        B, P = prompts.shape
        if P + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {P} + {max_new_tokens} new tokens exceed max_len "
                             f"{self.max_len}")
        if generator is None and temperature > 0:
            generator = torch.Generator(device=self.device).manual_seed(0)
        enc_out, enc_len, encode_s = None, 0, {}
        if cfg.is_encdec:
            if src_embeds is None:
                raise ValueError(f"{cfg.name}: enc-dec serving needs src_embeds")
            src = torch.as_tensor(src_embeds, device=self.device)
            enc_len = src.shape[1]
            self._sync()
            t0 = time.perf_counter()
            enc_out = encode(self.params, cfg, src)
            self._sync()
            encode_s = {"encode_s": time.perf_counter() - t0}
        cache = init_cache(cfg, B, self.max_len, enc_len=enc_len, device=self.device)
        self._sync()
        t0 = time.perf_counter()
        logits, cache = self._prefill(prompts, cache, enc_out)
        nxt = torch.argmax(logits[:, -1].float(), dim=-1, keepdim=True)
        self._sync()
        t1 = time.perf_counter()

        toks = [nxt]
        for i in range(max_new_tokens - 1):
            nxt, cache = self._decode(nxt, cache, P + i, temperature, generator)
            toks.append(nxt)
        out = torch.cat([prompts] + toks, dim=1)
        self._sync()
        t2 = time.perf_counter()
        stats = {
            "prefill_s": t1 - t0,
            "decode_s": t2 - t1,
            "tokens_per_s": B * max_new_tokens / max(t2 - t1, 1e-9),
            **encode_s,
        }
        return out, stats
