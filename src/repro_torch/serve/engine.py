"""Serving engine, single-batch path (port of ``repro.serve.engine``'s
``ServeEngine.__init__`` and ``generate``).

  engine = ServeEngine(cfg, params, max_len=96)        # device=None: the card
  tokens, stats = engine.generate(prompts, max_new_tokens=32)

``generate`` prefills once and decodes in lockstep on one preallocated dense
cache. It is the reference's numeric reference path, which its continuous
batching scheduler is pinned against; ``serve()`` and ``make_scheduler()``
raise until the scheduler slice ports that scheduler and the paged cache.

Startup warmup resolves the sparse-matmul plans of a SABLE model before the
first request and is restart-aware: when the persistent plan cache
(``core/cache.py``) already holds every plan for the device, the warmup only
loads them (``warmup_stats["plans_staged"] == 0``), so a forward never
measures.
"""
from __future__ import annotations

import time

import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import decode_step, init_cache, prefill

__all__ = ["ServeEngine"]


def _not_until_scheduler(what: str):
    return NotImplementedError(
        f"{what} is not ported yet; it comes with the scheduler slice "
        "(serve/scheduler.py, serve/paged_cache.py)"
    )


def _leaves(tree, path=()):
    """(key path, tensor) of every leaf of a dict/list params tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _has_sparse_ffn(params, patterns) -> bool:
    """True iff the FFN weights are actually tiled for one of the sable
    ``patterns``: some w1/w2/w3 leaf ends in (n_tiles, tm, tk). Layer
    stacking prepends a dim, so only trailing dims are matched. Dense-param
    engines thus skip the sparse-plan warmup even when cfg.sable is set."""
    want = {(p.n_tiles, p.tm, p.tk) for p in patterns.values()}
    return any(
        path and path[-1] in ("w1", "w2", "w3")
        and tuple(getattr(leaf, "shape", ())[-3:]) in want
        for path, leaf in _leaves(params)
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
        if cfg.is_encdec:
            raise NotImplementedError(
                f"{cfg.name}: encoder-decoder serving is not ported yet; it comes with the "
                "encoder-decoder slice"
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

    def _prefill(self, tokens, cache):
        return prefill(self.params, self.cfg, tokens, cache)

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
    # request-level serving: the scheduler slice
    # ------------------------------------------------------------------ #
    def make_scheduler(self, *, max_len=None, **kw):
        raise _not_until_scheduler("ServeEngine.make_scheduler (continuous batching)")

    def serve(self, requests, *, max_steps: int = 100_000, **kw):
        raise _not_until_scheduler("ServeEngine.serve (continuous batching)")

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
        """
        if src_embeds is not None:
            raise NotImplementedError(
                "src_embeds= (encoder-decoder serving) is not ported yet; it comes with "
                "the encoder-decoder slice"
            )
        cfg = self.cfg
        prompts = torch.as_tensor(prompts, device=self.device).long()
        B, P = prompts.shape
        if P + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {P} + {max_new_tokens} new tokens exceed max_len "
                             f"{self.max_len}")
        if generator is None and temperature > 0:
            generator = torch.Generator(device=self.device).manual_seed(0)
        cache = init_cache(cfg, B, self.max_len, device=self.device)
        self._sync()
        t0 = time.perf_counter()
        logits, cache = self._prefill(prompts, cache)
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
        }
        return out, stats
