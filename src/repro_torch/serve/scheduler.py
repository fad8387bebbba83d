"""Continuous-batching request scheduler over the paged KV cache (port of
``repro.serve.scheduler``).

A server admits and retires sequences *mid-decode* instead of running fixed
``generate`` batches, and every admission consults the persistent plan
cache (``core/cache.py``): a request whose sparse plans are warm goes
straight to decode, cold structures are staged off the decode path (at
most ``cold_stage_budget`` patterns per scheduler iteration).

Scheduler states::

    WAITING ──admit (pages + lane free)──▶ RUNNING ──len(tokens)==max──▶ FINISHED
       ▲                                     │
       └──────── resume (lossless) ◀── PREEMPTED (pages parked on host)

One ``step()`` is one deterministic scheduling iteration: (0) stage cold
plans, (1) admit/resume from the queue, (1b) advance every mid-prefill lane
by one chunk (``chunked_prefill``), (2) grow page tables for this step's
write position, evicting the youngest-arrival lane under page pressure,
(3) one batched decode step over all running lanes, (4) retire finished
sequences. The transcript, page tables and stats depend only on integer
lengths and arrival order, never on token values or params.

``prefix_sharing`` maps a request's page-aligned prompt prefix onto resident
pages (refcount + copy-on-write, see ``paged_cache.py``) and prefills only
the tail; ``chunked_prefill`` prefills ``prefill_chunk`` tokens per step,
interleaved with decode. Both need a fully-paged cache (attention-only).

Decode is ONE batched forward over the running lanes (``decode_step`` with a
(B,) position tensor: each lane writes its KV at its own position and
attends up to it), where the reference vmaps the single-sequence step over
lanes; so each SABLE FFN matmul launches K2 once a step at n = the lanes.
Greedy tokens equal ``ServeEngine.generate`` on each request alone (the
logits agree to ~1e-6, not bit for bit: the matmuls' row count and the
prefill's cache width change their rounding). Sampling draws from each
request's own ``torch.Generator`` with ``torch.multinomial`` on the lane's
logits row, one draw a step as ``generate`` makes; a step whose write is
lost (the lane parked under page pressure) rewinds the generator, so the
redone step draws the same.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import decode_step, init_cache, prefill, prefill_chunk
from .paged_cache import PagedKVCache, PagesExhausted, flatten

__all__ = ["Request", "ContinuousBatchingScheduler"]

WAITING, RUNNING, PREEMPTED, FINISHED = (
    "WAITING",
    "RUNNING",
    "PREEMPTED",
    "FINISHED",
)

_RID = itertools.count()


@dataclasses.dataclass(eq=False)  # identity semantics (numpy fields)
class Request:
    """One generation request. ``patterns`` (optional BlockPatterns) are
    the request's sparse structures for plan-warm admission; empty means
    dense / always warm."""

    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int
    temperature: float = 0.0
    generator: Optional[torch.Generator] = None  # the request's draws (sampling)
    patterns: tuple = ()
    rid: str = ""
    arrival: float = 0.0
    state: str = WAITING
    tokens: List[int] = dataclasses.field(default_factory=list)
    logits: list = dataclasses.field(default_factory=list)
    skips: int = 0  # times passed over by warm-first admission (aging)
    prefilled: int = 0  # prompt positions whose KV is resident (shared or computed)
    metrics: dict = dataclasses.field(default_factory=dict)

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    def output(self) -> np.ndarray:
        return np.concatenate(
            [np.asarray(self.prompt, np.int32), np.asarray(self.tokens, np.int32)]
        )


def lane_step(params, cfg: ModelConfig, paged: List[bool], tokens, view, pos,
              temperatures, generators):
    """One decode step over B lanes at their own positions: ``tokens``
    (B, 1), ``view`` the gathered (B-lane) cache, ``pos`` (B,) on the
    device. Returns (next tokens (B,), float32 logits (B, V), and per cache
    leaf the written slices, (B, repeat, ...feat) for a paged leaf and
    (B, repeat, 1, ...) for a state leaf), all on the device. Lane i is
    greedy at temperature 0, else a draw from softmax(logits_i /
    temperature) with ``generators[i]``, as ``ServeEngine.generate`` draws
    at B = 1."""
    logits, view = decode_step(params, cfg, tokens, view, pos)
    rows = logits[:, 0].float()
    nxt = torch.argmax(rows, dim=-1)
    for i, (temp, gen) in enumerate(zip(temperatures, generators)):
        if temp > 0:
            probs = torch.softmax(rows[i:i + 1] / max(temp, 1e-6), dim=-1)
            nxt[i] = torch.multinomial(probs, 1, generator=gen)[0, 0]
    lanes = torch.arange(tokens.shape[0], device=tokens.device)
    leaves, _ = flatten(view)
    slices = [
        leaf[:, lanes, pos].movedim(1, 0) if p else leaf.movedim(1, 0).unsqueeze(2)
        for leaf, p in zip(leaves, paged)
    ]
    return nxt, rows, slices


class ContinuousBatchingScheduler:
    """See module docstring. ``policy``: "fcfs" (strict arrival order) or
    "warm_first" (plan-warm requests admit ahead of cold ones, with aging:
    a request skipped ``max_skips`` times regains head-of-line priority).

    ``cold_cost_scoring=True`` refines warm_first with the learned cost
    model (``core/cost_model.py``): with no warm request queued, cold
    requests admit cheapest predicted staging first (and ``_stage_cold``
    stages cheapest first). Off by default: golden transcripts pin the
    unscored schedule.

    ``params`` lie on ``device`` (None = the card), where the paged arenas
    and every forward live. ``record_logits`` copies each step's float32
    logits rows to the host (leave it off at full width)."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        max_len: int,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        max_batch: int = 4,
        policy: str = "fcfs",
        cold_stage_budget: int = 1,
        max_skips: int = 4,
        cold_cost_scoring: bool = False,
        clock=None,
        mesh=None,
        plan_cache=None,
        record_logits: bool = False,
        prefix_sharing: bool = False,
        chunked_prefill: bool = False,
        prefill_chunk: Optional[int] = None,
        device=None,
    ):
        if policy not in ("fcfs", "warm_first"):
            raise ValueError(f"unknown admission policy {policy!r}")
        if mesh is not None:
            from ..core.sharded import shard_count

            shard_count(mesh)  # a TypeError for anything but a named DeviceMesh
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.max_len = int(max_len)
        self.max_batch = int(max_batch)
        self.policy = policy
        self.cold_stage_budget = int(cold_stage_budget)
        self.max_skips = int(max_skips)
        self.cold_cost_scoring = bool(cold_cost_scoring)
        self._stage_cost_model = False  # False = not resolved yet
        self.clock = clock if clock is not None else time.perf_counter
        self.mesh = mesh
        self.plan_cache = plan_cache
        self.record_logits = record_logits
        self.prefix_sharing = bool(prefix_sharing)
        self.chunked_prefill = bool(chunked_prefill)
        self.prefill_chunk = 2 * int(page_size) if prefill_chunk is None else int(prefill_chunk)
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")

        view_pages = math.ceil(self.max_len / page_size)
        if num_pages is None:
            num_pages = self.max_batch * view_pages
        self.kv = PagedKVCache(
            cfg, num_pages, page_size, self.max_len,
            prefix_sharing=self.prefix_sharing, device=self.device,
        )
        if (self.prefix_sharing or self.chunked_prefill) and not all(self.kv.paged):
            raise ValueError(
                "prefix_sharing/chunked_prefill need a fully-paged cache "
                "(attention-only decoder): SSM/conv state summarizes the "
                "whole prefix and cannot be shared or rebuilt per chunk"
            )
        # fixed dense width for chunk compute
        self._prefill_width = self.kv.view_pages * int(page_size)

        self.queue: List[Request] = []  # kept in arrival order
        self.lanes: List[Optional[Request]] = [None] * self.max_batch
        self.requests: dict = {}
        self.transcript: list = []
        self.stats = {
            "steps": 0,
            "admissions": 0,
            "evictions": 0,
            "resumes": 0,
            "finished": 0,
            "plans_staged": 0,
            "decode_tokens": 0,
            "prefill_tokens": 0,
            "prefill_chunks": 0,
            "prefix_hits": 0,
            "pages_shared": 0,
            "cow_copies": 0,
            "shared_releases": 0,
        }

    # ------------------------------------------------------------------ #
    # submission
    # ------------------------------------------------------------------ #
    def submit(
        self,
        prompt,
        max_new_tokens: int,
        temperature: float = 0.0,
        generator: Optional[torch.Generator] = None,
        seed: Optional[int] = None,
        patterns=(),
        rid: Optional[str] = None,
        arrival: Optional[float] = None,
    ) -> str:
        """Queue one request. Sampling draws from ``generator`` (a
        ``torch.Generator`` on the scheduler's device), else from a new one
        seeded ``seed`` (default 0, as ``generate``'s default)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) + max_new_tokens - 1 > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + gen ({max_new_tokens}) exceeds "
                f"max_len={self.max_len}"
            )
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                0 if seed is None else int(seed))
        req = Request(
            prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature),
            generator=generator,
            patterns=tuple(patterns),
            rid=rid if rid is not None else f"req{next(_RID)}",
            arrival=self.clock() if arrival is None else float(arrival),
        )
        if req.rid in self.requests:
            raise ValueError(f"duplicate rid {req.rid!r}")
        self.requests[req.rid] = req
        # arrival-ordered insert (preempted re-entries use the same path)
        self._enqueue(req)
        return req.rid

    def _enqueue(self, req: Request) -> None:
        i = len(self.queue)
        while i > 0 and self.queue[i - 1].arrival > req.arrival:
            i -= 1
        self.queue.insert(i, req)

    # ------------------------------------------------------------------ #
    # plan-warm admission
    # ------------------------------------------------------------------ #
    def _plan_keys(self, pattern) -> List[str]:
        from ..sparse.linear import pattern_plan_keys

        return pattern_plan_keys(pattern, self.device, self.mesh)

    def _store(self):
        from ..core import cache as cachelib

        return self.plan_cache if self.plan_cache is not None else cachelib.default_cache()

    def _is_warm(self, req: Request) -> bool:
        store = self._store()
        return all(store.has_plan(k) for p in req.patterns for k in self._plan_keys(p))

    # ------------------------------------------------------------------ #
    # predicted staging cost (cold_cost_scoring)
    # ------------------------------------------------------------------ #
    def _cost_model(self):
        """Lazily resolve the ``linear`` cost model over this scheduler's
        plan cache; None (no/too-small corpus) degrades scoring to the
        unscored behavior."""
        if self._stage_cost_model is False:
            from ..core import cache as cachelib
            from ..core import cost_model as cmlib

            self._stage_cost_model = cmlib.load_or_fit(
                self._store(), cachelib.device_key(self.device), "linear"
            )
        return self._stage_cost_model

    def _predicted_stage_cost(self, req: Request) -> float:
        """Predicted seconds to stage this request's still-cold patterns.
        0.0 when warm; inf for a pattern the model cannot score."""
        model = self._cost_model()
        if model is None:
            return 0.0
        from ..core import cost_model as cmlib

        store = self._store()
        total = 0.0
        for p in req.patterns:
            if all(store.has_plan(k) for k in self._plan_keys(p)):
                continue
            feats = cmlib.pattern_features(p)
            if model.nn_distance(feats) > cmlib.DEFAULT_MAX_DISTANCE:
                return float("inf")
            total += model.staging_cost(feats)
        return total

    def _stage_cold(self, ev: dict) -> None:
        """Stage up to ``cold_stage_budget`` cold patterns from the queue,
        off the decode path (decode proceeds this same iteration)."""
        if self.cold_stage_budget <= 0:
            return
        from ..sparse.linear import pattern_hash, warm_matmul_plans

        store = self._store()
        budget = self.cold_stage_budget
        seen = set()
        # waiting requests first, then running lanes: every submitted
        # pattern ends up staged so the next process restarts warm
        pool = list(self.queue) + [r for r in self.lanes if r is not None]
        if self.cold_cost_scoring:
            pool = sorted(enumerate(pool),
                          key=lambda ir: (self._predicted_stage_cost(ir[1]), ir[0]))
            pool = [r for _, r in pool]
        for req in pool:
            for p in req.patterns:
                h = pattern_hash(p)
                if h in seen:
                    continue
                seen.add(h)
                keys = self._plan_keys(p)
                cold = [k for k in keys if not store.has_plan(k)]
                if not cold:
                    continue
                warm_matmul_plans([p], cache=self.plan_cache, mesh=self.mesh,
                                  device=self.device)
                self.stats["plans_staged"] += sum(1 for k in cold if store.has_plan(k))
                ev["staged"].append(h)
                budget -= 1
                if budget <= 0:
                    return

    # ------------------------------------------------------------------ #
    # admission / eviction
    # ------------------------------------------------------------------ #
    def _pick_next(self) -> Optional[int]:
        if not self.queue:
            return None
        if self.policy == "fcfs":
            return 0
        # warm_first with aging: an over-skipped head wins unconditionally
        if self.queue[0].skips >= self.max_skips:
            return 0
        for i, r in enumerate(self.queue):
            if self._is_warm(r):
                for o in self.queue[:i]:
                    o.skips += 1
                return i
        # every queued request is cold: cheapest predicted staging first
        # when scoring, else strict arrival order
        if self.cold_cost_scoring and len(self.queue) > 1:
            costs = [self._predicted_stage_cost(r) for r in self.queue]
            i = min(range(len(costs)), key=lambda j: (costs[j], j))
            for o in self.queue[:i]:
                o.skips += 1
            return i
        return 0

    def _admit(self, now: float, ev: dict) -> None:
        while True:
            free = [i for i, r in enumerate(self.lanes) if r is None]
            if not free or not self.queue:
                return
            qi = self._pick_next()
            if qi is None:
                return
            req = self.queue[qi]
            if req.state == PREEMPTED:
                if not self.kv.resume(req.rid):
                    return  # head-of-line blocking on pages: deterministic
                self.stats["resumes"] += 1
                ev["resumed"].append(req.rid)
            elif self.prefix_sharing or self.chunked_prefill:
                if not self._begin_prefill(req, now, ev):
                    return
                ev["admitted"].append(req.rid)
            else:
                if not self.kv.alloc_seq(req.rid, req.prompt_len, zero=False):
                    return
                self._prefill_request(req, now)
                ev["admitted"].append(req.rid)
            self.queue.pop(qi)
            req.state = RUNNING
            self.stats["admissions"] += 1
            req.metrics.setdefault("admitted_at", now)
            if len(req.tokens) >= req.max_new_tokens:
                self._finish(req, free[0], now, ev, lane_assigned=False)
            else:
                self.lanes[free[0]] = req

    def _prompt(self, req: Request, start: int, end: int) -> torch.Tensor:
        return torch.as_tensor(req.prompt[None, start:end], dtype=torch.long).to(self.device)

    def _first_token(self, req: Request, logits, now: float) -> None:
        """The first generated token, greedy from the prompt's last
        position (as ``generate``)."""
        row = logits[:, -1].float()  # (1, V)
        req.tokens.append(int(torch.argmax(row, dim=-1)[0]))
        if self.record_logits:
            req.logits.append(row[0].cpu().numpy())
        req.metrics.setdefault("first_token_at", now)

    def _prefill_request(self, req: Request, now: float) -> None:
        """Whole-prompt prefill at admission: the plain path (both features
        off), which the golden transcript freezes."""
        P = req.prompt_len
        cache = init_cache(self.cfg, 1, P, device=self.device)
        logits, cache = prefill(self.params, self.cfg, self._prompt(req, 0, P), cache)
        self.kv.write_prefill(req.rid, cache, P)
        self.stats["prefill_tokens"] += P
        req.prefilled = P
        self._first_token(req, logits, now)

    # ------------------------------------------------------------------ #
    # prefix-shared / chunked prefill
    # ------------------------------------------------------------------ #
    def _begin_prefill(self, req: Request, now: float, ev: dict) -> bool:
        """Admission for the sharing/chunked path: attach the shared prompt
        prefix by reference, reserve pages for the tail (or only the first
        chunk when chunking) and prefill it at once unless chunking defers
        it to ``_advance_prefills``. False = not enough pages."""
        P = req.prompt_len
        ok = self.kv.alloc_seq(
            req.rid,
            P,
            tokens=req.prompt if self.prefix_sharing else None,
            reserve=self.prefill_chunk if self.chunked_prefill else None,
            zero=False,
        )
        if not ok:
            return False
        req.prefilled = self.kv.seq_len[req.rid]  # == shared span
        if req.prefilled:
            ev["shared"][req.rid] = req.prefilled
        if not self.chunked_prefill:
            self._prefill_one_chunk(req, now, ev, in_admit=True)
        return True

    def _prefill_one_chunk(self, req: Request, now: float, ev: dict,
                           in_admit: bool = False) -> None:
        """Advance one mid-prefill sequence by one chunk (or the whole tail
        when chunking is off); the final chunk emits the first generated
        token. Page pressure parks other lanes per policy; with nothing
        left to evict, this sequence parks itself losslessly."""
        P = req.prompt_len
        if self.prefix_sharing and self.chunked_prefill:
            # the prefix writer may have registered pages since our last
            # chunk: attach instead of recomputing
            if self.kv.attach_shared(req.rid):
                req.prefilled = self.kv.seq_len[req.rid]
                ev["shared"][req.rid] = req.prefilled
        start = req.prefilled
        end = P if not self.chunked_prefill else min(P, start + self.prefill_chunk)
        while not self.kv.ensure_capacity(req.rid, end, zero=False):
            others = [r for r in self.lanes if r is not None and r is not req]
            if others:
                self._evict(max(others, key=lambda r: (r.arrival, r.rid)), ev)
                continue
            if self._release_parked_shared_one():
                continue
            if in_admit:  # capacity was reserved at alloc; unreachable
                raise PagesExhausted(f"admission reserve lost for {req.rid!r}")
            self._evict(req, ev)
            return
        dense = self.kv.read_dense(req.rid, s_max=self._prefill_width)
        logits, dense = prefill_chunk(self.params, self.cfg, self._prompt(req, start, end),
                                      dense, start)
        self.kv.write_span(req.rid, dense, start, end)
        req.prefilled = end
        self.stats["prefill_tokens"] += end - start
        self.stats["prefill_chunks"] += 1
        ev["prefill"][req.rid] = [start, end]
        if end == P:
            self._first_token(req, logits, now)

    def _advance_prefills(self, now: float, ev: dict) -> None:
        """One chunk per mid-prefill lane per step, oldest arrival first."""
        if not self.chunked_prefill:
            return
        order = sorted(
            (i for i, r in enumerate(self.lanes) if r is not None and r.prefilled < r.prompt_len),
            key=lambda i: (self.lanes[i].arrival, self.lanes[i].rid),
        )
        for i in order:
            req = self.lanes[i]
            if req is None or req.prefilled >= req.prompt_len:
                continue  # evicted by an earlier lane's page pressure
            self._prefill_one_chunk(req, now, ev)
            # max_new_tokens == 1: the final chunk's token is the output
            if self.lanes[i] is req and req.tokens and len(req.tokens) >= req.max_new_tokens:
                self._finish(req, i, now, ev)

    def _release_parked_shared_one(self) -> bool:
        """Terminal-pressure escape valve: demote the youngest parked
        sequence's retained shared pages to host copies. False when none
        holds shared pages (always, with sharing off)."""
        if not self.prefix_sharing:
            return False
        parked = [
            r for r in self.queue
            if r.state == PREEMPTED and self.kv.is_parked(r.rid)
            and self.kv.parked_shared_pages(r.rid) > 0
        ]
        if not parked:
            return False
        victim = max(parked, key=lambda r: (r.arrival, r.rid))
        self.kv.release_parked_shared(victim.rid)
        self.stats["shared_releases"] += 1
        return True

    def _evict(self, req: Request, ev: dict) -> None:
        lane = self.lanes.index(req)
        self.kv.evict(req.rid)
        self.lanes[lane] = None
        req.state = PREEMPTED
        self.stats["evictions"] += 1
        ev["evicted"].append(req.rid)
        self._enqueue(req)

    def _ensure_growth(self, ev: dict) -> List[int]:
        """Reserve this step's write position for every decoding lane,
        evicting the youngest-arrival lane under page pressure. Returns the
        lanes that decode this step (mid-prefill lanes neither grow nor
        decode)."""
        order = sorted(
            (i for i, r in enumerate(self.lanes) if r is not None),
            key=lambda i: (self.lanes[i].arrival, self.lanes[i].rid),
        )
        for i in order:
            req = self.lanes[i]
            if req is None or not req.tokens:
                continue
            # this step consumes tokens[-1], writing its KV at position
            # prompt_len + len(tokens) - 1: reserve exactly that
            while not self.kv.ensure_capacity(req.rid, req.prompt_len + len(req.tokens)):
                running = [r for r in self.lanes if r is not None]
                victim = max(running, key=lambda r: (r.arrival, r.rid))
                if victim is req and self._release_parked_shared_one():
                    continue
                self._evict(victim, ev)
                if victim is req:
                    break
        return [i for i, r in enumerate(self.lanes) if r is not None and r.tokens]

    def _finish(self, req, lane, now, ev, lane_assigned=True) -> None:
        self.kv.free_seq(req.rid)
        if lane_assigned:
            self.lanes[lane] = None
        req.state = FINISHED
        req.metrics["finished_at"] = now
        self.stats["finished"] += 1
        ev["finished"].append(req.rid)

    # ------------------------------------------------------------------ #
    # the scheduling iteration
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def step(self) -> dict:
        now = self.clock()
        ev = {
            "step": self.stats["steps"],
            "admitted": [],
            "resumed": [],
            "evicted": [],
            "finished": [],
            "staged": [],
            "running": [],
            "page_tables": {},
        }
        if self.prefix_sharing or self.chunked_prefill:
            # gated: the frozen transcript compares events by full-dict
            # equality, so the plain schedule must not grow keys
            ev["shared"] = {}
            ev["prefill"] = {}
        self._stage_cold(ev)
        self._admit(now, ev)
        self._advance_prefills(now, ev)
        active = self._ensure_growth(ev)
        ev["running"] = [self.lanes[i].rid for i in active]
        ev["page_tables"] = {
            self.lanes[i].rid: list(self.kv.page_table[self.lanes[i].rid]) for i in active
        }
        if active:
            self._decode_once(active, ev)
        self.stats["steps"] += 1
        for k, v in self.kv.share_stats.items():
            self.stats[k] = v
        self.transcript.append(ev)
        return ev

    def _decode_once(self, active: List[int], ev: dict) -> None:
        """One batched forward over the decoding lanes (in lane order), one
        copy of the next tokens to the host, then each lane's append."""
        reqs = [self.lanes[i] for i in active]
        pos = [r.prompt_len + len(r.tokens) - 1 for r in reqs]
        # rewound if this step's write is lost
        before = {r.rid: r.generator.get_state() for r in reqs if r.temperature > 0}
        view = self.kv.gather([r.rid for r in reqs])
        nxt, logits, slices = lane_step(
            self.params, self.cfg, self.kv.paged,
            torch.as_tensor([[r.tokens[-1]] for r in reqs], dtype=torch.long).to(self.device),
            view,
            torch.as_tensor(pos, dtype=torch.long).to(self.device),
            [r.temperature for r in reqs],
            [r.generator for r in reqs],
        )
        del view
        nxt = nxt.cpu().tolist()
        rows = logits.cpu().numpy() if self.record_logits else None
        now = self.clock()
        for k, (i, req) in enumerate(zip(active, reqs)):
            if self.lanes[i] is not req:
                # parked by an earlier lane's page pressure before its own
                # append: this step's write is lost, so rewind its draws
                if req.rid in before:
                    req.generator.set_state(before[req.rid])
                continue
            slices_k = [leaf[k] for leaf in slices]
            while True:
                try:
                    self.kv.append_token(req.rid, slices_k, pos[k])
                    break
                except PagesExhausted:
                    # COW or growth needed a page mid-append: evict per
                    # policy (youngest other lane first), then the shared-
                    # page escape valve, then park this lane losslessly
                    others = [r for r in self.lanes if r is not None and r is not req]
                    if others:
                        self._evict(max(others, key=lambda r: (r.arrival, r.rid)), ev)
                        continue
                    if self._release_parked_shared_one():
                        continue
                    self._evict(req, ev)
                    if req.rid in before:
                        req.generator.set_state(before[req.rid])
                    break
            if self.lanes[i] is not req:
                continue  # parked itself above
            req.tokens.append(int(nxt[k]))
            if self.record_logits:
                req.logits.append(rows[k])
            self.stats["decode_tokens"] += 1
            if len(req.tokens) >= req.max_new_tokens:
                self._finish(req, i, now, ev)

    # ------------------------------------------------------------------ #
    def pending(self) -> int:
        return len(self.queue) + sum(r is not None for r in self.lanes)

    def run(self, max_steps: int = 100_000) -> dict:
        """Drive ``step()`` until every submitted request finished."""
        while self.pending() and self.stats["steps"] < max_steps:
            self.step()
        if self.pending():
            raise RuntimeError(
                f"scheduler did not drain in {max_steps} steps (queue={len(self.queue)})"
            )
        return {
            rid: {
                "tokens": req.output(),
                "prompt_len": req.prompt_len,
                "metrics": dict(req.metrics),
                "state": req.state,
            }
            for rid, req in self.requests.items()
        }
