"""Paged/blocked KV cache: a refcounted free-list page allocator over one
shared arena per cache leaf, with prefix sharing and copy-on-write (port of
``repro.serve.paged_cache``).

Every attention cache leaf is backed by ONE arena of fixed-size pages
(``page_size`` token positions each); a sequence owns ``ceil(len /
page_size)`` pages through a per-sequence page table and grows one page at
a time mid-decode. Pages are recycled through a FIFO free list, so N
concurrent requests share the arena without per-request preallocation.

**Prefix sharing** (``prefix_sharing=True``): every fully-written prompt
page is registered in a prefix index keyed by the cumulative blake2b digest
of the token ids it covers (the reference's bytes, so both packages key a
page alike), and ``alloc_seq`` maps a new request's page-aligned prompt
prefix onto resident pages with the same token history under a per-page
refcount. Pages with refcount > 1 are immutable: a write goes through
copy-on-write (``_writable_page``). The index holds only resident pages, so
a hit means the bytes are already in the arena.

Leaf classification is structural: two ``init_cache`` templates with
different ``s_max``; a leaf whose shape changes carries the sequence axis
(at 2) and is paged, a shape-stable leaf (a Mamba sub-layer's conv and SSD
state) is per-sequence *state* stored whole, one tensor a sequence in the
cache's dtype, and replaced wholesale by every write. A cache may hold only
state (mamba2) or both kinds (jamba). Leaves are taken in JAX's flattening
order (lists in order, dict keys sorted).

The arenas are torch tensors on the cache's device, shaped as the
reference's: ``(num_pages + 1, repeat, page_size, ...feat)``. Page id
``num_pages`` is a reserved always-zero page that pads the batch view of a
lane that has not allocated that far, so a gathered view equals the dense
reference cache over every written position and is zero beyond it.
``gather`` and ``read_dense`` index the arenas on the device; the
bookkeeping (tables, refcounts, digests) is Python on the host.

Eviction parks a sequence's *private* pages and state in host memory and
frees them; pages shared with other sequences stay resident under the
parked sequence's reference. ``resume`` reallocates the private pages and
copies them back bit for bit. ``release_parked_shared`` demotes a parked
sequence's retained shared pages to host copies under terminal pressure.
Page-capacity failures raise the typed ``PagesExhausted``.

``gather`` runs inside the ``kv.gather`` span, ``write_span`` (and so
``write_prefill``) and ``append_token`` inside ``kv.write`` (``tracing``).
"""
from __future__ import annotations

import collections
import hashlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import on_device, resolve_device
from ..models.config import ModelConfig
from ..models.transformer import init_cache
from ..tracing import span
from ..tree import flatten, unflatten

__all__ = ["PageAllocator", "PagedKVCache", "PagesExhausted"]


class PagesExhausted(RuntimeError):
    """A write needed a page the allocator could not provide. The cache
    state is consistent (the failed operation wrote nothing past its last
    completed page); the scheduler evicts per policy and retries."""


class PageAllocator:
    """FIFO free-list page allocator. Deterministic: pages are handed out
    in ascending id order initially and recycled in free order, so a fixed
    request sequence always produces the same page tables."""

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError("need at least one page")
        self.num_pages = int(num_pages)
        self._free = collections.deque(range(self.num_pages))
        self._held: set = set()
        self.total_allocated = 0  # cumulative pages handed out

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_held(self) -> int:
        return len(self._held)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages atomically; None (state unchanged) if the
        free list is short."""
        if n < 0:
            raise ValueError("negative allocation")
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        self._held.update(pages)
        self.total_allocated += n
        return pages

    def free(self, pages) -> None:
        for p in pages:
            if p not in self._held:
                raise ValueError(f"double free / foreign page {p}")
            self._held.discard(p)
            self._free.append(p)

    def check(self) -> None:
        """Invariant: every page is exactly once free or held."""
        assert len(self._free) + len(self._held) == self.num_pages
        assert set(self._free) | self._held == set(range(self.num_pages))
        assert not (set(self._free) & self._held)


class PagedKVCache:
    """Model-shaped paged cache arena (see module docstring).

    Parameters
    ----------
    cfg : ModelConfig (decoder-only)
    num_pages : total allocatable pages shared by all sequences
    page_size : token positions per page
    max_len : per-sequence logical capacity; the dense batch view is
        ``view_pages * page_size`` wide, ``view_pages = ceil(max_len /
        page_size)``
    dtype : the arenas' torch dtype (default: the compute dtype)
    prefix_sharing : maintain the prefix index (off by default: the golden
        serving transcript pins the unshared schedule)
    device : where the arenas live (None = the card)
    """

    def __init__(
        self,
        cfg: ModelConfig,
        num_pages: int,
        page_size: int,
        max_len: int,
        dtype=None,
        prefix_sharing: bool = False,
        device=None,
    ):
        if cfg.is_encdec:
            raise ValueError(
                "PagedKVCache is decoder-only; encoder-decoder serving does not page its cache"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.page_size = int(page_size)
        self.max_len = int(max_len)
        self.prefix_sharing = bool(prefix_sharing)
        self.view_pages = math.ceil(self.max_len / self.page_size)
        if num_pages < self.view_pages:
            raise ValueError(
                f"num_pages={num_pages} cannot hold even one max_len="
                f"{max_len} sequence ({self.view_pages} pages needed)"
            )
        self.allocator = PageAllocator(num_pages)
        self.zero_page = num_pages  # reserved, always zero, never allocated

        # structural classification on host templates: leaves whose shape
        # varies with s_max carry the sequence axis (paged)
        ta, _ = flatten(init_cache(cfg, 1, 2, dtype=dtype, device="cpu"))
        tb, self._spec = flatten(init_cache(cfg, 1, 3, dtype=dtype, device="cpu"))
        self.num_leaves = len(tb)
        self.paged: List[bool] = []
        self._arenas: List[Optional[torch.Tensor]] = []
        self._state_shape: List[Optional[tuple]] = []
        self._dtypes: List[torch.dtype] = []
        for la, lb in zip(ta, tb):
            self._dtypes.append(lb.dtype)
            if la.shape != lb.shape:
                diffs = [i for i, (x, y) in enumerate(zip(la.shape, lb.shape)) if x != y]
                assert diffs == [2], (
                    f"expected a single seq axis at 2, got {diffs} for "
                    f"{tuple(la.shape)} vs {tuple(lb.shape)}"
                )
                self.paged.append(True)
                self._arenas.append(torch.zeros(
                    (num_pages + 1, lb.shape[0], self.page_size) + tuple(lb.shape[3:]),
                    dtype=lb.dtype, device=self.device,
                ))
                self._state_shape.append(None)
            else:
                self.paged.append(False)
                self._arenas.append(None)
                self._state_shape.append(tuple(lb.shape))

        # per-sequence bookkeeping
        self.page_table: Dict[str, List[int]] = {}
        self.seq_len: Dict[str, int] = {}
        self._state: Dict[str, List[Optional[torch.Tensor]]] = {}
        self._parked: Dict[str, dict] = {}

        # refcounts + prefix index (page -> owners; digest <-> page)
        self._ref: Dict[int, int] = {}
        self._prefix_index: Dict[bytes, int] = {}
        self._page_digest: Dict[int, bytes] = {}
        # per-seq prompt digests + share cap (last-token page never shared)
        self._share_info: Dict[str, dict] = {}
        self._hit_rids: set = set()
        self.share_stats = {
            "prefix_hits": 0,
            "pages_shared": 0,
            "cow_copies": 0,
        }
        self.zero_writes = 0  # pages zeroed (prefill-path bandwidth audit)

    def _index(self, pages) -> torch.Tensor:
        return torch.as_tensor(pages, dtype=torch.long).to(self.device)

    # ------------------------------------------------------------------ #
    # allocation
    # ------------------------------------------------------------------ #
    def pages_needed(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.page_size)

    def can_alloc(self, n_tokens: int) -> bool:
        return self.allocator.num_free >= self.pages_needed(n_tokens)

    def _digests(self, tokens) -> List[bytes]:
        """Cumulative blake2b digest per full ``page_size`` token chunk:
        digest j identifies tokens[0 : (j+1)*page_size]."""
        toks = np.ascontiguousarray(np.asarray(tokens, np.int64).reshape(-1))
        h = hashlib.blake2b(str(self.page_size).encode(), digest_size=16)
        out = []
        for j in range(len(toks) // self.page_size):
            h.update(toks[j * self.page_size : (j + 1) * self.page_size].tobytes())
            out.append(h.copy().digest())
        return out

    def alloc_seq(
        self,
        rid: str,
        n_tokens: int,
        tokens=None,
        *,
        reserve: Optional[int] = None,
        zero: bool = True,
    ) -> bool:
        """Reserve pages for ``n_tokens`` positions and zero-init state.
        False (nothing changes) if the free list is short.

        With ``prefix_sharing`` on and the prompt ``tokens`` given, full
        pages whose cumulative digest is in the prefix index are attached
        by reference: ``seq_len[rid]`` comes back equal to the shared span
        (the last prompt token's page is never shared). ``reserve`` caps
        the initial reservation (chunked prefill); ``zero=False`` skips
        zeroing pages the caller overwrites at once."""
        if rid in self.page_table:
            raise ValueError(f"sequence {rid!r} already allocated")
        if n_tokens > self.max_len:
            raise ValueError(f"{n_tokens} tokens > max_len={self.max_len}")

        shared: List[int] = []
        digests: List[bytes] = []
        if self.prefix_sharing and tokens is not None and n_tokens > 1:
            digests = self._digests(tokens)
            cap = (n_tokens - 1) // self.page_size
            for j in range(min(cap, len(digests))):
                page = self._prefix_index.get(digests[j])
                if page is None:
                    break
                shared.append(page)

        target = max(n_tokens if reserve is None else min(reserve, n_tokens),
                     len(shared) * self.page_size)
        fresh = self.allocator.alloc(self.pages_needed(target) - len(shared))
        if fresh is None:
            return False
        for p in shared:
            self._ref[p] += 1
        for p in fresh:
            self._ref[p] = 1
            if zero:
                self._zero_page(p)
        self.page_table[rid] = shared + fresh
        self.seq_len[rid] = len(shared) * self.page_size
        self._state[rid] = [
            None if s is None else torch.zeros(s, dtype=self._dtypes[i], device=self.device)
            for i, s in enumerate(self._state_shape)
        ]
        if digests:
            self._share_info[rid] = {"digests": digests, "cap": cap}
        if shared:
            if rid not in self._hit_rids:
                self._hit_rids.add(rid)
                self.share_stats["prefix_hits"] += 1
            self.share_stats["pages_shared"] += len(shared)
        return True

    def attach_shared(self, rid: str) -> int:
        """Late prefix attachment for chunked prefill: a mid-prefill
        sequence re-probes before each chunk and swaps its next
        page-aligned, unwritten slots for index pages that have become
        resident since admission. Returns the token positions covered."""
        info = self._share_info.get(rid)
        if info is None or rid not in self.page_table:
            return 0
        ps = self.page_size
        attached = 0
        while True:
            sl = self.seq_len[rid]
            if sl % ps:
                break  # mid-page frontier (unaligned chunk): can't attach
            j = sl // ps
            if j >= info["cap"] or j >= len(info["digests"]):
                break
            d = info["digests"][j]
            page = None if d is None else self._prefix_index.get(d)
            if page is None:
                break
            pt = self.page_table[rid]
            if j < len(pt):
                # a reserved private page nothing has written yet: swap it
                # for the shared one and return it to the pool
                self._decref(pt[j])
                pt[j] = page
            else:
                pt.append(page)
            self._ref[page] += 1
            self.seq_len[rid] = sl + ps
            attached += 1
        if attached:
            if rid not in self._hit_rids:
                self._hit_rids.add(rid)
                self.share_stats["prefix_hits"] += 1
            self.share_stats["pages_shared"] += attached
        return attached * ps

    def ensure_capacity(self, rid: str, n_tokens: int, *, zero: bool = True) -> bool:
        """Grow the page table to cover ``n_tokens`` positions."""
        need = self.pages_needed(n_tokens) - len(self.page_table[rid])
        if need <= 0:
            return True
        pages = self.allocator.alloc(need)
        if pages is None:
            return False
        for p in pages:
            self._ref[p] = 1
            if zero:
                self._zero_page(p)
        self.page_table[rid].extend(pages)
        return True

    def free_seq(self, rid: str) -> None:
        """Release ``rid``, live or parked (a parked sequence drops its host
        copies and the shared pages it retained; never a double free)."""
        if rid in self._parked:
            park = self._parked.pop(rid)
            for slot in park["slots"]:
                if slot["page"] is not None:
                    self._decref(slot["page"])
        else:
            for p in self.page_table.pop(rid):
                self._decref(p)
        self.seq_len.pop(rid, None)
        self._state.pop(rid, None)
        self._share_info.pop(rid, None)
        self._hit_rids.discard(rid)

    def _decref(self, page: int) -> None:
        r = self._ref[page] - 1
        if r > 0:
            self._ref[page] = r
            return
        del self._ref[page]
        self._deregister(page)
        self.allocator.free([page])

    def _zero_page(self, page: int) -> None:
        # a recycled page may hold a dead sequence's KV; zeroing keeps every
        # gathered view equal to the dense reference cache
        self.zero_writes += 1
        for a in self._arenas:
            if a is not None:
                a[page].zero_()

    # ------------------------------------------------------------------ #
    # prefix index
    # ------------------------------------------------------------------ #
    def _register(self, rid: str) -> None:
        """Advertise ``rid``'s fully-written full prompt pages in the
        prefix index (first writer wins)."""
        info = self._share_info.get(rid)
        if info is None:
            return
        digests = info["digests"]
        pt = self.page_table[rid]
        n_full = min(self.seq_len[rid] // self.page_size, len(digests), len(pt))
        for j in range(n_full):
            d = digests[j]
            if d is None or d in self._prefix_index:
                continue
            page = pt[j]
            if page in self._page_digest:
                continue
            self._prefix_index[d] = page
            self._page_digest[page] = d

    def _deregister(self, page: int) -> None:
        d = self._page_digest.pop(page, None)
        if d is not None:
            self._prefix_index.pop(d, None)

    def _mark_overwritten(self, rid: str, start: int, end: int) -> None:
        """A write below the frontier mutates prompt pages away from their
        digests: void those slots' digests for this sequence."""
        if start >= self.seq_len[rid]:
            return
        info = self._share_info.get(rid)
        if info is None:
            return
        ps = self.page_size
        for j in range(start // ps, min((end - 1) // ps + 1, len(info["digests"]))):
            info["digests"][j] = None

    def _writable_page(self, rid: str, j: int) -> int:
        """Page backing slot ``j`` of ``rid``, made safe to write: a shared
        page is copied first (COW); a sole-owned page still advertised in
        the prefix index is deregistered."""
        pt = self.page_table[rid]
        page = pt[j]
        if self._ref[page] > 1:
            got = self.allocator.alloc(1)
            if got is None:
                raise PagesExhausted(f"copy-on-write for {rid!r} page slot {j}: no free pages")
            new = got[0]
            for a in self._arenas:
                if a is not None:
                    a[new] = a[page]
            self._ref[new] = 1
            self._ref[page] -= 1
            pt[j] = new
            self.share_stats["cow_copies"] += 1
            return new
        self._deregister(page)
        return page

    # ------------------------------------------------------------------ #
    # writes
    # ------------------------------------------------------------------ #
    def write_prefill(self, rid: str, cache, length: int, start: int = 0) -> None:
        """Copy a dense single-sequence cache (leaves ``(repeat, 1, S, ...)``
        with ``S >= length``) into this sequence's pages and state; with
        ``start > 0`` only positions ``[start, length)``."""
        self.write_span(rid, cache, start, length)

    def write_span(self, rid: str, cache, start: int, end: int) -> None:
        """Write positions ``[start, end)`` of a dense cache (tensors on the
        cache's device, or numpy arrays) into pages: one indexed copy per
        leaf. State leaves are replaced wholesale. Grows the page table
        (unzeroed: the write plus the tail zero cover every grown page),
        raising ``PagesExhausted`` when it can't."""
        with span("kv.write"):
            if not self.ensure_capacity(rid, end, zero=False):
                raise PagesExhausted(f"no pages for prefill of {rid!r}")
            self._mark_overwritten(rid, start, end)
            leaves, _ = flatten(cache)
            assert len(leaves) == self.num_leaves
            ps = self.page_size
            old_len = self.seq_len[rid]
            j0, j1 = start // ps, (max(end, start + 1) - 1) // ps
            pages = [self._writable_page(rid, j) for j in range(j0, j1 + 1)]
            if end > start:
                pos = np.arange(start, end)
                page_of = self._index(np.asarray(pages)[pos // ps - j0])
                off = self._index(pos % ps)
            for i, leaf in enumerate(leaves):
                arr = on_device(leaf, self.device)
                if self.paged[i]:
                    a = self._arenas[i]
                    if end > start:
                        # (n, repeat, ...feat) at (page, :, offset) per position
                        a[page_of, :, off] = arr[:, 0, start:end].movedim(0, 1).to(a.dtype)
                    # the frontier page may be fresh (unzeroed): zero the tail
                    # not written yet, so gathered views match the dense cache
                    if end >= old_len and end % ps:
                        a[pages[-1], :, end % ps:] = 0
                else:
                    self._state[rid][i] = arr.to(self._dtypes[i], copy=True)
            self.seq_len[rid] = max(old_len, end)
            if self.prefix_sharing:
                self._register(rid)

    def append_token(self, rid: str, slices, position: int) -> None:
        """Write one decode step's output for one lane: ``slices`` is a
        flat leaf list, paged leaves ``(repeat, ...feat)`` (the KV written
        at ``position``), state leaves ``(repeat, 1, ...)`` (replace the
        stored state)."""
        with span("kv.write"):
            if not self.ensure_capacity(rid, position + 1):
                raise PagesExhausted(f"no pages to append to {rid!r}")
            self._mark_overwritten(rid, position, position + 1)
            page = self._writable_page(rid, position // self.page_size)
            off = position % self.page_size
            for i, leaf in enumerate(slices):
                arr = on_device(leaf, self.device)
                if self.paged[i]:
                    self._arenas[i][page, :, off] = arr
                else:
                    self._state[rid][i] = arr.to(self._dtypes[i], copy=True)
            self.seq_len[rid] = max(self.seq_len[rid], position + 1)

    # ------------------------------------------------------------------ #
    # reads
    # ------------------------------------------------------------------ #
    def _full_table(self, rid: Optional[str]) -> List[int]:
        pt = [] if rid is None else self.page_table[rid]
        return list(pt) + [self.zero_page] * (self.view_pages - len(pt))

    def gather(self, rids: List[Optional[str]]):
        """Materialize the dense batch view for a list of lanes (None =
        empty lane, all zeros), shaped like ``init_cache(cfg, B, view_pages
        * page_size)``: one indexed read per paged leaf on the device."""
        with span("kv.gather"):
            B = len(rids)
            tables = self._index([self._full_table(r) for r in rids]).reshape(B, self.view_pages)
            leaves = []
            for i in range(self.num_leaves):
                if self.paged[i]:
                    a = self._arenas[i].movedim(1, 0)  # (repeat, pages, ps, ...feat)
                    v = a[:, tables]  # (repeat, B, VP, ps, ...feat)
                    leaves.append(v.reshape(v.shape[:2] + (-1,) + v.shape[4:]))
                else:
                    zero = torch.zeros(self._state_shape[i], dtype=self._dtypes[i],
                                       device=self.device)
                    leaves.append(
                        torch.cat([zero if r is None else self._state[r][i] for r in rids], dim=1)
                        if B else zero
                    )
            return unflatten(self._spec, leaves)

    def read_dense(self, rid: str, s_max: Optional[int] = None):
        """Dense single-sequence cache for ``rid``, shaped like
        ``init_cache(cfg, 1, s_max)``, every written position equal to the
        page contents bit for bit, zero beyond."""
        length = self.seq_len[rid]
        s_max = length if s_max is None else s_max
        if s_max < length:
            raise ValueError("s_max shorter than written length")
        ps = self.page_size
        pos = np.arange(length)
        page_of = self._index(np.asarray(self.page_table[rid], np.int64)[pos // ps])
        off = self._index(pos % ps)
        leaves = []
        for i in range(self.num_leaves):
            if self.paged[i]:
                a = self._arenas[i]
                out = torch.zeros((a.shape[1], 1, s_max) + tuple(a.shape[3:]),
                                  dtype=a.dtype, device=self.device)
                out[:, 0, :length] = a[page_of, :, off].movedim(0, 1)
                leaves.append(out)
            else:
                leaves.append(self._state[rid][i].clone())
        return unflatten(self._spec, leaves)

    # ------------------------------------------------------------------ #
    # eviction / resume (lossless preemption)
    # ------------------------------------------------------------------ #
    def _to_host(self, pages: List[int]) -> List[Optional[torch.Tensor]]:
        """Each arena's rows ``pages`` copied to host memory, one copy per
        leaf: (len(pages), repeat, ps, ...feat)."""
        idx = self._index(pages)
        return [None if a is None else a[idx].cpu() for a in self._arenas]

    def evict(self, rid: str) -> None:
        """Park ``rid``: private pages (refcount 1) are copied to the host
        and freed; shared pages stay resident under this sequence's
        reference."""
        pt = self.page_table.pop(rid)
        private = [p for p in pt if self._ref[p] <= 1]
        host = self._to_host(private) if private else None
        slots, k = [], 0
        for p in pt:
            if self._ref[p] > 1:
                slots.append({"page": p, "blobs": None})
                continue
            slots.append({"page": None, "blobs": [None if h is None else h[k] for h in host]})
            k += 1
            self._decref(p)
        self._parked[rid] = {
            "slots": slots,
            "state": [None if s is None else s.cpu() for s in self._state.pop(rid)],
            "seq_len": self.seq_len.pop(rid),
        }

    def resume(self, rid: str) -> bool:
        """Re-own pages for a parked sequence and restore its contents bit
        for bit: retained shared pages re-attach in place, private pages
        reallocate and are copied back (one copy per leaf). False (still
        parked, nothing changes) if pages are short."""
        park = self._parked[rid]
        private = [s for s in park["slots"] if s["page"] is None]
        pages = self.allocator.alloc(len(private))
        if pages is None:
            return False
        if private:
            idx = self._index(pages)
            for i, a in enumerate(self._arenas):
                if a is not None:
                    a[idx] = torch.stack([s["blobs"][i] for s in private]).to(self.device)
        table: List[int] = []
        it = iter(pages)
        for slot in park["slots"]:
            if slot["page"] is not None:
                table.append(slot["page"])  # ref was retained at evict
                continue
            p = next(it)
            self._ref[p] = 1
            table.append(p)
        self.page_table[rid] = table
        self.seq_len[rid] = park["seq_len"]
        self._state[rid] = [None if s is None else s.to(self.device) for s in park["state"]]
        del self._parked[rid]
        return True

    def is_parked(self, rid: str) -> bool:
        return rid in self._parked

    def parked_shared_pages(self, rid: str) -> int:
        """Pages a parked ``rid`` still holds resident by reference."""
        return sum(1 for s in self._parked[rid]["slots"] if s["page"] is not None)

    def release_parked_shared(self, rid: str) -> int:
        """Demote a parked sequence's retained shared pages to host copies,
        dropping its references (pages whose refcount hits zero free).
        Lossless. Returns the number of references released."""
        slots = [s for s in self._parked[rid]["slots"] if s["page"] is not None]
        if not slots:
            return 0
        host = self._to_host([s["page"] for s in slots])
        for k, slot in enumerate(slots):
            page = slot["page"]
            slot["blobs"] = [None if h is None else h[k] for h in host]
            slot["page"] = None
            self._decref(page)
        return len(slots)

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        return {
            "num_pages": self.allocator.num_pages,
            "free_pages": self.allocator.num_free,
            "held_pages": self.allocator.num_held,
            "pages_allocated_total": self.allocator.total_allocated,
            "page_size": self.page_size,
            "view_pages": self.view_pages,
            "sequences": len(self.page_table),
            "parked": len(self._parked),
            "indexed_prefix_pages": len(self._prefix_index),
            "shared_pages_now": sum(1 for r in self._ref.values() if r > 1),
            "zero_writes": self.zero_writes,
            **self.share_stats,
        }
