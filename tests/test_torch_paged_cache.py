"""PyTorch port, the paged KV cache: ``repro_torch.serve.paged_cache``
against a dense reference model (a copy of tests/test_paged_cache.py's) and
against the JAX package's ``PagedKVCache`` on the same operations.

Random alloc/append/overwrite/free/evict/resume interleavings must never
leak or double-allocate pages, every read must equal the dense reference
bit for bit, and the port must keep the reference's page tables, refcounts,
prefix index, counters and arena bytes step by step (its arenas are torch
tensors of the reference's shape). Property tests run without a deadline,
under real hypothesis when installed, else the fixed-seed stub.
"""
import gc
import json
import os
import weakref

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # keep deterministic sampling without hypothesis
    from _hypothesis_stub import given, settings, st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402
from repro_torch.serve.paged_cache import (  # noqa: E402
    PageAllocator, PagedKVCache, PagesExhausted, flatten, unflatten,
)
from test_torch_linear import _sealed_reference_plans  # noqa: E402,F401 (autouse)

CPU = "cpu"
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
requires_cuda = pytest.mark.requires_cuda


@pytest.fixture(autouse=True)
def _card(request):
    """Tests marked requires_cuda skip without a card: decided here, when the
    test runs, so that every worker collects the same tests."""
    if request.node.get_closest_marker("requires_cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def gqa_cfg():
    return get_config("llama3.2-3b", reduced=True)


# ---------------------------------------------------------------------- #
# allocator
# ---------------------------------------------------------------------- #
@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10_000), num_pages=st.integers(1, 24))
def test_allocator_never_leaks_or_double_allocates(seed, num_pages):
    rng = np.random.default_rng(seed)
    alloc = PageAllocator(num_pages)
    held = []
    for _ in range(60):
        alloc.check()
        if held and rng.random() < 0.4:
            alloc.free(held.pop(int(rng.integers(len(held)))))
        else:
            n = int(rng.integers(0, num_pages + 2))
            free_before = alloc.num_free
            got = alloc.alloc(n)
            assert (got is None) == (n > free_before)
            if got is None:
                assert alloc.num_free == free_before  # atomic: nothing taken
                continue
            assert len(got) == n
            held.append(got)
        flat = [p for ps in held for p in ps]
        assert len(flat) == len(set(flat)) == alloc.num_held
    for ps in held:
        alloc.free(ps)
    assert alloc.num_free == num_pages
    alloc.check()


def test_allocator_rejects_double_free_and_oversize():
    a = PageAllocator(4)
    got = a.alloc(3)
    assert a.alloc(2) is None and a.num_free == 1
    a.free(got)
    with pytest.raises(ValueError):
        a.free(got[:1])
    with pytest.raises(ValueError):
        a.alloc(-1)
    with pytest.raises(ValueError):
        PageAllocator(0)
    a.check()


# ---------------------------------------------------------------------- #
# the port's cache against a dense reference
# ---------------------------------------------------------------------- #
def _random_prefill_cache(cfg, length, rng):
    """A fake dense prefill result shaped like init_cache(cfg, 1, length):
    (the cache tree of numpy leaves, the flat leaves)."""
    leaves, spec = flatten(init_cache(cfg, 1, length, device=CPU))
    filled = [rng.standard_normal(tuple(leaf.shape)).astype(np.float32) for leaf in leaves]
    return unflatten(spec, filled), filled


def _random_slices(kv, rng):
    """One decode step's write for one lane, as the lane step emits it."""
    out = []
    for i in range(kv.num_leaves):
        a = kv._arenas[i]
        shape = ((a.shape[1],) + tuple(a.shape[3:])) if kv.paged[i] else kv._state_shape[i]
        out.append(rng.standard_normal(shape).astype(np.float32))
    return out


class _DenseRef:
    """Parallel dense reference: per-sequence numpy leaves grown position
    by position, bit for bit what PagedKVCache must reproduce."""

    def __init__(self, kv):
        self.kv = kv
        self.seqs = {}

    def prefill(self, rid, flat, length):
        self.seqs[rid] = {
            "len": length,
            "leaves": [leaf[:, :, :length].copy() if self.kv.paged[i] else leaf.copy()
                       for i, leaf in enumerate(flat)],
        }

    def append(self, rid, slices, position):
        s = self.seqs[rid]
        for i, sl in enumerate(slices):
            if self.kv.paged[i]:
                cur = s["leaves"][i]
                if position >= cur.shape[2]:
                    pad = np.zeros(cur.shape[:2] + (position + 1 - cur.shape[2],) + cur.shape[3:],
                                   cur.dtype)
                    cur = np.concatenate([cur, pad], axis=2)
                cur[:, 0, position] = sl
                s["leaves"][i] = cur
            else:
                s["leaves"][i] = sl.copy()
        s["len"] = max(s["len"], position + 1)

    def check(self, rid):
        s = self.seqs[rid]
        got, _ = flatten(self.kv.read_dense(rid))
        assert self.kv.seq_len[rid] == s["len"]
        for i, (g, r) in enumerate(zip(got, s["leaves"])):
            g = g.cpu().numpy()
            if self.kv.paged[i]:
                np.testing.assert_array_equal(g[:, :, :s["len"]], r[:, :, :s["len"]],
                                              err_msg=f"leaf {i}")
            else:
                np.testing.assert_array_equal(g, r, err_msg=f"leaf {i}")


def _det_cache(kv, cfg, tokens):
    """Dense prefill cache whose paged contents are a pure function of
    (leaf, position, token id): prompts agreeing on a token prefix get
    identical content over it, as a shared page would be."""
    P = len(tokens)
    leaves, spec = flatten(init_cache(cfg, 1, P, device=CPU))
    out = []
    for i, leaf in enumerate(leaves):
        arr = np.zeros(tuple(leaf.shape), np.float32)
        for pos in range(P):
            r = np.random.default_rng((i * 7919 + pos) * 65537 + int(tokens[pos]))
            arr[:, 0, pos] = r.standard_normal(arr.shape[:1] + arr.shape[3:]).astype(np.float32)
        out.append(arr)
    return unflatten(spec, out), out


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 10_000), page_size=st.integers(2, 6))
def test_random_ops_match_dense_reference(gqa_cfg, seed, page_size):
    rng = np.random.default_rng(seed)
    max_len = 4 * page_size
    kv = PagedKVCache(gqa_cfg, num_pages=14, page_size=page_size, max_len=max_len,
                      dtype=torch.float32, device=CPU)
    ref = _DenseRef(kv)
    live, parked, next_rid = [], [], 0
    for _ in range(50):
        kv.allocator.check()
        op = rng.random()
        if op < 0.35 or not live:
            P = int(rng.integers(1, max_len // 2 + 1))
            rid = f"q{next_rid}"
            if not kv.can_alloc(P):
                continue
            assert kv.alloc_seq(rid, P)
            cache, flat = _random_prefill_cache(gqa_cfg, P, rng)
            kv.write_prefill(rid, cache, P)
            ref.prefill(rid, flat, P)
            live.append(rid)
            next_rid += 1
        elif op < 0.70:
            rid = live[int(rng.integers(len(live)))]
            posn = kv.seq_len[rid]
            if posn >= max_len or not kv.ensure_capacity(rid, posn + 1):
                continue
            sl = _random_slices(kv, rng)
            kv.append_token(rid, sl, posn)
            ref.append(rid, sl, posn)
        elif op < 0.82:
            rid = live.pop(int(rng.integers(len(live))))
            kv.evict(rid)
            parked.append(rid)
        elif op < 0.90 and parked:
            rid = parked[int(rng.integers(len(parked)))]
            if kv.resume(rid):
                parked.remove(rid)
                live.append(rid)
                ref.check(rid)  # resume must be lossless
        elif live:
            rid = live.pop(int(rng.integers(len(live))))
            kv.free_seq(rid)
            del ref.seqs[rid]
        if live:
            ref.check(live[int(rng.integers(len(live)))])
    for rid in live:
        kv.free_seq(rid)
    for rid in parked:
        assert kv.resume(rid)
        ref.check(rid)
        kv.free_seq(rid)
    assert kv.allocator.num_free == kv.allocator.num_pages
    assert not bool(kv._arenas[0][kv.zero_page].any())  # the zero page stays zero
    kv.allocator.check()


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_shared_prefix_random_ops_match_dense_reference(gqa_cfg, seed):
    """Shared prompt prefixes, decode appends, overwrites inside a shared
    span (copy-on-write), evict, resume, finish and finish-while-parked keep
    every request's view equal to an unshared dense reference."""
    rng = np.random.default_rng(seed)
    max_len = 24
    kv = PagedKVCache(gqa_cfg, num_pages=40, page_size=4, max_len=max_len,
                      dtype=torch.float32, prefix_sharing=True, device=CPU)
    ref = _DenseRef(kv)
    vocab = 40
    families = [rng.integers(1, vocab, 8), rng.integers(1, vocab, 12)]
    live, parked, n = [], [], 0
    for _ in range(60):
        kv.allocator.check()
        op = rng.random()
        if op < 0.30 or not live:
            fam = families[int(rng.integers(len(families)))]
            tokens = np.concatenate([fam, rng.integers(1, vocab, int(rng.integers(1, 5)))])
            rid = f"s{n}"
            if not kv.alloc_seq(rid, len(tokens), tokens=tokens, zero=False):
                continue
            n += 1
            cache, flat = _det_cache(kv, gqa_cfg, tokens)
            kv.write_prefill(rid, cache, len(tokens), start=kv.seq_len[rid])
            ref.prefill(rid, flat, len(tokens))
            live.append(rid)
        elif op < 0.65:
            # append at the frontier, or overwrite inside the span (COW)
            rid = live[int(rng.integers(len(live)))]
            posn = kv.seq_len[rid] if op < 0.55 else int(rng.integers(0, kv.seq_len[rid]))
            if posn >= max_len:
                continue
            sl = _random_slices(kv, rng)
            try:
                kv.append_token(rid, sl, posn)
            except PagesExhausted:
                continue
            ref.append(rid, sl, posn)
        elif op < 0.78:
            rid = live.pop(int(rng.integers(len(live))))
            kv.evict(rid)
            parked.append(rid)
        elif op < 0.86 and parked:
            rid = parked[int(rng.integers(len(parked)))]
            if kv.resume(rid):
                parked.remove(rid)
                live.append(rid)
                ref.check(rid)
        elif op < 0.93 and parked:
            rid = parked.pop(int(rng.integers(len(parked))))
            kv.free_seq(rid)  # finish-while-parked
            del ref.seqs[rid]
        elif live:
            rid = live.pop(int(rng.integers(len(live))))
            kv.free_seq(rid)
            del ref.seqs[rid]
        for check_rid in live:
            ref.check(check_rid)
    for rid in live:
        kv.free_seq(rid)
    for rid in parked:
        assert kv.resume(rid)
        ref.check(rid)
        kv.free_seq(rid)
    assert kv.allocator.num_free == kv.allocator.num_pages
    kv.allocator.check()


# ---------------------------------------------------------------------- #
# the port's cache against the reference's, operation by operation
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jpc():
    """The reference's paged cache and config (numpy arenas, no jit)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jget
    from repro.serve import paged_cache

    return jax, jget("llama3.2-3b", reduced=True), paged_cache


def _assert_same_state(kv, jkv):
    assert kv.page_table == jkv.page_table
    assert kv.seq_len == jkv.seq_len
    assert kv._ref == jkv._ref
    assert kv._prefix_index == jkv._prefix_index
    assert kv._page_digest == jkv._page_digest
    assert kv.share_stats == jkv.share_stats
    assert kv.zero_writes == jkv.zero_writes
    assert set(kv._parked) == set(jkv._parked)
    assert kv.stats() == jkv.stats()
    assert list(kv.allocator._free) == list(jkv.allocator._free)
    for i, (a, b) in enumerate(zip(kv._arenas, jkv._arenas)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"arena {i}")


@pytest.mark.parametrize("sharing", [False, True], ids=["plain", "prefix-sharing"])
@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_ops_match_reference_cache_step_by_step(jpc, gqa_cfg, sharing, seed):
    """The same random operations on the port's and the reference's
    PagedKVCache leave equal page tables, seq_len, refcounts, prefix index
    (the digests are the reference's bytes), counters and arena bytes."""
    jax, jcfg, jpaged = jpc
    rng = np.random.default_rng(seed)
    ps, max_len = 4, 24
    kv = PagedKVCache(gqa_cfg, num_pages=16, page_size=ps, max_len=max_len,
                      dtype=torch.float32, prefix_sharing=sharing, device=CPU)
    jkv = jpaged.PagedKVCache(jcfg, num_pages=16, page_size=ps, max_len=max_len,
                              dtype=np.float32, prefix_sharing=sharing)
    families = [rng.integers(1, 30, 8), rng.integers(1, 30, 12)]
    live, parked, n = [], [], 0
    for _ in range(40):
        op = rng.random()
        if op < 0.3 or not live:
            tokens = np.concatenate([families[int(rng.integers(2))],
                                     rng.integers(1, 30, int(rng.integers(1, 5)))])
            rid, P = f"s{n}", len(tokens)
            zero = bool(rng.random() < 0.5)
            ok = kv.alloc_seq(rid, P, tokens=tokens, zero=zero)
            assert ok == jkv.alloc_seq(rid, P, tokens=tokens, zero=zero)
            if not ok:
                continue
            n += 1
            start = kv.seq_len[rid]
            cache, flat = _det_cache(kv, gqa_cfg, tokens)
            kv.write_prefill(rid, cache, P, start=start)
            jkv.write_prefill(rid, jax.tree_util.tree_unflatten(jkv.treedef, flat), P,
                              start=start)
            live.append(rid)
        elif op < 0.6:
            rid = live[int(rng.integers(len(live)))]
            posn = kv.seq_len[rid] if op < 0.5 else int(rng.integers(0, kv.seq_len[rid]))
            if posn >= max_len:
                continue
            sl = _random_slices(kv, rng)
            for cache in (kv, jkv):
                try:
                    cache.append_token(rid, sl, posn)
                except PagesExhausted:
                    pass
                except jpaged.PagesExhausted:
                    pass
        elif op < 0.75:
            rid = live.pop(int(rng.integers(len(live))))
            kv.evict(rid)
            jkv.evict(rid)
            parked.append(rid)
        elif op < 0.85 and parked:
            rid = parked[int(rng.integers(len(parked)))]
            if rng.random() < 0.3:
                assert kv.release_parked_shared(rid) == jkv.release_parked_shared(rid)
            ok = kv.resume(rid)
            assert ok == jkv.resume(rid)
            if ok:
                parked.remove(rid)
                live.append(rid)
        elif live:
            rid = live.pop(int(rng.integers(len(live))))
            kv.free_seq(rid)
            jkv.free_seq(rid)
        _assert_same_state(kv, jkv)
        if live:
            rid = live[0]
            got, _ = flatten(kv.read_dense(rid, s_max=max_len))
            want, _ = jax.tree_util.tree_flatten(jkv.read_dense(rid, s_max=max_len))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            got, _ = flatten(kv.gather(live[:2] + [None]))
            want, _ = jax.tree_util.tree_flatten(jkv.gather(live[:2] + [None]))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_flatten_round_trips_and_holds_no_reference_cycle():
    """JAX's leaf order (dict keys sorted), rebuilt by unflatten; and with
    the cyclic garbage collector off, a flattened tensor dies with its last
    reference (a cycle kept every decode step's batch view alive)."""
    tree = [{"b": 1, "a": (2, 3)}, [4]]
    leaves, spec = flatten(tree)
    assert leaves == [2, 3, 1, 4] and unflatten(spec, leaves) == tree
    gc.disable()
    try:
        t = torch.zeros(3)
        ref = weakref.ref(t)
        leaves, spec = flatten([{"k": t}])
        del t, leaves, spec
        assert ref() is None
    finally:
        gc.enable()


def test_layout_matches_golden_fixture():
    """Arena shapes, leaf classification, the view width and the reserved
    zero page are those tests/fixtures/serving.json freezes."""
    with open(os.path.join(FIXTURES, "serving.json")) as f:
        doc = json.load(f)
    frozen, s = doc["paged_cache"], doc["scheduler"]
    cfg = get_config(doc["config"], reduced=True)
    kv = PagedKVCache(cfg, num_pages=s["num_pages"], page_size=s["page_size"],
                      max_len=s["max_len"], dtype=torch.float32, device=CPU)
    assert kv.view_pages == frozen["view_pages"]
    assert kv.zero_page == frozen["zero_page"]
    assert kv.num_leaves == frozen["num_leaves"]
    assert list(kv.paged) == frozen["paged"]
    assert [None if a is None else list(a.shape) for a in kv._arenas] == frozen["arena_shapes"]


# ---------------------------------------------------------------------- #
# contracts the scheduler relies on
# ---------------------------------------------------------------------- #
def test_gather_pads_with_zero_page(gqa_cfg):
    kv = PagedKVCache(gqa_cfg, num_pages=8, page_size=4, max_len=16, dtype=torch.float32,
                      device=CPU)
    rng = np.random.default_rng(0)
    assert kv.alloc_seq("a", 3)
    cache, _ = _random_prefill_cache(gqa_cfg, 3, rng)
    kv.write_prefill("a", cache, 3)
    view, _ = flatten(kv.gather(["a", None]))
    dense, _ = flatten(kv.read_dense("a", s_max=16))
    for v, r in zip(view, dense):
        assert tuple(v.shape[1:3]) == (2, 16)
        torch.testing.assert_close(v[:, :1], r, rtol=0, atol=0)
        assert not bool(v[:, 1].any()) and not bool(v[:, 0, 3:].any())


def test_capacity_failures_are_clean_and_typed(gqa_cfg):
    kv = PagedKVCache(gqa_cfg, num_pages=4, page_size=4, max_len=16, dtype=torch.float32,
                      device=CPU)
    rng = np.random.default_rng(0)
    assert kv.pages_needed(0) == 0
    assert kv.alloc_seq("a", 12)
    assert not kv.alloc_seq("b", 8) and "b" not in kv.page_table
    assert kv.alloc_seq("c", 4)
    assert not kv.ensure_capacity("c", 8) and len(kv.page_table["c"]) == 1
    with pytest.raises(ValueError):
        kv.alloc_seq("d", 17)
    with pytest.raises(ValueError):
        PagedKVCache(gqa_cfg, num_pages=2, page_size=4, max_len=16, device=CPU)
    assert kv.alloc_seq("z", 0) and kv.page_table["z"] == []
    with pytest.raises(PagesExhausted):
        kv.append_token("z", _random_slices(kv, rng), 0)
    cache, _ = _random_prefill_cache(gqa_cfg, 4, rng)
    with pytest.raises(PagesExhausted):
        kv.write_prefill("z", cache, 4)
    assert issubclass(PagesExhausted, RuntimeError)
    assert kv.page_table["z"] == [] and kv.seq_len["z"] == 0
    kv.free_seq("a")
    kv.append_token("z", _random_slices(kv, rng), 0)
    for rid in ("c", "z"):
        kv.free_seq(rid)
    assert kv.allocator.num_free == 4
    kv.allocator.check()


def test_prefill_path_does_not_double_zero_and_parked_finish_frees_once(gqa_cfg):
    kv = PagedKVCache(gqa_cfg, num_pages=8, page_size=4, max_len=16, dtype=torch.float32,
                      device=CPU)
    rng = np.random.default_rng(0)
    assert kv.alloc_seq("a", 10, zero=False)
    cache, _ = _random_prefill_cache(gqa_cfg, 10, rng)
    kv.write_prefill("a", cache, 10)
    assert kv.zero_writes == 0
    for v in flatten(kv.gather(["a"]))[0]:
        assert not bool(v[:, 0, 10:].any())
    assert kv.alloc_seq("b", 3) and kv.zero_writes == 1
    kv.evict("a")
    assert kv.is_parked("a") and kv.allocator.num_held == 1
    kv.free_seq("a")  # finish-while-parked drops the host copies
    with pytest.raises(KeyError):
        kv.free_seq("a")
    kv.free_seq("b")
    assert kv.allocator.num_free == 8
    kv.allocator.check()


def test_prefix_sharing_cow_isolates_and_release_parked_shared(gqa_cfg):
    kv = PagedKVCache(gqa_cfg, num_pages=12, page_size=4, max_len=16, dtype=torch.float32,
                      prefix_sharing=True, device=CPU)
    tokens = np.random.default_rng(3).integers(1, 50, 12)
    cache, _ = _det_cache(kv, gqa_cfg, tokens)
    assert kv.alloc_seq("r1", 12, tokens=tokens, zero=False) and kv.seq_len["r1"] == 0
    kv.write_prefill("r1", cache, 12)
    assert kv.alloc_seq("r2", 12, tokens=tokens, zero=False)
    assert kv.seq_len["r2"] == 8 and kv.page_table["r2"][:2] == kv.page_table["r1"][:2]
    assert kv.allocator.num_held == 4
    kv.write_prefill("r2", cache, 12, start=8)
    ref1 = [t.clone() for t in flatten(kv.read_dense("r1"))[0]]
    sl = _random_slices(kv, np.random.default_rng(4))
    kv.append_token("r2", sl, 5)  # inside the shared page 1: COW
    assert kv.share_stats == {"prefix_hits": 1, "pages_shared": 2, "cow_copies": 1}
    for a, b in zip(flatten(kv.read_dense("r1"))[0], ref1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)  # the sibling is untouched
    want = [t.clone() for t in flatten(kv.read_dense("r2"))[0]]
    kv.evict("r2")
    assert kv.parked_shared_pages("r2") == 1
    kv.free_seq("r1")  # page 0 now held only by the parked r2
    assert kv.release_parked_shared("r2") == 1
    assert kv.resume("r2")
    for a, b in zip(flatten(kv.read_dense("r2"))[0], want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    kv.free_seq("r2")
    assert kv.allocator.num_free == 12
    kv.allocator.check()


@requires_cuda
def test_arenas_on_the_card_round_trip_bit_for_bit():
    """On the card: prefill, gather, read_dense, evict to host and resume
    give back the same bits, in bfloat16, and the zero page stays zero."""
    cfg = get_config("llama3.2-3b", reduced=True)
    kv = PagedKVCache(cfg, num_pages=10, page_size=4, max_len=16, device="cuda")
    assert kv._arenas[0].device.type == "cuda" and kv._arenas[0].dtype == torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    leaves, spec = flatten(init_cache(cfg, 1, 11, device="cuda"))
    dense = [torch.randn(tuple(x.shape), generator=gen, device="cuda").to(x.dtype) for x in leaves]
    assert kv.alloc_seq("a", 11, zero=False)
    kv.write_prefill("a", unflatten(spec, dense), 11)
    for got, want in zip(flatten(kv.read_dense("a"))[0], dense):
        assert torch.equal(got, want)
    view = [t.clone() for t in flatten(kv.gather(["a", None]))[0]]
    kv.evict("a")
    assert kv.resume("a")
    for got, want in zip(flatten(kv.gather(["a", None]))[0], view):
        assert torch.equal(got, want)
    assert not bool(kv._arenas[0][kv.zero_page].any())
