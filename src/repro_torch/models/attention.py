"""Attention mixers: GQA with RoPE and optional qk-norm, MLA (DeepSeek-V2's
multi-head latent attention) and the decoder's cross-attention over an
encoder's output (port of ``repro.models.attention``).

Cache layout (per layer): GQA ``{"k": (B, S_max, Kv, Dh), "v": (B, S_max,
Kv, Dh)}``; MLA ``{"ckv": (B, S_max, kv_lora_rank), "kr": (B, S_max,
qk_rope_dim)}``, the compressed latent and the rope key shared by every
head; cross ``{"k": (B, S_src, Kv, Dh), "v": ...}``, computed once at
prefill (``cross_kv``) and read at decode. The reference writes the new entries with ``dynamic_update_slice``
into a cache its decode step donates; the port writes them in place at
``cache_pos`` (an int, or a (B,) tensor of per-lane offsets) and returns
the same dict.

Under ``distributed.ctx.activation_sharding`` GQA, MLA and cross-attention
run their heads split over the tensor axis where the query heads divide it
(each rank's heads counted from its local weight's width, ``wo``
row-parallel and an all-reduce); key/value heads that do not divide it come
from the whole projection, each rank taking those its query heads read.
Where the query heads do not divide, the layer runs whole on every model
rank.

A cache under a mesh is the ``local_view`` of DTensors laid out by
``cache_specs``: its leaves may be ``ShardedLeaf``s. Key/value heads split
over "model" hold the rank's heads. A cache split over the sequence
(context parallel: GQA and cross K/V where the key/value heads do not
divide "model", MLA's latent always) holds a contiguous block of positions
on each rank: a write lands only in the rank's own positions (a decode
step's on the rank that owns ``pos``), and attention over it is taken per
rank over its block, for every query head, and joined by
``ctx.combine_partial_softmax``; each rank then keeps its own heads'
output. MLA's materialized prefill gathers the latent over "model" instead.
``_sdpa_chunked`` stays off under a mesh, as it is for per-lane positions.

``gqa_apply`` and ``mla_apply`` run inside the ``attn`` span (``tracing``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..device import resolve_device
from ..distributed.ctx import (
    MODEL,
    combine_partial_softmax,
    constrain,
    current,
    fetch,
    local_of,
    model_gather,
    model_input,
    model_offset,
    model_part,
    model_whole,
    split_over_model,
)
from ..tracing import span
from .config import ModelConfig
from .layers import dense_init, rmsnorm, rope

__all__ = ["gqa_init", "gqa_apply", "mla_init", "mla_apply", "cross_init", "cross_apply",
           "write_cache"]

NEG_INF = -1e30


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """q: (B,Sq,K,G,Dh) grouped; k,v: (B,Sk,K,Dh); mask: (1,1,1,Sq,Sk) or None.
    Scores and softmax in float32, masked entries at NEG_INF."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def _sdpa_chunked(q, k, v, q_offset: int, causal: bool, chunk: int) -> torch.Tensor:
    """Streaming-softmax (flash) attention: a loop over key chunks with
    running (m, l, acc); never materializes (Sq, Sk) scores. The same float32
    softmax accumulation as ``_sdpa``.

    q: (B,Sq,K,G,D) at global positions q_offset+i; k/v: (B,Sk,K,D).
    """
    B, Sq, K, G, D = q.shape
    Sk = k.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    qpos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, K, G, Sq), -math.inf, device=dev)
    l = torch.zeros((B, K, G, Sq), device=dev)  # noqa: E741 (the reference's name)
    acc = torch.zeros((B, Sq, K, G, D), device=dev)
    for c0 in range(0, Sk, chunk):
        # the reference pads the last chunk; masking its missing keys is the same
        kci, vci = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        kpi = c0 + torch.arange(kci.shape[1], device=dev)
        s = torch.einsum("bqkgd,bskd->bkgqs", q, kci).float() * scale
        valid = torch.ones((1, kci.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            valid = kpi[None, :] <= qpos[:, None]
        s = torch.where(valid, s, -math.inf)
        m2 = torch.maximum(m, s.amax(dim=-1))
        # exp(-inf - -inf) guard: rows with no valid keys yet keep l=0
        m2_safe = torch.where(torch.isinf(m2), 0.0, m2)
        p = torch.exp(s - m2_safe[..., None])
        p = torch.where(valid, p, 0.0)
        alpha = torch.where(torch.isinf(m), 0.0, torch.exp(m - m2_safe))
        l = l * alpha + p.sum(dim=-1)  # noqa: E741
        pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), vci)
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
        m = m2
    l = torch.clamp(l, min=1e-30)  # noqa: E741
    out = acc / l.permute(0, 3, 1, 2)[..., None]
    return out.to(q.dtype)


def causal_mask(sq: int, sk: int, offset, device=None) -> torch.Tensor:
    """Boolean, query i (global pos offset+i) sees key j<=pos: (1,1,1,Sq,Sk)
    for an int ``offset``, (B,1,1,Sq,Sk) for a (B,) tensor of per-lane
    offsets."""
    dev = resolve_device(device)
    kpos = torch.arange(sk, device=dev)
    if isinstance(offset, torch.Tensor):
        qpos = offset.to(dev)[:, None] + torch.arange(sq, device=dev)  # (B, Sq)
        return (kpos <= qpos[..., None])[:, None, None]
    qpos = offset + torch.arange(sq, device=dev)[:, None]
    return (kpos[None, :] <= qpos)[None, None, None]


def write_cache(cache: dict, new: dict, cache_pos, S: int) -> None:
    """Write each ``new[name]`` (B, S, ...) into ``cache[name]`` in place at
    positions [cache_pos, cache_pos + S): one offset for the batch, or one a
    lane for a (B,) tensor ``cache_pos`` (an indexed write). A leaf split
    over the sequence takes only the positions of its own block."""
    for name, val in new.items():
        leaf = cache[name]
        buf, lo = local_of(leaf), model_offset(leaf, 1)
        n = buf.shape[1]
        if isinstance(cache_pos, torch.Tensor):
            B = val.shape[0]
            lanes = torch.arange(B, device=buf.device)[:, None].expand(B, S)
            slots = cache_pos.to(buf.device)[:, None] + torch.arange(S, device=buf.device)
            if _seq_split(leaf):  # this rank's positions only
                slots = slots - lo
                mine = (slots >= 0) & (slots < n)
                buf[lanes[mine], slots[mine]] = val[mine].to(buf.dtype)
            else:
                buf[lanes, slots] = val.to(buf.dtype)
        else:
            a, b = max(cache_pos, lo), min(cache_pos + S, lo + n)
            if a < b:
                buf[:, a - lo:b - lo] = val[:, a - cache_pos:b - cache_pos]


def _seq_split(leaf) -> bool:
    """A cache leaf split over the sequence on more than one model rank."""
    return split_over_model(leaf, 1)


def _heads_split(leaf) -> bool:
    return split_over_model(leaf, 2)


def _gather_heads(t: torch.Tensor, split) -> torch.Tensor:
    """Every query head's ``t`` (dim 2), from this rank's where ``split``."""
    return model_gather(t, 2) if split else t


def _own_heads(t: torch.Tensor, split, n_local: int) -> torch.Tensor:
    """This rank's heads (dim 2) of every head's ``t`` where ``split``."""
    if not split:
        return t
    return t.narrow(2, current().model.rank * n_local, n_local)


def _sdpa_cp(q, k, v, mask) -> torch.Tensor:
    """``_sdpa`` over this rank's block of a sequence-split cache, joined
    across the model ranks (``combine_partial_softmax``): q (B,Sq,K,G,Dh)
    every head; k/v (B,Sk_local,K,Dh); mask (1 or B,1,1,Sq,Sk_local) or
    None. Float32 throughout, the output in v's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1)
    e = torch.exp(scores - m[..., None])
    acc = torch.einsum("bkgqs,bskd->bkgqd", e, v.float())
    m, l, acc = combine_partial_softmax(m, e.sum(dim=-1), acc)  # noqa: E741
    return (acc / l[..., None]).permute(0, 3, 1, 2, 4).to(v.dtype)


def _cp_mask(sq: int, n: int, lo: int, offset, device) -> torch.Tensor:
    """``causal_mask`` for keys at global positions [lo, lo + n)."""
    m = causal_mask(sq, lo + n, offset, device)
    return m[..., lo:]


# ---------------------------------------------------------------------- #
# GQA
# ---------------------------------------------------------------------- #
def gqa_init(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device=None) -> dict:
    d, H, Kv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def init(shape):
        return dense_init(generator, shape, dtype=dtype, device=device)

    p = {
        "wq": init((d, H * Dh)),
        "wk": init((d, Kv * Dh)),
        "wv": init((d, Kv * Dh)),
        "wo": init((H * Dh, d)),
    }
    if cfg.qk_norm:
        p["qn"] = torch.ones((Dh,), dtype=dtype, device=resolve_device(device))
        p["kn"] = torch.ones((Dh,), dtype=dtype, device=resolve_device(device))
    return p


def gqa_apply(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,  # (S,) or (B,S) global positions of x tokens
    cache: Optional[dict] = None,
    cache_pos=None,  # write offset into the cache: an int, or (B,) per lane
    causal: bool = True,
):
    """x: (B, S, d) -> (out (B, S, d), cache). With ``cache`` the new keys
    and values are written into it in place at [cache_pos, cache_pos + S),
    and the queries attend over the whole cache, masked causally at their
    global positions. A (B,) tensor ``cache_pos`` gives each lane its own
    offset (the scheduler's batched decode over lanes at different
    positions): an indexed write on the batch axis, a per-lane mask."""
    with span("attn"):
        B, S, d = x.shape
        H, Kv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        part = model_part(H)
        cp = cache is not None and _seq_split(cache["k"])
        kv_of = None
        if part is None:
            split = None
            q = (x @ fetch(p["wq"].to(x.dtype))).reshape(B, S, H, Dh)
            k = (x @ fetch(p["wk"].to(x.dtype))).reshape(B, S, Kv, Dh)
            v = (x @ fetch(p["wv"].to(x.dtype))).reshape(B, S, Kv, Dh)
            qn, kn = p.get("qn"), p.get("kn")
        else:  # this rank's query heads; their key/value heads
            split, xin = MODEL, model_input(x)
            wq = fetch(p["wq"].to(x.dtype), None, MODEL)
            H = wq.shape[-1] // Dh
            q = (xin @ wq).reshape(B, S, H, Dh)
            qn = model_input(p["qn"]) if cfg.qk_norm else None
            if model_part(Kv) and (cache is None or _heads_split(cache["k"])):
                wk = fetch(p["wk"].to(x.dtype), None, MODEL)
                Kv = wk.shape[-1] // Dh
                k = (xin @ wk).reshape(B, S, Kv, Dh)
                v = (xin @ fetch(p["wv"].to(x.dtype), None, MODEL)).reshape(B, S, Kv, Dh)
                kn = model_input(p["kn"]) if cfg.qk_norm else None
            else:  # every key/value head (cached whole), then one a query head
                k = (x @ fetch(p["wk"].to(x.dtype))).reshape(B, S, Kv, Dh)
                v = (x @ fetch(p["wv"].to(x.dtype))).reshape(B, S, Kv, Dh)
                if cfg.qk_norm:
                    k = rmsnorm(k, p["kn"], cfg.norm_eps)
                kn = None
                kv_of = (part[0] * H + torch.arange(H, device=x.device)) // (cfg.n_heads // Kv)
        if cfg.qk_norm:
            q = rmsnorm(q, qn, cfg.norm_eps)
            if kn is not None:
                k = rmsnorm(k, kn, cfg.norm_eps)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

        per_lane = isinstance(cache_pos, torch.Tensor)
        if cache is not None:
            write_cache(cache, {"k": k, "v": v}, cache_pos, S)
        if cp:  # every query head over this rank's positions, joined over "model"
            k_loc = local_of(cache["k"]).to(x.dtype)
            lo = model_offset(cache["k"], 1)
            qa = _gather_heads(q, split)
            mask = _cp_mask(S, k_loc.shape[1], lo, cache_pos, x.device) if causal else None
            out = _sdpa_cp(qa.reshape(B, S, Kv, qa.shape[2] // Kv, Dh), k_loc,
                           local_of(cache["v"]).to(x.dtype), mask)
            out = _own_heads(out.reshape(B, S, -1, Dh), split, H)
        else:
            if cache is not None:
                k_all, v_all = local_of(cache["k"]).to(x.dtype), local_of(cache["v"]).to(x.dtype)
                q_offset = cache_pos
            else:
                k_all, v_all = k, v
                q_offset = 0
            if kv_of is not None:  # G = 1
                k_all, v_all = model_input(k_all)[:, :, kv_of], model_input(v_all)[:, :, kv_of]
                Kv = H
            qg = q.reshape(B, S, Kv, H // Kv, Dh)
            chunk = cfg.attn_chunk
            if (chunk and S > 1 and k_all.shape[1] >= 2 * chunk and not per_lane
                    and current() is None):
                out = _sdpa_chunked(qg, k_all, v_all, q_offset, causal, chunk)
            else:
                mask = causal_mask(S, k_all.shape[1], q_offset, x.device) if causal else None
                out = _sdpa(qg, k_all, v_all, mask)
        out = out.reshape(B, S, H * Dh) @ fetch(p["wo"].to(x.dtype), split, None)
        return constrain(out, src="partial" if split else None), cache


# ---------------------------------------------------------------------- #
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------- #
def mla_init(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device=None) -> dict:
    """Random params in the reference's layout (``wdq``, ``qln``, ``wuq``,
    ``wdkv``, ``kvln``, ``wukv``, ``wo``), drawn from ``generator``."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    dev = resolve_device(device)

    def init(shape):
        return dense_init(generator, shape, dtype=dtype, device=dev)

    return {
        "wdq": init((d, m.q_lora_rank)),
        "qln": torch.ones((m.q_lora_rank,), dtype=dtype, device=dev),
        "wuq": init((m.q_lora_rank, H * qk)),
        "wdkv": init((d, m.kv_lora_rank + m.qk_rope_dim)),
        "kvln": torch.ones((m.kv_lora_rank,), dtype=dtype, device=dev),
        "wukv": init((m.kv_lora_rank, H * (m.qk_nope_dim + m.v_head_dim))),
        "wo": init((H * m.v_head_dim, d)),
    }


def mla_apply(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,  # (S,) or (B,S) global positions of x tokens
    cache: Optional[dict] = None,
    cache_pos=None,  # write offset into the cache: an int, or (B,) per lane
    causal: bool = True,
    absorb: Optional[bool] = None,
):
    """x: (B, S, d) -> (out (B, S, d), cache). ``absorb=None`` picks the
    absorbed formulation for a single-token decode step (a cache and S ==
    1) and the materialized one otherwise, as the reference does.

    Materialized: k_nope and v for every cached position from ``wukv``, the
    rope key broadcast over the heads. Absorbed: ``wuk`` folded into the
    queries, scores taken in the kv_lora-wide latent space plus the rope
    term, the probabilities applied to the latents and ``wuv`` after. Scores
    and softmax in float32 at scale 1/sqrt(qk_nope_dim + qk_rope_dim)."""
    with span("attn"):
        m = cfg.mla
        B, S, d = x.shape
        H = cfg.n_heads
        C, dn, dr, dv = m.kv_lora_rank, m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim
        if absorb is None:
            absorb = cache is not None and S == 1

        # the latents are whole on every model rank; the heads split where
        # they divide the tensor axis
        split = MODEL if model_part(H) else None
        cq = rmsnorm(x @ fetch(p["wdq"].to(x.dtype)), p["qln"], cfg.norm_eps)
        wuq = fetch(p["wuq"].to(x.dtype), None, split)
        H = wuq.shape[-1] // (dn + dr)
        q = (model_input(cq) if split else cq) @ wuq
        q = q.reshape(B, S, H, dn + dr)
        q_nope, q_rope = q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)

        ckv_full = x @ fetch(p["wdkv"].to(x.dtype))  # (B, S, C + dr)
        ckv = rmsnorm(ckv_full[..., :C], p["kvln"], cfg.norm_eps)
        k_rope = rope(ckv_full[..., None, C:], positions, cfg.rope_theta)[:, :, 0]  # (B, S, dr)

        if cache is not None:
            write_cache(cache, {"ckv": ckv, "kr": k_rope}, cache_pos, S)
            cp = _seq_split(cache["ckv"])
            lo = model_offset(cache["ckv"], 1)
            if cp and not absorb:  # the materialized prefill reads every position
                ckv_all, kr_all, lo = model_whole(cache["ckv"]), model_whole(cache["kr"]), 0
                cp = False
            else:
                ckv_all, kr_all = local_of(cache["ckv"]), local_of(cache["kr"])
            ckv_all, kr_all = ckv_all.to(x.dtype), kr_all.to(x.dtype)
            mask = _cp_mask(S, ckv_all.shape[1], lo, cache_pos, x.device)
        else:
            cp = False
            ckv_all, kr_all = ckv, k_rope
            mask = causal_mask(S, S, 0, x.device) if causal else None
        if split and not cp:
            ckv_all, kr_all = model_input(ckv_all), model_input(kr_all)
        sk = ckv_all.shape[1]

        wukv = fetch(p["wukv"].to(x.dtype), None, split).reshape(C, H, dn + dv)
        wuk, wuv = wukv[..., :dn], wukv[..., dn:]  # (C, H, dn), (C, H, dv)
        scale = 1.0 / math.sqrt(dn + dr)
        if cp:  # absorbed, every head over this rank's latent positions, joined
            q_c = _gather_heads(torch.einsum("bqhd,chd->bqhc", q_nope, wuk), split)
            q_r = _gather_heads(q_rope, split)
            scores = (torch.einsum("bqhc,bsc->bhqs", q_c, ckv_all)
                      + torch.einsum("bqhd,bsd->bhqs", q_r, kr_all)).float() * scale
            scores = torch.where(mask[:, 0], scores, NEG_INF)
            m_ = scores.amax(dim=-1)
            e = torch.exp(scores - m_[..., None])
            acc = torch.einsum("bhqs,bsc->bhqc", e, ckv_all.float())
            m_, l_, acc = combine_partial_softmax(m_, e.sum(dim=-1), acc)
            o_c = _own_heads((acc / l_[..., None]).permute(0, 2, 1, 3).to(x.dtype), split, H)
            out = torch.einsum("bqhc,chd->bqhd", o_c, wuv)
        else:
            if absorb:
                q_c = torch.einsum("bqhd,chd->bqhc", q_nope, wuk)  # (B, S, H, C)
                scores = (torch.einsum("bqhc,bsc->bhqs", q_c, ckv_all)
                          + torch.einsum("bqhd,bsd->bhqs", q_rope, kr_all)).float() * scale
            else:
                kv = torch.einsum("bsc,chd->bshd", ckv_all, wukv)  # materialized k_nope | v
                k = torch.cat([kv[..., :dn], kr_all[:, :, None].expand(B, sk, H, dr)], dim=-1)
                qf = torch.cat([q_nope, q_rope], dim=-1)
                scores = torch.einsum("bqhd,bshd->bhqs", qf, k).float() * scale
            if mask is not None:
                scores = torch.where(mask[:, 0], scores, NEG_INF)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            if absorb:
                o_c = torch.einsum("bhqs,bsc->bqhc", probs, ckv_all)  # compressed values
                out = torch.einsum("bqhc,chd->bqhd", o_c, wuv)
            else:
                out = torch.einsum("bhqs,bshd->bqhd", probs, kv[..., dn:])
        out = out.reshape(B, S, H * dv) @ fetch(p["wo"].to(x.dtype), split, None)
        return constrain(out, src="partial" if split else None), cache


# ---------------------------------------------------------------------- #
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------- #
def cross_init(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device=None) -> dict:
    """Random params in the reference's layout (``wq``, ``wk``, ``wv``,
    ``wo``), drawn from ``generator``."""
    d, H, Kv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def init(shape):
        return dense_init(generator, shape, dtype=dtype, device=device)

    return {
        "wq": init((d, H * Dh)),
        "wk": init((d, Kv * Dh)),
        "wv": init((d, Kv * Dh)),
        "wo": init((H * Dh, d)),
    }


def _cross_kv_split(cfg: ModelConfig, cache) -> bool:
    """Whether cross K/V come as this rank's key/value heads: the query and
    key/value heads divide "model" and the cache (if any) holds them so."""
    return bool(model_part(cfg.n_heads) and model_part(cfg.n_kv_heads)
                and (cache is None or _heads_split(cache["k"])))


def cross_kv(p: dict, enc_out: torch.Tensor, cfg: ModelConfig, cache=None) -> dict:
    """The encoder output's keys and values, (B, S_src, Kv, Dh) each, in
    ``enc_out``'s dtype: computed once a prefill and cached for decode.
    Under a mesh this rank's key/value heads where they split with the
    query heads (and ``cache``, the layer's cross cache, holds them so);
    every head otherwise."""
    B, Sk, _ = enc_out.shape
    Kv, Dh = cfg.n_kv_heads, cfg.head_dim
    if _cross_kv_split(cfg, cache):
        xin = model_input(enc_out)
        wk = fetch(p["wk"].to(enc_out.dtype), None, MODEL)
        k = (xin @ wk).reshape(B, Sk, -1, Dh)
        v = (xin @ fetch(p["wv"].to(enc_out.dtype), None, MODEL)).reshape(B, Sk, -1, Dh)
        return {"k": k, "v": v}
    k = (enc_out @ fetch(p["wk"].to(enc_out.dtype))).reshape(B, Sk, Kv, Dh)
    v = (enc_out @ fetch(p["wv"].to(enc_out.dtype))).reshape(B, Sk, Kv, Dh)
    return {"k": k, "v": v}


def cross_apply(p: dict, x: torch.Tensor, kv: dict, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) attends, unmasked and without RoPE, over ``kv`` (cast to
    x's dtype) -> (B, S, d). ``kv`` is ``cross_kv``'s output or the layer's
    cross cache; a cache split over the source positions is attended per
    rank and joined over "model"."""
    B, S, d = x.shape
    H, Kv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    split = MODEL if model_part(H) else None
    if split:
        wq = fetch(p["wq"].to(x.dtype), None, MODEL)
        H = wq.shape[-1] // Dh
        q = (model_input(x) @ wq).reshape(B, S, H, Dh)
    else:
        q = (x @ fetch(p["wq"].to(x.dtype))).reshape(B, S, H, Dh)
    k, v = local_of(kv["k"]).to(x.dtype), local_of(kv["v"]).to(x.dtype)
    if _seq_split(kv["k"]):
        qa = _gather_heads(q, split)
        out = _sdpa_cp(qa.reshape(B, S, Kv, qa.shape[2] // Kv, Dh), k, v, None)
        out = _own_heads(out.reshape(B, S, -1, Dh), split, H)
    else:
        if split and k.shape[2] == Kv:  # every key/value head: one a query head
            kv_of = (model_part(cfg.n_heads)[0] * H
                     + torch.arange(H, device=x.device)) // (cfg.n_heads // Kv)
            k, v = model_input(k)[:, :, kv_of], model_input(v)[:, :, kv_of]
        Kl = k.shape[2]
        out = _sdpa(q.reshape(B, S, Kl, H // Kl, Dh), k, v, None)
    out = out.reshape(B, S, H * Dh) @ fetch(p["wo"].to(x.dtype), split, None)
    return constrain(out, src="partial" if split else None)
