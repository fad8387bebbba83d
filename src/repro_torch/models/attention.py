"""Attention mixers: GQA with RoPE and optional qk-norm (port of
``repro.models.attention``; MLA and cross-attention come in later slices).

Cache layout (per layer): ``{"k": (B, S_max, Kv, Dh), "v": (B, S_max, Kv,
Dh)}``. The reference writes the new keys and values with
``dynamic_update_slice`` into a cache its decode step donates; the port
writes them in place at ``cache_pos`` and returns the same dict.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..device import resolve_device
from .config import ModelConfig
from .layers import dense_init, rmsnorm, rope

__all__ = ["gqa_init", "gqa_apply", "mla_init", "mla_apply", "cross_init", "cross_apply"]

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


def causal_mask(sq: int, sk: int, offset: int, device=None) -> torch.Tensor:
    """(1,1,1,Sq,Sk) boolean: query i (global pos offset+i) sees key j<=pos."""
    dev = resolve_device(device)
    qpos = offset + torch.arange(sq, device=dev)[:, None]
    kpos = torch.arange(sk, device=dev)[None, :]
    return (kpos <= qpos)[None, None, None]


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
    cache_pos: Optional[int] = None,  # write offset into the cache
    causal: bool = True,
):
    """x: (B, S, d) -> (out (B, S, d), cache). With ``cache`` the new keys
    and values are written into it in place at [cache_pos, cache_pos + S),
    and the queries attend over the whole cache, masked causally at their
    global positions."""
    B, S, d = x.shape
    H, Kv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // Kv
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, Dh)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, S, Kv, Dh)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, S, Kv, Dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["qn"], cfg.norm_eps)
        k = rmsnorm(k, p["kn"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is not None:
        cache["k"][:, cache_pos:cache_pos + S] = k
        cache["v"][:, cache_pos:cache_pos + S] = v
        k_all, v_all = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
        q_offset = cache_pos
    else:
        k_all, v_all = k, v
        q_offset = 0

    qg = q.reshape(B, S, Kv, G, Dh)
    chunk = cfg.attn_chunk
    if chunk and S > 1 and k_all.shape[1] >= 2 * chunk:
        out = _sdpa_chunked(qg, k_all, v_all, q_offset, causal, chunk)
    else:
        mask = causal_mask(S, k_all.shape[1], q_offset, x.device) if causal else None
        out = _sdpa(qg, k_all, v_all, mask)
    out = out.reshape(B, S, H * Dh)
    return out @ p["wo"].to(x.dtype), cache


# ---------------------------------------------------------------------- #
# MLA and cross-attention: later slices
# ---------------------------------------------------------------------- #
def _mla_not_ported(*_args, **_kwargs):
    raise NotImplementedError(
        "MLA attention is not ported yet; it comes with the MLA slice (the full "
        "DeepSeek-V2 model), after the scheduler slice"
    )


def _cross_not_ported(*_args, **_kwargs):
    raise NotImplementedError(
        "cross-attention is not ported yet; it comes with the encoder-decoder slice"
    )


mla_init = mla_apply = _mla_not_ported
cross_init = cross_apply = _cross_not_ported
