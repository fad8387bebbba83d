"""Model assembly: groups of stacked blocks -> LM forward passes for serving
(port of the inference half of ``repro.models.transformer``).

Public entry points (functions of (params, cfg, inputs)):

  init_params(cfg, generator, device)           -> params dict
  init_cache(cfg, batch, s_max, dtype, device)  -> cache list
  prefill(params, cfg, tokens, cache)           -> (logits, cache)
  prefill_chunk(params, cfg, tokens, cache, start)
  decode_step(params, cfg, token, cache, pos)   -> (logits, cache)

Params keep the reference's layout: each group's leaves are stacked along a
leading ``repeat`` axis, so ``convert.params_from_arrays`` maps the
reference's ``init_params`` tree leaf for leaf. Where the reference scans
over that axis, the port loops over the layers with views of it, and writes
each layer's keys and values into the stacked cache in place.

Ported: the GQA mixer, the dense FFN (dense or SABLE block-sparse) and the
MoE FFN. Mamba, MLA, cross-attention, ``encode`` and ``forward_train`` raise
``NotImplementedError`` until their slices.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from .attention import gqa_apply, gqa_init
from .config import GroupSpec, LayerSpec, ModelConfig
from .layers import dense_init, ffn_apply, ffn_init, rmsnorm
from .moe import moe_apply, moe_init

__all__ = [
    "init_params",
    "forward_train",
    "init_cache",
    "prefill",
    "prefill_chunk",
    "decode_step",
    "encode",
]


def _cdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _pdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet; they come with the "
            "encoder-decoder slice"
        )
    for g in cfg.groups:
        for s in g.layers:
            if s.mixer == "mamba":
                raise NotImplementedError(
                    f"{cfg.name}: Mamba layers are not ported yet; they come with the "
                    "Mamba slice"
                )
            if s.mixer == "mla":
                raise NotImplementedError(
                    f"{cfg.name}: MLA layers are not ported yet; they come with the MLA "
                    "slice (the full DeepSeek-V2 model)"
                )
            if s.cross_attn:
                raise NotImplementedError(
                    f"{cfg.name}: cross-attention is not ported yet; it comes with the "
                    "encoder-decoder slice"
                )


# ---------------------------------------------------------------------- #
# Init
# ---------------------------------------------------------------------- #
def _sublayer_init(gen, cfg: ModelConfig, spec: LayerSpec, dtype, dev):
    p = {}
    if spec.mixer == "gqa":
        p["mixer"] = gqa_init(gen, cfg, dtype, device=dev)
        p["ln_mixer"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    if spec.ffn == "dense":
        p["ffn"] = ffn_init(gen, cfg, dtype=dtype, device=dev)
        p["ln_ffn"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    elif spec.ffn == "moe":
        p["moe"] = moe_init(gen, cfg, dtype, device=dev)
        p["ln_ffn"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    return p


def _stack(trees: list):
    """Stack a list of equal dict trees leaf by leaf along a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _group_init(gen, cfg, g: GroupSpec, dtype, dev):
    """One group's params, each leaf stacked (repeat, ...). Layer by layer,
    then stacked: the draws are torch's own, not the reference's."""
    blocks = []
    for _ in range(g.repeat):
        blocks.append({f"sub{i}": _sublayer_init(gen, cfg, s, dtype, dev)
                       for i, s in enumerate(g.layers)})
    return _stack(blocks)


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """Random params in the reference's layout and ``cfg.param_dtype``, drawn
    from ``generator`` (which must live on ``device``, None = the card). To
    compute the reference's model, carry its params across with
    ``convert.params_from_arrays`` instead."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dtype = _pdtype(cfg)
    params = {
        "embed": dense_init(generator, (cfg.vocab_size, cfg.d_model), 0.02, dtype, dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "groups": [_group_init(generator, cfg, g, dtype, dev) for g in cfg.groups],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (cfg.d_model, cfg.vocab_size), 0.02, dtype,
                                       dev)
    return params


# ---------------------------------------------------------------------- #
# Block apply (one layer)
# ---------------------------------------------------------------------- #
def _block_apply(
    cfg: ModelConfig,
    specs,
    p_slice: dict,
    x,
    positions,
    cache_slice: Optional[dict],
    cache_pos,
    causal: bool,
):
    aux = 0.0  # a float32 tensor once an MoE layer adds its loss
    eps = cfg.norm_eps
    for i, spec in enumerate(specs):
        p = p_slice[f"sub{i}"]
        c = cache_slice.get(f"sub{i}") if cache_slice is not None else None
        if spec.mixer == "gqa":
            h = rmsnorm(x, p["ln_mixer"], eps)
            o, _ = gqa_apply(
                p["mixer"], h, cfg, positions,
                cache=c["attn"] if c else None, cache_pos=cache_pos, causal=causal,
            )
            x = x + o
        if spec.ffn == "dense":
            x = x + ffn_apply(p["ffn"], rmsnorm(x, p["ln_ffn"], eps), cfg)
        elif spec.ffn == "moe":
            y, a = moe_apply(p["moe"], rmsnorm(x, p["ln_ffn"], eps), cfg)
            x = x + y
            aux = aux + a
    return x, aux


def _unstack(tree, n: int) -> list:
    """The n per-layer views of a tree of stacked (n, ...) leaves."""
    if tree is None:
        return [None] * n
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(tree.unbind(0))


def _run_groups(cfg: ModelConfig, groups, group_params, x, positions, caches, cache_pos,
                causal):
    """Run each group's layers in order over views of its stacked params
    (and cache, written in place). Returns (x, caches, aux)."""
    aux_total = 0.0
    for gi, g in enumerate(groups):
        layers = _unstack(group_params[gi], g.repeat)
        layer_caches = _unstack(caches[gi] if caches is not None else None, g.repeat)
        for p_slice, c_slice in zip(layers, layer_caches):
            x, a = _block_apply(cfg, g.layers, p_slice, x, positions, c_slice, cache_pos,
                                causal)
            aux_total = aux_total + a
    return x, caches, aux_total


# ---------------------------------------------------------------------- #
# Cache construction
# ---------------------------------------------------------------------- #
def _sub_cache(cfg: ModelConfig, spec: LayerSpec, shape_prefix, s_max, dtype, dev):
    if spec.mixer == "gqa":
        kv = shape_prefix + (s_max, cfg.n_kv_heads, cfg.head_dim)
        return {"attn": {"k": torch.zeros(kv, dtype=dtype, device=dev),
                         "v": torch.zeros(kv, dtype=dtype, device=dev)}}
    return {}


def init_cache(cfg: ModelConfig, batch: int, s_max: int, enc_len: int = 0, dtype=None,
               device=None):
    """Decode-capacity cache, stacked (repeat, ...) per group, zeros on
    ``device`` (None = the card) in ``dtype`` (default: the compute dtype)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dtype = dtype or _cdtype(cfg)
    out = []
    for g in cfg.groups:
        block = {}
        for i, s in enumerate(g.layers):
            c = _sub_cache(cfg, s, (g.repeat, batch), s_max, dtype, dev)
            if c:
                block[f"sub{i}"] = c
        out.append(block)
    return out


# ---------------------------------------------------------------------- #
# Entry points
# ---------------------------------------------------------------------- #
def _embed(params, cfg, tokens):
    # gather, then cast: the reference casts the whole table first; the
    # values are the same
    return params["embed"][tokens].to(_cdtype(cfg))


def _unembed(params, cfg, x):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _no_encoder(enc_out) -> None:
    if enc_out is not None:
        raise NotImplementedError(
            "enc_out= (encoder-decoder models) is not ported yet; it comes with the "
            "encoder-decoder slice"
        )


def encode(params, cfg: ModelConfig, src_embeds):
    raise NotImplementedError(
        "encode (encoder-decoder models) is not ported yet; it comes with the "
        "encoder-decoder slice"
    )


def forward_train(params, cfg: ModelConfig, batch: dict):
    raise NotImplementedError(
        "forward_train is not ported yet; it comes with the training slice (the "
        "backward passes of the sparse families)"
    )


def prefill(params, cfg: ModelConfig, tokens, cache, enc_out=None):
    """Process the prompt, filling the cache at positions [0, S)."""
    return prefill_chunk(params, cfg, tokens, cache, 0, enc_out=enc_out)


def prefill_chunk(params, cfg: ModelConfig, tokens, cache, start: int, enc_out=None):
    """Process prompt positions [start, start+S), writing the cache at the
    same offsets and attending over every cached position <= each query.
    With start == 0 this is exactly ``prefill``."""
    _no_encoder(enc_out)
    x = _embed(params, cfg, tokens)
    positions = start + torch.arange(tokens.shape[1], device=tokens.device)
    x, new_cache, _ = _run_groups(cfg, cfg.groups, params["groups"], x, positions, cache,
                                  start, cfg.causal)
    return _unembed(params, cfg, x[:, -1:]), new_cache


def decode_step(params, cfg: ModelConfig, token, cache, pos: int, enc_out=None):
    """One decode step. token: (B, 1) integer, pos: its position (an int)."""
    _no_encoder(enc_out)
    x = _embed(params, cfg, token)
    positions = torch.full((token.shape[0], 1), pos, dtype=torch.int32, device=token.device)
    x, new_cache, _ = _run_groups(cfg, cfg.groups, params["groups"], x, positions, cache,
                                  pos, cfg.causal)
    return _unembed(params, cfg, x), new_cache
