"""Model assembly: groups of stacked blocks -> LM / enc-dec forward passes
(port of ``repro.models.transformer``).

Public entry points (functions of (params, cfg, inputs)):

  init_params(cfg, generator, device)           -> params dict
  forward_train(params, cfg, batch)             -> (logits, aux_loss)
  init_cache(cfg, batch, s_max, enc_len, dtype, device) -> cache list
  prefill(params, cfg, tokens, cache, enc_out)  -> (logits, cache)
  prefill_chunk(params, cfg, tokens, cache, start, enc_out)
  decode_step(params, cfg, token, cache, pos)   -> (logits, cache)
  encode(params, cfg, src_embeds)               -> enc_out  (enc-dec only)

Params keep the reference's layout: each group's leaves are stacked along a
leading ``repeat`` axis, so ``convert.params_from_arrays`` maps the
reference's ``init_params`` tree leaf for leaf. Where the reference scans
over that axis, the port loops over the layers with views of it, and writes
each layer's keys and values into the stacked cache in place.

A Mamba sub-layer's state leaves (``ssm_cache``: conv and SSD state) are
written in place too: the chunked SSD in "prefill" mode, the recurrent step
in "decode" mode, as the reference threads the mode. So every caller reads
the new state from the cache it passed in (the scheduler's lane step and
paged writes among them).

Under ``distributed.ctx.activation_sharding`` (model sharding) each layer
places its own collectives (see ``distributed.ctx``); the embedding is
vocab-parallel and the logits stay split over the vocabulary
(``whole_logits`` gathers them). ``prefill``, ``prefill_chunk``,
``decode_step`` and ``encode`` take params as DTensors (laid out by
``make_shardings(param_specs)``) or their ``local_view``, and a cache of
DTensors laid out by ``make_shardings(cache_specs)``: the layers see its
``local_view`` and write its local blocks in place, and the caller gets the
same DTensor tree back. Token inputs (``tokens``, ``token``, a per-lane
``pos``, ``src_embeds``) are the whole batch on every rank; each data shard
takes its rows where they split over the dp axes (``ctx.rows``), and runs
the whole batch otherwise. ``enc_out`` is ``encode``'s output under the same
context (this shard's rows), and so are the logits.

``forward_train`` runs the groups in a third mode, "train", with no cache
(a Mamba sub-layer writes no state). ``cfg.remat`` wraps each block as the
reference wraps its scan body: "full" in non-reentrant
``torch.utils.checkpoint`` (every activation recomputed in the backward),
"dots" in a selective-checkpoint policy that saves the outputs of plain
matmuls (``mm``/``addmm``, no batch dims), the counterpart of
``dots_with_no_batch_dims_saveable``. Values are the same either way: only
memory differs. Gradients reach the stacked ``(repeat, ...)`` leaves through
the per-layer views.

An encoder-decoder model (``cfg.enc_groups``) runs ``encode`` over
precomputed frame embeddings: the encoder's groups, bidirectional, with
RoPE at positions ``arange(S_src)``, then ``enc_final_norm``. Each decoder
layer with cross-attention computes the encoder output's keys and values
(``cross_kv``) in "prefill" and "train" modes; at prefill it writes them in
place into the cache's ``cross`` leaves (in the cache's dtype), which the
"decode" mode reads, so that a decode step needs no ``enc_out``. A chunked
prefill recomputes them every chunk, as the reference's does.

``prefill`` and ``prefill_chunk`` run inside the ``model.prefill`` span,
``decode_step`` inside ``model.decode`` (``tracing``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from ..distributed.ctx import (
    DP,
    MODEL,
    constrain,
    current,
    entered,
    fetch,
    local_of,
    local_view,
    model_block,
    model_gather,
    model_input,
    model_part,
    rows,
    rows_whole,
)
from ..tracing import span
from .attention import (
    cross_apply,
    cross_init,
    cross_kv,
    gqa_apply,
    gqa_init,
    mla_apply,
    mla_init,
    write_cache,
)
from .config import GroupSpec, LayerSpec, ModelConfig
from .layers import dense_init, ffn_apply, ffn_init, rmsnorm
from .moe import moe_apply, moe_init
from .ssm import mamba_apply, mamba_decode, mamba_init

__all__ = [
    "init_params",
    "forward_train",
    "init_cache",
    "prefill",
    "prefill_chunk",
    "decode_step",
    "encode",
    "whole_logits",
]


def _cdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _pdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------- #
# Init
# ---------------------------------------------------------------------- #
def _sublayer_init(gen, cfg: ModelConfig, spec: LayerSpec, dtype, dev):
    p = {}
    if spec.mixer in ("gqa", "mla"):
        init = gqa_init if spec.mixer == "gqa" else mla_init
        p["mixer"] = init(gen, cfg, dtype, device=dev)
        p["ln_mixer"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    elif spec.mixer == "mamba":
        p["mixer"] = mamba_init(gen, cfg, dtype, device=dev)
        p["ln_mixer"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    if spec.cross_attn:
        p["cross"] = cross_init(gen, cfg, dtype, device=dev)
        p["ln_cross"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    if spec.ffn == "dense":
        p["ffn"] = ffn_init(gen, cfg, dtype=dtype, device=dev)
        p["ln_ffn"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    elif spec.ffn == "moe":
        p["moe"] = moe_init(gen, cfg, dtype, device=dev)
        p["ln_ffn"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    return p


def _empty_like_stacked(tree, n: int):
    """Uninitialized (n, ...) stacks shaped like the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: _empty_like_stacked(v, n) for k, v in tree.items()}
    return tree.new_empty((n,) + tuple(tree.shape))


def _copy_layer(stacked, tree, i: int) -> None:
    """Copy each leaf of ``tree`` into row ``i`` of its stack."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _copy_layer(stacked[k], v, i)
    else:
        stacked[i].copy_(tree)


def _stack_one(tree):
    """Each leaf of ``tree`` as a (1, ...) tensor on the draw's memory, held
    once. Detached, it is no autograd view of the draw: training makes it a
    leaf of its own that takes ``requires_grad_()`` and in-place updates."""
    if isinstance(tree, dict):
        return {k: _stack_one(v) for k, v in tree.items()}
    return tree.unsqueeze(0).detach()


def _group_init(gen, cfg, g: GroupSpec, dtype, dev):
    """One group's params, each leaf stacked (repeat, ...). Sub-layer by
    sub-layer into preallocated stacks (torch's own draws, not the
    reference's), so that no more than one sub-layer is ever held twice; a
    group of one layer keeps its draws as (1, ...) views, held once."""
    stacked = {}
    for i in range(g.repeat):
        for j, s in enumerate(g.layers):
            sub = _sublayer_init(gen, cfg, s, dtype, dev)
            key = f"sub{j}"
            if g.repeat == 1:
                stacked[key] = _stack_one(sub)
                continue
            if key not in stacked:
                stacked[key] = _empty_like_stacked(sub, g.repeat)
            _copy_layer(stacked[key], sub, i)
            del sub  # before the next sub-layer's draws
    return stacked


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """Random params in the reference's layout and ``cfg.param_dtype``, drawn
    from ``generator`` (which must live on ``device``, None = the card). To
    compute the reference's model, carry its params across with
    ``convert.params_from_arrays`` instead."""
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
    if cfg.is_encdec:
        params["enc_groups"] = [_group_init(generator, cfg, g, dtype, dev)
                                for g in cfg.enc_groups]
        params["enc_final_norm"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
        if cfg.frontend_dim and cfg.frontend_dim != cfg.d_model:
            params["frontend_proj"] = dense_init(generator, (cfg.frontend_dim, cfg.d_model),
                                                 dtype=dtype, device=dev)
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
    enc_out,
    mode: str,
):
    aux = 0.0  # a float32 tensor once an MoE layer adds its loss
    eps = cfg.norm_eps
    for i, spec in enumerate(specs):
        p = p_slice[f"sub{i}"]
        c = cache_slice.get(f"sub{i}") if cache_slice is not None else None
        if spec.mixer in ("gqa", "mla"):
            h = rmsnorm(x, p["ln_mixer"], eps)
            fn = gqa_apply if spec.mixer == "gqa" else mla_apply
            o, _ = fn(
                p["mixer"], h, cfg, positions,
                cache=c["attn"] if c else None, cache_pos=cache_pos, causal=causal,
            )
            x = x + o
        elif spec.mixer == "mamba":
            h = rmsnorm(x, p["ln_mixer"], eps)
            if mode == "decode":
                o, nc = mamba_decode(p["mixer"], h, cfg, c["ssm_cache"])
            else:
                o, nc = mamba_apply(p["mixer"], h, cfg, return_cache=c is not None)
            x = x + o
            if c is not None:
                for k, v in nc.items():  # in place: callers read the cache they passed
                    leaf = c["ssm_cache"][k]
                    local_of(leaf).copy_(model_block(v, leaf))
        if spec.cross_attn:
            h = rmsnorm(x, p["ln_cross"], eps)
            cc = c.get("cross") if c is not None else None
            if cc is not None and mode == "decode":
                kv = cc
            else:
                if enc_out is None:
                    raise ValueError(f"{cfg.name}: cross-attention needs enc_out "
                                     "(encode's output) outside a cached decode step")
                kv = cross_kv(p["cross"], enc_out, cfg, cc)
                if cc is not None:  # in place, for the decode steps to read
                    write_cache(cc, kv, 0, enc_out.shape[1])
            x = x + cross_apply(p["cross"], h, kv, cfg)
        if spec.ffn == "dense":
            x = x + ffn_apply(p["ffn"], rmsnorm(x, p["ln_ffn"], eps), cfg)
        elif spec.ffn == "moe":
            # per-lane positions: each lane routes as its own group, as the
            # reference's lane step (a vmap of the single-sequence step) does
            y, a = moe_apply(p["moe"], rmsnorm(x, p["ln_ffn"], eps), cfg,
                             per_lane=isinstance(cache_pos, torch.Tensor))
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


# plain matmuls, no batch dims: what "dots" keeps for the backward
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat``'s checkpoint, as the reference wraps its
    scan body; the function itself where nothing is recomputed."""
    if cfg.remat not in ("full", "dots") or not torch.is_grad_enabled():
        return fn
    import functools

    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    ctx = current()
    if ctx is not None:  # the recompute may run on autograd's device thread
        inner = fn

        def fn(*args):
            with entered(ctx):
                return inner(*args)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def _run_groups(cfg: ModelConfig, groups, group_params, x, positions, caches, cache_pos,
                causal, enc_out, mode: str):
    """Run each group's layers in order over views of its stacked params
    (and cache, written in place); ``mode`` is "prefill", "decode" or
    "train" (no cache; each block under ``cfg.remat``). ``enc_out`` is the
    encoder's output the cross-attention layers read (None without them).
    Returns (x, caches, aux)."""
    aux_total = 0.0
    for gi, g in enumerate(groups):
        layers = _unstack(group_params[gi], g.repeat)
        layer_caches = _unstack(caches[gi] if caches is not None else None, g.repeat)

        def block(p_slice, x, c_slice=None, specs=g.layers):
            return _block_apply(cfg, specs, p_slice, x, positions, c_slice, cache_pos, causal,
                                enc_out, mode)

        if mode == "train":
            block = _remat(cfg, block)
        for p_slice, c_slice in zip(layers, layer_caches):
            x, a = block(p_slice, x, c_slice)
            aux_total = aux_total + a
    return x, caches, aux_total


# ---------------------------------------------------------------------- #
# Cache construction
# ---------------------------------------------------------------------- #
def _sub_cache(cfg: ModelConfig, spec: LayerSpec, shape_prefix, s_max, enc_len, dtype, dev):
    def zeros(*shape):
        return torch.zeros(shape_prefix + shape, dtype=dtype, device=dev)

    c = {}
    if spec.mixer == "gqa":
        kv = (s_max, cfg.n_kv_heads, cfg.head_dim)
        c["attn"] = {"k": zeros(*kv), "v": zeros(*kv)}
    elif spec.mixer == "mla":
        m = cfg.mla
        c["attn"] = {"ckv": zeros(s_max, m.kv_lora_rank), "kr": zeros(s_max, m.qk_rope_dim)}
    elif spec.mixer == "mamba":  # whole per-sequence state: no sequence axis
        s = cfg.ssm
        ch = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
        c["ssm_cache"] = {"conv": zeros(s.d_conv - 1, ch),
                          "ssm": zeros(s.n_heads(cfg.d_model), s.d_state, s.head_dim)}
    if spec.cross_attn:  # the encoder output's keys and values, written at prefill
        kv = (enc_len, cfg.n_kv_heads, cfg.head_dim)
        c["cross"] = {"k": zeros(*kv), "v": zeros(*kv)}
    return c


def init_cache(cfg: ModelConfig, batch: int, s_max: int, enc_len: int = 0, dtype=None,
               device=None):
    """Decode-capacity cache, stacked (repeat, ...) per group, zeros on
    ``device`` (None = the card) in ``dtype`` (default: the compute dtype);
    the cross-attention leaves hold ``enc_len`` encoder positions."""
    dev = resolve_device(device)
    dtype = dtype or _cdtype(cfg)
    out = []
    for g in cfg.groups:
        block = {}
        for i, s in enumerate(g.layers):
            c = _sub_cache(cfg, s, (g.repeat, batch), s_max, enc_len, dtype, dev)
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
    part = model_part(cfg.vocab_size)
    if part is None:
        return fetch(params["embed"])[tokens].to(_cdtype(cfg))
    # vocab-parallel: this rank's rows (cast, then gathered over fsdp), zeros
    # for the ids outside them, summed over "model"
    table = fetch(params["embed"].to(_cdtype(cfg)), MODEL, None)
    ids = tokens - part[0] * table.shape[0]
    mine = (ids >= 0) & (ids < table.shape[0])
    x = torch.where(mine[..., None], table[ids.clamp(0, table.shape[0] - 1)], 0)
    return constrain(x, DP, None, None, src="partial")


def _unembed(params, cfg, x):
    """Logits in the compute dtype; under a mesh split over the vocabulary
    on the tensor axis where it divides (each rank its own block)."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    m = MODEL if model_part(cfg.vocab_size) else None
    if m:
        x = model_input(x)
    if cfg.tie_embeddings:
        logits = x @ fetch(params["embed"].to(x.dtype), m, None).T
    else:
        logits = x @ fetch(params["lm_head"].to(x.dtype), None, m)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _view(tree):
    """The model's view of ``tree``: its ``local_view`` where it holds
    DTensors (a sharded server's params or cache), else ``tree``."""
    if tree is None or current() is None:
        return tree
    from torch.distributed.tensor import DTensor

    from ..tree import tree_leaves

    if any(isinstance(leaf, DTensor) for leaf in tree_leaves(tree)):
        return local_view(tree)[0]
    return tree


def whole_logits(logits, cfg: ModelConfig, batch: int):
    """Logits of a call under a mesh (this data shard's rows, split over
    the vocabulary on the tensor axis) gathered whole: (``batch``, ...,
    vocab), the same on every rank. Outside a context ``logits``."""
    if model_part(cfg.vocab_size):
        logits = model_gather(logits, -1)
    return rows_whole(logits, batch)


def encode(params, cfg: ModelConfig, src_embeds):
    """Encoder stack over precomputed frontend embeddings (B, S_src,
    frontend_dim), a tensor on the params' device: bidirectional, RoPE at
    positions arange(S_src), under ``cfg.remat`` where gradients are on.
    Returns (B, S_src, d_model) in the compute dtype (under a mesh this
    data shard's rows)."""
    return _encode(_view(params), cfg, rows(src_embeds))


def _encode(params, cfg: ModelConfig, src_embeds):
    x = src_embeds.to(_cdtype(cfg))
    if "frontend_proj" in params:
        x = x @ fetch(params["frontend_proj"].to(x.dtype))
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, _ = _run_groups(cfg, cfg.enc_groups, params["enc_groups"], x, positions, None, None,
                          False, None, "train")
    return rmsnorm(x, params["enc_final_norm"], cfg.norm_eps)


def forward_train(params, cfg: ModelConfig, batch: dict):
    """Teacher-forced forward. batch: {"tokens": (B, S)} integer tensor on
    the params' device and, for an enc-dec model, {"src_embeds": (B, S_src,
    frontend_dim)}. Returns (logits (B, S, V) in the compute dtype, aux 0-d
    float32: the MoE layers' load-balance loss, 0 without them).

    Under ``distributed.ctx.activation_sharding`` ``params`` is the step's
    ``local_view`` and ``batch`` this data shard's rows; the logits come out
    split over the vocabulary on the tensor axis where it divides."""
    tokens = batch["tokens"]
    enc_out = _encode(params, cfg, batch["src_embeds"]) if cfg.is_encdec else None
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, _, aux = _run_groups(cfg, cfg.groups, params["groups"], x, positions, None, None,
                            cfg.causal, enc_out, "train")
    if not isinstance(aux, torch.Tensor):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _unembed(params, cfg, x), aux


def prefill(params, cfg: ModelConfig, tokens, cache, enc_out=None):
    """Process the prompt, filling the cache at positions [0, S) (and, for
    an enc-dec model, its cross leaves from ``enc_out``)."""
    return prefill_chunk(params, cfg, tokens, cache, 0, enc_out=enc_out)


def prefill_chunk(params, cfg: ModelConfig, tokens, cache, start: int, enc_out=None):
    """Process prompt positions [start, start+S), writing the cache at the
    same offsets and attending over every cached position <= each query.
    With start == 0 this is exactly ``prefill``.

    Only valid for models whose cache is entirely attention KV: a Mamba
    sub-layer in "prefill" mode recomputes its state from scratch over just
    this chunk (as the reference's does), so chunked callers (the serving
    scheduler) gate on a fully-paged cache."""
    with span("model.prefill"):
        view = _view(params)
        tokens = rows(tokens)
        x = _embed(view, cfg, tokens)
        positions = start + torch.arange(tokens.shape[1], device=tokens.device)
        x, _, _ = _run_groups(cfg, cfg.groups, view["groups"], x, positions, _view(cache), start,
                              cfg.causal, enc_out, "prefill")
        return _unembed(view, cfg, x[:, -1:]), cache


def decode_step(params, cfg: ModelConfig, token, cache, pos, enc_out=None):
    """One decode step. token: (B, 1) integer; pos: its position, an int
    for the whole batch or a (B,) integer tensor, one per lane (each lane
    writes its cache at its own position and attends up to it). An enc-dec
    model reads the cross keys and values its prefill cached: ``enc_out``
    is not needed."""
    with span("model.decode"):
        view = _view(params)
        token = rows(token)
        if isinstance(pos, torch.Tensor):
            pos = rows(pos) if pos.dim() else pos
            positions = pos.to(device=token.device, dtype=torch.int32).reshape(-1, 1)
        else:
            positions = torch.full((token.shape[0], 1), pos, dtype=torch.int32,
                                   device=token.device)
        x = _embed(view, cfg, token)
        x, _, _ = _run_groups(cfg, cfg.groups, view["groups"], x, positions, _view(cache), pos,
                              cfg.causal, enc_out, "decode")
        return _unembed(view, cfg, x), cache
