"""Mixture-of-Experts with top-k routing, capacity buckets and a dropless
block-sparse path (port of ``repro.models.moe``).

Dispatch is the sort-free scatter formulation: each (token, k) assignment
gets a slot inside its (group, expert) capacity bucket through a masked
cumulative sum; tokens beyond capacity are dropped (``capacity_factor``
controls the trade). With ``MoEConfig.dropless`` the capacity covers every
token, and the expert FFN runs block-sparsely over the occupied capacity
blocks only: ``sdd`` on the hand-written K3 kernel for the first matmuls and
``dsd`` on K2 for the second (``kernels.bsr_ops``).

Shared experts (DeepSeek-style) are a dense FFN branch added to the routed
output; the router aux (load-balance) loss follows Switch/DeepSeek.

Params keep the reference's layout (``w1 (E, d, f)``, ``w2 (E, f, d)``, ...).
The dropless path reads the per-expert weights in place as the stacked
(d, E*f) matrix that ``sdd`` multiplies (a strided view, ``w1.permute(1, 0,
2)``), where the reference transposes ``w1`` and ``w3`` into it on every
call.

Under ``distributed.ctx.activation_sharding`` (batch rows split over the
data shards, each row its own routing group) the capacity path is expert
parallel where the experts divide the tensor axis: each model rank runs
its E/M experts on its data shard's buckets, then the expert outputs are
gathered back before the combine. The dropless path gathers every
expert's weights (the reference's "no EP resharding") and runs whole on
each model rank; the shared experts are a Megatron FFN. The load-balance
loss takes its means over the whole batch (sums over the data shards).

``moe_apply`` runs inside the ``moe`` span, its parts inside ``moe.route``,
``moe.dispatch``, ``moe.experts`` (the topology, K3 and K2 on the dropless
path), ``moe.combine`` and ``moe.shared`` (``tracing``), and hands the
router's counts to ``tracing.record_route``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..distributed.ctx import DP, MODEL, constrain, dp_size, dp_sum, fetch, model_input, model_part
from ..kernels.bsr_ops import dsd, sdd
from ..sparse.block_csr import topology_from_mask
from ..tracing import record_route, span
from .config import ModelConfig
from .layers import _act

__all__ = ["moe_apply", "moe_init"]


def _dense_init(gen, shape, dev, dtype, scale=None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(shape, generator=gen, device=dev).mul_(scale).to(dtype)


def moe_init(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32, *,
             device=None) -> dict:
    """Random params in the reference's layout, drawn from ``generator``
    (which must live on ``device``). torch's normal draws differ from
    ``jax.random``'s: to compute the reference's layer, carry its params
    across with ``convert.params_from_arrays``."""
    dev = resolve_device(device)
    mc = cfg.moe
    d, E, f = cfg.d_model, mc.num_experts, mc.d_ff
    p = {
        "router": _dense_init(generator, (d, E), dev, dtype, scale=0.02),
        "w1": _dense_init(generator, (E, d, f), dev, dtype),
        "w2": _dense_init(generator, (E, f, d), dev, dtype),
    }
    if cfg.ffn_type == "swiglu":
        p["w3"] = _dense_init(generator, (E, d, f), dev, dtype)
    if mc.num_shared:
        sf = (mc.shared_d_ff or mc.d_ff) * mc.num_shared
        p["sw1"] = _dense_init(generator, (d, sf), dev, dtype)
        p["sw2"] = _dense_init(generator, (sf, d), dev, dtype)
        if cfg.ffn_type == "swiglu":
            p["sw3"] = _dense_init(generator, (d, sf), dev, dtype)
    return p


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    mc = cfg.moe
    if mc.dropless:
        # full capacity: an expert can receive at most one slot per token
        # (top_k indices are distinct), so C = tokens guarantees no drops;
        # round to the sparse block size so capacity blocks tile exactly
        bm = mc.dropless_block
        return max(bm, -(-tokens // bm) * bm)
    c = int(math.ceil(tokens * mc.top_k / mc.num_experts * mc.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to 8, as the reference does


class _Routing(NamedTuple):
    G: int  # groups: batch rows, or one group for single-token decode
    Tg: int  # tokens per group
    C: int  # capacity slots per (group, expert) bucket
    probs: torch.Tensor  # (G, Tg, E) float32 router probabilities
    gate: torch.Tensor  # (G, Tg, k) float32, renormalised over the top k
    counts: torch.Tensor  # (G, E) assignments per bucket
    lin: torch.Tensor  # (G, Tg, k) buffer row (g*E + e)*C + slot; G*E*C if dropped
    dropped: torch.Tensor  # (G, Tg, k) bool


def _route(p: dict, x: torch.Tensor, cfg: ModelConfig, per_lane: bool = False) -> _Routing:
    """Router, top-k and the cumsum slots of ``moe_apply``.

    Groups are batch rows (the reference's data-sharded buckets); a
    single-token decode (S == 1) keeps one global group, since per-group
    capacity would pad E*C far beyond the token count there, unless
    ``per_lane`` asks for a group a row on the capacity path (see
    ``moe_apply``).
    """
    mc = cfg.moe
    B, S, d = x.shape
    E, k = mc.num_experts, mc.top_k
    G, Tg = (B, S) if S > 1 or (per_lane and not mc.dropless) else (1, B * S)
    C = _capacity(Tg, cfg)
    xg = x.reshape(G, Tg, d)
    logits = (xg @ fetch(p["router"].to(xg.dtype))).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)  # sorted, as lax.top_k
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)

    flat_idx = idx.reshape(G, Tg * k)
    onehot = F.one_hot(flat_idx, E)  # (G, Tg*k, E)
    slot_flat = torch.cumsum(onehot, dim=1) - onehot
    slot = slot_flat.gather(2, flat_idx[..., None])[..., 0].reshape(G, Tg, k)
    dropped = slot >= C
    group = torch.arange(G, device=x.device)[:, None, None]
    lin = torch.where(dropped, G * E * C, (group * E + idx) * C + slot)
    return _Routing(G, Tg, C, probs, gate, onehot.sum(dim=1), lin, dropped)


def _dispatch(x: torch.Tensor, r: _Routing, cfg: ModelConfig) -> torch.Tensor:
    """Scatter each assignment's token into its bucket slot: (G, E, C, d).
    Dropped assignments land on one extra row, which is cut off."""
    d = x.shape[-1]
    n_rows = r.G * cfg.moe.num_experts * r.C
    buf = x.new_zeros((n_rows + 1, d))
    tokens = x.reshape(r.G * r.Tg, d).repeat_interleave(cfg.moe.top_k, dim=0)
    buf.index_copy_(0, r.lin.reshape(-1), tokens)
    return buf[:n_rows].view(r.G, cfg.moe.num_experts, r.C, d)


def _dropless_topology(counts: torch.Tensor, C: int, tokens: int, cfg: ModelConfig,
                       f: int):
    """The ``sdd`` topology over the (G*E*C, d) buffer: capacity block row
    (g, e, j) meets expert e's column block iff bucket (g, e) fills block j.
    Derived on the device from the counts; no host sync."""
    mc = cfg.moe
    G, E = counts.shape
    bm = mc.dropless_block
    Cb = C // bm
    dev = counts.device
    occ = -(-counts // bm)  # (G, E) blocks needed per bucket
    occ_mask = torch.arange(Cb, device=dev)[None, None, :] < occ[:, :, None]  # (G, E, Cb)
    eye = torch.eye(E, dtype=torch.bool, device=dev)  # bucket (g, e) multiplies expert e only
    mask = (occ_mask[..., None] & eye[None, :, None, :]).reshape(G * E * Cb, E)
    # each expert wastes at most one partial block per group
    nnz_max = G * min(E * Cb, -(-tokens * mc.top_k // bm) + E)
    return topology_from_mask(mask, (bm, f), nnz_max=nnz_max, device=dev)


def _dropless_ffn(p: dict, buf: torch.Tensor, counts: torch.Tensor, tokens: int,
                  cfg: ModelConfig) -> torch.Tensor:
    """Expert FFN over only the OCCUPIED capacity blocks.

    The (G, E, C, d) buffer is one tall (G*E*C, d) matrix of
    (dropless_block, d) row blocks; each (group, expert) bucket occupies
    ``ceil(count/bm)`` of them. Against the per-expert weights stacked side
    by side as (d, E*f), the routed first matmul is ``sdd`` under the
    topology "bucket row block x its expert's column block", the activation
    runs elementwise on the block data, and ``dsd`` against the stacked
    (E*f, d) second weights maps back to the buffer. Unvisited capacity
    blocks come back as zero rows. FLOPs scale with the occupied blocks
    (~ tokens * top_k), not with the dense E*C buffer.
    """
    G, E, C, d = buf.shape
    f = p["w1"].shape[-1]
    topo = _dropless_topology(counts, C, tokens, cfg, f)
    a = buf.reshape(G * E * C, d)
    h = sdd(a, fetch(p["w1"].to(buf.dtype)).permute(1, 0, 2), topo)
    if cfg.ffn_type == "swiglu":
        g = sdd(a, fetch(p["w3"].to(buf.dtype)).permute(1, 0, 2), topo)
        h = h.with_data(F.silu(h.data) * g.data)
    else:
        h = h.with_data(_act(cfg, h.data))
    out = dsd(h, fetch(p["w2"].to(buf.dtype)).reshape(E * f, d))
    return out.reshape(G, E, C, d)


def _capacity_ffn(p: dict, buf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Expert FFN over the whole (G, E, C, d) buffer: batched products.
    Expert parallel where the experts split over the tensor axis: this
    rank's experts' buckets, its experts' weights, the outputs gathered."""
    ep = MODEL if model_part(cfg.moe.num_experts) else None
    buf = constrain(buf, DP, ep, None, None)
    h = torch.einsum("gecd,edf->gecf", buf, fetch(p["w1"].to(buf.dtype), ep))
    if cfg.ffn_type == "swiglu":
        g = torch.einsum("gecd,edf->gecf", buf, fetch(p["w3"].to(buf.dtype), ep))
        h = F.silu(h) * g
    else:
        h = _act(cfg, h)
    out = torch.einsum("gecf,efd->gecd", h, fetch(p["w2"].to(buf.dtype), ep))
    # back to the data shards before the combine
    return constrain(out, DP, None, None, None, src=1 if ep else None)


def _combine(out_buf: torch.Tensor, r: _Routing, dtype: torch.dtype) -> torch.Tensor:
    """Gather each assignment's expert output (dropped ones give zero) and
    sum them under the gates: (G*Tg, d)."""
    G, E, C, d = out_buf.shape
    flat = out_buf.reshape(G * E * C, d)
    gathered = flat[r.lin.clamp(max=G * E * C - 1)]  # (G, Tg, k, d)
    gathered = torch.where(r.dropped[..., None], 0, gathered)
    return (gathered * r.gate[..., None].to(dtype)).sum(dim=2).reshape(G * r.Tg, d)


def _shared_experts(p: dict, xt: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The shared experts, a dense FFN branch over every token: (T, d)."""
    m = MODEL if model_part(p["sw1"].shape[-1]) else None
    if m:
        xt = model_input(xt)
    h = xt @ fetch(p["sw1"].to(xt.dtype), None, m)
    if cfg.ffn_type == "swiglu":
        h = F.silu(h) * (xt @ fetch(p["sw3"].to(xt.dtype), None, m))
    else:
        h = _act(cfg, h)
    return constrain(h @ fetch(p["sw2"].to(xt.dtype), m, None), src="partial" if m else None)


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, per_lane: bool = False):
    """x: (B, S, d) -> (y (B, S, d), aux_loss 0-d float32).

    ``per_lane``: the rows are independent sequences decoded together (the
    scheduler's batched lane step), where the reference runs each alone (a
    ``vmap`` of the single-sequence step) and so routes each as one group of
    its own. On the capacity path each row then gets its own buckets, so
    more than C tokens on one expert drop nothing that the reference keeps;
    the dropless path drops nothing either way and keeps one group, whose
    buffer is the smaller."""
    mc = cfg.moe
    B, S, d = x.shape
    E, k = mc.num_experts, mc.top_k
    with span("moe"):
        with span("moe.route"):
            r = _route(p, x, cfg, per_lane)
        record_route(r.counts)
        with span("moe.dispatch"):
            buf = _dispatch(x, r, cfg)
        with span("moe.experts"):
            if mc.dropless:
                out_buf = _dropless_ffn(p, buf, r.counts, r.Tg, cfg)
            else:
                out_buf = _capacity_ffn(p, buf, cfg)
        del buf
        with span("moe.combine"):
            y = _combine(out_buf, r, x.dtype)
        if mc.num_shared:
            with span("moe.shared"):
                y = y + _shared_experts(p, x.reshape(B * S, d), cfg)

        # Switch-style load-balance aux loss, its means over the whole batch
        n_dp = dp_size()
        if n_dp == 1:
            me = r.probs.reshape(-1, E).mean(dim=0)  # mean router prob per expert
            ce = r.counts.sum(dim=0).float() / (r.G * r.Tg * k)
        else:  # the sums of every data shard
            me = dp_sum(r.probs.reshape(-1, E).sum(dim=0)) / (r.G * r.Tg * n_dp)
            ce = dp_sum(r.counts.sum(dim=0).float()) / (r.G * r.Tg * k * n_dp)
        aux = mc.aux_loss_coef * E * torch.sum(me * ce)
    return y.reshape(B, S, d), aux
