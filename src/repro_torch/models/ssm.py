"""Mamba-2 (SSD, state-space duality) mixer (port of ``repro.models.ssm``).

Prefill uses the chunked SSD algorithm: an intra-chunk "attention-like"
quadratic term plus inter-chunk state passing, a loop over the chunks:
O(S * Q) work with chunk size Q, parallel within chunks (batched matmuls).
Decode is the O(1) recurrent update on a (B, H, N, P) state.

Cache layout: {"conv": (B, d_conv-1, ch), "ssm": (B, H, N, P)}. The
conv cache holds the last d_conv-1 *pre-activation* conv inputs.

Dtypes follow the reference step for step: the softplus of dt runs in
float32 and is cast to the activations' dtype; ``dA``, its cumulative sum,
the decay matrix and the carried state run in that dtype (bfloat16 in
serving). Everything here is plain PyTorch: the reference computes SSD with
``einsum``, ``lax.scan`` and ``lax.conv_general_dilated``, outside any
Pallas kernel.

Under ``distributed.ctx.activation_sharding`` the mixer runs split over the
tensor axis by SSD heads where they divide it (else whole on every model
rank, its weights gathered): rank r takes heads [r H/M, (r+1) H/M).
``in_z``, ``in_x`` and ``in_dt`` are column blocks, ``out_proj`` a row
block whose partial sums are all-reduced; ``A_log``, ``D``, ``dt_bias``
and ``norm`` are the heads' (channels') slices. B and C are shared by all
heads of a group, so ``in_b``/``in_c`` are used whole on every rank. The
depthwise conv runs on the rank's channels: the x channels of its heads
and every B/C channel, cut from ``conv_w``/``conv_b`` fetched whole (they
are stored split contiguously over the concatenated channels, which does
not line up with the heads). The gated RMSNorm normalizes over the whole
``d_inner``: its sum of squares is all-reduced over "model".

A cache under a mesh keeps ``cache_specs``' layout: ``ssm`` (B, H, N, P)
split over H lines up with the heads and is read and written in place;
``conv`` (B, d_conv-1, ch) is split contiguously over ch. A rank reads the
conv window gathered over "model" and takes its channels; the mixer
returns the new window whole (the x channels of every head gathered over
"model"), and the caller writes its own block of it (``ctx.model_block``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..distributed.ctx import (
    MODEL,
    constrain,
    fetch,
    local_of,
    model_gather,
    model_input,
    model_part,
    model_whole,
)
from .config import ModelConfig
from .layers import dense_init, rmsnorm

__all__ = ["mamba_init", "mamba_apply", "mamba_decode", "ssd_chunked"]


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    gn = s.n_groups * s.d_state
    conv_ch = di + 2 * gn
    return s, di, nh, gn, conv_ch


def mamba_init(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device=None) -> dict:
    """Params in the reference's layout: the projections stored unfused
    (z/x/B/C/dt separately), drawn from ``generator`` (which must live on
    ``device``); torch's draws differ from ``jax.random``'s."""
    dev = resolve_device(device)
    s, di, nh, gn, conv_ch = _dims(cfg)
    d = cfg.d_model

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return {
        "in_z": dense_init(generator, (d, di), dtype=dtype, device=dev),
        "in_x": dense_init(generator, (d, di), dtype=dtype, device=dev),
        "in_b": dense_init(generator, (d, gn), dtype=dtype, device=dev),
        "in_c": dense_init(generator, (d, gn), dtype=dtype, device=dev),
        "in_dt": dense_init(generator, (d, nh), dtype=dtype, device=dev),
        "conv_w": dense_init(generator, (s.d_conv, conv_ch), 0.5, dtype, dev),
        "conv_b": full((conv_ch,), 0.0),
        "A_log": full((nh,), 0.0),  # A = -exp(A_log) = -1
        "D": full((nh,), 1.0),
        "dt_bias": full((nh,), math.log(math.expm1(0.01))),
        "norm": full((di,), 1.0),
        "out_proj": dense_init(generator, (di, d), dtype=dtype, device=dev),
    }


def _weights(p: dict, cfg: ModelConfig):
    """(weights at their use, heads): the whole mixer's (``heads`` None), or
    under a mesh whose "model" the heads divide this rank's, with ``heads``
    (h0, h1). Weights used whole in a computation that differs by rank take
    a gradient summed over "model" (``model_input``)."""
    s, di, nh, gn, conv_ch = _dims(cfg)
    part = model_part(nh)
    if part is None:
        return {k: fetch(v) for k, v in p.items()}, None
    r, M = part
    lo, hi = r * di // M, (r + 1) * di // M

    def channels(w):  # this rank's x channels, then every B/C channel
        w = model_input(fetch(w))
        return torch.cat([w[..., lo:hi], w[..., di:]], dim=-1)

    w = {k: fetch(p[k], None, MODEL) for k in ("in_z", "in_x", "in_dt")}
    w.update({k: model_input(fetch(p[k])) for k in ("in_b", "in_c")})
    w.update({k: fetch(p[k], MODEL) for k in ("A_log", "D", "dt_bias", "norm")})
    w.update(conv_w=channels(p["conv_w"]), conv_b=channels(p["conv_b"]),
             out_proj=fetch(p["out_proj"], MODEL, None))
    return w, (r * nh // M, (r + 1) * nh // M)


def _in_proj(p, x, heads=None):
    """The unfused input projections: (z, xbc, dt_raw); under a split a
    ``model_input`` of ``x`` (its gradient summed over "model")."""
    if heads is not None:
        x = model_input(x)
    z = x @ p["in_z"].to(x.dtype)
    xbc = torch.cat([x @ p["in_x"].to(x.dtype), x @ p["in_b"].to(x.dtype),
                     x @ p["in_c"].to(x.dtype)], dim=-1)
    dt_raw = x @ p["in_dt"].to(x.dtype)
    return z, xbc, dt_raw


def _group_heads(t: torch.Tensor, rep: int, dim: int, heads) -> torch.Tensor:
    """B or C per head (``jnp.repeat``: head h reads group h // rep), for
    this rank's heads."""
    t = t.repeat_interleave(rep, dim=dim)
    return t if heads is None else t.narrow(dim, heads[0], heads[1] - heads[0])


def _gated_norm(y, z, w, cfg: ModelConfig, heads) -> torch.Tensor:
    """rmsnorm(y * silu(z)) over the whole d_inner: under a split each
    rank's sum of squares is all-reduced over "model"."""
    h = y * F.silu(z)
    if heads is None:
        return rmsnorm(h, w, cfg.norm_eps)
    dt = h.dtype
    hf = h.float()
    ss = constrain(torch.sum(hf * hf, dim=-1, keepdim=True), src="partial")
    hf = hf * torch.rsqrt(model_input(ss) / cfg.ssm.d_inner(cfg.d_model) + cfg.norm_eps)
    return (hf * w.float()).to(dt)


def _whole_channels(xbc: torch.Tensor, di_local: int, heads) -> torch.Tensor:
    """Conv inputs of this rank's channels -> every channel (the x channels
    of every head gathered over "model"), for the conv cache."""
    if heads is None:
        return xbc
    return torch.cat([model_gather(xbc[..., :di_local], -1), xbc[..., di_local:]], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence, window d_conv. xbc: (B, S,
    ch); w: (d_conv, ch). The reference's ``conv_general_dilated`` with WIO
    weights is a cross-correlation, as ``conv1d`` is."""
    d_conv, ch = w.shape
    xt = F.pad(xbc.transpose(1, 2), (d_conv - 1, 0))  # (B, ch, d_conv-1+S)
    out = F.conv1d(xt, w.T[:, None, :].to(xbc.dtype), groups=ch)
    return out.transpose(1, 2) + b.to(xbc.dtype)


def _softplus_dt(dt_raw: torch.Tensor, dt_bias: torch.Tensor, dtype) -> torch.Tensor:
    return F.softplus(dt_raw.float() + dt_bias).to(dtype)


def ssd_chunked(xs, dt, A, B_, C_, chunk: int):
    """Chunked SSD. xs: (B, S, H, P); dt: (B, S, H) (post-softplus); A: (H,)
    < 0; B_/C_: (B, S, H, N). Returns (y (B, S, H, P), final state (B, H,
    N, P)), all in xs's dtype."""
    Bb, S, H, P = xs.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        def z(t):  # zeros after the sequence: (B, S, ...) -> (B, S + pad, ...)
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        xs, dt, B_, C_ = z(xs), z(dt), z(B_), z(C_)
    Sp = S + pad
    nc = Sp // Q

    def c(t):  # chunkify: (B, S, ...) -> (B, nc, Q, ...)
        return t.reshape(Bb, nc, Q, *t.shape[2:])

    xs_c, dt_c, B_c, C_c = c(xs), c(dt), c(B_), c(C_)
    dA = dt_c * A  # (B, nc, Q, H), negative
    cums = torch.cumsum(dA, dim=2)  # inclusive

    # intra-chunk: y_i += sum_{j<=i} exp(cums_i - cums_j) dt_j (C_i . B_j) x_j
    diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]  # (B, nc, Q, Q, H) [i, j]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xs.device).tril()[None, None, :, :, None]
    # the upper triangle's exp may be inf; it is never selected
    L = torch.where(tri, torch.exp(diff), 0.0).to(xs.dtype)
    cb = torch.einsum("bcihn,bcjhn->bcijh", C_c, B_c)
    xdt = xs_c * dt_c[..., None]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb * L, xdt)

    # per-chunk outgoing state: sum_j exp(cums_Q - cums_j) B_j (dt_j x_j)
    decay_end = torch.exp(cums[:, :, -1:, :] - cums)  # (B, nc, Q, H)
    states = torch.einsum("bcjhn,bcjhp->bchnp", B_c * decay_end[..., None].to(xs.dtype), xdt)

    # inter-chunk recurrence over nc, emitting the state at each chunk's start
    csum = cums[:, :, -1, :]  # (B, nc, H)
    carry = torch.zeros((Bb, H, N, P), dtype=xs.dtype, device=xs.device)
    starts = []
    for k in range(nc):
        starts.append(carry)
        carry = carry * torch.exp(csum[:, k])[..., None, None].to(carry.dtype) + states[:, k]
    starts = torch.stack(starts, dim=1)  # (B, nc, H, N, P)
    y_inter = torch.einsum("bcihn,bchnp->bcihp",
                           C_c * torch.exp(cums)[..., None].to(xs.dtype), starts)
    y = (y_intra + y_inter).reshape(Bb, Sp, H, P)
    return y[:, :S], carry


def _out_proj(p, y, heads=None):
    out = y @ p["out_proj"].to(y.dtype)
    return out if heads is None else constrain(out, src="partial")


def mamba_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, return_cache: bool = False):
    """Full-sequence forward (prefill). Returns (out, cache or None), the
    cache's conv leaf zero-padded on the left when S < d_conv - 1. Under a
    split the cache's ``ssm`` holds this rank's heads and its ``conv`` every
    channel (see the module's docstring)."""
    s, di, nh, gn, conv_ch = _dims(cfg)
    Bb, S, d = x.shape
    p, heads = _weights(p, cfg)
    z, xbc, dt_raw = _in_proj(p, x, heads)
    nh_l = dt_raw.shape[-1]
    di_l = nh_l * s.head_dim

    conv_act = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs = conv_act[..., :di_l]
    B_ = conv_act[..., di_l:di_l + gn].reshape(Bb, S, s.n_groups, s.d_state)
    C_ = conv_act[..., di_l + gn:].reshape(Bb, S, s.n_groups, s.d_state)
    rep = nh // s.n_groups
    B_h = _group_heads(B_, rep, 2, heads)
    C_h = _group_heads(C_, rep, 2, heads)

    dt = _softplus_dt(dt_raw, p["dt_bias"], x.dtype)
    A = -torch.exp(p["A_log"].float()).to(x.dtype)
    xh = xs.reshape(Bb, S, nh_l, s.head_dim)
    y, final_state = ssd_chunked(xh, dt, A, B_h, C_h, s.chunk)
    y = y + xh * p["D"].to(x.dtype)[None, None, :, None]
    out = _out_proj(p, _gated_norm(y.reshape(Bb, S, di_l), z, p["norm"], cfg, heads), heads)

    cache = None
    if return_cache:
        # the last (d_conv - 1) pre-activation conv inputs
        tail = _whole_channels(xbc[:, -(s.d_conv - 1):, :], di_l, heads)
        short = s.d_conv - 1 - tail.shape[1]
        if short > 0:
            tail = F.pad(tail, (0, 0, short, 0))
        cache = {"conv": tail, "ssm": final_state}
    return out, cache


def mamba_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict):
    """Single-token recurrent step. x: (B, 1, d). Returns (out (B, 1, d),
    the new cache {"conv", "ssm"}). Under a mesh ``cache``'s leaves may be
    split (``ShardedLeaf``): the conv window is read gathered over "model",
    and the new one comes back whole (see the module's docstring)."""
    s, di, nh, gn, conv_ch = _dims(cfg)
    Bb = x.shape[0]
    p, heads = _weights(p, cfg)
    z, xbc, dt_raw = _in_proj(p, x[:, 0], heads)
    nh_l = dt_raw.shape[-1]
    di_l = nh_l * s.head_dim

    window = model_whole(cache["conv"])  # (B, d_conv-1, ch): every channel
    mine = window if heads is None else torch.cat(
        [window[..., heads[0] * s.head_dim:heads[1] * s.head_dim], window[..., di:]], dim=-1)
    conv_act = _conv_step(mine, xbc, p["conv_w"], p["conv_b"])
    new_conv = torch.cat([window[:, 1:], _whole_channels(xbc, di_l, heads)[:, None, :]],
                         dim=1)

    xs = conv_act[..., :di_l]
    B_ = conv_act[..., di_l:di_l + gn].reshape(Bb, s.n_groups, s.d_state)
    C_ = conv_act[..., di_l + gn:].reshape(Bb, s.n_groups, s.d_state)
    rep = nh // s.n_groups
    B_h = _group_heads(B_, rep, 1, heads)  # (B, H, N)
    C_h = _group_heads(C_, rep, 1, heads)

    dt = _softplus_dt(dt_raw, p["dt_bias"], x.dtype)
    A = -torch.exp(p["A_log"].float()).to(x.dtype)
    xh = xs.reshape(Bb, nh_l, s.head_dim)
    y, new_state = _ssd_step(local_of(cache["ssm"]), xh, dt, A, B_h, C_h)
    y = y + xh * p["D"].to(x.dtype)[None, :, None]
    out = _out_proj(p, _gated_norm(y.reshape(Bb, di_l), z, p["norm"], cfg, heads), heads)
    return out[:, None, :], {"conv": new_conv, "ssm": new_state}


def _conv_step(conv_cache, xbc, w, b):
    """One position of the causal conv over the cached window: the
    activated conv output (B, ch)."""
    window = torch.cat([conv_cache, xbc[:, None, :]], dim=1)  # (B, d_conv, ch)
    conv_out = torch.einsum("bwc,wc->bc", window.to(xbc.dtype), w.to(xbc.dtype))
    return F.silu(conv_out + b.to(xbc.dtype))


def _ssd_step(state, xh, dt, A, B_h, C_h):
    """The recurrent SSD update of a (B, H, N, P) state by one position:
    (y (B, H, P), the new state)."""
    dA = torch.exp(dt * A)  # (B, H)
    new_state = state * dA[..., None, None] + torch.einsum("bhn,bhp->bhnp", B_h,
                                                          xh * dt[..., None])
    return torch.einsum("bhn,bhnp->bhp", C_h, new_state), new_state
