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
Pallas kernel. Under ``distributed.ctx.activation_sharding`` the mixer
runs whole on every model rank, its weights gathered (``fetch``); its
tensor parallelism is still to come.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..distributed.ctx import fetch
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


def _in_proj(p, x):
    """The unfused input projections: (z, xbc, dt_raw)."""
    z = x @ p["in_z"].to(x.dtype)
    xbc = torch.cat([x @ p["in_x"].to(x.dtype), x @ p["in_b"].to(x.dtype),
                     x @ p["in_c"].to(x.dtype)], dim=-1)
    dt_raw = x @ p["in_dt"].to(x.dtype)
    return z, xbc, dt_raw


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


def _out_proj(p, y):
    return y @ p["out_proj"].to(y.dtype)


def mamba_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, return_cache: bool = False):
    """Full-sequence forward (prefill). Returns (out, cache or None), the
    cache's conv leaf zero-padded on the left when S < d_conv - 1."""
    s, di, nh, gn, conv_ch = _dims(cfg)
    Bb, S, d = x.shape
    p = {k: fetch(v) for k, v in p.items()}  # whole under a mesh
    z, xbc, dt_raw = _in_proj(p, x)

    conv_act = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs = conv_act[..., :di]
    B_ = conv_act[..., di:di + gn].reshape(Bb, S, s.n_groups, s.d_state)
    C_ = conv_act[..., di + gn:].reshape(Bb, S, s.n_groups, s.d_state)
    rep = nh // s.n_groups
    # jnp.repeat: each group's rows repeated in place (head h reads group h // rep)
    B_h = B_.repeat_interleave(rep, dim=2)
    C_h = C_.repeat_interleave(rep, dim=2)

    dt = _softplus_dt(dt_raw, p["dt_bias"], x.dtype)
    A = -torch.exp(p["A_log"].float()).to(x.dtype)
    xh = xs.reshape(Bb, S, nh, s.head_dim)
    y, final_state = ssd_chunked(xh, dt, A, B_h, C_h, s.chunk)
    y = y + xh * p["D"].to(x.dtype)[None, None, :, None]
    out = _out_proj(p, rmsnorm(y.reshape(Bb, S, di) * F.silu(z), p["norm"], cfg.norm_eps))

    cache = None
    if return_cache:
        # the last (d_conv - 1) pre-activation conv inputs
        tail = xbc[:, -(s.d_conv - 1):, :]
        short = s.d_conv - 1 - tail.shape[1]
        if short > 0:
            tail = F.pad(tail, (0, 0, short, 0))
        cache = {"conv": tail, "ssm": final_state}
    return out, cache


def mamba_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict):
    """Single-token recurrent step. x: (B, 1, d). Returns (out (B, 1, d),
    the new cache {"conv", "ssm"})."""
    s, di, nh, gn, conv_ch = _dims(cfg)
    Bb = x.shape[0]
    z, xbc, dt_raw = _in_proj(p, x[:, 0])

    conv_act, new_conv = _conv_step(cache["conv"], xbc, p["conv_w"], p["conv_b"])

    xs = conv_act[..., :di]
    B_ = conv_act[..., di:di + gn].reshape(Bb, s.n_groups, s.d_state)
    C_ = conv_act[..., di + gn:].reshape(Bb, s.n_groups, s.d_state)
    rep = nh // s.n_groups
    B_h = B_.repeat_interleave(rep, dim=1)  # (B, H, N)
    C_h = C_.repeat_interleave(rep, dim=1)

    dt = _softplus_dt(dt_raw, p["dt_bias"], x.dtype)
    A = -torch.exp(p["A_log"].float()).to(x.dtype)
    xh = xs.reshape(Bb, nh, s.head_dim)
    y, new_state = _ssd_step(cache["ssm"], xh, dt, A, B_h, C_h)
    y = y + xh * p["D"].to(x.dtype)[None, :, None]
    out = _out_proj(p, rmsnorm(y.reshape(Bb, di) * F.silu(z), p["norm"], cfg.norm_eps))
    return out[:, None, :], {"conv": new_conv, "ssm": new_state}


def _conv_step(conv_cache, xbc, w, b):
    """One position of the causal conv over the cached window: (the
    activated conv output (B, ch), the next conv cache)."""
    window = torch.cat([conv_cache, xbc[:, None, :]], dim=1)  # (B, d_conv, ch)
    conv_out = torch.einsum("bwc,wc->bc", window.to(xbc.dtype), w.to(xbc.dtype))
    return F.silu(conv_out + b.to(xbc.dtype)), window[:, 1:]


def _ssd_step(state, xh, dt, A, B_h, C_h):
    """The recurrent SSD update of a (B, H, N, P) state by one position:
    (y (B, H, P), the new state)."""
    dA = torch.exp(dt * A)  # (B, H)
    new_state = state * dA[..., None, None] + torch.einsum("bhn,bhp->bhnp", B_h,
                                                          xh * dt[..., None])
    return torch.einsum("bhn,bhnp->bhp", C_h, new_state), new_state
