"""Shared layer primitives: norms, RoPE, FFNs (dense + SABLE-sparse) (port of
``repro.models.layers``).

Params are plain dicts of tensors in the reference's layouts. Every matmul
casts its weight to the activations' dtype, as the reference does; a server
that stores its params in the compute dtype makes those casts no-ops.

Under ``distributed.ctx.activation_sharding`` the FFN runs split over the
tensor axis where its width divides it (Megatron: column-parallel ``w1``/
``w3``, row-parallel ``w2`` and an all-reduce); a SABLE matrix whose tile
list divides it runs K2 on this rank's contiguous run of tiles (its own
sub-pattern and plan key) and reduces the partial sums. Outside a context
``fetch``, ``model_input`` and ``constrain`` return their argument.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..distributed.ctx import MODEL, constrain, fetch, model_input, model_part
from ..sparse.linear import random_pattern, sparse_matmul_auto, sub_pattern
from .config import ModelConfig, SableConfig

__all__ = [
    "rmsnorm",
    "rope",
    "ffn_apply",
    "ffn_init",
    "dense_init",
    "sable_patterns",
]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


@functools.lru_cache(maxsize=16)
def _rope_freqs(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """The reference's frequencies, computed in numpy float32, put on the
    device once."""
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.as_tensor(freqs, device=device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings. x: (B, S, H, D), positions: (B, S) or (S,)."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- #
# FFN
# ---------------------------------------------------------------------- #
def dense_init(generator: torch.Generator, shape, scale=None, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Normals from ``generator`` (which must live on ``device``) scaled by
    ``scale`` (default 1/sqrt(fan_in)), as the reference's ``dense_init``;
    torch's draws differ from ``jax.random``'s."""
    dev = resolve_device(device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(tuple(shape), generator=generator, device=dev).mul_(scale).to(dtype)


@functools.lru_cache(maxsize=16)
def _patterns(d_model: int, d_ff: int, sb: SableConfig) -> dict:
    pat_in = random_pattern(d_model, d_ff, sb.block_m, sb.block_n, sb.density, seed=sb.seed)
    pat_out = random_pattern(d_ff, d_model, sb.block_n, sb.block_m, sb.density, seed=sb.seed + 1)
    return {"in": pat_in, "out": pat_out}


def sable_patterns(cfg: ModelConfig) -> dict:
    """Static block patterns for the sparsified FFN matrices (shared across
    layers: one pattern per matrix serves the whole stack). Drawn once per
    (widths, SableConfig) in a process."""
    return dict(_patterns(cfg.d_model, cfg.d_ff, cfg.sable))


def ffn_init(generator: torch.Generator, cfg: ModelConfig, d_ff: int = None,
             dtype=torch.float32, device=None) -> dict:
    d_ff = d_ff or cfg.d_ff
    d = cfg.d_model

    def init(shape, scale=None):
        return dense_init(generator, shape, scale, dtype, device)

    if cfg.sable is not None and cfg.sable.target == "ffn":
        pats = sable_patterns(cfg)
        p_in, p_out = pats["in"], pats["out"]
        out = {
            "w1": init((p_in.n_tiles, p_in.tm, p_in.tk), 1 / math.sqrt(d)),
            "w2": init((p_out.n_tiles, p_out.tm, p_out.tk), 1 / math.sqrt(d_ff)),
        }
        if cfg.ffn_type == "swiglu":
            out["w3"] = init((p_in.n_tiles, p_in.tm, p_in.tk), 1 / math.sqrt(d))
        return out
    out = {"w1": init((d, d_ff)), "w2": init((d_ff, d))}
    if cfg.ffn_type == "swiglu":
        out["w3"] = init((d, d_ff))
    return out


def _act(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.ffn_type == "relu2":  # nemotron squared-ReLU
        r = F.relu(h)
        return r * r
    if cfg.ffn_type == "gelu":
        return F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return F.silu(h)


def _sable_matmul(x: torch.Tensor, tiles, pattern, part, out_model: bool):
    """x @ W for SABLE tiles. With ``part`` (this rank's model coordinate
    and the model size) the tile list is split over the tensor axis: this
    rank multiplies its own run of tiles (their sub-pattern) with ``x`` (a
    ``model_input``), and the partial sums are reduced: with ``out_model``
    reduce-scattered into a model-split last dim where it divides (else
    all-reduced, in ``sparse_matmul_auto``), without it all-reduced here."""
    if part is None:
        return sparse_matmul_auto(x, fetch(tiles.to(x.dtype)), pattern)
    y = sparse_matmul_auto(x, fetch(tiles.to(x.dtype), MODEL), sub_pattern(pattern, *part),
                           out_model=out_model)
    return y if out_model else constrain(y, src="partial")


def ffn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Dense or SABLE block-sparse FFN (swiglu / relu^2 / gelu). The sparse
    matrices go through ``sparse_matmul_auto``: the pattern's plan picks
    ``grouped`` or K2."""
    if cfg.sable is not None and p["w1"].dim() == 3:
        pats = sable_patterns(cfg)
        p_in, p_out = pats["in"], pats["out"]
        part_in, part_out = model_part(p_in.n_tiles), model_part(p_out.n_tiles)
        xin = model_input(x) if part_in else x
        h = _sable_matmul(xin, p["w1"], p_in, part_in, True)
        if cfg.ffn_type == "swiglu":
            h = F.silu(h) * _sable_matmul(xin, p["w3"], p_in, part_in, True)
        else:
            h = _act(cfg, h)
        # h is model-split on its last dim where w1's partial sums were
        # reduce-scattered; w2 takes it whole
        split = -1 if part_in and model_part(p_in.d_out) else None
        h = model_input(h, src=split) if part_out else constrain(h, src=split)
        # the residual stream stays row-major: K2's transposed output, added
        # to a (B, 1, d) stream at decode, gives strides that send every later
        # matmul through bmm, which reads its weight once per row
        return _sable_matmul(h, p["w2"], p_out, part_out, False).contiguous()
    m = MODEL if model_part(p["w1"].shape[-1]) else None
    if m:
        x = model_input(x)
    h = x @ fetch(p["w1"].to(x.dtype), None, m)
    if cfg.ffn_type == "swiglu":
        h = F.silu(h) * (x @ fetch(p["w3"].to(x.dtype), None, m))
    else:
        h = _act(cfg, h)
    return constrain(h @ fetch(p["w2"].to(x.dtype), m, None), src="partial" if m else None)
