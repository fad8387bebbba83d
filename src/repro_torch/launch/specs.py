"""Abstract inputs per (arch config x input shape) (port of
``repro.launch.specs``).

Params, optimizer state, caches and batches as tensors on
``torch.device("meta")``: shapes and dtypes, no memory. They are the
reference's ``jax.eval_shape`` results leaf for leaf (path, shape, dtype),
and the dry-run (``launch/dryrun.py``) lays its fake tensors out from them.
"""
from __future__ import annotations

import functools

import torch

from ..configs.shapes import Shape, src_len
from ..models.config import ModelConfig
from ..models.transformer import init_cache, init_params
from ..optim.adamw import AdamWConfig, adamw_init

__all__ = ["abstract_params", "abstract_opt", "abstract_cache", "input_specs"]

META = torch.device("meta")


@functools.lru_cache(maxsize=64)
def abstract_params(cfg: ModelConfig):
    """``init_params``' tree on the meta device (the draws are shapes alone)."""
    return init_params(cfg, torch.Generator().manual_seed(0), device=META)


def abstract_opt(cfg: ModelConfig, opt_cfg: AdamWConfig):
    return adamw_init(abstract_params(cfg), opt_cfg)


def abstract_cache(cfg: ModelConfig, batch: int, s_max: int, enc_len: int = 0):
    return init_cache(cfg, batch, s_max, enc_len=enc_len, dtype=getattr(torch, cfg.compute_dtype),
                      device=META)


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: Shape) -> dict:
    """Model inputs for this cell (params, optimizer state and cache apart).

    train    {"tokens": (B,S), "labels": (B,S)} [+ src_embeds]
    prefill  {"tokens": (B,S)} [+ src_embeds]
    decode   {"token": (B,1), "pos": scalar}
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        out = {"tokens": _spec((B, S), torch.int32)}
        if shape.kind == "train":
            out["labels"] = _spec((B, S), torch.int32)
        if cfg.is_encdec:
            out["src_embeds"] = _spec((B, src_len(cfg, shape), cfg.frontend_dim), torch.float32)
        return out
    if shape.kind == "decode":
        return {"token": _spec((B, 1), torch.int32), "pos": _spec((), torch.int32)}
    raise ValueError(shape.kind)
