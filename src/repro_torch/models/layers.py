"""Layer pieces of the port (from ``repro.models.layers``). So far only the
FFN activation, which the MoE layer needs; the rest of the module comes with
the models slice."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig


def _act(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.ffn_type == "relu2":  # nemotron squared-ReLU
        r = F.relu(h)
        return r * r
    if cfg.ffn_type == "gelu":
        return F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return F.silu(h)
