"""AdamW with global-norm clipping and optional low-precision moments (port
of ``repro.optim.adamw``).

Functions over trees (dicts and lists) of tensors. The arithmetic is the
reference's: moments, bias corrections and the update in float32, cast back
to each leaf's dtype; weight decay on leaves with ``ndim >= 2`` only;
``state_dtype`` sets the moments' dtype (default: the param's); ``count`` is
an int32 0-d tensor. ``adamw_update`` updates params and state in place,
under ``torch.no_grad()``, and returns them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4  # peak; callers may pass a schedule value per step
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Optional[str] = None  # None = follow param dtype


def adamw_init(params, cfg: AdamWConfig) -> dict:
    def zeros(p):
        dt = getattr(torch, cfg.state_dtype) if cfg.state_dtype else p.dtype
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    dev = tree_leaves(params)[0].device
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (0-d tensor)."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in leaves))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr=None):
    """One AdamW step, in place. Returns (params, state, metrics)."""
    lr = cfg.lr if lr is None else float(lr)
    state["count"] += 1
    count = state["count"].float()
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=count.device), count)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=count.device), count)
    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["mu"]),
                            tree_leaves(state["nu"])):
        g = g.float() * scale
        mu32 = mu.float() * b1 + (1 - b1) * g
        nu32 = nu.float() * b2 + (1 - b2) * g * g
        step = (mu32 / c1) / (torch.sqrt(nu32 / c2) + cfg.eps)
        if p.dim() >= 2:  # decay matrices only (norms/scalars exempt)
            step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
        mu.copy_(mu32)
        nu.copy_(nu32)
        del g, mu32, nu32, step
    return params, state, {"grad_norm": gnorm}
