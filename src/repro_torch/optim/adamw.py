"""AdamW with global-norm clipping and optional low-precision moments (port
of ``repro.optim.adamw``).

Functions over trees (dicts and lists) of tensors. The arithmetic is the
reference's: moments, bias corrections and the update in float32, cast back
to each leaf's dtype; weight decay on leaves with ``ndim >= 2`` only;
``state_dtype`` sets the moments' dtype (default: the param's); ``count`` is
an int32 0-d tensor. ``adamw_update`` updates params and state in place,
under ``torch.no_grad()``, and returns them.

Leaves may be DTensors (model sharding): each rank updates its own blocks
in place, and ``global_norm`` counts every element of the sharded gradients
once, so that the clip scale is the same on every rank.
"""
from __future__ import annotations

import dataclasses
import math
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


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's block on this rank (its storage), else the tensor."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments shaped like the params (DTensors laid out as theirs) and
    a zero ``count``."""
    from torch.distributed.tensor import DTensor

    def zeros(p):
        dt = getattr(torch, cfg.state_dtype) if cfg.state_dtype else p.dtype
        if isinstance(p, DTensor):
            return DTensor.from_local(torch.zeros_like(p.to_local(), dtype=dt), p.device_mesh,
                                      p.placements, shape=p.shape, stride=p.stride())
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    dev = tree_leaves(params)[0].device
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (0-d tensor).
    DTensor leaves count each element once: a rank's block is weighted by
    1 / (the ranks that hold it), and the sum is all-reduced over the mesh."""
    from torch.distributed.tensor import DTensor

    leaves = tree_leaves(tree)
    mesh = next((t.device_mesh for t in leaves if isinstance(t, DTensor)), None)
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in leaves))
    from ..distributed.ctx import all_reduce_, mesh_axes

    def copies(t) -> int:
        if not isinstance(t, DTensor):
            return mesh.size()
        return mesh.size() // math.prod(mesh.size(i) for i, p in enumerate(t.placements)
                                        if p.is_shard())

    total = sum(torch.sum(torch.square(_local(leaf).float())) / copies(leaf) for leaf in leaves)
    return torch.sqrt(all_reduce_(total, mesh_axes(mesh).values()))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr=None):
    """One AdamW step, in place. Returns (params, state, metrics)."""
    lr = cfg.lr if lr is None else float(lr)
    count = _local(state["count"])
    count += 1
    count = count.float()
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=count.device), count)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=count.device), count)
    for p, g, mu, nu in zip(*(map(_local, tree_leaves(t)) for t in
                              (params, grads, state["mu"], state["nu"]))):
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
