"""Train and eval steps (port of ``repro.train.step``).

``make_train_step`` returns ``step(params, opt_state, batch, step) ->
(params, opt_state, metrics)``, as the reference's does. The port's step
updates the params and the optimizer state in place (and returns them):
the loss's gradient comes from autograd (the params become leaves that
require grad at the first step), is cast to bfloat16 where
``ParallelConfig.compress_grads`` says so (the reference's default), and
goes to AdamW. The batch's numpy arrays move to the params' device. The
metrics are 0-d tensors on the device; nothing in the step waits for it.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..distributed.sharding import ParallelConfig, no_sharding
from ..models.config import ModelConfig
from ..models.transformer import forward_train
from ..optim.adamw import AdamWConfig, adamw_update
from ..tree import tree_leaves, tree_unflatten

__all__ = ["batch_to_device", "cross_entropy", "make_eval_step", "make_train_step"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE, stable, float32 accumulation."""
    logits = logits.float()
    m = logits.max(dim=-1, keepdim=True).values.detach()
    shifted = logits - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    gold = torch.gather(shifted, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """The batch's arrays (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def _device_of(params) -> torch.device:
    return tree_leaves(params)[0].device


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    pc: ParallelConfig = ParallelConfig(),
    schedule: Optional[Callable] = None,
    mesh=None,
) -> Callable:
    """Returns step(params, opt_state, batch, step) -> (params, opt_state,
    metrics); params and opt_state are updated in place. ``schedule(step)``
    gives the learning rate (default ``opt_cfg.lr``). ``mesh=`` raises until
    the sharding slice."""
    if mesh is not None:
        no_sharding("make_train_step(mesh=)")

    def step_fn(params, opt_state, batch, step):
        leaves = tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        batch = batch_to_device(batch, _device_of(params))
        logits, aux = forward_train(params, cfg, batch)
        ce = cross_entropy(logits, batch["labels"])
        del logits
        loss = ce + aux
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach gets zeros, as jax.grad gives it
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        if pc.compress_grads:
            grads = [g.to(torch.bfloat16) for g in grads]
        lr = schedule(step) if schedule is not None else opt_cfg.lr
        grads_tree = tree_unflatten(params, grads)
        del grads
        params, opt_state, om = adamw_update(params, grads_tree, opt_state, opt_cfg, lr)
        metrics = {"loss": loss.detach(), "lr": torch.tensor(float(lr), dtype=torch.float32),
                   "ce": ce.detach(), "aux": aux.detach(), **om}
        return params, opt_state, metrics

    return step_fn


def make_eval_step(cfg: ModelConfig) -> Callable:
    """Returns eval(params, batch) -> mean token CE (0-d tensor), without
    gradients."""

    @torch.no_grad()
    def eval_fn(params, batch):
        batch = batch_to_device(batch, _device_of(params))
        logits, _ = forward_train(params, cfg, batch)
        return cross_entropy(logits, batch["labels"])

    return eval_fn

