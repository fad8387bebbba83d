"""Train and eval steps (port of ``repro.train.step``).

``make_train_step`` returns ``step(params, opt_state, batch, step) ->
(params, opt_state, metrics)``, as the reference's does. The port's step
updates the params and the optimizer state in place (and returns them):
the loss's gradient comes from autograd (the params become leaves that
require grad at the first step), is cast to bfloat16 where
``ParallelConfig.compress_grads`` says so (the reference's default), and
goes to AdamW. The batch's numpy arrays move to the params' device. The
metrics are 0-d tensors on the device; nothing in the step waits for it.

With ``mesh=`` (a named ``DeviceMesh``; params and AdamW state DTensors
laid out by ``distributed.sharding.make_shardings``) the step runs the
model on each rank's local blocks under ``activation_sharding``: the
batch's rows split over the dp axes, the loss the global mean (each rank's
sum over the global token count, so that summed gradients are right; over
vocabulary-split logits the log-sum-exp and the gold logit are summed over
"model"), and each gradient summed over the dp axes its leaf is not split
on (the fsdp gathers' backward already summed the others; in bfloat16
under ``compress_grads``). Remat re-runs the same collectives in the same
order on every rank.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..distributed.ctx import activation_sharding, current, dp_sum, local_view, model_part
from ..distributed.sharding import ParallelConfig
from ..models.config import ModelConfig
from ..models.transformer import forward_train
from ..optim.adamw import AdamWConfig, adamw_update
from ..tree import tree_leaves, tree_unflatten

__all__ = ["batch_to_device", "cross_entropy", "make_eval_step", "make_train_step"]


def _token_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's CE, stable, float32 accumulation."""
    logits = logits.float()
    m = logits.max(dim=-1, keepdim=True).values.detach()
    shifted = logits - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    gold = torch.gather(shifted, -1, labels[..., None].long())[..., 0]
    return lse - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE, stable, float32 accumulation."""
    return torch.mean(_token_ce(logits, labels))


def _split_vocab_ce_sum(logits: torch.Tensor, labels: torch.Tensor, part) -> torch.Tensor:
    """Sum of token CEs over logits whose vocabulary is split over "model"
    (this rank holds block ``part[0]``): the max all-reduced (detached),
    then the sum of exps, then the gold logit from the rank that holds it."""
    import torch.distributed as dist

    from ..distributed.ctx import all_reduce_, constrain

    logits = logits.float()
    m = logits.max(dim=-1, keepdim=True).values.detach()
    all_reduce_(m, (current().model,), op=dist.ReduceOp.MAX)
    shifted = logits - m
    lse = torch.log(constrain(torch.sum(torch.exp(shifted), dim=-1), src="partial"))
    ids = labels.long() - part[0] * logits.shape[-1]
    mine = (ids >= 0) & (ids < logits.shape[-1])
    gold = torch.gather(shifted, -1, ids.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    gold = constrain(torch.where(mine, gold, 0.0), src="partial")
    return torch.sum(lse - gold)


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
    gives the learning rate (default ``opt_cfg.lr``). ``mesh=`` runs the
    sharded step described in the module's docstring; every rank of the
    mesh calls it with the whole batch."""
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh) or not mesh.mesh_dim_names:
            raise TypeError(f"mesh= takes a named DeviceMesh, got {type(mesh).__name__}")
        return _sharded_step(cfg, opt_cfg, pc, schedule, mesh)

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


def _sum_over_missing_dp(grads: list, leaves: list, pc: ParallelConfig) -> list:
    """Sum each gradient over the dp axes its leaf is not split on, one
    flat all-reduce per set of axes (bfloat16 under ``compress_grads``)."""
    from torch.distributed.tensor import DTensor

    from ..distributed.ctx import all_reduce_

    ctx = current()
    buckets: dict = {}
    for i, leaf in enumerate(leaves):
        split = set()
        if isinstance(leaf, DTensor):
            names = leaf.device_mesh.mesh_dim_names
            split = {names[j] for j, p in enumerate(leaf.placements) if p.is_shard()}
        axes = tuple(a for a in ctx.dp if a.name not in split and a.size > 1)
        if axes:
            buckets.setdefault(axes, []).append(i)
    dtype = torch.bfloat16 if pc.compress_grads else None
    for axes, idx in buckets.items():
        flat = all_reduce_(torch.cat([grads[i].reshape(-1).to(dtype or grads[i].dtype)
                                      for i in idx]), axes)
        for i, piece in zip(idx, flat.split([grads[i].numel() for i in idx])):
            grads[i] = piece.view_as(grads[i]).to(grads[i].dtype)
    return grads


def _sharded_step(cfg, opt_cfg, pc, schedule, mesh) -> Callable:
    def step_fn(params, opt_state, batch, step):
        from torch.distributed.tensor import DTensor

        leaves = tree_leaves(params)
        with activation_sharding(mesh, pc):
            ctx = current()
            view, locals_ = local_view(params, requires_grad=True)
            n_dp, i_dp = ctx.dp_size(), ctx.dp_index()
            batch = batch_to_device(batch, locals_[0].device)
            rows = {len(v) for v in batch.values()}.pop()
            if rows % n_dp:
                raise ValueError(f"a batch of {rows} rows does not split over {n_dp} data shards")
            k = rows // n_dp
            batch = {key: v[i_dp * k:(i_dp + 1) * k] for key, v in batch.items()}
            logits, aux = forward_train(view, cfg, batch)
            labels = batch["labels"]
            part = model_part(cfg.vocab_size)
            if part is not None:
                ce_sum = _split_vocab_ce_sum(logits, labels, part)
            else:
                ce_sum = torch.sum(_token_ce(logits, labels))
            del logits
            local = ce_sum / (labels.numel() * n_dp)
            grads = torch.autograd.grad(local + aux, locals_, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(locals_, grads)]
            if pc.compress_grads:
                grads = [g.to(torch.bfloat16) for g in grads]
            grads = _sum_over_missing_dp(grads, leaves, pc)
            ce = dp_sum(local.detach())
        grads = [DTensor.from_local(g, p.device_mesh, p.placements, shape=p.shape,
                                    stride=p.stride()) if isinstance(p, DTensor) else g
                 for p, g in zip(leaves, grads)]
        lr = schedule(step) if schedule is not None else opt_cfg.lr
        params, opt_state, om = adamw_update(params, tree_unflatten(params, grads), opt_state,
                                             opt_cfg, lr)
        aux = aux.detach()
        metrics = {"loss": ce + aux, "lr": torch.tensor(float(lr), dtype=torch.float32),
                   "ce": ce, "aux": aux, **om}
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
