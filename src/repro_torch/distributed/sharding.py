"""Sharding rules: DP / FSDP (ZeRO-3) / TP / EP over a device mesh (port of
``repro.distributed.sharding``).

Axes:
  dp axes      ("pod", "data")  - batch rows (data parallel)
  fsdp axes    ("data",) by default, ("pod", "data") with ``fsdp_over_pod``
               - parameter and optimizer-state sharding (ZeRO-3), gathered
               at each use (``distributed.ctx.fetch``)
  tensor axis  "model"          - Megatron-style TP and MoE expert
               parallelism

The rule table (regex over a leaf's path -> ``P``) is the reference's, in
its order; leaves of a stacked group get an unsharded stack dim prepended.
A mesh is a named ``torch.distributed.device_mesh.DeviceMesh``: only its
names and sizes are read here (``mesh_dim_names``, ``size``), so the rules
resolve without a process group. ``make_shardings`` gives each leaf a
``NamedSharding``: its resolved spec and the DTensor placements that lay
the leaf out as the reference's ``NamedSharding`` does (a dim over several
axes is split major to minor, in mesh order); ``distribute`` makes the
DTensors.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

from ..tree import flatten, tree_leaves, tree_paths, tree_unflatten, unflatten

__all__ = [
    "NamedSharding",
    "P",
    "ParallelConfig",
    "batch_specs",
    "cache_specs",
    "distribute",
    "dp_axes",
    "fsdp_axes",
    "make_shardings",
    "opt_state_specs",
    "param_specs",
    "path_of",
    "slice_shardings",
]


class P(tuple):
    """A PartitionSpec: one entry per tensor dim, None (unsharded), a mesh
    axis name, or a tuple of names (split over them jointly, major first).
    Unresolved specs hold the placeholders ``"__F__"`` (fsdp axes),
    ``"__M__"`` (tensor axis), ``"__FM__"`` (both) and ``"__DP__"``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def _is_spec(x) -> bool:
    return isinstance(x, P)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    fsdp: bool = True
    fsdp_over_pod: bool = False  # ZeRO across pods (DCN) too
    tensor_axis: str = "model"
    dp_axes: tuple = ("pod", "data")
    compress_grads: bool = True  # bfloat16 gradients and gradient collectives
    seq_shard_cache: bool = True  # context-parallel KV when heads don't divide
    anchor_scan_params: bool = True  # the reference's scan anchor; no effect here


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def _size(mesh, axis: str) -> int:
    return int(mesh.size(_names(mesh).index(axis)))


def _present(mesh, axes) -> tuple:
    return tuple(a for a in axes if a in _names(mesh))


def dp_axes(mesh, pc: ParallelConfig) -> tuple:
    return _present(mesh, pc.dp_axes)


def fsdp_axes(mesh, pc: ParallelConfig) -> Optional[tuple]:
    if not pc.fsdp:
        return None
    axes = ("pod", "data") if pc.fsdp_over_pod else ("data",)
    out = _present(mesh, axes)
    return out or None


def path_of(keys) -> str:
    """A leaf's keys and indices joined with "/" (``groups/0/sub0/ffn/w1``),
    as ``tree.tree_paths`` joins them."""
    return "/".join(str(k) for k in keys)


def _rules(F, M, FM):
    """F = fsdp axes (or None), M = tensor axis, FM = (F..., M) joint.

    Column-parallel weights shard their OUTPUT dim jointly over (fsdp,
    tensor): the contraction dim stays local, so using the weight costs one
    small gather over fsdp instead of an all-reduce of activation partial
    sums. Order matters."""
    return [
        # MoE: experts over the tensor axis (EP); FSDP shards the per-expert
        # dim that is not contracted
        (r"moe/router$", P(None, None)),
        (r"moe/w[13]$", P(M, None, F)),
        (r"moe/w2$", P(M, F, None)),
        (r"moe/sw[13]$", P(None, FM)),
        (r"moe/sw2$", P(M, F)),
        # MLA
        (r"mixer/wdq$", P(None, F)),
        (r"mixer/wuq$", P(None, FM)),
        (r"mixer/wdkv$", P(None, F)),
        (r"mixer/wukv$", P(None, FM)),
        (r"mixer/(qln|kvln)$", P()),
        # attention (gqa + cross): column-parallel qkv, row-parallel out
        (r"(mixer|cross)/w[qkv]$", P(None, FM)),
        (r"(mixer|cross)/wo$", P(M, F)),
        (r"(mixer|cross)/(qn|kn)$", P()),
        # mamba
        (r"mixer/in_(z|x|b|c|dt)$", P(None, FM)),
        (r"mixer/conv_w$", P(None, M)),
        (r"mixer/(conv_b|A_log|D|dt_bias|norm)$", P(M)),
        (r"mixer/out_proj$", P(M, F)),
        # FFN: SABLE tiles split the tile list over the tensor axis
        (r"ffn/w[123]$", "ffn"),  # resolved by ndim below
        # embeddings
        (r"(^|/)embed$", P(M, F)),
        (r"lm_head$", P(None, FM)),
        (r"frontend_proj$", P(None, F)),
    ]


def _spec_for(path: str, ndim: int, stacked: bool, F, M, FM) -> P:
    base_ndim = ndim - 1 if stacked else ndim
    spec = None
    for pat, s in _rules(F, M, FM):
        if re.search(pat, path):
            if s == "ffn":
                if base_ndim == 3:  # SABLE tiles (nt, tm, tk)
                    spec = P(M, None, None)
                elif re.search(r"ffn/w2$", path):
                    spec = P(M, F)
                else:
                    spec = P(None, FM)
            else:
                spec = s
            break
    if spec is None:
        spec = P()  # norms, scalars: replicated
    parts = list(spec) + [None] * (base_ndim - len(spec))
    if stacked:
        parts = [None] + parts
    return P(*parts[:ndim]) if ndim else P()


def param_specs(cfg, params):
    """Unresolved ``P`` tree for a params tree (anything with ``ndim``)."""
    del cfg
    specs = [_spec_for(path, leaf.ndim, path.startswith(("groups/", "enc_groups/")),
                       "__F__", "__M__", "__FM__") for path, leaf in tree_paths(params)]
    return tree_unflatten(params, specs)


def opt_state_specs(cfg, params, opt_state):
    """Moments share the param specs; the count scalar is replicated."""
    del opt_state
    pspecs = param_specs(cfg, params)
    return {"mu": pspecs, "nu": pspecs, "count": P()}


def batch_specs(cfg, batch):
    del cfg
    return tree_unflatten(batch, [P("__DP__", *([None] * (leaf.ndim - 1)))
                                  for leaf in tree_leaves(batch)])


def cache_specs(cfg, cache, pc: ParallelConfig = ParallelConfig(), model_size: int = 16):
    """KV/SSM cache specs. Heads shard over the tensor axis when they
    divide it; otherwise the sequence dim is split (context parallel)."""

    def one(path, nd):
        if re.search(r"(attn|cross)/(k|v)$", path):
            # (rep, B, S, K, hd)
            if cfg.n_kv_heads % model_size == 0:
                return P(None, "__DP__", None, "__M__", None)
            if pc.seq_shard_cache:
                return P(None, "__DP__", "__M__", None, None)
            return P(None, "__DP__", None, None, None)
        if re.search(r"attn/(ckv|kr)$", path):
            # (rep, B, S, c): the MLA latent, sequence-split
            return P(None, "__DP__", "__M__", None)
        if re.search(r"ssm_cache/conv$", path):
            return P(None, "__DP__", None, "__M__")
        if re.search(r"ssm_cache/ssm$", path):
            return P(None, "__DP__", "__M__", None, None)
        return P(*([None] * nd))

    return tree_unflatten(cache, [one(path, leaf.ndim) for path, leaf in tree_paths(cache)])


def slice_shardings(mesh, pc: ParallelConfig, tree):
    """``NamedSharding``s for ONE layer slice of a stacked params subtree
    (paths like ``sub0/mixer/wq``, no stack dim): the rule table with
    ``stacked=False``, resolved and sanitized as ``make_shardings``."""
    specs = [_spec_for(path, leaf.ndim, False, "__F__", "__M__", "__FM__")
             for path, leaf in tree_paths(tree)]
    return make_shardings(mesh, pc, tree_unflatten(tree, specs), tree)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A leaf's layout on ``mesh``: its resolved ``spec`` and the DTensor
    ``placements`` (one a mesh dim) that hold it."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        names = _names(self.mesh)
        out = [Replicate() for _ in names]
        for d, entry in enumerate(self.spec):
            axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                # DTensor splits a dim over several mesh dims in mesh order
                raise ValueError(f"{self.spec}: axes {axes} of dim {d} are not in the "
                                 f"mesh's order {names}")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)


def _axes_size(mesh, entry) -> int:
    if entry is None:
        return 1
    n = 1
    for a in entry if isinstance(entry, (tuple, list)) else (entry,):
        n *= _size(mesh, a)
    return n


def make_shardings(mesh, pc: ParallelConfig, spec_tree, tree=None):
    """Resolve the placeholder axes into a tree of ``NamedSharding``.

    With ``tree`` (leaves with ``shape``, in ``spec_tree``'s structure) the
    specs are sanitized as the reference's are: a dim whose size the axis
    product does not divide is not sharded (vocab 256206 over 16, a batch
    of 1 over dp)."""
    F = fsdp_axes(mesh, pc)
    M = pc.tensor_axis if pc.tensor_axis in _names(mesh) else None
    DP = dp_axes(mesh, pc)
    fm = (tuple(F) if F else ()) + ((M,) if M else ())

    def resolve(s):
        table = {"__F__": F, "__M__": M, "__FM__": fm or None, "__DP__": DP or None}
        return [table[p] if isinstance(p, str) and p in table else p for p in s]

    specs, spec_def = flatten(spec_tree, is_leaf=_is_spec)
    shapes = [None] * len(specs) if tree is None else [tuple(leaf.shape)
                                                        for leaf in tree_leaves(tree)]
    out = []
    for s, shape in zip(specs, shapes):
        parts = resolve(s)
        if shape is not None:
            parts = parts[: len(shape)]
            parts = [None if e is not None and shape[i] % _axes_size(mesh, e) else e
                     for i, e in enumerate(parts)]
        out.append(NamedSharding(mesh, P(*parts)))
    return unflatten(spec_def, out)


def distribute(tree, shardings):
    """Each leaf of ``tree`` (the whole tensor, the same on every rank) as a
    DTensor laid out by its ``NamedSharding``: every rank keeps its own
    block, cut from its own copy (no exchange)."""
    from torch.distributed.tensor import distribute_tensor

    shs = tree_leaves(shardings)
    return tree_unflatten(tree, [
        distribute_tensor(leaf.detach(), sh.mesh, sh.placements, src_data_rank=None)
        for leaf, sh in zip(tree_leaves(tree), shs)])
