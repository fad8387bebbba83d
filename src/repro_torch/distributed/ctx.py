"""Activation-sharding context: explicit SPMD over local tensors (port of
``repro.distributed.ctx``).

Model code is mesh-agnostic. Outside ``activation_sharding(mesh, pc)``
every function here returns its argument itself, so single-device code
runs unchanged. Inside it, where the reference leaves the layout to GSPMD
(``with_sharding_constraint`` placeholders), the port places the
collectives itself, on the process groups of the mesh's dims:

* the params are DTensors (``distributed.sharding.distribute``); the step
  hands the model ``local_view``: each leaf's local block, wrapped as a
  ``ShardedLeaf`` where it is split (the layer loop's views of a stacked
  leaf take ``local[i]``: the stack dim is never split);
* ``fetch(w, *parts)`` turns a leaf's block into the local tensor of the
  layout its use site asks for (``MODEL`` on a dim: this model rank's
  contiguous block; ``None``: whole): gathers over the fsdp axes (their
  gradient is reduce-scattered, i.e. summed over the data shards), a
  one-chunk exchange where a dim split jointly over (fsdp, model) must come
  out as a contiguous model block, a split of a replicated leaf;
* ``model_input`` and ``constrain`` are the activations' side (Megatron's
  f, g and friends): the input of a computation that differs by model rank
  (gradient summed over "model"), the all-reduce of a row-parallel output,
  the reduce-scatter of partial sums into a model-split dim, the gather of
  a model-split tensor back to a whole one;
* ``dp_sum`` sums over the data shards (the MoE's load-balance statistics,
  the reported loss).

A gather over "model" whose result feeds a computation that is the same on
every model rank has the slice of the gradient as its backward; one that
feeds a computation that differs by rank (``model_input(x, src=dim)``) has
a reduce-scatter. The use sites keep to that: a block either runs split
over "model" (local heads, local experts, a local FFN slice, between
``model_input`` and ``constrain(..., src="partial")``) or whole on every
model rank.

Serving runs under the same context. A cache is a tree of DTensors laid
out by ``cache_specs``; the entry points hand the layers its
``local_view``, whose split leaves (``ShardedLeaf``) say which dims are
split over which axes: ``local_of`` is the block a layer writes in place,
``model_offset`` the first index of its block on a dim split over
"model", ``model_whole`` the block gathered over "model" and
``model_block`` a whole value cut to it (``model_gather`` gathers an
activation split over "model"). ``rows`` takes this data shard's rows of a
serving batch where they split over the dp axes (``rows_whole`` gathers
them back); a batch whose rows do not split (``long_500k``'s one
sequence) runs whole on every dp rank, as its cache is whole there (the
train step refuses such a batch).
``combine_partial_softmax`` joins attention taken over a context-parallel
(sequence-split) cache: the row max all-reduced over "model", then the
rescaled sums of ``exp`` and of ``exp @ V``; it is for serving and has no
backward.

Collectives over a mesh dim of size 1 are skipped: on a one-rank mesh the
model runs the same operations as without one. Every collective issued
here (and the step's and AdamW's all-reduces, through ``all_reduce_``)
adds the bytes this rank sends to ``moved_bytes()``, by kind, as a ring
moves them: an all-gather or reduce-scatter of N bytes over n ranks sends
N (n - 1) / n, an all-reduce twice that, the one-chunk exchange N.
``moved_bytes(by_axes=True)`` keys the same bytes by (kind, the mesh dims
the group spans), for a model of the links they cross.

The reference's XLA-only pieces have no counterpart: its trace-cache
invalidation is gone and ``anchor_params`` returns its argument (nothing
partitions a scan here).
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional

import torch

from ..tree import tree_leaves, tree_unflatten

__all__ = [
    "DP",
    "MODEL",
    "NONE",
    "ShardedLeaf",
    "activation_sharding",
    "all_reduce_",
    "anchor_params",
    "combine_partial_softmax",
    "constrain",
    "current",
    "dp_size",
    "entered",
    "dp_sum",
    "fetch",
    "local_of",
    "local_view",
    "mesh_axes",
    "model_block",
    "model_gather",
    "model_input",
    "model_offset",
    "model_part",
    "model_whole",
    "moved_bytes",
    "moved_calls",
    "reset_moved_bytes",
    "rows",
    "rows_whole",
    "split_over_model",
    "wire_factor",
]

DP = "__DP__"
MODEL = "__M__"
NONE = None

_TLS = threading.local()


class _Axis(NamedTuple):
    name: str
    group: object  # the process group of this mesh dim
    size: int
    rank: int  # this rank's coordinate on it


def mesh_axes(mesh) -> dict:
    """{name: _Axis} of a named DeviceMesh's dims, in mesh order."""
    names = tuple(mesh.mesh_dim_names or ())
    return {n: _Axis(n, mesh.get_group(n), int(mesh.size(i)), int(mesh.get_local_rank(n)))
            for i, n in enumerate(names)}


class _Ctx:
    """The active context: the mesh's axes, its dp axes (batch rows, major
    first) and tensor axis, and the config."""

    def __init__(self, mesh, pc):
        from .sharding import dp_axes

        self.mesh, self.pc = mesh, pc
        self.axes = mesh_axes(mesh)
        self.dp = tuple(self.axes[a] for a in dp_axes(mesh, pc))
        self.model = self.axes.get(pc.tensor_axis)

    def model_split(self) -> Optional[_Axis]:
        """The tensor axis where it has more than one rank."""
        return self.model if self.model is not None and self.model.size > 1 else None

    def dp_index(self) -> int:
        i = 0
        for a in self.dp:
            i = i * a.size + a.rank
        return i

    def dp_size(self) -> int:
        n = 1
        for a in self.dp:
            n *= a.size
        return n


def current() -> Optional[_Ctx]:
    return getattr(_TLS, "ctx", None)


@contextlib.contextmanager
def activation_sharding(mesh, pc):
    """Run model code on ``mesh`` (a named DeviceMesh) under ``pc``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or not mesh.mesh_dim_names:
        raise TypeError(f"activation_sharding needs a named DeviceMesh, got {type(mesh).__name__}")
    with entered(_Ctx(mesh, pc)):
        yield


@contextlib.contextmanager
def entered(ctx: Optional[_Ctx]):
    """Make ``ctx`` (a ``current()``, or None) this thread's context: a
    remat's recompute runs on autograd's device thread, which must see the
    context of the forward it repeats."""
    prev = current()
    _TLS.ctx = ctx
    try:
        yield
    finally:
        _TLS.ctx = prev


def anchor_params(tree):
    """The reference pins a scanned layer slice to its storage layout for
    XLA's partitioner; the port has neither scan nor partitioner."""
    return tree


# ---------------------------------------------------------------------- #
# collectives along one tensor dim, over one mesh dim
# ---------------------------------------------------------------------- #
_KINDS = ("all_gather", "reduce_scatter", "all_reduce", "exchange")
_MOVED: dict = {}  # (kind, mesh dims of the group) -> bytes sent
_CALLS: dict = {}  # (kind, mesh dims of the group) -> collectives issued


def wire_factor(kind: str, n: int) -> float:
    """The share of a collective's tensor each of ``n`` ranks sends on a
    ring: all-reduce 2 (n - 1) / n, all-gather and reduce-scatter (n - 1) /
    n, an exchange (a permutation) 1; nothing on one rank."""
    if kind == "exchange":
        return 1.0
    if n <= 1:
        return 0.0
    return (2.0 if kind == "all_reduce" else 1.0) * (n - 1) / n


def moved_bytes(by_axes: bool = False) -> dict:
    """Bytes this rank sent since ``reset_moved_bytes``: by collective, or
    with ``by_axes`` by (collective, the names of the mesh dims its group
    spans)."""
    if by_axes:
        return dict(_MOVED)
    out = dict.fromkeys(_KINDS, 0.0)
    for (kind, _), b in _MOVED.items():
        out[kind] += b
    return out


def moved_calls() -> dict:
    """Collectives issued since ``reset_moved_bytes``, by (collective, mesh
    dims), as ``moved_bytes(by_axes=True)`` keys them."""
    return dict(_CALLS)


def reset_moved_bytes() -> None:
    _MOVED.clear()
    _CALLS.clear()


def _moved(kind: str, t: torch.Tensor, n: int = 2, axes: tuple = ()) -> None:
    """Count ``t`` (the whole gathered or reduced tensor; the chunk sent in
    an exchange) as a ring over ``n`` ranks sends it, under the mesh dims
    ``axes`` its group spans."""
    key = (kind, tuple(axes))
    _MOVED[key] = _MOVED.get(key, 0.0) + t.numel() * t.element_size() * wire_factor(kind, n)
    _CALLS[key] = _CALLS.get(key, 0) + 1


def _all_gather(x: torch.Tensor, dim: int, ax: _Axis) -> torch.Tensor:
    import torch.distributed as dist

    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((ax.size * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=ax.group)
    _moved("all_gather", out, ax.size, (ax.name,))
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, ax: _Axis, dtype=None) -> torch.Tensor:
    import torch.distributed as dist

    xt = x.movedim(dim, 0).to(dtype or x.dtype).contiguous()
    out = xt.new_empty((xt.shape[0] // ax.size,) + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=ax.group)
    _moved("reduce_scatter", xt, ax.size, (ax.name,))
    return out.to(x.dtype).movedim(0, dim)


def all_reduce_(x: torch.Tensor, axes, op=None) -> torch.Tensor:
    """``x`` reduced in place over each of ``axes`` (``_Axis``es; those of
    one rank skipped), sum unless ``op``."""
    import torch.distributed as dist

    for ax in axes:
        if ax.size > 1:
            dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=ax.group)
            _moved("all_reduce", x, ax.size, (ax.name,))
    return x


def _all_reduce(x: torch.Tensor, axes) -> torch.Tensor:
    return all_reduce_(x.clone(), axes)


def _narrow(x: torch.Tensor, dim: int, ax: _Axis) -> torch.Tensor:
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.rank * n, n)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``. Backward: the gradient's own block, summed
    over the axis's ranks (``sum``: the result fed computations that differ
    by rank) or sliced (the same computation on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, ax, bwd_sum, bf16):
        ctx.dim, ctx.ax, ctx.bwd_sum, ctx.bf16 = dim, ax, bwd_sum, bf16
        return _all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd_sum:
            dtype = torch.bfloat16 if ctx.bf16 else None
            return _reduce_scatter(g, ctx.dim, ctx.ax, dtype), None, None, None, None
        return _narrow(g, ctx.dim, ctx.ax), None, None, None, None


class _Split(torch.autograd.Function):
    """This rank's block of a tensor that is whole on every rank. Backward:
    the blocks' gradients gathered (each rank computed with its own)."""

    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _narrow(x, dim, ax).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.ax), None, None


class _ReduceScatter(torch.autograd.Function):
    """Partial sums -> this rank's block of their sum. Backward: gather."""

    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _reduce_scatter(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.ax), None, None


class _Sum(torch.autograd.Function):
    """All-reduce (sum) over ``axes``; the result is the same on every rank,
    so the backward passes the gradient through (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, axes):
        return _all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Fan(torch.autograd.Function):
    """Identity; the backward sums the gradient over ``axes`` (Megatron's f:
    the input of computations that differ by rank)."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axes), None


class _Permute(torch.autograd.Function):
    """Send this rank's tensor to global rank ``dst`` and take the one of
    ``src`` (a permutation of the ranks); the backward sends back."""

    @staticmethod
    def forward(ctx, x, dst, src, axes):
        ctx.dst, ctx.src, ctx.axes = dst, src, axes
        return _exchange(x, dst, src, axes)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.src, ctx.dst, ctx.axes), None, None, None


def _exchange(x: torch.Tensor, dst: int, src: int, axes: tuple) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dst), dist.P2POp(dist.irecv, out, src)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    _moved("exchange", x, axes=axes)
    return out


# ---------------------------------------------------------------------- #
# parameters
# ---------------------------------------------------------------------- #
class ShardedLeaf:
    """The model's view of a split parameter: this rank's ``local`` block,
    the mesh axes each dim is split over (``spec``, mesh order) and the
    whole ``shape``. Use sites ``fetch`` it; a use without ``fetch`` fails."""

    __slots__ = ("local", "spec", "shape")

    def __init__(self, local: torch.Tensor, spec: tuple, shape):
        self.local, self.spec, self.shape = local, spec, torch.Size(shape)

    def dim(self) -> int:
        return len(self.shape)

    def to(self, dtype) -> "ShardedLeaf":
        return ShardedLeaf(self.local.to(dtype), self.spec, self.shape)

    def unbind(self, dim: int = 0) -> list:
        if dim != 0 or self.spec[0]:
            raise ValueError("only an unsplit leading (stack) dim unbinds")
        return [ShardedLeaf(t, self.spec[1:], self.shape[1:]) for t in self.local.unbind(0)]


def _spec_of(t) -> tuple:
    """Per tensor dim, the mesh axes a DTensor is split over (mesh order)."""
    names = t.device_mesh.mesh_dim_names
    spec = [[] for _ in range(t.dim())]
    for name, p in zip(names, t.placements):
        if p.is_shard():
            spec[p.dim].append(name)
        elif not p.is_replicate():
            raise ValueError(f"{p} placement: a parameter is split or whole, not partial")
    return tuple(tuple(s) for s in spec)


def local_view(tree, requires_grad: bool = False):
    """(view, locals): the model's view of a tree of DTensors (a
    ``ShardedLeaf`` for each split leaf, the local tensor for a whole one)
    and the local tensors themselves, in ``tree_leaves`` order. Each local
    tensor shares its DTensor's storage; with ``requires_grad`` it is a new
    autograd leaf (the step differentiates with respect to these)."""
    from torch.distributed.tensor import DTensor

    views, locals_ = [], []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, DTensor):
            with torch.no_grad():
                loc = leaf.to_local()
            spec = _spec_of(leaf)
        else:
            loc, spec = leaf, ()
        loc = loc.detach()
        if requires_grad:
            loc.requires_grad_(True)
        locals_.append(loc)
        views.append(ShardedLeaf(loc, spec, leaf.shape) if any(spec) else loc)
    return tree_unflatten(tree, views), locals_


def model_part(n: int) -> Optional[tuple]:
    """(this rank's model coordinate, model size) where a dim of ``n``
    splits over a tensor axis of more than one rank in the active context;
    None otherwise (outside a context, too)."""
    ctx = current()
    ax = ctx.model_split() if ctx is not None else None
    if ax is None or n % ax.size:
        return None
    return ax.rank, ax.size


def _dim_to_layout(ctx: _Ctx, x, d: int, axes: tuple, want_model: bool):
    """One dim of a parameter block from its storage axes to the use site's
    layout: this model rank's contiguous block (``want_model``) or whole."""
    M = ctx.model_split()
    m_name = M.name if M is not None else None
    bf16 = ctx.pc.compress_grads
    dp_names = {a.name for a in ctx.dp}
    live = tuple(a for a in axes if ctx.axes[a].size > 1)

    def gather(x, names):  # minor to major: the block order of a joint split
        for a in reversed(names):
            ax = ctx.axes[a]
            x = _Gather.apply(x, d, ax, a in dp_names, bf16 and a in dp_names)
        return x

    if not want_model or M is None:
        return gather(x, live)
    f_names = tuple(a for a in live if a != m_name)
    if m_name not in live:
        if x.shape[d] * _prod(ctx, f_names) % M.size:
            raise ValueError(f"dim {d} of {x.shape[d]} does not split over {M.size} model ranks")
        return _Split.apply(gather(x, f_names), d, M)
    if not f_names:
        return x
    # joint (fsdp..., model) split: move chunk c to the rank that holds it
    # in the model-major order, then gather over fsdp
    dst, src = _joint_exchange(ctx, live, m_name, f_names)
    if dst is not None:
        x = _Permute.apply(x, dst, src, live)
    return gather(x, f_names)


def _prod(ctx, names) -> int:
    n = 1
    for a in names:
        n *= ctx.axes[a].size
    return n


def _joint_exchange(ctx: _Ctx, live: tuple, m_name: str, f_names: tuple):
    """(dst, src) global ranks of the one-chunk exchange that turns a dim
    split jointly over ``live`` (mesh order) into "model major": after it,
    rank (f, m) holds chunk m * K + f (K = fsdp ranks), so that a gather
    over fsdp gives model rank m its contiguous block. (None, None) where
    every rank already holds its chunk."""
    names = tuple(ctx.mesh.mesh_dim_names)
    coord = list(ctx.mesh.get_coordinate())
    sizes = [ctx.axes[a].size for a in live]
    K = _prod(ctx, f_names)

    def flat(vals, dims):
        i = 0
        for v, n in zip(vals, dims):
            i = i * n + v
        return i

    def unflat(i, dims):
        out = []
        for n in reversed(dims):
            out.append(i % n)
            i //= n
        return out[::-1]

    def rank_at(vals_by_name):
        c = list(coord)
        for a, v in vals_by_name.items():
            c[names.index(a)] = v
        return int(ctx.mesh.mesh[tuple(c)])

    f_sizes = [ctx.axes[a].size for a in f_names]
    mine = flat([ctx.axes[a].rank for a in live], sizes)
    target = ctx.axes[m_name].rank * K + flat([ctx.axes[a].rank for a in f_names], f_sizes)
    if mine == target:
        return None, None
    # chunk ``mine`` goes to the rank (f', m') with m' * K + f' == mine
    dst = {m_name: mine // K, **dict(zip(f_names, unflat(mine % K, f_sizes)))}
    # chunk ``target`` sits, by the natural order, at the coordinates it unflattens to
    src = dict(zip(live, unflat(target, sizes)))
    return rank_at(dst), rank_at(src)


def fetch(w, *parts):
    """A parameter at its use site, in the TP-only layout ``parts`` (per
    dim ``MODEL`` or None; dims past ``parts`` whole). Outside a context
    ``w`` itself. Inside one, ``w`` is a ``ShardedLeaf`` or a whole tensor,
    and the result is a plain local tensor: gathered over the fsdp axes
    (gradient reduce-scattered over them, in bfloat16 under
    ``compress_grads``), cut to this model rank's block where ``MODEL``
    asks for it."""
    ctx = current()
    if ctx is None:
        return w
    if isinstance(w, ShardedLeaf):
        out, spec = w.local, w.spec
    else:
        out, spec = w, ((),) * w.dim()
    want = list(parts) + [None] * (out.dim() - len(parts))
    for d in range(out.dim()):
        out = _dim_to_layout(ctx, out, d, spec[d], want[d] == MODEL)
    return out


# ---------------------------------------------------------------------- #
# activations
# ---------------------------------------------------------------------- #
def model_input(x: torch.Tensor, src=None) -> torch.Tensor:
    """``x`` whole, as the input of a computation that differs by model
    rank (a column-parallel matmul, local heads): its gradient is summed
    over "model". ``src=dim``: ``x`` is model-split along that dim and is
    gathered first (the gradient reduce-scattered back)."""
    ctx = current()
    ax = ctx.model_split() if ctx is not None else None
    if ax is None:
        return x
    if src is None:
        return _Fan.apply(x, (ax,))
    return _Gather.apply(x, src % x.dim(), ax, True, False)


def constrain(x: torch.Tensor, *parts, src=None) -> torch.Tensor:
    """Lay ``x`` out as ``parts`` over "model" (``MODEL`` on at most one
    dim; ``DP`` entries are the rows' data split, already local). ``src``
    is the layout ``x`` has: None (whole, the same on every model rank),
    ``"partial"`` (this rank's partial sums: all-reduced, or reduce-scattered
    into the ``MODEL`` dim where it divides) or a dim it is model-split
    along (gathered whole; the gradient sliced). Outside a context, or on a
    tensor axis of one rank, ``x`` itself."""
    ctx = current()
    ax = ctx.model_split() if ctx is not None else None
    if ax is None:
        return x
    want = next((i for i, p in enumerate(parts) if p == MODEL), None)
    if src == "partial":
        if want is not None and x.shape[want] % ax.size == 0:
            return _ReduceScatter.apply(x, want, ax)
        return _Sum.apply(x, (ax,))
    if src is None:
        return x if want is None else _Split.apply(x, want, ax)
    src = src % x.dim()
    if want == src:
        return x
    if want is not None:
        raise ValueError(f"cannot move a model split from dim {src} to dim {want}")
    return _Gather.apply(x, src, ax, False, False)


def dp_size() -> int:
    """Data shards in the active context (1 outside one)."""
    ctx = current()
    return ctx.dp_size() if ctx is not None else 1


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data shards; the sum is the same on every rank,
    so the gradient passes through to each shard's term."""
    ctx = current()
    if ctx is None or ctx.dp_size() == 1:
        return x
    return _Sum.apply(x, ctx.dp)


# ---------------------------------------------------------------------- #
# serving: batch rows, cache blocks, the context-parallel softmax
# ---------------------------------------------------------------------- #
def _rows_split(n: int) -> bool:
    """Whether a serving batch of ``n`` rows splits over the data shards
    (as ``make_shardings`` splits its cache's batch dim)."""
    ctx = current()
    return ctx is not None and ctx.dp_size() > 1 and n % ctx.dp_size() == 0


def rows(x):
    """This data shard's rows of ``x`` (the whole batch, the same on every
    rank) where they split over the dp axes; ``x`` itself otherwise (None,
    too): such a batch runs whole on every dp rank."""
    if x is None or not _rows_split(x.shape[0]):
        return x
    ctx = current()
    k = x.shape[0] // ctx.dp_size()
    i = ctx.dp_index()
    return x[i * k:(i + 1) * k]


def rows_whole(x: torch.Tensor, n: int) -> torch.Tensor:
    """The whole batch of ``n`` rows from this data shard's ``x`` where
    ``rows`` split it (gathered over the dp axes, a plain all-gather:
    serving, no backward); ``x`` itself otherwise."""
    if not _rows_split(n):
        return x
    for ax in reversed(current().dp):  # minor first: the rows' block order
        if ax.size > 1:
            x = _all_gather(x, 0, ax)
    return x


def model_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x``, split along ``dim`` over "model", gathered whole (a plain
    all-gather: serving, no backward); ``x`` itself where "model" has one
    rank or no context is active."""
    ctx = current()
    ax = ctx.model_split() if ctx is not None else None
    if ax is None:
        return x
    return _all_gather(x.contiguous(), dim % x.dim(), ax)


def split_over_model(leaf, d: int) -> bool:
    """Whether dim ``d`` of ``leaf`` (a ``ShardedLeaf``) is split over a
    tensor axis of more than one rank."""
    return _model_dim(leaf, d) is not None


def local_of(leaf) -> torch.Tensor:
    """The local block of a ``ShardedLeaf``; a tensor itself."""
    return leaf.local if isinstance(leaf, ShardedLeaf) else leaf


def _model_dim(leaf, d: int) -> Optional[_Axis]:
    """The tensor axis where dim ``d`` of ``leaf`` is split over it and it
    has more than one rank."""
    ctx = current()
    ax = ctx.model_split() if ctx is not None else None
    if ax is None or not isinstance(leaf, ShardedLeaf) or ax.name not in leaf.spec[d]:
        return None
    return ax


def model_offset(leaf, d: int) -> int:
    """The first index, in the whole dim ``d``, of this rank's block of
    ``leaf`` (0 where the dim is not split over "model")."""
    ax = _model_dim(leaf, d)
    return 0 if ax is None else ax.rank * local_of(leaf).shape[d]


def model_whole(leaf) -> torch.Tensor:
    """``leaf``'s block gathered over "model" on each dim split over it
    (a plain all-gather: serving, no backward); its rows stay local."""
    out = local_of(leaf)
    for d in range(out.dim()):
        ax = _model_dim(leaf, d)
        if ax is not None:
            out = _all_gather(out, d, ax)
    return out


def model_block(value: torch.Tensor, leaf) -> torch.Tensor:
    """``value``, whole over "model" on the dims of ``leaf`` split over it,
    cut to this rank's block there (a dim already the block's size is
    left as it is)."""
    for d in range(value.dim()):
        ax = _model_dim(leaf, d)
        if ax is not None and value.shape[d] == leaf.shape[d]:
            value = _narrow(value, d, ax)
    return value


def combine_partial_softmax(m: torch.Tensor, l: torch.Tensor,  # noqa: E741
                            acc: torch.Tensor):
    """Join softmax-weighted sums taken over disjoint key blocks, one a
    model rank (a context-parallel cache): ``m`` each row's local max,
    ``l`` the local sum of ``exp(s - m)``, ``acc`` the local sum of
    ``exp(s - m) v`` (``m``'s dims, then the value dim). Returns the rows'
    ``(max, sum, acc)`` over every rank's keys: the max all-reduced, the
    sums rescaled by ``exp(m - max)`` and all-reduced. A block whose keys
    are all masked (scores at a large negative) gets weight ``exp(m - max)
    = 0``. Outside a context, or on one model rank, the arguments."""
    import torch.distributed as dist

    ctx = current()
    ax = ctx.model_split() if ctx is not None else None
    if ax is None:
        return m, l, acc
    top = all_reduce_(m.clone(), (ax,), op=dist.ReduceOp.MAX)
    w = torch.exp(m - top)
    return top, all_reduce_(l * w, (ax,)), all_reduce_(acc * w[..., None], (ax,))
