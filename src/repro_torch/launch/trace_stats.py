"""Per-rank costs of one traced call of the port's program: FLOPs, a
memory-traffic estimate, the peak of live bytes and collective bytes (the
port's counterpart of ``repro.launch.hlo_stats``).

The reference reads its costs from the compiled per-device HLO. The port
has no HLO, so it measures one call of its own program, run on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and dtypes on the
trace device, nothing allocated) on one rank of a (fake) process group:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the call (the
  forward and, in a train step, the backward). It counts matmuls and
  convolutions, as the reference counts dot and convolution FLOPs;
  elementwise work is left out, as there. A convolution's backward is
  counted as twice its forward (grad input and grad weight, each the
  forward's multiply-adds): torch's own formula, like the reference's
  ``_conv_flops``, charges a grouped (depthwise) conv's weight gradient as
  if it were dense.
* Memory traffic: every op's output bytes, view ops and ``empty`` excluded
  (an in-place op's output is the block it wrote), plus the arguments read
  once: the reference's "each intermediate written once".
* Peak of live bytes: the arguments plus every storage an op creates, each
  freed when its last tensor dies (autograd's saved tensors keep theirs
  alive). The counterpart of ``memory_analysis()``'s argument and temp
  sizes.
* Collectives: what ``distributed.ctx`` counted (``moved_bytes(by_axes=
  True)``: ring wire bytes, ``ctx.wire_factor``), each split into bytes
  inside one node of ``node_size`` ranks and bytes across nodes: a group
  whose ranks (row-major over the mesh) lie in more than one node sends
  all its bytes across nodes, as the reference charges a group that spans
  pods to the DCN.
* An op census: count and output bytes by op name, from the same pass (the
  counterpart of ``op_census``/``top_traffic``; ``top_collectives`` is the
  collectives' table by mesh dims).
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..distributed import ctx

__all__ = ["TraceStats", "flop_counter", "group_ranks", "link_split", "trace", "wire_factor"]

wire_factor = ctx.wire_factor

_CENSUS_TOP = 15  # the ops a report lists, by output bytes
_NO_WRITE = {"empty.memory_format", "empty_strided.default", "new_empty.default",
             "new_empty_strided.default", "empty_like.default"}


def _tensors(tree):
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class TraceStats(TorchDispatchMode):
    """A dispatch mode that counts each op's output bytes (views and
    ``empty`` excluded) and the live bytes of the storages the ops create."""

    def __init__(self):
        super().__init__()
        self.out_bytes = 0
        self.live = 0
        self.peak = 0
        self.census = defaultdict(lambda: [0, 0])  # op -> [count, output bytes]
        self._sizes: dict = {}

    def hold(self, t: torch.Tensor) -> bool:
        """Count ``t``'s storage as live until its last tensor dies; False
        where it already is."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return False
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return True

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name.split("::")[-1] + "." + func._overloadname
        for t in _tensors(out):
            self.hold(t)
            if func.is_view or name in _NO_WRITE:
                continue
            b = t.numel() * t.element_size()
            self.out_bytes += b
            c = self.census[name]
            c[0] += 1
            c[1] += b
        return out


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                        _dilation, _transposed, _output_padding, _groups, output_mask,
                        out_shape=None, **kwargs) -> int:
    """Each of grad input and grad weight: the forward's 2 * numel(out) *
    (C_in / groups) * prod(kernel) (``w_shape`` is (C_out, C_in / groups,
    *kernel))."""
    fwd = 2 * _prod(grad_out_shape) * _prod(w_shape[1:])
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def _prod(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def flop_counter():
    """A ``FlopCounterMode`` with the grouped-conv backward counted right."""
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flop})


def group_ranks(mesh, axes) -> list:
    """The global ranks of this rank's group over the mesh dims ``axes``."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx = tuple(slice(None) if n in axes else c for n, c in zip(names, coord))
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():  # the rank table is a real tensor
        return [int(r) for r in mesh.mesh[idx].reshape(-1).tolist()]


def link_split(moved: dict, mesh, node_size: int, calls: dict = None) -> dict:
    """The reference's ``collectives`` table from ``ctx.moved_bytes(
    by_axes=True)``: per collective its wire bytes, those across nodes
    (a group spanning nodes) and the largest group; then the totals."""
    out: dict = {}
    for (kind, axes), wire in moved.items():
        ranks = group_ranks(mesh, axes)
        inter = len({r // node_size for r in ranks}) > 1
        s = out.setdefault(kind, {"count": 0, "wire_bytes": 0.0, "inter_node_wire_bytes": 0.0,
                                  "max_group": 1, "by_axes": {}})
        s["count"] += (calls or {}).get((kind, axes), 0)
        s["wire_bytes"] += wire
        s["inter_node_wire_bytes"] += wire if inter else 0.0
        s["max_group"] = max(s["max_group"], len(ranks))
        s["by_axes"]["|".join(axes)] = wire
    kinds = [v for v in out.values()]
    out["total_wire_bytes"] = sum(v["wire_bytes"] for v in kinds)
    out["total_inter_node_wire_bytes"] = sum(v["inter_node_wire_bytes"] for v in kinds)
    out["total_intra_node_wire_bytes"] = (out["total_wire_bytes"]
                                          - out["total_inter_node_wire_bytes"])
    return out


def trace(fn, args, mesh=None, node_size: int = 8) -> dict:
    """Run ``fn()`` once (under the caller's ``FakeTensorMode``) and count
    its costs on this rank. ``args`` are the tensors it reads (params,
    optimizer state, cache, batch: their local blocks), live before it
    starts. Returns ``flops``, ``hbm_bytes_est``, ``memory``
    (``argument_size_in_bytes``, ``peak_size_in_bytes``,
    ``temp_size_in_bytes``), ``collectives`` (``link_split``; empty
    without ``mesh``) and ``op_census`` (the ``_CENSUS_TOP`` ops writing most);
    ``result`` is ``fn``'s return."""
    stats = TraceStats()
    for t in _tensors(args):
        stats.hold(t)
    arg_bytes = stats.live
    ctx.reset_moved_bytes()
    with flop_counter() as flops, stats:
        result = fn()
    moved, calls = ctx.moved_bytes(by_axes=True), ctx.moved_calls()
    census = sorted(((k, v[0], v[1]) for k, v in stats.census.items()), key=lambda r: -r[2])
    return {
        "flops": float(flops.get_total_flops()),
        "flops_by_op": {str(k): float(v) for k, v in flops.get_flop_counts()["Global"].items()},
        "hbm_bytes_est": float(stats.out_bytes + arg_bytes),
        "memory": {"argument_size_in_bytes": arg_bytes, "peak_size_in_bytes": stats.peak,
                   "temp_size_in_bytes": stats.peak - arg_bytes},
        "collectives": link_split(moved, mesh, node_size, calls) if mesh is not None else {},
        "op_census": [{"op": k, "count": n, "bytes": b} for k, n, b in census[:_CENSUS_TOP]],
        "result": result,
    }
