"""Fault-tolerant checkpointing (port of ``repro.checkpoint.manager``), in
the reference's on-disk format, so that either package restores the other's
checkpoints:

  * ``<dir>/step_%08d/`` holds ``manifest.json`` and one ``leaf_%05d.npy``
    a leaf, in the reference's leaf order (dict keys sorted, lists in
    order), each named by its path (``params/groups/0/sub0/ffn/w1``);
  * a dtype numpy has (float32, int32, ...) is stored as such; bfloat16 is
    stored as its raw bytes (``"raw": true``) under the logical dtype name
    ``bfloat16``;
  * **atomicity**: writes go to ``<dir>/tmp.<step>.<pid>`` and are renamed
    to ``step_<n>`` only after the manifest is fsynced;
  * **asynchrony**: ``save_async`` copies the tensors to host memory on the
    calling thread and writes them on a background thread;
  * **retention**: ``keep_last_k`` garbage collection.

``restore_checkpoint`` puts each leaf on the device of the leaf it replaces
in ``tree_like``, or lays it out as that leaf where it is a DTensor.

A tree of DTensors (model sharding) is saved whole, leaf by leaf: every
rank joins each leaf's gather (``full_tensor``, a collective), rank 0
alone keeps it and writes it, the others drop it at once, and the ranks
meet at a barrier. ``restore_checkpoint(shardings=)`` (elastic restore)
loads each leaf whole on every rank and keeps the block its
``NamedSharding`` gives it, whatever the mesh's shape at save time.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..tree import tree_leaves, tree_paths, tree_unflatten

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint", "save_checkpoint"]

# torch dtypes numpy stores as themselves, by the reference's names
_NATIVE = {
    torch.float16: "float16", torch.float32: "float32", torch.float64: "float64",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
    torch.uint8: "uint8", torch.bool: "bool",
}


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _to_host(leaf, copy: bool = False) -> torch.Tensor:
    """A leaf as a CPU tensor, a copy where ``copy`` (numpy arrays and
    numbers become tensors; a DTensor is gathered whole: a collective. The
    whole of a replicated DTensor is its own storage, so ``copy`` holds
    for it too)."""
    if _is_dtensor(leaf):
        with torch.no_grad():
            return leaf.full_tensor().to("cpu", copy=copy)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=copy)
    return torch.as_tensor(np.asarray(leaf))


def _sharded(tree) -> bool:
    """A tree of DTensors: every rank gathers, rank 0 writes."""
    return any(_is_dtensor(leaf) for leaf in tree_leaves(tree))


def _writer() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _join_gathers(tree) -> None:
    """A rank that does not write: join each DTensor leaf's gather, in the
    writer's order, and keep nothing."""
    for leaf in tree_leaves(tree):
        if _is_dtensor(leaf):
            with torch.no_grad():
                leaf.full_tensor()


def _file_array(host: torch.Tensor):
    """(numpy array to store, dtype name, raw) for a CPU tensor."""
    if host.dtype in _NATIVE:
        return host.numpy(), _NATIVE[host.dtype], False
    # bfloat16 and other dtypes numpy lacks: the raw bytes, as the reference
    # stores them (np.ascontiguousarray(arr).view(np.uint8))
    name = str(host.dtype).removeprefix("torch.")
    flat = host.contiguous() if host.dim() else host.reshape(1)
    return flat.view(torch.uint8).numpy(), name, True


def save_checkpoint(directory: str, step: int, tree, extra: Optional[dict] = None) -> str:
    """Synchronous atomic save of a tree of tensors. Every rank calls it
    for a tree of DTensors; rank 0 writes each leaf as its gather ends."""
    if _sharded(tree):
        import torch.distributed as dist

        if _writer():
            final = _write(directory, step, tree, extra)
        else:
            _join_gathers(tree)
            final = os.path.join(directory, f"step_{step:08d}")
        dist.barrier()
        return final
    return _write(directory, step, tree, extra)


def _write(directory: str, step: int, tree, extra: Optional[dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (name, leaf) in enumerate(tree_paths(tree)):
        host = _to_host(leaf)
        arr, dtype, raw = _file_array(host)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"name": name, "file": fname, "shape": list(host.shape),
                                   "dtype": dtype, "raw": raw, "spec": ""})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory) if d.startswith("step_")]
    return max(steps) if steps else None


def _load_leaf(d: str, meta: dict, like) -> torch.Tensor:
    arr = np.load(os.path.join(d, meta["file"]))
    if meta.get("raw"):
        dtype = getattr(torch, meta["dtype"])
        t = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1)).view(dtype)
        t = t.reshape(meta["shape"])
    else:
        t = torch.from_numpy(np.asarray(arr))
        if isinstance(like, torch.Tensor):
            t = t.to(like.dtype)
    if isinstance(like, torch.Tensor):
        t = t.to(like.device)
    return t


def restore_checkpoint(directory: str, tree_like, step: Optional[int] = None, shardings=None):
    """Restore into the structure of ``tree_like`` (each leaf on its
    like's device, in its dtype, or the stored logical dtype for raw leaves).
    ``shardings``: a tree (or flat list) of ``distributed.sharding``'s
    ``NamedSharding`` for the current mesh: each leaf comes back a DTensor
    laid out by it (elastic restore); without it a DTensor like-leaf's own
    layout is kept. Returns (tree, step, extra)."""
    from torch.distributed.tensor import distribute_tensor

    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {m["name"]: m for m in manifest["leaves"]}
    likes = tree_paths(tree_like)
    if shardings is None:
        layouts = [(like.device_mesh, like.placements) if _is_dtensor(like) else None
                   for _, like in likes]
    else:
        from ..distributed.sharding import NamedSharding

        shs = tree_leaves(shardings)
        if not all(isinstance(s, NamedSharding) for s in shs):
            raise TypeError("shardings= takes distributed.sharding.NamedSharding leaves")
        layouts = [(s.mesh, s.placements) for s in shs]
    out = []
    for (name, like), layout in zip(likes, layouts):
        t = _load_leaf(d, by_name[name], like)
        if layout is not None:  # each rank read the whole leaf: it keeps its block
            t = distribute_tensor(t, *layout, src_data_rank=None)
        out.append(t)
    return tree_unflatten(tree_like, out), step, manifest.get("extra", {})


class CheckpointManager:
    """Async, retained, atomic checkpoints."""

    def __init__(self, directory: str, keep_last_k: int = 3):
        self.directory = directory
        self.keep = keep_last_k
        self._thread: Optional[threading.Thread] = None
        self.save_times: list[float] = []

    def save_async(self, step: int, tree, extra: Optional[dict] = None):
        """Copy ``tree`` to host memory here, then write it on a background
        thread (one save in flight). For a tree of DTensors every rank
        joins the gathers here and rank 0 alone keeps the copy."""
        self.wait()
        if _sharded(tree) and not _writer():
            _join_gathers(tree)
            return
        host_tree = tree_unflatten(tree, [_to_host(leaf, copy=True) for leaf in
                                          tree_leaves(tree)])

        def work():
            t0 = time.perf_counter()
            save_checkpoint(self.directory, step, host_tree, extra)
            self._gc()
            self.save_times.append(time.perf_counter() - t0)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree, extra: Optional[dict] = None):
        self.wait()
        save_checkpoint(self.directory, step, tree, extra)
        if _writer() or not _sharded(tree):
            self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, tree_like, step=None, shardings=None):
        self.wait()
        return restore_checkpoint(self.directory, tree_like, step, shardings)

    def latest_step(self):
        return latest_step(self.directory)

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))
