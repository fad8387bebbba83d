"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the process group the caller started (``dist.init_process_group``, with
an address, world size and rank of the caller's own: nothing tells a
program of a cluster). Meshes are built by functions, never at import, and
each rank calls the builder, as ``init_device_mesh`` requires.

The mesh's device type follows the process group's backend: ``"cuda"``
under NCCL (one rank per card), ``"cpu"`` under gloo (the CPU tests' ranks).
Without a process group a builder raises: the sharded path never runs a
host loop in its place.

``make_production_mesh`` (the reference's 512-chip TPU mesh) waits for the
dry-run slice; the reference's ``HW`` table holds a TPU's figures and has no
counterpart here.
"""
from __future__ import annotations

__all__ = ["make_local_mesh", "make_production_mesh", "make_staging_mesh", "mesh_device_type"]


def _world() -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a device mesh needs a process group: call "
            "torch.distributed.init_process_group(...) on every rank first"
        )
    return dist.get_world_size()


def mesh_device_type() -> str:
    """``"cuda"`` under an NCCL process group, ``"cpu"`` otherwise (gloo)."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(mesh_device_type(), tuple(int(d) for d in shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "make_production_mesh (the reference's 512-chip TPU mesh) is not ported yet; "
        "it comes with the dry-run slice"
    )


def make_staging_mesh(
    num_shards: int | tuple | None = None,
    axis: str = "shards",
    *,
    model: int | None = None,
    model_axis: str = "model",
):
    """Mesh for sharded staged execution (``stage_spmv(..., mesh=)``).

    1-D: ``make_staging_mesh(8)``, a ``"shards"`` axis over the first 8
    ranks. 2-D: ``make_staging_mesh(4, model=2)`` or
    ``make_staging_mesh((4, 2))``, a ``("shards", "model")`` mesh whose
    model axis column-partitions the dense SpMM operand. Every rank calls
    it; a rank past the mesh gets a mesh it has no coordinate in.
    """
    if isinstance(num_shards, (tuple, list)):
        if model is not None:
            raise ValueError("pass either a (shards, model) tuple or model=")
        num_shards, model = (int(d) for d in num_shards)
    world = _world()
    if num_shards is not None:
        n = num_shards
    else:  # all ranks by default; with model= given, shards fill the rest
        n = world if model is None else world // max(model, 1)
    if model is None:
        if n > world:
            raise ValueError(f"asked for {n} shards but only {world} devices")
        return _mesh((n,), (axis,))
    if n < 1 or n * model > world:
        raise ValueError(f"asked for {n}x{model} mesh but only {world} devices")
    return _mesh((n, model), (axis, model_axis))


def make_local_mesh(axes=("data", "model"), shape=None):
    """Mesh over every rank of the process group (tests, examples)."""
    n = _world()
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        else:
            m = 1
            for f in (2, 4, 8):
                if n % f == 0 and f <= n:
                    m = f
            shape = (n // m, m) if len(axes) == 2 else (1, n // m, m)
    prod = 1
    for d in shape:
        prod *= int(d)
    if prod != n:
        raise ValueError(f"{tuple(shape)} != {n} devices")
    return _mesh(tuple(shape), tuple(axes))
