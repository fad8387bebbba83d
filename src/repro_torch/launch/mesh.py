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

``make_production_mesh`` builds the reference's production shapes and
names, ``(16, 16)`` ("data", "model") or ``(2, 16, 16)`` ("pod", "data",
"model"), over a process group of 256 or 512 ranks: the same shapes keep
every sanitizing decision and every per-rank shape the reference's. The
dry-run builds it over a fake process group of that size (one process
traces rank 0's program; see ``launch/dryrun.py``).

``HW`` is the card's table for the dry-run's roofline. Its figures are
NVIDIA's data sheet for the H100 SXM5 80GB HBM3 at its 700 W power limit,
dense rates: they are not measurements of this repo. The network is a
model of a machine this repo has not run on: 8 cards a node joined by
NVLink (450 GB/s each way a card), nodes joined by one 400 Gb/s
InfiniBand port a card (50 GB/s each way), as in a DGX H100.
"""
from __future__ import annotations

__all__ = ["HW", "make_local_mesh", "make_production_mesh", "make_staging_mesh",
           "mesh_device_type"]

# H100 SXM5 80GB HBM3, 700 W: data-sheet figures (dense), per card
HW = {
    "peak_bf16_flops": 989e12,
    "hbm_bw": 3.35e12,  # bytes/s
    "hbm_bytes": 80e9,
    "nvlink_bw": 450e9,  # bytes/s each way, within a node
    "node_size": 8,  # cards a node
    "ib_bw": 50e9,  # bytes/s each way across nodes: one 400 Gb/s port a card
}


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


def _mesh(shape: tuple, names: tuple, device_type=None):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or mesh_device_type(), tuple(int(d) for d in shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The reference's production mesh over the current process group,
    which must have 256 (``multi_pod=False``) or 512 ranks. ``device_type``
    (default: the backend's, see ``mesh_device_type``) is the device its
    tensors live on; a fake group's trace names it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    world = _world()
    if world != need:
        raise ValueError(f"the production mesh {shape} needs a process group of {need} ranks, "
                         f"this one has {world}")
    return _mesh(shape, axes, device_type)


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
