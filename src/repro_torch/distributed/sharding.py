"""``ParallelConfig``: a copy of the reference's dataclass
(``repro.distributed.sharding``), whose ``compress_grads`` the train step
reads. The sharding rules over a device mesh (``param_specs``,
``make_shardings`` and the rest) come with the sharding slice."""
from __future__ import annotations

import dataclasses

__all__ = ["ParallelConfig"]


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    fsdp: bool = True
    fsdp_over_pod: bool = False  # ZeRO across pods (DCN) too
    tensor_axis: str = "model"
    dp_axes: tuple = ("pod", "data")
    compress_grads: bool = True  # gradients cast to bfloat16 before the optimizer
    seq_shard_cache: bool = True  # context-parallel KV when heads don't divide
    anchor_scan_params: bool = True  # pin scanned per-layer weight slices to their layout


def no_sharding(what: str) -> None:
    """Raise for an argument that needs the sharding slice."""
    raise NotImplementedError(
        f"{what} is not ported yet; it comes with the sharding slice (torch.distributed)"
    )
