"""Where the port runs.

Every entry point takes ``device=None``, which means the CUDA card: the
port's kernels are CUDA kernels, and the CPU runs only their plain PyTorch
versions, when a caller (a test) asks for ``device="cpu"`` by name. The
``"meta"`` device holds shapes alone (``launch/specs.py``).
"""
from __future__ import annotations

import torch

__all__ = ["on_device", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; raises if there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}: use 'cuda', 'cpu' or 'meta'")
    return dev


def on_device(a, dev: torch.device, dtype=None) -> torch.Tensor:
    """``a`` (numpy array or tensor) as a tensor on ``dev``; a tensor that
    lies on another device raises instead of being copied."""
    if isinstance(a, torch.Tensor) and a.device != dev:
        raise ValueError(f"tensor on {a.device}, expected {dev}")
    return torch.as_tensor(a, dtype=dtype, device=dev)
