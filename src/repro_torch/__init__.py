"""repro_torch: SABLE (staged blocked evaluation over structured sparse
matrices) in PyTorch, with hand-written CUDA kernels for Hopper.

The port of the JAX package ``repro``, which stays as its reference. Entry
points take ``device=None``, which means the CUDA card; ``device="cpu"``
runs the plain PyTorch versions of the kernels.
"""
from .device import resolve_device

__version__ = "0.1.0"
__all__ = ["resolve_device"]
