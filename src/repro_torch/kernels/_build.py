"""Build and load the CUDA kernels of ``csrc/`` at first use.

All sources go to ``torch.utils.cpp_extension.load`` in one call, compiled
for Hopper (``sm_90a``) into ``build/repro_torch_kernels/`` at the root of
the checkout, which ``.gitignore`` lists. ``load`` reuses that build while
the sources are unchanged. The kernels convert between bfloat16 and float
only through the CUDA intrinsics (``__bfloat162float``,
``__float2bfloat16``), so PyTorch's ``-D__CUDA_NO_BFLOAT16_CONVERSIONS__``
family of flags stays on.
"""
from __future__ import annotations

import os
import time
from pathlib import Path

__all__ = ["load_kernels", "build_seconds"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("binding.cpp", "bsr_spmv.cu", "bsr_spmm.cu", "bsr_sdd.cu")
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
_CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-Xptxas=-v"]

_module = None
_build_seconds = None


def load_kernels(verbose: bool = False):
    """The compiled extension (``bsr_spmv``, ``bsr_spmm``, ``bsr_sdd``); builds it once."""
    global _module, _build_seconds
    if _module is None:
        from torch.utils.cpp_extension import load

        os.makedirs(_BUILD_DIR, exist_ok=True)  # load() does not create it
        t0 = time.perf_counter()
        _module = load(
            name="repro_torch_kernels",
            sources=[str(_CSRC / s) for s in _SOURCES],
            build_directory=str(_BUILD_DIR),
            extra_cflags=["-O2"],
            extra_cuda_cflags=_CUDA_FLAGS,
            verbose=verbose,
        )
        _build_seconds = time.perf_counter() - t0
    return _module


def build_seconds():
    """Seconds the first ``load_kernels`` call took in this process, or None."""
    return _build_seconds
