"""Carry a VBR matrix across from the JAX package's numpy arrays.

``vbr_from_arrays(**dataclasses.asdict(v))`` rebuilds a reference VBR ``v``
in the port, and a fixture ``.npz`` carries the same fields. The result has
the same ``structure_hash`` and computes the same product.
"""
from __future__ import annotations

import numpy as np

from .core.vbr import VBR

__all__ = ["vbr_from_arrays"]


def vbr_from_arrays(shape, rpntr, cpntr, bindx, bpntrb, bpntre, indx, val) -> VBR:
    """The port's ``VBR`` from the reference's arrays (numpy or tensors)."""
    # the hash covers str(shape), so it must be a tuple of Python ints
    shape = tuple(int(s) for s in np.asarray(shape).reshape(-1))
    return VBR(
        shape=shape,
        rpntr=np.asarray(rpntr),
        cpntr=np.asarray(cpntr),
        bindx=np.asarray(bindx),
        bpntrb=np.asarray(bpntrb),
        bpntre=np.asarray(bpntre),
        indx=np.asarray(indx),
        val=np.asarray(val),
    )
