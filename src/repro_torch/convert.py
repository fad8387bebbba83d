"""Carry data across from the JAX package's numpy arrays.

``vbr_from_arrays(**dataclasses.asdict(v))`` rebuilds a reference VBR ``v``
in the port, and a fixture ``.npz`` carries the same fields. The result has
the same ``structure_hash`` and computes the same product.

``moe_params_from_arrays`` carries the reference's ``moe_init`` params (a
dict of arrays) across, so that both packages compute the same MoE layer.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.vbr import VBR
from .device import resolve_device

__all__ = ["moe_params_from_arrays", "vbr_from_arrays"]


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


def moe_params_from_arrays(params: dict, device=None, dtype=torch.float32) -> dict:
    """The port's MoE params from the reference's ``moe_init`` pytree, as
    numpy arrays (or anything ``np.asarray`` takes, JAX arrays too), in
    ``dtype`` on ``device`` (``None``: the card). Layouts stay the
    reference's: ``router (d, E)``, ``w1``/``w3`` ``(E, d, f)``, ``w2 (E, f, d)``,
    ``sw1``/``sw3`` ``(d, sf)``, ``sw2 (sf, d)``. Values go through float32,
    which holds bfloat16 and float16 exactly."""
    dev = resolve_device(device)
    return {
        name: torch.as_tensor(np.array(a, dtype=np.float32), device=dev).to(dtype)
        for name, a in params.items()
    }
