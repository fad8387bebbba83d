"""Carry data across from the JAX package's numpy arrays.

``vbr_from_arrays(**dataclasses.asdict(v))`` rebuilds a reference VBR ``v``
in the port, and a fixture ``.npz`` carries the same fields. The result has
the same ``structure_hash`` and computes the same product.

``params_from_arrays`` carries a params tree across leaf for leaf: the
reference's ``moe_init`` or ``mamba_init`` dict, so that both packages
compute the same layer, or its whole ``init_params`` tree (nested dicts and
lists, stacked ``(repeat, ...)`` group leaves, SABLE tiles ``(repeat, nt,
tm, tk)``), so that both packages compute the same model. It is generic:
every leaf crosses under its own key, whatever the layer kind.

``opt_state_from_arrays`` carries the reference's AdamW state across
(``adamw_init``/``adamw_update``'s ``{"mu", "nu", "count"}``) dtype by
dtype: each moment in its own dtype (float32, or bfloat16 under
``state_dtype``), ``count`` an int32 0-d tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.vbr import VBR
from .device import resolve_device

__all__ = ["opt_state_from_arrays", "params_from_arrays", "vbr_from_arrays"]


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


def params_from_arrays(tree, device=None, dtype=torch.float32):
    """The port's params from the reference's ``init_params`` or
    ``moe_init`` tree (dicts and lists of numpy or JAX arrays, or anything
    ``np.asarray`` takes), leaf for leaf in the same layout, in ``dtype`` on
    ``device`` (``None``: the card). MoE layouts: ``router (d, E)``,
    ``w1``/``w3`` ``(E, d, f)``, ``w2 (E, f, d)``, ``sw1``/``sw3`` ``(d, sf)``,
    ``sw2 (sf, d)``; Mamba-2: ``in_z``/``in_x`` ``(d, di)``, ``in_b``/``in_c``
    ``(d, G*N)``, ``in_dt (d, H)``, ``conv_w (d_conv, ch)``, ``conv_b (ch,)``,
    ``A_log``/``D``/``dt_bias`` ``(H,)``, ``norm (di,)``, ``out_proj (di,
    d)``. Values go through float32, which holds bfloat16 and float16
    exactly."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return torch.as_tensor(np.array(t, dtype=np.float32), device=dev).to(dtype)

    return conv(tree)


def _leaf_dtype(a) -> torch.dtype:
    """The torch dtype of a numpy or JAX array, by its name."""
    name = np.asarray(a).dtype.name
    if not hasattr(torch, name):
        raise TypeError(f"no torch dtype for {name!r}")
    return getattr(torch, name)


def opt_state_from_arrays(state, device=None) -> dict:
    """The port's AdamW state from the reference's ``{"mu", "nu",
    "count"}`` tree, each leaf in its own dtype on ``device``."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        dtype = _leaf_dtype(t)
        if dtype.is_floating_point:  # through float32, which holds bfloat16 exactly
            return torch.as_tensor(np.array(t, dtype=np.float32), device=dev).to(dtype)
        return torch.as_tensor(np.array(t), device=dev)

    return {"mu": conv(state["mu"]), "nu": conv(state["nu"]),
            "count": conv(state["count"]).to(torch.int32)}
