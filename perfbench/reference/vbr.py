"""Plain y = A x over a VBR matrix, block by block.

Reads only the harness's arrays: the structure on the host and the values
on the device. Each stored block is ``h x w`` column-major at its offset;
its product with the rows ``x[c0:c1]`` adds into ``y[r0:r1]``. float32
products run with TF32 off unless ``precision`` asks for TF32 (the
control), whose operands are rounded to TF32 first, so that SpMV, which
has no TF32 product on the card, reads TF32 too.
"""
from __future__ import annotations

import contextlib

import torch

CONTROL = "tf32"  # the next precision down from float32: the control's ``precision``


@contextlib.contextmanager
def matmul_precision(precision: str):
    """``"highest"`` (TF32 off) or ``"tf32"`` for the float32 products
    inside; the previous settings come back after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even: what
    the tensor cores read, for a device that has no TF32 of its own."""
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


def multiply(m, val: torch.Tensor, x: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """y = A x for the matrix ``m`` (structure) with values ``val``; ``x``
    is (cols,) or (cols, n). float32 in and out."""
    val, x = val.float(), x.float()
    if precision == "tf32":  # rounded here too: a matrix-vector product has no TF32 path
        val, x = round_tf32(val), round_tf32(x)
    y = torch.zeros((m.shape[0],) + tuple(x.shape[1:]), dtype=torch.float32, device=x.device)
    with matmul_precision(precision):
        blk = 0
        for a in range(len(m.rpntr) - 1):
            if m.bpntrb[a] < 0:
                continue
            r0, r1 = int(m.rpntr[a]), int(m.rpntr[a + 1])
            for bi in range(int(m.bpntrb[a]), int(m.bpntre[a])):
                b = int(m.bindx[bi])
                c0, c1 = int(m.cpntr[b]), int(m.cpntr[b + 1])
                off = int(m.indx[blk])
                a_blk = val[off:off + (r1 - r0) * (c1 - c0)].view(c1 - c0, r1 - r0).T
                y[r0:r1] += a_blk @ x[c0:c1]
                blk += 1
    return y


def rel_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    """max |y - ref| over max |ref|."""
    return float((y.float() - ref).abs().max() / ref.abs().max().clamp(min=1e-30))
