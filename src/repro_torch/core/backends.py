"""Stage-1 backends for the staged loop-nest IR (PyTorch port of
``repro.core.backends``).

Three evaluation strategies over a recorded ``Program``:

  * ``run_reference``      — elementwise NumPy interpretation (oracle),
  * ``run_vectorized``     — generic gather/scatter-add PyTorch evaluation
                             of any op in the DSL fragment (``vectorize``
                             builds its index tensors once, for staging),
  * ``match_block_matmul`` — recognizes the canonical dense-block
                             contraction (SpMV / SpMM bodies) and returns a
                             descriptor that ``staging.py`` lowers to
                             slice + matmul or to the CUDA kernels.

The matcher is the Stage-1 'constant folding' of the paper (Listing 2): it
proves that the loop nest is a dense column-major block times a dense
vector/matrix and extracts the constant bounds and value-array offset.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional

import numpy as np
import torch

from .dsl import (
    BinOp,
    Const,
    LinExpr,
    LinValue,
    Load,
    Loop,
    Program,
    StagingError,
    Store,
    Value,
)

__all__ = [
    "run_reference",
    "run_vectorized",
    "vectorize",
    "match_block_matmul",
    "BlockMatmul",
]


# ---------------------------------------------------------------------- #
# Reference interpreter (oracle)
# ---------------------------------------------------------------------- #
def _eval_value_scalar(v: Value, ivars: dict, env: dict):
    if isinstance(v, Const):
        return v.v
    if isinstance(v, LinValue):
        e = v.expr.subst(ivars)
        if not e.is_const():
            raise StagingError("unbound loop var in value")
        return e.const
    if isinstance(v, Load):
        idx = v.index.subst(ivars)
        if not idx.is_const():
            raise StagingError("unbound loop var in load index")
        return env[v.array.name][idx.const]
    if isinstance(v, BinOp):
        a = _eval_value_scalar(v.lhs, ivars, env)
        b = _eval_value_scalar(v.rhs, ivars, env)
        return {"*": a * b, "+": a + b, "-": a - b, "/": a / b if v.op == "/" else None}[
            v.op
        ] if v.op in "*+-/" else None
    raise StagingError(f"cannot interpret {v}")


def _run_stmt_ref(stmt, ivars: dict, env: dict) -> None:
    if isinstance(stmt, Loop):
        for i in range(stmt.start, stmt.stop):
            ivars[stmt.varname] = i
            for s in stmt.body:
                _run_stmt_ref(s, ivars, env)
        ivars.pop(stmt.varname, None)
    elif isinstance(stmt, Store):
        idx = stmt.index.subst(ivars)
        if not idx.is_const():
            raise StagingError("unbound loop var in store index")
        val = _eval_value_scalar(stmt.value, ivars, env)
        if stmt.accumulate:
            env[stmt.array.name][idx.const] += val
        else:
            env[stmt.array.name][idx.const] = val
    else:
        raise StagingError(f"unknown stmt {stmt}")


def run_reference(program: Program, env: dict) -> None:
    """Interpret the program elementwise over NumPy arrays (in place)."""
    for stmt in program:
        _run_stmt_ref(stmt, {}, env)


# ---------------------------------------------------------------------- #
# Generic vectorized PyTorch evaluation (gather / scatter-add)
# ---------------------------------------------------------------------- #
def _loop_nest(stmt, loops):
    """Yield (loops, store) leaves of the nest."""
    if isinstance(stmt, Loop):
        for s in stmt.body:
            yield from _loop_nest(s, loops + [stmt])
    elif isinstance(stmt, Store):
        yield loops, stmt


def _eval_lin_grid(e: LinExpr, grids: dict):
    """The affine expression over the nest's broadcast index grids: an int,
    or an int64 numpy array of size 1 on the loop axes it does not use."""
    out = e.const
    for k, c in e.coeffs.items():
        if c:
            out = out + c * grids[k]
    return out


_OPS = {
    "*": lambda a, b: a * b,
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "/": lambda a, b: a / b,
}


def _lower_value(v: Value, grids: dict, dev):
    """``(shape, eval(env))``: the value over the index grids, its indices
    built now as tensors on ``dev``; loads become gathers at evaluation."""
    if isinstance(v, Const):
        c = v.v
        return (), lambda env: c
    if isinstance(v, LinValue):
        g = _eval_lin_grid(v.expr, grids)
        t = torch.as_tensor(g, dtype=torch.int64, device=dev)
        return np.shape(g), lambda env: t
    if isinstance(v, Load):
        g = _eval_lin_grid(v.index, grids)
        idx = torch.as_tensor(g, dtype=torch.int64, device=dev)
        name = v.array.name
        return np.shape(g), lambda env: env[name][idx]
    if isinstance(v, BinOp) and v.op in _OPS:
        sa, a = _lower_value(v.lhs, grids, dev)
        sb, b = _lower_value(v.rhs, grids, dev)
        op = _OPS[v.op]
        return np.broadcast_shapes(sa, sb), lambda env: op(a(env), b(env))
    raise StagingError(f"cannot vectorize {v}")


def _lower_store(loops, store: Store, dev) -> Callable[[dict], None]:
    """One leaf of the nest as an in-place update of ``env[store.array]``.

    The store's index grid stays unbroadcast. Over the loop axes that the
    index does not use, an accumulating store adds every value into one
    slot, so the values are summed over those axes first (what a
    scatter-add of the broadcast grid computes); a plain store keeps the
    last value along them, as the loop run in order would."""
    nd = len(loops)
    grids = {}
    for ax, lp in enumerate(loops):
        shape = [1] * nd
        shape[ax] = lp.stop - lp.start
        grids[lp.varname] = np.arange(lp.start, lp.stop, dtype=np.int64).reshape(shape)
    vshape, value = _lower_value(store.value, grids, dev)
    vshape = (1,) * (nd - len(vshape)) + tuple(vshape)
    g = np.asarray(_eval_lin_grid(store.index, grids), dtype=np.int64)
    g = g.reshape((1,) * (nd - g.ndim) + g.shape)
    shape = np.broadcast_shapes(vshape, g.shape)
    fold = tuple(ax for ax in range(nd) if g.shape[ax] == 1 and shape[ax] > 1)
    folded = tuple(1 if ax in fold else n for ax, n in enumerate(shape))
    idx = torch.as_tensor(np.array(np.broadcast_to(g, folded)).reshape(-1), device=dev)
    name, accumulate = store.array.name, store.accumulate

    def run(env: dict) -> None:
        target = env[name]
        val = torch.as_tensor(value(env), device=target.device).to(target.dtype)
        val = val.reshape((1,) * (nd - val.dim()) + tuple(val.shape)).expand(shape)
        for ax in fold:
            val = (val.sum(ax, keepdim=True) if accumulate
                   else val.narrow(ax, shape[ax] - 1, 1))
        target.index_put_((idx,), val.expand(folded).reshape(-1), accumulate=accumulate)

    return run


def vectorize(program: Program, device=None) -> Callable[[dict], None]:
    """Lower ``program`` once: every index grid becomes an int64 tensor on
    ``device``, so that evaluating it is gathers, arithmetic and one
    ``index_put_`` a leaf of the nest. The returned ``run(env)`` updates
    the stored-to tensors of ``env`` in place, leaf after leaf."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    leaves = [_lower_store(loops, store, dev)
              for top in program for loops, store in _loop_nest(top, [])]

    def run(env: dict) -> None:
        for leaf in leaves:
            leaf(env)

    return run


def run_vectorized(program: Program, env: dict) -> dict:
    """Evaluate the program with one broadcasted index grid per loop nest.

    Returns the updated environment (functional: the tensors of ``env``
    are not written; a stored-to array is copied once). Loads become
    gathers, accumulating stores ``index_put_(accumulate=True)``
    scatter-adds (duplicate indices sum, matching sequential semantics for
    '+='), plain stores ``index_put_``; index tensors are int64 on the
    target's device.
    """
    env = {k: torch.as_tensor(a) for k, a in env.items()}
    stored = {store.array.name for top in program for _, store in _loop_nest(top, [])}
    for name in stored:
        env[name] = env[name].clone()
    devices = {env[name].device for name in stored}
    vectorize(program, next(iter(devices), None))(env)
    return env


# ---------------------------------------------------------------------- #
# Pattern matcher: dense-block contraction
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class BlockMatmul:
    """Stage-1 descriptor of ``y[rows] += A_block @ x[cols]``.

    A_block is the column-major dense block ``val[val_off : val_off+h*w]``
    of shape (h, w) reshaped from (w, h) storage.  For SpMM, ``n_cols`` is
    the dense right-hand matrix width (paper's col_width, e.g. 512) and x/y
    are row-major (rows x n_cols); for SpMV ``n_cols`` is None.
    """

    row_start: int
    row_end: int
    col_start: int
    col_end: int
    val_off: int
    n_cols: Optional[int]  # None => SpMV
    y_name: str = "y"
    x_name: str = "x"
    a_name: str = "val"

    @property
    def h(self) -> int:
        return self.row_end - self.row_start

    @property
    def w(self) -> int:
        return self.col_end - self.col_start


def _single_store(program: Program):
    """The canonical ops are one perfect nest with a single accumulate."""
    leaves = []
    for top in program:
        leaves.extend(_loop_nest(top, []))
    if len(leaves) != 1:
        return None
    loops, store = leaves[0]
    if not store.accumulate:
        return None
    return loops, store


def _as_mul_of_loads(v: Value):
    if isinstance(v, BinOp) and v.op == "*":
        if isinstance(v.lhs, Load) and isinstance(v.rhs, Load):
            return v.lhs, v.rhs
    return None


def match_block_matmul(program: Program) -> Optional[BlockMatmul]:
    """Recognize the SpMV / SpMM bodies of Section IV-B/C and extract the
    constant bounds/offsets (the paper's Listing 2 specialization)."""
    leaf = _single_store(program)
    if leaf is None:
        return None
    loops, store = leaf
    if len(loops) not in (2, 3):
        return None
    pair = _as_mul_of_loads(store.value)
    if pair is None:
        return None
    bounds = {lp.varname: (lp.start, lp.stop) for lp in loops}

    # try both operand orders: one load is the block (A), the other is x
    for a_load, x_load in (pair, pair[::-1]):
        m = _try_match(loops, bounds, store, a_load, x_load)
        if m is not None:
            return m
    return None


def _coeffs(e: LinExpr, names):
    return {n: e.coeffs.get(n, 0) for n in names}


def _try_match(loops, bounds, store, a_load, x_load) -> Optional[BlockMatmul]:
    names = [lp.varname for lp in loops]
    a_c = _coeffs(a_load.index, names)
    x_c = _coeffs(x_load.index, names)
    y_c = _coeffs(store.index, names)

    if len(loops) == 2:
        # SpMV: find i (row var: appears in y and A with coeff 1) and
        # j (col var: appears in x with coeff 1 and A with coeff h).
        for i, j in itertools.permutations(names, 2):
            h = bounds[i][1] - bounds[i][0]
            if (
                y_c[i] == 1 and y_c[j] == 0
                and x_c[j] == 1 and x_c[i] == 0
                and a_c[i] == 1 and a_c[j] == h
            ):
                i0, i1 = bounds[i]
                j0, j1 = bounds[j]
                # A index = (j-j0)*h + (i-i0) + off  (column-major block)
                off = a_load.index.const + j0 * h + i0
                row0 = i0 + store.index.const
                col0 = j0 + x_load.index.const
                return BlockMatmul(
                    row_start=row0,
                    row_end=row0 + (i1 - i0),
                    col_start=col0,
                    col_end=col0 + (j1 - j0),
                    val_off=off,
                    n_cols=None,
                    y_name=store.array.name,
                    x_name=x_load.array.name,
                    a_name=a_load.array.name,
                )
        return None

    # SpMM: vars i (rows of y), k (cols of block / rows of x), j (dense cols)
    for i, k, j in itertools.permutations(names, 3):
        h = bounds[i][1] - bounds[i][0]
        j0, j1 = bounds[j]
        cw = j1 - j0  # dense column width must span the full row (j0 == 0)
        if j0 != 0 or cw <= 0:
            continue
        if (
            y_c[j] == 1 and y_c[i] == cw and y_c[k] == 0
            and x_c[j] == 1 and x_c[k] == cw and x_c[i] == 0
            and a_c[i] == 1 and a_c[k] == h and a_c[j] == 0
        ):
            i0, i1 = bounds[i]
            k0, k1 = bounds[k]
            off = a_load.index.const + k0 * h + i0
            # constant parts of y/x indices encode row offsets * cw
            if store.index.const % cw or x_load.index.const % cw:
                continue
            row0 = i0 + store.index.const // cw
            col0 = k0 + x_load.index.const // cw
            return BlockMatmul(
                row_start=row0,
                row_end=row0 + (i1 - i0),
                col_start=col0,
                col_end=col0 + (k1 - k0),
                val_off=off,
                n_cols=cw,
                y_name=store.array.name,
                x_name=x_load.array.name,
                a_name=a_load.array.name,
            )
    return None
