"""Stage-1 backends for the staged loop-nest IR (PyTorch port of
``repro.core.backends``).

Two evaluation strategies over a recorded ``Program``:

  * ``run_reference``      — elementwise NumPy interpretation (oracle),
  * ``match_block_matmul`` — recognizes the canonical dense-block
                             contraction (SpMV / SpMM bodies) and returns a
                             descriptor that ``staging.py`` lowers to
                             slice + matmul or to the CUDA kernels.

The matcher is the Stage-1 'constant folding' of the paper (Listing 2): it
proves that the loop nest is a dense column-major block times a dense
vector/matrix and extracts the constant bounds and value-array offset.
The generic gather/scatter evaluator of the reference (``run_vectorized``)
serves only its ``gather`` staging backend and is ported with it.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

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
# Pattern matcher: dense-block contraction
# ---------------------------------------------------------------------- #
def _loop_nest(stmt, loops):
    """Yield (loops, store) leaves of the nest."""
    if isinstance(stmt, Loop):
        for s in stmt.body:
            yield from _loop_nest(s, loops + [stmt])
    elif isinstance(stmt, Store):
        yield loops, stmt


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
