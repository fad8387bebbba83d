"""SABLE's staged domain-specific language (paper Section IV-A), PyTorch port.

A plain-Python copy of ``repro.core.dsl``: the port keeps its own so that it
imports nothing of the JAX package.

The user writes a function over *one* block, using:

  * ``RepRange``   — a staged range with bounds known at staging time,
  * ``ArrayVal``   — a symbolic array handle (values deferred to runtime),
  * ``ConcreteArrayVal`` — an array whose values ARE available at staging
                     time (used for the density-check extension, Listing 3),
  * ``loopgen(rng, body)`` — emits a loop over ``rng`` (or unrolls it when
                     ``rng`` is a plain Python ``range``),
  * ``isDense(v)`` — staging-time density check on concrete values.

Executing the user function *records* a small loop-nest IR.  Index
expressions are kept affine (``LinExpr``) so that Stage-1 can constant-fold
bounds and offsets exactly like the paper's generated C (Listing 2), and so
that the pattern matcher in ``backends.py`` can recognize block mat-muls and
lower them onto the block-sparse kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np

__all__ = [
    "RepRange",
    "ArrayVal",
    "ConcreteArrayVal",
    "loopgen",
    "isDense",
    "stage_op",
    "StagingError",
    "LinExpr",
    "Const",
    "Load",
    "BinOp",
    "Store",
    "Loop",
    "Program",
]


class StagingError(Exception):
    """Raised when the op leaves the stageable fragment."""


# ---------------------------------------------------------------------- #
# Index expressions: affine in the loop variables
# ---------------------------------------------------------------------- #
class LinExpr:
    """Affine integer expression: sum(coeff_i * var_i) + const."""

    __slots__ = ("coeffs", "const")

    def __init__(self, coeffs: Optional[dict] = None, const: int = 0):
        self.coeffs: dict[str, int] = dict(coeffs or {})
        self.const = int(const)

    @staticmethod
    def of(x: Union["LinExpr", int]) -> "LinExpr":
        if isinstance(x, LinExpr):
            return x
        if isinstance(x, (int, np.integer)):
            return LinExpr({}, int(x))
        raise StagingError(f"cannot treat {type(x)} as an index expression")

    def is_const(self) -> bool:
        return not any(self.coeffs.values())

    # -- algebra ------------------------------------------------------- #
    def __add__(self, o):
        o = LinExpr.of(o)
        c = dict(self.coeffs)
        for k, v in o.coeffs.items():
            c[k] = c.get(k, 0) + v
        return LinExpr(c, self.const + o.const)

    __radd__ = __add__

    def __neg__(self):
        return LinExpr({k: -v for k, v in self.coeffs.items()}, -self.const)

    def __sub__(self, o):
        return self + (-LinExpr.of(o))

    def __rsub__(self, o):
        return LinExpr.of(o) + (-self)

    def __mul__(self, o):
        if isinstance(o, LinExpr):
            if o.is_const():
                o = o.const
            elif self.is_const():
                return o * self.const
            else:
                raise StagingError("non-affine index expression (var * var)")
        o = int(o)
        return LinExpr({k: v * o for k, v in self.coeffs.items()}, self.const * o)

    __rmul__ = __mul__

    def __repr__(self):
        terms = [f"{v}*{k}" for k, v in self.coeffs.items() if v] + [str(self.const)]
        return " + ".join(terms)

    def subst(self, env: dict[str, int]) -> "LinExpr":
        out = LinExpr({}, self.const)
        for k, v in self.coeffs.items():
            if k in env:
                out.const += v * env[k]
            else:
                out.coeffs[k] = out.coeffs.get(k, 0) + v
        return out


def var(name: str) -> LinExpr:
    return LinExpr({name: 1}, 0)


# ---------------------------------------------------------------------- #
# Value expressions (deferred arithmetic over array loads)
# ---------------------------------------------------------------------- #
class Value:
    def _bin(self, op, other, swap=False):
        other = as_value(other)
        lhs, rhs = (other, self) if swap else (self, other)
        # staging-time constant folding
        if isinstance(lhs, Const) and isinstance(rhs, Const):
            return Const(_PYOPS[op](lhs.v, rhs.v))
        return BinOp(op, lhs, rhs)

    def __mul__(self, o):
        return self._bin("*", o)

    def __rmul__(self, o):
        return self._bin("*", o, swap=True)

    def __add__(self, o):
        return self._bin("+", o)

    def __radd__(self, o):
        return self._bin("+", o, swap=True)

    def __sub__(self, o):
        return self._bin("-", o)

    def __rsub__(self, o):
        return self._bin("-", o, swap=True)

    def __truediv__(self, o):
        return self._bin("/", o)


_PYOPS = {
    "*": lambda a, b: a * b,
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "/": lambda a, b: a / b,
}


@dataclasses.dataclass
class Const(Value):
    v: float


@dataclasses.dataclass
class LinValue(Value):
    """An affine index expression used as a value (e.g. ``r1.start + i``)."""

    expr: LinExpr


@dataclasses.dataclass
class Load(Value):
    array: "ArrayVal"
    index: LinExpr


@dataclasses.dataclass
class BinOp(Value):
    op: str
    lhs: Value
    rhs: Value


def as_value(x) -> Value:
    if isinstance(x, Value):
        return x
    if isinstance(x, LinExpr):
        return Const(x.const) if x.is_const() else LinValue(x)
    if isinstance(x, (int, float, np.integer, np.floating)):
        return Const(float(x))
    raise StagingError(f"cannot stage value of type {type(x)}")


# ---------------------------------------------------------------------- #
# Statements
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class Store:
    array: "ArrayVal"
    index: LinExpr
    value: Value
    accumulate: bool


@dataclasses.dataclass
class Loop:
    varname: str
    start: int
    stop: int
    body: list


Program = list  # list[Store | Loop]

# recording context --------------------------------------------------- #
_STACK: list[list] = []


def _emit(stmt) -> None:
    if not _STACK:
        raise StagingError("DSL statement outside of stage_op()")
    _STACK[-1].append(stmt)


# ---------------------------------------------------------------------- #
# User-facing handles
# ---------------------------------------------------------------------- #
class RepRange:
    """A staged range: bounds are Python ints fixed at staging time.

    ``loopgen`` over a RepRange produces a *loop* in the generated code;
    iterating a plain ``range`` instead unrolls it (Listing 3's extension).
    """

    def __init__(self, start: int, stop: int):
        self.start = int(start)
        self.stop = int(stop)

    def __len__(self):
        return max(0, self.stop - self.start)

    def __repr__(self):
        return f"RepRange({self.start}, {self.stop})"


class ArrayVal:
    """Symbolic array whose *values* are deferred to runtime (Stage 2)."""

    def __init__(self, name: str):
        self.name = name

    def __getitem__(self, idx) -> Load:
        return Load(self, LinExpr.of(idx))

    def __setitem__(self, idx, value) -> None:
        idx = LinExpr.of(idx)
        value = as_value(value)
        # Recognize `a[i] += v`, which Python desugars to
        # `a[i] = a[i] + v`: the rhs is Add(Load(a, i), v).
        if (
            isinstance(value, BinOp)
            and value.op == "+"
            and isinstance(value.lhs, Load)
            and value.lhs.array is self
            and _lin_eq(value.lhs.index, idx)
        ):
            _emit(Store(self, idx, value.rhs, accumulate=True))
        else:
            _emit(Store(self, idx, value, accumulate=False))

    def __repr__(self):
        return f"ArrayVal({self.name})"


class ConcreteArrayVal(ArrayVal):
    """Array whose values are known at staging time.

    Loads with constant indices partially evaluate to constants, enabling
    the paper's ``isDense`` check (Listing 3/4) to elide work for zeros at
    Stage 0.
    """

    def __init__(self, name: str, data: np.ndarray):
        super().__init__(name)
        self.data = np.asarray(data)

    def __getitem__(self, idx):
        idx = LinExpr.of(idx)
        if idx.is_const():
            return Const(float(self.data[idx.const]))
        return Load(self, idx)


def _lin_eq(a: LinExpr, b: LinExpr) -> bool:
    d = a - b
    return d.is_const() and d.const == 0


def isDense(v) -> bool:
    """Staging-time density check (paper Listing 3).

    Only meaningful on values that are concrete at Stage 0; symbolic values
    are by definition 'dense' (we cannot elide them at staging time).
    """
    if isinstance(v, Const):
        return v.v != 0
    return True


def loopgen(rng: Union[RepRange, range], body: Callable) -> None:
    """Generate a loop over ``rng`` with ``body`` applied to the iteration
    variable.  RepRange -> staged loop; plain range -> full unroll."""
    if isinstance(rng, RepRange):
        name = f"v{len(_STACK)}_{id(rng) & 0xFFFF:x}"
        frame: list = []
        _STACK.append(frame)
        try:
            body(var(name))
        finally:
            _STACK.pop()
        loop = Loop(name, rng.start, rng.stop, frame)
        _emit(loop)
        return loop
    if isinstance(rng, range):
        for i in rng:  # Stage-0 unrolling
            body(LinExpr({}, i))
        return None
    raise StagingError(f"loopgen expects RepRange or range, got {type(rng)}")


def stage_op(fn: Callable, *args) -> Program:
    """Run the user's op function, recording its loop-nest IR (Stage 0)."""
    frame: list = []
    _STACK.append(frame)
    try:
        fn(*args)
    finally:
        _STACK.pop()
    return frame
