"""Expression IR for SQL+ML feature queries.

Two expression layers, mirroring OpenMLDB's planner:

* scalar expressions (``Col``, ``Lit``, ``BinOp``, ``Func``, ``Cast``) that
  evaluate row-wise over event columns or over already-computed features, and
* aggregate expressions (``Agg``) that reduce a scalar expression over a
  named window.

Expressions are immutable, hashable dataclasses so that plans can be
fingerprinted for the compiled-plan cache (paper §4 "caching") and compared
structurally by the optimizer's CSE pass.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

__all__ = [
    "AggFunc",
    "Agg",
    "BinOp",
    "Cast",
    "Col",
    "Expr",
    "Func",
    "Lit",
    "WindowSpec",
    "walk",
    "children",
    "replace_children",
    "collect_columns",
    "collect_aggs",
]


class AggFunc(enum.Enum):
    """Window aggregate functions supported by the engine."""

    SUM = "sum"
    COUNT = "count"
    AVG = "avg"
    MIN = "min"
    MAX = "max"
    STD = "std"
    VAR = "var"
    FIRST = "first"   # oldest event in window
    LAST = "last"     # newest event in window

    @property
    def decomposable(self) -> bool:
        """True if expressible via moment aggregates (pre-agg friendly)."""
        return self in (AggFunc.SUM, AggFunc.COUNT, AggFunc.AVG, AggFunc.STD,
                        AggFunc.VAR)

    @property
    def invertible(self) -> bool:
        """True if ``F(t) - F(t-W)`` subtraction applies (paper Eq. 2)."""
        return self in (AggFunc.SUM, AggFunc.COUNT)


@dataclass(frozen=True)
class Expr:
    """Base class for all expressions."""

    def fingerprint(self) -> str:
        return repr(self)


@dataclass(frozen=True)
class Col(Expr):
    name: str

    def __repr__(self) -> str:  # stable fingerprints
        return f"Col({self.name})"


@dataclass(frozen=True)
class Lit(Expr):
    value: float

    def __repr__(self) -> str:
        return f"Lit({self.value!r})"


@dataclass(frozen=True)
class BinOp(Expr):
    op: str  # + - * / // % > >= < <= == != and or
    lhs: Expr
    rhs: Expr

    def __repr__(self) -> str:
        return f"BinOp({self.op},{self.lhs!r},{self.rhs!r})"


@dataclass(frozen=True)
class Func(Expr):
    """Scalar function call: log, log1p, abs, sqrt, exp, neg, min2, max2,
    sigmoid, relu, clip(lo,hi) …"""

    name: str
    args: Tuple[Expr, ...]

    def __repr__(self) -> str:
        return f"Func({self.name},{list(self.args)!r})"


@dataclass(frozen=True)
class Cast(Expr):
    to: str  # "f32" | "i32" | "bool"
    arg: Expr

    def __repr__(self) -> str:
        return f"Cast({self.to},{self.arg!r})"


@dataclass(frozen=True)
class WindowSpec:
    """``WINDOW w AS (PARTITION BY key ORDER BY ts {ROWS|RANGE} BETWEEN
    <n> PRECEDING AND CURRENT ROW)``.

    ``rows_preceding`` — count-based window of the most recent N events.
    ``range_preceding`` — time-based window covering ``[t - range, t]``.
    Exactly one of the two must be set.
    """

    name: str
    partition_by: str
    order_by: str
    rows_preceding: Optional[int] = None
    range_preceding: Optional[float] = None

    def __post_init__(self) -> None:
        if (self.rows_preceding is None) == (self.range_preceding is None):
            raise ValueError(
                f"window {self.name!r}: exactly one of rows_preceding / "
                f"range_preceding must be given")

    @property
    def is_rows(self) -> bool:
        return self.rows_preceding is not None

    def frame_fingerprint(self) -> str:
        """Fingerprint of the frame only (ignores the window's name) —
        used by the window-merge optimizer pass."""
        return (f"W(p={self.partition_by},o={self.order_by},"
                f"rows={self.rows_preceding},range={self.range_preceding})")

    def __repr__(self) -> str:
        return f"{self.frame_fingerprint()}#{self.name}"


@dataclass(frozen=True)
class Agg(Expr):
    """Aggregate of a scalar expression over a named window."""

    func: AggFunc
    arg: Expr                  # Lit(1.0) for COUNT(*)
    window: str                # window name, resolved against the plan's specs

    def __repr__(self) -> str:
        return f"Agg({self.func.value},{self.arg!r},{self.window})"


# ---------------------------------------------------------------------------
# Tree utilities
# ---------------------------------------------------------------------------

def children(e: Expr) -> Tuple[Expr, ...]:
    if isinstance(e, BinOp):
        return (e.lhs, e.rhs)
    if isinstance(e, Func):
        return e.args
    if isinstance(e, Cast):
        return (e.arg,)
    if isinstance(e, Agg):
        return (e.arg,)
    return ()


def replace_children(e: Expr, new: Tuple[Expr, ...]) -> Expr:
    if isinstance(e, BinOp):
        return dataclasses.replace(e, lhs=new[0], rhs=new[1])
    if isinstance(e, Func):
        return dataclasses.replace(e, args=tuple(new))
    if isinstance(e, Cast):
        return dataclasses.replace(e, arg=new[0])
    if isinstance(e, Agg):
        return dataclasses.replace(e, arg=new[0])
    assert not new
    return e


def walk(e: Expr) -> Iterable[Expr]:
    """Pre-order traversal."""
    yield e
    for c in children(e):
        yield from walk(c)


def collect_columns(e: Expr) -> Tuple[str, ...]:
    seen: Dict[str, None] = {}
    for node in walk(e):
        if isinstance(node, Col):
            seen.setdefault(node.name)
    return tuple(seen)


def collect_aggs(e: Expr) -> Tuple[Agg, ...]:
    return tuple(n for n in walk(e) if isinstance(n, Agg))


# ---------------------------------------------------------------------------
# Scalar evaluation over a dict of tensors (row-major, broadcastable)
# ---------------------------------------------------------------------------


def _where0(cond, x):
    """``where(cond, x, 0)`` with the zero on ``x``'s device and dtype."""
    return torch.where(cond, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _as_bool(x):
    return x if x.dtype == torch.bool else x != 0


def _safe_var(sq, s, c):
    cm = torch.clamp(c, min=1.0)
    return _where0(c > 0, torch.clamp(sq / cm - (s / cm) ** 2, min=0.0))


_BINOPS: Dict[str, Callable[[Any, Any], Any]] = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "//": lambda a, b: a // b,
    "%": lambda a, b: a % b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "and": lambda a, b: torch.logical_and(a, b),
    "or": lambda a, b: torch.logical_or(a, b),
}

_FUNCS: Dict[str, Callable[..., Any]] = {
    "log": torch.log,
    "log1p": torch.log1p,
    "abs": torch.abs,
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "neg": lambda x: -x,
    "not": torch.logical_not,
    "min2": torch.minimum,
    "max2": torch.maximum,
    "sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "relu": lambda x: torch.clamp(x, min=0.0),
    "floor": torch.floor,
    "ceil": torch.ceil,
    "clip": lambda x, lo, hi: torch.clamp(x, lo, hi),
    "if": lambda c, a, b: torch.where(_as_bool(c), a, b),   # if(cond, a, b)
    # Aggregate-decomposition helpers (optimizer pass O1): guarded against
    # empty windows (count == 0 -> 0, matching engine empty-window policy).
    "safe_div": lambda a, b: _where0(b > 0, a / torch.clamp(b, min=1e-30)),
    "safe_var": _safe_var,
    "safe_std": lambda sq, s, c: torch.sqrt(_safe_var(sq, s, c)),
}

_CASTS = {"f32": torch.float32, "i32": torch.int32, "bool": torch.bool}


def _env_device(env: Dict[str, Any]) -> torch.device:
    """Device of the environment's tensors: literals are created there so
    every operation sees operands on one device."""
    for v in env.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def eval_scalar(e: Expr, env: Dict[str, Any]):
    """Evaluate a scalar expression against ``env`` (column name -> tensor).

    ``Agg`` nodes must have been replaced with ``Col`` references to
    materialised aggregate outputs before calling this (the physical planner
    guarantees that).
    """
    if isinstance(e, Col):
        if e.name not in env:
            raise KeyError(f"unknown column {e.name!r}; have {sorted(env)}")
        return env[e.name]
    if isinstance(e, Lit):
        return torch.tensor(e.value, dtype=torch.float32,
                            device=_env_device(env))
    if isinstance(e, BinOp):
        fn = _BINOPS.get(e.op)
        if fn is None:
            raise ValueError(f"unknown binop {e.op!r}")
        return fn(eval_scalar(e.lhs, env), eval_scalar(e.rhs, env))
    if isinstance(e, Func):
        fn = _FUNCS.get(e.name)
        if fn is None:
            raise ValueError(f"unknown function {e.name!r}")
        return fn(*(eval_scalar(a, env) for a in e.args))
    if isinstance(e, Cast):
        return eval_scalar(e.arg, env).to(_CASTS[e.to])
    if isinstance(e, Agg):
        raise TypeError("Agg node reached scalar evaluation — physical "
                        "planner must materialise aggregates first")
    raise TypeError(f"unknown expr node {type(e).__name__}")


def scalar_func_names() -> Tuple[str, ...]:
    return tuple(_FUNCS)
