"""Query front-ends: a Python builder DSL and a SQL-text parser.

Both produce :class:`repro.core.logical.Query`. The SQL dialect is the
OpenMLDB feature-query subset the paper exercises::

    SELECT user_id,
           SUM(amount)   OVER w  AS amt_sum,
           AVG(amount)   OVER w  AS amt_avg,
           COUNT(*)      OVER w2 AS n_recent,
           merchants.risk        AS m_risk,
           PREDICT(fraud_model, amt_sum, amt_avg, n_recent, m_risk) AS score
    FROM events
    LAST JOIN merchants ORDER BY mts ON merchant
    WHERE amount >= 0
    WINDOW w  AS (PARTITION BY user_id ORDER BY ts
                  ROWS BETWEEN 100 PRECEDING AND CURRENT ROW),
           w2 AS (PARTITION BY user_id ORDER BY ts
                  RANGE BETWEEN 3600 PRECEDING AND CURRENT ROW)

``LAST JOIN`` is the relational tier's point-in-time enrichment
(DESIGN.md §8): the latest right-table row with ORDER-BY-timestamp ≤ the
request timestamp, probed through the right table's declared join key.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

from repro_torch.core import expr as E
from repro_torch.core.logical import Join, Predict, Query

__all__ = ["Ex", "col", "lit", "tbl", "TableRef", "sum_", "count_", "avg_",
           "min_", "max_", "std_", "var_", "first_", "last_",
           "QueryBuilder", "parse_sql", "strip_explain_analyze"]


# ---------------------------------------------------------------------------
# Builder DSL
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Ex:
    """Operator-overloading wrapper around an Expr node."""

    node: E.Expr

    def _bin(self, op: str, other: "ExLike") -> "Ex":
        return Ex(E.BinOp(op, self.node, _unwrap(other)))

    def _rbin(self, op: str, other: "ExLike") -> "Ex":
        return Ex(E.BinOp(op, _unwrap(other), self.node))

    __add__ = lambda s, o: s._bin("+", o)
    __radd__ = lambda s, o: s._rbin("+", o)
    __sub__ = lambda s, o: s._bin("-", o)
    __rsub__ = lambda s, o: s._rbin("-", o)
    __mul__ = lambda s, o: s._bin("*", o)
    __rmul__ = lambda s, o: s._rbin("*", o)
    __truediv__ = lambda s, o: s._bin("/", o)
    __rtruediv__ = lambda s, o: s._rbin("/", o)
    __gt__ = lambda s, o: s._bin(">", o)
    __ge__ = lambda s, o: s._bin(">=", o)
    __lt__ = lambda s, o: s._bin("<", o)
    __le__ = lambda s, o: s._bin("<=", o)

    def eq(self, o: "ExLike") -> "Ex":
        return self._bin("==", o)

    def ne(self, o: "ExLike") -> "Ex":
        return self._bin("!=", o)

    def and_(self, o: "ExLike") -> "Ex":
        return self._bin("and", o)

    def or_(self, o: "ExLike") -> "Ex":
        return self._bin("or", o)

    def log1p(self) -> "Ex":
        return Ex(E.Func("log1p", (self.node,)))

    def abs(self) -> "Ex":
        return Ex(E.Func("abs", (self.node,)))

    def over(self, window: str) -> "Ex":
        """Attach a window to a pending aggregate (see ``sum_`` etc.)."""
        n = self.node
        if not (isinstance(n, E.Agg) and n.window == _PENDING_WINDOW):
            raise TypeError(".over() applies to aggregate expressions only")
        return Ex(E.Agg(n.func, n.arg, window))


ExLike = Union[Ex, E.Expr, float, int]


def _unwrap(x: ExLike) -> E.Expr:
    if isinstance(x, Ex):
        return x.node
    if isinstance(x, E.Expr):
        return x
    return E.Lit(float(x))


def col(name: str) -> Ex:
    return Ex(E.Col(name))


class TableRef:
    """``t.col`` disambiguation for joined tables.

    ``tbl("merchants").rating`` (or ``tbl("merchants")["rating"]``) builds
    a qualified column reference ``Col("merchants.rating")`` — required
    when an unqualified name is ambiguous across the main table and the
    LAST JOINed tables, handy always.
    """

    __slots__ = ("_name",)

    def __init__(self, name: str):
        object.__setattr__(self, "_name", name)

    def __getattr__(self, column: str) -> Ex:
        if column.startswith("_"):
            raise AttributeError(column)
        return Ex(E.Col(f"{self._name}.{column}"))

    def __getitem__(self, column: str) -> Ex:
        return Ex(E.Col(f"{self._name}.{column}"))

    def __repr__(self) -> str:
        return f"TableRef({self._name!r})"


def tbl(name: str) -> TableRef:
    return TableRef(name)


def lit(v: float) -> Ex:
    return Ex(E.Lit(float(v)))


_PENDING_WINDOW = "<pending>"


def _agg(func: E.AggFunc, arg: ExLike) -> Ex:
    return Ex(E.Agg(func, _unwrap(arg), _PENDING_WINDOW))


def sum_(arg: ExLike) -> Ex:
    return _agg(E.AggFunc.SUM, arg)


def count_(arg: ExLike = 1.0) -> Ex:
    return _agg(E.AggFunc.COUNT, arg)


def avg_(arg: ExLike) -> Ex:
    return _agg(E.AggFunc.AVG, arg)


def min_(arg: ExLike) -> Ex:
    return _agg(E.AggFunc.MIN, arg)


def max_(arg: ExLike) -> Ex:
    return _agg(E.AggFunc.MAX, arg)


def std_(arg: ExLike) -> Ex:
    return _agg(E.AggFunc.STD, arg)


def var_(arg: ExLike) -> Ex:
    return _agg(E.AggFunc.VAR, arg)


def first_(arg: ExLike) -> Ex:
    return _agg(E.AggFunc.FIRST, arg)


def last_(arg: ExLike) -> Ex:
    return _agg(E.AggFunc.LAST, arg)


class QueryBuilder:
    """Fluent builder producing a :class:`Query`."""

    def __init__(self, table: str):
        self._table = table
        self._outputs: List[Tuple[str, E.Expr]] = []
        self._windows: List[Tuple[str, E.WindowSpec]] = []
        self._where: Optional[E.Expr] = None
        self._predict: Optional[Predict] = None
        self._joins: List[Join] = []

    def last_join(self, table: str, *, on: str,
                  order_by: Optional[str] = None) -> "QueryBuilder":
        """Point-in-time LAST JOIN against ``table``.

        ``on`` names the main-table column holding ``table``'s keys (a
        declared join key of the right table); ``order_by`` is the right
        table's timestamp column — mandatory, because LAST JOIN selects
        the latest right row with that timestamp <= the request time.
        Reference joined columns as ``tbl(table).column``.
        """
        self._joins.append(Join(table=table, on=on, order_by=order_by))
        return self

    def window(self, name: str, *, partition_by: str, order_by: str,
               rows: Optional[int] = None,
               range_: Optional[float] = None) -> "QueryBuilder":
        self._windows.append((name, E.WindowSpec(
            name=name, partition_by=partition_by, order_by=order_by,
            rows_preceding=rows, range_preceding=range_)))
        return self

    def select(self, **named: ExLike) -> "QueryBuilder":
        for name, ex in named.items():
            self._outputs.append((name, _unwrap(ex)))
        return self

    def where(self, pred: ExLike) -> "QueryBuilder":
        self._where = _unwrap(pred)
        return self

    def predict(self, model: str, features: Sequence[str],
                output: str = "prediction") -> "QueryBuilder":
        self._predict = Predict(model, tuple(features), output)
        return self

    def build(self) -> Query:
        return Query(table=self._table, outputs=tuple(self._outputs),
                     windows=tuple(self._windows), where=self._where,
                     predict=self._predict, joins=tuple(self._joins))


# ---------------------------------------------------------------------------
# SQL parser (tokenizer + recursive descent)
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d*|\.\d+|\d+)
  | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><=|>=|!=|<>|==|[-+*/%(),.<>=])
""", re.VERBOSE)

# NOTE: "last" is deliberately NOT a keyword (LAST(x) OVER w is an
# aggregate call); the LAST JOIN clause is detected as the identifier
# "last" followed by the keyword "join".
_KEYWORDS = {
    "select", "from", "where", "window", "as", "partition", "by", "order",
    "rows", "range", "between", "preceding", "and", "current", "row", "or",
    "not", "over", "predict", "join", "on",
}

_AGG_NAMES = {
    "sum": E.AggFunc.SUM, "count": E.AggFunc.COUNT, "avg": E.AggFunc.AVG,
    "min": E.AggFunc.MIN, "max": E.AggFunc.MAX, "std": E.AggFunc.STD,
    "stddev": E.AggFunc.STD, "var": E.AggFunc.VAR, "variance": E.AggFunc.VAR,
    "first": E.AggFunc.FIRST, "last": E.AggFunc.LAST,
    "first_value": E.AggFunc.FIRST, "last_value": E.AggFunc.LAST,
}


@dataclass
class _Tok:
    kind: str   # "num" | "id" | "op" | "kw" | "eof"
    text: str
    pos: int


def _tokenize(sql: str) -> List[_Tok]:
    toks: List[_Tok] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SyntaxError(f"SQL tokenize error at {pos}: {sql[pos:pos+20]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        text = m.group()
        kind = m.lastgroup or "op"
        if kind == "id" and text.lower() in _KEYWORDS:
            toks.append(_Tok("kw", text.lower(), m.start()))
        else:
            toks.append(_Tok(kind, text, m.start()))
    toks.append(_Tok("eof", "", len(sql)))
    return toks


class _Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = _tokenize(sql)
        self.i = 0
        self._anon = 0

    # -- token helpers -----------------------------------------------------
    def peek(self, ahead: int = 0) -> _Tok:
        j = self.i + ahead
        return self.toks[j] if j < len(self.toks) else self.toks[-1]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, text: Optional[str] = None) -> Optional[_Tok]:
        t = self.peek()
        if t.kind == kind and (text is None or t.text == text):
            return self.next()
        return None

    def expect(self, kind: str, text: Optional[str] = None) -> _Tok:
        t = self.accept(kind, text)
        if t is None:
            got = self.peek()
            raise SyntaxError(
                f"expected {text or kind} at char {got.pos}, got "
                f"{got.text!r} in {self.sql!r}")
        return t

    # -- grammar -----------------------------------------------------------
    def parse(self) -> Query:
        self.expect("kw", "select")
        outputs: List[Tuple[str, E.Expr]] = []
        predicts: List[Tuple[str, List[E.Expr], str]] = []
        while True:
            item, name = self._select_item()
            if isinstance(item, tuple):            # pending PREDICT
                model, args, out = item
                predicts.append((model, args, name or out))
            else:
                outputs.append((name or self._anon_name(), item))
            if not self.accept("op", ","):
                break
        self.expect("kw", "from")
        table = self.expect("id").text
        joins: List[Join] = []
        while (self.peek().kind == "id" and self.peek().text.lower() == "last"
               and self.peek(1).kind == "kw" and self.peek(1).text == "join"):
            joins.append(self._last_join())
        where = None
        if self.accept("kw", "where"):
            where = self._expr()
        windows: List[Tuple[str, E.WindowSpec]] = []
        if self.accept("kw", "window"):
            while True:
                windows.append(self._window_def())
                if not self.accept("op", ","):
                    break
        self.expect("eof")
        if len(predicts) > 1:
            raise SyntaxError("at most one PREDICT per query")
        predict = None
        if predicts:
            # resolve PREDICT args against the FULL select list so alias
            # references work regardless of their position; expression
            # (or raw request-column) args materialise as hidden outputs
            model, args, out = predicts[0]
            aliases = dict(outputs)
            feats: List[str] = []
            for e in args:
                if isinstance(e, E.Col) and e.name in aliases:
                    feats.append(e.name)
                else:
                    synth = f"__pred_arg{len(outputs)}"
                    outputs.append((synth, _sub_aliases(e, aliases)))
                    feats.append(synth)
            predict = Predict(model, tuple(feats), out)
        return Query(table=table, outputs=tuple(outputs),
                     windows=tuple(windows), where=where,
                     predict=predict, joins=tuple(joins))

    def _anon_name(self) -> str:
        self._anon += 1
        return f"_col{self._anon}"

    def _colname(self, strip_table: Optional[str] = None) -> str:
        """Possibly-qualified column name ``id[.id]``. When the qualifier
        equals ``strip_table`` it is dropped (``m.ts`` in a join clause of
        table ``m`` names its own ``ts`` column)."""
        name = self.expect("id").text
        if self.accept("op", "."):
            field = self.expect("id").text
            if strip_table is not None and name == strip_table:
                return field
            return f"{name}.{field}"
        return name

    def _last_join(self) -> Join:
        """``LAST JOIN <table> [ORDER BY <ts_col>] ON <key> [ORDER BY ...]``

        ORDER BY is accepted on either side of ON (OpenMLDB writes it
        before); it is mandatory for point-in-time semantics, but the
        missing-order_by error is raised by ``logical.validate`` so SQL
        and builder queries share one actionable message.
        """
        self.next()                       # "last" (id)
        self.expect("kw", "join")
        jtable = self.expect("id").text

        def order_clause() -> Optional[str]:
            if self.accept("kw", "order"):
                self.expect("kw", "by")
                return self._colname(strip_table=jtable)
            return None

        order_by = order_clause()
        self.expect("kw", "on")
        on = self._colname(strip_table=jtable)
        if order_by is None:
            order_by = order_clause()
        return Join(table=jtable, on=on, order_by=order_by)

    def _select_item(self):
        if self.peek().kind == "kw" and self.peek().text == "predict":
            self.next()
            self.expect("op", "(")
            model = self.expect("id").text
            args: List[E.Expr] = []
            while self.accept("op", ","):
                args.append(self._expr())
            self.expect("op", ")")
            name = None
            if self.accept("kw", "as"):
                name = self.expect("id").text
            # pending: args resolve in parse() once every alias is known
            return (model, args, name or "prediction"), name
        e = self._expr()
        name = None
        if self.accept("kw", "as"):
            name = self.expect("id").text
        elif isinstance(e, E.Col):
            name = e.name
        return e, name

    def _window_def(self) -> Tuple[str, E.WindowSpec]:
        name = self.expect("id").text
        self.expect("kw", "as")
        self.expect("op", "(")
        self.expect("kw", "partition")
        self.expect("kw", "by")
        part = self._colname()
        self.expect("kw", "order")
        self.expect("kw", "by")
        order = self._colname()
        rows = rng = None
        if self.accept("kw", "rows"):
            rows = int(self._frame_bound())
        elif self.accept("kw", "range"):
            rng = float(self._frame_bound())
        else:
            raise SyntaxError(f"window {name}: expected ROWS or RANGE")
        self.expect("op", ")")
        return name, E.WindowSpec(name=name, partition_by=part,
                                  order_by=order, rows_preceding=rows,
                                  range_preceding=rng)

    def _frame_bound(self) -> float:
        self.expect("kw", "between")
        n = float(self.expect("num").text)
        self.expect("kw", "preceding")
        self.expect("kw", "and")
        self.expect("kw", "current")
        self.expect("kw", "row")
        return n

    # expression precedence: or < and < not < cmp < addsub < muldiv < unary
    def _expr(self) -> E.Expr:
        return self._or()

    def _or(self) -> E.Expr:
        e = self._and()
        while self.accept("kw", "or"):
            e = E.BinOp("or", e, self._and())
        return e

    def _and(self) -> E.Expr:
        e = self._not()
        while self.accept("kw", "and"):
            e = E.BinOp("and", e, self._not())
        return e

    def _not(self) -> E.Expr:
        if self.accept("kw", "not"):
            return E.Func("not", (self._not(),))
        return self._cmp()

    def _cmp(self) -> E.Expr:
        e = self._addsub()
        t = self.peek()
        if t.kind == "op" and t.text in (">", ">=", "<", "<=", "=", "==",
                                         "!=", "<>"):
            self.next()
            op = {"=": "==", "<>": "!="}.get(t.text, t.text)
            return E.BinOp(op, e, self._addsub())
        return e

    def _addsub(self) -> E.Expr:
        e = self._muldiv()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in ("+", "-"):
                self.next()
                e = E.BinOp(t.text, e, self._muldiv())
            else:
                return e

    def _muldiv(self) -> E.Expr:
        e = self._unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in ("*", "/", "%"):
                self.next()
                e = E.BinOp(t.text, e, self._unary())
            else:
                return e

    def _unary(self) -> E.Expr:
        if self.accept("op", "-"):
            return E.Func("neg", (self._unary(),))
        return self._atom()

    def _atom(self) -> E.Expr:
        if self.accept("op", "("):
            e = self._expr()
            self.expect("op", ")")
            return e
        t = self.peek()
        if t.kind == "num":
            self.next()
            return E.Lit(float(t.text))
        if t.kind == "id":
            self.next()
            low = t.text.lower()
            if self.peek().kind == "op" and self.peek().text == "(":
                return self._call(low)
            if (self.peek().kind == "op" and self.peek().text == "."
                    and self.peek(1).kind == "id"):
                self.next()                      # "." — qualified t.col ref
                return E.Col(f"{t.text}.{self.next().text}")
            return E.Col(t.text)
        raise SyntaxError(f"unexpected token {t.text!r} at char {t.pos}")

    def _call(self, fname: str) -> E.Expr:
        self.expect("op", "(")
        args: List[E.Expr] = []
        if not (self.peek().kind == "op" and self.peek().text == ")"):
            if fname == "count" and self.accept("op", "*"):
                args.append(E.Lit(1.0))
            else:
                args.append(self._expr())
                while self.accept("op", ","):
                    args.append(self._expr())
        self.expect("op", ")")
        if fname in _AGG_NAMES:
            self.expect("kw", "over")
            win = self.expect("id").text
            arg = args[0] if args else E.Lit(1.0)
            return E.Agg(_AGG_NAMES[fname], arg, win)
        if fname in E.scalar_func_names():
            return E.Func(fname, tuple(args))
        raise SyntaxError(f"unknown function {fname!r}")


def _sub_aliases(e: E.Expr, aliases: dict) -> E.Expr:
    """Replace top-level references to earlier SELECT aliases with their
    defining expressions (PREDICT expression arguments evaluate in event/
    aggregate scope, where aliases don't exist). Agg nodes are leaves —
    their arguments are event columns, never aliases."""
    if isinstance(e, E.Agg):
        return e
    if isinstance(e, E.Col) and e.name in aliases:
        return aliases[e.name]
    kids = tuple(_sub_aliases(c, aliases) for c in E.children(e))
    return E.replace_children(e, kids)


def parse_sql(sql: str) -> Query:
    """Parse the OpenMLDB-style feature-query SQL subset into a Query."""
    return _Parser(sql).parse()


_EXPLAIN_ANALYZE_RE = re.compile(r"^\s*explain\s+analyze\b", re.IGNORECASE)


def strip_explain_analyze(sql: str) -> Optional[str]:
    """``"EXPLAIN ANALYZE SELECT ..."`` -> ``"SELECT ..."``; ``None``
    when ``sql`` does not start with the EXPLAIN ANALYZE prefix (the
    engine then treats it as a deployment name). EXPLAIN/ANALYZE are
    deliberately not parser keywords — they never appear inside a query
    body, only as this statement prefix."""
    m = _EXPLAIN_ANALYZE_RE.match(sql)
    if m is None:
        return None
    return sql[m.end():].lstrip()
