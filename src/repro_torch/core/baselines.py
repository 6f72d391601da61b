"""Baseline execution models for the paper's system comparison (Table 1).

The port of the JAX package's ``repro.core.baselines``: the paper's point
is not the vendors of Table 1 but their *execution models*, so each
baseline below is the same feature query executed under a different
model, on the same data, in the same process:

* ``row_interpreter``  (PostgreSQL/MySQL class): per-request, per-row
  interpreted evaluation over host memory; key lookup is a host dict (as
  in the engine), no compilation, no vectorisation, no pre-aggregation.
* ``microbatch``       (SparkSQL/Flink class): vectorised columnar compute,
  but requests run in fixed micro-batches of 32, each with its own
  host⇄device round trip and dispatch; no pre-aggregation. The round trip
  is the execution model being emulated, so it stays on the card too.
* ``columnar_scan``    (ClickHouse class): vectorised, plan-cached
  execution without the ML-aware pre-aggregation tier or the online fast
  path.
* ``columnar_fullscan``: the strict no-index model: every request scans
  every key's storage and masks on the partition key (K·C work per
  request instead of C).
* ``openmldb``         the full stack (plan optimisation, plan cache,
  pre-aggregation, vectorised batch execution).

The ``engine`` and ``microbatch`` kinds go through ``Engine.request``, so
on the card they run the hand-written kernels. ``make_engine(profile)``
builds a configured engine (on the card unless ``device`` says
otherwise); ``BaselineRunner.serve_batch`` runs one request batch under
the profile's execution model.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import expr as E
from repro_torch.core.engine import Engine
from repro_torch.core.optimizer import OptFlags

__all__ = ["PROFILES", "PAPER_TABLE1", "BaselineRunner", "make_engine"]

PROFILES = {
    "openmldb": dict(kind="engine",
                     flags=OptFlags(query_opt=True, preagg=True,
                                    plan_cache=True, vectorized=True,
                                    assume_latest=True)),
    "row_interpreter": dict(kind="row"),
    "microbatch": dict(kind="microbatch", micro=32,
                       flags=OptFlags(query_opt=True, preagg=False,
                                      plan_cache=True, vectorized=True,
                                      assume_latest=False)),
    # ClickHouse-style: vectorised columnar execution, but no ML-aware
    # pre-aggregation tier and no online fast path.
    "columnar_scan": dict(kind="engine",
                          flags=OptFlags(query_opt=True, preagg=False,
                                         plan_cache=True, vectorized=True,
                                         assume_latest=False)),
    "columnar_fullscan": dict(kind="columnar",
                              flags=OptFlags(query_opt=True, preagg=False,
                                             plan_cache=True,
                                             vectorized=True,
                                             assume_latest=False)),
}

# The paper's Table 1 (queries/sec, latency range in ms), for reporting
# beside measured ratios; these are the paper's numbers, not the port's.
PAPER_TABLE1 = {
    "PostgreSQL": (1800, (85, 120)),
    "MySQL": (2100, (60, 95)),
    "SparkSQL": (3500, (50, 80)),
    "ClickHouse": (8200, (25, 60)),
    "FlinkSQL": (4200, (20, 40)),
    "OpenMLDB(paper)": (12500, (1, 5)),
}

# the columnar scan runs requests in chunks of this many (padded)
_CHUNK = 16
# bytes of temporaries per (request, slot) of one scanned slab; with the
# budget below this bounds a chunk's working set, whatever K is
_SLOT_BYTES = 32
_SLAB_BUDGET = 1 << 30


def make_engine(profile: str, **engine_kw) -> Engine:
    """An engine with ``profile``'s flags (``device`` defaults to the
    card, as ``Engine``'s does)."""
    p = PROFILES[profile]
    flags = p.get("flags", OptFlags())
    return Engine(flags, **engine_kw)


@dataclass
class _RowQuery:
    """Pre-resolved interpretation state for the row interpreter."""

    outputs: Tuple[Tuple[str, E.Expr], ...]
    windows: Dict[str, E.WindowSpec]
    where: Optional[E.Expr]


class BaselineRunner:
    """Runs one deployed query under a baseline execution model.

    ``slab_keys`` (columnar kind) is how many keys' storage one pass of
    the full scan covers: as many as keep a chunk's temporaries within
    ``_SLAB_BUDGET`` bytes. It changes no result."""

    def __init__(self, engine: Engine, deployment: str, profile: str):
        self.engine = engine
        self.dep = engine.deployments[deployment]
        self.profile = profile
        self.kind = PROFILES[profile]["kind"]
        self.micro = PROFILES[profile].get("micro", 100)
        q = self.dep.query
        self._rowq = _RowQuery(outputs=q.outputs,
                               windows=dict(q.windows), where=q.where)
        self.slab_keys = max(1, _SLAB_BUDGET // (
            _CHUNK * self.dep.table.capacity * _SLOT_BYTES))

    # ------------------------------------------------------------- dispatch
    def serve_batch(self, keys: Sequence, ts: Sequence[float],
                    rows: Optional[np.ndarray] = None):
        if self.kind == "engine":
            return self.engine.request(self.dep.name, keys, ts, rows)
        if self.kind == "microbatch":
            return self._serve_microbatch(keys, ts, rows)
        if self.kind == "row":
            return self._serve_rowwise(keys, ts, rows)
        if self.kind == "columnar":
            return self._serve_columnar(keys, ts, rows)
        raise ValueError(self.kind)

    # ------------------------------------------------- microbatch (SparkSQL)
    def _serve_microbatch(self, keys, ts, rows) -> Dict[str, np.ndarray]:
        outs = []
        n = len(keys)
        for s in range(0, n, self.micro):
            sl = slice(s, min(s + self.micro, n))
            # host->device->host round trip per micro-batch task:
            # batch-at-a-time dispatch with no shape-bucketing reuse
            outs.append(self.engine.request(
                self.dep.name, list(keys[sl]), list(np.asarray(ts)[sl]),
                None if rows is None else rows[sl]))
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    # ------------------------------------------- row interpreter (MySQL/PG)
    def _host_rows(self, keys: Sequence
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray]:
        """The interpreter reads host memory, fresh on every batch (tables
        are quiescent during a benchmark window). Only the rows of the
        batch's distinct keys come across: one gather on the table's
        device, then one device-to-host copy. Returns ``(kpos, values
        (U, C, V), ts (U, C), total (U,))`` with ``kpos[i]`` the row of
        request ``i``'s key."""
        table = self.dep.table
        kidx = table.key_indices(keys)
        uniq, kpos = np.unique(kidx, return_inverse=True)
        st = table.snapshot().state
        U, C, V = len(uniq), table.capacity, st.values.shape[2]
        with torch.no_grad():
            idx = table.put(uniq.astype(np.int64))
            # packed as 32-bit words, so every value crosses bit for bit
            packed = torch.cat(
                [st.values[idx].reshape(U, C * V).view(torch.int32),
                 st.ts[idx].view(torch.int32), st.total[idx][:, None]],
                1).cpu()
        host = packed.numpy()
        f32 = host[:, :C * V + C].view(np.float32)
        return (kpos, f32[:, :C * V].reshape(U, C, V), f32[:, C * V:],
                host[:, -1].copy())

    def _serve_rowwise(self, keys, ts, rows) -> Dict[str, np.ndarray]:
        table = self.dep.table
        kpos, values, tsbuf, total = self._host_rows(keys)
        C = table.capacity
        schema = table.schema
        out: Dict[str, List[float]] = {n: [] for n, _ in self._rowq.outputs}
        for i in range(len(keys)):
            kx = int(kpos[i])
            # storage timestamps are f32 — compare in the same precision
            t_req = float(np.float32(ts[i]))
            tot = int(total[kx])
            n_ret = min(tot, C)
            # reconstruct events in position order (index scan)
            evs: List[Tuple[float, np.ndarray]] = []
            for p in range(tot - n_ret, tot):
                s = p % C
                te = float(tsbuf[kx, s])
                if te <= t_req:
                    evs.append((te, values[kx, s]))
            for name, ex in self._rowq.outputs:
                val = self._interp(ex, evs, t_req, schema,
                                   rows[i] if rows is not None else None)
                out[name].append(val)
        return {n: np.asarray(v, np.float32) for n, v in out.items()}

    def _interp(self, e: E.Expr, evs, t_req, schema, req_row) -> float:
        """Row-at-a-time interpretation (no vectorisation on purpose)."""
        if isinstance(e, E.Lit):
            return float(e.value)
        if isinstance(e, E.Col):
            if req_row is not None and e.name in schema.value_cols:
                return float(req_row[schema.col_index(e.name)])
            if e.name == schema.ts_col:
                return t_req
            return 0.0
        if isinstance(e, E.BinOp):
            a = self._interp(e.lhs, evs, t_req, schema, req_row)
            b = self._interp(e.rhs, evs, t_req, schema, req_row)
            return float({
                "+": a + b, "-": a - b, "*": a * b,
                "/": a / b if b else 0.0,
                ">": a > b, ">=": a >= b, "<": a < b, "<=": a <= b,
                "==": a == b, "!=": a != b,
                "and": bool(a) and bool(b), "or": bool(a) or bool(b),
            }[e.op])
        if isinstance(e, E.Func):
            args = [self._interp(a, evs, t_req, schema, req_row)
                    for a in e.args]
            fn = {"log": math.log, "log1p": math.log1p, "abs": abs,
                  "sqrt": math.sqrt, "exp": math.exp,
                  "neg": lambda x: -x,
                  "sigmoid": lambda x: 1 / (1 + math.exp(-x)),
                  "relu": lambda x: max(x, 0.0),
                  "safe_div": lambda a, b: a / b if b > 0 else 0.0,
                  }.get(e.name)
            if fn is None:
                raise NotImplementedError(f"row interp func {e.name}")
            return float(fn(*args))
        if isinstance(e, E.Agg):
            spec = self._rowq.windows[e.window]
            if spec.is_rows:
                win = evs[-spec.rows_preceding:]
            else:
                lo = t_req - spec.range_preceding
                win = [ev for ev in evs if ev[0] >= lo]
            acc: List[float] = []
            for te, row in win:
                if isinstance(e.arg, E.Col):
                    acc.append(float(row[schema.col_index(e.arg.name)]))
                elif isinstance(e.arg, E.Lit):
                    acc.append(float(e.arg.value))
                else:
                    acc.append(self._interp_evt(e.arg, te, row))
            if e.func == E.AggFunc.COUNT:
                return float(len(acc))
            if not acc:
                return 0.0
            if e.func == E.AggFunc.SUM:
                s = 0.0
                for x in acc:    # row-at-a-time on purpose
                    s += x
                return s
            if e.func == E.AggFunc.AVG:
                return sum(acc) / len(acc)
            if e.func == E.AggFunc.MIN:
                return min(acc)
            if e.func == E.AggFunc.MAX:
                return max(acc)
            if e.func in (E.AggFunc.STD, E.AggFunc.VAR):
                m = sum(acc) / len(acc)
                v = sum((x - m) ** 2 for x in acc) / len(acc)
                return math.sqrt(v) if e.func == E.AggFunc.STD else v
            if e.func == E.AggFunc.FIRST:
                return acc[0]
            if e.func == E.AggFunc.LAST:
                return acc[-1]
        raise NotImplementedError(type(e).__name__)

    def _interp_evt(self, e: E.Expr, te: float, row: np.ndarray) -> float:
        schema = self.dep.table.schema
        if isinstance(e, E.Col):
            if e.name == schema.ts_col:
                return te
            return float(row[schema.col_index(e.name)])
        if isinstance(e, E.Lit):
            return float(e.value)
        if isinstance(e, E.BinOp):
            a = self._interp_evt(e.lhs, te, row)
            b = self._interp_evt(e.rhs, te, row)
            return float({"+": a + b, "-": a - b, "*": a * b,
                          "/": a / b if b else 0.0}[e.op])
        raise NotImplementedError

    # ------------------------------------------- columnar scan (ClickHouse)
    def _serve_columnar(self, keys, ts, rows) -> Dict[str, np.ndarray]:
        """Vectorised full-storage scan: no per-key index, so every
        request masks over all keys' slots (K·C work instead of C).
        Requests run in chunks of 16, padded to 16 — a scan engine
        pipelines queries, it does not materialise one K·C mask per
        concurrent request — and each chunk walks the keys in slabs of
        ``slab_keys``, so its working set stays bounded whatever K is.
        Plain torch on the table's device (the JAX package's version is
        ``jax.vmap`` under ``jax.jit``, with no kernel of its own)."""
        table = self.dep.table
        kidx_all = table.key_indices(keys)
        ts_all = np.asarray(ts, np.float32)
        st = table.snapshot().state
        outs: List[Dict[str, np.ndarray]] = []
        with torch.no_grad():
            for s in range(0, len(kidx_all), _CHUNK):
                kidx = kidx_all[s:s + _CHUNK]
                ts_arr = ts_all[s:s + _CHUNK]
                pad = _CHUNK - len(kidx)
                if pad:                        # pad to the chunk shape
                    kidx = np.pad(kidx, (0, pad))
                    ts_arr = np.pad(ts_arr, (0, pad))
                out = self._columnar_chunk(st, table.put(kidx.astype(
                    np.int64)), table.put(ts_arr))
                outs.append({k: v.cpu().numpy()[:_CHUNK - pad]
                             for k, v in out.items()})
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    def _columnar_chunk(self, st, kx: torch.Tensor, t_req: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
        """One chunk of requests (``kx``, ``t_req``: (R,)) over the whole
        table, slab by slab. Each aggregate keeps partial reductions per
        request; a slab reduces each key's C slots first, then across its
        keys, where every key but the request's own adds an exact zero
        (or the identity of min/max), so the slab size changes no bit."""
        schema = self.dep.table.schema
        aggs: Dict[E.Agg, None] = {}
        for _, ex in self._rowq.outputs:
            for node in E.walk(ex):
                if isinstance(node, E.Agg):
                    aggs.setdefault(node)
        K, C, _V = st.values.shape
        dev = st.values.device
        R = kx.shape[0]
        acc: Dict[E.Agg, Dict[str, torch.Tensor]] = {}
        slot = torch.arange(C, device=dev)
        for k0 in range(0, K, self.slab_keys):
            k1 = min(k0 + self.slab_keys, K)
            tot = st.total[k0:k1].long()[:, None]             # (Ks, 1)
            # each slot's absolute ring position; valid where >= 0
            p = tot - C + (slot[None, :] - tot % C) % C       # (Ks, C)
            tsl = st.ts[k0:k1]                                # (Ks, C)
            own = (torch.arange(k0, k1, device=dev)[None, :]
                   == kx[:, None])                            # (R, Ks)
            base = ((p >= 0)[None] & own[:, :, None]
                    & (tsl[None] <= t_req[:, None, None]))    # (R, Ks, C)
            for a in aggs:
                part = self._slab_partial(a, base, p, tsl, t_req,
                                          st.values[k0:k1], schema)
                if a not in acc:
                    acc[a] = part
                    continue
                for f, v in part.items():
                    acc[a][f] = (torch.minimum(acc[a][f], v) if f == "mn"
                                 else torch.maximum(acc[a][f], v)
                                 if f == "mx" else acc[a][f] + v)
        vals = {a: self._finish(a, acc[a]) for a in aggs}
        return {n: self._eval(ex, vals, R, dev)
                for n, ex in self._rowq.outputs}

    def _slab_partial(self, e: E.Agg, base, p, tsl, t_req, values, schema
                      ) -> Dict[str, torch.Tensor]:
        spec = self._rowq.windows[e.window]
        m = base
        if spec.is_rows:
            # keep rows with p >= p1 - W (ring positions are per-key
            # monotone, so this is the rows window); p1 per key row
            neg = torch.full((), -1, dtype=p.dtype, device=p.device)
            p1 = torch.where(m, p[None], neg).amax(-1, keepdim=True) + 1
            m = m & (p[None] >= p1 - spec.rows_preceding)
        else:
            m = m & (tsl[None] >= t_req[:, None, None]
                     - spec.range_preceding)
        if isinstance(e.arg, E.Col):
            x = values[..., schema.col_index(e.arg.name)][None]
        else:
            x = torch.ones_like(tsl)[None]
        mf = m.to(torch.float32)

        def total(t):                     # each key's C slots, then keys
            return t.sum(-1).sum(-1)

        f = e.func
        if f == E.AggFunc.COUNT:
            return {"n": total(mf)}
        if f in (E.AggFunc.SUM, E.AggFunc.AVG):
            return {"s": total(x * mf), "n": total(mf)}
        if f == E.AggFunc.MIN:
            big = torch.full((), 3e38, device=x.device)
            return {"mn": torch.where(m, x, big).amin(-1).amin(-1)}
        if f == E.AggFunc.MAX:
            big = torch.full((), -3e38, device=x.device)
            return {"mx": torch.where(m, x, big).amax(-1).amax(-1)}
        if f in (E.AggFunc.STD, E.AggFunc.VAR):
            return {"s": total(x * mf), "q": total(x * x * mf),
                    "n": total(mf)}
        if f in (E.AggFunc.FIRST, E.AggFunc.LAST):
            pb = p[None].expand_as(m)
            if f == E.AggFunc.LAST:
                fill = torch.full((), -1, dtype=p.dtype, device=p.device)
                psel = torch.where(m, pb, fill).amax(-1, keepdim=True)
            else:
                fill = torch.full((), 2 ** 30, dtype=p.dtype,
                                  device=p.device)
                psel = torch.where(m, pb, fill).amin(-1, keepdim=True)
            sel = (m & (pb == psel)).to(torch.float32)
            return {"s": total(x * sel)}
        raise NotImplementedError(f.name)

    @staticmethod
    def _finish(e: E.Agg, a: Dict[str, torch.Tensor]) -> torch.Tensor:
        f = e.func
        if f == E.AggFunc.COUNT:
            return a["n"]
        if f == E.AggFunc.AVG:
            return a["s"] / torch.clamp(a["n"], min=1.0)
        if f == E.AggFunc.MIN:
            return a["mn"]
        if f == E.AggFunc.MAX:
            return a["mx"]
        if f in (E.AggFunc.STD, E.AggFunc.VAR):
            c = torch.clamp(a["n"], min=1.0)
            mu = a["s"] / c
            var = torch.clamp(a["q"] / c - mu * mu, min=0.0)
            return torch.sqrt(var) if f == E.AggFunc.STD else var
        return a["s"]                     # SUM, FIRST, LAST

    def _eval(self, e: E.Expr, vals, R: int, dev) -> torch.Tensor:
        """An output over the chunk's aggregates, request by request as
        the JAX package's ``vmap`` does: a column of the request is 0."""
        if isinstance(e, E.Agg):
            return vals[e]
        if isinstance(e, E.Lit):
            return torch.full((R,), float(e.value), dtype=torch.float32,
                              device=dev)
        if isinstance(e, E.Col):
            return torch.zeros((R,), dtype=torch.float32, device=dev)
        if isinstance(e, E.BinOp):
            return E._BINOPS[e.op](self._eval(e.lhs, vals, R, dev),
                                   self._eval(e.rhs, vals, R, dev))
        if isinstance(e, E.Func):
            return E._FUNCS[e.name](*[self._eval(a, vals, R, dev)
                                      for a in e.args])
        raise NotImplementedError(type(e).__name__)
