"""Plain PyTorch versions of the feature kernels (the CPU execution path and
the oracle each CUDA kernel is held against).

Positional model (see featurestore.table): event ``p`` of a key lives at ring
slot ``p % C``; retained events are ``p ∈ [max(0, total−C), total)``. For a
request at time ``t`` the window is a position interval ``[p0, p1)`` with
``p1 = P_t = #{events with ts ≤ t}`` and

* ROWS  W : ``p0 = P_t − W``
* RANGE R : ``p0 = first p with ts[p] ≥ t − R``

Both clamped to retention. All aggregates reduce over that interval.

``window_agg_ref``    — naive fused multi-aggregate scan, O(C) per request.
``fused_window_ref``  — single-scan multi-window form: every plain window
                        spec of a deployment from one gather of the ring
                        block (shared positions/p1, batched reductions over
                        a (B, S, C) mask tensor).
``preagg_window_ref`` — bucketed pre-aggregation path (paper Eq. 2),
                        reading O(NB + 2·bucket) instead of O(C·V).
``last_join_ref``     — point-in-time LAST JOIN row lookup: latest right-
                        table row with ts ≤ req_ts, as a masked argmax over
                        positions + one-hot gather of the joined columns.

``cols`` (where a function takes it) names the value columns to read, so a
caller aggregates a few columns of a wide table without first copying them
out of it; ``None`` reads every column. Outputs follow ``cols`` order.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

NEG_INF = -3.0e38
POS_INF = 3.0e38
_BIG_I32 = 2**30

__all__ = ["window_agg_ref", "fused_window_ref", "preagg_window_ref",
           "last_join_ref", "window_bounds", "check_fused_specs",
           "FUSED_FIELDS", "NEG_INF", "POS_INF"]

FUSED_FIELDS = ("sum", "sumsq", "count", "min", "max", "first", "last")


def _gather_rows(a: torch.Tensor, req_key: torch.Tensor,
                 cols: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``a[req_key]`` (optionally narrowed to ``cols`` on the last axis).

    Columns are taken one by one rather than through an index built from
    a Python list, which would copy host memory to the device: every plain
    version issues device work only, so it can run inside a CUDA graph."""
    rows = a[req_key.long()]
    if cols is None:
        return rows
    if not cols:
        return rows[..., :0]
    return torch.stack([rows[..., c] for c in cols], dim=-1)


def _positions(ts: torch.Tensor, total: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot global positions + validity for gathered rings.

    ts (B, C); total (B,). Returns p (B, C) i32, valid (B, C) bool.
    """
    C = ts.shape[1]
    tot = total.to(torch.int32)[:, None]
    slots = torch.arange(C, dtype=torch.int32, device=ts.device)[None, :]
    rel = torch.remainder(slots - torch.remainder(tot, C), C)   # floor mod
    p = tot - C + rel
    valid = (p >= 0) & (p < tot)
    return p, valid


def _upper_bound(ts_rows: torch.Tensor, total_rows: torch.Tensor,
                 valid: torch.Tensor, req_ts: torch.Tensor,
                 assume_latest: bool) -> torch.Tensor:
    """``p1 = P_t`` — #events with ts ≤ req_ts. Depends only on the
    request time, never on the frame, so fused multi-window execution
    computes it ONCE and shares it across every spec."""
    if assume_latest:
        return total_rows
    after = valid & (ts_rows > req_ts[:, None])
    return total_rows - after.sum(1).to(torch.int32)


def _lower_bound(p1: torch.Tensor, ts_rows: torch.Tensor,
                 total_rows: torch.Tensor, valid: torch.Tensor,
                 req_ts: torch.Tensor, *,
                 rows_preceding: Optional[int],
                 range_preceding: Optional[float]) -> torch.Tensor:
    """Per-frame ``p0`` (ROWS count back from p1, or RANGE time predicate),
    clamped to [0, retention)."""
    C = ts_rows.shape[1]
    if rows_preceding is not None:
        p0 = p1 - int(rows_preceding)
    else:
        in_range = (valid & (ts_rows >= (req_ts - range_preceding)[:, None])
                    & (ts_rows <= req_ts[:, None]))
        p0 = p1 - in_range.sum(1).to(torch.int32)
    return torch.maximum(torch.clamp(p0, min=0), total_rows - C)


def window_bounds(ts_rows: torch.Tensor, total_rows: torch.Tensor,
                  req_ts: torch.Tensor, *, rows_preceding: Optional[int],
                  range_preceding: Optional[float],
                  assume_latest: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window position interval [p0, p1) per request.

    ts_rows (B, C) gathered ring timestamps; total_rows (B,); req_ts (B,).
    ``assume_latest``: online fast path — req_ts ≥ every ingested ts of the
    key, so ``P_t = total`` without scanning timestamps.
    """
    total_rows = total_rows.to(torch.int32)
    C = ts_rows.shape[1]
    if assume_latest and rows_preceding is not None:
        p1 = total_rows
        p0 = torch.clamp(p1 - int(rows_preceding), min=0)
        p0 = torch.maximum(p0, total_rows - C)
        return p0, p1
    _, valid = _positions(ts_rows, total_rows)
    p1 = _upper_bound(ts_rows, total_rows, valid, req_ts, assume_latest)
    p0 = _lower_bound(p1, ts_rows, total_rows, valid, req_ts,
                      rows_preceding=rows_preceding,
                      range_preceding=range_preceding)
    return p0, p1


def window_agg_ref(values: torch.Tensor, ts: torch.Tensor,
                   total: torch.Tensor, req_key: torch.Tensor,
                   req_ts: torch.Tensor, *,
                   cols: Optional[Sequence[int]] = None,
                   rows_preceding: Optional[int] = None,
                   range_preceding: Optional[float] = None,
                   evt_mask: Optional[torch.Tensor] = None,
                   assume_latest: bool = False,
                   fields: Optional[Tuple[str, ...]] = None
                   ) -> Dict[str, torch.Tensor]:
    """Naive fused multi-aggregate sliding window.

    values (K, C, V), ts (K, C), total (K,), req_key (B,), req_ts (B,),
    evt_mask optional (K, C) event-level WHERE mask. ``fields`` restricts
    which aggregates are materialised (None = all).

    Returns dict: sum/sumsq/min/max/first/last (B, Vo), count (B,).
    """
    fields = fields or ("sum", "sumsq", "count", "min", "max", "first",
                        "last")
    v = _gather_rows(values, req_key, cols)      # (B, C, Vo)
    t = _gather_rows(ts, req_key)                # (B, C)
    tot = _gather_rows(total, req_key)           # (B,)
    p, valid = _positions(t, tot)
    p0, p1 = window_bounds(t, tot, req_ts,
                           rows_preceding=rows_preceding,
                           range_preceding=range_preceding,
                           assume_latest=assume_latest)
    win = valid & (p >= p0[:, None]) & (p < p1[:, None])
    if evt_mask is not None:
        win = win & _gather_rows(evt_mask, req_key)
    winf = win[:, :, None].to(torch.float32)

    out: Dict[str, torch.Tensor] = {}
    if "sum" in fields:
        out["sum"] = (v * winf).sum(1)
    if "sumsq" in fields:
        out["sumsq"] = (v * v * winf).sum(1)
    if "count" in fields:
        out["count"] = win.sum(1).to(torch.float32)
    if "min" in fields:
        out["min"] = torch.where(win[:, :, None], v, POS_INF).amin(1)
    if "max" in fields:
        out["max"] = torch.where(win[:, :, None], v, NEG_INF).amax(1)
    if "first" in fields or "last" in fields:
        # first/last: events at min/max position inside the window.
        # Empty window -> 0.0 (SQL NULL has no tensor representation).
        nonempty = win.any(1)[:, None].to(torch.float32)
        if "first" in fields:
            idx = torch.where(win, p, _BIG_I32).argmin(1)
            out["first"] = torch.take_along_dim(
                v, idx[:, None, None], dim=1)[:, 0, :] * nonempty
        if "last" in fields:
            idx = torch.where(win, p, -1).argmax(1)
            out["last"] = torch.take_along_dim(
                v, idx[:, None, None], dim=1)[:, 0, :] * nonempty
    return out


def last_join_ref(values: torch.Tensor, ts: torch.Tensor,
                  total: torch.Tensor, req_key: torch.Tensor,
                  req_ts: torch.Tensor, *,
                  col_idx: Tuple[int, ...],
                  assume_latest: bool = False,
                  with_ts: bool = False
                  ) -> Tuple[torch.Tensor, ...]:
    """Point-in-time LAST JOIN row lookup (the relational tier's kernel).

    For each request ``i`` over the RIGHT table's ring buffer: select the
    **latest** retained row of key ``req_key[i]`` with ``ts <= req_ts[i]``
    — a masked argmax over global positions — and gather its ``col_idx``
    value columns. Per-key timestamps are non-decreasing (the ingest
    contract), so the qualifying positions are exactly
    ``[max(0, total-C), p1)`` with ``p1`` the shared upper bound the window
    kernels use.

    ``assume_latest`` is the online fast path (req_ts ≥ every ingested
    right-table ts): the newest retained row wins without a ts scan.

    Returns ``(row (B, len(col_idx)) f32, matched (B,) bool)``; unmatched
    requests (empty ring, or every row newer than req_ts) get zero rows.
    ``with_ts`` appends the selected row's timestamp ``(B,) f32`` (zero
    when unmatched).
    """
    if not col_idx:
        raise ValueError("last_join needs at least one value column")
    v = _gather_rows(values, req_key, col_idx).to(torch.float32)  # (B,C,Vc)
    t = _gather_rows(ts, req_key)                                  # (B, C)
    tot = _gather_rows(total, req_key).to(torch.int32)             # (B,)
    p, valid = _positions(t, tot)
    p1 = _upper_bound(t, tot, valid, req_ts, assume_latest)
    win = valid & (p < p1[:, None])
    p_last = torch.where(win, p, -1).amax(1)                       # (B,)
    matched = p_last >= 0
    # unique positions -> exact one-hot select (matches the LAST aggregate)
    sel = ((p == p_last[:, None]) & win).to(torch.float32)
    row = torch.einsum("bc,bcv->bv", sel, v)
    if not with_ts:
        return row, matched
    sel_ts = (sel * t.to(torch.float32)).sum(1)
    return row, matched, sel_ts


def check_fused_specs(spec_rows, spec_ranges, spec_fields) -> None:
    """Validate a fused-window spec table (shared by all backends)."""
    S = len(spec_rows)
    if not (len(spec_ranges) == S == len(spec_fields)) or S == 0:
        raise ValueError(
            f"spec table lengths must match and be non-empty: "
            f"rows={len(spec_rows)} ranges={len(spec_ranges)} "
            f"fields={len(spec_fields)}")
    for s in range(S):
        if (spec_rows[s] is None) == (spec_ranges[s] is None):
            raise ValueError(
                f"spec {s}: exactly one of rows/range must be given "
                f"(rows={spec_rows[s]}, range={spec_ranges[s]})")
        bad = [f for f in spec_fields[s] if f not in FUSED_FIELDS]
        if bad:
            raise ValueError(f"spec {s}: unknown fields {bad}")


def fused_window_ref(values: torch.Tensor, ts: torch.Tensor,
                     total: torch.Tensor, req_key: torch.Tensor,
                     req_ts: torch.Tensor, *,
                     spec_rows: Tuple[Optional[int], ...],
                     spec_ranges: Tuple[Optional[float], ...],
                     spec_fields: Tuple[Tuple[str, ...], ...],
                     cols: Optional[Sequence[int]] = None,
                     evt_mask: Optional[torch.Tensor] = None,
                     assume_latest: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """Single-scan fused MULTI-WINDOW aggregation.

    values (K, C, V) — the union of the specs' columns is ``cols`` (or all
    of V); ``spec_rows`` / ``spec_ranges`` / ``spec_fields`` are length-S
    static tuples (exactly one of rows/range per spec; per-spec field
    masks). Semantics per spec are identical to :func:`window_agg_ref`;
    fields a spec did not request are ZERO in its output rows.

    Returns dict: sum/sumsq/min/max/first/last (B, S, Vo), count (B, S).
    """
    check_fused_specs(spec_rows, spec_ranges, spec_fields)
    S = len(spec_rows)
    fields = tuple(f for f in FUSED_FIELDS
                   if any(f in sf for sf in spec_fields))
    v = _gather_rows(values, req_key, cols).to(torch.float32)  # ONE gather
    t = _gather_rows(ts, req_key)
    tot = _gather_rows(total, req_key).to(torch.int32)
    p, valid = _positions(t, tot)
    # shared upper bound, per-spec lower bounds — the same helpers
    # window_bounds lowers through, so single- and multi-window semantics
    # cannot drift apart
    p1 = _upper_bound(t, tot, valid, req_ts, assume_latest)
    p0s = torch.stack(
        [_lower_bound(p1, t, tot, valid, req_ts,
                      rows_preceding=spec_rows[s],
                      range_preceding=spec_ranges[s])
         for s in range(S)], dim=1)                # (B, S)

    base = valid
    if evt_mask is not None:
        base = base & _gather_rows(evt_mask, req_key)
    win = (base[:, None, :] & (p[:, None, :] >= p0s[:, :, None])
           & (p[:, None, :] < p1[:, None, None]))          # (B, S, C)
    winf = win.to(torch.float32)

    def keep(f, r):
        """Zero the spec rows that did not request field ``f``."""
        for s_, sf in enumerate(spec_fields):
            if f not in sf:
                r[:, s_] = 0.0
        return r

    out: Dict[str, torch.Tensor] = {}
    if "sum" in fields:
        out["sum"] = keep("sum", torch.einsum("bsc,bcv->bsv", winf, v))
    if "sumsq" in fields:
        out["sumsq"] = keep("sumsq",
                            torch.einsum("bsc,bcv->bsv", winf, v * v))
    if "count" in fields:
        out["count"] = keep("count", winf.sum(2))
    # min/max loop the static spec axis so the peak temporary stays
    # (B, C, V) like the per-group path — a broadcast over S would
    # materialise (B, S, C, V)
    if "min" in fields:
        r = torch.stack(
            [torch.where(win[:, s, :, None], v, POS_INF).amin(1)
             for s in range(S)], dim=1)
        out["min"] = keep("min", r)
    if "max" in fields:
        r = torch.stack(
            [torch.where(win[:, s, :, None], v, NEG_INF).amax(1)
             for s in range(S)], dim=1)
        out["max"] = keep("max", r)
    # positions are unique per key -> exact one-hot select (an empty
    # window selects nothing and yields 0, matching window_agg_ref)
    if "first" in fields:
        p_first = torch.where(win, p[:, None, :], _BIG_I32).amin(2)
        sel = (p[:, None, :] == p_first[:, :, None]) & win
        out["first"] = keep("first", torch.einsum(
            "bsc,bcv->bsv", sel.to(torch.float32), v))
    if "last" in fields:
        p_last = torch.where(win, p[:, None, :], -1).amax(2)
        sel = (p[:, None, :] == p_last[:, :, None]) & win
        out["last"] = keep("last", torch.einsum(
            "bsc,bcv->bsv", sel.to(torch.float32), v))
    return out


def preagg_window_ref(values: torch.Tensor, ts: torch.Tensor,
                      total: torch.Tensor,
                      pa_sum: torch.Tensor, pa_sumsq: torch.Tensor,
                      pa_min: torch.Tensor, pa_max: torch.Tensor,
                      pa_count: torch.Tensor,
                      req_key: torch.Tensor, req_ts: torch.Tensor, *,
                      bucket_size: int,
                      cols: Optional[Sequence[int]] = None,
                      rows_preceding: Optional[int] = None,
                      range_preceding: Optional[float] = None,
                      assume_latest: bool = False,
                      fields: Optional[Tuple[str, ...]] = None
                      ) -> Dict[str, torch.Tensor]:
    """Bucketed pre-aggregation window (paper Eq. 2).

    window [p0,p1) = head partial [p0, b0·B) + full buckets [b0, b1)
    + tail partial [b1·B, p1), with b0 = ceil(p0/B), b1 = floor(p1/B).
    ``cols`` selects the same columns of ``values`` and of the four value
    tiers. Exactness requires window span ≤ capacity − bucket_size.

    Returns dict: sum/sumsq/min/max (B, Vo), count (B,).
    """
    fields = fields or ("sum", "sumsq", "count", "min", "max")
    C = ts.shape[1]
    Bsz = bucket_size
    nb = pa_count.shape[1]
    t = _gather_rows(ts, req_key)
    tot = _gather_rows(total, req_key).to(torch.int32)
    p0, p1 = window_bounds(t, tot, req_ts,
                           rows_preceding=rows_preceding,
                           range_preceding=range_preceding,
                           assume_latest=assume_latest)
    b0 = torch.div(p0 + Bsz - 1, Bsz, rounding_mode="floor")
    b1 = torch.div(p1, Bsz, rounding_mode="floor")
    has_buckets = b0 <= b1

    # -- full buckets: slot s holds bucket index b(s) = b_head − ((b_head−s) mod NB)
    b_head = torch.div(torch.clamp(tot - 1, min=0), Bsz,
                       rounding_mode="floor")                  # (B,)
    s = torch.arange(nb, dtype=torch.int32, device=ts.device)[None, :]
    b_of_s = b_head[:, None] - torch.remainder(b_head[:, None] - s, nb)
    bmask = (has_buckets[:, None] & (b_of_s >= b0[:, None])
             & (b_of_s < b1[:, None]))                          # (B, NB)
    bmf = bmask[:, :, None].to(torch.float32)

    def g(a):                                                   # (B, NB, Vo)
        return _gather_rows(a, req_key, cols)

    # -- raw partials: head [p0, min(b0·B, p1)) and tail [b1·B, p1) (only
    #    when buckets exist; otherwise the head interval covers everything).
    head_end = torch.where(has_buckets, b0 * Bsz, p1)
    tail_start = torch.where(has_buckets, b1 * Bsz, p1)
    v_rows = _gather_rows(values, req_key, cols)                # (B, C, Vo)

    def partial(start, end):
        i = torch.arange(Bsz, dtype=torch.int32,
                         device=ts.device)[None, :]             # span ≤ bucket
        pp = start[:, None] + i                                 # (B, Bsz)
        m = pp < end[:, None]
        slot = torch.remainder(pp, C).long()
        vv = torch.take_along_dim(v_rows, slot[:, :, None], dim=1)
        mf = m[:, :, None].to(torch.float32)
        res = {}
        if "sum" in fields:
            res["sum"] = (vv * mf).sum(1)
        if "sumsq" in fields:
            res["sumsq"] = (vv * vv * mf).sum(1)
        if "count" in fields:
            res["count"] = m.sum(1).to(torch.float32)
        if "min" in fields:
            res["min"] = torch.where(m[:, :, None], vv, POS_INF).amin(1)
        if "max" in fields:
            res["max"] = torch.where(m[:, :, None], vv, NEG_INF).amax(1)
        return res

    h = partial(p0, head_end)
    tl = partial(tail_start, p1)

    out: Dict[str, torch.Tensor] = {}
    if "sum" in fields:
        out["sum"] = (g(pa_sum) * bmf).sum(1) + h["sum"] + tl["sum"]
    if "sumsq" in fields:
        out["sumsq"] = ((g(pa_sumsq) * bmf).sum(1)
                        + h["sumsq"] + tl["sumsq"])
    if "count" in fields:
        out["count"] = ((_gather_rows(pa_count, req_key) * bmask).sum(1)
                        + h["count"] + tl["count"])
    if "min" in fields:
        min_b = torch.where(bmask[:, :, None], g(pa_min), POS_INF).amin(1)
        out["min"] = torch.minimum(min_b, torch.minimum(h["min"], tl["min"]))
    if "max" in fields:
        max_b = torch.where(bmask[:, :, None], g(pa_max), NEG_INF).amax(1)
        out["max"] = torch.maximum(max_b, torch.maximum(h["max"], tl["max"]))
    return out
