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
``flash_attention_ref``  — causal / sliding-window GQA attention (dense).
``flash_attention_stream`` — the same attention as an online softmax over
                           KV blocks, never building the (Sq, Sk) scores.
``flash_attention_lse_ref`` — the dense attention and each row's
                           log-sum-exp (the training forward's outputs).
``flash_attention_bwd_ref`` — dq, dk, dv from the output and the
                           log-sum-exp (the FlashAttention-2 backward).
``decode_attention_ref`` — one-token GQA attention over a KV cache, prefix
                           or rolling-ring layout.

``cols`` (where a function takes it) names the value columns to read, so a
caller aggregates a few columns of a wide table without first copying them
out of it; ``None`` reads every column. Outputs follow ``cols`` order.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

NEG_INF = -3.0e38
POS_INF = 3.0e38
ATTN_NEG_INF = -1.0e30    # masked attention logits, as in the JAX package
_BIG_I32 = 2**30

__all__ = ["window_agg_ref", "fused_window_ref", "preagg_window_ref",
           "last_join_ref", "window_bounds", "check_fused_specs",
           "flash_attention_ref", "flash_attention_stream",
           "flash_attention_lse_ref", "flash_attention_bwd_ref",
           "decode_attention_ref", "FUSED_FIELDS", "NEG_INF", "POS_INF",
           "ATTN_NEG_INF"]

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


# ---------------------------------------------------------------------------
# Model-side attention
# ---------------------------------------------------------------------------
#
# The dense two keep the JAX reference's rounding: logits in the input dtype,
# softmax in f32, probabilities cast back to the input dtype before the PV
# product (the streaming form keeps flash_attention_xla's: f32 throughout).
# The heads stay grouped (``(Hkv, rep)``), with no repeat of K/V. A row that
# keeps no key gets the uniform average of V here (softmax of equal masked
# logits), where the kernels write 0; no prefill or decode of the model
# produces such a row.

def _query_positions(Sq: int, Sk: int, q_offset: Optional[int],
                     device) -> torch.Tensor:
    """Positions of the Sq query rows: ``q_offset + i`` (``Sk − Sq`` by
    default: right-aligned, the JAX package's only layout)."""
    off = Sk - Sq if q_offset is None else int(q_offset)
    return torch.arange(Sq, device=device) + off


def _attention_mask(Sq: int, Sk: int, causal: bool, window: Optional[int],
                    q_offset: Optional[int], device) -> torch.Tensor:
    """(Sq, Sk) bool: the (query, key) pairs the mask keeps."""
    qpos = _query_positions(Sq, Sk, q_offset, device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None,
                        q_offset: Optional[int] = None) -> torch.Tensor:
    """Reference GQA attention. q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) ->
    (B, Sq, Hq, D); query i at position ``i + q_offset`` (by default
    ``Sk − Sq``: right-aligned). ``window``: sliding-window span, None =
    full. A context-parallel rank passes the global position of its first
    query row as ``q_offset``, so its rows equal those rows of the
    whole-sequence call."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Sq, Hkv, rep, D)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k) * scale
    mask = _attention_mask(Sq, Sk, causal, window, q_offset, q.device)
    logits = logits.masked_fill(~mask, ATTN_NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs.to(q.dtype), v)
    return out.reshape(B, Sq, Hq, D)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: Optional[int], scale: float, q_offset: Optional[int]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scaled f32 scores (B, Hkv, rep, Sq, Sk) of q and k (products of
    the inputs' values, summed in f32) and the mask."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float()) * scale
    return s, _attention_mask(Sq, Sk, causal, window, q_offset, q.device)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None,
                            q_offset: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_ref`'s output and each row's log-sum-exp of
    its kept scaled scores, f32 (B, Hq, Sq), in natural-log units: the
    log-sum-exp of the masked logits (f32), so a row that keeps no key
    gets ``ATTN_NEG_INF`` (−1e30, the masked value) as the kernel writes
    it."""
    B, Sq, Hq, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    s, mask = _scores(q, k, causal, window, scale, q_offset)
    lse = torch.logsumexp(s.masked_fill(~mask, ATTN_NEG_INF), dim=-1)
    out = flash_attention_ref(q, k, v, causal=causal, window=window,
                              scale=scale, q_offset=q_offset)
    return out, lse.reshape(B, Hq, Sq)


def flash_attention_bwd_ref(dout: torch.Tensor, q: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None,
                            q_offset: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """dq, dk and dv of :func:`flash_attention_ref` at ``dout``, by the
    FlashAttention-2 backward's formulas, as the backward kernel computes
    them: ``Di = rowsum(dO ∘ O)``, ``P = exp(S·scale − lse)`` on the kept
    pairs (0 elsewhere), ``dV = Pᵀ dO``, ``dP = dO Vᵀ``,
    ``dS = P ∘ (dP − Di)``, ``dQ = scale · dS K``, ``dK = scale · dSᵀ Q``,
    K/V gradients summed over a group's query heads; everything in f32,
    with P and dS rounded to the inputs' dtype where they enter a product
    (the kernel's tensor-core operands in bf16; no rounding in f32).
    Returned in the inputs' dtype. A row that keeps no key (``lse`` at
    −1e30) has zero gradient."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    s, mask = _scores(q, k, causal, window, scale, q_offset)
    lse_g = lse.float().reshape(B, Hkv, rep, Sq)[..., None]
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    do = dout.float().reshape(B, Sq, Hkv, rep, D)
    di = (do * out.float().reshape(B, Sq, Hkv, rep, D)).sum(-1)
    di = di.permute(0, 2, 3, 1)[..., None]                # (B, Hkv, rep, Sq, 1)
    dp = torch.einsum("bqhrd,bkhd->bhrqk", do, v.float())
    ds = p * (dp - di)

    def rounded(t):
        return t.to(q.dtype).float()

    dv = torch.einsum("bhrqk,bqhrd->bkhd", rounded(p), do)
    dk = torch.einsum("bhrqk,bqhrd->bkhd", rounded(ds),
                      q.float().reshape(B, Sq, Hkv, rep, D)) * scale
    dq = torch.einsum("bhrqk,bkhd->bqhrd", rounded(ds), k.float()) * scale
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_stream(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: Optional[int] = None,
                           scale: Optional[float] = None,
                           block_k: int = 1024,
                           q_offset: Optional[int] = None) -> torch.Tensor:
    """Streaming online-softmax attention over KV blocks of ``block_k``
    (the JAX package's ``flash_attention_xla``): the flash kernel's
    algorithm in plain ops, so no (Sq, Sk) score tensor is ever made. The
    same rounding as JAX's: ``q·scale`` in f32, scores and probabilities
    in f32, a running max from ``-1e30``, masked probabilities exactly 0,
    ``acc / max(l, 1e-30)``, then q's dtype. Where ``block_k`` does not
    divide Sk it is :func:`flash_attention_ref`, as there. Every block is
    visited (no causal skipping), as in JAX's scan."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    bk = min(block_k, Sk)
    if bk <= 0 or Sk % bk:
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, q_offset=q_offset)
    qg = (q.float() * scale).reshape(B, Sq, Hkv, rep, D)
    qpos = _query_positions(Sq, Sk, q_offset, q.device)[:, None]
    acc = torch.zeros((B, Sq, Hkv, rep, D), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, Sq, Hkv, rep), ATTN_NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, Hkv, rep), dtype=torch.float32, device=q.device)
    for k_lo in range(0, Sk, bk):
        kb = k[:, k_lo:k_lo + bk].float()
        vb = v[:, k_lo:k_lo + bk].float()
        s = torch.einsum("bqhrd,bkhd->bqhrk", qg, kb)
        kpos = (k_lo + torch.arange(bk, device=q.device))[None, :]
        mask = torch.ones((Sq, bk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        mask = mask[None, :, None, None, :]
        s = torch.where(mask, s, ATTN_NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = (acc * alpha[..., None]
               + torch.einsum("bqhrk,bkhd->bqhrd", p, vb))
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor, *,
                         window: Optional[int] = None,
                         scale: Optional[float] = None,
                         ring: bool = False) -> torch.Tensor:
    """Single-token decode attention with KV cache.

    q (B, Hq, D); k_cache/v_cache (B, S, Hkv, D) -> (B, Hq, D).

    ``ring=False``: prefix layout — ``lengths`` (B,) = number of valid
    cache entries (the query attends to positions < length; ``window``
    restricts to the trailing ``window`` of them).

    ``ring=True``: rolling-ring layout (sliding-window serving) —
    ``lengths`` carries the current absolute POSITION (B,). The entry at
    ring slot ``s`` holds absolute position ``pos − ((pos − s) mod S)``; it
    is attended iff that position is ≥ 0 and within the window.
    """
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, rep, D)
    logits = torch.einsum("bhrd,bkhd->bhrk", qg, k_cache) * scale
    kpos = torch.arange(S, dtype=torch.int32, device=q.device)[None, :]
    lengths = lengths.to(torch.int32)[:, None]
    if ring:
        pos = lengths
        wrap = S * (torch.div(pos, S, rounding_mode="floor") + 1)
        ap = pos - torch.fmod(pos - kpos + wrap, S)
        mask = ap >= 0
        if window is not None:
            mask = mask & (ap > pos - window)
    else:
        mask = kpos < lengths
        if window is not None:
            mask = mask & (kpos >= lengths - window)
    logits = logits.masked_fill(~mask[:, None, None, :], ATTN_NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1)
    out = torch.einsum("bhrk,bkhd->bhrd", probs.to(q.dtype), v_cache)
    return out.reshape(B, Hq, D)
