"""Temporal windows: `group_by_dynamic` and `rolling`.

The port of the JAX package's `ops/temporal_window.py` (the capability
of `polars-time/src/group_by/`):

* non-overlapping dynamic windows are the truncated index: a plain
  group-by on (keys, window start), which the sorted tier answers in key
  order (kernel F over the key words, kernel B at the run starts);
* overlapping windows (period > every, or a `closed` other than "left")
  fan each row out to K candidate windows, mask the candidates the row
  does not fall in, and group the expanded rows by (keys, window start).
  Only the columns that the keys and aggregates read are expanded (the
  JAX package expands every column);
* `rolling` gives each row the aggregates of its trailing window
  (t - period, t] within its group: the rows sorted by (keys, t) on the
  sorted tier's layout (`groupby.build_groups` with t's words below the
  key), each window's bounds from one `torch.searchsorted`
  (`window_over.range_bounds`), sums and moments from sum levels and min
  and max from a sparse table (`range_agg`), and the results scattered
  back to the rows. Group starts come from the layout's run starts, not
  from a `cummax`, and the inverse permutation is a scatter, not a sort.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional, Sequence

import torch

from ..batch import Column, Table, storage_torch_dtype
from ..config import capacity_for
from ..dtypes import Date, Datetime, Duration, UInt32
from ..errors import ComputeError, InvalidOperationError
from ..expr import meta
from ..expr.eval import _float_dt, _sum_dtype, _type_bounds, eval_expr
from ..expr.expr import Expr, col as _col
from . import range_agg as R
from . import temporal as T
from .groupby import build_groups, group_by_agg
from .keycode import encode_key_words

__all__ = ["bucket_expr", "add_months_units", "dynamic_group_by",
           "rolling_agg"]


def _offset_lit(index_dtype, ns: int) -> Expr:
    """A duration of `ns` nanoseconds in the index column's units, as a
    literal the index can be moved by."""
    if isinstance(index_dtype, Datetime):
        unit = index_dtype.time_unit
        return Expr("lit", value=ns // (1_000_000_000
                                        // T.UNIT_PER_SECOND[unit]),
                    dtype=Duration(unit))
    return Expr("lit", value=ns // 86_400_000_000_000 * 86_400_000,
                dtype=Duration("ms"))


def bucket_expr(index_column: str, index_dtype, every: str,
                offset: Optional[str] = None) -> Expr:
    """The expression of each row's window start: the index truncated to
    `every`, moved by `offset`. (The JAX package moves a Datetime index
    by an Int64 literal, which its temporal arithmetic refuses; here the
    offset is a Duration.)"""
    e = _col(index_column)
    kind, n = T.parse_every(every)
    if isinstance(index_dtype, Datetime) or index_dtype == Date:
        om = 0
        if offset:
            okind, om = T.parse_every(offset)
            if okind != "fixed":
                om = 0
        if om:
            e = e - _offset_lit(index_dtype, om)
        out = Expr("dt", (e,), op="truncate", every=every)
        if om:
            out = out + _offset_lit(index_dtype, om)
        return out
    if kind != "fixed":
        raise InvalidOperationError("month buckets need a temporal index")
    off = T.parse_every(offset)[1] if offset else 0
    return ((e - off) // n) * n + off


def add_months_units(vals: torch.Tensor, delta_months, dt) -> torch.Tensor:
    """Index values (Datetime epochs or Date days) moved by whole civil
    months; a day past the new month's end saturates to its last day
    (Jan 31 + 1 month is Feb 28 or 29)."""
    if isinstance(dt, Datetime):
        pd = T.per_day(dt.time_unit)
        days = T.epoch_to_days(vals, dt.time_unit)
        rem = vals - days.to(vals.dtype) * pd
    else:
        days, rem, pd = vals, 0, None
    y, m, d = T.days_to_civil(days)
    total = y.to(torch.int64) * 12 + (m.to(torch.int64) - 1) + delta_months
    ny = torch.div(total, 12, rounding_mode="floor")
    nm = total - ny * 12 + 1
    one = torch.ones_like(nm)
    month_len = T.civil_to_days(torch.where(nm == 12, ny + 1, ny),
                                torch.where(nm == 12, one, nm + 1), one) - \
        T.civil_to_days(ny, nm, one)
    out_days = T.civil_to_days(ny, nm, torch.minimum(d.to(torch.int64),
                                                     month_len.long()))
    if isinstance(dt, Datetime):
        return out_days.to(vals.dtype) * pd + rem
    return out_days.to(vals.dtype)


def _span_units(dt, ns: int, what: str) -> int:
    """A duration in index units (epoch ticks, days, or raw for an
    integer index)."""
    if isinstance(dt, Datetime):
        return ns // (1_000_000_000 // T.UNIT_PER_SECOND[dt.time_unit])
    if dt == Date:
        d = ns // 86_400_000_000_000
        if d == 0:
            raise InvalidOperationError(
                f"{what} shorter than 1d on a Date index")
        return d
    return ns


def dynamic_group_by(table: Table, index_column: str, every: str,
                     period: Optional[str], offset: Optional[str],
                     closed: str, group_by: Sequence[Expr],
                     aggs: Sequence[Expr], start_by: str = "window"
                     ) -> Table:
    """group_by_dynamic(...).agg(...): one row per (keys, window start)
    that holds a row, in ascending (keys, window start) order."""
    dt = table.column(index_column).dtype
    if (period is None or period == every) and closed == "left":
        # non-overlapping windows: the truncation is the whole assignment
        b = bucket_expr(index_column, dt, every, offset).alias(index_column)
        return group_by_agg(table, list(group_by) + [b], list(aggs),
                            maintain_order="key")
    return _dynamic_overlap(table, index_column, every, period or every,
                            offset, closed, group_by, aggs)


def _dynamic_overlap(table: Table, index_column: str, every: str,
                     period: str, offset: Optional[str], closed: str,
                     group_by: Sequence[Expr], aggs: Sequence[Expr]
                     ) -> Table:
    """Overlapping or not-left-closed windows (the JAX package's
    `_dynamic_overlap`): each row fanned out to K = ceil(period/every) + 1
    candidate window starts trunc(t) - j·every, the candidates whose
    window does not hold t masked dead, then one group-by over (keys,
    window start) of the expanded rows, which the sorted tier returns in
    key order."""
    ekind, en = T.parse_every(every)
    pkind, pn = T.parse_every(period)
    dt = table.column(index_column).dtype
    if ekind == "months":
        if not (isinstance(dt, Datetime) or dt == Date):
            raise InvalidOperationError("month buckets need a temporal index")
        if pkind == "months":
            K = max(-(-pn // en), 1) + 1
        else:
            # a month holds at least 28 days: bound the candidates above
            K = max(pn // 86_400_000_000_000, 1) // (28 * en) + 2
    else:
        if pkind == "months":
            raise InvalidOperationError(
                "month-based period with fixed every not supported")
        e_units = _span_units(dt, en, "every")
        p_units = _span_units(dt, pn, "period")
        K = max(-(-p_units // e_units), 1) + 1

    cap = table.capacity
    dev = table.device
    ecap = capacity_for(cap * K)
    pos = torch.arange(ecap, device=dev)
    in_range = pos < cap * K
    rep = torch.where(in_range, torch.div(pos, K, rounding_mode="floor"), 0)
    j = torch.remainder(pos, K)
    # only the columns the keys and the aggregates read, and the index
    names = {index_column}
    for ex in list(group_by) + list(aggs):
        names |= meta.root_names(ex)
    names = [n for n in table.names if n in names]
    cols = {n: table.cols[n].take(rep) for n in names}
    exp_valid = table.row_mask()[rep] & in_range
    exp = Table(names, cols, ecap, None, exp_valid, device=dev)

    s0 = eval_expr(bucket_expr(index_column, dt, every, offset), exp,
                   "select")
    t = exp.column(index_column).data
    stor = t.dtype
    if ekind == "months":
        s = add_months_units(s0.data.to(stor), -(j * en), dt)
        end = add_months_units(s, pn, dt) if pkind == "months" else \
            s + _span_units(dt, pn, "period")
    else:
        s = s0.data.to(stor) - (j * e_units).to(stor)
        end = s + p_units
    if closed == "left":
        ok = (s <= t) & (t < end)
    elif closed == "right":
        ok = (s < t) & (t <= end)
    elif closed == "both":
        ok = (s <= t) & (t <= end)
    else:
        ok = (s < t) & (t < end)
    if s0.validity is not None:
        ok = ok & s0.validity
    exp = exp.with_column("__ws", Column(dt, s, None, None))
    exp = exp.with_valid(exp_valid & ok, None)
    keys = list(group_by) + [_col("__ws").alias(index_column)]
    return group_by_agg(exp, keys, list(aggs), maintain_order="key")


_ROLL_AGGS = {"sum", "mean", "min", "max", "count", "len", "std", "var",
              "first", "last"}


def rolling_agg(table: Table, index_column: str, period: str,
                group_by: Sequence[Expr], aggs: Sequence[Expr],
                closed: str = "right") -> Table:
    """df.rolling(index_column, period=...).agg(...): one output row per
    input row, in row order, each with the aggregates of its trailing
    window within its group (rows of its group whose index lies in
    (t - period, t] for closed="right", and up to the row itself
    whatever `closed` says, as in the JAX package)."""
    mask = table.row_mask()
    idx_col = table.column(index_column)
    dt = idx_col.dtype
    kind, _ = T.parse_every(period)
    if kind != "fixed":
        raise InvalidOperationError("month-based rolling periods unsupported")
    key_vals = [eval_expr(k, table, "select") for k in group_by]
    t = idx_col.data
    gctx = build_groups(key_vals, mask,
                        encode_key_words(t, dt, None, False, False),
                        row_gid=False)
    from .window_over import range_bounds
    spec = SimpleNamespace(attrs={"period": period, "closed": closed})
    lo, hi, _, _ = range_bounds(spec, t[gctx.perm], dt, gctx)
    cap = table.capacity
    slot = torch.arange(cap, device=mask.device)
    hi = torch.where(gctx.live_sorted, torch.maximum(hi, slot + 1), hi)
    longest = int((hi - lo).max()) if cap else 0

    names: List[str] = []
    cols = {}
    for k in group_by:
        nm = meta.output_name(k)
        names.append(nm)
        cols[nm] = table.column(nm)
    names.append(index_column)
    cols[index_column] = idx_col
    memo = {}   # each input's layout values and window sums, shared
    for ae in aggs:
        name, col = _rolling_one(ae, table, gctx, lo, hi, longest, memo)
        if name in cols:
            raise ComputeError(f"duplicate column {name!r}")
        names.append(name)
        cols[name] = col
    return Table(names, cols, cap, table._nrows, table.valid,
                 nrows_dev=table.nrows_dev, device=table.device)


def _memo(memo: dict, key, make):
    if key not in memo:
        memo[key] = make()
    return memo[key]


def _rolling_one(ae: Expr, table: Table, gctx, lo, hi, longest: int,
                 memo: dict):
    e = ae
    name = meta.output_name(ae)
    while e.kind in ("alias", "name_map"):
        e = e.children[0]
    if e.kind == "table_len":
        # pl.len(): the window's rows (the JAX package takes only
        # column aggregates here)
        length = (hi - lo).clamp(min=0).to(torch.int64)
        return name, Column(UInt32, torch.empty_like(length).scatter_(
            0, gctx.perm, length), None, None)
    if e.kind != "agg" or e.attrs["agg"] not in _ROLL_AGGS:
        raise InvalidOperationError(
            f"rolling agg supports {sorted(_ROLL_AGGS)}, got "
            f"{e.fingerprint()}")
    agg = e.attrs["agg"]
    cap = table.capacity
    perm = gctx.perm
    nl = R.levels_for(longest)
    fp = e.children[0].fingerprint()

    def layout():
        v = eval_expr(e.children[0], table, "agg")
        x = v.data.expand(cap)[perm]
        xv = v.valid_or_true().expand(cap)[perm] & gctx.live_sorted
        cnt = (hi - lo).clamp(min=0) if v.validity is None else \
            R.window_sum(xv, lo, hi, nl)
        return v, x, xv, cnt
    v, x, xv, cnt = _memo(memo, ("in", fp), layout)
    dt = v.dtype

    def back(arr, validity, out_dt):
        data = torch.empty_like(arr).scatter_(0, perm, arr)
        valid = None if validity is None else \
            torch.empty_like(validity).scatter_(0, perm, validity)
        return name, Column(out_dt, data, valid, v.sdict)

    if agg == "count":
        return back(cnt.to(torch.int64), None, UInt32)
    if agg == "len":
        return back((hi - lo).clamp(min=0).to(torch.int64), None, UInt32)
    if agg in ("sum", "mean", "std", "var"):
        acc = torch.float64 if dt.is_float else torch.int64
        xa = torch.where(xv, x, torch.zeros_like(x)).to(acc)
        s = _memo(memo, ("sum", fp), lambda: R.window_sum(xa, lo, hi, nl))
        if agg == "sum":
            out_dt = _sum_dtype(dt)
            return back(s.to(storage_torch_dtype(out_dt)), cnt > 0, out_dt)
        out_dt = _float_dt(dt)
        stor = storage_torch_dtype(out_dt)
        n = cnt.clamp(min=1).to(torch.float64)
        s = s.to(torch.float64)
        if agg == "mean":
            return back((s / n).to(stor), cnt > 0, out_dt)
        s2 = R.window_sum(xa.to(torch.float64) ** 2, lo, hi, nl)
        var = ((s2 - s * s / n) / (cnt - 1).clamp(min=1)).clamp(min=0)
        out = torch.sqrt(var) if agg == "std" else var
        return back(out.to(stor), cnt > 1, out_dt)
    if agg in ("min", "max"):
        lo_b, hi_b = _type_bounds(x.dtype)
        fill = hi_b if agg == "min" else lo_b
        levels = R.build_sparse(torch.where(xv, x, torch.full_like(x, fill)),
                                agg, nl, fill)
        return back(R.range_query(levels, lo, hi, agg, fill), cnt > 0, dt)
    p = (lo if agg == "first" else hi - 1).clamp(0, cap - 1)
    return back(x[p], (hi > lo) & xv[p], dt)
