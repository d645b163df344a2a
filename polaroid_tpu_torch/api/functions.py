"""Top-level frame constructors and functions (parity target:
`py-polars/src/polars/functions/`, as the JAX package's
`api/functions.py`). `col`, `lit` and `len` live in `expr/expr.py`, as in
the JAX package. The readers and scans (`read_*`, `scan_*`, `from_arrow`,
`from_pandas`, `from_dataframe`), the sink partitioning and credential
classes and `collect_all_async` come with the host IO and streaming
slices (ROADMAP.md). Constructors put their frame on the package default
device unless given `device=`."""

from __future__ import annotations

import builtins
from typing import Sequence

import numpy as np

from ..dtypes import Float64
from ..errors import ComputeError
from ..expr.expr import Expr, col


def from_dict(data, schema=None, device=None):
    from .frame import DataFrame
    return DataFrame(data, schema=schema, device=device)


def _pair(a, b):
    """Both inputs as Float64 over the rows where both are valid."""
    a = col(a) if isinstance(a, str) else a
    b = col(b) if isinstance(b, str) else b
    pair = a.is_not_null() & b.is_not_null()
    return a.filter(pair).cast(Float64), b.filter(pair).cast(Float64)


def corr(a, b, ddof: int = 1) -> Expr:
    """Pearson correlation by its sums, as the JAX package composes it:
    plain aggregations, so it is exact per group in a group-by and
    pairwise complete under nulls."""
    ax, bx = _pair(a, b)
    n = ax.count()
    sx, sy = ax.sum(), bx.sum()
    sxx, syy = (ax * ax).sum(), (bx * bx).sum()
    sxy = (ax * bx).sum()
    num = n * sxy - sx * sy
    den = (n * sxx - sx * sx).sqrt() * (n * syy - sy * sy).sqrt()
    return (num / den).alias("corr")


def cov(a, b, ddof: int = 1) -> Expr:
    """Covariance by its sums, over the rows where both are valid."""
    ax, bx = _pair(a, b)
    n = ax.count()
    return (((ax * bx).sum() - ax.sum() * bx.sum() / n)
            / (n - ddof)).alias("cov")


def rolling_cov(a, b, *, window_size: int, min_samples=None,
                ddof: int = 1) -> Expr:
    """Covariance of two columns over fixed trailing windows."""
    return Expr("rolling_pair", (_col_of(a), _col_of(b)), stat="cov",
                window_size=window_size, min_samples=min_samples, ddof=ddof)


def rolling_corr(a, b, *, window_size: int, min_samples=None,
                 ddof: int = 1) -> Expr:
    """Pearson correlation of two columns over fixed trailing windows."""
    return Expr("rolling_pair", (_col_of(a), _col_of(b)), stat="corr",
                window_size=window_size, min_samples=min_samples, ddof=ddof)


def _col_of(a) -> Expr:
    return col(a) if isinstance(a, str) else a


def concat(items: Sequence, how: str = "vertical", rechunk: bool = False):
    """Frames (or lazy frames, as a union node) stacked vertically
    ("vertical", "vertical_relaxed"), by the union of their columns
    ("diagonal", "diagonal_relaxed"), or side by side ("horizontal")."""
    items = list(items)
    if not items:
        raise ComputeError("concat needs at least one item")
    from .frame import DataFrame
    from .lazyframe import LazyFrame
    from ..plan import logical as L
    if isinstance(items[0], LazyFrame):
        if how == "horizontal":
            return LazyFrame._from_plan(L.HConcat([i._plan for i in items]))
        return LazyFrame._from_plan(L.Union([i._plan for i in items], how))
    if how in ("vertical", "vertical_relaxed", "diagonal",
               "diagonal_relaxed"):
        from ..ops.concat import vstack_tables
        hw = "vertical" if how.startswith("vertical") else "diagonal"
        return DataFrame._from_table(
            vstack_tables([i._table for i in items], hw))
    if how == "horizontal":
        out = items[0]
        for i in items[1:]:
            out = out.hstack(i)
        return out
    raise ComputeError(f"unknown concat strategy {how!r}")


# --- time (Slice D2) ------------------------------------------------------

def _wrap_col(x) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, str):
        return col(x)
    return Expr("lit", value=x, dtype=None)


def _month_advance(d, n: int):
    """A date or datetime moved by n months, the day saturated to the
    month's end."""
    m = d.month - 1 + n
    y = d.year + m // 12
    m = m % 12 + 1
    leap = y % 4 == 0 and (y % 100 != 0 or y % 400 == 0)
    last = [31, 29 if leap else 28, 31, 30, 31, 30, 31, 31, 30, 31, 30,
            31][m - 1]
    return d.replace(year=y, month=m, day=builtins.min(d.day, last))


def date_range(start, end, interval: str = "1d", *, closed: str = "both",
               eager: bool = False):
    """Dates (or datetimes, when an end is a datetime) from start to end
    every `interval`, built on the host. eager=True gives a Series; the
    lazy form is a column literal of Date (Datetime) values, which the
    JAX package gives as Int64 day counts."""
    import datetime as _dt
    import numpy as np
    from ..ops.temporal import parse_every
    from .series import Series
    kind, n = parse_every(interval)
    is_dt = isinstance(start, _dt.datetime) or isinstance(end, _dt.datetime)
    if kind == "months":
        def advance(d):
            return _month_advance(d, n)
    else:
        delta = _dt.timedelta(microseconds=n / 1000) if is_dt else \
            _dt.timedelta(days=n // (86_400 * 1_000_000_000))

        def advance(d):
            return d + delta
    out = []
    cur = start
    while cur <= end:
        out.append(cur)
        nxt = advance(cur)
        if nxt == cur:
            break
        cur = nxt
    if closed == "left":
        out = [d for d in out if d != end]
    elif closed == "none":
        out = out[1:-1]
    elif closed == "right":
        out = [d for d in out if d != start]
    if eager:
        return Series("literal", out)
    if is_dt:
        from ..dtypes import Datetime
        return Expr("lit", value=np.asarray(out, dtype="datetime64[us]")
                    .astype(np.int64), dtype=Datetime("us"))
    from ..dtypes import Date
    return Expr("lit", value=np.asarray(
        [(d - _dt.date(1970, 1, 1)).days for d in out]), dtype=Date)


def datetime_range(start, end, interval: str = "1d", *,
                   closed: str = "both", eager: bool = False, **kw):
    return date_range(start, end, interval, closed=closed, eager=eager)


def date_ranges(start, end, interval: str = "1d", **kw) -> Expr:
    """Per-row dates from start to end (both ends in) every `interval`
    of whole days, as a List(Date) column, as polars gives it (the JAX
    package's elements are the Int64 day counts)."""
    from ..dtypes import Date, Int64
    from ..ops.temporal import parse_every
    kind, ns = parse_every(interval)
    if kind != "fixed":
        raise ComputeError("date_ranges: month intervals unsupported")
    step = builtins.max(ns // (86_400 * 1_000_000_000), 1)
    return Expr("int_ranges", (_wrap_col(start).cast(Date).cast(Int64),
                               _wrap_col(end).cast(Date).cast(Int64) + 1),
                step=int(step), dtype=Date).alias("date_range")


def datetime_ranges(start, end, interval: str = "1d", *,
                    time_unit: str = "us", **kw) -> Expr:
    """Per-row datetimes from start to end (both ends in) every fixed
    `interval`, as a List(Datetime) column."""
    from ..dtypes import Datetime, Int64
    from ..ops.temporal import UNIT_PER_SECOND, parse_every
    kind, ns = parse_every(interval)
    if kind != "fixed":
        raise ComputeError("datetime_ranges: month intervals unsupported")
    dt = Datetime(time_unit)
    step = builtins.max(ns // (1_000_000_000 // UNIT_PER_SECOND[time_unit])
               if UNIT_PER_SECOND[time_unit] <= 1_000_000_000 else ns, 1)
    return Expr("int_ranges", (_wrap_col(start).cast(dt).cast(Int64),
                               _wrap_col(end).cast(dt).cast(Int64) + 1),
                step=int(step), dtype=dt).alias("datetime_range")


def time_range(start=None, end=None, interval: str = "1h", *,
               eager: bool = False, **kw):
    """Times of day from start to end every `interval` (a Time column:
    nanoseconds since midnight)."""
    import datetime as _dt
    import numpy as np
    from ..dtypes import Time
    from ..ops.temporal import parse_every
    from .series import Series
    s = start or _dt.time(0)
    e = end or _dt.time(23, 59, 59, 999999)
    _, ns = parse_every(interval)

    def nanos(t):
        return (t.hour * 3600 + t.minute * 60 + t.second) * 10 ** 9 \
            + t.microsecond * 1000
    out = list(range(nanos(s), nanos(e) + 1, builtins.max(ns, 1)))
    if eager:
        return Series("literal", out, dtype=Time)
    return Expr("lit", value=np.asarray(out, np.int64), dtype=Time) \
        .alias("time")


def time_ranges(*args, **kwargs):
    raise ComputeError("time_ranges (per-row) not supported; use time_range")


def datetime(year, month, day, hour=0, minute=0, second=0, microsecond=0,
             *, time_unit: str = "us", eager=False) -> Expr:
    """A Datetime from calendar fields (expressions, column names or
    ints) by the civil calendar on the device."""
    return Expr("datetime_components",
                (_wrap_col(year), _wrap_col(month), _wrap_col(day)),
                hour=hour, minute=minute, second=second,
                microsecond=microsecond, time_unit=time_unit)


def duration(*, weeks=0, days=0, hours=0, minutes=0, seconds=0,
             milliseconds=0, microseconds=0, time_unit: str = "us") -> Expr:
    import datetime as _dt
    from ..dtypes import Duration
    parts = (weeks, days, hours, minutes, seconds, milliseconds,
             microseconds)
    if not builtins.all(isinstance(p, (int, float)) for p in parts):
        raise ComputeError("pl.duration with expression parts not "
                           "supported yet")
    td = _dt.timedelta(weeks=weeks, days=days, hours=hours, minutes=minutes,
                       seconds=seconds, milliseconds=milliseconds,
                       microseconds=microseconds)
    return Expr("lit", value=td, dtype=Duration(time_unit))


def date(year, month, day) -> Expr:
    import datetime as _dt
    if builtins.all(isinstance(v, int) for v in (year, month, day)):
        return Expr("lit", value=_dt.date(year, month, day), dtype=None)
    return Expr("dt", (datetime(year, month, day),), op="date")


def time(hour=0, minute=0, second=0, microsecond=0) -> Expr:
    from ..dtypes import Time
    ns = ((int(hour) * 3600 + int(minute) * 60 + int(second))
          * 1_000_000_000 + int(microsecond) * 1000)
    return Expr("lit", value=ns, dtype=Time)


def from_epoch(column, time_unit: str = "us") -> Expr:
    from ..dtypes import Datetime
    e = _wrap_col(column)
    if time_unit == "s":
        e = e * 1_000_000
        time_unit = "us"
    return e.cast(Datetime(time_unit))


def row_index() -> Expr:
    """Each live row's position among the live rows (UInt32)."""
    return Expr("row_index")


# --- strings and nested columns (Slice E2) --------------------------------

def _flatten(items):
    out = []
    for x in items:
        if isinstance(x, (list, tuple)):
            out.extend(_flatten(x))
        else:
            out.append(x)
    return out


def concat_str(*exprs, separator: str = "") -> Expr:
    """The parts joined per row (a null part makes the row null)."""
    return Expr("concat_str", tuple(_wrap_col(e) for e in _flatten(exprs)),
                separator=separator)


def format(fmt: str, *args) -> Expr:
    """String interpolation: pl.format("a={}", col) as a concat_str."""
    from ..dtypes import String
    from ..expr.expr import lit
    parts = fmt.split("{}")
    if len(parts) - 1 != len(args):
        raise ComputeError("format placeholder count != number of args")
    es = []
    for i, p in enumerate(parts):
        if p:
            es.append(lit(p))
        if i < len(args):
            es.append(_wrap_col(args[i]).cast(String))
    return Expr("concat_str", tuple(es), separator="")


def concat_list(*exprs) -> Expr:
    """Flat or list columns combined into one list per row."""
    return Expr("concat_list", tuple(_wrap_col(e) for e in _flatten(exprs)))


def struct(*exprs, **named) -> Expr:
    from ..expr.expr import struct as _struct
    return _struct(*exprs, **named)


def implode(name) -> Expr:
    return _wrap_col(name).implode()


def int_ranges(start, end, step: int = 1) -> Expr:
    """Per-row integer ranges [start, end) as a List(Int64) column."""
    return Expr("int_ranges", (_wrap_col(start), _wrap_col(end)), step=step)


def element() -> Expr:
    """The current list element inside `.list.eval`."""
    from ..expr.expr import element as _element
    return _element()


def field(name) -> Expr:
    """A sibling struct field inside `struct.with_fields`."""
    names = [name] if isinstance(name, str) else list(name)
    if len(names) != 1:
        from ..errors import InvalidOperationError
        raise InvalidOperationError("pl.field supports one name")
    return Expr("field", name=names[0])


def escape_regex(value: str) -> str:
    import re
    return re.escape(value)


# --- constructors ---------------------------------------------------------

def from_records(records, schema=None, device=None):
    """A frame from row tuples (with `schema` names) or row dicts."""
    rows = list(records)
    if rows and isinstance(rows[0], dict):
        return from_dicts(rows, schema=schema, device=device)
    names = list(schema.keys()) if isinstance(schema, dict) else (
        list(schema) if schema is not None else
        [f"column_{i}" for i in range(len(rows[0]) if rows else 0)])
    cols = {n: [r[i] for r in rows] for i, n in enumerate(names)}
    return from_dict(cols, schema=schema if isinstance(schema, dict)
                     else None, device=device)


def from_dicts(dicts, schema=None, device=None):
    """A frame from row dicts: the columns in order of first sight, a
    missing key null."""
    from .frame import DataFrame
    rows = list(dicts)
    keys = []
    for r in rows:
        keys.extend(k for k in r if k not in keys)
    cols = {k: [r.get(k) for r in rows] for k in keys}
    return DataFrame(cols, schema=schema, device=device)


def from_numpy(arr, schema=None, device=None):
    """A frame from a 1- or 2-D array, one column per array column."""
    arr = np.asarray(arr)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    names = list(schema) if isinstance(schema, (list, tuple, dict)) else \
        [f"column_{i}" for i in range(arr.shape[1])]
    return from_dict({n: arr[:, i] for i, n in enumerate(names)},
                     device=device)


def from_torch(tensor, schema=None, device=None):
    """A frame from a 1- or 2-D tensor, one column per tensor column, on
    `device` (the package default unless given). Each column is copied
    tensor to tensor, so a tensor already on that device never passes
    through the host."""
    import torch
    from ..batch import Column, Table, resolve_device, storage_torch_dtype
    from ..config import capacity_for
    from ..dtypes import dtype_from_numpy
    from .frame import DataFrame
    dev = resolve_device(device)
    t = tensor.detach()
    if t.dim() == 1:
        t = t.reshape(-1, 1)
    if t.dim() != 2:
        raise ComputeError(f"from_torch takes a 1- or 2-D tensor, not "
                           f"{t.dim()}-D")
    if t.dtype == torch.uint64:
        t = t.view(torch.int64)     # the bits, as UInt64's storage holds
    n, w = t.shape
    dt = dtype_from_numpy(torch.empty(0, dtype=tensor.dtype).numpy().dtype)
    names = list(schema) if isinstance(schema, (list, tuple, dict)) else \
        [f"column_{i}" for i in range(w)]
    cap = capacity_for(n)
    stor = storage_torch_dtype(dt)
    cols = {}
    for i, name in enumerate(names):
        data = torch.zeros(cap, dtype=stor, device=dev)
        data[:n] = t[:, i].to(device=dev, dtype=stor)
        cols[name] = Column(dt, data)
    return DataFrame._from_table(Table(names, cols, cap, n, None,
                                       device=dev))


def from_repr(text: str, device=None):
    """A frame parsed back from its printed table."""
    lines = [ln for ln in text.splitlines() if "│" in ln]
    if len(lines) < 2:
        raise ComputeError("no table found in repr text")
    rows = [[c.strip() for c in ln.strip().strip("│").split("│")]
            for ln in lines]
    names = rows[0]
    dtypes = rows[1] if rows[1] and rows[1][0] and \
        not rows[1][0][0].isdigit() else None
    cols = {n: [] for n in names}

    def cell(s):
        if s in ("null", ""):
            return None
        if s in ("true", "false"):
            return s == "true"
        for conv in (int, float):
            try:
                return conv(s)
            except ValueError:
                pass
        return s.strip('"')
    for r in rows[2:] if dtypes else rows[1:]:
        for n, c in zip(names, r):
            cols[n].append(cell(c))
    return from_dict(cols, device=device)


def json_normalize(data, *, separator: str = ".", max_level=None,
                   device=None):
    """Nested dicts flattened into `separator`-joined columns."""
    rows = data if isinstance(data, list) else [data]

    def flatten(d, prefix="", level=0):
        out = {}
        for k, v in d.items():
            key = f"{prefix}{separator}{k}" if prefix else str(k)
            if isinstance(v, dict) and (max_level is None
                                        or level < max_level):
                out.update(flatten(v, key, level + 1))
            else:
                out[key] = v
        return out
    return from_dicts([flatten(r) for r in rows], device=device)


def select(*exprs, device=None, **named):
    """Expressions evaluated against an empty frame."""
    from .frame import DataFrame
    return DataFrame({}, device=device).select(*exprs, **named)


# --- ranges and constant series ---------------------------------------------

def int_range(start, end=None, step: int = 1, *, eager: bool = False,
              dtype=None, device=None):
    """0..n (or start..end) by `step`: a literal column, or a Series with
    `eager`."""
    from ..dtypes import Int64
    if end is None:
        start, end = 0, start
    vals = np.arange(start, end, step, dtype=np.int64)
    if eager:
        from .series import Series
        return Series("literal", vals, dtype=dtype or Int64, device=device)
    return Expr("lit", value=vals, dtype=dtype or Int64).alias("int")


def arange(start, end=None, step: int = 1, *, eager: bool = False,
           dtype=None, device=None):
    return int_range(start, end, step, eager=eager, dtype=dtype,
                     device=device)


def repeat(value, n: int, *, eager: bool = False, dtype=None, device=None):
    if eager:
        from .series import Series
        return Series("repeat", [value] * n, dtype=dtype, device=device)
    return Expr("lit", value=value, dtype=dtype)


def ones(n: int, dtype=None, *, eager: bool = True, device=None):
    from .series import Series
    return Series("ones", [1] * n, dtype=dtype, device=device)


def zeros(n: int, dtype=None, *, eager: bool = True, device=None):
    from .series import Series
    return Series("zeros", [0] * n, dtype=dtype, device=device)


def linear_space(start: float, end: float, num_samples: int, *,
                 eager: bool = True, device=None):
    vals = np.linspace(start, end, num_samples)
    if eager:
        from .series import Series
        return Series("literal", list(vals), device=device)
    return Expr("lit", value=list(vals), dtype=None)


def linear_spaces(start, end, num_samples, *, eager: bool = False, **kw):
    raise ComputeError("linear_spaces (per-row) not supported; "
                       "use linear_space")


# --- expression builders ----------------------------------------------------

def all(*names) -> Expr:
    if not names:
        return Expr("wildcard")
    if len(names) == 1 and isinstance(names[0], str):
        return col(names[0]).all()
    acc = _wrap_col(names[0])
    for n in names[1:]:
        acc = acc & _wrap_col(n)
    return acc


def any(*names) -> Expr:
    if len(names) == 1 and isinstance(names[0], str):
        return col(names[0]).any()
    acc = _wrap_col(names[0])
    for n in names[1:]:
        acc = acc | _wrap_col(n)
    return acc


def exclude(*names) -> Expr:
    """Every column but `names` (polars' `pl.exclude`; the JAX package's
    raises here, ROADMAP Queue 3)."""
    return Expr("wildcard").exclude(*_flatten(names))


def min(*exprs) -> Expr:
    if len(exprs) == 1:
        return _wrap_col(exprs[0]).min()
    return min_horizontal(*exprs)


def max(*exprs) -> Expr:
    if len(exprs) == 1:
        return _wrap_col(exprs[0]).max()
    return max_horizontal(*exprs)


def sum(*exprs) -> Expr:
    if len(exprs) == 1 and not isinstance(exprs[0], (list, tuple)):
        return _wrap_col(exprs[0]).sum()
    return sum_horizontal(*exprs)


def mean(e) -> Expr:
    return _wrap_col(e).mean()


def median(*columns) -> Expr:
    return _wrap_col(_flatten(columns)[0]).median()


def std(e, ddof: int = 1) -> Expr:
    return _wrap_col(e).std(ddof)


def var(e, ddof: int = 1) -> Expr:
    return _wrap_col(e).var(ddof)


def n_unique(*columns) -> Expr:
    return _wrap_col(_flatten(columns)[0]).n_unique()


def approx_n_unique(column) -> Expr:
    return _wrap_col(column).n_unique()


def count(e=None) -> Expr:
    if e is None:
        return Expr("table_len")
    return _wrap_col(e).count()


def quantile(column, q: float, interpolation: str = "nearest") -> Expr:
    return _wrap_col(column).quantile(q, interpolation)


def first(column=None) -> Expr:
    from ..expr.expr import first as _first
    return _first() if column is None else _wrap_col(column).first()


def last(column=None) -> Expr:
    from ..expr.expr import last as _last
    return _last() if column is None else _wrap_col(column).last()


def nth(*indices) -> Expr:
    from ..expr.expr import nth as _nth
    return _nth(*indices)


def head(column, n: int = 10) -> Expr:
    return _wrap_col(column).head(n)


def tail(column, n: int = 10) -> Expr:
    return _wrap_col(column).tail(n)


def min_horizontal(*exprs) -> Expr:
    from ..expr.expr import when
    es = [_wrap_col(e) for e in _flatten(exprs)]
    acc = es[0]
    for e in es[1:]:
        acc = when(acc.is_null() | (e.is_not_null() & (e < acc))) \
            .then(e).otherwise(acc)
    return acc.alias("min")


def max_horizontal(*exprs) -> Expr:
    from ..expr.expr import when
    es = [_wrap_col(e) for e in _flatten(exprs)]
    acc = es[0]
    for e in es[1:]:
        acc = when(acc.is_null() | (e.is_not_null() & (e > acc))) \
            .then(e).otherwise(acc)
    return acc.alias("max")


def sum_horizontal(*exprs) -> Expr:
    es = [_wrap_col(e) for e in _flatten(exprs)]
    acc = es[0].fill_null(0)
    for e in es[1:]:
        acc = acc + e.fill_null(0)
    return acc.alias("sum")


def mean_horizontal(*exprs) -> Expr:
    from ..dtypes import Int64
    es = [_wrap_col(e) for e in _flatten(exprs)]
    total = es[0].fill_null(0)
    cnt = es[0].is_not_null().cast(Int64)
    for e in es[1:]:
        total = total + e.fill_null(0)
        cnt = cnt + e.is_not_null().cast(Int64)
    return (total / cnt).alias("mean")


def any_horizontal(*exprs) -> Expr:
    es = [_wrap_col(e) for e in _flatten(exprs)]
    acc = es[0]
    for e in es[1:]:
        acc = acc | e
    return acc.alias("any")


def all_horizontal(*exprs) -> Expr:
    es = [_wrap_col(e) for e in _flatten(exprs)]
    acc = es[0]
    for e in es[1:]:
        acc = acc & e
    return acc.alias("all")


def cum_sum_horizontal(*exprs) -> Expr:
    from ..expr import meta
    es = [_wrap_col(e) for e in _flatten(exprs)]
    acc, fields = None, []
    for e in es:
        acc = e if acc is None else acc + e
        fields.append(acc.alias(meta.output_name(e)))
    return struct(*fields).alias("cum_sum")


def coalesce(*exprs) -> Expr:
    """The first non-null of the expressions, named after the first."""
    es = [_wrap_col(e) for e in _flatten(exprs)]
    acc = es[-1]
    for e in reversed(es[:-1]):
        acc = e.fill_null(acc)
    return acc


def fold(acc, function, exprs) -> Expr:
    """A horizontal fold with an accumulator; selectors among `exprs`
    expand against the schema when the plan is built."""
    acc_e = _wrap_col(acc) if isinstance(acc, (Expr, str)) else \
        Expr("lit", value=acc, dtype=None)
    es = tuple(_wrap_col(e) for e in _flatten([exprs]))
    return Expr("fold_exprs", (acc_e,) + es, function=function, mode="fold")


def reduce(function, exprs) -> Expr:
    es = tuple(_wrap_col(e) for e in _flatten([exprs]))
    return Expr("fold_exprs", (es[0],) + es, function=function,
                mode="reduce")


def cum_fold(acc, function, exprs) -> Expr:
    """fold keeping each step as a struct field."""
    from ..expr import meta
    out = _wrap_col(acc) if isinstance(acc, (Expr, str)) else \
        Expr("lit", value=acc, dtype=None)
    fields = []
    for e in _flatten([exprs]):
        e = _wrap_col(e)
        out = function(out, e)
        fields.append(out.alias(meta.output_name(e)))
    return struct(*fields).alias("cum_fold")


def cum_reduce(function, exprs) -> Expr:
    from ..expr import meta
    es = [_wrap_col(e) for e in _flatten([exprs])]
    out = es[0]
    fields = [out.alias(meta.output_name(es[0]))]
    for e in es[1:]:
        out = function(out, e)
        fields.append(out.alias(meta.output_name(e)))
    return struct(*fields).alias("cum_reduce")


def cum_sum(*columns) -> Expr:
    return _wrap_col(_flatten(columns)[0]).cum_sum()


def cum_count(*columns, reverse: bool = False) -> Expr:
    return _wrap_col(_flatten(columns)[0]).cum_count(reverse=reverse)


def arctan2(y, x) -> Expr:
    return Expr("binary", (_wrap_col(y), _wrap_col(x)), op="arctan2")


def arctan2d(y, x) -> Expr:
    return arctan2(y, x).degrees()


def arg_where(condition, *, eager: bool = False):
    if eager:
        raise TypeError("eager arg_where needs a Series input; use "
                        "Series.arg_true()")
    return _wrap_col(condition).arg_true()


def arg_sort_by(*exprs, descending=False) -> Expr:
    """The row indices that sort the frame by the expressions."""
    keys = [_wrap_col(e) for e in _flatten(exprs)]
    return Expr("row_index").sort_by(*keys, descending=descending)


def concat_arr(*exprs) -> Expr:
    return concat_list(*exprs)


def business_day_count(start, end) -> Expr:
    """Mondays to Fridays in [start, end) between two dates."""
    return Expr("business_day_count", (_wrap_col(start), _wrap_col(end)))


def map_batches(exprs, function, return_dtype=None) -> Expr:
    es = [_wrap_col(e) for e in _flatten([exprs])]
    if len(es) != 1:
        raise ComputeError("map_batches over multiple columns: pass one")
    return es[0].map_batches(function, return_dtype)


def map_groups(exprs, function, return_dtype=None, *,
               is_elementwise: bool = False,
               returns_scalar: bool = False) -> Expr:
    """A host function over each group's Series, one per input."""
    es = tuple(_wrap_col(x) for x in
               (exprs if isinstance(exprs, (list, tuple)) else [exprs]))
    return Expr("map_groups_udf", es, fn=function,
                return_dtype=return_dtype, returns_scalar=returns_scalar)


def groups(column: str) -> Expr:
    """Deprecated: `pl.col(column).agg_groups()`."""
    import warnings
    warnings.warn("pl.groups() is deprecated; use "
                  "pl.col(...).agg_groups() instead", DeprecationWarning,
                  stacklevel=2)
    return col(column).agg_groups()


def sql_expr(sql: str) -> Expr:
    """One SQL expression as an Expr."""
    from ..sql.parser import Parser, tokenize
    from ..sql.translate import translate_expr
    return translate_expr(Parser(tokenize(sql)).parse_expr(), None, None)


def sql(query: str, *, eager: bool = False):
    """SQL over the frames bound to names in the caller's scope."""
    import inspect
    from ..sql.context import SQLContext
    from .frame import DataFrame
    from .lazyframe import LazyFrame
    frame = inspect.currentframe().f_back
    ns = dict(frame.f_globals)
    ns.update(frame.f_locals)
    ctx = SQLContext()
    for name, obj in ns.items():
        if isinstance(obj, (DataFrame, LazyFrame)):
            ctx.register(name, obj)
    return ctx.execute(query, eager=eager)


# --- lazy frames ------------------------------------------------------------

def collect_all(lazy_frames, **kw):
    return [lf.collect(**kw) for lf in lazy_frames]


def collect_all_async(lazy_frames, **kw):
    """collect_all on a worker thread; returns a concurrent Future (on the
    card, as `LazyFrame.collect_async` runs)."""
    from .lazyframe import _submit
    lfs = list(lazy_frames)
    if not lfs:
        from ..batch import resolve_device
        import concurrent.futures as _fut
        fut = _fut.Future()
        fut.set_result([])
        return fut
    return _submit(lfs[0]._plan, lambda: [lf.collect(**kw) for lf in lfs])


def explain_all(lazy_frames, **kw) -> str:
    return "\n".join(lf.explain() for lf in lazy_frames)


def union(items, how: str = "vertical", **kw):
    return concat(items, how=how)


def align_frames(*frames, on, how: str = "outer", select=None):
    """The frames joined onto the union of their keys, in key order, so
    that each has the same key rows."""
    on_cols = [on] if isinstance(on, str) else list(on)
    keys = None
    for f in frames:
        k = f.select([col(c) for c in on_cols]).unique()
        keys = k if keys is None else concat([keys, k]).unique()
    keys = keys.sort(on_cols)
    out = []
    for f in frames:
        a = keys.join(f, on=on_cols, how="left").sort(on_cols)
        out.append(a if select is None else a.select(select))
    return out


# --- settings and information -----------------------------------------------

def set_random_seed(seed: int) -> None:
    """The seed that sampling without a seed of its own draws from."""
    from .. import config
    config.RANDOM_SEED = int(seed)


class StringCache:
    """A no-op: dictionaries are per column and merged on demand."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def enable_string_cache() -> None:
    return None


def disable_string_cache() -> None:
    return None


def using_string_cache() -> bool:
    return True


class Categories:
    """A handle for global categories: a no-op with per-column
    dictionaries."""

    def __init__(self, name: str = "") -> None:
        self.name = name


class GPUEngine:
    """Accepted for polars compatibility: every collect runs on the
    frame's device."""

    def __init__(self, **config) -> None:
        self.config = config


class QueryOptFlags:
    """Optimizer toggles (polars' QueryOptFlags)."""

    def __init__(self, *, predicate_pushdown=True, projection_pushdown=True,
                 slice_pushdown=True, comm_subplan_elim=True,
                 comm_subexpr_elim=True, **kw) -> None:
        self.predicate_pushdown = predicate_pushdown
        self.projection_pushdown = projection_pushdown
        self.slice_pushdown = slice_pushdown
        self.comm_subplan_elim = comm_subplan_elim
        self.comm_subexpr_elim = comm_subexpr_elim

    @classmethod
    def none(cls):
        return cls(predicate_pushdown=False, projection_pushdown=False,
                   slice_pushdown=False, comm_subplan_elim=False,
                   comm_subexpr_elim=False)


def build_info() -> dict:
    import torch
    return {"version": "0.1.0", "engine": "polaroid-tpu (torch)",
            "torch": torch.__version__, "cuda": torch.version.cuda}


def show_versions() -> None:
    for k, v in build_info().items():
        print(f"{k:10} {v}")


def get_index_type():
    from ..dtypes import UInt32
    return UInt32


def thread_pool_size() -> int:
    import os
    return os.cpu_count() or 1


threadpool_size = thread_pool_size
