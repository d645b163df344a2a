"""Top-level frame constructors and functions (the subset the port has
so far; parity target: `py-polars/src/polars/functions/`). `col`, `lit`
and `len` live in `expr/expr.py`, as in the JAX package."""

from __future__ import annotations

from typing import Sequence

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
    return d.replace(year=y, month=m, day=min(d.day, last))


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
    step = max(ns // (86_400 * 1_000_000_000), 1)
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
    step = max(ns // (1_000_000_000 // UNIT_PER_SECOND[time_unit])
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
    out = list(range(nanos(s), nanos(e) + 1, max(ns, 1)))
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
    if not all(isinstance(p, (int, float)) for p in parts):
        raise ComputeError("pl.duration with expression parts not "
                           "supported yet")
    td = _dt.timedelta(weeks=weeks, days=days, hours=hours, minutes=minutes,
                       seconds=seconds, milliseconds=milliseconds,
                       microseconds=microseconds)
    return Expr("lit", value=td, dtype=Duration(time_unit))


def date(year, month, day) -> Expr:
    import datetime as _dt
    if all(isinstance(v, int) for v in (year, month, day)):
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
