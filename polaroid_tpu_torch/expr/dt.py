"""The `dt` namespace: calendar fields, truncation, time zones.

The port of the JAX package's `_eval_dt` (`expr/eval.py`) and its
dispatch. Every op but `strftime` is torch integer arithmetic over the
whole column (`ops/temporal.py`); a tz-aware Datetime stores UTC epochs,
and the calendar ops run on its local wall time (`ops/tzdata.py`: one
`searchsorted` into the zone's transition table), a tz-aware result
going back to UTC the same way. `strftime` formats on the host and
encodes the text into a `StringDict`, as the JAX package does.
"""

from __future__ import annotations

import datetime as _pydt

import numpy as np
import torch

from ..dtypes import Boolean, Date, Datetime, Duration, Int32, Int64, \
    String, Time
from ..errors import ComputeError, InvalidOperationError
from ..ops import temporal as T
from ..ops import tzdata as TZ
from ..strings import StringDict
from .eval import Val, cast_val, eval_expr, rescale_time

__all__ = ["eval_dt"]

# ops on the stored UTC epoch, whatever the column's time zone
_UTC_OPS = ("epoch", "timestamp", "cast_time_unit", "with_time_unit",
            "replace_time_zone", "convert_time_zone", "base_utc_offset",
            "dst_offset")
_DURATION_TOTALS = {"total_days": 86_400, "total_hours": 3_600,
                    "total_minutes": 60, "total_seconds": 1}


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def eval_dt(e, table, ctx: str) -> Val:
    v = eval_expr(e.children[0], table, ctx)
    tv = eval_expr(e.children[1], table, ctx) \
        if e.attrs.get("op") == "combine" else None
    out = _dt(e, v, tv)
    out.live = v.live
    return out


def _duration(op: str, e, v: Val) -> Val:
    x = v.data.to(torch.int64)
    per_s = T.UNIT_PER_SECOND[v.dtype.time_unit]

    def out(data, dt):
        return Val(dt, data, v.validity, None, v.is_scalar)

    if op in _DURATION_TOTALS:
        return out(_fdiv(x, per_s * _DURATION_TOTALS[op]), Int64)
    if op == "total_milliseconds":
        return out(_fdiv(x, max(per_s // 1_000, 1)), Int64)
    if op == "total_microseconds":
        return out(_fdiv(x, max(per_s // 1_000_000, 1)), Int64)
    if op == "total_nanoseconds":
        return out(x * (1_000_000_000 // per_s), Int64)
    if op == "cast_time_unit":
        return cast_val(v, Duration(e.attrs["time_unit"]))
    if op == "with_time_unit":
        return out(v.data, Duration(e.attrs["time_unit"]))
    raise InvalidOperationError(f".dt.{op} on Duration")


def _dt(e, v: Val, tv) -> Val:
    op = e.attrs["op"]
    dt = v.dtype
    if isinstance(dt, Duration):
        return _duration(op, e, v)
    x = v.data
    if dt == Date:
        days, frac, tu = x.to(torch.int32), None, None
    elif isinstance(dt, Datetime):
        tu = dt.time_unit
        days, frac = T.epoch_to_days(x, tu), T.time_of_day(x, tu)
    else:
        raise InvalidOperationError(f".dt.{op} on {dt!r}")
    tzname = dt.time_zone if isinstance(dt, Datetime) else None
    local = bool(tzname) and tzname != "UTC" and op not in _UTC_OPS
    if local:
        x = TZ.localize(x, tu, tzname)
        days, frac = T.epoch_to_days(x, tu), T.time_of_day(x, tu)

    def out(data, out_dt):
        if local and isinstance(out_dt, Datetime) and out_dt.time_zone:
            data = TZ.delocalize(data, out_dt.time_unit, out_dt.time_zone)
        return Val(out_dt, data, v.validity, None, v.is_scalar)

    def with_days(new_days):
        """The same time of day on other days (a Date stays a Date)."""
        if dt == Date:
            return out(new_days.to(torch.int32), Date)
        return out(new_days.to(x.dtype) * T.per_day(tu) + frac, dt)

    if op in ("year", "quarter", "month", "day"):
        y, m, d = T.days_to_civil(days)
        res = _fdiv(m - 1, 3) + 1 if op == "quarter" else \
            {"year": y, "month": m, "day": d}[op]
        return out(res.to(torch.int32), Int32)
    if op == "is_leap_year":
        y, _, _ = T.days_to_civil(days)
        leap = (torch.remainder(y, 4) == 0) & \
            ((torch.remainder(y, 100) != 0) | (torch.remainder(y, 400) == 0))
        return out(leap, Boolean)
    if op == "iso_year":
        y, _, _ = T.days_to_civil(days)
        one = torch.ones_like(y)
        doy = days.to(torch.int64) - T.civil_to_days(y, one, one) + 1
        raw = _fdiv(doy - T.weekday(days) + 10, 7)
        iso_y = torch.where(raw < 1, y - 1, torch.where(
            raw > 52, torch.where(T.iso_week(days) == 1, y + 1, y), y))
        return out(iso_y.to(torch.int32), Int32)
    if op in ("month_start", "month_end", "days_in_month"):
        y, m, _ = T.days_to_civil(days)
        one = torch.ones_like(m)
        first = T.civil_to_days(y, m, one)
        nxt = T.civil_to_days(torch.where(m == 12, y + 1, y),
                              torch.where(m == 12, one, m + 1), one)
        if op == "days_in_month":
            return out((nxt - first).to(torch.int32), Int32)
        return with_days(first if op == "month_start" else nxt - 1)
    if op in ("century", "millennium"):
        y, _, _ = T.days_to_civil(days)
        span = 100 if op == "century" else 1000
        return out((_fdiv(y - 1, span) + 1).to(torch.int32), Int32)
    if op == "time":
        if frac is None:
            return out(torch.zeros_like(days, dtype=torch.int64), Time)
        return out(frac.to(torch.int64)
                   * (1_000_000_000 // T.UNIT_PER_SECOND[tu]), Time)
    if op == "with_time_unit":
        return out(x, Datetime(e.attrs["time_unit"]))
    if op == "datetime":
        return cast_val(v, Datetime("us")) if dt == Date else v
    if op in ("base_utc_offset", "dst_offset"):
        if not tzname or tzname == "UTC":
            return out(torch.zeros_like(x, dtype=torch.int64),
                       Duration("ms"))
        off = TZ.utc_offset(x.to(torch.int64), tu, tzname,
                            dst_only=op == "dst_offset",
                            base_only=op == "base_utc_offset")
        return out(rescale_time(off, tu, "ms"), Duration("ms"))
    if op == "is_business_day":
        return out(T.weekday(days) <= 5, Boolean)
    if op == "add_business_days":
        n = int(e.attrs["n"])
        wd0 = T.weekday(days).to(torch.int64) - 1          # Monday 0
        full, rem = divmod(abs(n), 5)
        if n >= 0:
            shift = full * 7 + rem + torch.where(wd0 + rem > 4, 2, 0)
        else:
            shift = -(full * 7 + rem + torch.where(wd0 - rem < 0, 2, 0))
        return with_days(days.to(torch.int64) + shift)
    if op == "replace":
        return _replace(e, dt, tu, x, days, frac, out)
    if op == "combine":
        tu2 = e.attrs.get("time_unit", "us")
        per_s = T.UNIT_PER_SECOND[tu2]
        tns = tv.data.to(torch.int64).expand(days.shape)
        tfrac = _fdiv(tns, 1_000_000_000 // per_s)
        validity = v.validity if tv.validity is None else (
            tv.validity if v.validity is None else v.validity & tv.validity)
        return Val(Datetime(tu2), days.to(torch.int64) * T.per_day(tu2)
                   + tfrac, validity, None, v.is_scalar)
    if op in ("strftime", "to_string"):
        return _strftime(e, v, dt, tu, x)
    if op == "ordinal_day":
        return out(T.ordinal_day(days), Int32)
    if op == "weekday":
        return out(T.weekday(days), Int32)
    if op == "week":
        return out(T.iso_week(days), Int32)
    if op in ("hour", "minute", "second", "millisecond", "microsecond",
              "nanosecond"):
        if frac is None:
            return out(torch.zeros_like(days), Int32)
        per_s = T.UNIT_PER_SECOND[tu]
        sec = _fdiv(frac, per_s)
        sub = frac - sec * per_s
        if op == "hour":
            res = _fdiv(sec, 3600)
        elif op == "minute":
            res = torch.remainder(_fdiv(sec, 60), 60)
        elif op == "second":
            res = torch.remainder(sec, 60)
        else:
            scale = {"millisecond": 1_000, "microsecond": 1_000_000,
                     "nanosecond": 1_000_000_000}[op]
            res = sub * (scale // per_s) if scale >= per_s \
                else _fdiv(sub, per_s // scale)
        return out(res.to(torch.int32), Int32)
    if op == "date":
        return out(days, Date)
    if op in ("timestamp", "epoch"):
        return _timestamp(e, dt, tu, x, days, out)
    if op == "truncate":
        if dt == Date:
            return out(T.truncate_days(days, e.attrs["every"]), Date)
        return out(T.truncate_epoch(x, tu, e.attrs["every"]), dt)
    if op == "cast_time_unit":
        return cast_val(v, Datetime(e.attrs["time_unit"], tzname))
    if op == "replace_time_zone":
        # the wall time stays; the stored UTC epoch moves
        if not isinstance(dt, Datetime):
            return out(x, dt)
        newtz = e.attrs["tz"]
        wall = TZ.localize(x, tu, tzname) if tzname and tzname != "UTC" \
            else x
        if newtz is None:
            return Val(Datetime(tu), wall, v.validity, None, v.is_scalar)
        epoch = wall if newtz == "UTC" else TZ.delocalize(wall, tu, newtz)
        return Val(Datetime(tu, newtz), epoch, v.validity, None,
                   v.is_scalar)
    if op == "convert_time_zone":
        if not tzname:
            raise InvalidOperationError(
                "convert_time_zone on a time-zone-naive datetime; call "
                "replace_time_zone first")
        return Val(Datetime(tu, e.attrs["tz"]), x, v.validity, None,
                   v.is_scalar)
    raise ComputeError(f"unknown dt op {op!r}")


def _replace(e, dt, tu, x, days, frac, out) -> Val:
    y, m, d = T.days_to_civil(days)
    a = e.attrs
    if a.get("year") is not None:
        y = torch.full_like(y, int(a["year"]))
    if a.get("month") is not None:
        m = torch.full_like(m, int(a["month"]))
    if a.get("day") is not None:
        d = torch.full_like(d, int(a["day"]))
    new_days = T.civil_to_days(y, m, d)
    if dt == Date:
        return out(new_days, Date)
    per_s = T.UNIT_PER_SECOND[tu]
    sec = _fdiv(frac, per_s)
    sub = frac - sec * per_s
    h = _fdiv(sec, 3600)
    mi = _fdiv(sec - h * 3600, 60)
    s2 = sec - h * 3600 - mi * 60
    if a.get("hour") is not None:
        h = torch.full_like(h, int(a["hour"]))
    if a.get("minute") is not None:
        mi = torch.full_like(mi, int(a["minute"]))
    if a.get("second") is not None:
        s2 = torch.full_like(s2, int(a["second"]))
    if a.get("microsecond") is not None:
        sub = torch.full_like(sub, int(a["microsecond"])
                              * (per_s // 1_000_000))
    f3 = (h * 3600 + mi * 60 + s2) * per_s + sub
    return out(new_days.to(x.dtype) * T.per_day(tu) + f3, dt)


def _timestamp(e, dt, tu, x, days, out) -> Val:
    tgt = e.attrs.get("time_unit", "us")
    if tgt in ("s", "d"):
        unit = tu or "us"
        base = x.to(torch.int64) if dt != Date else \
            days.to(torch.int64) * T.per_day(unit)
        per = T.UNIT_PER_SECOND[unit] * (86_400 if tgt == "d" else 1)
        return out(_fdiv(base, per), Int64)
    if dt == Date:
        return out(days.to(torch.int64) * T.per_day(tgt), Int64)
    return out(rescale_time(x, tu, tgt).to(torch.int64), Int64)


def _strftime(e, v: Val, dt, tu, x) -> Val:
    """Format on the host (one copy of the column and a Python loop over
    its rows) and encode the text into a sorted dictionary."""
    fmt = e.attrs.get("format") or "%Y-%m-%d %H:%M:%S"
    vals = x.cpu().numpy()
    if dt == Date:
        objs = vals.astype("datetime64[D]").astype(_pydt.date)
    else:
        objs = vals.astype(f"datetime64[{tu}]").astype(_pydt.datetime)
    txt = np.array([o.strftime(fmt) if o is not None else ""
                    for o in objs], dtype=object)
    mask = v.valid_or_true().cpu().numpy()
    codes, sdict = StringDict.encode(txt, mask)
    return Val(String, torch.from_numpy(np.asarray(codes, np.int32))
               .to(x.device), v.validity, sdict, v.is_scalar)
