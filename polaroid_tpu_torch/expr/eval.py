"""Expression evaluation over device tables: the elementwise subset.

The port of the elementwise part of the JAX package's `expr/eval.py`:
column references, literals, arithmetic, comparisons, Kleene boolean
logic, casts between numeric and temporal types, temporal literals and
arithmetic (Date, Datetime, Duration), `pl.datetime` from expressions,
`when/then/otherwise`, aliases and null propagation. Every operation is
a torch op over whole fixed-capacity columns; dead rows compute garbage
that is never read as a result. Scalars are (1,) tensors that
broadcast. The order-dependent ops (`window`, `fill_null`,
`rolling_cov`/`rolling_corr`) live in `expr/window.py`, `.over()` in
`ops/window_over.py` and the `dt` namespace in `expr/dt.py`.

The rest of that file (strings, lists, aggregations in a select
context) comes with later slices and raises NotImplementedError here. `expr.filter(pred)` is ported inside a
group-by aggregation: it keeps every row and narrows the rows that take
part in the aggregate (`Val.live`), as the JAX package's does.
"""

from __future__ import annotations

import datetime as _pydt
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..batch import Column, Table, storage_torch_dtype
from ..dtypes import Boolean, DataType, Date, Datetime, Duration, Float32, \
    Float64, Int64, Null, String, UInt32, supertype
from ..errors import InvalidOperationError
from ..ops import temporal as T
from ..strings import EMPTY_DICT, NULL_CODE, StringDict
from . import meta
from .expr import Expr

__all__ = ["Val", "eval_expr", "val_to_column"]

_CMP_OPS = {"eq", "neq", "lt", "le", "gt", "ge"}
_BOOL_OPS = {"and", "or", "xor"}
# expression kinds evaluated by expr/window.py, and their functions there
_WINDOW_KINDS = {"window": "eval_window", "fill_null": "eval_fill_null",
                 "fill_null_strategy": "eval_fill_null_strategy",
                 "rolling_pair": "eval_rolling_pair"}


class Val:
    """Evaluation result: device data + validity (+ live override).

    data shape: (capacity,) for row-wise results, (1,) for scalars.
    `live`: an optional bool mask of the rows that take part in an
    aggregate of this value (set by `expr.filter(pred)`, carried through
    elementwise ops), beside the table's live rows."""

    __slots__ = ("dtype", "data", "validity", "sdict", "is_scalar", "live")

    def __init__(self, dtype, data, validity=None, sdict=None,
                 is_scalar=False, live=None):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.sdict = sdict
        self.is_scalar = is_scalar
        self.live = live

    def valid_or_true(self):
        if self.validity is None:
            return torch.ones(self.data.shape, dtype=torch.bool,
                              device=self.data.device)
        return self.validity


def _and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _float_dt(dt):
    return Float32 if dt == Float32 else Float64


def _sum_dtype(dt: DataType) -> DataType:
    if dt.is_integer:
        return Int64 if dt.is_signed_integer or dt.bit_width() < 64 else dt
    return dt


def _type_bounds(tdt: torch.dtype):
    """(lowest, highest) value of a storage dtype: -inf/inf for floats,
    False/True (as 0/1) for bool."""
    if tdt.is_floating_point:
        return -math.inf, math.inf
    if tdt == torch.bool:
        return 0, 1
    info = torch.iinfo(tdt)
    return info.min, info.max


# ---------------------------------------------------------------------------
# casting
# ---------------------------------------------------------------------------

def _with_live(out: Val, live) -> Val:
    """`out` with the rows that take part in an aggregate narrowed as its
    operand's were (`expr.filter`)."""
    out.live = live
    return out


def cast_val(v: Val, dtype: DataType) -> Val:
    if isinstance(dtype, type) and issubclass(dtype, DataType):
        dtype = dtype()
    if v.dtype == dtype:
        return v
    return _with_live(_cast(v, dtype), v.live)


def _cast(v: Val, dtype: DataType) -> Val:
    src, dst = v.dtype, dtype
    if src.is_string and dst.is_string and src.is_binary == dst.is_binary:
        # String <-> Categorical: same codes and dictionary, relabeled
        return Val(dst, v.data, v.validity, v.sdict, v.is_scalar)
    if src == Null:
        data = torch.zeros(v.data.shape, dtype=storage_torch_dtype(dst),
                           device=v.data.device)
        return Val(dst, data, torch.zeros(v.data.shape, dtype=torch.bool,
                                          device=v.data.device),
                   EMPTY_DICT if dst.is_string else None, v.is_scalar)
    if src.is_string or dst.is_string:
        raise NotImplementedError(
            f"cast {src!r} -> {dst!r} is not ported yet: casts to and from "
            "strings come with Slice E (the expression surface)")
    if src == Date and isinstance(dst, Datetime):
        data = v.data.to(torch.int64) * T.per_day(dst.time_unit)
        return Val(dst, data, v.validity, None, v.is_scalar)
    if isinstance(src, Datetime) and dst == Date:
        return Val(dst, T.epoch_to_days(v.data, src.time_unit), v.validity,
                   None, v.is_scalar)
    if (isinstance(src, Datetime) and isinstance(dst, Datetime)) or \
            (isinstance(src, Duration) and isinstance(dst, Duration)):
        return Val(dst, rescale_time(v.data, src.time_unit, dst.time_unit),
                   v.validity, None, v.is_scalar)
    if dst.is_bool:
        return Val(dst, v.data != 0, v.validity, None, v.is_scalar)
    return Val(dst, v.data.to(storage_torch_dtype(dst)), v.validity, None,
               v.is_scalar)


def rescale_time(data: torch.Tensor, src_unit: str, dst_unit: str
                 ) -> torch.Tensor:
    """Epoch or duration counts from one time unit to another (a coarser
    unit floors)."""
    s, d = T.UNIT_PER_SECOND[src_unit], T.UNIT_PER_SECOND[dst_unit]
    if d >= s:
        return data * (d // s)
    return torch.div(data, s // d, rounding_mode="floor")


# ---------------------------------------------------------------------------
# literals
# ---------------------------------------------------------------------------

def _lit_val(value, dtype: Optional[DataType], device) -> Val:
    dt = meta._lit_dtype(value, dtype)
    if value is None:
        stor = storage_torch_dtype(dt) if dt != Null else torch.bool
        return Val(dt if dtype is not None else Null,
                   torch.zeros((1,), dtype=stor, device=device),
                   torch.zeros((1,), dtype=torch.bool, device=device),
                   EMPTY_DICT if dt.is_string else None, True)
    if isinstance(value, (list, tuple, np.ndarray)):
        raise NotImplementedError(
            f"literal {type(value).__name__} is not ported yet: list "
            "literals come with Slice E (the expression surface)")
    if dt.is_temporal:
        return Val(dt, torch.full((1,), _temporal_count(value, dt),
                                  dtype=storage_torch_dtype(dt),
                                  device=device), None, None, True)
    if dt.is_string:
        sd = StringDict(np.array([value], dtype=object))
        return Val(dt, torch.zeros((1,), dtype=torch.int32, device=device),
                   None, sd, True)
    return Val(dt, torch.full((1,), value, dtype=storage_torch_dtype(dt),
                              device=device), None, None, True)


def _temporal_count(value, dt: DataType) -> int:
    """A temporal literal's storage: epoch days (Date), epoch ticks
    (Datetime; a naive datetime is read as UTC, an aware one at its
    instant), ticks (Duration), nanoseconds since midnight (Time)."""
    if isinstance(value, np.datetime64):
        unit = "D" if dt == Date else dt.time_unit
        return int(value.astype(f"datetime64[{unit}]").astype(np.int64))
    if isinstance(value, np.timedelta64):
        return int(value.astype(f"timedelta64[{dt.time_unit}]")
                   .astype(np.int64))
    if dt == Date:
        if isinstance(value, _pydt.datetime):
            value = value.date()
        return (value - _pydt.date(1970, 1, 1)).days if \
            isinstance(value, _pydt.date) else int(value)
    if isinstance(dt, Datetime):
        if isinstance(value, _pydt.datetime):
            if value.tzinfo is None:
                value = value.replace(tzinfo=_pydt.timezone.utc)
            delta = value - _EPOCH
        elif isinstance(value, _pydt.date):
            delta = _pydt.datetime(value.year, value.month, value.day,
                                   tzinfo=_pydt.timezone.utc) - _EPOCH
        else:
            return int(value)
        return _td_ticks(delta, dt.time_unit)
    if isinstance(dt, Duration):
        return _td_ticks(value, dt.time_unit) \
            if isinstance(value, _pydt.timedelta) else int(value)
    if isinstance(value, _pydt.time):
        return ((value.hour * 3600 + value.minute * 60 + value.second)
                * 1_000_000_000 + value.microsecond * 1000)
    return int(value)


_EPOCH = _pydt.datetime(1970, 1, 1, tzinfo=_pydt.timezone.utc)


def _td_ticks(td: _pydt.timedelta, unit: str) -> int:
    """A timedelta in whole ticks of `unit`, exactly (no float)."""
    us = (td.days * 86_400 + td.seconds) * 1_000_000 + td.microseconds
    scale = T.UNIT_PER_SECOND[unit]
    return us * (scale // 1_000_000) if scale >= 1_000_000 \
        else us // (1_000_000 // scale)


# ---------------------------------------------------------------------------
# binary ops
# ---------------------------------------------------------------------------

def _align_strings(l: Val, r: Val) -> Tuple[Val, Val]:
    """Recode two string Vals onto one merged dictionary."""
    if l.sdict is r.sdict:
        return l, r
    merged, ra, rb = (l.sdict or EMPTY_DICT).merge(r.sdict or EMPTY_DICT)

    def recode(v, remap):
        if len(remap) == 0:
            return Val(v.dtype, v.data, v.validity, merged, v.is_scalar)
        rm = torch.from_numpy(remap).to(v.data.device)
        code = v.data
        new = torch.where(code >= 0, rm[code.clamp(0, len(remap) - 1)],
                          torch.full_like(code, int(NULL_CODE)))
        return Val(v.dtype, new, v.validity, merged, v.is_scalar)

    return recode(l, ra), recode(r, rb)


def _cmp(op, x, y):
    return {"eq": torch.eq, "neq": torch.ne, "lt": torch.lt,
            "le": torch.le, "gt": torch.gt, "ge": torch.ge}[op](x, y)


def _eval_kleene(op: str, l: Val, r: Val) -> Val:
    """Kleene logic for Boolean & / | (reference:
    `polars-arrow/src/compute/boolean_kleene/`)."""
    x, y = l.data, r.data
    validity = None
    if l.validity is not None or r.validity is not None:
        xv, yv = l.valid_or_true(), r.valid_or_true()
        if op == "and":
            validity = (xv & yv) | (xv & ~x) | (yv & ~y)
        elif op == "or":
            validity = (xv & yv) | (xv & x) | (yv & y)
        else:  # xor: null-propagating
            validity = xv & yv
    data = {"and": torch.logical_and, "or": torch.logical_or,
            "xor": torch.logical_xor}[op](x, y)
    return Val(Boolean, data, validity, None, l.is_scalar and r.is_scalar)


def _eval_binary_str(op: str, l: Val, r: Val) -> Val:
    if not (l.dtype.is_string and r.dtype.is_string) or op not in _CMP_OPS:
        raise InvalidOperationError(
            f"binary op {op} between {l.dtype!r} and {r.dtype!r}")
    a, b = _align_strings(l, r)
    return Val(Boolean, _cmp(op, a.data, b.data),
               _and_valid(l.validity, r.validity), None,
               l.is_scalar and r.is_scalar)


def _eval_binary(op: str, l: Val, r: Val) -> Val:
    return _with_live(_binary(op, l, r),
                      l.live if l.live is not None else r.live)


def _binary(op: str, l: Val, r: Val) -> Val:
    if l.dtype.is_string or r.dtype.is_string:
        return _eval_binary_str(op, l, r)
    if l.dtype == Null or r.dtype == Null:
        out_dt = Boolean if op in _CMP_OPS or op in _BOOL_OPS else \
            (l.dtype if r.dtype == Null else r.dtype)
        if out_dt == Null:
            out_dt = Boolean
        shape = torch.broadcast_shapes(l.data.shape, r.data.shape)
        dev = l.data.device
        return Val(out_dt,
                   torch.zeros(shape, dtype=storage_torch_dtype(out_dt),
                               device=dev),
                   torch.zeros(shape, dtype=torch.bool, device=dev), None,
                   l.is_scalar and r.is_scalar)
    if op in _BOOL_OPS and l.dtype.is_bool and r.dtype.is_bool:
        return _eval_kleene(op, l, r)
    if l.dtype.is_temporal or r.dtype.is_temporal:
        return _binary_temporal(op, l, r)

    st = supertype(l.dtype, r.dtype)
    out_dt = st
    if op in _CMP_OPS:
        out_dt = Boolean
    elif op == "truediv":
        out_dt = st = _float_dt(st)
    x, y = cast_val(l, st).data, cast_val(r, st).data
    validity = _and_valid(l.validity, r.validity)

    if op == "add":
        data = x + y
    elif op == "sub":
        data = x - y
    elif op == "mul":
        data = x * y
    elif op == "truediv":
        data = x / y
    elif op in ("floordiv", "mod"):
        if st.is_integer:
            zero = y == 0
            y1 = torch.where(zero, torch.ones_like(y), y)
            data = torch.div(x, y1, rounding_mode="floor") \
                if op == "floordiv" else torch.remainder(x, y1)
            validity = _and_valid(validity, ~zero)
        else:
            data = torch.floor(x / y) if op == "floordiv" \
                else torch.remainder(x, y)
    elif op == "pow":
        data = torch.pow(x, y)
    elif op in _CMP_OPS:
        data = _cmp(op, x, y)
    elif op in _BOOL_OPS:  # bitwise on ints
        data = {"and": torch.bitwise_and, "or": torch.bitwise_or,
                "xor": torch.bitwise_xor}[op](x, y)
    else:
        raise NotImplementedError(f"binary op {op!r} is not ported yet")
    return Val(out_dt, data, validity, None, l.is_scalar and r.is_scalar)


def _binary_temporal(op: str, l: Val, r: Val) -> Val:
    """Temporal compares and arithmetic (the JAX package's
    `_eval_binary_temporal`): Datetime/Date - Datetime/Date -> Duration
    (Date - Date in ms), Datetime/Date +- Duration, Duration +- Duration,
    Duration * / // a number, Duration / Duration -> Float64."""
    ldt, rdt = l.dtype, r.dtype
    validity = _and_valid(l.validity, r.validity)
    is_scalar = l.is_scalar and r.is_scalar

    def unify():
        st = supertype(ldt, rdt)
        return cast_val(l, st).data, cast_val(r, st).data, st

    def mk(dt, data):
        return Val(dt, data, validity, None, is_scalar)

    dated = (isinstance(ldt, Datetime) or ldt == Date,
             isinstance(rdt, Datetime) or rdt == Date)
    if op in _CMP_OPS:
        a, b, _ = unify()
        return mk(Boolean, _cmp(op, a, b))
    if op == "sub" and all(dated):
        a, b, st = unify()
        if st == Date:
            return mk(Duration("ms"), (a.to(torch.int64) - b.to(torch.int64))
                      * (T.SECONDS_PER_DAY * 1000))
        return mk(Duration(st.time_unit), a - b)
    if op in ("add", "sub") and isinstance(ldt, Duration) and \
            isinstance(rdt, Duration):
        a, b, st = unify()
        return mk(st, a + b if op == "add" else a - b)
    if op in ("add", "sub") and isinstance(rdt, Duration) and dated[0]:
        return _dt_plus_dur(op, l, r, validity, is_scalar)
    if op == "add" and isinstance(ldt, Duration) and dated[1]:
        return _dt_plus_dur(op, r, l, validity, is_scalar)
    if isinstance(ldt, Duration) and rdt.is_numeric and \
            op in ("mul", "truediv", "floordiv"):
        x, y = l.data, r.data
        if op == "mul":
            return mk(ldt, (x.to(torch.float64) * y).to(torch.int64))
        if op == "truediv":
            return mk(ldt, (x.to(torch.float64) / y).to(torch.int64))
        return mk(ldt, torch.div(x, y.to(torch.int64),
                                 rounding_mode="floor"))
    if isinstance(ldt, Duration) and isinstance(rdt, Duration) and \
            op == "truediv":
        a, b, _ = unify()
        return mk(Float64, a.to(torch.float64) / b.to(torch.float64))
    raise InvalidOperationError(
        f"temporal op {op} between {ldt!r} and {rdt!r}")


def _dt_plus_dur(op: str, dtv: Val, durv: Val, validity, is_scalar) -> Val:
    """Date or Datetime plus (minus) a Duration. A Date moves by the
    duration's whole days (floored) and stays a Date."""
    sign = 1 if op == "add" else -1
    unit = durv.dtype.time_unit
    if dtv.dtype == Date:
        whole = torch.div(durv.data, T.per_day(unit), rounding_mode="floor")
        return Val(Date, (dtv.data + sign * whole).to(torch.int32), validity,
                   None, is_scalar)
    dur = rescale_time(durv.data, unit, dtv.dtype.time_unit)
    return Val(dtv.dtype, dtv.data + sign * dur, validity, None, is_scalar)


def _eval_fma(op: str, a: Val, b: Val, c: Val) -> Val:
    """Fused multiply-add family from the optimizer's fuse pass:
    fma = a*b+c, fms = a*b-c, fsm = c-a*b, with the unfused chain's
    dtypes (multiply in supertype(a, b), then combine)."""
    m = _eval_binary("mul", a, b)
    if op == "fsm":
        return _eval_binary("sub", c, m)
    return _eval_binary("add" if op == "fma" else "sub", m, c)


def _eval_unary(op: str, v: Val) -> Val:
    return _with_live(_unary(op, v), v.live)


def _unary(op: str, v: Val) -> Val:
    x = v.data
    if op == "not":
        if not v.dtype.is_bool:
            raise InvalidOperationError(f"~ on {v.dtype!r}")
        return Val(Boolean, ~x, v.validity, None, v.is_scalar)
    if op == "neg":
        return Val(v.dtype, -x, v.validity, None, v.is_scalar)
    if op == "abs":
        return Val(v.dtype, torch.abs(x), v.validity, None, v.is_scalar)
    if op == "sqrt":
        out_dt = _float_dt(v.dtype)
        return Val(out_dt, torch.sqrt(x.to(storage_torch_dtype(out_dt))),
                   v.validity, None, v.is_scalar)
    raise NotImplementedError(f"unary op {op!r} is not ported yet")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def eval_expr(e: Expr, table: Table, ctx: str = "select") -> Val:
    k = e.kind
    if k == "col":
        return column_to_val(table.column(e.attrs["name"]))
    if k == "lit":
        return _lit_val(e.attrs["value"], e.attrs["dtype"], table.device)
    if k in ("alias", "name_map", "name_keep", "exclude"):
        return eval_expr(e.children[0], table, ctx)
    if k == "cast":
        return cast_val(eval_expr(e.children[0], table, ctx),
                        e.attrs["dtype"])
    if k == "binary":
        return _eval_binary(e.attrs["op"], eval_expr(e.children[0], table, ctx),
                            eval_expr(e.children[1], table, ctx))
    if k == "fma":
        a, b, c = (eval_expr(ch, table, ctx) for ch in e.children)
        return _eval_fma(e.attrs["op"], a, b, c)
    if k == "unary":
        return _eval_unary(e.attrs["op"], eval_expr(e.children[0], table, ctx))
    if k in ("is_null", "is_not_null"):
        v = eval_expr(e.children[0], table, ctx)
        valid = v.valid_or_true()
        return Val(Boolean, ~valid if k == "is_null" else valid, None, None,
                   v.is_scalar, v.live)
    if k == "expr_filter":
        # every row stays; only the rows where the predicate holds take
        # part in an aggregate of the value
        if ctx != "agg":
            raise NotImplementedError(
                "expr.filter outside a group-by aggregation is not ported "
                "yet: it comes with Slice E (the expression surface)")
        v = eval_expr(e.children[0], table, ctx)
        p = eval_expr(e.children[1], table, ctx)
        plive = p.data & p.valid_or_true()
        return _with_live(Val(v.dtype, v.data, v.validity, v.sdict,
                              v.is_scalar),
                          plive if v.live is None else v.live & plive)
    if k == "table_len":
        return Val(UInt32, table.row_mask().sum().view(1), None, None, True)
    if k in _WINDOW_KINDS:
        from . import window as W
        return getattr(W, _WINDOW_KINDS[k])(e, table, ctx)
    if k == "over":
        from ..ops.window_over import eval_over
        return eval_over(e, table, ctx)
    if k == "dt":
        from .dt import eval_dt
        return eval_dt(e, table, ctx)
    if k == "datetime_components":
        return _eval_datetime_components(e, table, ctx)
    if k == "when_then":
        return _eval_when_then(e, table, ctx)
    if k == "str":
        raise NotImplementedError(
            f"str.{e.attrs.get('op')} is not ported yet: the string "
            "namespace (str.strptime and str.to_datetime with it) comes "
            "with Slice E (the expression surface)")
    if k == "cumulative_eval":
        raise NotImplementedError(
            "cumulative_eval is not ported yet: it comes with Slice E (the "
            "expression surface)")
    raise NotImplementedError(
        f"expression kind {k!r} is not ported yet (later slices of the "
        "port bring the rest of expr/eval.py)")


def _eval_datetime_components(e: Expr, table: Table, ctx: str) -> Val:
    """pl.datetime(year, month, day, ...): epoch ticks from calendar
    fields (expressions or ints) by the civil calendar."""
    y, mo, d = (eval_expr(c, table, ctx) for c in e.children[:3])
    shape = torch.broadcast_shapes(y.data.shape, mo.data.shape, d.data.shape)
    days = T.civil_to_days(y.data.expand(shape), mo.data.expand(shape),
                           d.data.expand(shape)).to(torch.int64)
    tu = e.attrs.get("time_unit", "us")
    per_s = T.UNIT_PER_SECOND[tu]
    sec = (e.attrs.get("hour", 0) * 3600 + e.attrs.get("minute", 0) * 60
           + e.attrs.get("second", 0))
    sub = e.attrs.get("microsecond", 0) * (per_s // 1_000_000)
    validity = _and_valid(_and_valid(y.validity, mo.validity), d.validity)
    if validity is not None:
        validity = validity.expand(shape)
    return Val(Datetime(tu), days * T.per_day(tu) + sec * per_s + sub,
               validity, None, y.is_scalar and mo.is_scalar and d.is_scalar)


def _eval_when_then(e: Expr, table: Table, ctx: str) -> Val:
    """when/then/otherwise in a select context (the JAX package's
    `_eval_when_then`): the first branch whose condition holds (and is
    not null) gives the row's value, else the otherwise value; every
    value is cast to their supertype, and string values are recoded onto
    one merged dictionary."""
    nb = e.attrs["n_branches"]
    conds = [eval_expr(c, table, ctx) for c in e.children[:nb]]
    vals = [eval_expr(c, table, ctx) for c in e.children[nb:]]
    out_dt = Null
    for v in vals:
        if v.dtype != Null:
            out_dt = v.dtype if out_dt == Null else (
                String if out_dt.is_string else supertype(out_dt, v.dtype))
    if out_dt == Null:
        out_dt = Boolean
    cap = table.capacity
    dev = table.device
    sdict = None
    if out_dt.is_string:
        cur = Val(String, torch.zeros((1,), dtype=torch.int32, device=dev),
                  None, EMPTY_DICT, True)
        for v in vals:
            if v.dtype != Null:
                cur, _ = _align_strings(cur, v)
        sdict = cur.sdict
        vals_c = [None if v.dtype == Null else _align_strings(cur, v)[1]
                  for v in vals]
        stor = torch.int32
    else:
        vals_c = [None if v.dtype == Null else cast_val(v, out_dt)
                  for v in vals]
        stor = storage_torch_dtype(out_dt)
    data = torch.zeros(cap, dtype=stor, device=dev)
    validity = torch.zeros(cap, dtype=torch.bool, device=dev)
    decided = torch.zeros(cap, dtype=torch.bool, device=dev)
    for c, vv in zip(conds, vals_c[:-1]):
        holds = (c.data & c.valid_or_true()).expand(cap)
        takes = holds & ~decided
        if vv is not None:
            data = torch.where(takes, vv.data.expand(cap), data)
            validity = torch.where(takes, vv.valid_or_true().expand(cap),
                                   validity)
        decided = decided | holds
    ov = vals_c[-1]
    if ov is not None:
        data = torch.where(decided, data, ov.data.expand(cap))
        validity = torch.where(decided, validity,
                               ov.valid_or_true().expand(cap))
    return Val(out_dt, data, validity, sdict, False)


def column_to_val(c: Column) -> Val:
    return Val(c.dtype, c.data, c.validity, c.sdict, False)


def val_to_column(v: Val, cap: int) -> Column:
    """Materialize a Val as a contiguous Column of `cap` rows,
    broadcasting scalars."""
    data = v.data
    if data.shape[0] != cap:
        data = data.expand(cap).contiguous()
    validity = v.validity
    if validity is not None and validity.shape[0] != cap:
        validity = validity.expand(cap).contiguous()
    return Column(v.dtype, data, validity, v.sdict)
