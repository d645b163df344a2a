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

The select context (Slice E1): aggregates over the whole column
(`expr/agg.py`), the unary math and bit counts, and the kinds of
`_SELECT_KINDS` below (`clip`, `is_in`, `is_between`, `fill_nan`,
`replace`, `hash`, `search_sorted`, `sort_by`, `row_index`, and the
kinds that change the length: `drop_nulls`, `gather_every`, a slice,
`expr.filter`). A kind that changes the length keeps every row and
marks the rows of its result (`Val.live`), as the JAX package's does; a
group-by aggregate reads only those, a select compacts to them.

Strings and nested columns (Slice E2): casts to and from String and
Binary, `concat_str`, list literals and the `bin` namespace live here,
the `str` namespace in `expr/str.py` and the list and struct kinds in
`expr/nested.py`. A cast to String and `concat_str` format only the
distinct values on the host (`torch.unique` on the device, the inverse
maps them back), so the dictionary stays sorted and no host loop runs
over the rows.

The rest of the select kinds (the distinct flags, sampling, cut/qcut,
hist, the host UDFs, ...) live in `expr/misc.py`; a repeated
subexpression of one select or with_columns is evaluated once
(`cse_rewrite`, `cse_scope`).
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
from ..errors import ComputeError, InvalidOperationError
from ..ops import temporal as T
from ..strings import EMPTY_DICT, NULL_CODE, StringDict
from . import meta
from .expr import Expr

__all__ = ["Val", "eval_expr", "val_to_column", "cse_rewrite", "cse_scope"]

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

    __slots__ = ("dtype", "data", "validity", "sdict", "is_scalar", "live",
                 "lengths", "elem_valid", "fields")

    def __init__(self, dtype, data, validity=None, sdict=None,
                 is_scalar=False, live=None, lengths=None, elem_valid=None,
                 fields=None):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.sdict = sdict
        self.is_scalar = is_scalar
        self.live = live
        # nested layouts (batch.Column): a List holds 2-D data + lengths
        # (+ elem_valid), a Struct a dict of child Vals in `fields`
        self.lengths = lengths
        self.elem_valid = elem_valid
        self.fields = fields

    @property
    def rows(self) -> int:
        """The leading size: the capacity, or 1 for a scalar."""
        if self.data is not None:
            return self.data.shape[0]
        if self.lengths is not None:
            return self.lengths.shape[0]
        return max(f.rows for f in self.fields.values())

    @property
    def device(self):
        if self.data is not None:
            return self.data.device
        if self.lengths is not None:
            return self.lengths.device
        return next(iter(self.fields.values())).device

    def valid_or_true(self):
        if self.validity is None:
            return torch.ones((self.rows,), dtype=torch.bool,
                              device=self.device)
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


def cast_val(v: Val, dtype: DataType, strict: bool = True,
             live_mask=None) -> Val:
    """`v` as `dtype`. A strict cast from String raises when a live,
    non-null value does not parse (one host sync); `live_mask` narrows
    which rows count."""
    if isinstance(dtype, type) and issubclass(dtype, DataType):
        dtype = dtype()
    if v.dtype == dtype:
        return v
    if v.dtype.is_string and not dtype.is_string and dtype != Null and \
            not dtype.is_nested:
        return _with_live(_cast_from_string(v, dtype, strict, live_mask),
                          v.live)
    if v.dtype.is_binary and dtype.is_string and not dtype.is_binary:
        return _with_live(_binary_to_string(v, dtype, strict, live_mask),
                          v.live)
    return _with_live(_cast(v, dtype), v.live)


# the host formatter's calls (one per distinct value formatted): a test
# reads it to see that a cast to String formats the distinct values only
FORMAT_CALLS = [0]


def _fmt_float(x) -> str:
    """A float as the JAX package writes it: integral values with one
    decimal, the rest by repr."""
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    if x == int(x) and abs(x) < 1e15:
        return f"{x:.1f}"
    return repr(float(x))


def _format_host(dt: DataType, vals: np.ndarray) -> np.ndarray:
    """Host strings of distinct values of a non-string dtype (storage
    values in, object array out)."""
    FORMAT_CALLS[0] += len(vals)
    if dt.is_bool:
        return np.where(vals, "true", "false").astype(object)
    if dt.is_float:
        return np.array([_fmt_float(float(x)) for x in vals], dtype=object)
    if dt == Date:
        return vals.astype("datetime64[D]").astype(str).astype(object)
    if isinstance(dt, Datetime):
        return vals.astype(f"datetime64[{dt.time_unit}]").astype(str) \
            .astype(object)
    if repr(dt) == "UInt64":
        vals = vals.view(np.uint64)
    return vals.astype(str).astype(object)


def distinct_strings(v: Val):
    """(int32 codes on the device, sorted StringDict) of a non-string
    Val's values as strings: the distinct values by `torch.unique` on
    the device, formatted on the host, encoded, and gathered back by the
    inverse."""
    uniq, inv = torch.unique(v.data, return_inverse=True)
    txt = _format_host(v.dtype, uniq.cpu().numpy())
    codes, sd = StringDict.encode(txt, np.ones(len(txt), bool))
    lut = torch.from_numpy(codes).to(v.data.device)
    return lut[inv], sd


def _cast_from_string(v: Val, dst: DataType, strict: bool, live_mask) -> Val:
    """Parse each dictionary entry once on the host into a lookup table,
    gathered by code on the device."""
    sd = v.sdict or EMPTY_DICT

    def parse(s):
        try:
            if dst.is_float:
                return float(s)
            if dst.is_bool:
                return s in ("true", "True", "1")
            return int(str(s).strip())  # "12.5" is not an int (polars)
        except (ValueError, TypeError):
            return None
    parsed = [parse(s) for s in sd.values]
    oks = np.array([p is not None for p in parsed], dtype=bool)
    stor = storage_torch_dtype(dst)
    lut = torch.tensor([p if p is not None else 0 for p in parsed],
                       dtype=torch.float64 if dst.is_float else torch.int64
                       ).to(stor)
    dev = v.data.device
    if len(lut) == 0:
        data = torch.zeros(v.data.shape, dtype=stor, device=dev)
        okv = torch.zeros(v.data.shape, dtype=torch.bool, device=dev)
    else:
        code = v.data.clamp(0, len(lut) - 1).long()
        data = lut.to(dev)[code]
        okv = torch.from_numpy(oks).to(dev)[code]
    if strict:
        bad = ~okv
        if v.validity is not None:
            bad = bad & v.validity
        for live in (v.live, live_mask):
            if live is not None and live.shape == bad.shape:
                bad = bad & live
        if bool(bad.any()):
            first = sd.values[int(v.data[int(torch.argmax(bad.to(
                torch.int8)))])] if len(sd.values) else "?"
            raise InvalidOperationError(
                f"conversion from `str` to `{dst!r}` failed for value "
                f"{first!r}; use strict=False to set failures to null")
    return Val(dst, data, _and_valid(v.validity, okv), None, v.is_scalar)


def _cast(v: Val, dtype: DataType) -> Val:
    src, dst = v.dtype, dtype
    if src.is_string and dst.is_string:
        if src.is_binary != dst.is_binary:   # Binary -> String: cast_val
            return _string_to_binary(v, dst)
        # String <-> Categorical: same codes and dictionary, relabeled
        return Val(dst, v.data, v.validity, v.sdict, v.is_scalar)
    if src == Null:
        data = torch.zeros(v.data.shape, dtype=storage_torch_dtype(dst),
                           device=v.data.device)
        return Val(dst, data, torch.zeros(v.data.shape, dtype=torch.bool,
                                          device=v.data.device),
                   EMPTY_DICT if dst.is_string else None, v.is_scalar)
    if dst.is_string:
        if src.is_nested:
            raise InvalidOperationError(f"cast {src!r} -> {dst!r}")
        codes, sd = distinct_strings(v)
        if dst.is_binary:
            return _string_to_binary(Val(String, codes, v.validity, sd,
                                         v.is_scalar), dst)
        return Val(dst, codes, v.validity, sd, v.is_scalar)
    if src.is_nested or dst.is_nested:
        from .nested import cast_nested
        return cast_nested(v, dst)
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


def _string_to_binary(v: Val, dst: DataType) -> Val:
    """String -> Binary: UTF-8 keeps byte order as code-point order, so
    the codes carry over."""
    vals = np.array([str(w).encode("utf-8") for w in
                     (v.sdict or EMPTY_DICT).values], dtype=object)
    return Val(dst, v.data, v.validity, StringDict(vals), v.is_scalar)


def _binary_to_string(v: Val, dst: DataType, strict: bool, live_mask) -> Val:
    """Binary -> String: invalid UTF-8 becomes null, or raises when
    `strict` and a live, non-null row holds it (one host sync)."""
    mapped = []
    for w in (v.sdict or EMPTY_DICT).values:
        try:
            mapped.append(bytes(w).decode("utf-8"))
        except (UnicodeDecodeError, TypeError):
            mapped.append(None)
    out = remap_dict_val(v, mapped, dst)
    if strict and any(m is None for m in mapped):
        bad = out.data == NULL_CODE
        for m in (v.validity, v.live, live_mask):
            if m is not None and m.shape == bad.shape:
                bad = bad & m
        if bool(bad.any()):
            w = (v.sdict or EMPTY_DICT).values[int(v.data[int(
                torch.argmax(bad.to(torch.int8)))])]
            raise InvalidOperationError(
                f"cast Binary->String: invalid utf-8 {w!r}")
    return out


def remap_dict_val(v: Val, mapped, out_dt) -> Val:
    """A dictionary-coded Val whose entries were transformed (to None,
    or out of order): the new entries sorted and deduplicated, the codes
    remapped on the device, None entries made null."""
    keep = sorted({m for m in mapped if m is not None})
    index = {m: i for i, m in enumerate(keep)}
    remap = np.full(max(len(mapped), 1), NULL_CODE, dtype=np.int32)
    for i, m in enumerate(mapped):
        if m is not None:
            remap[i] = index[m]
    data = gather_codes(v.data, remap)
    return Val(out_dt, data, _and_valid(v.validity, data != NULL_CODE),
               StringDict(np.array(keep, dtype=object)), v.is_scalar)


def gather_codes(code: torch.Tensor, remap: np.ndarray) -> torch.Tensor:
    """remap[code] on the device, with -1 (null) kept."""
    if len(remap) == 0:
        return torch.full_like(code, int(NULL_CODE))
    rm = torch.from_numpy(np.ascontiguousarray(remap, dtype=np.int32)) \
        .to(code.device)
    return torch.where(code >= 0, rm[code.clamp(0, len(remap) - 1).long()],
                       torch.full_like(code, int(NULL_CODE)))


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

def _lit_val(value, dtype: Optional[DataType], device,
             table: Optional[Table] = None) -> Val:
    dt = meta._lit_dtype(value, dtype)
    if value is None:
        stor = storage_torch_dtype(dt) if dt != Null else torch.bool
        return Val(dt if dtype is not None else Null,
                   torch.zeros((1,), dtype=stor, device=device),
                   torch.zeros((1,), dtype=torch.bool, device=device),
                   EMPTY_DICT if dt.is_string else None, True)
    if isinstance(value, (list, tuple, np.ndarray)):
        return _array_lit(value, dtype, device, table)
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


def _array_lit(value, dtype: Optional[DataType], device,
               table: Optional[Table]) -> Val:
    """A list or array literal is a column of its own length, as in the
    JAX package: on a compact frame of that many rows it lines up with
    the rows; otherwise it carries its own rows (`live`), which a select
    compacts to."""
    from ..config import capacity_for
    from ..dtypes import dtype_from_numpy
    arr = np.asarray(value)
    adt = dtype_from_numpy(arr.dtype) if dtype is None else dtype
    if isinstance(adt, type):
        adt = adt()
    n = len(arr)
    aligned = table is not None and table.valid is None and \
        table._nrows == n and table.capacity >= n
    cap = table.capacity if aligned else capacity_for(n)
    if adt.is_string:
        codes, sd = StringDict.encode(arr.astype(object))
        host = np.full(cap, NULL_CODE, np.int32)
        host[:n] = codes
    else:
        sd = None
        host = np.zeros(cap, dtype=np.dtype(
            torch.empty(0, dtype=storage_torch_dtype(adt)).numpy().dtype))
        host[:n] = arr.astype(host.dtype)
    data = torch.from_numpy(host).to(device)
    live = None if aligned else \
        torch.arange(cap, device=device) < n
    return Val(adt, data, None, sd, False, live)


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
            return Val(v.dtype, v.data, v.validity, merged, v.is_scalar,
                       v.live, v.lengths, v.elem_valid)
        return Val(v.dtype, gather_codes(v.data, remap), v.validity, merged,
                   v.is_scalar, v.live, v.lengths, v.elem_valid)

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
    elif op in ("truediv", "arctan2"):
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
    elif op == "arctan2":
        data = torch.atan2(x, y)
    elif op in _CMP_OPS:
        data = _cmp(op, x, y)
    elif op in _BOOL_OPS:  # bitwise on ints
        data = {"and": torch.bitwise_and, "or": torch.bitwise_or,
                "xor": torch.bitwise_xor}[op](x, y)
    else:
        raise ComputeError(f"unknown binary op {op!r}")
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


def _eval_unary(op: str, v: Val, attrs=None) -> Val:
    return _with_live(_unary(op, v, attrs), v.live)


def _unary(op: str, v: Val, attrs=None) -> Val:
    """The JAX package's `_eval_unary`: sign, rounding, the float math,
    `reinterpret` and the bit counts (`_bit_unary`)."""
    attrs = attrs or {}
    x, dt = v.data, v.dtype

    def mk(out_dt, data):
        return Val(out_dt, data, v.validity, None, v.is_scalar)

    if op == "not":
        if not dt.is_bool:
            raise InvalidOperationError(f"~ on {dt!r}")
        return mk(Boolean, ~x)
    if op == "neg":
        return mk(dt, -x)
    if op == "abs":
        return mk(dt, torch.abs(x))
    if op == "sign":
        s = torch.sign(x)
        if x.is_floating_point():
            s = torch.where(torch.isnan(x), x, s)     # NaN stays NaN
        return mk(dt, s.to(x.dtype))
    if op in ("floor", "ceil"):
        if dt.is_integer:
            return v
        return mk(dt, torch.floor(x) if op == "floor" else torch.ceil(x))
    if op == "round":
        if dt.is_integer:
            return v
        m = 10.0 ** attrs.get("decimals", 0)
        # a tensor divisor: CUDA divides by a host scalar as a multiply by
        # its reciprocal, which is not correctly rounded
        return mk(dt, torch.round(x * m) / torch.tensor(m, dtype=x.dtype,
                                                        device=x.device))
    if op == "round_sig_figs":
        digits = int(attrs.get("digits", 1))
        if digits < 1:
            raise InvalidOperationError("round_sig_figs digits must be >= 1")
        xf = x.to(torch.float64)
        mag = torch.floor(torch.log10(torch.where(xf == 0, 1.0, xf.abs())))
        m = 10.0 ** (digits - 1 - mag)
        out = torch.where(xf == 0, 0.0, torch.round(xf * m) / m)
        return mk(dt, out.to(x.dtype) if dt.is_integer else out)
    if op == "reinterpret":
        return _reinterpret(v, attrs.get("signed", True))
    if op.startswith("bit_"):
        return mk(UInt32, _bit_unary(op, x, dt))
    out_dt = _float_dt(dt)
    xf = x.to(storage_torch_dtype(out_dt))
    if op == "log":
        return mk(out_dt, torch.log(xf) / math.log(attrs.get("base", math.e)))
    if op == "cbrt":
        return mk(out_dt, torch.sign(xf) * xf.abs().pow(1.0 / 3.0))
    if op == "cot":
        return mk(out_dt, 1.0 / torch.tan(xf))
    fn = _FLOAT_MATH.get(op)
    if fn is None:
        raise InvalidOperationError(f"unknown unary op {op!r}")
    return mk(out_dt, fn(xf))


_FLOAT_MATH = {
    "sqrt": torch.sqrt, "exp": torch.exp, "log1p": torch.log1p,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
}


def _reinterpret(v: Val, signed: bool) -> Val:
    """An integer's bits read as the signed or unsigned type of its
    width (UInt16 and UInt32 live in wider storage, so the bits are
    masked or sign-extended, not viewed)."""
    from ..dtypes import Int8, Int16, Int32, UInt8, UInt16, UInt64
    dt = v.dtype
    if not dt.is_integer:
        raise InvalidOperationError(f"reinterpret on {dt!r}")
    w = dt.bit_width()
    out_dt = {8: (Int8, UInt8), 16: (Int16, UInt16), 32: (Int32, UInt32),
              64: (Int64, UInt64)}[w][0 if signed else 1]
    x = v.data.to(torch.int64)
    if w < 64:
        x = x & ((1 << w) - 1)
        if signed:
            x = x - ((x >> (w - 1)) << w)
    return Val(out_dt, x.to(storage_torch_dtype(out_dt)), v.validity, None,
               v.is_scalar)


def _bit_length(u: torch.Tensor) -> torch.Tensor:
    """The bit length of non-negative int64 values below 2^63 (0 for 0)."""
    n = torch.zeros_like(u)
    for s in (32, 16, 8, 4, 2, 1):
        big = (u >> s) != 0
        n = n + torch.where(big, s, 0)
        u = torch.where(big, u >> s, u)
    return n + (u != 0).to(n.dtype)


def _popcount(u: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 words (all 64 bits)."""
    u = u - ((u >> 1) & 0x5555555555555555)
    u = (u & 0x3333333333333333) + ((u >> 2) & 0x3333333333333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (u * 0x0101010101010101) >> 56


def _bit_unary(op: str, x: torch.Tensor, dt) -> torch.Tensor:
    """The JAX package's `_eval_bit_unary`: counts of ones and zeros,
    leading and trailing ones and zeros, within the type's own width (a
    Boolean is one bit). Returns int64 counts."""
    if dt.is_bool:
        nbits = 1
    elif dt.is_integer:
        nbits = dt.bit_width()
    else:
        raise InvalidOperationError(f"{op} on {dt!r}")
    full = -1 if nbits == 64 else (1 << nbits) - 1
    u = x.to(torch.int64) & full

    def leading_zeros(a):
        # a holds nbits bits; its top bit set is the sign bit at 64
        top = a < 0
        return torch.where(top, 0, nbits - _bit_length(a.clamp(min=0)))

    def trailing_zeros(a):
        low = a & -a
        tz = torch.where(low < 0, 63, _bit_length(low.clamp(min=0)) - 1)
        return torch.where(a == 0, nbits, tz)

    if op == "bit_count_ones":
        return _popcount(u)
    if op == "bit_count_zeros":
        return nbits - _popcount(u)
    if op == "bit_leading_zeros":
        return leading_zeros(u)
    if op == "bit_leading_ones":
        return leading_zeros(~u & full)
    if op == "bit_trailing_zeros":
        return trailing_zeros(u)
    if op == "bit_trailing_ones":
        return trailing_zeros(~u & full)
    raise InvalidOperationError(f"unknown bit op {op!r}")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def eval_expr(e: Expr, table: Table, ctx: str = "select") -> Val:
    k = e.kind
    if k == "cse_cached":
        if not _CSE_STACK:
            return eval_expr(e.children[0], table, ctx)
        cache = _CSE_STACK[-1]
        hit = cache.get(e.attrs["fp"])
        if hit is None:
            hit = cache[e.attrs["fp"]] = eval_expr(e.children[0], table, ctx)
        return hit
    if k == "col":
        return column_to_val(table.column(e.attrs["name"]))
    if k == "lit":
        return _lit_val(e.attrs["value"], e.attrs["dtype"], table.device,
                        table)
    if k in ("alias", "name_map", "name_keep", "exclude"):
        return eval_expr(e.children[0], table, ctx)
    if k == "cast":
        from ..datatype_expr import resolve_dtype
        strict = e.attrs.get("strict", True)
        v = eval_expr(e.children[0], table, ctx)
        dt = resolve_dtype(e.attrs["dtype"], dict(table.schema), v.dtype)
        # a strict cast from a string checks only the live rows
        return cast_val(v, dt, strict,
                        table.row_mask() if strict and v.dtype.is_string
                        else None)
    if k == "binary":
        return _eval_binary(e.attrs["op"], eval_expr(e.children[0], table, ctx),
                            eval_expr(e.children[1], table, ctx))
    if k == "fma":
        a, b, c = (eval_expr(ch, table, ctx) for ch in e.children)
        return _eval_fma(e.attrs["op"], a, b, c)
    if k == "unary":
        return _eval_unary(e.attrs["op"], eval_expr(e.children[0], table, ctx),
                           e.attrs)
    if k in ("is_null", "is_not_null"):
        v = eval_expr(e.children[0], table, ctx)
        valid = v.valid_or_true()
        return Val(Boolean, ~valid if k == "is_null" else valid, None, None,
                   v.is_scalar, v.live)
    if k == "expr_filter":
        # every row stays; only the rows where the predicate holds take
        # part in an aggregate of the value (in a select, they are the
        # rows of the result)
        v = eval_expr(e.children[0], table, ctx)
        p = eval_expr(e.children[1], table, ctx)
        plive = p.data & p.valid_or_true()
        return _with_live(Val(v.dtype, v.data, v.validity, v.sdict,
                              v.is_scalar),
                          plive if v.live is None else v.live & plive)
    if k == "table_len":
        return Val(UInt32, table.row_mask().sum().view(1), None, None, True)
    if k == "agg":
        from .agg import eval_agg
        return eval_agg(e, eval_expr(e.children[0], table, ctx), table)
    if k in _SELECT_KINDS:
        return _SELECT_KINDS[k](e, table, ctx)
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
        from .str import eval_str
        return eval_str(e, eval_expr(e.children[0], table, ctx), table)
    if k == "bin":
        return _eval_bin(e, eval_expr(e.children[0], table, ctx))
    if k == "concat_str":
        return _eval_concat_str(e, table, ctx)
    if k in _NESTED_KINDS:
        from . import nested
        return nested.eval_nested(e, table, ctx)
    from .misc import MISC_KINDS
    if k in MISC_KINDS:
        return MISC_KINDS[k](e, table, ctx)
    raise ComputeError(f"cannot evaluate expr kind {k!r}")


# the list and struct kinds, evaluated by expr/nested.py
_NESTED_KINDS = {"list", "list_eval", "list_filter", "list_set",
                 "concat_list", "repeat_by", "int_ranges", "struct",
                 "struct_with_fields", "struct_rename", "struct_json_encode",
                 "struct_unnest", "struct_field", "field", "reshape"}


# ---------------------------------------------------------------------------
# concat_str and the bin namespace
# ---------------------------------------------------------------------------

def _eval_concat_str(e: Expr, table: Table, ctx: str) -> Val:
    """The parts joined by the separator, per row, as the JAX package
    joins them (a null part reads "" and makes the row null). Each part
    becomes int32 string codes (a non-string part through
    `distinct_strings`); the distinct code tuples are found on the device
    by `torch.unique` over the tuples packed into int64 words, only those
    are joined on the host, and the inverse maps them back."""
    sep = e.attrs.get("separator", "")
    cap = table.capacity
    dev = table.device
    codes, dicts, validity = [], [], None
    for c in e.children:
        v = eval_expr(c, table, ctx)
        if v.dtype.is_string:
            code, sd = v.data, v.sdict or EMPTY_DICT
        else:
            code, sd = distinct_strings(v)
        codes.append(code.expand(cap).to(torch.int64) + 1)   # null -> 0
        dicts.append(sd)
        if v.validity is not None:
            validity = _and_valid(validity, v.validity.expand(cap))
    # pack the code tuples into as few int64 words as fit, then one
    # unique over the word tuples
    key = None
    bits_used = 0
    words = []
    for code, sd in zip(codes, dicts):
        b = max(int(len(sd) + 1).bit_length(), 1)
        if key is None or bits_used + b > 62:
            if key is not None:
                words.append(key)
            key, bits_used = code, b
        else:
            key = (key << b) | code
            bits_used += b
    words.append(key)
    if len(words) == 1:
        uniq, inv = torch.unique(words[0], return_inverse=True)
        first_rows = torch.full((uniq.shape[0],), cap, dtype=torch.int64,
                                device=dev).scatter_reduce_(
            0, inv, torch.arange(cap, device=dev), "amin")
    else:
        stacked = torch.stack(words, 1)
        uniq, inv = torch.unique(stacked, dim=0, return_inverse=True)
        first_rows = torch.full((uniq.shape[0],), cap, dtype=torch.int64,
                                device=dev).scatter_reduce_(
            0, inv, torch.arange(cap, device=dev), "amin")
    host_codes = [c[first_rows].cpu().numpy() - 1 for c in codes]
    parts = []
    for hc, sd in zip(host_codes, dicts):
        dec = sd.decode(hc.astype(np.int32))
        parts.append(["" if t is None else str(t) for t in dec])
    joined = np.array([sep.join(p) for p in zip(*parts)], dtype=object)
    FORMAT_CALLS[0] += len(joined)
    tcodes, sd = StringDict.encode(joined, np.ones(len(joined), bool))
    lut = torch.from_numpy(tcodes).to(dev)
    return Val(String, lut[inv], validity, sd, False)


def _eval_bin(e: Expr, v: Val) -> Val:
    """The Binary (`bytes`) functions: host transforms of the dictionary
    and gathers by code on the device, as the `str` namespace."""
    from ..dtypes import Binary, physical_numpy_dtype
    op = e.attrs["op"]
    if not v.dtype.is_binary:
        raise InvalidOperationError(f".bin.{op} on {v.dtype!r}")
    sd = v.sdict or EMPTY_DICT
    code = v.data
    words = [bytes(w) for w in sd.values]

    def lut_gather(lut: np.ndarray, out_dt, validity=None):
        lt = torch.from_numpy(lut if len(lut) else np.zeros(1, lut.dtype))
        data = lt.to(code.device)[code.clamp(0, max(len(lut) - 1, 0)).long()]
        return Val(out_dt, data.to(storage_torch_dtype(out_dt)),
                   _and_valid(v.validity, validity), None, v.is_scalar,
                   v.live)

    if op in ("contains", "starts_with", "ends_with"):
        pat = e.attrs["pat"]
        pat = pat.encode("utf-8") if isinstance(pat, str) else bytes(pat)
        fn = {"contains": lambda w: pat in w,
              "starts_with": lambda w: w.startswith(pat),
              "ends_with": lambda w: w.endswith(pat)}[op]
        return lut_gather(np.array([fn(w) for w in words], dtype=bool),
                          Boolean)
    if op == "size":
        lut = np.array([len(w) for w in words], dtype=np.int64)
        unit = e.attrs.get("unit", "b")
        if unit != "b":
            scale = {"kb": 1024, "mb": 1024 ** 2, "gb": 1024 ** 3,
                     "tb": 1024 ** 4}[unit]
            return lut_gather((lut / scale).astype(np.float64), Float64)
        return lut_gather(lut, UInt32)
    if op == "slice":
        off, ln = e.attrs["offset"], e.attrs.get("length")

        def cut(w):
            start = off if off >= 0 else max(len(w) + off, 0)
            return w[start:] if ln is None else w[start:start + ln]
        return _with_live(remap_dict_val(v, [cut(w) for w in words],
                                         Binary()), v.live)
    if op == "encode":
        import base64
        mapped = [w.hex() for w in words] if e.attrs["encoding"] == "hex" \
            else [base64.b64encode(w).decode("ascii") for w in words]
        return _with_live(remap_dict_val(v, mapped, String), v.live)
    if op == "decode":
        import base64
        strict = e.attrs.get("strict", True)
        enc = e.attrs["encoding"]
        mapped = []
        for w in words:
            try:
                mapped.append(bytes.fromhex(w.decode("ascii")) if enc == "hex"
                              else base64.b64decode(w, validate=True))
            except Exception:
                if strict:
                    raise InvalidOperationError(
                        f".bin.decode({enc!r}): invalid input {w!r}") \
                        from None
                mapped.append(None)
        return _with_live(remap_dict_val(v, mapped, Binary()), v.live)
    if op == "reinterpret":
        out_dt = e.attrs["dtype"]
        if isinstance(out_dt, type) and issubclass(out_dt, DataType):
            out_dt = out_dt()
        endian = e.attrs.get("endianness", "little")
        npdt = np.dtype(physical_numpy_dtype(out_dt)).newbyteorder(
            "<" if endian == "little" else ">")
        vals = np.zeros(max(len(words), 1), dtype=npdt)
        for i, w in enumerate(words):
            if len(w) != npdt.itemsize:
                raise InvalidOperationError(
                    f".bin.reinterpret: value has {len(w)} bytes, "
                    f"{out_dt!r} needs {npdt.itemsize}")
            vals[i] = np.frombuffer(w, dtype=npdt)[0]
        host = vals.astype(npdt.newbyteorder("="))
        if host.dtype == np.uint64:
            host = host.view(np.int64)
        elif host.dtype.kind == "u" and host.dtype != np.uint8:
            host = host.astype(np.int64)
        return lut_gather(host, out_dt)
    raise InvalidOperationError(f"unknown .bin op {op!r}")


# ---------------------------------------------------------------------------
# the rest of the select context
# ---------------------------------------------------------------------------

def _live_of(v: Val, table: Table) -> torch.Tensor:
    mask = table.row_mask()
    return mask if v.live is None else mask & v.live


def _like(v: Val, dtype, data, validity=None) -> Val:
    """A result shaped as `v`, with its live rows."""
    return Val(dtype, data, v.validity if validity is None else validity,
               None, v.is_scalar, v.live)


def _eval_float_test(e: Expr, table: Table, ctx: str) -> Val:
    v = eval_expr(e.children[0], table, ctx)
    k = e.kind
    if not v.dtype.is_float:
        fill = k in ("is_not_nan", "is_finite")
        data = torch.full(v.data.shape, fill, dtype=torch.bool,
                          device=v.data.device)
    else:
        data = {"is_nan": torch.isnan, "is_not_nan":
                lambda a: ~torch.isnan(a), "is_finite": torch.isfinite,
                "is_infinite": torch.isinf}[k](v.data)
    return _like(v, Boolean, data)


def _eval_fill_nan(e: Expr, table: Table, ctx: str) -> Val:
    v = eval_expr(e.children[0], table, ctx)
    if not v.dtype.is_float:
        return v
    f = cast_val(eval_expr(e.children[1], table, ctx), v.dtype)
    return _like(v, v.dtype, torch.where(torch.isnan(v.data),
                                         f.data.expand(v.data.shape), v.data))


def _eval_clip(e: Expr, table: Table, ctx: str) -> Val:
    v = eval_expr(e.children[0], table, ctx)
    lo = eval_expr(e.children[1], table, ctx)
    hi = eval_expr(e.children[2], table, ctx)
    data = v.data
    if lo.dtype != Null:
        data = torch.maximum(data, cast_val(lo, v.dtype).data)
    if hi.dtype != Null:
        data = torch.minimum(data, cast_val(hi, v.dtype).data)
    return Val(v.dtype, data, v.validity, v.sdict, v.is_scalar, v.live)


def _eval_is_in(e: Expr, table: Table, ctx: str) -> Val:
    """Membership in a literal list: one `torch.searchsorted` into the
    sorted values (string values by their codes in the column's
    dictionary). A None in the list makes a null row True, as in the JAX
    package."""
    v = eval_expr(e.children[0], table, ctx)
    vals = e.attrs["values"]
    dev = v.data.device
    if v.dtype.is_string:
        sd = v.sdict or EMPTY_DICT
        codes = sorted(c for c in (sd.find(x) for x in vals if x is not None)
                       if c is not None)
        arr = np.asarray(codes, dtype=np.int32)
    else:
        arr = np.asarray([x for x in vals if x is not None])
        if arr.size and repr(v.dtype) == "UInt64":
            arr = arr.astype(np.uint64).view(np.int64)
        arr = np.sort(arr.astype(torch.empty(0, dtype=v.data.dtype)
                                 .numpy().dtype)) if arr.size else arr
    if arr.size == 0:
        data = torch.zeros(v.data.shape, dtype=torch.bool, device=dev)
    else:
        sa = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
        x = v.data.contiguous()
        i = torch.searchsorted(sa, x).clamp(max=sa.shape[0] - 1)
        data = sa[i] == x
    validity = v.validity
    if any(x is None for x in vals) and validity is not None:
        data = torch.where(validity, data, True)
        validity = None
    return Val(Boolean, data, validity, None, v.is_scalar, v.live)


def _eval_is_between(e: Expr, table: Table, ctx: str) -> Val:
    v, lo, hi = (eval_expr(c, table, ctx) for c in e.children)
    closed = e.attrs.get("closed", "both")
    lop = torch.ge if closed in ("both", "left") else torch.gt
    rop = torch.le if closed in ("both", "right") else torch.lt
    if v.dtype.is_string:
        a, b = _align_strings(v, lo)
        a, c = _align_strings(a, hi)
        _, b = _align_strings(a, b)
    else:
        st = supertype(supertype(v.dtype, lo.dtype), hi.dtype)
        a, b, c = cast_val(v, st), cast_val(lo, st), cast_val(hi, st)
    data = lop(a.data, b.data) & rop(a.data, c.data)
    validity = _and_valid(_and_valid(v.validity, lo.validity), hi.validity)
    return Val(Boolean, data, validity, None,
               v.is_scalar and lo.is_scalar and hi.is_scalar, v.live)


def _eval_replace(e: Expr, table: Table, ctx: str) -> Val:
    """Each value in `old` replaced by its `new` (strings through the
    dictionary, on the host)."""
    v = eval_expr(e.children[0], table, ctx)
    old, new = e.attrs["old"], e.attrs["new"]
    if len(new) == 1 and len(old) > 1:
        new = new * len(old)
    if v.dtype.is_string:
        mapping = dict(zip(old, new))
        nd, remap = (v.sdict or EMPTY_DICT).map_to_strings(
            lambda x: mapping.get(x, x))
        rm = torch.from_numpy(remap if len(remap) else
                              np.zeros(1, np.int32)).to(v.data.device)
        data = torch.where(v.data >= 0,
                           rm[v.data.clamp(0, max(len(remap) - 1, 0)).long()],
                           torch.full_like(v.data, int(NULL_CODE)))
        return Val(String, data, v.validity, nd, v.is_scalar, v.live)
    data = v.data
    for o, n in zip(old, new):
        data = torch.where(v.data == o, torch.full_like(data, n), data)
    return _like(v, v.dtype, data)


def _eval_hash(e: Expr, table: Table, ctx: str) -> Val:
    from ..ops.hashing import hash_array
    v = eval_expr(e.children[0], table, ctx)
    return _like(v, UInt32, hash_array(v.data, v.dtype,
                                       e.attrs.get("seed", 0)))


def _eval_row_index(e: Expr, table: Table, ctx: str) -> Val:
    mask = table.row_mask()
    return Val(UInt32, torch.cumsum(mask, 0) - 1, None, None, False)


def _eval_drop_nulls(e: Expr, table: Table, ctx: str) -> Val:
    v = eval_expr(e.children[0], table, ctx)
    if v.validity is None:
        return v
    live = v.validity if v.live is None else v.live & v.validity
    return Val(v.dtype, v.data, v.validity, v.sdict, v.is_scalar, live)


def _rank_in_live(live: torch.Tensor) -> torch.Tensor:
    """Each row's position among the live rows."""
    return torch.cumsum(live, 0) - 1


def _eval_gather_every(e: Expr, table: Table, ctx: str) -> Val:
    v = eval_expr(e.children[0], table, ctx)
    n, off = int(e.attrs["n"]), int(e.attrs.get("offset", 0))
    live = _live_of(v, table)
    rank = _rank_in_live(live)
    keep = live & (rank >= off) & (torch.remainder(rank - off, n) == 0)
    return Val(v.dtype, v.data, v.validity, v.sdict, v.is_scalar, keep)


def _eval_slice(e: Expr, table: Table, ctx: str) -> Val:
    v = eval_expr(e.children[0], table, ctx)
    if v.is_scalar:
        return v
    live = _live_of(v, table)
    rank = _rank_in_live(live)
    off, length = int(e.attrs["offset"]), e.attrs.get("length")
    start = torch.tensor(off, device=live.device) if off >= 0 else \
        (live.sum() + off).clamp(min=0)
    keep = live & (rank >= start)
    if length is not None:
        keep = keep & (rank < start + int(length))
    return Val(v.dtype, v.data, v.validity, v.sdict, False, keep)


def _eval_search_sorted(e: Expr, table: Table, ctx: str) -> Val:
    """Where each element would go in the (ascending) live values of the
    column: the live rows moved to the front by one compaction (kernel
    B), the rest filled with the largest value, one `torch.searchsorted`.
    Side "any" is "right", as in the JAX package."""
    from ..ops.cuda_partition import compact_words
    from ..ops.search import searchsorted
    v = eval_expr(e.children[0], table, ctx)
    elem = eval_expr(e.children[1], table, ctx)
    st = supertype(v.dtype, elem.dtype)
    v, el = cast_val(v, st), cast_val(elem, st)
    cap = table.capacity
    pos = torch.arange(cap, device=v.data.device)
    (perm,), n = compact_words(_live_of(v, table), [pos])
    packed = v.data.expand(cap)[torch.where(pos < n, perm, pos)]
    top = _type_bounds(packed.dtype)[1]
    packed = torch.where(pos < n, packed, torch.full_like(packed, top))
    side = "left" if e.attrs.get("side") == "left" else "right"
    out = torch.minimum(searchsorted(packed, el.data, side), n)
    return Val(UInt32, out, elem.validity, None, elem.is_scalar, elem.live)


def _sorted_by(table: Table, v: Val, keys, descs, nulls_last) -> Val:
    """`v` reordered by the keys (each a (Val, descending) pair) in the
    live order: the rows' (dead, key words) sorted stably, by one packed
    `torch.sort` for one 4-byte key word and by kernel F for more."""
    from ..ops.fused_sort import fused_argsort_dead_key
    from ..ops.keycode import encode_key_words
    from ..ops.merge_sort import merge_sort_words
    from .window import LiveOrder
    L = LiveOrder(table)
    cap = table.capacity
    words = [(~L.front).to(torch.int64)]
    for kv, desc in zip(keys, descs):
        kd = L.gather(kv.data)
        kvv = None if kv.validity is None else L.gather(kv.validity)
        words += encode_key_words(kd, kv.dtype, kvv, bool(desc), nulls_last)
    if len(words) == 2:
        perm = fused_argsort_dead_key(words[0], words[1])[2]
    else:
        perm = merge_sort_words(words, len(words), perm_only=True)[0]
    x = L.gather(v.data)
    data = torch.where(L.front, x[perm], x)
    validity = None
    if v.validity is not None:
        xv = L.gather(v.validity)
        validity = L.back(torch.where(L.front, xv[perm], xv))
    return Val(v.dtype, L.back(data), validity, v.sdict, False, v.live)


def _eval_sort_by(e: Expr, table: Table, ctx: str) -> Val:
    v = eval_expr(e.children[0], table, ctx)
    n_by = e.attrs.get("n_by", len(e.children) - 1)
    desc = e.attrs.get("descending", False)
    descs = desc if isinstance(desc, (list, tuple)) else [desc] * n_by
    keys = [eval_expr(c, table, ctx) for c in e.children[1:1 + n_by]]
    return _sorted_by(table, v, keys, descs, e.attrs.get("nulls_last", False))


def _eval_sort_self(e: Expr, table: Table, ctx: str) -> Val:
    v = eval_expr(e.children[0], table, ctx)
    return _sorted_by(table, v, [v], [e.attrs.get("descending", False)],
                      e.attrs.get("nulls_last", False))


_SELECT_KINDS = {
    "is_nan": _eval_float_test, "is_not_nan": _eval_float_test,
    "is_finite": _eval_float_test, "is_infinite": _eval_float_test,
    "fill_nan": _eval_fill_nan, "clip": _eval_clip, "is_in": _eval_is_in,
    "is_between": _eval_is_between, "replace": _eval_replace,
    "hash": _eval_hash, "row_index": _eval_row_index,
    "drop_nulls": _eval_drop_nulls, "gather_every": _eval_gather_every,
    "expr_slice": _eval_slice, "search_sorted": _eval_search_sorted,
    "sort_by": _eval_sort_by, "sort_self": _eval_sort_self,
}


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


def _eval_when_then(e: Expr, table: Table, ctx: str, evalf=None,
                    cap: Optional[int] = None) -> Val:
    """when/then/otherwise (the JAX package's `_eval_when_then`): the
    first branch whose condition holds (and is not null) gives the row's
    value, else the otherwise value; every value is cast to their
    supertype, and string values are recoded onto one merged dictionary.
    `evalf` and `cap` replace the child evaluator and the output length:
    a group-by evaluates the children per group over its group slots."""
    if evalf is None:
        def evalf(c):
            return eval_expr(c, table, ctx)
    nb = e.attrs["n_branches"]
    conds = [evalf(c) for c in e.children[:nb]]
    vals = [evalf(c) for c in e.children[nb:]]
    out_dt = Null
    for v in vals:
        if v.dtype != Null:
            out_dt = v.dtype if out_dt == Null else (
                String if out_dt.is_string else supertype(out_dt, v.dtype))
    if out_dt == Null:
        out_dt = Boolean
    cap = table.capacity if cap is None else cap
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


# ---------------------------------------------------------------------------
# common subexpressions
# ---------------------------------------------------------------------------

_CSE_STACK: list = []


class cse_scope:
    """A Val cache for the `cse_cached` nodes of one context."""

    def __enter__(self):
        _CSE_STACK.append({})
        return self

    def __exit__(self, *exc):
        _CSE_STACK.pop()
        return False


_CSE_TRIVIAL = {"col", "lit", "wildcard", "cols", "nth", "dtype_cols",
                "table_len", "alias", "name_map", "name_keep"}
# kinds whose evaluators read their children's structure, or evaluate
# them over another table (a partition, a list's elements, a prefix):
# shared whole at most, never opened
_CSE_OPAQUE = {"over", "list_eval", "list_filter", "cumulative_eval",
               "struct_with_fields", "map_groups_udf"}


def cse_rewrite(es):
    """Repeated non-trivial subexpressions wrapped in `cse_cached` nodes,
    evaluated once per table inside a `cse_scope` (the JAX package's
    `cse_rewrite`). Counting recurses into a subtree only on first
    sight, so the descendants of a shared subtree are not marked too;
    it does not open the `_CSE_OPAQUE` kinds."""
    counts = {}

    def count(e):
        fp = e.fingerprint()
        c = counts.get(fp, 0)
        counts[fp] = c + 1
        if c == 0 and e.kind not in _CSE_OPAQUE:
            for ch in e.children:
                count(ch)

    for e in es:
        count(e)
    shared = {fp for fp, c in counts.items() if c > 1}
    if not shared:
        return list(es), False

    def rewrite(e):
        fp = e.fingerprint()
        if fp in shared and e.children and e.kind not in _CSE_TRIVIAL \
                and e.kind != "cse_cached":
            return Expr("cse_cached", (children(e),), fp=fp)
        return children(e)

    def children(e):
        if not e.children or e.kind in _CSE_OPAQUE:
            return e
        return Expr(e.kind, tuple(rewrite(c) for c in e.children), **e.attrs)

    return [rewrite(e) for e in es], True


def column_to_val(c: Column) -> Val:
    """Column -> Val, recursively for nested layouts."""
    fields = None if c.fields is None else \
        {fn: column_to_val(f) for fn, f in c.fields.items()}
    return Val(c.dtype, c.data, c.validity, c.sdict, False,
               lengths=c.lengths, elem_valid=c.elem_valid, fields=fields)


def _expand_rows(x: Optional[torch.Tensor], cap: int):
    if x is None or x.shape[0] == cap:
        return x
    return x.expand((cap,) + tuple(x.shape[1:])).contiguous()


def val_to_column(v: Val, cap: int) -> Column:
    """Materialize a Val as a contiguous Column of `cap` rows,
    broadcasting scalars, nested layouts included."""
    fields = None if v.fields is None else \
        {fn: val_to_column(f, cap) for fn, f in v.fields.items()}
    return Column(v.dtype, _expand_rows(v.data, cap),
                  _expand_rows(v.validity, cap), v.sdict,
                  lengths=_expand_rows(v.lengths, cap),
                  elem_valid=_expand_rows(v.elem_valid, cap), fields=fields)
