"""Expression evaluation over device tables: the elementwise subset.

The port of the elementwise part of the JAX package's `expr/eval.py`:
column references, literals, arithmetic, comparisons, Kleene boolean
logic, casts between numeric types, aliases and null propagation. Every
operation is a torch op over whole fixed-capacity columns; dead rows
compute garbage that is never read as a result. Scalars are (1,) tensors
that broadcast.

The rest of that file (windows, strings, temporal, lists, aggregations
in a select context) comes with later slices and raises
NotImplementedError here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..batch import Column, Table, storage_torch_dtype
from ..dtypes import Boolean, DataType, Float32, Float64, Int64, Null, \
    UInt32, supertype
from ..errors import InvalidOperationError
from ..strings import EMPTY_DICT, NULL_CODE, StringDict
from . import meta
from .expr import Expr

__all__ = ["Val", "eval_expr", "val_to_column"]

_CMP_OPS = {"eq", "neq", "lt", "le", "gt", "ge"}
_BOOL_OPS = {"and", "or", "xor"}


class Val:
    """Evaluation result: device data + validity.

    data shape: (capacity,) for row-wise results, (1,) for scalars."""

    __slots__ = ("dtype", "data", "validity", "sdict", "is_scalar")

    def __init__(self, dtype, data, validity=None, sdict=None,
                 is_scalar=False):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.sdict = sdict
        self.is_scalar = is_scalar

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


# ---------------------------------------------------------------------------
# casting
# ---------------------------------------------------------------------------

def cast_val(v: Val, dtype: DataType) -> Val:
    if isinstance(dtype, type) and issubclass(dtype, DataType):
        dtype = dtype()
    if v.dtype == dtype:
        return v
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
    if src.is_string or dst.is_string or src.is_temporal or \
            dst.is_temporal:
        raise NotImplementedError(
            f"cast {src!r} -> {dst!r} is not ported yet")
    if dst.is_bool:
        return Val(dst, v.data != 0, v.validity, None, v.is_scalar)
    return Val(dst, v.data.to(storage_torch_dtype(dst)), v.validity, None,
               v.is_scalar)


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
    if isinstance(value, (list, tuple, np.ndarray)) or dt.is_temporal:
        raise NotImplementedError(
            f"literal {type(value).__name__} of {dt!r} is not ported yet")
    if dt.is_string:
        sd = StringDict(np.array([value], dtype=object))
        return Val(dt, torch.zeros((1,), dtype=torch.int32, device=device),
                   None, sd, True)
    return Val(dt, torch.full((1,), value, dtype=storage_torch_dtype(dt),
                              device=device), None, None, True)


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
        raise NotImplementedError("temporal arithmetic is not ported yet")

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


def _eval_fma(op: str, a: Val, b: Val, c: Val) -> Val:
    """Fused multiply-add family from the optimizer's fuse pass:
    fma = a*b+c, fms = a*b-c, fsm = c-a*b, with the unfused chain's
    dtypes (multiply in supertype(a, b), then combine)."""
    m = _eval_binary("mul", a, b)
    if op == "fsm":
        return _eval_binary("sub", c, m)
    return _eval_binary("add" if op == "fma" else "sub", m, c)


def _eval_unary(op: str, v: Val) -> Val:
    x = v.data
    if op == "not":
        if not v.dtype.is_bool:
            raise InvalidOperationError(f"~ on {v.dtype!r}")
        return Val(Boolean, ~x, v.validity, None, v.is_scalar)
    if op == "neg":
        return Val(v.dtype, -x, v.validity, None, v.is_scalar)
    if op == "abs":
        return Val(v.dtype, torch.abs(x), v.validity, None, v.is_scalar)
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
                   v.is_scalar)
    if k == "table_len":
        return Val(UInt32, table.row_mask().sum().view(1), None, None, True)
    raise NotImplementedError(
        f"expression kind {k!r} is not ported yet (later slices of the "
        "port bring the rest of expr/eval.py)")


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
