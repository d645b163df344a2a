"""Aggregations in a select context: reductions of a whole column.

The port of the JAX package's `_eval_agg` (`expr/eval.py:728-990`):
`df.select(pl.col("v").sum())`, and a scalar that broadcasts in
`with_columns`, as in `pl.col("v") - pl.col("v").mean()`. Each reduction
takes the table's live rows, narrowed by the value's own (`Val.live`,
from `expr.filter` or `drop_nulls`) and, for every aggregate but `len`,
`null_count`, `first` and `last`, by its validity. Sums and moments
accumulate in int64 or f64, as the JAX package's CPU path does. The
result is a (1,) scalar `Val`, null where the JAX package's is.

These are torch reductions: no Pallas kernel stands behind them in the
JAX package. The order statistics (median, quantile, n_unique, mode)
sort the column once with `torch.sort`.
"""

from __future__ import annotations

import math

import torch

from ..dtypes import Boolean, Date, Datetime, Duration, Float64, UInt32
from ..errors import ComputeError, InvalidOperationError
from .eval import Val, _float_dt, _live_of, _sum_dtype, _type_bounds
from ..batch import storage_torch_dtype

__all__ = ["eval_agg"]

_I64_SIGN = -(1 << 63)


def _agg_mask(v: Val, table):
    """(live rows, live rows whose value is valid)."""
    if v.is_scalar:
        live = torch.ones((1,), dtype=torch.bool, device=v.data.device)
        if v.live is not None:
            live = live & v.live
    else:
        live = _live_of(v, table)
    mask = live if v.validity is None else live & v.validity
    return live, mask


def _scalar(dtype, data, valid=None, sdict=None) -> Val:
    data = data.reshape(1)
    return Val(dtype, data, None if valid is None else valid.reshape(1),
               sdict, True)


def _is_temporal_num(dt) -> bool:
    return isinstance(dt, (Datetime, Duration)) or dt == Date


def _ordered(x: torch.Tensor, dt) -> torch.Tensor:
    """UInt64 is held in int64: flipping the sign bit makes signed order
    unsigned order (and flips it back)."""
    return x ^ _I64_SIGN if repr(dt) == "UInt64" else x


def _f64(x: torch.Tensor, dt) -> torch.Tensor:
    """Values as f64 (a UInt64 by its unsigned value)."""
    if repr(dt) == "UInt64":
        return (x ^ _I64_SIGN).to(torch.float64) + 2.0 ** 63
    return x.to(torch.float64)


def _out(dt, data: torch.Tensor) -> torch.Tensor:
    return data.to(storage_torch_dtype(dt))


def eval_agg(e, v: Val, table) -> Val:
    agg = e.attrs["agg"]
    live, mask = _agg_mask(v, table)
    dt = v.dtype
    x = v.data
    n = mask.sum()
    has = n > 0

    if agg == "len":
        return _scalar(UInt32, live.sum())
    if agg == "count":
        return _scalar(UInt32, n)
    if agg == "null_count":
        return _scalar(UInt32, (live & ~mask).sum())
    if agg in ("any", "all"):
        if not dt.is_bool:
            raise InvalidOperationError(f"{agg} on {dt!r}")
        if agg == "any":
            return _scalar(Boolean, (x & mask).any())
        return _scalar(Boolean, torch.where(mask, x, True).all())
    if agg == "sum":
        if dt.is_bool:
            return _scalar(UInt32, (x & mask).sum())
        acc = torch.float64 if dt.is_float else torch.int64
        s = torch.where(mask, x, torch.zeros_like(x)).to(acc).sum()
        out_dt = _sum_dtype(dt)
        return _scalar(out_dt, _out(out_dt, s))
    if agg == "product":
        acc = torch.float64 if dt.is_float else torch.int64
        s = torch.where(mask, x, torch.ones_like(x)).to(acc).prod()
        return _scalar(dt, s.to(x.dtype))
    if agg == "mean":
        xm = torch.where(mask, x, torch.zeros_like(x))
        # an integer sum is exact in int64, as the JAX package's
        s = xm.to(torch.float64).sum() if dt.is_float else \
            _f64(xm, dt).sum() if repr(dt) == "UInt64" else \
            xm.to(torch.int64).sum().to(torch.float64)
        mean = s / n.clamp(min=1)
        if _is_temporal_num(dt):
            return _scalar(dt, mean.to(x.dtype), has)
        out_dt = _float_dt(dt)
        return _scalar(out_dt, _out(out_dt, mean), has)
    if agg in ("min", "max", "nan_min", "nan_max"):
        is_max = agg.endswith("max")
        if dt.is_string:
            fill = -1 if is_max else _type_bounds(torch.int32)[1]
            r = torch.where(mask, x, torch.full_like(x, fill))
            return _scalar(dt, r.max() if is_max else r.min(), has, v.sdict)
        xo = _ordered(x, dt)
        if dt.is_bool:
            xo = xo.to(torch.int32)
        lo, hi = _type_bounds(xo.dtype)
        r = torch.where(mask, xo, torch.full_like(xo, lo if is_max else hi))
        r = r.max() if is_max else r.min()
        if dt.is_float and agg.startswith("nan"):
            r = torch.where((mask & torch.isnan(x)).any(),
                            torch.full_like(r, math.nan), r)
        return _scalar(dt, _ordered(r, dt).to(x.dtype), has)
    if agg in ("var", "std"):
        ddof = e.attrs.get("ddof", 1)
        xf = _f64(x, dt)
        m = torch.where(mask, xf, 0.0).sum() / n.clamp(min=1)
        ss = torch.where(mask, (xf - m) ** 2, 0.0).sum()
        var = ss / (n - ddof).clamp(min=1)
        out = var.sqrt() if agg == "std" else var
        out_dt = _float_dt(dt)
        return _scalar(out_dt, _out(out_dt, out), n > ddof)
    if agg in ("first", "last"):
        cap = x.shape[0]
        pos = torch.arange(cap, device=x.device)
        idx = torch.where(live, pos, cap if agg == "first" else -1)
        idx = (idx.min() if agg == "first" else idx.max()).clamp(0, cap - 1)
        valid = live.any()
        if v.validity is not None:
            valid = valid & v.validity[idx]
        return _scalar(dt, x[idx], valid, v.sdict)
    if agg in ("arg_min", "arg_max"):
        is_max = agg == "arg_max"
        xo = x.to(torch.int32) if dt.is_bool else _ordered(x, dt)
        if dt.is_string:
            lo, hi = -1, _type_bounds(torch.int32)[1]
        else:
            lo, hi = _type_bounds(xo.dtype)
        sel = torch.where(mask, xo, torch.full_like(xo, lo if is_max else hi))
        idx = sel.argmax() if is_max else sel.argmin()
        # the position among the live rows
        before = live & (torch.arange(x.shape[0], device=x.device) < idx)
        return _scalar(UInt32, before.sum(), has)
    if agg in ("median", "quantile"):
        q = 0.5 if agg == "median" else float(e.attrs["q"])
        interp = "linear" if agg == "median" else \
            e.attrs.get("interpolation", "nearest")
        return _quantile(x, dt, mask, n, q, interp)
    if agg == "n_unique":
        s = _sorted_valid(x, dt, mask)
        k = torch.arange(s.shape[0], device=x.device)
        new = (k < n) & ((k == 0) | _differs(s))
        return _scalar(UInt32, new.sum() + (live & ~mask).any())
    if agg == "mode":
        s = _sorted_valid(x, dt, mask)
        cap = s.shape[0]
        k = torch.arange(cap, device=x.device)
        new = (k == 0) | _differs(s)
        run = torch.cumsum(new, 0) - 1
        length = torch.zeros(cap, dtype=torch.int64, device=x.device)
        length.index_add_(0, run, (k < n).to(torch.int64))
        rl = torch.where(k < n, length[run], 0)
        best = rl.max()
        pos = torch.where(new & (k < n) & (rl == best), k, cap).min()
        return _scalar(dt, _ordered(s[pos.clamp(0, cap - 1)], dt).to(x.dtype),
                       best > 0, v.sdict)
    if agg == "entropy":
        base = float(e.attrs.get("base", math.e))
        xf = torch.where(mask, _f64(x, dt), 0.0)
        if bool(e.attrs.get("normalize", True)):
            s = xf.sum()
            p = xf / torch.where(s == 0, 1.0, s)
        else:
            p = xf
        term = torch.where(mask & (p > 0), p * torch.log(p), 0.0)
        out_dt = _float_dt(dt)
        return _scalar(out_dt, _out(out_dt, -term.sum() / math.log(base)),
                       has)
    if agg in ("skew", "kurtosis"):
        # central moments (reference: polars-compute/src/moment.rs)
        nf = n.to(torch.float64)
        xf = _f64(x, dt)
        m = torch.where(mask, xf, 0.0).sum() / nf.clamp(min=1)
        d = torch.where(mask, xf - m, 0.0)
        m2 = (d * d).sum() / nf.clamp(min=1)
        bias = e.attrs.get("bias", True)
        if agg == "skew":
            m3 = (d ** 3).sum() / nf.clamp(min=1)
            g = m3 / m2.clamp(min=1e-300) ** 1.5
            if not bias:
                g = g * torch.sqrt(nf * (nf - 1)) / (nf - 2).clamp(min=1)
            return _scalar(Float64, g, (n > (0 if bias else 2)) & (m2 > 0))
        m4 = (d ** 4).sum() / nf.clamp(min=1)
        g = m4 / (m2 * m2).clamp(min=1e-300)
        if not bias:
            g = ((nf + 1) * g - 3 * (nf - 1)) * (nf - 1) / \
                ((nf - 2) * (nf - 3)).clamp(min=1) + 3
        if e.attrs.get("fisher", True):
            g = g - 3.0
        return _scalar(Float64, g, (n > (0 if bias else 3)) & (m2 > 0))
    if agg in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        return _bitwise(agg, x, dt, mask, has)
    if agg == "implode":
        from ..ops.nested import implode_all
        packed, lengths, ev, ldt = implode_all(x, v.validity, live, dt)
        return Val(ldt, packed, None, v.sdict, True, lengths=lengths,
                   elem_valid=ev)
    if agg == "agg_groups":
        raise InvalidOperationError("agg_groups() outside group_by")
    raise ComputeError(f"unknown aggregation {agg!r}")


def _differs(s: torch.Tensor) -> torch.Tensor:
    """s[k] != s[k - 1] for k >= 1 (False at 0), by value; NaNs are one
    value."""
    out = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
    a, b = s[1:], s[:-1]
    ne = a != b
    if s.is_floating_point():
        ne = ne & ~(torch.isnan(a) & torch.isnan(b))
    out[1:] = ne
    return out


def _sorted_valid(x: torch.Tensor, dt, mask: torch.Tensor) -> torch.Tensor:
    """The valid values ascending (in `_ordered` space; NaN after every
    number), then the others: one sort of the values with the others
    filled by the largest key, one stable sort of the validity."""
    xo = _ordered(x, dt)
    if xo.dtype == torch.bool:
        xo = xo.to(torch.int32)
    fill = math.inf if xo.is_floating_point() else _type_bounds(xo.dtype)[1]
    s, perm = torch.sort(torch.where(mask, xo, torch.full_like(xo, fill)),
                         stable=True)
    return s[torch.argsort((~mask[perm]).to(torch.int8), stable=True)]


def _quantile(x, dt, mask, n, q: float, interp: str) -> Val:
    s = _ordered(_sorted_valid(x, dt, mask), dt)
    pos = q * (n.to(torch.float64) - 1)
    i0 = torch.floor(pos).long().clamp(min=0)
    i1 = torch.ceil(pos).long().clamp(min=0)
    sf = _f64(s, dt) if not _is_temporal_num(dt) else s.to(torch.float64)
    if interp == "linear":
        frac = pos - torch.floor(pos)
        val = sf[i0] * (1 - frac) + sf[i1] * frac
    elif interp == "lower":
        val = sf[i0]
    elif interp == "higher":
        val = sf[i1]
    elif interp == "midpoint":
        val = (sf[i0] + sf[i1]) / 2
    else:  # nearest
        val = sf[torch.round(pos).long().clamp(min=0)]
    has = n > 0
    if _is_temporal_num(dt):
        return _scalar(dt, val.to(x.dtype), has)
    out_dt = _float_dt(dt)
    return _scalar(out_dt, _out(out_dt, val), has)


def _bitwise(agg: str, x: torch.Tensor, dt, mask, has) -> Val:
    """AND, OR or XOR of the valid values, as a tree of halvings."""
    if dt.is_bool:
        if agg == "bitwise_and":
            r = torch.where(mask, x, True).all()
        elif agg == "bitwise_or":
            r = (mask & x).any()
        else:
            r = (mask & x).sum() % 2 == 1
        return _scalar(Boolean, r, has)
    if not dt.is_integer:
        raise InvalidOperationError(f"{agg} on {dt!r}")
    op = {"bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
          "bitwise_xor": torch.bitwise_xor}[agg]
    ident = 0 if agg != "bitwise_and" else \
        (255 if x.dtype == torch.uint8 else -1)
    r = torch.where(mask, x, torch.full_like(x, ident))
    while r.shape[0] > 1:
        if r.shape[0] % 2:
            r = torch.cat([r, r.new_full((1,), ident)])
        h = r.shape[0] // 2
        r = op(r[:h], r[h:])
    if repr(dt) in ("UInt16", "UInt32"):
        # the storage is wider than the type: keep the type's own bits
        r = r & ((1 << dt.bit_width()) - 1)
    return _scalar(dt, r, has)
