"""The rest of the select context's expression kinds.

The port of the JAX package's `expr/eval.py` kinds that the elementwise,
aggregate, window, string and nested modules leave: the distinct flags
(`is_duplicated`, `is_unique`, `is_first_distinct`, `is_last_distinct`),
`arg_true`, the type bounds, `to_physical`, `sample`, `extend_constant`,
`append`, `business_day_count`, `replace_strict`, `cut`/`qcut`, `hist`,
`shrink_dtype`, the extension wrappers, and the host UDFs
(`map_elements`, `map_batches`, `cumulative_eval`, `map_groups_udf`).

* The distinct flags sort the rows by (dead, key words) as the sorted
  tier does (`ops/groupby._sort_rows`: one packed `torch.sort` for one
  key word, kernel F for more). A run of equal keys is one value; its
  flags come from its bounds in sorted order and go back to the rows by
  one scatter through the permutation, where the JAX package writes
  them back by a second sort (TPU scatters serialise).
* `sample` draws from a `torch.Generator` on the frame's device, seeded
  from `seed` or `pl.set_random_seed`: a permutation of the live rows by
  one sort of uniform keys. JAX's PRNG stream cannot be matched, so the
  draw differs from the JAX package's; its sizes, the absence of repeats
  without replacement and the rows it draws from do not.
* `qcut` sorts the live values once and reads the breaks back once;
  `cut` and `qcut` bin by one `torch.searchsorted` over the breaks, and
  only the distinct breaks are formatted into labels.
* `hist` bins by `torch.searchsorted` and counts by kernel A (at most
  4096 bins; a scatter past that).
* The host UDFs copy their input to the host once per call and their
  result back once, as the JAX package does.
* A kind that changes the length keeps every row and marks the rows of
  its result (`Val.live`); `extend_constant` and `append` return more
  rows than the frame holds, padded to a capacity bucket.
"""

from __future__ import annotations

import numpy as np
import torch

from ..batch import Column, Table, storage_torch_dtype as _stor
from ..config import capacity_for
from ..dtypes import Boolean, Date, Datetime, Duration, Float32, Float64, \
    Int8, Int16, Int32, Int64, Null, String, Time, UInt8, UInt16, UInt32, \
    UInt64, supertype
from ..errors import ComputeError, InvalidOperationError, ShapeError
from ..strings import EMPTY_DICT, NULL_CODE, StringDict
from .eval import Val, _align_strings, _and_valid, _fmt_float, _lit_val, \
    _live_of, _type_bounds, cast_val, eval_expr, val_to_column
from .expr import Expr

__all__ = ["MISC_KINDS", "random_generator"]


# ---------------------------------------------------------------------------
# distinct flags
# ---------------------------------------------------------------------------

def _key_vals(v: Val):
    """The key columns of a value: a Struct's fields, else the value."""
    if v.fields is None:
        return [v]
    out = []
    for f in v.fields.values():
        out.extend(_key_vals(Val(f.dtype, f.data,
                                 _and_valid(f.validity, v.validity),
                                 f.sdict, f.is_scalar, None,
                                 fields=f.fields)))
    return out


def distinct_flags(key_vals, mask: torch.Tensor, kind: str) -> torch.Tensor:
    """Each live row's flag of `kind` over the rows' key tuples: the rows
    sorted by (dead, keys) stably, runs of equal keys found in sorted
    order, the flag scattered back through the permutation."""
    from ..ops.groupby import _sort_rows
    perm, live_sorted, _, newgrp = _sort_rows(key_vals, mask)
    # a run ends where the next sorted slot starts a run or is dead
    run_end = torch.cat([(newgrp | ~live_sorted)[1:],
                         newgrp.new_ones(1)]) & live_sorted
    if kind == "is_first_distinct":
        flag = newgrp
    elif kind == "is_last_distinct":
        flag = run_end
    elif kind == "is_unique":
        flag = newgrp & run_end
    elif kind == "is_duplicated":
        flag = live_sorted & ~(newgrp & run_end)
    else:
        raise ComputeError(f"unknown distinct flag {kind!r}")
    out = torch.empty_like(mask)
    out.scatter_(0, perm, flag)
    return out & mask


def _eval_distinct_flags(e: Expr, table: Table, ctx: str) -> Val:
    v = eval_expr(e.children[0], table, ctx)
    cap = table.capacity
    keys = [Val(k.dtype, k.data.expand(cap), None if k.validity is None
                else k.validity.expand(cap), k.sdict) for k in _key_vals(v)]
    return Val(Boolean, distinct_flags(keys, table.row_mask(), e.kind),
               None, None, False, v.live)


# ---------------------------------------------------------------------------
# small kinds
# ---------------------------------------------------------------------------

def _eval_arg_true(e: Expr, table: Table, ctx: str) -> Val:
    v = eval_expr(e.children[0], table, ctx)
    if not v.dtype.is_bool:
        raise InvalidOperationError(f"arg_true on {v.dtype!r}")
    mask = _live_of(v, table)
    pos = torch.cumsum(mask, 0) - 1
    keep = mask & (v.data & v.valid_or_true()).expand(mask.shape[0])
    return Val(UInt32, pos, None, None, False, keep)


def _eval_bounds(e: Expr, table: Table, ctx: str) -> Val:
    v = eval_expr(e.children[0], table, ctx)
    lo, hi = _type_bounds(v.data.dtype)
    if v.dtype == UInt64:
        lo, hi = 0, -1     # the all-ones word is 2^64 - 1
    elif v.dtype.is_integer and not v.dtype.is_signed_integer:
        lo, hi = 0, (1 << v.dtype.bit_width()) - 1
    val = lo if e.attrs["side"] == "lower" else hi
    return Val(v.dtype, torch.full((1,), val, dtype=v.data.dtype,
                                   device=v.data.device), None, None, True)


def _eval_to_physical(e: Expr, table: Table, ctx: str) -> Val:
    from ..dtypes import Categorical
    v = eval_expr(e.children[0], table, ctx)
    dt = v.dtype
    if dt.is_string or isinstance(dt, Categorical):
        return Val(UInt32, v.data.to(_stor(UInt32)), v.validity, None,
                   v.is_scalar, v.live)
    if dt == Date:
        phys = Int32
    elif isinstance(dt, (Datetime, Duration)) or dt == Time:
        phys = Int64
    else:
        return v
    return Val(phys, v.data, v.validity, None, v.is_scalar, v.live)


def _eval_business_day_count(e: Expr, table: Table, ctx: str) -> Val:
    s = eval_expr(e.children[0], table, ctx)
    en = eval_expr(e.children[1], table, ctx)
    if s.dtype != Date or en.dtype != Date:
        s, en = cast_val(s, Date), cast_val(en, Date)

    def weekdays(d):
        dm = d.to(torch.int64) + 3      # epoch day 0 is a Thursday
        return 5 * torch.div(dm, 7, rounding_mode="floor") + \
            torch.remainder(dm, 7).clamp(max=5)
    return Val(Int32, (weekdays(en.data) - weekdays(s.data)).to(torch.int32),
               _and_valid(s.validity, en.validity), None,
               s.is_scalar and en.is_scalar,
               s.live if s.live is not None else en.live)


def _eval_ext_to(e: Expr, table: Table, ctx: str) -> Val:
    from ..datatype_expr import resolve_dtype
    from ..dtypes import BaseExtension
    v = eval_expr(e.children[0], table, ctx)
    dt = resolve_dtype(e.attrs["dtype"], dict(table.schema), v.dtype)
    if not isinstance(dt, BaseExtension):
        raise InvalidOperationError(
            f"ext.to expects an extension dtype, got {dt!r}")
    if v.dtype != dt.storage:
        raise InvalidOperationError(
            f"ext.to: input dtype {v.dtype!r} does not match storage type "
            f"{dt.storage!r}")
    return _rebrand(v, dt)


def _eval_ext_storage(e: Expr, table: Table, ctx: str) -> Val:
    from ..dtypes import BaseExtension
    v = eval_expr(e.children[0], table, ctx)
    return _rebrand(v, v.dtype.storage) if isinstance(v.dtype, BaseExtension) \
        else v


def _rebrand(v: Val, dtype) -> Val:
    return Val(dtype, v.data, v.validity, v.sdict, v.is_scalar, v.live,
               v.lengths, v.elem_valid, v.fields)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def random_generator(seed, device) -> torch.Generator:
    """A generator on `device`: seeded from `seed`, else from
    `pl.set_random_seed`'s seed, else from fresh entropy."""
    from .. import config
    g = torch.Generator(device=device)
    seed = seed if seed is not None else config.RANDOM_SEED
    if seed is None:
        g.seed()
    else:
        g.manual_seed(int(seed))
    return g


def sample_order(mask: torch.Tensor, seed, with_replacement: bool):
    """(src, n_live): row indices whose first rows are the draw (live rows
    in a random order, or uniform picks among them with replacement) and
    the live count, both on the device."""
    cap = mask.shape[0]
    g = random_generator(seed, mask.device)
    u = torch.rand(cap, generator=g, device=mask.device,
                   dtype=torch.float64)
    order = torch.sort(torch.where(mask, u, 2.0)).indices
    n_live = mask.sum()
    if not with_replacement:
        return order, n_live
    u2 = torch.rand(cap, generator=g, device=mask.device,
                    dtype=torch.float64)
    pick = (u2 * n_live).to(torch.int64).clamp(
        max=(n_live - 1).clamp(min=0))
    return order[pick], n_live


def _take_count(n_live: torch.Tensor, n, fraction) -> torch.Tensor:
    if n is None:
        frac = 1.0 if fraction is None else float(fraction)
        return (n_live.to(torch.float64) * frac).to(torch.int64)
    return n_live.clamp(max=int(n))


def _eval_sample(e: Expr, table: Table, ctx: str) -> Val:
    v = eval_expr(e.children[0], table, ctx)
    cap = table.capacity
    mask = _live_of(v, table)
    wr = bool(e.attrs.get("with_replacement"))
    src, n_live = sample_order(mask, e.attrs.get("seed"), wr)
    n_take = _take_count(n_live, e.attrs.get("n"), e.attrs.get("fraction"))
    if not wr:
        n_take = n_take.clamp(max=n_live)
    keep = torch.arange(cap, device=mask.device) < n_take
    data = v.data.expand(cap)[src]
    validity = None if v.validity is None else v.validity.expand(cap)[src]
    return Val(v.dtype, data, validity, v.sdict, False, keep)


# ---------------------------------------------------------------------------
# kinds that add rows
# ---------------------------------------------------------------------------

def _pad(x: torch.Tensor, rows: int, fill=0) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    return torch.cat([x, torch.full((rows - x.shape[0],) + tuple(x.shape[1:]),
                                    fill, dtype=x.dtype, device=x.device)])


def _grown(dtype, parts, sdict=None) -> Val:
    """One Val from (data, validity or None, live) parts laid end to end,
    padded to a capacity bucket with dead rows."""
    total = sum(p[0].shape[0] for p in parts)
    rows = capacity_for(total)
    data = _pad(torch.cat([p[0] for p in parts]), rows)
    validity = None
    if any(p[1] is not None for p in parts):
        validity = _pad(torch.cat([
            p[1] if p[1] is not None else
            torch.ones(p[0].shape[0], dtype=torch.bool, device=p[0].device)
            for p in parts]), rows, False)
    live = _pad(torch.cat([p[2] for p in parts]), rows, False)
    return Val(dtype, data, validity, sdict, False, live)


def _eval_extend_constant(e: Expr, table: Table, ctx: str) -> Val:
    v = eval_expr(e.children[0], table, ctx)
    f = eval_expr(e.children[1], table, ctx)
    n = int(e.attrs["n"])
    if v.is_scalar:
        raise InvalidOperationError("extend_constant on scalar")
    if v.fields is not None or v.lengths is not None:
        raise InvalidOperationError(
            "extend/append on nested dtypes not supported")
    cap = table.capacity
    dev = table.device
    if f.dtype == Null:
        tail = torch.zeros(n, dtype=v.data.dtype, device=dev)
        tvalid = torch.zeros(n, dtype=torch.bool, device=dev)
        sdict = v.sdict
    elif v.dtype.is_string:
        a, b = _align_strings(v, f)
        v, tail, tvalid, sdict = a, b.data.expand(n), None, a.sdict
    else:
        fv = cast_val(f, v.dtype)
        tail, tvalid, sdict = fv.data.expand(n), None, v.sdict
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    return _grown(v.dtype, [(v.data.expand(cap),
                             None if v.validity is None
                             else v.validity.expand(cap),
                             _live_of(v, table)),
                            (tail, tvalid, ones)], sdict)


def _eval_append(e: Expr, table: Table, ctx: str) -> Val:
    l_ = eval_expr(e.children[0], table, ctx)
    r = eval_expr(e.children[1], table, ctx)
    if l_.dtype.is_string and r.dtype.is_string:
        a, b = _align_strings(l_, r)
        dt = String
    else:
        dt = supertype(l_.dtype, r.dtype)
        a, b = cast_val(l_, dt), cast_val(r, dt)
    cap = table.capacity
    mask = table.row_mask()

    def part(x: Val):
        rows = 1 if x.is_scalar else cap
        live = torch.ones(1, dtype=torch.bool, device=mask.device) \
            if x.is_scalar else _live_of(x, table)
        return (x.data.expand(rows), None if x.validity is None
                else x.validity.expand(rows), live)
    return _grown(dt, [part(a), part(b)], a.sdict)


# ---------------------------------------------------------------------------
# value mappings
# ---------------------------------------------------------------------------

def _eval_replace_strict(e: Expr, table: Table, ctx: str) -> Val:
    v = eval_expr(e.children[0], table, ctx)
    old, new = list(e.attrs["old"]), list(e.attrs["new"])
    default = e.attrs.get("default")
    dev = v.data.device
    live = _live_of(v, table) & v.valid_or_true().expand(table.capacity)
    if v.dtype.is_string:
        sd = v.sdict or EMPTY_DICT
        mapping = dict(zip(old, new))
        if default is None:
            codes = v.data.expand(table.capacity)
            used = torch.unique(codes[live & (codes >= 0)]).cpu().numpy()
            missing = [s for s in sd.values[used] if s not in mapping]
            if missing:
                raise InvalidOperationError(
                    f"replace_strict: value {missing[0]!r} not in mapping "
                    "and no default given")
        nd, remap = sd.map_to_strings(lambda s: mapping.get(s, default))
        rm = torch.from_numpy(remap if len(remap) else
                              np.zeros(1, np.int32)).to(dev)
        data = torch.where(v.data >= 0,
                           rm[v.data.clamp(0, max(len(remap) - 1, 0)).long()],
                           torch.full_like(v.data, int(NULL_CODE)))
        return Val(String, data, v.validity, nd, v.is_scalar, v.live)
    tgt = None
    for n2 in new + ([] if default is None else [default]):
        t2 = _lit_val(n2, None, dev).dtype
        tgt = t2 if tgt is None else supertype(tgt, t2)
    stor = _stor(tgt)
    data = torch.zeros(v.data.shape, dtype=stor, device=dev)
    matched = torch.zeros(v.data.shape, dtype=torch.bool, device=dev)
    for o, n2 in zip(old, new):
        hit = v.data == o
        matched = matched | hit
        data = torch.where(hit, torch.full_like(data, n2), data)
    if default is not None:
        data = torch.where(matched, data, torch.full_like(data, default))
    else:
        bad = live & ~matched.expand(table.capacity)
        if bool(bad.any()):
            badv = v.data.expand(table.capacity)[bad][0].item()
            raise InvalidOperationError(
                f"replace_strict: value {badv!r} not in mapping and no "
                "default given")
    return Val(tgt, data, v.validity, None, v.is_scalar, v.live)


def _eval_shrink_dtype(e: Expr, table: Table, ctx: str) -> Val:
    """The narrowest dtype that holds the live values: one readback of
    their min and max."""
    v = eval_expr(e.children[0], table, ctx)
    dt = v.dtype
    if dt.is_float:
        return cast_val(v, Float32)
    if not dt.is_integer:
        return v
    if v.is_scalar:
        mask = torch.ones(v.data.shape, dtype=torch.bool,
                          device=v.data.device)
    else:
        mask = _live_of(v, table) & v.valid_or_true()
    lo_b, hi_b = _type_bounds(v.data.dtype)
    x = v.data.expand(mask.shape[0])
    mn, mx = torch.stack([torch.where(mask, x, hi_b).min(),
                          torch.where(mask, x, lo_b).max()]).tolist()
    if mx < mn:
        mn = mx = 0
    if dt.is_signed_integer:
        for cand, (lo, hi) in ((Int8, (-128, 127)), (Int16, (-32768, 32767)),
                               (Int32, (-2 ** 31, 2 ** 31 - 1))):
            if lo <= mn and mx <= hi:
                return cast_val(v, cand)
        return cast_val(v, Int64)
    for cand, hi in ((UInt8, 255), (UInt16, 65535), (UInt32, 2 ** 32 - 1)):
        if 0 <= mx <= hi:
            return cast_val(v, cand)
    return cast_val(v, UInt64)


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------

def _fmt_break(b: float) -> str:
    return str(int(b)) if float(b).is_integer() else _fmt_float(b)


def qcut_breaks(x: torch.Tensor, mask: torch.Tensor, qs) -> list:
    """The breaks at quantiles `qs` of the live values, interpolated
    linearly as the JAX package's qcut: one sort, one readback."""
    xf = x.to(torch.float64)
    cap = x.shape[0]
    n = mask.sum()
    packed = torch.sort(torch.where(mask, xf, torch.inf)).values
    posf = torch.tensor(list(qs), dtype=torch.float64, device=x.device) * \
        (n - 1).to(torch.float64)
    lo_i = torch.floor(posf).to(torch.int64).clamp(0, cap - 1)
    hi_i = torch.minimum((lo_i + 1).clamp(min=0), (n - 1).clamp(min=0))
    lo_i = torch.minimum(lo_i, hi_i)
    frac = posf - lo_i.to(torch.float64)
    bk = packed[lo_i] * (1 - frac) + packed[hi_i] * frac
    return [float(b) for b in bk.cpu().numpy()]


def bin_index(x: torch.Tensor, breaks, left_closed: bool) -> torch.Tensor:
    """The count of breaks below each value (at or below when
    `left_closed`): one `torch.searchsorted` over the sorted breaks."""
    from ..ops.search import searchsorted
    b = torch.tensor(sorted(breaks), dtype=torch.float64, device=x.device)
    xf = x.to(torch.float64)
    idx = searchsorted(b, xf, "right" if left_closed else "left")
    return torch.where(torch.isnan(xf), 0, idx)


def _eval_cut(e: Expr, table: Table, ctx: str) -> Val:
    """cut/qcut -> Categorical bins, labelled as the JAX package labels
    them; only the distinct breaks are formatted."""
    from ..dtypes import Categorical
    v = eval_expr(e.children[0], table, ctx)
    if not v.dtype.is_numeric:
        raise InvalidOperationError(f"cut on {v.dtype!r}")
    left_closed = bool(e.attrs.get("left_closed", False))
    if e.kind == "qcut":
        cap = table.capacity
        mask = _live_of(v, table) & v.valid_or_true().expand(cap)
        breaks = qcut_breaks(v.data.expand(cap), mask, e.attrs["quantiles"])
    else:
        breaks = [float(b) for b in e.attrs["breaks"]]
    labels = e.attrs.get("labels")
    if labels is None:
        fmt = {b: _fmt_break(b) for b in set(breaks)}
        edges = ["-inf"] + [fmt[b] for b in breaks] + ["inf"]
        pat = "[{}, {})" if left_closed else "({}, {}]"
        labels = [pat.format(a, b) for a, b in zip(edges[:-1], edges[1:])]
    if len(labels) != len(breaks) + 1:
        raise ShapeError(
            f"cut needs {len(breaks) + 1} labels, got {len(labels)}")
    codes, sd = StringDict.encode(np.asarray(labels, dtype=object))
    lut = torch.from_numpy(np.ascontiguousarray(codes)).to(v.data.device)
    data = lut[bin_index(v.data, breaks, left_closed)]
    return Val(Categorical(), data, v.validity, sd, v.is_scalar, v.live)


# bins counted by kernel A (its one-hot width); past it, a scatter
HIST_KERNEL_BINS = 4096


def _eval_hist(e: Expr, table: Table, ctx: str) -> Val:
    """Histogram counts, one row per bin (the rows of the result are
    marked by `live`). A value on an inner edge counts in the bin to its
    left; the first bin holds its left edge, as in the JAX package."""
    from ..dtypes import Struct as StructT
    from ..ops.cuda_kernels import seg_sum
    from ..ops.search import searchsorted
    from ..ops.segment import segment_sum
    v = eval_expr(e.children[0], table, ctx)
    if not v.dtype.is_numeric:
        raise InvalidOperationError(f"hist on {v.dtype!r}")
    cap = table.capacity
    dev = table.device
    mask = _live_of(v, table) & v.valid_or_true().expand(cap)
    x = v.data.expand(cap).to(torch.float64)
    bins = e.attrs.get("bins")
    if bins is not None:
        edges = torch.tensor([float(b) for b in bins], dtype=torch.float64,
                             device=dev)
        nb = len(bins) - 1
    else:
        nb = int(e.attrs.get("bin_count") or 10)
        lo = torch.where(mask, x, torch.inf).min()
        hi = torch.where(mask, x, -torch.inf).max()
        span = torch.where(hi > lo, hi - lo, 1.0)
        edges = lo + span * torch.arange(nb + 1, dtype=torch.float64,
                                         device=dev) / nb
    if nb < 1:
        raise InvalidOperationError("hist needs at least one bin")
    b = searchsorted(edges[1:nb].contiguous(), x, "left")
    inb = mask & (x >= edges[0]) & (x <= edges[nb])
    if nb <= HIST_KERNEL_BINS:
        gid = torch.where(inb, b, nb).to(torch.int32)
        counts = seg_sum(torch.empty((0, cap), dtype=torch.float32,
                                     device=dev), gid, nb, count=True)[0]
    else:
        counts = segment_sum(inb.to(torch.float64).view(1, cap),
                             torch.where(inb, b, nb).to(torch.int32),
                             nb)[0]
    out_cap = max(cap, capacity_for(nb))
    data = _pad(counts.round().to(_stor(UInt32)), out_cap)
    live = torch.arange(out_cap, device=dev) < nb
    if not e.attrs.get("include_breakpoint"):
        return Val(UInt32, data, None, None, False, live)
    bp = _pad(edges[1:].to(_stor(Float64)), out_cap)
    fields = {"breakpoint": Val(Float64, bp), "count": Val(UInt32, data)}
    return Val(StructT([("breakpoint", Float64), ("count", UInt32)]),
               None, None, None, False, live, fields=fields)


# ---------------------------------------------------------------------------
# host UDFs
# ---------------------------------------------------------------------------

def host_values(v: Val, table: Table):
    """The value's rows on the host as Python values (None for nulls),
    with the live mask: one copy."""
    cap = table.capacity
    col = val_to_column(v, cap)
    mask = _live_of(v, table).expand(cap).cpu().numpy()
    vals = col.to_numpy(cap)
    return [None if x is None else (x.item() if isinstance(x, np.generic)
                                    else x) for x in vals], mask


def _series_val(values, dtype, device, live=None) -> Val:
    """A Val from host values (one copy to the device)."""
    from ..api.series import Series
    c = Series("", values, dtype=dtype, device=device)._col
    return Val(c.dtype, c.data, c.validity, c.sdict, False, live,
               lengths=c.lengths, elem_valid=c.elem_valid,
               fields=None if c.fields is None else
               {k: Val(f.dtype, f.data, f.validity, f.sdict)
                for k, f in c.fields.items()})


def _resolve_return(rd, table: Table, self_dt):
    from ..datatype_expr import resolve_dtype
    return None if rd is None else \
        resolve_dtype(rd, dict(table.schema), self_dt)


def _eval_map_elements(e: Expr, table: Table, ctx: str) -> Val:
    v = eval_expr(e.children[0], table, ctx)
    fn = e.attrs["fn"]
    skip_nulls = e.attrs.get("skip_nulls", True)
    src, mask = host_values(v, table)
    out = [(fn(s) if (s is not None or not skip_nulls) else None)
           if m else None for s, m in zip(src, mask)]
    return _series_val(out, _resolve_return(e.attrs.get("return_dtype"),
                                            table, v.dtype),
                       table.device, v.live)


def _eval_map_batches(e: Expr, table: Table, ctx: str) -> Val:
    """`fn` over the value's whole column (a tensor on the frame's
    device, as the JAX package hands its function the device array)."""
    v = eval_expr(e.children[0], table, ctx)
    data = e.attrs["fn"](v.data)
    if not isinstance(data, torch.Tensor):
        data = torch.as_tensor(np.asarray(data), device=v.data.device)
    rd = _resolve_return(e.attrs.get("return_dtype"), table, v.dtype) or \
        v.dtype
    return Val(rd, data.to(_stor(rd)), v.validity, None, v.is_scalar, v.live)


def _eval_cumulative(e: Expr, table: Table, ctx: str) -> Val:
    """cumulative_eval: the inner expression over every prefix of the
    live values, on the host after one copy (O(n) evaluations, as the
    JAX package's documented slow path)."""
    v = eval_expr(e.children[0], table, ctx)
    inner = e.children[1]
    min_samples = int(e.attrs.get("min_samples", 1))
    cap = table.capacity
    col = val_to_column(v, cap)
    cpu = torch.device("cpu")
    host = col.map_rows(lambda x: x.cpu())
    mask = _live_of(v, table).expand(cap).cpu()
    idxs = torch.nonzero(mask).flatten()
    full = [None] * cap
    for k in range(min_samples, len(idxs) + 1):
        pref = host.take(idxs[:k])
        t2 = Table(["__pt_element__"], {"__pt_element__": pref}, k, k,
                   None, device=cpu)
        r = eval_expr(inner, t2, "select")
        ok = r.validity is None or bool(r.validity[0])
        full[int(idxs[k - 1])] = r.data[0].item() if ok else None
    return _series_val(full, None, table.device, v.live)


def map_groups_series(e: Expr, table: Table, ctx: str):
    """The UDF's input columns as host Series (one copy each)."""
    from ..api.series import Series
    series = []
    for c in e.children:
        vals, mask = host_values(eval_expr(c, table, ctx), table)
        series.append(Series("", [x for x, m in zip(vals, mask) if m],
                             device="cpu"))
    return series


def _eval_map_groups_udf(e: Expr, table: Table, ctx: str) -> Val:
    """map_groups/plugin UDF outside a group-by: the whole frame is one
    group."""
    from ..api.series import Series
    out = e.attrs["fn"](map_groups_series(e, table, ctx))
    vals = out.to_list() if isinstance(out, Series) else (
        list(out) if isinstance(out, (list, tuple, np.ndarray)) else [out])
    if e.attrs.get("returns_scalar", False) and len(vals) == 1:
        r = _series_val(vals, None, table.device)
        return Val(r.dtype, r.data[:1], None if r.validity is None
                   else r.validity[:1], r.sdict, True)
    cap = max(table.capacity, capacity_for(len(vals)))
    r = _series_val(vals + [None] * (cap - len(vals)), None, table.device)
    live = torch.arange(cap, device=table.device) < len(vals)
    return Val(r.dtype, r.data, r.validity, r.sdict, False, live)


MISC_KINDS = {
    "is_duplicated": _eval_distinct_flags, "is_unique": _eval_distinct_flags,
    "is_first_distinct": _eval_distinct_flags,
    "is_last_distinct": _eval_distinct_flags,
    "arg_true": _eval_arg_true, "bounds": _eval_bounds,
    "to_physical": _eval_to_physical, "sample": _eval_sample,
    "extend_constant": _eval_extend_constant, "append": _eval_append,
    "business_day_count": _eval_business_day_count,
    "replace_strict": _eval_replace_strict, "cut": _eval_cut,
    "qcut": _eval_cut, "hist": _eval_hist,
    "shrink_dtype": _eval_shrink_dtype, "ext_to": _eval_ext_to,
    "ext_storage": _eval_ext_storage, "map_elements": _eval_map_elements,
    "map_batches": _eval_map_batches, "cumulative_eval": _eval_cumulative,
    "map_groups_udf": _eval_map_groups_udf,
}
