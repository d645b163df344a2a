"""Order-dependent ("window") expressions over a whole column.

The port of the window part of the JAX package's `expr/eval.py`
(`_live_order`, `_eval_window`, `_rolling`, `_win_stack`,
`_rolling_quantile`, `_rolling_moments`, `_ewm_mean`, `_ewm_var_std`,
`_rank`, `fill_null_strategy` and `_eval_rolling_pair`). Each op runs in
*live order*: the live rows at the front in row order, where the op
reads its neighbours, and the result goes back to the rows.

* The live order after a filter is one kernel-B compaction of the row
  index (`cuda_partition.compact_words`); a table whose live rows are
  already a prefix needs none. Results go back by a gather at each
  row's live position (a prefix sum of the mask).
* Fixed-size windows reduce an `unfold` view of the column (no w
  gathers), each window directly, so a window sum is as close as its
  own terms allow (a difference of prefix sums cancels over 2^23 rows);
  within a partition the slots before its start are masked first.
* Fills and interpolation find the last (next) valid row by a prefix
  count of the valid rows and one compaction of their positions; no
  `cummax`. `cum_min`/`cum_max` and the ewm recurrences are log-doubling
  scans (`ops/scan.py`).
* `rank` sorts the valid rows by their orderable words: one packed
  `torch.sort` for a 4-byte value, kernel F (`merge_sort_words`) for
  more words; ties are runs of equal values, found by one compaction.

* Range windows by a companion column (`rolling_*_by`): each row's
  bounds by two `torch.searchsorted`s over the sorted `by` values (ties
  of the row's value included, as the JAX package's), sums from each
  window's own blocks of sum levels, min and max from a sparse table,
  quantiles and ranks from a wavelet tree (`ops/range_agg.py`,
  `ops/wavelet.py`). `ewm_mean_by` is a doubling scan of (decay, value)
  pairs in float64, `interpolate_by` the fills' prefix count.

* `rolling_map` runs its function on the host over each window, after
  one copy of the column there, as the JAX package's host path does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..batch import storage_torch_dtype as _stor
from ..dtypes import Boolean, Float64, Null, UInt32, supertype
from ..errors import ComputeError, InvalidOperationError
from ..ops.cuda_partition import compact_words
from ..ops.keycode import encode_key_words
from ..ops.scan import reverse_scan, run_starts, seg_scan, seg_scan_multi
from .eval import Val, _float_dt, _type_bounds, cast_val, eval_expr
from .expr import Expr

__all__ = ["eval_window", "eval_fill_null", "eval_fill_null_strategy",
           "eval_rolling_pair"]

# range windows by a companion column
RANGE_BY = ("rolling_sum_by", "rolling_mean_by", "rolling_min_by",
            "rolling_max_by", "rolling_std_by", "rolling_var_by",
            "rolling_quantile_by", "rolling_rank_by")
_ROLLING = ("rolling_sum", "rolling_mean", "rolling_min", "rolling_max",
            "rolling_std", "rolling_var")


class LiveOrder:
    """The live rows of a table at the front, in row order.

    `perm[i]` is the row at live position i (None: the identity, when the
    live rows already form a prefix), `count` the live count (a device
    scalar) and `front` marks the positions below it. `gather` takes a
    row-order column to live order; `back` takes a live-order result to
    the rows, each row reading its live position (dead rows read a
    neighbour's, which no one reads)."""

    def __init__(self, table):
        mask = table.row_mask()
        cap = mask.shape[0]
        idx = torch.arange(cap, device=mask.device)
        self.cap = cap
        self.idx = idx
        if table.valid is None:
            self.perm = None
            self.count = mask.sum()
            self.pos = None
        else:
            (perm,), count = compact_words(mask, [idx])
            # past the live count the compaction leaves garbage
            self.perm = torch.where(idx < count, perm, idx)
            self.count = count
            self.pos = (torch.cumsum(mask, 0) - 1).clamp(0, cap - 1)
        self.front = idx < self.count

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        x = x.expand(self.cap)
        return x if self.perm is None else x[self.perm]

    def back(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.pos is None else x[self.pos]


def _valid_positions(xv: torch.Tensor):
    """(position of the k-th valid row (garbage past the valid count),
    number of valid rows at or before each row, valid count)."""
    idx = torch.arange(xv.shape[0], device=xv.device)
    (vpos,), nvalid = compact_words(xv, [idx])
    return vpos, torch.cumsum(xv, 0), nvalid


def _last_valid(xv: torch.Tensor):
    """(the last valid row at or before each row, whether there is one)."""
    vpos, upto, _ = _valid_positions(xv)
    k = upto - 1
    has = k >= 0
    return torch.where(has, vpos[k.clamp(min=0)], 0), has


def _next_valid(xv: torch.Tensor):
    """(the first valid row at or after each row, whether there is one)."""
    vpos, upto, nvalid = _valid_positions(xv)
    k = upto - xv.to(upto.dtype)         # valid rows strictly before
    has = k < nvalid
    return torch.where(has, vpos[k.clamp(max=xv.shape[0] - 1)], 0), has


def _shifted(x: torch.Tensor, k: int, pad) -> torch.Tensor:
    """x moved k rows later (k > 0) or earlier (k < 0), `pad` in the
    rows left empty."""
    n = x.shape[0]
    if k == 0:
        return x
    fill = torch.full((min(abs(k), n),), pad, dtype=x.dtype, device=x.device)
    if k > 0:
        return torch.cat([fill, x[:max(n - k, 0)]])
    return torch.cat([x[min(-k, n):], fill])


def roll_window(x: torch.Tensor, w: int, kind: str,
                lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Trailing-window reduction over rows [i-w+1, i] ("add", "min",
    "max"), the rows before `lo[i]` left out (a partition's start; None:
    row 0): one reduction of an `unfold` view of the padded column, the
    slots before a partition's start set to the identity first."""
    n = x.shape[0]
    if kind == "add":
        ident = 0
    else:
        lo_b, hi_b = _type_bounds(x.dtype)
        ident = hi_b if kind == "min" else lo_b
    xp = torch.cat([torch.full((w - 1,), ident, dtype=x.dtype,
                               device=x.device), x])
    win = xp.unfold(0, w, 1)            # row i: x[i-w+1 .. i]
    if lo is not None:
        # slot j of row i holds row i-w+1+j: in the partition when
        # j >= w-1 - (i - lo[i])
        idx = torch.arange(n, device=x.device)
        first = (w - 1 - (idx - lo)).clamp(min=0)
        slot = torch.arange(w, device=x.device)
        win = torch.where(slot[None, :] >= first[:, None], win,
                          torch.full((), ident, dtype=x.dtype,
                                     device=x.device))
    if kind == "add":
        return win.sum(1, dtype=x.dtype)
    return win.amin(1) if kind == "min" else win.amax(1)


def win_stack(x: torch.Tensor, xv: torch.Tensor, w: int, pad):
    """(cap, w) matrices of each row's trailing window x[i-w+1 .. i]
    (column j holds row i-w+1+j) and its validity; invalid and
    out-of-range slots hold `pad`. Built from `unfold` views."""
    xp = torch.cat([torch.full((w - 1,), pad, dtype=x.dtype,
                               device=x.device), torch.where(xv, x, pad)])
    vp = torch.cat([torch.zeros(w - 1, dtype=torch.bool, device=x.device),
                    xv])
    return xp.unfold(0, w, 1), vp.unfold(0, w, 1)


def _min_samples(e: Expr) -> int:
    return e.attrs.get("min_samples") or e.attrs["window_size"]


def _acc(dt) -> torch.dtype:
    return torch.float64 if dt.is_float else torch.int64


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def eval_window(e: Expr, table, ctx: str) -> Val:
    op = e.attrs["op"]
    v = eval_expr(e.children[0], table, ctx)
    fillv = eval_expr(e.children[1], table, ctx)
    byv = eval_expr(e.children[2], table, ctx) if len(e.children) > 2 \
        else None
    if v.is_scalar:
        raise InvalidOperationError(f"window op {op} on scalar")
    if op == "rank":
        return _rank(e, v, table)
    lo = LiveOrder(table)
    x = lo.gather(v.data)
    valid = lo.gather(v.valid_or_true())
    xv = valid & lo.front
    cap, idx, count, dt = lo.cap, lo.idx, lo.count, v.dtype

    def back(data, validity, out_dt=None, sdict=None):
        return Val(out_dt or dt, lo.back(data),
                   None if validity is None else lo.back(validity),
                   sdict if sdict is not None else v.sdict, False, v.live)

    if op == "reverse":
        src = torch.where(idx < count, count - 1 - idx, idx)
        return back(x[src], valid[src])
    if op == "rle_id":
        # a run of nulls is one run, whatever their storage holds
        change = torch.ones(cap, dtype=torch.bool, device=x.device)
        change[1:] = (xv[1:] != xv[:-1]) | (xv[1:] & (x[1:] != x[:-1]))
        return back(torch.cumsum(change, 0) - 1, None, UInt32)
    if op in ("peak_min", "peak_max"):
        lo_b, hi_b = _type_bounds(x.dtype)
        pad = hi_b if op == "peak_min" else lo_b
        xa = torch.where(xv, x, pad)
        prev = torch.where(idx > 0, _shifted(xa, 1, pad), pad)
        nxt = torch.where(idx < count - 1, _shifted(xa, -1, pad), pad)
        out = (xa < prev) & (xa < nxt) if op == "peak_min" \
            else (xa > prev) & (xa > nxt)
        return back(out & xv, None, Boolean)
    if op in ("shift", "diff", "pct_change"):
        n = e.attrs["n"]
        src = idx - n
        inb = (src >= 0) & (src < count)
        srcc = src.clamp(0, cap - 1)
        prev, pvalid = x[srcc], inb & xv[srcc]
        if op == "shift":
            data, validity = prev, pvalid
            if fillv.dtype != Null:
                fv = cast_val(fillv, dt)
                data = torch.where(inb, prev, fv.data.expand(cap))
                validity = torch.where(inb, pvalid, fv.valid_or_true()
                                       .expand(cap))
            return back(data, validity)
        validity = pvalid & xv
        if op == "diff":
            return diff_of(v, x, prev, validity, back)
        out_dt = _float_dt(dt)
        f = x.to(_stor(out_dt))
        return back(f / prev.to(_stor(out_dt)) - 1.0, validity, out_dt)
    if op in ("cum_sum", "cum_min", "cum_max", "cum_prod", "cum_count"):
        return _cumulative(e, op, x, xv, valid, back)
    if op in _ROLLING:
        return _rolling(e, v, x, xv, lo.front, back)
    if op == "rolling_quantile":
        return _rolling_quantile(e, v, x, xv, lo.front, back)
    if op in ("rolling_skew", "rolling_kurtosis"):
        return _rolling_moments(e, x, xv, lo.front, back)
    if op == "rolling_rank":
        return _rolling_rank(e, x, xv, lo.front, back)
    if op == "ewm_mean":
        return _ewm_mean(e, v, x, xv, None, back)
    if op in ("ewm_std", "ewm_var"):
        return _ewm_var_std(e, v, x, xv, back)
    if op in ("forward_fill", "backward_fill"):
        src, has = _last_valid(xv) if op == "forward_fill" \
            else _next_valid(xv)
        return back(x[src], has)
    if op == "interpolate":
        p, has_p = _last_valid(xv)
        nx, has_n = _next_valid(xv)
        out_dt = _float_dt(dt)
        f = x.to(_stor(out_dt))
        span = (nx - p).clamp(min=1)
        frac = (idx - p).to(torch.float64) / span
        data = f[p] * (1 - frac) + f[nx] * frac
        return back(torch.where(xv, f, data.to(f.dtype)),
                    (has_p & has_n) | xv, out_dt)
    if op == "arg_sort":
        return _arg_sort(e, v, x, xv, lo.front, back)
    if op == "rolling_map":
        return _rolling_map_host(e, x, xv, count, back)
    if op == "interpolate_by":
        return interpolate_by(v, x, xv, lo.gather(byv.data), back)
    if op == "ewm_mean_by":
        return ewm_mean_by(e, v, x, xv, lo.gather(byv.data), byv.dtype,
                           None, back)
    if op in RANGE_BY:
        b = lo.gather(byv.data)
        rlo, rhi = rolling_by_bounds(e, b, byv.dtype, lo.front, count)
        return range_window_reduce(e, v, x, xv, back, rlo, rhi, lo.front)
    raise ComputeError(f"unknown window op {op!r}")


def diff_of(v: Val, x, prev, validity, back) -> Val:
    """x - prev; a Date or Datetime difference is a Duration (Date - Date
    in ms), as the JAX package's temporal subtraction."""
    from .eval import _binary_temporal
    if not v.dtype.is_temporal:
        return back(x - prev, validity)
    d = _binary_temporal("sub", Val(v.dtype, x), Val(v.dtype, prev))
    return back(d.data, validity, d.dtype)


# ---------------------------------------------------------------------------
# range windows by a companion column
# ---------------------------------------------------------------------------

def _period(e: Expr, bdt):
    """The window's period in the `by` column's units: (months, span);
    months > 0 for a calendar period."""
    from ..dtypes import Date, Datetime, Duration
    from ..ops.temporal import UNIT_PER_SECOND, parse_every
    period = e.attrs["period"]
    if not isinstance(period, str):
        return 0, int(period)
    kind, ns = parse_every(period)
    if kind == "months":
        if not (isinstance(bdt, Datetime) or bdt == Date):
            raise InvalidOperationError(
                f"rolling_*_by: month-based period {period!r} needs a "
                f"date/datetime `by` column, got {bdt}")
        return ns, 0
    if isinstance(bdt, (Datetime, Duration)):
        return 0, ns // (1_000_000_000 // UNIT_PER_SECOND[bdt.time_unit])
    if bdt == Date:
        return 0, ns // (86_400 * 1_000_000_000)
    return 0, ns


def _sides(closed: str):
    """searchsorted sides of a window's lower and upper bound."""
    closed = closed or "right"
    return ("left" if closed in ("left", "both") else "right",
            "right" if closed in ("right", "both") else "left")


def window_targets(e: Expr, b: torch.Tensor, bdt, live: torch.Tensor):
    """(each row's `by` value as searched, dead rows pinned to the top;
    each row's window start)."""
    from ..ops.temporal_window import add_months_units
    months, span = _period(e, bdt)
    bi = b if b.is_floating_point() else b.to(torch.int64)
    _, hi_b = _type_bounds(bi.dtype)
    bs = torch.where(live, bi, torch.full_like(bi, hi_b))
    if months:
        return bs, torch.where(live, add_months_units(bi, -months, bdt), bs)
    return bs, bs - span


def rolling_by_bounds(e: Expr, b: torch.Tensor, bdt, live: torch.Tensor,
                      count) -> tuple:
    """[lo, hi) of each live-order row's range window over the sorted
    `by` values: rows j with by_j in (by_i - period, by_i] for
    closed="right" (the other `closed` modes move the edges), ties of
    by_i past the row included, as the JAX package's
    `_rolling_by_bounds`. Two `torch.searchsorted`s."""
    bs, target = window_targets(e, b, bdt, live)
    lo_side, hi_side = _sides(e.attrs.get("closed"))
    lo = torch.searchsorted(bs, target.contiguous(), right=lo_side == "right")
    hi = torch.searchsorted(bs, bs, right=hi_side == "right")
    return lo, torch.minimum(hi, count)


def range_window_reduce(e: Expr, v: Val, x, xv, back, lo, hi, live,
                        longest: Optional[int] = None, part=None) -> Val:
    """Reduce every row's range [lo, hi) for each rolling_*_by op (the
    JAX package's `_range_window_reduce`): sums and moments from sum
    levels (`range_agg.window_sum`, each window summed from its own
    blocks), min and max from a sparse table, quantiles and ranks from a
    wavelet tree. `longest` (the longest range; one readback when None)
    sizes the tables; `part` = (each slot's partition id, its partition's
    first slot, the longest partition) when no range leaves its
    partition (`.over()`)."""
    from ..ops import range_agg as R
    op = e.attrs["op"]
    min_p = e.attrs.get("min_samples") or 1
    dt = v.dtype
    length = (hi - lo).clamp(min=0)
    if longest is None:
        longest = int(length.max()) if length.numel() else 0
    nl = R.levels_for(longest)
    if v.validity is None:
        cnt = length
    else:
        cnt = R.window_sum(xv, lo, hi, nl)
    validity = (cnt >= min_p) & live
    if op in ("rolling_quantile_by", "rolling_rank_by"):
        return _rolling_order_by(e, v, x, xv, back, lo, hi, cnt, validity,
                                 part)
    if op in ("rolling_min_by", "rolling_max_by"):
        kind = "min" if op == "rolling_min_by" else "max"
        lo_b, hi_b = _type_bounds(x.dtype)
        pad = hi_b if kind == "min" else lo_b
        levels = R.build_sparse(torch.where(xv, x, torch.full_like(x, pad)),
                                kind, nl, pad)
        return back(R.range_query(levels, lo, hi, kind, pad), validity)
    xa = torch.where(xv, x, torch.zeros_like(x)).to(_acc(dt))
    s = R.window_sum(xa, lo, hi, nl)
    if op == "rolling_sum_by":
        return back(s.to(x.dtype), validity)
    out_dt = _float_dt(dt)
    stor = _stor(out_dt)
    n = cnt.clamp(min=1).to(torch.float64)
    s = s.to(torch.float64)
    if op == "rolling_mean_by":
        return back((s / n).to(stor), validity, out_dt)
    s2 = R.window_sum(xa.to(torch.float64) ** 2, lo, hi, nl)
    ddof = e.attrs.get("ddof", 1)
    var = ((s2 - s * s / n) / (n - ddof).clamp(min=1)).clamp(min=0)
    validity = validity & (cnt > ddof)
    if op == "rolling_var_by":
        return back(var.to(stor), validity, out_dt)
    return back(torch.sqrt(var).to(stor), validity, out_dt)


def _sort_in_partitions(words, xv, seg) -> torch.Tensor:
    """The stable permutation by (partition, invalid, value words): each
    partition's rows stay on its own slots, its valid values first in
    order. A 4-byte value packs into one int64 for one `torch.sort`;
    more words go to kernel F."""
    from ..ops.merge_sort import merge_sort_words
    inval = (~xv).to(torch.int64)
    if len(words) == 1:
        key = (seg.to(torch.int64) << 33) | (inval << 32) | words[0]
        return torch.sort(key, stable=True).indices
    return merge_sort_words([seg.to(torch.int64), inval] + list(words),
                            2 + len(words), perm_only=True)[0]


def _rolling_order_by(e: Expr, v: Val, x, xv, back, lo, hi, cnt,
                      validity, part=None) -> Val:
    """Order statistics of each range by a wavelet tree over the ranks
    (the JAX package's `_rolling_order_by`): the valid rows sorted by
    their orderable words (invalid rows last), each row's rank scattered
    back, equal values' rank intervals from the runs of equal words.
    With `part` (ranges within partitions) the ranks are each
    partition's own, so the tree needs ⌈log2(longest partition)⌉ levels,
    not ⌈log2(rows)⌉."""
    from ..ops.wavelet import build_wavelet, wavelet_count_lt, \
        wavelet_select
    op = e.attrs["op"]
    cap = x.shape[0]
    idx = torch.arange(cap, device=x.device)
    desc = e.attrs.get("descending", False) if op == "rolling_rank_by" \
        else False
    words = encode_key_words(x, v.dtype, None, desc, False)
    if part is None:
        order = sort_valid_first(words, xv)
        base, universe = torch.zeros_like(idx), cap
    else:
        seg, base, universe = part
        order = _sort_in_partitions(words, xv, seg)
    rank = torch.empty_like(order).scatter_(0, order, idx)
    tables = build_wavelet(rank - base, universe)
    empty = hi <= lo
    slo = torch.where(empty, idx, lo)
    shi = torch.where(empty, idx + 1, hi)
    if op == "rolling_quantile_by":
        q = float(e.attrs["q"])
        interp = e.attrs.get("interpolation", "nearest")
        out_dt = _float_dt(v.dtype)
        stor = _stor(out_dt)
        sorted_x = x[order].to(stor)
        pos = q * (cnt.clamp(min=1).to(stor) - 1)

        def at(k):
            k = torch.minimum(k.to(torch.int64).clamp(min=0),
                              (shi - slo - 1).clamp(min=0))
            return sorted_x[base + wavelet_select(tables, slo, shi, k)]

        if interp == "linear":
            i0 = torch.floor(pos)
            frac = pos - i0
            a0 = at(i0)
            data = torch.where(frac > 0, a0 * (1 - frac) + at(i0 + 1) * frac,
                               a0)
        elif interp == "lower":
            data = at(torch.floor(pos))
        elif interp == "higher":
            data = at(torch.ceil(pos))
        elif interp == "midpoint":
            data = (at(torch.floor(pos)) + at(torch.ceil(pos))) / 2
        else:  # nearest (round half to even, as jnp.round)
            data = at(torch.round(pos))
        return back(data, validity, out_dt)
    method = e.attrs.get("method", "average")
    if method == "dense":
        raise InvalidOperationError(
            "rolling_rank_by: method='dense' unsupported")
    diff = torch.zeros(cap, dtype=torch.bool, device=x.device)
    diff[0] = True
    vs = xv[order]
    diff[1:] = vs[1:] != vs[:-1]
    for w in [w[order] for w in words] + \
            ([] if part is None else [part[0][order]]):
        diff[1:] |= w[1:] != w[:-1]
    _, _, tstart, tnext = run_starts(diff)
    first, last = tstart[rank] - base, tnext[rank] - base
    n_lt = wavelet_count_lt(tables, slo, shi, first)
    n_eq = wavelet_count_lt(tables, slo, shi, last) - n_lt
    validity = validity & xv
    if method == "min":
        r = (n_lt + 1).to(torch.float64)
    elif method == "max":
        r = (n_lt + n_eq).to(torch.float64)
    else:
        r = n_lt + (n_eq + 1) / 2.0
    return back(r, validity, Float64)


def interpolate_by(v: Val, x, xv, b, back) -> Val:
    """Nulls filled on the line between the valid rows before and after,
    at the `by` value's fraction of their span."""
    p, has_p = _last_valid(xv)
    nx, has_n = _next_valid(xv)
    out_dt = _float_dt(v.dtype)
    stor = _stor(out_dt)
    f = x.to(stor)
    bf = b.to(stor)
    span = bf[nx] - bf[p]
    frac = (bf - bf[p]) / torch.where(span == 0, torch.ones_like(span), span)
    data = f[p] * (1 - frac) + f[nx] * frac
    return back(torch.where(xv, f, data), (has_p & has_n) | xv, out_dt)


def ewm_mean_by(e: Expr, v: Val, x, xv, b, bdt, seg, back,
                span: Optional[int] = None) -> Val:
    """The ewm of values at irregular `by` instants: y_t = (1 - a_t)
    y_{t-1} + a_t x_t with a_t = 1 - 2^(-Δby_t / half_life), null rows
    holding the state, as one log-doubling scan of (decay, value) pairs
    in float64 (`seg` restarts it at each partition)."""
    from ..dtypes import Date, Datetime, Duration
    from ..ops.temporal import UNIT_PER_SECOND, parse_every
    half_life = e.attrs["half_life"]
    if isinstance(half_life, str):
        kind, ns = parse_every(half_life)
        if kind != "fixed":
            raise InvalidOperationError(
                "ewm_mean_by: month-based half_life unsupported")
        if isinstance(bdt, (Datetime, Duration)):
            hl = ns * UNIT_PER_SECOND[bdt.time_unit] / 1_000_000_000
        elif bdt == Date:
            hl = ns / (86_400 * 1_000_000_000)
        else:
            hl = float(ns)
    else:
        hl = float(half_life)
    out_dt = _float_dt(v.dtype)
    n = x.shape[0]
    bf = b.to(torch.float64)
    prev = torch.cat([bf[:1], bf[:-1]])
    if seg is not None:
        first_of_seg = torch.ones(n, dtype=torch.bool, device=x.device)
        first_of_seg[1:] = seg[1:] != seg[:-1]
        prev = torch.where(first_of_seg, bf, prev)
    alpha = 1.0 - torch.exp2(-(bf - prev).clamp(min=0.0) / hl)
    f = x.to(torch.float64)
    seen = seg_scan(xv.to(torch.int64), seg, torch.add, span)
    first = xv & (seen == 1)
    A = torch.where(xv, 1.0 - alpha, torch.ones_like(f))
    A = torch.where(first, torch.zeros_like(f), A)
    B = torch.where(xv, torch.where(first, f, alpha * f), torch.zeros_like(f))

    def comb(p, c):
        (Ap, Bp), (Aq, Bq) = p, c
        return [Ap * Aq, Bp * Aq + Bq]

    _, y = seg_scan_multi([A, B], seg, comb, span)
    return back(y.to(_stor(out_dt)), xv & (seen > 0), out_dt)


def _cumulative(e: Expr, op: str, x, xv, valid, back) -> Val:
    rev = e.attrs.get("reverse", False)
    if op == "cum_count":
        c = xv.to(torch.int64)
        return back(c.flip(0).cumsum(0).flip(0) if rev else c.cumsum(0),
                    None, UInt32)
    if op == "cum_sum":
        xx = torch.where(xv, x, torch.zeros_like(x))
        data = xx.flip(0).cumsum(0).flip(0) if rev else xx.cumsum(0)
    elif op == "cum_prod":
        xx = torch.where(xv, x, torch.ones_like(x))
        data = xx.flip(0).cumprod(0).flip(0) if rev else xx.cumprod(0)
    else:
        lo_b, hi_b = _type_bounds(x.dtype)
        ident = hi_b if op == "cum_min" else lo_b
        fn = torch.minimum if op == "cum_min" else torch.maximum
        xx = torch.where(xv, x, torch.full_like(x, ident))
        data = reverse_scan(xx, None, fn) if rev else seg_scan(xx, None, fn)
    return back(data.to(x.dtype), valid)


def _rolling(e: Expr, v: Val, x, xv, front, back,
             lo: Optional[torch.Tensor] = None) -> Val:
    """Fixed-size trailing windows; `lo` clamps each row's window to its
    partition (`.over()`)."""
    op = e.attrs["op"]
    w = e.attrs["window_size"]
    min_p = _min_samples(e)
    dt = v.dtype
    cnt = roll_window(xv.to(torch.int64), w, "add", lo)
    validity = (cnt >= min_p) & front
    if op in ("rolling_min", "rolling_max"):
        lo_b, hi_b = _type_bounds(x.dtype)
        kind = "min" if op == "rolling_min" else "max"
        pad = hi_b if kind == "min" else lo_b
        return back(roll_window(torch.where(xv, x, torch.full_like(x, pad)),
                                w, kind, lo), validity)
    acc = _acc(dt)
    xa = torch.where(xv, x, torch.zeros_like(x)).to(acc)
    s = roll_window(xa, w, "add", lo)
    if op == "rolling_sum":
        return back(s.to(x.dtype), validity)
    out_dt = _float_dt(dt)
    n = cnt.clamp(min=1).to(torch.float64)
    s = s.to(torch.float64)
    if op == "rolling_mean":
        return back((s / n).to(_stor(out_dt)), validity, out_dt)
    s2 = roll_window(xa * xa, w, "add", lo).to(torch.float64)
    ddof = e.attrs.get("ddof", 1)
    var = ((s2 - s * s / n) / (n - ddof).clamp(min=1)).clamp(min=0)
    validity = validity & (cnt > ddof)
    if op == "rolling_var":
        return back(var.to(_stor(out_dt)), validity, out_dt)
    return back(torch.sqrt(var).to(_stor(out_dt)), validity, out_dt)


def _rolling_quantile(e: Expr, v: Val, x, xv, front, back) -> Val:
    w = e.attrs["window_size"]
    min_p = _min_samples(e)
    q = float(e.attrs["q"])
    interp = e.attrs.get("interpolation", "nearest")
    out_dt = _float_dt(v.dtype)
    stor = _stor(out_dt)
    _, hi_b = _type_bounds(x.dtype)
    m, mv = win_stack(x, xv, w, hi_b)
    s = torch.sort(m.to(stor), dim=1).values
    cnt = mv.sum(1)
    pos = q * (cnt.to(stor) - 1)
    validity = (cnt >= min_p) & front

    def at(p):
        return torch.gather(s, 1, p.clamp(0, w - 1).long()[:, None])[:, 0]

    if interp == "linear":
        i0 = torch.floor(pos)
        data = at(i0) * (1 - (pos - i0)) + at(torch.ceil(pos)) * (pos - i0)
    elif interp == "lower":
        data = at(torch.floor(pos))
    elif interp == "higher":
        data = at(torch.ceil(pos))
    elif interp == "midpoint":
        data = (at(torch.floor(pos)) + at(torch.ceil(pos))) / 2
    else:  # nearest (round half to even, as jnp.round)
        data = at(torch.round(pos))
    return back(data, validity, out_dt)


def _rolling_moments(e: Expr, x, xv, front, back) -> Val:
    op = e.attrs["op"]
    w = e.attrs["window_size"]
    min_p = _min_samples(e)
    f = torch.where(xv, x, torch.zeros_like(x)).to(torch.float64)
    n = roll_window(xv.to(torch.float64), w, "add")
    s1 = roll_window(f, w, "add")
    s2 = roll_window(f * f, w, "add")
    s3 = roll_window(f * f * f, w, "add")
    nn = n.clamp(min=1)
    m = s1 / nn
    m2 = (s2 / nn - m * m).clamp(min=0.0)
    validity = (n >= min_p) & front & (m2 > 0)
    if op == "rolling_skew":
        m3 = s3 / nn - 3 * m * s2 / nn + 2 * m ** 3
        g = m3 / m2.clamp(min=1e-300) ** 1.5
        if not e.attrs.get("bias", True):
            g = g * torch.sqrt(nn * (nn - 1)) / (nn - 2).clamp(min=1)
            validity = validity & (n > 2)
        return back(g, validity, Float64)
    s4 = roll_window(f ** 4, w, "add")
    m4 = s4 / nn - 4 * m * s3 / nn + 6 * m * m * s2 / nn - 3 * m ** 4
    g = m4 / (m2 * m2).clamp(min=1e-300)
    if not e.attrs.get("bias", True):
        g = ((nn + 1) * g - 3 * (nn - 1)) * (nn - 1) / \
            ((nn - 2) * (nn - 3)).clamp(min=1) + 3
        validity = validity & (n > 3)
    if e.attrs.get("fisher", True):
        g = g - 3.0
    return back(g, validity, Float64)


def _rolling_rank(e: Expr, x, xv, front, back) -> Val:
    w = e.attrs["window_size"]
    min_p = _min_samples(e)
    method = e.attrs.get("method", "average")
    if method not in ("average", "min", "max"):
        raise InvalidOperationError(
            f"rolling_rank: method {method!r} unsupported")
    _, hi_b = _type_bounds(x.dtype)
    m, mv = win_stack(x, xv, w, hi_b)
    cur = x[:, None]
    lt = ((m > cur) if e.attrs.get("descending", False) else (m < cur)) & mv
    eq = (m == cur) & mv
    n_lt = lt.sum(1).to(torch.float64)
    n_eq = eq.sum(1).to(torch.float64)      # the row itself included
    validity = (mv.sum(1) >= min_p) & front & xv
    if method == "min":
        r = n_lt + 1
    elif method == "max":
        r = n_lt + n_eq
    else:
        r = n_lt + (n_eq + 1) / 2.0
    return back(r, validity, Float64)


def _ewm_mean(e: Expr, v: Val, x, xv, seg, back, span=None) -> Val:
    """The ewm's (decay, numerator, denominator) recurrence by one
    log-doubling scan; `seg` restarts it at each partition (of at most
    `span` rows)."""
    alpha = float(e.attrs["alpha"])
    min_p = e.attrs.get("min_samples", 1)
    out_dt = _float_dt(v.dtype)
    stor = _stor(out_dt)
    f = x.to(stor)
    decay = torch.where(xv, torch.full_like(f, 1.0 - alpha),
                        torch.ones_like(f))
    num = torch.where(xv, f, torch.zeros_like(f))
    den = xv.to(stor)

    def comb(prev, cur):
        (Aa, Na, Da), (Ab, Nb, Db) = prev, cur
        return [Aa * Ab, Na * Ab + Nb, Da * Ab + Db]

    _, N, D = seg_scan_multi([decay, num, den], seg, comb, span)
    cnt = seg_scan(xv.to(torch.int64), seg, torch.add, span)
    tiny = 1e-300 if stor == torch.float64 else 1e-30
    return back(N / D.clamp(min=tiny), xv & (cnt >= min_p), out_dt)


def _ewm_var_std(e: Expr, v: Val, x, xv, back) -> Val:
    """EW variance by weighted-moment scans (the JAX package's
    `_ewm_var_std`)."""
    op = e.attrs["op"]
    alpha = float(e.attrs["alpha"])
    bias = e.attrs.get("bias", False)
    min_p = e.attrs.get("min_samples", 1)
    out_dt = _float_dt(v.dtype)
    stor = _stor(out_dt)
    f = x.to(stor)
    d = torch.where(xv, torch.full_like(f, 1.0 - alpha), torch.ones_like(f))

    def scan(decay, contrib):
        def c2(prev, cur):
            (Ap, Sp), (Aq, Sq) = prev, cur
            return [Ap * Aq, Sp * Aq + Sq]
        return seg_scan_multi(
            [decay, torch.where(xv, contrib, torch.zeros_like(contrib))],
            None, c2)[1]

    one = torch.ones_like(f)
    sw, sw2 = scan(d, one), scan(d * d, one)
    swx, swx2 = scan(d, f), scan(d, f * f)
    mean = swx / sw.clamp(min=1e-300)
    var = (swx2 / sw.clamp(min=1e-300) - mean * mean).clamp(min=0.0)
    if not bias:
        denom = sw * sw - sw2
        var = var * (sw * sw) / torch.where(denom <= 0, 1.0, denom)
        var = torch.where(denom <= 0, 0.0, var)
    validity = xv & (torch.cumsum(xv, 0) >= min_p)
    data = torch.sqrt(var) if op == "ewm_std" else var
    return back(data.to(stor), validity, out_dt)


def sort_valid_first(words, xv: torch.Tensor) -> torch.Tensor:
    """The stable permutation that puts the valid rows (xv) first, by
    their words: one packed torch.sort for one word, kernel F for more."""
    from ..ops.fused_sort import fused_argsort
    from ..ops.merge_sort import merge_sort_words
    if len(words) == 1 and xv.shape[0] < (1 << 31):
        return fused_argsort(words[0], xv)[1]
    inval = (~xv).to(torch.int64)
    return merge_sort_words([inval] + list(words), len(words) + 1,
                            perm_only=True)[0]


def rank_of_sorted(method: str, new: torch.Tensor, base: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """Integer ranks of sorted rows (twice the rank for "average") from
    their tie runs (`new` marks a tie's first row and every group's) and
    each row's group start `base`."""
    if method == "ordinal":
        return idx - base + 1
    rid, _, tstart, tnext = run_starts(new)
    if method == "min":
        return tstart - base + 1
    if method == "max":
        return tnext - base
    if method == "dense":
        return rid - rid[base] + 1
    return tstart + tnext - 2 * base + 1        # 2 * average rank


def _rank(e: Expr, v: Val, table) -> Val:
    """rank() in row order: the valid live rows sorted by value (ties by
    row, which is live order), ranks from the runs of equal values (a
    value compare: -0.0 ties 0.0, NaN ties nothing, as the JAX package's
    `_rank`), scattered back to the rows. NaN is the largest value."""
    method = e.attrs.get("method", "average")
    desc = e.attrs.get("descending", False)
    cap = table.capacity
    x = v.data.expand(cap)
    if x.is_floating_point():
        x = x + 0.0         # -0.0 becomes 0.0: the zeros tie, in row order
    xv = v.valid_or_true().expand(cap) & table.row_mask()
    perm = sort_valid_first(encode_key_words(x, v.dtype, None, desc, False),
                            xv)
    xs = x[perm]
    nvalid = xv.sum()
    idx = torch.arange(cap, device=x.device)
    vs = idx < nvalid
    new = torch.ones(cap, dtype=torch.bool, device=x.device)
    new[1:] = (xs[1:] != xs[:-1]) | (vs[1:] != vs[:-1])
    r = rank_of_sorted(method, new, torch.zeros_like(idx), idx)
    out = torch.empty_like(r).scatter_(0, perm, r)
    if method == "average":
        return Val(Float64, out.to(torch.float64) / 2, xv, v.sdict, False,
                   v.live)
    return Val(UInt32, out, xv, v.sdict, False, v.live)


def _arg_sort(e: Expr, v: Val, x, xv, front, back) -> Val:
    from ..ops.merge_sort import merge_sort_words
    words = [(~front).to(torch.int64)] + encode_key_words(
        x, v.dtype, xv, e.attrs.get("descending", False),
        e.attrs.get("nulls_last", False))
    perm = merge_sort_words(words, len(words), perm_only=True)[0]
    return back(perm, None, UInt32)


# ---------------------------------------------------------------------------
# fill_null, rolling_cov / rolling_corr
# ---------------------------------------------------------------------------

def eval_fill_null(e: Expr, table, ctx: str) -> Val:
    from .eval import _align_strings
    v = eval_expr(e.children[0], table, ctx)
    f = eval_expr(e.children[1], table, ctx)
    if v.validity is None or f.dtype == Null:
        return v
    if v.dtype.is_string:
        a, b = _align_strings(v, f)
        data = torch.where(v.validity, a.data, b.data.expand(a.data.shape))
        return Val(v.dtype, data, None, a.sdict, v.is_scalar, v.live)
    tgt = supertype(v.dtype, f.dtype)
    a, b = cast_val(v, tgt), cast_val(f, tgt)
    shape = a.data.shape
    data = torch.where(v.validity, a.data, b.data.expand(shape))
    validity = None if b.validity is None else \
        v.validity | b.validity.expand(shape)
    return Val(tgt, data, validity, None, v.is_scalar, v.live)


def eval_fill_null_strategy(e: Expr, table, ctx: str) -> Val:
    strat = e.attrs["strategy"]
    inner = e.children[0]
    if strat in ("forward", "backward"):
        op = "forward_fill" if strat == "forward" else "backward_fill"
        return eval_window(Expr("window", (inner, Expr("lit", value=None,
                                                       dtype=None)), op=op),
                           table, ctx)
    if strat in ("zero", "one"):
        return eval_fill_null(Expr("fill_null", (inner, Expr(
            "lit", value=0 if strat == "zero" else 1, dtype=None))),
            table, ctx)
    if strat not in ("min", "max", "mean"):
        raise ComputeError(f"unknown fill_null strategy {strat!r}")
    v = eval_expr(inner, table, ctx)
    cap = table.capacity
    x = v.data.expand(cap)
    xv = v.valid_or_true().expand(cap) & table.row_mask()
    if strat == "mean":
        xf = x.to(torch.float64)
        agg = torch.where(xv, xf, torch.zeros_like(xf)).sum() / \
            xv.sum().clamp(min=1)
    else:
        lo_b, hi_b = _type_bounds(x.dtype)
        pad = hi_b if strat == "min" else lo_b
        xa = torch.where(xv, x, torch.full_like(x, pad))
        agg = xa.min() if strat == "min" else xa.max()
    fill = agg.to(x.dtype).view(1)
    return Val(v.dtype, torch.where(v.valid_or_true(), v.data,
                                    fill.expand(v.data.shape)),
               None, v.sdict, v.is_scalar, v.live)


def eval_rolling_pair(e: Expr, table, ctx: str) -> Val:
    """rolling_cov / rolling_corr of two columns over fixed windows."""
    a = eval_expr(e.children[0], table, ctx)
    b = eval_expr(e.children[1], table, ctx)
    lo = LiveOrder(table)
    x, y = lo.gather(a.data), lo.gather(b.data)
    xv = lo.gather(a.valid_or_true()) & lo.gather(b.valid_or_true()) & \
        lo.front
    w = int(e.attrs["window_size"])
    min_p = e.attrs.get("min_samples") or w
    ddof = e.attrs.get("ddof", 1)
    zero = torch.zeros((), dtype=torch.float64, device=x.device)
    xf = torch.where(xv, x.to(torch.float64), zero)
    yf = torch.where(xv, y.to(torch.float64), zero)
    n = roll_window(xv.to(torch.float64), w, "add")
    sx, sy = roll_window(xf, w, "add"), roll_window(yf, w, "add")
    sxy = roll_window(xf * yf, w, "add")
    nn = n.clamp(min=1)
    cov = (sxy - sx * sy / nn) / (nn - ddof).clamp(min=1)
    validity = (n >= min_p) & (n > ddof) & lo.front
    if e.attrs["stat"] == "cov":
        data = cov
    else:
        sx2, sy2 = roll_window(xf * xf, w, "add"), roll_window(yf * yf, w,
                                                                 "add")
        vx = ((sx2 - sx * sx / nn) / (nn - ddof).clamp(min=1)).clamp(min=0)
        vy = ((sy2 - sy * sy / nn) / (nn - ddof).clamp(min=1)).clamp(min=0)
        den = torch.sqrt(vx * vy)
        data = cov / torch.where(den == 0, 1.0, den)
        validity = validity & (den > 0)
    return Val(Float64, lo.back(data), lo.back(validity), None, False,
               a.live if a.live is not None else b.live)


def _rolling_map_host(e: Expr, x, xv, count, back) -> Val:
    """The function over each row's trailing window of `window_size`
    rows (a Series of its values, nulls included), with at least
    `min_samples` valid values: one copy of the column to the host, one
    of the result back."""
    from ..api.series import Series
    w = e.attrs["window_size"]
    min_p = e.attrs.get("min_samples") or w
    fn = e.attrs["fn"]
    n = int(count)
    xs = x[:n].cpu().tolist()
    vs = xv[:n].cpu().tolist()
    data = torch.zeros(x.shape[0], dtype=torch.float64)
    valid = torch.zeros(x.shape[0], dtype=torch.bool)
    for i in range(n):
        vals = [a if ok else None for a, ok in
                zip(xs[max(0, i - w + 1):i + 1], vs[max(0, i - w + 1):i + 1])]
        if sum(u is not None for u in vals) < min_p:
            continue
        r = fn(Series("", vals, device="cpu"))
        if r is not None:
            data[i] = float(r)
            valid[i] = True
    return back(data.to(x.device), valid.to(x.device), Float64)
