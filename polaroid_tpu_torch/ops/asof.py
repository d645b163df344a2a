"""As-of join: each left row takes the right row with the nearest key.

The port of the JAX package's `ops/asof.py` (reference analogue:
`polars-ops/src/frame/join/asof/`). The right side is laid out once in
key order, and every left key is one binary search into it:

* the keys of both sides are cast to their supertype and mapped to
  signed int64 codes with the key's order (`keycode.orderable_i64`);
* with `by`, both sides' `by` columns go through one `build_groups` (the
  sorted tier's layout) over their concatenation, so equal `by` values
  get one group id on either side, as `asof.py:95-106` does;
* one readback takes the live keys' range and the group count. Where the
  group id and the key's offset from its minimum fit 62 bits together,
  the right side is one packed int64 (group id above the offset, dead
  and null rows as the int64 maximum), sorted by one `torch.sort`, and
  each left row is one `torch.searchsorted` of its own packed word: a
  row whose found slot lies in another group has no match. Otherwise
  kernel F (`merge_sort.merge_sort_words`) sorts (dead, group id, key
  words) and each left row searches its group's run
  (`range_agg.segmented_searchsorted`). The JAX package searches every
  left row with log2(capacity) + 1 rounds of gathers instead.

Unlike the JAX package, a null key on either side, or a null `by` value,
never matches (polars' semantics): the JAX package searches the raw key
data (`asof.py:35-44`), so a null right key can be the match of a valid
left key and a null left key matches too (ROADMAP Queue 3 keeps this
difference).

Strategies: "backward" (the last right key <= the left key), "forward"
(the first >= it) and "nearest" (the closer of the two; a tie goes
backward, as the JAX package's `d1 <= d2`). `tolerance` drops a match
farther than it: a number in the key's units, a `timedelta`, or a fixed
duration string ("1s", "500ms"); a calendar one ("1mo") raises.
"""

from __future__ import annotations

import datetime as _pydt
from typing import List, Sequence

import torch

from ..batch import Column, Table
from ..config import capacity_for
from ..dtypes import Date, Datetime, Duration, supertype
from ..errors import ComputeError
from ..expr.eval import Val, cast_val, column_to_val
from . import compact as Cp
from .keycode import encode_key_words, orderable_i64
from .merge_sort import merge_sort_words
from .range_agg import segmented_searchsorted
from .search import searchsorted

__all__ = ["asof_join_tables", "asof_join_plan"]

_I64_MAX = (1 << 63) - 1
# bits the packed (group id, key offset) word may use: the int64 maximum
# stays above every live word, as the dead rows' sentinel
_PACK_BITS = 62
_STRATEGIES = ("backward", "forward", "nearest")


def _names(x) -> List[str]:
    if x is None:
        return []
    return [x] if isinstance(x, str) else list(x)


def _by_groups(L: Table, R: Table, by_left: Sequence[str],
               by_right: Sequence[str], lok: torch.Tensor,
               rok: torch.Tensor):
    """(left group ids, right group ids, group count on the device, left
    rows with no null `by` value, right ditto): one `build_groups` over
    both sides' `by` columns, concatenated and padded to a power of two
    (kernel F sorts such lengths), with the rows that cannot match left
    out of the layout."""
    from .groupby import build_groups
    from .join import _key_vals, _unify_keys
    if len(by_left) != len(by_right):
        raise ComputeError("join_asof: `by_left` and `by_right` differ in "
                           "length")
    lv, rv = _unify_keys(_key_vals(L, by_left), _key_vals(R, by_right))
    capL, capR = L.capacity, R.capacity
    N = capacity_for(capL + capR)
    pad = N - capL - capR
    comb = []
    for a, b in zip(lv, rv):
        lok = lok & a.valid_or_true().expand(capL)
        rok = rok & b.valid_or_true().expand(capR)
        data = torch.cat([a.data.expand(capL), b.data.expand(capR),
                          a.data.new_zeros(pad)])
        comb.append(Val(a.dtype, data, None, a.sdict, False))
    mask = torch.cat([lok, rok, lok.new_zeros(pad)])
    g = build_groups(comb, mask)
    gid = g.gid.to(torch.int64)
    return gid[:capL], gid[capL:capL + capR], g.ngroups, lok, rok


def _tolerance_value(tol, st):
    """`tolerance` in the key's storage units: a Datetime's or Duration's
    ticks, a Date's days, else the number as given."""
    if tol is None or isinstance(tol, (int, float)) and \
            not isinstance(tol, bool):
        return tol
    unit = st.time_unit if isinstance(st, (Datetime, Duration)) else "us"
    if isinstance(tol, _pydt.timedelta):
        us = (tol.days * 86_400 + tol.seconds) * 1_000_000 + \
            tol.microseconds
        ns = us * 1000
    elif isinstance(tol, str):
        from .temporal import parse_every
        kind, ns = parse_every(tol)
        if kind != "fixed":
            raise ComputeError(
                f"join_asof: a calendar tolerance ({tol!r}) is not "
                "supported")
    else:
        raise ComputeError(f"join_asof: tolerance {tol!r} is not a number, "
                           "a timedelta or a duration string")
    if st == Date:
        return ns // 86_400_000_000_000
    return ns // {"ms": 1_000_000, "us": 1_000, "ns": 1}[unit]


def asof_join_tables(left: Table, right: Table, left_on: str, right_on: str,
                     by_left=None, by_right=None, strategy: str = "backward",
                     suffix: str = "_right", tolerance=None) -> Table:
    if strategy not in _STRATEGIES:
        raise ComputeError(f"join_asof: unknown strategy {strategy!r}")
    by_left, by_right = _names(by_left), _names(by_right)
    by = bool(by_left or by_right)
    L = Cp.compact(left)
    R = Cp.compact(right)
    capL, capR = L.capacity, R.capacity
    dev = L.device
    lc, rc = L.column(left_on), R.column(right_on)
    if lc.dtype.is_string or rc.dtype.is_string:
        raise ComputeError("join_asof: the `on` keys must be numeric or "
                           "temporal")
    st = supertype(lc.dtype, rc.dtype)
    lkv = cast_val(column_to_val(lc), st)
    rkv = cast_val(column_to_val(rc), st)
    # a null key never matches
    lok = L.row_mask() & lkv.valid_or_true()
    rok = R.row_mask() & rkv.valid_or_true()
    if by:
        lgid, rgid, ngroups, lok, rok = _by_groups(
            L, R, by_left, by_right or by_left, lok, rok)
    else:
        lgid = torch.zeros(capL, dtype=torch.int64, device=dev)
        rgid = torch.zeros(capR, dtype=torch.int64, device=dev)
        ngroups = torch.ones((), dtype=torch.int64, device=dev)
    lk, rk = orderable_i64(lkv.data, st), orderable_i64(rkv.data, st)
    # the one readback: the key range over both sides' rows that can
    # match, and the group count
    big = torch.tensor(_I64_MAX, device=dev)
    kmin = torch.minimum(torch.where(lok, lk, big).min(),
                         torch.where(rok, rk, big).min())
    kmax = torch.maximum(torch.where(lok, lk, -big - 1).max(),
                         torch.where(rok, rk, -big - 1).max())
    mn, mx, ng = torch.stack([kmin, kmax, ngroups.to(torch.int64)]).tolist()
    obits = max(mx - mn, 0).bit_length()
    gbits = max(ng - 1, 0).bit_length()
    nr = rok.sum()
    pos = torch.arange(capR, device=dev)
    if gbits + obits <= _PACK_BITS:
        rpack = torch.where(rok, (rgid << obits) | (rk - mn), big)
        spack, order = torch.sort(rpack, stable=True)
        lq = torch.where(lok, (lgid << obits) | (lk - mn),
                         torch.zeros_like(lk))
        sg = spack >> obits

        def find(side):
            p = searchsorted(spack, lq, side)
            if side == "right":
                p = p - 1
            pc = p.clamp(0, max(capR - 1, 0))
            return p, (p >= 0) & (p < nr) & (sg[pc] == lgid)
    else:
        words = [(~rok).to(torch.int64)]
        if by:
            words.append(torch.where(rok, rgid, 0))
        words += encode_key_words(rkv.data, st, None, False, False)
        order = merge_sort_words(words, len(words), perm_only=True)[0]
        live_s = pos < nr
        sk = torch.where(live_s, rk[order], big)
        if by:
            sg = torch.where(live_s, rgid[order], big)
            gs = searchsorted(sg, lgid, "left")
            ge = searchsorted(sg, lgid, "right")
        else:
            gs = torch.zeros_like(lk)
            ge = nr.expand(capL)

        def find(side):
            p = segmented_searchsorted(sk, gs, ge, lk, side) if by \
                else searchsorted(sk, lk, side).clamp(max=nr)
            if side == "right":
                p = p - 1
            return p, (p >= gs) & (p < ge)

    def value_at(p):
        return rkv.data[order[p.clamp(0, max(capR - 1, 0))]]

    lval = lkv.data
    if strategy == "backward":
        p, ok = find("right")
    elif strategy == "forward":
        p, ok = find("left")
    else:
        p1, ok1 = find("right")
        p2, ok2 = find("left")
        d1 = (lval - value_at(p1)).abs()
        d2 = (value_at(p2) - lval).abs()
        use1 = ok1 & (~ok2 | (d1 <= d2))
        p = torch.where(use1, p1, p2)
        ok = ok1 | ok2
    matched = ok & lok
    ridx = order[p.clamp(0, max(capR - 1, 0))]
    tol = _tolerance_value(tolerance, st)
    if tol is not None:
        matched = matched & ((lval - rkv.data[ridx]).abs() <= tol)
    names = list(L.names)
    cols = dict(L.cols)
    skip = set(by_right or by_left) if by else set()
    if right_on == left_on:
        skip.add(right_on)
    for n in R.names:
        if n in skip:
            continue
        c = R.cols[n]
        name = n if n not in cols else f"{n}{suffix}"
        validity = matched if c.validity is None \
            else matched & c.validity[ridx]
        names.append(name)
        cols[name] = Column(c.dtype, c.data[ridx], validity, c.sdict)
    return Table(names, cols, capL, L._nrows, L.valid,
                 nrows_dev=L.nrows_dev, device=dev)


def asof_join_plan(lf, other, on, left_on, right_on, by, by_left, by_right,
                   strategy, suffix, tolerance):
    """The as-of join as a map_function node over the left plan: the
    right plan is optimized and run once per collect, inside the node."""
    from ..api.lazyframe import LazyFrame
    from ..plan import logical as Lg
    if on is not None:
        left_on = right_on = on
    if left_on is None or right_on is None:
        raise ComputeError("join_asof requires `on` or `left_on` + "
                           "`right_on`")
    if by is not None:
        by_left = by_right = by
    lp, rp = lf._plan, other._plan

    def out_schema(ins):
        out = dict(ins)
        skip = set(_names(by_right or by_left))
        if right_on == left_on:
            skip.add(right_on)
        for n, dt in rp.schema().items():
            if n not in skip:
                out[n if n not in out else f"{n}{suffix}"] = dt
        return out

    def run(t):
        from ..exec.executor import execute
        from ..plan.optimizer import optimize
        return asof_join_tables(t, execute(optimize(rp)), left_on, right_on,
                                by_left, by_right, strategy, suffix,
                                tolerance)

    return LazyFrame._from_plan(
        Lg.MapFunction(lp, run, out_schema, True, "join_asof"))
