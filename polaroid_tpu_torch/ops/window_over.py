"""Grouped window expressions: `expr.over(partition_by)`.

The port of the JAX package's `ops/window_over.py` (capability analogue
of the reference's WindowExpr, `polars-expr/src/expressions/window.rs`):
an aggregation per partition broadcast back to the rows, or an
order-dependent op (shift, diff, cum_*, rank, fills, rolling and ewm
windows, reverse) segmented by partition. Everything runs on the sorted
tier's layout (`groupby.build_groups`): the rows sorted stably by
(dead, partition keys[, order_by words]), so each partition is one run
in row order (or `order_by` order), with no per-group loop.

Differences from the JAX package, which permutes through fused-sort
writebacks because gathers are slow on a TPU (`apply_perm_u32`,
`fused_argsort`): here the values go to the sorted layout by a gather
by `perm` and the results back by one scatter by `perm`. A partition's
start comes from the layout's run starts (one kernel-B compaction in
`build_groups`) gathered by each slot's group id, not from a `cummax`;
segmented scans are log-doubling scans (`ops/scan.py`); fills are a
prefix count, one compaction and a gather.

`rank().over()` with no `order_by` and a value of at most two words is
fused (`_rank_over_fused`): the value's words join the partition sort,
so ranks come out of run geometry with no second sort (H2O q8). A
nullable 8-byte value (three words) takes `_rank_over`: a second sort by
(group, value). Range windows by a companion column (`rolling_*_by`)
search each partition by one int64 key (the group id above the `by`
value's offset, `range_bounds`) and rank within each partition.
`mapping_strategy="join"` implodes each group's result into one list
(`groupby.group_implode`) and joins it back to the group's rows.
"""

from __future__ import annotations

import torch

from ..batch import storage_torch_dtype as _stor
from ..dtypes import Float64, Null, UInt32
from ..errors import InvalidOperationError
from ..expr.eval import Val, _float_dt, _type_bounds, cast_val, eval_expr
from ..expr.expr import Expr
from ..expr import window as W
from .groupby import SortedGroupContext, build_groups, eval_group_expr
from .keycode import encode_key_words
from .scan import reverse_scan, run_starts, seg_scan

__all__ = ["eval_over"]


def _full(v: Val, cap: int) -> Val:
    """`v` at full capacity (scalars broadcast)."""
    return Val(v.dtype, v.data.expand(cap),
               None if v.validity is None else v.validity.expand(cap),
               v.sdict, False, v.live)


def _is_agg_combo(e: Expr) -> bool:
    """An elementwise combination of aggregates (e.g. x.sum() + 1)."""
    if e.kind in ("agg", "table_len"):
        return True
    if e.kind in ("binary", "unary", "cast", "alias"):
        ok = False
        for c in e.children:
            if c.kind == "lit":
                continue
            if not _is_agg_combo(c):
                return False
            ok = True
        return ok
    return False


def _order_words(e: Expr, table, ctx: str, order_exprs, cap: int):
    """The order_by columns' words, below the partition key: the stable
    sort then lays each partition out in order_by order (ties keep row
    order)."""
    n_ord = len(order_exprs)
    desc = e.attrs.get("descending", False)
    nl = e.attrs.get("nulls_last", False)
    descs = list(desc) if isinstance(desc, (list, tuple)) else [desc] * n_ord
    nls = list(nl) if isinstance(nl, (list, tuple)) else [nl] * n_ord
    words = []
    for oe, d, nlast in zip(order_exprs, descs, nls):
        ov = _full(eval_expr(oe, table, ctx), cap)
        words.extend(encode_key_words(ov.data, ov.dtype, ov.validity,
                                      bool(d), bool(nlast)))
    return words


def eval_over(e: Expr, table, ctx: str) -> Val:
    inner = e.children[0]
    while inner.kind == "alias":    # the outer expression names the result
        inner = inner.children[0]
    n_part = e.attrs.get("n_partition", len(e.children) - 1)
    n_ord = e.attrs.get("n_order", 0)
    parts = list(e.children[1:1 + n_part])
    order_exprs = list(e.children[1 + n_part:1 + n_part + n_ord])
    cap = table.capacity
    mask = table.row_mask()
    key_vals = [_full(eval_expr(p, table, ctx), cap) for p in parts]
    ms = e.attrs.get("mapping_strategy", "group_to_rows")
    if ms not in ("group_to_rows", "explode", "join"):
        raise InvalidOperationError(
            f"unknown mapping_strategy {ms!r}; expected 'group_to_rows', "
            "'join' or 'explode'")
    if ms == "group_to_rows" and not order_exprs and cap < (1 << 30) and \
            inner.kind == "window" and inner.attrs.get("op") == "rank":
        v = _full(eval_expr(inner.children[0], table, ctx), cap)
        vw = encode_key_words(v.data, v.dtype, v.validity,
                              bool(inner.attrs.get("descending", False)),
                              True)
        if len(vw) <= 2:
            gctx = build_groups(key_vals, mask, vw, row_gid=False)
            return _rank_over_fused(inner, v, gctx, v.validity is not None)
    by_row = inner.kind != "window" or ms == "join"
    gctx = build_groups(key_vals, mask,
                        _order_words(e, table, ctx, order_exprs, cap),
                        row_gid=by_row)
    if ms == "join":
        return _eval_over_join(inner, table, gctx, cap)
    if ms == "explode":
        return _eval_over_explode(inner, table, ctx, gctx)
    if inner.kind in ("agg", "table_len") or _is_agg_combo(inner):
        gv = _full(eval_group_expr(inner, table, gctx, {}), cap)
        g = gctx.gid.clamp(0, cap - 1).long()
        return Val(gv.dtype, gv.data[g],
                   None if gv.validity is None else gv.validity[g],
                   gv.sdict, False)
    if inner.kind == "window":
        return _eval_window_over(inner, table, ctx, gctx)
    raise InvalidOperationError(
        f"expression kind {inner.kind!r} not supported with .over()")


def _eval_over_join(inner: Expr, table: Table, gctx, cap: int) -> Val:
    """mapping_strategy='join': each group's result as one list (its
    rows imploded, or a one-element list of its aggregate), joined back
    to every row of the group."""
    from ..dtypes import List as ListT
    from ..expr.eval import column_to_val, val_to_column
    from .groupby import group_implode
    g = gctx.gid.clamp(0, gctx.out_cap - 1).long()
    if inner.kind in ("agg", "table_len") or _is_agg_combo(inner):
        gv = _full(eval_group_expr(inner, table, gctx, {}), gctx.out_cap)
        return Val(ListT(gv.dtype), gv.data[g].unsqueeze(1),
                   None, gv.sdict, False,
                   lengths=torch.ones(cap, dtype=torch.int32,
                                      device=g.device),
                   elem_valid=None if gv.validity is None
                   else gv.validity[g].unsqueeze(1))
    gv = group_implode(eval_expr(inner, table, "agg"), gctx)
    return column_to_val(val_to_column(gv, gctx.out_cap).take(g))


def _eval_over_explode(inner: Expr, table, ctx: str,
                       gctx: SortedGroupContext) -> Val:
    """mapping_strategy='explode': the groups' results one after another,
    in key order (an aggregate: one row per group); only a select may
    change the frame's length. `live` marks the result's rows."""
    if ctx != "select":
        raise InvalidOperationError(
            "mapping_strategy='explode' only works in a select context "
            "(the output length differs from the frame height)")
    cap = gctx.cap
    if inner.kind in ("agg", "table_len") or _is_agg_combo(inner):
        gv = _full(eval_group_expr(inner, table, gctx, {}), cap)
        return Val(gv.dtype, gv.data, gv.validity, gv.sdict, False,
                   live=gctx.group_count > 0)
    v = _full(eval_expr(inner, table, ctx), cap)
    return Val(v.dtype, v.data[gctx.perm],
               None if v.validity is None else v.validity[gctx.perm],
               v.sdict, False, live=gctx.live_sorted)


class _Layout:
    """A value on the sorted layout: `x`, `xv` (valid and live) and each
    slot's partition bounds [gstart, gend) and group id `seg`."""

    def __init__(self, gctx: SortedGroupContext, v: Val):
        cap = gctx.cap
        perm = gctx.perm
        live = gctx.live_sorted
        self.idx = torch.arange(cap, device=perm.device)
        self.x = v.data[perm]
        self.valid = v.valid_or_true()[perm]
        self.xv = self.valid & live
        self.live = live
        self.seg = gctx.sgid
        self.perm = perm
        self._gctx = gctx
        self._sg = None

    def _group(self) -> torch.Tensor:
        if self._sg is None:
            self._sg = self._gctx.sgid.long().clamp(0, self._gctx.cap - 1)
        return self._sg

    @property
    def gstart(self) -> torch.Tensor:
        """Each slot's partition start (past the group count the run
        starts are garbage: a dead slot is a partition of its own)."""
        start = self._gctx.run_start.long()[self._group()]
        return torch.where(self.live, start, self.idx)

    @property
    def gend(self) -> torch.Tensor:
        """Each slot's partition end (exclusive)."""
        g = self._group()
        end = self._gctx.run_start.long()[g] + self._gctx.group_count[g]
        return torch.where(self.live, end, self.idx + 1)

    @property
    def span(self) -> int:
        """The longest partition's rows (one readback): the segmented
        scans need no more doubling steps than it asks."""
        return max(int(self._gctx.group_count.max()), 1)

    def back(self, data: torch.Tensor) -> torch.Tensor:
        """A sorted-layout result back to the rows (every slot is one
        row's, so the scatter writes every row)."""
        return torch.empty_like(data).scatter_(0, self.perm, data)


def _eval_window_over(e: Expr, table, ctx: str,
                      gctx: SortedGroupContext) -> Val:
    op = e.attrs["op"]
    v = _full(eval_expr(e.children[0], table, ctx), gctx.cap)
    fillv = eval_expr(e.children[1], table, ctx)
    L = _Layout(gctx, v)
    x, xv, idx, cap = L.x, L.xv, L.idx, gctx.cap

    def back(data, validity, out_dt=None):
        return Val(out_dt or v.dtype, L.back(data),
                   None if validity is None else L.back(validity),
                   v.sdict, False, v.live)

    if op in ("shift", "diff", "pct_change"):
        n = e.attrs.get("n", 1)
        src = idx - n
        inb = ((src >= L.gstart) if n >= 0 else (src < L.gend)) & L.live
        srcc = src.clamp(0, cap - 1)
        prev, pvalid = x[srcc], inb & xv[srcc]
        if op == "shift":
            if fillv.dtype != Null:
                fv = cast_val(fillv, v.dtype)
                return back(torch.where(inb, prev, fv.data.expand(cap)),
                            torch.where(inb, pvalid,
                                        fv.valid_or_true().expand(cap)))
            return back(prev, pvalid)
        validity = pvalid & xv
        if op == "diff":
            return W.diff_of(v, x, prev, validity, back)
        out_dt = _float_dt(v.dtype)
        stor = _stor(out_dt)
        return back(x.to(stor) / prev.to(stor) - 1.0, validity, out_dt)
    if op in ("cum_sum", "cum_min", "cum_max", "cum_count", "cum_prod"):
        rev = e.attrs.get("reverse", False)
        span = L.span

        def scan(vals, fn):
            return (reverse_scan if rev else seg_scan)(vals, L.seg, fn, span)

        if op == "cum_count":
            return back(scan(xv.to(torch.int64), torch.add), None, UInt32)
        if op == "cum_sum":
            data = scan(torch.where(xv, x, torch.zeros_like(x)), torch.add)
        elif op == "cum_prod":
            data = scan(torch.where(xv, x, torch.ones_like(x)), torch.mul)
        else:
            lo_b, hi_b = _type_bounds(x.dtype)
            ident = hi_b if op == "cum_min" else lo_b
            fn = torch.minimum if op == "cum_min" else torch.maximum
            data = scan(torch.where(xv, x, torch.full_like(x, ident)), fn)
        return back(data.to(x.dtype),
                    None if v.validity is None else L.valid)
    if op == "rank":
        return _rank_over(e, v, L, gctx)
    if op in ("forward_fill", "backward_fill"):
        if op == "forward_fill":
            src, has = W._last_valid(xv)
            has = has & (src >= L.gstart)
        else:
            src, has = W._next_valid(xv)
            has = has & (src < L.gend)
        return back(x[src], has & L.live)
    if op in W._ROLLING:
        return W._rolling(e, v, x, xv, L.live, back, lo=L.gstart)
    if op == "ewm_mean":
        return W._ewm_mean(e, v, x, xv, L.seg, back, L.span)
    if op == "reverse":
        src = (L.gstart + L.gend - 1 - idx).clamp(0, cap - 1)
        return back(x[src], L.valid[src])
    if op in W.RANGE_BY:
        byv = _full(eval_expr(e.children[2], table, ctx), cap)
        lo, hi, longest, longest_group = range_bounds(
            e, byv.data[L.perm], byv.dtype, gctx)
        return W.range_window_reduce(e, v, x, xv, back, lo, hi, L.live,
                                     longest, (L.seg, L.gstart,
                                               longest_group))
    raise InvalidOperationError(f"window op {op!r} not supported with .over()")


def range_bounds(e: Expr, b: torch.Tensor, bdt, gctx: SortedGroupContext,
                 closed=None):
    """[lo, hi) of each sorted slot's range window within its partition
    (`by` ascending within each partition, as the JAX package assumes
    and does not check), and the longest window. One readback gives the
    group count, the longest partition and the `by` column's range;
    where a group id and the `by` offset fit one int64 together, each
    bound is one `torch.searchsorted` over that key (ascending across
    the layout), else a segmented search of ⌈log2(longest partition)⌉
    + 1 rounds. Dead slots get empty windows."""
    from .range_agg import segmented_searchsorted
    cap = gctx.cap
    live = gctx.live_sorted
    idx = torch.arange(cap, device=live.device)
    bs, target = W.window_targets(e, b, bdt, live)
    lo_side, hi_side = W._sides(closed or e.attrs.get("closed"))
    stats = [gctx.ngroups.to(torch.int64), gctx.group_count.max()]
    keyed = not bs.is_floating_point()
    if keyed:
        lo_b, hi_b = W._type_bounds(bs.dtype)
        stats += [torch.where(live, bs, hi_b).min(),
                  torch.where(live, bs, lo_b).max()]
    stats = torch.stack([s.to(torch.int64) for s in stats]).tolist()
    ngroups, longest_group = stats[0], stats[1]
    if ngroups == 0:
        return idx, idx, 0, 0
    g = gctx.sgid.long().clamp(0, cap - 1)
    if keyed:
        bmin, bmax = stats[2], stats[3]
        S = (bmax - bmin + 2).bit_length()
        keyed = ngroups.bit_length() + S <= 62
    if keyed:
        gk = torch.where(live, g, ngroups) << S
        keys = gk | torch.where(live, bs - (bmin - 1), 0)
        qlo = gk | torch.where(live, (target - (bmin - 1)).clamp(min=0), 0)
        lo = torch.searchsorted(keys, qlo, right=lo_side == "right")
        hi = torch.searchsorted(keys, keys, right=hi_side == "right")
    else:
        start = gctx.run_start.long()[g]
        gs = torch.where(live, start, idx)
        ge = torch.where(live, start + gctx.group_count[g], idx)
        lo = segmented_searchsorted(bs, gs, ge, target, lo_side,
                                    longest_group)
        hi = segmented_searchsorted(bs, gs, ge, bs, hi_side, longest_group)
    lo = torch.where(live, lo, idx)
    hi = torch.where(live, hi, idx)
    return lo, hi, int((hi - lo).max()), longest_group


def _rank_over_fused(e: Expr, v: Val, gctx: SortedGroupContext,
                     has_nulls: bool) -> Val:
    """rank().over(partition) on a build sort that already ordered the
    rows by (partition, value words, nulls last): ranks fall out of run
    geometry with no second sort, and the stable build sort gives the
    ordinal tie-break by row. Ties are runs of equal value words; a new
    partition, and the first dead slot, start one too."""
    method = e.attrs.get("method", "average")
    cap = gctx.cap
    sw = list(gctx.sorted_extra)
    live = gctx.live_sorted
    # nulls carry a leading word that is 1 where valid (encode_key_words)
    xv = ((sw[0] == 1) & live) if has_nulls else live
    idx = torch.arange(cap, device=live.device)
    new = None
    if method != "ordinal":
        new = gctx.newgrp.clone()
        new[0] = True
        edge = live[1:] != live[:-1]
        for w in sw:
            edge |= w[1:] != w[:-1]
        new[1:] |= edge
    sg = gctx.sgid.long().clamp(0, cap - 1)
    base = torch.where(live, gctx.run_start.long()[sg], idx)
    r = W.rank_of_sorted(method, new, base, idx)
    out = torch.empty_like(r).scatter_(0, gctx.perm, r)
    valid = torch.empty_like(xv).scatter_(0, gctx.perm, xv)
    if method == "average":
        return Val(Float64, out.to(torch.float64) / 2, valid, v.sdict,
                   False, v.live)
    return Val(UInt32, out, valid, v.sdict, False, v.live)


def _rank_over(e: Expr, v: Val, L: _Layout, gctx: SortedGroupContext
               ) -> Val:
    """rank().over() by a second stable sort of the layout by (group,
    value words): the null values go to a group of their own after every
    partition; ties by layout slot are ties by row."""
    from .fused_sort import _SIGN64
    from .merge_sort import merge_sort_words
    method = e.attrs.get("method", "average")
    desc = e.attrs.get("descending", False)
    cap = gctx.cap
    gkey = torch.where(L.xv, gctx.sgid.long(), cap)
    vw = encode_key_words(L.x, v.dtype, None, desc, False)
    if len(vw) == 1:
        perm2 = torch.sort(((gkey << 32) | vw[0]) ^ _SIGN64,
                           stable=True).indices
    else:
        perm2 = merge_sort_words([gkey] + vw, 1 + len(vw),
                                 perm_only=True)[0]
    idx = L.idx
    sgk = gkey[perm2]
    g_new = torch.ones(cap, dtype=torch.bool, device=idx.device)
    g_new[1:] = sgk[1:] != sgk[:-1]
    new = g_new.clone()
    for w in vw:
        ws = w[perm2]
        new[1:] |= ws[1:] != ws[:-1]
    _, _, base, _ = run_starts(g_new)
    r = W.rank_of_sorted(method, new, base, idx)
    r = torch.empty_like(r).scatter_(0, perm2, r)
    if method == "average":
        return Val(Float64, L.back(r.to(torch.float64) / 2),
                   L.back(L.xv), v.sdict, False, v.live)
    return Val(UInt32, L.back(r), L.back(L.xv), v.sdict, False, v.live)
