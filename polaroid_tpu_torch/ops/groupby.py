"""Group-by: the dense (no-sort) tier.

The port of the dense tier of the JAX package's `ops/groupby.py`. When
every key's domain is statically small (dictionary strings, booleans,
8-bit ints, and integers with cached min/max stats, see
exec/executor.py) the group id of a row is its mixed-radix key code,
with no sort. All per-group sums, counts and means are one-hot segment
sums, taken by the hand-written kernel `cuda_kernels.seg_sum`, and every
simple reduction of one request is batched into ONE kernel pass (the
"stash"). The JAX package takes that kernel path only on accelerators;
the port takes it on every device, so the CPU tests run the card's path
with the kernel's plain version. Integer sums stay an exact int64
`index_add_`, as the JAX package's `_seg_sum` scatter is exact.

The empty group slots are removed with the compaction kernel
(`compact.compact_device`). Min, max, var and std, key domains above
4096 slots, maintain_order=True and the sorted layout raise
NotImplementedError naming the slice that brings them.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..batch import Column, Table, storage_torch_dtype
from ..config import capacity_for
from ..dtypes import Boolean, UInt32
from ..errors import DuplicateError
from ..expr import meta
from ..expr.eval import Val, _eval_binary, _eval_unary, _float_dt, \
    _lit_val, _sum_dtype, cast_val, eval_expr
from ..expr.expr import Expr
from .compact import compact_device
from .cuda_kernels import MAX_GROUPS, seg_sum

__all__ = ["GroupContext", "build_groups_dense", "group_by_agg"]

_NEXT_SLICE = {
    "min": "Slice A2 (onehot_seg_minmax)",
    "max": "Slice A2 (onehot_seg_minmax)",
    "var": "Slice A2 (onehot_gather)",
    "std": "Slice A2 (onehot_gather)",
}


class GroupContext:
    """Dense group layout over rows: `gid` is the key code of each row
    (dead rows get gid == out_cap, outside every group), `out_cap` the
    group-slot count (padded key-domain product), `group_count` the live
    rows of each slot (int64) and `stash` the batched kernel sums, keyed
    ("len",) / ("count"|"sum", id(column data))."""

    __slots__ = ("gid", "live", "cap", "group_count", "out_cap", "stash")

    def __init__(self, gid, live, cap, group_count, out_cap):
        self.gid = gid
        self.live = live
        self.cap = cap
        self.group_count = group_count
        self.out_cap = out_cap
        self.stash = {}


def _aggs_have_quantile(agg_exprs) -> bool:
    """Static: does any output aggregate a median/quantile? (the
    optimizer keeps a sort after such a group-by)"""
    for e in agg_exprs:
        ee = e
        while ee.kind == "alias":
            ee = ee.children[0]
        if ee.kind == "agg" and ee.attrs.get("agg") in ("median",
                                                        "quantile"):
            return True
    return False


def _seg_sums(rows: List[torch.Tensor], gid, G: int) -> List[torch.Tensor]:
    """Per-group f64 sums of several (n,) rows in ONE kernel pass. Rows
    travel as f32 when they all are f32 (0/1 counts are exact there) and
    as f64 otherwise."""
    dt = torch.float64 if any(r.dtype == torch.float64 for r in rows) \
        else torch.float32
    out = seg_sum(torch.stack([r.to(dt) for r in rows]), gid, G)
    return list(out.unbind(0))


# --- dense (no-sort) group layout for statically small key domains --------

def _dense_spans(key_vals: Sequence[Val], key_exprs=None, table=None):
    """Per-key (span, base) when the key's domain is statically known:
    dictionary strings (dict length), Boolean, 8/16-bit ints, and wider
    ints carrying host-cached min/max stats (see Column.stats). Returns
    None if any key is unbounded. Slot 0 of each span is null."""
    out = []
    for i, v in enumerate(key_vals):
        dt = v.dtype
        name = repr(dt)
        if dt.is_string:
            if v.sdict is None:
                return None
            out.append((len(v.sdict) + 1, None))
        elif name == "Boolean":
            out.append((3, None))
        elif name in ("Int8", "UInt8"):
            out.append((257, -128 if name == "Int8" else 0))
        elif name in ("Int16", "UInt16"):
            out.append((65537, -32768 if name == "Int16" else 0))
        elif dt.is_integer and key_exprs is not None and table is not None:
            e = key_exprs[i]
            while e.kind == "alias":
                e = e.children[0]
            if e.kind != "col":
                return None
            c = table.cols.get(e.attrs["name"])
            if c is None or c.stats is None or "min" not in c.stats:
                return None
            span = int(c.stats["max"]) - int(c.stats["min"]) + 2
            out.append((max(span, 2), int(c.stats["min"])))
        else:
            return None
    return out


def _dense_code(v: Val, span: int, base, cap: int) -> torch.Tensor:
    data = v.data.expand(cap)
    if v.dtype.is_string or v.dtype == Boolean:
        code = data.to(torch.int32) + 1  # null string code -1 -> 0
    else:  # integer with known base
        code = (data.to(torch.int64) - base + 1).to(torch.int32)
    if v.validity is not None:
        code = torch.where(v.validity.expand(cap), code,
                           torch.zeros_like(code))
    return code.clamp(0, span - 1)


def _dense_decode(gidx: torch.Tensor, v: Val, span: int, base=None):
    """Group slot code -> key value (data, validity); code 0 is null."""
    code = gidx.to(torch.int64)
    validity = code != 0
    if v.dtype.is_string:
        hi = max(len(v.sdict) - 1, 0) if v.sdict is not None else 0
        return (code - 1).clamp(0, hi).to(torch.int32), validity
    if v.dtype == Boolean:
        return code == 2, validity
    return (code - 1 + (base or 0)).to(storage_torch_dtype(v.dtype)), \
        validity


def build_groups_dense(key_vals: Sequence[Val], mask: torch.Tensor,
                       spans) -> GroupContext:
    """O(n) group layout: gid = mixed-radix dense key code; no sort."""
    cap = mask.shape[0]
    prod = 1
    for span, _ in spans:
        prod *= span
    out_cap = capacity_for(prod)
    if out_cap > MAX_GROUPS:
        raise NotImplementedError(
            f"group-by over {out_cap} key slots: domains above {MAX_GROUPS} "
            "take the hash-exchange group-by (Slice B of the port)")
    gid = torch.zeros(cap, dtype=torch.int32, device=mask.device)
    for v, (span, base) in zip(key_vals, spans):
        gid = gid * span + _dense_code(v, span, base or 0, cap)
    gid = torch.where(mask, gid, torch.full_like(gid, out_cap))
    (cnt,) = _seg_sums([torch.ones(cap, dtype=torch.float32,
                                   device=mask.device)], gid, out_cap)
    return GroupContext(gid, mask, cap, cnt.to(torch.int64), out_cap)


# ---------------------------------------------------------------------------
# aggregation over groups
# ---------------------------------------------------------------------------

def reduce_group(agg: str, v: Val, ctx: GroupContext) -> Val:
    """One grouped reduction (reference: `polars-expr/src/reduce/*.rs`)."""
    cap, ncap, gid, dt = ctx.cap, ctx.out_cap, ctx.gid, v.dtype
    sx = v.data.expand(cap)
    # rows that take part: live, and non-null for the value aggregates
    present = ctx.live
    spart = present if v.validity is None else \
        (present & v.validity.expand(cap))
    stash = ctx.stash  # batched sums of this request, keyed by column

    def counted(mask):
        (c,) = _seg_sums([mask.to(torch.float32)], gid, ncap)
        return Val(UInt32, c.to(torch.int64))

    if agg == "len":
        return counted(present)
    if agg == "count":
        st = stash.get(("count", id(v.data)))
        return Val(UInt32, st.to(torch.int64)) if st is not None \
            else counted(spart)
    if agg == "null_count":
        return counted(present & ~spart)
    if agg == "sum":
        if dt.is_bool:
            return counted(spart & sx)
        if dt.is_float:
            out_dt = _sum_dtype(dt)
            s = stash.get(("sum", id(v.data)))
            if s is None:
                (s,) = _seg_sums([torch.where(spart, sx,
                                              torch.zeros_like(sx))],
                                 gid, ncap)
            return Val(out_dt, s.to(storage_torch_dtype(out_dt)))
        if dt.is_integer:
            # exact int64 scatter, as the JAX package's _seg_sum
            x = torch.where(spart, sx, torch.zeros_like(sx)).to(torch.int64)
            idx = torch.where(gid < ncap, gid,
                              torch.full_like(gid, ncap)).long()
            s = torch.zeros(ncap + 1, dtype=torch.int64, device=sx.device)
            s.index_add_(0, idx, x)
            out_dt = _sum_dtype(dt)
            return Val(out_dt, s[:ncap].to(storage_torch_dtype(out_dt)))
    if agg == "mean" and (dt.is_float or dt.is_integer or dt.is_bool):
        out_dt = _float_dt(dt)
        ss = stash.get(("sum", id(v.data)))
        nn = stash.get(("count", id(v.data)))
        if ss is None or nn is None:
            xf = sx.to(torch.float64) if not dt.is_float else sx
            ss, nn = _seg_sums([torch.where(spart, xf, torch.zeros_like(xf)),
                                spart.to(torch.float32)], gid, ncap)
        m = ss / nn.clamp(min=1)
        return Val(out_dt, m.to(storage_torch_dtype(out_dt)), nn > 0)
    if agg in _NEXT_SLICE:
        raise NotImplementedError(
            f"group-by {agg} is not ported yet: it comes with "
            f"{_NEXT_SLICE[agg]}")
    raise NotImplementedError(
        f"group-by aggregation {agg!r} on {dt!r} is not ported yet")


def eval_group_expr(e: Expr, table: Table, ctx: GroupContext,
                    key_outputs: dict) -> Val:
    """Evaluate an agg-context expression to a per-group Val."""
    k = e.kind
    if k in ("alias", "name_map", "name_keep"):
        return eval_group_expr(e.children[0], table, ctx, key_outputs)
    if k == "agg":
        inner = eval_expr(e.children[0], table, "agg")
        return reduce_group(e.attrs["agg"], inner, ctx)
    if k == "table_len":
        # the layout pass already counted the live rows of each group
        return Val(UInt32, ctx.group_count)
    if k == "lit":
        return _lit_val(e.attrs["value"], e.attrs["dtype"], table.device)
    if k == "col" and e.attrs["name"] in key_outputs:
        return key_outputs[e.attrs["name"]]
    if k == "cast":
        return cast_val(eval_group_expr(e.children[0], table, ctx,
                                        key_outputs), e.attrs["dtype"])
    if k == "binary":
        return _eval_binary(
            e.attrs["op"],
            eval_group_expr(e.children[0], table, ctx, key_outputs),
            eval_group_expr(e.children[1], table, ctx, key_outputs))
    if k == "unary":
        return _eval_unary(e.attrs["op"], eval_group_expr(
            e.children[0], table, ctx, key_outputs))
    raise NotImplementedError(
        f"expression kind {k!r} in a group-by aggregation is not ported yet")


def _collect_stash_requests(agg_exprs, table: Table, cap: int) -> dict:
    """The simple one-hot reductions of one request, to batch into one
    kernel pass (the JAX package's one-request stash)."""
    reqs = {}

    def visit(e):
        if e.kind == "table_len":
            reqs.setdefault(("len",), None)
        elif e.kind == "agg" and e.children:
            c = e.children[0]
            while c.kind == "alias":
                c = c.children[0]
            kind = e.attrs.get("agg")
            colo = table.cols.get(c.attrs.get("name")) \
                if c.kind == "col" else None
            if colo is not None and colo.data.shape[0] == cap:
                did = id(colo.data)
                dt = colo.dtype
                if kind == "len":
                    reqs.setdefault(("len",), None)
                if kind in ("count", "mean"):
                    reqs.setdefault(("count", did), colo)
                if (kind == "sum" and dt.is_float) or (
                        kind == "mean" and (dt.is_float or dt.is_integer
                                            or dt.is_bool)):
                    reqs.setdefault(("sum", did), colo)
        for ch in e.children:
            visit(ch)

    for e in agg_exprs:
        visit(e)
    return reqs


def _fill_stash(gctx: GroupContext, reqs: dict) -> None:
    cap = gctx.cap
    dev = gctx.gid.device
    rows = []
    for rk, colo in reqs.items():
        if rk[0] == "len":
            rows.append(torch.ones(cap, dtype=torch.float32, device=dev))
        elif rk[0] == "count":
            rows.append(torch.ones(cap, dtype=torch.float32, device=dev)
                        if colo.validity is None
                        else colo.validity.to(torch.float32))
        else:  # sum
            x = colo.data if colo.dtype.is_float \
                else colo.data.to(torch.float64)
            if colo.validity is not None:
                x = torch.where(colo.validity, x, torch.zeros_like(x))
            rows.append(x)
    # gid already routes dead rows outside every group
    gctx.stash = dict(zip(reqs.keys(), _seg_sums(rows, gctx.gid,
                                                  gctx.out_cap)))


def _needs_sorted_layout(agg_exprs: Sequence[Expr]) -> bool:
    """product's cumprod trick requires contiguous group runs."""
    def rec(e: Expr) -> bool:
        if e.kind == "agg" and e.attrs.get("agg") == "product":
            return True
        return any(rec(c) for c in e.children)
    return any(rec(a) for a in agg_exprs)


def group_by_agg(table: Table, key_exprs: Sequence[Expr],
                 agg_exprs: Sequence[Expr],
                 maintain_order=False) -> Table:
    """GROUP BY keys AGG exprs -> one row per group, in ascending key
    order (nulls first). maintain_order may be the optimizer's "key"
    sentinel: the dense layout emits key order, so it needs nothing."""
    if maintain_order is True:
        raise NotImplementedError(
            "group_by(maintain_order=True) needs the first row of each "
            "group (onehot_seg_minmax): Slice A2 of the port")
    cap = table.capacity
    mask = table.row_mask()
    key_vals = [eval_expr(k, table, "select") for k in key_exprs]
    spans = _dense_spans(key_vals, key_exprs, table)
    if spans is None or _needs_sorted_layout(agg_exprs):
        raise NotImplementedError(
            "this group-by needs the sorted layout (an unbounded key, or "
            "product): Slice B of the port")
    gctx = build_groups_dense(key_vals, mask, spans)
    reqs = _collect_stash_requests(agg_exprs, table, cap)
    if len(reqs) > 1:
        _fill_stash(gctx, reqs)
    ocap = gctx.out_cap

    # group keys: the slot index IS the key — decode it
    key_outputs = {}
    names: List[str] = []
    cols = {}
    gvalid_rows = gctx.group_count > 0
    slot = torch.arange(ocap, dtype=torch.int64, device=mask.device)
    key_decoded = []
    for span, _ in reversed(spans):
        key_decoded.append(slot % span)
        slot = slot // span
    key_decoded.reverse()
    for ke, kv, kc, (span, base) in zip(key_exprs, key_vals, key_decoded,
                                        spans):
        name = meta.output_name(ke)
        data, kvalid = _dense_decode(kc, kv, span, base)
        svalid = kvalid & gvalid_rows if kv.validity is not None else None
        key_outputs[name] = Val(kv.dtype, data, svalid, kv.sdict)
        if name in cols:
            raise DuplicateError(f"duplicate key name {name!r}")
        names.append(name)
        cols[name] = Column(kv.dtype, data, svalid, kv.sdict)

    for ae in agg_exprs:
        name = meta.output_name(ae)
        v = eval_group_expr(ae, table, gctx, key_outputs)
        if name in cols:
            raise DuplicateError(f"duplicate column name {name!r}")
        names.append(name)
        data = v.data.expand(ocap).contiguous()
        validity = v.validity.expand(ocap).contiguous() \
            if v.validity is not None else None
        cols[name] = Column(v.dtype, data, validity, v.sdict)

    # the dense layout leaves empty key slots: compact them away on the
    # device with the compaction kernel (no host sync)
    tmp = Table(names, cols, ocap, None, gvalid_rows, device=mask.device)
    out, count = compact_device(tmp)
    return out.with_valid(None, None, nrows_dev=count)
