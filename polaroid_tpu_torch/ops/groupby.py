"""Group-by: the dense (no-sort) tier and the hash tier.

The port of the dense and hash-exchange tiers of the JAX package's
`ops/groupby.py`. When every key's domain is statically known
(dictionary strings, booleans, 8/16-bit ints, and integers with cached
min/max stats, see exec/executor.py) each row gets a mixed-radix key
code with no sort, and the product of the key spans picks the layout:

* up to 4096 slots, the dense tier: the key code IS the group id. All
  per-group sums, counts and means are one-hot segment sums taken by the
  hand-written kernel `cuda_kernels.seg_sum`, and every simple reduction
  of one request is batched into ONE kernel pass (the "stash"). Min and
  max (and so any, all, first, last and each group's first row) are
  segment extremes taken by the kernel `cuda_kernels.seg_minmax`, and
  var/std broadcast each group's mean back to its rows with the kernel
  `cuda_kernels.gather`. The empty group slots are removed with the
  compaction kernel (`compact.compact_device`), or, under
  maintain_order=True, sorted last by a stable sort of the few slots by
  their first row.
* up to 2^32 slots, the hash tier (`ops/hgroup.py`): the key codes go
  through the hash exchange (kernel E, `exchange.bucket_exchange`), or
  the carry sort when `hgroup.precheck` refuses it, and each live row
  gets a dense group id in hash order. The same reductions then run as
  large-G torch scatter ops (`ops/segment.py`), which stand in for the
  JAX package's XLA segmented scans there.

The JAX package takes the one-hot kernels only on accelerators and the
hash tier only at 2^14 <= capacity < 2^24; the port takes both on every
device and at every capacity, so the CPU tests run the card's path with
the kernels' plain versions. Integer sums are an exact int64 scatter in
both tiers, as the JAX package's `_seg_sum` scatter is exact.

Unbounded or larger key domains and the sorted layout raise
NotImplementedError naming the slice that brings them.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..batch import Column, Table, storage_torch_dtype
from ..config import capacity_for
from ..dtypes import Boolean, UInt32
from ..errors import DuplicateError, InvalidOperationError
from ..expr import meta
from ..expr.eval import Val, _eval_binary, _eval_unary, _float_dt, \
    _lit_val, _sum_dtype, _type_bounds, cast_val, eval_expr
from ..expr.expr import Expr
from . import hgroup
from .compact import compact_device, gather_table
from .cuda_kernels import MAX_GROUPS, gather, seg_minmax, seg_sum
from .segment import segment_minmax, segment_sum, segment_sum_int, \
    segment_take

__all__ = ["GroupContext", "HashGroupContext", "build_groups_dense",
           "build_groups_hash", "group_by_agg"]

_I64_SIGN = -(1 << 63)
# the largest key domain of the hash tier: its key codes are u32 words
_HASH_DOMAIN = 1 << 32
_SORTED_TIER = "the sorted tier (Slice B2 of the port)"

# aggregates that need each group's rows in order: the sorted tier
_NEXT_SLICE = {agg: _SORTED_TIER
               for agg in ("median", "quantile", "n_unique", "arg_min",
                           "arg_max", "product")}


class GroupContext:
    """Dense group layout over rows: `gid` is the key code of each row
    (dead rows get gid == out_cap, outside every group), `out_cap` the
    group-slot count (padded key-domain product), `group_count` the live
    rows of each slot (int64) and `stash` the batched kernel sums, keyed
    ("len",) / ("count"|"sum", id(column data)).

    The reduction primitives (`sums`, `extreme`, `take`, `int_sum`) are
    the dense tier's kernels here; `HashGroupContext` takes the same
    reductions over any number of groups."""

    __slots__ = ("gid", "live", "cap", "group_count", "out_cap", "stash",
                 "_group_start")

    def __init__(self, gid, live, cap, group_count, out_cap):
        self.gid = gid
        self.live = live
        self.cap = cap
        self.group_count = group_count
        self.out_cap = out_cap
        self.stash = {}
        self._group_start = None

    def _positions(self) -> torch.Tensor:
        return torch.arange(self.cap, dtype=torch.int32,
                            device=self.gid.device)

    @property
    def group_start(self) -> torch.Tensor:
        """The first live row of each slot (int32; cap for an empty
        slot): one segment min over the row positions, taken at first
        use and kept."""
        if self._group_start is None:
            self._group_start = self.extreme(self._positions(), None, False,
                                             self.cap)
        return self._group_start

    def group_end(self) -> torch.Tensor:
        """The last live row of each slot (int32; -1 for an empty one)."""
        return self.extreme(self._positions(), None, True, -1)

    def slot_codes(self) -> torch.Tensor:
        """The key code of each group slot (int64): the slot itself."""
        return torch.arange(self.out_cap, dtype=torch.int64,
                            device=self.gid.device)

    def sums(self, rows: List[torch.Tensor]) -> List[torch.Tensor]:
        """Per-group f64 sums of several (n,) rows in ONE kernel pass.
        Rows travel as f32 when they all are f32 (0/1 counts are exact
        there) and as f64 otherwise."""
        dt = torch.float64 if any(r.dtype == torch.float64 for r in rows) \
            else torch.float32
        out = seg_sum(torch.stack([r.to(dt) for r in rows]), self.gid,
                      self.out_cap)
        return list(out.unbind(0))

    def _extreme(self, x, gid, is_max, identity):
        return seg_minmax(x, gid, self.out_cap, is_max, identity)

    def extreme(self, x: torch.Tensor, live, is_max: bool, identity
                ) -> torch.Tensor:
        """Per-group min/max of the rows of `x` where `live` (None: every
        row); rows outside `live` go to an id outside every group. Bool
        and ints narrower than 32 bits are widened to int32 (the result
        stays widened)."""
        gid = self.gid
        if live is not None:
            gid = torch.where(live, gid, torch.full_like(gid, self.out_cap))
        if x.dtype in (torch.bool, torch.int8, torch.uint8, torch.int16):
            x = x.to(torch.int32)
        return self._extreme(x.contiguous(), gid, is_max, identity)

    def take(self, table: torch.Tensor) -> torch.Tensor:
        """Each row's entry of a per-group table (0 for dead rows)."""
        return gather(table, self.gid)

    def int_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Exact int64 per-group sums, as the JAX package's _seg_sum."""
        return segment_sum_int(x, self.gid, self.out_cap)


class HashGroupContext(GroupContext):
    """The hash tier's layout: `gid` numbers each live row's group
    densely (hash order on the exchange path, key order on the carry-sort
    fallback), `out_cap` is the row capacity (there are never more groups
    than rows), `key_codes` the key code of each group (2^32 past the
    last) and `ngroups` their device count. The reductions are large-G
    torch scatter ops (`ops/segment.py`)."""

    __slots__ = ("key_codes", "ngroups")

    def __init__(self, gid, live, cap, group_count, key_codes, ngroups):
        super().__init__(gid, live, cap, group_count, cap)
        self.key_codes = key_codes
        self.ngroups = ngroups

    def slot_codes(self) -> torch.Tensor:
        return self.key_codes

    def sums(self, rows: List[torch.Tensor]) -> List[torch.Tensor]:
        out = segment_sum(torch.stack([r.to(torch.float64) for r in rows]),
                          self.gid, self.out_cap)
        return list(out.unbind(0))

    def _extreme(self, x, gid, is_max, identity):
        return segment_minmax(x, gid, self.out_cap, is_max, identity)

    def take(self, table: torch.Tensor) -> torch.Tensor:
        return segment_take(table, self.gid)


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


def _to_f64(x: torch.Tensor, dt) -> torch.Tensor:
    """Values as float64. UInt64 is held in int64 (values >= 2^63 wrap to
    negative): convert it from its two 32-bit halves, which rounds once,
    as a uint64 -> float64 conversion does."""
    if repr(dt) != "UInt64":
        return x.to(torch.float64)
    hi = ((x >> 32) & 0xFFFFFFFF).to(torch.float64)
    return hi * 4294967296.0 + (x & 0xFFFFFFFF).to(torch.float64)


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


def _dense_code(v: Val, span: int, base, cap: int,
                dtype=torch.int32) -> torch.Tensor:
    """Each row's code in [0, span) (0 for null), as `dtype`: int32 for
    the dense tier, int64 for the hash tier's spans of up to 2^32."""
    data = v.data.expand(cap)
    if v.dtype.is_string or v.dtype == Boolean:
        code = data.to(dtype) + 1  # null string code -1 -> 0
    else:  # integer with known base
        code = (data.to(torch.int64) - base + 1).clamp(0, span - 1).to(dtype)
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


def _span_product(spans) -> int:
    prod = 1
    for span, _ in spans:
        prod *= span
    return prod


def build_groups_dense(key_vals: Sequence[Val], mask: torch.Tensor,
                       spans) -> GroupContext:
    """O(n) group layout: gid = mixed-radix dense key code; no sort. The
    span product must be at most MAX_GROUPS."""
    cap = mask.shape[0]
    out_cap = capacity_for(_span_product(spans))
    gid = torch.zeros(cap, dtype=torch.int32, device=mask.device)
    for v, (span, base) in zip(key_vals, spans):
        gid = gid * span + _dense_code(v, span, base or 0, cap)
    gid = torch.where(mask, gid, torch.full_like(gid, out_cap))
    ctx = GroupContext(gid, mask, cap, None, out_cap)
    (cnt,) = ctx.sums([torch.ones(cap, dtype=torch.float32,
                                  device=mask.device)])
    ctx.group_count = cnt.to(torch.int64)
    return ctx


def build_groups_hash(key_vals: Sequence[Val], mask: torch.Tensor,
                      spans) -> HashGroupContext:
    """The hash tier's layout of a key domain of at most 2^32 slots: the
    mixed-radix key code (first key most significant, as the dense
    decode) grouped by the hash exchange, or by the carry sort when
    `hgroup.precheck` refuses it (`hgroup.group_ids`)."""
    cap = mask.shape[0]
    code = torch.zeros(cap, dtype=torch.int64, device=mask.device)
    for v, (span, base) in zip(key_vals, spans):
        code = code * span + _dense_code(v, span, base or 0, cap,
                                         torch.int64)
    gid, codes, ngroups = hgroup.group_ids(code, mask)
    count = segment_sum_int(mask.to(torch.int64), gid, cap)
    return HashGroupContext(gid, mask, cap, count, codes, ngroups)


# ---------------------------------------------------------------------------
# aggregation over groups
# ---------------------------------------------------------------------------

def reduce_group(agg: str, v: Val, ctx: GroupContext,
                 attrs: dict = None) -> Val:
    """One grouped reduction (reference: `polars-expr/src/reduce/*.rs`)."""
    cap, dt = ctx.cap, v.dtype
    sx = v.data.expand(cap)
    # rows that take part: live, and non-null for the value aggregates
    present = ctx.live
    spart = present if v.validity is None else \
        (present & v.validity.expand(cap))
    stash = ctx.stash  # batched sums of this request, keyed by column

    def counted(mask):
        (c,) = ctx.sums([mask.to(torch.float32)])
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
                (s,) = ctx.sums([torch.where(spart, sx,
                                             torch.zeros_like(sx))])
            return Val(out_dt, s.to(storage_torch_dtype(out_dt)))
        if dt.is_integer:
            s = ctx.int_sum(torch.where(spart, sx, torch.zeros_like(sx)))
            out_dt = _sum_dtype(dt)
            return Val(out_dt, s.to(storage_torch_dtype(out_dt)))
    numeric = dt.is_float or dt.is_integer or dt.is_bool
    if agg in ("mean", "var", "std") and numeric:
        out_dt = _float_dt(dt)
        xf = sx if dt.is_float else _to_f64(sx, dt)
        ss = stash.get(("sum", id(v.data)))
        nn = stash.get(("count", id(v.data)))
        if ss is None or nn is None:
            ss, nn = ctx.sums([torch.where(spart, xf, torch.zeros_like(xf)),
                               spart.to(torch.float32)])
        m = ss / nn.clamp(min=1)
        if agg == "mean":
            return Val(out_dt, m.to(storage_torch_dtype(out_dt)), nn > 0)
        # two passes in f64, as the JAX package's CPU path: the group mean
        # gathered back to the rows (dead rows read 0 and are masked),
        # then the squared deviations summed
        ddof = (attrs or {}).get("ddof", 1)
        xf = xf.to(torch.float64)
        d2 = torch.where(spart, (xf - ctx.take(m)) ** 2,
                         torch.zeros_like(xf))
        (sq,) = ctx.sums([d2])
        var = sq / (nn - ddof).clamp(min=1)
        out = torch.sqrt(var) if agg == "std" else var
        return Val(out_dt, out.to(storage_torch_dtype(out_dt)), nn > ddof)
    if agg in ("any", "all"):
        if not dt.is_bool:
            raise InvalidOperationError(f"{agg} on {dt!r}")
        if agg == "any":
            r = ctx.extreme(spart & sx, None, True, 0)
        else:
            r = ctx.extreme(sx, spart, False, 1)
        return Val(Boolean, r == 1)
    if agg in ("min", "max"):
        is_max = agg == "max"
        if v.validity is None:
            has = ctx.group_count > 0
        else:
            n = stash.get(("count", id(v.data)))
            has = (n if n is not None else counted(spart).data) > 0
        if dt.is_string:
            # sorted dictionary: code order is string order
            r = ctx.extreme(sx, spart, is_max,
                            -1 if is_max else _type_bounds(torch.int32)[1])
            return Val(dt, r, has, v.sdict)
        # UInt64 is held in int64: flip the sign bit so that signed order
        # is unsigned order, and flip it back after
        u64 = repr(dt) == "UInt64"
        x = sx ^ _I64_SIGN if u64 else sx
        lo, hi = _type_bounds(x.dtype)
        r = ctx.extreme(x, spart, is_max, lo if is_max else hi)
        if u64:
            r = r ^ _I64_SIGN
        return Val(dt, r.to(sx.dtype), has)
    if agg in ("first", "last"):
        sel = ctx.group_start if agg == "first" else ctx.group_end()
        selc = sel.clamp(0, cap - 1).long()
        validity = ctx.group_count > 0
        if v.validity is not None:
            validity = validity & v.validity.expand(cap)[selc]
        return Val(dt, sx[selc], validity, v.sdict)
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
        return reduce_group(e.attrs["agg"], inner, ctx, e.attrs)
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
                numeric = dt.is_float or dt.is_integer or dt.is_bool
                if kind == "count" or (kind in ("mean", "var", "std")
                                       and numeric):
                    reqs.setdefault(("count", did), colo)
                if (kind == "sum" and dt.is_float) or (
                        kind in ("mean", "var", "std") and numeric):
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
                else _to_f64(colo.data, colo.dtype)
            if colo.validity is not None:
                x = torch.where(colo.validity, x, torch.zeros_like(x))
            rows.append(x)
    # gid already routes dead rows outside every group
    gctx.stash = dict(zip(reqs.keys(), gctx.sums(rows)))


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
    """GROUP BY keys AGG exprs -> one row per group. The dense tier emits
    ascending key order (nulls first), the hash tier hash order;
    maintain_order=True gives the order of each group's first live row,
    and the optimizer's "key" sentinel (a sort on the keys after the
    group-by was dropped) ascending key order from either tier."""
    cap = table.capacity
    mask = table.row_mask()
    key_vals = [eval_expr(k, table, "select") for k in key_exprs]
    spans = _dense_spans(key_vals, key_exprs, table)
    if spans is None or _needs_sorted_layout(agg_exprs):
        raise NotImplementedError(
            "this group-by needs the sorted layout (an unbounded key, or "
            f"product): it comes with {_SORTED_TIER}")
    domain = _span_product(spans)
    if domain <= MAX_GROUPS:
        gctx = build_groups_dense(key_vals, mask, spans)
    elif domain <= _HASH_DOMAIN:
        gctx = build_groups_hash(key_vals, mask, spans)
    else:
        raise NotImplementedError(
            f"group-by over {domain} key slots: domains above 2^32 come "
            f"with {_SORTED_TIER}")
    reqs = _collect_stash_requests(agg_exprs, table, cap)
    if len(reqs) > 1:
        _fill_stash(gctx, reqs)
    ocap = gctx.out_cap

    # group keys: decode each slot's mixed-radix key code
    key_outputs = {}
    names: List[str] = []
    cols = {}
    gvalid_rows = gctx.group_count > 0
    slot = gctx.slot_codes()
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

    tmp = Table(names, cols, ocap, None, gvalid_rows, device=mask.device)
    hashed = isinstance(gctx, HashGroupContext)
    if maintain_order is True or (hashed and maintain_order == "key"):
        # a stable sort of the slots by each group's first row (or, for
        # "key", by its key code), in which the empty slots (first row
        # cap, key code 2^32) go last, so the groups come out as a prefix
        # (no host sync)
        perm = torch.sort(gctx.group_start if maintain_order is True
                          else gctx.key_codes, stable=True).indices
        out = gather_table(tmp, perm, None, None)
        return out.with_valid(None, None, nrows_dev=gvalid_rows.sum())
    if hashed:
        # the hash tier numbered its groups densely: they already are a
        # prefix (the compaction kernel removed the layout's empty slots
        # when it gathered the group keys, hgroup.hash_group_ids)
        return tmp.with_valid(None, None, nrows_dev=gctx.ngroups)
    # the dense layout leaves empty key slots: compact them away on the
    # device with the compaction kernel (no host sync)
    out, count = compact_device(tmp)
    return out.with_valid(None, None, nrows_dev=count)
