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

* otherwise, the sorted tier (`build_groups`): an unbounded key (a
  computed integer key, a float key, an integer without stats) or a
  key domain above 2^32. The rows are sorted by (dead, key
  words): one key word by one packed `torch.sort`
  (`fused_sort.fused_argsort_dead_key`), more by kernel F
  (`merge_sort.merge_sort_words`, the permutation alone), and the group
  keys come out of the sorted key columns at each group's first row
  through the compaction kernel. Groups come out in ascending key
  order, nulls first.

Aggregates that need each group's values in order (median, quantile,
n_unique, mode) sort (group id, value words) once more, over any tier's
group ids: 4-byte values by one packed `torch.sort`, wider ones by
kernel F. arg_min/arg_max take two segment extremes and a count.

The JAX package takes the one-hot kernels only on accelerators and the
hash tier only at 2^14 <= capacity < 2^24; the port takes both on every
device and at every capacity, so the CPU tests run the card's path with
the kernels' plain versions. Integer sums are an exact int64 scatter in
every tier, as the JAX package's `_seg_sum` scatter is exact.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..batch import Column, Table, storage_torch_dtype, width_for
from ..config import capacity_for
from ..dtypes import Boolean, Float64, UInt32
from ..errors import ComputeError, DuplicateError, InvalidOperationError
from ..expr import meta
from ..expr.eval import Val, _eval_binary, _eval_fma, _eval_unary, \
    _float_dt, _lit_val, _sum_dtype, _type_bounds, cast_val, \
    column_to_val, eval_expr, val_to_column
from ..expr.expr import Expr
from . import hgroup
from .compact import _unword, _word, compact_device, gather_table
from .cuda_kernels import gather, seg_minmax, seg_sum
from .cuda_partition import compact_words
from .fused_sort import fused_argsort_dead_key, fused_sort_kv
from .keycode import U32, code_bits, decode_orderable, encode_key_words, \
    encode_orderable
from .merge_sort import merge_sort_words
from .segment import segment_minmax, segment_prod, segment_sum, \
    segment_sum_int, segment_take

__all__ = ["GroupContext", "HashGroupContext", "SortedGroupContext",
           "build_groups_dense", "build_groups_hash", "build_groups",
           "group_by_agg", "unique_table", "quantile_of_groups"]

_I64_SIGN = -(1 << 63)
# the dense tier's key-domain limit (the JAX package's _MXU_GROUP_LIMIT):
# kernels A and C take more groups (cuda_kernels.MAX_GROUPS), the tier's
# routing stays at this bound
DENSE_GROUPS = 4096
# the largest key domain of the hash tier: its key codes are u32 words
_HASH_DOMAIN = 1 << 32
# bits of a column counted in one batched sum by bitwise_xor
_BIT_CHUNK = 16


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

    def key_order(self):
        """What to sort the groups by for ascending key order, or None
        when the layout already emits it (the dense slots are key codes)."""
        return None

    def sums(self, rows, count: bool = False) -> List[torch.Tensor]:
        """Per-group f64 sums of several (n,) rows (a list, or the rows of
        one (C, n) tensor) in ONE kernel pass; with `count`, the live rows
        of each group first (kernel A counts them from the group ids: no
        row of ones). Rows travel as f32 when they all are f32 (0/1 counts
        are exact there) and as f64 otherwise."""
        if isinstance(rows, torch.Tensor):
            vals = rows
        elif rows:
            dt = torch.float64 if any(r.dtype == torch.float64
                                      for r in rows) else torch.float32
            vals = torch.stack([r.to(dt) for r in rows])
        else:
            vals = torch.empty((0, self.cap), dtype=torch.float32,
                               device=self.gid.device)
        return list(seg_sum(vals, self.gid, self.out_cap,
                            count=count).unbind(0))

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

    def key_order(self):
        return self.key_codes

    def sums(self, rows, count: bool = False) -> List[torch.Tensor]:
        vals = rows if isinstance(rows, torch.Tensor) else \
            torch.stack([r.to(torch.float64) for r in rows]) if rows else None
        if count:
            ones = torch.ones((1, self.cap), dtype=torch.float64,
                              device=self.gid.device)
            vals = ones if vals is None else torch.cat(
                [ones, vals.to(torch.float64)])
        return list(segment_sum(vals, self.gid, self.out_cap).unbind(0))

    def _extreme(self, x, gid, is_max, identity):
        return segment_minmax(x, gid, self.out_cap, is_max, identity)

    def take(self, table: torch.Tensor) -> torch.Tensor:
        return segment_take(table, self.gid)


class SortedGroupContext(HashGroupContext):
    """The sorted tier's layout. The rows are sorted by (dead, key
    words), stably, so each group is one run of the sort that starts at
    the group's first row. `gid` numbers each live row's group in
    ascending key order (cap for dead rows) in ROW order: the JAX package
    keeps it in sorted order and gathers every value column by the
    permutation, the port scatters it to the rows once, so its
    reductions are the hash tier's scatters over each column as it lies,
    with no gather per column and no run of equal ids for the atomics to
    contend on. `keys` holds each key's (data, validity) at its group's
    first row and `group_start` that row, for the first `ngroups` slots
    (cap after).

    The sorted layout itself stays for the windows (`ops/window_over.py`):
    `perm` (sorted slot -> row), `live_sorted`, `newgrp` (a group starts
    at the slot), `sgid` (each slot's group id, cap for dead slots),
    `run_start` (each group's first sorted slot, for the first `ngroups`
    groups) and `sorted_extra` (the ordering words below the key, sorted)."""

    __slots__ = ("keys", "perm", "live_sorted", "newgrp", "sgid",
                 "run_start", "sorted_extra")

    def __init__(self, gid, live, cap, group_count, ngroups, group_start,
                 keys, layout):
        super().__init__(gid, live, cap, group_count, None, ngroups)
        self._group_start = group_start
        self.keys = keys
        (self.perm, self.live_sorted, self.newgrp, self.sgid,
         self.run_start, self.sorted_extra) = layout

    def key_order(self):
        return None

    def group_end(self) -> torch.Tensor:
        """The row of each group's last sorted slot (-1 for an empty
        slot): the last row in the order of the ordering words, and with
        none the group's last row."""
        inside = self.group_count > 0
        last = (self.run_start.to(torch.int64) + self.group_count - 1) \
            .clamp(0, self.cap - 1)
        return torch.where(inside, self.perm[last].to(torch.int32), -1)


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
    span product must be at most DENSE_GROUPS."""
    cap = mask.shape[0]
    out_cap = capacity_for(_span_product(spans))
    gid = torch.zeros(cap, dtype=torch.int32, device=mask.device)
    for v, (span, base) in zip(key_vals, spans):
        gid = gid * span + _dense_code(v, span, base or 0, cap)
    gid = torch.where(mask, gid, torch.full_like(gid, out_cap))
    ctx = GroupContext(gid, mask, cap, None, out_cap)
    (cnt,) = ctx.sums([], count=True)
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


def _key_bits(data: torch.Tensor) -> torch.Tensor:
    """A key column's storage bits as integers: equal bits, equal key
    words (the orderable encoding is a bijection), so -0.0 and 0.0 and
    NaNs of other payloads stay apart, as they do in the JAX package."""
    if data.dtype == torch.float32:
        return data.view(torch.int32)
    if data.dtype == torch.float64:
        return data.view(torch.int64)
    return data


def _sort_rows(key_vals: Sequence[Val], mask: torch.Tensor,
               extra_words: Sequence[torch.Tensor] = ()):
    """The rows sorted by (dead, key words, extra words), stably: (perm,
    live_sorted, sorted keys as (data, validity) per key, newgrp). One
    key word and no extra word go to one packed torch.sort and the sorted
    word is decoded back; more go to kernel F, which returns the
    permutation alone, and the key columns are gathered by it. Groups
    are runs of equal keys: the extra words only order the rows within
    each group."""
    cap = mask.shape[0]
    words = [(~mask).to(torch.int64)]
    keys = []
    for v in key_vals:
        data = v.data.expand(cap)
        validity = None if v.validity is None else v.validity.expand(cap)
        keys.append((data, validity))
        words.extend(encode_key_words(data, v.dtype, validity, False, False))
    words.extend(extra_words)
    if len(words) == 2 and not extra_words and cap < (1 << 31):
        dead_s, key_s, perm = fused_argsort_dead_key(words[0], words[1])
        live_sorted = dead_s == 0
        skeys = [(decode_orderable(key_s, key_vals[0].dtype, False), None)]
    else:
        perm = merge_sort_words(words, len(words), perm_only=True)[0]
        live_sorted = mask[perm]
        skeys = [(d[perm], None if va is None else va[perm])
                 for d, va in keys]
    differs = torch.zeros(cap, dtype=torch.bool, device=mask.device)
    differs[0] = True
    for data, validity in skeys:
        b = _key_bits(data)
        if validity is not None:
            b = torch.where(validity, b, torch.zeros_like(b))
            differs[1:] |= validity[1:] != validity[:-1]
        differs[1:] |= b[1:] != b[:-1]
    return perm, live_sorted, skeys, differs & live_sorted


def build_groups(key_vals: Sequence[Val], mask: torch.Tensor,
                 extra_words: Sequence[torch.Tensor] = (),
                 row_gid: bool = True) -> SortedGroupContext:
    """The sorted tier's layout of any keys (see SortedGroupContext).
    One compaction (kernel B) at the run starts gives each group's first
    row, its first sorted slot and its keys, with no host sync: the
    group count stays on the device. `extra_words` (32-bit words as
    int64, `keycode.encode_key_words`) order the rows within each group,
    below the key; the layout keeps them sorted (`sorted_extra`), and a
    group's first row is then its first in that order. row_gid=False
    leaves `gid` None: a window on the sorted layout reduces nothing by
    row."""
    cap = mask.shape[0]
    dev = mask.device
    perm, live_sorted, skeys, newgrp = _sort_rows(key_vals, mask,
                                                  extra_words)
    ngroups = newgrp.sum()
    sgid = torch.where(live_sorted, torch.cumsum(newgrp, 0) - 1,
                       torch.full_like(perm, cap)).to(torch.int32)
    gid = None
    if row_gid:
        gid = torch.empty(cap, dtype=torch.int32, device=dev)
        gid.scatter_(0, perm, sgid)
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    words = [perm, idx]
    for data, validity in skeys:
        words.append(_word(data))
        if validity is not None:
            words.append(validity.to(torch.int32))
    outs, _ = compact_words(newgrp, words)
    first, start = outs[0], outs[1]
    inside = idx < ngroups
    # a group's rows are the sorted slots from its start to the next
    # group's (the live count after the last)
    nxt = torch.where(idx + 1 < ngroups, start.roll(-1), mask.sum())
    count = torch.where(inside, nxt - start, 0).to(torch.int64)
    it = iter(outs[2:])
    keys = []
    for data, validity in skeys:
        kd = _unword(next(it), data.dtype)
        keys.append((kd, None if validity is None else next(it) != 0))
    return SortedGroupContext(
        gid, mask, cap, count, ngroups,
        torch.where(inside, first, torch.full_like(first, cap)), keys,
        (perm, live_sorted, newgrp, sgid, start,
         tuple(w[perm] for w in extra_words)))


# ---------------------------------------------------------------------------
# aggregation over groups
# ---------------------------------------------------------------------------

def _part(v: Val, ctx: GroupContext):
    """(values, spart, present) over the rows: `present` the live rows
    that an aggregate of `v` counts (narrowed by `v.live`, the JAX
    package's `_group_present`), `spart` those with a valid value."""
    cap = ctx.cap
    present = ctx.live if v.live is None else ctx.live & v.live.expand(cap)
    spart = present if v.validity is None else \
        present & v.validity.expand(cap)
    return v.data.expand(cap), spart, present


def _count(ctx: GroupContext, rows: torch.Tensor) -> torch.Tensor:
    """Per-group int64 count of the rows where `rows` is set."""
    (c,) = ctx.sums([rows.to(torch.float32)])
    return c.to(torch.int64)


def reduce_group(agg: str, v: Val, ctx: GroupContext,
                 attrs: dict = None) -> Val:
    """One grouped reduction (reference: `polars-expr/src/reduce/*.rs`)."""
    if agg in ("implode", "agg_groups"):
        return group_implode(v, ctx, agg)
    if v.lengths is not None or v.fields is not None:
        raise InvalidOperationError(
            f"group-by {agg} of the nested column {v.dtype!r}")
    cap, dt = ctx.cap, v.dtype
    sx, spart, present = _part(v, ctx)
    # batched sums of this request, keyed by column: they hold every
    # live row, so a filtered value cannot use them
    stash = ctx.stash if v.live is None else {}

    def counted(mask):
        return Val(UInt32, _count(ctx, mask))

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
        if v.validity is None and v.live is None:
            has = ctx.group_count > 0
        else:
            n = stash.get(("count", id(v.data)))
            has = (n if n is not None else counted(spart).data) > 0
        if dt.is_string:
            # sorted dictionary: code order is string order
            r = ctx.extreme(sx, spart, is_max,
                            -1 if is_max else _type_bounds(torch.int32)[1])
            return Val(dt, r, has, v.sdict)
        x = _signed_order(sx, dt)
        lo, hi = _type_bounds(x.dtype)
        r = _signed_order(ctx.extreme(x, spart, is_max, lo if is_max else hi),
                          dt)
        return Val(dt, r.to(sx.dtype), has)
    if agg in ("first", "last"):
        if v.live is None:
            sel = ctx.group_start if agg == "first" else ctx.group_end()
            has = ctx.group_count > 0
        else:
            sel = ctx.extreme(ctx._positions(), present, agg == "last",
                              cap if agg == "first" else -1)
            has = (sel >= 0) & (sel < cap)
        selc = sel.clamp(0, cap - 1).long()
        validity = has
        if v.validity is not None:
            validity = validity & v.validity.expand(cap)[selc]
        return Val(dt, sx[selc], validity, v.sdict)
    if agg == "product":
        # each group's own rows, in f64 or in int64 that wraps (the JAX
        # package's cumprod ratio is not kept: ROADMAP Queue 3)
        acc = torch.float64 if dt.is_float else torch.int64
        x = torch.where(spart, sx.to(acc), torch.ones((), dtype=acc,
                                                      device=sx.device))
        return Val(dt, segment_prod(x, ctx.gid, ctx.out_cap).to(sx.dtype))
    if agg in ("median", "quantile"):
        q = 0.5 if agg == "median" else float(attrs["q"])
        interp = "linear" if agg == "median" else \
            attrs.get("interpolation", "nearest")
        val, n = quantile_of_groups(sx, dt, spart, ctx, q, interp)
        out_dt = _float_dt(dt)
        return Val(out_dt, val.to(storage_torch_dtype(out_dt)), n > 0)
    if agg == "n_unique":
        return _group_n_unique(v, ctx)
    if agg in ("arg_min", "arg_max"):
        return _group_arg_extreme(v, ctx, agg == "arg_max")
    if agg == "mode":
        return _group_mode(v, ctx)
    if agg in ("skew", "kurtosis") and numeric:
        return _group_moment(agg, sx, dt, spart, ctx, attrs or {})
    if agg in ("nan_min", "nan_max") and numeric and not dt.is_bool:
        # the segment extremes already let a NaN win (kernel C's order)
        r = reduce_group(agg[4:], v, ctx, attrs)
        if dt.is_float:
            r.data = torch.where(torch.isnan(r.data),
                                 torch.full_like(r.data, float("nan")),
                                 r.data)
        return r
    if agg in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        return _group_bitwise(agg, sx, dt, spart, ctx)
    if agg == "entropy" and numeric:
        a = attrs or {}
        xf = torch.where(spart, _to_f64(sx, dt), 0.0)
        if bool(a.get("normalize", True)):
            (tot,) = ctx.sums([xf])
            trow = ctx.take(tot)
            p = xf / torch.where(trow == 0, 1.0, trow)
        else:
            p = xf
        term = torch.where(spart & (p > 0), p * torch.log(p), 0.0)
        (h,) = ctx.sums([term])
        out_dt = _float_dt(dt)
        h = -h / math.log(float(a.get("base", math.e)))
        return Val(out_dt, h.to(storage_torch_dtype(out_dt)),
                   counted(spart).data > 0)
    raise ComputeError(f"unknown group aggregation {agg!r} on {dt!r}")


def _implode_layout(ctx: GroupContext, present: torch.Tensor,
                    own_live: bool):
    """Where each row goes in its group's list: the rows sorted by
    (group id, row) stably, by one packed `torch.sort` of id * cap + row
    (kernel F over the two words where that would pass 2^62), each
    group's first sorted slot (a segment min, kernel C on the dense
    tier), each row's place after it, the group counts (kernel A on the
    dense tier) and the list width, `width_for` the largest count (one
    host sync). The layout of the live rows is kept on the context for
    the request's other implodes."""
    if not own_live and "implode" in ctx.stash:
        return ctx.stash["implode"]
    cap, ncap = ctx.cap, ctx.out_cap
    dev = ctx.gid.device
    g = torch.where(present, ctx.gid.to(torch.int64),
                    torch.full_like(ctx.gid, ncap, dtype=torch.int64))
    slot = torch.arange(cap, dtype=torch.int64, device=dev)
    if (ncap + 1) * cap < (1 << 62):
        sslot = torch.sort(g * cap + slot).values % cap
    else:
        sslot = merge_sort_words([g, slot], 2, perm_only=True)[0].long()
    sg = g[sslot]
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    inside = sg < ncap
    base = ctx._extreme(torch.where(inside, idx, cap).contiguous(),
                        torch.where(inside, sg, ncap).to(torch.int32)
                        .contiguous(), False, cap)
    pos = idx.to(torch.int64) - base[sg.clamp(max=ncap - 1)]
    counts = _count(ctx, present)
    W = width_for(int(counts.max()) if ncap else 1)
    tgt = torch.where(inside & (pos < W), sg.clamp(max=ncap - 1) * W
                      + pos.clamp(0, W - 1), ncap * W)
    out = (sslot, tgt, counts.to(torch.int32), W)
    if not own_live:
        ctx.stash["implode"] = out
    return out


def _scatter_grid(vals: torch.Tensor, tgt: torch.Tensor, ncap: int, W: int
                  ) -> torch.Tensor:
    flat = vals.new_zeros(ncap * W + 1)
    flat[tgt] = vals
    return flat[:ncap * W].reshape(ncap, W)


def group_implode(v: Val, ctx: GroupContext, agg: str = "implode") -> Val:
    """Each group's rows, in row order, as one padded list row (polars'
    implicit implode: `agg(pl.col("x"))`), or their row indices
    (`agg_groups`). A List input is lifted one level (List(List)) and a
    Struct input imploded field by field (List(Struct))."""
    from ..batch import _reshape_leading
    from ..dtypes import List as ListT, Struct as StructT
    from ..expr.eval import val_to_column
    cap, ncap = ctx.cap, ctx.out_cap
    present = ctx.live if v.live is None else ctx.live & v.live.expand(cap)
    sslot, tgt, counts, W = _implode_layout(ctx, present, v.live is not None)
    nested = agg == "implode" and (v.lengths is not None or
                                   v.fields is not None)
    ev = None
    if v.validity is not None and (nested or v.live is not None):
        ev = _scatter_grid(v.validity.expand(cap)[sslot], tgt, ncap, W)
    if nested and isinstance(v.dtype, StructT):
        fields = {nm: group_implode(
            Val(f.dtype, f.data, f.validity, f.sdict, False, v.live,
                f.lengths, f.elem_valid, f.fields), ctx)
            for nm, f in v.fields.items()}
        return Val(ListT(v.dtype), None, None, None, False, lengths=counts,
                   elem_valid=ev, fields=fields)
    if nested:
        rows = _scatter_grid(sslot, tgt, ncap, W).reshape(-1)
        taken = val_to_column(v, cap).take(rows)
        taken.validity = None
        return Val(ListT(v.dtype), None, None, None, False, lengths=counts,
                   elem_valid=ev, fields={"item": _reshape_leading(
                       taken, ncap, W)})
    if agg == "agg_groups":
        return Val(ListT(UInt32), _scatter_grid(sslot, tgt, ncap, W), None,
                   None, False, lengths=counts)
    data2 = _scatter_grid(v.data.expand(cap)[sslot], tgt, ncap, W)
    if v.validity is not None:
        spart = present & v.validity.expand(cap)
        ev = _scatter_grid(spart[sslot], tgt, ncap, W)
    elif v.live is not None:
        ev = _scatter_grid(present[sslot], tgt, ncap, W)
    return Val(ListT(v.dtype), data2, None, v.sdict, False, lengths=counts,
               elem_valid=ev)


def _group_moment(agg: str, sx: torch.Tensor, dt, spart: torch.Tensor,
                  ctx: GroupContext, attrs: dict) -> Val:
    """Each group's skew or kurtosis from its central moments in f64, in
    two passes as the JAX package's CPU path: the group mean gathered back
    to the rows, then the sums of the deviations' powers."""
    xf = torch.where(spart, _to_f64(sx, dt), 0.0)
    s, n = ctx.sums([xf, spart.to(torch.float64)])
    m = s / n.clamp(min=1)
    d = torch.where(spart, xf - ctx.take(m), 0.0)
    d2 = d * d
    moments = ctx.sums([d2, d2 * d] if agg == "skew" else [d2, d2 * d2])
    m2, mk = (x / n.clamp(min=1) for x in moments)
    bias = attrs.get("bias", True)
    if agg == "skew":
        g = mk / m2.clamp(min=1e-300) ** 1.5
        if not bias:
            g = g * torch.sqrt(n * (n - 1)) / (n - 2).clamp(min=1)
        return Val(Float64, g, (n > (0 if bias else 2)) & (m2 > 0))
    g = mk / (m2 * m2).clamp(min=1e-300)
    if not bias:
        g = ((n + 1) * g - 3 * (n - 1)) * (n - 1) / \
            ((n - 2) * (n - 3)).clamp(min=1) + 3
    if attrs.get("fisher", True):
        g = g - 3.0
    return Val(Float64, g, (n > (0 if bias else 3)) & (m2 > 0))


def _group_bitwise(agg: str, sx: torch.Tensor, dt, spart: torch.Tensor,
                   ctx: GroupContext) -> Val:
    """Each group's AND, OR or XOR of its valid values, one bit at a
    time: OR and AND as the bit's segment max and min (kernel C on the
    dense tier), XOR as the parity of the bits' counts, 16 bits to one
    batched per-group sum (kernel A on the dense tier). Words of at most
    32 bits are shifted as int32."""
    if not (dt.is_integer or dt.is_bool):
        raise InvalidOperationError(f"{agg} on {dt!r}")
    nbits = 1 if dt.is_bool else dt.bit_width()
    x = sx.to(torch.int32 if nbits <= 32 else torch.int64)
    out = torch.zeros(ctx.out_cap, dtype=torch.int64, device=x.device)
    if agg == "bitwise_xor":
        # counts are exact in f32 below 2^24 rows
        fdt = torch.float32 if ctx.cap <= (1 << 24) else torch.float64
        live = spart.to(x.dtype)
        for b0 in range(0, nbits, _BIT_CHUNK):
            b1 = min(b0 + _BIT_CHUNK, nbits)
            shifts = torch.arange(b0, b1, dtype=x.dtype, device=x.device)
            bits = (x.unsqueeze(0) >> shifts.unsqueeze(1)) & live
            for b, cnt in zip(range(b0, b1), ctx.sums((bits & 1).to(fdt))):
                out = out | ((cnt.to(torch.int64) & 1) << b)
    else:
        is_or = agg == "bitwise_or"
        for b in range(nbits):
            bit = ((x >> b) & 1).to(torch.int32)
            r = ctx.extreme(bit, spart, is_or, 0 if is_or else 1)
            out = out | (r.to(torch.int64) << b)
    has = _count(ctx, spart) > 0
    if dt.is_bool:
        return Val(Boolean, out != 0, has)
    if nbits < 64 and dt.is_signed_integer:
        out = out - ((out >> (nbits - 1)) << nbits)
    return Val(dt, out.to(storage_torch_dtype(dt)), has)


def _signed_order(x: torch.Tensor, dt) -> torch.Tensor:
    """UInt64 is held in int64: flipping the sign bit makes signed order
    unsigned order (and flips it back); other types as they are."""
    return x ^ _I64_SIGN if repr(dt) == "UInt64" else x


def _sort_pairs(x: torch.Tensor, dt, gid: torch.Tensor, part: torch.Tensor,
                ncap: int, ids: bool = True):
    """The rows where `part` is set sorted by (group id, value code) into
    a prefix, as (ids, codes); the other rows follow with id `ncap`. The
    code is the value's orderable code (`keycode.encode_orderable`): a
    32-bit code packs with its id into one int64 for one `torch.sort`
    (`fused_sort.fused_sort_kv`); a 64-bit one goes to kernel F over (id,
    the code's two halves), padded to a power of two with rows that sort
    last, and the codes, and the ids unless `ids` is false (None then),
    are gathered by the permutation alone. Group g's values are then one
    ascending run, in group order."""
    n = gid.shape[0]
    gkey = torch.where(part, gid.to(torch.int64),
                       torch.full_like(gid, ncap, dtype=torch.int64))
    code = encode_orderable(x, dt)
    if code_bits(dt) == 32 and ncap < (1 << 31):
        return fused_sort_kv(gkey, code)
    words = [gkey, (code >> 32) & U32, code & U32]
    npad = 1 << (n - 1).bit_length()
    if npad != n:
        words = [torch.cat([w, w.new_full((npad - n,), U32)])
                 for w in words]
    perm = merge_sort_words(words, 3, perm_only=True)[0][:n]
    return gkey[perm] if ids else None, code[perm]


def quantile_of_groups(x: torch.Tensor, dt, part: torch.Tensor,
                       ctx: GroupContext, q: float, interp: str):
    """Per-group quantile of the rows of `x` where `part` is set, in f64,
    with the group's valid count: the JAX package's `_group_quantile`
    (every interpolation; nearest rounds half to even) over any tier's
    group ids. The value codes are sorted into runs (`_sort_pairs`),
    group g's run starts after the counts of the groups before it, and
    the picks are gathers from it, decoded."""
    ncap = ctx.out_cap
    n = _count(ctx, part)
    codes = _sort_pairs(x, dt, ctx.gid, part, ncap, ids=False)[1]
    base = torch.cumsum(n, 0) - n
    pos = q * (n.to(torch.float64) - 1)
    top = codes.shape[0] - 1

    def pick(i):
        at = (base + i.to(torch.int64).clamp(min=0)).clamp(0, top)
        return _to_f64(decode_orderable(codes[at], dt, False), dt)

    lo, hi = torch.floor(pos), torch.ceil(pos)
    if interp == "linear":
        frac = pos - lo
        val = pick(lo) * (1 - frac) + pick(hi) * frac
    elif interp == "lower":
        val = pick(lo)
    elif interp == "higher":
        val = pick(hi)
    elif interp == "midpoint":
        val = (pick(lo) + pick(hi)) / 2
    elif interp == "nearest":
        val = pick(torch.round(pos))
    else:
        raise ComputeError(f"unknown interpolation {interp!r}")
    return val, n


def _pair_boundaries(words) -> torch.Tensor:
    """Sorted rows that differ from the row before in any word."""
    new = torch.zeros(words[0].shape[0], dtype=torch.bool,
                      device=words[0].device)
    new[0] = True
    for w in words:
        new[1:] |= w[1:] != w[:-1]
    return new


def _group_n_unique(v: Val, ctx: GroupContext) -> Val:
    """Distinct values per group, null counting as one: a sort of (group
    id, value code) over the valid rows, the value boundaries inside each
    group's run counted as the difference of a prefix sum at the run's
    ends, plus one for a group that holds a null."""
    ncap = ctx.out_cap
    sx, spart, present = _part(v, ctx)
    g, c = _sort_pairs(sx, v.dtype, ctx.gid, spart, ncap)
    new = _pair_boundaries([g, c]) & (g < ncap)
    prefix = torch.cat([new.new_zeros(1, dtype=torch.int64),
                        torch.cumsum(new, 0)])
    m = _count(ctx, spart)
    base = torch.cumsum(m, 0) - m
    distinct = prefix[base + m] - prefix[base]
    if v.validity is not None:
        distinct = distinct + (_count(ctx, present & ~spart) > 0)
    return Val(UInt32, distinct)


def _group_arg_extreme(v: Val, ctx: GroupContext, is_max: bool) -> Val:
    """arg_min/arg_max: the position among the group's rows (counting
    nulls) of its first row holding the extreme valid value; null when
    the group has no valid value or its extreme is NaN (which equals no
    row), as in the JAX package."""
    cap = ctx.cap
    sx, spart, present = _part(v, ctx)
    x = _signed_order(sx, v.dtype)
    if x.dtype in (torch.bool, torch.int8, torch.uint8, torch.int16):
        x = x.to(torch.int32)
    lo, hi = _type_bounds(x.dtype)
    m = ctx.extreme(x, spart, is_max, lo if is_max else hi)
    hit = spart & (x == segment_take(m, ctx.gid))
    pos = ctx._positions()
    first = ctx.extreme(pos, hit, False, cap)
    before = present & (pos < segment_take(first, ctx.gid))
    has = first < cap
    return Val(UInt32, torch.where(has, _count(ctx, before), 0), has)


def _group_mode(v: Val, ctx: GroupContext) -> Val:
    """The most frequent valid value of each group, the smallest (keycode
    order) winning a tie, as the JAX package picks it: a sort of (group
    id, value code), run lengths from the run bounds, and per group the
    longest run's first start."""
    cap, ncap = ctx.cap, ctx.out_cap
    sx, spart, _ = _part(v, ctx)
    g, c = _sort_pairs(sx, v.dtype, ctx.gid, spart, ncap)
    new = _pair_boundaries([g, c]) & (g < ncap)
    j = torch.arange(cap, device=g.device)
    # a run ends where the next row starts a run or takes no part
    last = torch.cat([(new | (g >= ncap))[1:], new.new_ones(1)])
    end = torch.flip(torch.cummin(torch.flip(
        torch.where(last, j, cap), [0]), 0).values, [0])
    run = torch.where(new, end - j + 1, 0)
    gs = torch.where(new, g, ncap)
    best = segment_minmax(run, gs, ncap, True, 0)
    is_best = new & (run == segment_take(best, gs))
    at = segment_minmax(torch.where(is_best, j, cap), gs, ncap, False, cap)
    has = at < cap
    return Val(v.dtype, decode_orderable(c[at.clamp(max=cap - 1)], v.dtype,
                                         False), has, v.sdict)


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
    if k == "when_then":
        # the branches over per-group values, one result per group slot
        from ..expr.eval import _eval_when_then
        return _eval_when_then(
            e, table, "agg", evalf=lambda c: eval_group_expr(
                c, table, ctx, key_outputs), cap=ctx.out_cap)
    if k == "map_groups_udf":
        return _eval_map_groups_udf(e, table, ctx)
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
    if k == "fma":
        # the optimizer's fused multiply-add over per-group values (it
        # rewrites agg combinations such as corr(a, b) ** 2)
        a, b, c = (eval_group_expr(ch, table, ctx, key_outputs)
                   for ch in e.children)
        return _eval_fma(e.attrs["op"], a, b, c)
    if k == "unary":
        return _eval_unary(e.attrs["op"], eval_group_expr(
            e.children[0], table, ctx, key_outputs), e.attrs)
    if k in ("col", "expr_filter", "drop_nulls"):
        # a column, filtered or not, without a reduction: polars' implicit
        # implode
        return group_implode(eval_expr(e, table, "agg"), ctx)
    if k == "list":
        from ..expr.nested import eval_list
        v = eval_group_expr(e.children[0], table, ctx, key_outputs)
        return eval_list(e, v, Table([], {}, ctx.out_cap, ctx.out_cap, None,
                                     device=ctx.gid.device))
    raise InvalidOperationError(
        f"expression kind {k!r} not supported in group_by aggregation")


def _eval_map_groups_udf(e: Expr, table: Table, ctx: GroupContext) -> Val:
    """pl.map_groups(exprs, fn): the host function over each group's
    Series. The group ids and the input columns go to the host once, the
    results come back once, each at its group's slot."""
    from ..api.series import Series
    from ..expr.misc import _series_val, host_values
    fn = e.attrs["fn"]
    returns_scalar = e.attrs.get("returns_scalar", False)
    cols = [host_values(eval_expr(c, table, "agg"), table)[0]
            for c in e.children]
    gid = ctx.gid.cpu().numpy()
    live = ctx.live.cpu().numpy()
    rows = np.nonzero(live)[0]
    rows = rows[np.argsort(gid[rows], kind="stable")]
    slots, starts = np.unique(gid[rows], return_index=True)
    ncap = ctx.out_cap
    results = [None] * ncap
    filled = np.zeros(ncap, dtype=bool)
    for g, part in zip(slots, np.split(rows, starts[1:])):
        out = fn([Series("", [c[i] for i in part], device="cpu")
                  for c in cols])
        if isinstance(out, Series):
            out = out.to_list()
        if returns_scalar and isinstance(out, list):
            out = out[0] if out else None
        results[int(g)] = out
        filled[int(g)] = True
    v = _series_val(results, None, table.device)
    has = torch.from_numpy(filled).to(table.device)
    return Val(v.dtype, v.data, has if v.validity is None
               else v.validity & has, v.sdict, False, lengths=v.lengths,
               elem_valid=v.elem_valid, fields=v.fields)


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
            if colo is not None and not colo.is_nested and \
                    colo.data.shape[0] == cap:
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
    # `len` and a count without validity are each group's live rows: the
    # pass's count row (gid already routes dead rows outside every group)
    counted = [rk for rk, colo in reqs.items() if rk[0] == "len" or (
        rk[0] == "count" and colo.validity is None)]
    keys, rows = [], []
    for rk, colo in reqs.items():
        if rk in counted:
            continue
        if rk[0] == "count":
            rows.append(colo.validity.to(torch.float32))
        else:  # sum
            x = colo.data if colo.dtype.is_float \
                else _to_f64(colo.data, colo.dtype)
            if colo.validity is not None:
                x = torch.where(colo.validity, x, torch.zeros_like(x))
            rows.append(x)
        keys.append(rk)
    res = gctx.sums(rows, count=bool(counted))
    gctx.stash = dict.fromkeys(counted, res[0]) if counted else {}
    gctx.stash.update(zip(keys, res[1:] if counted else res))


def group_by_agg(table: Table, key_exprs: Sequence[Expr],
                 agg_exprs: Sequence[Expr],
                 maintain_order=False) -> Table:
    """GROUP BY keys AGG exprs -> one row per group. The dense and sorted
    tiers emit ascending key order (nulls first), the hash tier hash
    order; maintain_order=True gives the order of each group's first live
    row, and the optimizer's "key" sentinel (a sort on the keys after the
    group-by was dropped) ascending key order from every tier."""
    cap = table.capacity
    mask = table.row_mask()
    key_vals = [eval_expr(k, table, "select") for k in key_exprs]
    spans = _dense_spans(key_vals, key_exprs, table)
    domain = None if spans is None else _span_product(spans)
    if domain is None or domain > _HASH_DOMAIN:
        spans = None
        gctx = build_groups(key_vals, mask)
    elif domain <= DENSE_GROUPS:
        gctx = build_groups_dense(key_vals, mask, spans)
    else:
        gctx = build_groups_hash(key_vals, mask, spans)
    reqs = _collect_stash_requests(agg_exprs, table, cap)
    if len(reqs) > 1:
        _fill_stash(gctx, reqs)
    ocap = gctx.out_cap

    key_outputs = {}
    names: List[str] = []
    cols = {}
    gvalid_rows = gctx.group_count > 0
    if spans is None:
        # the sorted tier compacted each group's keys out of its first row
        keys = [(kv, data, validity) for kv, (data, validity)
                in zip(key_vals, gctx.keys)]
    else:
        # decode each slot's mixed-radix key code
        slot = gctx.slot_codes()
        key_decoded = []
        for span, _ in reversed(spans):
            key_decoded.append(slot % span)
            slot = slot // span
        key_decoded.reverse()
        keys = []
        for kv, kc, (span, base) in zip(key_vals, key_decoded, spans):
            data, kvalid = _dense_decode(kc, kv, span, base)
            keys.append((kv, data,
                         kvalid if kv.validity is not None else None))
    for ke, (kv, data, kvalid) in zip(key_exprs, keys):
        name = meta.output_name(ke)
        svalid = kvalid & gvalid_rows if kvalid is not None else None
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
        cols[name] = val_to_column(v, ocap)

    tmp = Table(names, cols, ocap, None, gvalid_rows, device=mask.device)
    order = gctx.group_start if maintain_order is True else \
        gctx.key_order() if maintain_order == "key" else None
    if order is not None:
        # a stable sort of the slots by each group's first row (or, for
        # "key", by its key code), in which the empty slots (first row
        # cap, key code 2^32) go last, so the groups come out as a prefix
        # (no host sync)
        perm = torch.sort(order, stable=True).indices
        out = gather_table(tmp, perm, None, None)
        return out.with_valid(None, None, nrows_dev=gvalid_rows.sum())
    if isinstance(gctx, HashGroupContext):
        # the hash and sorted tiers numbered their groups densely: they
        # already are a prefix (the compaction kernel removed the empty
        # slots when it gathered the group keys)
        return tmp.with_valid(None, None, nrows_dev=gctx.ngroups)
    # the dense layout leaves empty key slots: compact them away on the
    # device with the compaction kernel (no host sync)
    out, count = compact_device(tmp)
    return out.with_valid(None, None, nrows_dev=count)


# ---------------------------------------------------------------------------
# unique / distinct
# ---------------------------------------------------------------------------

def unique_table(table: Table, subset: Optional[Sequence[str]],
                 keep: str = "any", maintain_order: bool = False) -> Table:
    """DISTINCT through the sorted tier's row sort: one representative
    row per key group, as a row mask in the original order (so every
    `maintain_order` is met). The sort is stable, so a run's first
    sorted slot is the group's first row and its last the last row. The
    JAX package writes the mask back to row order by a 2-word sort; a
    scatter by the permutation is the same function. keep="any" takes
    the first row."""
    names = subset or list(table.names)
    mask = table.row_mask()
    key_vals = [column_to_val(table.column(n)) for n in names]
    perm, live_sorted, _, newgrp = _sort_rows(key_vals, mask)
    if keep not in ("any", "first", "last", "none"):
        raise ComputeError(f"invalid keep strategy {keep!r}")
    if keep in ("any", "first"):
        is_rep = newgrp
    else:
        # a run ends where the next sorted slot starts a run or is dead
        run_end = torch.cat([(newgrp | ~live_sorted)[1:],
                             newgrp.new_ones(1)]) & live_sorted
        is_rep = run_end if keep == "last" else run_end & newgrp
    sel = torch.empty_like(mask)
    sel.scatter_(0, perm, is_rep)
    return table.with_valid(sel & mask, None)
