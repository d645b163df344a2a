"""Joins: dense, collocated and sort-merge equi-joins, and the cross join.

The port of the JAX package's `ops/join.py`. Both sides' key columns are
cast to a common supertype (string columns recoded onto one merged
dictionary), and the join takes the first route that fits, as the JAX
package picks them on an accelerator (`join.py:144-202`):

* dense (`_dense_join`): inner, left, semi and anti joins whose key
  domains are statically small (dictionary strings, booleans, 8/16-bit
  ints, and wider ints by their bucketed min/max) give each row a
  mixed-radix key code with no sort. A right side with at most one row
  per code gives an output aligned with the left rows (one gather per
  right column); otherwise one readback sizes the expansion.
* collocated (`ops/hjoin.py`): an inner or left join on one key of at
  most 31 bits over a large domain, through the hash exchange (kernel
  E). Its `ok` is read once; False (a wide key, a full exchange cell, a
  duplicate right key) falls through to the next route.
* sort-merge (`_merged_sort_stats`): both sides' (dead, key words, side
  tag) sorted at once by kernel F (`keycode.lex_sort_indices`), with the
  side row riding as a tail word; every key's rows are then one run, left
  rows first. One readback of (largest right run, output size, unmatched
  null-key rows) picks the m:1 route (`_m1_join_fast`: the output is
  aligned with the left rows) or the expansion of every kind.

The JAX package takes the collocated route only off the CPU
(`join.py:166`); the port takes it on every device, so the CPU tests run
the routes the card runs. Unlike the JAX package, the port memoises no
readback by the identity of its input arrays (`_CJ_OK_MEMO`,
`_DENSE_DECISION_MEMO`): a tensor can change in place under one
identity, and on the card a readback costs microseconds. Its integer-key
stats remember the live rows they were taken over (see
`_int_key_stats`).

Where the JAX package sorts with `merge_sort_words` (its merged sort and
its sort-as-scatter writebacks), the port launches kernel F; the m:1
route sorts the writeback key with the hit flag and the build row (not
every right payload word, which could pass F's 32 words) and gathers the
right columns by that row. Plain `lax.sort`/`argsort` calls stay torch
sorts.

`ROUTES` counts the joins that took each route.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence

import torch

from ..batch import Column, Table
from ..config import capacity_for
from ..dtypes import supertype
from ..errors import ComputeError, SchemaError
from ..expr.eval import Val, _align_strings, cast_val
from . import compact as C
from .keycode import U32, encode_key_words, lex_sort_indices
from .merge_sort import sort_ops
from .segment import SPILL, segment_sum_int, spill_slots

__all__ = ["join_tables", "cross_join", "lookup_join_sorted", "ROUTES"]

# route name -> joins that took it (reset by callers that count them)
ROUTES: collections.Counter = collections.Counter()
_STAT_BUCKET = 1024
# the collocated route needs this many rows, and a larger key span than
# the dense route's lookup handles best
_COLLOCATE_ROWS = 1 << 15
_COLLOCATE_SPAN = 1 << 16


def _key_vals(t: Table, names: Sequence[str]) -> List[Val]:
    out = []
    for n in names:
        c = t.column(n)
        out.append(Val(c.dtype, c.data, c.validity, c.sdict, False))
    return out


def _unify_keys(lv: List[Val], rv: List[Val]):
    """Cast both sides' keys to common supertypes; merge string dicts."""
    lo, ro = [], []
    for a, b in zip(lv, rv):
        if a.dtype.is_string or b.dtype.is_string:
            if not (a.dtype.is_string and b.dtype.is_string):
                raise SchemaError(
                    f"join key dtype mismatch: {a.dtype!r} vs {b.dtype!r}")
            a, b = _align_strings(a, b)
        else:
            st = supertype(a.dtype, b.dtype)
            a, b = cast_val(a, st), cast_val(b, st)
        lo.append(a)
        ro.append(b)
    return lo, ro


def minmax_masked(data: torch.Tensor, mask: torch.Tensor):
    """(min, max) of the rows in `mask` in one readback; (0, 0) if
    none."""
    x = data.to(torch.int64)
    big = torch.iinfo(torch.int64)
    packed = torch.stack([
        torch.where(mask, x, torch.full_like(x, big.max)).min(),
        torch.where(mask, x, torch.full_like(x, big.min)).max()])
    mn, mx = (int(v) for v in packed.tolist())
    return (0, 0) if mx < mn else (mn, mx)


def _bucketed(mn: int, mx: int) -> dict:
    B = _STAT_BUCKET
    return {"min": (mn // B) * B, "max": ((mx // B) + 1) * B - 1}


def _int_key_stats(tbl: Table, name: Optional[str], v: Val) -> tuple:
    """Bucketed (min, max) of an integer join key over the table's live
    rows (the reference's Sample phase analogue, `equi_join.rs:250`): one
    readback, cached on the Column with the live rows it was taken over
    (`Table.live_key`), as the executor caches the group-by's stats. The
    JAX package reuses them for any rows (`join.py:436-453`), so a join
    of a filtered frame leaves bounds that clip the unfiltered frame's
    keys."""
    c = tbl.cols.get(name) if name is not None else None
    live = tbl.live_key()
    if c is not None and v.data is c.data:
        st = c.stats
        if st is not None and _same_live(st.get("over"), live):
            return st["min"], st["max"]
        _ensure_col_stats(tbl, name)
        return c.stats["min"], c.stats["max"]
    mask = tbl.row_mask()
    if v.validity is not None:
        mask = mask & v.validity.expand(tbl.capacity)
    st = _bucketed(*minmax_masked(v.data.expand(tbl.capacity), mask))
    return st["min"], st["max"]


def _same_live(over, live) -> bool:
    return over is live or (type(over) is int and type(live) is int
                            and over == live)


def _ensure_col_stats(tbl: Table, name: str) -> None:
    """Cache the bucketed min/max of a flat integer column over the
    table's live rows (one readback), unless it holds bounds for those
    rows already."""
    c = tbl.cols[name]
    live = tbl.live_key()
    if not c.dtype.is_integer or (c.stats is not None and
                                  _same_live(c.stats.get("over"), live)):
        return
    mask = tbl.row_mask()
    if c.validity is not None:
        mask = mask & c.validity
    c.stats = dict(_bucketed(*minmax_masked(c.data, mask)), over=live)


def _propagate_join_stats(out: Table, sources: dict) -> None:
    """Live output values are a subset of their source column's live
    values, so the source's bounds bound the output column too: cached
    on the source and copied to the output (for the output's live rows),
    they spare a downstream group-by its stats readback. `sources` maps
    an output column to its (table, column); a column merged from both
    sides (a coalesced full-join key) has none."""
    live = out.live_key()
    for n, (src_t, src_n) in sources.items():
        c = out.cols[n]
        if c.dtype != src_t.cols[src_n].dtype:
            continue
        _ensure_col_stats(src_t, src_n)
        st = src_t.cols[src_n].stats
        if st is not None:
            # a new Column: the m:1 routes share the left Column objects
            out.cols[n] = Column(c.dtype, c.data, c.validity, c.sdict,
                                 dict(st, over=live))


def _right_columns(left: Table, right: Table, right_on, coalesce: bool,
                   suffix: str, sources: dict):
    """(right column, output name) of the m:1 routes, whose output is the
    left table plus the right columns (a coalesced key left out); the
    sources of every output column go into `sources`."""
    sources.update((n, (left, n)) for n in left.names)
    lnames = set(left.names)
    out = []
    for n in right.names:
        if coalesce and n in right_on:
            continue
        name = f"{n}{suffix}" if n in lnames else n
        sources[name] = (right, n)
        out.append((n, name))
    return out


def join_tables(left: Table, right: Table, left_on: Sequence[str],
                right_on: Sequence[str], how: str, suffix: str = "_right",
                join_nulls: bool = False, coalesce: Optional[bool] = None,
                maintain_order: Optional[str] = None,
                validate: str = "m:m") -> Table:
    if how == "cross":
        return cross_join(left, right, suffix)
    if how == "outer":
        how = "full"
    if how not in ("inner", "left", "right", "full", "semi", "anti"):
        raise ComputeError(f"unknown join type {how!r}")
    if coalesce is None:
        coalesce = how != "full"
    if len(left_on) != len(right_on):
        raise ComputeError("left_on and right_on lengths differ")

    lv, rv = _unify_keys(_key_vals(left, left_on), _key_vals(right, right_on))
    lmask = left.row_mask()
    rmask = right.row_mask()
    if validate and validate not in ("m:m", "many_to_many"):
        _validate(validate, lv, rv, lmask, rmask)
    if not join_nulls:
        for v in lv:
            if v.validity is not None:
                lmask = lmask & v.validity
        for v in rv:
            if v.validity is not None:
                rmask = rmask & v.validity
    capL, capR = left.capacity, right.capacity

    spans = None
    if how in ("inner", "left", "semi", "anti") and not join_nulls:
        spans = _dense_join_spans(lv, rv, left, right, left_on, right_on)
    span_prod = _span_product(spans) if spans is not None else 0
    if (how in ("inner", "left") and not join_nulls
            and maintain_order in (None, "none")
            and capL + capR >= _COLLOCATE_ROWS
            and (spans is None or span_prod > _COLLOCATE_SPAN)):
        from .hjoin import collocated_join
        res = collocated_join(left, right, left_on, right_on, how, suffix,
                              coalesce, lv, rv, lmask, rmask)
        if res is not None and bool(res[1]):   # the one readback
            ROUTES["collocated"] += 1
            return res[0]
    if spans is not None:
        return _dense_join(left, right, left_on, right_on, how, suffix,
                           coalesce, lv, rv, lmask, rmask, spans)
    return _sort_merge_join(left, right, left_on, right_on, how, suffix,
                            coalesce, lv, rv, lmask, rmask, join_nulls)


def _validate(validate: str, lv, rv, lmask, rmask) -> None:
    """Uniqueness checks (opt-in; one readback per checked side),
    through the sorted tier's group layout (`groupby.build_groups`)."""
    from .groupby import build_groups

    def unique(vals, mask) -> bool:
        g = build_groups(vals, mask)
        return bool(g.ngroups == mask.sum())

    if validate in ("1:1", "one_to_one", "1:m", "one_to_many") and \
            not unique(lv, lmask):
        raise ComputeError(f"join keys did not fulfill {validate} "
                           "validation: left keys are not unique")
    if validate in ("1:1", "one_to_one", "m:1", "many_to_one") and \
            not unique(rv, rmask):
        raise ComputeError(f"join keys did not fulfill {validate} "
                           "validation: right keys are not unique")


# ---------------------------------------------------------------------------
# dense routes
# ---------------------------------------------------------------------------

def _span_product(spans) -> int:
    prod = 1
    for s, _ in spans:
        prod *= s
    return prod


def _dense_join_spans(lv, rv, left: Table, right: Table, left_on,
                      right_on):
    """Per-key (span, base) when both sides' domains are small: shared
    string dictionaries, booleans, 8/16-bit ints, and wider ints by their
    bucketed stats. None when a key is unbounded or the span product
    passes max(4 * (capL + capR), 2^21)."""
    spans = []
    for ki, (a, b) in enumerate(zip(lv, rv)):
        dt = a.dtype
        if dt.is_string:
            # after _align_strings both share one dict
            spans.append((len(a.sdict or []) + 1, None))
        elif repr(dt) == "Boolean":
            spans.append((3, None))
        elif dt.is_integer:
            bits = dt.bit_width()
            if bits <= 16:
                base = -(1 << (bits - 1)) if dt.is_signed_integer else 0
                spans.append(((1 << bits) + 1, base))
            else:
                lmn, lmx = _int_key_stats(left, left_on[ki], a)
                rmn, rmx = _int_key_stats(right, right_on[ki], b)
                mn, mx = min(lmn, rmn), max(lmx, rmx)
                spans.append((mx - mn + 2, mn))
        else:
            return None
    if _span_product(spans) > max(4 * (left.capacity + right.capacity),
                                  1 << 21):
        return None
    return spans


def _dense_codes(vals, mask, cap: int, spans, prod: int) -> torch.Tensor:
    """Mixed-radix dense key code per row (int64); dead rows get the dump
    code `prod`."""
    code = torch.zeros(cap, dtype=torch.int64, device=mask.device)
    for v, (span, base) in zip(vals, spans):
        data = v.data.expand(cap)
        if v.dtype.is_string or repr(v.dtype) == "Boolean":
            c = data.to(torch.int64) + 1
        else:
            c = data.to(torch.int64) - (base or 0) + 1
        code = code * span + c.clamp(0, span - 1)
    return torch.where(mask, code, torch.full_like(code, prod))


def _expand_rows(m: torch.Tensor, moff: torch.Tensor,
                 capO: int) -> torch.Tensor:
    """Map output slot k -> the row that emits it, given per-row emission
    counts `m` and their inclusive cumsum `moff`: each emitting row marks
    its first output slot (the starts of rows with m > 0 are unique and
    increasing), a prefix sum gives each slot the ordinal of its row, and
    the emitting rows in order (one scatter) map ordinals to rows. The
    JAX package scatters the rows and forward-fills them with a cummax;
    a 1-D `torch.cummax` of 2^24 int64 took 49 ms on the card (H2O
    q5_full), the prefix sum a pass at memory speed."""
    n = m.shape[0]
    dev = m.device
    emit = m > 0
    first = torch.zeros(capO + SPILL, dtype=torch.int64, device=dev)
    first.scatter_(0, torch.where(emit, moff - m, spill_slots(n, capO, dev)),
                   torch.ones_like(m))
    ordinal = torch.cumsum(first[:capO], 0) - 1
    rows = torch.zeros(n + SPILL, dtype=torch.int64, device=dev)
    rows.scatter_(0, torch.where(emit, torch.cumsum(emit, 0) - 1,
                                 spill_slots(n, n, dev)),
                  torch.arange(n, device=dev))
    return rows[ordinal.clamp(min=0)]


def _dense_join(left, right, left_on, right_on, how, suffix, coalesce,
                lv, rv, lmask, rmask, spans) -> Table:
    """Direct-indexed join over a small dense key domain: counts of right
    rows per code, then ONE readback of (output size, largest right
    run); the m:1 route or the expansion follows."""
    capL, capR = left.capacity, right.capacity
    prod = _span_product(spans)
    code_l = _dense_codes(lv, lmask, capL, spans, prod)
    code_r = _dense_codes(rv, rmask, capR, spans, prod)
    counts = segment_sum_int(torch.ones_like(code_r), code_r, prod)
    cnt_p = torch.where(lmask, counts[code_l.clamp(0, prod - 1)],
                        torch.zeros_like(code_l))
    row_live = left.row_mask()
    if how in ("semi", "anti"):
        ROUTES["dense_semi_anti"] += 1
        sel = lmask & (cnt_p > 0)
        if how == "anti":
            sel = row_live & ~sel
        return left.with_valid(sel & row_live, None)
    m = cnt_p if how == "inner" else \
        torch.where(row_live, cnt_p.clamp(min=1), torch.zeros_like(cnt_p))
    total, mcr = (int(x) for x in
                  torch.stack([m.sum(), counts.max()]).tolist())
    if mcr <= 1:
        ROUTES["dense_m1"] += 1
        return _dense_m1_join(left, right, right_on, how, suffix, coalesce,
                              code_l, code_r, cnt_p, lmask, prod)
    ROUTES["dense_expand"] += 1
    capO = capacity_for(max(total, 1))
    offsets = torch.cumsum(counts, 0) - counts   # exclusive per code
    rsorted = torch.sort(code_r, stable=True).indices  # dump sorts last
    moff = torch.cumsum(m, 0)
    k = torch.arange(capO, dtype=torch.int64, device=m.device)
    p = _expand_rows(m, moff, capO).clamp(0, capL - 1)
    j = k - (moff[p] - m[p])
    slot = offsets[code_l[p].clamp(0, prod - 1)] + j
    ridx = rsorted[slot.clamp(0, capR - 1)]
    lmatch = k < total
    rmatch = lmatch & (cnt_p[p] > 0)
    return _assemble_join_output(left, right, left_on, right_on, how,
                                 suffix, coalesce, p, ridx, lmatch, rmatch,
                                 total, capO)


def _dense_m1_join(left: Table, right: Table, right_on, how: str,
                   suffix: str, coalesce: bool, code_l, code_r, cnt_p,
                   lmask, prod: int) -> Table:
    """Dense-domain join when every key has at most one right row: the
    output is the left table (its columns untouched), with each right
    column gathered through a code -> right row table, unmatched rows
    masked out (inner) or given null right columns (left). Reference
    analogue: the unique-build-side probe of
    `polars-ops/src/frame/join/hash_join/single_keys_inner.rs`."""
    capL, capR = left.capacity, right.capacity
    rmatch = lmask & (cnt_p > 0)
    out_valid = rmatch if how == "inner" else left.row_mask()
    ridx = torch.zeros(prod + SPILL, dtype=torch.int64, device=lmask.device)
    ridx.scatter_(0, torch.where(code_r < prod, code_r,
                                 spill_slots(capR, prod, code_r.device)),
                  torch.arange(capR, device=code_r.device))
    gidx = ridx[code_l.clamp(0, prod - 1)]
    names, cols, sources = list(left.names), dict(left.cols), {}
    for n, name in _right_columns(left, right, right_on, coalesce, suffix,
                                  sources):
        gc = right.cols[n].take(gidx)
        validity = rmatch if gc.validity is None else gc.validity & rmatch
        names.append(name)
        cols[name] = Column(gc.dtype, gc.data, validity, gc.sdict)
    out = Table(names, cols, capL, None, out_valid, device=left.device)
    _propagate_join_stats(out, sources)
    return out


def _assemble_join_output(left, right, left_on, right_on, how, suffix,
                          coalesce, lidx, ridx, lmatch, rmatch, total, capO):
    """The expansion's output: every column gathered by its side's row
    index, with the join stats of its source."""
    names: List[str] = []
    cols = {}
    sources = {}
    lkeys = set(left_on) if coalesce else set()
    rkeys = set(right_on) if coalesce else set()

    def add_side(t: Table, sidx, match, skip: set, is_left: bool):
        for n in t.names:
            if n in skip:
                continue
            gc = t.cols[n].take(sidx)
            validity = gc.validity
            if (how in ("full", "right") and is_left) or \
                    (how in ("full", "left") and not is_left):
                validity = match if validity is None else validity & match
            name = n
            if name in cols:
                name = f"{n}{suffix}"
                if name in cols:
                    raise ComputeError(f"duplicate output column {name!r}")
            names.append(name)
            cols[name] = Column(gc.dtype, gc.data, validity, gc.sdict)
            sources[name] = (t, n)

    if how == "right":
        add_side(left, lidx, lmatch, lkeys, True)
        add_side(right, ridx, rmatch, set(), False)
    else:
        add_side(left, lidx, lmatch, set(), True)
        add_side(right, ridx, rmatch, rkeys, False)

    if how == "full" and coalesce:
        # merge key columns: take left when matched else right
        for ln, rn in zip(left_on, right_on):
            lc = left.cols[ln]
            rc = right.cols[rn]
            a = Val(lc.dtype, lc.data[lidx],
                    None if lc.validity is None else lc.validity[lidx],
                    lc.sdict, False)
            b = Val(rc.dtype, rc.data[ridx],
                    None if rc.validity is None else rc.validity[ridx],
                    rc.sdict, False)
            if a.dtype.is_string:
                a, b = _align_strings(a, b)
            else:
                st = supertype(a.dtype, b.dtype)
                a, b = cast_val(a, st), cast_val(b, st)
            data = torch.where(lmatch, a.data, b.data)
            av = lmatch if a.validity is None else lmatch & a.validity
            bv = rmatch if b.validity is None else rmatch & b.validity
            cols[ln] = Column(a.dtype, data, torch.where(lmatch, av, bv),
                              a.sdict)
            sources.pop(ln, None)
            rname = f"{rn}{suffix}" if rn in cols or rn == ln else rn
            names[:] = [n for n in names if n != rname]
            cols.pop(rname, None)
            sources.pop(rname, None)

    out = Table(names, cols, capO, total, None, device=lidx.device)
    _propagate_join_stats(out, sources)
    return out


# ---------------------------------------------------------------------------
# sort-merge routes
# ---------------------------------------------------------------------------

def _merged_sort_stats(words: List[torch.Tensor], side_idx: torch.Tensor):
    """The merged lexicographic sort by (dead, key words, tag) on kernel
    F, the side row riding as a tail word, and the run statistics of the
    sorted layout: (s_sideidx, s_tag, live_sorted, gid, cl, cr,
    group_start, perm). A length that is not a power of two is padded
    with all-ones words, which sort after every row."""
    n = side_idx.shape[0]
    capT = 1 << max(n - 1, 0).bit_length()
    if capT != n:
        words = [torch.cat([w, w.new_full((capT - n,), U32)])
                 for w in words]
        side_idx = torch.cat([side_idx, side_idx.new_zeros(capT - n)])
    skeys, tails, perm = lex_sort_indices(words, (side_idx,))
    s_sideidx = tails[0]
    s_tag = skeys[-1]
    live_sorted = skeys[0] == 0
    newgrp = torch.zeros(capT, dtype=torch.bool, device=perm.device)
    newgrp[0] = True
    for w in skeys[1:-1]:
        newgrp[1:] |= w[1:] != w[:-1]
    newgrp &= live_sorted
    gid = torch.where(live_sorted, torch.cumsum(newgrp, 0) - 1,
                      torch.full_like(perm, capT))
    cl = segment_sum_int((live_sorted & (s_tag == 0)).to(torch.int64), gid,
                         capT)
    cr = segment_sum_int((live_sorted & (s_tag == 1)).to(torch.int64), gid,
                         capT)
    idx = torch.arange(capT, device=perm.device)
    group_start = torch.full((capT + SPILL,), capT, dtype=torch.int64,
                             device=perm.device)
    group_start.scatter_(0, torch.where(newgrp, gid,
                                        spill_slots(capT, capT, idx.device)),
                         idx)
    return (s_sideidx, s_tag, live_sorted, gid, cl, cr, group_start[:capT],
            perm)


def _writeback(s_tag, s_sideidx, capL: int, payloads: List[torch.Tensor]):
    """Sorted-layout values back to left-row order by a sort (kernel F,
    `sort_ops`), as the JAX package does: every left slot sorts by its
    row, every other slot after them. Returns the payloads' first capL
    rows."""
    wb = torch.where(s_tag == 0, s_sideidx,
                     torch.full_like(s_sideidx, capL)).to(torch.int32)
    outs = sort_ops([wb] + payloads, 1, is_stable=False)
    return [o[:capL] for o in outs[1:]]


def _sort_merge_join(left, right, left_on, right_on, how, suffix, coalesce,
                     lv, rv, lmask, rmask, join_nulls) -> Table:
    capL, capR = left.capacity, right.capacity

    def side_words(vals, cap):
        ws = []
        for v in vals:
            validity = None
            if join_nulls and v.validity is not None:
                validity = v.validity.expand(cap)
            ws.append(encode_key_words(v.data.expand(cap), v.dtype,
                                       validity, False, False))
        return ws

    lws = side_words(lv, capL)
    rws = side_words(rv, capR)
    for i in range(len(lws)):
        # nullability differs between sides under join_nulls: pad a null
        # word (1: valid) on the side that has none
        if len(lws[i]) < len(rws[i]):
            lws[i] = [torch.ones_like(lws[i][0])] + lws[i]
        elif len(rws[i]) < len(lws[i]):
            rws[i] = [torch.ones_like(rws[i][0])] + rws[i]
    dev = lmask.device
    dead = torch.cat([(~lmask).to(torch.int64), (~rmask).to(torch.int64)])
    keywords = [torch.cat([lw, rw]) for li, ri in zip(lws, rws)
                for lw, rw in zip(li, ri)]
    tag = torch.cat([torch.zeros(capL, dtype=torch.int64, device=dev),
                     torch.ones(capR, dtype=torch.int64, device=dev)])
    side_idx = torch.cat([torch.arange(capL, device=dev),
                          torch.arange(capR, device=dev)])
    (s_sideidx, s_tag, live_sorted, gid, cl, cr, group_start,
     perm) = _merged_sort_stats([dead] + keywords + [tag], side_idx)
    capT = perm.shape[0]

    if how in ("semi", "anti"):
        ROUTES["sortmerge_semi_anti"] += 1
        flag = (cr > 0)[gid.clamp(0, capT - 1)]
        want = flag if how == "semi" else ~flag
        lsel = want & live_sorted & (s_tag == 0)
        (sel,) = _writeback(s_tag, s_sideidx, capL, [lsel])
        row_mask = left.row_mask()
        if how == "anti" and not join_nulls:
            # anti keeps the left rows whose null keys take no part
            sel = sel | (row_mask & ~lmask)
        return left.with_valid(sel & row_mask, None)

    # the count phase: ONE readback of (largest right run, matched rows,
    # unmatched null-key rows of each side)
    cr1 = cr.clamp(min=1)
    cl1 = cl.clamp(min=1)
    if how == "inner":
        m = cl * cr
    elif how == "left":
        m = cl * cr1
    elif how == "right":
        m = cl1 * cr
    else:
        m = cl * cr1 + torch.where(cl == 0, cr, torch.zeros_like(cr))
    lnull = left.row_mask() & ~lmask
    rnull = right.row_mask() & ~rmask
    zero = m.new_zeros(())
    eL = lnull.sum() if how in ("left", "full") and not join_nulls else zero
    eR = rnull.sum() if how in ("right", "full") and not join_nulls else zero
    mcr, mtotal, extraL, extraR = (int(x) for x in torch.stack(
        [cr.max(), m.sum(), eL, eR]).tolist())
    total = mtotal + extraL + extraR

    if how in ("inner", "left") and mcr <= 1:
        ROUTES["sortmerge_m1"] += 1
        return _m1_join_fast(left, right, right_on, how, suffix, coalesce,
                             gid, live_sorted, s_tag, s_sideidx)

    ROUTES["sortmerge_expand"] += 1
    capO = capacity_for(max(total, 1))
    offsets = torch.cumsum(m, 0)
    k = torch.arange(capO, dtype=torch.int64, device=dev)
    g = _expand_rows(m, offsets, capO).clamp(0, capT - 1)
    r = k - (offsets[g] - m[g])
    cl_g, cr_g = cl[g], cr[g]
    cr1_g, cl1_g = cr1[g], cl1[g]
    gs = group_start[g]
    true = torch.ones(capO, dtype=torch.bool, device=dev)
    if how == "inner":
        i, j = r // cr_g.clamp(min=1), r % cr_g.clamp(min=1)
        lmatch, rmatch = true, true
    elif how == "left":
        i, j = r // cr1_g, r % cr1_g
        lmatch, rmatch = true, cr_g > 0
    elif how == "right":
        j, i = r // cl1_g, r % cl1_g
        rmatch, lmatch = true, cl_g > 0
    else:  # full
        main = cl_g * cr1_g
        in_main = r < main
        i = torch.where(in_main, r // cr1_g, torch.zeros_like(r))
        j = torch.where(in_main, r % cr1_g, r - main)
        lmatch = in_main & (cl_g > 0)
        rmatch = torch.where(in_main, cr_g > 0, true)
    valid_out = k < mtotal
    lslot = (gs + i).clamp(0, capT - 1)
    rslot = (gs + cl_g + j).clamp(0, capT - 1)
    lidx = s_sideidx[lslot].clamp(0, capL - 1)
    ridx = s_sideidx[rslot].clamp(0, capR - 1)
    lmatch = lmatch & valid_out
    rmatch = rmatch & valid_out

    # append the unmatched null-key rows (host-known counts)
    pos = k - mtotal
    if extraL:
        nl_perm = torch.sort((~lnull).to(torch.int8), stable=True).indices
        sel = (pos >= 0) & (pos < extraL)
        lidx = torch.where(sel, nl_perm[pos.clamp(0, capL - 1)], lidx)
        lmatch = lmatch | sel
    if extraR:
        nr_perm = torch.sort((~rnull).to(torch.int8), stable=True).indices
        pos2 = pos - extraL
        sel2 = (pos2 >= 0) & (pos2 < extraR)
        ridx = torch.where(sel2, nr_perm[pos2.clamp(0, capR - 1)], ridx)
        rmatch = rmatch | sel2
    return _assemble_join_output(left, right, left_on, right_on, how,
                                 suffix, coalesce, lidx, ridx, lmatch,
                                 rmatch, total, capO)


def _m1_join_fast(left: Table, right: Table, right_on, how: str,
                  suffix: str, coalesce: bool, gid, live_sorted, s_tag,
                  s_sideidx) -> Table:
    """Inner/left join when each key run holds at most one right row: the
    output is the left table (original order), the right columns
    gathered by each left row's build row.
      1. one scatter by run id gives each run its right row (unique: at
         most one per run), and each left slot reads its run's;
      2. one writeback sort by left row (kernel F) takes (hit, build
         row) back to left-row order;
      3. one gather per right column.
    The JAX package sorts every right payload word into place and fills
    it with a cummax instead (`_m1_fill`)."""
    capL, capR = left.capacity, right.capacity
    capT = gid.shape[0]
    dev = gid.device
    isr = live_sorted & (s_tag == 1)
    rrow = torch.full((capT + SPILL,), -1, dtype=torch.int64, device=dev)
    rrow.scatter_(0, torch.where(isr, gid, spill_slots(capT, capT, dev)),
                  s_sideidx)
    build = rrow[gid.clamp(0, capT - 1)]
    hit_sorted = live_sorted & (s_tag == 0) & (build >= 0)
    hit, brow = _writeback(s_tag, s_sideidx, capL,
                           [hit_sorted, build.clamp(0, capR - 1)
                            .to(torch.int32)])
    brow = brow.to(torch.int64)
    names, cols, sources = list(left.names), dict(left.cols), {}
    for n, name in _right_columns(left, right, right_on, coalesce, suffix,
                                  sources):
        gc = right.cols[n].take(brow)
        validity = hit if gc.validity is None else gc.validity & hit
        names.append(name)
        cols[name] = Column(gc.dtype, gc.data, validity, gc.sdict)
    out_valid = left.row_mask()
    if how == "inner":
        out_valid = out_valid & hit
    out = Table(names, cols, capL, None, out_valid, device=left.device)
    _propagate_join_stats(out, sources)
    return out


def cross_join(left: Table, right: Table, suffix: str = "_right") -> Table:
    """Every (left, right) pair, left-major: both sides compacted (kernel
    B), their row counts read, and one gather per column."""
    ROUTES["cross"] += 1
    L = C.compact(left)
    R = C.compact(right)
    nl, nr = L.nrows or 0, R.nrows or 0
    total = nl * nr
    capO = capacity_for(max(total, 1))
    k = torch.arange(capO, dtype=torch.int64, device=left.device)
    i = (k // max(nr, 1)).clamp(0, max(L.capacity - 1, 0))
    j = (k % max(nr, 1)).clamp(0, max(R.capacity - 1, 0))
    names, cols = [], {}
    for n in L.names:
        names.append(n)
        cols[n] = L.cols[n].take(i)
    for n in R.names:
        name = n if n not in cols else f"{n}{suffix}"
        names.append(name)
        cols[name] = R.cols[n].take(j)
    return Table(names, cols, capO, total, None, device=left.device)


def lookup_join_sorted(bkey: torch.Tensor, bval: torch.Tensor,
                       pkey: torch.Tensor, key_dtype=None):
    """Inner-join value lookup against a unique-key build side, in sorts
    and one cumulative max: returns (value float32, hit) aligned with
    pkey. Both sides sort at once by (key words, side tag) on kernel F,
    so each key run holds its build row first; one cummax over (run id
    << 32 | the build value's bits), packed at the build rows, carries
    each run's build value to its probe rows (the JAX package takes a
    segmented doubling max, the same function for unique build keys);
    and a writeback sort by probe index (kernel F) aligns the result.
    `key_dtype` names the keys' logical dtype where their storage does
    not (UInt32 lives in int64)."""
    from ..dtypes import dtype_from_numpy
    from .keycode import code_bits, encode_orderable
    nb, npr = bkey.shape[0], pkey.shape[0]
    tot = nb + npr
    dev = bkey.device
    dt = key_dtype or dtype_from_numpy(
        torch.empty(0, dtype=bkey.dtype).numpy().dtype)
    k = encode_orderable(torch.cat([bkey, pkey]), dt)
    kwords = [(k >> 32) & U32, k & U32] if code_bits(dt) == 64 else [k]
    tag = torch.cat([torch.zeros(nb, dtype=torch.int64, device=dev),
                     torch.ones(npr, dtype=torch.int64, device=dev)])
    vbits = torch.cat([bval.to(torch.float32).view(torch.int32)
                       .to(torch.int64) & U32,
                       torch.zeros(npr, dtype=torch.int64, device=dev)])
    idx = torch.cat([torch.full((nb,), tot, dtype=torch.int64, device=dev),
                     torch.arange(npr, device=dev)])
    nk = len(kwords)
    n2 = 1 << max(tot - 1, 0).bit_length()
    # pads sort after every row (all-ones keys) and write back last
    words = [torch.cat([w, w.new_full((n2 - tot,), fill)]) for w, fill in
             zip(kwords + [tag, vbits, idx], [U32] * (nk + 1) + [0, tot])]
    from .merge_sort import merge_sort_words
    out = merge_sort_words(words, nk + 1, stable=False)
    skw, st, sv, si = out[:nk], out[nk], out[nk + 1], out[nk + 2]
    isb = st == 0
    newk = torch.zeros(n2, dtype=torch.bool, device=dev)
    newk[0] = True
    for w in skw:
        newk[1:] |= w[1:] != w[:-1]
    rid = torch.cumsum(newk, 0)
    gm = torch.cummax(torch.where(isb, (rid << 32) | sv,
                                  torch.zeros_like(sv)), 0).values
    hit = ((gm >> 32) == rid) & (st == 1)
    outv = torch.where(hit, gm & U32, torch.zeros_like(gm))
    outv = (outv - ((outv >> 31) << 32)).to(torch.int32).view(torch.float32)
    _, rv, rh = sort_ops([si.to(torch.int32), outv, hit], 1,
                         is_stable=False)
    return rv[:npr], rh[:npr]
