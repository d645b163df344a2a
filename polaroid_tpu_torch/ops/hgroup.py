"""Hash-exchange group-by: the group layout of large key domains.

The port of the JAX package's `ops/hgroup.py`. A u32 key (the group-by's
mixed-radix key code, `ops/groupby.py`) is grouped with no hash table:

  1. ``h = fmix32(key)``, a bijection, so equal h means equal key and the
     top 5 bits spread any key skew over K = 32 buckets. Dead rows take
     ``h = 0xFFFFFFFF`` (the one live key that hashes there takes the
     fallback).
  2. Per block of S = 8192 rows: the live rows of each (block, bucket)
     are counted, and the block is sorted by h (`torch.sort` along dim 1,
     as the JAX package's `lax.sort`), which makes each bucket's rows one
     contiguous run.
  3. `bucket_exchange` (kernel E, csrc/exchange.cu) moves every run into
     a padded [K, B * CAP] bucket-major layout. When a cell would hold
     more than CAP rows (or the reserved key is live) `precheck` says so
     first, and the caller takes the carry sort instead.
  4. One sort of each bucket row by h makes each key's rows one run; run
     starts and ends mark the groups.

The exchange moves two words: h, and the row each slot came from (the
block sort's indices). After the final sort every live slot knows its
source row, so one scatter gives each row its group id, and every
aggregate is then a reduction of the row's own column by that id
(`ops/segment.py`). No value column rides the exchange, so Float64 and
Int64 values keep all their bits; the TPU carries 4-byte value words
through every sort instead (`polaroid_tpu/ops/groupby.py:2052`).

Words are held as int64 in [0, 2^32) everywhere except in the exchange,
which takes 4-byte int32 bit patterns: sorts and compares of h use the
int64 view, so the fill 0xFFFFFFFF sorts after every live h.

`adaptive_local_groupby` (the distributed engine's per-slot group-by of
u32 keys, `parallel/shuffle.py`) picks among the dense route (kernels A
and C over at most 8192 groups), this exchange, and the carry sort.
"""

from __future__ import annotations

import collections
from typing import List, NamedTuple, Sequence

import torch

from ..dtypes import dtype_from_numpy
from .cuda_partition import compact_words
from .exchange import CAP, K, S, bucket_exchange
from .hashing import U32_MASK, fmix32
from .segment import SPILL, spill_slots

__all__ = ["FILL", "FALLBACKS", "fmix32_inv", "precheck", "out_capacity",
           "hash_prep", "cell_extents", "exchange_words", "hash_layout", "group_ids",
           "hash_group_ids", "carry_sort", "carry_group_ids",
           "hash_groupby_u32", "local_groupby_carry",
           "adaptive_local_groupby", "ADAPTIVE_ROUTES", "DENSE_G",
           "DENSE_G_SMALL"]

FILL = 0xFFFFFFFF
_C1_INV = pow(0x85EBCA6B, -1, 1 << 32)
_C2_INV = pow(0xC2B2AE35, -1, 1 << 32)
_LOG_K = 5
# group-bys that took the carry-sort fallback (reset by callers that
# count them)
FALLBACKS = 0


def fmix32_inv(h: torch.Tensor) -> torch.Tensor:
    """Inverse of hashing.fmix32 (each step is invertible); int64 words
    in [0, 2^32), each multiply masked back to 32 bits (see fmix32)."""
    h = h.to(torch.int64) & U32_MASK
    h = h ^ (h >> 16)
    h = (h * _C2_INV) & U32_MASK
    h = h ^ (h >> 13) ^ (h >> 26)
    h = (h * _C1_INV) & U32_MASK
    return h ^ (h >> 16)


def _to_word(h: torch.Tensor) -> torch.Tensor:
    """Non-negative int64 below 2^32 -> the int32 with the same 32 bits:
    h - 2^32 where bit 31 is set, written out so no cast has to wrap."""
    return (h - ((h >> 31) << 32)).to(torch.int32)


def _from_word(w: torch.Tensor) -> torch.Tensor:
    """An int32 bit pattern -> its u32 value as a non-negative int64."""
    return w.to(torch.int64) & U32_MASK


def out_capacity(n: int) -> int:
    """Slots of the hash layout for n rows: B * K * CAP."""
    return -(-n // S) * K * CAP


class HashPrep(NamedTuple):
    """What precheck computes, and the pipeline reuses."""
    h: torch.Tensor        # (B * S,) int64: fmix32(key), FILL if dead/pad
    counts: torch.Tensor   # (B, K) int32: live rows per (block, bucket)
    starts: torch.Tensor   # (B, K) int32: exclusive prefix along K
    ok: torch.Tensor       # bool scalar: no cell past CAP, no live FILL


def hash_prep(key: torch.Tensor, valid: torch.Tensor) -> HashPrep:
    """Hash the keys (u32 values in an int64 tensor; only the low 32 bits
    count), pad to whole blocks and count every (block, bucket) cell."""
    n = key.shape[0]
    B = max(-(-n // S), 1)
    npad = B * S
    dev = key.device
    h = torch.where(valid, fmix32(key), torch.full_like(key, FILL,
                                                        dtype=torch.int64))
    badkey = (valid & (h == FILL)).any()
    if npad != n:
        h = torch.cat([h, torch.full((npad - n,), FILL, dtype=torch.int64,
                                     device=dev)])
    counts, starts = cell_extents(h, h != FILL)
    ok = (counts.max() <= CAP) & ~badkey
    return HashPrep(h, counts, starts, ok)


def cell_extents(h: torch.Tensor, live: torch.Tensor):
    """(counts, starts), each (B, K) int32, of the (block, bucket) cells
    of (B * S,) int64 words below 2^32, bucketed by their top 5 bits:
    the live rows of each cell, and the exclusive prefix of those counts
    along K (a cell's first row once its block is sorted)."""
    npad = h.shape[0]
    B = npad // S
    dev = h.device
    block = torch.arange(npad, dtype=torch.int64, device=dev) // S
    # dead and pad rows go to spill slots past the cells (segment.py)
    cell = torch.where(live, block * K + (h >> (32 - _LOG_K)),
                       spill_slots(npad, B * K, dev))
    counts = torch.zeros(B * K + SPILL, dtype=torch.int32, device=dev)
    counts.index_add_(0, cell, torch.ones(npad, dtype=torch.int32,
                                          device=dev))
    counts = counts[:B * K].view(B, K)
    starts = (torch.cumsum(counts, 1, dtype=torch.int32) - counts)
    return counts, starts.contiguous()


def precheck(key: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The fast path's feasibility, without running the pipeline: no
    bucket cell past CAP and no live key hashing to the fill."""
    return hash_prep(key, valid).ok


class HashLayout(NamedTuple):
    h: torch.Tensor        # (M,) int64: each slot's h, bucket-major, sorted
    src: torch.Tensor      # (M,) int32: the row each slot came from
    start: torch.Tensor    # (M,) bool: a live slot that starts its run
    end: torch.Tensor      # (M,) bool: a live slot that ends its run
    live: torch.Tensor     # (M,) bool


def exchange_words(prep: HashPrep):
    """The block sort: (words, fills) for `bucket_exchange`, h and the
    row index of each slot, every block sorted by h. Unstable, as the JAX
    package's: no result depends on the order of the rows within a run."""
    B = prep.counts.shape[0]
    hs, order = torch.sort(prep.h.view(B, S), dim=1)
    rows = order + torch.arange(B, dtype=torch.int64,
                                device=order.device)[:, None] * S
    return ([_to_word(hs).reshape(-1), rows.to(torch.int32).reshape(-1)],
            (FILL, FILL))


def hash_layout(prep: HashPrep) -> HashLayout:
    """Block sort, exchange, and the per-bucket sort: the M = B * K * CAP
    slots, each key's rows one run within its bucket row."""
    dev = prep.h.device
    words, fills = exchange_words(prep)
    hx, rx = bucket_exchange(prep.starts, prep.counts, words, fills)
    hfin, perm = torch.sort(_from_word(hx), dim=1)
    src = rx.gather(1, perm)
    live = hfin != FILL
    first = torch.ones((K, 1), dtype=torch.bool, device=dev)
    start = torch.cat([first, hfin[:, 1:] != hfin[:, :-1]], 1) & live
    end = torch.cat([hfin[:, :-1] != hfin[:, 1:], first], 1) & live
    return HashLayout(hfin.reshape(-1), src.reshape(-1), start.reshape(-1),
                      end.reshape(-1), live.reshape(-1))


def _row_ids(ids: torch.Tensor, live: torch.Tensor, src: torch.Tensor,
             n: int) -> torch.Tensor:
    """(n,) int32: ids[s] at row src[s] for every live slot s; n for the
    rows no live slot names (dead rows). Pads write spill rows past n,
    which are dropped."""
    out = torch.full((n + SPILL,), n, dtype=torch.int32, device=ids.device)
    out.scatter_(0, torch.where(live, src.to(torch.int64),
                                spill_slots(ids.shape[0], n, ids.device)),
                 ids.to(torch.int32))
    return out[:n]


def _run_ids(lay: HashLayout, n: int):
    """(rank, gid): each slot's run rank in slot order (valid on live
    slots), and each of the n rows' run rank (n for dead rows)."""
    rank = torch.cumsum(lay.start, 0) - 1
    return rank, _row_ids(rank, lay.live, lay.src, n)


def hash_group_ids(prep: HashPrep, n: int):
    """The fast path: (gid, codes, ngroups). gid (n,) int32 numbers each
    live row's group by its run's rank in slot order (hash order), n for
    dead rows; codes (n,) int64 holds each group's key, and 2^32 past
    ngroups; ngroups is a device scalar."""
    lay = hash_layout(prep)
    _, gid = _run_ids(lay, n)
    # the compaction kernel moves each run's h to the rank-th place: the
    # empty slots of the layout go, the groups stay, in hash order
    (hw,), ngroups = compact_words(lay.start, [_to_word(lay.h)])
    return gid, _codes(fmix32_inv(_from_word(hw[:n])), ngroups), ngroups


def _codes(keys: torch.Tensor, ngroups: torch.Tensor) -> torch.Tensor:
    """keys of the first ngroups slots, 2^32 (above every key) after."""
    idx = torch.arange(keys.shape[0], device=keys.device)
    return torch.where(idx < ngroups, keys, torch.full_like(keys, 1 << 32))


def carry_sort(key: torch.Tensor, valid: torch.Tensor):
    """One stable sort of (dead, key): (sv, perm, live, newg), the sorted
    keys (2^32 for dead rows, which sort last), the sort's permutation,
    the live sorted rows, and the first row of each group."""
    comp = torch.where(valid, key.to(torch.int64) & U32_MASK,
                       torch.full_like(key, 1 << 32, dtype=torch.int64))
    sv, perm = torch.sort(comp, stable=True)
    live = sv < (1 << 32)
    newg = torch.cat([live[:1], sv[1:] != sv[:-1]]) & live
    return sv, perm, live, newg


def carry_group_ids(key: torch.Tensor, valid: torch.Tensor):
    """The fallback, the u32 branch of the JAX package's carry sort
    (`_local_groupby_carry`): groups numbered in ascending key order.
    Returns (gid, codes, ngroups) as `hash_group_ids`."""
    n = key.shape[0]
    sv, perm, live, newg = carry_sort(key, valid)
    rank = torch.cumsum(newg, 0) - 1
    gid = torch.empty(n, dtype=torch.int32, device=key.device)
    gid.scatter_(0, perm, torch.where(live, rank, torch.full_like(rank, n))
                 .to(torch.int32))
    (kw,), ngroups = compact_words(newg, [_to_word(sv & U32_MASK)])
    return gid, _codes(_from_word(kw), ngroups), ngroups


def group_ids(key: torch.Tensor, valid: torch.Tensor):
    """(gid, codes, ngroups) of the key, by the hash exchange when
    `precheck` allows it and by the carry sort otherwise. Reading the
    precheck is the one host readback of the choice."""
    global FALLBACKS
    prep = hash_prep(key, valid)
    if bool(prep.ok):
        return hash_group_ids(prep, key.shape[0])
    FALLBACKS += 1
    return carry_group_ids(key, valid)


# ---------------------------------------------------------------------------
# the JAX package's array-level contracts
# ---------------------------------------------------------------------------

def _ident(dt: torch.dtype, agg: str):
    if dt.is_floating_point:
        return float("inf") if agg == "min" else -float("inf")
    info = torch.iinfo(dt)
    return info.max if agg == "min" else info.min


def _is_quantile(agg) -> bool:
    return isinstance(agg, tuple) and agg[0] == "quantile"


def _reduce(vals, aggs, gid, G: int, scan_dtypes) -> List[torch.Tensor]:
    """(G,) per-group results of each (value, aggregate) over row group
    ids `gid` (ids outside [0, G) take no part), through the reductions
    of the group-by's hash context, the ones its collects run."""
    # groupby imports this module, so these are imported here
    from .groupby import HashGroupContext, quantile_of_groups
    part = (gid >= 0) & (gid < G)
    ctx = HashGroupContext(gid, part, G, None, None, None)
    outs = []
    for i, (v, agg) in enumerate(zip(vals, aggs)):
        sdt = None if scan_dtypes is None else scan_dtypes[i]
        if agg == "count":
            outs.append(ctx.int_sum(torch.ones_like(gid)).to(torch.int32))
        elif agg in ("sum", "sumsq", "sumprod"):
            # sumprod: v is a pair (a, b) and each group sums a * b
            a, b = v if agg == "sumprod" else (v, v)
            sdt = sdt or a.dtype
            if a.dtype.is_floating_point or sdt.is_floating_point:
                x = a.to(torch.float64)
                if agg != "sum":
                    x = x * b.to(torch.float64)
                outs.append(ctx.sums([x])[0].to(sdt))
            else:
                x = a.to(sdt)
                if agg != "sum":
                    x = x * b.to(sdt)
                outs.append(ctx.int_sum(x).to(sdt))
        elif agg in ("min", "max"):
            wide = torch.int32 if v.dtype in (
                torch.bool, torch.int8, torch.uint8, torch.int16) else v.dtype
            outs.append(ctx.extreme(v, None, agg == "max",
                                    _ident(wide, agg)).to(v.dtype))
        else:  # ("quantile", q, interp), checked by the caller
            _, q, interp = agg
            dt = dtype_from_numpy(torch.empty(0, dtype=v.dtype).numpy()
                                  .dtype)
            val, _ = quantile_of_groups(v, dt, part, ctx, q, interp)
            outs.append(val.to(torch.float32))
    return outs


def hash_groupby_u32(key: torch.Tensor, vals: Sequence[torch.Tensor],
                     valid: torch.Tensor, aggs: Sequence, scan_dtypes=None,
                     prep: HashPrep = None):
    """The fast path's array contract, as the JAX package's: returns
    (gkey (M,) int64, outs, gvalid (M,) bool, ok) with M = out_capacity(n);
    each group's results sit at its run's end slot, where gvalid is set.
    When `ok` is False the outputs are garbage and the caller takes its
    fallback. aggs[i] is "sum", "count", "min", "max", "sumsq" (the
    square taken after the cast to scan_dtypes[i]), "sumprod" (vals[i] is
    a pair (a, b) and each group sums a * b) or ("quantile", q, interp)
    (a Float32 result, computed in f64 over the group's sorted values);
    scan_dtypes[i] (optional) is the accumulator and output dtype of a
    sum/sumsq/sumprod. Every value is reduced from the rows' own columns,
    so no Dekker two-product or two-float accumulator is needed. `prep`
    is `hash_prep(key, valid)` where the caller has it already."""
    for a in aggs:
        if a not in ("sum", "count", "min", "max", "sumsq", "sumprod") \
                and not _is_quantile(a):
            raise ValueError(f"hash group-by aggregate {a!r} is not part "
                             "of the contract")
    n = key.shape[0]
    prep = hash_prep(key, valid) if prep is None else prep
    lay = hash_layout(prep)
    rank, gid = _run_ids(lay, n)
    at_end = torch.where(lay.end, rank, torch.full_like(rank, n))
    outs = []
    for o, a in zip(_reduce(vals, aggs, gid, n, scan_dtypes), aggs):
        fill = _ident(o.dtype, a) if a in ("min", "max") else 0
        outs.append(torch.cat([o, torch.full((1,), fill, dtype=o.dtype,
                                             device=o.device)])[at_end])
    return fmix32_inv(lay.h), outs, lay.end, prep.ok


def local_groupby_carry(key: torch.Tensor, vals: Sequence[torch.Tensor],
                        valid: torch.Tensor, aggs: Sequence[str]):
    """The carry-sort group-by over u32 keys (the JAX package's
    `_local_groupby_carry`): (gkey (n,) int64, outs, gvalid (n,)), groups
    in ascending key order as a prefix. Sums keep the value dtype."""
    n = key.shape[0]
    gid, codes, ngroups = carry_group_ids(key, valid)
    gvalid = torch.arange(n, device=key.device) < ngroups
    outs = _reduce(vals, aggs, gid, n, None)
    return torch.where(gvalid, codes, torch.zeros_like(codes)), outs, gvalid



# ---------------------------------------------------------------------------
# the adaptive local group-by: dense (range < 8192) / hash exchange / carry
# ---------------------------------------------------------------------------

DENSE_G = 8192
DENSE_G_SMALL = 1024
# route name -> adaptive group-bys that took it ("dense_1024",
# "dense_8192", "hash", "carry"); reset by callers that count them
ADAPTIVE_ROUTES: collections.Counter = collections.Counter()


def _pad(x: torch.Tensor, M: int, fill=0) -> torch.Tensor:
    return torch.cat([x, x.new_full((M - x.shape[0],), fill)])


def _dense_branch(key, vals, valid, aggs, kmin: int, M: int, G: int):
    """The range-guaranteed dense group-by: gid = key - kmin < G. Counts
    and sums in one pass of kernel A (`seg_sum`), each min or max by
    kernel C (`seg_minmax`); group g's results at slot g, padded to M."""
    from ..parallel.shuffle import _ident
    from .cuda_kernels import seg_minmax, seg_sum
    gid = torch.where(valid, (key.to(torch.int64) & U32_MASK) - kmin,
                      torch.full_like(key, -1, dtype=torch.int64)
                      ).to(torch.int32)
    # the count row: kernel A counts the ids in [0, G), and invalid rows'
    # ids are -1
    stacked = [torch.where(valid, v.to(torch.float32), 0.)
               for v, a in zip(vals, aggs) if a == "sum"]
    res = seg_sum(torch.stack(stacked) if stacked else torch.empty(
        (0, gid.shape[0]), dtype=torch.float32, device=gid.device), gid, G,
        count=True)
    cnt = res[0]
    gv = cnt > 0
    outs = []
    si = 1
    for v, a in zip(vals, aggs):
        if a == "count":
            outs.append(cnt.to(torch.int32))
        elif a == "sum":
            outs.append(torch.where(gv, res[si], 0.).to(v.dtype))
            si += 1
        else:
            ident = float("inf") if a == "min" else float("-inf")
            x = torch.where(valid, v.to(torch.float32), ident)
            r = seg_minmax(x, gid, G, a == "max", ident)
            outs.append(torch.where(gv, r.to(v.dtype), torch.full_like(
                r, _ident(v.dtype, a), dtype=v.dtype)))
    gkey = (kmin + torch.arange(G, dtype=torch.int64, device=key.device)) \
        & U32_MASK
    return (_pad(gkey, M), tuple(_pad(o, M) for o in outs),
            _pad(gv, M, False))


def adaptive_local_groupby(key, vals, valid, aggs, slow_fn):
    """The runtime-adaptive group-by over u32 keys (int64 tensors below
    2^32) and 4-byte values (the JAX package's): the dense route when the
    live key range is under DENSE_G_SMALL or DENSE_G and every aggregate
    is a count or over floats (the f32 one-hot sums are exact for ints
    only below 2^24), else the hash exchange (kernels E and B) when
    `precheck` allows it, else `slow_fn` (the carry sort). The JAX
    package picks with `lax.cond` on the device; here kmin, kmax, any
    live row and the precheck come back in one readback.

    slow_fn() -> (gkey (n,), outs, gvalid (n,)). Returns the same triple
    at capacity `out_capacity(n)`."""
    n = key.shape[0]
    M = out_capacity(n)
    k32 = key.to(torch.int64) & U32_MASK
    prep = hash_prep(k32, valid)
    kmin = torch.where(valid, k32, torch.full_like(k32, U32_MASK)).min()
    kmax = torch.where(valid, k32, torch.zeros_like(k32)).max()
    kmin, kmax, any_live, ok = torch.stack(
        [kmin, kmax, valid.any().to(torch.int64),
         prep.ok.to(torch.int64)]).tolist()
    dense_static = n < (1 << 24) and all(
        a == "count" or v.dtype.is_floating_point
        for v, a in zip(vals, aggs))
    rng = kmax - kmin
    if dense_static and any_live and rng < DENSE_G_SMALL:
        ADAPTIVE_ROUTES["dense_1024"] += 1
        return _dense_branch(k32, vals, valid, aggs, kmin, M, DENSE_G_SMALL)
    if dense_static and any_live and rng < DENSE_G:
        ADAPTIVE_ROUTES["dense_8192"] += 1
        return _dense_branch(k32, vals, valid, aggs, kmin, M, DENSE_G)
    if ok:
        ADAPTIVE_ROUTES["hash"] += 1
        gkey, outs, gv, _ = hash_groupby_u32(k32, vals, valid, aggs,
                                             prep=prep)
        return gkey, tuple(outs), gv
    ADAPTIVE_ROUTES["carry"] += 1
    gkey, outs, gv = slow_fn()
    return (_pad(gkey.to(torch.int64) & U32_MASK, M),
            tuple(_pad(o, M) for o in outs), _pad(gv, M, False))
