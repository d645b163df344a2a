"""Distributed shuffles and relational steps over a mesh of shard slots.

The port of the JAX package's `parallel/shuffle.py`. Every slot holds a
row shard; a group-by first pre-aggregates each shard, a join
pre-partitions both sides, and then records are exchanged by
`hash(key) % S` (or by explicit destinations, for the range-partitioned
sort) with one all-to-all, and each slot finishes with a local pass.

The JAX package writes each step as one per-shard program under
`shard_map`, with `lax.all_to_all` in the middle. Here one process
drives the slots (`run_sharded` is the stand-in for `shard_map`): a
sharded array is a list of S per-slot tensors, a step runs once per slot
under that slot's device, and `all_to_all` moves the blocks between
slots (a transpose when they share a device, one device copy per block
otherwise). A builder (`make_sharded_groupby`, ...) returns a plain
function over global arrays whose capacity is a multiple of S: row
block s is shard s, and the outputs come back concatenated on the
mesh's home device.

Keys are packed u64 words (`ops/keycode.py`), held as int64 tensors with
the u64's bits. The routing is the JAX package's bit for bit: each
record's destination, its slot within that destination (the stable
order of the destinations), the zero fills of the empty slots and the
count of records dropped past a destination's capacity. The local sorts
are kernel F (`sort_ops`), the group boundaries kernel B
(`compact_words`), and the adaptive group-by of u32 keys on the card
reaches kernels A, C and E (`ops/hgroup.py`).
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable, List, Sequence

import torch

from ..dtypes import DataType, Int32, UInt8, UInt32, UInt64, \
    dtype_from_numpy
from ..ops.cuda_partition import compact_words
from ..ops.hashing import U32_MASK, combine_hashes, fmix32
from ..ops.merge_sort import sort_ops
from ..ops.segment import SPILL, segment_minmax, segment_sum, \
    segment_sum_int, spill_slots
from .mesh import CHIP_AXIS, HOST_AXIS, Mesh, is_mesh_2d, total_shards

__all__ = ["run_sharded", "shard_rows", "unshard_rows", "map_slots",
           "all_to_all", "local_groupby", "exchange_by_hash",
           "exchange_records", "exchange_records_2d",
           "make_sharded_groupby", "make_sharded_groupby_2d",
           "make_groupby_partials", "make_groupby_merge",
           "local_groupby_exact", "make_sharded_groupby_exact",
           "shuffle_rows_step", "local_join", "local_semi_flags",
           "local_join_count", "make_sharded_join_count", "make_dest_hist",
           "dest_hist", "make_sharded_join", "make_sharded_semi",
           "local_unique", "make_sharded_unique", "COUNTS",
           "reset_counts", "total_shards", "is_mesh_2d"]

# agg kind -> the kind that merges its partials
_MERGE_OF = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}
# exchanges run ("exchanges"), bytes moved between distinct slots
# ("bytes"), the largest per-destination capacity ("per_dest_cap") and
# the records dropped past it ("dropped", counted where a caller reads
# the drop counts back); reset by callers that count them
COUNTS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    COUNTS.clear()


# ---------------------------------------------------------------------------
# the shard_map stand-in
# ---------------------------------------------------------------------------

def _on(dev: torch.device):
    """Run under a slot's device (the current CUDA device, so that new
    tensors and launches land on it)."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def shard_rows(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """A global (cap,) array as S row blocks, block s on slot s's device:
    a view where that is the array's own device, a copy otherwise."""
    S = mesh.size
    cap = x.shape[0]
    if cap % S:
        raise ValueError(f"capacity {cap} is not a multiple of {S} shards")
    B = cap // S
    return [x[s * B:(s + 1) * B] if dev == x.device else
            x[s * B:(s + 1) * B].to(dev, non_blocking=True)
            for s, dev in enumerate(mesh.devices)]


def unshard_rows(mesh: Mesh, blocks: Sequence[torch.Tensor]
                 ) -> torch.Tensor:
    """The per-slot blocks concatenated on the mesh's home device."""
    home = mesh.home
    return torch.cat([b if b.device == home else
                      b.to(home, non_blocking=True) for b in blocks])


def map_slots(mesh: Mesh, fn: Callable, *per_slot) -> list:
    """[fn(*(a[s] for a in per_slot)) for each slot s], each call under
    slot s's device."""
    out = []
    for s, dev in enumerate(mesh.devices):
        with _on(dev):
            out.append(fn(*[a[s] for a in per_slot]))
    return out


def _columns(results: list) -> tuple:
    """Per-slot tuples -> a tuple of per-slot lists."""
    return tuple(list(c) for c in zip(*results))


def run_sharded(mesh: Mesh, step: Callable, *arrays: torch.Tensor):
    """Run `step` once per slot over each array's row block (block s on
    slot s's device) and concatenate each of its outputs over the slots
    on the home device: `shard_map` with every spec the row sharding.
    `step` returns a tensor or a tuple of tensors."""
    res = map_slots(mesh, step, *[shard_rows(mesh, a) for a in arrays])
    if isinstance(res[0], torch.Tensor):
        return unshard_rows(mesh, res)
    return tuple(unshard_rows(mesh, c) for c in _columns(res))


def all_to_all(sends: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """`lax.all_to_all` (split and concat on axis 0, tiled) over a group
    of G slots: slot i sends a (G, P) buffer whose row j goes to slot j,
    and slot j receives (G, P) whose row i came from slot i. On one
    device this is a transpose; across devices one copy per (source,
    destination) block, queued on the destination's stream."""
    G = len(sends)
    blk = sends[0][0].numel() * sends[0].element_size()
    COUNTS["bytes"] += G * (G - 1) * blk
    if all(d == devices[0] for d in devices):
        return list(torch.stack(list(sends)).transpose(0, 1).contiguous()
                    .unbind(0))
    recv = []
    for j, dev in enumerate(devices):
        with _on(dev):
            r = torch.empty(sends[0].shape, dtype=sends[0].dtype,
                            device=dev)
            for i in range(G):
                r[i].copy_(sends[i][j], non_blocking=True)
        recv.append(r)
    return recv


# ---------------------------------------------------------------------------
# hashing, segment helpers
# ---------------------------------------------------------------------------

def _hash_u64(k: torch.Tensor) -> torch.Tensor:
    """u32 hash (int64) of packed u64 keys: fmix32 of each half,
    combined as the JAX package's `combine_hashes`."""
    lo = k & U32_MASK
    hi = (k >> 32) & U32_MASK
    return combine_hashes(fmix32(hi), fmix32(lo))


def _changed(x: torch.Tensor) -> torch.Tensor:
    """True at slot 0 and where x differs from the slot before."""
    return torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                      x[1:] != x[:-1]])


def _segscan(v: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive sum: at slot i, the sum of v over
    [segment_start(i), i], a segment starting at every set flag (the JAX
    package's `_segscan` with add, its only use)."""
    v = v.to(torch.int64)
    n = v.shape[0]
    c = torch.cumsum(v, 0)
    seg = torch.cumsum(flags.to(torch.int64), 0)
    # base[k]: the running total just before segment k's first slot (0
    # before the first flag); the unflagged slots write to spill slots
    # past n (one address would serialise their writes)
    base = torch.zeros(n + 1 + SPILL, dtype=torch.int64, device=v.device)
    base.scatter_(0, torch.where(flags, seg,
                                 spill_slots(n, n + 1, v.device)), c - v)
    return c - base[seg]


def _group_bounds(newg: torch.Tensor, live: torch.Tensor, carry=()):
    """(starts, ends, ngroups, carried): group g's sorted-slot range
    [start, end) for g < ngroups (a device scalar), from one stable
    compaction of the group-start slots (kernel B). `carry` words are
    compacted with them: each group's leading values (its key)."""
    cap = newg.shape[0]
    idx = torch.arange(cap, dtype=torch.int32, device=newg.device)
    nlive = live.sum()
    out, ngroups = compact_words(newg.contiguous(), [idx] + list(carry))
    starts = out[0].to(torch.int64)
    g = torch.arange(cap, device=newg.device)
    next_start = torch.cat([starts[1:], starts.new_full((1,), cap)])
    ends = torch.where(g < ngroups - 1, next_start, nlive)
    return starts, ends, ngroups, list(out[1:])


def _ident(dt: torch.dtype, kind: str):
    if dt.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    if dt == torch.bool:
        return kind == "min"
    info = torch.iinfo(dt)
    return info.max if kind == "min" else info.min


def _dtype_of(t: torch.Tensor) -> DataType:
    return dtype_from_numpy(torch.empty(0, dtype=t.dtype).numpy().dtype)


def _gsum(x: torch.Tensor, gid: torch.Tensor, G: int) -> torch.Tensor:
    """Per-group sums in x's dtype (floats added in f64, ints in int64
    and wrapped back)."""
    if x.dtype.is_floating_point:
        return segment_sum(x[None], gid, G)[0].to(x.dtype)
    return segment_sum_int(x, gid, G).to(x.dtype)


def _gext(x: torch.Tensor, gid: torch.Tensor, G: int, kind: str
          ) -> torch.Tensor:
    """Per-group min or max in x's dtype; the dtype's identity for an
    empty group."""
    wide = x
    if x.dtype in (torch.bool, torch.int8, torch.uint8, torch.int16):
        wide = x.to(torch.int32)
    return segment_minmax(wide.contiguous(), gid, G, kind == "max",
                          _ident(x.dtype, kind)).to(x.dtype)


def _key_from_words(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """A packed key from its (hi, lo) u32 words, or one word as it is."""
    if len(words) == 1:
        return words[0]
    return (words[0] << 32) | words[1]


# ---------------------------------------------------------------------------
# the local group-by
# ---------------------------------------------------------------------------

def local_groupby(key: torch.Tensor, vals: Sequence[torch.Tensor],
                  valid: torch.Tensor, aggs: Sequence[str],
                  key_dtype: DataType = UInt64):
    """Per-slot group-by over packed keys (UInt64: any int64 bits;
    UInt32: values below 2^32). Returns (gkey, outs, gvalid), a masked
    partial-group table whose live slots gvalid marks; aggs[i] applies to
    vals[i] and "count" counts the valid rows.

    On the card, u32 keys with 4-byte values and sum/count/min/max at
    2^14 <= n < 2^24 rows take the adaptive group-by (dense through
    kernels A and C, the hash exchange through E and B, or the carry
    sort), as the JAX package does off the CPU; everything else takes the
    carry sort."""
    cap = key.shape[0]
    if (key.device.type == "cuda" and key_dtype == UInt32
            and (1 << 14) <= cap < (1 << 24)
            and all(v.element_size() == 4 for v in vals)
            and all(a in ("sum", "count", "min", "max") for a in aggs)):
        from ..ops.hgroup import adaptive_local_groupby
        gk, outs, gv = adaptive_local_groupby(
            key, list(vals), valid, aggs,
            lambda: _local_groupby_carry(key, vals, valid, aggs, key_dtype))
        return gk, list(outs), gv
    return _local_groupby_carry(key, vals, valid, aggs, key_dtype)


def _local_groupby_carry(key, vals, valid, aggs, key_dtype=UInt64):
    """The carry-sort group-by: ONE stable sort of (dead, key) with the
    value columns riding along (kernel F), then each group's reductions
    over the sorted rows and its key by one compaction (kernel B).
    Groups come out in ascending key order as a prefix of the n slots."""
    from ..ops.hgroup import _reduce
    cap = key.shape[0]
    dead = (~valid).to(torch.int64)
    out = sort_ops([dead, key] + list(vals), 2, is_stable=True,
                   dtypes=[UInt32, key_dtype] + [_dtype_of(v) for v in vals])
    sdead, skey, svals = out[0], out[1], out[2:]
    live = sdead == 0
    newg = _changed(skey) & live
    gid = torch.where(live, torch.cumsum(newg, 0) - 1,
                      torch.full_like(skey, cap))
    outs = _reduce(svals, aggs, gid, cap, None)
    _, _, ngroups, (gkey,) = _group_bounds(newg, live, [skey])
    gvalid = torch.arange(cap, device=key.device) < ngroups
    return torch.where(gvalid, gkey, torch.zeros_like(gkey)), outs, gvalid


# ---------------------------------------------------------------------------
# exchanges
# ---------------------------------------------------------------------------

def _send_buffers(dest, key, payloads, valid, num_shards: int,
                  per_dest_cap: int):
    """One slot's send buffers: records sorted stably by destination, a
    destination's records in its row of per_dest_cap slots, zeros after
    them; those past per_dest_cap are dropped (and counted)."""
    cap = key.shape[0]
    dev = key.device
    S, P = num_shards, per_dest_cap
    d = torch.where(valid, dest.to(torch.int64) & U32_MASK,
                    torch.full_like(key, S))
    dsort, order = torch.sort(d, stable=True)
    starts = torch.searchsorted(dsort, torch.arange(S + 1, device=dev))
    counts = starts[1:] - starts[:-1]
    p = torch.arange(S * P, device=dev)
    dd = p // P
    w = p % P
    src = order[(starts[dd] + w).clamp(0, cap - 1)]
    ok = w < counts[dd]

    def scatter(arr):
        return torch.where(ok, arr[src], arr.new_zeros(())).view(S, P)

    dropped = (counts - P).clamp(min=0).sum()
    return (scatter(key), [scatter(x) for x in payloads],
            scatter(valid.to(torch.int32)), dropped)


def exchange_records(dest, key, payloads, valid, num_shards: int,
                     per_dest_cap: int, devices: Sequence[torch.device],
                     with_overflow: bool = False):
    """Route records to explicit destinations over a group of slots (the
    range partition of the sort, the hash partition of joins and
    group-bys). Every argument is a per-slot list (`payloads[s]` a list
    of that slot's payload columns); `devices` holds each slot's device.

    Returns per-slot lists (keys, payloads, valids) of capacity
    num_shards * per_dest_cap, and with `with_overflow` also each slot's
    count of records it could not send (int64 scalars): a record past
    its destination's per_dest_cap slots is dropped, so callers size the
    capacity losslessly and refuse a result with drops."""
    S = num_shards
    COUNTS["exchanges"] += 1
    COUNTS["per_dest_cap"] = max(COUNTS["per_dest_cap"], per_dest_cap)
    sends = []
    for s, dev in enumerate(devices):
        with _on(dev):
            sends.append(_send_buffers(dest[s], key[s], payloads[s],
                                       valid[s], S, per_dest_cap))
    skey, spay, svalid, dropped = _columns(sends)
    n = S * per_dest_cap
    rkey = [r.reshape(n) for r in all_to_all(skey, devices)]
    rvalid = [r.reshape(n) != 0 for r in all_to_all(svalid, devices)]
    npay = len(payloads[0]) if payloads else 0
    rpay_cols = [[r.reshape(n) for r in
                  all_to_all([spay[s][j] for s in range(S)], devices)]
                 for j in range(npay)]
    rpay = [[rpay_cols[j][s] for j in range(npay)] for s in range(S)]
    if with_overflow:
        return rkey, rpay, rvalid, list(dropped)
    return rkey, rpay, rvalid


def exchange_by_hash(key, payloads, valid, num_shards: int,
                     per_dest_cap: int, devices):
    """Route (key, payload) records to slot hash(key) % S; per-slot lists
    in and out, as `exchange_records`."""
    dest = [_hash_u64(k) % num_shards for k in key]
    return exchange_records(dest, key, payloads, valid, num_shards,
                            per_dest_cap, devices)


def exchange_records_2d(dest, key, payloads, valid, n_hosts: int,
                        n_chips: int, per_dest_cap: int, devices,
                        with_overflow: bool = False):
    """The two-stage exchange over a (hosts x chips) mesh: records bound
    for slot d = h * C + c first move among the C slots of their host,
    routed by c (capacity H * per_dest_cap, since one source may hold
    records for every host of that chip index), then among the H slots of
    one chip index, routed by h (capacity C * per_dest_cap). The final
    capacity is S * per_dest_cap, as the flat exchange's; the drop
    counts of both stages add up."""
    H, C = n_hosts, n_chips
    S = H * C
    c_d = [(d & U32_MASK) % C for d in dest]
    h_d = [(d & U32_MASK) // C for d in dest]
    k1, p1, v1, drop1 = [None] * S, [None] * S, [None] * S, [None] * S
    for h in range(H):
        idx = [h * C + c for c in range(C)]
        rk, rp, rv, dr = exchange_records(
            [c_d[i] for i in idx], [key[i] for i in idx],
            [list(payloads[i]) + [h_d[i]] for i in idx],
            [valid[i] for i in idx], C, H * per_dest_cap,
            [devices[i] for i in idx], with_overflow=True)
        for j, i in enumerate(idx):
            k1[i], p1[i], v1[i], drop1[i] = rk[j], rp[j], rv[j], dr[j]
    k2, p2, v2, drop2 = [None] * S, [None] * S, [None] * S, [None] * S
    for c in range(C):
        idx = [h * C + c for h in range(H)]
        rk, rp, rv, dr = exchange_records(
            [torch.where(v1[i], p1[i][-1], torch.full_like(p1[i][-1], H))
             for i in idx], [k1[i] for i in idx],
            [p1[i][:-1] for i in idx], [v1[i] for i in idx], H,
            C * per_dest_cap, [devices[i] for i in idx], with_overflow=True)
        for j, i in enumerate(idx):
            k2[i], p2[i], v2[i], drop2[i] = rk[j], rp[j], rv[j], dr[j]
    if with_overflow:
        return k2, p2, v2, [a + b for a, b in zip(drop1, drop2)]
    return k2, p2, v2


def _router(mesh: Mesh, per_dest_cap: int, with_overflow: bool = False):
    """The exchange bound to the mesh: one all-to-all over a flat mesh,
    the two-stage schedule over a (hosts x chips) one. Per-slot lists in
    and out; the output capacity is S * per_dest_cap either way."""
    devs = mesh.devices
    if is_mesh_2d(mesh):
        H, C = mesh.shape[HOST_AXIS], mesh.shape[CHIP_AXIS]

        def route(dest, key, pays, valid):
            return exchange_records_2d(dest, key, pays, valid, H, C,
                                       per_dest_cap, devs,
                                       with_overflow=with_overflow)
    else:
        S = mesh.size

        def route(dest, key, pays, valid):
            return exchange_records(dest, key, pays, valid, S, per_dest_cap,
                                    devs, with_overflow=with_overflow)
    return route


def _shard_all(mesh: Mesh, *arrays):
    return [shard_rows(mesh, a) for a in arrays]


def _dests(mesh: Mesh, keys) -> list:
    S = mesh.size
    return map_slots(mesh, lambda k: _hash_u64(k) % S, keys)


def _gather_out(mesh: Mesh, *per_slot_lists) -> tuple:
    return tuple(unshard_rows(mesh, c) for c in per_slot_lists)


# ---------------------------------------------------------------------------
# sharded group-by builders
# ---------------------------------------------------------------------------

def make_sharded_groupby(mesh: Mesh, aggs: Sequence[str], per_dest_cap: int):
    """The distributed group-by over row-sharded arrays (a flat or a
    hosts x chips mesh): per-slot partial aggregation, the exchange by
    key hash, per-slot merge. fn(key, valid, *vals) -> (gkey, gvalid,
    dropped (S,), *outs), concatenated over the slots. per_dest_cap = the
    shard capacity is always lossless; `make_groupby_partials` /
    `make_groupby_merge` size it from an exact histogram."""
    partials = make_groupby_partials(mesh, aggs, per_slot=True)
    merge = make_groupby_merge(mesh, aggs, per_dest_cap, per_slot=True)

    def fn(key, valid, *vals):
        gkey, gvalid, _, parts = partials(key, valid, *vals)
        gk, gv, dropped, outs = merge(gkey, gvalid, *parts)
        return _gather_out(mesh, gk, gv) + (torch.stack(
            [d.to(mesh.home) for d in dropped]),) + _gather_out(mesh, *outs)
    return fn


def make_sharded_groupby_2d(mesh: Mesh, aggs: Sequence[str],
                            per_dest_cap: int):
    """`make_sharded_groupby` over a (hosts x chips) mesh."""
    if not is_mesh_2d(mesh):
        raise ValueError("make_sharded_groupby_2d needs a (hosts x chips) "
                         "mesh")
    return make_sharded_groupby(mesh, aggs, per_dest_cap)


def make_groupby_partials(mesh: Mesh, aggs: Sequence[str],
                          per_slot: bool = False):
    """Phase 1 of the sized group-by: per-slot partial aggregation and
    each slot's exact count of groups per destination. fn(key, valid,
    *vals) -> (gkey, gvalid, counts (S * S,), *partials); the host reads
    the counts' max to size phase 2's exchange. `per_slot` keeps per-slot
    lists (for the builders here)."""
    S = mesh.size

    def step(k, v, *x):
        gk, parts, gv = local_groupby(k, list(x), v, aggs)
        dest = _hash_u64(gk) % S
        # dead groups count in bin S (no mask, so no readback)
        counts = torch.bincount(torch.where(gv, dest, S),
                                minlength=S + 1)[:S]
        return gk, gv, counts, parts

    def fn(key, valid, *vals):
        res = map_slots(mesh, step, *_shard_all(mesh, key, valid, *vals))
        gk, gv, counts, parts = _columns(res)
        parts = [list(c) for c in zip(*parts)]
        if per_slot:
            return gk, gv, counts, parts
        return _gather_out(mesh, gk, gv, counts) + _gather_out(mesh, *parts)
    return fn


def make_groupby_merge(mesh: Mesh, aggs: Sequence[str], per_dest_cap: int,
                       per_slot: bool = False):
    """Phase 2: exchange the partial states by key hash at the
    histogram's capacity and merge them per slot. fn(gkey, gvalid,
    *partials) -> (gkey, gvalid, dropped (S,), *outs)."""
    route = _router(mesh, per_dest_cap, with_overflow=True)
    merge_aggs = [_MERGE_OF[a] for a in aggs]

    def fn(gkey, gvalid, *partials):
        if not per_slot:
            gkey, gvalid, *partials = _shard_all(mesh, gkey, gvalid,
                                                 *partials)
        dest = _dests(mesh, gkey)
        pays = [list(p) for p in zip(*partials)] if partials \
            else [[] for _ in range(mesh.size)]
        rkey, rpart, rvalid, dropped = route(dest, gkey, pays, gvalid)
        res = map_slots(mesh, lambda k, p, v: local_groupby(
            k, p, v, merge_aggs), rkey, rpart, rvalid)
        gk, outs, gv = _columns(res)
        outs = [list(c) for c in zip(*outs)]
        if per_slot:
            return gk, gv, dropped, outs
        return _gather_out(mesh, gk, gv) + (torch.stack(
            [d.to(mesh.home) for d in dropped]),) + _gather_out(mesh, *outs)
    return fn


# ---------------------------------------------------------------------------
# the exact group-by: whole groups on one slot
# ---------------------------------------------------------------------------

def _venc_words(x: torch.Tensor) -> List[torch.Tensor]:
    """Order-preserving u32 word(s) of a value column (sort operands)."""
    from ..ops.keycode import U32, code_bits, encode_orderable
    dt = _dtype_of(x)
    u = encode_orderable(x, dt)
    if code_bits(dt) == 64:
        return [(u >> 32) & U32, u & U32]
    return [u]


def _vdec(words: Sequence[torch.Tensor], dtype: torch.dtype
          ) -> torch.Tensor:
    """Sorted order-preserving words back to values of `dtype`."""
    from ..ops.keycode import decode_orderable
    dt = dtype_from_numpy(torch.empty(0, dtype=dtype).numpy().dtype)
    return decode_orderable(_key_from_words(words), dt, False)


def local_groupby_exact(key, valid, rowidx, vals, vvalids, specs):
    """Per-slot exact group-by on packed u64 keys over WHOLE rows: every
    group's rows are on this slot (hash-routed), so holistic and
    order-dependent aggregates are exact. specs: dicts {kind, vi, q,
    interp, ddof}, kind in {len, count, null_count, sum, min, max, mean,
    std, var, any, all, first, last, median, quantile, n_unique}; vi
    indexes vals/vvalids. rowidx (the global row) orders first/last.

    Returns (gkey, gvalid, outs), outs alternating (data, out_valid) per
    spec, group g's result at slot g."""
    cap = key.shape[0]
    dev = key.device
    dead = (~valid).to(torch.int64)
    nv = len(vals)
    ops = [dead, key, rowidx.to(torch.int32)] + list(vals) + \
        [v.to(torch.uint8) for v in vvalids]
    out = sort_ops(ops, 3, is_stable=True,
                   dtypes=[UInt32, UInt64, Int32] +
                   [_dtype_of(v) for v in vals] + [UInt8] * nv)
    sdead, skey = out[0], out[1]
    svals = list(out[3:3 + nv])
    svv = [v != 0 for v in out[3 + nv:]]
    live = sdead == 0
    newg = _changed(skey) & live
    starts, ends, ngroups, (gkey,) = _group_bounds(newg, live, [skey])
    g_arange = torch.arange(cap, device=dev)
    gvalid = g_arange < ngroups
    gcount = torch.where(gvalid, ends - starts, 0)
    gid = torch.where(live, torch.cumsum(newg, 0) - 1,
                      torch.full_like(skey, cap))
    gkey = torch.where(gvalid, gkey, torch.zeros_like(gkey))
    s0 = starts.clamp(0, cap - 1)
    e1 = (ends - 1).clamp(0, cap - 1)

    nn_cache: dict = {}
    byval_cache: dict = {}

    def cnt_nn(vi):
        if vi not in nn_cache:
            nn_cache[vi] = segment_sum_int((live & svv[vi]).to(torch.int64),
                                           gid, cap)
        return nn_cache[vi]

    def byval(vi):
        """A second sort: within each group, valid values ascending and
        nulls after them. Its group bounds are the base sort's."""
        if vi not in byval_cache:
            vnull = (~vvalids[vi]).to(torch.int64)
            words = _venc_words(vals[vi])
            nk = 3 + len(words)
            sout = sort_ops([dead, key, vnull] + words, nk, is_stable=True,
                            dtypes=[UInt32, UInt64] + [UInt32] * (nk - 2))
            byval_cache[vi] = (list(sout[3:]), sout[2])
        return byval_cache[vi]

    outs: list = []
    for sp in specs:
        kind = sp["kind"]
        vi = sp.get("vi")
        if kind == "len":
            outs += [gcount.to(torch.int64), gvalid]
            continue
        if kind == "count":
            outs += [cnt_nn(vi), gvalid]
            continue
        if kind == "null_count":
            outs += [gcount - cnt_nn(vi), gvalid]
            continue
        sv = svals[vi]
        ok = live & svv[vi]
        if kind == "sum":
            outs += [_gsum(torch.where(ok, sv, sv.new_zeros(())), gid, cap),
                     gvalid]
            continue
        if kind in ("min", "max"):
            iv = _ident(sv.dtype, kind)
            outs += [_gext(torch.where(ok, sv, torch.full_like(sv, iv)), gid,
                           cap, kind), gvalid & (cnt_nn(vi) > 0)]
            continue
        if kind in ("any", "all"):
            fill = 0 if kind == "any" else 1
            v = torch.where(ok, sv.to(torch.int32),
                            torch.full_like(sv, fill, dtype=torch.int32))
            red = _gext(v, gid, cap, "max" if kind == "any" else "min")
            outs += [red != 0, gvalid]
            continue
        if kind in ("first", "last"):
            slot = s0 if kind == "first" else e1
            outs += [sv[slot], gvalid & svv[vi][slot]]
            continue
        if kind in ("mean", "std", "var"):
            c = cnt_nn(vi).to(torch.float64)
            vf = sv.to(torch.float64)
            m = torch.where(ok, vf, 0.0)
            s = _gsum(m, gid, cap)
            if kind == "mean":
                outs += [s / c.clamp(min=1), gvalid & (cnt_nn(vi) > 0)]
                continue
            ddof = sp.get("ddof", 1)
            s2 = _gsum(torch.where(ok, vf * vf, 0.0), gid, cap)
            var = (s2 - s * s / c.clamp(min=1)) / (c - ddof).clamp(min=1)
            if kind == "std":
                var = torch.sqrt(var.clamp(min=0.0))
            outs += [var, gvalid & (cnt_nn(vi) > ddof)]
            continue
        if kind == "n_unique":
            swords, svnull = byval(vi)
            newpair = newg | _changed(svnull)
            for w in swords:
                newpair = newpair | _changed(w)
            outs += [segment_sum_int((live & newpair).to(torch.int64), gid,
                                     cap), gvalid]
            continue
        if kind in ("median", "quantile"):
            q = 0.5 if kind == "median" else float(sp.get("q", 0.5))
            interp = "linear" if kind == "median" else \
                sp.get("interp", "nearest")
            swords, _ = byval(vi)
            c = cnt_nn(vi)
            pos = (c - 1).to(torch.float64) * q
            if interp == "lower":
                ilo = ihi = torch.floor(pos)
            elif interp == "higher":
                ilo = ihi = torch.ceil(pos)
            elif interp == "nearest":
                ilo = ihi = torch.round(pos)
            else:  # linear, midpoint
                ilo, ihi = torch.floor(pos), torch.ceil(pos)
            lo_slot = (s0 + ilo.clamp(min=0).to(torch.int64)).clamp(0, cap - 1)
            hi_slot = (s0 + ihi.clamp(min=0).to(torch.int64)).clamp(0, cap - 1)
            dt = vals[vi].dtype
            vlo = _vdec([w[lo_slot] for w in swords], dt)
            if interp == "linear":
                vhi = _vdec([w[hi_slot] for w in swords], dt)
                frac = pos - torch.floor(pos)
                res = vlo.to(torch.float64) * (1 - frac) + \
                    vhi.to(torch.float64) * frac
            elif interp == "midpoint":
                vhi = _vdec([w[hi_slot] for w in swords], dt)
                res = (vlo.to(torch.float64) + vhi.to(torch.float64)) * 0.5
            else:
                res = vlo
            outs += [res, gvalid & (c > 0)]
            continue
        raise ValueError(f"exact agg kind {kind!r}")
    return gkey, gvalid, outs


def make_sharded_groupby_exact(mesh: Mesh, specs, n_vals: int,
                               per_dest_cap: int):
    """The exact distributed group-by: whole rows (key, value columns,
    their validity and the global row index) exchanged by key hash, then
    `local_groupby_exact` per slot. fn(key, valid, rowidx, *vals,
    *vvalids) -> (gkey, gvalid, dropped (S,), *outs), outs alternating
    (data, out_valid) per spec."""
    route = _router(mesh, per_dest_cap, with_overflow=True)

    def fn(key, valid, rowidx, *vv):
        key, valid, rowidx, *vv = _shard_all(mesh, key, valid, rowidx, *vv)
        S = mesh.size
        pays = [[rowidx[s]] + [x[s] for x in vv[:n_vals]] +
                [x[s].to(torch.uint8) for x in vv[n_vals:]]
                for s in range(S)]
        k2, p2, v2, dropped = route(_dests(mesh, key), key, pays, valid)

        def step(k, p, v):
            gkey, gvalid, outs = local_groupby_exact(
                k, v, p[0], p[1:1 + n_vals], [x != 0 for x in p[1 + n_vals:]],
                specs)
            return [gkey, gvalid] + outs
        res = _columns(map_slots(mesh, step, k2, p2, v2))
        return _gather_out(mesh, res[0], res[1]) + (torch.stack(
            [d.to(mesh.home) for d in dropped]),) + \
            _gather_out(mesh, *res[2:])
    return fn


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------

def shuffle_rows_step(key, payloads, valid, num_shards: int,
                      per_dest_cap: int, devices):
    """The row shuffle of a join: every live row to hash(key) % S (rows
    are not pre-aggregated)."""
    return exchange_by_hash(key, payloads, valid, num_shards, per_dest_cap,
                            devices)


def _expand_slots(m: torch.Tensor, offs: torch.Tensor, out_cap: int
                  ) -> torch.Tensor:
    """Output slot -> group: slot k < total belongs to the group whose
    range [offs - m, offs) holds it, the number of groups with offs <= k
    (one binary search per slot; offs = cumsum(m) is sorted). Slots past
    the total take the last emitting group, as the JAX package's
    scatter of each group's index at its first slot followed by a
    cumulative max gives (torch's cummax took 12 ms over 2^23 slots on
    the H100: PERF.md, PR 15)."""
    k = torch.arange(out_cap, dtype=torch.int64, device=m.device)
    return torch.searchsorted(offs, torch.minimum(k, offs[-1:] - 1),
                              right=True)


def _merged_side_counts(lkey, lvalid, rkey, rvalid, want_ids: bool):
    """Both sides' keys sorted together (kernel F; left before right
    within a key): per-group side counts (cl, cr) in the sorted layout,
    and with `want_ids` each slot's side index and key."""
    capL, capR = lkey.shape[0], rkey.shape[0]
    capT = capL + capR
    dev = lkey.device
    key = torch.cat([lkey, rkey])
    valid = torch.cat([lvalid, rvalid])
    tag = torch.cat([torch.zeros(capL, dtype=torch.int64, device=dev),
                     torch.ones(capR, dtype=torch.int64, device=dev)])
    dead = (~valid).to(torch.int64)
    if want_ids:
        sidx = torch.cat([torch.arange(capL, dtype=torch.int32, device=dev),
                          torch.arange(capR, dtype=torch.int32, device=dev)])
        sdead, skey64, stag, ssid = sort_ops(
            [dead, key, tag, sidx], 3, is_stable=True,
            dtypes=[UInt32, UInt64, UInt32, Int32])
        ssid = ssid.to(torch.int64)
    else:
        sdead, skey64, stag = sort_ops([dead, key, tag], 3, is_stable=True,
                                       dtypes=[UInt32, UInt64, UInt32])
        ssid = None
    live = sdead == 0
    newg = _changed(skey64) & live
    starts, ends, ngroups, _ = _group_bounds(newg, live)
    e1 = (ends - 1).clamp(0, capT - 1)
    cl_scan = _segscan(live & (stag == 0), newg)
    cr_scan = _segscan(live & (stag == 1), newg)
    gv = torch.arange(capT, device=dev) < ngroups
    cl = torch.where(gv, cl_scan[e1], 0)
    cr = torch.where(gv, cr_scan[e1], 0)
    return (capL, capR, capT, live, stag, ssid,
            skey64 if want_ids else None, starts, cl, cr, newg, ngroups)


def _join_emit_counts(cl: torch.Tensor, cr: torch.Tensor, how: str
                      ) -> torch.Tensor:
    """Output rows of each group for each join kind, unmatched rows
    included."""
    cl1 = cl.clamp(min=1)
    cr1 = cr.clamp(min=1)
    if how == "inner":
        return cl * cr
    if how == "left":
        return cl * cr1
    if how == "right":
        return cl1 * cr
    if how == "full":
        return cl * cr1 + torch.where(cl == 0, cr, 0)
    raise ValueError(f"join type {how!r}")


def local_join(lkey, lpay, lvalid, rkey, rpay, rvalid, out_cap: int,
               how: str = "inner"):
    """Per-slot inner/left/right/full join on packed u64 keys with a
    fixed output capacity (rows past it are lost: callers size it from
    `local_join_count`). Returns (jkey, lpay', rpay', jvalid, lmatch,
    rmatch) of capacity out_cap; lmatch/rmatch are False where that
    side of an output row is an unmatched fill."""
    (capL, capR, capT, live, stag, ssid, skey64, gstart, cl, cr,
     newg, ngroups) = _merged_side_counts(lkey, lvalid, rkey, rvalid, True)
    dev = lkey.device
    m = _join_emit_counts(cl, cr, how)
    offs = torch.cumsum(m, 0)
    k = torch.arange(out_cap, dtype=torch.int64, device=dev)
    gc = _expand_slots(m, offs, out_cap).clamp(0, capT - 1)
    base = offs[gc] - m[gc]
    r = k - base
    cl_g, cr_g = cl[gc], cr[gc]
    cl1_g = cl_g.clamp(min=1)
    cr1_g = cr_g.clamp(min=1)
    ones = torch.ones(out_cap, dtype=torch.bool, device=dev)
    if how in ("inner", "left"):
        i = r // cr1_g
        j = r % cr1_g
        lmatch = ones
        rmatch = ones if how == "inner" else cr_g > 0
    elif how == "right":
        j = r // cl1_g
        i = r % cl1_g
        rmatch = ones
        lmatch = cl_g > 0
    else:  # full
        main = cl_g * cr1_g
        in_main = r < main
        i = torch.where(in_main, r // cr1_g, 0)
        j = torch.where(in_main, r % cr1_g, r - main)
        lmatch = in_main & (cl_g > 0)
        rmatch = torch.where(in_main, cr_g > 0, True)
    lslot = (gstart[gc] + i).clamp(0, capT - 1)
    rslot = (gstart[gc] + cl_g + j).clamp(0, capT - 1)
    total = offs[capT - 1]
    jvalid = k < total
    lmatch = lmatch & jvalid
    rmatch = rmatch & jvalid
    lidx = ssid[lslot].clamp(0, capL - 1)
    ridx = ssid[rslot].clamp(0, capR - 1)
    jkey = torch.where(lmatch, skey64[lslot], skey64[rslot])
    return (jkey, [p[lidx] for p in lpay], [p[ridx] for p in rpay], jvalid,
            lmatch, rmatch)


def local_semi_flags(lkey, lvalid, rkey, rvalid, how: str) -> torch.Tensor:
    """Per-slot semi/anti flags aligned with the exchanged LEFT rows:
    True where the row survives (semi: it has a match; anti: it has
    none), written back to left-row order by one scatter."""
    (capL, capR, capT, live, stag, ssid, _, gstart, cl, cr,
     newg, ngroups) = _merged_side_counts(lkey, lvalid, rkey, rvalid, True)
    gid = (torch.cumsum(newg, 0) - 1).clamp(0, capT - 1)
    has_match = cr[gid] > 0
    want = has_match if how == "semi" else ~has_match
    sel = want & live & (stag == 0)
    # the right side's rows write to spill slots past capL
    wb = torch.where(stag == 0, ssid, spill_slots(capT, capL, lkey.device))
    out = torch.zeros(capL + SPILL, dtype=torch.bool, device=lkey.device)
    out.scatter_(0, wb, sel)
    return out[:capL]


def local_join_count(lkey, lvalid, rkey, rvalid, how: str = "inner"
                     ) -> torch.Tensor:
    """Per-slot join output-row count (the sizing pass before
    `local_join`), as a (1,) int64."""
    (_, _, _, _, _, _, _, _, cl, cr, _, _) = _merged_side_counts(
        lkey, lvalid, rkey, rvalid, False)
    return _join_emit_counts(cl, cr, how).sum()[None]


def make_sharded_join_count(mesh: Mesh, l_dest_cap: int, r_dest_cap: int,
                            how: str = "inner"):
    """fn(lkey, lvalid, rkey, rvalid) -> (S,) output-row counts per slot
    after both sides' key exchange (the caller reads them back to size
    the join's output)."""
    route_l = _router(mesh, l_dest_cap)
    route_r = _router(mesh, r_dest_cap)
    S = mesh.size

    def fn(lkey, lvalid, rkey, rvalid):
        lkey, lvalid, rkey, rvalid = _shard_all(mesh, lkey, lvalid, rkey,
                                                rvalid)
        lk, _, lv = route_l(_dests(mesh, lkey), lkey, [[]] * S, lvalid)
        rk, _, rv = route_r(_dests(mesh, rkey), rkey, [[]] * S, rvalid)
        return unshard_rows(mesh, map_slots(
            mesh, lambda a, b, c, d: local_join_count(a, b, c, d, how),
            lk, lv, rk, rv))
    return fn


def dest_hist(S: int, dest: torch.Tensor, valid: torch.Tensor
              ) -> torch.Tensor:
    """(S, S) int64: the valid records of each source shard (row //
    (cap / S)) bound for each destination; its max is the lossless
    per_dest_cap of an exchange, its column sums each slot's intake."""
    cap = dest.shape[0]
    src = torch.arange(cap, device=dest.device) // (cap // S)
    idx = torch.where(valid, src * S + dest.to(torch.int64), S * S)
    return torch.bincount(idx, minlength=S * S + 1)[:S * S].view(S, S)


def make_dest_hist(S: int):
    """fn(key, valid) -> the (S, S) histogram of hash routing
    (`dest_hist` of hash(key) % S): the exchange capacity is read from
    it exactly, where the reference engine samples."""
    def hist(key, valid):
        return dest_hist(S, _hash_u64(key) % S, valid)
    return hist


def _side_pays(S, pays):
    return [[p[s] for p in pays] for s in range(S)]


def make_sharded_join(mesh: Mesh, n_lpay: int, n_rpay: int,
                      per_dest_cap: int, out_cap: int,
                      r_per_dest_cap: int = None, how: str = "inner"):
    """The distributed join (inner/left/right/full): both sides
    exchanged by key hash, then `local_join` per slot. fn(lkey, lvalid,
    rkey, rvalid, *lpays, *rpays) -> (jkey, jvalid, lmatch, rmatch,
    dropped (S,), *lpays', *rpays'); a caller refuses a result with
    drops."""
    S = mesh.size
    r_cap = r_per_dest_cap if r_per_dest_cap is not None else per_dest_cap
    route_l = _router(mesh, per_dest_cap, with_overflow=True)
    route_r = _router(mesh, r_cap, with_overflow=True)

    def fn(lkey, lvalid, rkey, rvalid, *pays):
        lkey, lvalid, rkey, rvalid, *pays = _shard_all(
            mesh, lkey, lvalid, rkey, rvalid, *pays)
        lk, lp, lv, ldrop = route_l(_dests(mesh, lkey), lkey,
                                    _side_pays(S, pays[:n_lpay]), lvalid)
        rk, rp, rv, rdrop = route_r(_dests(mesh, rkey), rkey,
                                    _side_pays(S, pays[n_lpay:]), rvalid)

        def step(a, b, c, d, e, f):
            jk, lo, ro, jv, lm, rm = local_join(a, b, c, d, e, f, out_cap,
                                                how)
            return [jk, jv, lm, rm] + lo + ro
        res = _columns(map_slots(mesh, step, lk, lp, lv, rk, rp, rv))
        dropped = torch.stack([(a + b).to(mesh.home)
                               for a, b in zip(ldrop, rdrop)])
        return _gather_out(mesh, *res[:4]) + (dropped,) + \
            _gather_out(mesh, *res[4:])
    return fn


def _stable_partition(flag: torch.Tensor, arrays, out_cap: int):
    """The flagged rows first, in order, then the rest (a stable
    partition by one scatter), cut to out_cap rows: (flag', arrays')."""
    n = flag.shape[0]
    f = flag.to(torch.int64)
    c = torch.cumsum(f, 0)
    pos = torch.where(flag, c - 1,
                      f.sum() + torch.arange(n, device=flag.device) - c)
    outs = [torch.empty_like(a).scatter_(0, pos, a)[:out_cap]
            for a in [flag] + list(arrays)]
    return outs[0], outs[1:]


def make_sharded_semi(mesh: Mesh, per_dest_cap: int, r_per_dest_cap: int,
                      how: str, n_lpay: int, out_cap: int = None):
    """The distributed semi/anti join: left rows with their payloads and
    the right keys exchanged by key hash; per slot, the exchanged left
    rows and a survive flag. fn(lkey, lvalid, rkey, rvalid, *lpays) ->
    (flag, dropped (S,), *lpays'); `out_cap` moves each slot's survivors
    to a prefix and keeps out_cap rows of it."""
    S = mesh.size
    route_l = _router(mesh, per_dest_cap, with_overflow=True)
    route_r = _router(mesh, r_per_dest_cap, with_overflow=True)

    def fn(lkey, lvalid, rkey, rvalid, *lpay):
        lkey, lvalid, rkey, rvalid, *lpay = _shard_all(
            mesh, lkey, lvalid, rkey, rvalid, *lpay)
        lk, lp, lv, ldrop = route_l(_dests(mesh, lkey), lkey,
                                    _side_pays(S, lpay), lvalid)
        rk, _, rv, rdrop = route_r(_dests(mesh, rkey), rkey, [[]] * S,
                                   rvalid)

        def step(a, p, b, c, d):
            flag = local_semi_flags(a, b, c, d, how) & b
            if out_cap is not None and out_cap < a.shape[0]:
                flag, p = _stable_partition(flag, p, out_cap)
            return [flag] + list(p)
        res = _columns(map_slots(mesh, step, lk, lp, lv, rk, rv))
        dropped = torch.stack([(a + b).to(mesh.home)
                               for a, b in zip(ldrop, rdrop)])
        return (unshard_rows(mesh, res[0]), dropped) + \
            _gather_out(mesh, *res[1:])
    return fn


# ---------------------------------------------------------------------------
# distinct
# ---------------------------------------------------------------------------

def local_unique(key, rowidx, valid, keep: str) -> torch.Tensor:
    """Per-slot DISTINCT flags on packed u64 keys: True where the row is
    its group's representative. rowidx is the global row, so
    keep="first"/"last" mean what they mean on one device (equal keys
    were routed to one slot). Flags come back in row order."""
    cap = key.shape[0]
    dead = (~valid).to(torch.int64)
    pos = torch.arange(cap, dtype=torch.int32, device=key.device)
    sdead, skey, _, spos = sort_ops(
        [dead, key, rowidx.to(torch.int32), pos], 3, is_stable=True,
        dtypes=[UInt32, UInt64, Int32, Int32])
    live = sdead == 0
    newg = _changed(skey) & live
    nxt_live = torch.cat([live[1:], live.new_zeros(1)])
    run_end = (torch.cat([newg[1:], newg.new_ones(1)]) | ~nxt_live) & live
    if keep in ("any", "first"):
        rep = newg
    elif keep == "last":
        rep = run_end
    elif keep == "none":
        rep = newg & run_end
    else:
        raise ValueError(f"keep {keep!r}")
    out = torch.zeros(cap, dtype=torch.bool, device=key.device)
    return out.scatter_(0, spos.to(torch.int64), rep)


def make_sharded_unique(mesh: Mesh, per_dest_cap: int, keep: str,
                        n_pay: int, out_cap: int = None):
    """The distributed DISTINCT: rows with a global row index exchanged
    by the packed subset key; each slot flags its representatives.
    fn(key, valid, rowidx, *pays) -> (flag, dropped (S,), rowidx',
    *pays'); `out_cap` (from the histogram's per-slot intake) moves each
    slot's survivors to a prefix and keeps out_cap rows of it."""
    S = mesh.size
    route = _router(mesh, per_dest_cap, with_overflow=True)

    def fn(key, valid, rowidx, *pays):
        key, valid, rowidx, *pays = _shard_all(mesh, key, valid, rowidx,
                                               *pays)
        k2, p2, v2, dropped = route(
            _dests(mesh, key), key,
            [[rowidx[s]] + [p[s] for p in pays] for s in range(S)], valid)

        def step(k, p, v):
            flag = local_unique(k, p[0], v, keep) & v
            if out_cap is not None and out_cap < k.shape[0]:
                flag, p = _stable_partition(flag, p, out_cap)
            return [flag] + list(p)
        res = _columns(map_slots(mesh, step, k2, p2, v2))
        return (unshard_rows(mesh, res[0]),
                torch.stack([d.to(mesh.home) for d in dropped])) + \
            _gather_out(mesh, *res[1:])
    return fn
