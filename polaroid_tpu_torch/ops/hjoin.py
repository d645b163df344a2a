"""Hash-collocate join: the exchange-based equi-join of 31-bit keys.

The port of the JAX package's `ops/hjoin.py`. Build (right) and probe
(left) rows meet with no hash table:

  1. ``w = mix31(key) << 1 | side``: `mix31` is a bijection of
     [0, 2^31), so equal high 31 bits of w mean equal keys, and within a
     key's run the build rows (side 0) sort before the probe rows. A key
     above 2^31 - 1 is refused (`ok` False) and the caller takes another
     route.
  2. Per block of S = 8192 rows: the live rows of each (block, bucket)
     are counted (bucket = the top 5 bits of w) and the block's rows are
     grouped by bucket, by one stable `torch.sort` of the 8-bit bucket
     along dim 1 (the JAX package sorts each block by w with `lax.sort`).
  3. `bucket_exchange` (kernel E, csrc/exchange.cu) moves every run into
     the padded [K, B * CAP] bucket-major layout; a cell past CAP rows
     is refused.
  4. One sort of each bucket row by w (as int32 with the sign bit
     flipped) makes each key's rows one run, build rows first.
  5. Runs are numbered by one prefix sum over the layout; each run's
     first slot, when it is a build row, writes that row into a table by
     run id, and every slot of the run reads it back: an exact fill of
     runs of any length.

The exchange moves two words, w and the row each slot came from, as the
port's hash group-by does (`ops/hgroup.py`). Every output column is then
gathered by the probe row or by the filled build row, so Float64 and
Int64 columns keep all their bits, whatever their width. The JAX package
instead carries every payload word through the block sorts, the exchange
and the bucket sorts (with an offset encoding of 8-byte keys and paired
transport slots), and fills runs with an 8-step doubling ladder that a
`lax.cond` upgrades to an exact u64 cummax (`hjoin.py:119-219`); the
H100 has no gather penalty that would call for that. A `torch.cummax`
along the bucket rows, the first design here, took 4.7 ms of H2O q5's
busy time on the card, and the prefix sum along them 2.9 ms; the 1-D
prefix sum, scatter and gather that replace them are each a pass at
memory speed.

Other differences from the JAX package, each held by a test:
* a pad slot is told from a live row by its row word, not by w, so a
  probe key whose w is 0xFFFFFFFF (mix31(key) = 2^31 - 1) still joins;
* a Float32 key joins on its bits, as the sort-merge route does:
  -0.0 and 0.0 are different keys on every route;
* a left join keeps its left rows with null keys (with null right
  columns); the JAX package's collocated route drops them;
* `collocated_join` returns the output compacted by kernel B: a join of
  unique right keys gives at most one row per live left row, so the
  table has the left side's capacity (a power of two), with its row
  count on the device.

Words are held as int64 in [0, 2^32) everywhere except in the exchange,
which takes 4-byte int32 bit patterns.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .cuda_partition import compact_words
from .exchange import CAP, S, bucket_exchange
from .hashing import U32_MASK
from .hgroup import _from_word, _to_word, cell_extents
from .segment import SPILL, spill_slots

__all__ = ["mix31", "mix31_inv", "collocate", "run_fill",
           "lookup_join_collocated", "collocated_join", "FILL"]

_M31 = (1 << 31) - 1
# odd multipliers are units mod 2^31; each xorshift is invertible
_C1 = 0x65EBCA6B
_C2 = 0x42B2AE35
_C1_INV = pow(_C1, -1, 1 << 31)
_C2_INV = pow(_C2, -1, 1 << 31)
FILL = 0xFFFFFFFF
# sorts a dead row after every live w in its block
_DEAD = 1 << 32
# the int32 sign bit: x ^ _SIGN32 orders int32 bit patterns as u32 values
_SIGN32 = -(1 << 31)


def mix31(x: torch.Tensor) -> torch.Tensor:
    """Bijective mixer on [0, 2^31) (int64 in, int64 out): equal outputs,
    equal inputs. Each product of two 31-bit values fits in int64."""
    x = x.to(torch.int64) & _M31
    x = x ^ (x >> 16)
    x = (x * _C1) & _M31
    x = x ^ (x >> 13)
    x = (x * _C2) & _M31
    return x ^ (x >> 16)


def mix31_inv(h: torch.Tensor) -> torch.Tensor:
    h = h.to(torch.int64) & _M31
    h = h ^ (h >> 16)
    h = (h * _C2_INV) & _M31
    h = h ^ (h >> 13) ^ (h >> 26)
    h = (h * _C1_INV) & _M31
    return h ^ (h >> 16)


class Collocated(NamedTuple):
    w: torch.Tensor      # (K, L) int64: each slot's w, sorted per bucket row
    src: torch.Tensor    # (K, L) int64: the row each slot holds, -1 for pads
    nb: int              # build rows; a probe row i is src nb + i
    ok: torch.Tensor     # bool scalar: no key past 2^31 - 1, no cell past CAP


def collocate(bkey: torch.Tensor, pkey: torch.Tensor,
              bvalid: Optional[torch.Tensor] = None,
              pvalid: Optional[torch.Tensor] = None) -> Collocated:
    """Collocate build and probe rows by key: bkey and pkey are u32 key
    values as int64 (a valid key above 2^31 - 1 sets `ok` False);
    bvalid/pvalid mark the rows that take part. Rows are numbered build
    first, then probe. Within a bucket row every key is one run of
    slots, its build rows first."""
    nb, npr = bkey.shape[0], pkey.shape[0]
    n = nb + npr
    B = max(-(-n // S), 1)
    dev = bkey.device
    key = torch.cat([bkey, pkey]).to(torch.int64)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    if bvalid is not None:
        live[:nb] = bvalid
    if pvalid is not None:
        live[nb:] = pvalid
    badk = (live & ((key < 0) | (key > _M31))).any()
    side = (torch.arange(n, device=dev) >= nb).to(torch.int64)
    w = torch.where(live, (mix31(key) << 1) | side,
                    torch.full_like(key, _DEAD))
    if B * S != n:
        w = torch.cat([w, w.new_full((B * S - n,), _DEAD)])
    counts, starts = cell_extents(w, w != _DEAD)
    ok = (counts.max() <= CAP) & ~badk
    # the exchange needs each block's rows grouped by bucket, not sorted:
    # one stable sort of the 8-bit bucket (32 for dead rows) per block
    digit = torch.where(w != _DEAD, w >> 27, torch.full_like(w, 32))
    order = torch.sort(digit.to(torch.uint8).view(B, S), dim=1,
                       stable=True).indices
    ws = w.view(B, S).gather(1, order)
    rows = order + torch.arange(B, dtype=torch.int64, device=dev)[:, None] * S
    wx, rx = bucket_exchange(starts, counts,
                             [_to_word(ws).reshape(-1),
                              rows.to(torch.int32).reshape(-1)],
                             (FILL, FILL))
    # sorted as int32 with the sign bit flipped, which orders the words
    # as u32 values (half the radix passes of an int64 sort)
    skey, perm = torch.sort(wx ^ _SIGN32, dim=1)
    return Collocated(_from_word(skey ^ _SIGN32),
                      rx.gather(1, perm).to(torch.int64), nb, ok)


def run_fill(w: torch.Tensor, src: torch.Tensor):
    """(build, has_build), each (K, L): the row of each slot's run's
    first slot when that slot is a build row (the m:1 build row), and
    whether the run has one. Runs are numbered across the whole layout
    by one prefix sum; each run's first slot writes its build row into a
    table by run id (one scatter) and every slot reads its run's entry
    (one gather), so a run of any length fills exactly."""
    h = w >> 1
    flag = torch.ones_like(h, dtype=torch.bool)
    flag[:, 1:] = h[:, 1:] != h[:, :-1]
    rid = torch.cumsum(flag.reshape(-1), 0) - 1
    first_build = (flag & (src >= 0) & ((w & 1) == 0)).reshape(-1)
    M = rid.shape[0]
    table = torch.full((M + SPILL,), -1, dtype=torch.int64, device=w.device)
    table.scatter_(0, torch.where(first_build, rid,
                                  spill_slots(M, M, w.device)),
                   src.reshape(-1))
    build = table[rid].view_as(w)
    return build.clamp(min=0), build >= 0


def lookup_join_collocated(bkey: torch.Tensor, bval: torch.Tensor,
                           pkey: torch.Tensor):
    """The JAX package's kernel-level join contract: returns (pidx (M,),
    value (M,) float32, hit (M,), live (M,), ok) with probe rows in
    collocated (unaligned) order; `live` marks the probe slots, `hit`
    those whose key has a build row. ok False: the caller must take
    another route."""
    col = collocate(bkey, pkey)
    build, has_build = run_fill(col.w, col.src)
    is_probe = (col.src >= 0) & ((col.w & 1) == 1)
    hit = has_build & is_probe
    nb = col.nb
    value = bval.to(torch.float32)[build.clamp(0, max(nb - 1, 0))]
    value = torch.where(hit, value, torch.zeros_like(value))
    pidx = torch.where(is_probe, col.src - nb, torch.zeros_like(col.src))
    return (pidx.reshape(-1), value.reshape(-1), hit.reshape(-1),
            is_probe.reshape(-1), col.ok)


def _key_word(v, cap: int, base: int):
    """A key Val's u32 word as int64, or None when the key does not ride
    one word (as in the JAX package: narrower than 4 bytes, Float64,
    Boolean): 4-byte keys by their bits (Float32 too, so a negative one
    sets `ok` False), 8-byte integers as key - base (a live value outside
    [base, base + 2^31) sets `ok` False)."""
    data = v.data.expand(cap)
    name = repr(v.dtype)
    if name == "Float32":
        return data.contiguous().view(torch.int32).to(torch.int64) & U32_MASK
    if v.dtype.is_integer:
        bits = v.dtype.bit_width()
        if bits == 64:
            return data.to(torch.int64) - base
        if bits < 32:
            return None
    elif not (v.dtype.is_string or name == "Date"):
        return None
    # Int32, UInt32 (held in int64), dictionary codes and dates
    return data.to(torch.int64) & U32_MASK


def collocated_join(left, right, left_on, right_on, how: str, suffix: str,
                    coalesce: bool, lv, rv, lmask, rmask):
    """Inner/left join on one key whose right values are unique, as the
    JAX package's `collocated_join` contract: returns (Table, ok), where
    `ok` is a device scalar the caller reads once; False means a key past
    31 bits, an exchange cell past CAP or a duplicate right key, and the
    table is garbage. Returns None when the join is statically
    ineligible (another kind, several keys, a key type that does not
    ride one word, a range of 8-byte keys wider than 2^31, or output
    names that collide). Output rows come in collocated order."""
    from ..batch import Column, Table
    from .join import _int_key_stats, _propagate_join_stats, _right_columns
    if how not in ("inner", "left") or len(lv) != 1:
        return None
    capL, capR = left.capacity, right.capacity
    key_base = 0
    if all(v.dtype.is_integer and v.dtype.bit_width() == 64
           for v in (lv[0], rv[0])):
        lmn, lmx = _int_key_stats(left, left_on[0], lv[0])
        rmn, rmx = _int_key_stats(right, right_on[0], rv[0])
        mn, mx = min(lmn, rmn), max(lmx, rmx)
        if mn < 0 or mx > _M31:
            if mx - mn > _M31:
                return None
            key_base = mn
    pk = _key_word(lv[0], capL, key_base)
    bk = _key_word(rv[0], capR, key_base)
    if pk is None or bk is None:
        return None
    sources = {}
    rnames = _right_columns(left, right, right_on, coalesce, suffix,
                            sources)
    names = list(left.names) + [name for _, name in rnames]
    if len(set(names)) != len(names):
        return None

    col = collocate(bk, pk, rmask, lmask)
    w, src, nb = col.w, col.src, col.nb
    is_build = (src >= 0) & ((w & 1) == 0)
    h = w >> 1
    dup = (is_build[:, 1:] & is_build[:, :-1] & (h[:, 1:] == h[:, :-1])).any()
    ok = col.ok & ~dup
    build, has_build = run_fill(w, src)
    is_probe = (src >= 0) & ((w & 1) == 1)
    keep = is_probe & has_build if how == "inner" else is_probe
    lrow = (src - nb).reshape(-1)
    rrow = build.reshape(-1)
    hit = has_build.reshape(-1)
    keep = keep.reshape(-1)
    if how == "left":
        # live left rows whose key is null take no part in the exchange,
        # and come out once each with null right columns
        extra = left.row_mask() & ~lmask
        idx = torch.arange(capL, dtype=torch.int64, device=lrow.device)
        lrow = torch.cat([lrow, idx])
        rrow = torch.cat([rrow, torch.zeros_like(idx)])
        hit = torch.cat([hit, torch.zeros_like(extra)])
        keep = torch.cat([keep, extra])
    # at most one output row per live left row: the first capL slots of
    # the compaction hold them all
    (lo, ro, ho), count = compact_words(keep, [lrow, rrow,
                                               hit.to(torch.int32)])
    lidx = lo[:capL].clamp(0, capL - 1)
    ridx = ro[:capL].clamp(0, capR - 1)
    rmatch = ho[:capL] != 0
    cols = {n: left.cols[n].take(lidx) for n in left.names}
    for n, name in rnames:
        c = right.cols[n].take(ridx)
        validity = rmatch if c.validity is None else c.validity & rmatch
        cols[name] = Column(c.dtype, c.data, validity, c.sdict)
    out = Table(names, cols, capL, None, None, nrows_dev=count,
                device=left.device)
    _propagate_join_stats(out, sources)
    return out, ok
