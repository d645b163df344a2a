"""Reductions over per-row ranges [lo_i, hi_i) of a column.

The port of the JAX package's `ops/range_agg.py`, which the range
windows (`rolling_*_by`, `group_by_dynamic`'s and `rolling`'s windows)
reduce with. Min and max come from a sparse table, each range from two
overlapping power-of-two blocks.

Sums differ from the JAX package's: it takes one prefix sum of the whole
column and subtracts (`prefix_range_sum`, kept here), so a window's sum
cancels against the column's prefix (over 2^23 prices of [1, 200) its
error reaches about 2^-53 · 1.7·10^9, and one NaN spoils every later
window). Here a range's sum adds the disjoint power-of-two blocks of its
binary decomposition from sum levels built like the sparse table
(`build_sum_levels`, `range_sum`): its error depends on its own terms
only (at most about 2·⌈log2 w⌉·2^-53·Σ|x| of its w rows in float64),
and a NaN spoils only the ranges that hold it. Integer sums and counts
stay one prefix sum (`window_sum`): they are exact either way.

Both tables build only as many levels as the longest range needs: the
caller passes that length (one readback). The searches stop early the
same way: `segmented_searchsorted` takes ⌈log2 of the longest segment⌉
+ 1 rounds (and where a group id and the searched values fit one int64
together, `window_over.range_bounds` needs only one `torch.searchsorted`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["levels_for", "build_sparse", "range_query", "build_sum_levels",
           "range_sum", "window_sum", "prefix_range_sum",
           "segmented_searchsorted", "floor_log2"]


def levels_for(longest: int) -> int:
    """Levels of a table whose ranges hold at most `longest` rows:
    floor(log2(longest)) + 1 (level k reduces 2^k rows)."""
    return max(int(longest), 1).bit_length()


def floor_log2(length: torch.Tensor) -> torch.Tensor:
    """floor(log2(length)) of positive int64 lengths, exactly (frexp of
    a power of two is exact); 0 for a length of 0."""
    _, e = torch.frexp(length.clamp(min=1).to(torch.float64))
    return (e - 1).to(torch.int64)


def _pad_tail(x: torch.Tensor, k: int, ident) -> torch.Tensor:
    """x moved k rows earlier, `ident` in the last k rows."""
    n = x.shape[0]
    fill = torch.full((min(k, n),), ident, dtype=x.dtype, device=x.device)
    return torch.cat([x[k:], fill]) if k < n else fill[:n]


def build_sparse(x: torch.Tensor, kind: str, nlevels: Optional[int] = None,
                 ident=None) -> torch.Tensor:
    """Sparse table (nlevels, n): row k holds reduce(x[i : i + 2^k]) for
    kind "min" or "max" (past the end, `ident` pads). nlevels defaults to
    every level that fits n."""
    n = x.shape[0]
    if nlevels is None:
        nlevels = levels_for(n)
    if ident is None:
        from ..expr.eval import _type_bounds
        lo_b, hi_b = _type_bounds(x.dtype)
        ident = hi_b if kind == "min" else lo_b
    fn = torch.minimum if kind == "min" else torch.maximum
    levels = torch.empty((nlevels, n), dtype=x.dtype, device=x.device)
    levels[0] = x
    for k in range(1, nlevels):
        fn(levels[k - 1], _pad_tail(levels[k - 1], 1 << (k - 1), ident),
           out=levels[k])
    return levels


def range_query(levels: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                kind: str, empty_val) -> torch.Tensor:
    """reduce(x[lo:hi]) per row from a sparse table (two overlapping
    blocks of 2^k rows, k = floor(log2(hi - lo))); an empty range gives
    `empty_val`. Every range must hold at most 2^len(levels) - 1 rows."""
    fn = torch.minimum if kind == "min" else torch.maximum
    nl, n = levels.shape
    length = (hi - lo).clamp(min=0)
    k = floor_log2(length).clamp(max=nl - 1)
    a = lo.clamp(0, n - 1)
    b = (hi - (1 << k)).clamp(0, n - 1)
    r = fn(levels[k, a], levels[k, b])
    return torch.where(length > 0, r, torch.full_like(r, empty_val))


def build_sum_levels(x: torch.Tensor, nlevels: int) -> torch.Tensor:
    """Sum levels (nlevels, n): row k holds sum(x[i : i + 2^k]) as a
    pairwise tree (zero past the end)."""
    levels = torch.empty((nlevels,) + x.shape, dtype=x.dtype,
                         device=x.device)
    levels[0] = x
    for k in range(1, nlevels):
        torch.add(levels[k - 1], _pad_tail(levels[k - 1], 1 << (k - 1), 0),
                  out=levels[k])
    return levels


def range_sum(levels: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
              ) -> torch.Tensor:
    """sum(x[lo:hi]) per row: the blocks of the length's binary
    decomposition, largest first, each one gather from its level; 0 for
    an empty range. Every range must hold at most 2^len(levels) - 1
    rows."""
    nl, n = levels.shape
    length = (hi - lo).clamp(min=0)
    pos = lo.clamp(0, n - 1)
    acc = torch.zeros(lo.shape, dtype=levels.dtype, device=levels.device)
    for k in range(nl - 1, -1, -1):
        take = ((length >> k) & 1).bool()
        blk = levels[k, pos.clamp(max=n - 1)]
        acc = acc + torch.where(take, blk, torch.zeros_like(blk))
        pos = pos + (take.to(pos.dtype) << k)
    return acc


def window_sum(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
               nlevels: int) -> torch.Tensor:
    """sum(x[lo:hi]) per row as the windows need it: an integer sum by
    one prefix sum (exact: a difference of two's-complement prefixes is
    the window's sum whenever that sum fits), a float sum from its own
    blocks of `nlevels` sum levels."""
    if not x.is_floating_point():
        return prefix_range_sum(x.to(torch.int64), lo, hi)
    return range_sum(build_sum_levels(x, nlevels), lo, hi)


def prefix_range_sum(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
                     ) -> torch.Tensor:
    """sum(x[lo:hi]) per row by one prefix sum of the whole column (the
    JAX package's method; exact for integers)."""
    cs = torch.cumsum(x, 0)
    n = x.shape[0]
    hi_s = cs[(hi - 1).clamp(0, n - 1)]
    lo_s = torch.where(lo > 0, cs[(lo - 1).clamp(0, n - 1)],
                       torch.zeros_like(hi_s))
    return torch.where(hi > lo, hi_s - lo_s, torch.zeros_like(hi_s))


def segmented_searchsorted(sorted_vals: torch.Tensor,
                           grp_start: torch.Tensor, grp_end: torch.Tensor,
                           queries: torch.Tensor, side: str = "left",
                           span: Optional[int] = None) -> torch.Tensor:
    """Each query's binary search restricted to [grp_start_i,
    grp_end_i): ⌈log2(span)⌉ + 1 rounds of gathers, `span` the longest
    segment (the column's length by default)."""
    n = sorted_vals.shape[0]
    longest = n if span is None else span
    rounds = max(1, int(math.ceil(math.log2(max(longest, 2)))) + 1)
    lo, hi = grp_start, grp_end
    for _ in range(rounds):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        mv = sorted_vals[mid.clamp(0, n - 1)]
        go = (mv <= queries) if side == "right" else (mv < queries)
        cont = lo < hi
        lo = torch.where(go & cont, mid + 1, lo)
        hi = torch.where(~go & cont, mid, hi)
    return lo

