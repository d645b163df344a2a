"""Wavelet-tree rank and select over row ranges.

The port of the JAX package's `ops/wavelet.py`: the order statistics of
variable windows (`rolling_quantile_by`, `rolling_median_by`,
`rolling_rank_by`) without a loop per window. The tree is built once
over the column's rank space, L = ceil(log2(n)) levels, each a prefix
count of zero bits and a stable partition of the ranks by that bit (a
scatter), and every row's query then walks the L levels with two
gathers each.

* `wavelet_select(k)`: the rank of the k-th smallest element of
  [lo_i, hi_i) (quantiles);
* `wavelet_count_lt(key)`: how many elements of [lo_i, hi_i) have a
  rank below key_i (ranks).

Ranks are distinct (a stable argsort), so equal values hold a contiguous
interval of ranks, and a rank query asks both of its edges.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

__all__ = ["build_wavelet", "wavelet_select", "wavelet_count_lt"]


def build_wavelet(ranks: torch.Tensor, universe: Optional[int] = None
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The level tables of `ranks` (integers in [0, universe), n by
    default; distinct within every range that is queried): per level,
    most significant bit first, (Z, total zeros) with Z the exclusive
    prefix count of zero bits in that level's order (n + 1 entries:
    Z[hi] - Z[lo] counts the zeros of [lo, hi))."""
    n = ranks.shape[0]
    u = n if universe is None else universe
    levels = max(1, int(math.ceil(math.log2(max(u, 2)))))
    vals = ranks.to(torch.int32)
    pos = torch.arange(n, dtype=torch.int32, device=ranks.device)
    tables = []
    for lvl in range(levels):
        bit = (vals >> (levels - 1 - lvl)) & 1
        Z = torch.zeros(n + 1, dtype=torch.int32, device=ranks.device)
        torch.cumsum(bit == 0, 0, dtype=torch.int32, out=Z[1:])
        tz = Z[n]
        tables.append((Z, tz))
        if lvl + 1 < levels:
            # stable partition: the zeros keep their order, then the ones
            zb = Z[:n]
            dest = torch.where(bit == 0, zb, tz + (pos - zb)).long()
            vals = torch.empty_like(vals).scatter_(0, dest, vals)
    return tables


def wavelet_select(tables, lo: torch.Tensor, hi: torch.Tensor,
                   k: torch.Tensor) -> torch.Tensor:
    """The rank of the k-th smallest element (from 0) of [lo_i, hi_i),
    per row (int64). The caller keeps lo < hi and 0 <= k < hi - lo. The
    walk runs in int32 (positions are below 2^31), half the bytes of
    int64 per level."""
    levels = len(tables)
    lo, hi, k = lo.int(), hi.int(), k.int()
    res = torch.zeros_like(k)
    for lvl, (Z, tz) in enumerate(tables):
        zlo, zhi = Z.index_select(0, lo), Z.index_select(0, hi)
        cz = zhi - zlo
        left = k < cz
        lo = torch.where(left, zlo, tz + (lo - zlo))
        hi = torch.where(left, zhi, tz + (hi - zhi))
        k = torch.where(left, k, k - cz)
        res = res | torch.where(left, 0, 1 << (levels - 1 - lvl))
    return res.long()


def wavelet_count_lt(tables, lo: torch.Tensor, hi: torch.Tensor,
                     key: torch.Tensor) -> torch.Tensor:
    """How many elements of [lo_i, hi_i) have a rank below key_i (int64;
    the walk runs in int32)."""
    levels = len(tables)
    lo, hi, key = lo.int(), hi.int(), key.int()
    acc = torch.zeros_like(lo)
    for lvl, (Z, tz) in enumerate(tables):
        bit = (key >> (levels - 1 - lvl)) & 1
        zlo, zhi = Z.index_select(0, lo), Z.index_select(0, hi)
        cz = zhi - zlo
        acc = acc + torch.where(bit == 1, cz, 0)
        left = bit == 0
        lo = torch.where(left, zlo, tz + (lo - zlo))
        hi = torch.where(left, zhi, tz + (hi - zhi))
    return acc.long()
