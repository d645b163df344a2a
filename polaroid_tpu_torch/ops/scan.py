"""Scans for the order-dependent ops: segmented log-doubling scans and
the run geometry of sorted data.

The port of the JAX package's `_seg_scan_doubling` and
`_seg_scan_doubling_multi` (`ops/groupby.py`), which the windows use:
an inclusive scan as log2(n) steps of shift + combine + select, each
step combining a row with the row 2^k before it when both lie in one
segment. A float sum then adds along a tree of depth log2(n), so its
error grows with the depth, not with the magnitude of a global prefix;
a segmented `cum_sum` cannot be a global `cumsum` minus each run's base,
which cancels far past the windows' tolerance over 10^7 rows. torch has
no `associative_scan`; these are torch ops, not a kernel (no Pallas
kernel stands behind them in the JAX package).

`run_starts` finds where runs of sorted data start by one compaction
(kernel B, `cuda_partition.compact_words`) of the row positions: a
row's run start is then a gather by its run id, with no `cummax` (a 1-D
`torch.cummax` of 2^24 int64 takes about 49 ms on an H100).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .cuda_partition import compact_words

__all__ = ["seg_scan", "seg_scan_multi", "run_starts", "reverse_scan"]


def seg_scan(v: torch.Tensor, seg: Optional[torch.Tensor],
             op: Callable, span: Optional[int] = None) -> torch.Tensor:
    """Inclusive scan of `v` by the associative, commutative `op`
    (torch.add, torch.minimum, torch.maximum, torch.mul), restarting
    where `seg` changes (segments are runs of equal `seg`); seg None is
    one segment. `span` bounds the length of the segments that matter:
    the scan then takes ceil(log2(span)) steps, not log2(n)."""
    n = v.shape[0]
    end = n if span is None else min(n, span)
    k = 1
    while k < end:
        cur = v[k:]
        comb = op(v[:-k], cur)
        if seg is not None:
            comb = torch.where(seg[k:] == seg[:-k], comb, cur)
        v = torch.cat([v[:k], comb])
        k <<= 1
    return v


def seg_scan_multi(arrs: Sequence[torch.Tensor],
                   seg: Optional[torch.Tensor],
                   combine: Callable, span: Optional[int] = None
                   ) -> List[torch.Tensor]:
    """Inclusive segmented scan over a tuple of arrays with an
    associative combine(earlier, later) -> combined: the log-doubling
    form of a linear recurrence (the ewm's (decay, numerator,
    denominator) triples). `span` as in seg_scan."""
    arrs = list(arrs)
    n = arrs[0].shape[0]
    end = n if span is None else min(n, span)
    k = 1
    while k < end:
        prev = [a[:-k] for a in arrs]
        cur = [a[k:] for a in arrs]
        new = combine(prev, cur)
        if seg is not None:
            same = seg[k:] == seg[:-k]
            new = [torch.where(same, x, c) for x, c in zip(new, cur)]
        arrs = [torch.cat([a[:k], x]) for a, x in zip(arrs, new)]
        k <<= 1
    return arrs


def reverse_scan(v: torch.Tensor, seg: Optional[torch.Tensor],
                 op: Callable, span: Optional[int] = None) -> torch.Tensor:
    """The scan from each segment's end back to its start."""
    flip = None if seg is None else seg.flip(0)
    return seg_scan(v.flip(0), flip, op, span).flip(0)


def run_starts(new: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Runs of rows marked by `new` (True where a run starts; row 0
    should be marked): (run id of each row (int64, -1 before the first
    mark), each run's start position (int64, garbage past the run
    count), the start of each row's run and the start of the next run
    (the row count after the last run)). One kernel-B compaction, a
    prefix sum and two gathers; no host sync."""
    n = new.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=new.device)
    (starts,), nruns = compact_words(new, [idx])
    rid = torch.cumsum(new, 0) - 1
    ridc = rid.clamp(0, n - 1)
    start = torch.where(rid >= 0, starts[ridc], 0)
    nxt_id = rid + 1
    nxt = torch.where(nxt_id < nruns, starts[nxt_id.clamp(0, n - 1)], n)
    return rid, starts, start, nxt
