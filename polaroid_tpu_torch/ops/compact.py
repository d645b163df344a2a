"""Device-side row compaction and gather.

The port of the JAX package's `ops/compact.py`. Compaction moves the live
rows of every column to a stable front prefix with ONE call of the
compaction kernel (`cuda_partition.compact_words`) carrying every column
as 4-byte words:
* 4-byte columns go as they are;
* 8-byte columns go as their two 4-byte halves, strided views of
  `data.view(torch.int32)`, and come back bit for bit (the JAX package
  needs a compensated (hi, lo) f32 pair there because a TPU holds f64 as
  f32; the port does not);
* 1- and 2-byte columns and validity masks are widened to int32.
The live count stays on the device (`nrows_dev`), so `collect()` makes no
host sync.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..batch import Column, Table
from ..config import capacity_for
from .cuda_partition import compact_words


def gather_table(table: Table, perm: torch.Tensor, nrows: Optional[int],
                 valid: Optional[torch.Tensor]) -> Table:
    """Gather every column by `perm`; the caller supplies the new live
    state."""
    cols = {name: table.cols[name].take(perm) for name in table.names}
    return Table(list(table.names), cols, table.capacity, nrows, valid,
                 device=table.device)


def _words(x: torch.Tensor) -> List[torch.Tensor]:
    if x.element_size() == 8:
        w = x.view(torch.int32)
        return [w[0::2], w[1::2]]
    if x.element_size() == 4:
        return [x]
    return [x.to(torch.int32)]


def _unwords(ws: List[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    if dtype.itemsize == 8:
        # the two halves are strided views of one buffer (see
        # cuda_partition._mirror_outputs): view it back as 8-byte values
        n = ws[0].shape[0]
        return ws[0].as_strided((n, 2), (2, 1)).view(dtype).view(n)
    if dtype.itemsize == 4:
        return ws[0]
    if dtype == torch.bool:
        return ws[0] != 0
    return ws[0].to(dtype)


def _compact_prefix(table: Table, mask: torch.Tensor
                    ) -> Tuple[Table, torch.Tensor]:
    """(table with its live rows as a stable prefix, device live count)."""
    words, layout = [], []
    for name in table.names:
        c = table.cols[name]
        ws = _words(c.data)
        hasv = c.validity is not None
        if hasv:
            ws.append(c.validity.to(torch.int32))
        layout.append((name, c, len(ws) - int(hasv), hasv))
        words.extend(ws)
    if not words:
        return table, mask.sum()
    outs, count = compact_words(mask, words)
    cols = {}
    wi = 0
    for name, c, nw, hasv in layout:
        data = _unwords(outs[wi:wi + nw], c.data.dtype)
        wi += nw
        validity = None
        if hasv:
            validity = outs[wi] != 0
            wi += 1
        cols[name] = Column(c.dtype, data, validity, c.sdict)
    return Table(list(table.names), cols, table.capacity, None, None,
                 device=table.device), count


def compact(table: Table) -> Table:
    """A compact-state table (live rows form a front prefix, same
    capacity), with the row count left on the device as `nrows_dev`."""
    if table.valid is None:
        return table
    out, count = _compact_prefix(table, table.valid)
    return out.with_valid(None, None, nrows_dev=count)


def compact_device(table: Table) -> Tuple[Table, torch.Tensor]:
    """(table with its live rows as a prefix, device live count)."""
    return _compact_prefix(table, table.row_mask())


def shrink_to(table: Table, nrows: int) -> Table:
    """Re-bucket a compact table to the smallest capacity holding nrows."""
    cap = capacity_for(nrows)
    if cap >= table.capacity:
        return table.with_valid(None, nrows)
    cols = {name: Column(c.dtype, c.data[:cap],
                         c.validity[:cap] if c.validity is not None
                         else None, c.sdict)
            for name, c in table.cols.items()}
    return Table(list(table.names), cols, cap, nrows, None,
                 device=table.device)


def slice_rows(table: Table, offset: int, length: Optional[int]) -> Table:
    """head/tail/slice on live rows. Negative offset counts from the end."""
    t = compact(table)
    n = t.nrows or 0
    if offset < 0:
        offset = max(n + offset, 0)
    end = n if length is None else min(offset + length, n)
    offset = min(offset, n)
    end = max(end, offset)
    new_n = end - offset
    if offset == 0:
        return shrink_to(t, new_n) if new_n < n else t.with_valid(None, new_n)
    cols = {name: Column(c.dtype, torch.roll(c.data, -offset, 0),
                         torch.roll(c.validity, -offset, 0)
                         if c.validity is not None else None, c.sdict)
            for name, c in t.cols.items()}
    out = Table(list(t.names), cols, t.capacity, new_n, None,
                device=t.device)
    return shrink_to(out, new_n)
