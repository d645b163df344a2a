"""Device-side row compaction and gather.

The port of the JAX package's `ops/compact.py`. Compaction moves the live
rows of every column to a stable front prefix with ONE call of the
compaction kernel (`cuda_partition.compact_words`) carrying every column
as one word:
* 4-byte columns go as they are;
* 8-byte columns go as one int64 view and come back bit for bit (the JAX
  package splits them into 4-byte halves, and needs a compensated
  (hi, lo) f32 pair for f64 because a TPU holds f64 as f32; the port
  does not);
* 1- and 2-byte columns and validity masks are widened to int32.
The live count stays on the device (`nrows_dev`), so `collect()` makes no
host sync.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def _word(x: torch.Tensor) -> torch.Tensor:
    if x.element_size() == 8:
        return x.view(torch.int64)
    if x.element_size() == 4:
        return x
    return x.to(torch.int32)


def _unword(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype.itemsize in (4, 8):
        return w.view(dtype)
    if dtype == torch.bool:
        return w != 0
    return w.to(dtype)


def _compact_prefix(table: Table, mask: torch.Tensor
                    ) -> Tuple[Table, torch.Tensor]:
    """(table with its live rows as a stable prefix, device live count)."""
    words = []
    nested = [n for n in table.names if table.cols[n].is_nested]
    for name in table.names:
        c = table.cols[name]
        if c.is_nested:
            continue
        words.append(_word(c.data))
        if c.validity is not None:
            words.append(c.validity.to(torch.int32))
    if nested:
        # a nested column moves by its rows' positions, compacted as one
        # more word, and one gather of each of its tensors
        words.append(torch.arange(table.capacity, dtype=torch.int32,
                                  device=mask.device))
    if not words:
        return table, mask.sum()
    outs, count = compact_words(mask, words)
    rows = outs[-1].long().clamp(0, table.capacity - 1) if nested else None
    cols = {}
    it = iter(outs)
    for name in table.names:
        c = table.cols[name]
        if c.is_nested:
            cols[name] = c.take(rows)
            continue
        data = _unword(next(it), c.data.dtype)
        validity = next(it) != 0 if c.validity is not None else None
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
    cols = {name: c.map_rows(lambda x: x[:cap])
            for name, c in table.cols.items()}
    return Table(list(table.names), cols, cap, nrows, None,
                 device=table.device)


def grow_to(table: Table, capacity: int) -> Table:
    """Pad a table to a larger capacity bucket (pad rows are dead; a
    string pad holds the null code)."""
    if capacity <= table.capacity:
        return table
    pad = capacity - table.capacity

    def grown(x: torch.Tensor, fill) -> torch.Tensor:
        return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])

    cols = {name: c.map_rows(lambda x: grown(x, 0)) if c.is_nested else
            Column(c.dtype, grown(c.data, -1 if c.dtype.is_string else 0),
                   None if c.validity is None
                   else grown(c.validity, False), c.sdict)
            for name, c in table.cols.items()}
    valid = None if table.valid is None else grown(table.valid, False)
    return Table(list(table.names), cols, capacity, table._nrows, valid,
                 nrows_dev=table.nrows_dev, device=table.device)


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
    cols = {name: c.map_rows(lambda x: torch.roll(x, -offset, 0))
            for name, c in t.cols.items()}
    out = Table(list(t.names), cols, t.capacity, new_n, None,
                device=t.device)
    return shrink_to(out, new_n)
