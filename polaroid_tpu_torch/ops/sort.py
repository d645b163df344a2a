"""Table sorting.

The port of the JAX package's `ops/sort.py`: key columns are encoded into
order-preserving 32-bit words (`keycode.py`) behind a leading liveness
word, so a masked table sorts without prior compaction and its dead rows
go last, and the rows are then sorted lexicographically by those words:
- one key word (a null-free key of at most 4 bytes) goes to one
  `torch.sort` of the packed [dead:1 | key:32 | idx:31] word
  (`fused_sort.fused_argsort`);
- more words go to kernel F, `merge_sort.merge_sort_words`, which
  returns only the permutation (its radix passes carry the row index and
  nothing else), so no key word is written back.
Both orders are stable, whatever `maintain_order` asks (a stable order is
one of the orders an unstable sort may give).

The table is then gathered by the permutation, which is the JAX
package's CPU route. Its accelerator route carries every column through
the sort instead (`_try_fused_table_sort`, `_sort_table_carried`,
switched by PT_SORT_CARRY), because a gather costs about 8.7 ns per
element on a TPU; a gather on the card moves its bytes at memory speed,
so those routes and their switch are not ported.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..batch import Table
from ..errors import ShapeError
from . import compact as C
from .fused_sort import fused_argsort
from .keycode import encode_key_words
from .merge_sort import merge_sort_words


def sort_perm(key_vals, descending: Sequence[bool], nulls_last: Sequence[bool],
              mask: torch.Tensor) -> torch.Tensor:
    """Permutation sorting live rows by the given evaluated key Vals
    (dead rows pushed to the back). Stable for equal keys."""
    cap = mask.shape[0]
    words: List[torch.Tensor] = [(~mask).to(torch.int64)]
    for v, d, nl in zip(key_vals, descending, nulls_last):
        data = v.data.expand(cap)
        validity = v.validity.expand(cap) if v.validity is not None \
            else None
        words.extend(encode_key_words(data, v.dtype, validity, d, nl))
    if len(words) == 2 and cap < (1 << 31):
        return fused_argsort(words[1], live=mask)[1]
    return merge_sort_words(words, len(words), perm_only=True)[0]


def sort_table(table: Table, key_vals, descending, nulls_last,
               maintain_order: bool = True) -> Table:
    """The table's live rows sorted by the key Vals, as a prefix. The
    order is the stable one whatever `maintain_order` says."""
    if not key_vals:
        raise ShapeError("sort requires at least one key")
    mask = table.row_mask()
    count = mask.sum()
    perm = sort_perm(key_vals, descending, nulls_last, mask)
    out = C.gather_table(table, perm, None, None)
    # live rows are now a prefix; the count stays on the device until the
    # host reads it
    return out.with_valid(None, table._nrows, nrows_dev=count)


def top_k_table(table: Table, key_vals, k: int, descending,
                nulls_last) -> Table:
    """sort + slice fused (the reference lowers sort+slice to TopK,
    `polars-stream/src/physical_plan/lower_ir.rs:639`): sort, then shrink
    to the first k rows."""
    t = sort_table(table, key_vals, descending, nulls_last,
                   maintain_order=False)
    t = C.compact(t)
    n = min(k, t.nrows or 0)
    return C.shrink_to(t.with_valid(None, n), n)
