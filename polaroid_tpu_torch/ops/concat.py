"""vstack / vertical and diagonal concatenation.

The port of the JAX package's `ops/concat.py` (reference analogue:
`polars-core` vstack + `polars-plan` Union lowering). Schemas are unified
by supertype (a diagonal concat fills missing columns with nulls);
string columns are recoded onto one merged dictionary. The port has no
List or Struct dtype yet, so nested columns raise (Slice E).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..batch import Column, Table, storage_torch_dtype
from ..config import capacity_for
from ..dtypes import DataType, supertype
from ..errors import SchemaError
from ..expr.eval import Val, cast_val
from ..strings import NULL_CODE, StringDict
from . import compact as C

__all__ = ["vstack_tables"]


def _unify_schema(tables: Sequence[Table], how: str):
    if how in ("vertical", "vertical_relaxed"):
        names = list(tables[0].names)
        for t in tables[1:]:
            if list(t.names) != names and how == "vertical":
                raise SchemaError(
                    f"vstack schemas differ: {names} vs {list(t.names)}")
        dtypes = {}
        for n in names:
            dt: Optional[DataType] = None
            for t in tables:
                if n not in t.cols:
                    raise SchemaError(f"column {n!r} missing in vstack input")
                cdt = t.cols[n].dtype
                dt = cdt if dt is None else supertype(dt, cdt)
            dtypes[n] = dt
        return names, dtypes
    # diagonal: union of columns
    names: List[str] = []
    for t in tables:
        for n in t.names:
            if n not in names:
                names.append(n)
    dtypes = {}
    for n in names:
        dt = None
        for t in tables:
            if n in t.cols:
                cdt = t.cols[n].dtype
                dt = cdt if dt is None else supertype(dt, cdt)
        dtypes[n] = dt
    return names, dtypes


def _concat_nested(n: str, dt: DataType) -> Column:
    raise NotImplementedError(
        f"concatenating the {dt!r} column {n!r} is not ported yet: nested "
        "columns come with Slice E (the expression surface)")


def _merged_dict(tables: Sequence[Table], n: str):
    """One sorted dictionary over every input's dictionary of column n,
    and each input's old code -> new code remap (None: no dictionary)."""
    sdict = StringDict(np.array([], dtype=object))
    remaps: List[Optional[np.ndarray]] = [None] * len(tables)
    for i, t in enumerate(tables):
        if n in t.cols and t.cols[n].sdict is not None:
            sdict, rm_merged, rm_new = sdict.merge(t.cols[n].sdict)
            # the earlier remaps compose with the merge's
            for j in range(i):
                if remaps[j] is not None:
                    remaps[j] = rm_merged[remaps[j]]
            remaps[i] = rm_new
    return sdict, remaps


def vstack_tables(tables: Sequence[Table], how: str = "vertical") -> Table:
    """Concatenate tables vertically. Inputs are compacted first (one host
    sync per input to learn its row count); the result is a fresh
    compact table."""
    tables = [C.compact(t) for t in tables]
    names, dtypes = _unify_schema(tables, how)
    total = sum(t.nrows or 0 for t in tables)
    cap = capacity_for(total)
    dev = tables[0].device
    cols = {}
    for n in names:
        dt = dtypes[n]
        if dt.is_nested:
            cols[n] = _concat_nested(n, dt)
            continue
        stor = storage_torch_dtype(dt)
        sdict, remaps = _merged_dict(tables, n) if dt.is_string \
            else (None, None)
        parts_data, parts_valid = [], []
        any_valid = False
        for i, t in enumerate(tables):
            nt = t.nrows or 0
            if n not in t.cols:    # diagonal: a column of nulls
                fill = int(NULL_CODE) if dt.is_string else 0
                parts_data.append(torch.full((nt,), fill, dtype=stor,
                                             device=dev))
                parts_valid.append(torch.zeros(nt, dtype=torch.bool,
                                               device=dev))
                any_valid = True
                continue
            c = t.cols[n]
            if dt.is_string:
                data = c.data[:nt]
                if remaps[i] is not None and len(remaps[i]):
                    rm = torch.from_numpy(remaps[i]).to(dev)
                    data = torch.where(
                        data >= 0, rm[data.clamp(0, len(remaps[i]) - 1)],
                        torch.full_like(data, int(NULL_CODE)))
            else:
                data = cast_val(Val(c.dtype, c.data[:nt], None, c.sdict),
                                dt).data
            parts_data.append(data)
            if c.validity is not None:
                parts_valid.append(c.validity[:nt])
                any_valid = True
            else:
                parts_valid.append(torch.ones(nt, dtype=torch.bool,
                                              device=dev))
        pad = cap - total
        parts_data.append(torch.zeros(pad, dtype=stor, device=dev))
        validity = None
        if any_valid:
            parts_valid.append(torch.zeros(pad, dtype=torch.bool,
                                           device=dev))
            validity = torch.cat(parts_valid)
        cols[n] = Column(dt, torch.cat(parts_data), validity, sdict)
    return Table(names, cols, cap, total, None, device=dev)
