"""vstack / vertical and diagonal concatenation.

The port of the JAX package's `ops/concat.py` (reference analogue:
`polars-core` vstack + `polars-plan` Union lowering). Schemas are unified
by supertype (a diagonal concat fills missing columns with nulls);
string columns are recoded onto one merged dictionary, and List and
Struct columns concatenate by `_concat_nested`.
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


def _concat_nested(tables: Sequence[Table], n: str, dt: DataType,
                   cap: int, total: int) -> Column:
    """Vertical concat of List and Struct columns (inputs compact). A
    Struct concatenates field by field; a List of a flat type pads every
    part to the widest width on the device (strings recoded onto one
    dictionary); a List of a nested type is rebuilt through the host."""
    from ..batch import _list_column_from_host
    from ..dtypes import List as ListT, Struct as StructT
    dev = tables[0].device
    counts = [t.nrows or 0 for t in tables]
    if isinstance(dt, StructT):
        fields = {}
        for fname, _ in dt.fields:
            sub = []
            for t, nt in zip(tables, counts):
                c = t.cols.get(n)
                if c is not None and c.fields is not None and \
                        fname in c.fields:
                    sub.append(Table([fname], {fname: c.fields[fname]},
                                     t.capacity, nt, None, device=dev))
                else:
                    sub.append(Table([], {}, t.capacity, nt, None,
                                     device=dev))
            fields[fname] = vstack_tables(sub, "diagonal").cols[fname]
        return Column(dt, None, _row_validity(tables, n, counts, cap, dev),
                      fields=fields)
    if isinstance(dt.inner, (ListT, StructT)):
        rows: list = []
        for t, nt in zip(tables, counts):
            c = t.cols.get(n)
            rows.extend([None] * nt if c is None else list(c.to_numpy(nt)))
        return _list_column_from_host(rows, dt, cap).map_rows(
            lambda x: x.to(dev))
    inner = dt.inner
    stor = storage_torch_dtype(inner)
    W = max([t.cols[n].data.shape[1] for t in tables if n in t.cols] + [1])
    sdict, remaps = _merged_dict(tables, n) if inner.is_string \
        else (None, None)
    datas, lens, evs = [], [], []
    for i, (t, nt) in enumerate(zip(tables, counts)):
        c = t.cols.get(n)
        if c is None:
            datas.append(torch.zeros(nt, W, dtype=stor, device=dev))
            lens.append(torch.zeros(nt, dtype=torch.int32, device=dev))
            evs.append(torch.zeros(nt, W, dtype=torch.bool, device=dev))
            continue
        d = c.data[:nt]
        if inner.is_string:
            if remaps[i] is not None and len(remaps[i]):
                from ..expr.eval import gather_codes
                d = gather_codes(d, remaps[i])
        else:
            d = cast_val(Val(c.dtype.inner, d.reshape(-1), None, c.sdict),
                         inner).data.reshape(d.shape)
        pad = W - d.shape[1]
        in_len = torch.arange(d.shape[1], device=dev).unsqueeze(0) < \
            c.lengths[:nt].unsqueeze(1)
        ev = in_len if c.elem_valid is None else c.elem_valid[:nt] & in_len
        datas.append(torch.nn.functional.pad(d.to(stor), (0, pad)))
        evs.append(torch.nn.functional.pad(ev, (0, pad)))
        lens.append(c.lengths[:nt])
    datas.append(torch.zeros(cap - total, W, dtype=stor, device=dev))
    evs.append(torch.zeros(cap - total, W, dtype=torch.bool, device=dev))
    lens.append(torch.zeros(cap - total, dtype=torch.int32, device=dev))
    lengths = torch.cat(lens)
    ev = torch.cat(evs)
    in_len = torch.arange(W, device=dev).unsqueeze(0) < lengths.unsqueeze(1)
    return Column(dt, torch.cat(datas),
                  _row_validity(tables, n, counts, cap, dev), sdict,
                  lengths=lengths,
                  elem_valid=None if bool((ev == in_len).all()) else ev)


def _row_validity(tables, n, counts, cap, dev):
    """The concatenated row validity of column n (a missing column's
    rows are null), or None when every row is valid."""
    parts, any_null = [], False
    for t, nt in zip(tables, counts):
        c = t.cols.get(n)
        if c is None or c.validity is not None:
            any_null = True
            parts.append(torch.zeros(nt, dtype=torch.bool, device=dev)
                         if c is None else c.validity[:nt])
        else:
            parts.append(torch.ones(nt, dtype=torch.bool, device=dev))
    if not any_null:
        return None
    parts.append(torch.zeros(cap - sum(counts), dtype=torch.bool,
                             device=dev))
    return torch.cat(parts)


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
            cols[n] = _concat_nested(tables, n, dt, cap, total)
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
