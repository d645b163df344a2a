"""Arrow <-> device tables (the host boundary).

The port of the JAX package's `io/arrow_interop.py`. Arrow is the host
interchange format: pyarrow's C++ decodes variable-length layouts and
files, and this module turns its arrays into fixed-capacity columns of
torch tensors on the frame's device (strings as codes into a sorted
dictionary, `strings.py`). pyarrow is imported inside the functions, so
the package imports on a machine without it; there every function here
raises `ModuleNotFoundError` naming pyarrow.

Storage follows `batch.py`: UInt16 in int32, UInt32 in int64, UInt64 as
its int64 bit pattern (a value at or above 2^63 round-trips). Host
buffers are owned before `torch.from_numpy` (a borrowed Arrow view is
read-only) and copied to the device synchronously.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..batch import Column, Table, resolve_device, storage_torch_dtype, \
    width_for
from ..config import capacity_for
from ..dtypes import (Binary, Boolean, Categorical, DataType, Date, Datetime,
                      Duration, Float32, Float64, Int8, Int16, Int32, Int64,
                      List as ListT, String, Struct as StructT, Time, UInt8,
                      UInt16, UInt32, UInt64)
from ..errors import SchemaError
from ..strings import NULL_CODE, StringDict

__all__ = ["dtype_from_arrow", "dtype_to_arrow", "column_from_arrow",
           "table_from_arrow", "table_to_arrow"]

_NP_OF = {torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32,
          torch.int64: np.int64, torch.uint8: np.uint8,
          torch.float32: np.float32, torch.float64: np.float64,
          torch.bool: np.bool_}


def _simple_types():
    import pyarrow as pa
    return {pa.int8(): Int8, pa.int16(): Int16, pa.int32(): Int32,
            pa.int64(): Int64, pa.uint8(): UInt8, pa.uint16(): UInt16,
            pa.uint32(): UInt32, pa.uint64(): UInt64, pa.float32(): Float32,
            pa.float64(): Float64, pa.bool_(): Boolean, pa.date32(): Date}


def dtype_from_arrow(t) -> DataType:
    import pyarrow as pa
    simple = _simple_types()
    if t in simple:
        return simple[t]
    T = pa.types
    if T.is_string(t) or T.is_large_string(t) or T.is_string_view(t):
        return String
    if T.is_binary(t) or T.is_large_binary(t) or T.is_fixed_size_binary(t) \
            or T.is_binary_view(t):
        return Binary()
    if T.is_dictionary(t):
        return Categorical()
    if T.is_timestamp(t):
        return Datetime(t.unit if t.unit in ("ms", "us", "ns") else "us",
                        t.tz)
    if T.is_duration(t):
        return Duration(t.unit if t.unit in ("ms", "us", "ns") else "us")
    if T.is_date64(t):
        return Datetime("ms")
    if T.is_time32(t) or T.is_time64(t):
        return Time
    if T.is_decimal(t):
        return Float64
    if T.is_null(t):
        return Boolean
    if T.is_list(t) or T.is_large_list(t):
        return ListT(dtype_from_arrow(t.value_type))
    if T.is_struct(t):
        return StructT([(t.field(i).name, dtype_from_arrow(t.field(i).type))
                        for i in range(t.num_fields)])
    raise SchemaError(f"unsupported arrow type: {t}")


def dtype_to_arrow(dt: DataType):
    import pyarrow as pa
    if isinstance(dt, type) and issubclass(dt, DataType):
        dt = dt()
    simple = {"Int8": pa.int8(), "Int16": pa.int16(), "Int32": pa.int32(),
              "Int64": pa.int64(), "UInt8": pa.uint8(), "UInt16": pa.uint16(),
              "UInt32": pa.uint32(), "UInt64": pa.uint64(),
              "Float32": pa.float32(), "Float64": pa.float64(),
              "Boolean": pa.bool_(), "String": pa.large_string(),
              "Categorical": pa.large_string(),
              "Binary": pa.large_binary(), "Date": pa.date32(),
              "Time": pa.time64("ns")}
    name = repr(dt)
    if name in simple:
        return simple[name]
    if isinstance(dt, Datetime):
        return pa.timestamp(dt.time_unit, dt.time_zone)
    if isinstance(dt, Duration):
        return pa.duration(dt.time_unit)
    if isinstance(dt, ListT):
        return pa.large_list(dtype_to_arrow(dt.inner))
    if isinstance(dt, StructT):
        return pa.struct([pa.field(n, dtype_to_arrow(d))
                          for n, d in dt.fields])
    raise SchemaError(f"cannot convert {dt!r} to arrow")


def _put(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """An owned, writable, contiguous host buffer as a tensor on
    `device` (a synchronous copy: the buffer may be freed after)."""
    a = np.ascontiguousarray(host)
    if not a.flags.owndata or not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _storage_np(dt: DataType) -> np.dtype:
    return np.dtype(_NP_OF[storage_torch_dtype(dt)])


def _to_storage(vals: np.ndarray, dt: DataType) -> np.ndarray:
    """Host values of `dt` in the port's storage dtype (UInt64 by bit
    pattern)."""
    if vals.dtype == np.uint64:
        return vals.view(np.int64)
    return vals.astype(_storage_np(dt), copy=False)


def _padded(vals: np.ndarray, capacity: int, fill=0) -> np.ndarray:
    out = np.full(capacity, fill, dtype=vals.dtype)
    out[:len(vals)] = vals
    return out


def _validity(mask: Optional[np.ndarray], capacity: int,
              device) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    return _put(_padded(mask, capacity, False), device)


def _physical(arr):
    """Temporal and decimal arrays as the integer (or float) Arrow array
    the port stores, in the dtype's unit; nulls filled with 0."""
    import pyarrow as pa
    t = arr.type
    T = pa.types
    if T.is_timestamp(t):
        unit = t.unit if t.unit in ("ms", "us", "ns") else "us"
        arr = arr.cast(pa.timestamp(unit, t.tz)).cast(pa.int64())
    elif T.is_duration(t):
        unit = t.unit if t.unit in ("ms", "us", "ns") else "us"
        arr = arr.cast(pa.duration(unit)).cast(pa.int64())
    elif T.is_date32(t):
        arr = arr.cast(pa.int32())
    elif T.is_date64(t):
        arr = arr.cast(pa.int64())
    elif T.is_time32(t) or T.is_time64(t):
        arr = arr.cast(pa.time64("ns")).cast(pa.int64())
    elif T.is_decimal(t):
        arr = arr.cast(pa.float64())
    if arr.null_count:
        arr = arr.fill_null(False if T.is_boolean(arr.type) else 0)
    return arr


def column_from_arrow(arr, capacity: int, as_string: bool = False,
                      device=None) -> Column:
    """One Arrow (chunked) array as a column of `capacity` rows on
    `device`. `as_string`: a dictionary read forced by the Parquet
    reader on a plain string or binary column stays String or Binary."""
    import pyarrow as pa
    device = resolve_device(device)
    T = pa.types
    t = arr.type
    if isinstance(arr, pa.ChunkedArray) and not T.is_dictionary(t):
        arr = arr.combine_chunks() if arr.num_chunks != 1 else arr.chunk(0)
    if isinstance(arr, pa.ChunkedArray) and arr.num_chunks == 0:
        arr = pa.array([], type=t)
    if as_string and T.is_dictionary(t):
        vt = t.value_type
        dt = Binary() if (T.is_binary(vt) or T.is_large_binary(vt)
                          or T.is_fixed_size_binary(vt)) else String
    else:
        dt = dtype_from_arrow(t)
    n = len(arr)
    mask = ~np.asarray(arr.is_null()) if arr.null_count else None
    if T.is_null(t):
        mask = np.zeros(n, bool)
    if T.is_list(t) or T.is_large_list(t):
        return _list_column_from_arrow(arr, dt, n, mask, capacity, device)
    if T.is_struct(t):
        fields = {t.field(i).name: column_from_arrow(arr.field(i), capacity,
                                                     device=device)
                  for i in range(t.num_fields)}
        return Column(dt, None, _validity(mask, capacity, device),
                      fields=fields)
    if dt.is_string:
        if T.is_dictionary(t):
            # a Parquet dictionary page comes pre-encoded: sort only the
            # O(unique) dictionary and remap the codes
            codes, sdict = StringDict.encode_dictionary(arr)
        else:
            if T.is_fixed_size_binary(t) or T.is_binary_view(t):
                arr = arr.cast(pa.large_binary())
            elif T.is_string_view(t):
                arr = arr.cast(pa.large_string())
            codes, sdict = StringDict.encode_arrow(arr)
        return Column(dt, _put(_padded(codes, capacity, NULL_CODE), device),
                      _validity(mask, capacity, device), sdict)
    if T.is_null(t):
        vals = np.zeros(n, bool)
    else:
        vals = _physical(arr).to_numpy(zero_copy_only=False)
    data = _padded(_to_storage(np.asarray(vals), dt), capacity)
    return Column(dt, _put(data, device), _validity(mask, capacity, device))


def _list_column_from_arrow(arr, dt, n: int, mask, capacity: int,
                            device) -> Column:
    """An Arrow list as the port's padded (capacity, width) layout: the
    flat child gathered by (row base + lane), masked past each length."""
    import pyarrow as pa
    from ..batch import _list_column_from_host
    vt = arr.type.value_type
    T = pa.types
    if T.is_list(vt) or T.is_large_list(vt) or T.is_struct(vt):
        # nested inner types go through host values (the port's own
        # nested constructor)
        return _list_column_from_host(arr.to_pylist(), dt, capacity) \
            .map_rows(lambda x: x.to(device))
    offs = np.asarray(arr.offsets).astype(np.int64)
    lens = np.diff(offs).astype(np.int32)
    if mask is not None:
        lens = np.where(mask, lens, 0).astype(np.int32)
    W = width_for(int(lens.max()) if n else 1)
    child = arr.values
    ccap = max(len(child), 1)
    ccol = column_from_arrow(child, ccap, device="cpu")
    idx = np.minimum(offs[:-1, None] + np.arange(W)[None, :], ccap - 1)
    in_len = np.arange(W)[None, :] < lens[:, None]
    cdata = ccol.data.numpy()
    fill = NULL_CODE if dt.inner.is_string else 0
    data = np.full((capacity, W), fill, dtype=cdata.dtype)
    data[:n] = np.where(in_len, cdata[idx], fill)
    lens_full = _padded(lens, capacity)
    elem_valid = None
    if ccol.validity is not None:
        ev = np.zeros((capacity, W), bool)
        ev[:n] = ccol.validity.numpy()[idx] & in_len
        if not (ev[:n] == in_len).all():
            data[:n][~ev[:n]] = fill
            elem_valid = _put(ev, device)
    return Column(dt, _put(data, device), _validity(mask, capacity, device),
                  ccol.sdict, lengths=_put(lens_full, device),
                  elem_valid=elem_valid)


# a table of at least this many rows and two columns converts its
# columns on a thread pool (Arrow's C++ releases the GIL)
PARALLEL_ROWS = 1 << 20


def table_from_arrow(at, capacity: Optional[int] = None,
                     string_cols: frozenset = frozenset(),
                     device=None) -> Table:
    device = resolve_device(device)
    n = at.num_rows
    cap = capacity or capacity_for(n)
    names = list(at.column_names)

    def conv(nm):
        return column_from_arrow(at.column(nm), cap, nm in string_cols,
                                 device)
    if n >= PARALLEL_ROWS and len(names) > 1:
        import concurrent.futures as _f
        with _f.ThreadPoolExecutor(max_workers=min(len(names), 8)) as ex:
            cols = list(ex.map(conv, names))
    else:
        cols = [conv(nm) for nm in names]
    return Table(names, dict(zip(names, cols)), cap, n, None, device=device)


def _strings_by_take(sdict, codes: np.ndarray, valid, patype):
    """A String (or Binary) column's live rows as an Arrow array: the
    dictionary's values taken by the codes, null where the validity or a
    negative code says so (one Arrow `take`, no Python string per row)."""
    import pyarrow as pa
    null = codes < 0 if valid is None else ~valid | (codes < 0)
    values = pa.array(sdict.values if sdict is not None else [],
                      type=patype)
    idx = pa.array(np.where(null, 0, codes).astype(np.int32, copy=False),
                   mask=null)
    return values.take(idx)


def table_to_arrow(t: Table):
    """The live rows as a pyarrow Table: compacted on the device first
    (kernel B on the card), then one host copy per buffer."""
    import pyarrow as pa
    from ..batch import _host_logical
    from ..ops.compact import compact
    t = compact(t)
    n = t.count_rows()
    fields, arrays = [], []
    for name in t.names:
        c = t.cols[name]
        patype = dtype_to_arrow(c.dtype)
        if c.dtype.is_nested:
            arr = pa.array(list(c.to_numpy(n)), type=patype)
        else:
            data = c.data[:n].cpu().numpy()
            valid = c.validity[:n].cpu().numpy() \
                if c.validity is not None else None
            m = None if valid is None else ~valid
            if c.dtype.is_string:
                arr = _strings_by_take(c.sdict, data, valid, patype)
            elif repr(c.dtype) == "Date":
                arr = pa.array(data.astype(np.int32), pa.int32(),
                               mask=m).cast(patype)
            elif isinstance(c.dtype, (Datetime, Duration)) or \
                    repr(c.dtype) == "Time":
                arr = pa.array(data.astype(np.int64), pa.int64(),
                               mask=m).cast(patype)
            else:
                arr = pa.array(_host_logical(c.dtype, data), type=patype,
                               mask=m)
        fields.append(pa.field(name, patype))
        arrays.append(arr)
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))
