"""Fixed-capacity columnar batches in torch tensors.

The port of the JAX package's `batch.py`: a `Table` is a set of
same-capacity 1-D tensors (one per column) plus validity masks. The
capacity is a power-of-two bucket (`config.capacity_for`) and the live
rows are either a prefix `[0, nrows)` ("compact" state) or a boolean
`valid` mask ("masked" state, e.g. after a filter, with no host sync and
no compaction). The row count of a compact table may stay on the device
(`nrows_dev`) until the host reads it.

Two storage rules differ from the JAX package:
* Float64 stays float64 on every device (the JAX package stores it as
  f32 on a TPU, which emulates f64).
* Unsigned words are held in wider signed tensors (UInt16 in int32,
  UInt32 and UInt64 in int64) with the logical dtype on the `Column`:
  torch lacks `>>`, `<` and `cummax` for uint32/uint64 on the CPU.
  UInt64 values at or above 2^63 wrap to negative int64; code that
  orders or converts them (group min/max, means, var/std in
  ops/groupby.py) undoes the wrap.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import datetime as _pydt

import numpy as np
import torch

from .config import CONFIG, capacity_for
from .dtypes import (
    Binary, Boolean, DataType, Date, Datetime, Duration, Float64, Int64,
    Null, String,
    dtype_from_numpy, physical_numpy_dtype,
)
from .errors import ColumnNotFoundError, ComputeError, DuplicateError, \
    SchemaError, ShapeError
from .strings import EMPTY_DICT, NULL_CODE, StringDict

__all__ = ["Column", "Table", "resolve_device", "storage_torch_dtype",
           "width_for"]

_STORAGE = {
    "Int8": torch.int8, "Int16": torch.int16, "Int32": torch.int32,
    "Int64": torch.int64, "UInt8": torch.uint8, "UInt16": torch.int32,
    "UInt32": torch.int64, "UInt64": torch.int64, "Float32": torch.float32,
    "Float64": torch.float64, "Boolean": torch.bool, "String": torch.int32,
    "Categorical": torch.int32, "Enum": torch.int32, "Binary": torch.int32,
    "Date": torch.int32,
    "Time": torch.int64, "Null": torch.bool,
}


def storage_torch_dtype(dt: DataType) -> torch.dtype:
    """The tensor dtype that holds a logical dtype."""
    if isinstance(dt, type) and issubclass(dt, DataType):
        dt = dt()
    name = repr(dt)
    if name.startswith(("Datetime", "Duration")):
        return torch.int64
    try:
        return _STORAGE[name]
    except KeyError:
        raise SchemaError(f"no physical dtype for {name}") from None


def resolve_device(device=None) -> torch.device:
    """The device a new frame lives on: `device`, else CONFIG.device.
    Asking for CUDA without a card raises; nothing falls back to the CPU
    unless the caller asks for the CPU."""
    dev = torch.device(device if device is not None else CONFIG.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "polaroid_tpu_torch runs on a CUDA device by default, and CUDA "
            "is not available; pass device='cpu' (or set "
            "Config.device = 'cpu') to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _host_logical(dt: DataType, arr: np.ndarray) -> np.ndarray:
    """Storage array (host) -> the logical numpy dtype of `dt`."""
    name = repr(dt)
    if name == "UInt64":
        return arr.view(np.uint64)
    if name in ("UInt16", "UInt32"):
        return arr.astype(physical_numpy_dtype(dt))
    return arr


class Column:
    """One column: `data` (capacity,) tensor + optional bool `validity`
    (True = non-null; None = all non-null) + the string dictionary of a
    string column. Rows outside the table's live set hold garbage that no
    kernel reads as a result.

    `stats` caches {"min", "max"} bucket bounds of an integer column: they
    give the group-by a dense key domain (see exec/executor.py).

    Nested layouts (the JAX package's, in torch tensors):
      * List(T): `data` is (capacity, width) padded to `width_for(the
        longest list)`, `lengths` (capacity,) int32, and `elem_valid`
        (capacity, width) marks the non-null elements (None: all inside
        the length are valid). A List(String)'s `sdict` is its elements'.
      * Struct: `fields` is an ordered {name: Column} of child columns and
        `data` is None.
      * List(Struct): `lengths` (+ `elem_valid` for null structs) and
        `fields` {name: List column of that field}, all of one width.
      * List(List(T)): `lengths` (+ `elem_valid`) and `fields` {"item":
        the child List column lifted to a (capacity, width, ...) leading
        layout}, to any depth."""

    __slots__ = ("dtype", "data", "validity", "sdict", "stats", "lengths",
                 "elem_valid", "fields")

    def __init__(self, dtype: DataType, data: Optional[torch.Tensor],
                 validity: Optional[torch.Tensor] = None,
                 sdict: Optional[StringDict] = None,
                 stats: Optional[dict] = None,
                 lengths: Optional[torch.Tensor] = None,
                 elem_valid: Optional[torch.Tensor] = None,
                 fields: Optional[Dict[str, "Column"]] = None):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.sdict = sdict
        self.stats = stats
        self.lengths = lengths
        self.elem_valid = elem_valid
        self.fields = fields

    @property
    def capacity(self) -> int:
        if self.data is not None:
            return self.data.shape[0]
        if self.lengths is not None:
            return self.lengths.shape[0]
        return next(iter(self.fields.values())).capacity

    @property
    def is_nested(self) -> bool:
        return self.lengths is not None or self.fields is not None

    @property
    def device(self) -> torch.device:
        if self.data is not None:
            return self.data.device
        if self.lengths is not None:
            return self.lengths.device
        return next(iter(self.fields.values())).device

    def map_rows(self, fn) -> "Column":
        """Every row-leading tensor of the column (data, validity,
        lengths, element validity, and the fields', recursively) through
        `fn`; the dictionary stays."""
        def f(x):
            return None if x is None else fn(x)
        return Column(self.dtype, f(self.data), f(self.validity), self.sdict,
                      None, f(self.lengths), f(self.elem_valid),
                      None if self.fields is None else
                      {k: c.map_rows(fn) for k, c in self.fields.items()})

    def take(self, perm: torch.Tensor) -> "Column":
        """Gather rows by index (axis 0), flat and nested alike."""
        if not self.is_nested:
            return Column(self.dtype, self.data[perm],
                          self.validity[perm] if self.validity is not None
                          else None, self.sdict)
        return self.map_rows(lambda x: x[perm])

    @staticmethod
    def from_host(values, dtype: Optional[DataType] = None,
                  capacity: Optional[int] = None,
                  device: Optional[torch.device] = None,
                  validity: Optional[np.ndarray] = None) -> "Column":
        """Build a column from host values (a numpy array or a list with
        None for nulls), padded to `capacity`. `validity` marks the
        non-null rows of a numpy array. Lists, tuples and 2-D arrays make
        List columns and dicts Struct columns."""
        if isinstance(dtype, type) and issubclass(dtype, DataType):
            dtype = dtype()
        device = resolve_device(device)
        nested = _detect_nested(values, dtype)
        if nested is not None:
            if validity is not None:
                values = [v if ok else None
                          for v, ok in zip(list(values), validity)]
            build = _list_column_from_host if nested == "list" \
                else _struct_column_from_host
            return build(values, dtype, capacity).map_rows(
                lambda x: x.to(device))
        vals, mask, dt, sdict = _coerce_host_values(values, dtype)
        if validity is not None:
            validity = np.asarray(validity, dtype=bool)
            mask = validity if mask is None else (mask & validity)
        n = len(vals)
        cap = capacity_for(n) if capacity is None else capacity
        if cap < n:
            raise ShapeError(f"capacity {cap} < row count {n}")
        stor = storage_torch_dtype(dt)
        out = torch.full((cap,), int(NULL_CODE) if dt.is_string else 0,
                         dtype=stor)
        host = np.ascontiguousarray(vals)
        if host.dtype == np.uint64:
            host = host.view(np.int64)
        elif host.dtype.kind == "u" and host.dtype != np.uint8:
            host = host.astype(np.int64)
        out[:n] = torch.from_numpy(host).to(stor)
        data = out.to(device)
        vt = None
        if mask is not None and not mask.all():
            m = torch.zeros(cap, dtype=torch.bool)
            m[:n] = torch.from_numpy(np.ascontiguousarray(mask))
            vt = m.to(device)
        return Column(dt, data, vt, sdict)

    def to_numpy(self, nrows: int, valid_mask: Optional[np.ndarray] = None):
        """Host copy of the live rows (object array when nulls, strings
        or nested values)."""
        if self.fields is not None and self.lengths is not None:
            return _nested_list_to_numpy(self, nrows, valid_mask)
        if self.fields is not None:
            return _struct_to_numpy(self, nrows, valid_mask)
        if self.lengths is not None:
            return _list_to_numpy(self, nrows, valid_mask)
        data = _host_logical(self.dtype,
                             self.data[:nrows].cpu().numpy())
        vmask = None
        if self.validity is not None:
            vmask = self.validity[:nrows].cpu().numpy()
        if valid_mask is not None:
            data = data[valid_mask[:nrows]]
            if vmask is not None:
                vmask = vmask[valid_mask[:nrows]]
        if self.dtype.is_string:
            codes = data.copy()
            if vmask is not None:
                codes[~vmask] = NULL_CODE
            return (self.sdict or EMPTY_DICT).decode(codes)
        out = _decode_flat_host(self.dtype, data)
        if vmask is not None and not vmask.all():
            out = np.asarray(out, dtype=object)
            out[~vmask] = None
        return out


def _decode_flat_host(dt: DataType, data: np.ndarray, sdict=None):
    """A flat host storage array -> the values a user sees."""
    if dt.is_string:
        return (sdict or EMPTY_DICT).decode(data.astype(np.int32))
    if repr(dt) == "Date":
        return data.astype("datetime64[D]").astype(object)
    if isinstance(dt, Datetime):
        return data.astype(f"datetime64[{dt.time_unit}]")
    if isinstance(dt, Duration):
        return data.astype(f"timedelta64[{dt.time_unit}]")
    return data


# ---------------------------------------------------------------------------
# nested columns: host <-> device
# ---------------------------------------------------------------------------

def width_for(n: int) -> int:
    """The list-width bucket: the power of two >= n (at least 1)."""
    c = max(int(n), 1)
    return 1 << (c - 1).bit_length()


def _detect_nested(values, dtype: Optional[DataType]) -> Optional[str]:
    from .dtypes import List as ListT, Struct as StructT
    if isinstance(dtype, ListT):
        return "list"
    if isinstance(dtype, StructT):
        return "struct"
    if isinstance(values, np.ndarray):
        if values.ndim == 2:
            return "list"
        if values.dtype.kind != "O":
            return None
    for v in values:
        if v is None:
            continue
        if isinstance(v, (list, tuple, np.ndarray)):
            return "list"
        if isinstance(v, dict):
            return "struct"
        return None
    return None


def _first_list_elem(seq):
    for row in seq:
        if row is None:
            continue
        for e in row:
            if e is not None:
                return e
    return None


def _row_mask(mask: np.ndarray, cap: int) -> Optional[torch.Tensor]:
    if mask.all():
        return None
    m = np.zeros(cap, dtype=bool)
    m[:len(mask)] = mask
    return torch.from_numpy(m)


def _list_column_from_host(values, dtype: Optional[DataType],
                           capacity: Optional[int],
                           width: Optional[int] = None) -> Column:
    """List rows (None = a null list) -> a List column on the CPU."""
    from .dtypes import List as ListT, Struct as StructT
    if isinstance(values, np.ndarray) and values.ndim == 2:
        seq = [list(r) for r in values]
    else:
        seq = [None if v is None else list(v) for v in values]
    n = len(seq)
    cap = capacity_for(n) if capacity is None else capacity
    if cap < n:
        raise ShapeError(f"capacity {cap} < row count {n}")
    mask = np.array([v is not None for v in seq], dtype=bool)
    lens = np.array([len(v) if v is not None else 0 for v in seq],
                    dtype=np.int32)
    W = width if width is not None else \
        width_for(int(lens.max()) if n else 1)
    inner_dt = dtype.inner if isinstance(dtype, ListT) else None
    e0 = _first_list_elem(seq)
    if isinstance(inner_dt, StructT) or \
            (inner_dt is None and isinstance(e0, dict)):
        return _list_of_struct_from_host(seq, mask, lens, W, inner_dt, cap)
    if isinstance(inner_dt, ListT) or (inner_dt is None and isinstance(
            e0, (list, tuple, np.ndarray))):
        return _list_of_list_from_host(seq, mask, lens, W, inner_dt, cap)
    # one flat coercion over the padded (cap, W) grid reuses the scalar
    # coercion (strings, temporal, bool) unchanged
    flat: list = [None] * (cap * W)
    for i, row in enumerate(seq):
        if row is not None:
            flat[i * W:i * W + len(row)] = row
    vals, emask, dt, sdict = _coerce_host_values(flat, inner_dt)
    if emask is None:
        emask = np.ones(cap * W, dtype=bool)
    stor = storage_torch_dtype(dt)
    host = np.asarray(vals)
    if host.dtype == np.uint64:
        host = host.view(np.int64)
    data = torch.from_numpy(np.ascontiguousarray(host)).to(stor) \
        .reshape(cap, W)
    lens_full = np.zeros(cap, dtype=np.int32)
    lens_full[:n] = lens
    in_len = np.arange(W)[None, :] < lens_full[:, None]
    em2 = emask.reshape(cap, W) & in_len
    return Column(ListT(dt), data, _row_mask(mask, cap), sdict,
                  lengths=torch.from_numpy(lens_full),
                  elem_valid=None if (em2 == in_len).all()
                  else torch.from_numpy(em2))


def _list_of_struct_from_host(seq, mask, lens, W, inner_dt, cap) -> Column:
    """List(Struct): lengths + one List column per field, of one width."""
    from .dtypes import List as ListT, Struct as StructT
    n = len(seq)
    if isinstance(inner_dt, StructT):
        names = [nm for nm, _ in inner_dt.fields]
        fdts = dict(inner_dt.fields)
    else:
        names = []
        for row in seq:
            for e in (row or ()):
                if isinstance(e, dict):
                    names += [k for k in e if k not in names]
        fdts = {}
    ev = np.zeros((cap, W), dtype=bool)
    for i, row in enumerate(seq):
        for j, e in enumerate(row or ()):
            ev[i, j] = e is not None
    fields = {}
    for nm in names:
        frows = [None if row is None else
                 [None if e is None else e.get(nm) for e in row]
                 for row in seq]
        fields[nm] = _list_column_from_host(
            frows, ListT(fdts[nm]) if nm in fdts else None, cap, width=W)
    lens_full = np.zeros(cap, dtype=np.int32)
    lens_full[:n] = lens
    in_len = np.arange(W)[None, :] < lens_full[:, None]
    return Column(ListT(StructT([(nm, fields[nm].dtype.inner)
                                 for nm in names])), None,
                  _row_mask(mask, cap), None,
                  lengths=torch.from_numpy(lens_full),
                  elem_valid=None if (ev == in_len).all()
                  else torch.from_numpy(ev), fields=fields)


def _reshape_leading(col: Column, cap: int, W: int) -> Column:
    """Lift a flat-leading column ((cap*W, ...) tensors) to a nested
    child layout ((cap, W, ...) tensors), recursing into fields."""
    return col.map_rows(lambda a: a.reshape((cap, W) + tuple(a.shape[1:])))


def _flatten_leading(col: Column) -> Column:
    """The inverse of `_reshape_leading`: (cap, W, ...) -> (cap*W, ...)."""
    return col.map_rows(lambda a: a.reshape(
        (a.shape[0] * a.shape[1],) + tuple(a.shape[2:])))


def _list_of_list_from_host(seq, mask, lens, W1, inner_dt, cap) -> Column:
    """List(List(T)) at any depth: the outer lengths and the child List
    column (built flat over cap*W1 rows by the ordinary constructor, so
    any inner composes) lifted to a (cap, W1, ...) leading layout."""
    from .dtypes import List as ListT
    from .errors import InvalidOperationError
    n = len(seq)
    child_seq: list = [None] * (cap * W1)
    for i, row in enumerate(seq):
        for j, e in enumerate(row or ()):
            if e is None:
                continue
            if isinstance(e, np.ndarray):
                e = e.tolist()
            if not isinstance(e, (list, tuple)):
                raise InvalidOperationError(
                    f"List(List): inner elements must be lists, got "
                    f"{type(e).__name__}")
            child_seq[i * W1 + j] = e
    child = _list_column_from_host(child_seq, inner_dt, cap * W1)
    lens_full = np.zeros(cap, dtype=np.int32)
    lens_full[:n] = lens
    in_len1 = np.arange(W1)[None, :] < lens_full[:, None]
    # the child's row validity marks the present inner lists: it becomes
    # the outer element validity, and the lifted child carries none
    ev = in_len1 if child.validity is None else \
        child.validity.numpy().reshape(cap, W1)
    child = _reshape_leading(
        Column(child.dtype, child.data, None, child.sdict,
               lengths=child.lengths, elem_valid=child.elem_valid,
               fields=child.fields), cap, W1)
    return Column(ListT(child.dtype), None, _row_mask(mask, cap), None,
                  lengths=torch.from_numpy(lens_full),
                  elem_valid=None if (ev == in_len1).all()
                  else torch.from_numpy(ev), fields={"item": child})


def _struct_column_from_host(values, dtype: Optional[DataType],
                             capacity: Optional[int]) -> Column:
    from .dtypes import Struct as StructT
    seq = list(values)
    n = len(seq)
    cap = capacity_for(n) if capacity is None else capacity
    if cap < n:
        raise ShapeError(f"capacity {cap} < row count {n}")
    mask = np.array([v is not None for v in seq], dtype=bool)
    if isinstance(dtype, StructT):
        keys = [k for k, _ in dtype.fields]
        fdts = dict(dtype.fields)
    else:
        keys, fdts = [], {}
        for row in seq:
            for k in (row or ()):
                if k not in keys:
                    keys.append(k)
    fields = {}
    for k in keys:
        fields[k] = Column.from_host(
            [row.get(k) if row is not None else None for row in seq],
            dtype=fdts.get(k), capacity=cap, device="cpu")
    return Column(StructT([(k, fields[k].dtype) for k in keys]), None,
                  _row_mask(mask, cap), fields=fields)


def _empty_column(dt: DataType, cap: int, device=None) -> Column:
    """A column of `dt` with every row empty (0, or an empty list)."""
    from .dtypes import List as ListT, Struct as StructT

    def zeros(shape, tdt):
        return torch.zeros(shape, dtype=tdt, device=device)
    if isinstance(dt, ListT) and isinstance(dt.inner, StructT):
        return Column(dt, None, None, lengths=zeros(cap, torch.int32),
                      fields={nm: _empty_column(ListT(fd), cap, device)
                              for nm, fd in dt.inner.fields})
    if isinstance(dt, ListT) and isinstance(dt.inner, ListT):
        child = _reshape_leading(_empty_column(dt.inner, cap, device),
                                 cap, 1)
        return Column(dt, None, None, lengths=zeros(cap, torch.int32),
                      fields={"item": child})
    if isinstance(dt, ListT):
        return Column(dt, zeros((cap, 1), storage_torch_dtype(dt.inner)),
                      None, EMPTY_DICT if dt.inner.is_string else None,
                      lengths=zeros(cap, torch.int32))
    if isinstance(dt, StructT):
        return Column(dt, None, None,
                      fields={n: _empty_column(d, cap, device)
                              for n, d in dt.fields})
    return Column(dt, zeros(cap, storage_torch_dtype(dt)), None,
                  EMPTY_DICT if dt.is_string else None)


def _select_rows(x: Optional[torch.Tensor], nrows: int,
                 valid_mask: Optional[np.ndarray]):
    if x is None:
        return None
    h = x[:nrows].cpu().numpy()
    return h[valid_mask[:nrows]] if valid_mask is not None else h


def _py(x):
    return x.item() if isinstance(x, np.generic) else x


def _struct_to_numpy(col: Column, nrows: int,
                     valid_mask: Optional[np.ndarray]) -> np.ndarray:
    parts = {k: f.to_numpy(nrows, valid_mask) for k, f in col.fields.items()}
    m = len(next(iter(parts.values()))) if parts else 0
    vmask = _select_rows(col.validity, nrows, valid_mask)
    out = np.empty(m, dtype=object)
    for i in range(m):
        out[i] = ({k: _py(parts[k][i]) for k in parts}
                  if vmask is None or vmask[i] else None)
    return out


def _list_to_numpy(col: Column, nrows: int,
                   valid_mask: Optional[np.ndarray]) -> np.ndarray:
    data = _select_rows(col.data, nrows, valid_mask)
    lens = _select_rows(col.lengths, nrows, valid_mask)
    ev = _select_rows(col.elem_valid, nrows, valid_mask)
    vmask = _select_rows(col.validity, nrows, valid_mask)
    inner = col.dtype.inner
    data = _host_logical(inner, data) if not inner.is_nested else data
    out = np.empty(len(data), dtype=object)
    for i in range(len(data)):
        if vmask is not None and not vmask[i]:
            out[i] = None
            continue
        L = int(lens[i])
        vals = _decode_flat_host(inner, data[i, :L], col.sdict)
        vals = [_py(v) for v in vals]
        out[i] = vals if ev is None else \
            [v if ev[i, j] else None for j, v in enumerate(vals)]
    return out


def _nested_list_to_numpy(col: Column, nrows: int,
                          valid_mask: Optional[np.ndarray]) -> np.ndarray:
    """List(Struct) and List(List) rows -> host lists."""
    from .dtypes import Struct as StructT
    lens = _select_rows(col.lengths, nrows, valid_mask)
    ev = _select_rows(col.elem_valid, nrows, valid_mask)
    vmask = _select_rows(col.validity, nrows, valid_mask)
    m = len(lens)
    out = np.empty(m, dtype=object)
    if isinstance(col.dtype.inner, StructT):
        parts = {nm: f.to_numpy(nrows, valid_mask)
                 for nm, f in col.fields.items()}
        for i in range(m):
            if vmask is not None and not vmask[i]:
                out[i] = None
                continue
            out[i] = [None if ev is not None and not ev[i, j] else
                      {nm: (parts[nm][i][j] if parts[nm][i] is not None
                            else None) for nm in parts}
                      for j in range(int(lens[i]))]
        return out
    # List(List): decode the lifted child at its flat layout (recursion
    # takes any depth), then regroup by the outer lengths
    child = col.fields["item"]
    W1 = (child.lengths if child.lengths is not None
          else child.data).shape[1]
    childrows = _flatten_leading(child).to_numpy(nrows * W1)
    orig = np.nonzero(valid_mask[:nrows])[0] if valid_mask is not None \
        else np.arange(m)
    for i in range(m):
        if vmask is not None and not vmask[i]:
            out[i] = None
            continue
        oi = int(orig[i])
        out[i] = [None if ev is not None and not ev[i, j] else
                  childrows[oi * W1 + j] for j in range(int(lens[i]))]
    return out


def _coerce_host_values(values, dtype: Optional[DataType]):
    """Host input -> (np array, non-null mask | None, DataType, sdict)."""
    if isinstance(values, np.ndarray) and values.dtype.kind not in "OUS":
        dt = dtype or dtype_from_numpy(values.dtype)
        if values.dtype.kind == "M":
            unit = np.datetime_data(values.dtype)[0]
            if unit == "D":
                values = values.astype(np.int64).astype(np.int32)
            else:
                tu = dt.time_unit if isinstance(dt, Datetime) else "us"
                values = values.astype(f"datetime64[{tu}]").astype(np.int64)
        elif values.dtype.kind == "m":
            tu = dt.time_unit if isinstance(dt, Duration) else "us"
            values = values.astype(f"timedelta64[{tu}]").astype(np.int64)
        elif dtype is not None and not dt.is_string:
            values = values.astype(physical_numpy_dtype(dt), copy=False)
        return values, None, dt, None

    if isinstance(values, np.ndarray) and values.dtype.kind == "U" and \
            (dtype is None or dtype.is_string):
        # fixed-width unicode: the word-sort encode, no Python string per
        # row (strings.py)
        codes, sdict = StringDict.encode(values)
        return codes, None, dtype or String, sdict
    seq = list(values)
    mask = np.array([v is not None for v in seq], dtype=bool)
    non_null = [v for v in seq if v is not None]
    if dtype is not None:
        dt = dtype
    elif not non_null:
        dt = Null
    else:
        v0 = non_null[0]
        if isinstance(v0, (bool, np.bool_)):
            dt = Boolean
        elif isinstance(v0, (int, np.integer)):
            dt = Int64
        elif isinstance(v0, (float, np.floating)):
            dt = Float64
        elif isinstance(v0, str):
            dt = String
        elif isinstance(v0, (bytes, bytearray)):
            dt = Binary()
        elif isinstance(v0, _pydt.datetime):
            dt = Datetime("us")
        elif isinstance(v0, _pydt.date):
            dt = Date
        elif isinstance(v0, _pydt.timedelta):
            dt = Duration("us")
        else:
            raise ComputeError(
                f"cannot build a column from host values of type "
                f"{type(v0).__name__}")
    if dt.is_string:
        codes, sdict = StringDict.encode(np.asarray(seq, dtype=object), mask)
        return codes, mask, dt, sdict
    if dt == Null:
        return np.zeros(len(seq), dtype=bool), mask, Boolean, None
    if dt.is_temporal and any(isinstance(v, (_pydt.date, _pydt.timedelta,
                                             _pydt.time))
                              for v in non_null[:1]):
        # Python dates, datetimes (a naive one read as UTC) and
        # timedeltas, in the dtype's units, exactly
        from .expr.eval import _temporal_count
        vals = np.array([_temporal_count(v, dt) if v is not None else 0
                         for v in seq], dtype=physical_numpy_dtype(dt))
        return vals, mask, dt, None
    stor = physical_numpy_dtype(dt)
    vals = np.array([v if v is not None else 0 for v in seq]).astype(stor)
    return vals, mask, dt, None


class Table:
    """An ordered set of equal-capacity columns + the live-row state.

    Live rows: if `valid` is None, rows [0, nrows) are live ("compact").
    Otherwise `valid` (bool, (capacity,)) marks them and `nrows` may be
    None until a host sync. With `valid` None and the host count unknown,
    `nrows_dev` (a device scalar) holds the prefix length; reading
    `.nrows` syncs it once."""

    __slots__ = ("names", "cols", "capacity", "_nrows", "valid",
                 "nrows_dev", "device")

    def __init__(self, names: List[str], cols: Dict[str, Column],
                 capacity: int, nrows: Optional[int],
                 valid: Optional[torch.Tensor] = None,
                 nrows_dev: Optional[torch.Tensor] = None,
                 device: Optional[torch.device] = None):
        self.names = names
        self.cols = cols
        self.capacity = capacity
        self._nrows = nrows
        self.valid = valid
        self.nrows_dev = nrows_dev
        if device is None:
            device = next(iter(cols.values())).device if cols \
                else resolve_device(None)
        self.device = device

    @property
    def nrows(self) -> Optional[int]:
        """Host row count; syncs a deferred device count on first read."""
        if self._nrows is None and self.valid is None and \
                self.nrows_dev is not None:
            self._nrows = int(self.nrows_dev)
        return self._nrows

    @staticmethod
    def from_dict(data: Dict[str, object],
                  schema: Optional[Dict[str, DataType]] = None,
                  device=None,
                  validity: Optional[Dict[str, np.ndarray]] = None
                  ) -> "Table":
        device = resolve_device(device)
        names = list(data.keys())
        lengths = {k: len(v) for k, v in data.items()}
        n = max(lengths.values()) if lengths else 0
        for k, ln in lengths.items():
            if ln != n:
                raise ShapeError(f"column {k!r} has length {ln}, expected {n}")
        cap = capacity_for(n)
        cols = {}
        for k in names:
            dt = schema.get(k) if schema else None
            vm = validity.get(k) if validity else None
            cols[k] = Column.from_host(data[k], dtype=dt, capacity=cap,
                                       device=device, validity=vm)
        return Table(names, cols, cap, n, None, device=device)

    # --- introspection -------------------------------------------------
    @property
    def schema(self) -> Dict[str, DataType]:
        return {n: self.cols[n].dtype for n in self.names}

    @property
    def width(self) -> int:
        return len(self.names)

    def column(self, name: str) -> Column:
        try:
            return self.cols[name]
        except KeyError:
            raise ColumnNotFoundError(
                f"{name!r} not found; available: {self.names}") from None

    # --- live rows -------------------------------------------------------
    def row_mask(self) -> torch.Tensor:
        """Bool (capacity,) mask of live rows (device-only, never syncs)."""
        if self.valid is not None:
            return self.valid
        idx = torch.arange(self.capacity, device=self.device)
        if self._nrows is not None:
            return idx < self._nrows
        if self.nrows_dev is not None:
            return idx < self.nrows_dev
        return idx < 0

    def live_key(self):
        """What identifies the live rows: the mask tensor, the host row
        count or the device row count. Cached stats remember it."""
        if self.valid is not None:
            return self.valid
        return self._nrows if self._nrows is not None else self.nrows_dev

    def count_rows(self) -> int:
        """Host-synced live row count (caches into nrows)."""
        if self._nrows is None:
            if self.valid is not None:
                self._nrows = int(self.valid.sum())
            elif self.nrows_dev is not None:
                self._nrows = int(self.nrows_dev)
        return self._nrows

    # --- structural ops (no device compute) ------------------------------
    def select_columns(self, names: Sequence[str]) -> "Table":
        for n in names:
            if n not in self.cols:
                raise ColumnNotFoundError(
                    f"{n!r} not found; available: {self.names}")
        return Table(list(names), {n: self.cols[n] for n in names},
                     self.capacity, self._nrows, self.valid,
                     nrows_dev=self.nrows_dev, device=self.device)

    def drop_columns(self, names: Sequence[str]) -> "Table":
        drop = set(names)
        return self.select_columns([n for n in self.names if n not in drop])

    def rename(self, mapping: Dict[str, str], strict: bool = True
               ) -> "Table":
        for old in mapping:
            if old not in self.cols and strict:
                raise ColumnNotFoundError(f"{old!r} not found")
        new_names = [mapping.get(n, n) for n in self.names]
        if len(set(new_names)) != len(new_names):
            raise DuplicateError(
                f"duplicate column names after rename: {new_names}")
        cols = {mapping.get(n, n): c for n, c in self.cols.items()}
        return Table(new_names, cols, self.capacity, self._nrows, self.valid,
                     nrows_dev=self.nrows_dev, device=self.device)

    def with_column(self, name: str, col: Column) -> "Table":
        if col.capacity != self.capacity and self.width > 0:
            raise ShapeError(f"column capacity {col.capacity} != table "
                             f"capacity {self.capacity}")
        cols = dict(self.cols)
        names = list(self.names)
        if name not in cols:
            names.append(name)
        cols[name] = col
        return Table(names, cols, self.capacity, self._nrows, self.valid,
                     nrows_dev=self.nrows_dev, device=self.device)

    def with_valid(self, valid: Optional[torch.Tensor],
                   nrows: Optional[int],
                   nrows_dev: Optional[torch.Tensor] = None) -> "Table":
        return Table(self.names, self.cols, self.capacity, nrows, valid,
                     nrows_dev=nrows_dev, device=self.device)

    # --- host materialization ------------------------------------------
    def to_numpy_dict(self) -> Dict[str, np.ndarray]:
        n = self.count_rows()
        vmask = self.valid.cpu().numpy() if self.valid is not None else None
        out = {}
        for name in self.names:
            c = self.cols[name]
            out[name] = c.to_numpy(self.capacity, vmask) \
                if vmask is not None else c.to_numpy(n)
        return out

    def __repr__(self) -> str:
        n = self._nrows if self._nrows is not None else \
            ("deferred" if self.nrows_dev is not None else "?")
        body = ", ".join(f"{k}: {v!r}" for k, v in self.schema.items())
        return f"Table[{n} rows, cap {self.capacity}]({body})"
