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
  UInt64 values at or above 2^63 wrap to negative int64.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .config import CONFIG, capacity_for
from .dtypes import (
    Boolean, DataType, Datetime, Duration, Float64, Int64, Null, String,
    dtype_from_numpy, physical_numpy_dtype,
)
from .errors import ColumnNotFoundError, ShapeError
from .strings import NULL_CODE, StringDict

__all__ = ["Column", "Table", "resolve_device", "storage_torch_dtype"]

_STORAGE = {
    "Int8": torch.int8, "Int16": torch.int16, "Int32": torch.int32,
    "Int64": torch.int64, "UInt8": torch.uint8, "UInt16": torch.int32,
    "UInt32": torch.int64, "UInt64": torch.int64, "Float32": torch.float32,
    "Float64": torch.float64, "Boolean": torch.bool, "String": torch.int32,
    "Categorical": torch.int32, "Binary": torch.int32, "Date": torch.int32,
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
        raise NotImplementedError(
            f"{name} columns are not ported yet") from None


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
    give the group-by a dense key domain (see exec/executor.py)."""

    __slots__ = ("dtype", "data", "validity", "sdict", "stats")

    def __init__(self, dtype: DataType, data: torch.Tensor,
                 validity: Optional[torch.Tensor] = None,
                 sdict: Optional[StringDict] = None,
                 stats: Optional[dict] = None):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.sdict = sdict
        self.stats = stats

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def take(self, perm: torch.Tensor) -> "Column":
        return Column(self.dtype, self.data[perm],
                      self.validity[perm] if self.validity is not None
                      else None, self.sdict)

    @staticmethod
    def from_host(values, dtype: Optional[DataType] = None,
                  capacity: Optional[int] = None,
                  device: Optional[torch.device] = None,
                  validity: Optional[np.ndarray] = None) -> "Column":
        """Build a column from host values (a numpy array or a list with
        None for nulls), padded to `capacity`. `validity` marks the
        non-null rows of a numpy array."""
        if isinstance(dtype, type) and issubclass(dtype, DataType):
            dtype = dtype()
        device = resolve_device(device)
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
        """Host copy of the live rows (object array when nulls/strings)."""
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
            return self.sdict.decode(codes)
        if repr(self.dtype) == "Date":
            out = data.astype("datetime64[D]").astype(object)
        elif isinstance(self.dtype, Datetime):
            out = data.astype(f"datetime64[{self.dtype.time_unit}]")
        elif isinstance(self.dtype, Duration):
            out = data.astype(f"timedelta64[{self.dtype.time_unit}]")
        else:
            out = data
        if vmask is not None and not vmask.all():
            out = np.asarray(out, dtype=object)
            out[~vmask] = None
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
        elif isinstance(v0, (str, bytes)):
            dt = String
        else:
            raise NotImplementedError(
                f"host values of type {type(v0).__name__} are not ported yet")
    if dt.is_string:
        codes, sdict = StringDict.encode(np.asarray(seq, dtype=object), mask)
        return codes, mask, dt, sdict
    if dt == Null:
        return np.zeros(len(seq), dtype=bool), mask, Boolean, None
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
            device = next(iter(cols.values())).data.device if cols \
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
