"""Data type system.

Logical dtypes with physical on-device representations, mirroring the
capability surface of the reference's dtype system
(`crates/polars-core/src/datatypes/`, `crates/polars-dtype/`):
ints/uints/floats/bool/utf8/categorical/temporal types, plus
supertype resolution used by the type coercion pass
(`polars-plan/src/plans/conversion/type_coercion/`).

Physical mapping (see `batch.storage_torch_dtype` for the torch side):
  * numerics map to the same-width dtype; Float64 stays float64
  * Boolean -> bool_
  * String/Categorical -> int32 codes into a host-side sorted dictionary
    (`strings.py`); sorted dictionaries make code order == string order,
    so comparisons/sorts/joins run on the device codes
  * Date -> int32 days since epoch; Datetime/Duration/Time -> int64
    us/ns counts
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from .errors import SchemaError

__all__ = [
    "DataType", "Int8", "Int16", "Int32", "Int64", "UInt8", "UInt16",
    "UInt32", "UInt64", "Float32", "Float64", "Boolean", "String", "Utf8",
    "Categorical", "Date", "Datetime", "Duration", "Time", "Null",
    "List", "Struct",
    "dtype_from_numpy", "supertype", "physical_numpy_dtype",
    "NUMERIC_DTYPES", "INTEGER_DTYPES", "FLOAT_DTYPES",
]


class DataType:
    """Base logical data type. Parametric types override __eq__/__hash__."""

    _name: str = "unknown"

    def __repr__(self) -> str:
        return self._name

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, type) and issubclass(other, DataType):
            other = other()  # allow `dt == pl.Int64` style with classes
        return isinstance(other, DataType) and repr(self) == repr(other)

    def __hash__(self) -> int:
        return hash(repr(self))

    # --- classification -------------------------------------------------
    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_float

    @property
    def is_integer(self) -> bool:
        return self._name.startswith(("Int", "UInt"))

    @property
    def is_signed_integer(self) -> bool:
        return self._name.startswith("Int")

    @property
    def is_unsigned_integer(self) -> bool:
        return self._name.startswith("UInt")

    @property
    def is_float(self) -> bool:
        return self._name.startswith("Float")

    @property
    def is_temporal(self) -> bool:
        return self._name.startswith(("Date", "Datetime", "Duration", "Time"))

    @property
    def is_string(self) -> bool:
        # "dictionary-coded variable-length" — Binary shares the whole
        # code-based kernel path (sort/group/join/filter) with String
        return self._name in ("String", "Categorical", "Binary")

    @property
    def is_binary(self) -> bool:
        return self._name == "Binary"

    @property
    def is_bool(self) -> bool:
        return self._name == "Boolean"

    @property
    def is_nested(self) -> bool:
        return False

    def bit_width(self) -> int:
        return {"Int8": 8, "Int16": 16, "Int32": 32, "Int64": 64,
                "UInt8": 8, "UInt16": 16, "UInt32": 32, "UInt64": 64,
                "Float32": 32, "Float64": 64, "Boolean": 1}.get(self._name, 0)


def _simple(name: str) -> type:
    cls = type(name, (DataType,), {"_name": name})
    return cls


Int8 = _simple("Int8")()
Int16 = _simple("Int16")()
Int32 = _simple("Int32")()
Int64 = _simple("Int64")()
UInt8 = _simple("UInt8")()
UInt16 = _simple("UInt16")()
UInt32 = _simple("UInt32")()
UInt64 = _simple("UInt64")()
Float32 = _simple("Float32")()
Float64 = _simple("Float64")()
Boolean = _simple("Boolean")()
Null = _simple("Null")()
Time = _simple("Time")()  # int64 nanoseconds since midnight


class _String(DataType):
    _name = "String"


String = _String()
Utf8 = String  # polars alias


class Categorical(DataType):
    _name = "Categorical"

    def __init__(self, ordering: str = "lexical") -> None:
        self.ordering = ordering


class _Date(DataType):
    _name = "Date"


Date = _Date()


class Datetime(DataType):
    def __init__(self, time_unit: str = "us", time_zone: Optional[str] = None):
        if time_unit not in ("ms", "us", "ns"):
            raise SchemaError(f"invalid time unit {time_unit!r}")
        self.time_unit = time_unit
        self.time_zone = time_zone

    @property
    def _name(self) -> str:  # type: ignore[override]
        tz = f", {self.time_zone}" if self.time_zone else ""
        return f"Datetime({self.time_unit}{tz})"


class Duration(DataType):
    def __init__(self, time_unit: str = "us"):
        if time_unit not in ("ms", "us", "ns"):
            raise SchemaError(f"invalid time unit {time_unit!r}")
        self.time_unit = time_unit

    @property
    def _name(self) -> str:  # type: ignore[override]
        return f"Duration({self.time_unit})"


class List(DataType):
    """Nested list type.

    Physical layout (vs the reference's Arrow offsets+child,
    `polars-arrow/src/array/list/`): a list column is a fixed-width padded
    2-D device array `(capacity, width)` of the inner physical dtype plus a
    per-row `lengths` int32 vector. The port has no list columns yet.
    """

    def __init__(self, inner: DataType):
        if isinstance(inner, type) and issubclass(inner, DataType):
            inner = inner()
        self.inner = inner

    @property
    def _name(self) -> str:  # type: ignore[override]
        return f"List({self.inner!r})"

    @property
    def is_nested(self) -> bool:
        return True


class Struct(DataType):
    """Nested struct type: named fields, stored as parallel child columns
    (the reference's `polars-arrow/src/array/struct_/` equivalent — struct
    of arrays, never array of structs)."""

    def __init__(self, fields):
        # accepts {name: dtype} or [(name, dtype)] or [Field-like]
        if isinstance(fields, dict):
            items = list(fields.items())
        else:
            items = [(f[0], f[1]) if isinstance(f, (tuple, list))
                     else (f.name, f.dtype) for f in fields]
        norm = []
        for n, d in items:
            if isinstance(d, type) and issubclass(d, DataType):
                d = d()
            norm.append((n, d))
        self.fields = norm

    @property
    def _name(self) -> str:  # type: ignore[override]
        body = ", ".join(f"{n!r}: {d!r}" for n, d in self.fields)
        return f"Struct({{{body}}})"

    @property
    def is_nested(self) -> bool:
        return True

    def field_dtype(self, name: str) -> "DataType":
        for n, d in self.fields:
            if n == name:
                return d
        raise SchemaError(f"struct has no field {name!r}")


INTEGER_DTYPES = [Int8, Int16, Int32, Int64, UInt8, UInt16, UInt32, UInt64]
FLOAT_DTYPES = [Float32, Float64]
NUMERIC_DTYPES = INTEGER_DTYPES + FLOAT_DTYPES

_NP_TO_DT = {
    np.dtype("int8"): Int8, np.dtype("int16"): Int16,
    np.dtype("int32"): Int32, np.dtype("int64"): Int64,
    np.dtype("uint8"): UInt8, np.dtype("uint16"): UInt16,
    np.dtype("uint32"): UInt32, np.dtype("uint64"): UInt64,
    np.dtype("float32"): Float32, np.dtype("float64"): Float64,
    np.dtype("bool"): Boolean,
}

_DT_TO_NP = {
    "Int8": np.int8, "Int16": np.int16, "Int32": np.int32, "Int64": np.int64,
    "UInt8": np.uint8, "UInt16": np.uint16, "UInt32": np.uint32,
    "UInt64": np.uint64, "Float32": np.float32, "Float64": np.float64,
    "Boolean": np.bool_, "String": np.int32, "Categorical": np.int32,
    "Binary": np.int32, "Date": np.int32, "Time": np.int64,
    "Null": np.bool_,
}


def dtype_from_numpy(np_dtype: np.dtype) -> DataType:
    np_dtype = np.dtype(np_dtype)
    if np_dtype in _NP_TO_DT:
        return _NP_TO_DT[np_dtype]
    if np_dtype.kind in ("U", "S", "O"):
        return String
    if np_dtype.kind == "M":  # datetime64
        unit = np.datetime_data(np_dtype)[0]
        if unit == "D":
            return Date
        return Datetime(unit if unit in ("ms", "us", "ns") else "us")
    if np_dtype.kind == "m":
        unit = np.datetime_data(np_dtype)[0]
        return Duration(unit if unit in ("ms", "us", "ns") else "us")
    raise SchemaError(f"unsupported numpy dtype: {np_dtype}")


def physical_numpy_dtype(dt: DataType) -> np.dtype:
    """The on-device physical storage dtype for a logical dtype."""
    if isinstance(dt, type) and issubclass(dt, DataType):
        dt = dt()  # allow bare classes like pl.Categorical in schemas
    name = repr(dt)
    if name.startswith("Datetime") or name.startswith("Duration"):
        return np.dtype(np.int64)
    if name.startswith("List"):
        raise SchemaError("List has no flat physical dtype")
    try:
        return np.dtype(_DT_TO_NP[name])
    except KeyError:
        raise SchemaError(f"no physical dtype for {name}") from None


_INT_RANK = {repr(d): i for i, d in enumerate([Int8, Int16, Int32, Int64])}
_UINT_RANK = {repr(d): i for i, d in enumerate([UInt8, UInt16, UInt32, UInt64])}
_SIGNED_FOR_UINT = [Int16, Int32, Int64, Int64]


def supertype(a: DataType, b: DataType) -> DataType:
    """Least common supertype, following the reference's coercion rules
    (`polars-core/src/utils/supertype.rs` semantics): int+float -> float,
    signed+unsigned -> wider signed, bool promotes to any numeric,
    Null promotes to anything, temporal types match on unit.
    """
    if a == b:
        return a
    if a == Null:
        return b
    if b == Null:
        return a
    if a.is_bool and b.is_numeric:
        return b
    if b.is_bool and a.is_numeric:
        return a
    if a.is_string and b.is_string:
        if a.is_binary != b.is_binary:
            raise SchemaError(f"no supertype of {a!r} and {b!r}")
        return Binary() if a.is_binary else String
    if a.is_numeric and b.is_numeric:
        if a.is_float and b.is_float:
            return Float64
        if a.is_float:
            return a if a == Float64 or b.bit_width() <= 16 else Float64
        if b.is_float:
            return b if b == Float64 or a.bit_width() <= 16 else Float64
        if a.is_signed_integer and b.is_signed_integer:
            return a if _INT_RANK[repr(a)] >= _INT_RANK[repr(b)] else b
        if a.is_unsigned_integer and b.is_unsigned_integer:
            return a if _UINT_RANK[repr(a)] >= _UINT_RANK[repr(b)] else b
        # mixed signedness -> signed type one rank wider than the uint
        u, s = (a, b) if a.is_unsigned_integer else (b, a)
        cand = _SIGNED_FOR_UINT[_UINT_RANK[repr(u)]]
        return cand if _INT_RANK[repr(cand)] >= _INT_RANK[repr(s)] else s
    if isinstance(a, Datetime) and isinstance(b, Datetime):
        order = {"ms": 0, "us": 1, "ns": 2}
        tu = a.time_unit if order[a.time_unit] >= order[b.time_unit] else b.time_unit
        return Datetime(tu, a.time_zone or b.time_zone)
    if isinstance(a, Duration) and isinstance(b, Duration):
        order = {"ms": 0, "us": 1, "ns": 2}
        tu = a.time_unit if order[a.time_unit] >= order[b.time_unit] else b.time_unit
        return Duration(tu)
    if (a == Date and isinstance(b, Datetime)):
        return b
    if (b == Date and isinstance(a, Datetime)):
        return a
    if isinstance(a, List) and isinstance(b, List):
        return List(supertype(a.inner, b.inner))
    raise SchemaError(f"no supertype of {a!r} and {b!r}")


# --- additional py-polars dtype surface -----------------------------------

class Array(List):
    """Fixed-size list (reference: polars Array). Our list layout is
    already fixed-width padded, so Array shares List's kernels; `size`
    is kept for schema fidelity."""
    _name = "Array"

    def __init__(self, inner=None, size: int = 0, shape=None) -> None:
        if isinstance(inner, type) and inner is not None and \
                issubclass(inner, DataType):
            inner = inner()
        List.__init__(self, inner if inner is not None else Null)
        if shape is not None:
            size = shape if isinstance(shape, int) else int(shape[0])
        self.size = int(size)


class Enum(Categorical):
    """Fixed-category categorical (reference: polars Enum)."""
    _name = "Enum"

    def __init__(self, categories=None) -> None:
        Categorical.__init__(self, "physical")
        self.categories = list(categories) if categories is not None else []


class Binary(DataType):
    _name = "Binary"


class _Decimal(DataType):
    """Decimal(precision, scale) — stored as Float64 (documented
    approximation; exact decimal arithmetic is a future round)."""
    _name = "Decimal"

    def __init__(self, precision=None, scale: int = 0) -> None:
        self.precision = precision
        self.scale = scale


Decimal = _Decimal
Object = _simple("Object")()
Unknown = _simple("Unknown")()
Int128 = _simple("Int128")()
UInt128 = _simple("UInt128")()
Float16 = _simple("Float16")()


class Field:
    """Struct field spec (reference: polars Field)."""

    def __init__(self, name: str, dtype) -> None:
        self.name = name
        self.dtype = dtype() if isinstance(dtype, type) else dtype

    def __repr__(self) -> str:
        return f"Field({self.name!r}, {self.dtype!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Field) and other.name == self.name \
            and other.dtype == self.dtype


class Schema(dict):
    """Ordered name -> dtype mapping (reference: polars Schema,
    `crates/polars-schema/src/schema.rs`)."""

    def __init__(self, mapping=None, **named) -> None:
        items = []
        if mapping is not None:
            items = list(mapping.items()) if isinstance(mapping, dict) \
                else list(mapping)
        items += list(named.items())
        super().__init__(
            (n, d() if isinstance(d, type) else d) for n, d in items)

    def names(self):
        return list(self.keys())

    def dtypes(self):
        return list(self.values())

    def len(self) -> int:
        return len(self)

    def to_python(self) -> dict:
        import datetime as _dt
        py = {"Int": int, "UInt": int, "Float": float, "Boolean": bool,
              "String": str}
        out = {}
        for n, d in self.items():
            r = repr(d)
            if r.startswith(("Int", "UInt")):
                out[n] = int
            elif r.startswith("Float"):
                out[n] = float
            elif r == "Boolean":
                out[n] = bool
            elif r == "String":
                out[n] = str
            elif r == "Date":
                out[n] = _dt.date
            elif r.startswith("Datetime"):
                out[n] = _dt.datetime
            else:
                out[n] = object
        return out


class BaseExtension(DataType):
    """Base class for extension data types (reference:
    `py-polars/src/polars/datatypes/classes.py:1305`): a logical wrapper
    around a storage dtype plus free-form metadata."""

    _name = "Extension"

    def __init__(self, name: str, storage, metadata=None) -> None:
        if isinstance(storage, type) and issubclass(storage, DataType):
            storage = storage()
        self._ext_name = name
        self._storage = storage
        self._metadata = metadata

    @classmethod
    def ext_from_params(cls, name, storage, metadata):
        """Create an instance from raw parameters."""
        slf = cls.__new__(cls)
        slf._ext_name = name
        slf._storage = storage
        slf._metadata = metadata
        return slf

    @property
    def ext_name(self) -> str:
        return self._ext_name

    @property
    def storage(self):
        return self._storage

    @property
    def metadata(self):
        return self._metadata

    def __repr__(self):
        return f"Extension({self._ext_name!r}, {self._storage!r})"

    def __eq__(self, other):
        return (isinstance(other, BaseExtension)
                and other._ext_name == self._ext_name
                and repr(other._storage) == repr(self._storage))

    def __hash__(self):
        return hash(("ext", self._ext_name, repr(self._storage)))


class Extension(BaseExtension):
    """Generic opaque extension type (reference:
    polars.datatypes.Extension)."""


_EXTENSION_REGISTRY: dict = {}


def register_extension_type(ext_name: str, ext_class=None, *,
                            as_storage: bool = False) -> None:
    """Register an extension type under `ext_name` (reference:
    `py-polars/src/polars/datatypes/extension.py:15`)."""
    if ext_name in _EXTENSION_REGISTRY:
        raise ValueError(
            f"extension type {ext_name!r} is already registered")
    if as_storage:
        if ext_class is not None:
            raise ValueError(
                "cannot specify ext_class when as_storage is True")
        _EXTENSION_REGISTRY[ext_name] = "storage"
        return
    if not (isinstance(ext_class, type)
            and issubclass(ext_class, BaseExtension)):
        raise TypeError("ext_class must be a BaseExtension subclass")
    _EXTENSION_REGISTRY[ext_name] = ext_class


def unregister_extension_type(ext_name: str) -> None:
    """Remove a registered extension type (reference:
    `py-polars/src/polars/datatypes/extension.py:47`)."""
    _EXTENSION_REGISTRY.pop(ext_name, None)


def get_extension_type(ext_name: str):
    """Look up a registered extension type; 'storage' means pass-through
    (reference: `py-polars/src/polars/datatypes/extension.py:60`)."""
    return _EXTENSION_REGISTRY.get(ext_name)
