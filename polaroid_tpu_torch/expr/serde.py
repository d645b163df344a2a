"""Expression serialization (JSON-able dicts).

The port of the JAX package's `expr/serde.py` (the reference's
serializable DslPlan, `polars-plan/src/dsl/plan.rs`): an expression
round-trips through plain dicts in the JAX package's format, so the
same expression gives the same JSON text in both packages and either
package loads the other's. numpy only.
"""

from __future__ import annotations

import base64
import datetime as _pydt
from typing import Any, Dict, Optional

import numpy as np

from ..dtypes import (Boolean, Categorical, DataType, Date, Datetime,
                      Duration, Float32, Float64, Int8, Int16, Int32, Int64,
                      Null, String, Time, UInt8, UInt16, UInt32, UInt64)
from ..errors import ComputeError
from .expr import Expr

FORMAT_VERSION = 1

_SIMPLE_DTYPES = {
    "Int8": Int8, "Int16": Int16, "Int32": Int32, "Int64": Int64,
    "UInt8": UInt8, "UInt16": UInt16, "UInt32": UInt32, "UInt64": UInt64,
    "Float32": Float32, "Float64": Float64, "Boolean": Boolean,
    "String": String, "Date": Date, "Time": Time, "Null": Null,
}


def dtype_to_obj(dt: Optional[DataType]):
    if dt is None:
        return None
    name = repr(dt)
    if name in _SIMPLE_DTYPES:
        return name
    if isinstance(dt, Datetime):
        return {"Datetime": [dt.time_unit, dt.time_zone]}
    if isinstance(dt, Duration):
        return {"Duration": dt.time_unit}
    if isinstance(dt, Categorical):
        return "String"
    raise ComputeError(f"cannot serialize dtype {name}")


def dtype_from_obj(o) -> Optional[DataType]:
    if o is None:
        return None
    if isinstance(o, str):
        return _SIMPLE_DTYPES[o]
    if "Datetime" in o:
        tu, tz = o["Datetime"]
        return Datetime(tu, tz)
    if "Duration" in o:
        return Duration(o["Duration"])
    raise ComputeError(f"cannot deserialize dtype {o!r}")


def _value_to_obj(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, DataType):
        return {"$dtype": dtype_to_obj(v)}
    if isinstance(v, _pydt.datetime):
        return {"$datetime": v.isoformat()}
    if isinstance(v, _pydt.date):
        return {"$date": v.isoformat()}
    if isinstance(v, _pydt.timedelta):
        return {"$timedelta": v.total_seconds()}
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return {"$ndarray": {"dtype": str(v.dtype),
                             "data": base64.b64encode(v.tobytes()).decode(),
                             "shape": list(v.shape)}}
    if isinstance(v, (list, tuple)):
        return {"$list": [_value_to_obj(x) for x in v]}
    raise ComputeError(f"cannot serialize expr attr value {v!r}")


def _value_from_obj(o):
    if not isinstance(o, dict):
        return o
    if "$dtype" in o:
        return dtype_from_obj(o["$dtype"])
    if "$datetime" in o:
        return _pydt.datetime.fromisoformat(o["$datetime"])
    if "$date" in o:
        return _pydt.date.fromisoformat(o["$date"])
    if "$timedelta" in o:
        return _pydt.timedelta(seconds=o["$timedelta"])
    if "$ndarray" in o:
        d = o["$ndarray"]
        return np.frombuffer(base64.b64decode(d["data"]),
                             dtype=np.dtype(d["dtype"])).reshape(d["shape"])
    if "$list" in o:
        return tuple(_value_from_obj(x) for x in o["$list"])
    return o


def expr_to_dict(e: Expr) -> Dict[str, Any]:
    attrs = {}
    for k, v in e.attrs.items():
        if callable(v) and not isinstance(v, DataType):
            raise ComputeError("cannot serialize expression with a Python "
                               "callable (map_batches)")
        attrs[k] = _value_to_obj(v)
    return {"kind": e.kind,
            "children": [expr_to_dict(c) for c in e.children],
            "attrs": attrs}


def expr_from_dict(d: Dict[str, Any]) -> Expr:
    children = tuple(expr_from_dict(c) for c in d.get("children", []))
    attrs = {k: _value_from_obj(v) for k, v in d.get("attrs", {}).items()}
    return Expr(d["kind"], children, **attrs)


def exprs_to_obj(exprs) -> list:
    return [expr_to_dict(e) for e in exprs]


def exprs_from_obj(obj) -> list:
    return [expr_from_dict(d) for d in obj]
