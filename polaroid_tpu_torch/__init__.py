"""polaroid_tpu_torch: the PyTorch/CUDA port of polaroid-tpu.

The same polars-style API as the JAX package (`import polaroid_tpu_torch
as pl`), on torch tensors. Frames live on the CUDA device unless the
caller asks for the CPU (`device="cpu"`, or `Config.device = "cpu"`);
without a card the default raises. The hot kernels are hand-written CUDA
for Hopper (csrc/), built with nvcc at first use.

This first slice runs filter -> with_columns -> group_by(small key
domain) -> agg(len / count / sum / mean) -> collect. The rest of the
JAX package's surface comes with later slices (see ROADMAP.md).
"""

from __future__ import annotations

from .config import CONFIG, _ConfigProxy
Config = _ConfigProxy()  # usable as pl.Config.device = "cpu" and as a ctx mgr
from .dtypes import (  # noqa: E402
    Boolean, DataType, Date, Datetime, Duration, Float32, Float64, Int8,
    Int16, Int32, Int64, Null, String, UInt8, UInt16, UInt32, UInt64, Utf8,
)
from .errors import (  # noqa: E402
    ColumnNotFoundError, ComputeError, DuplicateError, InvalidOperationError,
    PolaroidError, SchemaError, ShapeError,
)
from .expr.expr import Expr, col, len_ as len, lit  # noqa: E402
from .api.frame import DataFrame  # noqa: E402
from .api.series import Series  # noqa: E402
from .api.lazyframe import LazyFrame  # noqa: E402
from .api.functions import from_dict  # noqa: E402
from . import testing  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "DataFrame", "LazyFrame", "Series", "Expr", "Config", "CONFIG",
    "col", "lit", "len", "from_dict",
    "Int8", "Int16", "Int32", "Int64", "UInt8", "UInt16", "UInt32", "UInt64",
    "Float32", "Float64", "Boolean", "String", "Utf8", "Date", "Datetime",
    "Duration", "Null", "DataType",
    "PolaroidError", "ColumnNotFoundError", "ComputeError", "SchemaError",
    "ShapeError", "InvalidOperationError", "DuplicateError",
]
