"""polaroid_tpu_torch: the PyTorch/CUDA port of polaroid-tpu.

The same polars-style API as the JAX package (`import polaroid_tpu_torch
as pl`), on torch tensors. Frames live on the CUDA device unless the
caller asks for the CPU (`device="cpu"`, or `Config.device = "cpu"`);
without a card the default raises. The hot kernels are hand-written CUDA
for Hopper (csrc/), built with nvcc at first use.

The port runs filter -> with_columns -> group_by -> agg -> collect over
any key (the dense, hash and sorted tiers, with median, quantile,
n_unique, mode, arg_min/arg_max, product and corr/cov), unique, sort,
top_k, head, equi-joins of every kind (`join`), `concat`, and the
order-dependent window expressions (shift, cum_*, rolling, ewm, rank,
fills) with `.over()`, and time: temporal casts and arithmetic, the `dt`
namespace with time zones, range windows (`rolling_*_by`),
`group_by_dynamic`, `rolling`, `upsample`, `when/then` and the finance
functions of `timeseries`, the as-of and inequality joins (`join_asof`,
`join_where`), and the select context: aggregates over the whole column,
the unary math, `clip`, `is_in`, `is_between`, `sort_by` and the frame
reductions, and strings and nested columns: the `str`, `bin`, `list`
and `struct` namespaces, String casts, `concat_str`, List and Struct
columns, `implode`, `explode` and `unnest`. The rest of the JAX package's surface comes with later
slices (see ROADMAP.md).
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
from .expr.expr import Expr, col, len_ as len, lit, when  # noqa: E402
from .api.frame import DataFrame  # noqa: E402
from .api.series import Series  # noqa: E402
from .api.lazyframe import LazyFrame  # noqa: E402
from .api.functions import concat, corr, cov, from_dict, rolling_corr, \
    rolling_cov, row_index  # noqa: E402
from .api.functions import date, date_range, date_ranges, datetime, \
    datetime_range, datetime_ranges, duration, from_epoch, time, \
    time_range, time_ranges  # noqa: E402
from .api.functions import concat_list, concat_str, element, \
    escape_regex, field, format, implode, int_ranges, struct  # noqa: E402
from .dtypes import Array, Binary, Categorical, Enum, Field, List, \
    Struct, Time  # noqa: E402
from . import exceptions, testing, timeseries  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "DataFrame", "LazyFrame", "Series", "Expr", "Config", "CONFIG",
    "col", "lit", "len", "from_dict", "corr", "cov", "concat", "row_index",
    "rolling_cov", "rolling_corr", "when", "date", "date_range",
    "date_ranges", "datetime", "datetime_range", "datetime_ranges",
    "duration", "from_epoch", "time", "time_range", "time_ranges",
    "timeseries", "Time", "exceptions", "concat_list", "concat_str",
    "element", "escape_regex", "field", "format", "implode", "int_ranges",
    "struct", "Array", "Binary", "Categorical", "Enum", "Field", "List",
    "Struct",
    "Int8", "Int16", "Int32", "Int64", "UInt8", "UInt16", "UInt32", "UInt64",
    "Float32", "Float64", "Boolean", "String", "Utf8", "Date", "Datetime",
    "Duration", "Null", "DataType",
    "PolaroidError", "ColumnNotFoundError", "ComputeError", "SchemaError",
    "ShapeError", "InvalidOperationError", "DuplicateError",
]
