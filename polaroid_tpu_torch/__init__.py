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
columns, `implode`, `explode` and `unnest`, and the rest of the
expression and frame surface: SQL (`SQLContext`, `pl.sql`,
`DataFrame.sql`), `pl.selectors`, the top-level expression functions,
the distinct flags, `cut`/`qcut`/`hist`, sampling, the host UDFs,
`pivot`/`unpivot` and the frame and series helpers. File IO,
serialization, streaming and the distributed engine come with later
slices (see ROADMAP.md).
"""

from __future__ import annotations

from .config import CONFIG, _ConfigProxy
Config = _ConfigProxy()  # usable as pl.Config.device = "cpu" and as a ctx mgr
from .dtypes import (  # noqa: E402
    Boolean, DataType, Date, Datetime, Decimal, Duration, Float16, Float32,
    Float64, Int8, Int16, Int32, Int64, Int128, Null, Object, Schema,
    String, UInt8, UInt16, UInt32, UInt64, UInt128, Unknown, Utf8,
)
from .errors import (  # noqa: E402
    ColumnNotFoundError, ComputeError, DuplicateError, InvalidOperationError,
    NoDataError, OutOfBoundsError, PolaroidError, SchemaError, ShapeError,
    SQLInterfaceError, SQLSyntaxError,
)
from .expr.expr import Expr, col, len_ as len, lit, nth, when  # noqa: E402
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
from .api.functions import (  # noqa: E402
    align_frames, all, all_horizontal, any, any_horizontal, approx_n_unique,
    arange, arctan2, arctan2d, arg_sort_by, arg_where, build_info,
    business_day_count, Categories, coalesce, collect_all, collect_all_async,
    concat_arr, count,
    cum_count, cum_fold, cum_reduce, cum_sum, cum_sum_horizontal,
    disable_string_cache, enable_string_cache, exclude, explain_all, first,
    fold, from_dicts, from_numpy, from_records, from_repr, from_torch,
    get_index_type, GPUEngine, groups, head, int_range, json_normalize, last,
    linear_space, linear_spaces, map_batches, map_groups, max,
    max_horizontal, mean, mean_horizontal, median, min, min_horizontal,
    n_unique, ones, quantile, QueryOptFlags, reduce, repeat, select,
    set_random_seed, show_versions, sql_expr, std, StringCache, sum,
    sum_horizontal, tail, thread_pool_size, threadpool_size, union,
    using_string_cache, var, zeros,
)
from .dtypes import BaseExtension, Extension, get_extension_type, \
    register_extension_type, unregister_extension_type  # noqa: E402
from .datatype_expr import DataTypeExpr, dtype_of, self_dtype, \
    struct_with_fields  # noqa: E402
from . import datatype_expr, exceptions, monads, plugins, selectors, \
    testing, timeseries  # noqa: E402
from .sql.context import SQLContext  # noqa: E402
# bound after the sql subpackage is imported, so that the function wins
# over the module attribute (polars exposes `pl.sql` as a function)
from .api.functions import sql  # noqa: E402

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
    "Struct", "SQLContext", "sql", "selectors", "all", "any", "min", "max",
    "sum", "mean", "median", "std", "var", "count", "first", "last", "nth",
    "coalesce", "exclude", "select", "fold", "reduce", "int_range",
    "arange", "repeat", "from_dicts", "from_numpy", "from_records",
    "min_horizontal", "max_horizontal", "sum_horizontal",
    "mean_horizontal",
    "Int8", "Int16", "Int32", "Int64", "UInt8", "UInt16", "UInt32", "UInt64",
    "Float32", "Float64", "Boolean", "String", "Utf8", "Date", "Datetime",
    "Duration", "Null", "DataType",
    "PolaroidError", "ColumnNotFoundError", "ComputeError", "SchemaError",
    "ShapeError", "InvalidOperationError", "DuplicateError",
]
