"""Expression metadata: expansion, naming, dtype inference, classification.

The planner-facing half of expressions — capability analogue of the
reference's expr IR utilities (`polars-plan/src/plans/aexpr/`,
`is_elementwise_rec_cached` at `polars-stream/src/physical_plan/
lower_expr.rs:91`, output-name/field resolution in
`polars-plan/src/plans/aexpr/schema.rs`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

import datetime as _pydt

from ..dtypes import (
    Boolean, DataType, Date, Datetime, Duration, Float32, Float64, Int32,
    Int64, Null, String, UInt32, supertype,
)
from ..errors import ColumnNotFoundError, ComputeError, SchemaError
from .expr import Expr, WhenThen

__all__ = [
    "expand_exprs", "output_name", "root_names", "output_dtype",
    "is_elementwise", "has_agg", "is_scalar_expr",
]

_EXPANSION_KINDS = ("wildcard", "cols", "dtype_cols", "nth", "selector")


def _find_expansion(e: Expr) -> Optional[Expr]:
    if e.kind in _EXPANSION_KINDS:
        return e
    for c in e.children:
        r = _find_expansion(c)
        if r is not None:
            return r
    return None


def _substitute(e: Expr, target: Expr, repl: Expr) -> Expr:
    if e is target:
        return repl
    if not e.children:
        return e
    new_children = tuple(_substitute(c, target, repl) for c in e.children)
    return Expr(e.kind, new_children, **e.attrs)


def expand_exprs(exprs: Sequence, schema: Dict[str, DataType]) -> List[Expr]:
    """Expand wildcard/cols/dtype-selector expressions against a schema:
    `pl.col("*").sum()` -> one sum-expr per column (reference:
    `polars-plan/src/plans/conversion/expr_expansion.rs`)."""
    out: List[Expr] = []
    for e in exprs:
        if isinstance(e, WhenThen):
            e = e._as_expr()
        if isinstance(e, str):
            e = Expr("col", name=e)
        e = _expand_folds(e, schema)
        e, excluded = _strip_excludes(e)
        node = _find_expansion(e)
        if node is None:
            out.append(e)
            continue
        if node.kind == "wildcard":
            names = list(schema.keys())
        elif node.kind == "selector":
            pred = node.attrs["pred"]
            w = len(schema)
            names = [n for i, (n, d) in enumerate(schema.items())
                     if pred(n, d, i, w)]
        elif node.kind == "cols":
            names = list(node.attrs["names"])
        elif node.kind == "nth":
            all_names = list(schema.keys())
            names = [all_names[node.attrs["n"]]]
        else:  # dtype_cols
            want = []
            for d in node.attrs["dtypes"]:
                if isinstance(d, type) and issubclass(d, DataType):
                    d = d()
                want.append(d)
            names = [n for n, dt in schema.items() if any(dt == w for w in want)]
        for name in names:
            if name in excluded:
                continue
            out.append(_substitute(e, node, Expr("col", name=name)))
    return out


def _bind_fields(e: Expr) -> Expr:
    if e.kind == "field":
        return Expr("col", name=f"__pt_field_{e.attrs['name']}")
    if not e.children:
        return e
    return Expr(e.kind, tuple(_bind_fields(c) for c in e.children),
                **e.attrs)


def _strip_excludes(e: Expr):
    """Remove `.exclude(...)` wrappers, returning (expr, excluded-names) —
    the names are dropped from wildcard/cols expansion (reference:
    expr_expansion.rs exclude handling)."""
    excluded: Set[str] = set()

    def walk(node: Expr) -> Expr:
        if node.kind == "exclude":
            excluded.update(node.attrs["names"])
            return walk(node.children[0])
        if not node.children:
            return node
        return Expr(node.kind, tuple(walk(c) for c in node.children),
                    **node.attrs)

    return walk(e), excluded


def output_name(e: Expr) -> str:
    """Leftmost-root naming rule (reference: output_name resolution in
    `polars-plan/src/utils.rs`)."""
    if e.kind == "alias":
        return e.attrs["name"]
    if e.kind == "col":
        return e.attrs["name"]
    if e.kind == "lit":
        return "literal"
    if e.kind == "table_len":
        return "len"
    if e.kind == "row_index":
        return "index"
    if e.kind == "name_map":
        base = output_name(e.children[0])
        how, arg = e.attrs["how"], e.attrs["arg"]
        if how == "prefix":
            return f"{arg}{base}"
        if how == "suffix":
            return f"{base}{arg}"
        if how == "upper":
            return base.upper()
        if how == "map":
            return str(arg(base))
        if how == "replace":
            import re as _re
            pattern, value, literal = arg
            if literal:
                return base.replace(pattern, value)
            return _re.sub(pattern, value, base)
        return base.lower()
    if e.kind == "when_then":
        # name comes from first then-branch value
        nb = e.attrs["n_branches"]
        return output_name(e.children[nb])
    if e.kind == "value_counts":
        return output_name(e.children[0])
    if e.kind == "struct_field":
        return e.attrs["name"]
    for c in e.children:
        try:
            return output_name(c)
        except ComputeError:
            continue
    raise ComputeError(f"cannot determine output name of {e.kind} expression; "
                       "use .alias()")


def strip_top_explode(e: Expr):
    """Split a top-level `.explode()` off an expression (possibly under an
    alias). Returns (expr_without_explode, had_explode) — the planner turns
    `select(col.explode())` into Select + Explode nodes."""
    if e.kind == "alias":
        inner, hit = strip_top_explode(e.children[0])
        if hit:
            return Expr("alias", (inner,), **e.attrs), True
        return e, False
    if e.kind == "explode_expr":
        return e.children[0], True
    return e, False


def root_names(e: Expr, acc: Optional[Set[str]] = None) -> Set[str]:
    if acc is None:
        acc = set()
    if e.kind == "col":
        acc.add(e.attrs["name"])
    for c in e.children:
        root_names(c, acc)
    return acc


def _lit_dtype(value, dtype) -> DataType:
    if dtype is not None:
        return dtype
    if value is None:
        return Null
    if isinstance(value, bool):
        return Boolean
    if isinstance(value, int):
        return Int64
    if isinstance(value, float):
        return Float64
    if isinstance(value, str):
        return String
    if isinstance(value, (bytes, bytearray)):
        from ..dtypes import Binary
        return Binary()
    if isinstance(value, _pydt.datetime):
        return Datetime("us")
    if isinstance(value, _pydt.date):
        return Date
    if isinstance(value, _pydt.timedelta):
        return Duration("us")
    import numpy as np
    if isinstance(value, np.generic):
        from ..dtypes import dtype_from_numpy
        return dtype_from_numpy(value.dtype)
    if isinstance(value, (list, tuple, np.ndarray)):
        return Int64  # gather indices etc.
    raise SchemaError(f"cannot infer literal dtype for {value!r}")


_CMP = {"eq", "neq", "lt", "le", "gt", "ge"}
_BOOL_OPS = {"and", "or", "xor"}

_STR_DTYPES = {
    "len_chars": UInt32, "len_bytes": UInt32, "count_matches": UInt32,
    "to_integer": Int64, "to_decimal": Float64, "starts_with": Boolean,
    "ends_with": Boolean, "contains": Boolean, "to_date": Date,
    "contains_any": Boolean, "find": UInt32,
}

_DT_INT_OPS = {
    "year": Int32, "quarter": Int32, "month": Int32, "day": Int32,
    "ordinal_day": Int32, "weekday": Int32, "week": Int32, "hour": Int32,
    "minute": Int32, "second": Int32, "millisecond": Int32,
    "microsecond": Int32, "nanosecond": Int32, "total_days": Int64,
    "total_hours": Int64, "total_minutes": Int64, "total_seconds": Int64,
    "total_milliseconds": Int64, "total_microseconds": Int64,
    "timestamp": Int64,
}


def output_dtype(e: Expr, schema: Dict[str, DataType]) -> DataType:
    k = e.kind
    if k == "col":
        name = e.attrs["name"]
        if name not in schema:
            raise ColumnNotFoundError(f"{name!r} not found; available: {list(schema)}")
        return schema[name]
    if k == "lit":
        return _lit_dtype(e.attrs["value"], e.attrs["dtype"])
    if k in ("alias", "name_map", "name_keep", "sort_self", "sort_by",
             "expr_filter", "expr_slice", "drop_nulls", "expr_unique",
             "gather", "over", "fill_null_strategy",
             "cse_cached"):
        return output_dtype(e.children[0], schema)
    if k == "explode_expr":
        from ..dtypes import List as ListT
        ct = output_dtype(e.children[0], schema)
        return ct.inner if isinstance(ct, ListT) else ct
    if k == "repeat_by":
        from ..dtypes import List as ListT
        return ListT(output_dtype(e.children[0], schema))
    if k == "int_ranges":
        from ..dtypes import List as ListT
        return ListT(Int64)
    if k == "concat_list":
        from ..dtypes import List as ListT
        inner = None
        for c in e.children:
            d = output_dtype(c, schema)
            d = d.inner if isinstance(d, ListT) else d
            inner = d if inner is None else supertype(inner, d)
        return ListT(inner)
    if k in ("cast", "ext_to"):
        # dtype expressions (datatype_expr.py) come with Slice E
        return e.attrs["dtype"]
    if k == "ext_storage":
        from ..dtypes import BaseExtension as _BaseExt
        ct = output_dtype(e.children[0], schema)
        return ct.storage if isinstance(ct, _BaseExt) else ct
    if k == "binary":
        op = e.attrs["op"]
        lt_ = output_dtype(e.children[0], schema)
        rt = output_dtype(e.children[1], schema)
        if op in _CMP:
            return Boolean
        if op in _BOOL_OPS:
            if lt_.is_bool and rt.is_bool:
                return Boolean
            return supertype(lt_, rt)  # bitwise on ints
        if op in ("truediv", "arctan2"):
            st = supertype(lt_, rt)
            return Float32 if st == Float32 else Float64
        if op == "pow":
            st = supertype(lt_, rt)
            return st if st.is_float else Float64
        st = supertype(lt_, rt)
        if isinstance(st, Datetime) and op == "sub":
            return Duration(st.time_unit)
        if st == Date and op == "sub":
            return Duration("ms")
        return st
    if k == "fma":
        st1 = supertype(output_dtype(e.children[0], schema),
                        output_dtype(e.children[1], schema))
        return supertype(st1, output_dtype(e.children[2], schema))
    if k == "unary":
        op = e.attrs["op"]
        ct = output_dtype(e.children[0], schema)
        if op == "not":
            return Boolean
        if op in ("neg", "abs", "sign", "floor", "ceil", "round"):
            return ct
        return Float32 if ct == Float32 else Float64
    if k in ("is_null", "is_not_null", "is_nan", "is_not_nan", "is_finite",
             "is_infinite", "is_in", "is_in_expr", "is_between",
             "is_duplicated", "is_unique", "is_first_distinct",
             "is_last_distinct"):
        return Boolean
    if k in ("fill_null", "fill_nan"):
        ct = output_dtype(e.children[0], schema)
        ft = output_dtype(e.children[1], schema)
        return ct if ft == Null else supertype(ct, ft)
    if k == "clip":
        return output_dtype(e.children[0], schema)
    if k == "agg":
        agg = e.attrs["agg"]
        ct = output_dtype(e.children[0], schema)
        if agg in ("count", "len", "null_count", "n_unique"):
            return UInt32
        if agg in ("any", "all"):
            return Boolean
        if agg in ("mean", "median", "std", "var", "quantile", "entropy"):
            if isinstance(ct, (Datetime, Duration)) or ct == Date:
                return ct
            return Float32 if ct == Float32 else Float64
        if agg in ("arg_min", "arg_max"):
            return UInt32
        if agg == "sum":
            if ct.is_bool:
                return UInt32
            if ct.is_integer:
                return Int64 if ct.is_signed_integer else ct
            return ct
        if agg == "implode":
            from ..dtypes import List as ListT
            return ListT(ct)
        if agg == "agg_groups":
            from ..dtypes import List as ListT
            return ListT(UInt32)
        if agg in ("skew", "kurtosis"):
            return Float64
        return ct  # min/max/first/last/product/mode/nan_*/bitwise_*
    if k == "when_then":
        nb = e.attrs["n_branches"]
        vals = e.children[nb:]
        dt = output_dtype(vals[0], schema)
        for v in vals[1:]:
            vt = output_dtype(v, schema)
            if vt != Null:
                dt = supertype(dt, vt) if dt != Null else vt
        return dt
    if k == "window":
        op = e.attrs["op"]
        ct = output_dtype(e.children[0], schema)
        if op in ("cum_count", "rle_id"):
            return UInt32
        if op in ("peak_min", "peak_max"):
            return Boolean
        if op in ("pct_change", "rolling_mean", "rolling_std", "rolling_var",
                  "ewm_mean", "interpolate", "interpolate_by",
                  "rolling_quantile", "ewm_std", "ewm_var", "ewm_mean_by",
                  "rolling_mean_by", "rolling_std_by", "rolling_var_by",
                  "rolling_quantile_by"):
            return Float32 if ct == Float32 else Float64
        if op in ("rolling_skew", "rolling_kurtosis", "rolling_map",
                  "rolling_rank", "rolling_rank_by"):
            return Float64
        if op == "arg_sort":
            return UInt32
        if op == "rank":
            return Float64 if e.attrs.get("method") == "average" else UInt32
        if op == "diff" and ct == Date:
            return Duration("ms")
        return ct
    if k == "table_len":
        return UInt32
    if k == "bin":
        op = e.attrs["op"]
        if op in ("contains", "starts_with", "ends_with"):
            return Boolean
        if op == "size":
            return UInt32 if e.attrs.get("unit", "b") == "b" else Float64
        if op == "encode":
            return String
        if op == "reinterpret":
            d = e.attrs["dtype"]
            return d() if isinstance(d, type) else d
        from ..dtypes import Binary
        return Binary()
    if k == "str":
        op = e.attrs["op"]
        if op in _STR_DTYPES:
            return _STR_DTYPES[op]
        if op in ("to_datetime",):
            return Datetime(e.attrs.get("time_unit", "us"))
        if op == "strptime":
            return e.attrs["dtype"]
        if op in ("split", "extract_all", "extract_many", "chars"):
            from ..dtypes import List as ListT
            return ListT(String)
        if op == "find_many":
            from ..dtypes import List as ListT
            return ListT(UInt32)
        if op == "to_time":
            from ..dtypes import Time as _Time
            return _Time
        if op == "extract_groups":
            import re as _re
            from ..dtypes import Struct as StructT
            rx = _re.compile(e.attrs["pat"])
            by_idx = {i: nm for nm, i in rx.groupindex.items()}
            return StructT([(by_idx.get(g, str(g)), String)
                            for g in range(1, rx.groups + 1)])
        if op in ("split_exact", "splitn"):
            from ..dtypes import Struct as StructT
            n = int(e.attrs["n"]) + (1 if op == "split_exact" else 0)
            return StructT([(f"field_{i}", String) for i in range(n)])
        if op == "json_decode" and e.attrs.get("dtype") is not None:
            return e.attrs["dtype"]
        return String
    if k == "dt":
        op = e.attrs["op"]
        ct = output_dtype(e.children[0], schema)
        if op in _DT_INT_OPS:
            return _DT_INT_OPS[op]
        if op in ("is_leap_year", "is_business_day"):
            return Boolean
        if op in ("iso_year", "century", "millennium", "days_in_month"):
            return Int32
        if op == "total_nanoseconds":
            return Int64
        if op == "time":
            from ..dtypes import Time as _Time
            return _Time
        if op in ("base_utc_offset", "dst_offset"):
            return Duration("ms")
        if op == "combine":
            return Datetime(e.attrs.get("time_unit", "us"))
        if op == "datetime":
            return Datetime("us") if ct == Date else ct
        if op == "with_time_unit":
            return Duration(e.attrs["time_unit"]) \
                if isinstance(ct, Duration) else Datetime(e.attrs["time_unit"])
        if op in ("replace", "add_business_days"):
            return ct
        if op in ("strftime", "to_string"):
            return String
        if op == "date":
            return Date
        if op == "cast_time_unit":
            return Datetime(e.attrs["time_unit"]) if isinstance(ct, Datetime) \
                else Duration(e.attrs["time_unit"])
        return ct
    if k == "list":
        from ..dtypes import List as ListT
        op = e.attrs["op"]
        ct = output_dtype(e.children[0], schema)
        inner = ct.inner if isinstance(ct, ListT) else ct
        if op in ("len", "n_elements", "arg_min", "arg_max", "n_unique",
                  "count_matches"):
            return UInt32
        if op in ("median", "std", "var"):
            return Float64
        if op == "to_struct":
            from ..dtypes import Struct as StructT
            names = e.attrs.get("fields")
            if names is None:
                raise SchemaError(
                    "list.to_struct in a lazy schema needs fields=[...]")
            return StructT([(n, inner) for n in names])
        if op == "sum":
            if inner.is_bool:
                return UInt32
            return inner if inner.is_float else Int64
        if op == "mean":
            return Float64
        if op in ("min", "max", "first", "last", "get"):
            return inner
        if op in ("any", "all", "contains"):
            return Boolean
        if op == "join":
            return String
        return ct  # reverse/sort/unique/head/tail/slice keep the list dtype
    if k == "struct":
        from ..dtypes import Struct as StructT
        return StructT([(n, output_dtype(c, schema))
                        for n, c in zip(e.attrs["names"], e.children)])
    if k == "struct_with_fields":
        from ..dtypes import Struct as StructT
        ct = output_dtype(e.children[0], schema)
        if not isinstance(ct, StructT):
            raise SchemaError(f".struct.with_fields on non-struct {ct!r}")
        fields = dict(ct.fields)
        schema2 = dict(schema)
        for fn, fd in fields.items():
            schema2[f"__pt_field_{fn}"] = fd
        for n, c in zip(e.attrs["names"], e.children[1:]):
            fields[n] = output_dtype(_bind_fields(c), schema2)
        return StructT(list(fields.items()))
    if k == "field":
        mn = f"__pt_field_{e.attrs['name']}"
        if mn in schema:
            return schema[mn]
        raise SchemaError("pl.field(...) outside struct.with_fields")
    if k == "business_day_count":
        return Int32
    if k == "row_index":
        return UInt32
    if k == "hist":
        if e.attrs.get("include_breakpoint"):
            from ..dtypes import Struct as StructT
            return StructT([("breakpoint", Float64), ("count", UInt32)])
        return UInt32
    if k == "rolling_pair":
        return Float64
    if k == "struct_json_encode":
        return String
    if k == "struct_unnest":
        return output_dtype(e.children[0], schema)
    if k == "struct_field":
        from ..dtypes import Struct as StructT
        ct = output_dtype(e.children[0], schema)
        if isinstance(ct, StructT):
            return ct.field_dtype(e.attrs["name"])
        raise SchemaError(f".struct.field on non-struct {ct!r}")
    if k == "struct_rename":
        from ..dtypes import Struct as StructT
        ct = output_dtype(e.children[0], schema)
        if isinstance(ct, StructT):
            return StructT([(n, d) for n, (_, d)
                            in zip(e.attrs["names"], ct.fields)])
        raise SchemaError(f".struct.rename_fields on non-struct {ct!r}")
    if k == "cat_categories":
        return String
    if k in ("gather_every", "shrink_dtype"):
        return output_dtype(e.children[0], schema)
    if k == "datetime_components":
        return Datetime(e.attrs.get("time_unit", "us"))
    if k == "rle":
        from ..dtypes import Struct as StructT
        return StructT([("len", UInt32),
                        ("value", output_dtype(e.children[0], schema))])
    if k == "list_eval":
        from ..dtypes import List as ListT
        ct = output_dtype(e.children[0], schema)
        inner = ct.inner if isinstance(ct, ListT) else ct
        return ListT(output_dtype(e.children[1], {"__pt_element__": inner}))
    if k in ("list_filter", "list_set"):
        return output_dtype(e.children[0], schema)
    if k in ("cut", "qcut"):
        from ..dtypes import Categorical as _Cat
        return _Cat()
    if k == "search_sorted":
        return UInt32
    if k == "concat_str":
        return String
    if k == "hash":
        return UInt32
    if k == "unique_counts":
        return UInt32
    if k == "value_counts":
        return output_dtype(e.children[0], schema)
    if k == "map_batches":
        rd = e.attrs.get("return_dtype")
        return rd if rd is not None else output_dtype(e.children[0], schema)
    if k == "replace":
        return output_dtype(e.children[0], schema)
    if k == "arg_true":
        return UInt32
    if k in ("bounds", "sample", "extend_constant", "exclude"):
        return output_dtype(e.children[0], schema)
    if k == "append":
        return supertype(output_dtype(e.children[0], schema),
                         output_dtype(e.children[1], schema))
    if k == "to_physical":
        from ..dtypes import Categorical, Time
        ct = output_dtype(e.children[0], schema)
        if ct.is_string or isinstance(ct, Categorical):
            return UInt32
        if ct == Date:
            return Int32
        if isinstance(ct, (Datetime, Duration)) or ct == Time:
            return Int64
        return ct
    if k == "map_elements":
        rd = e.attrs.get("return_dtype")
        return rd if rd is not None else output_dtype(e.children[0], schema)
    if k == "cumulative_eval":
        inner = output_dtype(e.children[0], schema)
        return output_dtype(e.children[1], {"__pt_element__": inner})
    if k == "replace_strict":
        rd = e.attrs.get("return_dtype")
        if rd is not None:
            return rd
        dt = None
        for n in e.attrs["new"]:
            t = _lit_dtype(n, None)
            dt = t if dt is None else supertype(dt, t)
        if e.attrs.get("default") is not None:
            dt = supertype(dt, _lit_dtype(e.attrs["default"], None))
        return dt
    raise SchemaError(f"cannot infer output dtype of expr kind {k!r}")


_NON_ELEMENTWISE = {"agg", "window", "over", "sort_self", "sort_by",
                    "expr_filter", "expr_slice", "drop_nulls", "expr_unique",
                    "table_len", "is_duplicated", "is_unique",
                    "is_first_distinct", "is_last_distinct", "gather",
                    "unique_counts",
                    "value_counts", "repeat_by", "explode_expr",
                    "fill_null_strategy", "map_batches", "qcut",
                    "search_sorted", "cat_categories", "gather_every",
                    "shrink_dtype", "rle", "arg_true", "sample",
                    "extend_constant", "append", "cumulative_eval",
                    "map_elements", "hist"}


def is_elementwise(e: Expr) -> bool:
    """True if the expr maps row->row independently (streamable; reference:
    `lower_expr.rs:91`)."""
    if e.kind in _NON_ELEMENTWISE:
        return False
    return all(is_elementwise(c) for c in e.children)


def has_agg(e: Expr) -> bool:
    if e.kind == "agg" or e.kind == "table_len":
        return True
    if e.kind == "over":
        return False  # over() restores row-length
    return any(has_agg(c) for c in e.children)


def is_scalar_expr(e: Expr) -> bool:
    """Output is a single row in select context (aggregate at the top of
    every path from root to leaves)."""
    k = e.kind
    if k in ("agg", "table_len"):
        return True
    if k == "lit":
        import numpy as np
        v = e.attrs["value"]
        return not isinstance(v, (list, tuple, np.ndarray))
    if k in ("alias", "cast", "name_map"):
        return is_scalar_expr(e.children[0])
    if k in ("binary", "fma"):
        return all(is_scalar_expr(c) for c in e.children)
    if k == "unary":
        return is_scalar_expr(e.children[0])
    return False


def _expand_folds(e: Expr, schema) -> Expr:
    """Resolve deferred horizontal folds (`pl.fold`/`pl.reduce`): their
    input selectors expand against the schema INSIDE the fold (consumed
    horizontally), unlike ordinary wildcard expansion which would clone
    the whole expression per column."""
    if e.kind == "fold_exprs":
        inputs = expand_exprs(list(e.children[1:]), schema)
        fn = e.attrs["function"]
        if e.attrs["mode"] == "reduce":
            acc = inputs[0]
            rest = inputs[1:]
        else:
            acc = _expand_folds(e.children[0], schema)
            rest = inputs
        for x in rest:
            acc = fn(acc, x)
        return acc.alias(e.attrs["mode"])
    if not e.children:
        return e
    ch = tuple(_expand_folds(c, schema) for c in e.children)
    if all(a is b for a, b in zip(ch, e.children)):
        return e
    return Expr(e.kind, ch, **e.attrs)
