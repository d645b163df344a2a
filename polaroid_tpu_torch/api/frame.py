"""Eager DataFrame (the subset the port has so far).

Parity target: `py-polars/src/polars/dataframe/frame.py`, as in the JAX
package's `api/frame.py`: the eager API is a thin layer over the same
device ops the lazy engine uses. A frame lives on one device: the
package default (`Config.device`, "cuda") unless the caller passes
`device=`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..batch import Column, Table, resolve_device
from ..config import capacity_for
from ..dtypes import DataType
from ..errors import ComputeError, DuplicateError
from ..expr import meta
from ..expr.eval import eval_expr, val_to_column
from ..expr.expr import Expr, col as _col
from ..ops import compact as C
from ..ops import temporal as T
from ..ops import sort as S
from .series import Series, _py


def _to_exprs(args, kwargs=None) -> List[Expr]:
    flat = []

    def rec(a):
        if isinstance(a, (list, tuple)):
            for x in a:
                rec(x)
        elif isinstance(a, Expr):
            flat.append(a)
        elif isinstance(a, str):
            flat.append(_col(a))
        else:
            from ..expr.expr import lit
            flat.append(lit(a))
    for a in args:
        rec(a)
    for name, a in (kwargs or {}).items():
        e = _to_exprs([a])[0]
        flat.append(e.alias(name))
    return flat


def _join_keys(on, how: str, left_on, right_on):
    """(left_on, right_on) as lists from `on` or the pair; none for a
    cross join."""
    if on is not None:
        left_on = right_on = [on] if isinstance(on, str) else list(on)
    elif how != "cross":
        if left_on is None or right_on is None:
            raise ComputeError("join requires `on` or `left_on`+`right_on`")
        left_on = [left_on] if isinstance(left_on, str) else list(left_on)
        right_on = [right_on] if isinstance(right_on, str) \
            else list(right_on)
    else:
        left_on = right_on = []
    return left_on, right_on


def _per_key(flag, nk: int) -> List[bool]:
    """One flag per sort key from one flag or a list of them."""
    return list(flag) if isinstance(flag, (list, tuple)) else [flag] * nk


def _column_names(columns) -> List[str]:
    """Column names from names, expressions and lists of them."""
    flat = []
    for c in columns:
        flat.extend(c if isinstance(c, (list, tuple)) else [c])
    return [c.attrs["name"] if isinstance(c, Expr) else c for c in flat]


def unnest_schema(schema: Dict[str, DataType], columns) -> Dict:
    from ..dtypes import Struct as StructT
    from ..errors import SchemaError
    out = {}
    for n, dt in schema.items():
        if n not in columns:
            pairs = [(n, dt)]
        elif not isinstance(dt, StructT):
            raise SchemaError(f"unnest: {n!r} is {dt!r}, not a Struct")
        else:
            pairs = dt.fields
        for fn, fdt in pairs:
            if fn in out:
                raise DuplicateError(
                    f"unnest: column {fn!r} occurs more than once")
            out[fn] = fdt
    return out


def unnest_table(t: Table, columns) -> Table:
    """Struct columns replaced by their fields in place (a null struct
    makes its fields null); a field name that meets another column's
    raises, as in polars."""
    from ..errors import SchemaError
    names, cols = [], {}
    for n in t.names:
        c = t.cols[n]
        if n not in columns:
            parts = [(n, c)]
        elif c.fields is None or c.lengths is not None:
            raise SchemaError(f"unnest: {n!r} is {c.dtype!r}, not a Struct")
        else:
            parts = []
            for fn, f in c.fields.items():
                if c.validity is not None:
                    fv = c.validity if f.validity is None \
                        else f.validity & c.validity
                    f = Column(f.dtype, f.data, fv, f.sdict,
                               lengths=f.lengths, elem_valid=f.elem_valid,
                               fields=f.fields)
                parts.append((fn, f))
        for fn, f in parts:
            if fn in cols:
                raise DuplicateError(
                    f"unnest: column {fn!r} occurs more than once")
            names.append(fn)
            cols[fn] = f
    return Table(names, cols, t.capacity, t._nrows, t.valid,
                 nrows_dev=t.nrows_dev, device=t.device)


def _table_of_series(series) -> Table:
    """A frame's table from Series of one length, each column grown to
    the largest capacity among them."""
    n = len(series[0])
    if any(len(x) != n for x in series):
        from ..errors import ShapeError
        raise ShapeError("the Series of a DataFrame differ in length")
    cap = max(x._col.capacity for x in series)
    names, cols = [], {}
    for i, x in enumerate(series):
        name = x.name or f"column_{i}"
        if name in cols:
            raise DuplicateError(f"duplicate column name {name!r}")
        t = C.grow_to(Table([name], {name: x._col}, x._col.capacity, n),
                      cap)
        names.append(name)
        cols[name] = t.cols[name]
    return Table(names, cols, cap, n, None)


class DataFrame:
    def __init__(self, data=None, schema=None, device=None):
        if isinstance(data, Table):
            self._table = data
            return
        if isinstance(data, DataFrame):
            self._table = data._table
            return
        if data is None:
            data = {}
        if isinstance(data, Series):
            data = [data]
        if isinstance(data, (list, tuple)) and data and \
                all(isinstance(x, Series) for x in data):
            self._table = _table_of_series(data)
            return
        if not isinstance(data, dict):
            raise ComputeError(
                f"cannot construct DataFrame from {type(data)}; the port "
                "takes a dict of numpy arrays or lists")
        if any(isinstance(v, Series) for v in data.values()):
            self._table = _table_of_series(
                [v.alias(k) if isinstance(v, Series)
                 else Series(k, v, device=device) for k, v in data.items()])
            return
        self._table = Table.from_dict(
            data, schema if isinstance(schema, dict) else None,
            device=resolve_device(device))

    @classmethod
    def _from_table(cls, t: Table) -> "DataFrame":
        df = cls.__new__(cls)
        df._table = t
        return df

    # --- introspection --------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self._table.device

    @property
    def height(self) -> int:
        return self._table.count_rows()

    @property
    def width(self) -> int:
        return self._table.width

    @property
    def shape(self):
        return (self.height, self.width)

    @property
    def columns(self) -> List[str]:
        return list(self._table.names)

    @property
    def schema(self) -> Dict[str, DataType]:
        return self._table.schema

    @property
    def dtypes(self) -> List[DataType]:
        return [self._table.cols[n].dtype for n in self._table.names]

    def __len__(self) -> int:
        return self.height

    def __repr__(self) -> str:
        return f"DataFrame{self.shape} on {self.device}: " + \
            ", ".join(f"{k}: {v!r}" for k, v in self.schema.items())

    # --- expression contexts --------------------------------------------
    def select(self, *exprs, **named_exprs) -> "DataFrame":
        es = meta.expand_exprs(_to_exprs(exprs, named_exprs), self.schema)
        stripped, explode_names = [], []
        for e in es:
            e2, hit = meta.strip_top_explode(e)
            stripped.append(e2)
            if hit:
                explode_names.append(meta.output_name(e2))
        if explode_names:
            return self.select(*stripped).explode(explode_names)
        if len(es) == 1:
            e0 = es[0]
            while e0.kind == "alias":
                e0 = e0.children[0]
            if e0.kind == "struct_unnest":
                inner = self.select(e0.children[0])
                return inner.unnest(inner.columns[0])
        t = self._table
        results = []
        for e in es:
            name = meta.output_name(e)
            if e.kind == "col" and e.attrs["name"] in t.cols:
                # bare column: pass the Column object through (keeps stats)
                results.append((name, t.cols[name], False))
                continue
            v = eval_expr(e, t, "select")
            results.append((name, v, v.is_scalar))
        if not results:
            return DataFrame._from_table(
                Table([], {}, capacity_for(0), 0, None, device=t.device))
        any_row = any(not s for _, _, s in results)
        if any(not isinstance(v, Column) and (
                v.live is not None or v.rows > t.capacity)
               for _, v, _ in results):
            return self._select_compacted(results)
        cap = t.capacity if any_row else capacity_for(1)
        names, cols = [], {}
        for name, v, _ in results:
            if name in cols:
                raise DuplicateError(f"duplicate column name {name!r}")
            names.append(name)
            cols[name] = v if isinstance(v, Column) \
                else val_to_column(v, cap)
        if any_row:
            return DataFrame._from_table(Table(
                names, cols, cap, t._nrows, t.valid, nrows_dev=t.nrows_dev,
                device=t.device))
        return DataFrame._from_table(Table(names, cols, cap, 1, None,
                                           device=t.device))

    def _select_compacted(self, results) -> "DataFrame":
        """A select whose results have rows of their own (a Val's `live`
        marks them: `.over(mapping_strategy="explode")`): each column is
        compacted to its rows (kernel B), and all must count the same."""
        from ..errors import ShapeError
        t = self._table
        base = t.row_mask()
        # a list literal may carry more rows than the frame holds
        cap = max([t.capacity] + [v.rows for _, v, s in results
                                  if not s and not isinstance(v, Column)])
        n_out, cols, names = None, {}, []
        for name, v, scalar in results:
            if name in cols:
                raise DuplicateError(f"duplicate column name {name!r}")
            own = v.capacity if isinstance(v, Column) else \
                (1 if scalar else v.rows)
            col = v if isinstance(v, Column) else \
                val_to_column(v, cap if scalar else own)
            if not scalar:
                m = base if isinstance(v, Column) or v.live is None \
                    else v.live.expand(own)
                one = Table([name], {name: col}, own, None, m,
                            device=t.device)
                packed, count = C.compact_device(one)
                col = C.grow_to(packed, cap).cols[name]
                c = int(count)
                if n_out is not None and c != n_out:
                    raise ShapeError(f"select: column lengths differ ({c} "
                                     f"vs {n_out})")
                n_out = c
            names.append(name)
            cols[name] = col
        out = Table(names, cols, cap, 1 if n_out is None else n_out,
                    None, device=t.device)
        return DataFrame._from_table(C.shrink_to(out, out.nrows))

    def with_columns(self, *exprs, **named_exprs) -> "DataFrame":
        es = meta.expand_exprs(_to_exprs(exprs, named_exprs), self.schema)
        t = self._table
        for e in es:
            v = eval_expr(e, t, "select")
            if v.live is not None:
                from ..errors import InvalidOperationError
                raise InvalidOperationError(
                    f"{meta.output_name(e)!r}: an expression that changes "
                    "the frame's length works only in a select")
            t = t.with_column(meta.output_name(e),
                              val_to_column(v, t.capacity))
        return DataFrame._from_table(t)

    def filter(self, *predicates, **constraints) -> "DataFrame":
        """Mask the rows: no compaction and no host sync here; collect()
        or a host read compacts."""
        preds = _to_exprs(predicates)
        for k, v in constraints.items():
            preds.append(_col(k) == v)
        t = self._table
        mask = t.row_mask()
        for p in preds:
            v = eval_expr(p, t, "filter")
            if not v.dtype.is_bool:
                raise ComputeError(
                    f"filter predicate must be Boolean, got {v.dtype!r}")
            mask = mask & (v.data & v.valid_or_true()).expand(t.capacity)
        return DataFrame._from_table(t.with_valid(mask, None))

    def shift(self, n: int = 1, *, fill_value=None) -> "DataFrame":
        return self.with_columns([_col(c).shift(n, fill_value=fill_value)
                                  for c in self.columns])

    def interpolate(self) -> "DataFrame":
        return self.with_columns([_col(c).interpolate()
                                  for c in self.columns
                                  if self.schema[c].is_numeric])

    def fill_null(self, value=None, strategy: Optional[str] = None
                  ) -> "DataFrame":
        return self.with_columns([_col(n).fill_null(value, strategy=strategy)
                                  for n in self.columns])

    def drop_nulls(self, subset=None) -> "DataFrame":
        """The rows with no null in the `subset` columns (all columns by
        default)."""
        names = [subset] if isinstance(subset, str) else \
            (subset or self.columns)
        pred = None
        for n in names:
            p = _col(n).is_not_null()
            pred = p if pred is None else pred & p
        return self.filter(pred) if pred is not None else self

    # --- reductions ------------------------------------------------------
    def _agg_all(self, agg: str, **kw) -> "DataFrame":
        """One row: `agg` of every column it applies to (numeric,
        Boolean and temporal columns; strings too for min and max)."""
        exprs = []
        for n in self.columns:
            dt = self.schema[n]
            if agg in ("sum", "mean", "min", "max", "median", "std",
                       "var") and not (dt.is_numeric or dt.is_bool or
                                       dt.is_temporal or
                                       (agg in ("min", "max")
                                        and dt.is_string)):
                continue
            exprs.append(Expr("agg", (_col(n),), agg=agg, **kw).alias(n))
        return self.select(exprs) if exprs else DataFrame(device=self.device)

    def sum(self) -> "DataFrame":
        return self._agg_all("sum")

    def mean(self) -> "DataFrame":
        return self._agg_all("mean")

    def min(self) -> "DataFrame":
        return self._agg_all("min")

    def max(self) -> "DataFrame":
        return self._agg_all("max")

    def median(self) -> "DataFrame":
        return self._agg_all("median")

    def std(self, ddof: int = 1) -> "DataFrame":
        return self._agg_all("std", ddof=ddof)

    def var(self, ddof: int = 1) -> "DataFrame":
        return self._agg_all("var", ddof=ddof)

    def null_count(self) -> "DataFrame":
        return self.select([_col(n).null_count().alias(n)
                            for n in self.columns])

    def describe(self) -> "DataFrame":
        """count, null_count, mean, std, min, the quartiles and max of
        every column (as the JAX package's `describe`: Float64 for
        numeric and Boolean columns, strings for the others)."""
        from ..dtypes import Float64, UInt8
        stats = ["count", "null_count", "mean", "std", "min", "25%", "50%",
                 "75%", "max"]
        data: Dict[str, list] = {"statistic": stats}
        for name in self.columns:
            dt = self.schema[name]
            c = _col(name)
            if dt.is_numeric or dt.is_bool:
                cc = c if not dt.is_bool else c.cast(UInt8)
                row = self.select(
                    c.count().cast(Float64).alias("count"),
                    c.null_count().cast(Float64).alias("nc"),
                    cc.mean().alias("mean"), cc.std().alias("std"),
                    cc.min().cast(Float64).alias("min"),
                    cc.quantile(0.25, "linear").alias("q1"),
                    cc.quantile(0.5, "linear").alias("q2"),
                    cc.quantile(0.75, "linear").alias("q3"),
                    cc.max().cast(Float64).alias("max")).to_dict()
                data[name] = [None if v[0] is None else float(v[0])
                              for v in row.values()]
                continue

            def one(e):
                return self.select(e.alias("v")).to_dict()["v"][0]
            mn = one(c.min()) if dt.is_string or dt.is_temporal else None
            mx = one(c.max()) if dt.is_string or dt.is_temporal else None
            data[name] = [str(one(c.count())), str(one(c.null_count())),
                          None, None, None if mn is None else str(mn),
                          None, None, None, None if mx is None else str(mx)]
        return DataFrame(data, device=self.device)

    # --- row ops --------------------------------------------------------
    def head(self, n: int = 5) -> "DataFrame":
        return DataFrame._from_table(C.slice_rows(self._table, 0, max(n, 0)))

    def tail(self, n: int = 5) -> "DataFrame":
        return DataFrame._from_table(C.slice_rows(self._table, -n, n))

    def sort(self, by, *more_by, descending=False, nulls_last=False,
             maintain_order: bool = False) -> "DataFrame":
        """Sort on the frame's device (`ops/sort.sort_table`); nulls
        first unless `nulls_last`. `descending` and `nulls_last` take one
        flag or one per key."""
        keys = meta.expand_exprs(_to_exprs((by,) + more_by), self.schema)
        nk = len(keys)
        desc = _per_key(descending, nk)
        nl = _per_key(nulls_last, nk)
        t = self._table
        vals = [eval_expr(k, t, "select") for k in keys]
        return DataFrame._from_table(
            S.sort_table(t, vals, desc, nl, maintain_order))

    def top_k(self, k: int, by, descending=False) -> "DataFrame":
        """The k rows with the largest keys, largest first (the smallest
        for a key marked `descending`); nulls last."""
        keys = _to_exprs(tuple(by) if isinstance(by, (list, tuple))
                         else (by,))
        nk = len(keys)
        desc = [not d for d in _per_key(descending, nk)]
        t = self._table
        vals = [eval_expr(kk, t, "select") for kk in keys]
        return DataFrame._from_table(
            S.top_k_table(t, vals, k, desc, [True] * nk))

    def bottom_k(self, k: int, by, descending=False) -> "DataFrame":
        """The k rows with the smallest keys, smallest first; nulls
        last."""
        desc = [not d for d in descending] \
            if isinstance(descending, (list, tuple)) else not descending
        return self.top_k(k, by, descending=desc)

    # --- relational ops -------------------------------------------------
    def unique(self, subset=None, keep: str = "any",
               maintain_order: bool = False) -> "DataFrame":
        """One row per distinct value of the `subset` columns (all
        columns by default), in the frame's order; keep is "any",
        "first", "last" or "none" (only rows whose value is unique)."""
        from ..ops.groupby import unique_table
        names = [subset] if isinstance(subset, str) else \
            (list(subset) if subset is not None else None)
        return DataFrame._from_table(C.compact(
            unique_table(self._table, names, keep, maintain_order)))

    def join(self, other: "DataFrame", on=None, how: str = "inner", *,
             left_on=None, right_on=None, suffix: str = "_right",
             join_nulls: bool = False, nulls_equal: bool = False,
             coalesce: Optional[bool] = None,
             maintain_order: Optional[str] = None,
             validate: str = "m:m") -> "DataFrame":
        """Equi-join on `on` (or `left_on`/`right_on`) of every kind:
        inner, left, right, full (outer), semi, anti, cross
        (`ops/join.join_tables`). Nulls match nulls only with
        `join_nulls`/`nulls_equal`; `validate` ("1:1", "1:m", "m:1")
        checks that the named side's keys are unique."""
        from ..ops.join import join_tables
        left_on, right_on = _join_keys(on, how, left_on, right_on)
        return DataFrame._from_table(join_tables(
            self._table, other._table, left_on, right_on, how, suffix,
            join_nulls or nulls_equal, coalesce, maintain_order, validate))

    def vstack(self, other: "DataFrame") -> "DataFrame":
        from ..ops.concat import vstack_tables
        return DataFrame._from_table(
            vstack_tables([self._table, other._table]))

    def hstack(self, other: "DataFrame") -> "DataFrame":
        """The columns of both frames side by side (both compacted, the
        smaller capacity grown to the larger); a column of `other`
        replaces one of the same name."""
        if not isinstance(other, DataFrame):
            raise ComputeError("hstack expects a DataFrame")
        t, ot = C.compact(self._table), C.compact(other._table)
        cap = max(t.capacity, ot.capacity)
        t, ot = C.grow_to(t, cap), C.grow_to(ot, cap)
        for name in ot.names:
            t = t.with_column(name, ot.cols[name])
        return DataFrame._from_table(t)

    def explode(self, *columns) -> "DataFrame":
        """One row per element of the List columns (their lengths must
        match); the other columns repeat."""
        from ..ops.nested import explode_table
        return DataFrame._from_table(
            explode_table(self._table, _column_names(columns)))

    def unnest(self, *columns) -> "DataFrame":
        """Each Struct column replaced by its fields."""
        return DataFrame._from_table(
            unnest_table(self._table, _column_names(columns)))

    def to_struct(self, name: str = "") -> Series:
        """The rows as one Struct series."""
        from ..expr.expr import struct
        out = self.select(struct(*[_col(c) for c in self.columns])
                          .alias(name or "struct"))
        return out.get_column(name or "struct")

    def rows(self, named: bool = False):
        d = self.to_dict()
        if named:
            return [dict(zip(d, r)) for r in zip(*d.values())]
        return list(zip(*d.values()))

    def group_by(self, *by, maintain_order: bool = False, **named_by):
        from .groupby import GroupBy
        return GroupBy(self, _to_exprs(by, named_by), maintain_order)

    def group_by_dynamic(self, index_column: str, *, every: str,
                         period: Optional[str] = None,
                         offset: Optional[str] = None, closed: str = "left",
                         group_by=None, start_by: str = "window"):
        """Windows of the index column (`every` apart, `period` long,
        moved by `offset`) grouped with the `group_by` keys
        (`ops/temporal_window.dynamic_group_by`)."""
        from ..ops.temporal_window import dynamic_group_by
        keys = _to_exprs((group_by,)) if group_by is not None else []
        frame = self

        class _Dynamic:
            def agg(_self, *aggs, **named):
                es = meta.expand_exprs(_to_exprs(aggs, named), frame.schema)
                return DataFrame._from_table(dynamic_group_by(
                    frame._table, index_column, every, period, offset,
                    closed, keys, es, start_by))
        return _Dynamic()

    def rolling(self, index_column: str, *, period: str, group_by=None,
                closed: str = "right"):
        """Each row's aggregates over its trailing window of the index
        column within its `group_by` group
        (`ops/temporal_window.rolling_agg`)."""
        from ..ops.temporal_window import rolling_agg
        keys = _to_exprs((group_by,)) if group_by is not None else []
        frame = self

        class _Rolling:
            def agg(_self, *aggs, **named):
                es = meta.expand_exprs(_to_exprs(aggs, named), frame.schema)
                return DataFrame._from_table(rolling_agg(
                    frame._table, index_column, period, keys, es, closed))
        return _Rolling()

    def upsample(self, time_column: str, *, every: str) -> "DataFrame":
        """Rows at every `every` from the first to the last time, the
        frame's columns joined on (nulls where no row has that time). The
        grid is built on the host: a fixed `every` steps by its length; a
        calendar one ("1mo", "1q", "1y") moves the first time by whole
        months (`temporal_window.add_months_units`: a day past a month's
        end becomes its last day), each point from the first, so the day
        does not drift."""
        from ..dtypes import Date
        from ..ops.temporal import days_to_civil, parse_every
        from ..ops.temporal_window import add_months_units
        t = C.compact(self._table)
        n = t.count_rows()
        if n == 0:
            return self
        c = t.column(time_column)
        vals = c.data[:n].cpu()
        lo, hi = int(vals.min()), int(vals.max())
        kind, step = parse_every(every)
        if kind == "months":
            ends = torch.tensor([lo, hi], dtype=vals.dtype)
            days = ends if c.dtype == Date else \
                torch.div(ends, T.per_day(c.dtype.time_unit),
                          rounding_mode="floor")
            y, m, _ = days_to_civil(days)
            span = (int(y[1]) - int(y[0])) * 12 + int(m[1]) - int(m[0])
            k = torch.arange(span // step + 1, dtype=torch.int64) * step
            grid = add_months_units(ends[:1].expand(k.shape[0]), k, c.dtype)
            grid = grid[grid <= hi].numpy()
        else:
            unit = c.dtype.time_unit if c.dtype != Date else None
            per = T.per_day("ns") if unit is None else \
                1_000_000_000 // T.UNIT_PER_SECOND[unit]
            grid = np.arange(lo, hi + 1, max(step // per, 1), dtype=np.int64)
        grid = grid.astype("datetime64[D]" if c.dtype == Date
                           else f"datetime64[{c.dtype.time_unit}]")
        gdf = DataFrame({time_column: grid}, schema={time_column: c.dtype},
                        device=self.device)
        return gdf.join(self, on=time_column, how="left")

    def join_asof(self, other: "DataFrame", **kw) -> "DataFrame":
        """As-of join on sorted-order keys (see `LazyFrame.join_asof`)."""
        return self.lazy().join_asof(other.lazy(), **kw).collect()

    def join_where(self, other: "DataFrame", *predicates,
                   suffix: str = "_right") -> "DataFrame":
        """Join on inequality predicates (see `LazyFrame.join_where`)."""
        return self.lazy().join_where(other.lazy(), *predicates,
                                      suffix=suffix).collect()

    def lazy(self):
        from .lazyframe import LazyFrame
        return LazyFrame._from_table(self._table)

    # --- conversion ------------------------------------------------------
    def get_column(self, name: str) -> Series:
        t = C.compact(self._table)
        return Series._from_column(name, t.column(name), t.count_rows())

    def to_dict(self, as_series: bool = False) -> Dict[str, Any]:
        d = self._table.to_numpy_dict()
        if as_series:
            return {k: self.get_column(k) for k in d}
        return {k: [_py(x) for x in v] for k, v in d.items()}

    def to_numpy(self) -> np.ndarray:
        d = self._table.to_numpy_dict()
        return np.column_stack([np.asarray(v) for v in d.values()]) \
            if d else np.zeros((0, 0))
