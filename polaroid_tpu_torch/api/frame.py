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
from ..errors import ColumnNotFoundError, ComputeError, DuplicateError
from ..expr import meta
from ..expr.eval import cse_rewrite, cse_scope, eval_expr, val_to_column
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


def _pandas_values(series) -> np.ndarray:
    """A pandas column's values; in an object column NaN and NA are
    nulls (None), in a float column NaN stays NaN."""
    vals = np.array(series.to_numpy())  # owned: pandas may lend a view
    if vals.dtype == object:
        vals[series.isna().to_numpy()] = None
    return vals


class DataFrame:
    def __init__(self, data=None, schema=None, strict: bool = True,
                 device=None):
        # `strict` is accepted and, as in the JAX package, changes nothing
        if isinstance(data, Table):
            self._table = data
            return
        if isinstance(data, DataFrame):
            self._table = data._table
            return
        if data is None:
            data = {}
        mod = type(data).__module__ or ""
        if mod.startswith("pyarrow"):
            from ..io.arrow_interop import table_from_arrow
            self._table = table_from_arrow(data, device=device)
            return
        if mod.startswith("pandas"):
            data = {c: _pandas_values(data[c]) for c in data.columns}
        if isinstance(data, Series):
            data = [data]
        if isinstance(data, (list, tuple)) and data and \
                all(isinstance(x, Series) for x in data):
            self._table = _table_of_series(data)
            return
        if isinstance(data, (list, tuple)) and data and \
                all(isinstance(x, dict) for x in data):
            # row dicts
            keys = []
            for r in data:
                keys.extend(k for k in r if k not in keys)
            data = {k: [r.get(k) for r in data] for k in keys}
        if not data and schema:
            # an empty frame that keeps the declared schema
            from ..batch import _empty_column
            dev = resolve_device(device)
            items = schema.items() if isinstance(schema, dict) else schema
            cap = capacity_for(0)
            cols = {n: _empty_column(d() if isinstance(d, type) else d, cap,
                                     dev) for n, d in items}
            self._table = Table(list(cols), cols, cap, 0, None, device=dev)
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
        from .fmt import format_frame
        return format_frame(self)

    def is_empty(self) -> bool:
        return self.height == 0

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.get_column(key)
        if isinstance(key, (list, tuple)) and key and isinstance(key[0], str):
            return self.select(list(key))
        if isinstance(key, slice):
            start = key.start or 0
            stop = key.stop if key.stop is not None else self.height
            return self.slice(start, stop - start)
        if isinstance(key, int):
            return self.row(key)
        raise ComputeError(f"unsupported index {key!r}")

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
            if e0.kind == "rle":
                return self._select_rle(e0, meta.output_name(es[0]))
            if e0.kind == "cat_categories":
                return self._select_categories(e0, meta.output_name(es[0]))
        t = self._table
        results = []
        es, _ = cse_rewrite(es)
        with cse_scope():
            for e in es:
                name = meta.output_name(e)
                if e.kind == "col" and e.attrs["name"] in t.cols:
                    # a bare column: the Column passes through (keeps stats)
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

    def _select_rle(self, e0: Expr, name: str) -> "DataFrame":
        """The runs of equal values of one column in the live order, as a
        Struct{len, value} column: run starts by comparing neighbours,
        compacted by kernel B."""
        from ..dtypes import Struct as StructT, UInt32
        from ..ops.cuda_partition import compact_words
        t = C.compact(self._table)
        n = t.count_rows()
        v = eval_expr(e0.children[0], t, "select")
        cap = t.capacity
        x = v.data.expand(cap)
        xv = v.valid_or_true().expand(cap)
        idx = torch.arange(cap, device=t.device)
        new = idx < n
        new[1:] &= (xv[1:] != xv[:-1]) | (xv[1:] & (x[1:] != x[:-1]))
        (starts,), runs = compact_words(new, [idx.to(torch.int32)])
        runs = int(runs)
        starts = starts.long()
        nxt = torch.where(idx + 1 < runs, starts.roll(-1), n)
        lens = torch.where(idx < runs, nxt - starts, 0)
        at = starts.clamp(0, cap - 1)
        fields = {"len": Column(UInt32, lens),
                  "value": Column(v.dtype, x[at], None if v.validity is None
                                  else xv[at], v.sdict)}
        col = Column(StructT([("len", UInt32), ("value", v.dtype)]), None,
                     fields=fields)
        return DataFrame._from_table(C.shrink_to(
            Table([name], {name: col}, cap, runs, None, device=t.device),
            runs))

    def _select_categories(self, e0: Expr, name: str) -> "DataFrame":
        """The dictionary entries that the live rows use (one device
        unique of the codes, one readback)."""
        t = self._table
        v = eval_expr(e0.children[0], t, "select")
        if not v.dtype.is_string:
            raise ComputeError(f".cat.get_categories on {v.dtype!r}")
        codes = v.data.expand(t.capacity)
        live = t.row_mask() & v.valid_or_true().expand(t.capacity) & \
            (codes >= 0)
        used = torch.unique(codes[live]).cpu().numpy()
        cats = list((v.sdict.values if v.sdict is not None
                     else np.array([], dtype=object))[used])
        return DataFrame({name: cats}, schema={name: v.dtype}
                         if not cats else None, device=self.device)

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
                # `live` alone, not ANDed with the row mask: a kind that
                # keeps the frame's rows has folded the mask in, and one
                # that makes new rows (hist's bins, mode, ...) puts them
                # in slots that the mask may hold dead
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
        # common subexpressions are shared when no expression reads a
        # column that another one (re)defines (every expression sees the
        # input frame)
        reads = set()
        for e in es:
            reads |= meta.root_names(e)
        if not ({meta.output_name(e) for e in es} & reads):
            es, _ = cse_rewrite(es)
        with cse_scope():
            for e in es:
                v = eval_expr(e, t, "select")
                if v.live is not None:
                    from ..errors import InvalidOperationError
                    raise InvalidOperationError(
                        f"{meta.output_name(e)!r}: an expression that "
                        "changes the frame's length works only in a select")
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

    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame(self._table.to_numpy_dict())

    def to_arrow(self):
        """The live rows as a pyarrow Table (compacted on the device
        first)."""
        from ..io.arrow_interop import table_to_arrow
        return table_to_arrow(self._table)

    # --- io ------------------------------------------------------------
    def write_parquet(self, file, compression: str = "zstd", **kw) -> None:
        from ..io.parquet import write_parquet
        write_parquet(self, file, compression=compression, **kw)

    def write_csv(self, file=None, **kw):
        from ..io.csv import write_csv
        return write_csv(self, file, **kw)

    def write_ipc(self, file, **kw) -> None:
        from ..io.ipc import write_ipc
        write_ipc(self, file, **kw)

    def write_ipc_stream(self, file, **kw) -> None:
        from ..io.ipc import write_ipc_stream
        write_ipc_stream(self, file)

    def write_ndjson(self, file=None, **kw):
        from ..io.json_io import write_ndjson
        return write_ndjson(self, file)

    def write_json(self, file=None):
        from ..io.json_io import write_json
        return write_json(self, file)

    def write_delta(self, target, *, mode: str = "error",
                    table: str = "data") -> None:
        """Write into the versioned lakehouse store under `target`
        (`lakehouse.LakeStore`): "append", "overwrite", "error" (or
        "ignore") where the table exists."""
        from ..errors import InvalidOperationError
        from ..lakehouse import LakeStore
        store = LakeStore(str(target), device=self.device)
        if mode == "append":
            store.append(table, self)
        elif mode in ("overwrite", "error", "ignore"):
            if mode == "error" and table in store.tables():
                raise InvalidOperationError(
                    f"delta table {table!r} already exists")
            if mode == "ignore" and table in store.tables():
                return
            store.overwrite(table, self)
        else:
            raise InvalidOperationError(f"unknown write_delta mode {mode!r}")

    def write_avro(self, file, compression: str = "uncompressed",
                   **kw) -> None:
        """An Avro object container file (null or deflate codec; the
        port's own encoder, `io/avro.py`)."""
        from ..io.avro import write_avro
        write_avro(self, file, compression=compression)

    def write_excel(self, workbook=None, **kw) -> None:
        raise ModuleNotFoundError(
            "write_excel requires xlsxwriter, which is not bundled")

    def write_database(self, table_name: str, connection, **kw) -> None:
        raise ModuleNotFoundError(
            "write_database requires sqlalchemy, which is not bundled")

    def write_iceberg(self, target, **kw) -> None:
        raise ModuleNotFoundError(
            "write_iceberg requires pyiceberg, which is not bundled")

    def write_clipboard(self, **kw) -> None:
        raise OSError("no clipboard available in a headless environment")

    def serialize(self, file=None, *, format: str = "binary"):
        """The frame as Arrow IPC bytes (the format the JAX package
        writes, so either package reads the other's)."""
        import io as _io
        buf = _io.BytesIO()
        self.write_ipc(buf)
        data = buf.getvalue()
        if file is None:
            return data
        if hasattr(file, "write"):
            file.write(data)
        else:
            with open(file, "wb") as f:
                f.write(data)
        return None

    @classmethod
    def deserialize(cls, source, *, format: str = "binary",
                    device=None) -> "DataFrame":
        import io as _io
        from ..io.ipc import read_ipc_table
        if isinstance(source, (bytes, bytearray)):
            source = _io.BytesIO(source)
        return cls._from_table(read_ipc_table(source, device=device))

    # --- the rest of the frame surface ------------------------------------
    def with_row_index(self, name: str = "index", offset: int = 0
                       ) -> "DataFrame":
        """A UInt32 row number (from `offset`) as the first column."""
        from ..dtypes import UInt32
        t = C.compact(self._table)
        idx = torch.arange(t.capacity, device=t.device) + offset
        out = t.with_column(name, Column(UInt32, idx))
        return DataFrame._from_table(out.select_columns(
            [name] + [n for n in out.names if n != name]))

    def with_row_count(self, name: str = "row_nr", offset: int = 0
                       ) -> "DataFrame":
        return self.with_row_index(name, offset)

    def drop(self, *names, strict: bool = True) -> "DataFrame":
        flat = _column_names(names)
        if strict:
            for n in flat:
                if n not in self._table.cols:
                    raise ColumnNotFoundError(f"{n!r} not found")
        return DataFrame._from_table(self._table.drop_columns(flat))

    def drop_in_place(self, name: str) -> Series:
        s = self.get_column(name)
        self._table = self.drop(name)._table
        return s

    def rename(self, mapping: Dict[str, str], strict: bool = True
               ) -> "DataFrame":
        return DataFrame._from_table(self._table.rename(mapping, strict))

    def cast(self, dtypes, strict: bool = True) -> "DataFrame":
        exprs = [_col(k).cast(v, strict=strict) for k, v in dtypes.items()] \
            if isinstance(dtypes, dict) else \
            [_col(n).cast(dtypes, strict=strict) for n in self.columns]
        return self.with_columns(exprs)

    def limit(self, n: int = 5) -> "DataFrame":
        return self.head(n)

    def slice(self, offset: int, length: Optional[int] = None
              ) -> "DataFrame":
        return DataFrame._from_table(C.slice_rows(self._table, offset,
                                                  length))

    def reverse(self) -> "DataFrame":
        t = C.compact(self._table)
        n = t.count_rows()
        idx = torch.arange(t.capacity, device=t.device)
        perm = torch.where(idx < n, n - 1 - idx, idx)
        return DataFrame._from_table(C.gather_table(t, perm, n, None))

    def gather_every(self, n: int, offset: int = 0) -> "DataFrame":
        return self.select([_col(c).gather_every(n, offset)
                            for c in self.columns])

    def n_unique(self, subset=None) -> int:
        return self.unique(subset).height

    def approx_n_unique(self) -> "DataFrame":
        return self.select([_col(n).n_unique().alias(n)
                            for n in self.columns])

    def product(self) -> "DataFrame":
        return self._agg_all("product")

    def quantile(self, q: float, interpolation: str = "nearest"
                 ) -> "DataFrame":
        return self._agg_all("quantile", q=q, interpolation=interpolation)

    def count(self) -> "DataFrame":
        return self.select([_col(n).count().alias(n) for n in self.columns])

    def fill_nan(self, value) -> "DataFrame":
        return self.with_columns([_col(n).fill_nan(value)
                                  for n in self.columns
                                  if self.schema[n].is_float])

    def drop_nans(self, subset=None) -> "DataFrame":
        """The rows with no NaN in the float `subset` columns (nulls
        stay)."""
        names = [subset] if isinstance(subset, str) else \
            (subset or self.columns)
        pred = None
        for n in names:
            if self.schema[n].is_float:
                p = _col(n).is_not_nan().fill_null(True)
                pred = p if pred is None else pred & p
        return self.filter(pred) if pred is not None else self

    def remove(self, *predicates, **constraints) -> "DataFrame":
        """The rows where the predicates do not all hold."""
        preds = [p if isinstance(p, Expr) else _col(str(p))
                 for p in predicates]
        preds += [_col(k) == v for k, v in constraints.items()]
        if not preds:
            return self
        keep = preds[0]
        for p in preds[1:]:
            keep = keep & p
        return self.filter(~keep.fill_null(False))

    # --- horizontal -------------------------------------------------------
    def fold(self, operation) -> Series:
        acc = self.get_column(self.columns[0])
        for n in self.columns[1:]:
            acc = operation(acc, self.get_column(n))
        return acc

    def _horizontal(self, fn, name: str) -> Series:
        from . import functions as F
        return self.select(getattr(F, fn)(*self.columns).alias(name)) \
            .get_column(name)

    def max_horizontal(self) -> Series:
        return self._horizontal("max_horizontal", "max")

    def min_horizontal(self) -> Series:
        return self._horizontal("min_horizontal", "min")

    def sum_horizontal(self) -> Series:
        return self._horizontal("sum_horizontal", "sum")

    def mean_horizontal(self) -> Series:
        return self._horizontal("mean_horizontal", "mean")

    # --- distinct rows ----------------------------------------------------
    def is_duplicated(self) -> Series:
        """Whether each row's values occur in another row too: one sort of
        the rows by all columns (`expr/misc.distinct_flags`)."""
        return self._row_flags("is_duplicated", "dup")

    def is_unique(self) -> Series:
        return self._row_flags("is_unique", "uniq")

    def _row_flags(self, kind: str, name: str) -> Series:
        from ..dtypes import Boolean
        from ..expr.eval import column_to_val
        from ..expr.misc import distinct_flags
        t = C.compact(self._table)
        n = t.count_rows()
        keys = [column_to_val(t.cols[c]) for c in t.names]
        flags = distinct_flags(keys, t.row_mask(), kind)
        return Series._from_column(name, Column(Boolean, flags), n)

    # --- reshaping ----------------------------------------------------------
    def pivot(self, on, *, index=None, values=None,
              aggregate_function: str = "first", on_columns=None,
              separator: str = "_") -> "DataFrame":
        """One column per distinct `on` value (sorted; `on_columns` names
        them instead), filled by the aggregate of each `values` column
        over the rows of that value, per `index` group; a combination
        with no rows is null. The distinct values are found on the device
        and read back once, for the column names."""
        from ..expr.expr import when
        on_names = [on] if isinstance(on, str) else list(on)
        if len(on_names) != 1:
            raise ComputeError("pivot supports a single `on` column")
        on_col = on_names[0]
        index = [index] if isinstance(index, str) else list(index or [])
        if not index:
            index = [c for c in self.columns if c != on_col and
                     (values is None or c not in values)][:1]
        if values is None:
            values = [c for c in self.columns
                      if c != on_col and c not in index]
        values = [values] if isinstance(values, str) else list(values)
        if on_columns is not None:
            distinct = list(on_columns.to_list()
                            if hasattr(on_columns, "to_list") else on_columns)
        else:
            distinct = sorted(self.select(on_col).unique()
                              .get_column(on_col).to_list(),
                              key=lambda x: (x is None, x))
        aggs = []
        for v in values:
            for d in distinct:
                sel = _col(on_col).is_null() if d is None \
                    else _col(on_col) == d
                agg = getattr(_col(v).filter(sel), aggregate_function)()
                name = str(d) if len(values) == 1 else f"{v}{separator}{d}"
                aggs.append(when(sel.sum() > 0).then(agg).alias(name))
        return self.group_by(index, maintain_order=True).agg(aggs)

    def unpivot(self, on=None, *, index=None,
                variable_name: str = "variable",
                value_name: str = "value") -> "DataFrame":
        return self.lazy().unpivot(on, index=index,
                                   variable_name=variable_name,
                                   value_name=value_name).collect()

    melt = unpivot

    def partition_by(self, *by, as_dict: bool = False,
                     maintain_order: bool = True):
        """One frame per distinct key of the `by` columns."""
        names = _column_names(by)
        key_rows = self.select(names).unique(
            maintain_order=maintain_order).rows()
        out = []
        for row in key_rows:
            pred = None
            for n, v in zip(names, row):
                p = _col(n).is_null() if v is None else _col(n) == v
                pred = p if pred is None else pred & p
            out.append(self.filter(pred))
        if as_dict:
            return {row if len(row) > 1 else row[0]: df
                    for row, df in zip(key_rows, out)}
        return out

    def transpose(self, include_header: bool = False,
                  header_name: str = "column", column_names=None
                  ) -> "DataFrame":
        d = self.to_dict()
        rows = list(zip(*[d[n] for n in self.columns])) if self.columns \
            else []
        names = list(column_names) if column_names is not None else \
            [f"column_{i}" for i in range(self.height)]
        out = {header_name: list(self.columns)} if include_header else {}
        for i, r in enumerate(rows):
            out[names[i]] = list(r)
        return DataFrame(out, device=self.device)

    def unstack(self, *, step: int, how: str = "vertical", columns=None,
                fill_values=None) -> "DataFrame":
        cols = [columns] if isinstance(columns, str) else \
            (list(columns) if columns is not None else list(self.columns))
        d = self.to_dict()
        n = self.height
        k = -(-n // step)
        out = {}
        for c in cols:
            vals = d[c]
            for i in range(step):
                chunk = vals[i * k:(i + 1) * k] if how == "vertical" \
                    else vals[i::step]
                out[f"{c}_{i}"] = chunk + [fill_values] * (k - len(chunk))
        return DataFrame(out, device=self.device)

    def to_dummies(self, columns=None, *, separator: str = "_",
                   drop_first: bool = False) -> "DataFrame":
        """A UInt8 indicator column per distinct value of each column;
        the distinct values are read back once per column."""
        from ..dtypes import UInt8
        cols = [columns] if isinstance(columns, str) else \
            (list(columns) if columns is not None else list(self.columns))
        exprs = []
        for n in self.columns:
            if n not in cols:
                exprs.append(_col(n))
                continue
            cats = sorted((v for v in self.select(n).unique()
                           .get_column(n).to_list() if v is not None),
                          key=str)
            for c in cats[1:] if drop_first else cats:
                exprs.append((_col(n) == c).fill_null(False).cast(UInt8)
                             .alias(f"{n}{separator}{c}"))
        return self.select(exprs)

    # --- sampling -----------------------------------------------------------
    def sample(self, n: Optional[int] = None, *,
               fraction: Optional[float] = None, with_replacement: bool = False,
               shuffle: bool = False, seed: Optional[int] = None
               ) -> "DataFrame":
        """`n` rows (or `fraction` of them) drawn on the device from a
        seeded `torch.Generator` (`expr/misc.sample_order`); in frame order
        unless `shuffle`."""
        from ..expr.misc import sample_order
        t = C.compact(self._table)
        total = t.count_rows()
        if n is None:
            n = total if fraction is None else int(total * fraction)
        if not with_replacement:
            n = min(n, total)
        if with_replacement and n > t.capacity:
            t = C.grow_to(t, capacity_for(n))
        src, _ = sample_order(t.row_mask() if total else
                              torch.zeros(t.capacity, dtype=torch.bool,
                                          device=t.device),
                              seed, with_replacement)
        head = src[:n]
        if not shuffle:
            head = torch.sort(head).values
        perm = torch.cat([head, src[n:]])
        return DataFrame._from_table(C.shrink_to(
            C.gather_table(t, perm, n, None), n))

    def shuffle(self, seed: Optional[int] = None) -> "DataFrame":
        return self.sample(fraction=1.0, shuffle=True, seed=seed)

    # --- combining ------------------------------------------------------------
    def extend(self, other: "DataFrame") -> "DataFrame":
        """Append `other`'s rows in place."""
        self._table = self.vstack(other)._table
        return self

    def insert_column(self, index: int, series: Series) -> "DataFrame":
        names = list(self.columns)
        names.insert(index, series.name)
        t = self.hstack(series.to_frame())._table
        return DataFrame._from_table(t.select_columns(names))

    def replace_column(self, index: int, series: Series) -> "DataFrame":
        names = list(self.columns)
        out = self.drop(names[index]).hstack(series.to_frame())
        names[index] = series.name
        return DataFrame._from_table(out._table.select_columns(names))

    def merge_sorted(self, other: "DataFrame", key: str) -> "DataFrame":
        return self.lazy().merge_sorted(other.lazy(), key).collect()

    def update(self, other: "DataFrame", on=None, how: str = "left",
               include_nulls: bool = False) -> "DataFrame":
        """This frame's values replaced by `other`'s non-null values (or
        all of them with `include_nulls`), matched by `on` or by row
        position."""
        from ..expr.expr import when
        shared = [c for c in other.columns if c in self.columns]
        if on is None:
            left = self.with_row_index("__pt_upd")
            right = other.with_row_index("__pt_upd")
            keys = ["__pt_upd"]
        else:
            left, right = self, other
            keys = [on] if isinstance(on, str) else list(on)
        upd = [c for c in shared if c not in keys]
        right = right.select([_col(k) for k in keys] +
                             [_col(c).alias(f"__pt_new_{c}") for c in upd])
        j = left.join(right, on=keys, how=how)
        exprs = []
        for c in j.columns:
            if c.startswith("__pt_new_") or c == "__pt_upd":
                continue
            if c in upd:
                new = _col(f"__pt_new_{c}")
                exprs.append(new.alias(c) if include_nulls else
                             when(new.is_not_null()).then(new)
                             .otherwise(_col(c)).alias(c))
            else:
                exprs.append(_col(c))
        return j.select(exprs)

    # --- introspection and conversion ------------------------------------------
    def collect_schema(self) -> Dict[str, DataType]:
        return dict(self.schema)

    def get_column_index(self, name: str) -> int:
        if name not in self.columns:
            raise ColumnNotFoundError(name)
        return self.columns.index(name)

    def get_columns(self) -> List[Series]:
        return [self.get_column(n) for n in self.columns]

    def iter_columns(self):
        for n in self.columns:
            yield self.get_column(n)

    def to_series(self, index: int = 0) -> Series:
        return self.get_column(self.columns[index])

    def row(self, index: int, *, named: bool = False):
        r = self.slice(index, 1).rows(named=named)
        return r[0]

    def item(self, row: Optional[int] = None, column=None):
        if row is None and column is None:
            if self.shape != (1, 1):
                from ..errors import ShapeError
                raise ShapeError(
                    f"can only call .item() on 1x1 frame, got {self.shape}")
            return self.rows()[0][0]
        name = column if isinstance(column, str) else self.columns[column]
        return self.get_column(name).to_list()[row]

    def iter_rows(self, named: bool = False):
        yield from self.rows(named=named)

    def iter_slices(self, n_rows: int = 10000):
        for off in range(0, self.height, n_rows):
            yield self.slice(off, n_rows)

    def to_dicts(self) -> List[Dict[str, Any]]:
        return self.rows(named=True)

    def rows_by_key(self, key, *, named: bool = False, unique: bool = False,
                    include_key: bool = False):
        keys = [key] if isinstance(key, str) else list(key)
        vnames = [c for c in self.columns
                  if include_key or c not in keys]
        out: Dict[Any, Any] = {}
        for r in self.rows(named=True):
            kv = r[keys[0]] if len(keys) == 1 else tuple(r[k] for k in keys)
            val = {c: r[c] for c in vnames} if named \
                else tuple(r[c] for c in vnames)
            if unique:
                out[kv] = val
            else:
                out.setdefault(kv, []).append(val)
        return out

    def equals(self, other: "DataFrame", *, null_equal: bool = True) -> bool:
        return self.columns == other.columns and \
            self.schema == other.schema and self.rows() == other.rows()

    def estimated_size(self, unit: str = "b"):
        total = 0
        for c in self._table.cols.values():
            for x in (c.data, c.validity, c.lengths, c.elem_valid):
                if x is not None:
                    total += x.numel() * x.element_size()
        div = {"b": 1, "kb": 1024, "mb": 1024 ** 2, "gb": 1024 ** 3}[unit]
        return total / div if div > 1 else int(total)

    def hash_rows(self, seed: int = 0) -> Series:
        """A UInt32 hash of each row's values (the port's mix of
        `ops/hashing`; the JAX package's hashes differ in value)."""
        from ..dtypes import UInt32
        from ..ops.hashing import combine_hashes, hash_array
        t = C.compact(self._table)
        acc = None
        for n in t.names:
            c = t.cols[n]
            h = hash_array(c.data, c.dtype, seed)
            acc = h if acc is None else combine_hashes(acc, h)
        return Series._from_column("", Column(UInt32, acc), t.count_rows())

    def match_to_schema(self, schema, *, missing_columns: str = "raise",
                        extra_columns: str = "raise") -> "DataFrame":
        from ..errors import SchemaError
        from ..expr.expr import lit
        tgt = dict(schema)
        out = self
        extra = [n for n in out.columns if n not in tgt]
        if extra:
            if extra_columns != "ignore":
                raise SchemaError(f"extra columns {extra}")
            out = out.drop(*extra)
        exprs = []
        for n, dt in tgt.items():
            dt = dt() if isinstance(dt, type) else dt
            if n in out.columns:
                exprs.append(_col(n).cast(dt) if out.schema[n] != dt
                             else _col(n))
            elif missing_columns == "insert":
                exprs.append(lit(None, dtype=dt).alias(n))
            else:
                raise SchemaError(f"missing column {n!r}")
        return out.select(exprs)

    def to_torch(self, return_type: str = "tensor"):
        """The columns as tensors on the frame's device: a dict of them,
        or one float32 (rows, columns) tensor."""
        t = C.compact(self._table)
        n = t.count_rows()
        if return_type == "dict":
            return {c: t.cols[c].data[:n] for c in t.names}
        return torch.stack([t.cols[c].data[:n].to(torch.float32)
                            for c in t.names], 1)

    def to_init_repr(self, n: int = 1000) -> str:
        d = self.head(n).to_dict()
        body = ",\n    ".join(
            f'pl.Series("{c}", {d[c]!r}, dtype=pl.{self.schema[c]!r})'
            for c in self.columns)
        return f"pl.DataFrame([\n    {body}\n])"

    def corr(self, **kw) -> "DataFrame":
        """The Pearson correlation matrix of the numeric columns."""
        num = [c for c in self.columns if self.schema[c].is_numeric]
        t = C.compact(self._table)
        n = t.count_rows()
        mat = torch.corrcoef(torch.stack(
            [t.cols[c].data[:n].to(torch.float64) for c in num]))
        mat = torch.atleast_2d(mat).cpu().numpy()
        return DataFrame({c: mat[i] for i, c in enumerate(num)},
                         device=self.device)

    # --- misc -------------------------------------------------------------
    def pipe(self, function, *args, **kwargs):
        return function(self, *args, **kwargs)

    def select_seq(self, *exprs, **named) -> "DataFrame":
        return self.select(*exprs, **named)

    def with_columns_seq(self, *exprs, **named) -> "DataFrame":
        return self.with_columns(*exprs, **named)

    def map_rows(self, function, return_dtype=None) -> "DataFrame":
        """`function` over each row tuple, on the host."""
        outs = [function(r) for r in self.rows()]
        if outs and isinstance(outs[0], tuple):
            cols = {f"column_{i}": [o[i] for o in outs]
                    for i in range(len(outs[0]))}
        else:
            cols = {"map": outs}
        return DataFrame(cols, device=self.device)

    def map_columns(self, names, function) -> "DataFrame":
        names = [names] if isinstance(names, str) else list(names)
        out = self
        for n in names:
            s = function(out.get_column(n))
            out = out.replace_column(out.columns.index(n), s.alias(n))
        return out

    def glimpse(self, *, return_as_string: bool = False):
        from .fmt import glimpse
        out = glimpse(self)
        if return_as_string:
            return out
        print(out)
        return None

    def show(self, n: int = 10) -> None:
        print(self.head(n))

    def sql(self, query: str, *, table_name: str = "self") -> "DataFrame":
        """SQL over this frame, registered as `table_name`."""
        from ..sql.context import SQLContext
        return SQLContext({table_name: self}).execute(query, eager=True)

    def clear(self, n: int = 0) -> "DataFrame":
        """A frame of this schema with `n` rows, all null."""
        from ..batch import _empty_column
        cap = capacity_for(n)
        none = torch.zeros(cap, dtype=torch.bool, device=self.device)
        cols = {}
        for k, dt in self.schema.items():
            c = _empty_column(dt, cap, self.device)
            cols[k] = c if not n else Column(c.dtype, c.data, none, c.sdict,
                                             lengths=c.lengths,
                                             elem_valid=c.elem_valid,
                                             fields=c.fields)
        return DataFrame._from_table(Table(list(cols), cols, cap, n, None,
                                           device=self.device))

    def clone(self) -> "DataFrame":
        return DataFrame._from_table(self._table)

    def rechunk(self) -> "DataFrame":
        return self

    def shrink_to_fit(self, in_place: bool = False) -> "DataFrame":
        return self if in_place else self.clone()

    def n_chunks(self, strategy: str = "first"):
        return 1 if strategy == "first" else [1] * self.width

    def flags(self) -> Dict[str, dict]:
        return {n: {"SORTED_ASC": False, "SORTED_DESC": False}
                for n in self.columns}

    def set_sorted(self, column, *, descending: bool = False
                   ) -> "DataFrame":
        return self     # sortedness is found where it is needed

    @property
    def style(self):
        raise ModuleNotFoundError(
            "DataFrame.style requires great_tables, which is not bundled")

    @property
    def plot(self):
        raise ModuleNotFoundError(
            "plotting requires altair, which is not bundled")
