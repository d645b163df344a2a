"""Logical query plan IR.

Capability analogue of the reference's `DslPlan`/`IR`
(`polars-plan/src/plans/ir/mod.rs:43` — variants Scan/Filter/Select/
GroupBy/Join/Sort/Distinct/Slice/HStack/Union/HConcat/Sink/...). Nodes are
immutable Python objects; schemas are resolved lazily and cached; plans
serialize to dicts (the `prepare_cloud_plan` analogue,
`polars-plan/src/client/mod.rs:8`) for the server layer.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..dtypes import Boolean, DataType, UInt32
from ..errors import ColumnNotFoundError, ComputeError, SchemaError
from ..expr import meta
from ..expr.expr import Expr

Schema = Dict[str, DataType]


class Plan:
    """Base logical plan node."""

    kind: str = "plan"
    inputs: Tuple["Plan", ...] = ()

    def __init__(self):
        self._schema: Optional[Schema] = None

    def schema(self) -> Schema:
        if self._schema is None:
            self._schema = self._compute_schema()
        return self._schema

    def _compute_schema(self) -> Schema:
        raise NotImplementedError

    def with_inputs(self, inputs: Sequence["Plan"]) -> "Plan":
        raise NotImplementedError

    def describe(self, indent: int = 0) -> str:
        pad = "  " * indent
        s = f"{pad}{self!r}"
        for i in self.inputs:
            s += "\n" + i.describe(indent + 1)
        return s

    def fingerprint(self) -> str:
        """Structural identity for common-subplan elimination (reference:
        `polars-plan/src/plans/optimizer/cse/`)."""
        parts = []
        for k, v in sorted(self.__dict__.items()):
            if k in ("_schema", "inputs", "_file_schema") or \
                    isinstance(v, Plan):
                continue
            parts.append(f"{k}={_fp_value(v)}")
        ch = ",".join(c.fingerprint() for c in self.inputs)
        return f"{self.kind}({';'.join(parts)};{ch})"

    def __repr__(self) -> str:
        return self.kind.upper()


def _fp_value(v) -> str:
    if isinstance(v, Expr):
        return v.fingerprint()
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_fp_value(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ",".join(f"{k}:{_fp_value(x)}"
                              for k, x in sorted(v.items())) + "}"
    if callable(v):
        return f"fn@{id(v)}"
    if hasattr(v, "cols") and hasattr(v, "capacity"):  # a Table
        return f"table@{id(v)}"
    return repr(v)


class DataFrameScan(Plan):
    kind = "df_scan"

    def __init__(self, table):
        super().__init__()
        self.table = table

    def _compute_schema(self) -> Schema:
        return dict(self.table.schema)

    def with_inputs(self, inputs):
        return self

    def __repr__(self):
        return f"DF_SCAN[{len(self.table.names)} cols]"


class Scan(Plan):
    kind = "scan"

    def __init__(self, fmt: str, source, columns: Optional[List[str]] = None,
                 predicate: Optional[Expr] = None,
                 n_rows: Optional[int] = None, options: Optional[dict] = None,
                 file_schema: Optional[Schema] = None):
        super().__init__()
        self.fmt = fmt
        self.source = source
        self.columns = columns
        self.predicate = predicate
        self.n_rows = n_rows
        self.options = options or {}
        self._file_schema = file_schema

    def file_schema(self) -> Schema:
        if self._file_schema is None:
            self._file_schema = _resolve_file_schema(self)
        return self._file_schema

    def _compute_schema(self) -> Schema:
        fs = self.file_schema()
        if self.columns is not None:
            return {c: fs[c] for c in self.columns}
        return dict(fs)

    def with_inputs(self, inputs):
        return self

    def replace(self, **kw) -> "Scan":
        s = Scan(self.fmt, self.source,
                 kw.get("columns", self.columns),
                 kw.get("predicate", self.predicate),
                 kw.get("n_rows", self.n_rows),
                 dict(self.options), self._file_schema)
        return s

    def __repr__(self):
        cols = f" π={len(self.columns)}" if self.columns is not None else ""
        pred = " σ" if self.predicate is not None else ""
        nr = f" n={self.n_rows}" if self.n_rows is not None else ""
        return f"SCAN[{self.fmt}:{self.source}]{cols}{pred}{nr}"


class FastCount(Plan):
    """count(*) fast path: row count straight from file metadata with no
    column reads (reference: the count-star rewrite,
    `polars-plan/src/plans/optimizer/count_star.rs`)."""

    kind = "fast_count"

    def __init__(self, fmt: str, source, n_rows: Optional[int], name: str):
        super().__init__()
        self.fmt = fmt
        self.source = source
        self.n_rows = n_rows
        self.name = name

    def _compute_schema(self) -> Schema:
        return {self.name: UInt32}

    def with_inputs(self, inputs):
        return self

    def __repr__(self):
        return f"FAST_COUNT[{self.fmt}:{self.source}]"


def _resolve_file_schema(scan: Scan) -> Schema:
    # file scans (io/parquet.py, io/arrow_interop.py) come with Slice A3:
    # the JAX package decodes through pyarrow, which the card's host lacks
    raise NotImplementedError(
        f"{scan.fmt} scans are not ported yet: they come with Slice H "
        "(host IO; Slice A3's file scans moved there)")


class _Unary(Plan):
    def __init__(self, input: Plan):
        super().__init__()
        self.input = input
        self.inputs = (input,)


class Select(_Unary):
    kind = "select"

    def __init__(self, input: Plan, exprs: List[Expr]):
        super().__init__(input)
        self.exprs = exprs

    def _compute_schema(self) -> Schema:
        ins = self.input.schema()
        out: Schema = {}
        for e in meta.expand_exprs(self.exprs, ins):
            out[meta.output_name(e)] = meta.output_dtype(e, ins)
        return out

    def with_inputs(self, inputs):
        return Select(inputs[0], self.exprs)

    def __repr__(self):
        return f"SELECT[{len(self.exprs)} exprs]"


class WithColumns(_Unary):
    kind = "with_columns"

    def __init__(self, input: Plan, exprs: List[Expr]):
        super().__init__(input)
        self.exprs = exprs

    def _compute_schema(self) -> Schema:
        out = dict(self.input.schema())
        for e in meta.expand_exprs(self.exprs, self.input.schema()):
            out[meta.output_name(e)] = meta.output_dtype(e, self.input.schema())
        return out

    def with_inputs(self, inputs):
        return WithColumns(inputs[0], self.exprs)

    def __repr__(self):
        return f"WITH_COLUMNS[{len(self.exprs)} exprs]"


class Filter(_Unary):
    kind = "filter"

    def __init__(self, input: Plan, predicate: Expr):
        super().__init__(input)
        self.predicate = predicate

    def _compute_schema(self) -> Schema:
        return self.input.schema()

    def with_inputs(self, inputs):
        return Filter(inputs[0], self.predicate)

    def __repr__(self):
        return "FILTER"


class GroupBy(_Unary):
    kind = "group_by"

    def __init__(self, input: Plan, keys: List[Expr], aggs: List[Expr],
                 maintain_order: bool = False):
        super().__init__(input)
        self.keys = keys
        self.aggs = aggs
        self.maintain_order = maintain_order

    def _compute_schema(self) -> Schema:
        ins = self.input.schema()
        out: Schema = {}
        for k in meta.expand_exprs(self.keys, ins):
            out[meta.output_name(k)] = meta.output_dtype(k, ins)
        for a in meta.expand_exprs(self.aggs, ins):
            out[meta.output_name(a)] = meta.output_dtype(a, ins)
        return out

    def with_inputs(self, inputs):
        return GroupBy(inputs[0], self.keys, self.aggs, self.maintain_order)

    def __repr__(self):
        return f"GROUP_BY[{len(self.keys)} keys, {len(self.aggs)} aggs]"


class Sort(_Unary):
    kind = "sort"

    def __init__(self, input: Plan, by: List[Expr], descending: List[bool],
                 nulls_last: List[bool], maintain_order: bool = True,
                 slice_: Optional[Tuple[int, int]] = None):
        super().__init__(input)
        self.by = by
        self.descending = descending
        self.nulls_last = nulls_last
        self.maintain_order = maintain_order
        self.slice_ = slice_  # top-k fusion (offset, len)

    def _compute_schema(self) -> Schema:
        return self.input.schema()

    def with_inputs(self, inputs):
        return Sort(inputs[0], self.by, self.descending, self.nulls_last,
                    self.maintain_order, self.slice_)

    def __repr__(self):
        tk = f" topk={self.slice_}" if self.slice_ else ""
        return f"SORT[{len(self.by)} keys]{tk}"


class Slice(_Unary):
    kind = "slice"

    def __init__(self, input: Plan, offset: int, length: Optional[int]):
        super().__init__(input)
        self.offset = offset
        self.length = length

    def _compute_schema(self) -> Schema:
        return self.input.schema()

    def with_inputs(self, inputs):
        return Slice(inputs[0], self.offset, self.length)

    def __repr__(self):
        return f"SLICE[{self.offset}:{self.length}]"


class Distinct(_Unary):
    kind = "distinct"

    def __init__(self, input: Plan, subset: Optional[List[str]],
                 keep: str = "any", maintain_order: bool = False):
        super().__init__(input)
        self.subset = subset
        self.keep = keep
        self.maintain_order = maintain_order

    def _compute_schema(self) -> Schema:
        return self.input.schema()

    def with_inputs(self, inputs):
        return Distinct(inputs[0], self.subset, self.keep, self.maintain_order)

    def __repr__(self):
        return f"DISTINCT[{self.subset}]"


class Join(Plan):
    kind = "join"

    def __init__(self, left: Plan, right: Plan, left_on: List[str],
                 right_on: List[str], how: str, suffix: str = "_right",
                 join_nulls: bool = False, coalesce: Optional[bool] = None,
                 maintain_order: Optional[str] = None,
                 validate: str = "m:m"):
        super().__init__()
        self.left = left
        self.right = right
        self.inputs = (left, right)
        self.left_on = left_on
        self.right_on = right_on
        self.how = how
        self.suffix = suffix
        self.join_nulls = join_nulls
        self.coalesce = coalesce
        self.maintain_order = maintain_order
        self.validate = validate

    def _compute_schema(self) -> Schema:
        ls = self.left.schema()
        rs = self.right.schema()
        how = self.how
        coalesce = self.coalesce
        if coalesce is None:
            coalesce = how not in ("full", "outer")
        out: Schema = {}
        if how in ("semi", "anti"):
            return dict(ls)
        if how == "right":
            for n, dt in ls.items():
                if coalesce and n in self.left_on:
                    continue
                out[n] = dt
            for n, dt in rs.items():
                name = n if n not in out else f"{n}{self.suffix}"
                out[name] = dt
            return out
        for n, dt in ls.items():
            out[n] = dt
        skip = set(self.right_on) if (coalesce and how != "cross") else set()
        for n, dt in rs.items():
            if n in skip:
                continue
            name = n if n not in out else f"{n}{self.suffix}"
            out[name] = dt
        return out

    def with_inputs(self, inputs):
        return Join(inputs[0], inputs[1], self.left_on, self.right_on,
                    self.how, self.suffix, self.join_nulls, self.coalesce,
                    self.maintain_order, self.validate)

    def __repr__(self):
        return f"JOIN[{self.how} on {self.left_on}]"


class IEJoin(Plan):
    """Inequality join (join_where): `preds` are (left_expr, op,
    right_expr) inequalities with op in lt/le/gt/ge; `post` are extra
    predicates over the joined schema. Reference:
    `polars-ops/src/frame/join/iejoin/mod.rs`."""
    kind = "iejoin"

    def __init__(self, left: Plan, right: Plan, preds, post,
                 suffix: str = "_right"):
        super().__init__()
        self.left = left
        self.right = right
        self.inputs = (left, right)
        self.preds = preds
        self.post = post
        self.suffix = suffix

    def _compute_schema(self) -> Schema:
        ls = self.left.schema()
        rs = self.right.schema()
        out: Schema = dict(ls)
        for n, dt in rs.items():
            name = n if n not in out else f"{n}{self.suffix}"
            out[name] = dt
        return out

    def with_inputs(self, inputs):
        return IEJoin(inputs[0], inputs[1], self.preds, self.post,
                      self.suffix)

    def __repr__(self):
        ops = ",".join(op for (_, op, _) in self.preds)
        return f"IEJOIN[{ops}]"


class Union(Plan):
    kind = "union"

    def __init__(self, inputs_: List[Plan], how: str = "vertical",
                 rechunk: bool = False):
        super().__init__()
        self.inputs = tuple(inputs_)
        self.how = how

    def _compute_schema(self) -> Schema:
        from ..dtypes import supertype
        if self.how.startswith("vertical"):
            base = dict(self.inputs[0].schema())
            for p in self.inputs[1:]:
                for n, dt in p.schema().items():
                    if n in base:
                        base[n] = supertype(base[n], dt)
            return base
        out: Schema = {}
        for p in self.inputs:
            for n, dt in p.schema().items():
                out[n] = supertype(out[n], dt) if n in out else dt
        return out

    def with_inputs(self, inputs):
        return Union(list(inputs), self.how)

    def __repr__(self):
        return f"UNION[{self.how}, {len(self.inputs)}]"


class HConcat(Plan):
    kind = "hconcat"

    def __init__(self, inputs_: List[Plan]):
        super().__init__()
        self.inputs = tuple(inputs_)

    def _compute_schema(self) -> Schema:
        out: Schema = {}
        for p in self.inputs:
            for n, dt in p.schema().items():
                if n in out:
                    raise SchemaError(f"duplicate column {n!r} in hconcat")
                out[n] = dt
        return out

    def with_inputs(self, inputs):
        return HConcat(list(inputs))


class Rename(_Unary):
    kind = "rename"

    def __init__(self, input: Plan, mapping: Dict[str, str]):
        super().__init__(input)
        self.mapping = mapping

    def _compute_schema(self) -> Schema:
        return {self.mapping.get(n, n): dt
                for n, dt in self.input.schema().items()}

    def with_inputs(self, inputs):
        return Rename(inputs[0], self.mapping)

    def __repr__(self):
        return f"RENAME[{self.mapping}]"


class Drop(_Unary):
    kind = "drop"

    def __init__(self, input: Plan, names: List[str], strict: bool = True):
        super().__init__(input)
        self.names = names
        self.strict = strict

    def _compute_schema(self) -> Schema:
        drop = set(self.names)
        if self.strict:
            for n in drop:
                if n not in self.input.schema():
                    raise ColumnNotFoundError(f"{n!r} not found")
        return {n: dt for n, dt in self.input.schema().items() if n not in drop}

    def with_inputs(self, inputs):
        return Drop(inputs[0], self.names, self.strict)

    def __repr__(self):
        return f"DROP[{self.names}]"


class WithRowIndex(_Unary):
    kind = "with_row_index"

    def __init__(self, input: Plan, name: str = "index", offset: int = 0):
        super().__init__(input)
        self.name = name
        self.offset = offset

    def _compute_schema(self) -> Schema:
        return {self.name: UInt32, **self.input.schema()}

    def with_inputs(self, inputs):
        return WithRowIndex(inputs[0], self.name, self.offset)


class MapFunction(_Unary):
    """Opaque host function Table -> Table (blocks pushdown)."""

    kind = "map_function"

    def __init__(self, input: Plan, fn, schema_fn=None, streamable=False,
                 label: str = "map"):
        super().__init__(input)
        self.fn = fn
        self.schema_fn = schema_fn
        self.streamable = streamable
        self.label = label

    def _compute_schema(self) -> Schema:
        if self.schema_fn is not None:
            return self.schema_fn(self.input.schema())
        return self.input.schema()

    def with_inputs(self, inputs):
        return MapFunction(inputs[0], self.fn, self.schema_fn,
                           self.streamable, self.label)

    def __repr__(self):
        return f"MAP[{self.label}]"


class Sink(_Unary):
    kind = "sink"

    def __init__(self, input: Plan, fmt: str, target, options: dict):
        super().__init__(input)
        self.fmt = fmt
        self.target = target
        self.options = options

    def _compute_schema(self) -> Schema:
        return self.input.schema()

    def with_inputs(self, inputs):
        return Sink(inputs[0], self.fmt, self.target, self.options)

    def __repr__(self):
        return f"SINK[{self.fmt}:{self.target}]"


class Cache(_Unary):
    """Materialize-once barrier: the executor memoizes this subtree's
    result per query run (reference: IR::Cache + common-subplan-elim,
    `polars-plan/src/plans/optimizer/cse/`)."""

    kind = "cache"
    _counter = [0]

    def __init__(self, input: Plan, cache_id: Optional[int] = None):
        super().__init__(input)
        if cache_id is None:
            Cache._counter[0] += 1
            cache_id = Cache._counter[0]
        self.cache_id = cache_id

    def _compute_schema(self) -> Schema:
        return self.input.schema()

    def with_inputs(self, inputs):
        return Cache(inputs[0], self.cache_id)

    def __repr__(self):
        return f"CACHE[{self.cache_id}]"


class Explode(_Unary):
    kind = "explode"

    def __init__(self, input: Plan, columns: List[str]):
        super().__init__(input)
        self.columns = columns

    def _compute_schema(self) -> Schema:
        from ..dtypes import List as ListT
        out = dict(self.input.schema())
        for c in self.columns:
            dt = out.get(c)
            if isinstance(dt, ListT):
                out[c] = dt.inner
        return out

    def with_inputs(self, inputs):
        return Explode(inputs[0], self.columns)


class Unpivot(_Unary):
    kind = "unpivot"

    def __init__(self, input: Plan, on: List[str], index: List[str],
                 variable_name: str = "variable", value_name: str = "value"):
        super().__init__(input)
        self.on = on
        self.index = index
        self.variable_name = variable_name
        self.value_name = value_name

    def _compute_schema(self) -> Schema:
        from ..dtypes import String, supertype
        ins = self.input.schema()
        out = {n: ins[n] for n in self.index}
        out[self.variable_name] = String
        dt = None
        for n in self.on:
            dt = ins[n] if dt is None else supertype(dt, ins[n])
        out[self.value_name] = dt
        return out

    def with_inputs(self, inputs):
        return Unpivot(inputs[0], self.on, self.index, self.variable_name,
                       self.value_name)
