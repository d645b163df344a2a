"""LazyFrame: deferred query construction (the subset the port has so
far).

Parity target: `py-polars/src/polars/lazyframe/frame.py`, as in the JAX
package's `api/lazyframe.py`: builds the logical plan
(`plan/logical.py`), runs the optimizer, then the in-memory executor,
and compacts the result on the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..expr import meta
from ..expr.expr import Expr, col as _col
from ..plan import logical as L
from ..plan.optimizer import optimize
from .frame import _join_keys, _per_key


def _to_exprs(args, kwargs=None) -> List[Expr]:
    from .frame import _to_exprs as f
    return f(args, kwargs)


class LazyFrame:
    def __init__(self, data=None, schema=None, device=None):
        from .frame import DataFrame
        self._plan = L.DataFrameScan(
            DataFrame(data, schema=schema, device=device)._table)

    @classmethod
    def _from_plan(cls, plan: L.Plan) -> "LazyFrame":
        lf = cls.__new__(cls)
        lf._plan = plan
        return lf

    @classmethod
    def _from_table(cls, table) -> "LazyFrame":
        return cls._from_plan(L.DataFrameScan(table))

    # --- introspection --------------------------------------------------
    @property
    def columns(self) -> List[str]:
        return list(self._plan.schema().keys())

    @property
    def schema(self) -> Dict[str, object]:
        return dict(self._plan.schema())

    def explain(self, optimized: bool = True) -> str:
        p = optimize(self._plan) if optimized else self._plan
        return p.describe()

    def __repr__(self) -> str:
        return f"<LazyFrame at 0x{id(self):x}>\n{self._plan.describe()}"

    # --- plan constructors ------------------------------------------------
    def select(self, *exprs, **named) -> "LazyFrame":
        stripped, explode_names = [], []
        for e in _to_exprs(exprs, named):
            e2, hit = meta.strip_top_explode(e)
            stripped.append(e2)
            if hit:
                explode_names.append(meta.output_name(e2))
        plan = L.Select(self._plan, stripped)
        if explode_names:
            plan = L.Explode(plan, explode_names)
        return LazyFrame._from_plan(plan)

    def explode(self, *columns) -> "LazyFrame":
        from .frame import _column_names
        return LazyFrame._from_plan(L.Explode(self._plan,
                                              _column_names(columns)))

    def unnest(self, *columns) -> "LazyFrame":
        from .frame import _column_names, unnest_schema, unnest_table
        names = _column_names(columns)
        return LazyFrame._from_plan(L.MapFunction(
            self._plan, lambda t: unnest_table(t, names),
            schema_fn=lambda s: unnest_schema(s, names),
            label=f"unnest[{','.join(names)}]"))

    def with_columns(self, *exprs, **named) -> "LazyFrame":
        return LazyFrame._from_plan(
            L.WithColumns(self._plan, _to_exprs(exprs, named)))

    def filter(self, *predicates, **constraints) -> "LazyFrame":
        preds = _to_exprs(predicates)
        for k, v in constraints.items():
            preds.append(_col(k) == v)
        pred = preds[0]
        for p in preds[1:]:
            pred = pred & p
        return LazyFrame._from_plan(L.Filter(self._plan, pred))

    def group_by(self, *by, maintain_order: bool = False, **named_by):
        return LazyGroupBy(self, _to_exprs(by, named_by), maintain_order)

    def sort(self, by, *more_by, descending=False, nulls_last=False,
             maintain_order: bool = False) -> "LazyFrame":
        """A sort node (`ops/sort.sort_table` on the device); the
        optimizer removes it where the input is already in that order (a
        group-by's key order). `descending` and `nulls_last` take one
        flag or one per key."""
        keys = _to_exprs((by,) + more_by)
        nk = len(keys)
        return LazyFrame._from_plan(L.Sort(
            self._plan, keys, _per_key(descending, nk),
            _per_key(nulls_last, nk), maintain_order))

    def top_k(self, k: int, by, descending=False) -> "LazyFrame":
        """The k rows with the largest keys, largest first (the smallest
        for a key marked `descending`); nulls last. A sort node fused with
        its slice, run by `ops/sort.top_k_table`."""
        keys = _to_exprs(tuple(by) if isinstance(by, (list, tuple))
                         else (by,))
        nk = len(keys)
        desc = [not d for d in _per_key(descending, nk)]
        return LazyFrame._from_plan(
            L.Sort(self._plan, keys, desc, [True] * nk, True, (0, k)))

    def bottom_k(self, k: int, by, descending=False) -> "LazyFrame":
        """The k rows with the smallest keys, smallest first; nulls
        last."""
        desc = [not d for d in descending] \
            if isinstance(descending, (list, tuple)) else not descending
        return self.top_k(k, by, descending=desc)

    def head(self, n: int = 5) -> "LazyFrame":
        return LazyFrame._from_plan(L.Slice(self._plan, 0, n))

    def limit(self, n: int = 5) -> "LazyFrame":
        return self.head(n)

    def tail(self, n: int = 5) -> "LazyFrame":
        return LazyFrame._from_plan(L.Slice(self._plan, -n, n))

    def slice(self, offset: int, length: Optional[int] = None
              ) -> "LazyFrame":
        return LazyFrame._from_plan(L.Slice(self._plan, offset, length))

    def first(self) -> "LazyFrame":
        return self.head(1)

    def last(self) -> "LazyFrame":
        return self.tail(1)

    def shift(self, n: int = 1, *, fill_value=None) -> "LazyFrame":
        return self.with_columns([_col(c).shift(n, fill_value=fill_value)
                                  for c in self.columns])

    def interpolate(self) -> "LazyFrame":
        return self.with_columns([_col(c).interpolate()
                                  for c, dt in self._plan.schema().items()
                                  if dt.is_numeric])

    def fill_null(self, value=None, strategy: Optional[str] = None
                  ) -> "LazyFrame":
        return self.with_columns([_col("*").fill_null(value,
                                                      strategy=strategy)])

    def join(self, other: "LazyFrame", on=None, how: str = "inner", *,
             left_on=None, right_on=None, suffix: str = "_right",
             join_nulls: bool = False, nulls_equal: bool = False,
             coalesce: Optional[bool] = None,
             maintain_order: Optional[str] = None,
             validate: str = "m:m", allow_parallel: bool = True
             ) -> "LazyFrame":
        """A join node (see `DataFrame.join`). Unlike the JAX package's
        lazy join, it keeps `validate`; `allow_parallel` is accepted and,
        as there, changes nothing."""
        left_on, right_on = _join_keys(on, how, left_on, right_on)
        return LazyFrame._from_plan(L.Join(
            self._plan, other._plan, left_on, right_on, how, suffix,
            join_nulls or nulls_equal, coalesce, maintain_order, validate))

    def unique(self, subset=None, keep: str = "any",
               maintain_order: bool = False) -> "LazyFrame":
        names = [subset] if isinstance(subset, str) else \
            (list(subset) if subset is not None else None)
        return LazyFrame._from_plan(
            L.Distinct(self._plan, names, keep, maintain_order))

    def group_by_dynamic(self, index_column: str, *, every: str,
                         period: Optional[str] = None,
                         offset: Optional[str] = None, closed: str = "left",
                         group_by=None, start_by: str = "window"):
        """Dynamic windows (see `DataFrame.group_by_dynamic`). Windows
        that do not overlap lower to a group-by on the truncated index
        and a sort by the keys, which every optimizer pass sees through;
        overlapping ones to a map_function node."""
        return _LazyDynamic(self, index_column, every, period, offset,
                            closed, group_by, start_by)

    def rolling(self, index_column: str, *, period: str, group_by=None,
                closed: str = "right"):
        """Rolling windows (see `DataFrame.rolling`), as a map_function
        node."""
        return _LazyRolling(self, index_column, period, group_by, closed)

    def join_asof(self, other: "LazyFrame", *, on=None, left_on=None,
                  right_on=None, by=None, by_left=None, by_right=None,
                  strategy: str = "backward", suffix: str = "_right",
                  tolerance=None) -> "LazyFrame":
        """Each left row joined to the right row whose key is the last
        at or before its own ("backward"), the first at or after it
        ("forward") or the nearer of the two ("nearest"), within equal
        `by` values and `tolerance` (`ops/asof.py`). A null key never
        matches."""
        from ..ops.asof import asof_join_plan
        return asof_join_plan(self, other, on, left_on, right_on, by,
                              by_left, by_right, strategy, suffix, tolerance)

    def join_where(self, other: "LazyFrame", *predicates,
                   suffix: str = "_right") -> "LazyFrame":
        """Inequality join (`ops/iejoin.py`): predicates of the form
        `left_expr OP right_expr` (OP an inequality) drive a sort and
        wavelet-tree enumeration of the pairs, with no cross product.
        Right-side names that clash take `suffix`, and the predicates
        name them so. Predicates that do not split into one side each
        filter the pairs; with none that splits, the join is a cross
        join and a filter."""
        from ..errors import ComputeError
        from ..expr import meta
        if not predicates:
            raise ComputeError("join_where requires at least one predicate")
        preds = _to_exprs(predicates)
        lschema = self._plan.schema()
        rschema = other._plan.schema()
        out_right = {f"{n}{suffix}" if n in lschema else n: n
                     for n in rschema}
        flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}

        def side(e):
            roots = meta.root_names(e)
            if roots and roots <= set(lschema):
                return "l"
            if roots and roots <= set(out_right):
                return "r"
            return None

        def to_right(e):
            # joined-output names back to the right frame's names
            if e.kind == "col":
                return Expr("col", (), name=out_right[e.attrs["name"]])
            if not e.children:
                return e
            return Expr(e.kind, tuple(to_right(c) for c in e.children),
                        **e.attrs)

        def sortable(e):
            try:
                dt = meta.output_dtype(e, lschema)
            except Exception:
                return False
            return not (dt.is_string or dt.is_nested)

        ineq, post = [], []
        for p in preds:
            op = p.attrs.get("op") if p.kind == "binary" else None
            if op in flip:
                a, b = p.children
                sa, sb = side(a), side(b)
                if sa == "l" and sb == "r" and sortable(a):
                    ineq.append((a, op, to_right(b)))
                    continue
                if sa == "r" and sb == "l" and sortable(b):
                    ineq.append((b, flip[op], to_right(a)))
                    continue
            post.append(p)
        if ineq:
            return LazyFrame._from_plan(
                L.IEJoin(self._plan, other._plan, ineq, post, suffix))
        pred = preds[0]
        for p in preds[1:]:
            pred = pred & p
        crossed = L.Join(self._plan, other._plan, [], [], "cross", suffix,
                         False, None)
        return LazyFrame._from_plan(L.Filter(crossed, pred))

    def lazy(self) -> "LazyFrame":
        return self

    # --- the rest of the lazy surface --------------------------------------
    def collect_schema(self) -> Dict[str, object]:
        return self.schema

    @property
    def dtypes(self):
        return list(self._plan.schema().values())

    @property
    def width(self) -> int:
        return len(self.columns)

    def show_graph(self) -> str:
        return self.explain()

    def optimized_plan(self) -> L.Plan:
        return optimize(self._plan)

    def drop(self, *names, strict: bool = True) -> "LazyFrame":
        from .frame import _column_names
        return LazyFrame._from_plan(L.Drop(self._plan, _column_names(names),
                                           strict))

    def rename(self, mapping: Dict[str, str], strict: bool = True
               ) -> "LazyFrame":
        return LazyFrame._from_plan(L.Rename(self._plan, dict(mapping)))

    def cast(self, dtypes, strict: bool = True) -> "LazyFrame":
        exprs = [_col(k).cast(v, strict=strict) for k, v in dtypes.items()] \
            if isinstance(dtypes, dict) else \
            [_col(n).cast(dtypes, strict=strict) for n in self.columns]
        return self.with_columns(exprs)

    def with_row_index(self, name: str = "index", offset: int = 0
                       ) -> "LazyFrame":
        return LazyFrame._from_plan(L.WithRowIndex(self._plan, name, offset))

    def with_row_count(self, name: str = "row_nr", offset: int = 0
                       ) -> "LazyFrame":
        return self.with_row_index(name, offset)

    def drop_nulls(self, subset=None) -> "LazyFrame":
        names = [subset] if isinstance(subset, str) else \
            (subset or self.columns)
        pred = None
        for n in names:
            p = _col(n).is_not_null()
            pred = p if pred is None else pred & p
        return self.filter(pred) if pred is not None else self

    def drop_nans(self, subset=None) -> "LazyFrame":
        sch = self.schema
        names = [subset] if isinstance(subset, str) else (subset or list(sch))
        pred = None
        for n in names:
            if sch[n].is_float:
                p = _col(n).is_not_nan().fill_null(True)  # nulls are kept
                pred = p if pred is None else pred & p
        return self.filter(pred) if pred is not None else self

    def fill_nan(self, value) -> "LazyFrame":
        exprs = [_col(n).fill_nan(value) for n, dt in self.schema.items()
                 if dt.is_float]
        return self.with_columns(exprs) if exprs else self

    def remove(self, *predicates, **constraints) -> "LazyFrame":
        preds = [p if isinstance(p, Expr) else _col(str(p))
                 for p in predicates]
        preds += [_col(k) == v for k, v in constraints.items()]
        if not preds:
            return self
        keep = preds[0]
        for p in preds[1:]:
            keep = keep & p
        return self.filter(~keep.fill_null(False))

    def gather_every(self, n: int, offset: int = 0) -> "LazyFrame":
        return self.select([_col(c).gather_every(n, offset)
                            for c in self.columns])

    def reverse(self) -> "LazyFrame":
        return self.select([_col(c).reverse() for c in self.columns])

    def merge_sorted(self, other: "LazyFrame", key: str) -> "LazyFrame":
        """Two frames sorted by `key` merged into one: a stable sort of
        their union by the key."""
        union = L.Union([self._plan, other._plan], "vertical_relaxed")
        return LazyFrame._from_plan(
            L.Sort(union, [_col(key)], [False], [False], True))

    def unpivot(self, on=None, *, index=None,
                variable_name: str = "variable",
                value_name: str = "value") -> "LazyFrame":
        index = [index] if isinstance(index, str) else list(index or [])
        if on is None:
            on = [c for c in self.columns if c not in index]
        on = [on] if isinstance(on, str) else list(on)
        return LazyFrame._from_plan(
            L.Unpivot(self._plan, on, index, variable_name, value_name))

    melt = unpivot

    def pivot(self, on, on_columns, *, index=None, values=None,
              aggregate_function=None, maintain_order: bool = False,
              separator: str = "_") -> "LazyFrame":
        """A pivot whose output columns `on_columns` names up front (so
        the schema is known before the run)."""
        on_col = on if isinstance(on, str) else list(on)[0]
        combos = list(on_columns.to_list() if hasattr(on_columns, "to_list")
                      else on_columns)
        schema = self._plan.schema()
        idx = [index] if isinstance(index, str) else list(index or [])
        vals = [values] if isinstance(values, str) else \
            list(values) if values is not None else None
        if not idx:
            idx = [c for c in schema if c != on_col and
                   (vals is None or c not in vals)][:1]
        if vals is None:
            vals = [c for c in schema if c != on_col and c not in idx]

        def run(df):
            return df.pivot(on_col, index=idx, values=vals,
                            aggregate_function=aggregate_function or "first",
                            on_columns=combos, separator=separator)

        def out_schema(ins):
            out = {c: ins[c] for c in idx}
            for v in vals:
                for c in combos:
                    out[str(c) if len(vals) == 1
                        else f"{v}{separator}{c}"] = ins[v]
            return out
        return self._map_frame(run, out_schema, "pivot")

    def _map_frame(self, fn, schema_fn=None, label: str = "map",
                   streamable: bool = False) -> "LazyFrame":
        """An opaque DataFrame -> DataFrame step of the plan; a streamable
        one runs on each batch of a streaming collect."""
        def wrapped(t):
            from .frame import DataFrame
            return fn(DataFrame._from_table(t))._table
        return LazyFrame._from_plan(L.MapFunction(
            self._plan, wrapped, schema_fn, streamable, label))

    def map_batches(self, fn, schema=None, streamable: bool = False
                    ) -> "LazyFrame":
        return self._map_frame(fn, (lambda s: dict(schema)) if schema
                               else None, streamable=streamable)

    def match_to_schema(self, schema, **kw) -> "LazyFrame":
        sch = {n: (d() if isinstance(d, type) else d)
               for n, d in dict(schema).items()}
        return self._map_frame(lambda df: df.match_to_schema(schema, **kw),
                               lambda _s: sch)

    def update(self, other: "LazyFrame", on=None, how: str = "left",
               include_nulls: bool = False) -> "LazyFrame":
        def fn(df):
            o = other.collect() if isinstance(other, LazyFrame) else other
            return df.update(o, on=on, how=how, include_nulls=include_nulls)
        return self._map_frame(fn)

    def with_context(self, other) -> "LazyFrame":
        """The other frames' columns beside this one's, at collect."""
        others = other if isinstance(other, (list, tuple)) else [other]

        def fn(df):
            for o in others:
                df = df.hstack(o.collect() if isinstance(o, LazyFrame)
                               else o)
            return df
        return self._map_frame(fn)

    def inspect(self, fmt: str = "{}") -> "LazyFrame":
        def fn(df):
            print(fmt.format(df))
            return df
        return self._map_frame(fn, label="inspect")

    def cache(self) -> "LazyFrame":
        return LazyFrame._from_plan(L.Cache(self._plan))

    def clone(self) -> "LazyFrame":
        return LazyFrame._from_plan(self._plan)

    def clear(self, n: int = 0) -> "LazyFrame":
        return self.collect().clear(n).lazy()

    def set_sorted(self, column, *, descending: bool = False
                   ) -> "LazyFrame":
        return self     # sortedness is found where it is needed

    def pipe(self, function, *args, **kwargs):
        return function(self, *args, **kwargs)

    def pipe_with_schema(self, function) -> "LazyFrame":
        return function(self, dict(self._plan.schema()))

    def select_seq(self, *exprs, **named) -> "LazyFrame":
        return self.select(*exprs, **named)

    def with_columns_seq(self, *exprs, **named) -> "LazyFrame":
        return self.with_columns(*exprs, **named)

    def _agg_all(self, agg: str, **kw) -> "LazyFrame":
        cols = [n for n, dt in self._plan.schema().items()
                if agg in ("count", "null_count", "first", "last")
                or dt.is_numeric or dt.is_bool or dt.is_temporal
                or (agg in ("min", "max") and dt.is_string)]
        return self.select([Expr("agg", (_col(n),), agg=agg, **kw).alias(n)
                            for n in cols])

    def sum(self) -> "LazyFrame":
        return self._agg_all("sum")

    def mean(self) -> "LazyFrame":
        return self._agg_all("mean")

    def min(self) -> "LazyFrame":
        return self._agg_all("min")

    def max(self) -> "LazyFrame":
        return self._agg_all("max")

    def median(self) -> "LazyFrame":
        return self._agg_all("median")

    def std(self, ddof: int = 1) -> "LazyFrame":
        return self._agg_all("std", ddof=ddof)

    def var(self, ddof: int = 1) -> "LazyFrame":
        return self._agg_all("var", ddof=ddof)

    def quantile(self, q: float, interpolation: str = "nearest"
                 ) -> "LazyFrame":
        return self._agg_all("quantile", q=q, interpolation=interpolation)

    def null_count(self) -> "LazyFrame":
        return self._agg_all("null_count")

    def count(self) -> "LazyFrame":
        return self._agg_all("count")

    def approx_n_unique(self) -> "LazyFrame":
        return self._agg_all("n_unique")

    def describe(self):
        return self.collect().describe()

    def fetch(self, n_rows: int = 500):
        return self.head(n_rows).collect()

    def profile(self, **kw):
        """(the result, a frame with one row per node the executor ran —
        a fused chain is one — and its wall ms, fenced on the card)."""
        from .frame import DataFrame
        from ..exec.executor import ExecState, execute
        from ..ops.compact import compact
        self._plan.schema()
        state = ExecState(track_metrics=True)
        t = execute(optimize(self._plan), state)
        prof = DataFrame({"node": [n for n, _ in state.timings],
                          "ms": [dt * 1e3 for _, dt in state.timings]},
                         device=t.device)
        return DataFrame._from_table(compact(t)), prof

    def show(self, n: int = 10) -> None:
        print(self.head(n).collect())

    def sql(self, query: str, *, table_name: str = "self") -> "LazyFrame":
        """SQL over this frame, registered as `table_name`."""
        from ..sql.context import SQLContext
        return SQLContext({table_name: self}).execute(query)

    # --- execution ------------------------------------------------------
    def collect(self, engine: str = "auto", streaming: bool = False,
                background: bool = False, **kw):
        """Run the plan; the result's live rows are compacted on the
        device and its row count stays there until the host reads it.
        `engine="auto"` takes `CONFIG.engine_affinity`; "streaming" (or
        `streaming=True`) runs the streaming executor over the plan
        optimized for it; "distributed" shards it over `mesh` (default
        `make_mesh()`: a slot on each card), which must have its home
        slot on the frame's device; anything else runs in memory."""
        from .frame import DataFrame
        from ..config import CONFIG
        from ..exec.executor import ExecState, execute
        from ..ops.compact import compact
        self._plan.schema()  # validate names/dtypes before pushdowns
        eng = engine if engine != "auto" else CONFIG.engine_affinity
        if streaming:
            eng = "streaming"
        plan = self._optimized(eng)
        if CONFIG.visualize_ir:
            print(plan.describe())
        if eng == "streaming":
            from ..exec.streaming import execute_streaming
            t = execute_streaming(plan)
        elif eng == "distributed":
            from ..exec.distributed import collect_distributed
            t = collect_distributed(plan, kw.get("mesh"))
        else:
            state = ExecState()
            t = execute(plan, state)
            if CONFIG.log_metrics and state.timings:
                for name, dt in state.timings:
                    print(f"[metrics] {name}: {dt*1e3:.2f} ms")
        return DataFrame._from_table(compact(t))

    def _optimized(self, engine: str) -> L.Plan:
        """The plan optimized for `engine`, kept on this frame: a lazy
        frame's plan never changes, so its later collects reuse the
        optimizer's work. (The JAX package keeps a process-wide cache by
        plan fingerprint; here that would keep every collected frame's
        device tensors alive.)"""
        cache = self.__dict__.setdefault("_opt_plans", {})
        plan = cache.get(engine)
        if plan is None:
            plan = cache[engine] = optimize(self._plan, engine)
        return plan

    def collect_async(self, **kw):
        """Collect on a worker thread; returns a concurrent Future. On the
        card the thread runs on the frame's device, on a stream of its
        own that first waits for the caller's stream, and synchronizes
        that stream before the Future resolves."""
        return _submit(self._plan, lambda: self.collect(**kw))

    def collect_batches(self, *, batch_size: int = 65536, engine="auto"):
        """Iterator of DataFrame batches of `batch_size` rows of the
        result."""
        out = self.collect(engine=engine)
        off = 0
        while off < out.height:
            yield out.slice(off, batch_size)
            off += batch_size

    def sink_batches(self, callback, *, batch_size: int = 65536,
                     engine="auto") -> None:
        """Call `callback` on each batch of the result; a truthy return
        stops (polars' contract)."""
        for b in self.collect_batches(batch_size=batch_size, engine=engine):
            if callback(b):
                break

    # --- sinks (the streaming engine writes batch by batch) ---------------
    def _sink(self, fmt: str, path, kw) -> None:
        from ..exec.streaming import execute_streaming
        execute_streaming(optimize(L.Sink(self._plan, fmt, path, kw),
                                   "streaming"))

    def sink_parquet(self, path, **kw) -> None:
        """The result written to Parquet batch by batch; a
        `PartitionByKey` path writes a hive directory per key, a
        `PartitionMaxSize` files of at most its size."""
        from .io import PartitionByKey, PartitionMaxSize
        if isinstance(path, PartitionByKey):
            self.collect().write_parquet(path.base_path,
                                         partition_by=path.by, **kw)
            return
        if isinstance(path, PartitionMaxSize):
            import os
            os.makedirs(path.base_path, exist_ok=True)
            for i, b in enumerate(self.collect_batches(
                    batch_size=path.max_size)):
                b.write_parquet(os.path.join(path.base_path,
                                             f"{i:08d}.parquet"), **kw)
            return
        self._sink("parquet", path, kw)

    def sink_csv(self, path, **kw) -> None:
        self._sink("csv", path, kw)

    def sink_ipc(self, path, **kw) -> None:
        self._sink("ipc", path, kw)

    def sink_ndjson(self, path, **kw) -> None:
        self._sink("ndjson", path, kw)

    # --- serialization and remote execution ---------------------------------
    def serialize(self) -> str:
        """The plan as JSON text in the JAX package's format (an
        in-memory frame's rows as Arrow IPC, which needs pyarrow)."""
        import json
        from ..plan.serde import plan_to_dict
        return json.dumps(plan_to_dict(self._plan))

    @staticmethod
    def deserialize(source, device=None) -> "LazyFrame":
        import json
        from ..plan.serde import plan_from_dict
        data = json.loads(source) if isinstance(source, str) else source
        return LazyFrame._from_plan(plan_from_dict(data, device))

    def remote(self, context=None, **_kw) -> "LazyFrameRemote":
        """Run this query elsewhere: without a context, `collect()` runs
        the distributed engine on the default mesh (a shard slot on each
        card); with a server's address or a `client.RemoteClient`, the
        plan is shipped there and the result comes back."""
        return LazyFrameRemote(self, context)


class LazyFrameRemote:
    """A lazy frame to run remotely (polars cloud's `LazyFrameRemote`).
    Without a context it runs on the in-process distributed engine; with
    a `RemoteClient`, or an address string (a client made for the call,
    its result on this plan's device), through the server's ExecutePlan
    and Collect. The handle the call made is released after."""

    def __init__(self, lf: LazyFrame, context=None):
        self._lf = lf
        self._context = context

    def collect(self, **kw):
        ctx = self._context
        if ctx is None:
            return self._lf.collect(engine="distributed", **kw)
        owned = isinstance(ctx, str)
        if owned:
            from ..client import RemoteClient
            ctx = RemoteClient(ctx, device=_plan_device(self._lf._plan))
        try:
            rf = ctx.execute_plan(self._lf)
            try:
                return rf.collect()
            finally:
                rf.release()
        finally:
            if owned:
                ctx.close()

    def show(self, n: int = 10):
        return self._lf.head(n).collect()


def _plan_device(plan: L.Plan):
    """The device of the first in-memory table or file scan that names
    one under `plan`, else the configured one."""
    from ..batch import resolve_device
    stack = [plan]
    while stack:
        p = stack.pop()
        if p.kind == "df_scan":
            return p.table.device
        if p.kind in ("scan", "fast_count") and p.device is not None:
            return resolve_device(p.device)
        stack.extend(p.inputs)
    return resolve_device(None)


def _submit(plan: L.Plan, fn):
    """fn() on a worker thread, as `LazyFrame.collect_async` says."""
    import concurrent.futures as _fut
    import torch
    dev = _plan_device(plan)

    def run():
        if dev.type != "cuda":
            return fn()
        with torch.cuda.device(dev):
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                out = fn()
            stream.synchronize()
        return out
    caller = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    ex = _fut.ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(run)
    ex.shutdown(wait=False)
    return fut


class LazyGroupBy:
    """A lazy group-by. `having`'s predicates are aggregated beside the
    others as hidden `__pt_having_i` columns, which a filter after the
    group-by reads (a null as False) and drops."""

    def __init__(self, lf: LazyFrame, keys: List[Expr],
                 maintain_order: bool, having=None):
        self._lf = lf
        self._keys = keys
        self._maintain_order = maintain_order
        self._having = list(having) if having else []

    def agg(self, *aggs, **named) -> LazyFrame:
        hav = [h.alias(f"__pt_having_{i}")
               for i, h in enumerate(self._having)]
        out = LazyFrame._from_plan(
            L.GroupBy(self._lf._plan, self._keys,
                      _to_exprs(aggs, named) + hav, self._maintain_order))
        if not hav:
            return out
        names = [f"__pt_having_{i}" for i in range(len(hav))]
        pred = _col(names[0]).fill_null(False)
        for n in names[1:]:
            pred = pred & _col(n).fill_null(False)
        return out.filter(pred).drop(*names)

    def having(self, *predicates) -> "LazyGroupBy":
        return LazyGroupBy(self._lf, self._keys, self._maintain_order,
                           having=self._having + list(predicates))

    def head(self, n: int = 5) -> LazyFrame:
        """The first n rows of every group, in the frame's row order."""
        return self._lf.filter(self._ordinal() <= n)

    def tail(self, n: int = 5) -> LazyFrame:
        glen = Expr("table_len").over(*self._keys)
        return self._lf.filter(self._ordinal() > glen - n)

    def _ordinal(self) -> Expr:
        from ..expr.expr import lit
        return lit(True).cum_count().over(*self._keys)

    def all(self) -> LazyFrame:
        return self._each(lambda c: c.implode())

    def map_groups(self, function, schema=None) -> LazyFrame:
        from .groupby import GroupBy
        keys, order = self._keys, self._maintain_order
        return self._lf.map_batches(
            lambda df: GroupBy(df, keys, order).map_groups(function),
            schema=schema)

    apply = map_groups

    def len(self, name: str = "len") -> LazyFrame:
        return self.agg(Expr("table_len").alias(name))

    def count(self) -> LazyFrame:
        return self.len(name="count")

    def sum(self) -> LazyFrame:
        return self._arith(lambda c: c.sum())

    def mean(self) -> LazyFrame:
        return self._arith(lambda c: c.mean())

    def median(self) -> LazyFrame:
        return self._arith(lambda c: c.median())

    def quantile(self, q: float, interpolation: str = "nearest"
                 ) -> LazyFrame:
        return self._arith(lambda c: c.quantile(q, interpolation))

    def min(self) -> LazyFrame:
        return self._each(lambda c: c.min())

    def max(self) -> LazyFrame:
        return self._each(lambda c: c.max())

    def first(self) -> LazyFrame:
        return self._each(lambda c: c.first())

    def last(self) -> LazyFrame:
        return self._each(lambda c: c.last())

    def n_unique(self) -> LazyFrame:
        return self._each(lambda c: c.n_unique())

    def _non_keys(self) -> Dict[str, object]:
        """The columns that are not a key's output name, with their
        dtypes (a key without a name leaves every column)."""
        from ..errors import ComputeError
        keys = set()
        for k in self._keys:
            try:
                keys.add(meta.output_name(k))
            except ComputeError:
                pass
        return {n: dt for n, dt in self._lf.schema.items() if n not in keys}

    def _each(self, agg) -> LazyFrame:
        return self.agg([agg(_col(n)).alias(n) for n in self._non_keys()])

    def _arith(self, agg) -> LazyFrame:
        """`agg` of every non-key column; a String, Categorical, Binary or
        nested column, which has no arithmetic, gives nulls of its dtype,
        as polars does."""
        from ..expr.expr import lit
        cols = self._non_keys()
        out = self.agg([
            (lit(None, dtype=dt).first() if dt.is_string
             else agg(_col(n))).alias(n)
            for n, dt in cols.items() if not dt.is_nested])
        nested = {n: dt for n, dt in cols.items() if dt.is_nested}
        if not nested:
            return out
        # a nested dtype has no null literal: its nulls join the result
        order = [meta.output_name(k) for k in self._keys] + list(cols)

        def add_nulls(df):
            from .frame import DataFrame
            from .series import Series
            return df.hstack(DataFrame([
                Series(n, [None] * df.height, dtype=dt, device=df.device)
                for n, dt in nested.items()])).select(order)
        schema = {**out.schema, **nested}
        return out.map_batches(add_nulls, schema={n: schema[n]
                                                  for n in order})


class _LazyDynamic:
    def __init__(self, lf, index_column, every, period, offset, closed,
                 group_by, start_by):
        self._lf = lf
        self._args = (index_column, every, period, offset, closed)
        self._group_by = group_by
        self._start_by = start_by

    def _keys(self) -> List[Expr]:
        gb = self._group_by
        return _to_exprs((gb,)) if gb is not None else []

    def agg(self, *aggs, **named) -> LazyFrame:
        from ..expr import meta
        index_column, every, period, offset, closed = self._args
        plan = self._lf._plan
        if (period is None or period == every) and closed == "left":
            from ..ops.temporal_window import bucket_expr
            ins = plan.schema()
            b = bucket_expr(index_column, ins[index_column], every,
                            offset).alias(index_column)
            gkeys = self._keys() + [b]
            es = meta.expand_exprs(_to_exprs(aggs, named), ins)
            gb = L.GroupBy(plan, gkeys, list(es), False)
            names = [meta.output_name(k) for k in gkeys]
            return LazyFrame._from_plan(L.Sort(
                gb, [_col(n) for n in names], [False] * len(names),
                [False] * len(names), False, None))
        keys = self._keys()

        def fn(t):
            from ..ops.temporal_window import dynamic_group_by
            es = meta.expand_exprs(_to_exprs(aggs, named), dict(t.schema))
            return dynamic_group_by(t, index_column, every, period, offset,
                                    closed, keys, es, self._start_by)

        def schema_fn(ins):
            out = {meta.output_name(k): meta.output_dtype(k, ins)
                   for k in keys}
            out[index_column] = ins[index_column]
            for a in meta.expand_exprs(_to_exprs(aggs, named), ins):
                out[meta.output_name(a)] = meta.output_dtype(a, ins)
            return out
        return LazyFrame._from_plan(L.MapFunction(plan, fn, schema_fn, False,
                                                  "group_by_dynamic"))


class _LazyRolling:
    def __init__(self, lf, index_column, period, group_by, closed):
        self._lf = lf
        self._args = (index_column, period, group_by, closed)

    def agg(self, *aggs, **named) -> LazyFrame:
        from ..expr import meta
        index_column, period, group_by, closed = self._args
        keys = _to_exprs((group_by,)) if group_by is not None else []

        def fn(t):
            from ..ops.temporal_window import rolling_agg
            es = meta.expand_exprs(_to_exprs(aggs, named), dict(t.schema))
            return rolling_agg(t, index_column, period, keys, es, closed)

        def schema_fn(ins):
            out = {meta.output_name(k): meta.output_dtype(k, ins)
                   for k in keys}
            out[index_column] = ins[index_column]
            for a in meta.expand_exprs(_to_exprs(aggs, named), ins):
                out[meta.output_name(a)] = meta.output_dtype(a, ins)
            return out
        return LazyFrame._from_plan(L.MapFunction(
            self._lf._plan, fn, schema_fn, False, "rolling"))
