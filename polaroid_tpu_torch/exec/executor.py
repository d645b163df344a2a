"""In-memory plan executor.

The port of the JAX package's `exec/executor.py`: a post-order walk over
the optimized logical plan, each node dispatching to the torch ops and
kernels in `ops/`. A chain of two or more filter/select/with_columns
nodes, or one that ends in a group-by or an unsliced sort, runs as one
fused chain (`exec/compiled.py`: on the card a CUDA graph, captured
once and replayed). `execute_eager` runs the same plan with every chain
applied node by node. Per-node wall times are recorded when
`track_metrics` is set (the `.profile()` hook), each fenced on the card
by `torch.cuda.synchronize()`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from ..batch import Table
from ..config import CONFIG
from ..expr.eval import eval_expr
from ..ops import compact as C
from ..ops import sort as S
from ..ops.concat import vstack_tables
from ..ops.groupby import unique_table
from ..ops.join import join_tables
from ..plan import logical as L
from .compiled import (BREAKERS, FUSABLE, apply_chain, collect_fusable_chain,
                       run_fused)


class ExecState:
    def __init__(self, track_metrics: bool = False, fuse: bool = True):
        self.track_metrics = track_metrics or CONFIG.track_metrics
        # (repr of the node, seconds) of every node run, in order
        self.timings: List[tuple] = []
        # Cache-node results, one entry per cache_id per query run
        self.subplan_cache: Dict[int, Table] = {}
        # False: chains run node by node (`execute_eager`)
        self.fuse = fuse


def execute(plan: L.Plan, state: Optional[ExecState] = None) -> Table:
    state = state or ExecState()
    t0 = time.perf_counter() if state.track_metrics else 0.0
    out = _exec(plan, state)
    if state.track_metrics:
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        state.timings.append((repr(plan), time.perf_counter() - t0))
    return out


def execute_eager(plan: L.Plan, state: Optional[ExecState] = None) -> Table:
    """The plan's result with every fusable chain applied node by node:
    what `execute` computes, without the fused route."""
    state = state or ExecState()
    state.fuse = False
    return execute(plan, state)


def _exec(plan: L.Plan, state: ExecState) -> Table:
    k = plan.kind
    if k in FUSABLE or k in BREAKERS:
        chain, inp = collect_fusable_chain(plan)
        if chain and (len(chain) >= 2 or chain[-1].kind in BREAKERS):
            t = execute(inp, state)
            return run_fused(chain, t) if state.fuse else \
                apply_chain(chain, t)
    if k == "df_scan":
        return plan.table
    if k == "cache":
        hit = state.subplan_cache.get(plan.cache_id)
        if hit is None:
            hit = execute(plan.input, state)
            state.subplan_cache[plan.cache_id] = hit
        return hit
    if k == "join":
        return join_tables(execute(plan.left, state),
                           execute(plan.right, state), plan.left_on,
                           plan.right_on, plan.how, plan.suffix,
                           plan.join_nulls, plan.coalesce,
                           plan.maintain_order, plan.validate)
    if k == "iejoin":
        from ..ops.iejoin import iejoin_tables
        return iejoin_tables(execute(plan.left, state),
                             execute(plan.right, state), plan.preds,
                             plan.post, plan.suffix)
    if k == "union":
        how = "vertical" if plan.how.startswith("vertical") else "diagonal"
        return vstack_tables([execute(p, state) for p in plan.inputs], how)
    if k == "hconcat":
        from ..api.frame import DataFrame
        tables = [execute(p, state) for p in plan.inputs]
        df = DataFrame._from_table(tables[0])
        for t in tables[1:]:
            df = df.hstack(DataFrame._from_table(t))
        return df._table
    if k in FUSABLE:
        # a single elementwise node
        return apply_chain([plan], execute(plan.input, state))
    if k == "sort":
        t = execute(plan.input, state)
        vals = [eval_expr(b, t, "select") for b in plan.by]
        if plan.slice_ is not None and plan.slice_[0] == 0:
            return S.top_k_table(t, vals, plan.slice_[1], plan.descending,
                                 plan.nulls_last)
        return S.sort_table(t, vals, plan.descending, plan.nulls_last,
                            plan.maintain_order)
    if k == "slice":
        return C.slice_rows(execute(plan.input, state), plan.offset,
                            plan.length)
    if k == "distinct":
        return unique_table(execute(plan.input, state), plan.subset,
                            plan.keep, plan.maintain_order)
    if k == "explode":
        from ..ops.nested import explode_table
        return explode_table(execute(plan.input, state), plan.columns)
    if k == "map_function":
        # an opaque Table -> Table function (the lazy rolling, the
        # overlapping group_by_dynamic and map_batches build one)
        return plan.fn(execute(plan.input, state))
    if k == "rename":
        return execute(plan.input, state).rename(plan.mapping, strict=False)
    if k == "drop":
        t = execute(plan.input, state)
        return t.drop_columns([n for n in plan.names if n in t.cols])
    if k == "with_row_index":
        from ..api.frame import DataFrame
        return DataFrame._from_table(execute(plan.input, state)) \
            .with_row_index(plan.name, plan.offset)._table
    if k == "unpivot":
        return _unpivot(execute(plan.input, state), plan)
    if k == "scan":
        return _exec_scan(plan)
    if k == "fast_count":
        from ..api.frame import DataFrame
        from ..dtypes import UInt32
        from ..io.parquet import parquet_num_rows
        n = parquet_num_rows(plan.source)
        if plan.n_rows is not None:
            n = min(n, plan.n_rows)
        return DataFrame({plan.name: [n]}, schema={plan.name: UInt32},
                         device=plan.device)._table
    if k == "sink":
        t = execute(plan.input, state)
        run_sink(t, plan)
        return t
    raise NotImplementedError(f"plan node {k!r} has no executor")


def _exec_scan(plan: L.Scan) -> Table:
    """A file scan: a predicate pushed into it becomes a pyarrow filter
    in the Parquet decoder where it converts (`scan_predicate.py`); what
    stays (every predicate, for the other formats) filters on the
    device after the read."""
    from ..batch import resolve_device
    device = resolve_device(plan.device)
    residual = plan.predicate
    n_rows = plan.n_rows if residual is None else None
    if plan.fmt == "parquet":
        from ..io.parquet import read_parquet_table
        from .scan_predicate import to_arrow_filter
        filters = None
        if plan.predicate is not None:
            filters, residual = to_arrow_filter(plan.predicate)
        t = read_parquet_table(plan.source, columns=plan.columns,
                               filters=filters,
                               n_rows=plan.n_rows if residual is None
                               else None, device=device)
    elif plan.fmt == "csv":
        from ..io.csv import read_csv_table
        t = read_csv_table(plan.source, columns=plan.columns, n_rows=n_rows,
                           device=device,
                           **{kk: v for kk, v in plan.options.items()
                              if kk in ("has_header", "separator",
                                        "null_values")})
    elif plan.fmt == "ipc":
        from ..io.ipc import read_ipc_table
        t = read_ipc_table(plan.source, columns=plan.columns, n_rows=n_rows,
                           device=device)
    elif plan.fmt == "ndjson":
        from ..io.json_io import read_ndjson_table
        t = read_ndjson_table(plan.source, n_rows=n_rows, device=device)
        if plan.columns is not None:
            t = t.select_columns([c for c in plan.columns if c in t.cols])
    else:
        from ..errors import ComputeError
        raise ComputeError(f"unknown scan format {plan.fmt!r}")
    if residual is not None:
        from ..api.frame import DataFrame
        t = DataFrame._from_table(t).filter(residual)._table
        if plan.n_rows is not None:
            t = C.slice_rows(t, 0, plan.n_rows)
    return t


def run_sink(t: Table, plan: L.Sink) -> None:
    """A sink's whole input written at once (the in-memory engine)."""
    from ..api.frame import DataFrame
    df = DataFrame._from_table(t)
    write = {"parquet": df.write_parquet, "csv": df.write_csv,
             "ipc": df.write_ipc, "ndjson": df.write_ndjson}.get(plan.fmt)
    if write is None:
        from ..errors import ComputeError
        raise ComputeError(f"unknown sink format {plan.fmt!r}")
    write(plan.target, **plan.options)


def _unpivot(t: Table, plan: L.Unpivot) -> Table:
    """The `on` columns stacked under the index columns: one select per
    column (the column's name as a literal), stacked by one vstack."""
    from ..api.frame import DataFrame
    from ..expr.expr import col, lit
    df = DataFrame._from_table(t)
    parts = [df.select([col(i) for i in plan.index] + [
        lit(n).alias(plan.variable_name), col(n).alias(plan.value_name)]
    )._table for n in plan.on]
    return vstack_tables(parts, "vertical")
