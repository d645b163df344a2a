"""In-memory plan executor, run eagerly.

The port of the JAX package's `exec/executor.py`: a post-order walk over
the optimized logical plan, each node dispatching to the torch ops and
kernels in `ops/`. The JAX package traces chains of elementwise nodes
(plus a group-by on top) into one jitted program (`exec/compiled.py`);
PyTorch runs eagerly, so the port applies the nodes one by one. What
comes across from that file is its host pre-pass, `_ensure_groupby_stats`:
it gives a bare integer group key the bucketed min/max that puts it on
the dense or hash tier of the group-by. A computed or redefined key has
no stats and takes the sorted tier, as the JAX package's does.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..batch import Table
from ..expr import meta
from ..expr.eval import eval_expr
from ..ops import compact as C
from ..ops import sort as S
from ..ops.concat import vstack_tables
from ..ops.groupby import group_by_agg, unique_table
from ..ops.join import join_tables, minmax_masked
from ..plan import logical as L

# nodes applied on top of their input table, as one chain under a group-by
_CHAIN = ("filter", "select", "with_columns")


def execute(plan: L.Plan, cache: Optional[Dict[int, Table]] = None
            ) -> Table:
    """The plan's result table. `cache` holds the results of the shared
    subplans (`cache` nodes, which the optimizer puts where one subplan
    occurs twice, as in a self-join) for one run."""
    if cache is None:
        cache = {}
    k = plan.kind
    if k == "df_scan":
        return plan.table
    if k == "cache":
        if plan.cache_id not in cache:
            cache[plan.cache_id] = execute(plan.input, cache)
        return cache[plan.cache_id]
    if k == "join":
        return join_tables(execute(plan.left, cache),
                           execute(plan.right, cache), plan.left_on,
                           plan.right_on, plan.how, plan.suffix,
                           plan.join_nulls, plan.coalesce,
                           plan.maintain_order, plan.validate)
    if k == "iejoin":
        from ..ops.iejoin import iejoin_tables
        return iejoin_tables(execute(plan.left, cache),
                             execute(plan.right, cache), plan.preds,
                             plan.post, plan.suffix)
    if k == "union":
        how = "vertical" if plan.how.startswith("vertical") else "diagonal"
        return vstack_tables([execute(p, cache) for p in plan.inputs], how)
    if k == "hconcat":
        from ..api.frame import DataFrame
        tables = [execute(p, cache) for p in plan.inputs]
        df = DataFrame._from_table(tables[0])
        for t in tables[1:]:
            df = df.hstack(DataFrame._from_table(t))
        return df._table
    if k == "group_by":
        # the chain of elementwise nodes below the group-by runs on top
        # of its input, after the stats pre-pass has seen that input
        chain: List[L.Plan] = [plan]
        inp = plan.input
        while inp.kind in _CHAIN:
            chain.append(inp)
            inp = inp.input
        chain.reverse()
        t = execute(inp, cache)
        _ensure_groupby_stats(chain, t)
        for node in chain:
            t = _apply_node(node, t)
        return t
    if k in _CHAIN:
        return _apply_node(plan, execute(plan.input, cache))
    if k == "sort":
        t = execute(plan.input, cache)
        vals = [eval_expr(b, t, "select") for b in plan.by]
        if plan.slice_ is not None and plan.slice_[0] == 0:
            return S.top_k_table(t, vals, plan.slice_[1], plan.descending,
                                 plan.nulls_last)
        return S.sort_table(t, vals, plan.descending, plan.nulls_last,
                            plan.maintain_order)
    if k == "slice":
        return C.slice_rows(execute(plan.input, cache), plan.offset,
                            plan.length)
    if k == "distinct":
        return unique_table(execute(plan.input, cache), plan.subset,
                            plan.keep, plan.maintain_order)
    if k == "explode":
        from ..ops.nested import explode_table
        return explode_table(execute(plan.input, cache), plan.columns)
    if k == "map_function":
        # an opaque Table -> Table function (the lazy rolling, the
        # overlapping group_by_dynamic and map_batches build one)
        return plan.fn(execute(plan.input, cache))
    if k == "rename":
        return execute(plan.input, cache).rename(plan.mapping, strict=False)
    if k == "drop":
        t = execute(plan.input, cache)
        return t.drop_columns([n for n in plan.names if n in t.cols])
    if k == "with_row_index":
        from ..api.frame import DataFrame
        return DataFrame._from_table(execute(plan.input, cache)) \
            .with_row_index(plan.name, plan.offset)._table
    if k == "unpivot":
        return _unpivot(execute(plan.input, cache), plan)
    raise NotImplementedError(
        f"plan node {k!r} is not ported yet: file scans and sinks come "
        "with Slice H (host IO)")


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


def _apply_node(node: L.Plan, table: Table) -> Table:
    from ..api.frame import DataFrame
    k = node.kind
    if k == "filter":
        return DataFrame._from_table(table).filter(node.predicate)._table
    if k == "select":
        return DataFrame._from_table(table).select(node.exprs)._table
    if k == "with_columns":
        return DataFrame._from_table(table).with_columns(node.exprs)._table
    ins = dict(table.schema)
    return group_by_agg(table, meta.expand_exprs(node.keys, ins),
                        meta.expand_exprs(node.aggs, ins),
                        node.maintain_order)


def _ensure_groupby_stats(nodes: List[L.Plan], table: Table) -> None:
    """Host pre-pass: cache bucketed min/max on integer key columns so the
    group-by can take the dense O(n) path. One device sync per column,
    amortized across calls (stats live on the Column object).

    Tables that share a Column may have different live rows (a filter or
    head() keeps the Column objects), so the stats remember the live rows
    they were taken over and are taken again for others. The JAX package
    reuses them for any table, and then groups keys outside the cached
    range into the edge slot (ROADMAP Queue 3)."""
    live = table.live_key()
    redefined = set()
    for node in nodes:
        if node.kind in ("select", "with_columns"):
            for e in node.exprs:
                # a bare col passes through unchanged — stats stay valid
                if e.kind != "col":
                    redefined.add(meta.output_name(e))
        if node.kind != "group_by":
            continue
        for ke in node.keys:
            e = ke
            while e.kind == "alias":
                e = e.children[0]
            if e.kind != "col":
                continue
            name = e.attrs["name"]
            if name in redefined or name not in table.cols:
                continue
            c = table.cols[name]
            if not c.dtype.is_integer:
                continue
            over = c.stats["over"] if c.stats is not None else None
            if over is live or (type(over) is int and type(live) is int
                                 and over == live):
                continue
            mask = table.row_mask()
            if c.validity is not None:
                mask = mask & c.validity
            mn, mx = minmax_masked(c.data, mask)
            # bucket bounds so stats stay stable across similar batches
            B = 16
            c.stats = {"min": (mn // B) * B, "max": ((mx // B) + 1) * B - 1,
                       "over": live}
