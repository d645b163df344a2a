"""In-memory plan executor, run eagerly.

The port of the JAX package's `exec/executor.py`: a post-order walk over
the optimized logical plan, each node dispatching to the torch ops and
kernels in `ops/`. The JAX package traces chains of elementwise nodes
(plus a group-by on top) into one jitted program (`exec/compiled.py`);
PyTorch runs eagerly, so the port applies the nodes one by one. What
comes across from that file is its host pre-pass, `_ensure_groupby_stats`:
it gives an integer group key the bucketed min/max that puts it on the
dense group-by path.
"""

from __future__ import annotations

from typing import List

import torch

from ..batch import Table
from ..expr import meta
from ..ops import compact as C
from ..ops.groupby import group_by_agg
from ..plan import logical as L

# nodes applied on top of their input table, as one chain under a group-by
_CHAIN = ("filter", "select", "with_columns")


def execute(plan: L.Plan) -> Table:
    k = plan.kind
    if k == "df_scan":
        return plan.table
    if k == "group_by":
        # the chain of elementwise nodes below the group-by runs on top
        # of its input, after the stats pre-pass has seen that input
        chain: List[L.Plan] = [plan]
        inp = plan.input
        while inp.kind in _CHAIN:
            chain.append(inp)
            inp = inp.input
        chain.reverse()
        t = execute(inp)
        _ensure_groupby_stats(chain, t)
        for node in chain:
            t = _apply_node(node, t)
        return t
    if k in _CHAIN:
        return _apply_node(plan, execute(plan.input))
    if k == "slice":
        return C.slice_rows(execute(plan.input), plan.offset,
                            plan.length)
    raise NotImplementedError(
        f"plan node {k!r} is not ported yet (later slices of the port)")


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


def _live_key(table: Table):
    """What identifies the live rows of `table`: its mask tensor, its
    host row count or its device row count."""
    if table.valid is not None:
        return table.valid
    return table._nrows if table._nrows is not None else table.nrows_dev


def _ensure_groupby_stats(nodes: List[L.Plan], table: Table) -> None:
    """Host pre-pass: cache bucketed min/max on integer key columns so the
    group-by can take the dense O(n) path. One device sync per column,
    amortized across calls (stats live on the Column object).

    Tables that share a Column may have different live rows (a filter or
    head() keeps the Column objects), so the stats remember the live rows
    they were taken over and are taken again for others. The JAX package
    reuses them for any table, and then groups keys outside the cached
    range into the edge slot (ROADMAP Queue 3)."""
    live = _live_key(table)
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
            x = c.data.to(torch.int64)
            big = torch.iinfo(torch.int64)
            # (min, max) in ONE readback
            packed = torch.stack([
                torch.where(mask, x, torch.full_like(x, big.max)).min(),
                torch.where(mask, x, torch.full_like(x, big.min)).max()])
            mn, mx = (int(v) for v in packed.tolist())
            if mx < mn:
                mn, mx = 0, 0
            # bucket bounds so stats stay stable across similar batches
            B = 16
            c.stats = {"min": (mn // B) * B, "max": ((mx // B) + 1) * B - 1,
                       "over": live}
