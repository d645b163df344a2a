"""Logical plan serialization.

The port of the JAX package's `plan/serde.py` (the reference's
`prepare_cloud_plan`, `polars-plan/src/client/mod.rs:8`): versioned,
JSON-able plan dicts in the JAX package's format (`PLAN_FORMAT_VERSION`
1), so either package loads the other's plans. An in-memory frame's
payload is Arrow IPC in base64 (pyarrow, imported there, on the host);
a file scan carries its path and pushdown state.
"""

from __future__ import annotations

import base64
import io
from typing import Any, Dict

from ..errors import ComputeError
from ..expr.serde import expr_from_dict, expr_to_dict
from . import logical as L

PLAN_FORMAT_VERSION = 1


def plan_to_dict(p: L.Plan) -> Dict[str, Any]:
    k = p.kind
    out: Dict[str, Any] = {"kind": k, "v": PLAN_FORMAT_VERSION}
    if k == "df_scan":
        import pyarrow as pa
        from ..io.arrow_interop import table_to_arrow
        at = table_to_arrow(p.table)
        sink = io.BytesIO()
        with pa.ipc.new_stream(sink, at.schema) as w:
            for b in at.to_batches():
                w.write_batch(b)
        out["ipc"] = base64.b64encode(sink.getvalue()).decode()
        return out
    if k == "scan":
        out.update({"fmt": p.fmt, "source": p.source, "columns": p.columns,
                    "n_rows": p.n_rows, "options": p.options,
                    "predicate": expr_to_dict(p.predicate)
                    if p.predicate is not None else None})
        return out
    if k in ("select", "with_columns"):
        out["exprs"] = [expr_to_dict(e) for e in p.exprs]
    elif k == "filter":
        out["predicate"] = expr_to_dict(p.predicate)
    elif k == "group_by":
        out["keys"] = [expr_to_dict(e) for e in p.keys]
        out["aggs"] = [expr_to_dict(e) for e in p.aggs]
        out["maintain_order"] = p.maintain_order
    elif k == "sort":
        out["by"] = [expr_to_dict(e) for e in p.by]
        out["descending"] = list(p.descending)
        out["nulls_last"] = list(p.nulls_last)
        out["slice"] = p.slice_
    elif k == "slice":
        out["offset"] = p.offset
        out["length"] = p.length
    elif k == "distinct":
        out["subset"] = p.subset
        out["keep"] = p.keep
        out["maintain_order"] = p.maintain_order
    elif k == "join":
        out["left_on"] = p.left_on
        out["right_on"] = p.right_on
        out["how"] = p.how
        out["suffix"] = p.suffix
        out["join_nulls"] = p.join_nulls
        out["coalesce"] = p.coalesce
    elif k == "iejoin":
        out["preds"] = [[expr_to_dict(a), op, expr_to_dict(b)]
                        for (a, op, b) in p.preds]
        out["post"] = [expr_to_dict(e) for e in p.post]
        out["suffix"] = p.suffix
    elif k == "union":
        out["how"] = p.how
    elif k == "rename":
        out["mapping"] = p.mapping
    elif k == "drop":
        out["names"] = p.names
    elif k == "with_row_index":
        out["name"] = p.name
        out["offset"] = p.offset
    elif k == "sink":
        out["fmt"] = p.fmt
        out["target"] = str(p.target)
        out["options"] = p.options
    elif k in ("hconcat",):
        pass
    elif k == "unpivot":
        out.update({"on": p.on, "index": p.index,
                    "variable_name": p.variable_name,
                    "value_name": p.value_name})
    else:
        raise ComputeError(f"cannot serialize plan node {k!r} "
                           "(map_function carries Python callables)")
    out["inputs"] = [plan_to_dict(i) for i in p.inputs]
    return out


def plan_from_dict(d: Dict[str, Any], device=None) -> L.Plan:
    """The plan of a dict; an in-memory frame's rows go to `device`
    (default `Config.device`)."""
    k = d["kind"]
    if k == "df_scan":
        import pyarrow as pa
        from ..io.arrow_interop import table_from_arrow
        buf = io.BytesIO(base64.b64decode(d["ipc"]))
        with pa.ipc.open_stream(buf) as r:
            at = r.read_all()
        return L.DataFrameScan(table_from_arrow(at, device=device))
    if k == "scan":
        return L.Scan(d["fmt"], d["source"], d.get("columns"),
                      expr_from_dict(d["predicate"])
                      if d.get("predicate") else None,
                      d.get("n_rows"), d.get("options") or {},
                      device=device)
    ins = [plan_from_dict(i, device) for i in d.get("inputs", [])]
    if k == "select":
        return L.Select(ins[0], [expr_from_dict(e) for e in d["exprs"]])
    if k == "with_columns":
        return L.WithColumns(ins[0], [expr_from_dict(e) for e in d["exprs"]])
    if k == "filter":
        return L.Filter(ins[0], expr_from_dict(d["predicate"]))
    if k == "group_by":
        return L.GroupBy(ins[0], [expr_from_dict(e) for e in d["keys"]],
                         [expr_from_dict(e) for e in d["aggs"]],
                         d.get("maintain_order", False))
    if k == "sort":
        return L.Sort(ins[0], [expr_from_dict(e) for e in d["by"]],
                      d["descending"], d["nulls_last"], True,
                      tuple(d["slice"]) if d.get("slice") else None)
    if k == "slice":
        return L.Slice(ins[0], d["offset"], d.get("length"))
    if k == "distinct":
        return L.Distinct(ins[0], d.get("subset"), d.get("keep", "any"),
                          d.get("maintain_order", False))
    if k == "join":
        return L.Join(ins[0], ins[1], d["left_on"], d["right_on"], d["how"],
                      d.get("suffix", "_right"), d.get("join_nulls", False),
                      d.get("coalesce"))
    if k == "iejoin":
        preds = [(expr_from_dict(a), op, expr_from_dict(b))
                 for (a, op, b) in d["preds"]]
        post = [expr_from_dict(e) for e in d.get("post", [])]
        return L.IEJoin(ins[0], ins[1], preds, post,
                        d.get("suffix", "_right"))
    if k == "union":
        return L.Union(ins, d.get("how", "vertical"))
    if k == "rename":
        return L.Rename(ins[0], d["mapping"])
    if k == "drop":
        return L.Drop(ins[0], d["names"], strict=False)
    if k == "with_row_index":
        return L.WithRowIndex(ins[0], d["name"], d.get("offset", 0))
    if k == "sink":
        return L.Sink(ins[0], d["fmt"], d["target"], d.get("options") or {})
    if k == "hconcat":
        return L.HConcat(ins)
    if k == "unpivot":
        return L.Unpivot(ins[0], d["on"], d["index"], d["variable_name"],
                         d["value_name"])
    raise ComputeError(f"unknown plan kind {k!r}")
