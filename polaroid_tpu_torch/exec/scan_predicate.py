"""Expr -> pyarrow dataset filter (scan predicate pushdown).

The port of the JAX package's `exec/scan_predicate.py` (the reference's
`polars-mem-engine/src/scan_predicate/`): the conjuncts of a predicate
pushed into a scan that convert to pyarrow compute expressions filter
rows in the decoder, with row-group statistics skipping; the rest stay
a residual that the device evaluates after the scan.

`to_arrow_filter` returns (arrow filter | None, residual Expr | None).
"""

from __future__ import annotations

import datetime as _pydt
from typing import List, Optional, Tuple

from ..expr.expr import Expr

_CMP = {"eq": "__eq__", "neq": "__ne__", "lt": "__lt__", "le": "__le__",
        "gt": "__gt__", "ge": "__ge__"}


def _conv(e: Expr):
    """Convert a single expr to a pyarrow expression, or raise ValueError."""
    import pyarrow.compute as pc
    k = e.kind
    if k == "col":
        return pc.field(e.attrs["name"])
    if k == "lit":
        v = e.attrs["value"]
        if v is None or isinstance(v, (bool, int, float, str, _pydt.date,
                                       _pydt.datetime)):
            return pc.scalar(v)
        raise ValueError("non-scalar literal")
    if k == "binary":
        op = e.attrs["op"]
        l = _conv(e.children[0])
        r = _conv(e.children[1])
        if op in _CMP:
            return getattr(l, _CMP[op])(r)
        if op == "and":
            return l & r
        if op == "or":
            return l | r
        raise ValueError(f"op {op}")
    if k == "unary" and e.attrs.get("op") == "not":
        return ~_conv(e.children[0])
    if k == "is_null":
        return _conv(e.children[0]).is_null()
    if k == "is_not_null":
        return ~(_conv(e.children[0]).is_null())
    if k == "is_in":
        return _conv(e.children[0]).isin(list(e.attrs["values"]))
    if k == "is_between":
        lo = _conv(e.children[1])
        hi = _conv(e.children[2])
        x = _conv(e.children[0])
        closed = e.attrs.get("closed", "both")
        left = (x >= lo) if closed in ("both", "left") else (x > lo)
        right = (x <= hi) if closed in ("both", "right") else (x < hi)
        return left & right
    if k == "alias":
        return _conv(e.children[0])
    raise ValueError(f"kind {k}")


def _split_conjuncts(e: Expr) -> List[Expr]:
    if e.kind == "binary" and e.attrs.get("op") == "and":
        return _split_conjuncts(e.children[0]) + _split_conjuncts(e.children[1])
    return [e]


def to_arrow_filter(pred: Expr) -> Tuple[Optional[object], Optional[Expr]]:
    import pyarrow.compute  # noqa: F401  (without pyarrow this raises)
    conjs = _split_conjuncts(pred)
    converted = []
    residual: List[Expr] = []
    for c in conjs:
        try:
            converted.append(_conv(c))
        except Exception:  # what pyarrow cannot express stays a residual
            residual.append(c)
    flt = None
    for c in converted:
        flt = c if flt is None else (flt & c)
    res = None
    for c in residual:
        res = c if res is None else Expr("binary", (res, c), op="and")
    return flt, res
