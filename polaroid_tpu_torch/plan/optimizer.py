"""Plan optimizer: projection / predicate / slice pushdown.

Capability analogue of the reference optimizer
(`polars-plan/src/plans/optimizer/mod.rs:100` — projection pushdown,
predicate pushdown, slice pushdown, simplify; CSE later). Pushdowns matter
even more on TPU: pruning columns/rows at the pyarrow scan keeps host->HBM
transfer minimal, and sort+slice fuses into top-k.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from ..expr import meta
from ..expr.expr import Expr
from . import logical as L


def optimize(plan: L.Plan, engine: str = "in-memory") -> L.Plan:
    plan = simplify_plan_exprs(plan)
    plan = cluster_with_columns(plan)
    plan = push_predicates(plan)
    plan = push_slice(plan)
    plan = count_star_fast_path(plan)
    plan = push_projection(plan, None)
    plan = fuse_arithmetic(plan)
    if engine in ("in-memory", "auto"):
        # sortedness is an in-memory-engine property: its sort-based
        # group-by emits key order; hash-sharded engines do not
        plan = elide_redundant_sorts(plan)
    plan = insert_common_subplan_caches(plan)
    return plan


# ---------------------------------------------------------------------------
# sortedness propagation (reference: `polars-plan/src/plans/optimizer/
# set_order/` + sortedness analysis): track "output rows are ordered by
# K" through the plan and remove Sort nodes that re-establish an order
# the input already has. Doubly important in this engine: the in-memory
# group-by IS a sort, so group_by(k).agg(...).sort(k) carries its order
# for free (asc, nulls first, NaN last — verified identical to
# sort_table's encoding).
# ---------------------------------------------------------------------------

def _bare_col(e: Expr) -> Optional[str]:
    while e.kind == "alias":
        e = e.children[0]
    return e.attrs["name"] if e.kind == "col" else None


def output_sortedness(plan: L.Plan) -> List:
    """Longest known [(name, descending, nulls_last)] prefix the plan's
    output rows are ordered by (empty = unknown)."""
    k = plan.kind
    if k == "sort":
        out = []
        for e, d, nl in zip(plan.by, plan.descending, plan.nulls_last):
            n = _bare_col(e)
            if n is None:
                break
            out.append((n, bool(d), bool(nl)))
        return out
    if k == "group_by" and not plan.maintain_order:
        # every key by its output name: once the elision pins the group-by
        # to key order, a computed or aliased key comes out ordered as a
        # bare one does (the JAX package stops at the first aliased key,
        # so a sort after group_by_dynamic's truncated index stays there)
        return [(meta.output_name(e), False, False) for e in plan.keys]
    if k in ("filter", "slice", "cache", "with_row_index", "fast_count"):
        return output_sortedness(plan.input) if plan.inputs else []
    if k == "distinct":
        # representative masks preserve input row order
        return output_sortedness(plan.input)
    if k in ("select", "with_columns"):
        s = output_sortedness(plan.input)
        if not s:
            return []
        # a sorted column survives if no expression redefines it; for
        # select it must also still be present (as a bare passthrough)
        redefined, passed = set(), set()
        try:
            ins = plan.input.schema()
            exprs = meta.expand_exprs(plan.exprs, ins)
        except Exception:
            return []
        for e in exprs:
            n = meta.output_name(e)
            inner = e
            while inner.kind == "alias":
                inner = inner.children[0]
            if inner.kind == "col" and inner.attrs["name"] == n:
                passed.add(n)
            else:
                redefined.add(n)
        out = []
        for (n, d, nl) in s:
            if n in redefined or (k == "select" and n not in passed):
                break
            out.append((n, d, nl))
        return out
    if k == "rename":
        s = output_sortedness(plan.input)
        return [(plan.mapping.get(n, n), d, nl) for (n, d, nl) in s]
    if k == "drop":
        s = output_sortedness(plan.input)
        out = []
        dropped = set(plan.names)
        for (n, d, nl) in s:
            if n in dropped:
                break
            out.append((n, d, nl))
        return out
    if k == "join" and plan.how in ("semi", "anti", "cross"):
        # semi/anti are row masks on the left table; cross enumerates
        # left-major — all preserve the left side's order
        return output_sortedness(plan.left)
    return []


def _pin_groupby_key_order(plan: L.Plan) -> Optional[L.Plan]:
    """Walk to the sortedness ORIGIN of `plan` and, if it is a
    group_by, return a copy with maintain_order="key" — the executor
    contract that closes the hash-exchange path (which emits hash
    order) so the elided sort stays sound under the runtime-adaptive
    group-by dispatch. Returns the (possibly rebuilt) plan, or None
    when the elision should NOT happen: unknown origin, or a group-by
    whose aggregates want the hash path badly enough (median/quantile
    have no dense formulation) that hash + a real sort beats the
    sorted-layout path + elision."""
    k = plan.kind
    if k == "sort":
        return plan
    if k == "group_by" and not plan.maintain_order:
        from ..ops.groupby import _aggs_have_quantile
        if _aggs_have_quantile(plan.aggs):
            return None
        return L.GroupBy(plan.input, plan.keys, plan.aggs, "key")
    if k in ("filter", "slice", "cache", "with_row_index", "fast_count",
             "distinct", "select", "with_columns", "rename", "drop"):
        if not plan.inputs:
            return None
        sub = _pin_groupby_key_order(plan.inputs[0])
        if sub is None:
            return None
        return plan.with_inputs([sub] + list(plan.inputs[1:]))
    if k == "join" and plan.how in ("semi", "anti", "cross"):
        sub = _pin_groupby_key_order(plan.left)
        if sub is None:
            return None
        return plan.with_inputs([sub] + list(plan.inputs[1:]))
    return None


def elide_redundant_sorts(plan: L.Plan) -> L.Plan:
    new_inputs = [elide_redundant_sorts(p) for p in plan.inputs]
    if plan.inputs:
        plan = plan.with_inputs(new_inputs)
    if plan.kind == "sort" and plan.slice_ is None:
        want = []
        for e, d, nl in zip(plan.by, plan.descending, plan.nulls_last):
            n = _bare_col(e)
            if n is None:
                return plan
            want.append((n, bool(d), bool(nl)))
        have = output_sortedness(plan.input)
        if want and len(want) <= len(have) and have[:len(want)] == want:
            try:
                ins = plan.input.schema()
            except Exception:
                return plan
            if any(ins.get(n) is None or ins[n].is_nested
                   for (n, _, _) in want):
                return plan
            # already ordered: a stable sort would be the identity —
            # but a group-by origin must be PINNED to key order first
            # (the hash-exchange group-by emits hash order; the pin
            # closes that gate at execution)
            pinned = _pin_groupby_key_order(plan.input)
            if pinned is None:
                return plan
            return pinned
    return plan


def count_star_fast_path(plan: L.Plan) -> L.Plan:
    """select(len()) directly over an unfiltered parquet scan -> row count
    from file metadata, zero column reads (reference: count-star rewrite,
    `polars-plan/src/plans/optimizer/count_star.rs`). Runs after
    predicate/slice pushdown so a pushed filter (scan.predicate) or
    head() (scan.n_rows, still eligible: count = min) is visible here."""
    if plan.kind == "select" and plan.input.kind == "scan" and \
            len(plan.exprs) == 1:
        sc = plan.input
        e = plan.exprs[0]
        name = meta.output_name(e)
        if e.kind == "alias":
            e = e.children[0]
        if e.kind == "table_len" and sc.predicate is None and \
                sc.fmt == "parquet":
            return L.FastCount(sc.fmt, sc.source, sc.n_rows, name)
    new_inputs = [count_star_fast_path(p) for p in plan.inputs]
    return plan.with_inputs(new_inputs) if plan.inputs else plan


# ---------------------------------------------------------------------------
# expression simplification (reference: simplify_expr pass,
# `polars-plan/src/plans/optimizer/simplify_expr/`) — constant folding and
# boolean identities. Runs FIRST so pushdowns and the arrow-filter
# translation see canonical predicates.
# ---------------------------------------------------------------------------

import operator as _op  # noqa: E402

_FOLD = {
    "add": _op.add, "sub": _op.sub, "mul": _op.mul, "truediv": _op.truediv,
    "floordiv": _op.floordiv, "mod": _op.mod, "pow": _op.pow,
    "eq": _op.eq, "neq": _op.ne, "lt": _op.lt, "le": _op.le,
    "gt": _op.gt, "ge": _op.ge, "and": _op.and_, "or": _op.or_,
    "xor": _op.xor,
}


def _lit_bool(e: Expr):
    if e.kind == "lit" and isinstance(e.attrs.get("value"), bool):
        return e.attrs["value"]
    return None


def simplify_expr(e: Expr) -> Expr:
    if e.children:
        ch = tuple(simplify_expr(c) for c in e.children)
        if any(a is not b for a, b in zip(ch, e.children)):
            e = Expr(e.kind, ch, **e.attrs)
    if e.kind == "binary":
        op = e.attrs.get("op")
        a, b = e.children
        if op in ("and", "or"):
            for x, other in ((a, b), (b, a)):
                lb = _lit_bool(x)
                if lb is None:
                    continue
                if (op == "and" and lb is True) or \
                        (op == "or" and lb is False):
                    return other  # identity element
                # x & False / x | True: only foldable to a constant when
                # `other` can't be null (nulls: null & False == False in
                # polars Kleene logic, so the fold IS safe for `and`;
                # null | True == True, safe for `or`)
                return Expr("lit", value=lb, dtype=None)
        fn = _FOLD.get(op)
        if fn is not None and a.kind == "lit" and b.kind == "lit":
            va, vb = a.attrs.get("value"), b.attrs.get("value")
            if va is not None and vb is not None:
                try:
                    return Expr("lit", value=fn(va, vb), dtype=None)
                except Exception:
                    return e
        return e
    if e.kind == "unary":
        op = e.attrs.get("op")
        c = e.children[0]
        if op == "not":
            if c.kind == "unary" and c.attrs.get("op") == "not":
                return c.children[0]
            lb = _lit_bool(c)
            if lb is not None:
                return Expr("lit", value=not lb, dtype=None)
        if op == "neg" and c.kind == "lit" and \
                isinstance(c.attrs.get("value"), (int, float)) and \
                not isinstance(c.attrs.get("value"), bool):
            return Expr("lit", value=-c.attrs["value"],
                        dtype=c.attrs.get("dtype"))
        return e
    if e.kind == "alias" and e.children[0].kind == "alias":
        return Expr("alias", (e.children[0].children[0],),
                    name=e.attrs["name"])
    return e


# ---------------------------------------------------------------------------
# cluster_with_columns (reference: `polars-plan/src/plans/optimizer/
# cluster_with_columns.rs`): merge adjacent WITH_COLUMNS nodes whose
# upper expressions neither read nor rewrite the lower node's outputs.
# One plan node = one executor dispatch + one capacity pass, so merging
# directly cuts engine glue.
# ---------------------------------------------------------------------------

def cluster_with_columns(plan: L.Plan) -> L.Plan:
    new_inputs = [cluster_with_columns(p) for p in plan.inputs]
    if plan.inputs:
        plan = plan.with_inputs(new_inputs)
    while plan.kind == "with_columns" and plan.input.kind == "with_columns":
        lower = plan.input
        try:
            in_schema = lower.input.schema()
            lower_x = meta.expand_exprs(lower.exprs, in_schema)
            upper_x = meta.expand_exprs(plan.exprs, lower.schema())
            lower_outs = {meta.output_name(x) for x in lower_x}
            upper_outs = {meta.output_name(x) for x in upper_x}
            upper_refs: Set[str] = set()
            for x in upper_x:
                meta.root_names(x, upper_refs)
        except Exception:
            break  # unresolvable schema/name — leave as-is
        if (upper_refs & lower_outs) or (upper_outs & lower_outs):
            break
        plan = L.WithColumns(lower.input,
                             list(lower.exprs) + list(plan.exprs))
    return plan


# ---------------------------------------------------------------------------
# fused arithmetic (reference: `polars-plan/src/plans/optimizer/fused.rs`
# FusedMultiplyAdd / Sub): a*b+c, c+a*b -> fma; a*b-c -> fms; c-a*b -> fsm.
# Each eager torch op is its own kernel launch — fusing removes one
# launch and one intermediate device array per site.
# ---------------------------------------------------------------------------

def _numeric(e: Expr, schema) -> bool:
    dt = meta.output_dtype(e, schema)
    return bool(dt.is_integer or dt.is_float)


def _fuse_expr(e: Expr, schema) -> Expr:
    if e.children:
        ch = tuple(_fuse_expr(c, schema) for c in e.children)
        if any(a is not b for a, b in zip(ch, e.children)):
            e = Expr(e.kind, ch, **e.attrs)
    if e.kind != "binary" or e.attrs.get("op") not in ("add", "sub"):
        return e
    op = e.attrs["op"]
    l, r = e.children

    def _is_mul(x: Expr) -> bool:
        return x.kind == "binary" and x.attrs.get("op") == "mul"

    if _is_mul(l):
        a, b, c, fop = l.children[0], l.children[1], r, \
            ("fma" if op == "add" else "fms")
    elif _is_mul(r):
        a, b, c, fop = r.children[0], r.children[1], l, \
            ("fma" if op == "add" else "fsm")
    else:
        return e
    try:
        if not (_numeric(a, schema) and _numeric(b, schema)
                and _numeric(c, schema)):
            return e
        name = meta.output_name(e)
    except Exception:
        return e
    fused = Expr("fma", (a, b, c), op=fop)
    # preserve the unfused leftmost-root output name
    return Expr("alias", (fused,), name=name)


def fuse_arithmetic(plan: L.Plan) -> L.Plan:
    new_inputs = [fuse_arithmetic(p) for p in plan.inputs]
    if plan.inputs:
        plan = plan.with_inputs(new_inputs)
    k = plan.kind
    if k in ("select", "with_columns"):
        schema = plan.input.schema()
        exprs = [_fuse_expr(x, schema) for x in plan.exprs]
        if any(a is not b for a, b in zip(exprs, plan.exprs)):
            cls = L.Select if k == "select" else L.WithColumns
            return cls(plan.input, exprs)
    elif k == "group_by":
        schema = plan.input.schema()
        aggs = [_fuse_expr(x, schema) for x in plan.aggs]
        if any(a is not b for a, b in zip(aggs, plan.aggs)):
            return L.GroupBy(plan.input, list(plan.keys), aggs,
                             plan.maintain_order)
    return plan


def simplify_plan_exprs(plan: L.Plan) -> L.Plan:
    new_inputs = [simplify_plan_exprs(p) for p in plan.inputs]
    if plan.inputs:
        plan = plan.with_inputs(new_inputs)
    k = plan.kind
    if k == "filter":
        pred = simplify_expr(plan.predicate)
        if _lit_bool(pred) is True:
            return plan.input
        if pred is not plan.predicate:
            return L.Filter(plan.input, pred)
        return plan
    if k in ("select", "with_columns"):
        exprs = [simplify_expr(x) for x in plan.exprs]
        if any(a is not b for a, b in zip(exprs, plan.exprs)):
            cls = L.Select if k == "select" else L.WithColumns
            return cls(plan.input, exprs)
        return plan
    if k == "group_by":
        keys = [simplify_expr(x) for x in plan.keys]
        aggs = [simplify_expr(x) for x in plan.aggs]
        if any(a is not b for a, b in zip(keys + aggs,
                                          list(plan.keys) + list(plan.aggs))):
            return L.GroupBy(plan.input, keys, aggs, plan.maintain_order)
        return plan
    return plan


# ---------------------------------------------------------------------------
# common subplan elimination (runs LAST, after pushdowns have specialized
# each branch — only still-identical subtrees share a cache)
# ---------------------------------------------------------------------------

def insert_common_subplan_caches(plan: L.Plan) -> L.Plan:
    """Wrap subplans that occur more than once in a shared Cache node so
    the executor materializes them exactly once per query (reference:
    common-subplan-elim, `polars-plan/src/plans/optimizer/cse/`).

    Counting only recurses into a subtree the first time its fingerprint
    is seen: descendants of a shared subtree are not themselves marked
    (the outer cache already deduplicates them)."""
    counts: Dict[str, int] = {}

    def walk(p: L.Plan) -> None:
        fp = p.fingerprint()
        counts[fp] = counts.get(fp, 0) + 1
        if counts[fp] == 1:
            for i in p.inputs:
                walk(i)

    walk(plan)
    shared = {fp for fp, c in counts.items() if c > 1}
    if not shared:
        return plan
    cache_nodes: Dict[str, L.Plan] = {}

    def rewrite(p: L.Plan) -> L.Plan:
        fp = p.fingerprint()
        if fp in shared and p.inputs and p.kind not in ("df_scan", "cache"):
            if fp not in cache_nodes:
                cache_nodes[fp] = L.Cache(_rewrite_children(p))
            return cache_nodes[fp]
        return _rewrite_children(p)

    def _rewrite_children(p: L.Plan) -> L.Plan:
        if not p.inputs:
            return p
        new_ins = [rewrite(i) for i in p.inputs]
        if all(a is b for a, b in zip(new_ins, p.inputs)):
            return p
        return p.with_inputs(new_ins)

    return rewrite(plan)


# ---------------------------------------------------------------------------
# predicate pushdown
# ---------------------------------------------------------------------------

def _split_conjuncts(e: Expr) -> List[Expr]:
    if e.kind == "binary" and e.attrs.get("op") == "and":
        return _split_conjuncts(e.children[0]) + _split_conjuncts(e.children[1])
    return [e]


def _join_conjuncts(es: Sequence[Expr]) -> Expr:
    acc = es[0]
    for e in es[1:]:
        acc = Expr("binary", (acc, e), op="and")
    return acc


def _passthrough_names(node) -> Set[str]:
    """Output names of `node` that are plain copies of input columns."""
    ins = set(node.input.schema().keys())
    if node.kind == "with_columns":
        redefined = set()
        for e in meta.expand_exprs(node.exprs, node.input.schema()):
            redefined.add(meta.output_name(e))
        return ins - redefined
    if node.kind == "select":
        out = set()
        for e in meta.expand_exprs(node.exprs, node.input.schema()):
            if e.kind == "col":
                out.add(e.attrs["name"])
            elif e.kind == "alias" and e.children[0].kind == "col":
                pass  # renamed, not a passthrough under the same name
        return out & ins
    return set()


def push_predicates(plan: L.Plan, pending: Optional[List[Expr]] = None) -> L.Plan:
    pending = pending or []
    k = plan.kind

    if k == "filter":
        conj = _split_conjuncts(plan.predicate)
        return push_predicates(plan.input, pending + conj)

    if k in ("select", "with_columns") and pending:
        # a window or an aggregate reads the rows around each row: a
        # filter below it would change what it reads
        pt = _passthrough_names(plan) if all(
            meta.is_elementwise(e) for e in plan.exprs) else set()
        down, stay = [], []
        for c in pending:
            roots = meta.root_names(c)
            if roots <= pt and meta.is_elementwise(c):
                down.append(c)
            else:
                stay.append(c)
        new_in = push_predicates(plan.input, down)
        out = plan.with_inputs([new_in])
        if stay:
            out = L.Filter(out, _join_conjuncts(stay))
        return out

    if k == "join" and pending:
        ls = set(plan.left.schema().keys())
        rs_schema = plan.right.schema()
        out_schema = plan.schema()
        down_l, down_r, stay = [], [], []
        for c in pending:
            roots = meta.root_names(c)
            if not meta.is_elementwise(c):
                stay.append(c)
            elif roots <= ls and plan.how in ("inner", "left", "semi", "anti"):
                down_l.append(c)
            elif plan.how in ("inner", "right") and \
                    all(r in rs_schema and r not in ls for r in roots):
                down_r.append(c)
            else:
                stay.append(c)
        nl = push_predicates(plan.left, down_l)
        nr = push_predicates(plan.right, down_r)
        out = plan.with_inputs([nl, nr])
        if stay:
            out = L.Filter(out, _join_conjuncts(stay))
        return out

    if k == "group_by" and pending:
        ins = plan.input.schema()
        plain_keys = set()
        for e in meta.expand_exprs(plan.keys, ins):
            if e.kind == "col":
                plain_keys.add(e.attrs["name"])
        down, stay = [], []
        for c in pending:
            roots = meta.root_names(c)
            if roots <= plain_keys and meta.is_elementwise(c):
                down.append(c)
            else:
                stay.append(c)
        new_in = push_predicates(plan.input, down)
        out = plan.with_inputs([new_in])
        if stay:
            out = L.Filter(out, _join_conjuncts(stay))
        return out

    if k == "sort" and pending:
        return plan.with_inputs([push_predicates(plan.input, pending)])

    if k in ("distinct",) and pending:
        # distinct keeps whole rows: a filter commutes when keep is
        # first/any over the same rows? Not in general (keep="first" picks
        # different representatives) — only safe for keep="any"/"none" on
        # key-only predicates; be conservative and stop here.
        out = plan.with_inputs([push_predicates(plan.input, [])])
        return L.Filter(out, _join_conjuncts(pending))

    if k == "rename" and pending:
        inv = {v: kk for kk, v in plan.mapping.items()}
        renamed = [_rename_expr(c, inv) for c in pending]
        return plan.with_inputs([push_predicates(plan.input, renamed)])

    if k == "union" and pending:
        new_inputs = [push_predicates(p, list(pending)) for p in plan.inputs]
        return plan.with_inputs(new_inputs)

    if k == "scan" and pending:
        new_pred = _join_conjuncts(pending)
        if plan.predicate is not None:
            new_pred = Expr("binary", (plan.predicate, new_pred), op="and")
        if plan.n_rows is None:
            return plan.replace(predicate=new_pred)
        # predicate after head() must stay a Filter
        return L.Filter(plan, _join_conjuncts(pending))

    # default: stop pushing here
    new_inputs = [push_predicates(p, []) for p in plan.inputs]
    out = plan.with_inputs(new_inputs) if plan.inputs else plan
    if pending:
        out = L.Filter(out, _join_conjuncts(pending))
    return out


def _rename_expr(e: Expr, mapping: Dict[str, str]) -> Expr:
    if e.kind == "col":
        n = e.attrs["name"]
        return Expr("col", name=mapping.get(n, n))
    if not e.children:
        return e
    return Expr(e.kind, tuple(_rename_expr(c, mapping) for c in e.children),
                **e.attrs)


# ---------------------------------------------------------------------------
# slice pushdown
# ---------------------------------------------------------------------------

def push_slice(plan: L.Plan) -> L.Plan:
    if plan.kind == "slice" and plan.offset == 0 and plan.length is not None:
        child = plan.input
        n = plan.length
        if child.kind == "scan" and child.predicate is None:
            sc = child.replace(n_rows=n if child.n_rows is None
                               else min(child.n_rows, n))
            return push_slice(sc)
        if child.kind == "sort":
            # a sort that already carries a top-k slice keeps the shorter
            # of its own length and the outer one
            fused = (0, n) if child.slice_ is None else \
                (child.slice_[0], min(child.slice_[1], n))
            return L.Sort(push_slice(child.input), child.by,
                          child.descending, child.nulls_last,
                          child.maintain_order, fused)
        if child.kind in ("select", "with_columns") and \
                all(meta.is_elementwise(e) for e in child.exprs):
            pushed = L.Slice(child.input, 0, n)
            return child.with_inputs([push_slice(pushed)])
    new_inputs = [push_slice(p) for p in plan.inputs]
    return plan.with_inputs(new_inputs) if plan.inputs else plan


# ---------------------------------------------------------------------------
# projection pushdown
# ---------------------------------------------------------------------------

def push_projection(plan: L.Plan, needed: Optional[Set[str]]) -> L.Plan:
    k = plan.kind

    if k == "scan":
        fs = plan.file_schema()
        cols = list(fs.keys())
        if needed is not None:
            pred_roots = meta.root_names(plan.predicate) \
                if plan.predicate is not None else set()
            want = needed | pred_roots
            cols = [c for c in cols if c in want]
        if plan.columns is not None:
            cols = [c for c in plan.columns if c in (needed or set(plan.columns))
                    or needed is None]
        return plan.replace(columns=cols if needed is not None else plan.columns)

    if k == "df_scan":
        if needed is not None:
            keep = [n for n in plan.table.names if n in needed]
            return L.DataFrameScan(plan.table.select_columns(keep))
        return plan

    if k == "select":
        ins = plan.input.schema()
        exprs = meta.expand_exprs(plan.exprs, ins)
        if needed is not None:
            exprs = [e for e in exprs if meta.output_name(e) in needed]
            if not exprs:  # keep at least one for shape
                exprs = meta.expand_exprs(plan.exprs, ins)[:1]
        roots: Set[str] = set()
        for e in exprs:
            roots |= meta.root_names(e)
        roots &= set(ins.keys())
        return L.Select(push_projection(plan.input, roots), exprs)

    if k == "with_columns":
        ins = plan.input.schema()
        exprs = meta.expand_exprs(plan.exprs, ins)
        if needed is not None:
            exprs = [e for e in exprs if meta.output_name(e) in needed]
        roots: Set[str] = set()
        for e in exprs:
            roots |= meta.root_names(e)
        if needed is None:
            child_need = None
        else:
            child_need = (needed & set(ins.keys())) | (roots & set(ins.keys()))
        new_in = push_projection(plan.input, child_need)
        out: L.Plan = L.WithColumns(new_in, exprs) if exprs else new_in
        if needed is not None:
            out_names = [n for n in out.schema() if n in needed]
            if set(out.schema().keys()) != set(out_names):
                out = L.Select(out, [Expr("col", name=n) for n in out_names])
        return out

    if k == "filter":
        roots = meta.root_names(plan.predicate)
        child_need = None if needed is None else \
            (needed | roots) & set(plan.input.schema().keys())
        out = L.Filter(push_projection(plan.input, child_need), plan.predicate)
        if needed is not None and set(out.schema()) - needed:
            keep = [n for n in out.schema() if n in needed]
            return L.Select(out, [Expr("col", name=n) for n in keep])
        return out

    if k == "group_by":
        ins = plan.input.schema()
        keys = meta.expand_exprs(plan.keys, ins)
        aggs = meta.expand_exprs(plan.aggs, ins)
        if needed is not None:
            aggs = [a for a in aggs if meta.output_name(a) in needed]
        roots: Set[str] = set()
        for e in list(keys) + list(aggs):
            roots |= meta.root_names(e)
        roots &= set(ins.keys())
        return L.GroupBy(push_projection(plan.input, roots), keys, aggs,
                         plan.maintain_order)

    if k == "join":
        ls, rs = plan.left.schema(), plan.right.schema()
        if needed is None:
            ln = rn = None
        else:
            ln = set(plan.left_on)
            rn = set(plan.right_on)
            for n in needed:
                if n in ls:
                    ln.add(n)
                base = n[: -len(plan.suffix)] if n.endswith(plan.suffix) else n
                if base in rs:
                    rn.add(base)
                elif n in rs:
                    rn.add(n)
        out = plan.with_inputs([push_projection(plan.left, ln),
                                push_projection(plan.right, rn)])
        if needed is not None and set(out.schema()) - needed:
            keep = [n for n in out.schema() if n in needed]
            if keep:
                return L.Select(out, [Expr("col", name=n) for n in keep])
        return out

    if k == "sort":
        roots: Set[str] = set()
        for e in plan.by:
            roots |= meta.root_names(e)
        child_need = None if needed is None else \
            (needed | roots) & set(plan.input.schema().keys())
        out = L.Sort(push_projection(plan.input, child_need), plan.by,
                     plan.descending, plan.nulls_last, plan.maintain_order,
                     plan.slice_)
        if needed is not None and set(out.schema()) - needed:
            keep = [n for n in out.schema() if n in needed]
            return L.Select(out, [Expr("col", name=n) for n in keep])
        return out

    if k == "distinct":
        # distinct semantics depend on all subset columns; row identity
        # keeps every column
        sub = set(plan.subset) if plan.subset else set(plan.input.schema())
        child_need = None if needed is None else \
            (needed | sub) & set(plan.input.schema().keys())
        out = plan.with_inputs([push_projection(plan.input, child_need)])
        if needed is not None and set(out.schema()) - needed:
            keep = [n for n in out.schema() if n in needed]
            return L.Select(out, [Expr("col", name=n) for n in keep])
        return out

    if k == "rename":
        if needed is None:
            child_need = None
        else:
            inv = {v: kk for kk, v in plan.mapping.items()}
            child_need = {inv.get(n, n) for n in needed}
        return L.Rename(push_projection(plan.input, child_need), plan.mapping)

    if k == "drop":
        child_need = None if needed is None else \
            needed & set(plan.schema().keys())
        inner = push_projection(
            plan.input,
            None if child_need is None else child_need)
        # after projection, dropped cols may already be gone
        present = set(inner.schema().keys())
        names = [n for n in plan.names if n in present]
        return L.Drop(inner, names, strict=False) if names else inner

    if k == "union":
        return plan.with_inputs([push_projection(p, needed)
                                 for p in plan.inputs])

    if k == "slice":
        return plan.with_inputs([push_projection(plan.input, needed)])

    if k == "with_row_index":
        child_need = None
        if needed is not None:
            child_need = {n for n in needed if n != plan.name} & \
                set(plan.input.schema().keys())
        return plan.with_inputs([push_projection(plan.input, child_need)])

    if k == "explode":
        # the exploded columns set the row count: they stay, the other
        # columns only as far as they are needed above
        child_need = None if needed is None else \
            (needed | set(plan.columns)) & set(plan.input.schema().keys())
        return plan.with_inputs([push_projection(plan.input, child_need)])

    # opaque nodes (map_function, sink, unpivot, hconcat): need all
    return plan.with_inputs([push_projection(p, None) for p in plan.inputs]) \
        if plan.inputs else plan
