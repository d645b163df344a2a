"""SQL AST -> LazyFrame translation.

Capability analogue of `crates/polars-sql/src/context.rs` (execute_query /
process_select) and `sql_expr.rs` (expression lowering).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from ..dtypes import (Boolean, Date, Datetime, Float32, Float64, Int16,
                      Int32, Int64, String, UInt32)
from ..errors import SQLInterfaceError, SQLSyntaxError
from ..expr.expr import Expr, col, lit, when
from ..expr import meta

_DTYPES = {
    "int": Int64, "integer": Int64, "bigint": Int64, "smallint": Int16,
    "int2": Int16, "int4": Int32, "int8": Int64, "float": Float64,
    "real": Float32, "double": Float64, "float4": Float32, "float8": Float64,
    "varchar": String, "text": String, "string": String, "char": String,
    "bool": Boolean, "boolean": Boolean, "date": Date,
    "timestamp": Datetime("us"), "datetime": Datetime("us"),
    "decimal": Float64, "numeric": Float64,
}

_AGG_FNS = {"sum", "avg", "mean", "min", "max", "count", "stddev", "stdev",
            "std", "variance", "var", "median", "first", "last",
            "count_distinct", "approx_count_distinct", "array_agg",
            "quantile", "quantile_cont", "quantile_disc",
            "bit_and", "bit_or", "bit_xor",
            "corr", "covar", "covar_samp", "covar_pop"}


class Scope:
    """Maps (table_alias, column) -> output column name after joins."""

    def __init__(self):
        self.tables: Dict[str, Dict[str, str]] = {}
        self.order: List[str] = []

    def add(self, alias: Optional[str], columns, suffix_map=None):
        m = {}
        for c in columns:
            m[c] = (suffix_map or {}).get(c, c)
        key = alias or f"__t{len(self.order)}"
        self.tables[key] = m
        self.order.append(key)

    def resolve(self, table: Optional[str], name: str) -> str:
        if table is not None:
            t = self.tables.get(table)
            if t is None:
                raise SQLInterfaceError(f"unknown table alias {table!r}")
            if name not in t:
                raise SQLInterfaceError(
                    f"column {name!r} not found in table {table!r}")
            return t[name]
        return name


def _like_to_regex(pat: str) -> str:
    out = []
    for ch in pat:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


def _translate_window_fn(e: Dict, scope, alias_env) -> Expr:
    """fn(...) OVER (PARTITION BY ... [ORDER BY ...]) -> Expr.over()
    (reference: polars-sql window support; engine: `ops/window_over.py`)."""
    over = e["over"]
    name = e["name"]
    args = e["args"]
    parts = [translate_expr(p, scope, alias_env) for p in over["partition"]]
    if not parts:
        parts = [lit(1)]  # global window: one partition
    order = over.get("order") or []
    descs = over.get("desc") or []

    def okey(i=0):
        return translate_expr(order[i], scope, alias_env)

    if name in ("row_number", "rank", "dense_rank"):
        if not order:
            raise SQLInterfaceError(f"{name}() OVER requires ORDER BY")
        if len(order) > 1:
            raise SQLInterfaceError(
                f"{name}() OVER supports one ORDER BY key")
        method = {"row_number": "ordinal", "rank": "min",
                  "dense_rank": "dense"}[name]
        base = okey().rank(method=method, descending=bool(descs[0]))
        return base.over(*parts).alias(name)
    # ORDER BY inside OVER: evaluated through over(order_by=...) so the
    # window runs in sort order while output stays in row order
    okw = {}
    if order:
        okw = dict(order_by=[translate_expr(o, scope, alias_env)
                             for o in order],
                   descending=[bool(d) for d in descs])
    if name in ("lag", "lead"):
        n = 1
        if len(args) > 1 and args[1]["type"] == "lit":
            n = int(args[1]["val"])
        if name == "lead":
            n = -n
        base = translate_expr(args[0], scope, alias_env).shift(n)
        return base.over(*parts, **okw)
    if name in ("first_value", "last_value"):
        base = translate_expr(args[0], scope, alias_env)
        base = base.first() if name == "first_value" else base.last()
        return base.over(*parts, **okw)
    inner = {"type": "fn", "name": name, "args": args,
             "distinct": e.get("distinct")}
    base = _translate_fn(inner, scope, alias_env)
    return base.over(*parts, **okw)


def translate_expr(e: Dict, scope: Optional[Scope],
                   alias_env: Optional[Dict[str, Expr]] = None) -> Expr:
    t = e["type"]
    if t == "lit":
        return lit(e["val"])
    if t == "col":
        name = e["name"]
        if alias_env and e.get("table") is None and name in alias_env:
            return alias_env[name]
        if scope is not None:
            return col(scope.resolve(e.get("table"), name))
        return col(name)
    if t == "star":
        return col("*")
    if t == "bin":
        op = e["op"]
        l = translate_expr(e["l"], scope, alias_env)
        r = translate_expr(e["r"], scope, alias_env)
        if op == "concat":
            from ..api.functions import concat_str
            return concat_str(l, r)
        return Expr("binary", (l, r), op=op)
    if t == "not":
        return ~translate_expr(e["e"], scope, alias_env)
    if t == "neg":
        return -translate_expr(e["e"], scope, alias_env)
    if t == "is_null":
        inner = translate_expr(e["e"], scope, alias_env)
        return inner.is_not_null() if e["neg"] else inner.is_null()
    if t == "in":
        inner = translate_expr(e["e"], scope, alias_env)
        vals = []
        for v in e["vals"]:
            if v["type"] != "lit":
                raise SQLInterfaceError("IN requires literal list")
            vals.append(v["val"])
        r = inner.is_in(vals)
        return ~r if e["neg"] else r
    if t == "between":
        inner = translate_expr(e["e"], scope, alias_env)
        r = inner.is_between(translate_expr(e["lo"], scope, alias_env),
                             translate_expr(e["hi"], scope, alias_env))
        return ~r if e["neg"] else r
    if t == "like":
        inner = translate_expr(e["e"], scope, alias_env)
        rx = _like_to_regex(e["pat"])
        if e.get("ci"):
            rx = "(?i)" + rx
        r = inner.str.contains(rx, literal=False)
        return ~r if e["neg"] else r
    if t == "cast":
        dt = _DTYPES.get(e["dtype"].lower())
        if dt is None:
            raise SQLInterfaceError(f"unknown type {e['dtype']!r}")
        return translate_expr(e["e"], scope, alias_env).cast(dt)
    if t == "case":
        base = e["base"]
        w = None
        for cond, val in e["branches"]:
            c = translate_expr(cond, scope, alias_env)
            if base is not None:
                c = translate_expr(base, scope, alias_env) == c
            v = translate_expr(val, scope, alias_env)
            w = when(c).then(v) if w is None else w.when(c).then(v)
        els = translate_expr(e["else"], scope, alias_env) if e["else"] \
            else lit(None)
        return w.otherwise(els)
    if t == "fn":
        return _translate_fn(e, scope, alias_env)
    if t == "scalar_subquery":
        raise SQLInterfaceError("scalar subqueries not yet supported")
    raise SQLSyntaxError(f"cannot translate expr {t!r}")


def _translate_fn(e: Dict, scope, alias_env) -> Expr:
    name = e["name"]
    args = e["args"]
    if e.get("over") is not None:
        return _translate_window_fn(e, scope, alias_env)

    def a(i=0):
        return translate_expr(args[i], scope, alias_env)

    if name == "count":
        if not args or args[0]["type"] == "star":
            return Expr("table_len").alias("count")
        if e.get("distinct"):
            return a().n_unique()
        return a().count()
    if name in ("sum",):
        return a().sum()
    if name in ("avg", "mean"):
        return a().mean()
    if name == "min" and len(args) == 1:
        return a().min()
    if name == "max" and len(args) == 1:
        return a().max()
    if name in ("stddev", "stdev", "std"):
        return a().std()
    if name in ("variance", "var"):
        return a().var()
    if name == "median":
        return a().median()
    if name == "quantile":
        return a().quantile(args[1]["val"])
    if name in ("first",):
        return a().first()
    if name in ("last",):
        return a().last()
    # scalar functions
    simple = {
        "abs": lambda: a().abs(), "ceil": lambda: a().ceil(),
        "ceiling": lambda: a().ceil(), "floor": lambda: a().floor(),
        "sqrt": lambda: a().sqrt(), "exp": lambda: a().exp(),
        "ln": lambda: a().log(2.718281828459045),
        "log10": lambda: a().log10(), "log2": lambda: a().log(2.0),
        "sin": lambda: a().sin(), "cos": lambda: a().cos(),
        "tan": lambda: a().tan(), "asin": lambda: a().arcsin(),
        "acos": lambda: a().arccos(), "atan": lambda: a().arctan(),
        "upper": lambda: a().str.to_uppercase(),
        "ucase": lambda: a().str.to_uppercase(),
        "lower": lambda: a().str.to_lowercase(),
        "lcase": lambda: a().str.to_lowercase(),
        "length": lambda: a().str.len_chars(),
        "char_length": lambda: a().str.len_chars(),
        "character_length": lambda: a().str.len_chars(),
        "octet_length": lambda: a().str.len_bytes(),
        "trim": lambda: a().str.strip_chars(),
        "ltrim": lambda: a().str.strip_chars_start(),
        "rtrim": lambda: a().str.strip_chars_end(),
        "reverse": lambda: a().str.reverse(),
        "initcap": lambda: a().str.to_titlecase(),
    }
    if name in simple:
        return simple[name]()
    if name == "round":
        d = args[1]["val"] if len(args) > 1 else 0
        return a().round(d)
    if name in ("pow", "power"):
        return a() ** translate_expr(args[1], scope, alias_env)
    if name in ("substr", "substring"):
        off = args[1]["val"] - 1
        ln = args[2]["val"] if len(args) > 2 else None
        return a().str.slice(off, ln)
    if name == "replace":
        return a().str.replace_all(args[1]["val"], args[2]["val"],
                                   literal=True)
    if name == "coalesce":
        from ..api.functions import coalesce
        return coalesce(*[translate_expr(x, scope, alias_env) for x in args])
    if name == "nullif":
        x = a()
        y = translate_expr(args[1], scope, alias_env)
        return when(x == y).then(lit(None)).otherwise(x)
    if name in ("greatest",):
        from ..api.functions import max_horizontal
        return max_horizontal(*[translate_expr(x, scope, alias_env)
                                for x in args])
    if name in ("least",):
        from ..api.functions import min_horizontal
        return min_horizontal(*[translate_expr(x, scope, alias_env)
                                for x in args])
    if name == "starts_with":
        return a().str.starts_with(args[1]["val"])
    if name == "ends_with":
        return a().str.ends_with(args[1]["val"])
    if name == "date_part" or name == "extract":
        part = args[0]["val"].lower()
        inner = translate_expr(args[1], scope, alias_env)
        parts = {"year": "year", "month": "month", "day": "day",
                 "hour": "hour", "minute": "minute", "second": "second",
                 "quarter": "quarter", "week": "week", "dow": "weekday",
                 "doy": "ordinal_day"}
        if part not in parts:
            raise SQLInterfaceError(f"unknown date part {part!r}")
        return Expr("dt", (inner,), op=parts[part])
    if name in ("year", "month", "day", "hour", "minute", "second",
                "quarter", "week", "weekday"):
        return Expr("dt", (a(),), op=name)
    if name == "date_trunc":
        every = {"year": "1y", "quarter": "1q", "month": "1mo",
                 "week": "1w", "day": "1d", "hour": "1h",
                 "minute": "1m", "second": "1s"}[args[0]["val"].lower()]
        return translate_expr(args[1], scope, alias_env).dt.truncate(every)
    if name == "strftime":
        return a().dt.to_string(args[1]["val"])
    if name == "strptime":
        return a().str.to_datetime(format=args[1]["val"]
                                   if len(args) > 1 else None)
    if name == "to_date":
        return a().str.to_date(format=args[1]["val"]
                               if len(args) > 1 else None)
    if name == "date":
        return a().cast(_DTYPES["date"])
    if name in ("timestamp", "datetime"):
        return a().str.to_datetime()
    if name == "time":
        return a().str.to_time()
    # math extras
    if name == "pi":
        import math
        return lit(math.pi)
    if name == "cbrt":
        return a().cbrt()
    if name == "sign":
        return a().sign()
    if name == "log1p":
        return a().log1p()
    if name == "log":
        if len(args) == 2:  # LOG(base, x)
            return translate_expr(args[1], scope, alias_env).log(
                float(args[0]["val"]))
        return a().log(2.718281828459045)
    if name == "cot":
        return a().cot()
    if name == "degrees":
        return a().degrees()
    if name == "radians":
        return a().radians()
    if name in ("asind", "acosd", "atand", "cotd"):
        return getattr(a(), {"asind": "arcsin", "acosd": "arccos",
                             "atand": "arctan", "cotd": "cot"}[name])() \
            .degrees()
    if name in ("sind", "cosd", "tand"):
        return getattr(a().radians(),
                       {"sind": "sin", "cosd": "cos", "tand": "tan"}[name])()
    if name == "atan2":
        from ..api.functions import arctan2
        return arctan2(a(), translate_expr(args[1], scope, alias_env))
    if name == "atan2d":
        from ..api.functions import arctan2d
        return arctan2d(a(), translate_expr(args[1], scope, alias_env))
    if name == "mod":
        return a() % translate_expr(args[1], scope, alias_env)
    if name == "div":
        return a() // translate_expr(args[1], scope, alias_env)
    # bitwise
    if name in ("bit_and", "bit_or", "bit_xor"):
        return getattr(a(), f"bitwise_{name[4:]}")()
    if name == "bit_count":
        return a().bitwise_count_ones()
    if name == "bit_length":
        return a().str.len_bytes() * 8
    # strings
    if name == "left":
        return a().str.head(int(args[1]["val"]))
    if name == "right":
        return a().str.tail(int(args[1]["val"]))
    if name == "strpos":
        # SQL is 1-based; 0 = not found
        return a().str.find(args[1]["val"], literal=True).fill_null(-1) + 1
    if name == "split_part":
        # 1-based part index
        return a().str.split(args[1]["val"]) \
            .list.get(int(args[2]["val"]) - 1)
    if name == "string_to_array":
        return a().str.split(args[1]["val"])
    if name == "regexp_like":
        return a().str.contains(args[1]["val"], literal=False)
    if name == "normalize":
        form = args[1]["val"] if len(args) > 1 else "NFC"
        return a().str.normalize(str(form).upper())
    if name == "concat":
        from ..api.functions import concat_str
        return concat_str(*[translate_expr(x, scope, alias_env)
                            for x in args])
    if name == "concat_ws":
        from ..api.functions import concat_str
        return concat_str(*[translate_expr(x, scope, alias_env)
                            for x in args[1:]],
                          separator=args[0]["val"])
    # arrays (list columns)
    if name == "array_agg":
        return a().implode()
    if name == "array_contains":
        return a().list.contains(args[1]["val"])
    if name == "array_get":
        return a().list.get(int(args[1]["val"]))
    if name in ("array_length", "cardinality"):
        return a().list.len()
    if name == "array_max":
        return a().list.max()
    if name == "array_min":
        return a().list.min()
    if name == "array_mean":
        return a().list.mean()
    if name == "array_sum":
        return a().list.sum()
    if name == "array_unique":
        return a().list.unique()
    if name == "array_reverse":
        return a().list.reverse()
    if name == "array_to_string":
        return a().list.join(args[1]["val"] if len(args) > 1 else ",")
    if name in ("explode", "unnest"):
        return a().explode()
    # stats
    if name == "corr":
        from ..api.functions import corr as _corr
        return _corr(a(), translate_expr(args[1], scope, alias_env))
    if name in ("covar_samp", "covar", "covar_pop"):
        from ..api.functions import cov as _cov
        ddof = 0 if name == "covar_pop" else 1
        return _cov(a(), translate_expr(args[1], scope, alias_env),
                    ddof=ddof)
    if name == "quantile_cont":
        return a().quantile(float(args[1]["val"]), interpolation="linear")
    if name == "quantile_disc":
        return a().quantile(float(args[1]["val"]), interpolation="lower")
    if name == "if":
        return when(a()).then(
            translate_expr(args[1], scope, alias_env)).otherwise(
            translate_expr(args[2], scope, alias_env))
    if name == "ifnull":
        return a().fill_null(translate_expr(args[1], scope, alias_env))
    raise SQLInterfaceError(f"unknown SQL function {name!r}")


def _has_agg_ast(e: Dict) -> bool:
    if e["type"] == "fn" and e.get("over") is not None:
        return False  # window fn keeps row length
    if e["type"] == "fn" and (e["name"] in _AGG_FNS or
                              (e["name"] == "count")):
        return True
    for k, v in e.items():
        if isinstance(v, dict) and "type" in v:
            if _has_agg_ast(v):
                return True
        if isinstance(v, (list, tuple)):
            for x in v:
                if isinstance(x, dict) and "type" in x and _has_agg_ast(x):
                    return True
                if isinstance(x, tuple):
                    for y in x:
                        if isinstance(y, dict) and "type" in y and \
                                _has_agg_ast(y):
                            return True
    return False


def _device(tables: Dict[str, object]):
    """The device of the first registered frame's data (None, the
    package default, without one)."""
    for lf in tables.values():
        stack = [lf._plan]
        while stack:
            p = stack.pop()
            if hasattr(p, "table"):
                return p.table.device
            stack.extend(p.inputs)
    return None


def translate(stmt: Dict, tables: Dict[str, object],
              ctes: Optional[Dict[str, object]] = None):
    ctes = dict(ctes or {})
    t = stmt["type"]
    if t == "show_tables":
        from ..api.frame import DataFrame
        return DataFrame({"name": sorted(tables)},
                         device=_device(tables)).lazy()
    if t == "with":
        env = dict(ctes)
        for name, q in stmt["ctes"]:
            env[name] = translate(q, tables, env)
        return translate(stmt["body"], tables, env)
    if t == "union":
        from ..api.functions import concat
        l = translate(stmt["left"], tables, ctes)
        r = translate(stmt["right"], tables, ctes)
        out = concat([l, r], how="vertical_relaxed")
        if not stmt["all"]:
            out = out.unique(maintain_order=True)
        return out
    if t == "ordered":
        lf = translate(stmt["input"], tables, ctes)
        return _apply_order_limit(lf, stmt["order_by"], stmt["limit"],
                                  stmt["offset"], None, None)
    if t == "select":
        return _translate_select(stmt, tables, ctes)
    raise SQLSyntaxError(f"unsupported statement {t!r}")


def _rel_to_lf(rel, tables, ctes, scope: Scope):
    if rel["type"] == "table":
        name = rel["name"]
        lf = ctes.get(name) or tables.get(name)
        if lf is None:
            raise SQLInterfaceError(f"table {name!r} not found")
        cols = list(lf.schema.keys())
        scope.add(rel.get("alias") or name, cols)
        return lf
    if rel["type"] == "table_fn":
        raise NotImplementedError(
            f"the SQL table function {rel['fn']}(...) reads a file: the "
            "port's file readers come with Slice H (host IO and services)")
    if rel["type"] == "subquery":
        lf = translate(rel["query"], tables, ctes)
        scope.add(rel.get("alias"), list(lf.schema.keys()))
        return lf
    raise SQLSyntaxError(f"unknown relation {rel['type']!r}")


def _translate_select(stmt, tables, ctes):
    scope = Scope()
    if stmt["from"] is None:
        from ..api.frame import DataFrame
        lf = DataFrame({"__dummy": [0]}, device=_device(tables)).lazy()
        items = []
        for it in stmt["items"]:
            e = translate_expr(it["expr"], None)
            if it["alias"]:
                e = e.alias(it["alias"])
            items.append(e)
        return lf.select(items)

    lf = _rel_to_lf(stmt["from"], tables, ctes, scope)

    for j in stmt["joins"]:
        right_scope = Scope()
        rlf = _rel_to_lf(j["rel"], tables, ctes, right_scope)
        how = j["how"]
        if how == "cross":
            lf = lf.join(rlf, how="cross")
        elif j["using"] is not None:
            lf = lf.join(rlf, on=j["using"], how=how)
        elif j["on"] is not None:
            lons, rons = _extract_equi_keys(j["on"], scope, right_scope)
            lf = lf.join(rlf, left_on=lons, right_on=rons, how=how)
        else:
            raise SQLInterfaceError("JOIN requires ON or USING")
        # merge right scope with suffix mapping for collisions
        if how not in ("semi", "anti"):
            lcols = set()
            for tmap in scope.tables.values():
                lcols.update(tmap.values())
            for talias, tmap in right_scope.tables.items():
                newmap = {}
                for c, _ in tmap.items():
                    if j["using"] is not None and c in j["using"]:
                        newmap[c] = c
                    elif c in lcols:
                        newmap[c] = f"{c}_right"
                    else:
                        newmap[c] = c
                scope.tables[talias] = newmap
                scope.order.append(talias)

    if stmt["where"] is not None:
        lf = lf.filter(translate_expr(stmt["where"], scope))

    items = stmt["items"]
    has_group = bool(stmt["group_by"])
    has_agg = any(_has_agg_ast(it["expr"]) for it in items
                  if it["expr"]["type"] != "star")

    select_exprs: List[Expr] = []
    alias_env: Dict[str, Expr] = {}
    out_names: List[str] = []

    def item_expr(it, idx):
        if it["expr"]["type"] == "star":
            return None
        e = translate_expr(it["expr"], scope, None)
        if it["alias"]:
            e = e.alias(it["alias"])
        return e

    if has_group or has_agg:
        # resolve group keys (support ordinals + select aliases)
        keys: List[Expr] = []
        for g in stmt["group_by"]:
            if g["type"] == "lit" and isinstance(g["val"], int):
                it = items[g["val"] - 1]
                e = item_expr(it, g["val"] - 1)
            else:
                e = translate_expr(g, scope)
            keys.append(e)
        key_fps = {k.fingerprint() for k in keys}
        key_names = set()
        for k in keys:
            try:
                key_names.add(meta.output_name(k))
            except Exception:
                pass
        aggs: List[Expr] = []
        final_names: List[str] = []
        for i, it in enumerate(items):
            if it["expr"]["type"] == "star":
                raise SQLInterfaceError("SELECT * with GROUP BY unsupported")
            e = item_expr(it, i)
            nm = meta.output_name(e)
            base = e.children[0] if e.kind == "alias" else e
            if base.fingerprint() in key_fps or \
                    (base.kind == "col" and base.attrs["name"] in key_names):
                final_names.append(nm)
                continue
            if not _has_agg_ast(it["expr"]):
                raise SQLInterfaceError(
                    f"column {nm!r} must appear in GROUP BY or an aggregate")
            aggs.append(e)
            final_names.append(nm)
        # HAVING: rewrite aggregate subtrees to (possibly hidden) agg outputs
        hidden: List[Expr] = []
        having_expr = None
        if stmt["having"] is not None:
            agg_map = {}
            for a in aggs:
                base = a.children[0] if a.kind == "alias" else a
                agg_map[base.fingerprint()] = meta.output_name(a)
            raw = translate_expr(stmt["having"], scope,
                                 {meta.output_name(a): col(meta.output_name(a))
                                  for a in aggs})
            having_expr = _rewrite_having(raw, agg_map, hidden)
        lf = lf.group_by(keys).agg(aggs + hidden)
        if having_expr is not None:
            lf = lf.filter(having_expr)
        # project in select order (drops hidden having columns)
        lf = lf.select([col(n) for n in final_names])
        out_schema_names = final_names
    else:
        for i, it in enumerate(items):
            if it["expr"]["type"] == "star":
                select_exprs.append(Expr("wildcard"))
                continue
            e = item_expr(it, i)
            select_exprs.append(e)
            try:
                alias_env[meta.output_name(e)] = e
            except Exception:
                pass
        # SQL scoping: ORDER BY may reference pre-projection columns and
        # select aliases — sort before projecting.
        if stmt["order_by"]:
            keys, descs, nls = [], [], []
            positional = [meta.output_name(e) if e.kind != "wildcard" else None
                          for e in select_exprs]
            for ob in stmt["order_by"]:
                g = ob["expr"]
                if g["type"] == "lit" and isinstance(g["val"], int):
                    e = select_exprs[g["val"] - 1]
                else:
                    e = translate_expr(g, scope, alias_env)
                keys.append(e)
                descs.append(ob["desc"])
                nl = ob["nulls_last"]
                nls.append(nl if nl is not None else False)
            lf = lf.sort(keys, descending=descs, nulls_last=nls)
        lf = lf.select(select_exprs)
        if stmt["distinct"]:
            lf = lf.unique(maintain_order=True)
        if stmt["offset"] is not None:
            lf = lf.slice(stmt["offset"], stmt["limit"])
        elif stmt["limit"] is not None:
            lf = lf.head(stmt["limit"])
        return lf

    if stmt["distinct"]:
        lf = lf.unique(maintain_order=True)

    return _apply_order_limit(lf, stmt["order_by"], stmt["limit"],
                              stmt["offset"], out_schema_names, items)


def _rewrite_having(e: Expr, agg_map: Dict[str, str],
                    hidden: List[Expr]) -> Expr:
    """Replace aggregate subtrees with references to agg output columns,
    adding hidden aggregations for ones not in the SELECT list."""
    if e.kind in ("agg", "table_len"):
        fp = e.fingerprint()
        if fp in agg_map:
            return col(agg_map[fp])
        name = f"__having_{len(hidden)}"
        hidden.append(e.alias(name))
        agg_map[fp] = name
        return col(name)
    if not e.children:
        return e
    return Expr(e.kind, tuple(_rewrite_having(c, agg_map, hidden)
                              for c in e.children), **e.attrs)


def _apply_order_limit(lf, order_by, limit, offset, out_names, items):
    if order_by:
        keys, descs, nls = [], [], []
        for ob in order_by:
            g = ob["expr"]
            if g["type"] == "lit" and isinstance(g["val"], int) and out_names:
                e = col(out_names[g["val"] - 1])
            else:
                e = translate_expr(g, None)
            keys.append(e)
            descs.append(ob["desc"])
            nl = ob["nulls_last"]
            nls.append(nl if nl is not None else False)
        lf = lf.sort(keys, descending=descs, nulls_last=nls)
    if offset is not None:
        lf = lf.slice(offset, limit)
    elif limit is not None:
        lf = lf.head(limit)
    return lf


def _extract_equi_keys(on: Dict, lscope: Scope, rscope: Scope):
    """Split `a.x = b.y AND ...` into (left_cols, right_cols)."""
    pairs: List[Tuple[str, str]] = []

    def rec(e):
        if e["type"] == "bin" and e["op"] == "and":
            rec(e["l"])
            rec(e["r"])
            return
        if e["type"] == "bin" and e["op"] == "eq":
            l, r = e["l"], e["r"]
            if l["type"] == "col" and r["type"] == "col":
                lc = _side_of(l, lscope, rscope)
                rc = _side_of(r, lscope, rscope)
                if lc[0] == "left" and rc[0] == "right":
                    pairs.append((lc[1], rc[1]))
                    return
                if lc[0] == "right" and rc[0] == "left":
                    pairs.append((rc[1], lc[1]))
                    return
        raise SQLInterfaceError(
            "only equi-join ON conditions (a.x = b.y [AND ...]) supported")

    rec(on)
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _side_of(c: Dict, lscope: Scope, rscope: Scope):
    table, name = c.get("table"), c["name"]
    if table is not None:
        if table in rscope.tables:
            return ("right", rscope.resolve(table, name))
        if table in lscope.tables:
            return ("left", lscope.resolve(table, name))
        raise SQLInterfaceError(f"unknown table alias {table!r}")
    # unqualified: search right first then left
    for talias, tmap in rscope.tables.items():
        if name in tmap:
            return ("right", tmap[name])
    for talias, tmap in lscope.tables.items():
        if name in tmap:
            return ("left", tmap[name])
    raise SQLInterfaceError(f"column {name!r} not found in join scopes")
