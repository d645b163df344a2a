"""SQL parser: tokenizer + recursive-descent -> AST dicts.

Capability analogue of the reference's SQL frontend
(`crates/polars-sql/src/context.rs`, `sql_expr.rs` — which delegates to
the sqlparser crate; we hand-roll since no SQL dep is available).

Supported: SELECT [DISTINCT] exprs FROM rel [JOIN ...] [WHERE] [GROUP BY]
[HAVING] [ORDER BY] [LIMIT/OFFSET], UNION [ALL], WITH CTEs, subqueries in
FROM, CASE WHEN, CAST, IN/BETWEEN/LIKE/IS NULL, aggregate + scalar
functions, count(*) and count(distinct x).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

from ..errors import SQLSyntaxError

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*|/\*.*?\*/)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><>|!=|>=|<=|\|\||::|[-+*/%(),.;=<>])
""", re.VERBOSE | re.DOTALL)

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "in", "between", "like", "ilike",
    "is", "null", "case", "when", "then", "else", "end", "cast", "join",
    "inner", "left", "right", "full", "outer", "cross", "on", "using",
    "union", "all", "distinct", "with", "asc", "desc", "nulls", "first",
    "last", "true", "false", "exists", "anti", "semi", "show", "tables",
    "create", "table", "drop", "describe", "interval", "over", "partition",
}


class Tok:
    __slots__ = ("kind", "val")

    def __init__(self, kind, val):
        self.kind = kind
        self.val = val

    def __repr__(self):
        return f"{self.kind}:{self.val}"


def tokenize(sql: str) -> List[Tok]:
    out: List[Tok] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SQLSyntaxError(f"unexpected character {sql[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        val = m.group()
        if kind == "ident":
            low = val.lower()
            if low in KEYWORDS:
                out.append(Tok("kw", low))
            else:
                out.append(Tok("ident", val))
        elif kind == "qident":
            out.append(Tok("ident", val[1:-1].replace('""', '"')))
        elif kind == "str":
            out.append(Tok("str", val[1:-1].replace("''", "'")))
        elif kind == "num":
            out.append(Tok("num", val))
        else:
            out.append(Tok("op", val))
    out.append(Tok("eof", ""))
    return out


class Parser:
    def __init__(self, toks: List[Tok]):
        self.toks = toks
        self.i = 0

    # --- cursor helpers -------------------------------------------------
    def peek(self, k: int = 0) -> Tok:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, val: Optional[str] = None) -> Optional[Tok]:
        t = self.peek()
        if t.kind == kind and (val is None or t.val == val):
            return self.next()
        return None

    def expect(self, kind: str, val: Optional[str] = None) -> Tok:
        t = self.accept(kind, val)
        if t is None:
            raise SQLSyntaxError(
                f"expected {val or kind}, got {self.peek().val!r}")
        return t

    def _next_is_lparen(self) -> bool:
        nxt = self.peek(1)
        return nxt.kind == "op" and nxt.val == "("

    def kw(self, *vals) -> Optional[str]:
        t = self.peek()
        if t.kind == "kw" and t.val in vals:
            self.next()
            return t.val
        return None

    # --- statements -----------------------------------------------------
    def parse_statement(self) -> Dict:
        if self.peek().kind == "kw" and self.peek().val == "show":
            self.next()
            self.expect("kw", "tables")
            return {"type": "show_tables"}
        if self.peek().kind == "kw" and self.peek().val == "with":
            return self.parse_with()
        if self.peek().kind == "kw" and self.peek().val in ("select",):
            return self.parse_set_expr()
        if self.peek().kind == "op" and self.peek().val == "(":
            return self.parse_set_expr()
        raise SQLSyntaxError(f"unsupported statement start {self.peek().val!r}")

    def parse_with(self) -> Dict:
        self.expect("kw", "with")
        ctes = []
        while True:
            name = self.expect("ident").val
            self.expect("kw", "as")
            self.expect("op", "(")
            q = self.parse_set_expr()
            self.expect("op", ")")
            ctes.append((name, q))
            if not self.accept("op", ","):
                break
        body = self.parse_set_expr()
        return {"type": "with", "ctes": ctes, "body": body}

    def parse_set_expr(self) -> Dict:
        left = self.parse_select_core()
        while self.peek().kind == "kw" and self.peek().val == "union":
            self.next()
            all_ = bool(self.kw("all"))
            right = self.parse_select_core()
            left = {"type": "union", "left": left, "right": right, "all": all_}
        # trailing order/limit applying to the union
        if self.peek().kind == "kw" and self.peek().val in ("order", "limit"):
            ob, lim, off = self.parse_order_limit()
            left = {"type": "ordered", "input": left, "order_by": ob,
                    "limit": lim, "offset": off}
        return left

    def parse_select_core(self) -> Dict:
        if self.accept("op", "("):
            q = self.parse_set_expr()
            self.expect("op", ")")
            return q
        self.expect("kw", "select")
        distinct = bool(self.kw("distinct"))
        items = []
        while True:
            if self.peek().kind == "op" and self.peek().val == "*":
                self.next()
                items.append({"expr": {"type": "star"}, "alias": None})
            else:
                e = self.parse_expr()
                alias = None
                if self.kw("as"):
                    alias = self.expect("ident").val
                elif self.peek().kind == "ident" and \
                        self.peek(1).val in (",", "") or \
                        (self.peek().kind == "ident" and
                         self.peek(1).kind == "kw" and
                         self.peek(1).val in ("from",)):
                    alias = self.next().val
                items.append({"expr": e, "alias": alias})
            if not self.accept("op", ","):
                break
        rel = None
        joins = []
        if self.kw("from"):
            rel = self.parse_relation()
            while True:
                jt = self._try_join_type()
                if jt is None:
                    break
                right = self.parse_relation()
                on = None
                using = None
                if self.kw("on"):
                    on = self.parse_expr()
                elif self.kw("using"):
                    self.expect("op", "(")
                    using = [self.expect("ident").val]
                    while self.accept("op", ","):
                        using.append(self.expect("ident").val)
                    self.expect("op", ")")
                joins.append({"how": jt, "rel": right, "on": on,
                              "using": using})
        where = self.parse_expr() if self.kw("where") else None
        group_by = []
        if self.kw("group"):
            self.expect("kw", "by")
            group_by.append(self.parse_expr())
            while self.accept("op", ","):
                group_by.append(self.parse_expr())
        having = self.parse_expr() if self.kw("having") else None
        ob, lim, off = self.parse_order_limit()
        return {"type": "select", "distinct": distinct, "items": items,
                "from": rel, "joins": joins, "where": where,
                "group_by": group_by, "having": having, "order_by": ob,
                "limit": lim, "offset": off}

    def parse_order_limit(self):
        ob = []
        if self.kw("order"):
            self.expect("kw", "by")
            while True:
                e = self.parse_expr()
                desc = False
                if self.kw("desc"):
                    desc = True
                else:
                    self.kw("asc")
                nulls_last = None
                if self.kw("nulls"):
                    w = self.kw("first", "last")
                    nulls_last = (w == "last")
                ob.append({"expr": e, "desc": desc, "nulls_last": nulls_last})
                if not self.accept("op", ","):
                    break
        lim = off = None
        if self.kw("limit"):
            lim = int(self.expect("num").val)
        if self.kw("offset"):
            off = int(self.expect("num").val)
        return ob, lim, off

    def _try_join_type(self) -> Optional[str]:
        t = self.peek()
        if t.kind != "kw":
            return None
        if t.val == "join":
            self.next()
            return "inner"
        if t.val in ("inner", "left", "right", "full", "cross", "anti",
                     "semi"):
            how = t.val
            self.next()
            self.kw("outer")
            self.expect("kw", "join")
            return how
        return None

    def parse_relation(self) -> Dict:
        if self.accept("op", "("):
            q = self.parse_set_expr()
            self.expect("op", ")")
            alias = None
            self.kw("as")
            if self.peek().kind == "ident":
                alias = self.next().val
            return {"type": "subquery", "query": q, "alias": alias}
        name = self.expect("ident").val
        # table functions: read_parquet('...'), read_csv('...')
        if self.peek().val == "(" and name.lower() in (
                "read_parquet", "read_csv", "read_ipc", "read_ndjson",
                "read_json"):
            self.next()
            arg = self.expect("str").val
            self.expect("op", ")")
            alias = None
            self.kw("as")
            if self.peek().kind == "ident":
                alias = self.next().val
            return {"type": "table_fn", "fn": name.lower(), "arg": arg,
                    "alias": alias}
        alias = None
        if self.kw("as"):
            alias = self.expect("ident").val
        elif self.peek().kind == "ident":
            alias = self.next().val
        return {"type": "table", "name": name, "alias": alias}

    # --- expressions (precedence climbing) ------------------------------
    def parse_expr(self) -> Dict:
        return self.parse_or()

    def parse_or(self) -> Dict:
        left = self.parse_and()
        while self.kw("or"):
            left = {"type": "bin", "op": "or", "l": left, "r": self.parse_and()}
        return left

    def parse_and(self) -> Dict:
        left = self.parse_not()
        while self.kw("and"):
            left = {"type": "bin", "op": "and", "l": left, "r": self.parse_not()}
        return left

    def parse_not(self) -> Dict:
        if self.kw("not"):
            return {"type": "not", "e": self.parse_not()}
        return self.parse_cmp()

    def parse_cmp(self) -> Dict:
        left = self.parse_add()
        t = self.peek()
        if t.kind == "op" and t.val in ("=", "<>", "!=", "<", "<=", ">", ">="):
            self.next()
            op = {"=": "eq", "<>": "neq", "!=": "neq", "<": "lt", "<=": "le",
                  ">": "gt", ">=": "ge"}[t.val]
            return {"type": "bin", "op": op, "l": left, "r": self.parse_add()}
        if t.kind == "kw" and t.val == "is":
            self.next()
            neg = bool(self.kw("not"))
            self.expect("kw", "null")
            return {"type": "is_null", "e": left, "neg": neg}
        neg = False
        if t.kind == "kw" and t.val == "not":
            if self.peek(1).kind == "kw" and self.peek(1).val in (
                    "in", "between", "like", "ilike"):
                self.next()
                neg = True
                t = self.peek()
        if t.kind == "kw" and t.val == "in":
            self.next()
            self.expect("op", "(")
            vals = [self.parse_expr()]
            while self.accept("op", ","):
                vals.append(self.parse_expr())
            self.expect("op", ")")
            return {"type": "in", "e": left, "vals": vals, "neg": neg}
        if t.kind == "kw" and t.val == "between":
            self.next()
            lo = self.parse_add()
            self.expect("kw", "and")
            hi = self.parse_add()
            return {"type": "between", "e": left, "lo": lo, "hi": hi,
                    "neg": neg}
        if t.kind == "kw" and t.val in ("like", "ilike"):
            ci = t.val == "ilike"
            self.next()
            pat = self.expect("str").val
            return {"type": "like", "e": left, "pat": pat, "neg": neg,
                    "ci": ci}
        return left

    def parse_add(self) -> Dict:
        left = self.parse_mul()
        while True:
            t = self.peek()
            if t.kind == "op" and t.val in ("+", "-", "||"):
                self.next()
                op = {"+": "add", "-": "sub", "||": "concat"}[t.val]
                left = {"type": "bin", "op": op, "l": left,
                        "r": self.parse_mul()}
            else:
                return left

    def parse_mul(self) -> Dict:
        left = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.val in ("*", "/", "%"):
                self.next()
                op = {"*": "mul", "/": "truediv", "%": "mod"}[t.val]
                left = {"type": "bin", "op": op, "l": left,
                        "r": self.parse_unary()}
            else:
                return left

    def parse_unary(self) -> Dict:
        if self.accept("op", "-"):
            return {"type": "neg", "e": self.parse_unary()}
        if self.accept("op", "+"):
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self) -> Dict:
        e = self.parse_primary()
        while self.accept("op", "::"):
            dt = self.expect("ident").val
            e = {"type": "cast", "e": e, "dtype": dt}
        return e

    def parse_primary(self) -> Dict:
        t = self.peek()
        if t.kind == "num":
            self.next()
            v = t.val
            if "." in v or "e" in v or "E" in v:
                return {"type": "lit", "val": float(v)}
            return {"type": "lit", "val": int(v)}
        if t.kind == "str":
            self.next()
            return {"type": "lit", "val": t.val}
        if t.kind == "kw" and t.val in ("true", "false"):
            self.next()
            return {"type": "lit", "val": t.val == "true"}
        if t.kind == "kw" and t.val == "null":
            self.next()
            return {"type": "lit", "val": None}
        if t.kind == "kw" and t.val == "case":
            return self.parse_case()
        if t.kind == "kw" and t.val == "cast":
            self.next()
            self.expect("op", "(")
            e = self.parse_expr()
            self.expect("kw", "as")
            dt = self.expect("ident").val
            self.expect("op", ")")
            return {"type": "cast", "e": e, "dtype": dt}
        if t.kind == "op" and t.val == "(":
            self.next()
            if self.peek().kind == "kw" and self.peek().val == "select":
                q = self.parse_set_expr()
                self.expect("op", ")")
                return {"type": "scalar_subquery", "query": q}
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        if t.kind == "ident" or (
                t.kind == "kw" and t.val in ("left", "right", "if")
                and self._next_is_lparen()):
            # LEFT/RIGHT/IF are keywords AND function names
            name = self.next().val
            if self.peek().val == "(" and self.peek().kind == "op":
                self.next()
                distinct = bool(self.kw("distinct"))
                args = []
                if self.peek().val == "*":
                    self.next()
                    args.append({"type": "star"})
                elif self.peek().val != ")":
                    args.append(self.parse_expr())
                    while self.accept("op", ","):
                        args.append(self.parse_expr())
                self.expect("op", ")")
                fn_e = {"type": "fn", "name": name.lower(), "args": args,
                        "distinct": distinct}
                if self.peek().kind == "kw" and self.peek().val == "over":
                    fn_e["over"] = self.parse_over_clause()
                return fn_e
            if self.accept("op", "."):
                col = self.expect("ident").val if self.peek().kind == "ident" \
                    else self.expect("op", "*").val
                return {"type": "col", "table": name, "name": col}
            return {"type": "col", "table": None, "name": name}
        raise SQLSyntaxError(f"unexpected token {t.val!r}")

    def parse_over_clause(self) -> Dict:
        """OVER (PARTITION BY e[, ...] [ORDER BY e [ASC|DESC][, ...]])"""
        self.expect("kw", "over")
        self.expect("op", "(")
        partition: List[Dict] = []
        order: List[Dict] = []
        descs: List[bool] = []
        if self.kw("partition"):
            self.expect("kw", "by")
            partition.append(self.parse_expr())
            while self.accept("op", ","):
                partition.append(self.parse_expr())
        if self.kw("order"):
            self.expect("kw", "by")
            while True:
                order.append(self.parse_expr())
                d = False
                if self.kw("desc"):
                    d = True
                else:
                    self.kw("asc")
                descs.append(d)
                if not self.accept("op", ","):
                    break
        self.expect("op", ")")
        return {"partition": partition, "order": order, "desc": descs}

    def parse_case(self) -> Dict:
        self.expect("kw", "case")
        base = None
        if not (self.peek().kind == "kw" and self.peek().val == "when"):
            base = self.parse_expr()
        branches = []
        while self.kw("when"):
            cond = self.parse_expr()
            self.expect("kw", "then")
            val = self.parse_expr()
            branches.append((cond, val))
        els = self.parse_expr() if self.kw("else") else None
        self.expect("kw", "end")
        return {"type": "case", "base": base, "branches": branches,
                "else": els}


def parse_sql(sql: str) -> Dict:
    p = Parser(tokenize(sql))
    stmt = p.parse_statement()
    p.accept("op", ";")
    if p.peek().kind != "eof":
        raise SQLSyntaxError(f"trailing tokens: {p.peek().val!r}")
    return stmt
