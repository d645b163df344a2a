"""User-facing expression DSL.

Capability-parity with the reference's `Expr` DSL
(`crates/polars-plan/src/dsl/`, surfaced in `py-polars/src/polars/expr/`):
column refs, literals, arithmetic/comparison/boolean ops, casts,
null-handling, aggregations, window-ish ops (shift/diff/cum_*), when/then/
otherwise, is_in/is_between, and `.str`/`.dt` namespaces.

An `Expr` is an immutable tree: (kind, children, attrs). Evaluation lives
in `eval.py`; planner metadata (output name/dtype, elementwise-ness) in
`meta.py` — mirroring the reference's split between the DSL and
`polars-expr`'s physical expressions.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence, Tuple

from ..dtypes import DataType

__all__ = ["Expr", "col", "lit", "when", "len_", "all_", "nth", "first", "last"]

_BINOPS = {
    "add": "+", "sub": "-", "mul": "*", "truediv": "/", "floordiv": "//",
    "mod": "%", "pow": "**", "eq": "==", "neq": "!=", "lt": "<", "le": "<=",
    "gt": ">", "ge": ">=", "and": "&", "or": "|", "xor": "^",
}

AGG_NAMES = {
    "sum", "mean", "min", "max", "median", "quantile", "std", "var",
    "count", "len", "n_unique", "null_count", "first", "last", "any",
    "all", "product", "arg_min", "arg_max", "implode",
}

WINDOW_NAMES = {
    "shift", "diff", "pct_change", "cum_sum", "cum_min", "cum_max",
    "cum_prod", "cum_count", "rolling_mean", "rolling_sum", "rolling_min",
    "rolling_max", "rolling_std", "rolling_var", "ewm_mean", "rank",
    "arg_sort", "interpolate", "forward_fill", "backward_fill",
}


class Expr:
    __slots__ = ("kind", "children", "attrs")

    def __init__(self, kind: str, children: Tuple["Expr", ...] = (), **attrs):
        self.kind = kind
        self.children = children
        self.attrs = attrs

    # --- structural -----------------------------------------------------
    def fingerprint(self) -> str:
        items = ",".join(f"{k}={_fp_val(v)}" for k, v in sorted(self.attrs.items()))
        ch = ",".join(c.fingerprint() for c in self.children)
        return f"{self.kind}({items};{ch})"

    def __repr__(self) -> str:
        return self.fingerprint()

    # --- naming ---------------------------------------------------------
    def alias(self, name: str) -> "Expr":
        return Expr("alias", (self,), name=name)

    def name_keep(self) -> "Expr":
        return self

    # --- casts & nulls --------------------------------------------------
    def cast(self, dtype: DataType, strict: bool = True) -> "Expr":
        if isinstance(dtype, type) and issubclass(dtype, DataType):
            dtype = dtype()
        return Expr("cast", (self,), dtype=dtype, strict=strict)

    def is_null(self) -> "Expr":
        return Expr("is_null", (self,))

    def is_not_null(self) -> "Expr":
        return Expr("is_not_null", (self,))

    def is_nan(self) -> "Expr":
        return Expr("is_nan", (self,))

    def is_not_nan(self) -> "Expr":
        return Expr("is_not_nan", (self,))

    def is_finite(self) -> "Expr":
        return Expr("is_finite", (self,))

    def is_infinite(self) -> "Expr":
        return Expr("is_infinite", (self,))

    def fill_null(self, value=None, strategy: Optional[str] = None) -> "Expr":
        if strategy is not None:
            return Expr("fill_null_strategy", (self,), strategy=strategy)
        return Expr("fill_null", (self, _wrap(value)))

    def fill_nan(self, value) -> "Expr":
        return Expr("fill_nan", (self, _wrap(value)))

    def drop_nulls(self) -> "Expr":
        return Expr("drop_nulls", (self,))

    def drop_nans(self) -> "Expr":
        return Expr("expr_filter", (self, self.is_not_nan()))

    def item(self) -> "Expr":
        return self._agg("first")

    # --- arithmetic / comparison operators ------------------------------
    def _bin(self, op: str, other, reflect: bool = False) -> "Expr":
        other = _wrap(other)
        l, r = (other, self) if reflect else (self, other)
        return Expr("binary", (l, r), op=op)

    def __add__(self, o): return self._bin("add", o)
    def __radd__(self, o): return self._bin("add", o, True)
    def __sub__(self, o): return self._bin("sub", o)
    def __rsub__(self, o): return self._bin("sub", o, True)
    def __mul__(self, o): return self._bin("mul", o)
    def __rmul__(self, o): return self._bin("mul", o, True)
    def __truediv__(self, o): return self._bin("truediv", o)
    def __rtruediv__(self, o): return self._bin("truediv", o, True)
    def __floordiv__(self, o): return self._bin("floordiv", o)
    def __rfloordiv__(self, o): return self._bin("floordiv", o, True)
    def __mod__(self, o): return self._bin("mod", o)
    def __rmod__(self, o): return self._bin("mod", o, True)
    def __pow__(self, o): return self._bin("pow", o)
    def __rpow__(self, o): return self._bin("pow", o, True)
    def __eq__(self, o): return self._bin("eq", o)  # type: ignore[override]
    def __ne__(self, o): return self._bin("neq", o)  # type: ignore[override]
    def __lt__(self, o): return self._bin("lt", o)
    def __le__(self, o): return self._bin("le", o)
    def __gt__(self, o): return self._bin("gt", o)
    def __ge__(self, o): return self._bin("ge", o)
    def __and__(self, o): return self._bin("and", o)
    def __rand__(self, o): return self._bin("and", o, True)
    def __or__(self, o): return self._bin("or", o)
    def __ror__(self, o): return self._bin("or", o, True)
    def __xor__(self, o): return self._bin("xor", o)
    def __invert__(self): return Expr("unary", (self,), op="not")
    def __neg__(self): return Expr("unary", (self,), op="neg")
    def __abs__(self): return Expr("unary", (self,), op="abs")
    def __hash__(self):  # Exprs are used as dict keys in CSE
        return hash(self.fingerprint())

    def eq(self, o): return self._bin("eq", o)
    def ne(self, o): return self._bin("neq", o)
    def lt(self, o): return self._bin("lt", o)
    def le(self, o): return self._bin("le", o)
    def gt(self, o): return self._bin("gt", o)
    def ge(self, o): return self._bin("ge", o)
    def not_(self): return Expr("unary", (self,), op="not")

    # method-form arithmetic (py-polars `Expr.add/sub/...` parity)
    def add(self, o): return self._bin("add", o)
    def sub(self, o): return self._bin("sub", o)
    def mul(self, o): return self._bin("mul", o)
    def truediv(self, o): return self._bin("truediv", o)
    def floordiv(self, o): return self._bin("floordiv", o)
    def mod(self, o): return self._bin("mod", o)
    def pow(self, o): return self._bin("pow", o)
    def xor(self, o): return self._bin("xor", o)
    def neg(self): return Expr("unary", (self,), op="neg")

    def and_(self, *others) -> "Expr":
        acc = self
        for o in _flatten(others):
            acc = acc._bin("and", _wrap_col(o) if isinstance(o, str) else o)
        return acc

    def or_(self, *others) -> "Expr":
        acc = self
        for o in _flatten(others):
            acc = acc._bin("or", _wrap_col(o) if isinstance(o, str) else o)
        return acc

    def eq_missing(self, o) -> "Expr":
        """Equality where null == null is true (reference:
        `polars-plan/src/dsl/mod.rs` eq_missing)."""
        o = _wrap(o)
        return (self.is_null() & o.is_null()) | \
            self._bin("eq", o).fill_null(False)

    def ne_missing(self, o) -> "Expr":
        return self.eq_missing(o).not_()

    # --- math -----------------------------------------------------------
    def _un(self, op: str, **kw) -> "Expr":
        return Expr("unary", (self,), op=op, **kw)

    def abs(self): return self._un("abs")
    def sign(self): return self._un("sign")
    def sqrt(self): return self._un("sqrt")
    def cbrt(self): return self._un("cbrt")
    def exp(self): return self._un("exp")
    def log(self, base: float = 2.718281828459045): return self._un("log", base=base)
    def log1p(self): return self._un("log1p")
    def log10(self): return self._un("log", base=10.0)
    def sin(self): return self._un("sin")
    def cos(self): return self._un("cos")
    def tan(self): return self._un("tan")
    def arcsin(self): return self._un("arcsin")
    def arccos(self): return self._un("arccos")
    def arctan(self): return self._un("arctan")
    def sinh(self): return self._un("sinh")
    def cosh(self): return self._un("cosh")
    def tanh(self): return self._un("tanh")
    def arcsinh(self): return self._un("arcsinh")
    def arccosh(self): return self._un("arccosh")
    def arctanh(self): return self._un("arctanh")
    def cot(self): return self._un("cot")
    def degrees(self): return self._un("degrees")
    def radians(self): return self._un("radians")
    def floor(self): return self._un("floor")
    def ceil(self): return self._un("ceil")
    def round(self, decimals: int = 0): return self._un("round", decimals=decimals)
    def clip(self, lower_bound=None, upper_bound=None):
        return Expr("clip", (self, _wrap(lower_bound), _wrap(upper_bound)))

    # --- membership -----------------------------------------------------
    def is_in(self, values) -> "Expr":
        if isinstance(values, Expr):
            return Expr("is_in_expr", (self, values))
        return Expr("is_in", (self,), values=tuple(values))

    def is_between(self, lower, upper, closed: str = "both") -> "Expr":
        return Expr("is_between", (self, _wrap(lower), _wrap(upper)), closed=closed)

    def is_duplicated(self) -> "Expr":
        return Expr("is_duplicated", (self,))

    def is_unique(self) -> "Expr":
        return Expr("is_unique", (self,))

    def is_first_distinct(self) -> "Expr":
        return Expr("is_first_distinct", (self,))

    # --- aggregations ---------------------------------------------------
    def _agg(self, name: str, **kw) -> "Expr":
        return Expr("agg", (self,), agg=name, **kw)

    def sum(self): return self._agg("sum")
    def mean(self): return self._agg("mean")
    def min(self): return self._agg("min")
    def max(self): return self._agg("max")
    def median(self): return self._agg("median")
    def quantile(self, q: float, interpolation: str = "nearest"):
        return self._agg("quantile", q=q, interpolation=interpolation)
    def std(self, ddof: int = 1): return self._agg("std", ddof=ddof)
    def var(self, ddof: int = 1): return self._agg("var", ddof=ddof)
    def count(self): return self._agg("count")
    def len(self): return self._agg("len")
    def n_unique(self): return self._agg("n_unique")
    def null_count(self): return self._agg("null_count")
    def first(self): return self._agg("first")
    def last(self): return self._agg("last")
    def any(self): return self._agg("any")
    def all(self): return self._agg("all")
    def product(self): return self._agg("product")
    def arg_min(self): return self._agg("arg_min")
    def arg_max(self): return self._agg("arg_max")
    def implode(self): return self._agg("implode")
    def agg_groups(self): return self._agg("agg_groups")
    def mode(self): return self._agg("mode")
    def skew(self, bias: bool = True): return self._agg("skew", bias=bias)
    def kurtosis(self, fisher: bool = True, bias: bool = True):
        return self._agg("kurtosis", fisher=fisher, bias=bias)
    def nan_min(self): return self._agg("nan_min")
    def nan_max(self): return self._agg("nan_max")
    def bitwise_and(self): return self._agg("bitwise_and")
    def bitwise_or(self): return self._agg("bitwise_or")
    def bitwise_xor(self): return self._agg("bitwise_xor")
    def has_nulls(self): return self.null_count() > 0
    def approx_n_unique(self): return self._agg("n_unique")

    # elementwise bit introspection (reference: polars-compute/src/bitwise/)
    def bitwise_count_ones(self): return self._un("bit_count_ones")
    def bitwise_count_zeros(self): return self._un("bit_count_zeros")
    def bitwise_leading_ones(self): return self._un("bit_leading_ones")
    def bitwise_leading_zeros(self): return self._un("bit_leading_zeros")
    def bitwise_trailing_ones(self): return self._un("bit_trailing_ones")
    def bitwise_trailing_zeros(self): return self._un("bit_trailing_zeros")

    def dot(self, other) -> "Expr":
        return (self * _wrap_col(other)).sum()

    def index_of(self, element) -> "Expr":
        if element is None:
            return self.is_null().arg_true().first()
        return self._bin("eq", element).fill_null(False).arg_true().first()

    # --- order-dependent (window) ops -----------------------------------
    def shift(self, n: int = 1, fill_value=None) -> "Expr":
        return Expr("window", (self, _wrap(fill_value)), op="shift", n=n)

    def diff(self, n: int = 1) -> "Expr":
        return Expr("window", (self, _wrap(None)), op="diff", n=n)

    def pct_change(self, n: int = 1) -> "Expr":
        return Expr("window", (self, _wrap(None)), op="pct_change", n=n)

    def cum_sum(self, reverse: bool = False):
        return Expr("window", (self, _wrap(None)), op="cum_sum", reverse=reverse)

    def cum_min(self, reverse: bool = False):
        return Expr("window", (self, _wrap(None)), op="cum_min", reverse=reverse)

    def cum_max(self, reverse: bool = False):
        return Expr("window", (self, _wrap(None)), op="cum_max", reverse=reverse)

    def cum_prod(self, reverse: bool = False):
        return Expr("window", (self, _wrap(None)), op="cum_prod", reverse=reverse)

    def cum_count(self, reverse: bool = False):
        return Expr("window", (self, _wrap(None)), op="cum_count", reverse=reverse)

    def rolling_mean(self, window_size: int, min_samples: Optional[int] = None):
        return Expr("window", (self, _wrap(None)), op="rolling_mean",
                    window_size=window_size, min_samples=min_samples)

    def rolling_sum(self, window_size: int, min_samples: Optional[int] = None):
        return Expr("window", (self, _wrap(None)), op="rolling_sum",
                    window_size=window_size, min_samples=min_samples)

    def rolling_min(self, window_size: int, min_samples: Optional[int] = None):
        return Expr("window", (self, _wrap(None)), op="rolling_min",
                    window_size=window_size, min_samples=min_samples)

    def rolling_max(self, window_size: int, min_samples: Optional[int] = None):
        return Expr("window", (self, _wrap(None)), op="rolling_max",
                    window_size=window_size, min_samples=min_samples)

    def rolling_std(self, window_size: int, min_samples: Optional[int] = None,
                    ddof: int = 1):
        return Expr("window", (self, _wrap(None)), op="rolling_std",
                    window_size=window_size, min_samples=min_samples, ddof=ddof)

    def rolling_var(self, window_size: int, min_samples: Optional[int] = None,
                    ddof: int = 1):
        return Expr("window", (self, _wrap(None)), op="rolling_var",
                    window_size=window_size, min_samples=min_samples, ddof=ddof)

    def rolling_median(self, window_size: int,
                       min_samples: Optional[int] = None):
        return Expr("window", (self, _wrap(None)), op="rolling_quantile",
                    window_size=window_size, min_samples=min_samples,
                    q=0.5, interpolation="linear")

    def rolling_quantile(self, quantile: float,
                         interpolation: str = "nearest",
                         window_size: int = 2,
                         min_samples: Optional[int] = None):
        return Expr("window", (self, _wrap(None)), op="rolling_quantile",
                    window_size=window_size, min_samples=min_samples,
                    q=quantile, interpolation=interpolation)

    def rolling_skew(self, window_size: int, bias: bool = True,
                     min_samples: Optional[int] = None):
        return Expr("window", (self, _wrap(None)), op="rolling_skew",
                    window_size=window_size, min_samples=min_samples,
                    bias=bias)

    def rolling_kurtosis(self, window_size: int, fisher: bool = True,
                         bias: bool = True,
                         min_samples: Optional[int] = None):
        return Expr("window", (self, _wrap(None)), op="rolling_kurtosis",
                    window_size=window_size, min_samples=min_samples,
                    fisher=fisher, bias=bias)

    def rolling_map(self, function, window_size: int,
                    min_samples: Optional[int] = None):
        return Expr("window", (self, _wrap(None)), op="rolling_map",
                    window_size=window_size, min_samples=min_samples,
                    fn=function)

    def rolling_rank(self, window_size: int, method: str = "average",
                     descending: bool = False,
                     min_samples: Optional[int] = None):
        return Expr("window", (self, _wrap(None)), op="rolling_rank",
                    window_size=window_size, min_samples=min_samples,
                    method=method, descending=descending)

    # range-windowed (by a sorted companion column, e.g. time)
    def _rolling_by(self, op: str, by, window_size, min_samples,
                    closed: str = "right", **kw):
        return Expr("window", (self, _wrap(None), _wrap_col(by)),
                    op=op, period=window_size,
                    min_samples=min_samples, closed=closed, **kw)

    def rolling_sum_by(self, by, window_size, min_samples: int = 1,
                       closed: str = "right"):
        return self._rolling_by("rolling_sum_by", by, window_size,
                                min_samples, closed)

    def rolling_mean_by(self, by, window_size, min_samples: int = 1,
                        closed: str = "right"):
        return self._rolling_by("rolling_mean_by", by, window_size,
                                min_samples, closed)

    def rolling_min_by(self, by, window_size, min_samples: int = 1,
                       closed: str = "right"):
        return self._rolling_by("rolling_min_by", by, window_size,
                                min_samples, closed)

    def rolling_max_by(self, by, window_size, min_samples: int = 1,
                       closed: str = "right"):
        return self._rolling_by("rolling_max_by", by, window_size,
                                min_samples, closed)

    def rolling_std_by(self, by, window_size, min_samples: int = 1,
                       ddof: int = 1, closed: str = "right"):
        return self._rolling_by("rolling_std_by", by, window_size,
                                min_samples, closed, ddof=ddof)

    def rolling_var_by(self, by, window_size, min_samples: int = 1,
                       ddof: int = 1, closed: str = "right"):
        return self._rolling_by("rolling_var_by", by, window_size,
                                min_samples, closed, ddof=ddof)

    def rolling_median_by(self, by, window_size, min_samples: int = 1,
                          closed: str = "right"):
        return self._rolling_by("rolling_quantile_by", by, window_size,
                                min_samples, closed, q=0.5,
                                interpolation="linear")

    def rolling_quantile_by(self, by, window_size, quantile: float = 0.5,
                            interpolation: str = "nearest",
                            min_samples: int = 1, closed: str = "right"):
        return self._rolling_by("rolling_quantile_by", by, window_size,
                                min_samples, closed, q=quantile,
                                interpolation=interpolation)

    def rolling_rank_by(self, by, window_size, method: str = "average",
                        descending: bool = False, min_samples: int = 1,
                        closed: str = "right"):
        return self._rolling_by("rolling_rank_by", by, window_size,
                                min_samples, closed, method=method,
                                descending=descending)

    def rolling(self, index_column, *, period, offset=None,
                closed: str = "right") -> "Expr":
        """Apply this aggregation over value-range rolling windows of
        `index_column` (reference: `Expr.rolling`,
        `py-polars/src/polars/expr/expr.py:3790`) — rewritten onto the
        engine's rolling_*_by range-window kernels."""
        from ..errors import InvalidOperationError
        import datetime as _dt
        if isinstance(period, _dt.timedelta):
            period = f"{int(period.total_seconds() * 1e6)}us"
        if offset is not None:
            raise InvalidOperationError(
                "Expr.rolling(offset=...) is not supported yet")
        if self.kind == "table_len":
            from ..dtypes import Int32
            ones = _wrap_col(index_column).is_not_null().cast(Int32)
            return ones._rolling_by("rolling_sum_by", index_column, period,
                                    1, closed)
        if self.kind == "alias":
            return self.children[0].rolling(
                index_column, period=period, closed=closed).alias(
                    self.attrs["name"])
        if self.kind != "agg":
            raise InvalidOperationError(
                "Expr.rolling expects an aggregation expression, e.g. "
                "pl.col('x').sum().rolling(index_column='t', period='2h')")
        agg = self.attrs["agg"]
        child = self.children[0]
        if agg == "sum":
            return child.rolling_sum_by(index_column, period, closed=closed)
        if agg == "mean":
            return child.rolling_mean_by(index_column, period, closed=closed)
        if agg == "min":
            return child.rolling_min_by(index_column, period, closed=closed)
        if agg == "max":
            return child.rolling_max_by(index_column, period, closed=closed)
        if agg == "std":
            return child.rolling_std_by(index_column, period, closed=closed,
                                        ddof=self.attrs.get("ddof", 1))
        if agg == "var":
            return child.rolling_var_by(index_column, period, closed=closed,
                                        ddof=self.attrs.get("ddof", 1))
        if agg == "median":
            return child.rolling_median_by(index_column, period,
                                           closed=closed)
        if agg == "quantile":
            return child.rolling_quantile_by(
                index_column, period, quantile=self.attrs.get("q", 0.5),
                interpolation=self.attrs.get("interpolation", "nearest"),
                closed=closed)
        if agg in ("count", "len"):
            from ..dtypes import Int32
            src = child.is_not_null().cast(Int32) if agg == "count" \
                else Expr("lit", value=1, dtype=None)
            return src._rolling_by("rolling_sum_by", index_column, period,
                                   1, closed)
        raise InvalidOperationError(
            f"aggregation {agg!r} is not supported with Expr.rolling")

    def reshape(self, dimensions) -> "Expr":
        """Reshape to a flat column or a fixed-width Array column
        (reference: `py-polars/src/polars/expr/expr.py:9864`)."""
        dims = tuple(int(d) for d in dimensions)
        return Expr("reshape", (self,), dims=dims)

    def interpolate_by(self, by) -> "Expr":
        return Expr("window", (self, _wrap(None), _wrap_col(by)),
                    op="interpolate_by")

    def ewm_mean_by(self, by, half_life) -> "Expr":
        return Expr("window", (self, _wrap(None), _wrap_col(by)),
                    op="ewm_mean_by", half_life=half_life)

    def ewm_std(self, alpha: Optional[float] = None,
                span: Optional[float] = None,
                half_life: Optional[float] = None, com: Optional[float] = None,
                adjust: bool = True, bias: bool = False,
                min_samples: int = 1):
        alpha = _resolve_alpha(alpha, span, half_life, com)
        return Expr("window", (self, _wrap(None)), op="ewm_std", alpha=alpha,
                    adjust=adjust, bias=bias, min_samples=min_samples)

    def ewm_var(self, alpha: Optional[float] = None,
                span: Optional[float] = None,
                half_life: Optional[float] = None, com: Optional[float] = None,
                adjust: bool = True, bias: bool = False,
                min_samples: int = 1):
        alpha = _resolve_alpha(alpha, span, half_life, com)
        return Expr("window", (self, _wrap(None)), op="ewm_var", alpha=alpha,
                    adjust=adjust, bias=bias, min_samples=min_samples)

    def ewm_mean(self, alpha: Optional[float] = None, span: Optional[float] = None,
                 half_life: Optional[float] = None, com: Optional[float] = None,
                 adjust: bool = True, min_samples: int = 1):
        alpha = _resolve_alpha(alpha, span, half_life, com)
        return Expr("window", (self, _wrap(None)), op="ewm_mean", alpha=alpha,
                    adjust=adjust, min_samples=min_samples)

    def rank(self, method: str = "average", descending: bool = False):
        return Expr("window", (self, _wrap(None)), op="rank", method=method,
                    descending=descending)

    def forward_fill(self):
        return Expr("window", (self, _wrap(None)), op="forward_fill")

    def backward_fill(self):
        return Expr("window", (self, _wrap(None)), op="backward_fill")

    def interpolate(self):
        return Expr("window", (self, _wrap(None)), op="interpolate")

    # --- over (grouped window) ------------------------------------------
    def over(self, *partition_by, mapping_strategy: str = "group_to_rows",
             order_by=None, descending: bool = False,
             nulls_last: bool = False) -> "Expr":
        parts = tuple(_wrap_col(p) for p in _flatten(partition_by))
        obs = ()
        if order_by is not None:
            obs = tuple(_wrap_col(o) for o in _flatten([order_by]))
        return Expr("over", (self,) + parts + obs, n_partition=len(parts),
                    n_order=len(obs), descending=descending,
                    nulls_last=nulls_last, mapping_strategy=mapping_strategy)

    # --- sorting helpers ------------------------------------------------
    def sort(self, descending: bool = False, nulls_last: bool = False):
        return Expr("sort_self", (self,), descending=descending,
                    nulls_last=nulls_last)

    def sort_by(self, *by, descending=False, nulls_last: bool = False):
        by_exprs = tuple(_wrap_col(b) for b in _flatten(by))
        return Expr("sort_by", (self,) + by_exprs, descending=descending,
                    nulls_last=nulls_last, n_by=len(by_exprs))

    def reverse(self):
        return Expr("window", (self, _wrap(None)), op="reverse")

    def arg_sort(self, descending: bool = False, nulls_last: bool = False):
        return Expr("window", (self, _wrap(None)), op="arg_sort",
                    descending=descending, nulls_last=nulls_last)

    def arg_true(self) -> "Expr":
        return Expr("arg_true", (self,))

    def arg_unique(self) -> "Expr":
        return self.is_first_distinct().arg_true()

    def is_last_distinct(self) -> "Expr":
        return Expr("is_last_distinct", (self,))

    def top_k(self, k: int = 5) -> "Expr":
        return Expr("sort_self", (self,), descending=True,
                    nulls_last=True).head(k)

    def bottom_k(self, k: int = 5) -> "Expr":
        return Expr("sort_self", (self,), descending=False,
                    nulls_last=True).head(k)

    def top_k_by(self, by, k: int = 5) -> "Expr":
        return self.sort_by(by, descending=True, nulls_last=True).head(k)

    def bottom_k_by(self, by, k: int = 5) -> "Expr":
        return self.sort_by(by, descending=False, nulls_last=True).head(k)

    def filter(self, predicate: "Expr") -> "Expr":
        return Expr("expr_filter", (self, predicate))

    def where(self, predicate: "Expr") -> "Expr":
        return self.filter(predicate)

    def slice(self, offset: int, length: Optional[int] = None) -> "Expr":
        return Expr("expr_slice", (self,), offset=offset, length=length)

    def head(self, n: int = 10) -> "Expr":
        return self.slice(0, n)

    def tail(self, n: int = 10) -> "Expr":
        return Expr("expr_slice", (self,), offset=-n, length=n)

    def gather(self, indices) -> "Expr":
        return Expr("gather", (self, _wrap(indices)))

    def get(self, index: int) -> "Expr":
        return Expr("gather", (self, _wrap(index)))

    # --- misc -----------------------------------------------------------
    def unique(self, maintain_order: bool = False) -> "Expr":
        return Expr("expr_unique", (self,), maintain_order=maintain_order)

    def unique_counts(self) -> "Expr":
        return Expr("unique_counts", (self,))

    def value_counts(self) -> "Expr":
        return Expr("value_counts", (self,))

    def hash(self, seed: int = 0) -> "Expr":
        return Expr("hash", (self,), seed=seed)

    def map_batches(self, fn, return_dtype: Optional[DataType] = None) -> "Expr":
        return Expr("map_batches", (self,), fn=fn, return_dtype=return_dtype)

    def repeat_by(self, by) -> "Expr":
        return Expr("repeat_by", (self, _wrap_col(by)))

    def explode(self) -> "Expr":
        return Expr("explode_expr", (self,))

    def rle(self) -> "Expr":
        return Expr("rle", (self,))

    def rle_id(self) -> "Expr":
        return Expr("window", (self, _wrap(None)), op="rle_id")

    def gather_every(self, n: int, offset: int = 0) -> "Expr":
        return Expr("gather_every", (self,), n=n, offset=offset)

    def peak_min(self) -> "Expr":
        return Expr("window", (self, _wrap(None)), op="peak_min")

    def peak_max(self) -> "Expr":
        return Expr("window", (self, _wrap(None)), op="peak_max")

    def shrink_dtype(self) -> "Expr":
        return Expr("shrink_dtype", (self,))

    def entropy(self, base: float = 2.718281828459045,
                normalize: bool = True) -> "Expr":
        return self._agg("entropy", base=base, normalize=normalize)

    def hist(self, bins=None, *, bin_count: Optional[int] = None,
             include_category: bool = False,
             include_breakpoint: bool = False) -> "Expr":
        return Expr("hist", (self,),
                    bins=tuple(bins) if bins is not None else None,
                    bin_count=bin_count,
                    include_category=include_category,
                    include_breakpoint=include_breakpoint)

    def cut(self, breaks, labels=None, left_closed: bool = False) -> "Expr":
        return Expr("cut", (self,), breaks=tuple(breaks),
                    labels=tuple(labels) if labels is not None else None,
                    left_closed=left_closed)

    def qcut(self, quantiles, labels=None, left_closed: bool = False,
             allow_duplicates: bool = False) -> "Expr":
        if isinstance(quantiles, int):
            quantiles = [i / quantiles for i in range(1, quantiles)]
        return Expr("qcut", (self,), quantiles=tuple(quantiles),
                    labels=tuple(labels) if labels is not None else None,
                    left_closed=left_closed)

    def search_sorted(self, element, side: str = "any") -> "Expr":
        return Expr("search_sorted", (self, _wrap(element)), side=side)

    def replace(self, old, new=None) -> "Expr":
        if isinstance(old, dict):
            old, new = tuple(old.keys()), tuple(old.values())
        return Expr("replace", (self,), old=tuple(old) if isinstance(old, (list, tuple)) else (old,),
                    new=tuple(new) if isinstance(new, (list, tuple)) else (new,))

    def replace_strict(self, old, new=None, default=None,
                       return_dtype=None) -> "Expr":
        """Like replace, but unmatched values map to `default` (reference:
        `py-polars` Expr.replace_strict)."""
        if isinstance(old, dict):
            old, new = tuple(old.keys()), tuple(old.values())
        return Expr("replace_strict", (self,),
                    old=tuple(old) if isinstance(old, (list, tuple)) else (old,),
                    new=tuple(new) if isinstance(new, (list, tuple)) else (new,),
                    default=default, return_dtype=return_dtype)

    def extend_constant(self, value, n: int) -> "Expr":
        return Expr("extend_constant", (self, _wrap(value)), n=n)

    def append(self, other) -> "Expr":
        return Expr("append", (self, _wrap(other)))

    def is_close(self, other, abs_tol: float = 1e-12, rel_tol: float = 1e-9,
                 nans_equal: bool = False) -> "Expr":
        """|a-b| <= max(rel_tol*max(|a|,|b|), abs_tol); infinities are close
        iff identical (reference: py-polars Expr.is_close)."""
        o = _wrap(other)
        la, lb = self.abs(), o.abs()
        scale = when(la >= lb).then(la).otherwise(lb)
        tol = when(scale * rel_tol >= abs_tol).then(scale * rel_tol) \
            .otherwise(lit(abs_tol))
        close = ((self - o).abs() <= tol) & self.is_finite() & o.is_finite()
        close = close | (self.is_infinite() & o.is_infinite()
                         & (self._bin("eq", o)))
        if nans_equal:
            close = close | (self.is_nan() & o.is_nan())
        return close

    def lower_bound(self) -> "Expr":
        return Expr("bounds", (self,), side="lower")

    def upper_bound(self) -> "Expr":
        return Expr("bounds", (self,), side="upper")

    def reinterpret(self, signed: bool = True) -> "Expr":
        return self._un("reinterpret", signed=signed)

    def round_sig_figs(self, digits: int) -> "Expr":
        return self._un("round_sig_figs", digits=digits)

    def to_physical(self) -> "Expr":
        return Expr("to_physical", (self,))

    def sample(self, n=None, fraction=None, with_replacement: bool = False,
               shuffle: bool = False, seed=None) -> "Expr":
        return Expr("sample", (self,), n=n, fraction=fraction,
                    with_replacement=with_replacement, seed=seed)

    def shuffle(self, seed=None) -> "Expr":
        return Expr("sample", (self,), n=None, fraction=1.0,
                    with_replacement=False, seed=seed)

    def set_sorted(self, descending: bool = False) -> "Expr":
        return self  # sortedness flags are recomputed, not trusted

    def rechunk(self) -> "Expr":
        return self  # single fixed-capacity buffer: always one chunk

    def limit(self, n: int = 10) -> "Expr":
        return self.head(n)

    def flatten(self) -> "Expr":
        return Expr("explode_expr", (self,))

    def pipe(self, function, *args, **kwargs):
        return function(self, *args, **kwargs)

    def inspect(self, fmt: str = "{}") -> "Expr":
        return self

    def exclude(self, *columns) -> "Expr":
        names = tuple(str(c) for c in _flatten(columns))
        return Expr("exclude", (self,), names=names)

    def map_elements(self, function, return_dtype=None,
                     skip_nulls: bool = True) -> "Expr":
        return Expr("map_elements", (self,), fn=function,
                    return_dtype=return_dtype, skip_nulls=skip_nulls)

    def cumulative_eval(self, expr: "Expr", min_samples: int = 1) -> "Expr":
        return Expr("cumulative_eval", (self, expr), min_samples=min_samples)

    def serialize(self, format: str = "json"):
        """JSON text in the JAX package's format (`expr/serde.py`)."""
        import json
        from . import serde
        return json.dumps(serde.expr_to_dict(self))

    @classmethod
    def deserialize(cls, source, format: str = "json") -> "Expr":
        import json
        from . import serde
        if hasattr(source, "read"):
            source = source.read()
        return serde.expr_from_dict(json.loads(source))

    from_json = deserialize

    # --- namespaces -----------------------------------------------------
    @property
    def str(self) -> "StrNamespace":
        return StrNamespace(self)

    @property
    def dt(self) -> "DtNamespace":
        return DtNamespace(self)

    @property
    def name(self) -> "NameNamespace":
        return NameNamespace(self)

    @property
    def list(self) -> "ListNamespace":
        return ListNamespace(self)

    @property
    def cat(self) -> "CatNamespace":
        return CatNamespace(self)

    @property
    def struct(self) -> "StructNamespace":
        return StructNamespace(self)

    @property
    def arr(self) -> "ListNamespace":
        # fixed-size arrays share the padded-list layout; same kernels
        return ListNamespace(self)

    @property
    def meta(self) -> "MetaNamespace":
        return MetaNamespace(self)

    @property
    def bin(self) -> "BinNamespace":
        return BinNamespace(self)

    @property
    def ext(self) -> "ExtNamespace":
        return ExtNamespace(self)

    def register_plugin(self, *, lib, symbol, args=None, kwargs=None,
                        is_elementwise: bool = False,
                        input_wildcard_expansion: bool = False,
                        returns_scalar: bool = False,
                        cast_to_supertypes: bool = False,
                        pass_name_to_apply: bool = False,
                        changes_length: bool = False) -> "Expr":
        """Deprecated plugin hook: `plugins.register_plugin_function`
        with this expression as the first input."""
        import warnings
        warnings.warn(
            "`register_plugin` is deprecated; use "
            "`polaroid_tpu_torch.plugins.register_plugin_function` instead.",
            DeprecationWarning, stacklevel=2)
        from ..plugins import register_plugin_function
        return register_plugin_function(
            plugin_path=lib, function_name=symbol,
            args=[self, *(args or [])], kwargs=kwargs,
            is_elementwise=is_elementwise,
            input_wildcard_expansion=input_wildcard_expansion,
            returns_scalar=returns_scalar,
            cast_to_supertype=cast_to_supertypes,
            pass_name_to_apply=pass_name_to_apply,
            changes_length=changes_length)


class ExtNamespace:
    """Extension-dtype functions (reference:
    `py-polars/src/polars/expr/ext.py:17` ExprExtensionNameSpace):
    wrap storage values into an extension dtype and back."""

    def __init__(self, e: Expr):
        self._e = e

    def to(self, dtype) -> Expr:
        """Convert storage-typed input to the extension `dtype`."""
        return Expr("ext_to", (self._e,), dtype=dtype)

    def storage(self) -> Expr:
        """Unwrap to the storage values; non-extension input passes
        through unchanged."""
        return Expr("ext_storage", (self._e,))


class BinNamespace:
    """Binary (`bytes`) functions — host-side dictionary transforms +
    device gathers (reference surface: py-polars binary namespace)."""

    def __init__(self, e: Expr):
        self._e = e

    def _op(self, op: str, **kw) -> Expr:
        return Expr("bin", (self._e,), op=op, **kw)

    def slice(self, offset: int, length: Optional[int] = None) -> Expr:
        return self._op("slice", offset=offset, length=length)

    def head(self, n: int = 5) -> Expr:
        return self._op("slice", offset=0, length=n)

    def tail(self, n: int = 5) -> Expr:
        return self._op("slice", offset=-n, length=n)

    def contains(self, literal) -> Expr:
        return self._op("contains", pat=literal)

    def starts_with(self, prefix) -> Expr:
        return self._op("starts_with", pat=prefix)

    def ends_with(self, suffix) -> Expr:
        return self._op("ends_with", pat=suffix)

    def size(self, unit: str = "b") -> Expr:
        return self._op("size", unit=unit)

    def encode(self, encoding: str) -> Expr:
        if encoding not in ("hex", "base64"):
            raise ValueError(f"encoding must be 'hex' or 'base64', got {encoding!r}")
        return self._op("encode", encoding=encoding)

    def decode(self, encoding: str, strict: bool = True) -> Expr:
        if encoding not in ("hex", "base64"):
            raise ValueError(f"encoding must be 'hex' or 'base64', got {encoding!r}")
        return self._op("decode", encoding=encoding, strict=strict)

    def reinterpret(self, dtype, endianness: str = "little") -> Expr:
        return self._op("reinterpret", dtype=dtype, endianness=endianness)


class StrNamespace:
    """String functions. Evaluated as host-side dictionary transforms +
    device gathers (see `strings.StringDict.map_to_array`)."""

    def __init__(self, e: Expr):
        self._e = e

    def _op(self, op: str, **kw) -> Expr:
        return Expr("str", (self._e,), op=op, **kw)

    def len_chars(self): return self._op("len_chars")
    def len_bytes(self): return self._op("len_bytes")
    def to_uppercase(self): return self._op("to_uppercase")
    def to_lowercase(self): return self._op("to_lowercase")
    def to_titlecase(self): return self._op("to_titlecase")
    def strip_chars(self, characters: Optional[str] = None):
        return self._op("strip_chars", characters=characters)
    def strip_chars_start(self, characters: Optional[str] = None):
        return self._op("strip_chars_start", characters=characters)
    def strip_chars_end(self, characters: Optional[str] = None):
        return self._op("strip_chars_end", characters=characters)
    def starts_with(self, prefix: str): return self._op("starts_with", pat=prefix)
    def ends_with(self, suffix: str): return self._op("ends_with", pat=suffix)
    def contains(self, pattern: str, literal: bool = False):
        return self._op("contains", pat=pattern, literal=literal)
    def slice(self, offset: int, length: Optional[int] = None):
        return self._op("slice", offset=offset, length=length)
    def head(self, n: int): return self._op("slice", offset=0, length=n)
    def tail(self, n: int): return self._op("slice", offset=-n, length=None)
    def replace(self, pattern: str, value: str, literal: bool = False):
        return self._op("replace", pat=pattern, value=value, literal=literal, n=1)
    def replace_all(self, pattern: str, value: str, literal: bool = False):
        return self._op("replace", pat=pattern, value=value, literal=literal, n=-1)
    def split(self, by: str): return self._op("split", by=by)
    def extract(self, pattern: str, group_index: int = 1):
        return self._op("extract", pat=pattern, group_index=group_index)
    def count_matches(self, pattern: str, literal: bool = False):
        return self._op("count_matches", pat=pattern, literal=literal)
    def to_integer(self, base: int = 10, strict: bool = True):
        return self._op("to_integer", base=base, strict=strict)
    def to_decimal(self): return self._op("to_decimal")
    def json_decode(self, dtype=None):
        return self._op("json_decode", dtype=dtype)
    def zfill(self, length: int): return self._op("zfill", length=length)
    def pad_start(self, length: int, fill_char: str = " "):
        return self._op("pad_start", length=length, fill_char=fill_char)
    def pad_end(self, length: int, fill_char: str = " "):
        return self._op("pad_end", length=length, fill_char=fill_char)
    def reverse(self): return self._op("reverse")
    def to_datetime(self, format: Optional[str] = None, time_unit: str = "us"):
        return self._op("to_datetime", format=format, time_unit=time_unit)
    def to_date(self, format: Optional[str] = None):
        return self._op("to_date", format=format)
    def strptime(self, dtype, format: Optional[str] = None):
        return self._op("strptime", dtype=dtype, format=format)
    def to_time(self, format: Optional[str] = None):
        return self._op("to_time", format=format)
    def strip_prefix(self, prefix: str):
        return self._op("strip_prefix", pat=prefix)
    def strip_suffix(self, suffix: str):
        return self._op("strip_suffix", pat=suffix)
    def normalize(self, form: str = "NFC"):
        return self._op("normalize", form=form)
    def escape_regex(self):
        return self._op("escape_regex")
    def replace_many(self, patterns, replace_with=None):
        if isinstance(patterns, dict):
            patterns, replace_with = list(patterns.keys()), \
                list(patterns.values())
        if isinstance(replace_with, str):
            replace_with = [replace_with] * len(list(patterns))
        return self._op("replace_many", patterns=tuple(patterns),
                        values=tuple(replace_with))
    def contains_any(self, patterns, ascii_case_insensitive: bool = False):
        return self._op("contains_any", patterns=tuple(patterns),
                        nocase=ascii_case_insensitive)
    def find(self, pattern: str, literal: bool = False, strict: bool = True):
        return self._op("find", pat=pattern, literal=literal)
    def find_many(self, patterns, ascii_case_insensitive: bool = False):
        return self._op("find_many", patterns=tuple(patterns),
                        nocase=ascii_case_insensitive)
    def extract_all(self, pattern: str):
        return self._op("extract_all", pat=pattern)
    def extract_many(self, patterns, ascii_case_insensitive: bool = False):
        return self._op("extract_many", patterns=tuple(patterns),
                        nocase=ascii_case_insensitive)
    def extract_groups(self, pattern: str):
        return self._op("extract_groups", pat=pattern)
    def split_exact(self, by: str, n: int):
        return self._op("split_exact", by=by, n=n)
    def splitn(self, by: str, n: int):
        return self._op("splitn", by=by, n=n)
    def json_path_match(self, json_path: str):
        return self._op("json_path_match", path=json_path)
    def concat(self, delimiter: str = "-", ignore_nulls: bool = True):
        return self._op("str_concat", delimiter=delimiter,
                        ignore_nulls=ignore_nulls)
    def join(self, delimiter: str = "", ignore_nulls: bool = True):
        return self._op("str_concat", delimiter=delimiter,
                        ignore_nulls=ignore_nulls)
    def encode(self, encoding: str):
        return self._op("encode", encoding=encoding)
    def decode(self, encoding: str, strict: bool = True):
        return self._op("decode", encoding=encoding)
    def explode(self):
        return Expr("explode_expr", (self._op("chars"),))


class DtNamespace:
    """Temporal functions, computed on-device from epoch ints via the
    vectorized civil-calendar algorithm (no host round trips)."""

    def __init__(self, e: Expr):
        self._e = e

    def _op(self, op: str, **kw) -> Expr:
        return Expr("dt", (self._e,), op=op, **kw)

    def year(self): return self._op("year")
    def quarter(self): return self._op("quarter")
    def month(self): return self._op("month")
    def day(self): return self._op("day")
    def ordinal_day(self): return self._op("ordinal_day")
    def weekday(self): return self._op("weekday")
    def week(self): return self._op("week")
    def hour(self): return self._op("hour")
    def minute(self): return self._op("minute")
    def second(self): return self._op("second")
    def millisecond(self): return self._op("millisecond")
    def microsecond(self): return self._op("microsecond")
    def nanosecond(self): return self._op("nanosecond")
    def date(self): return self._op("date")
    def truncate(self, every: str): return self._op("truncate", every=every)
    def round(self, every: str): return self._op("round", every=every)
    def offset_by(self, by: str): return self._op("offset_by", by=by)
    def timestamp(self, time_unit: str = "us"):
        return self._op("timestamp", time_unit=time_unit)
    def epoch(self, time_unit: str = "us"):
        return self._op("timestamp", time_unit=time_unit)
    def total_days(self): return self._op("total_days")
    def total_hours(self): return self._op("total_hours")
    def total_minutes(self): return self._op("total_minutes")
    def total_seconds(self): return self._op("total_seconds")
    def total_milliseconds(self): return self._op("total_milliseconds")
    def total_microseconds(self): return self._op("total_microseconds")
    def cast_time_unit(self, time_unit: str):
        return self._op("cast_time_unit", time_unit=time_unit)
    def replace_time_zone(self, tz): return self._op("replace_time_zone", tz=tz)
    def convert_time_zone(self, tz): return self._op("convert_time_zone", tz=tz)
    def is_leap_year(self): return self._op("is_leap_year")
    def iso_year(self): return self._op("iso_year")
    def century(self): return self._op("century")
    def millennium(self): return self._op("millennium")
    def days_in_month(self): return self._op("days_in_month")
    def time(self): return self._op("time")
    def total_nanoseconds(self): return self._op("total_nanoseconds")
    def with_time_unit(self, time_unit: str):
        return self._op("with_time_unit", time_unit=time_unit)
    def base_utc_offset(self): return self._op("base_utc_offset")
    def dst_offset(self): return self._op("dst_offset")
    def is_business_day(self): return self._op("is_business_day")
    def add_business_days(self, n: int, roll: str = "raise"):
        return self._op("add_business_days", n=n, roll=roll)
    def datetime(self): return self._op("datetime")
    def replace(self, *, year=None, month=None, day=None, hour=None,
                minute=None, second=None, microsecond=None):
        return self._op("replace", year=year, month=month, day=day,
                        hour=hour, minute=minute, second=second,
                        microsecond=microsecond)
    def combine(self, time, time_unit: str = "us"):
        return Expr("dt", (self._e, _wrap_col(time)), op="combine",
                    time_unit=time_unit)
    def month_start(self): return self._op("month_start")
    def month_end(self): return self._op("month_end")
    def strftime(self, format: str): return self._op("strftime", format=format)
    def to_string(self, format: Optional[str] = None):
        return self._op("to_string", format=format)


class ListNamespace:
    """List functions over `dtypes.List` columns — masked axis-1 device
    kernels (`ops/nested.py`)."""

    def __init__(self, e: Expr):
        self._e = e

    def _op(self, op: str, **kw) -> Expr:
        return Expr("list", (self._e,), op=op, **kw)

    def len(self): return self._op("len")
    def sum(self): return self._op("sum")
    def mean(self): return self._op("mean")
    def min(self): return self._op("min")
    def max(self): return self._op("max")
    def any(self): return self._op("any")
    def all(self): return self._op("all")
    def first(self): return self._op("first")
    def last(self): return self._op("last")
    def get(self, index: int): return self._op("get", index=index)
    def item(self, *, allow_empty: bool = False):
        return self._op("item", allow_empty=allow_empty)
    def to_list(self): return self._op("to_list")
    def contains(self, item): return self._op("contains", item=item)
    def arg_min(self): return self._op("arg_min")
    def arg_max(self): return self._op("arg_max")
    def reverse(self): return self._op("reverse")
    def sort(self, descending: bool = False):
        return self._op("sort", descending=descending)
    def unique(self): return self._op("unique")
    def head(self, n: int = 5): return self._op("head", n=n)
    def tail(self, n: int = 5): return self._op("tail", n=n)
    def slice(self, offset: int, length: Optional[int] = None):
        return self._op("slice", offset=offset, length=length)
    def join(self, separator: str = ""):
        return self._op("join", separator=separator)
    def explode(self): return Expr("explode_expr", (self._e,))
    def median(self): return self._op("median")
    def std(self, ddof: int = 1): return self._op("std", ddof=ddof)
    def var(self, ddof: int = 1): return self._op("var", ddof=ddof)
    def n_unique(self): return self._op("n_unique")
    def count_matches(self, element): return self._op("count_matches",
                                                      element=element)
    def diff(self, n: int = 1, null_behavior: str = "ignore"):
        return self._op("diff", n=n, null_behavior=null_behavior)
    def shift(self, n: int = 1): return self._op("shift", n=n)
    def drop_nulls(self): return self._op("drop_nulls")
    def gather(self, indices, null_on_oob: bool = False):
        return self._op("gather", indices=tuple(indices),
                        null_on_oob=null_on_oob)
    def gather_every(self, n: int, offset: int = 0):
        return self._op("gather_every", n=n, offset=offset)
    def sample(self, n: int = 1, seed=None):
        return self._op("sample", n=n, seed=seed)
    def to_array(self, width: int):
        return self._e  # padded lists already are fixed-width arrays
    def to_struct(self, n_field_strategy: str = "first_non_null",
                  fields=None, upper_bound: int = 0):
        return self._op("to_struct", fields=tuple(fields)
                        if fields is not None else None)
    def concat(self, other) -> "Expr":
        others = other if isinstance(other, (list, tuple)) else [other]
        return Expr("concat_list",
                    (self._e,) + tuple(_wrap_col(o) for o in others))
    def set_union(self, other):
        return Expr("list_set", (self._e, _wrap_col(other)), how="union")
    def set_intersection(self, other):
        return Expr("list_set", (self._e, _wrap_col(other)),
                    how="intersection")
    def set_difference(self, other):
        return Expr("list_set", (self._e, _wrap_col(other)),
                    how="difference")
    def set_symmetric_difference(self, other):
        return Expr("list_set", (self._e, _wrap_col(other)),
                    how="symmetric_difference")
    def filter(self, predicate: "Expr") -> "Expr":
        return Expr("list_filter", (self._e, predicate))
    def agg(self, expr: "Expr") -> "Expr":
        return Expr("list_eval", (self._e, expr))

    def eval(self, expr: "Expr") -> "Expr":
        """Run an elementwise expression over each list's elements
        (use `pl.element()` inside `expr`)."""
        return Expr("list_eval", (self._e, expr))


def element() -> "Expr":
    """The current list element inside `.list.eval`."""
    return Expr("col", name="__pt_element__")


class CatNamespace:
    """Categorical functions. Our dictionaries are sorted-unique, so the
    physical codes are already lexical ranks (reference:
    `polars-dtype` categorical mappings)."""

    def __init__(self, e: Expr):
        self._e = e

    def get_categories(self) -> Expr:
        return Expr("cat_categories", (self._e,))

    def to_local(self) -> Expr:
        return self._e  # dictionaries are always per-column ("local")

    def set_ordering(self, ordering: str) -> Expr:
        return self._e  # sorted dicts: lexical == physical ordering

    # string ops on the category values (same dictionary machinery)
    def starts_with(self, prefix: str) -> Expr:
        return Expr("str", (self._e,), op="starts_with", pat=prefix)

    def ends_with(self, suffix: str) -> Expr:
        return Expr("str", (self._e,), op="ends_with", pat=suffix)

    def len_chars(self) -> Expr:
        return Expr("str", (self._e,), op="len_chars")

    def len_bytes(self) -> Expr:
        return Expr("str", (self._e,), op="len_bytes")

    def slice(self, offset: int, length: Optional[int] = None) -> Expr:
        return Expr("str", (self._e,), op="slice", offset=offset,
                    length=length)


class StructNamespace:
    def __init__(self, e: Expr):
        self._e = e

    def field(self, name: str) -> Expr:
        return Expr("struct_field", (self._e,), name=name)

    def rename_fields(self, names) -> Expr:
        return Expr("struct_rename", (self._e,), names=tuple(names))

    def __getitem__(self, name: str) -> Expr:
        return self.field(name)

    def prefix_fields(self, prefix: str) -> Expr:
        return Expr("struct_rename", (self._e,), names=None, prefix=prefix)

    def suffix_fields(self, suffix: str) -> Expr:
        return Expr("struct_rename", (self._e,), names=None, suffix=suffix)

    def with_fields(self, *fields, **named) -> Expr:
        from . import meta as _meta
        flat = list(_flatten(fields))
        children = [self._e]
        names = []
        for f in flat:
            e = _wrap_col(f)
            children.append(e)
            names.append(_meta.output_name(e))
        for k, v in named.items():
            children.append(_wrap(v))
            names.append(k)
        return Expr("struct_with_fields", tuple(children),
                    names=tuple(names))

    def json_encode(self) -> Expr:
        return Expr("struct_json_encode", (self._e,))

    def unnest(self) -> Expr:
        return Expr("struct_unnest", (self._e,))



def struct(*exprs, **named) -> Expr:
    """Build a struct column from field expressions (`pl.struct`,
    reference: `polars-plan/src/dsl/functions/horizontal.rs` as_struct)."""
    from . import meta as _meta
    flat = list(_flatten(exprs))
    children = []
    names = []
    for f in flat:
        e = _wrap_col(f)
        children.append(e)
        names.append(_meta.output_name(e))
    for k, v in named.items():
        children.append(_wrap(v))
        names.append(k)
    return Expr("struct", tuple(children), names=tuple(names))


class MetaNamespace:
    """Expression-tree introspection (reference: py-polars Expr.meta)."""

    def __init__(self, e: Expr):
        self._e = e

    def output_name(self) -> str:
        from . import meta as _meta
        return _meta.output_name(self._e)

    def root_names(self):
        from . import meta as _meta
        return sorted(_meta.root_names(self._e))

    def eq(self, other: "Expr") -> bool:
        o = other._e if isinstance(other, MetaNamespace) else other
        return self._e.fingerprint() == o.fingerprint()

    def ne(self, other: "Expr") -> bool:
        return not self.eq(other)

    def has_multiple_outputs(self) -> bool:
        def walk(e):
            if e.kind in ("wildcard", "cols", "dtype_cols"):
                return True
            return any(walk(c) for c in e.children)
        return walk(self._e)

    def is_column(self) -> bool:
        return self._e.kind == "col"

    def is_column_selection(self, allow_aliasing: bool = False) -> bool:
        e = self._e
        if e.kind == "alias" and allow_aliasing:
            e = e.children[0]
        return e.kind in ("col", "cols", "wildcard", "dtype_cols", "nth")

    def is_literal(self, allow_aliasing: bool = False) -> bool:
        e = self._e
        if e.kind == "alias" and allow_aliasing:
            e = e.children[0]
        return e.kind == "lit"

    def is_regex_projection(self) -> bool:
        return self._e.kind == "col" and \
            str(self._e.attrs.get("name", "")).startswith("^")

    def pop(self):
        return list(self._e.children)

    def undo_aliases(self) -> Expr:
        def strip(e: Expr) -> Expr:
            if e.kind == "alias":
                return strip(e.children[0])
            if not e.children:
                return e
            return Expr(e.kind, tuple(strip(c) for c in e.children),
                        **e.attrs)
        return strip(self._e)

    def tree_format(self, return_as_string: bool = True):
        lines = []

        def walk(e: Expr, depth: int):
            label = e.kind
            if e.kind == "col":
                label = f'col("{e.attrs["name"]}")'
            elif e.kind == "lit":
                label = f'lit({e.attrs["value"]!r})'
            elif "op" in e.attrs:
                label = f'{e.kind}[{e.attrs["op"]}]'
            elif "agg" in e.attrs:
                label = f'agg[{e.attrs["agg"]}]'
            lines.append("  " * depth + label)
            for c in e.children:
                walk(c, depth + 1)
        walk(self._e, 0)
        out = "\n".join(lines)
        if return_as_string:
            return out
        print(out)


class NameNamespace:
    def __init__(self, e: Expr):
        self._e = e

    def keep(self) -> Expr:
        return Expr("name_keep", (self._e,))

    def prefix(self, prefix: str) -> Expr:
        return Expr("name_map", (self._e,), how="prefix", arg=prefix)

    def suffix(self, suffix: str) -> Expr:
        return Expr("name_map", (self._e,), how="suffix", arg=suffix)

    def to_uppercase(self) -> Expr:
        return Expr("name_map", (self._e,), how="upper", arg=None)

    def to_lowercase(self) -> Expr:
        return Expr("name_map", (self._e,), how="lower", arg=None)

    def map(self, function) -> Expr:
        return Expr("name_map", (self._e,), how="map", arg=function)

    def replace(self, pattern: str, value: str, *,
                literal: bool = False) -> Expr:
        return Expr("name_map", (self._e,), how="replace",
                    arg=(pattern, value, literal))

    # struct-field renames (only take effect on struct columns)
    def map_fields(self, function) -> Expr:
        return Expr("struct_rename", (self._e,), names=None, fn=function)

    def prefix_fields(self, prefix: str) -> Expr:
        return Expr("struct_rename", (self._e,), names=None, prefix=prefix)

    def suffix_fields(self, suffix: str) -> Expr:
        return Expr("struct_rename", (self._e,), names=None, suffix=suffix)


# --- free functions -----------------------------------------------------

def col(*names: str) -> Expr:
    flat = list(_flatten(names))
    if len(flat) == 1:
        if flat[0] == "*":
            return Expr("wildcard")
        if isinstance(flat[0], DataType) or (isinstance(flat[0], type)):
            return Expr("dtype_cols", dtypes=(flat[0],))
        return Expr("col", name=flat[0])
    if flat and all(isinstance(f, (DataType, type)) for f in flat):
        return Expr("dtype_cols", dtypes=tuple(flat))
    return Expr("cols", names=tuple(flat))


def nth(n: int) -> Expr:
    return Expr("nth", n=n)


def first() -> Expr:
    return Expr("nth", n=0)


def last() -> Expr:
    return Expr("nth", n=-1)


def lit(value: Any, dtype: Optional[DataType] = None) -> Expr:
    if isinstance(dtype, type) and dtype is not None and issubclass(dtype, DataType):
        dtype = dtype()
    return Expr("lit", value=value, dtype=dtype)


def len_() -> Expr:
    return Expr("table_len")


def all_(*exprs) -> Expr:
    if not exprs:
        return Expr("wildcard")
    # horizontal AND fold
    acc = _wrap(exprs[0])
    for e in exprs[1:]:
        acc = acc & _wrap(e)
    return acc


class WhenThen:
    def __init__(self, branches):
        self._branches = branches  # list[(cond Expr, value Expr)]

    def when(self, condition) -> "When":
        return When(self._branches, _wrap(condition))

    def otherwise(self, value) -> Expr:
        conds = tuple(c for c, _ in self._branches)
        vals = tuple(v for _, v in self._branches)
        return Expr("when_then", conds + vals + (_wrap(value),),
                    n_branches=len(self._branches))

    # polars allows using WhenThen directly (implicit otherwise(None))
    def _as_expr(self) -> Expr:
        return self.otherwise(None)

    def alias(self, name: str) -> Expr:
        return self._as_expr().alias(name)


class When:
    def __init__(self, branches, condition: Expr):
        self._branches = branches
        self._condition = condition

    def then(self, value) -> WhenThen:
        return WhenThen(self._branches + [(self._condition, _wrap(value))])


def when(condition) -> When:
    return When([], _wrap(condition))


# --- helpers ------------------------------------------------------------

def _resolve_alpha(alpha, span, half_life, com) -> float:
    if alpha is not None:
        return alpha
    if span is not None:
        return 2.0 / (span + 1.0)
    if com is not None:
        return 1.0 / (1.0 + com)
    if half_life is not None:
        return 1.0 - 0.5 ** (1.0 / half_life)
    raise ValueError("one of alpha/span/half_life/com required")


def _wrap(v) -> Expr:
    if isinstance(v, Expr):
        return v
    if isinstance(v, WhenThen):
        return v._as_expr()
    return lit(v)


def _wrap_col(v) -> Expr:
    if isinstance(v, Expr):
        return v
    if isinstance(v, str):
        return col(v)
    return lit(v)


def _flatten(items) -> Iterable:
    for it in items:
        if isinstance(it, (list, tuple)):
            yield from _flatten(it)
        else:
            yield it


def _fp_val(v) -> str:
    if isinstance(v, Expr):
        return v.fingerprint()
    if callable(v):
        return f"fn@{id(v)}"
    return repr(v)
