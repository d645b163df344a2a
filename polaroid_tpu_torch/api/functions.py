"""Top-level frame constructors and functions (the subset the port has
so far; parity target: `py-polars/src/polars/functions/`). `col`, `lit`
and `len` live in `expr/expr.py`, as in the JAX package."""

from __future__ import annotations

from typing import Sequence

from ..dtypes import Float64
from ..errors import ComputeError
from ..expr.expr import Expr, col


def from_dict(data, schema=None, device=None):
    from .frame import DataFrame
    return DataFrame(data, schema=schema, device=device)


def _pair(a, b):
    """Both inputs as Float64 over the rows where both are valid."""
    a = col(a) if isinstance(a, str) else a
    b = col(b) if isinstance(b, str) else b
    pair = a.is_not_null() & b.is_not_null()
    return a.filter(pair).cast(Float64), b.filter(pair).cast(Float64)


def corr(a, b, ddof: int = 1) -> Expr:
    """Pearson correlation by its sums, as the JAX package composes it:
    plain aggregations, so it is exact per group in a group-by and
    pairwise complete under nulls."""
    ax, bx = _pair(a, b)
    n = ax.count()
    sx, sy = ax.sum(), bx.sum()
    sxx, syy = (ax * ax).sum(), (bx * bx).sum()
    sxy = (ax * bx).sum()
    num = n * sxy - sx * sy
    den = (n * sxx - sx * sx).sqrt() * (n * syy - sy * sy).sqrt()
    return (num / den).alias("corr")


def cov(a, b, ddof: int = 1) -> Expr:
    """Covariance by its sums, over the rows where both are valid."""
    ax, bx = _pair(a, b)
    n = ax.count()
    return (((ax * bx).sum() - ax.sum() * bx.sum() / n)
            / (n - ddof)).alias("cov")


def rolling_cov(a, b, *, window_size: int, min_samples=None,
                ddof: int = 1) -> Expr:
    """Covariance of two columns over fixed trailing windows."""
    return Expr("rolling_pair", (_col_of(a), _col_of(b)), stat="cov",
                window_size=window_size, min_samples=min_samples, ddof=ddof)


def rolling_corr(a, b, *, window_size: int, min_samples=None,
                 ddof: int = 1) -> Expr:
    """Pearson correlation of two columns over fixed trailing windows."""
    return Expr("rolling_pair", (_col_of(a), _col_of(b)), stat="corr",
                window_size=window_size, min_samples=min_samples, ddof=ddof)


def _col_of(a) -> Expr:
    return col(a) if isinstance(a, str) else a


def concat(items: Sequence, how: str = "vertical", rechunk: bool = False):
    """Frames (or lazy frames, as a union node) stacked vertically
    ("vertical", "vertical_relaxed"), by the union of their columns
    ("diagonal", "diagonal_relaxed"), or side by side ("horizontal")."""
    items = list(items)
    if not items:
        raise ComputeError("concat needs at least one item")
    from .frame import DataFrame
    from .lazyframe import LazyFrame
    from ..plan import logical as L
    if isinstance(items[0], LazyFrame):
        if how == "horizontal":
            return LazyFrame._from_plan(L.HConcat([i._plan for i in items]))
        return LazyFrame._from_plan(L.Union([i._plan for i in items], how))
    if how in ("vertical", "vertical_relaxed", "diagonal",
               "diagonal_relaxed"):
        from ..ops.concat import vstack_tables
        hw = "vertical" if how.startswith("vertical") else "diagonal"
        return DataFrame._from_table(
            vstack_tables([i._table for i in items], hw))
    if how == "horizontal":
        out = items[0]
        for i in items[1:]:
            out = out.hstack(i)
        return out
    raise ComputeError(f"unknown concat strategy {how!r}")
