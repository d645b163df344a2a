"""Series: a named single column (the subset the port has so far).

Parity target: `py-polars/src/polars/series/`, as in the JAX package's
`api/series.py`: a view and conversion type over one `Column`.
"""

from __future__ import annotations

from typing import Any, List as _ListT, Optional

import numpy as np

from ..batch import Column
from ..dtypes import DataType


def _py(v):
    return v.item() if isinstance(v, np.generic) else v


class Series:
    def __init__(self, name="", values=None, dtype: Optional[DataType] = None,
                 device=None):
        if values is None and not isinstance(name, str):
            name, values = "", name
        values = values if values is not None else []
        self._col = Column.from_host(values, dtype=dtype, device=device)
        self._len = len(values)
        self.name = name

    @classmethod
    def _from_column(cls, name: str, col: Column, length: int) -> "Series":
        s = cls.__new__(cls)
        s._col = col
        s._len = length
        s.name = name
        return s

    def __len__(self) -> int:
        return self._len

    @property
    def dtype(self) -> DataType:
        return self._col.dtype

    @property
    def shape(self):
        return (len(self),)

    def sort(self, descending: bool = False) -> "Series":
        """The values in order on the series' device, nulls first: a
        one-column table through `ops/sort.sort_table`, as a frame
        sorts."""
        from ..batch import Table
        from .frame import DataFrame
        name = self.name or ""
        t = Table([name], {name: self._col}, self._col.capacity, len(self))
        return DataFrame._from_table(t).sort(name, descending=descending) \
            .get_column(name)

    def _apply(self, make_expr) -> "Series":
        """make_expr(col) evaluated over this series as a one-column
        frame, as the JAX package's Series does."""
        from ..batch import Table
        from ..expr.expr import col
        from .frame import DataFrame
        name = self.name or ""
        t = Table([name], {name: self._col}, self._col.capacity, len(self))
        return DataFrame._from_table(t).select(
            make_expr(col(name)).alias(name)).get_column(name)

    @property
    def dt(self) -> "_Namespace":
        """The `dt` namespace over the series."""
        return _Namespace(self, "dt")

    @property
    def str(self) -> "_Namespace":
        """The `str` namespace over the series."""
        return _Namespace(self, "str")

    @property
    def list(self) -> "_Namespace":
        """The `list` namespace over the series."""
        return _Namespace(self, "list")

    @property
    def struct(self) -> "_Namespace":
        """The `struct` namespace over the series (`unnest` gives a
        frame)."""
        return _Namespace(self, "struct")

    @property
    def bin(self) -> "_Namespace":
        """The `bin` namespace over the series."""
        return _Namespace(self, "bin")

    @property
    def arr(self) -> "_Namespace":
        """The `arr` namespace (fixed-width lists) over the series."""
        return _Namespace(self, "arr")

    @property
    def cat(self) -> "_Namespace":
        """The `cat` namespace over the series."""
        return _Namespace(self, "cat")

    def explode(self) -> "Series":
        """One row per list element (an empty or null list: one null)."""
        name = self.name or ""
        return self.to_frame(name).explode(name).get_column(name)

    def implode(self) -> "Series":
        """The whole series as one list row."""
        return self._apply(lambda c: c.implode())

    def alias(self, name: str) -> "Series":
        return Series._from_column(name, self._col, len(self))

    def to_frame(self, name: Optional[str] = None):
        """The series as a one-column frame."""
        from ..batch import Table
        from .frame import DataFrame
        name = name or self.name or ""
        return DataFrame._from_table(Table([name], {name: self._col},
                                           self._col.capacity, len(self)))

    def _agg(self, agg: str, **kw):
        """A reduction of the series, read back as a Python value."""
        from ..expr.expr import Expr, col
        e = Expr("agg", (col(self.name or ""),), agg=agg, **kw)
        return self.to_frame().select(e.alias("v")).to_dict()["v"][0]

    def sum(self):
        return self._agg("sum")

    def mean(self):
        return self._agg("mean")

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self._col.to_numpy(len(self)))

    def to_list(self) -> _ListT[Any]:
        return [_py(v) for v in self._col.to_numpy(len(self))]

    def __repr__(self) -> str:
        vals = self.to_list()
        more = "..." if len(vals) > 10 else ""
        return f"Series({self.name!r}, {vals[:10]}{more})"


class _Namespace:
    """`Expr.<ns>.<op>(...)` over a series, as a one-column frame."""

    def __init__(self, s: Series, ns: str):
        self._s = s
        self._ns = ns

    def __getattr__(self, op: str):
        if self._ns == "struct" and op == "unnest":
            name = self._s.name or ""
            return lambda: self._s.to_frame(name).unnest(name)

        def method(*args, **kwargs) -> Series:
            return self._s._apply(
                lambda c: getattr(getattr(c, self._ns), op)(*args, **kwargs))
        method.__name__ = op
        return method


def _window_method(name: str):
    def method(self, *args, **kwargs) -> "Series":
        return self._apply(lambda c: getattr(c, name)(*args, **kwargs))
    method.__name__ = name
    method.__doc__ = f"`Expr.{name}` over the series."
    return method


# the order-dependent expressions, as Series methods
for _name in ("shift", "diff", "pct_change", "cum_sum", "cum_min",
              "cum_max", "cum_prod", "cum_count", "rolling_sum",
              "rolling_mean", "rolling_min", "rolling_max", "rolling_std",
              "rolling_var", "rolling_median", "rolling_quantile",
              "rolling_skew", "rolling_kurtosis", "rolling_rank",
              "ewm_mean", "ewm_std", "ewm_var", "rank", "forward_fill",
              "backward_fill", "interpolate", "fill_null", "reverse",
              "rle_id", "peak_min", "peak_max", "arg_sort"):
    setattr(Series, _name, _window_method(_name))
del _name
