"""Series: a named single column.

Parity target: `py-polars/src/polars/series/`, as in the JAX package's
`api/series.py`: a view and conversion type over one `Column`. Its
computing methods are expressions evaluated over the series as a
one-column frame, so they run where the frame's do; an `Expr` method
that the class does not name is reached the same way (`__getattr__`).
"""

from __future__ import annotations

import math
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

    def min(self):
        return self._agg("min")

    def max(self):
        return self._agg("max")

    def median(self):
        return self._agg("median")

    def std(self, ddof: int = 1):
        return self._agg("std", ddof=ddof)

    def var(self, ddof: int = 1):
        return self._agg("var", ddof=ddof)

    def n_unique(self):
        return self._agg("n_unique")

    def null_count(self):
        return self._agg("null_count")

    def count(self):
        return self._agg("count")

    def first(self):
        return self._agg("first")

    def last(self):
        return self._agg("last")

    def quantile(self, q: float, interpolation: str = "nearest"):
        return self._agg("quantile", q=q, interpolation=interpolation)

    def arg_min(self):
        return self._agg("arg_min")

    def arg_max(self):
        return self._agg("arg_max")

    def entropy(self, base: float = math.e, normalize: bool = True):
        return self._agg("entropy", base=base, normalize=normalize)

    def mode(self) -> "Series":
        from ..expr.expr import Expr
        return self._apply(lambda c: Expr("agg", (c,), agg="mode"))

    def dot(self, other: "Series"):
        return self._with(other, lambda c, o: (c * o).sum()).item()

    def to_pandas(self):
        import pandas as pd
        return pd.Series(self.to_list(), name=self.name or "")

    def to_arrow(self):
        import pyarrow as pa
        return pa.array(self.to_list())

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self._col.to_numpy(len(self)))

    def to_list(self) -> _ListT[Any]:
        return [_py(v) for v in self._col.to_numpy(len(self))]

    def __repr__(self) -> str:
        vals = self.head(10).to_list()
        more = "..." if len(self) > 10 else ""
        return f"Series({self.name!r}, {vals}{more})"

    # --- the rest of the series surface ------------------------------------
    def _with(self, other: "Series", make_expr) -> "Series":
        """make_expr(col, other col) over this series and `other` side by
        side."""
        from ..expr.expr import col
        name = self.name or ""
        df = self.to_frame(name).hstack(other.to_frame("__pt_rhs"))
        return df.select(make_expr(col(name), col("__pt_rhs")).alias(name)) \
            .get_column(name)

    def _bin(self, other, op: str) -> "Series":
        from ..expr.expr import Expr, lit
        if isinstance(other, Series):
            return self._with(other, lambda c, o: Expr("binary", (c, o),
                                                       op=op))
        return self._apply(lambda c: Expr("binary", (c, lit(other)), op=op))

    def __add__(self, o):
        return self._bin(o, "add")

    def __sub__(self, o):
        return self._bin(o, "sub")

    def __mul__(self, o):
        return self._bin(o, "mul")

    def __truediv__(self, o):
        return self._bin(o, "truediv")

    def __floordiv__(self, o):
        return self._bin(o, "floordiv")

    def __mod__(self, o):
        return self._bin(o, "mod")

    def __lt__(self, o):
        return self._bin(o, "lt")

    def __le__(self, o):
        return self._bin(o, "le")

    def __gt__(self, o):
        return self._bin(o, "gt")

    def __ge__(self, o):
        return self._bin(o, "ge")

    def __neg__(self):
        return self._apply(lambda c: -c)

    def __eq__(self, other):
        if isinstance(other, Series):
            return self.to_list() == other.to_list()
        return NotImplemented

    def __ne__(self, other):
        if isinstance(other, Series):
            return self.to_list() != other.to_list()
        return NotImplemented

    def __hash__(self):
        return id(self)

    def __getitem__(self, i):
        if isinstance(i, int):
            return self.item(i)
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step == 1:
                return self.slice(start, max(stop - start, 0))
            return self.gather(list(range(start, stop, step)))
        raise TypeError(i)

    def __iter__(self):
        return iter(self.to_list())

    @property
    def device(self):
        return self._col.device

    def len(self) -> int:
        return len(self)

    def is_empty(self) -> bool:
        return len(self) == 0

    def item(self, index: int = 0):
        if index < 0:
            index += len(self)
        return self.slice(index, 1).to_list()[0]

    def rename(self, name: str) -> "Series":
        return Series._from_column(name, self._col, len(self))

    def clone(self) -> "Series":
        return Series._from_column(self.name, self._col, len(self))

    def cast(self, dtype, strict: bool = True) -> "Series":
        return self._apply(lambda c: c.cast(dtype, strict=strict))

    def to_physical(self) -> "Series":
        return self._apply(lambda c: c.to_physical())

    def has_nulls(self) -> bool:
        return self.null_count() > 0

    def has_validity(self) -> bool:
        return self._col.validity is not None

    def is_sorted(self, descending: bool = False) -> bool:
        """Whether the non-null values are in order (compared on the
        device; a String's codes are in the dictionary's sorted order)."""
        s = self.drop_nulls()
        x = s._col.data[:len(s)]
        ok = x[1:] <= x[:-1] if descending else x[1:] >= x[:-1]
        return bool(ok.all())

    def equals(self, other: "Series", *, check_dtypes: bool = False,
               check_names: bool = False, null_equal: bool = True) -> bool:
        if check_dtypes and self.dtype != other.dtype:
            return False
        if check_names and self.name != other.name:
            return False
        return self.to_list() == other.to_list()

    series_equal = equals

    # row selection
    def head(self, n: int = 10) -> "Series":
        return self.to_frame().head(n).get_column(self.name or "")

    def tail(self, n: int = 10) -> "Series":
        return self.to_frame().tail(n).get_column(self.name or "")

    def limit(self, n: int = 10) -> "Series":
        return self.head(n)

    def slice(self, offset: int, length: Optional[int] = None) -> "Series":
        return self.to_frame().slice(offset, length) \
            .get_column(self.name or "")

    def filter(self, mask) -> "Series":
        from ..expr.expr import col
        if not isinstance(mask, Series):
            raise TypeError("filter expects a boolean Series")
        name = self.name or ""
        df = self.to_frame(name).hstack(mask.to_frame("__pt_mask"))
        return df.filter(col("__pt_mask")).get_column(name)

    def gather(self, indices) -> "Series":
        """The values at `indices` (one gather on the device)."""
        import torch
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64)
                              ).to(self._col.device)
        n = idx.shape[0]
        from ..config import capacity_for
        cap = capacity_for(n)
        idx = torch.cat([idx, idx.new_zeros(cap - n)])
        return Series._from_column(self.name, self._col.take(idx), n)

    def gather_every(self, n: int, offset: int = 0) -> "Series":
        return self._apply(lambda c: c.gather_every(n, offset))

    def drop_nulls(self) -> "Series":
        return self._apply(lambda c: c.drop_nulls())

    def drop_nans(self) -> "Series":
        return self._apply(lambda c: c.filter(c.is_not_nan().fill_null(True)))

    def sample(self, n: Optional[int] = None, *, fraction=None,
               with_replacement: bool = False, shuffle: bool = False,
               seed=None) -> "Series":
        return self.to_frame().sample(
            n, fraction=fraction, with_replacement=with_replacement,
            shuffle=shuffle, seed=seed).get_column(self.name or "")

    def shuffle(self, seed=None) -> "Series":
        return self.sample(fraction=1.0, shuffle=True, seed=seed)

    def unique(self, maintain_order: bool = False) -> "Series":
        return self.to_frame().unique(maintain_order=maintain_order) \
            .get_column(self.name or "")

    # values
    def abs(self) -> "Series":
        return self._apply(lambda c: c.abs())

    def sqrt(self) -> "Series":
        return self._apply(lambda c: c.sqrt())

    def exp(self) -> "Series":
        return self._apply(lambda c: c.exp())

    def log(self, base: float = math.e) -> "Series":
        return self._apply(lambda c: c.log(base))

    def round(self, decimals: int = 0) -> "Series":
        return self._apply(lambda c: c.round(decimals))

    def clip(self, lower_bound=None, upper_bound=None) -> "Series":
        return self._apply(lambda c: c.clip(lower_bound, upper_bound))

    def is_null(self) -> "Series":
        return self._apply(lambda c: c.is_null())

    def is_not_null(self) -> "Series":
        return self._apply(lambda c: c.is_not_null())

    def search_sorted(self, element, side: str = "any"):
        out = self._apply(lambda c: c.search_sorted(element, side))
        return out.item() if not hasattr(element, "__len__") else out

    def zip_with(self, mask: "Series", other: "Series") -> "Series":
        from ..expr.expr import col, when
        name = self.name or ""
        df = self.to_frame(name).hstack(mask.to_frame("__pt_m")) \
            .hstack(other.to_frame("__pt_o"))
        return df.select(when(col("__pt_m")).then(col(name))
                         .otherwise(col("__pt_o")).alias(name)) \
            .get_column(name)

    def set(self, filter_mask: "Series", value) -> "Series":
        """`value` where the mask holds."""
        from ..expr.expr import col, lit, when
        name = self.name or ""
        df = self.to_frame(name).hstack(filter_mask.to_frame("__pt_m"))
        return df.select(when(col("__pt_m").fill_null(False))
                         .then(lit(value)).otherwise(col(name))
                         .cast(self.dtype).alias(name)).get_column(name)

    def scatter(self, indices, values) -> "Series":
        """`values` written at `indices` (an index_put on the device; a
        String series is rebuilt on the host, where its dictionary is)."""
        import torch
        idx = np.atleast_1d(np.asarray(indices, dtype=np.int64))
        vals = values.to_list() if isinstance(values, Series) else (
            list(values) if hasattr(values, "__len__") and
            not isinstance(values, str) else [values] * len(idx))
        if self.dtype.is_string or self._col.is_nested or \
                any(v is None for v in vals):
            lst = self.to_list()
            for i, v in zip(idx, vals):
                lst[int(i)] = v
            return Series(self.name, lst, dtype=self.dtype,
                          device=self._col.device)
        src = Series("", vals, dtype=self.dtype, device=self._col.device)
        ti = torch.as_tensor(idx).to(self._col.device)
        data = self._col.data.clone()
        data[ti] = src._col.data[:len(idx)]
        validity = None
        if self._col.validity is not None:
            validity = self._col.validity.clone()
            validity[ti] = True
        return Series._from_column(
            self.name, Column(self.dtype, data, validity, self._col.sdict),
            len(self))

    def append(self, other: "Series") -> "Series":
        from ..ops.concat import vstack_tables
        name = self.name or ""
        t = vstack_tables([self.to_frame(name)._table,
                           other.to_frame(name)._table])
        return Series._from_column(self.name, t.cols[name], t.count_rows())

    def extend(self, other: "Series") -> "Series":
        """Append `other`'s values in place."""
        out = self.append(other)
        self._col, self._len = out._col, out._len
        return self

    def extend_constant(self, value, n: int) -> "Series":
        return self._apply(lambda c: c.extend_constant(value, n))

    def new_from_index(self, index: int, length: int) -> "Series":
        return Series(self.name, [self.item(index)] * length,
                      dtype=self.dtype, device=self._col.device)

    def map_elements(self, function, return_dtype=None, *,
                     skip_nulls: bool = True) -> "Series":
        return self._apply(lambda c: c.map_elements(
            function, return_dtype=return_dtype, skip_nulls=skip_nulls))

    def reshape(self, dimensions) -> "Series":
        dims = tuple(dimensions)
        if len(dims) != 2:
            from ..errors import InvalidOperationError
            raise InvalidOperationError("reshape supports 2 dimensions")
        lst = self.to_list()
        k = int(dims[1])
        return Series(self.name, [lst[i:i + k] for i in range(0, len(lst), k)],
                      device=self._col.device)

    # summaries
    def value_counts(self, *, sort: bool = False, name: str = "count"):
        """A frame of each distinct value and its count: by count, largest
        first, with `sort`, else by value."""
        from ..expr.expr import Expr
        n = self.name or ""
        out = self.to_frame(n).group_by(n).agg(Expr("table_len").alias(name))
        return out.sort(name, descending=True) if sort else out.sort(n)

    def unique_counts(self) -> "Series":
        """The count of each distinct value, in order of first sight."""
        from ..expr.expr import Expr
        n = self.name or ""
        return self.to_frame(n).group_by(n, maintain_order=True).agg(
            Expr("table_len").alias("count")).get_column("count").alias(n)

    def hist(self, bins=None, *, bin_count: Optional[int] = None):
        """A frame of each bin's right edge and count (`Expr.hist`: kernel
        A counts the bins)."""
        name = self.name or ""
        out = self._apply(lambda c: c.hist(bins, bin_count=bin_count,
                                           include_breakpoint=True))
        return out.to_frame(name).unnest(name)

    def to_dummies(self, separator: str = "_", drop_first: bool = False):
        return self.to_frame().to_dummies(separator=separator,
                                          drop_first=drop_first)

    def describe(self):
        return self.to_frame().describe()

    # conversion and storage
    def to_torch(self):
        """The values as a tensor on the series' device."""
        return self._col.data[:len(self)]

    def to_init_repr(self, n: int = 1000) -> str:
        return (f'pl.Series("{self.name}", {self.head(n).to_list()!r}, '
                f"dtype=pl.{self.dtype!r})")

    def estimated_size(self, unit: str = "b"):
        c = self._col
        total = sum(x.numel() * x.element_size() for x in
                    (c.data, c.validity, c.lengths, c.elem_valid)
                    if x is not None)
        div = {"b": 1, "kb": 1024, "mb": 1024 ** 2, "gb": 1024 ** 3}[unit]
        return total / div if div > 1 else int(total)

    def clear(self, n: int = 0) -> "Series":
        return Series(self.name, [None] * n, dtype=self.dtype,
                      device=self._col.device)

    def chunk_lengths(self):
        return [len(self)]

    def get_chunks(self):
        return [self]

    def n_chunks(self) -> int:
        return 1

    def rechunk(self, in_place: bool = False) -> "Series":
        return self if in_place else self.clone()

    def shrink_to_fit(self, in_place: bool = False) -> "Series":
        return self if in_place else self.clone()

    @property
    def flags(self) -> dict:
        return {"SORTED_ASC": False, "SORTED_DESC": False}

    @property
    def ext(self) -> "_Namespace":
        """The `ext` namespace (extension dtypes) over the series."""
        return _Namespace(self, "ext")

    @property
    def plot(self):
        raise ModuleNotFoundError(
            "plotting requires altair, which is not bundled")

    def __getattr__(self, attr):
        """An `Expr` method the class does not name, over the series; a
        reduction comes back as a Python value."""
        from ..expr.expr import Expr
        target = getattr(Expr, attr, None) if not attr.startswith("_") \
            else None
        if target is None or not callable(target):
            raise AttributeError(
                f"'Series' object has no attribute {attr!r}")

        def method(*args, **kwargs):
            from ..expr import meta
            from ..expr.expr import col
            name = self.name or ""
            frame = self.to_frame(name)
            extra = []

            def wrap(a):
                nonlocal frame
                if isinstance(a, Series):
                    cn = f"__pt_arg{len(extra)}"
                    extra.append(cn)
                    frame = frame.hstack(a.to_frame(cn))
                    return col(cn)
                return a
            e = target(col(name), *[wrap(a) for a in args],
                       **{k: wrap(v) for k, v in kwargs.items()})
            if not isinstance(e, Expr):
                return e
            out = frame.select(e.alias(name)).get_column(name)
            if meta.is_scalar_expr(e) and attr not in ("implode",
                                                       "agg_groups"):
                return out.item() if len(out) else None
            return out
        method.__name__ = attr
        return method


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
