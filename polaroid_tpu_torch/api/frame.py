"""Eager DataFrame (the subset the first slice needs).

Parity target: `py-polars/src/polars/dataframe/frame.py`, as in the JAX
package's `api/frame.py`: the eager API is a thin layer over the same
device ops the lazy engine uses. A frame lives on one device: the
package default (`Config.device`, "cuda") unless the caller passes
`device=`.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..batch import Column, Table, resolve_device
from ..config import capacity_for
from ..dtypes import DataType
from ..errors import ComputeError, DuplicateError
from ..expr import meta
from ..expr.eval import eval_expr, val_to_column
from ..expr.expr import Expr, col as _col
from ..ops import compact as C
from .series import Series, _py


def _to_exprs(args, kwargs=None) -> List[Expr]:
    flat = []

    def rec(a):
        if isinstance(a, (list, tuple)):
            for x in a:
                rec(x)
        elif isinstance(a, Expr):
            flat.append(a)
        elif isinstance(a, str):
            flat.append(_col(a))
        else:
            from ..expr.expr import lit
            flat.append(lit(a))
    for a in args:
        rec(a)
    for name, a in (kwargs or {}).items():
        e = _to_exprs([a])[0]
        flat.append(e.alias(name))
    return flat


class DataFrame:
    def __init__(self, data=None, schema=None, device=None):
        if isinstance(data, Table):
            self._table = data
            return
        if isinstance(data, DataFrame):
            self._table = data._table
            return
        if data is None:
            data = {}
        if not isinstance(data, dict):
            raise ComputeError(
                f"cannot construct DataFrame from {type(data)}; the port "
                "takes a dict of numpy arrays or lists")
        self._table = Table.from_dict(
            data, schema if isinstance(schema, dict) else None,
            device=resolve_device(device))

    @classmethod
    def _from_table(cls, t: Table) -> "DataFrame":
        df = cls.__new__(cls)
        df._table = t
        return df

    # --- introspection --------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self._table.device

    @property
    def height(self) -> int:
        return self._table.count_rows()

    @property
    def width(self) -> int:
        return self._table.width

    @property
    def shape(self):
        return (self.height, self.width)

    @property
    def columns(self) -> List[str]:
        return list(self._table.names)

    @property
    def schema(self) -> Dict[str, DataType]:
        return self._table.schema

    @property
    def dtypes(self) -> List[DataType]:
        return [self._table.cols[n].dtype for n in self._table.names]

    def __len__(self) -> int:
        return self.height

    def __repr__(self) -> str:
        return f"DataFrame{self.shape} on {self.device}: " + \
            ", ".join(f"{k}: {v!r}" for k, v in self.schema.items())

    # --- expression contexts --------------------------------------------
    def select(self, *exprs, **named_exprs) -> "DataFrame":
        es = meta.expand_exprs(_to_exprs(exprs, named_exprs), self.schema)
        t = self._table
        results = []
        for e in es:
            name = meta.output_name(e)
            if e.kind == "col" and e.attrs["name"] in t.cols:
                # bare column: pass the Column object through (keeps stats)
                results.append((name, t.cols[name], False))
                continue
            v = eval_expr(e, t, "select")
            results.append((name, v, v.is_scalar))
        if not results:
            return DataFrame._from_table(
                Table([], {}, capacity_for(0), 0, None, device=t.device))
        any_row = any(not s for _, _, s in results)
        cap = t.capacity if any_row else capacity_for(1)
        names, cols = [], {}
        for name, v, _ in results:
            if name in cols:
                raise DuplicateError(f"duplicate column name {name!r}")
            names.append(name)
            cols[name] = v if isinstance(v, Column) \
                else val_to_column(v, cap)
        if any_row:
            return DataFrame._from_table(Table(
                names, cols, cap, t._nrows, t.valid, nrows_dev=t.nrows_dev,
                device=t.device))
        return DataFrame._from_table(Table(names, cols, cap, 1, None,
                                           device=t.device))

    def with_columns(self, *exprs, **named_exprs) -> "DataFrame":
        es = meta.expand_exprs(_to_exprs(exprs, named_exprs), self.schema)
        t = self._table
        for e in es:
            v = eval_expr(e, t, "select")
            t = t.with_column(meta.output_name(e),
                              val_to_column(v, t.capacity))
        return DataFrame._from_table(t)

    def filter(self, *predicates, **constraints) -> "DataFrame":
        """Mask the rows: no compaction and no host sync here; collect()
        or a host read compacts."""
        preds = _to_exprs(predicates)
        for k, v in constraints.items():
            preds.append(_col(k) == v)
        t = self._table
        mask = t.row_mask()
        for p in preds:
            v = eval_expr(p, t, "filter")
            if not v.dtype.is_bool:
                raise ComputeError(
                    f"filter predicate must be Boolean, got {v.dtype!r}")
            mask = mask & (v.data & v.valid_or_true()).expand(t.capacity)
        return DataFrame._from_table(t.with_valid(mask, None))

    # --- row ops --------------------------------------------------------
    def head(self, n: int = 5) -> "DataFrame":
        return DataFrame._from_table(C.slice_rows(self._table, 0, max(n, 0)))

    def sort(self, by, *more_by, descending: bool = False) -> "DataFrame":
        """Sort by key columns ON THE HOST, nulls first (stable). A
        convenience for comparing results; the device sort comes with
        Slice B of the port."""
        t = C.compact(self._table)
        n = t.count_rows()
        keys = meta.expand_exprs(_to_exprs((by,) + more_by), self.schema)
        sort_keys = []
        for e in keys:
            v = eval_expr(e, t, "select")
            x = v.data.expand(t.capacity)[:n].cpu().numpy()
            valid = v.valid_or_true().expand(t.capacity)[:n].cpu().numpy()
            rank = np.unique(x, return_inverse=True)[1].reshape(-1)
            rank = np.where(valid, -rank if descending else rank, 0)
            # nulls first: the validity is the more significant key
            sort_keys += [valid, rank]
        # np.lexsort's last key is the most significant
        order = np.lexsort(sort_keys[::-1]) if sort_keys else np.arange(n)
        perm = torch.arange(t.capacity, device=t.device)
        perm[:n] = torch.from_numpy(order).to(t.device)
        return DataFrame._from_table(C.gather_table(t, perm, n, None))

    # --- relational ops -------------------------------------------------
    def group_by(self, *by, maintain_order: bool = False, **named_by):
        from .groupby import GroupBy
        return GroupBy(self, _to_exprs(by, named_by), maintain_order)

    def lazy(self):
        from .lazyframe import LazyFrame
        return LazyFrame._from_table(self._table)

    # --- conversion ------------------------------------------------------
    def get_column(self, name: str) -> Series:
        t = C.compact(self._table)
        return Series._from_column(name, t.column(name), t.count_rows())

    def to_dict(self, as_series: bool = False) -> Dict[str, Any]:
        d = self._table.to_numpy_dict()
        if as_series:
            return {k: self.get_column(k) for k in d}
        return {k: [_py(x) for x in v] for k, v in d.items()}

    def to_numpy(self) -> np.ndarray:
        d = self._table.to_numpy_dict()
        return np.column_stack([np.asarray(v) for v in d.values()]) \
            if d else np.zeros((0, 0))
