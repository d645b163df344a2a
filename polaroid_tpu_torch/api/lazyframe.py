"""LazyFrame: deferred query construction (the subset the first slice
needs).

Parity target: `py-polars/src/polars/lazyframe/frame.py`, as in the JAX
package's `api/lazyframe.py`: builds the logical plan
(`plan/logical.py`), runs the optimizer, then the in-memory executor,
and compacts the result on the device.
"""

from __future__ import annotations

from typing import Dict, List

from ..expr.expr import Expr, col as _col
from ..plan import logical as L
from ..plan.optimizer import optimize


def _to_exprs(args, kwargs=None) -> List[Expr]:
    from .frame import _to_exprs as f
    return f(args, kwargs)


class LazyFrame:
    def __init__(self, data=None, schema=None, device=None):
        from .frame import DataFrame
        self._plan = L.DataFrameScan(
            DataFrame(data, schema=schema, device=device)._table)

    @classmethod
    def _from_plan(cls, plan: L.Plan) -> "LazyFrame":
        lf = cls.__new__(cls)
        lf._plan = plan
        return lf

    @classmethod
    def _from_table(cls, table) -> "LazyFrame":
        return cls._from_plan(L.DataFrameScan(table))

    # --- introspection --------------------------------------------------
    @property
    def columns(self) -> List[str]:
        return list(self._plan.schema().keys())

    @property
    def schema(self) -> Dict[str, object]:
        return dict(self._plan.schema())

    def explain(self, optimized: bool = True) -> str:
        p = optimize(self._plan) if optimized else self._plan
        return p.describe()

    def __repr__(self) -> str:
        return f"<LazyFrame at 0x{id(self):x}>\n{self._plan.describe()}"

    # --- plan constructors ------------------------------------------------
    def select(self, *exprs, **named) -> "LazyFrame":
        return LazyFrame._from_plan(
            L.Select(self._plan, _to_exprs(exprs, named)))

    def with_columns(self, *exprs, **named) -> "LazyFrame":
        return LazyFrame._from_plan(
            L.WithColumns(self._plan, _to_exprs(exprs, named)))

    def filter(self, *predicates, **constraints) -> "LazyFrame":
        preds = _to_exprs(predicates)
        for k, v in constraints.items():
            preds.append(_col(k) == v)
        pred = preds[0]
        for p in preds[1:]:
            pred = pred & p
        return LazyFrame._from_plan(L.Filter(self._plan, pred))

    def group_by(self, *by, maintain_order: bool = False, **named_by):
        return LazyGroupBy(self, _to_exprs(by, named_by), maintain_order)

    def sort(self, by, *more_by, descending=False,
             nulls_last=False) -> "LazyFrame":
        """A sort node; the optimizer removes it where the input is
        already in that order (a group-by's key order). Any other sort
        comes with Slice B of the port."""
        keys = _to_exprs((by,) + more_by)
        nk = len(keys)
        desc = list(descending) if isinstance(descending, (list, tuple)) \
            else [descending] * nk
        nl = list(nulls_last) if isinstance(nulls_last, (list, tuple)) \
            else [nulls_last] * nk
        return LazyFrame._from_plan(L.Sort(self._plan, keys, desc, nl))

    def head(self, n: int = 5) -> "LazyFrame":
        return LazyFrame._from_plan(L.Slice(self._plan, 0, n))

    def lazy(self) -> "LazyFrame":
        return self

    # --- execution ------------------------------------------------------
    def collect(self):
        """Run the plan; the result's live rows are compacted on the
        device and its row count stays there until the host reads it."""
        from .frame import DataFrame
        from ..exec.executor import execute
        from ..ops.compact import compact
        self._plan.schema()  # validate names/dtypes before pushdowns
        return DataFrame._from_table(compact(execute(optimize(self._plan))))


class LazyGroupBy:
    def __init__(self, lf: LazyFrame, keys: List[Expr],
                 maintain_order: bool):
        self._lf = lf
        self._keys = keys
        self._maintain_order = maintain_order

    def agg(self, *aggs, **named) -> LazyFrame:
        return LazyFrame._from_plan(
            L.GroupBy(self._lf._plan, self._keys, _to_exprs(aggs, named),
                      self._maintain_order))
