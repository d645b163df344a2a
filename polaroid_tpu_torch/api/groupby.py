"""GroupBy namespace (eager).

Parity target: `py-polars/src/polars/dataframe/group_by.py`. The eager
group-by runs the lazy plan of one group-by over the frame, so that it
takes the executor's integer-key stats pre-pass too: every method but
the iteration and `map_groups` is its `LazyGroupBy` method, collected.
"""

from __future__ import annotations

from typing import List

from ..expr import meta
from ..expr.expr import Expr


class GroupBy:
    def __init__(self, df, keys: List[Expr], maintain_order: bool = False,
                 having=None):
        self._df = df
        self._keys = keys
        self._maintain_order = maintain_order
        self._having = list(having) if having else []

    def _lazy(self):
        from .lazyframe import LazyGroupBy
        return LazyGroupBy(self._df.lazy(), self._keys, self._maintain_order,
                           having=self._having)

    def agg(self, *aggs, **named_aggs):
        return self._lazy().agg(*aggs, **named_aggs).collect()

    def having(self, *predicates) -> "GroupBy":
        """Keep only the groups whose aggregate predicates hold (applied
        after agg; reference: py-polars GroupBy.having)."""
        return GroupBy(self._df, self._keys, self._maintain_order,
                       having=self._having + list(predicates))

    def head(self, n: int = 5):
        """The first n rows of every group, in the frame's row order."""
        return self._lazy().head(n).collect()

    def tail(self, n: int = 5):
        return self._lazy().tail(n).collect()

    def all(self):
        """Every non-key column imploded per group."""
        return self._lazy().all().collect()

    def __iter__(self):
        """(key, sub-frame) pairs in the keys' first-occurrence order; a
        single key is the value itself, several are a tuple."""
        parts = self._df.partition_by(
            [meta.output_name(k) for k in self._keys], as_dict=True,
            maintain_order=True)
        yield from parts.items()

    def map_groups(self, function):
        """A DataFrame -> DataFrame function on every group, the results
        stacked (`concat(how="vertical_relaxed")`)."""
        from .functions import concat
        outs = [function(sub) for _, sub in self]
        if not outs:
            from .frame import DataFrame
            return DataFrame(device=self._df.device)
        return concat(outs, how="vertical_relaxed")

    apply = map_groups

    def len(self, name: str = "len"):
        return self._lazy().len(name).collect()

    def count(self):
        return self._lazy().count().collect()

    def sum(self):
        return self._lazy().sum().collect()

    def mean(self):
        return self._lazy().mean().collect()

    def min(self):
        return self._lazy().min().collect()

    def max(self):
        return self._lazy().max().collect()

    def first(self):
        return self._lazy().first().collect()

    def last(self):
        return self._lazy().last().collect()

    def median(self):
        return self._lazy().median().collect()

    def n_unique(self):
        return self._lazy().n_unique().collect()

    def quantile(self, q: float, interpolation: str = "nearest"):
        return self._lazy().quantile(q, interpolation).collect()
