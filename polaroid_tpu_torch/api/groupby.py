"""GroupBy namespace (eager).

Parity target: `py-polars/src/polars/dataframe/group_by.py`. The eager
group-by runs the lazy plan of one group-by over the frame, so that it
takes the executor's integer-key stats pre-pass too.
"""

from __future__ import annotations

from typing import List

from ..expr.expr import Expr


class GroupBy:
    def __init__(self, df, keys: List[Expr], maintain_order: bool = False):
        self._df = df
        self._keys = keys
        self._maintain_order = maintain_order

    def agg(self, *aggs, **named_aggs):
        return self._df.lazy().group_by(
            self._keys, maintain_order=self._maintain_order).agg(
                *aggs, **named_aggs).collect()
