"""Series: a named single column (the subset the first slice needs).

Parity target: `py-polars/src/polars/series/`, as in the JAX package's
`api/series.py`: a view and conversion type over one `Column`.
"""

from __future__ import annotations

from typing import Any, List, Optional

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

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self._col.to_numpy(len(self)))

    def to_list(self) -> List[Any]:
        return [_py(v) for v in self._col.to_numpy(len(self))]

    def __repr__(self) -> str:
        vals = self.to_list()
        more = "..." if len(vals) > 10 else ""
        return f"Series({self.name!r}, {vals[:10]}{more})"
