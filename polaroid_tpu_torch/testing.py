"""Helpers for tests that hold the port against the JAX package."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .api.frame import DataFrame
from .batch import Column, Table, resolve_device
from .config import capacity_for
from .dtypes import String
from .strings import StringDict


def frame_from_numpy(columns: Dict[str, object],
                     validity: Optional[Dict[str, np.ndarray]] = None,
                     device=None, schema=None,
                     strings: Optional[Dict[str, StringDict]] = None
                     ) -> DataFrame:
    """The port's frame from the same host data a test hands to
    `polaroid_tpu.DataFrame`: numpy arrays (strings as Python lists),
    plus a non-null mask per nullable column. A column named in
    `strings` is a String column given as int32 codes into that sorted
    dictionary (no Python string is built). Without `device` the frame
    goes to the package default device."""
    if not strings:
        return DataFrame._from_table(Table.from_dict(
            columns, schema, device=device, validity=validity))
    device = resolve_device(device)
    n = len(next(iter(columns.values())))
    cap = capacity_for(n)
    cols = {}
    for k, v in columns.items():
        vm = (validity or {}).get(k)
        if k in strings:
            c = Column.from_host(np.asarray(v, dtype=np.int32), dtype=String,
                                 capacity=cap, device=device, validity=vm)
            c.sdict = strings[k]
        else:
            c = Column.from_host(v, dtype=(schema or {}).get(k),
                                 capacity=cap, device=device, validity=vm)
        cols[k] = c
    return DataFrame._from_table(Table(list(columns), cols, cap, n, None,
                                       device=device))
