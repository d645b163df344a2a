"""Helpers for tests that hold the port against the JAX package."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .api.frame import DataFrame
from .batch import Table


def frame_from_numpy(columns: Dict[str, object],
                     validity: Optional[Dict[str, np.ndarray]] = None,
                     device=None, schema=None) -> DataFrame:
    """The port's frame from the same host data a test hands to
    `polaroid_tpu.DataFrame`: numpy arrays (strings as Python lists),
    plus a non-null mask per nullable column. Without `device` the frame
    goes to the package default device."""
    return DataFrame._from_table(
        Table.from_dict(columns, schema, device=device, validity=validity))
