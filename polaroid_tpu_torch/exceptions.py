"""The `pl.exceptions` namespace, as polars has it.

The port's copy of the JAX package's `exceptions.py`: polars surfaces
its errors as `polars.exceptions` (py-polars/src/polars/exceptions.py),
and users catch `pl.exceptions.ColumnNotFoundError` and the rest. This
module re-exports the port's errors (`errors.py`) under their names and
the polars aliases.
"""

from __future__ import annotations

from .errors import (
    ColumnNotFoundError,
    ComputeError,
    DuplicateError,
    InvalidOperationError,
    NoDataError,
    OutOfBoundsError,
    PolaroidError,
    SchemaError,
    ShapeError,
    SQLInterfaceError,
    SQLSyntaxError,
)

# the polars names
PolarsError = PolaroidError
SchemaFieldNotFoundError = ColumnNotFoundError
StructFieldNotFoundError = ColumnNotFoundError

__all__ = [
    "ColumnNotFoundError",
    "ComputeError",
    "DuplicateError",
    "InvalidOperationError",
    "NoDataError",
    "OutOfBoundsError",
    "PolaroidError",
    "PolarsError",
    "SchemaError",
    "SchemaFieldNotFoundError",
    "ShapeError",
    "SQLInterfaceError",
    "SQLSyntaxError",
    "StructFieldNotFoundError",
]
