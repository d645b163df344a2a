"""Error types for polaroid-tpu.

Mirrors the reference's error taxonomy (`polars-error/src/lib.rs`:
ColumnNotFound, SchemaMismatch, ComputeError, InvalidOperation,
ShapeMismatch, Duplicate, OutOfBounds) without copying its machinery.
Error *strategy* env vars (PT_PANIC_ON_ERR analogue of POLARS_PANIC_ON_ERR)
are handled in `config.py`.
"""

from __future__ import annotations


class PolaroidError(Exception):
    """Base class for all engine errors."""


class ColumnNotFoundError(PolaroidError, KeyError):
    def __str__(self) -> str:  # KeyError quotes its message otherwise
        return self.args[0] if self.args else ""


class SchemaError(PolaroidError):
    pass


class ShapeError(PolaroidError):
    pass


class ComputeError(PolaroidError):
    pass


class InvalidOperationError(PolaroidError):
    pass


class DuplicateError(PolaroidError):
    pass


class OutOfBoundsError(PolaroidError, IndexError):
    pass


class NoDataError(PolaroidError):
    pass


class SQLSyntaxError(PolaroidError):
    pass


class SQLInterfaceError(PolaroidError):
    pass
