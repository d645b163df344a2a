"""Lazily-evaluated datatype expressions.

Capability analogue of the reference's DataTypeExpr
(`py-polars/src/polars/datatype_expr/datatype_expr.py:30`,
`py-polars/src/polars/functions/datatype.py`): a dtype that resolves
against a schema at plan/eval time, usable anywhere a concrete DataType
is accepted (`Expr.cast`, `map_batches(return_dtype=...)`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from .dtypes import DataType, Struct

__all__ = ["DataTypeExpr", "dtype_of", "self_dtype", "struct_with_fields"]


def _norm(d):
    if isinstance(d, type) and issubclass(d, DataType):
        return d()
    return d


class DataTypeExpr:
    """A DataType resolved lazily against the frame schema."""

    def __init__(self, resolver: Callable[[Dict[str, DataType],
                                           Optional[DataType]], DataType],
                 label: str = "dtype_expr"):
        self._resolver = resolver
        self._label = label

    def collect_dtype(self, context) -> DataType:
        """Resolve against a schema mapping (or an object with .schema)."""
        schema = context if isinstance(context, dict) \
            else dict(context.schema)
        return self._resolve(schema, None)

    def _resolve(self, schema: Dict[str, DataType],
                 self_dtype: Optional[DataType]) -> DataType:
        return self._resolver(schema, self_dtype)

    def __repr__(self):
        return f"DataTypeExpr[{self._label}]"

    # dtype-namespace sugar mirrored from the reference (list/arr/struct
    # accessors) resolves eagerly through the same resolver
    def inner_dtype(self) -> "DataTypeExpr":
        def r(schema, sd):
            dt = self._resolve(schema, sd)
            return getattr(dt, "inner", dt)
        return DataTypeExpr(r, f"{self._label}.inner")


def dtype_of(col_or_expr) -> DataTypeExpr:
    """Lazily get the dtype of a column or expression (reference:
    `py-polars/src/polars/functions/datatype.py:18`)."""
    if isinstance(col_or_expr, str):
        name = col_or_expr

        def r(schema, _sd):
            from .errors import ColumnNotFoundError
            if name not in schema:
                raise ColumnNotFoundError(name)
            return schema[name]

        return DataTypeExpr(r, f"dtype_of({name!r})")

    expr = col_or_expr

    def r(schema, _sd):
        from .expr import meta
        return meta.output_dtype(expr, schema)

    return DataTypeExpr(r, "dtype_of(<expr>)")


def self_dtype() -> DataTypeExpr:
    """The dtype of `self` inside map_elements/map_batches (reference:
    `py-polars/src/polars/functions/datatype.py:80`)."""

    def r(_schema, sd):
        if sd is None:
            from .errors import InvalidOperationError
            raise InvalidOperationError(
                "self_dtype() is only usable as return_dtype of "
                "map_elements/map_batches")
        return sd

    return DataTypeExpr(r, "self_dtype()")


def struct_with_fields(mapping) -> DataTypeExpr:
    """A Struct dtype whose field dtypes may themselves be lazy
    (reference: `py-polars/src/polars/functions/datatype.py:94`)."""

    def r(schema, sd):
        fields = []
        for name, d in dict(mapping).items():
            if isinstance(d, DataTypeExpr):
                d = d._resolve(schema, sd)
            fields.append((name, _norm(d)))
        return Struct(fields)

    return DataTypeExpr(r, "struct_with_fields")


def resolve_dtype(d, schema: Dict[str, DataType],
                  self_dt: Optional[DataType] = None):
    """Resolve `d` if it is a DataTypeExpr; pass through otherwise."""
    if isinstance(d, DataTypeExpr):
        return d._resolve(schema, self_dt)
    return _norm(d)
