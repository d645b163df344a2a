"""Top-level frame constructors (the subset the first slice needs;
parity target: `py-polars/src/polars/functions/`). `col`, `lit` and
`len` live in `expr/expr.py`, as in the JAX package."""

from __future__ import annotations


def from_dict(data, schema=None, device=None):
    from .frame import DataFrame
    return DataFrame(data, schema=schema, device=device)
