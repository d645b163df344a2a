"""Test helpers (`pl.testing`): the frame and series assertions, and
frames built from host data for tests that hold the port against the
JAX package.

The assertions are the JAX package's `testing.py` (the analogue of the
reference's polars-testing crate, `crates/polars-testing/src/asserts/
mod.rs`). They read both sides through `to_dict`/`to_list`, `columns`,
`schema` and `name`, so either side may be a frame or series of the JAX
package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from .api.frame import DataFrame
from .batch import Column, Table, resolve_device
from .config import capacity_for
from .dtypes import String
from .strings import StringDict

__all__ = ["assert_frame_equal", "assert_frame_not_equal",
           "assert_series_equal", "assert_series_not_equal",
           "frame_from_numpy"]


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


def _vals_close(a, b, *, check_exact: bool, rtol: float, atol: float) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(
            _vals_close(x, y, check_exact=check_exact, rtol=rtol, atol=atol)
            for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(
            _vals_close(a[k], b[k], check_exact=check_exact, rtol=rtol,
                        atol=atol) for k in a)
    if isinstance(a, float) or isinstance(b, float):
        if isinstance(a, float) and isinstance(b, float) \
                and math.isnan(a) and math.isnan(b):
            return True
        if check_exact:
            return a == b
        try:
            return math.isclose(float(a), float(b), rel_tol=rtol,
                                abs_tol=atol)
        except (TypeError, ValueError):
            return a == b
    return a == b


def assert_series_equal(left, right, *, check_dtypes: bool = True,
                        check_names: bool = True, check_exact: bool = False,
                        rtol: float = 1e-5, atol: float = 1e-8,
                        check_order: bool = True) -> None:
    if check_names and (left.name or "") != (right.name or ""):
        raise AssertionError(
            f"Series name mismatch: {left.name!r} != {right.name!r}")
    if check_dtypes and repr(left.dtype) != repr(right.dtype):
        raise AssertionError(
            f"Series dtype mismatch: {left.dtype!r} != {right.dtype!r}")
    lv, rv = left.to_list(), right.to_list()
    if not check_order:
        lv = sorted(lv, key=lambda x: (x is None, x))
        rv = sorted(rv, key=lambda x: (x is None, x))
    if len(lv) != len(rv):
        raise AssertionError(
            f"Series length mismatch: {len(lv)} != {len(rv)}")
    for i, (a, b) in enumerate(zip(lv, rv)):
        if not _vals_close(a, b, check_exact=check_exact, rtol=rtol,
                           atol=atol):
            raise AssertionError(
                f"Series values differ at index {i}: {a!r} != {b!r}")


def assert_series_not_equal(left, right, **kw) -> None:
    try:
        assert_series_equal(left, right, **kw)
    except AssertionError:
        return
    raise AssertionError("Series are equal (expected not equal)")


def assert_frame_equal(left, right, *, check_dtypes: bool = True,
                       check_column_order: bool = True,
                       check_row_order: bool = True,
                       check_exact: bool = False,
                       rtol: float = 1e-5, atol: float = 1e-8) -> None:
    lcols, rcols = list(left.columns), list(right.columns)
    if check_column_order:
        if lcols != rcols:
            raise AssertionError(
                f"column order/name mismatch: {lcols} != {rcols}")
    elif set(lcols) != set(rcols):
        raise AssertionError(f"column set mismatch: {lcols} != {rcols}")
    if left.height != right.height:
        raise AssertionError(
            f"height mismatch: {left.height} != {right.height}")
    ld, rd = left.to_dict(), right.to_dict()
    if not check_row_order:
        order_l = sorted(range(left.height),
                         key=lambda i: tuple(
                             (ld[c][i] is None, ld[c][i]) for c in lcols))
        order_r = sorted(range(right.height),
                         key=lambda i: tuple(
                             (rd[c][i] is None, rd[c][i]) for c in lcols))
        ld = {c: [ld[c][i] for i in order_l] for c in lcols}
        rd = {c: [rd[c][i] for i in order_r] for c in lcols}
    for c in lcols:
        if check_dtypes and repr(left.schema[c]) != repr(right.schema[c]):
            raise AssertionError(
                f"dtype mismatch in {c!r}: {left.schema[c]!r} != "
                f"{right.schema[c]!r}")
        for i, (a, b) in enumerate(zip(ld[c], rd[c])):
            if not _vals_close(a, b, check_exact=check_exact, rtol=rtol,
                               atol=atol):
                raise AssertionError(
                    f"frames differ in column {c!r} at row {i}: "
                    f"{a!r} != {b!r}")


def assert_frame_not_equal(left, right, **kw) -> None:
    try:
        assert_frame_equal(left, right, **kw)
    except AssertionError:
        return
    raise AssertionError("frames are equal (expected not equal)")
