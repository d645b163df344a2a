"""Column selectors (`import polaroid_tpu_torch.selectors as cs`).

Parity target: `py-polars/src/polars/selectors.py` — schema-driven column
sets with set algebra (`|`, `&`, `-`, `~`). A Selector IS an Expr whose
expansion resolves against the frame schema (see
`expr/meta.py expand_exprs`), so `cs.numeric().sum()` works anywhere an
expression does.
"""

from __future__ import annotations

import re
from typing import Callable

from .dtypes import (
    Boolean, Categorical, DataType, Date, Datetime, Duration, Float32,
    Float64, Int8, Int16, Int32, Int64, String, Time, UInt8, UInt16,
    UInt32, UInt64,
)
from .expr.expr import Expr

__all__ = [
    "all", "alpha", "alphanumeric", "binary", "boolean", "by_dtype",
    "by_index", "by_name", "categorical", "contains", "date", "datetime",
    "digit",
    "duration", "ends_with", "exclude", "expand_selector", "first",
    "float", "integer", "last", "matches", "numeric", "signed_integer",
    "starts_with", "string", "temporal", "time", "unsigned_integer",
]


class Selector(Expr):
    """A schema predicate that expands to matching columns."""

    def __init__(self, pred: Callable, label: str):
        Expr.__init__(self, "selector", (), pred=pred, label=label)

    # --- set algebra (overrides the elementwise Expr operators) ----------
    def __or__(self, other):
        if isinstance(other, Selector):
            a, b = self.attrs["pred"], other.attrs["pred"]
            return Selector(lambda n, d, i, w: a(n, d, i, w) or b(n, d, i, w),
                            f"({self.attrs['label']} | "
                            f"{other.attrs['label']})")
        return Expr.__or__(self, other)

    def __and__(self, other):
        if isinstance(other, Selector):
            a, b = self.attrs["pred"], other.attrs["pred"]
            return Selector(
                lambda n, d, i, w: a(n, d, i, w) and b(n, d, i, w),
                f"({self.attrs['label']} & {other.attrs['label']})")
        return Expr.__and__(self, other)

    def __sub__(self, other):
        if isinstance(other, Selector):
            a, b = self.attrs["pred"], other.attrs["pred"]
            return Selector(
                lambda n, d, i, w: a(n, d, i, w) and not b(n, d, i, w),
                f"({self.attrs['label']} - {other.attrs['label']})")
        return Expr.__sub__(self, other)

    def __invert__(self):
        a = self.attrs["pred"]
        return Selector(lambda n, d, i, w: not a(n, d, i, w),
                        f"~{self.attrs['label']}")

    def __repr__(self):
        return f"cs.{self.attrs['label']}"

    def as_expr(self) -> Expr:
        return Expr("selector", (), **self.attrs)


def all() -> Selector:
    return Selector(lambda n, d, i, w: True, "all()")


def first() -> Selector:
    return Selector(lambda n, d, i, w: i == 0, "first()")


def last() -> Selector:
    return Selector(lambda n, d, i, w: i == w - 1, "last()")


def numeric() -> Selector:
    return Selector(lambda n, d, i, w: d.is_numeric, "numeric()")


def float() -> Selector:
    return Selector(lambda n, d, i, w: d.is_float, "float()")


def integer() -> Selector:
    return Selector(lambda n, d, i, w: d.is_integer, "integer()")


def signed_integer() -> Selector:
    return Selector(lambda n, d, i, w: d.is_integer and d.is_signed_integer,
                    "signed_integer()")


def unsigned_integer() -> Selector:
    return Selector(
        lambda n, d, i, w: d.is_integer and not d.is_signed_integer,
        "unsigned_integer()")


def boolean() -> Selector:
    return Selector(lambda n, d, i, w: d.is_bool, "boolean()")


def string(include_categorical: bool = False) -> Selector:
    def pred(n, d, i, w):
        if isinstance(d, Categorical):
            return include_categorical
        return d.is_string and not d.is_binary
    return Selector(pred, "string()")


def binary() -> Selector:
    return Selector(lambda n, d, i, w: d.is_binary, "binary()")


def categorical() -> Selector:
    return Selector(lambda n, d, i, w: isinstance(d, Categorical),
                    "categorical()")


def date() -> Selector:
    return Selector(lambda n, d, i, w: d == Date, "date()")


def datetime(time_unit=None) -> Selector:
    def pred(n, d, i, w):
        if not isinstance(d, Datetime):
            return False
        if time_unit is None:
            return True
        units = [time_unit] if isinstance(time_unit, str) else list(time_unit)
        return d.time_unit in units
    return Selector(pred, "datetime()")


def duration(time_unit=None) -> Selector:
    def pred(n, d, i, w):
        if not isinstance(d, Duration):
            return False
        if time_unit is None:
            return True
        units = [time_unit] if isinstance(time_unit, str) else list(time_unit)
        return d.time_unit in units
    return Selector(pred, "duration()")


def time() -> Selector:
    return Selector(lambda n, d, i, w: d == Time, "time()")


def temporal() -> Selector:
    return Selector(lambda n, d, i, w: d.is_temporal, "temporal()")


def by_dtype(*dtypes) -> Selector:
    flat = []
    for d in dtypes:
        flat.extend(d if isinstance(d, (list, tuple)) else [d])
    insts = [d() if isinstance(d, type) else d for d in flat]

    def pred(n, d, i, w):
        return builtins_any(d == t for t in insts)
    return Selector(pred, f"by_dtype({insts})")


def by_name(*names, require_all: bool = True) -> Selector:
    flat = []
    for n in names:
        flat.extend(n if isinstance(n, (list, tuple)) else [n])
    want = set(flat)
    return Selector(lambda n, d, i, w: n in want, f"by_name({sorted(want)})")


def by_index(*indices) -> Selector:
    flat = []
    for ix in indices:
        flat.extend(ix if isinstance(ix, (list, tuple, range)) else [ix])
    want = set(int(i) for i in flat)

    def pred(n, d, i, w):
        return i in want or (i - w) in want
    return Selector(pred, f"by_index({sorted(want)})")


def starts_with(*prefixes) -> Selector:
    pre = tuple(prefixes)
    return Selector(lambda n, d, i, w: n.startswith(pre),
                    f"starts_with{pre}")


def ends_with(*suffixes) -> Selector:
    suf = tuple(suffixes)
    return Selector(lambda n, d, i, w: n.endswith(suf), f"ends_with{suf}")


def contains(*substrings) -> Selector:
    subs = tuple(substrings)
    return Selector(lambda n, d, i, w: builtins_any(s in n for s in subs),
                    f"contains{subs}")


def matches(pattern: str) -> Selector:
    rx = re.compile(pattern)
    return Selector(lambda n, d, i, w: rx.search(n) is not None,
                    f"matches({pattern!r})")


def alpha(ascii_only: bool = False, ignore_spaces: bool = False) -> Selector:
    def pred(n, d, i, w):
        s = n.replace(" ", "") if ignore_spaces else n
        return s.isalpha() and (not ascii_only or s.isascii())
    return Selector(pred, "alpha()")


def alphanumeric(ascii_only: bool = False,
                 ignore_spaces: bool = False) -> Selector:
    def pred(n, d, i, w):
        s = n.replace(" ", "") if ignore_spaces else n
        return s.isalnum() and (not ascii_only or s.isascii())
    return Selector(pred, "alphanumeric()")


def digit(ascii_only: bool = False) -> Selector:
    return Selector(lambda n, d, i, w: n.isdigit(), "digit()")


def exclude(*names) -> Selector:
    return ~by_name(*names)


def expand_selector(target, selector: Selector) -> tuple:
    """Resolve a selector against a frame/schema to concrete names."""
    schema = target if isinstance(target, dict) else dict(target.schema)
    pred = selector.attrs["pred"]
    w = len(schema)
    return tuple(n for i, (n, d) in enumerate(schema.items())
                 if pred(n, d, i, w))


def builtins_any(it) -> bool:
    for x in it:
        if x:
            return True
    return False
