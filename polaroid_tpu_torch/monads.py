"""Functional primitives: Result / Option / Lazy (reference:
`crates/polars-python/src/monads.rs` — a Polarway addition exposing
Rust-style monads to Python notebooks)."""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["Result", "Option", "Lazy"]

_SENTINEL = object()


class Result:
    """Rust-style Result<T, E>."""

    __slots__ = ("_val", "_is_ok")

    def __init__(self, value, is_ok: bool):
        self._val = value
        self._is_ok = is_ok

    @staticmethod
    def ok(value) -> "Result":
        return Result(value, True)

    @staticmethod
    def err(error) -> "Result":
        return Result(error, False)

    def is_ok(self) -> bool:
        return self._is_ok

    def is_err(self) -> bool:
        return not self._is_ok

    def unwrap(self):
        if not self._is_ok:
            raise ValueError("Called unwrap() on an Err value")
        return self._val

    def unwrap_or(self, default):
        return self._val if self._is_ok else default

    def ok_value(self):
        return self._val if self._is_ok else None

    def err_value(self):
        return None if self._is_ok else self._val

    def map(self, fn: Callable) -> "Result":
        if not self._is_ok:
            return self
        try:
            return Result.ok(fn(self._val))
        except Exception as exc:  # noqa: BLE001 — map captures failures
            return Result.err(exc)

    def flat_map(self, fn: Callable) -> "Result":
        if not self._is_ok:
            return self
        out = fn(self._val)
        if not isinstance(out, Result):
            raise TypeError("flat_map fn must return a Result")
        return out

    and_then = flat_map

    def match_result(self, on_ok: Callable, on_err: Callable):
        return on_ok(self._val) if self._is_ok else on_err(self._val)

    def __repr__(self) -> str:
        return f"Ok({self._val!r})" if self._is_ok \
            else f"Err({self._val!r})"


class Option:
    """Rust-style Option<T>."""

    __slots__ = ("_val",)

    def __init__(self, value=_SENTINEL):
        self._val = value

    @staticmethod
    def some(value) -> "Option":
        return Option(value)

    @staticmethod
    def nothing() -> "Option":
        return Option()

    none = nothing

    def is_some(self) -> bool:
        return self._val is not _SENTINEL

    def is_none(self) -> bool:
        return self._val is _SENTINEL

    def unwrap(self):
        if self.is_none():
            raise ValueError("Called unwrap() on a None value")
        return self._val

    def unwrap_or(self, default):
        return default if self.is_none() else self._val

    def get(self):
        return None if self.is_none() else self._val

    def map(self, fn: Callable) -> "Option":
        if self.is_none():
            return self
        return Option.some(fn(self._val))

    def flat_map(self, fn: Callable) -> "Option":
        if self.is_none():
            return self
        out = fn(self._val)
        if not isinstance(out, Option):
            raise TypeError("flat_map fn must return an Option")
        return out

    def filter(self, pred: Callable) -> "Option":
        if self.is_some() and pred(self._val):
            return self
        return Option.nothing()

    def match_option(self, on_some: Callable, on_none: Callable):
        return on_some(self._val) if self.is_some() else on_none()

    def __repr__(self) -> str:
        return "None_" if self.is_none() else f"Some({self._val!r})"


class Lazy:
    """Deferred computation with memoization."""

    __slots__ = ("_fn", "_val", "_done")

    def __init__(self, fn: Callable[[], Any]):
        self._fn = fn
        self._val = None
        self._done = False

    def force(self):
        if not self._done:
            self._val = self._fn()
            self._done = True
        return self._val

    def is_evaluated(self) -> bool:
        return self._done

    def map(self, fn: Callable) -> "Lazy":
        return Lazy(lambda: fn(self.force()))

    def __repr__(self) -> str:
        return f"Lazy(evaluated={self._done})"
