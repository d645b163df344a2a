"""SQL frontend: SQLContext translating SQL to LazyFrames.

Capability analogue of `crates/polars-sql/src/context.rs`. The parser
lives in `parser.py` (hand-written recursive descent; no external deps).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..errors import SQLInterfaceError


class SQLContext:
    def __init__(self, frames: Optional[Dict[str, object]] = None,
                 eager: bool = False, **named_frames):
        self._tables: Dict[str, object] = {}
        self._eager = eager
        frames = dict(frames or {})
        frames.update(named_frames)
        for name, f in frames.items():
            self.register(name, f)

    def register(self, name: str, frame) -> "SQLContext":
        from ..api.frame import DataFrame
        from ..api.lazyframe import LazyFrame
        if isinstance(frame, DataFrame):
            frame = frame.lazy()
        if not isinstance(frame, LazyFrame):
            raise SQLInterfaceError(f"cannot register {type(frame)}")
        self._tables[name] = frame
        return self

    def register_many(self, frames: Dict[str, object]) -> "SQLContext":
        for n, f in frames.items():
            self.register(n, f)
        return self

    def unregister(self, name: str) -> "SQLContext":
        self._tables.pop(name, None)
        return self

    def tables(self):
        return sorted(self._tables)

    def execute(self, query: str, eager: Optional[bool] = None):
        from .parser import parse_sql
        from .translate import translate
        stmt = parse_sql(query)
        lf = translate(stmt, self._tables)
        if eager if eager is not None else self._eager:
            return lf.collect()
        return lf
