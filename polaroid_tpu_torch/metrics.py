"""Engine metrics and tracing.

Capability analogue of the reference's metrics system
(`polars-stream/src/metrics.rs` GraphMetrics, TaskMetrics at
`async_executor/mod.rs:64-70`, PipeMetrics at `pipe.rs:57-64`, printed
breakdown at `skeleton.rs:157-213`): per-node wall time and row counts
collected when PT_TRACK_METRICS is set, printed sorted by total time when
PT_LOG_METRICS is set, and queryable programmatically. The executors
fence each timed node on the card with `torch.cuda.synchronize()` on
the table's device (`exec/executor.py`, `exec/streaming.py`), so a
node's time includes its device work.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional


class NodeMetrics:
    __slots__ = ("name", "calls", "total_s", "rows_in", "rows_out",
                 "batches")

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.total_s = 0.0
        self.rows_in = 0
        self.rows_out = 0
        self.batches = 0


class QueryMetrics:
    """Collected per collect() when tracking is on."""

    def __init__(self):
        self.nodes: Dict[str, NodeMetrics] = {}
        self.started = time.time()
        self._lock = threading.Lock()

    def node(self, name: str) -> NodeMetrics:
        with self._lock:
            if name not in self.nodes:
                self.nodes[name] = NodeMetrics(name)
            return self.nodes[name]

    @contextmanager
    def timed(self, name: str, rows_in: Optional[int] = None):
        m = self.node(name)
        t0 = time.perf_counter()
        try:
            yield m
        finally:
            m.total_s += time.perf_counter() - t0
            m.calls += 1
            if rows_in:
                m.rows_in += rows_in

    def report(self) -> List[dict]:
        out = [{"node": m.name, "calls": m.calls,
                "total_ms": round(m.total_s * 1e3, 3),
                "rows_in": m.rows_in, "rows_out": m.rows_out,
                "batches": m.batches}
               for m in self.nodes.values()]
        return sorted(out, key=lambda d: -d["total_ms"])

    def print_report(self) -> None:
        rows = self.report()
        if not rows:
            return
        w = max(len(r["node"]) for r in rows)
        print(f"[metrics] {'node':<{w}}  {'calls':>5}  {'total_ms':>10}  "
              f"{'rows_out':>10}")
        for r in rows:
            print(f"[metrics] {r['node']:<{w}}  {r['calls']:>5}  "
                  f"{r['total_ms']:>10.2f}  {r['rows_out']:>10}")


_CURRENT: List[QueryMetrics] = []


def current() -> Optional[QueryMetrics]:
    return _CURRENT[-1] if _CURRENT else None


@contextmanager
def tracking(enabled: bool = True):
    if not enabled:
        yield None
        return
    qm = QueryMetrics()
    _CURRENT.append(qm)
    try:
        yield qm
    finally:
        _CURRENT.pop()
