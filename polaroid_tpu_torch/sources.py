"""Network data sources: WebSocket / REST streaming ingestion.

The port of the JAX package's `sources.py`: async sources yield row
batches as DataFrames on the source's device (`DataSource(device=...)`,
CUDA unless the caller asks for the CPU), with backpressure (bounded
buffer), health checks and auto-reconnect; a token-bucket rate limiter
throttles polling. websockets and aiohttp are imported when a source
connects.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import AsyncIterator, Callable, Dict, List, Optional

from .batch import resolve_device


class TokenBucketRateLimiter:
    """`rate` tokens/s, burst `capacity`."""

    def __init__(self, rate: float, capacity: Optional[float] = None):
        self.rate = rate
        self.capacity = capacity if capacity is not None else rate
        self._tokens = self.capacity
        self._last = time.monotonic()
        self._lock = asyncio.Lock()

    async def acquire(self, n: float = 1.0) -> None:
        async with self._lock:
            while True:
                now = time.monotonic()
                self._tokens = min(self.capacity,
                                   self._tokens + (now - self._last) * self.rate)
                self._last = now
                if self._tokens >= n:
                    self._tokens -= n
                    return
                wait = (n - self._tokens) / self.rate
                await asyncio.sleep(wait)

    def try_acquire(self, n: float = 1.0) -> bool:
        now = time.monotonic()
        self._tokens = min(self.capacity,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False


class DataSource:
    """Base streaming source.

    Subclasses implement `_connect` and `_receive`; `stream()` yields
    DataFrames of up to `batch_rows` rows on `device`, flushing at least
    every `flush_interval` seconds. `buffer_size` bounds in-flight rows
    (backpressure)."""

    def __init__(self, batch_rows: int = 1024, flush_interval: float = 1.0,
                 buffer_size: int = 65536,
                 parser: Optional[Callable[[bytes], Optional[dict]]] = None,
                 max_reconnects: int = 5, device=None):
        self.device = resolve_device(device)
        self.batch_rows = batch_rows
        self.flush_interval = flush_interval
        self.buffer_size = buffer_size
        self.parser = parser or (lambda m: json.loads(m))
        self.max_reconnects = max_reconnects
        self._healthy = False
        self.rows_received = 0
        self.reconnects = 0

    def is_healthy(self) -> bool:
        return self._healthy

    async def _connect(self):
        raise NotImplementedError

    async def _receive(self, conn) -> AsyncIterator:
        raise NotImplementedError
        yield  # pragma: no cover

    async def stream(self, max_batches: Optional[int] = None
                     ) -> AsyncIterator:
        rows: List[dict] = []
        batches = 0
        attempts = 0
        last_flush = time.monotonic()
        while True:
            try:
                conn = await self._connect()
                self._healthy = True
                attempts = 0
                async for msg in self._receive(conn):
                    rec = self.parser(msg)
                    if rec is None:
                        continue
                    if isinstance(rec, list):
                        rows.extend(rec)
                    else:
                        rows.append(rec)
                    self.rows_received += len(rec) if isinstance(rec, list) else 1
                    now = time.monotonic()
                    if len(rows) >= self.batch_rows or (
                            rows and now - last_flush >= self.flush_interval):
                        yield _rows_to_frame(rows, self.device)
                        rows = []
                        last_flush = now
                        batches += 1
                        if max_batches is not None and batches >= max_batches:
                            return
                # stream ended cleanly
                break
            except (ConnectionError, OSError, asyncio.IncompleteReadError):
                self._healthy = False
                attempts += 1
                self.reconnects += 1
                if attempts > self.max_reconnects:
                    raise
                await asyncio.sleep(min(0.1 * (2 ** attempts), 5.0))
        if rows:
            yield _rows_to_frame(rows, self.device)


def _rows_to_frame(rows: List[dict], device):
    """One batch of records as a frame on `device` (a key missing from a
    record is null there)."""
    from .api.frame import DataFrame
    cols: Dict[str, list] = {}
    for r in rows:
        for k in r:
            cols.setdefault(k, [])
    for r in rows:
        for k in cols:
            cols[k].append(r.get(k))
    return DataFrame(cols, device=device)


class WebSocketSource(DataSource):
    """Subscribes to a WebSocket and batches its tick messages."""

    def __init__(self, url: str, subscribe_message: Optional[str] = None,
                 **kw):
        super().__init__(**kw)
        self.url = url
        self.subscribe_message = subscribe_message

    async def _connect(self):
        import websockets
        conn = await websockets.connect(self.url)
        if self.subscribe_message:
            await conn.send(self.subscribe_message)
        return conn

    async def _receive(self, conn):
        try:
            async for msg in conn:
                yield msg
        finally:
            await conn.close()


class RestSource(DataSource):
    """Polls an HTTP endpoint on an interval, rate limited."""

    def __init__(self, url: str, interval_s: float = 1.0,
                 rate_limiter: Optional[TokenBucketRateLimiter] = None,
                 max_polls: Optional[int] = None, **kw):
        super().__init__(**kw)
        self.url = url
        self.interval_s = interval_s
        self.rate_limiter = rate_limiter
        self.max_polls = max_polls

    async def _connect(self):
        import aiohttp
        return aiohttp.ClientSession()

    async def _receive(self, session):
        polls = 0
        try:
            while self.max_polls is None or polls < self.max_polls:
                if self.rate_limiter is not None:
                    await self.rate_limiter.acquire()
                async with session.get(self.url) as resp:
                    body = await resp.text()
                yield body
                polls += 1
                if self.max_polls is not None and polls >= self.max_polls:
                    break
                await asyncio.sleep(self.interval_s)
        finally:
            await session.close()


async def collect_stream(source: DataSource, max_batches: int):
    """Materialize a bounded number of batches into one DataFrame on the
    source's device."""
    from .api.functions import concat
    frames = []
    async for df in source.stream(max_batches=max_batches):
        frames.append(df)
    if not frames:
        from .api.frame import DataFrame
        return DataFrame(device=source.device)
    return concat(frames, how="diagonal") if len(frames) > 1 else frames[0]
