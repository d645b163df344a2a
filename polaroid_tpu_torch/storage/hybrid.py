"""Hybrid tiered storage: RAM LRU -> Parquet cold tier -> SQL queries.

The port of the JAX package's `storage/hybrid.py`: the RAM tier holds
Arrow IPC buffers in the byte-accounted LRU of `native.NativeLRU`, the
cold tier one zstd Parquet file per key, and `query` runs SQL over every
stored key through the port's `SQLContext`. Frames are stored from
wherever they live (`to_arrow` compacts them on their device first) and
loaded onto the storage's device (`HybridStorage(device=...)`, CUDA
unless the caller asks for the CPU). pyarrow is imported where Arrow
buffers are made or read.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import List

from ..batch import resolve_device
from ..errors import NoDataError
from ..native import NativeLRU


class StorageStats:
    """Counts of the storage's operations and bytes."""

    def __init__(self):
        self.cache_hits = 0
        self.cache_misses = 0
        self.stores = 0
        self.loads = 0
        self.queries = 0
        self.bytes_written = 0
        self.bytes_read = 0

    def as_dict(self) -> dict:
        total = self.cache_hits + self.cache_misses
        return {
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_hit_rate": self.cache_hits / total if total else 0.0,
            "stores": self.stores, "loads": self.loads,
            "queries": self.queries,
            "bytes_written": self.bytes_written,
            "bytes_read": self.bytes_read,
        }


class MemoryCacheBackend:
    """RAM tier: Arrow IPC buffers in a byte-accounted LRU."""

    def __init__(self, capacity_bytes: int = 2 << 30, device=None):
        self.device = resolve_device(device)
        self._lru = NativeLRU(capacity_bytes)

    def store(self, key: str, df) -> int:
        import pyarrow as pa
        at = df.to_arrow()
        sink = io.BytesIO()
        with pa.ipc.new_stream(sink, at.schema) as w:
            for b in at.to_batches(max_chunksize=1 << 16):
                w.write_batch(b)
        data = sink.getvalue()
        self._lru.put(key, data)
        return len(data)

    def load(self, key: str):
        data = self._lru.get(key)
        if data is None:
            return None
        import pyarrow as pa
        from ..api.frame import DataFrame
        with pa.ipc.open_stream(io.BytesIO(data)) as r:
            return DataFrame(r.read_all(), device=self.device)

    def delete(self, key: str) -> bool:
        return self._lru.delete(key)

    def stats(self) -> dict:
        return self._lru.stats()


class ParquetBackend:
    """Cold tier: one zstd parquet file per key."""

    def __init__(self, root: str, compression: str = "zstd",
                 compression_level: int = 9, device=None):
        self.device = resolve_device(device)
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.compression = compression
        self.level = compression_level

    def _path(self, key: str) -> Path:
        safe = key.replace("/", "__")
        return self.root / f"{safe}.parquet"

    def store(self, key: str, df) -> int:
        p = self._path(key)
        df.write_parquet(p, compression=self.compression,
                         compression_level=self.level)
        return p.stat().st_size

    def load(self, key: str):
        p = self._path(key)
        if not p.exists():
            return None
        from ..api.io import read_parquet
        return read_parquet(str(p), device=self.device)

    def scan(self, key: str):
        p = self._path(key)
        if not p.exists():
            return None
        from ..api.io import scan_parquet
        return scan_parquet(str(p), device=self.device)

    def delete(self, key: str) -> bool:
        p = self._path(key)
        if p.exists():
            p.unlink()
            return True
        return False

    def list_keys(self) -> List[str]:
        return sorted(p.stem.replace("__", "/")
                      for p in self.root.glob("*.parquet"))


class HybridStorage:
    """store() writes cold + warms cache; load() serves RAM-first;
    query() runs SQL over all stored keys via the engine's SQLContext."""

    def __init__(self, root: str, cache_bytes: int = 2 << 30,
                 compression_level: int = 9, device=None):
        self.device = resolve_device(device)
        self.cache = MemoryCacheBackend(cache_bytes, device=self.device)
        self.cold = ParquetBackend(root, compression_level=compression_level,
                                   device=self.device)
        self.stats_ = StorageStats()

    def store(self, key: str, df) -> None:
        self.stats_.stores += 1
        self.stats_.bytes_written += self.cold.store(key, df)
        self.cache.store(key, df)

    def load(self, key: str):
        self.stats_.loads += 1
        df = self.cache.load(key)
        if df is not None:
            self.stats_.cache_hits += 1
            return df
        self.stats_.cache_misses += 1
        df = self.cold.load(key)
        if df is None:
            raise NoDataError(f"key {key!r} not found")
        self.cache.store(key, df)
        return df

    def query(self, sql: str):
        """SQL over stored tables; table name == key."""
        self.stats_.queries += 1
        from ..sql.context import SQLContext
        ctx = SQLContext(device=self.device)
        for key in self.cold.list_keys():
            lf = self.cold.scan(key)
            if lf is not None:
                ctx.register(key, lf)
        return ctx.execute(sql, eager=True)

    def delete(self, key: str) -> bool:
        self.cache.delete(key)
        return self.cold.delete(key)

    def list_keys(self) -> List[str]:
        return self.cold.list_keys()

    def stats(self) -> dict:
        out = self.stats_.as_dict()
        out["cache"] = self.cache.stats()
        return out
