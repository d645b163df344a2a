"""ctypes bindings for the native host library (native/memstore.cpp).

The port's own copy of the JAX package's bindings: it loads the repo's
`native/libptmemstore.so` and, where the library does not load, answers
with the same pure-Python probes (`/proc/meminfo`, `/proc/self/statm`).
These are host memory figures: the streaming engine's spill thresholds
read them (`exec/streaming.py`); nothing here touches the card.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

_LIB = None
_TRIED = False


def _find_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    candidates = [
        os.path.join(here, "native", "libptmemstore.so"),
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "libptmemstore.so"),
    ]
    for p in candidates:
        if os.path.exists(p):
            try:
                lib = ctypes.CDLL(p)
                lib.pt_available_memory.restype = ctypes.c_int64
                lib.pt_total_memory.restype = ctypes.c_int64
                lib.pt_process_rss.restype = ctypes.c_int64
                lib.pt_adaptive_chunk_rows.restype = ctypes.c_int64
                lib.pt_adaptive_chunk_rows.argtypes = [
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int32]
                lib.pt_cache_new.restype = ctypes.c_void_p
                lib.pt_cache_new.argtypes = [ctypes.c_int64]
                lib.pt_cache_free.argtypes = [ctypes.c_void_p]
                lib.pt_cache_put.restype = ctypes.c_int32
                lib.pt_cache_put.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                    ctypes.c_int64]
                lib.pt_cache_get.restype = ctypes.c_int64
                lib.pt_cache_get.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                    ctypes.c_int64]
                lib.pt_cache_delete.restype = ctypes.c_int32
                lib.pt_cache_delete.argtypes = [ctypes.c_void_p,
                                                ctypes.c_char_p]
                lib.pt_cache_stats.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64 * 6)]
                _LIB = lib
                return lib
            except OSError:
                continue
    return None


def available_memory() -> int:
    lib = _find_lib()
    if lib is not None:
        return lib.pt_available_memory()
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 1 << 30


def process_rss() -> int:
    lib = _find_lib()
    if lib is not None:
        return lib.pt_process_rss()
    try:
        with open("/proc/self/statm") as f:
            parts = f.read().split()
        return int(parts[1]) * os.sysconf("SC_PAGE_SIZE")
    except OSError:
        return -1


def adaptive_chunk_rows(current_rows: int, bytes_per_row: int,
                        min_rows: int = 1 << 14, max_rows: int = 1 << 24,
                        frac_pct: int = 20) -> int:
    """Next streaming batch size given memory pressure (reference:
    polars-streaming-adaptive chunk_strategy.rs)."""
    lib = _find_lib()
    if lib is not None:
        return lib.pt_adaptive_chunk_rows(current_rows, bytes_per_row,
                                          min_rows, max_rows, frac_pct)
    avail = available_memory()
    target = (avail * frac_pct // 100) // max(bytes_per_row, 1)
    nxt = current_rows + (target - current_rows) // 2
    return max(min_rows, min(nxt, max_rows))


class NativeLRU:
    """Byte-accounted LRU over the native cache; falls back to an
    OrderedDict implementation."""

    def __init__(self, capacity_bytes: int):
        self._lib = _find_lib()
        self.capacity = capacity_bytes
        if self._lib is not None:
            self._h = self._lib.pt_cache_new(capacity_bytes)
            self._py = None
        else:
            from collections import OrderedDict
            self._h = None
            self._py = OrderedDict()
            self._used = 0
            self._hits = self._misses = self._evict = 0
            self._lock = threading.Lock()

    def put(self, key: str, data: bytes) -> bool:
        if self._h is not None:
            return self._lib.pt_cache_put(self._h, key.encode(), data,
                                          len(data)) == 0
        with self._lock:
            if len(data) > self.capacity:
                return False
            if key in self._py:
                self._used -= len(self._py.pop(key))
            while self._used + len(data) > self.capacity and self._py:
                _, v = self._py.popitem(last=False)
                self._used -= len(v)
                self._evict += 1
            self._py[key] = data
            self._used += len(data)
            return True

    def get(self, key: str) -> Optional[bytes]:
        if self._h is not None:
            n = self._lib.pt_cache_get(self._h, key.encode(), None, 0)
            if n < 0:
                return None
            buf = ctypes.create_string_buffer(n)
            self._lib.pt_cache_get(self._h, key.encode(), buf, n)
            return buf.raw
        with self._lock:
            if key not in self._py:
                self._misses += 1
                return None
            self._hits += 1
            v = self._py.pop(key)
            self._py[key] = v
            return v

    def delete(self, key: str) -> bool:
        if self._h is not None:
            return self._lib.pt_cache_delete(self._h, key.encode()) == 0
        with self._lock:
            v = self._py.pop(key, None)
            if v is not None:
                self._used -= len(v)
            return v is not None

    def stats(self) -> dict:
        if self._h is not None:
            arr = (ctypes.c_int64 * 6)()
            self._lib.pt_cache_stats(self._h, ctypes.byref(arr))
            return {"hits": arr[0], "misses": arr[1], "evictions": arr[2],
                    "used_bytes": arr[3], "capacity_bytes": arr[4],
                    "entries": arr[5], "native": True}
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "evictions": self._evict, "used_bytes": self._used,
                    "capacity_bytes": self.capacity,
                    "entries": len(self._py), "native": False}

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            try:
                self._lib.pt_cache_free(self._h)
            except Exception:
                pass


def has_native() -> bool:
    return _find_lib() is not None
