"""Handle registry: uuid -> frame with TTL + touch-on-access.

The port of the JAX package's `server/handles.py`: clients hold 36-byte
handles; intermediate results never cross the wire; expired handles are
reclaimed lazily so leaked client sessions don't pin server memory.

A handle's frame may hold tensors on the card (an uploaded frame, a lazy
plan over one). The registry is its only reference that outlives a
request: releasing or reaping the handle drops it, and the card's memory
goes back to the caching allocator once the last frame over those
tensors is gone. The entry is dropped outside the registry's lock.

`EXEC_LOCK` is the one lock under which the process's servers execute
plans, on every device: the kernel wrappers' launch counters and input
records are module globals that a CUDA-graph capture winds back
(`exec/compiled.py`), torch's sync debug mode that a capture's first run
turns on is the process's, and a lazy frame keeps its optimized plan, so
two plans executing at once could count, flag or cache each other's
work. Building a frame from Arrow (an upload, a client's result) runs
no kernel wrapper and reads none of that state, so it takes no lock;
parsing, serialization and the wire run concurrently too.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, List

from ..errors import ComputeError

DEFAULT_TTL_S = 3600.0

EXEC_LOCK = threading.RLock()


class _Entry:
    __slots__ = ("frame", "created", "last_access")

    def __init__(self, frame):
        self.frame = frame
        self.created = time.time()
        self.last_access = self.created


class HandleManager:
    def __init__(self, ttl_s: float = DEFAULT_TTL_S):
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.Lock()
        self._ttl = ttl_s

    def create(self, frame) -> str:
        h = str(uuid.uuid4())
        with self._lock:
            self._entries[h] = _Entry(frame)
        return h

    def get(self, handle: str):
        with self._lock:
            dead = self._reap_locked()
            e = self._entries.get(handle)
            if e is not None:
                e.last_access = time.time()
        del dead
        if e is None:
            raise ComputeError(f"unknown or expired handle {handle!r}")
        return e.frame

    def release(self, handle: str) -> bool:
        with self._lock:
            e = self._entries.pop(handle, None)
        return e is not None

    def list(self) -> List[str]:
        with self._lock:
            dead = self._reap_locked()
            out = sorted(self._entries)
        del dead
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _reap_locked(self) -> list:
        """Take the expired entries out; they are returned so that the
        caller frees them after letting go of the lock."""
        now = time.time()
        dead = [h for h, e in self._entries.items()
                if now - e.last_access > self._ttl]
        return [self._entries.pop(h) for h in dead]
