"""Engine configuration via environment variables.

The port's cut of the JAX package's `config.py` (itself the analogue of
the reference's env-var flags, `polars-core/src/config.rs:1-55`): values
come from PT_* env vars and can be set programmatically via `Config`.
The port reads two of them:
* `device` — where new frames live, "cuda" unless PT_DEVICE says
  otherwise. There is no silent fallback: "cuda" without a card raises
  (`batch.resolve_device`).
* `min_capacity` — the smallest row-capacity bucket. Capacities are the
  JAX package's power-of-two buckets, so that masked tables and dense
  group slots line up with it slot for slot.
Float64 is always stored as float64: the card computes it natively.
"""

from __future__ import annotations

import os
from typing import Any


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


class Config:
    """Global engine configuration. Attributes can be set programmatically;
    env vars provide the defaults."""

    def __init__(self) -> None:
        self.reload()

    def reload(self) -> None:
        self.device: str = os.environ.get("PT_DEVICE", "cuda")
        self.min_capacity: int = _env_int("PT_MIN_CAPACITY", 128)

    def set(self, **kwargs: Any) -> "Config":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown config key: {k}")
            setattr(self, k, v)
        return self

    def __call__(self, **options: Any) -> "Config":
        # pl.Config(device="cpu"): applies immediately, restores on exit
        self._saved = {}
        for k, v in options.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown config option: {k}")
            self._saved[k] = getattr(self, k)
            setattr(self, k, v)
        return self

    def __enter__(self) -> "Config":
        return self

    def __exit__(self, *exc) -> None:
        for k, v in getattr(self, "_saved", {}).items():
            setattr(self, k, v)
        self._saved = {}

    def restore_defaults(self) -> "Config":
        self.reload()
        return self


class _ConfigProxy:
    """Lets pl.Config act both as the global instance
    (pl.Config.device = "cpu") and as a constructor-style context
    manager (with pl.Config(device="cpu"): ...)."""

    def __getattr__(self, name):
        return getattr(CONFIG, name)

    def __setattr__(self, name, value):
        setattr(CONFIG, name, value)

    def __call__(self, **options):
        return CONFIG(**options)

    def __enter__(self):
        return CONFIG.__enter__()

    def __exit__(self, *exc):
        return CONFIG.__exit__(*exc)


CONFIG = Config()


def capacity_for(n: int) -> int:
    """Round a row count up to a capacity bucket: a power of two
    (>= CONFIG.min_capacity), the JAX package's buckets."""
    c = max(int(n), 1)
    b = CONFIG.min_capacity
    while b < c:
        b <<= 1
    return b
