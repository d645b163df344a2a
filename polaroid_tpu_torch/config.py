"""Engine configuration via environment variables.

The port's cut of the JAX package's `config.py` (itself the analogue of
the reference's env-var flags, `polars-core/src/config.rs:1-55`): values
come from PT_* env vars and can be set programmatically via `Config`.
The port reads these:
* `device` — where new frames live, "cuda" unless PT_DEVICE says
  otherwise. There is no silent fallback: "cuda" without a card raises
  (`batch.resolve_device`).
* `min_capacity` — the smallest row-capacity bucket. Capacities are the
  JAX package's power-of-two buckets, so that masked tables and dense
  group slots line up with it slot for slot.
* `fmt_max_rows`, `fmt_max_cols`, `fmt_str_len` — how a frame prints
  (polars' `tbl_rows`, `tbl_cols`, `fmt_str_lengths`).
* the engine settings, with the JAX package's env names and defaults:
  `engine_affinity` ("auto" | "in-memory" | "streaming" |
  "distributed"), `batch_rows` (rows per streamed batch),
  `join_sample_limit`,
  `join_build_budget_rows` and `join_grace_partitions` (the streaming
  joins' build-side choice and spill), `track_metrics`, `log_metrics`
  (per-node timings, `metrics.py`) and `visualize_ir` (print the
  optimized plan at collect).
`verbose` (PT_VERBOSE, `set_verbose`) is kept and read nowhere, as in
the JAX package. Float64 is always stored as float64: the card computes
it natively.
"""

from __future__ import annotations

import os
from typing import Any


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v in (None, ""):
        return default
    return v not in ("0", "false", "False", "no")


class Config:
    """Global engine configuration. Attributes can be set programmatically;
    env vars provide the defaults."""

    def __init__(self) -> None:
        self.reload()

    def reload(self) -> None:
        self.device: str = os.environ.get("PT_DEVICE", "cuda")
        # verbosity (POLARS_VERBOSE)
        self.verbose: bool = _env_bool("PT_VERBOSE")
        self.min_capacity: int = _env_int("PT_MIN_CAPACITY", 128)
        # how a frame prints (`api/fmt.py`)
        self.fmt_max_rows: int = _env_int("PT_FMT_MAX_ROWS", 10)
        self.fmt_max_cols: int = _env_int("PT_FMT_MAX_COLS", 12)
        self.fmt_str_len: int = _env_int("PT_FMT_STR_LEN", 30)
        # engine selection default: "auto" | "in-memory" | "streaming"
        # (POLARS_ENGINE_AFFINITY)
        self.engine_affinity: str = os.environ.get("PT_ENGINE_AFFINITY",
                                                   "auto")
        # target rows per streamed batch (POLARS_IDEAL_MORSEL_SIZE)
        self.batch_rows: int = _env_int("PT_BATCH_ROWS", 1 << 21)
        # rows each side of a streaming join may buffer while the smaller
        # side is chosen as the build side (POLARS_JOIN_SAMPLE_LIMIT)
        self.join_sample_limit: int = _env_int("PT_JOIN_SAMPLE_LIMIT",
                                               10_000_000)
        # the streaming join's build-side row budget; past it the
        # grace-hash join spills both sides to partitions
        self.join_build_budget_rows: int = _env_int(
            "PT_JOIN_BUILD_BUDGET_ROWS", 10_000_000)
        self.join_grace_partitions: int = _env_int(
            "PT_JOIN_GRACE_PARTITIONS", 8)
        # per-node timings (POLARS_TRACK_METRICS), printed when
        # log_metrics is set
        self.track_metrics: bool = _env_bool("PT_TRACK_METRICS")
        self.log_metrics: bool = _env_bool("PT_LOG_METRICS")
        # print the optimized plan at collect (POLARS_VISUALIZE_IR)
        self.visualize_ir: bool = _env_bool("PT_VISUALIZE_IR")

    # the polars option names of the formatting settings
    _PL_NAMES = {"tbl_rows": "fmt_max_rows", "tbl_cols": "fmt_max_cols",
                 "fmt_str_lengths": "fmt_str_len", "verbose": "verbose"}

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
            k = self._PL_NAMES.get(k, k)
            if not hasattr(self, k):
                raise AttributeError(f"unknown config option: {k}")
            self._saved[k] = getattr(self, k)
            setattr(self, k, v)
        return self

    def set_tbl_rows(self, n: int) -> "Config":
        self.fmt_max_rows = n
        return self

    def set_tbl_cols(self, n: int) -> "Config":
        self.fmt_max_cols = n
        return self

    def set_fmt_str_lengths(self, n: int) -> "Config":
        self.fmt_str_len = n
        return self

    def set_verbose(self, active: bool = True) -> "Config":
        self.verbose = active
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


# the seed of `pl.set_random_seed`: sampling without a seed of its own
# draws from it (None: fresh entropy)
RANDOM_SEED = None
