"""Host-side sorted string dictionaries.

The device holds only int32 *codes*; the strings live in a host-side
**sorted** dictionary, so code order is string order and group-bys and
comparisons on strings are integer ops on the card. Null is code -1 (the
validity mask stays authoritative).

This is the dictionary-encoding part of the JAX package's `strings.py`,
built on numpy alone (the JAX package encodes through pyarrow, which the
port does not require). String functions come with a later slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

NULL_CODE = np.int32(-1)

_DICT_COUNTER = [0]


class StringDict:
    """Immutable sorted dictionary of unique strings (or bytes)."""

    __slots__ = ("values", "version")

    def __init__(self, values: np.ndarray):
        # values must be sorted and unique, dtype=object
        self.values = values
        # monotonic id, usable as a cache key (id() can be reused by GC)
        _DICT_COUNTER[0] += 1
        self.version = _DICT_COUNTER[0]

    def __len__(self) -> int:
        return len(self.values)

    def __repr__(self) -> str:
        return f"StringDict(n={len(self.values)})"

    @staticmethod
    def encode(strings, mask: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, "StringDict"]:
        """Encode strings (None = null) to int32 codes into a new sorted
        dictionary. `mask` marks the non-null entries when given."""
        obj = np.asarray(strings, dtype=object)
        if mask is None:
            mask = np.array([v is not None for v in obj], dtype=bool)
        codes = np.full(len(obj), NULL_CODE, dtype=np.int32)
        if mask.any():
            uniq, inv = np.unique(obj[mask], return_inverse=True)
            codes[mask] = inv.astype(np.int32)
        else:
            uniq = np.array([], dtype=object)
        return codes, StringDict(np.asarray(uniq, dtype=object))

    def decode(self, codes: np.ndarray) -> np.ndarray:
        out = np.empty(len(codes), dtype=object)
        valid = codes >= 0
        out[valid] = self.values[codes[valid]]
        out[~valid] = None
        return out

    def merge(self, other: "StringDict"
              ) -> Tuple["StringDict", np.ndarray, np.ndarray]:
        """Union two dictionaries. Returns (merged, remap_self, remap_other)
        where remap_x maps an old code to its new code (int32)."""
        merged = np.union1d(self.values, other.values).astype(object)
        remap_a = np.searchsorted(merged, self.values).astype(np.int32)
        remap_b = np.searchsorted(merged, other.values).astype(np.int32)
        return StringDict(merged), remap_a, remap_b


EMPTY_DICT = StringDict(np.array([], dtype=object))
