"""Host-side sorted string dictionaries.

The device holds only int32 *codes*; the strings live in a host-side
**sorted** dictionary, so code order is string order and group-bys and
comparisons on strings are integer ops on the card. Null is code -1 (the
validity mask stays authoritative). String functions (`expr/str.py`) map
the dictionary once on the host, O(distinct), and gather the result by
code on the device.

The port of the JAX package's `strings.py` on numpy and torch alone: the
JAX package encodes through pyarrow, which the port does not require.
A fixed-width numpy unicode array (the bulk input) is encoded without a
Python string per row: its UCS4 code points are narrowed to bytes when
they all fit one, packed big-endian into 8-byte words (word order is
code-point order, and numpy pads with NULs, which order first), sorted
by those words (`torch.unique` for one word, a least-significant-first
chain of stable argsorts for more) and only the distinct rows are
decoded to Python strings.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

NULL_CODE = np.int32(-1)

_DICT_COUNTER = [0]


def _orderable_i64(words: np.ndarray) -> torch.Tensor:
    """uint64 words as int64 that order as the unsigned words do."""
    return torch.from_numpy((words ^ np.uint64(1 << 63)).view(np.int64))


def _row_words(mat: np.ndarray) -> np.ndarray:
    """(n, W) uint8 rows -> (n, ceil(W/8)) uint64 words, big-endian, so
    integer order is byte order (rows are zero-padded)."""
    n, w = mat.shape
    nw = max((w + 7) // 8, 1)
    if w != nw * 8:
        pad = np.zeros((n, nw * 8), np.uint8)
        pad[:, :w] = mat
        mat = pad
    return np.ascontiguousarray(mat).view(">u8").astype(np.uint64)


def unique_rows(mat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(first row index of each distinct row in ascending byte order,
    each row's rank among the distinct rows (int32)) for (n, W) uint8
    rows."""
    words = _row_words(mat)
    n, nw = words.shape
    if nw == 1:
        uniq, inv = torch.unique(_orderable_i64(words[:, 0]), sorted=True,
                                 return_inverse=True)
        first = torch.full((len(uniq),), n, dtype=torch.int64) \
            .scatter_reduce_(0, inv, torch.arange(n), "amin")
        return first.numpy(), inv.numpy().astype(np.int32)
    perm = torch.arange(n)
    for j in range(nw - 1, -1, -1):
        key = _orderable_i64(np.ascontiguousarray(words[:, j]))[perm]
        perm = perm[torch.argsort(key, stable=True)]
    perm = perm.numpy()
    sw = words[perm]
    new = np.ones(n, bool)
    new[1:] = (sw[1:] != sw[:-1]).any(axis=1)
    rank = (np.cumsum(new) - 1).astype(np.int32)
    inv = np.empty(n, np.int32)
    inv[perm] = rank
    return perm[new], inv


def _encode_fixed_unicode(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A numpy 'U' array -> (int32 codes, sorted distinct strings)."""
    n = len(raw)
    ncp = raw.dtype.itemsize // 4
    if n == 0:
        return np.zeros(0, np.int32), np.array([], dtype=object)
    if ncp == 0:
        return np.zeros(n, np.int32), np.array([""], dtype=object)
    cps = np.ascontiguousarray(raw).view(np.uint32).reshape(n, ncp)
    if int(cps.max()) <= 0xFF:
        mat = cps.astype(np.uint8)
    else:
        mat = cps.astype(">u4").view(np.uint8).reshape(n, 4 * ncp)
    first, inv = unique_rows(mat)
    uniq = np.ascontiguousarray(raw[first]).astype(object)
    return inv, uniq


class StringDict:
    """Immutable sorted dictionary of unique strings (or bytes)."""

    __slots__ = ("values", "version", "_last_merge")

    def __init__(self, values: np.ndarray):
        # values must be sorted and unique, dtype=object
        self.values = values
        # monotonic id, usable as a cache key (id() can be reused by GC)
        _DICT_COUNTER[0] += 1
        self.version = _DICT_COUNTER[0]
        # (other's version, merge result) of the last `merge`
        self._last_merge = None

    def __len__(self) -> int:
        return len(self.values)

    def __repr__(self) -> str:
        return f"StringDict(n={len(self.values)})"

    @staticmethod
    def encode(strings, mask: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, "StringDict"]:
        """Encode strings (None = null) to int32 codes into a new sorted
        dictionary. `mask` marks the non-null entries when given. A
        fixed-width numpy unicode array takes the word-sort path (module
        docstring); anything else goes through `np.unique` over Python
        objects."""
        if isinstance(strings, np.ndarray) and strings.dtype.kind == "U":
            codes, uniq = _encode_fixed_unicode(strings)
            sd = StringDict(uniq)
            if mask is not None and not np.all(mask):
                # a masked entry's string may be the only one of its kind:
                # re-encode over the unmasked rows' codes alone
                used = np.unique(codes[mask])
                remap = np.full(len(uniq), NULL_CODE, np.int32)
                remap[used] = np.arange(len(used), dtype=np.int32)
                codes = np.where(mask, remap[codes], NULL_CODE)
                sd = StringDict(uniq[used])
            return codes.astype(np.int32, copy=False), sd
        obj = np.asarray(strings, dtype=object)
        if obj.ndim != 1:
            obj = np.array(list(strings) + [None], dtype=object)[:-1]
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

    # --- literal binding (comparisons against string literals) ----------
    def find(self, s) -> Optional[int]:
        """The code of `s`, or None if it is absent."""
        i = int(np.searchsorted(self.values, s))
        if i < len(self.values) and self.values[i] == s:
            return i
        return None

    def lower_bound(self, s) -> int:
        """The first code whose string is >= s: `col < s` is
        `code < lower_bound(s)`, `col <= s` is `code < upper_bound(s)`."""
        return int(np.searchsorted(self.values, s, side="left"))

    def upper_bound(self, s) -> int:
        return int(np.searchsorted(self.values, s, side="right"))

    # --- per-code transforms --------------------------------------------
    def map_to_array(self, fn: Callable, dtype) -> np.ndarray:
        """`fn` of every dictionary entry: a lookup table (one entry per
        code) to gather on the device."""
        out = np.empty(len(self.values), dtype=dtype)
        for i, v in enumerate(self.values):
            out[i] = fn(v)
        return out

    def map_to_strings(self, fn) -> Tuple["StringDict", np.ndarray]:
        """Each string through a str -> str function: (the new sorted
        dictionary, the map of old codes to new ones)."""
        mapped = np.array([fn(v) for v in self.values], dtype=object)
        if len(mapped) == 0:
            return StringDict(np.array([], dtype=object)), \
                np.zeros(0, np.int32)
        uniq, inv = np.unique(mapped, return_inverse=True)
        return StringDict(np.asarray(uniq, dtype=object)), \
            inv.astype(np.int32)

    # --- merging (joins, concats, comparisons across columns) -----------
    def merge(self, other: "StringDict"
              ) -> Tuple["StringDict", np.ndarray, np.ndarray]:
        """Union two dictionaries. Returns (merged, remap_self, remap_other)
        where remap_x maps an old code to its new code (int32). A
        dictionary never changes, so it keeps the result of its last
        merge, for as long as it lives: a join or comparison of two string
        columns repeated over the same frames merges once."""
        last = self._last_merge
        if last is not None and last[0] == other.version:
            return last[1]
        merged = np.union1d(self.values, other.values).astype(object)
        remap_a = np.searchsorted(merged, self.values).astype(np.int32)
        remap_b = np.searchsorted(merged, other.values).astype(np.int32)
        hit = (StringDict(merged), remap_a, remap_b)
        self._last_merge = (other.version, hit)
        return hit


EMPTY_DICT = StringDict(np.array([], dtype=object))
