"""Fused-word device sorts: one `torch.sort` of a packed int64.

The port of the JAX package's `ops/fused_sort.py`. There a key and its
cargo are packed into one u64 and sorted by a single-operand `lax.sort`,
outside any Pallas kernel; here the same packings go to one `torch.sort`
of an int64 (a radix sort on the card). The packed word is unsigned, and
torch sorts int64 as signed, so the top bit is flipped before the sort
and back after: without the flip a key >= 2^31 in the high word would
sort first.

Words are 32-bit unsigned values held as non-negative int64 tensors
(see `keycode.py`). Packings (n < 2^31 rows; "hi" orders before "lo"):

  kv       hi=key            lo=cargo        full sort of a 2-word row; ties
                                             in `key` order by cargo
  masked   dead rows become (~0, ~0)         dead rows sort last; a live
                                             all-ones row ties with them
                                             bit for bit, harmlessly
  argsort  hi=key|~0 if dead  lo=dead<<31|idx  stable argsort, dead rows
                                             after live rows of equal key
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["fused_sort_kv", "fused_argsort", "fused_argsort_dead_key",
           "apply_perm_u32"]

_U32 = 0xFFFFFFFF
_SIGN64 = -(1 << 63)        # the int64 whose bits are 1 << 63


def _sort_packed(hi: torch.Tensor, lo: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort the u64 words (hi << 32 | lo) ascending as unsigned; returns
    the sorted (hi, lo)."""
    w = torch.sort(((hi << 32) | lo) ^ _SIGN64).values ^ _SIGN64
    return (w >> 32) & _U32, w & _U32


def fused_sort_kv(key: torch.Tensor, cargo: torch.Tensor,
                  live: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort (key, cargo) word pairs by key, ties by cargo, in one sort.
    Dead rows (live=False) sort last as all-ones words."""
    if live is not None:
        key = torch.where(live, key, _U32)
        cargo = torch.where(live, cargo, _U32)
    return _sort_packed(key, cargo)


def fused_argsort_dead_key(dead: torch.Tensor, key: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Stable argsort by (dead, key), packed [dead:1 | key:32 | idx:31]
    into one word. Returns (dead_s, key_s, perm) in sorted order; dead
    must be 0/1, n < 2^31."""
    n = key.shape[0]
    idx = torch.arange(n, device=key.device)
    d = dead.to(torch.int64)
    hi = (d << 31) | (key >> 1)
    lo = ((key & 1) << 31) | idx
    shi, slo = _sort_packed(hi, lo)
    return shi >> 31, ((shi << 1) & _U32) | (slo >> 31), slo & 0x7FFFFFFF


def apply_perm_u32(perm: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
    """out[j] = word[i] where perm[i] == j: `word` (in permuted space)
    back to the space `perm` points into, by one sort of (perm, word)
    pairs by perm. `perm` must be a permutation of 0..n-1."""
    return fused_sort_kv(perm.to(torch.int64), word)[1]


def fused_argsort(key: torch.Tensor, live: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable argsort of a 32-bit key word with dead rows last.

    Returns (sorted_key, perm): perm[i] is the original row of the row
    at sorted position i. Dead rows take key ~0 (after every live key)
    and bit 31 in the low word (after live rows that hold key ~0).
    n < 2^31."""
    n = key.shape[0]
    lo = torch.arange(n, device=key.device)
    if live is not None:
        key = torch.where(live, key, _U32)
        lo = torch.where(live, lo, lo | (1 << 31))
    skey, slo = _sort_packed(key, lo)
    return skey, slo & 0x7FFFFFFF
