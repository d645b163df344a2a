"""Device-side hashing: the murmur3 32-bit finalizer.

The port of `_fmix32` from the JAX package's `ops/hashing.py`, which the
hash-exchange group-by (`ops/hgroup.py`) uses to spread keys over
buckets. The JAX package computes in uint32; torch has no `>>` or `<` for
uint32 on the CPU, so each u32 word rides a non-negative int64 here.
`hash_columns` and the rest of that module come with the join slice.
"""

from __future__ import annotations

import torch

__all__ = ["U32_MASK", "fmix32"]

U32_MASK = 0xFFFFFFFF


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's fmix32 of u32 words held as int64 (any int64 input is
    first reduced mod 2^32, as a cast to uint32 would). Returns int64 in
    [0, 2^32).

    Each multiply is masked back to 32 bits at once: the int64 product
    of two values below 2^32 can pass 2^63, where it wraps, but its low
    32 bits are still those of the u32 product, on the CPU and on CUDA."""
    h = h.to(torch.int64) & U32_MASK
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & U32_MASK
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & U32_MASK
    return h ^ (h >> 16)
