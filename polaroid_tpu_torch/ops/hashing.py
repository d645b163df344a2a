"""Device-side hashing: the murmur3 32-bit finalizer.

The port of `_fmix32` from the JAX package's `ops/hashing.py`, which the
hash-exchange group-by (`ops/hgroup.py`) uses to spread keys over
buckets. The JAX package computes in uint32; torch has no `>>` or `<` for
uint32 on the CPU, so each u32 word rides a non-negative int64 here.
`hash_array` is `expr.hash()` over a column's logical values.
"""

from __future__ import annotations

import torch

__all__ = ["U32_MASK", "fmix32", "hash_array"]

U32_MASK = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


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


def _u32_words(x: torch.Tensor, dtype):
    """A column as one or two u32 words (int64), by its logical type as
    the JAX package stores it: 8-byte types as (hi, lo) of their bits,
    the rest as one word; a float's -0.0 hashes as 0.0."""
    if x.is_floating_point():
        x = torch.where(x == 0, torch.zeros_like(x), x)
        if x.dtype == torch.float64:
            x = x.view(torch.int64)
        else:
            return [x.view(torch.int32).to(torch.int64) & U32_MASK]
    from .keycode import code_bits
    x = x.to(torch.int64)
    if code_bits(dtype) == 64:
        return [(x >> 32) & U32_MASK, x & U32_MASK]
    return [x & U32_MASK]


def combine_hashes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a ^ ((b + GOLDEN + (a << 6) + (a >> 2)) & U32_MASK)) & U32_MASK


def hash_array(x: torch.Tensor, dtype, seed: int = 0) -> torch.Tensor:
    """u32 hash (int64) of each element, as the JAX package's
    `hash_array`: fmix32 of each word xor the seeded golden ratio,
    combined across the words."""
    h = (seed ^ GOLDEN) & U32_MASK
    acc = None
    for w in _u32_words(x, dtype):
        hw = fmix32(w ^ h)
        acc = hw if acc is None else combine_hashes(acc, hw)
    return acc
