"""Per-group reductions over any number of groups, as torch scatter ops.

The hash tier of the group-by (`ops/groupby.py`, `ops/hgroup.py`) numbers
its groups up to the table's capacity, far past the dense tier's 4096
slots that the one-hot kernels hold in shared memory. These reductions
stand in for the JAX package's XLA segmented scans there
(`_seg_scan_doubling_multi`, `jax.ops.segment_*`), which no Pallas
kernel computes. The kernels' plain versions in `cuda_kernels` are the
same functions at G <= 8192, so they call these.

Group ids outside [0, G) (dead rows, rows that take no part) are
spread over SPILL extra slots and dropped. Routed to one slot, their
atomics would all serialise on one address, which made each scatter of
a 2^24-row table with 6.8M dead rows cost milliseconds on the H100
(PERF.md has the traces).
"""

from __future__ import annotations

import torch

__all__ = ["SPILL", "spill_slots", "segment_sum", "segment_sum_int",
           "segment_prod", "segment_minmax", "segment_take", "minmax_keys"]

# the signed integer type a float's order keys live in
_KEY_TYPES = {torch.float32: torch.int32, torch.float64: torch.int64}
# extra slots that the rows outside every group are spread over
SPILL = 1024


def spill_slots(n: int, base: int, device) -> torch.Tensor:
    """(n,) int64: base + (i mod SPILL), the spill slot of row i."""
    return base + (torch.arange(n, dtype=torch.int64, device=device)
                   & (SPILL - 1))


def _route(gid: torch.Tensor, G: int) -> torch.Tensor:
    """Ids in [0, G) as they are, the others to their spill slots past G
    (the outputs hold G + SPILL slots)."""
    return torch.where((gid >= 0) & (gid < G), gid.long(),
                       spill_slots(gid.shape[0], G, gid.device))


def segment_sum(vals: torch.Tensor, gid: torch.Tensor, G: int
                ) -> torch.Tensor:
    """out[c, g] = sum of vals[c, i] over gid[i] == g, in f64, for
    (C, n) rows: one index_add_."""
    out = torch.zeros((vals.shape[0], G + SPILL), dtype=torch.float64,
                      device=vals.device)
    out.index_add_(1, _route(gid, G), vals.to(torch.float64))
    return out[:, :G]


def segment_sum_int(x: torch.Tensor, gid: torch.Tensor, G: int
                    ) -> torch.Tensor:
    """Exact int64 per-group sums of an integer row, as the JAX
    package's `_seg_sum` scatter."""
    out = torch.zeros(G + SPILL, dtype=torch.int64, device=x.device)
    out.index_add_(0, _route(gid, G), x.to(torch.int64))
    return out[:G]


def segment_prod(x: torch.Tensor, gid: torch.Tensor, G: int
                 ) -> torch.Tensor:
    """Per-group products of an f64 or int64 row over each group's own
    rows (1 for a group with none): int64 wraps modulo 2^64, so an
    integer product is exact in any order. No Pallas kernel computes it:
    the JAX package divides a running cumprod instead, which a zero or
    an overflow in an earlier group spoils."""
    out = torch.ones(G + SPILL, dtype=x.dtype, device=x.device)
    out.scatter_reduce_(0, _route(gid, G), x, "prod")
    return out[:G]


def minmax_keys(x: torch.Tensor, is_max: bool) -> torch.Tensor:
    """Signed-integer keys in the order the reduction wants (the encoding
    of csrc/seg_minmax.cu): ints as they are; a float's bits b as
    b >= 0 ? b : b ^ 0x7f..f, so -0.0 < +0.0; any NaN as the key that
    wins (the key type's min for min, its max for max)."""
    if not x.dtype.is_floating_point:
        return x
    info = torch.iinfo(_KEY_TYPES[x.dtype])
    b = x.view(_KEY_TYPES[x.dtype])
    key = torch.where(b >= 0, b, b ^ info.max)
    return torch.where(torch.isnan(x),
                       torch.full_like(key, info.max if is_max else info.min),
                       key)


def segment_minmax(x: torch.Tensor, gid: torch.Tensor, G: int,
                   is_max: bool, identity) -> torch.Tensor:
    """Per-group min (or max) of (n,) f32, f64, int32 or int64 values; a
    group with no rows gives `identity`. scatter_reduce_ of the order
    keys, decoded back to values: a group holding a NaN gives NaN, -0.0
    orders below +0.0. For floats a second scatter keeps each group's
    largest NaN bit pattern (as unsigned), which a group whose key is the
    NaN key decodes to, as csrc/seg_minmax.cu does."""
    idx = _route(gid, G)
    ident = minmax_keys(torch.tensor([identity], dtype=x.dtype), is_max)
    out = ident.to(x.device).expand(G + SPILL).clone()
    out.scatter_reduce_(0, idx, minmax_keys(x, is_max),
                        "amax" if is_max else "amin")
    out = out[:G]
    if not x.dtype.is_floating_point:
        return out
    info = torch.iinfo(out.dtype)
    # bits ^ sign bit puts the unsigned order of the bits in signed order
    ub = torch.where(torch.isnan(x), x.view(out.dtype) ^ info.min,
                     torch.full_like(idx, info.min, dtype=out.dtype))
    nan_bits = torch.full((G + SPILL,), info.min, dtype=out.dtype,
                          device=x.device)
    nan_bits.scatter_reduce_(0, idx, ub, "amax")
    bits = torch.where(out >= 0, out, out ^ info.max)
    nan_key = info.max if is_max else info.min
    return torch.where(out == nan_key, nan_bits[:G] ^ info.min,
                       bits).view(x.dtype)


def segment_take(table: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """out[i] = table[gid[i]], and 0 where gid[i] lies outside [0, G)."""
    G = table.shape[0]
    idx = torch.where((gid >= 0) & (gid < G), gid, torch.full_like(gid, G))
    return torch.cat([table, table.new_zeros(1)])[idx.long()]
