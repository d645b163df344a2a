"""Hand-written CUDA bucket exchange, with its plain PyTorch version.

The counterpart of the JAX package's `ops/exchange.py`. Kernel E,
`bucket_exchange`, replaces `bucket_exchange` there (Pallas kernel
`_exchange_kernel`): B blocks of S = 8192 rows, each sorted so that the
rows of each of its K = 32 buckets form one contiguous run, go to a
bucket-major [K, B * CAP] layout of padded cells of CAP = 384 slots
(source: csrc/exchange.cu). Pad slots hold a fill word per word; a run
longer than CAP is cut at CAP, so the caller checks counts.max() <= CAP
first (`hgroup.precheck`) and takes its fallback otherwise.

Words are 4-byte bit patterns held in int32 tensors; a fill is given as
its u32 value (0xFFFFFFFF is -1 in the int32 tensor).

A wrapper runs its plain version only for tensors that lie on the CPU;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

__all__ = ["S", "K", "CAP", "bucket_exchange", "bucket_exchange_plain",
           "EXCHANGE_LAUNCHES", "RECORD"]

S = 8192          # block rows; must equal PT_S in csrc/exchange.cu
K = 32            # buckets per exchange; PT_K
CAP = 384         # cell capacity; PT_CAP
MAX_WORDS = 8     # words per launch; PT_MAX_WORDS
# kernel launches made by `bucket_exchange` (reset by callers that count
# them)
EXCHANGE_LAUNCHES = 0
# None, or a list to which each call on the card appends its (starts,
# counts, words, fills), so that a caller can hold the kernel against its
# plain version on the inputs a query gave it
RECORD = None


def _i32(fill: int) -> int:
    """A u32 fill word as the int32 with the same bits."""
    fill &= 0xFFFFFFFF
    return fill - (1 << 32) if fill >= (1 << 31) else fill


def _extents(starts: torch.Tensor, counts: torch.Tensor):
    """(start, kept length) of every cell, clamped as the kernel clamps
    them: starts to [0, S], lengths to [0, min(CAP, S - start)]."""
    s = starts.to(torch.int64).clamp(0, S)
    c = torch.minimum(counts.to(torch.int64).clamp(0, CAP), S - s)
    return s, c


def bucket_exchange_plain(starts: torch.Tensor, counts: torch.Tensor,
                          words: Sequence[torch.Tensor],
                          fills: Sequence[int]) -> List[torch.Tensor]:
    """The destination slot of every kept row, built in torch, and one
    scatter per word into a fill-initialised output."""
    B = starts.shape[0]
    dev = starts.device
    s, c = _extents(starts, counts)
    j = torch.arange(CAP, dtype=torch.int64, device=dev)
    b = torch.arange(B, dtype=torch.int64, device=dev)[:, None, None]
    k = torch.arange(K, dtype=torch.int64, device=dev)[None, :, None]
    keep = j < c[:, :, None]                                  # (B, K, CAP)
    src = (b * S + s[:, :, None] + j).clamp(max=B * S - 1)
    # slots past a run go to one extra slot, dropped after the scatter
    M = B * K * CAP
    dst = torch.where(keep, k * (B * CAP) + b * CAP + j,
                      torch.full_like(keep, M, dtype=torch.int64))
    outs = []
    for w, fill in zip(words, fills):
        out = torch.full((M + 1,), _i32(fill), dtype=torch.int32, device=dev)
        out.scatter_(0, dst.reshape(-1), w[src.reshape(-1)])
        outs.append(out[:M].view(K, B * CAP))
    return outs


def _check(starts: torch.Tensor, counts: torch.Tensor,
           words: Sequence[torch.Tensor], fills: Sequence[int]) -> None:
    for name, t in (("starts", starts), ("counts", counts)):
        if t.dim() != 2 or t.shape[1] != K or t.shape[0] < 1 or \
                t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"bucket_exchange: {name} must be a contiguous "
                            f"(B, {K}) int32, got {tuple(t.shape)} {t.dtype}")
    if counts.shape != starts.shape or counts.device != starts.device:
        raise ValueError("bucket_exchange: starts and counts differ in "
                         "shape or device")
    n = starts.shape[0] * S
    if not 1 <= len(words) <= MAX_WORDS or len(words) != len(fills):
        raise ValueError(f"bucket_exchange: needs 1 to {MAX_WORDS} words "
                         "and one fill per word")
    for w in words:
        if w.dim() != 1 or w.shape[0] != n or w.dtype != torch.int32 or \
                not w.is_contiguous():
            raise TypeError(f"bucket_exchange: words must be contiguous "
                            f"({n},) int32, got {tuple(w.shape)} {w.dtype}")
        if w.device != starts.device:
            raise ValueError("bucket_exchange: words and starts lie on "
                             "different devices")


def bucket_exchange(starts: torch.Tensor, counts: torch.Tensor,
                    words: Sequence[torch.Tensor], fills: Sequence[int]
                    ) -> List[torch.Tensor]:
    """words: 1 to MAX_WORDS (B * S,) int32 bit patterns, each block
    sorted so that its bucket runs are contiguous; starts/counts: (B, K)
    int32 run extents.
    Returns one (K, B * CAP) int32 tensor per word, bucket-major; pad
    slots hold fills[w]; rows past CAP in a cell are dropped."""
    global EXCHANGE_LAUNCHES
    _check(starts, counts, words, fills)
    if starts.device.type == "cpu":
        return bucket_exchange_plain(starts, counts, words, fills)
    if starts.device.type != "cuda":
        raise ValueError(f"bucket_exchange: unsupported device "
                         f"{starts.device}")
    if RECORD is not None:
        RECORD.append((starts, counts, list(words), list(fills)))
    from .cuda_build import check, library
    lib = library("exchange")
    geo = (ctypes.c_int * 4)()
    lib.pt_exchange_geometry.argtypes = [ctypes.c_void_p]
    lib.pt_exchange_geometry.restype = None
    lib.pt_exchange_geometry(ctypes.addressof(geo))
    if tuple(geo) != (S, K, CAP, MAX_WORDS):
        raise RuntimeError("csrc/exchange.cu's geometry differs from "
                           "ops/exchange.py's")
    fn = lib.pt_bucket_exchange
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B = starts.shape[0]
    outs = [torch.empty((K, B * CAP), dtype=torch.int32,
                        device=starts.device) for _ in words]
    W = len(words)
    ins = (ctypes.c_void_p * W)(*[w.data_ptr() for w in words])
    ous = (ctypes.c_void_p * W)(*[o.data_ptr() for o in outs])
    fl = (ctypes.c_uint32 * W)(*[f & 0xFFFFFFFF for f in fills])
    with torch.cuda.device(starts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(starts.data_ptr(), counts.data_ptr(), B, W,
                 ctypes.addressof(ins), ctypes.addressof(ous),
                 ctypes.addressof(fl), stream)
        check(lib, err, "bucket_exchange launch")
        EXCHANGE_LAUNCHES += 1
    return outs
