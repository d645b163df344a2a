"""Hand-written CUDA stable compaction, with its plain PyTorch version.

The counterpart of the JAX package's `ops/pallas_partition.py`. Kernel B,
`compact_words`, replaces `compact_words` there (Pallas kernels
`_partition_concat_kernel` and `_concat_kernel`, one contract): the rows
where `mask` is true move to a stable prefix of every word
(source: csrc/compact.cu). It takes any n >= 1; the TPU's
8192-row tiling guard is gone.

As on the TPU, the per-tile live counts and their exclusive prefix are
computed outside the kernel, here as torch ops; the kernel ranks the live
rows of each tile with warp ballots and writes each live row once.

A wrapper runs its plain version only for tensors that lie on the CPU;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

__all__ = ["compact_words", "compact_words_plain", "LAUNCHES"]

TILE = 1024        # rows per block; must equal PT_TILE in csrc/compact.cu
MAX_WORDS = 32     # words per launch; must equal PT_MAX_WORDS
# kernel launches made by `compact_words` (reset by callers that count them)
LAUNCHES = 0
# row count of the last launch (lets a caller see a full-width compaction)
LAST_ROWS = 0


def compact_words_plain(mask: torch.Tensor, words: List[torch.Tensor]
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """nonzero + gather: the live rows of each word to its prefix (the
    outputs are laid out as the kernel's, see _mirror_outputs)."""
    idx = torch.nonzero(mask).squeeze(1)
    outs = _mirror_outputs(words)
    for w, out in zip(words, outs):
        out[:idx.numel()] = w[idx]
    return outs, mask.sum()


def _check(mask: torch.Tensor, words: List[torch.Tensor]) -> None:
    if mask.dim() != 1 or mask.dtype != torch.bool or \
            not mask.is_contiguous():
        raise TypeError("compact_words: mask must be a contiguous (n,) bool")
    n = mask.shape[0]
    if n < 1 or not words:
        raise ValueError("compact_words: needs n >= 1 and at least one word")
    for w in words:
        if w.dim() != 1 or w.shape[0] != n or w.element_size() != 4:
            raise TypeError(f"compact_words: words must be ({n},) 4-byte "
                            f"tensors, got {tuple(w.shape)} {w.dtype}")
        if w.stride(0) < 1:
            raise ValueError("compact_words: word strides must be >= 1")
        if w.device != mask.device:
            raise ValueError("compact_words: mask and words lie on "
                             "different devices")


def _mirror_outputs(words: List[torch.Tensor]) -> List[torch.Tensor]:
    """One output per word with the word's stride; words that view one
    buffer (the two halves of an 8-byte column) get views of one new
    buffer at the same relative offsets, so the caller reads the 8-byte
    result back with a plain view."""
    n = words[0].shape[0]
    spans = {}
    for w in words:
        key = w.untyped_storage().data_ptr()
        lo = w.storage_offset()
        hi = lo + (n - 1) * w.stride(0) + 1
        a, b = spans.get(key, (lo, hi))
        spans[key] = (min(a, lo), max(b, hi))
    bufs = {}
    outs = []
    for w in words:
        key = w.untyped_storage().data_ptr()
        lo, hi = spans[key]
        if key not in bufs:
            bufs[key] = torch.empty(hi - lo, dtype=w.dtype, device=w.device)
        buf = bufs[key].view(w.dtype)
        outs.append(buf.as_strided((n,), (w.stride(0),),
                                   w.storage_offset() - lo))
    return outs


def _tile_offsets(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(exclusive prefix of the per-tile live counts, total live count)."""
    n = mask.shape[0]
    full = n // TILE
    counts = mask[:full * TILE].view(full, TILE).sum(1)
    if n % TILE:
        counts = torch.cat([counts, mask[full * TILE:].sum().view(1)])
    incl = torch.cumsum(counts, 0)
    return incl - counts, incl[-1]


def compact_words(mask: torch.Tensor, words: List[torch.Tensor]
                  ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Stable-compact `words` ((n,) 4-byte tensors, strides allowed) so
    that the rows where `mask` is true form a prefix, in their original
    order; rows past the live count are garbage. Returns (compacted
    words, live count as a device int64 scalar). Never syncs the host."""
    global LAUNCHES, LAST_ROWS
    _check(mask, words)
    if mask.device.type == "cpu":
        return compact_words_plain(mask, words)
    if mask.device.type != "cuda":
        raise ValueError(f"compact_words: unsupported device {mask.device}")
    from .cuda_build import check, library
    lib = library("compact")
    lib.pt_compact_tile.argtypes = []
    lib.pt_compact_tile.restype = ctypes.c_int
    if lib.pt_compact_tile() != TILE:
        raise RuntimeError("csrc/compact.cu's PT_TILE differs from TILE")
    fn = lib.pt_compact_words
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = mask.shape[0]
    offs, count = _tile_offsets(mask)
    outs = _mirror_outputs(words)
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream().cuda_stream
        for w0 in range(0, len(words), MAX_WORDS):
            ws, os_ = words[w0:w0 + MAX_WORDS], outs[w0:w0 + MAX_WORDS]
            W = len(ws)
            ins = (ctypes.c_void_p * W)(*[w.data_ptr() for w in ws])
            ous = (ctypes.c_void_p * W)(*[o.data_ptr() for o in os_])
            strides = (ctypes.c_longlong * W)(*[w.stride(0) for w in ws])
            err = fn(mask.data_ptr(), offs.data_ptr(), n, W,
                     ctypes.addressof(ins), ctypes.addressof(ous),
                     ctypes.addressof(strides), stream)
            check(lib, err, "compact_words launch")
            LAUNCHES += 1
            LAST_ROWS = n
    return outs, count
