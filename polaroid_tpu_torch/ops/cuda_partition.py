"""Hand-written CUDA stable compaction, with its plain PyTorch version.

The counterpart of the JAX package's `ops/pallas_partition.py`. Kernel B,
`compact_words`, replaces `compact_words` there (Pallas kernels
`_partition_concat_kernel` and `_concat_kernel`, one contract): the rows
where `mask` is true move to a stable prefix of every word
(source: csrc/compact.cu). It takes any n >= 1; the TPU's
8192-row tiling guard is gone, and a word may be 4 or 8 bytes wide.

One launch does the whole compaction: the mask is cut into as many tiles
as blocks fit the card; each block takes a tile by an atomic ticket,
counts its live rows, finds its offset by a decoupled look-back over the
earlier tiles' published counts, and writes each live row once; the last
tile writes the live count. The look-back's status words and the tile
ticket persist per device and stream (`cuda_build.zeroed_scratch`): the
last block to finish its look-back returns them to zero, so a call
allocates only its outputs and the count.

A wrapper runs its plain version only for tensors that lie on the CPU;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, List, Tuple

import torch

__all__ = ["compact_words", "compact_words_plain", "LAUNCHES", "RECORD"]

MAX_WORDS = 32     # words per launch; must equal PT_MAX_WORDS in csrc/compact.cu
# kernel launches made by `compact_words` (reset by callers that count them)
LAUNCHES = 0
# row count of the last launch (lets a caller see a full-width compaction)
LAST_ROWS = 0
# None, or a list to which each call on the card appends its (mask,
# words), so that a caller can hold the kernel against its plain version
# on the inputs a query gave it
RECORD = None


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
        if w.dim() != 1 or w.shape[0] != n or w.element_size() not in (4, 8):
            raise TypeError(f"compact_words: words must be ({n},) 4- or "
                            f"8-byte tensors, got {tuple(w.shape)} {w.dtype}")
        if w.stride(0) < 1:
            raise ValueError("compact_words: word strides must be >= 1")
        if w.device != mask.device:
            raise ValueError("compact_words: mask and words lie on "
                             "different devices")


def _disjoint(a: Tuple[int, int, int], b: Tuple[int, int, int],
              n: int) -> bool:
    """Whether two words' bytes in one storage never meet, or are the
    same bytes: each word is (byte offset, byte stride, element bytes)."""
    if a == b:
        return True
    (oa, sa, ea), (ob, sb, eb) = a, b
    if oa + (n - 1) * sa + ea <= ob or ob + (n - 1) * sb + eb <= oa:
        return True
    if sa != sb:
        return False
    d = (ob - oa) % sa
    return d >= ea and d + eb <= sa


def _mirror_outputs(words: List[torch.Tensor]) -> List[torch.Tensor]:
    """One output per word with the word's stride. Words that view one
    storage without sharing a byte between different rows (the two
    halves of an 8-byte column) get views of one new buffer at the same
    relative byte offsets, so the caller reads the 8-byte result back
    with a plain view; a word that would overlap another's bytes in a
    different place gets a buffer of its own."""
    n = words[0].shape[0]
    groups: Dict[int, List[list]] = {}   # storage -> [[word index, ...]]
    spans = []                           # (byte offset, stride, size)
    for i, w in enumerate(words):
        e = w.element_size()
        o = w.storage_offset() * e
        spans.append((o, w.stride(0) * e, e))
        mine = groups.setdefault(w.data_ptr() - o, [])
        for g in mine:
            if all(_disjoint(spans[j], spans[i], n) for j in g):
                g.append(i)
                break
        else:
            mine.append([i])
    outs: List[torch.Tensor] = [None] * len(words)
    for g in (g for gs in groups.values() for g in gs):
        if len(g) == 1:
            w = words[g[0]]
            outs[g[0]] = torch.empty_strided((n,), w.stride(), dtype=w.dtype,
                                             device=w.device)
            continue
        # 8-aligned, so that every word's offset is a whole element
        lo = min(spans[i][0] for i in g) // 8 * 8
        hi = max(o + (n - 1) * st + e for o, st, e in (spans[i] for i in g))
        buf = torch.empty(-(-(hi - lo) // 8) * 8, dtype=torch.uint8,
                          device=words[g[0]].device)
        for i in g:
            w, (o, _, e) = words[i], spans[i]
            outs[i] = buf.view(w.dtype).as_strided((n,), (w.stride(0),),
                                                   (o - lo) // e)
    return outs


_LIB = None
# device index -> the most tiles of a launch (the blocks that fit the card)
_BLOCKS: Dict[int, int] = {}


def _lib():
    """csrc/compact.cu's library, its entry point typed, its limits
    checked against this module's."""
    global _LIB
    if _LIB is None:
        from .cuda_build import library
        lib = library("compact")
        c, p = ctypes.c_int, ctypes.c_void_p
        lib.pt_compact_max_words.argtypes = []
        lib.pt_compact_max_words.restype = c
        lib.pt_compact_words.argtypes = [p, ctypes.c_longlong, c, p,
                                         ctypes.c_uint, p, p, c, c, c, p]
        lib.pt_compact_words.restype = c
        lib.pt_compact_blocks.argtypes = [p]
        lib.pt_compact_blocks.restype = c
        if lib.pt_compact_max_words() != MAX_WORDS:
            raise RuntimeError("csrc/compact.cu's PT_MAX_WORDS differs from "
                               "MAX_WORDS")
        _LIB = lib
    return _LIB


def _grid(lib, dev: torch.device) -> int:
    """The most tiles of a launch on `dev` (the current device): the
    blocks that fit the card at once, queried once."""
    blocks = _BLOCKS.get(dev.index)
    if blocks is None:
        from .cuda_build import check
        out = ctypes.c_int()
        check(lib, lib.pt_compact_blocks(ctypes.byref(out)),
              "compact_words occupancy")
        blocks = _BLOCKS[dev.index] = out.value
    return blocks


def compact_words(mask: torch.Tensor, words: List[torch.Tensor]
                  ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Stable-compact `words` ((n,) 4- or 8-byte tensors, strides allowed)
    so that the rows where `mask` is true form a prefix, in their original
    order; rows past the live count are garbage. Returns (compacted
    words, live count as a device int64 scalar). Never syncs the host."""
    global LAUNCHES, LAST_ROWS
    _check(mask, words)
    if mask.device.type == "cpu":
        return compact_words_plain(mask, words)
    if mask.device.type != "cuda":
        raise ValueError(f"compact_words: unsupported device {mask.device}")
    n = mask.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"compact_words: n = {n} rows, the kernel takes "
                         "fewer than 2^31")
    if RECORD is not None:
        RECORD.append((mask, list(words)))
    from .cuda_build import check, zeroed_scratch
    lib = _lib()
    outs = _mirror_outputs(words)
    count = torch.empty((), dtype=torch.int64, device=mask.device)
    dev = mask.device
    with (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
          else contextlib.nullcontext()):
        stream = torch.cuda.current_stream(dev).cuda_stream
        grid = _grid(lib, dev)
        # the tile ticket, the ticket of finished look-backs, a status
        # word per tile
        status = zeroed_scratch("compact", 2 + grid, dev, stream)
        for w0 in range(0, len(words), MAX_WORDS):
            ws, os_ = words[w0:w0 + MAX_WORDS], outs[w0:w0 + MAX_WORDS]
            # [input pointers, output pointers, strides] of the launch
            table = (ctypes.c_longlong * (3 * len(ws)))(
                *[w.data_ptr() for w in ws], *[o.data_ptr() for o in os_],
                *[w.stride(0) for w in ws])
            wide = sum(1 << i for i, w in enumerate(ws)
                       if w.element_size() == 8)
            err = lib.pt_compact_words(
                mask.data_ptr(), n, len(ws), table, wide, status.data_ptr(),
                count.data_ptr(), int(w0 == 0),
                int(w0 + MAX_WORDS >= len(words)), grid, stream)
            check(lib, err, "compact_words launch")
            LAUNCHES += 1
            LAST_ROWS = n
    return outs, count
