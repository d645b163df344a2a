"""Hand-written CUDA bitonic sort of word tuples, with its plain PyTorch
version, and `sort_ops` on top of it.

The counterpart of the JAX package's `ops/merge_sort.py`. Kernel F,
`merge_sort_words`, replaces `merge_sort_words` there (Pallas kernel
`_chunk_kernel` behind `_chunk_pass`): it sorts tuples of 32-bit words
lexicographically by their first `num_keys` words, the other words riding
along, as an alternating-direction bitonic network (source:
csrc/merge_sort.cu: a shared-memory tile pass for every distance below
the tile, one global pass per larger distance).

Unlike the JAX package, where the kernel is an opt-in beside
`lax.sort(num_keys=k)`, it is the port's only lexicographic sort over more
than one word: torch has no multi-operand sort (`torch.sort` sorts one
tensor). A key that fits one int64 with its row index goes to
`torch.sort` on a packed word instead (`ops/fused_sort.py`).

Words are 32-bit unsigned values held as non-negative int64 tensors
(torch has no unsigned compare on the CPU); the kernel gets them as int32
bit patterns in one [W, n] buffer and compares them as unsigned.

A wrapper runs its plain version only for tensors that lie on the CPU;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from ..dtypes import DataType, dtype_from_numpy

__all__ = ["merge_sort_words", "merge_sort_words_plain", "sort_ops",
           "tile_rows", "passes", "LAUNCHES"]

MAX_WORDS = 32          # words per row, injected index included; PT_MAX_WORDS
MAX_TILE = 4096         # rows of a shared-memory tile; PT_MAX_TILE
SMEM_BYTES = 232448     # shared memory a tile may use (227 KB); PT_SMEM_BYTES
# sorts run by `merge_sort_words` on the card, one per call of the kernel's
# entry point (each enqueues the tile and stage passes of one network);
# reset by callers that count them
LAUNCHES = 0


def tile_rows(n: int, words: int) -> int:
    """Rows T of the kernel's shared-memory tile for n rows of `words`
    words: the largest power of two up to MAX_TILE (and n) whose words fit
    SMEM_BYTES."""
    t = MAX_TILE
    while t > 1 and t * words * 4 > SMEM_BYTES:
        t //= 2
    return min(t, n)


def passes(n: int, words: int):
    """(stage passes, tile passes) the kernel makes over n rows."""
    t = tile_rows(n, words)
    levels = (n // t).bit_length() - 1      # levels 2T .. n
    return levels * (levels + 1) // 2, 1 + levels


def _check(operands: Sequence[torch.Tensor], num_keys: int,
           stable: bool) -> int:
    if not operands:
        raise ValueError("merge_sort_words: needs at least one word")
    n = operands[0].shape[0]
    if n < 1 or n & (n - 1) or n >= (1 << 31):
        raise ValueError(f"merge_sort_words needs power-of-two length "
                         f"below 2^31, got {n}")
    if not 1 <= num_keys <= len(operands):
        raise ValueError(f"merge_sort_words: num_keys {num_keys} outside "
                         f"[1, {len(operands)}]")
    if len(operands) + int(stable) > MAX_WORDS:
        raise ValueError(f"merge_sort_words: at most {MAX_WORDS} words, "
                         "the injected index included")
    for w in operands:
        if w.dim() != 1 or w.shape[0] != n or w.dtype != torch.int64:
            raise TypeError(f"merge_sort_words: words must be ({n},) int64 "
                            f"holding u32 values, got {tuple(w.shape)} "
                            f"{w.dtype}")
        if w.device != operands[0].device:
            raise ValueError("merge_sort_words: words lie on different "
                             "devices")
    return n


def merge_sort_words_plain(operands: Sequence[torch.Tensor], num_keys: int,
                           stable: bool = True) -> List[torch.Tensor]:
    """An LSD chain of stable `torch.sort` passes over the key words,
    least significant first, carrying the permutation. The result is the
    stable order for either `stable`; with stable=True the permutation is
    returned at out[num_keys], as the kernel returns its injected index."""
    n = _check(operands, num_keys, stable)
    perm = torch.arange(n, device=operands[0].device)
    for w in reversed(operands[:num_keys]):
        perm = perm[torch.sort(w[perm], stable=True).indices]
    out = [w[perm] for w in operands]
    if stable:
        out.insert(num_keys, perm)
    return out


def merge_sort_words(operands: Sequence[torch.Tensor], num_keys: int,
                     stable: bool = True) -> List[torch.Tensor]:
    """Sort 32-bit words (non-negative int64 tensors of one power-of-two
    length n < 2^31) lexicographically by the first `num_keys`; the other
    operands ride along.

    stable=True injects the row index as the last key word: every
    combined key is then distinct, the order is the stable one, and the
    index comes back at out[num_keys] as the sort permutation (sorted
    slot -> original row). With stable=False rows with equal keys come
    out in the network's order."""
    global LAUNCHES
    n = _check(operands, num_keys, stable)
    dev = operands[0].device
    if dev.type == "cpu":
        return merge_sort_words_plain(operands, num_keys, stable)
    if dev.type != "cuda":
        raise ValueError(f"merge_sort_words: unsupported device {dev}")
    from .cuda_build import check, library
    lib = library("merge_sort")
    lim = (ctypes.c_int * 3)()
    lib.pt_merge_sort_limits.argtypes = [ctypes.c_void_p]
    lib.pt_merge_sort_limits.restype = None
    lib.pt_merge_sort_limits(ctypes.addressof(lim))
    if tuple(lim) != (MAX_WORDS, MAX_TILE, SMEM_BYTES):
        raise RuntimeError("csrc/merge_sort.cu's limits differ from "
                           "ops/merge_sort.py's")
    fn = lib.pt_merge_sort_words
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    words = list(operands[:num_keys])
    if stable:
        words.append(torch.arange(n, device=dev))
    words += list(operands[num_keys:])
    nk = num_keys + int(stable)
    W = len(words)
    buf = torch.empty((W, n), dtype=torch.int32, device=dev)
    for row, w in zip(buf, words):
        row.copy_(w)            # the low 32 bits, as an int32 bit pattern
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(buf.data_ptr(), n, W, nk, tile_rows(n, W), stream)
        check(lib, err, "merge_sort_words launch")
        LAUNCHES += 1
    return list((buf.to(torch.int64) & 0xFFFFFFFF).unbind(0))


def sort_ops(operands: Sequence[torch.Tensor], num_keys: int,
             is_stable: bool = True,
             dtypes: Optional[Sequence[DataType]] = None
             ) -> List[torch.Tensor]:
    """The port of the JAX package's `sort_ops`, its `lax.sort`
    replacement for equal-length 1-D operands: key operands map to
    orderable words (`keycode.encode_orderable`), payloads to their
    bits, `merge_sort_words` sorts, and everything is decoded back.

    `dtypes` gives each operand's logical dtype where its storage does
    not name it (UInt32 and UInt64 live in int64, UInt16 in int32);
    the default reads it off the tensor. A length that is not a power of
    two is padded with all-ones keys and sorted stably, so the pads come
    after every row, all-ones rows included."""
    from .keycode import (U32, code_bits, col_from_u32_words,
                          col_to_u32_words, decode_orderable,
                          encode_orderable)
    if dtypes is None:
        dtypes = [dtype_from_numpy(torch.empty(0, dtype=o.dtype).numpy().dtype)
                  for o in operands]
    n = operands[0].shape[0]
    npad = 1 << max(n - 1, 0).bit_length()
    words: List[torch.Tensor] = []
    layout = []                     # (is key, dtype, words) per operand
    for i, (o, dt) in enumerate(zip(operands, dtypes)):
        if i < num_keys:
            u = encode_orderable(o, dt, False)
            ws = [(u >> 32) & U32, u & U32] if code_bits(dt) == 64 else [u]
        else:
            ws = col_to_u32_words(o, dt)
        words += ws
        layout.append((i < num_keys, dt, len(ws)))
    nk = sum(nw for key, _, nw in layout if key)
    stable = is_stable or npad != n
    if npad != n:
        words = [torch.cat([w, w.new_full((npad - n,), U32 if i < nk
                                          else 0)])
                 for i, w in enumerate(words)]
    out = merge_sort_words(words, nk, stable=stable)
    if stable:
        del out[nk]                 # the injected index
    res: List[torch.Tensor] = []
    wi = 0
    for key, dt, nw in layout:
        ws = [w[:n] for w in out[wi:wi + nw]]
        wi += nw
        if key:
            u = (ws[0] << 32) | ws[1] if nw == 2 else ws[0]
            res.append(decode_orderable(u, dt, False))
        else:
            res.append(col_from_u32_words(ws, dt))
    return res
