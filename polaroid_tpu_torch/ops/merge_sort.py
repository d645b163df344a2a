"""Hand-written CUDA radix sort of word tuples, with its plain PyTorch
version, and `sort_ops` on top of it.

The counterpart of the JAX package's `ops/merge_sort.py`. Kernel F,
`merge_sort_words`, replaces `merge_sort_words` there (Pallas kernel
`_chunk_kernel` behind `_chunk_pass`): it sorts tuples of 32-bit words
lexicographically by their first `num_keys` words, the other words riding
along, as a least-significant-digit radix sort over the key words' 8-bit
digits (source: csrc/radix_sort.cu): one histogram of every digit, one
chained-scan pass per digit whose rows do not all share one value, and a
placement of the output words through the final row index, the only
payload the passes move.

Unlike the JAX package, where the kernel is an opt-in beside
`lax.sort(num_keys=k)`, it is the port's only lexicographic sort over more
than one word: torch has no multi-operand sort (`torch.sort` sorts one
tensor). A key that fits one int64 with its row index goes to
`torch.sort` on a packed word instead (`ops/fused_sort.py`).

Words are 32-bit unsigned values held as non-negative int64 tensors
(torch has no unsigned compare on the CPU); the kernels read their low 32
bits in place.

A wrapper runs its plain version only for tensors that lie on the CPU;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dtypes import DataType, dtype_from_numpy

__all__ = ["merge_sort_words", "merge_sort_words_plain", "sort_ops",
           "digit_histograms", "digit_histograms_plain", "radix_plan",
           "LAUNCHES", "PASSES", "RECORD"]

MAX_WORDS = 32      # words per row, the index included; PT_MAX_WORDS
TILE = 3840         # rows of a digit pass's tile; PT_TILE
RADIX = 256         # values of an 8-bit digit; PT_RADIX
DIGITS = 4          # 8-bit digits of a 32-bit word
# sorts run by `merge_sort_words` on the card, one per call (each launches
# the histogram, the digit passes and the placement); reset by callers
# that count them
LAUNCHES = 0
# digit passes the last sort on the card ran (radix_plan's count)
PASSES = 0
# None, or a list to which each sort on the card appends its (operands,
# num_keys, stable, perm_only), so that a caller can hold the kernel
# against its plain version on the inputs a query gave it
RECORD = None


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


def digit_histograms_plain(words: Sequence[torch.Tensor],
                           num_keys: int) -> torch.Tensor:
    """[num_keys, 4, 256] int32: the rows of key word w whose digit d
    (bits 8d .. 8d + 7) is v, at [w, d, v]."""
    out = torch.zeros((num_keys, DIGITS, RADIX), dtype=torch.int32,
                      device=words[0].device)
    for w in range(num_keys):
        for d in range(DIGITS):
            out[w, d] = torch.bincount((words[w] >> (8 * d)) & (RADIX - 1),
                                       minlength=RADIX)
    return out


def radix_plan(hist: torch.Tensor, n: int
               ) -> Tuple[List[Tuple[int, int]], torch.Tensor]:
    """The digit passes of an LSD radix sort of n rows whose key words
    have the [nk, 4, 256] digit counts `hist`: (word, digit) pairs, least
    significant first (the last word's digit 0 first, the first word's
    digit 3 last), leaving out every digit whose n rows share one value (a
    pass over it is the identity); and each pass's digit bases, a [P, 256]
    int32 tensor on the CPU whose row p gives the first output slot of
    each digit value (the exclusive prefix of its counts)."""
    h = hist.cpu().numpy().astype(np.int64)
    trivial = (h == n).any(-1)
    passes = [(w, d) for w in reversed(range(h.shape[0]))
              for d in range(DIGITS) if not trivial[w, d]]
    excl = (np.cumsum(h, -1) - h).reshape(-1, RADIX)
    bases = excl[[w * DIGITS + d for w, d in passes]].astype(np.int32)
    return passes, torch.from_numpy(bases)


_LIB = None


def _lib():
    """csrc/radix_sort.cu's library, its entry points typed, its limits
    checked against this module's."""
    global _LIB
    if _LIB is None:
        from .cuda_build import library
        lib = library("radix_sort")
        c, p = ctypes.c_int, ctypes.c_void_p
        lib.pt_radix_limits.argtypes = [p]
        lib.pt_radix_limits.restype = None
        lib.pt_radix_histogram.argtypes = [p, ctypes.c_longlong, c, p, p]
        lib.pt_radix_histogram.restype = c
        lib.pt_radix_sort.argtypes = [p, c, ctypes.c_longlong, c, p, p, p, p,
                                      p, p, c, p, p, p]
        lib.pt_radix_sort.restype = c
        lim = (c * 3)()
        lib.pt_radix_limits(ctypes.addressof(lim))
        if tuple(lim) != (MAX_WORDS, TILE, RADIX):
            raise RuntimeError("csrc/radix_sort.cu's limits differ from "
                               "ops/merge_sort.py's")
        _LIB = lib
    return _LIB


def _ptrs(words: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * max(len(words), 1))(
        *[w.data_ptr() for w in words])


def _device(words: Sequence[torch.Tensor]) -> torch.device:
    dev = words[0].device
    if dev.type != "cuda":
        raise ValueError(f"merge_sort_words: unsupported device {dev}")
    return dev


def digit_histograms(words: Sequence[torch.Tensor],
                     num_keys: int) -> torch.Tensor:
    """The histogram kernel: `digit_histograms_plain` of int64 words of
    one power-of-two length n < 2^31."""
    _check(words, num_keys, False)
    if words[0].device.type == "cpu":
        return digit_histograms_plain(words, num_keys)
    dev = _device(words)
    from .cuda_build import check
    lib = _lib()
    words = [w.contiguous() for w in words[:num_keys]]
    hist = torch.zeros((num_keys, DIGITS, RADIX), dtype=torch.int32,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pt_radix_histogram(_ptrs(words), words[0].shape[0],
                                     num_keys, hist.data_ptr(), stream)
        check(lib, err, "digit_histograms launch")
    return hist


def merge_sort_words(operands: Sequence[torch.Tensor], num_keys: int,
                     stable: bool = True, perm_only: bool = False
                     ) -> List[torch.Tensor]:
    """Sort 32-bit words (non-negative int64 tensors of one power-of-two
    length n < 2^31) lexicographically by the first `num_keys`; the other
    operands ride along.

    The order is the stable one for either `stable` (a stable order is one
    of the orders an unstable sort may give). stable=True returns the
    permutation (sorted slot -> original row) at out[num_keys].
    perm_only=True returns [permutation] alone and reads only the key
    words."""
    global LAUNCHES, PASSES
    if perm_only:
        operands, stable = operands[:num_keys], True
    n = _check(operands, num_keys, stable)
    if operands[0].device.type == "cpu":
        out = merge_sort_words_plain(operands, num_keys, stable)
        return [out[num_keys]] if perm_only else out
    dev = _device(operands)
    if RECORD is not None:
        RECORD.append((list(operands), num_keys, stable, perm_only))
    from .cuda_build import check
    lib = _lib()
    words = [w.contiguous() for w in operands]
    # everything the passes need is allocated before the readback, so that
    # the device waits on the host only for the plan
    out = [] if perm_only else [torch.empty_like(w) for w in words]
    perm = torch.empty(n, dtype=torch.int64, device=dev) if stable else None
    # look-back words, then one tile ticket per pass
    status = torch.zeros(-(-n // TILE) * RADIX + DIGITS * num_keys,
                         dtype=torch.int64, device=dev)
    scratch = torch.empty((2, 2, n), dtype=torch.int32,
                          device=dev)           # [keys, index][ping, pong]
    hist = digit_histograms(words, num_keys)
    passes, bases = radix_plan(hist, n)     # the one readback (a sync)
    P = len(passes)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pt_radix_sort(
            _ptrs(words), len(words), n, P,
            (ctypes.c_int * max(P, 1))(*[w for w, _ in passes]),
            (ctypes.c_int * max(P, 1))(*[d for _, d in passes]),
            bases.data_ptr(), status.data_ptr(), scratch[0].data_ptr(),
            scratch[1].data_ptr(), int(not perm_only),
            _ptrs(out), None if perm is None else perm.data_ptr(), stream)
        check(lib, err, "merge_sort_words launch")
        LAUNCHES += 1
        PASSES = P
    if perm_only:
        return [perm]
    if stable:
        out.insert(num_keys, perm)
    return out


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
