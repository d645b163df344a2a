"""Hand-written CUDA kernels for the aggregation paths, with their plain
PyTorch versions.

The counterpart of the JAX package's `ops/pallas_kernels.py`:
* kernel A, `seg_sum`, replaces `onehot_seg_sum` (`_seg_sum_kernel`):
  per-group sums of C value rows over dense group ids, in one pass over
  the rows (source: csrc/seg_sum.cu). The TPU kernel's radix one-hot
  matrix product was a formulation for the MXU; on the card each block
  adds rows into f64 partial sums in shared memory.
* kernel C, `seg_minmax`, replaces `onehot_seg_minmax`
  (`_seg_minmax_kernel`): per-group min or max of one row, typed
  (f32, f64, int32, int64) where the TPU kernel is f32 only, in one
  launch whose last block decodes the result (source:
  csrc/seg_minmax.cu).
* kernel D, `gather`, replaces `onehot_gather` (`_gather_kernel`):
  out[i] = table[gid[i]], in the table's type (f32 or f64) where the TPU
  kernel gathers in f32 through the MXU (source: csrc/gather.cu).

A wrapper runs its plain version only for tensors that lie on the CPU;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from .segment import segment_minmax, segment_sum, segment_take

__all__ = ["seg_sum", "seg_sum_plain", "seg_minmax", "seg_minmax_plain",
           "gather", "gather_plain", "MAX_GROUPS", "LAUNCHES",
           "MINMAX_LAUNCHES", "GATHER_LAUNCHES", "RECORD", "MINMAX_RECORD"]

# the most groups kernels A and C take: the JAX package's largest dense
# key range (`_DENSE_G` of its adaptive local group-by). One block's
# C x G f64 partials of A must fit shared memory (3 rows at 8192, so
# `seg_sum` splits C), and C keeps 2 x G keys in it (128 KB at 8192).
# The group-by's dense tier keeps its own, smaller bound
# (`ops/groupby.py` DENSE_GROUPS).
MAX_GROUPS = 8192
# dynamic shared memory one block may use on sm_90 (227 KB)
_SMEM_BYTES = 232448
# kernel launches made by `seg_sum`, `seg_minmax` and `gather` (reset by
# callers that count them)
LAUNCHES = 0
MINMAX_LAUNCHES = 0
GATHER_LAUNCHES = 0
# None, or a list to which each `seg_sum` call on the card appends its
# (vals, gid, G), so that a caller can hold the kernel against its plain
# version on the inputs a query gave it
RECORD = None
# the same for kernel C: each launch on the card appends its (x, gid, G,
# is_max, identity)
MINMAX_RECORD = None


def seg_sum_plain(vals: torch.Tensor, gid: torch.Tensor, G: int
                  ) -> torch.Tensor:
    """out[c, g] = sum_i vals[c, i] * [gid[i] == g], in f64: one
    index_add_, ids outside [0, G) dropped (`segment.segment_sum`)."""
    return segment_sum(vals, gid, G)


def _check(vals: torch.Tensor, gid: torch.Tensor, G: int) -> None:
    if vals.dim() != 2 or vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"seg_sum: vals must be (C, n) float32/float64, got "
                        f"{tuple(vals.shape)} {vals.dtype}")
    if gid.dim() != 1 or gid.dtype != torch.int32 or \
            gid.shape[0] != vals.shape[1]:
        raise TypeError(f"seg_sum: gid must be ({vals.shape[1]},) int32, "
                        f"got {tuple(gid.shape)} {gid.dtype}")
    if not (vals.is_contiguous() and gid.is_contiguous()):
        raise ValueError("seg_sum: inputs must be contiguous")
    if vals.device != gid.device:
        raise ValueError("seg_sum: vals and gid lie on different devices")
    if not 1 <= G <= MAX_GROUPS:
        raise ValueError(f"seg_sum: G={G} outside [1, {MAX_GROUPS}]")


def seg_sum(vals: torch.Tensor, gid: torch.Tensor, G: int) -> torch.Tensor:
    """Per-group sums of the rows of `vals` ((C, n) f32 or f64) over group
    ids `gid` ((n,) int32); ids outside [0, G) contribute nothing.
    Returns (C, G) float64. G <= MAX_GROUPS."""
    global LAUNCHES
    _check(vals, gid, G)
    if vals.device.type == "cpu":
        return seg_sum_plain(vals, gid, G)
    if vals.device.type != "cuda":
        raise ValueError(f"seg_sum: unsupported device {vals.device}")
    if RECORD is not None:
        RECORD.append((vals, gid, G))
    from .cuda_build import check, library
    lib = library("seg_sum")
    fn = lib.pt_seg_sum_f32 if vals.dtype == torch.float32 \
        else lib.pt_seg_sum_f64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    C, n = vals.shape
    out = torch.zeros((C, G), dtype=torch.float64, device=vals.device)
    # split C so that one block's C x G f64 partials fit shared memory
    rows = max(1, _SMEM_BYTES // (G * 8))
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, C, rows):
            c1 = min(C, c0 + rows)
            err = fn(vals[c0:c1].data_ptr(), gid.data_ptr(), n, c1 - c0, G,
                     out[c0:c1].data_ptr(), stream)
            check(lib, err, "seg_sum launch")
            LAUNCHES += 1
    return out


# --- kernel C: segment min / max -------------------------------------------

# dtype -> (type code of pt_seg_minmax_blocks, entry point suffix)
_MINMAX_TYPES = {torch.float32: (0, "f32"), torch.float64: (1, "f64"),
                 torch.int32: (2, "i32"), torch.int64: (3, "i64")}


def seg_minmax_plain(x: torch.Tensor, gid: torch.Tensor, G: int,
                     is_max: bool, identity) -> torch.Tensor:
    """scatter_reduce_ of the order keys (ids outside [0, G) dropped),
    decoded back to values, with each group's largest NaN bit pattern
    kept for floats, as in the kernel (`segment.segment_minmax`)."""
    return segment_minmax(x, gid, G, is_max, identity)


def _check_minmax(x: torch.Tensor, gid: torch.Tensor, G: int,
                  identity) -> None:
    if x.dim() != 1 or x.dtype not in _MINMAX_TYPES:
        raise TypeError(f"seg_minmax: x must be (n,) float32/float64/int32/"
                        f"int64, got {tuple(x.shape)} {x.dtype}")
    if gid.dim() != 1 or gid.dtype != torch.int32 or \
            gid.shape[0] != x.shape[0]:
        raise TypeError(f"seg_minmax: gid must be ({x.shape[0]},) int32, "
                        f"got {tuple(gid.shape)} {gid.dtype}")
    if not (x.is_contiguous() and gid.is_contiguous()):
        raise ValueError("seg_minmax: inputs must be contiguous")
    if x.device != gid.device:
        raise ValueError("seg_minmax: x and gid lie on different devices")
    if not 1 <= G <= MAX_GROUPS:
        raise ValueError(f"seg_minmax: G={G} outside [1, {MAX_GROUPS}]")
    if identity != identity:
        raise ValueError("seg_minmax: the identity must not be NaN")


_MINMAX_LIB = None
# (device index, dtype, is_max, G) -> the most blocks that fit the card
_MINMAX_BLOCKS: dict = {}


def _minmax_lib():
    """csrc/seg_minmax.cu's library with its entry points typed."""
    global _MINMAX_LIB
    if _MINMAX_LIB is None:
        from .cuda_build import library
        lib = library("seg_minmax")
        c, p = ctypes.c_int, ctypes.c_void_p
        lib.pt_seg_minmax_blocks.argtypes = [c, c, c, p]
        lib.pt_seg_minmax_blocks.restype = c
        for _, suffix in _MINMAX_TYPES.values():
            fn = getattr(lib, "pt_seg_minmax_" + suffix)
            ident = ctypes.c_double if suffix[0] == "f" \
                else ctypes.c_longlong
            fn.argtypes = [p, p, ctypes.c_longlong, c, c, ident, p, p, c, p]
            fn.restype = c
        lib.pt_seg_minmax_max_groups.argtypes = []
        lib.pt_seg_minmax_max_groups.restype = c
        if lib.pt_seg_minmax_max_groups() != MAX_GROUPS:
            raise RuntimeError("csrc/seg_minmax.cu's PT_MAX_GROUPS differs "
                               "from MAX_GROUPS")
        _MINMAX_LIB = lib
    return _MINMAX_LIB


def seg_minmax(x: torch.Tensor, gid: torch.Tensor, G: int, is_max: bool,
               identity) -> torch.Tensor:
    """Per-group min (or max, `is_max`) of `x` ((n,) f32, f64, int32 or
    int64) over group ids `gid` ((n,) int32); ids outside [0, G) are
    ignored and a group with no rows gives `identity`. A group holding a
    NaN gives NaN (of its NaNs, the one whose bits are largest as an
    unsigned integer); -0.0 orders below +0.0. Returns (G,) in x's dtype.
    G <= MAX_GROUPS."""
    global MINMAX_LAUNCHES
    _check_minmax(x, gid, G, identity)
    if x.device.type == "cpu":
        return seg_minmax_plain(x, gid, G, is_max, identity)
    if x.device.type != "cuda":
        raise ValueError(f"seg_minmax: unsupported device {x.device}")
    from .cuda_build import check, zeroed_scratch
    lib = _minmax_lib()
    code, suffix = _MINMAX_TYPES[x.dtype]
    floating = x.dtype.is_floating_point
    out = torch.empty(G, dtype=x.dtype, device=x.device)
    dev = x.device
    with (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
          else contextlib.nullcontext()):
        key = (dev.index, x.dtype, bool(is_max), G)
        blocks = _MINMAX_BLOCKS.get(key)
        if blocks is None:
            n_blocks = ctypes.c_int()
            err = lib.pt_seg_minmax_blocks(code, int(is_max), G,
                                           ctypes.byref(n_blocks))
            check(lib, err, "seg_minmax occupancy")
            blocks = _MINMAX_BLOCKS[key] = n_blocks.value
        stream = torch.cuda.current_stream(dev).cuda_stream
        # keys and NaN patterns of MAX_GROUPS groups, then the ticket of
        # finished blocks
        scratch = zeroed_scratch("seg_minmax", 2 * MAX_GROUPS + 1, dev,
                                 stream)
        err = getattr(lib, "pt_seg_minmax_" + suffix)(
            x.data_ptr(), gid.data_ptr(), x.shape[0], G, int(is_max),
            float(identity) if floating else int(identity), out.data_ptr(),
            scratch.data_ptr(), blocks, stream)
        check(lib, err, "seg_minmax launch")
        MINMAX_LAUNCHES += 1
        if MINMAX_RECORD is not None:
            MINMAX_RECORD.append((x, gid, G, bool(is_max), identity))
    return out


# --- kernel D: group -> row gather ------------------------------------------

def gather_plain(table: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """Index a zero-padded table: ids outside [0, G) read the pad."""
    return segment_take(table, gid)


def _check_gather(table: torch.Tensor, gid: torch.Tensor) -> None:
    if table.dim() != 1 or table.dtype not in (torch.float32,
                                               torch.float64) or \
            table.shape[0] < 1:
        raise TypeError(f"gather: table must be (G >= 1,) float32/float64, "
                        f"got {tuple(table.shape)} {table.dtype}")
    if gid.dim() != 1 or gid.dtype != torch.int32:
        raise TypeError(f"gather: gid must be (n,) int32, got "
                        f"{tuple(gid.shape)} {gid.dtype}")
    if not (table.is_contiguous() and gid.is_contiguous()):
        raise ValueError("gather: inputs must be contiguous")
    if table.device != gid.device:
        raise ValueError("gather: table and gid lie on different devices")


def gather(table: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """out[i] = table[gid[i]] for a (G,) f32 or f64 table and (n,) int32
    ids; 0 where gid[i] lies outside [0, G). Returns (n,) in the table's
    dtype."""
    global GATHER_LAUNCHES
    _check_gather(table, gid)
    if table.device.type == "cpu":
        return gather_plain(table, gid)
    if table.device.type != "cuda":
        raise ValueError(f"gather: unsupported device {table.device}")
    from .cuda_build import check, library
    lib = library("gather")
    fn = lib.pt_gather_f32 if table.dtype == torch.float32 \
        else lib.pt_gather_f64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(gid.shape[0], dtype=table.dtype, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), table.shape[0], gid.data_ptr(),
                 gid.shape[0], out.data_ptr(), stream)
        check(lib, err, "gather launch")
        GATHER_LAUNCHES += 1
    return out
