"""Hand-written CUDA kernels for the aggregation paths, with their plain
PyTorch versions.

The counterpart of the JAX package's `ops/pallas_kernels.py`:
* kernel A, `seg_sum`, replaces `onehot_seg_sum` (`_seg_sum_kernel`):
  per-group sums of C value rows over dense group ids, in one pass over
  the rows and one launch (source: csrc/seg_sum.cu). The TPU kernel's
  radix one-hot matrix product was a formulation for the MXU; on the card
  each warp adds the rows that share a group by shuffles, and the block
  keeps f64 partial sums in shared memory (`seg_sum_plan` sizes them).
  With `count=True` row 0 of the result counts the ids in [0, G), which
  the kernel takes from `gid` alone: a caller that wants a group's row
  count passes no row of ones, and `vals` may have no row at all.
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

import collections
import contextlib
import ctypes

import torch

from .segment import segment_minmax, segment_sum, segment_take

__all__ = ["seg_sum", "seg_sum_plain", "seg_sum_plan", "SegSumPlan",
           "seg_minmax", "seg_minmax_plain",
           "gather", "gather_plain", "MAX_GROUPS", "LAUNCHES",
           "MINMAX_LAUNCHES", "GATHER_LAUNCHES", "RECORD", "MINMAX_RECORD"]

# the most groups kernels A and C take: the JAX package's largest dense
# key range (`_DENSE_G` of its adaptive local group-by). A keeps a block's
# f64 partials of up to 3 columns at 8192 in shared memory (`seg_sum_plan`
# puts more columns in further blocks of the same launch), and C keeps
# 2 x G keys in it (128 KB at 8192). The group-by's dense tier keeps its
# own, smaller bound (`ops/groupby.py` DENSE_GROUPS).
MAX_GROUPS = 8192
# dynamic shared memory one block may use on sm_90 (227 KB)
_SMEM_BYTES = 232448
# kernel A: its block (csrc/seg_sum.cu kMaxThreads, whose
# __launch_bounds__ holds a thread to 64 registers: one such block an SM),
# the most columns one block takes, the rows each thread holds in flight by
# that most (RowsInFlight), and the work that adding by peer sets must save
# for a warp to add a chunk so: a sampled 32-row slot's rows in [0, G) less
# their distinct groups, at least this over the columns a block takes (and
# at least 2)
_SEG_THREADS = 1024
_SEG_CMAX = (0, 1, 2, 4, 8)
_SEG_ROWS = {0: 8, 1: 8, 2: 8, 4: 4, 8: 2}
_SEG_AGGREGATE_WORK = 12
# kernel launches made by `seg_sum`, `seg_minmax` and `gather` (reset by
# callers that count them)
LAUNCHES = 0
MINMAX_LAUNCHES = 0
GATHER_LAUNCHES = 0
# None, or a list to which each `seg_sum` call on the card appends its
# (vals, gid, G, count), so that a caller can hold the kernel against its
# plain version on the inputs a query gave it
RECORD = None
# the same for kernel C: each launch on the card appends its (x, gid, G,
# is_max, identity)
MINMAX_RECORD = None


def seg_sum_plain(vals: torch.Tensor, gid: torch.Tensor, G: int,
                  count: bool = False) -> torch.Tensor:
    """out[c, g] = sum_i vals[c, i] * [gid[i] == g], in f64: one
    index_add_, ids outside [0, G) dropped (`segment.segment_sum`); with
    `count`, over a row of ones put before the rows of `vals`."""
    if count:
        vals = torch.cat([torch.ones((1, vals.shape[1]), dtype=vals.dtype,
                                     device=vals.device), vals])
    return segment_sum(vals, gid, G)


SegSumPlan = collections.namedtuple("SegSumPlan", [
    "launches", "cmax", "cols", "groups", "replicas", "private", "threads",
    "blocks", "smem", "aggregate_at"])


def seg_sum_plan(C: int, G: int, count: bool, sms: int, n: int
                 ) -> SegSumPlan:
    """Kernel A's launch for C value rows (and a count row with `count`)
    over n rows and G groups on a card of `sms` SMs: one launch of
    `blocks` blocks of `threads`, one an SM; `cols` columns a block (f64
    partials of at most 8 columns, as many as fit a block's shared memory
    beside a u32 count row), in `groups` column groups (the count in the
    first; `blocks` is a multiple of `groups`, fewer than the SMs where n
    gives a block fewer than one chunk of rows a thread); `cmax` the
    kernel's most columns a block (a power of two, 0 for a count alone);
    `replicas` copies of a block's partials: one a warp (`private`: the
    adds of a warp's peer sets need no atomics) where they fit, else two
    where they fit, else one; `smem` their bytes; `aggregate_at` the rows
    of a sampled slot that adding by peer sets must save for a warp to add
    its chunk so (0, never, for a count alone: native atomics take hot
    counts best). The item size of the values does not change it."""
    return _seg_plan(C, G, count, sms, n)


def _seg_plan(C: int, G: int, count: bool, sms: int, n: int,
              threads: int = _SEG_THREADS, replicas: int = None,
              workers: int = None, aggregate_at: int = None) -> SegSumPlan:
    """`seg_sum_plan`, with the threads a block, the replicas, the blocks
    of each column group and the aggregation threshold given where they
    are not None (`tools/torch_seg_sum_probe.py` times such variants)."""
    cnt = 1 if count else 0
    fit = (_SMEM_BYTES // G - 4 * cnt) // 8
    groups = -(-C // min(_SEG_CMAX[-1], fit)) if C else 1
    cols = -(-C // groups)
    cmax = next(c for c in _SEG_CMAX if c >= cols)
    copy = G * (8 * cols + 4 * cnt)
    warps = threads // 32
    if replicas is None:
        replicas = next(r for r in (warps, 2, 1)
                        if r == 1 or r * copy <= _SMEM_BYTES)
    if workers is None:
        rows = threads * _SEG_ROWS[cmax]
        workers = max(1, min(sms // groups, -(-n // rows)))
    if aggregate_at is None:
        aggregate_at = max(2, _SEG_AGGREGATE_WORK // cols) if cols else 0
    return SegSumPlan(1, cmax, cols, groups, replicas, replicas == warps,
                      threads, workers * groups, replicas * copy,
                      aggregate_at)


def _seg_words(plan: SegSumPlan, f64: bool, C: int, G: int, count: bool):
    """csrc/seg_sum.cu's plan words of a launch, as a ctypes int array."""
    flags = (1 if count else 0) | (2 if plan.private else 0) | \
        (plan.aggregate_at << 8)
    return (ctypes.c_int * 11)(
        int(f64), plan.cmax, C, G, plan.cols, plan.groups, plan.replicas,
        flags, plan.threads, plan.blocks, plan.smem)


def _check(vals: torch.Tensor, gid: torch.Tensor, G: int,
           count: bool) -> None:
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
    if vals.shape[0] == 0 and not count:
        raise ValueError("seg_sum: no row to sum and no count asked for")


_SEG_LIB = None
# device index -> its SM count
_SMS: dict = {}


def _seg_lib():
    """csrc/seg_sum.cu's library with its entry points typed."""
    global _SEG_LIB
    if _SEG_LIB is None:
        from .cuda_build import library
        lib = library("seg_sum")
        c, p = ctypes.c_int, ctypes.c_void_p
        lib.pt_seg_sum.argtypes = [p, p, ctypes.c_longlong,
                                   ctypes.POINTER(c), p, p, p]
        lib.pt_seg_sum.restype = c
        lib.pt_seg_sum_occupancy.argtypes = [c, c, c, c,
                                             ctypes.POINTER(c)]
        lib.pt_seg_sum_occupancy.restype = c
        _SEG_LIB = lib
    return _SEG_LIB


def _sm_count(dev: torch.device) -> int:
    sms = _SMS.get(dev.index)
    if sms is None:
        sms = _SMS[dev.index] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    return sms


def _seg_launch(vals: torch.Tensor, gid: torch.Tensor, words,
                out: torch.Tensor) -> None:
    """One launch of kernel A by its plan words (`_seg_words`) into `out`
    ((C + count, G) f64, every element written), on the current stream of
    the current device, which is vals' device. Its scratch (block 0's flag
    that the result is zeroed, and the finished blocks' ticket) persists
    per stream, zero between launches."""
    from .cuda_build import zeroed_scratch
    lib = _seg_lib()
    dev = vals.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    scratch = zeroed_scratch("seg_sum", 1, dev, stream)
    err = lib.pt_seg_sum(vals.data_ptr(), gid.data_ptr(), vals.shape[1],
                         words, out.data_ptr(), scratch.data_ptr(), stream)
    if err:
        from .cuda_build import check
        check(lib, err, "seg_sum launch")


# (C, G, count, dtype, device index, n) -> (seg_sum_plan's plan, its words)
_SEG_PLANS: dict = {}


def seg_sum(vals: torch.Tensor, gid: torch.Tensor, G: int,
            count: bool = False) -> torch.Tensor:
    """Per-group sums of the rows of `vals` ((C, n) f32 or f64) over group
    ids `gid` ((n,) int32); ids outside [0, G) contribute nothing.
    Returns (C, G) float64, or with `count` (C + 1, G) whose row 0 counts
    the ids in [0, G) (exactly the sums of a row of ones; C may be 0).
    G <= MAX_GROUPS."""
    global LAUNCHES
    _check(vals, gid, G, count)
    dev = vals.device
    if dev.type == "cpu":
        return seg_sum_plain(vals, gid, G, count)
    if dev.type != "cuda":
        raise ValueError(f"seg_sum: unsupported device {dev}")
    count = bool(count)
    if RECORD is not None:
        RECORD.append((vals, gid, G, count))
    C, n = vals.shape
    key = (C, G, count, vals.dtype, dev.index, n)
    hit = _SEG_PLANS.get(key)
    if hit is None:
        if len(_SEG_PLANS) > 4096:
            _SEG_PLANS.clear()
        plan = seg_sum_plan(C, G, count, _sm_count(dev), n)
        hit = _SEG_PLANS[key] = (plan, _seg_words(
            plan, vals.dtype == torch.float64, C, G, count))
    out = torch.empty((C + count, G), dtype=torch.float64, device=dev)
    with (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
          else contextlib.nullcontext()):
        _seg_launch(vals, gid, hit[1], out)
        LAUNCHES += hit[0].launches
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
