"""Hand-written CUDA kernels for the aggregation paths, with their plain
PyTorch versions.

The counterpart of the JAX package's `ops/pallas_kernels.py`. Kernel A,
`seg_sum`, replaces `onehot_seg_sum` (its Pallas kernel
`_seg_sum_kernel`): per-group sums of C value rows over dense group ids,
in one pass over the rows (source: csrc/seg_sum.cu). The TPU kernel's
radix one-hot matrix product was a formulation for the MXU; on the card
each block adds rows into f64 partial sums in shared memory.

A wrapper runs its plain version only for tensors that lie on the CPU;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["seg_sum", "seg_sum_plain", "MAX_GROUPS", "LAUNCHES"]

# the dense group-by's key-domain limit (the JAX package's
# _MXU_GROUP_LIMIT): one block's C x G f64 partials must fit shared memory
MAX_GROUPS = 4096
# dynamic shared memory one block may use on sm_90 (227 KB)
_SMEM_BYTES = 232448
# kernel launches made by `seg_sum` (reset by callers that count them)
LAUNCHES = 0


def seg_sum_plain(vals: torch.Tensor, gid: torch.Tensor, G: int
                  ) -> torch.Tensor:
    """out[c, g] = sum_i vals[c, i] * [gid[i] == g], in f64: index_add_
    into G+1 slots, ids outside [0, G) routed to slot G and dropped."""
    idx = torch.where((gid >= 0) & (gid < G), gid,
                      torch.full_like(gid, G)).long()
    out = torch.zeros((vals.shape[0], G + 1), dtype=torch.float64,
                      device=vals.device)
    out.index_add_(1, idx, vals.to(torch.float64))
    return out[:, :G]


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
