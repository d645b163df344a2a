"""Build and load the port's CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` for `sm_90a` into a
shared library with a plain C interface, at first use, and loaded with
ctypes. Libraries are named by a hash of their source and flags, so an
edited source is rebuilt and a built one is reused. They go to
`polaroid_tpu_torch/_build/` (or $PT_TORCH_BUILD_DIR), which git ignores.

Nothing here runs when the package is imported: a machine without
`nvcc` imports the package and runs its CPU paths. A kernel that cannot
be built raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("seg_sum", "compact")
# -Xptxas -v: ptxas reports registers, shared memory and spills per kernel
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# nvcc's report of the last build of each source, ptxas' lines included
BUILD_LOG: Dict[str, str] = {}


def build_dir() -> str:
    return os.environ.get("PT_TORCH_BUILD_DIR") or os.path.join(_PKG, "_build")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from csrc/ at first use")


def library_path(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return os.path.join(build_dir(), f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every missing library of `names`, one nvcc process per
    source, all started together. Returns the seconds it took."""
    t0 = time.perf_counter()
    os.makedirs(build_dir(), exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path()] + FLAGS + [
            "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        BUILD_LOG[name] = log
        if p.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            lib.pt_error_string.argtypes = [ctypes.c_int]
            lib.pt_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.pt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
