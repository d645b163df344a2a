#!/usr/bin/env python3
"""Kernel A (`seg_sum`, csrc/seg_sum.cu) on one CUDA card: its build, its
SASS atomics, and its time at the shapes the port gives it, in the plan
`seg_sum_plan` picks and in variants of it.

    python3 tools/torch_seg_sum_probe.py [--only NAME,...] [--reps 20]
                                         [--out FILE.json]

For each shape (rows, groups, value rows, dtype, count row, how the keys
fall: uniform, hot, one group, as q1's stash) it makes the inputs on the
card from a seed, holds the kernel against its plain version (counts
exact, sums within 2 * n_g * 2^-53 * sum|v| of their group) in every
variant, and times with CUDA events over back-to-back calls:
* `wrapper`: the public `seg_sum` call (the zeroed result, the plan and
  the launch), and its host ms a call when nothing waits for the card;
* from replays of a CUDA graph of 20 launches, the device ms of: `plan`,
  the launch by the plan; variants of it: the aggregation threshold (0:
  every lane adds its own row with a shared atomic), threads a block, copies of the partials, blocks; `fixed`, the
  plan's blocks over one row (zeroing, merging and launching the blocks,
  and no flush); `flush`, its blocks each over G rows of distinct groups
  (every partial nonzero, so every block flushes C x G);
* `index_add_`: one index_add_ of the same rows (the library yardstick);
* the bound: n * (4 + C * itemsize) + (C + count) * G * 8 bytes at
  3.35 TB/s.
Prints one JSON line a shape and writes them all to --out. Exits 1 if
any check failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12

# name: (rows, G, value rows, dtype, count, keys)
SHAPES = {
    "q1_check": (1 << 23, 1024, 2, "f64", True, "q1"),
    "q1_check_ones": (1 << 23, 1024, 4, "f64", False, "q1"),
    "J1_c1": (1 << 21, 2048, 1, "f32", False, "uniform"),
    "J1_c2": (1 << 21, 2048, 2, "f32", False, "uniform"),
    "T1_twap": (1 << 23, 1024, 1, "f64", False, "uniform"),
    "L1": (1 << 23, 1024, 1, "f32", False, "uniform"),
    "L2_count": (1 << 25, 128, 0, "f32", True, "hot6"),
    "L2_ones": (1 << 25, 128, 1, "f32", False, "hot6"),
    "E3_cut_count": (1 << 23, 128, 0, "f32", True, "hot5"),
    "sql_q4": (1 << 24, 128, 3, "f64", True, "uniform"),
    "D0_1024": (1 << 22, 1024, 2, "f32", False, "uniform"),
    "D0_8192": (1 << 22, 8192, 2, "f32", False, "uniform"),
    "G8192_c4_f64": (1 << 22, 8192, 4, "f64", False, "uniform"),
    "one_group": (1 << 23, 1024, 1, "f64", True, "one"),
    "G128_uniform_c1": (1 << 23, 128, 1, "f32", False, "uniform"),
    "G8192_c1_f32": (1 << 21, 8192, 1, "f32", False, "uniform"),
}


def make_inputs(torch, n, G, C, dtype, keys, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    if keys == "uniform":
        gid = torch.randint(0, G, (n,), generator=g, device=dev)
    elif keys.startswith("hot"):
        codes = torch.randperm(G, generator=g, device=dev)[:int(keys[3:])]
        gid = codes[torch.randint(0, codes.numel(), (n,), generator=g,
                                  device=dev)]
    elif keys == "one":
        gid = torch.full((n,), G // 3, device=dev)
    else:  # q1: 1000 symbols at slots 1..1000, 20% dead rows at slot G
        sym = torch.randint(0, 1000, (n,), generator=g, device=dev) + 1
        live = torch.rand(n, generator=g, device=dev) < 0.8
        gid = torch.where(live, sym, G)
    dt = torch.float32 if dtype == "f32" else torch.float64
    vals = (torch.rand((C, n), generator=g, device=dev,
                       dtype=torch.float64) * 200 - 50).to(dt)
    if keys == "q1" and C == 4:
        vals[:2] = 1
    return vals.contiguous(), gid.to(torch.int32).contiguous()


def events_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, k=20, replays=5):
    """Device ms of one fn() from replays of a CUDA graph of k calls: no
    host time between the launches."""
    from polaroid_tpu_torch.ops.cuda_build import prepare_scratch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    prepare_scratch(torch.device("cuda", torch.cuda.current_device()),
                    side.cuda_stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(k):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (k * replays)


def fault(torch, TK, vals, gid, G, count, got):
    """None if `got` holds the plain version's counts exactly and its sums
    within the tolerance, else what differs."""
    want = TK.seg_sum_plain(vals, gid, G, count)
    n = vals.shape[1]
    ones = torch.ones((1, n), dtype=torch.float64, device=vals.device)
    n_g = TK.seg_sum_plain(ones, gid, G)
    mag = TK.seg_sum_plain(vals.abs(), gid, G, count)
    if got.shape != want.shape:
        return {"what": "shape", "got": list(got.shape)}
    if count and not torch.equal(got[0], want[0]):
        return {"what": "count", "cells": int((got[0] != want[0]).sum())}
    tol = 2 * n_g * 2.0 ** -53 * mag
    over = (got - want).abs() - tol
    if bool((over > 0).any()):
        return {"what": "sums", "worst_over_tol": float(over.max())}
    return None


def sass_atomics(path):
    """Counts of the atomic and reduction SASS opcodes in a built library."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    try:
        text = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                              text=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return {"error": str(e)}
    out = {}
    for line in text.splitlines():
        for tok in line.replace(";", " ").split():
            if tok.startswith(("ATOMS", "ATOMG", "ATOM.", "RED.", "REDG")):
                out[tok] = out.get(tok, 0) + 1
    return out


def host_us(fn, calls=2000):
    """Host microseconds a call of fn(), nothing waiting for the card."""
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) * 1e6 / calls


def host_parts(torch, TK):
    """Host microseconds of each part of a seg_sum call at J1's shape."""
    import contextlib
    vals, gid = make_inputs(torch, 1 << 21, 2048, 1, "f32", "uniform", 0)
    dev = vals.device
    out = torch.zeros((1, 2048), dtype=torch.float64, device=dev)
    plan = TK.seg_sum_plan(1, 2048, False, TK._sm_count(dev), 1 << 21)
    words = TK._seg_words(plan, False, 1, 2048, False)
    parts = {
        "seg_sum": lambda: TK.seg_sum(vals, gid, 2048),
        "check": lambda: TK._check(vals, gid, 2048, False),
        "zeros": lambda: torch.zeros((1, 2048), dtype=torch.float64,
                                     device=dev),
        "empty": lambda: torch.empty((1, 2048), dtype=torch.float64,
                                     device=dev),
        "launch": lambda: TK._seg_launch(vals, gid, words, out),
        "current_device": lambda: torch.cuda.current_device(),
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "data_ptr": lambda: vals.data_ptr(),
        "device_guard": lambda: contextlib.nullcontext() if dev.index ==
        torch.cuda.current_device() else None,
        "shape": lambda: vals.shape,
    }
    out_us = {k: host_us(f) for k, f in parts.items()}
    torch.cuda.synchronize()
    return out_us


def probe_shape(torch, TK, name, spec, reps, seed):
    n, G, C, dtype, count, keys = spec
    vals, gid = make_inputs(torch, n, G, C, dtype, keys, seed)
    dev = vals.device
    sms = TK._sm_count(dev)
    itemsize = vals.element_size()
    out = {"shape": name, "n": n, "G": G, "C": C, "dtype": dtype,
           "count": count, "keys": keys}
    faults = []
    res = torch.zeros((C + count, G), dtype=torch.float64, device=dev)

    f64 = vals.dtype == torch.float64

    def run(plan, v=vals, g=gid):
        TK._seg_launch(v, g, TK._seg_words(plan, f64, C, G, count), res)

    def check(tag, plan):
        run(plan)
        torch.cuda.synchronize()
        f = fault(torch, TK, vals, gid, G, count, res)
        if f:
            faults.append({"variant": tag, **f})

    plan = TK.seg_sum_plan(C, G, count, sms, n)
    out["plan"] = plan._asdict()
    got = TK.seg_sum(vals, gid, G, count)
    torch.cuda.synchronize()
    f = fault(torch, TK, vals, gid, G, count, got)
    if f:
        faults.append({"variant": "wrapper", **f})
    out["wrapper_ms"] = events_ms(torch, lambda: TK.seg_sum(
        vals, gid, G, count), reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        TK.seg_sum(vals, gid, G, count)
    out["wrapper_host_ms"] = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    out["zeros_device_ms"] = graph_ms(torch, lambda: res.zero_())
    variants = {"plan": plan}
    if C:
        for at in (0, 4, 8, 16):
            variants[f"aggregate_at_{at}"] = plan._replace(aggregate_at=at)
    for threads in (256, 512, 1024):
        if threads != plan.threads:
            variants[f"threads_{threads}"] = TK._seg_plan(
                C, G, count, sms, n, threads)
    for r in sorted({1, 2, 4, 32} - {plan.replicas}):
        if r * G * (8 * plan.cols + 4 * count) <= TK._SMEM_BYTES:
            variants[f"replicas_{r}"] = TK._seg_plan(
                C, G, count, sms, n, plan.threads, replicas=r)
    workers = plan.blocks // plan.groups
    for w in sorted({max(1, workers // 2), sms, 2 * sms} - {workers}):
        variants[f"workers_{w}"] = TK._seg_plan(
            C, G, count, sms, n, plan.threads, workers=w)
    times = {}
    for tag, p in variants.items():
        check(tag, p)
        times[tag] = {"device_ms": graph_ms(torch, lambda: run(p)),
                      "replicas": p.replicas, "blocks": p.blocks,
                      "threads": p.threads}
    out["variants"] = times
    # the plan's blocks over one row, and over G distinct groups each
    one_v, one_g = vals[:, :1].contiguous(), gid[:1].contiguous()
    out["fixed_device_ms"] = graph_ms(
        torch, lambda: run(plan, one_v, one_g))
    per_block = plan.threads * TK._SEG_ROWS[plan.cmax]
    m = (plan.blocks // plan.groups) * per_block
    fl_g = (torch.arange(m, device=dev, dtype=torch.int32) % G).contiguous()
    fl_v = torch.ones((C, m), dtype=vals.dtype, device=dev)
    out["flush_rows"] = m
    out["flush_device_ms"] = graph_ms(
        torch, lambda: run(plan, fl_v, fl_g))
    del fl_g, fl_v
    # rows outside every group spread over spill slots past G, as the
    # port's own scatters do
    from polaroid_tpu_torch.ops.segment import SPILL, spill_slots
    idx = torch.where((gid >= 0) & (gid < G), gid.long(),
                      spill_slots(n, G, dev))
    buf = torch.zeros((C + count, G + SPILL), dtype=torch.float64,
                      device=dev)
    v64 = torch.cat([torch.ones((1, n), dtype=torch.float64, device=dev),
                     vals.double()]) if count else vals.double()
    out["index_add_ms"] = events_ms(torch, lambda: buf.index_add_(
        1, idx, v64), max(3, reps // 4))
    out["plain_ms"] = events_ms(torch, lambda: TK.seg_sum_plain(
        vals, gid, G, count), max(3, reps // 4))
    nbytes = n * (4 + C * itemsize) + (C + count) * G * 8
    out["bound_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
    if count:
        ones_bytes = n * (4 + (C + 1) * itemsize) + (C + 1) * G * 8
        out["bound_ones_ms"] = 1e3 * ones_bytes / HBM_BYTES_PER_S
    out["faults"] = faults
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_seg_sum_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from polaroid_tpu_torch.ops import cuda_build as B
    from polaroid_tpu_torch.ops import cuda_kernels as TK
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    B.build(["seg_sum"])
    head = {"card": smi, "torch": torch.__version__,
            "build_s": time.perf_counter() - t0,
            "ptxas": [ln.strip() for ln in B.BUILD_LOG.get(
                "seg_sum", "").splitlines()
                      if "registers" in ln or "spill" in ln],
            "sass_atomics": sass_atomics(B.library_path("seg_sum"))}
    lib = TK._seg_lib()
    import ctypes
    occ = {}
    for f64 in (0, 1):
        for cmax in TK._SEG_CMAX:
            for threads, smem in ((512, 115712), (512, 232448),
                                  (256, 57344)):
                b = ctypes.c_int()
                err = lib.pt_seg_sum_occupancy(f64, cmax, threads, smem,
                                               ctypes.byref(b))
                occ[f"f64={f64} cmax={cmax} t={threads} smem={smem}"] = \
                    b.value if err == 0 else f"error {err}"
    head["occupancy"] = occ
    head["host_us"] = host_parts(torch, TK)
    print(json.dumps(head))
    names = [s for s in args.only.split(",") if s] or list(SHAPES)
    results, bad = [head], 0
    for name in names:
        r = probe_shape(torch, TK, name, SHAPES[name], args.reps, args.seed)
        bad += len(r["faults"])
        results.append(r)
        print(json.dumps(r))
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"faults": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
