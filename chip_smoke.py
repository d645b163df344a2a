#!/usr/bin/env python3
"""Run polaroid_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed 0] [--rows 8388608] [--reps 5]

Phases:
1. the card (name and power limit from nvidia-smi) and a fresh build of
   every CUDA kernel of the port from csrc/;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the headline query gives it, with times for the kernel, its
   plain version, one PyTorch library call computing the same function,
   and the least time the card could take (the bound);
3. the headline query q1 (filter -> with_columns -> group_by(symbol) ->
   agg(len, sum, mean) -> collect) at --rows rows, against a numpy
   oracle, with the kernels' launch counts during one collect, the
   median of --reps collects and a torch.profiler trace of one more;
4. filter -> with_columns -> collect at --rows rows, bit-exact against
   numpy boolean indexing, through a full-width compaction, timed and
   traced the same way.

The line before the last lists every ported kernel with its numbers;
the last line is {"ok": true, "device": {...}}. Any failed check raises,
and the script exits non-zero without a result line. Needs one card; it
exits non-zero where CUDA is not available.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
N_SYMBOLS = 1000


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back calls, after a
    warm-up call, with CUDA events."""
    import torch
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


def time_collects(lf, reps: int):
    """Host ms of `reps` collects, each fenced by torch.cuda.synchronize()."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lf.collect()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def trace_collect(lf):
    """One collect under torch.profiler: the device's busy ms (the sum of
    the durations of the device-side events — kernels, memsets, copies;
    one stream, so they do not overlap), how many there were, and the
    five costliest by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lf.collect()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"device_busy_ms": sum(ms for ms, _ in by_name.values()),
            "device_ops": sum(c for _, c in by_name.values()),
            "top": [{"name": k[:80], "ms": ms, "count": c}
                    for k, (ms, c) in top]}


def make_q1_data(rows: int, seed: int):
    """The bench's q1 columns: f32 price, int32 volume, uint32 symbol."""
    import numpy as np
    rng = np.random.default_rng(seed)
    price = rng.uniform(1, 200, rows).astype(np.float32)
    volume = rng.integers(0, 5000, rows).astype(np.int32)
    symbol = rng.integers(0, N_SYMBOLS, rows).astype(np.uint32)
    return {"symbol": symbol, "price": price, "volume": volume}


def check_seg_sum(args, torch, TK, data):
    """Kernel A at the q1 stash's shape: C = 4 f64 rows (len, count(price),
    sum(notional), sum(price)) over n rows and G = 1024 group slots."""
    n = args.rows
    dev = torch.device("cuda")
    G = 1024
    sym = torch.from_numpy(data["symbol"].astype("int64")).to(dev)
    price = torch.from_numpy(data["price"]).to(dev).double()
    volume = torch.from_numpy(data["volume"]).to(dev)
    live = volume > 1000
    # dense code of the symbol (span base 0: slot = code + 1); dead rows
    # go to slot G, outside every group
    gid = torch.where(live, sym + 1, torch.full_like(sym, G)).to(torch.int32)
    ones = torch.ones(n, dtype=torch.float64, device=dev)
    vals = torch.stack([ones, ones, price * volume.double(), price])
    got = TK.seg_sum(vals, gid, G)
    want = TK.seg_sum_plain(vals, gid, G)
    torch.cuda.synchronize()
    # counts exact
    assert torch.equal(got[:2], want[:2]), "seg_sum counts differ"
    # sums: both sides add in f64 in an order that varies, so each group
    # agrees within 2 * n_g * 2^-53 * sum|v| of that group
    mag = TK.seg_sum_plain(vals.abs(), gid, G)
    tol = 2 * want[0] * 2.0 ** -53 * mag
    err = (got - want).abs()
    assert bool((err <= tol).all()), "seg_sum sums outside tolerance"
    idx = torch.where((gid >= 0) & (gid < G), gid, torch.full_like(gid, G)) \
        .long()
    buf = torch.zeros((4, G + 1), dtype=torch.float64, device=dev)
    out = {
        "kernel": "seg_sum", "n": n, "C": 4, "G": G, "dtype": "float64",
        "max_abs_err": float(err.max()),
        "kernel_ms": cuda_ms(lambda: TK.seg_sum(vals, gid, G), args.reps),
        "plain_ms": cuda_ms(lambda: TK.seg_sum_plain(vals, gid, G),
                            args.reps),
        "library_ms": cuda_ms(lambda: buf.index_add_(1, idx, vals),
                              args.reps),
    }
    nbytes = n * (4 + 4 * 8) + 4 * G * 8
    ops = 4 * n
    out["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                ops / F32_OPS_PER_S)
    out["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= \
        ops / F32_OPS_PER_S else "operations"
    return out


def check_compact(args, torch, TP, n, n_cols8, n_cols4, live_frac, seed):
    """Kernel B over the words of `n_cols8` 8-byte columns (two strided
    4-byte words each) and `n_cols4` 4-byte columns."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.rand(n, generator=g, device=dev) < live_frac
    cols8 = [torch.randn(n, generator=g, device=dev, dtype=torch.float64)
             for _ in range(n_cols8)]
    cols4 = [torch.randn(n, generator=g, device=dev) for _ in range(n_cols4)]
    words = []
    for c in cols8:
        w = c.view(torch.int32)
        words += [w[0::2], w[1::2]]
    words += cols4
    outs, cnt = TP.compact_words(mask, words)
    want, want_cnt = TP.compact_words_plain(mask, words)
    torch.cuda.synchronize()
    k = int(cnt)
    assert k == int(want_cnt), "compact_words count differs"
    for o, w in zip(outs, want):
        assert torch.equal(o[:k], w[:k]), "compact_words prefix differs"
    stacked = torch.stack([w.contiguous() for w in words])
    W = len(words)
    out = {
        "kernel": "compact_words", "n": n, "words": W, "live": k,
        "max_abs_err": 0.0,
        "kernel_ms": cuda_ms(lambda: TP.compact_words(mask, words),
                             args.reps),
        "plain_ms": cuda_ms(lambda: TP.compact_words_plain(mask, words),
                            args.reps),
        "library_ms": cuda_ms(lambda: torch.masked_select(stacked, mask),
                              args.reps),
    }
    nbytes = n * (1 + 4 * W) + k * 4 * W
    out["bound_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
    out["bound_by"] = "bytes"
    return out


def q1_frame(pl, df):
    return (df.lazy()
            .filter(pl.col("volume") > 1000)
            .with_columns((pl.col("price") * pl.col("volume"))
                          .alias("notional"))
            .group_by("symbol")
            .agg(pl.len().alias("n"), pl.col("notional").sum().alias("total"),
                 pl.col("price").mean().alias("avg")))


def check_q1(out, data):
    """q1 against a numpy oracle: exact counts and symbol set; f64 sums
    within rtol 1e-10; means (Float32, as price is Float32) within rtol
    1e-10 of the oracle rounded to float32."""
    import numpy as np
    live = data["volume"] > 1000
    sym = data["symbol"][live]
    price = data["price"][live].astype(np.float64)
    notional = price * data["volume"][live].astype(np.float64)
    cnt = np.bincount(sym, minlength=N_SYMBOLS)
    tot = np.bincount(sym, weights=notional, minlength=N_SYMBOLS)
    psum = np.bincount(sym, weights=price, minlength=N_SYMBOLS)
    present = np.nonzero(cnt)[0]
    got = {k: out.get_column(k).to_numpy() for k in out.columns}
    assert np.array_equal(got["symbol"].astype(np.int64), present), \
        "q1 symbol set differs"
    assert np.array_equal(got["n"].astype(np.int64), cnt[present]), \
        "q1 counts differ"
    want_tot = tot[present]
    assert np.all(np.abs(got["total"] - want_tot) <= 1e-10 * np.abs(want_tot)), \
        "q1 sums differ"
    want_avg = (psum[present] / cnt[present]).astype(np.float32) \
        .astype(np.float64)
    assert got["avg"].dtype == np.float32
    assert np.all(np.abs(got["avg"].astype(np.float64) - want_avg)
                  <= 1e-10 * np.abs(want_avg)), "q1 means differ"
    return len(present)


def check_filter(out, data):
    """filter -> with_columns -> collect, bit-exact against numpy."""
    import numpy as np
    live = data["volume"] > 1000
    want = {k: v[live] for k, v in data.items()}
    want["notional"] = want["price"].astype(np.float64) * \
        want["volume"].astype(np.float64)
    assert out.height == int(live.sum()), "filter row count differs"
    for k, w in want.items():
        g = out.get_column(k).to_numpy()
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        assert np.array_equal(g.view(f"u{g.itemsize}"),
                              w.view(f"u{w.itemsize}")), f"{k} differs"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1 << 23)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import polaroid_tpu_torch as pl
    from polaroid_tpu_torch.ops import cuda_build as B
    from polaroid_tpu_torch.ops import cuda_kernels as TK
    from polaroid_tpu_torch.ops import cuda_partition as TP

    # --- 1. the card and the build --------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"phase": "device", "name": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count(),
                      "torch": torch.__version__, "cuda": torch.version.cuda}))
    shutil.rmtree(B.build_dir(), ignore_errors=True)
    build_s = B.build(B.SOURCES)
    for name in B.SOURCES:
        for line in B.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "sources": [f"polaroid_tpu_torch/csrc/{s}.cu"
                                  for s in B.SOURCES]}))

    # --- 2. each kernel against its plain version -------------------------
    data = make_q1_data(args.rows, args.seed)
    seg = check_seg_sum(args, torch, TK, data)
    print(json.dumps({"phase": "kernel", **seg}))
    comp_full = check_compact(args, torch, TP, args.rows, 4, 0, 0.8,
                              args.seed)
    print(json.dumps({"phase": "kernel", **comp_full}))
    comp_groups = check_compact(args, torch, TP, 1024, 3, 1, 0.98,
                                args.seed + 1)
    print(json.dumps({"phase": "kernel", **comp_groups}))

    # --- 3. q1 end to end ---------------------------------------------------
    df = pl.DataFrame(data, device="cuda")
    lf = q1_frame(pl, df)
    TK.LAUNCHES = TP.LAUNCHES = 0
    out = lf.collect()
    q1_launches = {"seg_sum": TK.LAUNCHES, "compact_words": TP.LAUNCHES}
    assert q1_launches["seg_sum"] > 0, "q1 did not launch seg_sum"
    assert q1_launches["compact_words"] > 0, "q1 did not launch compact_words"
    ngroups = check_q1(out, data)
    times = time_collects(lf, args.reps)
    print(json.dumps({"phase": "q1", "rows": args.rows, "groups": ngroups,
                      "launches": q1_launches,
                      "median_ms": statistics.median(times),
                      "ms": times, "trace": trace_collect(lf)}))

    # --- 4. filter -> with_columns -> collect -------------------------------
    lf2 = (df.lazy().filter(pl.col("volume") > 1000)
           .with_columns((pl.col("price") * pl.col("volume"))
                         .alias("notional")))
    TK.LAUNCHES = TP.LAUNCHES = 0
    TP.LAST_ROWS = 0
    out2 = lf2.collect()
    filter_launches = {"seg_sum": TK.LAUNCHES, "compact_words": TP.LAUNCHES}
    assert filter_launches["compact_words"] > 0 and \
        TP.LAST_ROWS == df._table.capacity, \
        "the filter collect did not compact at full width"
    check_filter(out2, data)
    times = time_collects(lf2, args.reps)
    print(json.dumps({"phase": "filter_collect", "rows": args.rows,
                      "live": out2.height, "launches": filter_launches,
                      "median_ms": statistics.median(times), "ms": times,
                      "trace": trace_collect(lf2)}))

    # --- 5. result ------------------------------------------------------------
    kernels = [
        {"name": "seg_sum", "route": "cuda",
         "source": "polaroid_tpu_torch/csrc/seg_sum.cu",
         "replaces": "polaroid_tpu/ops/pallas_kernels.py:120",
         "launches": q1_launches["seg_sum"] + filter_launches["seg_sum"],
         "max_abs_err": seg["max_abs_err"], "ms": seg["kernel_ms"],
         "plain_ms": seg["plain_ms"], "bound_ms": seg["bound_ms"],
         "bound_by": seg["bound_by"], "library_ms": seg["library_ms"]},
        {"name": "compact_words", "route": "cuda",
         "source": "polaroid_tpu_torch/csrc/compact.cu",
         "replaces": "polaroid_tpu/ops/pallas_partition.py:281",
         "launches": q1_launches["compact_words"]
         + filter_launches["compact_words"],
         "max_abs_err": comp_full["max_abs_err"], "ms": comp_full["kernel_ms"],
         "plain_ms": comp_full["plain_ms"], "bound_ms": comp_full["bound_ms"],
         "bound_by": comp_full["bound_by"],
         "library_ms": comp_full["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
