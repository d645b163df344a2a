#!/usr/bin/env python3
"""Run polaroid_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed 0] [--rows 8388608] [--reps 5] [--only-taq]
                          [--only-surface] [--only-stream] [--only-dist]

Phases:
1. the card (name and power limit from nvidia-smi) and a fresh build of
   every CUDA kernel of the port from csrc/;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it, with times for the kernel, its
   plain version, one PyTorch library call computing the same function,
   and the least time the card could take (the bound); for the
   compaction and the segment min/max, also the device-only time of one
   call from a trace, which must hold exactly one device kernel; the
   segment sum, the exchange, the radix sort and the compaction also on
   the inputs of every launch that one collect of each phase-9 query,
   each phase-10 join, each phase-11 window query and each phase-12
   time query makes (recorded by their wrappers; each sort timed in the
   mode the query called it in);
   A launch whose shape (every tensor's shape and dtype, every other
   argument) was timed already is held to its plain version again and
   keeps the earlier launch's times ("timed_at").
3. the headline query q1 (filter -> with_columns -> group_by(symbol) ->
   agg(len, sum, mean) -> collect) at --rows rows, against a numpy
   oracle, with the kernels' launch counts during one collect, the
   median of --reps collects and a torch.profiler trace of one more.
   Phases 3-5 run through the fused chain (exec/compiled.py): the first
   collect runs the chain eagerly and captures it as a CUDA graph (its
   host ms, capture included, is printed); every later collect must
   replay it once, with no capture, and is checked by the same oracle;
   a replay launches its kernels from the graph, where no wrapper
   counts, so the kernels of one traced collect after the first are
   counted from the trace's device events and must be the first
   collect's launches (OHLC may stay eager where its route reads a
   value back, and then prints the op);
4. filter -> with_columns -> collect at --rows rows, bit-exact against
   numpy boolean indexing, through a full-width compaction, timed and
   traced the same way;
5. the per-symbol OHLC bar (filter -> group_by(symbol,
   maintain_order=True) -> agg(first, max, min, last, sum, std, len) ->
   collect) at --rows rows against a numpy oracle, timed and traced the
   same way;
6. the H2O.ai db-benchmark group-by queries over large key domains (q2,
   q3, q5, q7, q10, q6 without its median, and q3 sorted by its key) on
   G1_1e7_1e2_0_0 data (10^7 rows, K = 100) through the hash tier, each
   against a numpy oracle, with the exchange kernel launched and no
   fallback, timed and traced the same way;
7. a group-by whose bucket cells overflow (8 keys over a span above
   4096), which must take the carry-sort fallback, against numpy;
8. device sorts on the same H2O frame at 10^7 rows (S1-S6: three Int32
   keys, a descending Float64 key, two keys with 5% nulls placed last,
   top_k and bottom_k, a sort after a hash group-by, and one Int32 key
   that takes the packed torch.sort), each bit for bit against a stable
   numpy oracle, with the radix kernel launched where more than one
   key word is sorted, timed and traced the same way.
9. the sorted tier of the group-by and the ordered aggregates on the
   same frame at 10^7 rows: H2O q6 with its median, q9 (corr ** 2),
   H2O's six-key q10 (the sorted tier over 7 key words), a derived
   bucket key with no stats (K1), a nullable key on the dense tier with
   a median, a nearest quantile, n_unique and arg_max (N1) and unique
   over three keys (U1), each against a numpy oracle, with the kernels
   of each query's route launched, timed and traced the same way.
10. joins: the H2O.ai db-benchmark join suite on J1_1e7_NA_0_0 data (x
   and big of 10^7 rows; q1-q4 on the dense route, q5 on the collocated
   route through kernel E, and q5_full, a full join on the sort-merge
   route through kernel F over 2^25 rows) and bench.py's orders x users
   join -> group_by (J1, 2^21 x 2^20), each against a numpy oracle (every
   column bit for bit; J1's Float32 sums within one ulp), with the route
   and the launches of kernels E, F and B asserted, timed and traced the
   same way, with the host ms of each join's first collect beside the
   median. Phase 2 also holds A, E, F and B on the inputs of every
   launch of that first collect of each join, and times the
   kernel-level collocated join at bench.py's shape (2^22 probes x 2^20
   keys).
11. windows and .over(): H2O q8 exactly as bench.py writes it
   (rank("ordinal", descending=True).over("id6") -> filter(r <= 2)), W1
   aggregates broadcast to rows and W2 order-dependent windows over
   partitions on the H2O frame at 10^7 rows, W3 per-symbol pct_change,
   rolling mean and std, cum_sum, ewm_mean and forward_fill on the q1
   data at --rows rows, and W4 plain rolling mean and max, cum_sum, rank
   and forward_fill after a filter, each against a numpy oracle, with
   the launches of kernels F and B asserted, timed and traced the same
   way.
12. time, on 2^23 trades (the q1 columns plus ts, whole milliseconds
   drawn over the 10 NYSE regular sessions of 2024-03-04..15, in arrival
   order): T1 1-minute OHLCV bars, 5-minute VWAP and TWAP by symbol (the
   reference's polars-timeseries functions), T2 overlapping 5-minute
   windows every minute, T3 the 5-minute rolling group-by, T4 range
   windows per symbol (mean, max, median by ts) and over the whole
   column (a 1-minute volume sum, an ewm with a 30 s half-life), T5
   calendar fields (the New York hour across the DST change, weekday,
   hourly truncation, date, the per-symbol gap, the session label) and
   the trading-hours filter, each against a numpy oracle, with the
   launches of kernels F, B and A asserted, timed and traced the same
   way, with the host ms of each query's first collect. Phase 2 also
   holds F, B and A on the inputs of every launch of that first
   collect.
13. as-of and inequality joins and the select context, on the trades of
   phase 12, 2^23 quotes drawn the same way and 1024 event windows of
   60-600 s: A1-A3 the trades joined as of their quotes (by symbol
   backward within 1 s, market-wide nearest, by symbol forward), I1 the
   trades inside each window (join_where on two inequalities), X1 a
   transaction-cost select over A1 (mid, clipped and rounded slippage,
   a deviation from the mean price, a volume band, then the mean,
   volume-weighted mean, count, skew and largest deviation) and X2 the
   slippage's mean, skew and kurtosis, the top price and the OR of the
   volumes per symbol, each against a numpy oracle, with the launches
   of kernels F, B and A asserted, timed and traced the same way, with
   the host ms of each query's first collect. Phase 2 also holds F, B
   and A on the inputs of every launch of that first collect.

14. strings and nested columns, on the trades of phase 12 with the
   string columns of a NYSE Daily TAQ trade record (a ticker per symbol,
   3% with a share class; the exchange code, FINRA's "D" on about 35%;
   the 4-character sale condition; the session date as text), drawn
   from seed + 7 as numpy fixed-width unicode arrays, the frame's build
   timed: P1 volume by (day, venue) over concat_str, str.contains and
   str.strptime after a filter, P2 symbol normalisation (split, extract,
   replace, len_chars, a Float32 price to String and back), L1 per-symbol
   price, volume, venue and (ts, price) struct lists (implode) with list
   len/max/mean/last/n_unique, L2 sale-condition codes (extract_all ->
   explode -> group_by), L3 L1 exploded back to rows and unnested, each
   against a numpy oracle, with the launches of kernels F, B, A, C and E
   asserted, timed and traced the same way, with the host ms of each
   query's first collect. Phase 2 also holds A, B, C, E and F on the
   inputs of every launch of that first collect (C on those of every
   phase from 9 on). `--only-taq` runs the build, those checks and
   phase 14 alone, and prints no result line.
15. SQL and the rest of the surface, on the H2O frame of phase 6 (10^7
   rows) and the TAQ trades of phase 14 (2^23): sql_q1-sql_q10, the
   db-benchmark group-by suite as its SQL solutions write it, through
   SQLContext(x=frame).execute, each against the numpy checkers of
   phases 6, 9 and 11 and, where those phases run the query through the
   expression API, against that result bit for bit, with the host ms of
   the parse and translation; sql_trf, each symbol's off-exchange (TRF)
   share of volume, the 20 largest; E3_when, group-level when/then over
   id3; E3_distinct, the distinct flags at 10^7 rows (over (id3, id6)
   they mix both answers); E3_qcut and E3_cut
   (price deciles and fixed breaks, volume per bin), E3_hist (64 price
   bins), E3_pivot (volume by sym x ex) and E3_unpivot; and the string
   and nested items of phase 14 not measured there: struct.json_encode,
   str.json_decode, list.eval and the list set ops at 2^23 rows, each
   against numpy, with the launches asserted where a route is known,
   timed and traced the same way, with the host ms of each query's
   first collect. Phase 2 also holds A, B, C, E and F on the inputs of
   every launch of that first collect. `--only-surface` runs the build,
   those checks and phase 15 alone, and prints no result line.
16. fused chains and the streaming engine. G: q1, filter, OHLC, J1, W4
   (rolling mean, cum_sum) and T4 sum_by through the fused route (a
   collect) and through the same chains applied node by node (the
   executor's eager function), each the median of --reps, busy ms,
   device ops and idle share from a trace, the two results held to each
   other (bit for bit but for float sums, within the query's bound),
   every fused chain replayed once per collect, or named with the op
   that read back. Then the trades of phase 12 split by session into 10
   day frames and streamed as their union, collect(engine="streaming")
   held against the in-memory collect of the same plan (bit for bit in
   keys, integers, extremes and nulls; Float64 within rtol 1e-12; std
   within the bound of its sum-of-squares formula) and against numpy,
   with each stream's batch count asserted: ST1 per-symbol VWAP, count,
   min/max/mean/std (kernel A per batch on the card, counted in a trace
   of the first collect, whose kernels the next collect, all replays,
   runs again; one replay per batch after the first), ST2 a filter -> with_columns -> select chain under head(10^6)
   (stops after two batches), ST3 inner and left joins with a 1000-row
   symbol table (the build side) and a group-by of sector, ST4 top_k,
   unique over (symbol, day) and with_row_index, ST5 cum_sum,
   rolling_mean and shift across the day boundaries, ST6 the external
   sort by (price descending, ts) and a grace join, both spilling, and
   ST7 collect_batches, sink_batches, collect_async and profile.
   `--only-stream` runs the build, phase 2's checks on G's first
   collects and phase 16 alone, and prints no result line.
17. the distributed engine (`collect(engine="distributed")`) on a mesh
   of 4 shard slots, slot s on card s % cards (all four on one card of
   a one-card machine), with its 2 x 2 twin: D0 dryrun_multichip(4)
   and one shard's 2^22 rows of the H2O frame grouped by a u32 key over
   each route of the adaptive local group-by (id1: dense through A and
   C at G 1024; id3 % 5000: at G 8192; id3: the hash exchange, E; kf:
   the carry sort, F and B), against numpy; D1 H2O q2, q3, q5, q7, q10
   (sharded) and q6 (exact) at 10^7 rows against phase 6's checker and
   the in-memory collect; D2 the sorts S1 and S2 (sample sort) bit for
   bit against the in-memory sort; D3 U1 (distinct) against phase 9's
   checker and the in-memory collect; D4 the joins q2, q3 (left), q5
   and J1 against phase 10's checkers. Each prints its route, the
   exchanges, bytes between slots, per-destination capacity and drops
   (0, asserted), the launches of A, B, C, E and F, the median of --reps
   collects beside the in-memory median, and busy ms, device ops and
   idle share from a trace. Phase 2's checks run first on every launch
   of one run of each. `--only-dist` runs the build and phase 17 alone,
   and prints no result line.
Each phase prints its seconds.

The line before the last lists every ported kernel with its numbers;
"launches" counts the wrappers' launches of the main path's run, and
"replay_launches" the kernels that the traced collects after the first
(phases 3-5, ST1) ran on the card, from the traces;
the last line is {"ok": true, "device": {...}}. Any failed check raises,
and the script exits non-zero without a result line. Needs one card; it
exits non-zero where CUDA is not available.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
N_SYMBOLS = 1000
H2O_ROWS = 10_000_000       # the rows of H2O's G1_1e7_1e2_0_0


_MARK = [START]


def phase_seconds(name: str) -> None:
    """Print the seconds since the last phase ended (or the start)."""
    now = time.perf_counter()
    print(json.dumps({"phase": "seconds", "of": name,
                      "seconds": now - _MARK[0], "wall": now - START}))
    _MARK[0] = now


# True while phase 2 checks a launch whose shape it has timed already:
# cuda_ms and the one-call traces then time nothing (the check stands)
_NO_TIMING = [False]


def cuda_ms(fn, reps: int, window_ms: float = 20.0) -> float:
    """Mean device time of fn() over back-to-back calls, after a warm-up
    call, with CUDA events: at least `reps` calls, and enough of them to
    fill about `window_ms` (at most 1000), so that a kernel of a few
    microseconds is not timed over a window shorter than the card's
    clock and launch jitter."""
    import torch
    if _NO_TIMING[0]:
        return None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    calls = max(reps, min(1000, int(window_ms / max(start.elapsed_time(end),
                                                     1e-3))))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def max_abs_err(got, want) -> float:
    """Largest |got - want| over the elements that differ (0 where equal,
    so that equal infinities, such as an empty group's identity, count
    as no error)."""
    import torch
    d = (got.double() - want.double()).abs()
    return float(torch.where(got == want, torch.zeros_like(d), d).max())


def reset_launches(TK, TP, TE, TH, TM) -> None:
    """Set every kernel's launch count, and the hash tier's count of
    carry-sort fallbacks, to 0."""
    TK.LAUNCHES = TK.MINMAX_LAUNCHES = TK.GATHER_LAUNCHES = 0
    TP.LAUNCHES = 0
    TE.EXCHANGE_LAUNCHES = 0
    TM.LAUNCHES = 0
    TH.FALLBACKS = 0


def read_launches(TK, TP, TE, TH, TM) -> dict:
    return {"seg_sum": TK.LAUNCHES, "compact_words": TP.LAUNCHES,
            "seg_minmax": TK.MINMAX_LAUNCHES, "gather": TK.GATHER_LAUNCHES,
            "bucket_exchange": TE.EXCHANGE_LAUNCHES,
            "merge_sort": TM.LAUNCHES, "fallbacks": TH.FALLBACKS}


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


def trace_collect(lf, top_n: int = 5):
    """One collect under torch.profiler, summarised as trace_call says."""
    return trace_call(lf.collect, top_n=top_n)


def trace_call(fn, top_n: int = 5, each: bool = False, attempts: int = 6):
    """fn() under torch.profiler: the device's busy ms (the sum of the
    durations of the device-side events — kernels, memsets, copies; one
    stream, so they do not overlap), how many there were, the launches
    of the wrappers' kernels among them (kernel_launches), the `top_n`
    costliest by name and, with `each`, every device event in the order
    it ran (name, ms). A trace that recorded no device event at all (the
    profiler can drop a window's events, at times several in a row) is
    taken again after a pause, up to `attempts` traces in all;
    "traces_taken" says how many were."""
    for attempt in range(1, attempts + 1):
        out = _one_trace(fn, top_n, each)
        if out["device_ops"]:
            break
        time.sleep(0.2)
    return {**out, "traces_taken": attempt}


# the __global__ function each wrapper's count stands for: the wrapper
# launches it once per count (polaroid_tpu_torch/csrc/*.cu); a graph's
# replay launches it too, and only a trace sees that
KERNEL_OF = {"seg_sum_kernel": "seg_sum", "compact_kernel": "compact_words",
             "minmax_kernel": "seg_minmax", "gather_kernel": "gather",
             "exchange_kernel": "bucket_exchange",
             "place_kernel": "merge_sort"}
_KERNEL_NAME = re.compile(r"(?:void )?\(anonymous namespace\)::(\w+)[<(]")


def kernel_launches(names) -> dict:
    """The launches of the wrappers' kernels among device events' names,
    under read_launches' names (fallbacks aside)."""
    out = dict.fromkeys(KERNEL_OF.values(), 0)
    for name in names:
        m = _KERNEL_NAME.match(name)
        if m and m.group(1) in KERNEL_OF:
            out[KERNEL_OF[m.group(1)]] += 1
    return out


def _one_trace(fn, top_n, each):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    device = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    for e in device:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    out = {"device_busy_ms": sum(ms for ms, _ in by_name.values()),
           "device_ops": sum(c for _, c in by_name.values()),
           "launches": kernel_launches(e.name for e in device),
           "top": [{"name": k[:80], "ms": ms, "count": c}
                   for k, (ms, c) in top]}
    if each:
        out["events"] = [[e.name[:48], e.time_range.elapsed_us() / 1e3]
                         for e in device]
    return out


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
    # counts exact
    assert torch.equal(TK.seg_sum(vals, gid, G)[:2],
                       TK.seg_sum_plain(vals, gid, G)[:2]), \
        "seg_sum counts differ"
    return compare_seg_sum(args, torch, TK, vals, gid, G, trace=False)


def compare_seg_sum(args, torch, TK, vals, gid, G, trace=True):
    """Kernel A on (vals, gid, G) against its plain version: both add in
    f64 in an order that varies, so each (row, group) agrees within
    2 * n_g * 2^-53 * sum|v| of that group; times, the device-only time
    of its kernels from a trace with `trace`, and the bound: vals and
    gid read once, the (C, G) f64 sums written once."""
    from polaroid_tpu_torch.ops.segment import SPILL, spill_slots
    C, n = vals.shape
    dev = vals.device
    got = TK.seg_sum(vals, gid, G)
    want = TK.seg_sum_plain(vals, gid, G)
    mag = TK.seg_sum_plain(vals.abs(), gid, G)
    ones = torch.ones((1, n), dtype=torch.float64, device=dev)
    count = TK.seg_sum_plain(ones, gid, G)
    torch.cuda.synchronize()
    tol = 2 * count * 2.0 ** -53 * mag
    err = (got - want).abs()
    assert bool((err <= tol).all()), \
        f"seg_sum sums outside tolerance: {float((err - tol).max())}"
    # the library yardstick: one index_add_ (of the values in f64, cast
    # beforehand), the rows outside every group spread over spill slots
    # past G as the port's own scatters do
    idx = torch.where((gid >= 0) & (gid < G), gid.long(),
                      spill_slots(n, G, dev))
    buf = torch.zeros((C, G + SPILL), dtype=torch.float64, device=dev)
    v64 = vals.double()
    out = {
        "kernel": "seg_sum", "n": n, "C": C, "G": G,
        "dtype": str(vals.dtype).split(".")[1],
        "max_abs_err": float(err.max()),
        "kernel_ms": cuda_ms(lambda: TK.seg_sum(vals, gid, G), args.reps),
        "plain_ms": cuda_ms(lambda: TK.seg_sum_plain(vals, gid, G),
                            args.reps),
        "library_ms": cuda_ms(lambda: buf.index_add_(1, idx, v64),
                              args.reps),
    }
    if trace:
        out.update(device_ms_of(lambda: TK.seg_sum(vals, gid, G),
                                "seg_sum_kernel"))
    nbytes = n * (4 + C * vals.element_size()) + C * G * 8
    ops = C * n
    out["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                ops / F32_OPS_PER_S)
    out["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= \
        ops / F32_OPS_PER_S else "operations"
    return out


def check_compact(args, torch, TP, n, n_cols8, n_cols4, live_frac, seed):
    """Kernel B over the words of `n_cols8` 8-byte columns (one int64 view
    each, as ops/compact.py passes them) and `n_cols4` 4-byte columns."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.rand(n, generator=g, device=dev) < live_frac
    cols8 = [torch.randn(n, generator=g, device=dev, dtype=torch.float64)
             for _ in range(n_cols8)]
    cols4 = [torch.randn(n, generator=g, device=dev) for _ in range(n_cols4)]
    words = [c.view(torch.int64) for c in cols8] + cols4
    return compare_compact(args, torch, TP, mask, words)


def one_kernel_call(fn, what):
    """The device-only ms and device events of one fn() call from a
    trace (trace_call); asserts that the call ran exactly one device
    kernel (no torch op, memset or copy beside it)."""
    if _NO_TIMING[0]:
        return {}
    tr = trace_call(fn, each=True)
    assert tr["device_ops"] == 1, f"one {what} call ran {tr['events']}"
    return {"trace_ms": tr["device_busy_ms"],
            "trace_device_ops": tr["device_ops"],
            "traces_taken": tr["traces_taken"]}


def device_ms_of(fn, kernel: str):
    """The device ms of the events named `kernel` in a trace of one fn()
    call (trace_call), with the trace's device ops. If every trace came
    back empty, the profiler (not the port) lost the window, and the
    time is reported as None (the kernel's CUDA-event time stands
    beside it)."""
    if _NO_TIMING[0]:
        return {}
    tr = trace_call(fn, each=True)
    if not tr["device_ops"]:
        print(json.dumps({"phase": "trace_dropped", "kernel": kernel,
                          "attempts": tr["traces_taken"]}))
        return {"trace_ms": None, "traces_taken": tr["traces_taken"]}
    ms = [t for n, t in tr["events"] if kernel in n]
    assert ms, f"the trace of one call holds no {kernel}: {tr}"
    return {"trace_ms": sum(ms), "trace_device_ops": tr["device_ops"],
            "traces_taken": tr["traces_taken"]}


def compare_compact(args, torch, TP, mask, words):
    """Kernel B on (mask, words) against its plain version: equal live
    counts and live prefixes bit for bit; times, the device-only time of
    one call from a trace, and the bound. The bound counts what the mask
    asks for: the mask, and each live row's word read once and written
    once: n + sum_w 2 k b_w bytes."""
    n = mask.shape[0]
    outs, cnt = TP.compact_words(mask, words)
    want, want_cnt = TP.compact_words_plain(mask, words)
    torch.cuda.synchronize()
    k = int(cnt)
    assert k == int(want_cnt), "compact_words count differs"
    for o, w in zip(outs, want):
        assert torch.equal(o[:k], w[:k]), "compact_words prefix differs"
    # the library yardstick: one masked_select of every word's 4-byte
    # halves stacked, as in earlier runs
    halves = []
    for w in words:
        if w.element_size() == 8:
            h = w.contiguous().view(torch.int32)
            halves += [h[0::2], h[1::2]]
        else:
            halves.append(w)
    stacked = torch.stack([h.contiguous() for h in halves])
    out = {
        "kernel": "compact_words", "n": n, "words": len(words),
        "word_bytes": [w.element_size() for w in words], "live": k,
        "max_abs_err": 0.0,
        "kernel_ms": cuda_ms(lambda: TP.compact_words(mask, words),
                             args.reps),
        "plain_ms": cuda_ms(lambda: TP.compact_words_plain(mask, words),
                            args.reps),
        "library_ms": cuda_ms(lambda: torch.masked_select(stacked, mask),
                              args.reps),
        **one_kernel_call(lambda: TP.compact_words(mask, words),
                          "compact_words"),
    }
    nbytes = n + sum(2 * k * w.element_size() for w in words)
    out["bound_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
    out["bound_by"] = "bytes"
    return out


def check_seg_minmax(args, torch, TK, data, is_max):
    """Kernel C at the OHLC path's shapes, G = 1024: the max of the f32
    price (is_max) or the min of the int32 row positions (identity n),
    over the live rows' symbol slots. Bit for bit against the plain
    version; then a small check of NaN, +-0, +-inf and int64 extremes."""
    from polaroid_tpu_torch.ops.segment import SPILL, spill_slots
    n = args.rows
    dev = torch.device("cuda")
    G = 1024
    sym = torch.from_numpy(data["symbol"].astype("int32")).to(dev)
    live = torch.from_numpy(data["volume"]).to(dev) > 1000
    gid = torch.where(live, sym + 1, torch.full_like(sym, G))
    if is_max:
        x = torch.from_numpy(data["price"]).to(dev)
        ident = -float("inf")
    else:
        x = torch.arange(n, dtype=torch.int32, device=dev)
        ident = n
    got = TK.seg_minmax(x, gid, G, is_max, ident)
    want = TK.seg_minmax_plain(x, gid, G, is_max, ident)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "seg_minmax differs from its plain version"
    # the awkward values, each dtype, both reductions
    g = torch.Generator(device=dev).manual_seed(args.seed)
    m = 100_003
    sgid = torch.randint(-2, 300, (m,), generator=g, device=dev,
                         dtype=torch.int32)
    for dt in (torch.float32, torch.float64, torch.int32, torch.int64):
        kt = {torch.float32: torch.int32, torch.float64: torch.int64}.get(
            dt, dt)
        if dt.is_floating_point:
            v = torch.randn(m, generator=g, device=dev).to(dt)
            sp = torch.tensor([float("nan"), -0.0, 0.0, float("inf"),
                               -float("inf")], dtype=dt, device=dev)
            pos = torch.randint(0, m, (m // 20,), generator=g, device=dev)
            v[pos] = sp[torch.randint(0, 5, (m // 20,), generator=g,
                                      device=dev)]
            v = torch.where((sgid % 2 == 1) & torch.isnan(v), -v, v)
            lo, hi = -float("inf"), float("inf")
        else:
            info = torch.iinfo(dt)
            v = torch.randint(info.min, info.max, (m,), generator=g,
                              device=dev, dtype=dt)
            v[:2] = torch.tensor([info.min, info.max], dtype=dt, device=dev)
            lo, hi = info.min, info.max
        for mx in (False, True):
            a = TK.seg_minmax(v, sgid, 297, mx, lo if mx else hi)
            b = TK.seg_minmax_plain(v, sgid, 297, mx, lo if mx else hi)
            assert torch.equal(a.view(kt), b.view(kt)), \
                f"seg_minmax {dt} is_max={mx} differs on special values"
    # the library yardstick, dead rows spread as in check_seg_sum
    idx = torch.where((gid >= 0) & (gid < G), gid.long(),
                      spill_slots(n, G, dev))
    buf = torch.full((G + SPILL,), ident, dtype=x.dtype, device=dev)
    red = "amax" if is_max else "amin"
    out = {
        "kernel": "seg_minmax", "n": n, "G": G, "dtype": str(x.dtype),
        "is_max": is_max,
        "max_abs_err": max_abs_err(got, want),
        "kernel_ms": cuda_ms(lambda: TK.seg_minmax(x, gid, G, is_max, ident),
                             args.reps),
        "plain_ms": cuda_ms(lambda: TK.seg_minmax_plain(x, gid, G, is_max,
                                                        ident), args.reps),
        "library_ms": cuda_ms(lambda: buf.scatter_reduce_(0, idx, x, red),
                              args.reps),
        **one_kernel_call(lambda: TK.seg_minmax(x, gid, G, is_max, ident),
                          "seg_minmax"),
    }
    nbytes = n * (4 + x.element_size()) + G * x.element_size()
    out["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S, n / F32_OPS_PER_S)
    out["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= \
        n / F32_OPS_PER_S else "operations"
    return out


def compare_seg_minmax(args, torch, TK, x, gid, G, is_max, ident):
    """Kernel C on inputs a query gave it, bit for bit against its plain
    version, with its time, the plain version's, one scatter_reduce_
    (the library call) and the bound: x and gid read once, G values
    written once."""
    from polaroid_tpu_torch.ops.segment import SPILL, spill_slots
    got = TK.seg_minmax(x, gid, G, is_max, ident)
    want = TK.seg_minmax_plain(x, gid, G, is_max, ident)
    kt = {torch.float32: torch.int32, torch.float64: torch.int64}.get(
        x.dtype, x.dtype)
    assert torch.equal(got.view(kt), want.view(kt)), \
        "seg_minmax differs from its plain version on a query's input"
    n = x.shape[0]
    idx = torch.where((gid >= 0) & (gid < G), gid.long(),
                      spill_slots(n, G, x.device))
    buf = torch.full((G + SPILL,), ident, dtype=x.dtype, device=x.device)
    red = "amax" if is_max else "amin"
    nbytes = n * (4 + x.element_size()) + G * x.element_size()
    return {
        "kernel": "seg_minmax", "n": n, "G": G, "dtype": str(x.dtype),
        "is_max": is_max, "max_abs_err": max_abs_err(got, want),
        "kernel_ms": cuda_ms(lambda: TK.seg_minmax(x, gid, G, is_max,
                                                   ident), args.reps),
        "plain_ms": cuda_ms(lambda: TK.seg_minmax_plain(x, gid, G, is_max,
                                                        ident), args.reps),
        "library_ms": cuda_ms(lambda: buf.scatter_reduce_(0, idx, x, red),
                              args.reps),
        "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, n / F32_OPS_PER_S),
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >=
        n / F32_OPS_PER_S else "operations"}


def check_gather(args, torch, TK):
    """Kernel D: an f64 table of G = 1024 group means gathered to
    --rows rows, about 20% of the ids outside [0, G); bit for bit."""
    n = args.rows
    dev = torch.device("cuda")
    G = 1024
    g = torch.Generator(device=dev).manual_seed(args.seed)
    table = torch.randn(G, generator=g, device=dev, dtype=torch.float64)
    gid = torch.randint(0, G + G // 4, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    got = TK.gather(table, gid)
    want = TK.gather_plain(table, gid)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "gather differs from its plain version"
    idx = torch.where(gid < G, gid, torch.full_like(gid, G)).long()
    padded = torch.cat([table, table.new_zeros(1)])
    out = {
        "kernel": "gather", "n": n, "G": G, "dtype": "float64",
        "out_of_range": float((gid >= G).double().mean()),
        "max_abs_err": max_abs_err(got, want),
        "kernel_ms": cuda_ms(lambda: TK.gather(table, gid), args.reps),
        "plain_ms": cuda_ms(lambda: TK.gather_plain(table, gid), args.reps),
        "library_ms": cuda_ms(lambda: padded.index_select(0, idx),
                              args.reps),
    }
    nbytes = n * (4 + 8) + G * 8
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


def ohlc_frame(pl, df):
    return (df.lazy()
            .filter(pl.col("volume") > 1000)
            .group_by("symbol", maintain_order=True)
            .agg(pl.col("price").first().alias("open"),
                 pl.col("price").max().alias("high"),
                 pl.col("price").min().alias("low"),
                 pl.col("price").last().alias("close"),
                 pl.col("volume").sum().alias("vol"),
                 pl.col("price").std().alias("sd"),
                 pl.len().alias("n")))


def check_ohlc(out, data):
    """The OHLC bar against numpy: rows in the order of each symbol's
    first live row; open/high/low/close bit for bit; vol (int64) and n
    exact; sd (Float32) within one float32 ulp of the f64 two-pass std
    (ddof 1) rounded to float32."""
    import numpy as np
    live = data["volume"] > 1000
    sym = data["symbol"][live]
    price = data["price"][live]
    order = np.argsort(sym, kind="stable")
    ss = sym[order]
    starts = np.flatnonzero(np.r_[True, ss[1:] != ss[:-1]])
    ends = np.r_[starts[1:], len(ss)]
    cnt = ends - starts
    first, last = order[starts], order[ends - 1]
    ps = price[order]
    hi = np.maximum.reduceat(ps, starts)
    lo = np.minimum.reduceat(ps, starts)
    vol = np.add.reduceat(data["volume"][live][order].astype(np.int64),
                          starts)
    p64 = ps.astype(np.float64)
    mean = np.add.reduceat(p64, starts) / cnt
    dev = (p64 - np.repeat(mean, cnt)) ** 2
    sd = np.sqrt(np.add.reduceat(dev, starts) / (cnt - 1)).astype(np.float32)
    rank = np.argsort(first, kind="stable")  # first-occurrence order
    want = {"symbol": ss[starts][rank], "open": price[first][rank],
            "high": hi[rank], "low": lo[rank], "close": price[last][rank],
            "vol": vol[rank], "n": cnt[rank]}
    got = {k: out.get_column(k).to_numpy() for k in out.columns}
    assert out.height == len(starts), "ohlc group count differs"
    for k in ("open", "high", "low", "close"):
        assert got[k].dtype == np.float32, (k, got[k].dtype)
        assert np.array_equal(got[k].view(np.uint32),
                              want[k].view(np.uint32)), f"ohlc {k} differs"
    assert np.array_equal(got["symbol"].astype(np.int64),
                          want["symbol"].astype(np.int64)), \
        "ohlc row order differs"
    assert got["vol"].dtype == np.int64 and \
        np.array_equal(got["vol"], want["vol"]), "ohlc vol differs"
    assert np.array_equal(got["n"].astype(np.int64), want["n"]), \
        "ohlc counts differ"
    sdw = sd[rank]
    assert got["sd"].dtype == np.float32
    assert np.all(np.abs(got["sd"] - sdw) <= np.spacing(sdw)), \
        "ohlc sd differs"
    return len(starts)


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


def h2o_key_code(torch, data, col):
    """One int32 key column's codes as the hash tier builds them, at the
    table's capacity (code = value - min + 1, the key's stats base), and
    the live rows."""
    from polaroid_tpu_torch.config import capacity_for
    dev = torch.device("cuda")
    x = data[col]
    cap = capacity_for(len(x))
    code = torch.zeros(cap, dtype=torch.int64, device=dev)
    code[:len(x)] = torch.from_numpy(x).to(dev).long() - int(x.min()) + 1
    return code, torch.arange(cap, device=dev) < len(x)


def check_exchange(args, torch, TE, TH, prep):
    """Kernel E at the H2O q3 collect's shape (capacity 2^24: B = 2048
    blocks, 2 words, 10^7 live rows)."""
    assert bool(prep.ok), "the q3 exchange input overflows a cell"
    words, fills = TH.exchange_words(prep)
    return compare_exchange(args, torch, TE, prep.starts, prep.counts,
                            words, fills)


def compare_exchange(args, torch, TE, starts, counts, words, fills,
                     trace=False):
    """Kernel E on (starts, counts, words, fills) bit for bit against its
    plain version, pads included; times, the device-only time of one
    call from a trace with `trace`, and the bound: each kept row's words
    read once, every slot of every word written once, and the extents
    read."""
    B = starts.shape[0]
    got = TE.bucket_exchange(starts, counts, words, fills)
    want = TE.bucket_exchange_plain(starts, counts, words, fills)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w), "bucket_exchange differs from its plain " \
            "version"
    # the library yardstick: one index_copy_ of the kept rows of every
    # word to their slots, computed beforehand
    s = starts.long()
    c = counts.long().clamp(max=TE.CAP)
    j = torch.arange(TE.CAP, device=s.device)
    b = torch.arange(B, device=s.device)[:, None, None]
    k = torch.arange(TE.K, device=s.device)[None, :, None]
    keep = j < c[:, :, None]
    src = (b * TE.S + s[:, :, None] + j)[keep]
    dst = (k * (B * TE.CAP) + b * TE.CAP + j)[keep]
    vals = torch.stack([w[src] for w in words])
    lib_out = torch.empty((len(words), TE.K * B * TE.CAP), dtype=torch.int32,
                          device=s.device)
    live = int(c.sum())
    W = len(words)
    out = {
        "kernel": "bucket_exchange", "blocks": B, "words": W, "live": live,
        "slots": TE.K * B * TE.CAP, "max_abs_err": 0.0,
        "kernel_ms": cuda_ms(lambda: TE.bucket_exchange(starts, counts,
                                                        words, fills),
                             args.reps),
        "plain_ms": cuda_ms(lambda: TE.bucket_exchange_plain(
            starts, counts, words, fills), args.reps),
        "library_ms": cuda_ms(lambda: lib_out.index_copy_(1, dst, vals),
                              args.reps),
    }
    if trace:
        out.update(device_ms_of(lambda: TE.bucket_exchange(
            starts, counts, words, fills), "exchange_kernel"))
    nbytes = 4 * W * (live + TE.K * B * TE.CAP) + 2 * 4 * B * TE.K
    out["bound_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
    out["bound_by"] = "bytes"
    return out


def check_merge_sort(args, torch, TM, h2o):
    """Kernel F at query S1's shape: n = 2^24 rows (the H2O frame's
    capacity), W = 5 words (the dead-row word, the orderable codes of id1,
    id2 and id3, and the row index), every word bit for bit against the
    plain version; the digit passes run and skipped, the perm_only route
    that the sorts take (bit for bit and timed), and a trace of one sort
    by kernel (histogram, digit passes, placement, scratch and readback).
    Each sort reads its histogram back to the host, so its time includes
    that sync."""
    from polaroid_tpu_torch.config import capacity_for
    from polaroid_tpu_torch.dtypes import Int32
    from polaroid_tpu_torch.ops.keycode import encode_orderable
    dev = torch.device("cuda")
    rows = len(h2o["id1"])
    n = capacity_for(rows)
    live = torch.arange(n, device=dev) < rows
    words = [(~live).to(torch.int64)]
    for c in ("id1", "id2", "id3"):
        x = torch.zeros(n, dtype=torch.int32, device=dev)
        x[:rows] = torch.from_numpy(h2o[c]).to(dev)
        words.append(encode_orderable(x, Int32))
    nk = len(words)
    got = TM.merge_sort_words(words, nk)
    digit_passes = TM.PASSES
    want = TM.merge_sort_words_plain(words, nk)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w), "merge_sort_words differs from its plain " \
            "version"
    perm = TM.merge_sort_words(words, nk, perm_only=True)
    assert len(perm) == 1 and torch.equal(perm[0], want[nk]), \
        "merge_sort_words(perm_only=True) differs from the plain permutation"
    W = nk + 1
    # the library yardstick: no torch call sorts W words
    # lexicographically; one stable torch.sort of 2^24 int64 (the packed
    # id3 code and row, as the one-word route sorts) is the one-call
    # yardstick for a sort of this size
    packed = (words[3] << 31) | torch.arange(n, device=dev)
    out = {
        "kernel": "merge_sort", "n": n, "words": W, "num_keys": nk,
        "digit_passes": digit_passes,
        "digits_skipped": TM.DIGITS * nk - digit_passes, "max_abs_err": 0.0,
        "kernel_ms": cuda_ms(lambda: TM.merge_sort_words(words, nk),
                             args.reps),
        "perm_only_ms": cuda_ms(lambda: TM.merge_sort_words(
            words, nk, perm_only=True), args.reps),
        "histogram_ms": cuda_ms(lambda: TM.digit_histograms(words, nk),
                                args.reps),
        "plain_ms": cuda_ms(lambda: TM.merge_sort_words_plain(words, nk),
                            args.reps),
        "library": "torch.sort(stable=True) of one int64 of n",
        "library_ms": cuda_ms(lambda: torch.sort(packed, stable=True),
                              args.reps),
    }
    out["trace"] = trace_call(lambda: TM.merge_sort_words(words, nk),
                              top_n=8, each=True)
    nbytes = 2 * 4 * W * n
    out["bound_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
    out["bound_by"] = "bytes"
    return out


def compare_merge_sort(args, torch, TM, words, nk, stable=True,
                       perm_only=True):
    """Kernel F on the words a query gave it, in the mode the query called
    it in: the permutation alone (the route the group-by and unique take)
    or every word out (the sort-merge join's merged sort, its side row
    riding as a tail word). Both modes are held bit for bit against the
    plain version. Times of the recorded mode (`kernel_ms`, and its
    device-only time from a trace), of the permutation-only route
    (`perm_only_ms`), the plain version and one stable torch.sort of an
    int64 of n (the lowest key word packed with the row); the digit
    passes run. The bound counts the bytes the recorded mode moves, a
    32-bit word being 4 bytes: each key word read once and the
    permutation written once (8 bytes a row) alone; every word read and
    written once, and the permutation written when the sort is stable,
    with every word out."""
    n = words[0].shape[0]
    want = TM.merge_sort_words_plain(words, nk)
    perm = TM.merge_sort_words(words, nk, perm_only=True)
    got = TM.merge_sort_words(words, nk)
    torch.cuda.synchronize()
    assert len(perm) == 1 and torch.equal(perm[0], want[nk]), \
        "merge_sort_words(perm_only=True) differs from the plain permutation"
    for g, w in zip(got, want):
        assert torch.equal(g, w), "merge_sort_words differs from its plain " \
            "version"

    def recorded():
        return TM.merge_sort_words(words, nk, stable=stable,
                                   perm_only=perm_only)
    recorded()
    digit_passes = TM.PASSES
    packed = (words[nk - 1] << 31) | torch.arange(n, device=words[0].device)
    tr = trace_call(recorded) if not _NO_TIMING[0] else \
        {"device_busy_ms": None, "device_ops": 0, "traces_taken": 0}
    out = {
        "kernel": "merge_sort", "n": n, "num_keys": nk, "words": len(words),
        "mode": "perm_only" if perm_only else "every_word",
        "digit_passes": digit_passes, "max_abs_err": 0.0,
        "kernel_ms": cuda_ms(recorded, args.reps),
        "trace_ms": tr["device_busy_ms"] if tr["device_ops"] else None,
        "trace_device_ops": tr["device_ops"],
        "traces_taken": tr["traces_taken"],
        "perm_only_ms": cuda_ms(lambda: TM.merge_sort_words(
            words, nk, perm_only=True), args.reps),
        "plain_ms": cuda_ms(lambda: TM.merge_sort_words_plain(words, nk),
                            args.reps),
        "library_ms": cuda_ms(lambda: torch.sort(packed, stable=True),
                              args.reps),
    }
    if perm_only:
        nbytes = 4 * nk * n + 8 * n
    else:
        nbytes = 2 * 4 * len(words) * n + (8 * n if stable else 0)
    out["bound_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
    out["perm_only_bound_ms"] = 1e3 * (4 * nk * n + 8 * n) / HBM_BYTES_PER_S
    out["bound_by"] = "bytes"
    return out


def record_kernel_inputs(torch, TK, TE, TM, TP, lf):
    """The inputs of every launch of kernels A, E, F, B and C in one
    collect of `lf` (the wrappers' RECORD lists): [(vals, gid, G)],
    [(starts, counts, words, fills)], [(words, num_keys, stable,
    perm_only)], [(mask, words)] and [(x, gid, G, is_max, identity)],
    and the host ms of that collect, fenced."""
    from polaroid_tpu_torch.exec import compiled as CM
    # a replay records nothing: each chain is seen for the first time,
    # and runs eagerly
    CM.clear_cache(nofuse=False)
    TK.RECORD, TE.RECORD, TM.RECORD, TP.RECORD = [], [], [], []
    TK.MINMAX_RECORD = []
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lf.collect()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return (TK.RECORD, TE.RECORD, TM.RECORD, TP.RECORD,
                TK.MINMAX_RECORD, ms)
    finally:
        TK.RECORD = TE.RECORD = TM.RECORD = TP.RECORD = None
        TK.MINMAX_RECORD = None


# (kernel, launch_signature) -> (the launch it was timed at, its numbers)
_TIMED = {}


def launch_signature(inputs):
    """The shape of a recorded launch: every tensor's shape and dtype
    and every other argument, in order."""
    import torch
    if isinstance(inputs, torch.Tensor):
        return ("t", tuple(inputs.shape), str(inputs.dtype))
    if isinstance(inputs, (list, tuple)):
        return tuple(launch_signature(x) for x in inputs)
    return repr(inputs)


def check_recorded_kernels(args, torch, TK, TE, TM, TP, queries):
    """Kernels A, E, F, B and C at the shapes the queries give them:
    every launch of one collect of each (name, lazy frame), on the
    inputs that collect gave it, held against the plain version
    (compare_seg_sum, compare_exchange, compare_merge_sort,
    compare_compact, compare_seg_minmax); returns ({kernel: {"query#i":
    numbers}}, {query: host ms of that collect, the first of its frames
    when no collect of them came before})."""
    out = {"seg_sum": {}, "bucket_exchange": {}, "merge_sort": {},
           "compact_words": {}, "seg_minmax": {}}
    first_ms = {}
    for name, lf in queries:
        sums, exchanges, sorts, compactions, extremes, first_ms[name] = \
            record_kernel_inputs(torch, TK, TE, TM, TP, lf)
        checks = [("seg_sum", a, lambda a: compare_seg_sum(
            args, torch, TK, *a)) for a in sums] + \
            [("bucket_exchange", e, lambda e: compare_exchange(
                args, torch, TE, *e, trace=True)) for e in exchanges] + \
            [("merge_sort", x, lambda x: compare_merge_sort(
                args, torch, TM, *x)) for x in sorts] + \
            [("compact_words", c, lambda c: compare_compact(
                args, torch, TP, *c)) for c in compactions] + \
            [("seg_minmax", m, lambda m: compare_seg_minmax(
                args, torch, TK, *m)) for m in extremes]
        seen = {}
        for kernel, inputs, check in checks:
            i = seen[kernel] = seen.get(kernel, -1) + 1
            sig = (kernel, launch_signature(inputs))
            prior = _TIMED.get(sig)
            if prior is None:
                m = check(inputs)
                _TIMED[sig] = (f"{name}#{i}", m)
            else:
                # a shape timed already: held to the plain version again,
                # the times are those of the launch it was timed at
                _NO_TIMING[0] = True
                try:
                    m = check(inputs)
                finally:
                    _NO_TIMING[0] = False
                m = {**prior[1], **{k: v for k, v in m.items()
                                    if v is not None and k in (
                                        "max_abs_err", "live",
                                        "digit_passes")},
                     "timed_at": prior[0]}
            out[kernel][f"{name}#{i}"] = m
            print(json.dumps({"phase": "kernel", "shape": f"{name}#{i}",
                              **m}))
        del sums, exchanges, sorts, compactions, extremes, checks
    return out, first_ms


def make_h2o_data(rows: int, seed: int):
    """G1_1e7_1e2_0_0 of the H2O.ai db-benchmark (K = 100, no NAs,
    unsorted): id1, id2, id4, id5 in [1, K]; id3, id6 in [1, rows / K];
    v1 in [1, 5], v2 in [1, 15] (int32), v3 uniform on [0, 100)
    (Float64). The ids are int32, as bench.py builds them, not strings.
    kf = (id4 % 8) * 10_000 is the overflowing key of phase 7."""
    import numpy as np
    rng = np.random.default_rng(seed)
    K = 100
    big = max(rows // K, 1)
    d = {}
    for name, hi in (("id1", K), ("id2", K), ("id3", big), ("id4", K),
                     ("id5", K), ("id6", big)):
        d[name] = rng.integers(1, hi + 1, rows, dtype=np.int32)
    d["v1"] = rng.integers(1, 6, rows, dtype=np.int32)
    d["v2"] = rng.integers(1, 16, rows, dtype=np.int32)
    d["v3"] = rng.uniform(0, 100, rows)
    d["kf"] = (d["id4"] % 8).astype(np.int32) * 10_000
    return d


def h2o_queries(pl, df):
    """(name, keys, lazy frame, order) of phase 6: order is None (any),
    "first" (each group's first row) or "key" (ascending key)."""
    c = pl.col
    return [
        ("q2", ("id1", "id2"), df.lazy().group_by("id1", "id2")
         .agg(c("v1").sum().alias("v1")), None),
        ("q3", ("id3",), df.lazy().group_by("id3")
         .agg(c("v1").sum().alias("v1"), c("v3").mean().alias("v3")), None),
        ("q5", ("id6",), df.lazy().group_by("id6")
         .agg(c("v1").sum().alias("v1"), c("v2").sum().alias("v2"),
              c("v3").sum().alias("v3")), None),
        ("q7", ("id3",), df.lazy().group_by("id3")
         .agg((c("v1").max() - c("v2").min()).alias("range_v1_v2")), None),
        ("q10", ("id1", "id2", "id4"), df.lazy().group_by("id1", "id2", "id4")
         .agg(c("v3").sum().alias("v3"), pl.len().alias("count")), None),
        ("q6", ("id4", "id5"), df.lazy().group_by("id4", "id5",
                                                  maintain_order=True)
         .agg(c("v3").std().alias("sd_v3"), c("v3").first().alias("first"),
              c("v3").last().alias("last")), "first"),
        ("q3_sorted", ("id3",), df.lazy().group_by("id3")
         .agg(c("v1").sum().alias("v1"), c("v3").mean().alias("v3"))
         .sort("id3"), "key"),
    ]


def h2o_oracle(data, keys, outputs):
    """numpy per-group results: the groups in ascending key order (their
    key columns), their first rows, and each named output."""
    import numpy as np
    code = np.zeros(len(data[keys[0]]), dtype=np.int64)
    for k in keys:
        code = code * (int(data[k].max()) + 1) + data[k]
    order = np.argsort(code, kind="stable")
    sc = code[order]
    starts = np.flatnonzero(np.r_[True, sc[1:] != sc[:-1]])
    ends = np.r_[starts[1:], len(sc)]
    cnt = ends - starts
    first = order[starts]
    want = {k: data[k][first] for k in keys}

    def red(ufunc, col, dtype=None):
        v = data[col][order]
        return ufunc.reduceat(v if dtype is None else v.astype(dtype),
                              starts)

    for name, (kind, col) in outputs.items():
        if kind == "sum":
            want[name] = red(np.add, col, np.int64 if col != "v3" else None)
        elif kind == "mean":
            want[name] = red(np.add, col) / cnt
        elif kind == "range":
            want[name] = red(np.maximum, "v1") - red(np.minimum, "v2")
        elif kind == "len":
            want[name] = cnt
        elif kind == "std":
            v = data[col][order]
            mean = np.add.reduceat(v, starts) / cnt
            dev = (v - np.repeat(mean, cnt)) ** 2
            with np.errstate(invalid="ignore", divide="ignore"):
                want[name] = np.sqrt(np.add.reduceat(dev, starts) /
                                     (cnt - 1))
        elif kind == "first":
            want[name] = data[col][first]
        elif kind == "last":
            want[name] = data[col][order[ends - 1]]
    return want, first


H2O_OUTPUTS = {
    "q2": {"v1": ("sum", "v1")},
    "q3": {"v1": ("sum", "v1"), "v3": ("mean", "v3")},
    "q5": {"v1": ("sum", "v1"), "v2": ("sum", "v2"), "v3": ("sum", "v3")},
    "q7": {"range_v1_v2": ("range", None)},
    "q10": {"v3": ("sum", "v3"), "count": ("len", None)},
    "q6": {"sd_v3": ("std", "v3"), "first": ("first", "v3"),
           "last": ("last", "v3")},
    "q3_sorted": {"v1": ("sum", "v1"), "v3": ("mean", "v3")},
    "fallback": {"v1": ("sum", "v1"), "v3": ("mean", "v3"),
                 "n": ("len", None)},
    "S5_group_by": {"v1": ("sum", "v1")},
}
# Float64 outputs held to rtol 1e-12; the rest exact (bit for bit)
H2O_CLOSE = {"v3", "sd_v3"}
NULL_SHARE = 0.05           # the null rows of H2O's G1_1e7_1e2_5_0 files


def check_h2o(name, out, data, keys, order):
    """A phase-6/7 result against numpy: key sets and counts exact,
    integer sums and first/last/min/max bit for bit, Float64 sums, means
    and std within rtol 1e-12, and the row order where one is asked."""
    import numpy as np
    outputs = H2O_OUTPUTS[name]
    want, first = h2o_oracle(data, keys, outputs)
    got = {k: out.get_column(k).to_numpy() for k in out.columns}
    ng = len(want[keys[0]])
    assert out.height == ng, f"{name}: {out.height} groups, want {ng}"
    if order == "first":
        perm = np.argsort(first, kind="stable")
        want = {k: v[perm] for k, v in want.items()}
    elif order is None:
        gcode = np.zeros(ng, dtype=np.int64)
        for k in keys:
            gcode = gcode * (int(data[k].max()) + 1) + got[k].astype(np.int64)
        perm = np.argsort(gcode, kind="stable")
        got = {k: v[perm] for k, v in got.items()}
    for k in keys:
        assert np.array_equal(got[k].astype(np.int64),
                              want[k].astype(np.int64)), \
            f"{name}: key {k} (or the row order) differs"
    for col in outputs:
        g, w = got[col], want[col]
        if col in H2O_CLOSE:
            g = g.astype(np.float64)
            nan = np.isnan(w)
            assert np.array_equal(np.isnan(g.astype(np.float64)), nan), \
                f"{name}: {col} nulls differ"
            assert np.all(np.abs(g[~nan] - w[~nan])
                          <= 1e-12 * np.abs(w[~nan])), f"{name}: {col}"
        elif g.dtype.kind == "f":
            assert np.array_equal(g.view(np.uint64),
                                  w.astype(np.float64).view(np.uint64)), \
                f"{name}: {col} differs"
        else:
            assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), \
                f"{name}: {col} differs"
    return ng


def with_null_copies(pl, hdf, h2o, seed: int):
    """The H2O frame plus id4n and v3n: id4 and v3 with NULL_SHARE of
    their rows null, drawn from the seed; returns the frame and the
    host validity masks."""
    import numpy as np
    from polaroid_tpu_torch.batch import Column
    rng = np.random.default_rng(seed + 1)
    t = hdf._table
    valid = {}
    for name, src in (("id4n", "id4"), ("v3n", "v3")):
        valid[name] = rng.uniform(size=len(h2o[src])) >= NULL_SHARE
        t = t.with_column(name, Column.from_host(
            h2o[src], capacity=t.capacity, device=t.device,
            validity=valid[name]))
    return pl.DataFrame._from_table(t), valid


def f64_code(x):
    """numpy's copy of the port's orderable code of float64 values (a
    uint64 whose order is the values' order)."""
    import numpy as np
    b = x.view(np.uint64)
    return np.where(b >> np.uint64(63) == 1, ~b, b | np.uint64(1 << 63))


def sort_queries(pl, hdf, ndf):
    """(name, lazy frame) of phase 8."""
    c = pl.col
    return [
        ("S1", hdf.lazy().sort(["id1", "id2", "id3"], maintain_order=True)),
        ("S2", hdf.lazy().sort("v3", descending=True, maintain_order=True)),
        ("S3", ndf.lazy().sort(["id4n", "v3n"], descending=[False, True],
                               nulls_last=True, maintain_order=True)),
        ("S4_top_k", hdf.lazy().top_k(10, by="v3")),
        ("S4_bottom_k", hdf.lazy().bottom_k(10, by="v3")),
        ("S5", hdf.lazy().group_by("id3").agg(c("v1").sum())
         .sort("v1", descending=True, maintain_order=True)),
        ("S6", hdf.lazy().sort("id3", maintain_order=True)),
    ]


def sort_oracle(name, data, valid):
    """The rows of a phase-8 result, as positions into `data`: numpy's
    stable sorts (np.lexsort: last key most significant)."""
    import numpy as np
    if name == "S1":
        return np.lexsort((data["id3"], data["id2"], data["id1"]))
    code = f64_code(data["v3"])
    if name == "S2":
        return np.argsort(~code, kind="stable")
    if name == "S3":
        # nulls last: null word 1 for valid rows, 2 for nulls; the value
        # words of null rows zeroed; v3 descending as the NOT of its code
        v4, v3 = valid["id4n"], valid["v3n"]
        return np.lexsort((np.where(v3, ~code, 0), np.where(v3, 1, 2),
                           np.where(v4, data["id4"], 0),
                           np.where(v4, 1, 2)))
    if name == "S4_top_k":
        return np.argsort(~code, kind="stable")[:10]
    if name == "S4_bottom_k":
        return np.argsort(code, kind="stable")[:10]
    if name == "S6":
        return np.argsort(data["id3"], kind="stable")
    raise KeyError(name)


def host_columns(out):
    """Each column of a collected frame as (host values, host validity or
    None), read off its table."""
    t = out._table
    n = t.count_rows()
    return {k: (c.data[:n].cpu().numpy(),
                None if c.validity is None else c.validity[:n].cpu().numpy())
            for k, c in t.cols.items()}


def check_rows(name, got, want, valid):
    """Every column of `got` (host_columns) bit for bit against the
    `want` columns, and the nulls where `valid` has a mask."""
    import numpy as np
    assert sorted(got) == sorted(want), f"{name}: columns {sorted(got)}"
    for k, w in want.items():
        g, gv = got[k]
        assert g.dtype == w.dtype and len(g) == len(w), \
            f"{name}: {k} is {g.dtype}[{len(g)}], want {w.dtype}[{len(w)}]"
        wv = valid.get(k)
        if wv is None:
            assert gv is None or gv.all(), f"{name}: {k} has nulls"
            wv = np.ones(len(w), dtype=bool)
        else:
            assert gv is not None and np.array_equal(gv, wv), \
                f"{name}: the nulls of {k} differ"
        u = f"u{w.itemsize}"
        assert np.array_equal(g.view(u)[wv], w.view(u)[wv]), \
            f"{name}: {k} differs"


def check_sort(name, out, data, valid, group_base=None):
    """A phase-8 result against numpy. S5 is held to a stable numpy sort
    of its own group-by collected alone (`group_base`, itself checked
    against the H2O oracle), since equal sums keep the group-by's hash
    order."""
    import numpy as np
    got = host_columns(out)
    if name == "S5":
        keys, sums = group_base
        order = np.argsort(-sums, kind="stable")
        check_rows(name, got, {"id3": keys[order], "v1": sums[order]}, {})
        return len(order)
    order = sort_oracle(name, data, valid)
    check_rows(name, got, {k: v[order] for k, v in data.items()},
               {k: v[order] for k, v in valid.items()})
    return len(order)


def sorted_tier_queries(pl, hdf, ndf):
    """(name, lazy frame, launches it must make) of phase 9: the kernels
    that the port's route for each query runs, whatever else it runs."""
    c = pl.col
    return [
        ("q6", hdf.lazy().group_by("id4", "id5")
         .agg(c("v3").median().alias("median_v3"),
              c("v3").std().alias("sd_v3")),
         ("merge_sort", "compact_words", "bucket_exchange")),
        ("q9", hdf.lazy().group_by("id2", "id4")
         .agg((pl.corr("v1", "v2") ** 2).alias("r2")),
         ("compact_words", "bucket_exchange")),
        ("q10_full", hdf.lazy()
         .group_by("id1", "id2", "id3", "id4", "id5", "id6")
         .agg(c("v3").sum().alias("v3"), c("v1").count().alias("count")),
         ("merge_sort", "compact_words")),
        # k is Int64 (Int32 % an integer literal) with the validity of
        # the modulo's zero guard: a null word and two code words, which
        # kernel F sorts, skipping the digits that are constant
        ("K1", hdf.lazy().with_columns((c("id3") % 1000).alias("k"))
         .group_by("k").agg(c("v1").sum().alias("v1"),
                            c("v3").mean().alias("v3")),
         ("merge_sort", "compact_words")),
        ("N1", ndf.lazy().group_by("id4n")
         .agg(c("v3n").median().alias("median_v3n"),
              c("v3").quantile(0.9, "nearest").alias("q90_v3"),
              c("id6").n_unique().alias("nu_id6"),
              c("v2").arg_max().alias("am_v2")),
         ("merge_sort", "seg_sum", "seg_minmax")),
        ("U1", hdf.lazy().unique(subset=["id1", "id2", "id4"], keep="first",
                                 maintain_order=True),
         ("merge_sort",)),
    ]


def groups_of(data, keys, valid=None):
    """numpy's groups of the key columns: the row order that sorts them
    (nulls first, then ascending, stable), the run starts and lengths in
    it, and each row's group; a null key is a group of its own."""
    import numpy as np
    cols = []
    for k in reversed(keys):
        v = valid.get(k) if valid else None
        cols.append(data[k] if v is None else np.where(v, data[k], 0))
        if v is not None:
            cols.append(v)
    order = np.lexsort(cols)
    sk = [c[order] for c in cols]
    new = np.ones(len(order), dtype=bool)
    new[1:] = np.any([c[1:] != c[:-1] for c in sk], axis=0)
    starts = np.flatnonzero(new)
    cnt = np.diff(np.r_[starts, len(order)])
    return order, starts, cnt


def check_sorted_tier(name, out, data, valid):
    """A phase-9 result against numpy: keys, counts, integer sums,
    n_unique, arg_max, the nearest quantile and the unique rows exact (in
    the tier's row order: ascending key order for the dense and sorted
    tiers, the frame's order for U1, key order after sorting the hash
    tier's rows); medians within one f64 ulp of numpy's median; std,
    means and Float64 sums within rtol 1e-12; r2 within 1e-12. Returns
    the group count and, for each checked column with a tolerance, the
    largest error read (relative for rtol, in ulps for medians, absolute
    for r2)."""
    import numpy as np
    if name == "U1":
        code = (data["id1"].astype(np.int64) * 101 + data["id2"]) * 101 \
            + data["id4"]
        first = np.sort(np.unique(code, return_index=True)[1])
        check_rows(name, host_columns(out),
                   {k: v[first] for k, v in data.items()}, {})
        return len(first), {}
    keys = {"q6": ["id4", "id5"], "q9": ["id2", "id4"],
            "q10_full": ["id1", "id2", "id3", "id4", "id5", "id6"],
            "K1": ["k"], "N1": ["id4n"]}[name]
    if name == "K1":
        data = dict(data, k=data["id3"] % 1000)
    if name == "N1":
        data = dict(data, id4n=data["id4"])
    order, starts, cnt = groups_of(data, keys, valid)
    got = {k: v for k, (v, _) in host_columns(out).items()}
    ng = len(starts)
    assert len(got[keys[0]]) == ng, f"{name}: {len(got[keys[0]])} groups, " \
        f"want {ng}"
    first = order[starts]
    if name in ("q6", "q9"):
        # the hash tier: its rows sorted by key
        perm = np.lexsort([got[k] for k in reversed(keys)])
        got = {k: v[perm] for k, v in got.items()}
    for k in keys:
        if k == "id4n":
            gv = host_columns(out)[k][1]
            assert gv is not None and not gv[0] and gv[1:].all(), \
                f"{name}: the null key is not the first group"
            assert np.array_equal(got[k][1:], data["id4"][first][1:]), \
                f"{name}: key {k} differs"
        else:
            assert np.array_equal(got[k].astype(np.int64),
                                  data[k][first].astype(np.int64)), \
                f"{name}: key {k} (or the row order) differs"

    def red(col):
        v = data[col][order].astype(np.int64 if col != "v3" else np.float64)
        return np.add.reduceat(v, starts)

    errs = {}

    def outside(ok, g, w, what):
        """The failure message: how many groups miss, and the first."""
        bad = np.flatnonzero(~ok)
        j = bad[0]
        return f"{name}: {what}: {len(bad)} groups outside, the first " \
            f"(row {j}, {cnt[j]} rows) {g[j]!r} against {w[j]!r}"

    def close(g, w, what):
        errs[what] = float(np.max(np.abs(g - w) / np.abs(w)))
        ok = np.abs(g - w) <= 1e-12 * np.abs(w)
        assert ok.all(), outside(ok, g, w, what)

    def within_ulp(g, w, what):
        errs[what] = float(np.max(np.abs(g - w) / np.spacing(w)))
        ok = np.abs(g - w) <= np.spacing(w)
        assert ok.all(), outside(ok, g, w, what)

    def medians(col, live):
        """numpy's median of each group's rows where `live`, and its
        nearest 0.9 quantile (the position rounded half to even)."""
        med = np.full(ng, np.nan)
        q90 = np.full(ng, np.nan)
        for j, (s0, c0) in enumerate(zip(starts, cnt)):
            rows = order[s0:s0 + c0]
            x = np.sort(data[col][rows[live[rows]]])
            if len(x):
                med[j] = np.median(x)
                q90[j] = x[int(np.round(0.9 * (len(x) - 1)))]
        return med, q90

    if name == "q6":
        med, _ = medians("v3", np.ones(len(order), dtype=bool))
        within_ulp(got["median_v3"], med, "median_v3")
        v = data["v3"][order]
        mean = np.add.reduceat(v, starts) / cnt
        sd = np.sqrt(np.add.reduceat((v - np.repeat(mean, cnt)) ** 2,
                                     starts) / (cnt - 1))
        close(got["sd_v3"], sd, "sd_v3")
    elif name == "q9":
        n = cnt.astype(np.float64)
        x, y = data["v1"][order].astype(np.int64), \
            data["v2"][order].astype(np.int64)
        sx, sy = np.add.reduceat(x, starts), np.add.reduceat(y, starts)
        sxx, syy = np.add.reduceat(x * x, starts), np.add.reduceat(y * y,
                                                                   starts)
        sxy = np.add.reduceat(x * y, starts)
        r = (n * sxy - sx * sy) / (np.sqrt(n * sxx - sx * sx) *
                                   np.sqrt(n * syy - sy * sy))
        errs["r2"] = float(np.max(np.abs(got["r2"] - r * r)))
        assert np.all(np.abs(got["r2"] - r * r) <= 1e-12), f"{name}: r2"
    elif name == "q10_full":
        close(got["v3"], red("v3"), "v3")
        assert np.array_equal(got["count"], cnt), f"{name}: count"
    elif name == "K1":
        assert np.array_equal(got["v1"], red("v1")), f"{name}: v1"
        close(got["v3"], red("v3") / cnt, "v3")
    elif name == "N1":
        med, _ = medians("v3", valid["v3n"])
        within_ulp(got["median_v3n"], med, "median_v3n")
        _, q90 = medians("v3", np.ones(len(order), dtype=bool))
        assert np.array_equal(got["q90_v3"], q90), f"{name}: q90_v3"
        ids = data["id6"][order]
        nu = [len(np.unique(ids[s0:s0 + c0])) for s0, c0 in zip(starts, cnt)]
        assert np.array_equal(got["nu_id6"], nu), f"{name}: nu_id6"
        am = [int(np.argmax(data["v2"][np.sort(order[s0:s0 + c0])]))
              for s0, c0 in zip(starts, cnt)]
        assert np.array_equal(got["am_v2"], am), f"{name}: am_v2"
    return ng, errs


# --- phase 10: joins ---------------------------------------------------------

J1_ORDERS, J1_USERS = 1 << 21, 1 << 20     # bench.py:694's engine join


def id_dict(keys):
    """A sorted StringDict of the strings "id<k>" over the distinct
    positive ints `keys`, and each k's code (an int32 array indexed by k):
    the strings' order is that of the decimal digits padded on the right,
    a string before the longer ones it prefixes, so no string is sorted."""
    import numpy as np
    from polaroid_tpu_torch.strings import StringDict
    keys = np.unique(keys)
    digits = 1 + sum((keys >= 10 ** i).astype(np.int64) for i in range(1, 12))
    ks = keys[np.lexsort((digits, keys * 10 ** (12 - digits)))]
    lut = np.full(int(keys.max()) + 1, -1, np.int32)
    lut[ks] = np.arange(len(ks), dtype=np.int32)
    return StringDict(np.char.add("id", ks.astype(str)).astype(object)), lut


def make_join_data(rows: int, seed: int):
    """J1_1e7_NA_0_0 of the H2O.ai db-benchmark's join suite, as its
    _data/join-datagen.R defines it, from `seed`: x and big of `rows`
    rows, small of 10, medium of rows / 1000. Each key of n values (id1:
    10, id2: rows / 1000, id3: rows) is drawn from 1.1 n values; x draws
    from the first n, the right tables from the first 0.9 n and the last
    0.1 n, so about 90% of x's rows match. small is unique on id1,
    medium on id2 (so on id5), big on id3. id4, id5, id6 are the strings
    "id<id1>", "id<id2>", "id<id3>", held as codes into sorted
    dictionaries: one over id1's and one over id3's whole key space,
    shared by the tables; id5 has x's own (over x's values) and the right
    tables' (over theirs), so a join on it merges two dictionaries. v1,
    v2 are uniform on [0, 100) (Float64). Returns (tables of numpy
    columns, {(table, column): StringDict}); J1's orders and users (the
    bench's engine join) ride along."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def split(n):
        key = rng.permutation(np.arange(1, n * 11 // 10 + 1))
        return key[:n], np.concatenate([key[:n * 9 // 10], key[n:]])

    n1, n2 = 10, max(rows // 1000, 10)
    (x1, r1), (x2, r2), (x3, r3) = split(n1), split(n2), split(rows)
    i32 = np.int32
    t = {
        "x": {"id1": rng.choice(x1, rows), "id2": rng.choice(x2, rows),
              "id3": rng.choice(x3, rows)},
        "small": {"id1": rng.permutation(r1)},
        "medium": {"id1": rng.choice(r1, n2), "id2": rng.permutation(r2)},
        "big": {"id1": rng.choice(r1, rows), "id2": rng.choice(r2, rows),
                "id3": rng.permutation(r3)},
    }
    d4, lut4 = id_dict(np.arange(1, n1 * 11 // 10 + 1))
    d6, lut6 = id_dict(np.arange(1, rows * 11 // 10 + 1))
    d5x, lut5x = id_dict(x2)
    d5r, lut5r = id_dict(r2)
    dicts = {}
    for name, cols in t.items():
        ids = dict(cols)
        for c in ids:
            cols[c] = ids[c].astype(i32)
        cols["id4"] = lut4[ids["id1"]]
        dicts[name, "id4"] = d4
        if "id2" in ids:
            cols["id5"] = (lut5x if name == "x" else lut5r)[ids["id2"]]
            dicts[name, "id5"] = d5x if name == "x" else d5r
        if "id3" in ids:
            cols["id6"] = lut6[ids["id3"]]
            dicts[name, "id6"] = d6
        cols["v1" if name == "x" else "v2"] = rng.uniform(0, 100, len(
            ids["id1"]))
    t["orders"] = {"user_id": rng.integers(0, J1_USERS, J1_ORDERS),
                   "amount": rng.uniform(1, 500, J1_ORDERS)
                   .astype(np.float32)}
    t["users"] = {"user_id": rng.permutation(J1_USERS),
                  "country": rng.integers(0, 30, J1_USERS).astype(i32)}
    return t, dicts


def join_frames(pl, tables, dicts, device):
    from polaroid_tpu_torch.testing import frame_from_numpy
    return {name: frame_from_numpy(
        cols, device=device,
        strings={c: d for (tn, c), d in dicts.items() if tn == name})
        for name, cols in tables.items()}


def join_queries(pl, f):
    """(name, lazy frame, route, launches, (left, right)) of phase 10:
    the route the port must take (`ops/join.ROUTES`), the exact launches
    of kernels E, F and B that one collect must make, and the input
    tables."""
    x, small, medium, big = (f[k].lazy() for k in ("x", "small", "medium",
                                                     "big"))
    m1 = {"bucket_exchange": 0, "merge_sort": 0, "compact_words": 1}
    return [
        ("q1", x.join(small, on="id1"), "dense_m1", m1, ("x", "small")),
        ("q2", x.join(medium, on="id2"), "dense_m1", m1, ("x", "medium")),
        ("q3", x.join(medium, on="id2", how="left"), "dense_m1", m1,
         ("x", "medium")),
        ("q4", x.join(medium, on="id5"), "dense_m1", m1, ("x", "medium")),
        ("q5", x.join(big, on="id3"), "collocated",
         {"bucket_exchange": 1, "merge_sort": 0, "compact_words": 1},
         ("x", "big")),
        ("q5_full", x.join(big, on="id3", how="full"), "sortmerge_expand",
         {"bucket_exchange": 0, "merge_sort": 1, "compact_words": 0},
         ("x", "big")),
        # the bench's engine join (BASELINE.md's orders x users pipeline,
        # with one group key as bench.py cuts it): the collocated join,
        # then the dense tier (kernel A) and its compaction
        ("J1", f["orders"].lazy().join(f["users"].lazy(), on="user_id")
         .group_by("country").agg(pl.len().alias("n"),
                                  pl.col("amount").sum().alias("s")),
         "collocated",
         {"bucket_exchange": 1, "merge_sort": 0, "compact_words": 2},
         ("orders", "users")),
    ]


def m1_oracle(left, right, lk, rk, rkey, how):
    """numpy's m:1 join: right rows unique on rk; left rows in order
    (all of them for a left join); right columns named as the port names
    them (the key `rkey` coalesced). Returns (columns, validity)."""
    import numpy as np
    lut = np.full(int(max(lk.max(), rk.max())) + 1, -1, np.int64)
    lut[rk] = np.arange(len(rk))
    ridx = lut[lk]
    hit = ridx >= 0
    rows = hit if how == "inner" else np.ones(len(lk), bool)
    cols = {n: v[rows] for n, v in left.items()}
    valid = {}
    for n, v in right.items():
        if n == rkey:
            continue
        name = f"{n}_right" if n in left else n
        cols[name] = v[ridx[rows].clip(0)]
        if how == "left":
            valid[name] = hit[rows]
    return cols, valid


def full_oracle(left, right, key):
    """numpy's full join on a key unique on the right (no coalesce)."""
    import numpy as np
    lk, rk = left[key], right[key]
    lut = np.full(int(max(lk.max(), rk.max())) + 1, -1, np.int64)
    lut[rk] = np.arange(len(rk))
    ridx = lut[lk]
    hit = ridx >= 0
    rmatched = np.zeros(len(rk), bool)
    rmatched[ridx[hit]] = True
    nl, only_r = len(lk), np.nonzero(~rmatched)[0]
    lrow = np.concatenate([np.arange(nl), np.zeros(len(only_r), np.int64)])
    rrow = np.concatenate([ridx.clip(0), only_r])
    lvalid = np.arange(len(lrow)) < nl
    rvalid = np.concatenate([hit, np.ones(len(only_r), bool)])
    cols, valid = {}, {}
    for n, v in left.items():
        cols[n], valid[n] = v[lrow], lvalid
    for n, v in right.items():
        name = f"{n}_right" if n in left else n
        cols[name], valid[name] = v[rrow], rvalid
    return cols, valid


def canonical(cols, valid, keys):
    """The rows ordered by the `keys` arrays (the first most significant):
    (columns, validity) permuted alike."""
    import numpy as np
    order = np.lexsort(list(reversed(keys)))
    return ({k: v[order] for k, v in cols.items()},
            {k: v[order] for k, v in valid.items()})


def host_ordered(got, keys):
    """host_columns' (data, validity) pairs ordered by the `keys`
    arrays."""
    import numpy as np
    order = np.lexsort(list(reversed(keys)))
    return {k: (d[order], None if v is None else v[order])
            for k, (d, v) in got.items()}


def by_v1(want, valid, got):
    """An m:1 join's rows (one per x row) and the oracle's, both ordered
    by x's v1: one plain argsort each where v1 has no ties (then every
    sort gives the same order), stable sorts by (v1, id3) where it
    has."""
    import numpy as np
    ow = np.argsort(want["v1"])
    sv = want["v1"][ow]
    if np.all(sv[1:] != sv[:-1]):
        og = np.argsort(got["v1"][0])
        return ({k: v[ow] for k, v in want.items()},
                {k: v[ow] for k, v in valid.items()},
                {k: (d[og], None if v is None else v[og])
                 for k, (d, v) in got.items()})
    want, valid = canonical(want, valid, [want["v1"], want["id3"]])
    return want, valid, host_ordered(got, [got["v1"][0], got["id3"][0]])


def check_join(name, out, tables, dicts, any_order=False):
    """A phase-10 result against numpy, every column bit for bit and its
    nulls exact; the join order is unspecified for q5 and q5_full (and
    for q1-q4 with `any_order`: each x row's own v1 orders those), so
    both sides are ordered by (key, v1, v2) first; the string columns
    keep their source's dictionary. J1: counts exact, the Float32 sums
    within one f32 ulp of numpy's f64 sums rounded to Float32. Returns
    the output rows."""
    import numpy as np
    got = host_columns(out)
    if name == "J1":
        o, u = tables["orders"], tables["users"]
        country = np.empty(J1_USERS, np.int32)
        country[u["user_id"]] = u["country"]
        c = country[o["user_id"]]
        n = np.bincount(c, minlength=30)
        s = np.bincount(c, weights=o["amount"].astype(np.float64),
                        minlength=30).astype(np.float32)
        order = np.argsort(got["country"][0])
        keys = got["country"][0][order]
        assert np.array_equal(keys, np.nonzero(n)[0]), "J1: countries"
        assert np.array_equal(got["n"][0][order], n[keys]), "J1: counts"
        gs = got["s"][0][order]
        assert gs.dtype == np.float32, f"J1: s is {gs.dtype}"
        ulps = np.abs(gs.astype(np.float64) - s[keys]) / np.spacing(s[keys])
        assert ulps.max() <= 1, f"J1: sums {ulps.max()} ulp off"
        return len(keys)
    x = tables["x"]
    if name in ("q1", "q2", "q3"):
        right = tables["small" if name == "q1" else "medium"]
        key = "id1" if name == "q1" else "id2"
        want, valid = m1_oracle(x, right, x[key], right[key], key,
                                "left" if name == "q3" else "inner")
    elif name == "q4":
        # id5 equal <=> id2 equal ("id" + id2)
        right = tables["medium"]
        want, valid = m1_oracle(x, right, x["id2"], right["id2"], "id5",
                                "inner")
    elif name == "q5":
        want, valid = m1_oracle(x, tables["big"], x["id3"],
                                tables["big"]["id3"], "id3", "inner")
        if not any_order:
            want, valid = canonical(want, valid, [want["id3"],
                                                  want["v1"]])
            got = host_ordered(got, [got["id3"][0], got["v1"][0]])
    else:
        want, valid = full_oracle(x, tables["big"], "id3")

        def keys(cols, val):
            lv, rv = val("id3"), val("id3_right")
            return [np.where(lv, cols("id3"), cols("id3_right")),
                    np.where(lv, cols("v1"), -1.0),
                    np.where(rv, cols("v2"), -1.0)]
        want, valid = canonical(want, valid, keys(want.get, valid.get))
        got = host_ordered(got, keys(lambda k: got[k][0],
                                     lambda k: got[k][1]))
    if any_order and name in ("q1", "q2", "q3", "q4", "q5"):
        want, valid, got = by_v1(want, valid, got)
    assert list(out.columns) == list(want), f"{name}: {out.columns}"
    check_rows(name, got, want, valid)
    right = {"q1": "small", "q5": "big", "q5_full": "big"}.get(name,
                                                               "medium")
    for k, c in out._table.cols.items():
        if c.dtype.is_string:
            table, base = ("x", k) if not k.endswith("_right") else \
                (right, k[:-len("_right")])
            assert c.sdict is dicts[table, base], f"{name}: {k}'s dictionary"
    return len(next(iter(want.values())))


# --- phase 11: windows and .over() -------------------------------------------

W_WINDOW = 20               # the finance windows' length (rows)
W_ALPHA = 0.1               # the ewm's smoothing factor


def with_null_price(pl, df, data, seed: int):
    """The q1 frame plus pricen: price with NULL_SHARE of its rows null,
    drawn from the seed; returns the frame and pricen's host validity."""
    import numpy as np
    from polaroid_tpu_torch.batch import Column
    rng = np.random.default_rng(seed + 2)
    valid = rng.uniform(size=len(data["price"])) >= NULL_SHARE
    t = df._table
    t = t.with_column("pricen", Column.from_host(
        data["price"], capacity=t.capacity, device=t.device,
        validity=valid))
    return pl.DataFrame._from_table(t), valid


def window_queries(pl, hdf, qdf):
    """(name, lazy frame, kernels it must launch) of phase 11: q8 exactly
    as bench.py writes it, W1 aggregates broadcast to rows and W2
    order-dependent windows over the H2O frame's partitions, W3
    per-symbol finance windows on the q1 data, W4 plain windows over the
    whole column after a filter. Every `.over()` builds the sorted
    layout (kernel B at its run starts; kernel F when more than one word
    is sorted); W4's live order after the filter is a kernel-B
    compaction."""
    c = pl.col
    w = W_WINDOW
    h, q = hdf.lazy(), qdf.lazy()
    qf = q.filter(c("volume") > 1000)
    FB, B = ("merge_sort", "compact_words"), ("compact_words",)
    return [
        ("q8", h.with_columns(
            c("v3").rank("ordinal", descending=True).over("id6")
            .alias("r")).filter(c("r") <= 2).select("id6", "v3"), FB),
        ("W1_center", h.select(
            (c("v3") - c("v3").mean().over("id6")).alias("x")), B),
        ("W1_sum", h.select(c("v1").sum().over("id1", "id2").alias("x")),
         FB),
        ("W1_len", h.select(pl.len().over("id4").alias("x")), B),
        ("W2_cum_sum", h.select(c("v3").cum_sum().over("id4").alias("x")),
         B),
        ("W2_shift", h.select(c("v3").shift(1).over("id3").alias("x")), B),
        ("W2_diff", h.select(c("v1").diff().over("id6").alias("x")), B),
        ("W2_rank_dense", h.select(
            c("v3").rank("dense").over("id1", "id2").alias("x")), FB),
        ("W2_cum_sum_ordered", h.select(
            c("v3").cum_sum().over("id4", order_by="id3").alias("x")), FB),
        ("W3_pct_change", q.select(
            c("price").pct_change().over("symbol").alias("x")), B),
        ("W3_rolling_mean", q.select(
            c("price").rolling_mean(w).over("symbol").alias("x")), B),
        ("W3_rolling_std", q.select(
            c("price").rolling_std(w).over("symbol").alias("x")), B),
        ("W3_cum_sum", q.select(
            c("volume").cum_sum().over("symbol").alias("x")), B),
        ("W3_ewm_mean", q.select(
            c("price").ewm_mean(alpha=W_ALPHA).over("symbol").alias("x")),
         B),
        ("W3_forward_fill", q.select(
            c("pricen").forward_fill().over("symbol").alias("x")), B),
        ("W4_rolling_mean", qf.select(c("price").rolling_mean(w).alias("x")),
         B),
        ("W4_rolling_max", qf.select(c("price").rolling_max(w).alias("x")),
         B),
        ("W4_cum_sum", qf.select(
            c("price").cast(pl.Float64).cum_sum().alias("x")), B),
        ("W4_rank", qf.select(c("price").rank().alias("x")), B),
        ("W4_forward_fill", qf.select(c("pricen").forward_fill()
                                      .alias("x")), B),
    ]


def _layout(*keys, groups=None):
    """numpy's stable sort by the key columns (the first most
    significant), grouped by the first `groups` of them (all by
    default): (order, sorted group id, each group's start, each sorted
    row's position in its group)."""
    import numpy as np
    n = len(keys[0])
    order = np.lexsort(tuple(reversed(keys))) if len(keys) > 1 \
        else np.argsort(keys[0], kind="stable")
    diff = np.zeros(n, dtype=bool)
    diff[0] = True
    for k in keys[:groups]:
        sk = k[order]
        diff[1:] |= sk[1:] != sk[:-1]
    gid = np.cumsum(diff) - 1
    starts = np.flatnonzero(diff)
    return order, gid, starts, np.arange(n) - starts[gid]


def _unsort(order, vals):
    import numpy as np
    out = np.empty_like(vals)
    out[order] = vals
    return out


def _rolling_f64(xs, pos, w):
    """Each sorted row's trailing window of w rows in f64: its sum, its
    variance (ddof 1, two passes), its sum of squares, and whether the
    window lies in the row's group (pos >= w - 1)."""
    import numpy as np
    from numpy.lib.stride_tricks import sliding_window_view
    x = xs.astype(np.float64)
    full = pos >= w - 1
    s = np.zeros(len(x))
    m = np.zeros(len(x))
    win = sliding_window_view(x, w)
    s[w - 1:] = win.sum(1)
    mean = s / w
    dev = win - mean[w - 1:, None]
    m[w - 1:] = (dev * dev).sum(1) / (w - 1)
    sq = np.zeros(len(x))
    sq[w - 1:] = (win * win).sum(1)
    return s, m, sq, full


def _cum_bound(xs, gid, starts):
    """4·n·2^-53·Σ|x| of each sorted row's partition (n rows)."""
    import numpy as np
    n = np.diff(np.r_[starts, len(xs)])
    a = np.add.reduceat(np.abs(xs.astype(np.float64)), starts)
    return (4 * n * 2.0 ** -53 * a)[gid]


def window_oracle(name, h2o, q1, pricen_valid):
    """numpy's answer to a phase-11 query: {column: values}, {column:
    validity}, and a tolerance per column (None: bit for bit; else an
    array of absolute bounds, or "ulp32" for one Float32 ulp)."""
    import numpy as np
    import scipy.signal
    if name == "q8":
        order, gid, starts, pos = _layout(h2o["id6"], -h2o["v3"],
                                           groups=1)
        keep = _unsort(order, pos) < 2
        return {"id6": h2o["id6"][keep], "v3": h2o["v3"][keep]}, {}, {}
    if name.startswith(("W1", "W2")):
        d = h2o
        n = len(d["v3"])
        if name == "W1_center":
            order, gid, starts, _ = _layout(d["id6"])
            cnt = np.diff(np.r_[starts, n])
            mean = np.add.reduceat(d["v3"][order], starts) / cnt
            m = _unsort(order, mean[gid])
            return {"x": d["v3"] - m}, {}, \
                {"x": 1e-12 * np.abs(m) + 2.0 ** -52 * np.abs(d["v3"])}
        if name == "W1_sum":
            order, gid, starts, _ = _layout(d["id1"], d["id2"])
            s = np.add.reduceat(d["v1"][order].astype(np.int64), starts)
            return {"x": _unsort(order, s[gid])}, {}, {}
        if name == "W1_len":
            order, gid, starts, _ = _layout(d["id4"])
            cnt = np.diff(np.r_[starts, n])
            return {"x": _unsort(order, cnt[gid].astype(np.int64))}, {}, {}
        if name in ("W2_cum_sum", "W2_cum_sum_ordered"):
            keys = (d["id4"],) if name == "W2_cum_sum" else (d["id4"],
                                                             d["id3"])
            order, gid, starts, _ = _layout(*keys, groups=1)
            xs = d["v3"][order]
            cs = np.concatenate([np.cumsum(p) for p in
                                 np.split(xs, starts[1:])])
            return {"x": _unsort(order, cs)}, {}, \
                {"x": _unsort(order, _cum_bound(xs, gid, starts))}
        if name in ("W2_shift", "W2_diff"):
            key, col = ("id3", "v3") if name == "W2_shift" else ("id6", "v1")
            order, gid, starts, pos = _layout(d[key])
            xs = d[col][order]
            prev = np.r_[xs[:1], xs[:-1]]
            out = prev if name == "W2_shift" else xs - prev
            return {"x": _unsort(order, out)}, \
                {"x": _unsort(order, pos > 0)}, {}
        if name == "W2_rank_dense":
            # v3 has no ties (phase 8 asserts it): dense == ordinal
            order, gid, starts, pos = _layout(d["id1"], d["id2"], d["v3"],
                                              groups=2)
            return {"x": _unsort(order, pos + 1).astype(np.int64)}, {}, {}
    x, sym = q1["price"], q1["symbol"]
    if name.startswith("W3"):
        order, gid, starts, pos = _layout(sym)
        xs = x[order]
        w = W_WINDOW
        if name == "W3_pct_change":
            prev = np.r_[xs[:1], xs[:-1]]
            return {"x": _unsort(order, xs / prev - np.float32(1))}, \
                {"x": _unsort(order, pos > 0)}, {"x": "ulp32"}
        if name in ("W3_rolling_mean", "W3_rolling_std"):
            s, var, sq, full = _rolling_f64(xs, pos, w)
            valid = _unsort(order, full)
            if name == "W3_rolling_mean":
                return {"x": _unsort(order, s / w)}, {"x": valid}, \
                    {"x": "ulp32"}
            return {"x": _unsort(order, var)}, {"x": valid}, \
                {"x": ("var32", _unsort(order, 8 * w * 2.0 ** -53 * sq))}
        if name == "W3_cum_sum":
            vs = q1["volume"][order].astype(np.int64)
            cs = np.cumsum(vs)
            base = np.r_[0, cs][starts]
            return {"x": _unsort(order, (cs - base[gid]).astype(np.int32))}, \
                {}, {}
        if name == "W3_ewm_mean":
            a = 1.0 - W_ALPHA
            out = np.empty(len(xs))
            for s0, s1 in zip(starts, np.r_[starts[1:], len(xs)]):
                part = xs[s0:s1].astype(np.float64)
                num = scipy.signal.lfilter([1.0], [1.0, -a], part)
                den = scipy.signal.lfilter([1.0], [1.0, -a],
                                           np.ones(len(part)))
                out[s0:s1] = num / den
            return {"x": _unsort(order, out)}, {}, \
                {"x": 8 * np.log2(len(xs)) * 2.0 ** -24 *
                 np.abs(_unsort(order, out))}
        if name == "W3_forward_fill":
            vs = pricen_valid[order]
            idx = np.where(vs, np.arange(len(xs)), -1)
            last = np.maximum.accumulate(idx)
            has = last >= starts[gid]
            return {"x": _unsort(order, xs[np.maximum(last, 0)])}, \
                {"x": _unsort(order, has)}, {}
    live = q1["volume"] > 1000
    xl = x[live]
    n = len(xl)
    w = W_WINDOW
    pos = np.arange(n)
    if name == "W4_rolling_mean":
        s, _, _, full = _rolling_f64(xl, pos, w)
        return {"x": s / w}, {"x": full}, {"x": "ulp32"}
    if name == "W4_rolling_max":
        from numpy.lib.stride_tricks import sliding_window_view
        m = np.full(n, xl[0])
        m[w - 1:] = sliding_window_view(xl, w).max(1)
        return {"x": m}, {"x": pos >= w - 1}, {}
    if name == "W4_cum_sum":
        x64 = xl.astype(np.float64)
        return {"x": np.cumsum(x64)}, {}, \
            {"x": np.full(n, 4 * n * 2.0 ** -53 * np.abs(x64).sum())}
    if name == "W4_rank":
        order = np.argsort(xl, kind="stable")
        sx = xl[order]
        new = np.r_[True, sx[1:] != sx[:-1]]
        starts = np.flatnonzero(new)
        ends = np.r_[starts[1:], n]
        gid = np.cumsum(new) - 1
        avg = (starts + 1 + ends) / 2.0
        return {"x": _unsort(order, avg[gid])}, {}, {}
    if name == "W4_forward_fill":
        vl = pricen_valid[live]
        last = np.maximum.accumulate(np.where(vl, pos, -1))
        return {"x": xl[np.maximum(last, 0)]}, {"x": last >= 0}, {}
    raise KeyError(name)


def check_window(name, got, h2o, q1, pricen_valid):
    """A phase-11 result (host_columns) against numpy: the rows and nulls
    exact; integers, counts, ranks, shifts, fills, min/max and q8's rows
    bit for bit; Float64 within the bound window_oracle gives (W1: 1e-12
    of the group mean; cum_sum over a partition of n rows:
    4·n·2^-53·Σ|x|); Float32 means and pct_change within one f32 ulp of
    numpy's f64 (or f32) value; Float32 rolling std with its square
    within 8·w·2^-53·Σx² of the window's variance, plus the f32
    rounding; the Float32 ewm within 8·log2(n)·2^-24 of its value.
    Returns the largest error of each inexact column, against its
    bound."""
    want, valid, tol = window_oracle(name, h2o, q1, pricen_valid)
    return compare_columns(name, got, want, valid, tol)


def compare_columns(name, got, want, valid, tol):
    """A result's columns (host_columns) against an oracle's: {column:
    values}, {column: validity} (absent: no nulls) and {column:
    tolerance}: None bit for bit (strings by value), "ulp32" one Float32
    ulp of the f64 value, ("var32", bound) a Float32 std whose square lies
    within `bound` of the variance (plus the f32 rounding), ("f32",
    bound) a Float32 value within `bound` plus one ulp of the f64 value,
    or an array of absolute bounds. Returns the row count and the largest
    error of each inexact column, against its bound."""
    import numpy as np
    assert sorted(got) == sorted(want), f"{name}: columns {sorted(got)}"
    errs = {}
    for k, w in want.items():
        g, gv = got[k]
        assert len(g) == len(w), f"{name}: {k} has {len(g)} rows, want " \
            f"{len(w)}"
        wv = valid.get(k)
        if wv is None:
            assert gv is None or gv.all(), f"{name}: {k} has nulls"
            wv = np.ones(len(w), dtype=bool)
        else:
            assert gv is not None and np.array_equal(gv, wv), \
                f"{name}: the nulls of {k} differ"
        g, w = g[wv], w[wv]
        t = tol.get(k)
        if t is None:
            assert g.dtype.kind == w.dtype.kind or g.dtype.kind in "iu", \
                f"{name}: {k} is {g.dtype}, want {w.dtype}"
            if g.dtype.kind == "O" or w.dtype.kind == "O":
                assert np.array_equal(g.astype(object), w.astype(object)), \
                    f"{name}: {k} differs"
            elif g.dtype.kind == "f":
                assert g.dtype == w.dtype and np.array_equal(
                    g.view(f"u{g.itemsize}"), w.view(f"u{w.itemsize}")), \
                    f"{name}: {k} differs"
            else:
                assert np.array_equal(g.astype(np.int64),
                                      w.astype(np.int64)), \
                    f"{name}: {k} differs"
            continue
        g64 = g.astype(np.float64)
        if isinstance(t, str):      # one f32 ulp
            assert g.dtype == np.float32, f"{name}: {k} is {g.dtype}"
            bound = np.spacing(np.abs(w.astype(np.float32))).astype(
                np.float64)
            err = np.abs(g64 - w)
        elif isinstance(t, tuple) and t[0] == "f32":
            assert g.dtype == np.float32, f"{name}: {k} is {g.dtype}"
            bound = t[1][wv] + np.spacing(np.abs(w.astype(np.float32))) \
                .astype(np.float64)
            err = np.abs(g64 - w)
        elif isinstance(t, tuple):  # f32 std against the window variance
            assert g.dtype == np.float32, f"{name}: {k} is {g.dtype}"
            var_bound = t[1][wv]
            bound = var_bound + 2 * g64 * np.spacing(g).astype(np.float64) \
                + np.spacing(g).astype(np.float64) ** 2
            err = np.abs(g64 * g64 - w)
        else:
            bound = t[wv]
            both_nan = np.isnan(g64) & np.isnan(w)    # 0 / 0 on both sides
            err = np.where(both_nan, 0.0, np.abs(g64 - w))
            bound = np.where(both_nan, 0.0, bound)
        bad = ~(err <= bound)
        assert not bad.any(), \
            f"{name}: {k} outside its bound at {int(bad.sum())} rows " \
            f"(first {np.flatnonzero(bad)[:5].tolist()})"
        errs[k] = [float(err.max()) if len(err) else 0.0,
                   float(bound[np.argmax(err)]) if len(err) else 0.0]
    return len(next(iter(want.values()))), errs


# --- phase 12: time ------------------------------------------------------------

SESSION_MS = 23_400_000     # an NYSE regular session, 09:30-16:00, in ms
# the 10 regular sessions of 2024-03-04..15 open at 09:30 America/New_York:
# 14:30Z before the US DST change of 2024-03-10, 13:30Z after it
SESSION_OPENS = ["2024-03-04T14:30", "2024-03-05T14:30", "2024-03-06T14:30",
                 "2024-03-07T14:30", "2024-03-08T14:30", "2024-03-11T13:30",
                 "2024-03-12T13:30", "2024-03-13T13:30", "2024-03-14T13:30",
                 "2024-03-15T13:30"]
DST_2024_US = 1710054000_000_000   # 2024-03-10T07:00Z in µs
MINUTE_US = 60_000_000
BAR_PERIOD = 5                     # T2's and T3's windows, in minutes
MEDIAN_SAMPLE = 1 << 14            # rows whose window median numpy checks


def make_trades_data(rows: int, seed: int):
    """The q1 columns (make_q1_data) plus ts, a Datetime("us") column of
    whole milliseconds, ascending (arrival order), drawn uniformly over
    the 10 NYSE regular sessions of 2024-03-04..15."""
    import numpy as np
    data = make_q1_data(rows, seed)
    rng = np.random.default_rng(seed + 3)
    ms = np.sort(rng.integers(0, len(SESSION_OPENS) * SESSION_MS, rows))
    opens = np.array(SESSION_OPENS, dtype="datetime64[us]").astype(np.int64)
    data["ts"] = opens[ms // SESSION_MS] + (ms % SESSION_MS) * 1000
    return data


def trades_frame(pl, data, device="cuda"):
    """The trades as a frame: symbol, price, volume, ts."""
    cols = {k: v for k, v in data.items() if k != "ts"}
    cols["ts"] = data["ts"].astype("datetime64[us]")
    return pl.DataFrame(cols, device=device)


def time_queries(pl, tdf):
    """(name, lazy frame, kernels it must launch, kernels it must not) of
    phase 12: T1 the reference's finance bars (OHLCV by symbol and
    minute through the lazy fast path, 5-minute VWAP, TWAP by symbol),
    T2 overlapping 5-minute windows every minute, T3 the 5-minute
    rolling group-by, T4 range windows per symbol and over the whole
    time-ordered column, T5 calendar fields, time zones, the session
    labels and the trading-hours filter."""
    from polaroid_tpu_torch import timeseries as TS
    c = pl.col
    lf = tdf.lazy()
    FB, B, AB = ("merge_sort", "compact_words"), ("compact_words",), \
        ("seg_sum", "compact_words")
    period = f"{BAR_PERIOD}m"
    ts = c("ts")
    return [
        ("T1_ohlcv", TS.resample_ohlcv(lf, every="1m", time_column="ts",
                                       by="symbol"), FB, ()),
        ("T1_vwap", TS.vwap(lf, by="symbol", every=period,
                            time_column="ts"), FB, ()),
        ("T1_twap", TS.twap(lf, time_column="ts", by="symbol"), AB,
         ("merge_sort",)),
        ("T2_overlap", lf.group_by_dynamic(
            "ts", every="1m", period=period, group_by="symbol").agg(
                c("price").mean().alias("mean"),
                c("price").max().alias("max"), pl.len().alias("n")), FB, ()),
        ("T3_rolling", lf.rolling("ts", period=period, group_by="symbol")
         .agg(c("volume").sum().alias("volume"),
              c("price").mean().alias("mean"), c("price").max().alias("max"),
              c("price").std().alias("std"),
              c("price").first().alias("first"),
              c("price").last().alias("last"), pl.len().alias("n")),
         FB, ()),
        ("T4_mean_by", lf.select(c("price").rolling_mean_by("ts", period)
                                 .over("symbol").alias("x")), B,
         ("merge_sort",)),
        ("T4_max_by", lf.select(c("price").rolling_max_by("ts", period)
                                .over("symbol").alias("x")), B,
         ("merge_sort",)),
        ("T4_median_by", lf.select(c("price").rolling_median_by("ts", period)
                                   .over("symbol").alias("x")), B,
         ("merge_sort",)),
        ("T4_sum_by", lf.select(c("volume").rolling_sum_by("ts", "1m")
                                .alias("x")), (),
         ("merge_sort", "compact_words", "seg_sum")),
        ("T4_ewm_by", lf.select(c("price").ewm_mean_by("ts", half_life="30s")
                                .alias("x")), (),
         ("merge_sort", "compact_words", "seg_sum")),
        ("T5_calendar", TS.filter_trading_hours(lf.with_columns(
            ts.dt.replace_time_zone("UTC")
            .dt.convert_time_zone("America/New_York").dt.hour().alias("h"),
            ts.dt.weekday().alias("wd"), ts.dt.truncate("1h").alias("tr"),
            ts.dt.date().alias("d"),
            (ts - ts.shift(1).over("symbol")).dt.total_microseconds()
            .alias("gap"), TS.session_id("ts")), "us", "ts"), B,
         ("merge_sort",)),
    ]


def _runs(*keys):
    """The rows ordered stably by the keys (the first most significant)
    and the starts of their runs of equal keys: (order, starts, ends,
    run of each ordered row)."""
    import numpy as np
    n = len(keys[0])
    order = np.lexsort(tuple(reversed(keys)))
    new = np.zeros(n, dtype=bool)
    new[0] = True
    for k in keys:
        sk = k[order]
        new[1:] |= sk[1:] != sk[:-1]
    starts = np.flatnonzero(new)
    return order, starts, np.r_[starts[1:], n], np.cumsum(new) - 1


def _p23(price):
    """Each f32 price in [1, 200) times 2^23: an exact int64."""
    import numpy as np
    return (price.astype(np.float64) * 2.0 ** 23).astype(np.int64)


def _mean_bound(n, abs_sum):
    """2·⌈log2 n⌉·2^-53·Σ|x| / n: a mean's f64 error bound."""
    import numpy as np
    lg = np.ceil(np.log2(np.maximum(n, 1)))
    return 2 * lg * 2.0 ** -53 * abs_sum / np.maximum(n, 1)


def _symbol_windows(d):
    """Each row's 5-minute window within its symbol, (t - 5m, t] with the
    ties of t past the row, on the (symbol, ts) layout: (order, lo, hi),
    from one np.searchsorted over a combined (symbol, ts) key."""
    import numpy as np
    order = np.lexsort((d["ts"], d["symbol"]))
    off = d["ts"][order] - d["ts"].min() + 1
    key = (d["symbol"][order].astype(np.int64) << 42) | off
    base = d["symbol"][order].astype(np.int64) << 42
    target = base | np.maximum(off - BAR_PERIOD * MINUTE_US, 0)
    return order, np.searchsorted(key, target, "right"), \
        np.searchsorted(key, key, "right")


def _window_stats(x, lo, hi):
    """Per window [lo, hi) of the f32 values x: exact mean (from int64
    sums of x·2^23), max and the two-pass variance in longdouble, by one
    pass per window slot."""
    import numpy as np
    n = hi - lo
    cs = np.r_[0, np.cumsum(_p23(x))]
    s = (cs[hi] - cs[lo]).astype(np.longdouble) / 2.0 ** 23
    mean = s / n
    mx = x[lo].copy()
    dev2 = np.zeros(len(lo), dtype=np.longdouble)
    sq = np.zeros(len(lo))
    for k in range(int(n.max())):
        inside = k < n
        v = x[np.minimum(lo + k, len(x) - 1)]
        mx = np.where(inside, np.maximum(mx, v), mx)
        dv = v.astype(np.longdouble) - mean
        dev2 += np.where(inside, dv * dv, 0)
        sq += np.where(inside, v.astype(np.float64) ** 2, 0)
    var = dev2 / np.maximum(n - 1, 1)
    return n, s, mean, mx, var, sq


def _ewm_by(x, t, half_life_us):
    """The time-decayed ewm y_i = d_i y_{i-1} + (1 - d_i) x_i, d_i =
    2^(-(t_i - t_{i-1}) / half_life), y_0 = x_0, evaluated in order: the
    rows in blocks run in lockstep, once for each block's affine map and
    once more from each block's true entry state."""
    import numpy as np
    n = len(x)
    B = 2048
    m = -(-n // B)
    pad = m * B - n
    f = np.r_[x.astype(np.float64), np.zeros(pad)].reshape(m, B)
    dt = np.r_[0.0, np.diff(t).astype(np.float64), np.zeros(pad)]
    d = np.exp2(-dt / half_life_us)
    d[0] = 0.0
    d[n:] = 1.0
    d = d.reshape(m, B)
    A = np.ones(m)
    Bv = np.zeros(m)
    for j in range(B):
        A = A * d[:, j]
        Bv = d[:, j] * Bv + (1 - d[:, j]) * f[:, j]
    entry = np.zeros(m)
    y = 0.0
    for i in range(m):
        entry[i] = y
        y = A[i] * y + Bv[i]
    out = np.empty((m, B))
    y = entry
    for j in range(B):
        y = d[:, j] * y + (1 - d[:, j]) * f[:, j]
        out[:, j] = y
    return out.reshape(-1)[:n]


def time_oracle(name, d, got=None):
    """numpy's answer to a phase-12 query on the trades data, as
    window_oracle gives it: ({column: values}, {column: validity},
    {column: tolerance})."""
    import numpy as np
    ts, sym, price, vol = d["ts"], d["symbol"], d["price"], d["volume"]
    n = len(ts)
    if name in ("T1_ohlcv", "T1_vwap"):
        every = (1 if name == "T1_ohlcv" else BAR_PERIOD) * MINUTE_US
        bucket = ts // every * every
        order, starts, ends, _ = _runs(sym, bucket)
        p = price[order]
        v = vol[order].astype(np.int64)
        keys = {"symbol": sym[order][starts], "ts": bucket[order][starts]}
        if name == "T1_ohlcv":
            return {**keys, "open": p[starts], "close": p[ends - 1],
                    "high": np.maximum.reduceat(p, starts),
                    "low": np.minimum.reduceat(p, starts),
                    "volume": np.add.reduceat(v, starts)}, {}, {}
        pv = np.add.reduceat(_p23(p) * v, starts)
        vs = np.add.reduceat(v, starts)
        with np.errstate(invalid="ignore", divide="ignore"):
            w = (pv.astype(np.longdouble) / 2.0 ** 23 / vs).astype(np.float64)
        return {**keys, "vwap": w, "total_volume": vs}, {}, \
            {"vwap": 1e-12 * np.abs(w)}
    if name == "T1_twap":
        order, starts, ends, run = _runs(sym)
        t = ts[order]
        dtu = np.r_[t[1:] - t[:-1], 0]
        dtu[ends - 1] = 0
        p = price[order].astype(np.longdouble)
        num = np.add.reduceat(p * dtu, starts)
        den = np.add.reduceat(dtu, starts)
        w = (num / den).astype(np.float64)
        return {"symbol": sym[order][starts], "twap": w}, {}, \
            {"twap": 1e-12 * np.abs(w)}
    if name == "T2_overlap":
        m0 = ts // MINUTE_US
        order, starts, ends, _ = _runs(sym, m0)
        p = price[order]
        bs, bm = sym[order][starts].astype(np.int64), m0[order][starts]
        base = bm.min() - BAR_PERIOD
        bkey = (bs << 32) | (bm - base)
        bcnt = ends - starts
        bsum = np.add.reduceat(_p23(p), starts)
        babs = np.add.reduceat(np.abs(p.astype(np.float64)), starts)
        bmax = np.maximum.reduceat(p, starts)
        wins = np.unique((bkey[:, None] - np.arange(BAR_PERIOD)).ravel())
        cnt = np.zeros(len(wins), dtype=np.int64)
        tot = np.zeros(len(wins), dtype=np.int64)
        ab = np.zeros(len(wins))
        mx = np.full(len(wins), -np.inf, dtype=np.float32)
        for j in range(BAR_PERIOD):
            i = np.minimum(np.searchsorted(bkey, wins + j), len(bkey) - 1)
            hit = bkey[i] == wins + j
            cnt += np.where(hit, bcnt[i], 0)
            tot += np.where(hit, bsum[i], 0)
            ab += np.where(hit, babs[i], 0)
            mx = np.where(hit, np.maximum(mx, bmax[i]), mx)
        mean = (tot.astype(np.longdouble) / 2.0 ** 23 / cnt).astype(
            np.float64)
        return {"symbol": (wins >> 32).astype(np.uint32),
                "ts": ((wins & 0xFFFFFFFF) + base) * MINUTE_US,
                "mean": mean, "max": mx, "n": cnt}, {}, \
            {"mean": ("f32", _mean_bound(cnt, ab))}
    if name in ("T3_rolling", "T4_mean_by", "T4_max_by", "T4_median_by"):
        order, lo, hi = _symbol_windows(d)
        p = price[order]
        if name == "T4_median_by":
            rng = np.random.default_rng(7)
            rows = rng.choice(n, MEDIAN_SAMPLE, replace=False)
            want = np.array([np.median(p[a:b]) for a, b in
                             zip(lo[rows], hi[rows])], dtype=np.float32)
            return {"x": want}, {}, {}, order[rows]
        cnt, s, mean, mx, var, sq = _window_stats(p, lo, hi)
        ab = np.abs(s).astype(np.float64)
        mb = ("f32", _unsort(order, _mean_bound(cnt, ab)))
        mean64 = _unsort(order, mean.astype(np.float64))
        if name == "T4_mean_by":
            return {"x": mean64}, {}, {"x": mb}
        if name == "T4_max_by":
            return {"x": _unsort(order, mx)}, {}, {}
        cv = np.r_[0, np.cumsum(vol[order].astype(np.int64))]
        return {"symbol": sym, "ts": ts,
                "volume": _unsort(order, cv[hi] - cv[lo]),
                "mean": mean64, "max": _unsort(order, mx),
                "std": _unsort(order, var.astype(np.float64)),
                "first": _unsort(order, p[lo]),
                "last": _unsort(order, p[hi - 1]),
                "n": _unsort(order, cnt)}, \
            {"std": _unsort(order, cnt > 1)}, \
            {"mean": mb, "std": ("var32", _unsort(
                order, 8 * cnt * 2.0 ** -53 * sq))}
    if name == "T4_sum_by":
        lo = np.searchsorted(ts, ts - MINUTE_US, "right")
        hi = np.searchsorted(ts, ts, "right")
        cv = np.r_[0, np.cumsum(vol.astype(np.int64))]
        return {"x": (cv[hi] - cv[lo]).astype(np.int32)}, {}, {}
    if name == "T4_ewm_by":
        y = _ewm_by(price, ts, 30 * 1_000_000)
        return {"x": y}, {}, {"x": 8 * np.log2(n) * 2.0 ** -24 * np.abs(y)}
    if name == "T5_calendar":
        hour = ts // 3_600_000_000 % 24
        keep = (hour >= 13) & (hour < 21)
        local = ts - np.where(ts < DST_2024_US, 5, 4) * 3_600_000_000
        order, starts, ends, _ = _runs(sym)
        t = ts[order]
        gap = np.r_[0, t[1:] - t[:-1]]
        first = np.zeros(n, dtype=bool)
        first[starts] = True
        session = np.where((hour >= 13) & (hour < 21), "us", np.where(
            (hour >= 7) & (hour < 13), "europe", "asia")).astype(object)
        days = ts // 86_400_000_000
        want = {"symbol": sym, "price": price, "volume": vol, "ts": ts,
                "h": local // 3_600_000_000 % 24,
                "wd": (days + 3) % 7 + 1,
                "tr": ts // 3_600_000_000 * 3_600_000_000, "d": days,
                "gap": _unsort(order, gap), "session": session}
        return {k: v[keep] for k, v in want.items()}, \
            {"gap": _unsort(order, ~first)[keep]}, {}
    raise KeyError(name)


def check_time(name, got, d):
    """A phase-12 result (host_columns; String columns decoded) against
    time_oracle; T4_median_by on its sampled rows."""
    out = time_oracle(name, d, got)
    if len(out) == 4:
        want, valid, tol, rows = out
        got = {k: (g[rows], None if gv is None else gv[rows])
               for k, (g, gv) in got.items()}
        _, errs = compare_columns(name, got, want, valid, tol)
        return len(d["ts"]), errs
    return compare_columns(name, got, *out)


def decoded_columns(out):
    """host_columns with each String column decoded by its dictionary."""
    got = host_columns(out)
    for k, c in out._table.cols.items():
        if c.dtype.is_string:
            codes, valid = got[k]
            got[k] = (c.sdict.decode(codes), valid)
    return got


def run_time_phase(args, torch, TK, TP, TE, TH, TM, tqueries, tdata,
                   first_ms, runs):
    """Phase 12: every query's collect with its launches asserted, its
    result copied to the host, a trace and the timed collects; then the
    numpy oracles."""
    import numpy as np
    results = []
    for name, lft, must, never in tqueries:
        reset_launches(TK, TP, TE, TH, TM)
        outt = lft.collect()
        tl = read_launches(TK, TP, TE, TH, TM)
        for kernel in must:
            assert tl[kernel] >= 1, f"{name} did not launch {kernel}"
        for kernel in never:
            assert tl[kernel] == 0, f"{name} launched {kernel}"
        assert tl["fallbacks"] == 0, f"{name} took the fallback"
        runs.append(tl)
        got = decoded_columns(outt)
        del outt
        tr = trace_collect(lft, top_n=8)
        times = time_collects(lft, args.reps)
        results.append((name, got, tl, times, tr))
    for name, got, tl, times, tr in results:
        nout, errs = check_time(name, got, tdata)
        for k, (g, _) in got.items():
            if g.dtype.kind == "f":
                assert np.isfinite(g).all() or name == "T1_vwap", \
                    f"{name}: {k} is not finite"
        med = statistics.median(times)
        print(json.dumps({
            "phase": "time", "query": name, "rows": len(tdata["ts"]),
            "out_rows": nout, "launches": tl, "largest_error": errs,
            "first_collect_ms": first_ms.get(name),
            "median_ms": med, "ms": times,
            "idle_share": 1 - tr["device_busy_ms"] / med
            if tr["device_ops"] else None, "trace": tr}))


# --- phase 13: as-of and inequality joins, the select context ---------------

ASOF_TOLERANCE_US = 1_000_000      # A1's tolerance, "1s"
N_WINDOWS = 1024                   # I1's event windows
WINDOW_S = (60, 600)               # their lengths, in seconds
TCA_VOLUME = (1250, 3749)          # X1's volume band: half of [0, 5000)
SPREAD = (0.01, 0.05)              # a quote's ask - bid


def _session_us(ms):
    """Milliseconds into the concatenated sessions -> epoch µs."""
    import numpy as np
    opens = np.array(SESSION_OPENS, dtype="datetime64[us]").astype(np.int64)
    return opens[ms // SESSION_MS] + (ms % SESSION_MS) * 1000


def make_quotes_data(rows: int, seed: int):
    """Quotes drawn as the trades are (seed + 5): symbol UInt32 in [0,
    1000), ts whole milliseconds ascending over the same sessions, bid
    Float64 over the trades' price range, ask = bid + a spread in
    [0.01, 0.05]."""
    import numpy as np
    rng = np.random.default_rng(seed + 5)
    ms = np.sort(rng.integers(0, len(SESSION_OPENS) * SESSION_MS, rows))
    bid = rng.uniform(1, 200, rows)
    return {"symbol": rng.integers(0, N_SYMBOLS, rows).astype(np.uint32),
            "ts": _session_us(ms), "bid": bid,
            "ask": bid + rng.uniform(*SPREAD, rows)}


def make_windows_data(seed: int, n: int = N_WINDOWS):
    """Event windows (seed + 6): start uniform over the sessions'
    milliseconds, end = start + 60..600 s, an Int32 id and a Float64
    weight."""
    import numpy as np
    rng = np.random.default_rng(seed + 6)
    start = _session_us(rng.integers(0, len(SESSION_OPENS) * SESSION_MS, n))
    length = rng.integers(WINDOW_S[0] * 1000, WINDOW_S[1] * 1000 + 1, n)
    return {"start": start, "end": start + length * 1000,
            "wid": np.arange(n, dtype=np.int32),
            "weight": rng.uniform(0, 1, n)}


def _frame_of(pl, data, times, device):
    cols = {k: (v.astype("datetime64[us]") if k in times else v)
            for k, v in data.items()}
    return pl.DataFrame(cols, device=device)


def asof_frames(pl, tdata, qdata, wdata, device="cuda"):
    return (_frame_of(pl, tdata, ("ts",), device),
            _frame_of(pl, qdata, ("ts",), device),
            _frame_of(pl, wdata, ("start", "end"), device))


def tca_exprs(pl):
    """The transaction-cost columns over an as-of join's output: the
    quote's mid and each trade's slippage from it in basis points,
    clipped to +-500 and rounded to 0.01."""
    c = pl.col
    mid = (c("bid") + c("ask")) / 2
    slip = ((c("price") - mid) / mid * 1e4).clip(-500, 500).round(2)
    return mid.alias("mid"), slip.alias("slip_bps")


def asof_queries(pl, tdf, qdf, wdf, tolerance_us=ASOF_TOLERANCE_US):
    """(name, lazy frame, kernels it must launch, kernels it must not) of
    phase 13: A1-A3 trades joined as of their quotes (by symbol backward
    within 1 s, market-wide nearest, by symbol forward), I1 the trades in
    each event window (an inequality join), X1 a TCA select over A1 and
    X2 per-symbol TCA aggregates over A1. A1's tolerance is a duration
    string ("1000000us" is A1's "1s")."""
    c = pl.col
    t, q = tdf.lazy(), qdf.lazy()
    a1 = t.join_asof(q, on="ts", by="symbol", strategy="backward",
                     tolerance=f"{tolerance_us}us")
    mid, slip = tca_exprs(pl)
    lo, hi = TCA_VOLUME
    x1 = (a1.with_columns(mid, slip,
                          (c("price") - c("price").mean()).alias("dev"))
          .filter(c("mid").is_not_null() & c("volume").is_between(lo, hi))
          .select(c("slip_bps").mean().alias("slip_mean"),
                  ((c("slip_bps") * c("volume")).sum() / c("volume").sum())
                  .alias("slip_vw"), pl.len().alias("n"),
                  c("slip_bps").skew().alias("slip_skew"),
                  c("dev").abs().max().alias("dev_max")))
    x2 = (a1.with_columns(slip).group_by("symbol").agg(
        c("slip_bps").mean().alias("slip_mean"),
        c("slip_bps").skew().alias("slip_skew"),
        c("slip_bps").kurtosis().alias("slip_kurt"),
        c("price").nan_max().alias("price_max"),
        c("volume").bitwise_or().alias("volume_or")))
    F, B = ("merge_sort",), ("compact_words",)
    return [
        ("A1_backward", a1, B, F),
        ("A2_nearest", t.join_asof(q, on="ts", strategy="nearest"), (),
         F + B),
        ("A3_forward", t.join_asof(q, on="ts", by="symbol",
                                   strategy="forward"), B, F),
        ("I1_windows", t.join_where(wdf.lazy(), c("ts") >= c("start"),
                                    c("ts") < c("end")), F, ()),
        ("X1_tca", x1, B, F),
        ("X2_tca_by_symbol", x2, B + ("seg_sum",), F),
    ]


def _asof_match(td, qd, strategy, by, tol_us=None):
    """The numpy as-of join: each trade's quote row and whether it has
    one, by a stable argsort of the quotes' (symbol, ts) key (41 bits of
    ts offset under the symbol, or ts alone without `by`) and
    np.searchsorted; a tie of distances goes backward."""
    import numpy as np
    tts, qts = td["ts"], qd["ts"]
    if by:
        base = min(tts.min(), qts.min())
        tk = (td["symbol"].astype(np.int64) << 41) | (tts - base)
        qk = (qd["symbol"].astype(np.int64) << 41) | (qts - base)
    else:
        tk, qk = tts, qts
    order = np.argsort(qk, kind="stable")
    sk = qk[order]
    n = len(sk)

    def side(s):
        p = np.searchsorted(sk, tk, s) - (s == "right")
        pc = np.clip(p, 0, n - 1)
        ok = (p >= 0) & (p < n)
        if by:
            ok &= (sk[pc] >> 41) == td["symbol"].astype(np.int64)
        return pc, ok

    if strategy == "backward":
        p, ok = side("right")
    elif strategy == "forward":
        p, ok = side("left")
    else:
        p1, ok1 = side("right")
        p2, ok2 = side("left")
        d1 = tts - qts[order[p1]]
        d2 = qts[order[p2]] - tts
        use1 = ok1 & (~ok2 | (d1 <= d2))
        p = np.where(use1, p1, p2)
        ok = ok1 | ok2
    ridx = order[p]
    if tol_us is not None:
        ok &= np.abs(tts - qts[ridx]) <= tol_us
    return ridx, ok


def _moment_bound(x, w=None):
    """A tolerance for a mean of `x` (weights `w`): 1e-12 of the mean of
    |x| (the f64 sum's rounding, whatever its order), at least 1e-300."""
    import numpy as np
    a = np.abs(x) if w is None else np.abs(x * w)
    d = len(x) if w is None else np.abs(w).sum()
    return max(1e-12 * a.sum() / max(d, 1), 1e-300)


def _tca_host(td, qd, ridx, ok):
    """mid and slip_bps in f64 as the port computes them, per trade (NaN
    where there is no quote)."""
    import numpy as np
    mid = (qd["bid"][ridx] + qd["ask"][ridx]) / 2
    slip = np.round(np.clip((td["price"].astype(np.float64) - mid) / mid
                            * 1e4, -500, 500) * 100) / 100
    return np.where(ok, mid, np.nan), np.where(ok, slip, np.nan)


def _skew_kurt(x):
    """The biased skew and Fisher kurtosis of x, in f64, two passes."""
    import numpy as np
    d = x - x.mean()
    m2 = (d * d).mean()
    return (d ** 3).mean() / m2 ** 1.5, (d ** 4).mean() / (m2 * m2) - 3.0


def asof_oracle(name, td, qd, wd, got, tolerance_us=ASOF_TOLERANCE_US):
    """(want, valid, tol) of a phase-13 query for compare_columns; I1's
    and X2's got are reordered to the oracle's order first (in place)."""
    import numpy as np
    if name.startswith(("A", "X")):
        strategy = {"A1": "backward", "A2": "nearest", "A3": "forward",
                    "X1": "backward", "X2": "backward"}[name[:2]]
        by = name[:2] != "A2"
        tol = tolerance_us if name[:2] in ("A1", "X1", "X2") else None
        ridx, ok = _asof_match(td, qd, strategy, by, tol)
    if name.startswith("A"):
        want = dict(td)
        valid = {}
        for k in ("bid", "ask") + (() if by else ("symbol",)):
            key = k if k != "symbol" else "symbol_right"
            want[key], valid[key] = qd[k][ridx], ok
        return want, valid, {}
    if name.startswith("I1"):
        lo = np.searchsorted(td["ts"], wd["start"], "left")
        hi = np.searchsorted(td["ts"], wd["end"], "left")
        m = hi - lo
        w = np.repeat(np.arange(len(m)), m)
        t = np.repeat(lo - np.r_[0, np.cumsum(m)[:-1]], m) + \
            np.arange(m.sum())
        want = {**{k: v[t] for k, v in td.items()},
                **{k: v[w] for k, v in wd.items()}}
        key = lambda d: np.lexsort((d["price"].view(np.uint32),
                                    d["volume"], d["symbol"], d["ts"],
                                    d["wid"]))
        ow = key(want)
        want = {k: v[ow] for k, v in want.items()}
        og = key({k: g for k, (g, _) in got.items()})
        for k in got:
            got[k] = (got[k][0][og], None if got[k][1] is None
                      else got[k][1][og])
        return want, {}, {}
    mid, slip = _tca_host(td, qd, ridx, ok)
    if name.startswith("X1"):
        price = td["price"]
        dev = price - np.float32(price.astype(np.float64).sum() / len(price))
        lo, hi = TCA_VOLUME
        keep = ok & (td["volume"] >= lo) & (td["volume"] <= hi)
        s, v = slip[keep], td["volume"][keep].astype(np.float64)
        sk, _ = _skew_kurt(s)
        dmax = np.abs(dev[keep]).max()
        want = {"slip_mean": np.array([s.mean()]),
                "slip_vw": np.array([(s * v).sum() / v.sum()]),
                "n": np.array([keep.sum()]),
                "slip_skew": np.array([sk]),
                "dev_max": np.array([dmax], dtype=np.float32)}
        tol = {"slip_mean": np.array([_moment_bound(s)]),
               "slip_vw": np.array([_moment_bound(s, v)]),
               "slip_skew": np.array([1e-10 * max(1.0, abs(sk))]),
               "dev_max": ("f32", np.array([float(np.spacing(
                   np.float32(dmax)))]))}
        return want, {}, tol
    # X2: per symbol, in key order
    syms = np.unique(td["symbol"])
    cols = {k: [] for k in ("slip_mean", "slip_skew", "slip_kurt",
                            "price_max", "volume_or")}
    tol = {k: [] for k in ("slip_mean", "slip_skew", "slip_kurt")}
    has, moments = [], []
    for g in syms:
        rows = td["symbol"] == g
        s = slip[rows & ok]
        has.append(len(s) > 0)
        moments.append(len(s) > 0 and s.var() > 0)
        sk, ku = _skew_kurt(s) if moments[-1] else (0.0, 0.0)
        cols["slip_mean"].append(s.mean() if has[-1] else 0.0)
        cols["slip_skew"].append(sk)
        cols["slip_kurt"].append(ku)
        cols["price_max"].append(td["price"][rows].max())
        cols["volume_or"].append(np.bitwise_or.reduce(td["volume"][rows]))
        tol["slip_mean"].append(_moment_bound(s))
        tol["slip_skew"].append(1e-10 * max(1.0, abs(sk)))
        tol["slip_kurt"].append(1e-10 * max(1.0, abs(ku)))
    want = {"symbol": syms, **{k: np.array(v) for k, v in cols.items()}}
    want["price_max"] = want["price_max"].astype(np.float32)
    want["volume_or"] = want["volume_or"].astype(np.int32)
    order = np.argsort(got["symbol"][0], kind="stable")
    for k in got:
        got[k] = (got[k][0][order], None if got[k][1] is None
                  else got[k][1][order])
    has, moments = np.array(has), np.array(moments)
    valid = {} if has.all() and moments.all() else {
        "slip_mean": has, "slip_skew": moments, "slip_kurt": moments}
    return want, valid, {k: np.array(v) for k, v in tol.items()}


def run_asof_phase(args, torch, TK, TP, TE, TH, TM, queries, td, qd, wd,
                   first_ms, runs):
    """Phase 13: every query's collect with its launches asserted, its
    result copied to the host, a trace and the timed collects; then the
    numpy oracles."""
    import numpy as np
    results = []
    for name, lfq, must, never in queries:
        reset_launches(TK, TP, TE, TH, TM)
        out = lfq.collect()
        ql = read_launches(TK, TP, TE, TH, TM)
        for kernel in must:
            assert ql[kernel] >= 1, f"{name} did not launch {kernel}"
        for kernel in never:
            assert ql[kernel] == 0, f"{name} launched {kernel}"
        assert ql["fallbacks"] == 0, f"{name} took the fallback"
        runs.append(ql)
        got = host_columns(out)
        del out
        tr = trace_collect(lfq, top_n=8)
        times = time_collects(lfq, args.reps)
        results.append((name, got, ql, times, tr))
    for name, got, ql, times, tr in results:
        want, valid, tol = asof_oracle(name, td, qd, wd, got)
        nout, errs = compare_columns(name, got, want, valid, tol)
        med = statistics.median(times)
        matched = valid.get("bid")
        print(json.dumps({
            "phase": "asof", "query": name, "trades": len(td["ts"]),
            "quotes": len(qd["ts"]), "windows": len(wd["start"]),
            "out_rows": nout,
            "matched": None if matched is None else int(matched.sum()),
            "launches": ql, "largest_error": errs,
            "first_collect_ms": first_ms.get(name), "median_ms": med,
            "ms": times, "idle_share": 1 - tr["device_busy_ms"] / med
            if tr["device_ops"] else None, "trace": tr}))


def check_lookup_join(args, torch, TE):
    """The kernel-level join at bench.py:589-608's shape, 2^22 probes x
    2^20 unique build keys: `lookup_join_collocated`, held against the
    values (every probe key is built), timed, and traced for kernel E's
    own device time."""
    from polaroid_tpu_torch.ops.hjoin import lookup_join_collocated
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    nb, npr = 1 << 20, 1 << 22
    bkey = torch.randperm(nb, generator=g, device=dev)
    bval = torch.rand(nb, generator=g, device=dev)
    pkey = torch.randint(0, nb, (npr,), generator=g, device=dev)
    pidx, value, hit, live, ok = lookup_join_collocated(bkey, bval, pkey)
    assert bool(ok), "the lookup join refused its input"
    want = torch.empty_like(bval)
    want[bkey] = bval
    assert int(live.sum()) == npr and bool((hit == live).all()), \
        "lookup join: a probe row is missing or has no build row"
    assert torch.equal(value[live], want[pkey[pidx[live]]]), \
        "lookup join: values differ"
    ex = device_ms_of(lambda: lookup_join_collocated(bkey, bval, pkey),
                      "exchange_kernel")
    return {"probes": npr, "build": nb,
            "ms": cuda_ms(lambda: lookup_join_collocated(bkey, bval, pkey),
                          args.reps),
            "exchange_device_ms": ex["trace_ms"],
            "trace_device_ops": ex.get("trace_device_ops"),
            "traces_taken": ex["traces_taken"]}


# --- phase 14: strings and nested columns ------------------------------------

# 16 participant codes of the NYSE Daily TAQ trade file's Exchange field;
# "D" is FINRA's trade reporting facility, which prints about 35% of trades
VENUE_CODES = "ABCDHIJKLMNPUVXZ"
TRF_SHARE = 0.35
SUFFIX_SHARE = 0.03     # tickers with a share class, as in "BRK A"
SWEEP_SHARE = 0.30      # "F" (intermarket sweep) in the condition's slot 2
EXT_SHARE = 0.03        # "T" or "U" (extended hours) in slot 3
ODD_SHARE = 0.45        # "I" (odd lot) in slot 4
TAQ_CODES = "@FTUI"     # what the condition's slots can hold, blank aside


def make_taq_data(rows: int, seed: int):
    """Phase 12's trades (make_trades_data) plus the string columns of a
    NYSE Daily TAQ trade record, drawn from seed + 7 as fixed-width numpy
    unicode arrays: sym, each symbol's ticker (a unique root of 1-4
    capital letters, 3% with a share class, "BRK A"); ex, the exchange
    code (16 codes, "D" on about 35% of prints); cond, the 4-character
    sale condition ("@" or blank in each slot, "F" in slot 2 on 30%, "T"
    or "U" in slot 3 on 3%, "I" in slot 4 on 45% of prints); date, the
    session's New York date as "YYYYMMDD". The draws (sym_id, ex_id,
    the condition's code points, the session) stay for the oracles."""
    import numpy as np
    data = make_trades_data(rows, seed)
    rng = np.random.default_rng(seed + 7)
    roots, seen = [], set()
    while len(roots) < N_SYMBOLS:
        k = int(rng.choice(4, p=[0.02, 0.18, 0.40, 0.40])) + 1
        r = "".join(chr(65 + c) for c in rng.integers(0, 26, k))
        if r not in seen:
            seen.add(r)
            roots.append(r)
    has_cls = rng.random(N_SYMBOLS) < SUFFIX_SHARE
    cls = np.array(["AB"[c] for c in rng.integers(0, 2, N_SYMBOLS)])
    tickers = np.array([r + (" " + c if h else "")
                        for r, h, c in zip(roots, has_cls, cls)])
    p = np.full(len(VENUE_CODES), (1 - TRF_SHARE) / (len(VENUE_CODES) - 1))
    p[VENUE_CODES.index("D")] = TRF_SHARE
    ex_id = rng.choice(len(VENUE_CODES), rows, p=p)
    cp = np.where(rng.random((rows, 4)) < 0.5, ord("@"), ord(" ")) \
        .astype(np.uint32)
    cp[:, 1] = np.where(rng.random(rows) < SWEEP_SHARE, ord("F"), cp[:, 1])
    tu = np.where(rng.random(rows) < 0.5, ord("T"), ord("U"))
    cp[:, 2] = np.where(rng.random(rows) < EXT_SHARE, tu, cp[:, 2])
    cp[:, 3] = np.where(rng.random(rows) < ODD_SHARE, ord("I"), cp[:, 3])
    opens = np.array(SESSION_OPENS, dtype="datetime64[us]").astype(np.int64)
    session = np.searchsorted(opens, data["ts"], "right") - 1
    days = np.array([d[:10].replace("-", "") for d in SESSION_OPENS])
    sym_id = data.pop("symbol").astype(np.int64)
    data.update(
        sym=tickers[sym_id], ex=np.array(list(VENUE_CODES))[ex_id],
        cond=np.ascontiguousarray(cp).view("<U4").ravel(),
        date=days[session])
    extra = {"sym_id": sym_id, "ex_id": ex_id, "cp": cp,
             "session": session, "tickers": tickers,
             "roots": np.array(roots), "has_cls": has_cls, "cls": cls}
    return data, extra


def taq_frame(pl, data, device="cuda"):
    """The trades with their TAQ strings: sym, ex, cond, date, price,
    volume, ts."""
    cols = {k: data[k] for k in ("sym", "ex", "cond", "date", "price",
                                 "volume")}
    cols["ts"] = data["ts"].astype("datetime64[us]")
    return pl.DataFrame(cols, device=device)


def taq_queries(pl, df):
    """(name, lazy frame, kernels it must launch, kernels it must not) of
    phase 14: P1 volume by venue and day, P2 symbol normalisation, L1
    per-symbol sequences (implode), L2 sale-condition codes (explode), L3
    L1 back to rows. The kernels: F merge_sort, B compact_words, A
    seg_sum, C seg_minmax, E bucket_exchange."""
    c = pl.col
    p1 = (df.lazy()
          .with_columns(
              venue=pl.concat_str([c("sym"), c("ex")], separator="."),
              odd=c("cond").str.contains("I", literal=True),
              ext=c("cond").str.contains("[TU]"),
              day=c("date").str.strptime(pl.Date, "%Y%m%d"))
          .filter(~c("ext") & ~c("odd"))
          .group_by(["day", "venue"])
          .agg(pl.len().alias("n"), c("volume").sum().alias("volume"),
               c("price").mean().alias("price")))
    px = c("price").round(2).cast(pl.String)
    p2 = df.lazy().select(
        root=c("sym").str.split(" ").list.first(),
        cls=c("sym").str.extract(r" (\w)$", 1),
        ticker=c("sym").str.replace(" ", ".", literal=True)
        .str.to_lowercase(),
        nch=c("sym").str.len_chars(),
        px=px, back=px.cast(pl.Float64))
    l1 = (df.lazy()
          .with_columns(ticks=pl.struct(["ts", "price"]))
          .group_by("sym", maintain_order=True)
          .agg(c("price"), c("volume"), c("ex").alias("venues"), c("ticks"))
          .with_columns(n=c("price").list.len(), hi=c("price").list.max(),
                        m=c("price").list.mean(),
                        last=c("price").list.last(),
                        nv=c("venues").list.n_unique()))
    l2 = (df.lazy()
          .with_columns(codes=c("cond").str.extract_all(r"[^ ]"))
          .explode("codes")
          .group_by("codes")
          .agg(pl.len().alias("n"), c("volume").sum().alias("volume")))
    # the struct's price field would meet the price list's name when
    # unnested, which polars refuses: the list comes back as px
    l3 = (l1.select("sym", c("price").alias("px"), "volume", "ticks")
          .explode(["px", "volume", "ticks"])
          .unnest("ticks"))
    kernels = ("merge_sort", "compact_words", "seg_sum", "seg_minmax",
               "bucket_exchange")

    def never(*must):
        return tuple(k for k in kernels if k not in must)
    return [("P1", p1, ("merge_sort", "compact_words"),
             never("merge_sort", "compact_words")),
            ("P2", p2, (), never()),
            ("L1", l1, ("seg_sum", "seg_minmax"),
             never("seg_sum", "seg_minmax")),
            ("L2", l2, ("seg_sum", "compact_words"),
             never("seg_sum", "compact_words")),
            ("L3", l3, ("seg_sum", "seg_minmax"),
             never("seg_sum", "seg_minmax"))]


def _taq_cols(out):
    """A collected frame's columns on the host: flat ones as (values,
    validity or None); String ones with their dictionary's strings as a
    third item; List ones as {"data", "lengths", "elem_valid",
    "validity", "values"} (2-D data); List(Struct) ones with "fields",
    one such dict per field."""
    t = out._table
    n = t.count_rows()

    def h(x):
        return None if x is None else x[:n].cpu().numpy()

    def one(c):
        if c.lengths is not None:
            d = {"lengths": h(c.lengths), "elem_valid": h(c.elem_valid),
                 "validity": h(c.validity),
                 "values": None if c.sdict is None else c.sdict.values}
            if c.fields is not None:
                d["fields"] = {k: one(f) for k, f in c.fields.items()}
            else:
                d["data"] = h(c.data)
            return d
        if c.dtype.is_string:
            return h(c.data), h(c.validity), c.sdict.values
        return h(c.data), h(c.validity)
    return {k: one(c) for k, c in t.cols.items()}


def _codes_of(values, strings):
    """The codes of `strings` in a sorted dictionary's `values` (every
    string must be there)."""
    import numpy as np
    values = np.asarray(values, dtype=object)
    idx = np.searchsorted(values, strings)
    assert (idx < len(values)).all() and \
        (values[np.minimum(idx, len(values) - 1)] == strings).all(), \
        "a string is missing from the dictionary"
    return idx


def _codes_at(values, strings, ids):
    """_codes_of(values, strings[ids]), looking up each distinct id once
    (only the strings a result holds are in its dictionary)."""
    import numpy as np
    u, inv = np.unique(ids, return_inverse=True)
    return _codes_of(values, strings[u])[inv]


def _flat_lists(col):
    """A List column's elements in row order, concatenated (2-D data
    read row by row inside each length)."""
    import numpy as np
    d = col["data"]
    inside = np.arange(d.shape[1])[None, :] < col["lengths"][:, None]
    assert col["validity"] is None or col["validity"].all(), "null list"
    assert col["elem_valid"] is None or col["elem_valid"][inside].all(), \
        "null element"
    return d[inside]


def _same(name, k, got, want):
    import numpy as np
    assert got.shape == want.shape, \
        f"{name}: {k} has {got.shape}, want {want.shape}"
    u = f"u{want.dtype.itemsize}"
    if got.dtype.kind == "f" or want.dtype.kind == "f":
        assert got.dtype == want.dtype and np.array_equal(
            got.view(u), want.view(u)), f"{name}: {k} differs"
    else:
        assert np.array_equal(got.astype(np.int64), want.astype(np.int64)), \
            f"{name}: {k} differs"


def _fmt_float(x: float) -> str:
    """A float as the cast to String writes it (the JAX package's
    `_fmt_float`)."""
    if x == int(x) and abs(x) < 1e15:
        return f"{x:.1f}"
    return repr(float(x))


def taq_oracle(name, got, d, x):
    """Hold one phase-14 result (_taq_cols) against numpy: strings,
    counts, integer sums, list lengths and elements, maxima and lasts bit
    for bit; f64 means within rtol 1e-12, P1's Float32 mean within one
    ulp of the f64 mean; `back` equal to round(price, 2). Returns (rows
    out, the largest relative error of each inexact column)."""
    import numpy as np
    price, volume = d["price"], d["volume"].astype(np.int64)
    errs = {}
    if name == "P1":
        cp = x["cp"]
        keep = (cp[:, 3] != ord("I")) & ~np.isin(cp[:, 2], [ord("T"),
                                                           ord("U")])
        nv = len(VENUE_CODES)
        key = (x["session"] * N_SYMBOLS + x["sym_id"]) * nv + x["ex_id"]
        uk, inv, cnt = np.unique(key[keep], return_inverse=True,
                                 return_counts=True)
        vol = np.bincount(inv, weights=volume[keep], minlength=len(uk))
        mean = np.bincount(inv, weights=price[keep].astype(np.float64),
                           minlength=len(uk)) / cnt
        days, _ = got["day"]
        vcodes, _, vvals = got["venue"]
        sess_of_day = {int(v): i for i, v in enumerate(
            np.array([s[:10] for s in SESSION_OPENS], dtype="datetime64[D]")
            .astype(np.int64))}
        tick_id = {t: i for i, t in enumerate(x["tickers"])}
        vkey = np.array([tick_id[s.rsplit(".", 1)[0]] * nv +
                         VENUE_CODES.index(s.rsplit(".", 1)[1])
                         for s in vvals], dtype=np.int64)
        gkey = np.array([sess_of_day[int(v)] for v in days]) \
            * (N_SYMBOLS * nv) + vkey[vcodes]
        order = np.argsort(gkey)
        _same(name, "keys", gkey[order], uk)
        _same(name, "n", got["n"][0][order], cnt)
        _same(name, "volume", got["volume"][0][order], vol.astype(np.int64))
        g = got["price"][0][order]
        assert g.dtype == np.float32
        err = np.abs(g.astype(np.float64) - mean)
        assert (err <= np.spacing(np.abs(mean.astype(np.float32)))).all(), \
            f"{name}: price outside one f32 ulp"
        errs["price"] = float((err / np.abs(mean)).max())
        return len(uk), errs
    sym_id = x["sym_id"]
    if name == "P2":
        tick = x["tickers"]
        want = {"root": x["roots"],
                "ticker": np.array([t.replace(" ", ".").lower()
                                    for t in tick])}
        for k, w in want.items():
            codes, valid, vals = got[k]
            assert valid is None or valid.all(), f"{name}: {k} has nulls"
            _same(name, k, codes, _codes_at(vals, w, sym_id))
        codes, valid, vals = got["cls"]
        has = x["has_cls"][sym_id]
        assert valid is not None and np.array_equal(valid, has), \
            f"{name}: the nulls of cls differ"
        _same(name, "cls", codes[has], _codes_at(vals, x["cls"], sym_id[has]))
        _same(name, "nch", got["nch"][0],
              np.array([len(t) for t in tick])[sym_id])
        back = np.round(price, 2).astype(np.float64)
        _same(name, "back", got["back"][0], back)
        codes, _, vals = got["px"]
        lut = np.array([float(s) for s in vals])
        assert all(_fmt_float(v) == s for v, s in zip(lut, vals)), \
            f"{name}: a px string is not its value's"
        _same(name, "px", lut[codes], back)
        return len(sym_id), errs
    first = np.unique(sym_id, return_index=True)[1]
    order = np.unique(sym_id)[np.argsort(first)]      # by first appearance
    rank = np.empty(N_SYMBOLS, np.int64)
    rank[order] = np.arange(len(order))
    perm = np.argsort(rank[sym_id], kind="stable")
    counts = np.bincount(rank[sym_id], minlength=len(order))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    tick = x["tickers"]
    if name == "L1":
        codes, _, vals = got["sym"]
        _same(name, "sym", codes, _codes_of(vals, tick[order]))
        for k, src in (("price", price), ("volume", d["volume"])):
            _same(name, k + " lengths", got[k]["lengths"], counts)
            _same(name, k, _flat_lists(got[k]), src[perm])
        ven = got["venues"]
        _same(name, "venues", _flat_lists(ven), _codes_of(
            ven["values"], np.array(list(VENUE_CODES)))[x["ex_id"][perm]])
        ticks = got["ticks"]
        _same(name, "ticks lengths", ticks["lengths"], counts)
        _same(name, "ticks.ts", _flat_lists(ticks["fields"]["ts"]),
              d["ts"][perm])
        _same(name, "ticks.price", _flat_lists(ticks["fields"]["price"]),
              price[perm])
        ps = price[perm]
        _same(name, "n", got["n"][0], counts)
        _same(name, "hi", got["hi"][0], np.maximum.reduceat(ps, starts))
        _same(name, "last", got["last"][0], ps[starts + counts - 1])
        mean = np.add.reduceat(ps.astype(np.float64), starts) / counts
        err = np.abs(got["m"][0] - mean) / np.abs(mean)
        assert (err <= 1e-12).all(), f"{name}: m outside rtol 1e-12"
        errs["m"] = float(err.max())
        pairs = np.unique(rank[sym_id] * len(VENUE_CODES) + x["ex_id"])
        _same(name, "nv", got["nv"][0],
              np.bincount(pairs // len(VENUE_CODES), minlength=len(order)))
        return len(order), errs
    if name == "L2":
        cp = x["cp"]
        codes, valid, vals = got["codes"]
        n, vol = got["n"][0], got["volume"][0]
        seen = {}
        for i in range(len(codes)):
            key = None if valid is not None and not valid[i] \
                else vals[codes[i]]
            seen[key] = (int(n[i]), int(vol[i]))
        want = {}
        for ch in TAQ_CODES:
            hit = cp == ord(ch)
            if hit.any():
                want[ch] = (int(hit.sum()),
                            int((hit * volume[:, None]).sum()))
        empty = (cp == ord(" ")).all(axis=1)
        if empty.any():
            want[None] = (int(empty.sum()), int(volume[empty].sum()))
        assert seen == want, f"{name}: {seen} != {want}"
        return len(want), errs
    # L3: the trades stably sorted by their symbol's first appearance
    codes, _, vals = got["sym"]
    _same(name, "sym", codes, _codes_at(vals, tick, sym_id[perm]))
    _same(name, "px", got["px"][0], price[perm])
    _same(name, "volume", got["volume"][0], d["volume"][perm])
    _same(name, "ts", got["ts"][0], d["ts"][perm])
    _same(name, "price", got["price"][0], price[perm])
    for k in ("px", "volume", "ts", "price"):
        assert got[k][1] is None or got[k][1].all(), f"{name}: {k} nulls"
    return len(sym_id), errs


def make_taq(args, torch, pl):
    """Phase 14's data, its frame on the card (the build timed, fenced:
    the string columns' dictionary encode and the copies) and queries."""
    d, x = make_taq_data(args.rows, args.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    df = taq_frame(pl, d)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    return {"data": d, "draws": x, "frame": df, "build_ms": build_ms,
            "queries": taq_queries(pl, df)}


def run_taq_only(args, torch, pl, TK, TP, TE, TH, TM):
    """--only-taq: phase 2 on phase 14's launches, then phase 14."""
    taq = make_taq(args, torch, pl)
    _, first_ms = check_recorded_kernels(
        args, torch, TK, TE, TM, TP,
        [(name, lf) for name, lf, *_ in taq["queries"]])
    run_taq_phase(args, torch, TK, TP, TE, TH, TM, taq["queries"],
                  taq["data"], taq["draws"], first_ms, taq["build_ms"], [])


def run_taq_phase(args, torch, TK, TP, TE, TH, TM, queries, d, x,
                  first_ms, build_ms, runs):
    """Phase 14: every query's collect with its launches asserted, its
    result copied to the host, a trace and the timed collects; then the
    numpy oracles."""
    results = []
    for name, lfq, must, never in queries:
        reset_launches(TK, TP, TE, TH, TM)
        out = lfq.collect()
        ql = read_launches(TK, TP, TE, TH, TM)
        for kernel in must:
            assert ql[kernel] >= 1, f"{name} did not launch {kernel}"
        for kernel in never:
            assert ql[kernel] == 0, f"{name} launched {kernel}"
        assert ql["fallbacks"] == 0, f"{name} took the fallback"
        runs.append(ql)
        got = _taq_cols(out)
        del out
        tr = trace_collect(lfq, top_n=8)
        times = time_collects(lfq, args.reps)
        results.append((name, got, ql, times, tr))
    for name, got, ql, times, tr in results:
        nout, errs = taq_oracle(name, got, d, x)
        med = statistics.median(times)
        print(json.dumps({
            "phase": "taq", "query": name, "trades": len(d["ts"]),
            "frame_build_ms": build_ms, "out_rows": nout,
            "launches": {"F": ql["merge_sort"], "B": ql["compact_words"],
                         "A": ql["seg_sum"], "C": ql["seg_minmax"],
                         "E": ql["bucket_exchange"]},
            "largest_rel_error": errs,
            "first_collect_ms": first_ms.get(name), "median_ms": med,
            "ms": times, "busy_ms": tr["device_busy_ms"],
            "device_ops": tr["device_ops"],
            "idle_share": 1 - tr["device_busy_ms"] / med
            if tr["device_ops"] else None,
            "top_op": tr["top"][0] if tr["top"] else None, "trace": tr}))


# --- phase 15: SQL and the rest of the surface -------------------------------

# the db-benchmark group-by suite as its SQL solutions write it
# (h2oai/db-benchmark, duckdb/groupby-duckdb.R), with each query's keys
SQL_H2O = [
    ("sql_q1", "SELECT id1, sum(v1) AS v1 FROM x GROUP BY id1", ("id1",)),
    ("sql_q2", "SELECT id1, id2, sum(v1) AS v1 FROM x GROUP BY id1, id2",
     ("id1", "id2")),
    ("sql_q3", "SELECT id3, sum(v1) AS v1, avg(v3) AS v3 FROM x GROUP BY id3",
     ("id3",)),
    ("sql_q4", "SELECT id4, avg(v1) AS v1, avg(v2) AS v2, avg(v3) AS v3 "
     "FROM x GROUP BY id4", ("id4",)),
    ("sql_q5", "SELECT id6, sum(v1) AS v1, sum(v2) AS v2, sum(v3) AS v3 "
     "FROM x GROUP BY id6", ("id6",)),
    ("sql_q6", "SELECT id4, id5, quantile_cont(v3, 0.5) AS median_v3, "
     "stddev(v3) AS sd_v3 FROM x GROUP BY id4, id5", ("id4", "id5")),
    ("sql_q7", "SELECT id3, max(v1)-min(v2) AS range_v1_v2 FROM x "
     "GROUP BY id3", ("id3",)),
    ("sql_q8", "SELECT id6, largest2_v3 FROM (SELECT id6, v3 AS largest2_v3, "
     "row_number() OVER (PARTITION BY id6 ORDER BY v3 DESC) AS order_v3 "
     "FROM x WHERE v3 IS NOT NULL) sub_query WHERE order_v3 <= 2",
     ("id6",)),
    ("sql_q9", "SELECT id2, id4, pow(corr(v1, v2), 2) AS r2 FROM x "
     "GROUP BY id2, id4", ("id2", "id4")),
    ("sql_q10", "SELECT id1, id2, id3, id4, id5, id6, sum(v3) AS v3, "
     "count(*) AS count FROM x GROUP BY id1, id2, id3, id4, id5, id6",
     ("id1", "id2", "id3", "id4", "id5", "id6")),
]
# the off-exchange (FINRA TRF) share of each symbol's volume, the 20
# largest, over phase 14's TAQ trades
SQL_TRF = ("SELECT sym, sum(CASE WHEN ex = 'D' THEN volume ELSE 0 END) / "
           "sum(volume) AS trf_share FROM trades GROUP BY sym "
           "ORDER BY trf_share DESC LIMIT 20")
TRF_TOP = 20
# each SQL query's twin through the expression API in phases 6, 9 and 11
SQL_TWIN = {"sql_q2": "q2", "sql_q3": "q3", "sql_q5": "q5", "sql_q7": "q7",
            "sql_q6": "q6", "sql_q9": "q9", "sql_q10": "q10_full",
            "sql_q8": "q8"}
H2O_OUTPUTS.update({
    "sql_q1": {"v1": ("sum", "v1")},
    "sql_q2": H2O_OUTPUTS["q2"], "sql_q3": H2O_OUTPUTS["q3"],
    "sql_q4": {"v1": ("mean", "v1"), "v2": ("mean", "v2"),
               "v3": ("mean", "v3")},
    "sql_q5": H2O_OUTPUTS["q5"], "sql_q7": H2O_OUTPUTS["q7"],
    "sql_q10": H2O_OUTPUTS["q10"],
})
CUT_BREAKS = (25.0, 50.0, 100.0, 150.0)
QCUT_BINS = 10
HIST_BINS = 64
SET_OPS = ("set_intersection", "set_union", "set_difference",
           "set_symmetric_difference")


def sql_queries(pl, hdf, tdf):
    """(name, lazy frame, host ms of its parse and translation) of phase
    15's SQL queries: the H2O suite over x = the H2O frame, sql_trf over
    trades = the TAQ frame."""
    ctx = pl.SQLContext(x=hdf, trades=tdf)
    out = []
    for name, query in [(n, q) for n, q, _ in SQL_H2O] + [("sql_trf",
                                                           SQL_TRF)]:
        t0 = time.perf_counter()
        lf = ctx.execute(query)
        out.append((name, lf, (time.perf_counter() - t0) * 1e3))
    return out


class EagerQuery:
    """An eager frame operation behind the `collect()` that the phase's
    timers and recorders call."""

    def __init__(self, fn):
        self.collect = fn


def json_dtype(pl):
    return pl.Struct([pl.Field("ex", pl.String), pl.Field("cond", pl.String)])


def surface_queries(pl, hdf, tdf):
    """(name, query) of phase 15's expression and frame surface: E3_when,
    group-level when/then over id3's 10^5 groups; E3_distinct, the
    distinct flags at 10^7 rows, those over (id3, id6) mixing both
    answers; E3_qcut/E3_cut, price deciles and fixed breaks, each
    summing the volume per bin; E3_hist, 64 price bins;
    E3_pivot, volume by sym x ex (eager: the venues are read back for
    the column names) and E3_unpivot, back to rows; and the E2 items at
    2^23 rows: struct.json_encode, str.json_decode, list.eval and the
    list set ops."""
    c = pl.col
    t = tdf.lazy()
    codes_a = pl.concat_list([c("volume") % 7, c("volume") % 5])
    codes_b = pl.concat_list([c("volume") % 3, c("volume") % 11])
    pivoted = tdf.pivot("ex", index="sym", values="volume",
                        aggregate_function="sum")
    jdf = tdf.select(pl.struct("ex", "cond").struct.json_encode().alias("j"))
    return [
        ("E3_when", hdf.lazy().group_by("id3").agg(
            pl.when(c("v1").sum() >= 300).then(c("v3").max())
            .otherwise(c("v3").min()).alias("x"))),
        ("E3_distinct", hdf.lazy().select(
            c("v3").is_unique().sum().alias("u"),
            c("id6").is_first_distinct().alias("first"),
            pl.struct("id4", "id5").is_duplicated().alias("dup"),
            pl.struct("id3", "id6").is_duplicated().alias("dup36"),
            pl.struct("id3", "id6").is_unique().alias("uniq36"))),
        ("E3_qcut", t.with_columns(b=c("price").qcut(QCUT_BINS))
         .group_by("b").agg(c("volume").sum())),
        ("E3_cut", t.with_columns(b=c("price").cut(CUT_BREAKS))
         .group_by("b").agg(c("volume").sum())),
        ("E3_hist", t.select(c("price").hist(bin_count=HIST_BINS)
                             .alias("n"))),
        ("E3_pivot", EagerQuery(lambda: tdf.pivot(
            "ex", index="sym", values="volume", aggregate_function="sum"))),
        ("E3_unpivot", pivoted.lazy().unpivot(
            index="sym", variable_name="ex", value_name="volume")),
        ("E2_json_encode", t.select(pl.struct("ex", "cond").struct
                                    .json_encode().alias("j"))),
        ("E2_json_decode", jdf.lazy().select(
            c("j").str.json_decode(json_dtype(pl)).alias("s")).unnest("s")),
        ("E2_list_eval", t.select(
            pl.concat_list([c("price"), c("price") * 2])
            .list.eval(pl.element() * 2 + 1).alias("e"))),
        ("E2_set_ops", t.select(*[getattr(codes_a.list, op)(codes_b)
                                  .alias(op) for op in SET_OPS])),
    ]


# the kernels each phase-15 query must launch: the SQL queries those of
# their API twins' routes, the histogram kernel A
SURFACE_MUST = {"sql_q1": ("seg_sum",), "sql_q4": ("seg_sum",),
                "sql_q2": ("bucket_exchange",), "sql_q3": ("bucket_exchange",),
                "sql_q5": ("bucket_exchange",), "sql_q7": ("bucket_exchange",),
                "sql_q6": ("merge_sort", "compact_words", "bucket_exchange"),
                "sql_q8": ("merge_sort", "compact_words"),
                "sql_q9": ("compact_words", "bucket_exchange"),
                "sql_q10": ("merge_sort", "compact_words"),
                "E3_when": ("bucket_exchange",),
                "E3_distinct": ("merge_sort",), "E3_hist": ("seg_sum",)}


def twin_frames(pl, hdf):
    """The API twins of the SQL queries, by name (phases 6, 9 and 11)."""
    twins = {n: lf for n, _, lf, _ in h2o_queries(pl, hdf)}
    twins.update({n: lf for n, lf, _ in sorted_tier_queries(pl, hdf, hdf)})
    twins.update({n: lf for n, lf, _ in window_queries(pl, hdf, hdf)
                  if n == "q8"})
    return {s: twins[t] for s, t in SQL_TWIN.items()}


def _bits(a):
    import numpy as np
    a = np.asarray(a)
    return a.view(f"u{a.itemsize}") if a.dtype.kind == "f" else \
        a.astype(np.int64)


def check_twin(name, got, twin):
    """A SQL result against its API twin's: the same columns (q8's
    largest2_v3 is the twin's v3) and rows, compared after sorting both
    by the keys (q8 keeps the frame's order on both); keys, integers and
    nulls bit for bit, Float64 within rtol 1e-12, as the checkers of
    phases 6 and 9 hold them: the hash tier's float sums are atomic
    scatter-adds, whose order, and so whose last bits, vary from one
    collect to the next. Returns the largest relative difference of the
    Float64 columns and whether every column matched bit for bit."""
    import numpy as np
    if name == "sql_q8":
        got = {("v3" if k == "largest2_v3" else k): v for k, v in got.items()}
    assert sorted(got) == sorted(twin), \
        f"{name}: columns {sorted(got)}, twin {sorted(twin)}"
    keys = dict((n, k) for n, _, k in SQL_H2O)[name]

    def order(cols):
        if name == "sql_q8":
            return np.arange(len(cols[keys[0]][0]))
        return np.lexsort([cols[k][0] for k in reversed(keys)])
    og, ot = order(got), order(twin)
    rel, bits = 0.0, True
    for k in twin:
        g, gv = got[k]
        w, wv = twin[k]
        assert len(g) == len(w), f"{name}: {k} has {len(g)} rows, twin " \
            f"{len(w)}"
        assert g.dtype == w.dtype, f"{name}: {k} is {g.dtype}, twin {w.dtype}"
        gv = np.ones(len(g), bool) if gv is None else gv
        wv = np.ones(len(w), bool) if wv is None else wv
        assert np.array_equal(gv[og], wv[ot]), f"{name}: {k} nulls differ"
        g, w = g[og][gv[og]], w[ot][wv[ot]]
        same = np.array_equal(_bits(g), _bits(w))
        bits = bits and same
        if g.dtype.kind == "f" and k not in keys:
            both_nan = np.isnan(g) & np.isnan(w)
            err = np.where(both_nan, 0.0, np.abs(g - w))
            bound = 1e-12 * np.abs(w)
            assert np.all(err <= bound), f"{name}: {k} differs from the twin"
            rel = max(rel, float(np.max(np.where(err > 0, err / np.abs(w),
                                                 0.0))) if len(g) else 0.0)
        else:
            assert same, f"{name}: {k} differs from the twin"
    return rel, bits


def trf_oracle(got, d, x):
    """sql_trf against numpy: the 20 largest off-exchange shares (volume
    printed on venue D over all volume, per symbol), each returned
    symbol's share exact, largest first."""
    import numpy as np
    sym_id = x["sym_id"]
    vol = d["volume"].astype(np.int64)
    trf = np.bincount(sym_id, np.where(d["ex"] == "D", vol, 0),
                      minlength=N_SYMBOLS)
    tot = np.bincount(sym_id, vol, minlength=N_SYMBOLS)
    with np.errstate(invalid="ignore", divide="ignore"):
        share = trf / tot
    share = np.where(tot > 0, share, -np.inf)
    sym, _, values = got["sym"]
    names = np.asarray(values, dtype=object)[sym]
    g = got["trf_share"][0]
    assert len(g) == TRF_TOP, f"sql_trf: {len(g)} rows"
    assert np.all(g[:-1] >= g[1:]), "sql_trf: not largest first"
    ids = np.array([int(np.flatnonzero(x["tickers"] == s)[0]) for s in names])
    assert np.array_equal(g, share[ids]), "sql_trf: a share differs"
    assert np.array_equal(np.sort(g), np.sort(share)[-TRF_TOP:]), \
        "sql_trf: not the 20 largest"
    return len(g)


def _bin_sums(labels, bins, vol, nb):
    """{label: volume sum} of the non-empty bins."""
    import numpy as np
    s = np.bincount(bins, vol, minlength=nb).astype(np.int64)
    n = np.bincount(bins, minlength=nb)
    return {labels[i]: int(s[i]) for i in range(nb) if n[i]}


def _cut_labels(breaks):
    edges = ["-inf"] + [str(int(b)) if float(b).is_integer() else
                        _fmt_float(b) for b in breaks] + ["inf"]
    return [f"({a}, {b}]" for a, b in zip(edges[:-1], edges[1:])]


def surface_oracle(name, got, h2o, d, x):
    """A phase-15 surface query's result (_taq_cols) against numpy; the
    row count and the largest error of each inexact column."""
    import numpy as np
    errs = {}
    price = d["price"].astype(np.float64)
    vol = d["volume"].astype(np.int64)
    if name == "E3_when":
        keys = h2o["id3"]
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
        s1 = np.add.reduceat(h2o["v1"][order].astype(np.int64), starts)
        mx = np.maximum.reduceat(h2o["v3"][order], starts)
        mn = np.minimum.reduceat(h2o["v3"][order], starts)
        want = np.where(s1 >= 300, mx, mn)
        gk, gx = got["id3"][0], got["x"][0]
        perm = np.argsort(gk, kind="stable")
        assert np.array_equal(gk[perm], sk[starts]), f"{name}: keys"
        assert np.array_equal(_bits(gx[perm]), _bits(want)), f"{name}: x"
        return len(starts), errs
    if name == "E3_distinct":
        n = len(h2o["v3"])
        u = len(np.unique(h2o["v3"]))
        first = np.zeros(n, bool)
        first[np.unique(h2o["id6"], return_index=True)[1]] = True
        def dup(a, b):
            code = h2o[a].astype(np.int64) * (int(h2o[b].max()) + 1) + h2o[b]
            _, inv, cnt = np.unique(code, return_inverse=True,
                                    return_counts=True)
            return cnt[inv] > 1
        dup36 = dup("id3", "id6")
        # v3 is tie-free and (id4, id5) has ~1000 rows a pair, so u and
        # dup are constant; first, dup36 and uniq36 mix both answers, so
        # a flag kernel that sets every flag alike fails here
        for flags in (first, dup36):
            assert 0 < flags.sum() < n, f"{name}: oracle flags constant"
        assert np.all(got["u"][0] == u), f"{name}: u"
        assert np.array_equal(got["first"][0], first), f"{name}: first"
        assert np.array_equal(got["dup"][0], dup("id4", "id5")), \
            f"{name}: dup"
        assert np.array_equal(got["dup36"][0], dup36), f"{name}: dup36"
        assert np.array_equal(got["uniq36"][0], ~dup36), f"{name}: uniq36"
        return n, errs
    if name in ("E3_qcut", "E3_cut"):
        if name == "E3_qcut":
            xs = np.sort(price)
            n = len(xs)
            qs = np.array([i / QCUT_BINS for i in range(1, QCUT_BINS)])
            posf = qs * (n - 1)
            lo = np.clip(np.floor(posf).astype(np.int64), 0, n - 1)
            hi = np.minimum(lo + 1, n - 1)
            lo = np.minimum(lo, hi)
            frac = posf - lo
            breaks = xs[lo] * (1 - frac) + xs[hi] * frac
        else:
            breaks = np.array(CUT_BREAKS)
        bins = np.searchsorted(np.sort(breaks), price, "left")
        want = _bin_sums(_cut_labels(breaks), bins, vol, len(breaks) + 1)
        b, _, values = got["b"]
        labels = np.asarray(values, dtype=object)[b]
        have = dict(zip(labels.tolist(), got["volume"][0].tolist()))
        assert have == want, f"{name}: {have} != {want}"
        return len(have), errs
    if name == "E3_hist":
        lo, hi = price.min(), price.max()
        edges = lo + (hi - lo) * np.arange(HIST_BINS + 1,
                                           dtype=np.float64) / HIST_BINS
        bins = np.searchsorted(edges[1:HIST_BINS], price, "left")
        want = np.bincount(bins, minlength=HIST_BINS)
        assert np.array_equal(got["n"][0].astype(np.int64), want), \
            f"{name}: counts"
        return HIST_BINS, errs
    if name in ("E3_pivot", "E3_unpivot"):
        sym, ex = x["sym_id"], x["ex_id"]
        tab = np.zeros((N_SYMBOLS, len(VENUE_CODES)), np.int64)
        np.add.at(tab, (sym, ex), vol)
        has = np.zeros_like(tab, bool)
        has[sym, ex] = True
        s, _, values = got["sym"]
        names = np.asarray(values, dtype=object)[s]
        pos = {t: i for i, t in enumerate(x["tickers"].tolist())}
        rows = np.array([pos[t] for t in names.tolist()])
        if name == "E3_pivot":
            first = np.unique(sym, return_index=True)[1]
            assert np.array_equal(rows, sym[np.sort(first)]), \
                f"{name}: the rows are not in order of first sight"
            for j, code in enumerate(VENUE_CODES):
                g, gv = got[code]
                gv = np.ones(len(g), bool) if gv is None else gv
                assert np.array_equal(gv, has[rows, j]), f"{name}: {code} nulls"
                assert np.array_equal(g[gv], tab[rows, j][gv]), \
                    f"{name}: {code}"
            return len(rows), errs
        e, _, evalues = got["ex"]
        exj = np.array([VENUE_CODES.index(v) for v in
                        np.asarray(evalues, dtype=object)[e].tolist()])
        npiv = len(rows) // len(VENUE_CODES)
        assert np.array_equal(exj, np.repeat(np.arange(len(VENUE_CODES)),
                                             npiv)), f"{name}: ex"
        g, gv = got["volume"]
        gv = np.ones(len(g), bool) if gv is None else gv
        assert np.array_equal(gv, has[rows, exj]), f"{name}: nulls"
        assert np.array_equal(g[gv], tab[rows, exj][gv]), f"{name}: volume"
        return len(rows), errs
    if name == "E2_json_encode":
        j, _, values = got["j"]
        want = np.char.add(np.char.add(np.char.add(
            np.char.add('{"ex": "', d["ex"]), '", "cond": "'), d["cond"]),
            '"}')
        assert np.array_equal(np.asarray(values, dtype=object)[j]
                              .astype(str), want), f"{name}: strings"
        return len(j), errs
    if name == "E2_json_decode":
        for k in ("ex", "cond"):
            codes, _, values = got[k]
            assert np.array_equal(np.asarray(values, dtype=object)[codes]
                                  .astype(str), d[k]), f"{name}: {k}"
        return len(d["ex"]), errs
    if name == "E2_list_eval":
        p = d["price"]
        want = np.stack([p * 2 + 1, (p * 2) * 2 + 1], 1)
        col = got["e"]
        assert np.all(col["lengths"] == 2), f"{name}: lengths"
        _same(name, "e", col["data"][:, :2].astype(np.float32), want)
        return len(p), errs
    if name == "E2_set_ops":
        v = d["volume"].astype(np.int64)
        a = (1 << (v % 7)) | (1 << (v % 5))
        b = (1 << (v % 3)) | (1 << (v % 11))
        want = {"set_intersection": a & b, "set_union": a | b,
                "set_difference": a & ~b, "set_symmetric_difference": a ^ b}
        for op, w in want.items():
            col = got[op]
            inside = np.arange(col["data"].shape[1])[None, :] < \
                col["lengths"][:, None]
            bits = np.where(inside, 1 << col["data"].astype(np.int64),
                            0).sum(1)
            assert np.array_equal(bits, w), f"{name}: {op}"
            pop = np.array([bin(int(u)).count("1") for u in
                            np.unique(w)])[np.searchsorted(np.unique(w), w)]
            assert np.array_equal(col["lengths"], pop), \
                f"{name}: {op} repeats an element"
        return len(v), errs
    raise AssertionError(f"no oracle for {name}")


def sql_oracle(name, out, h2o, d, x):
    """A SQL result against numpy: the H2O queries by the checkers of
    phases 6 (check_h2o), 9 (check_sorted_tier) and 11 (check_window),
    sql_trf by trf_oracle; the row count and the largest errors."""
    if name == "sql_trf":
        return trf_oracle(_taq_cols(out), d, x), {}
    if name in ("sql_q6", "sql_q9"):
        return check_sorted_tier(name[4:], out, h2o, {})
    if name == "sql_q8":
        got = {("v3" if k == "largest2_v3" else k): v
               for k, v in host_columns(out).items()}
        return check_window("q8", got, h2o, None, None)
    keys = dict(((n, k) for n, _, k in SQL_H2O))[name]
    return check_h2o(name, out, h2o, keys, None), {}


def run_surface_phase(args, torch, TK, TP, TE, TH, TM, sqlq, surfq, twins,
                      h2o, d, x, first_ms, runs):
    """Phase 15: every query's collect with its launches asserted, its
    result kept, a trace and the timed collects; then each SQL twin's
    trace; then the oracles, and each SQL query's twin collected and
    compared."""
    parse_ms = {n: ms for n, _, ms in sqlq}
    results = []
    for name, q in [(n, lf) for n, lf, _ in sqlq] + surfq:
        reset_launches(TK, TP, TE, TH, TM)
        out = q.collect()
        ql = read_launches(TK, TP, TE, TH, TM)
        for kernel in SURFACE_MUST.get(name, ()):
            assert ql[kernel] >= 1, f"{name} did not launch {kernel}"
        assert ql["fallbacks"] == 0, f"{name} took the fallback"
        runs.append(ql)
        tr = trace_collect(q, top_n=8)
        times = time_collects(q, args.reps)
        results.append((name, out, ql, times, tr))
    twin_busy = {}
    for name, lf in twins.items():
        twin_busy[name] = trace_collect(lf)["device_busy_ms"]
    for name, out, ql, times, tr in results:
        if name.startswith("sql_"):
            nout, errs = sql_oracle(name, out, h2o, d, x)
            if name in twins:
                twin = host_columns(twins[name].collect())
                rel, bits = check_twin(name, host_columns(out), twin)
                # the twin against itself, collected again: do its float
                # bits repeat?
                _, self_bits = check_twin(name, twin, host_columns(
                    twins[name].collect()))
                errs.update(twin_rel_diff=rel, twin_bits_equal=bits,
                            twin_repeats_bits=self_bits)
        else:
            nout, errs = surface_oracle(name, _taq_cols(out), h2o, d, x)
        med = statistics.median(times)
        print(json.dumps({
            "phase": "surface", "query": name, "out_rows": nout,
            "rows": H2O_ROWS if name.startswith(("sql_q", "E3_when",
                                                 "E3_distinct"))
            else len(d["ts"]),
            "launches": {"F": ql["merge_sort"], "B": ql["compact_words"],
                         "A": ql["seg_sum"], "C": ql["seg_minmax"],
                         "D": ql["gather"], "E": ql["bucket_exchange"]},
            "largest_error": errs, "parse_translate_ms": parse_ms.get(name),
            "twin": SQL_TWIN.get(name),
            "twin_busy_ms": twin_busy.get(name),
            "first_collect_ms": first_ms.get(name), "median_ms": med,
            "ms": times, "busy_ms": tr["device_busy_ms"],
            "device_ops": tr["device_ops"],
            "idle_share": 1 - tr["device_busy_ms"] / med
            if tr["device_ops"] else None,
            "top_op": tr["top"][0] if tr["top"] else None, "trace": tr}))
        del out


def make_surface(args, torch, pl, hdf, taq):
    """Phase 15's queries over the H2O frame and the TAQ frame."""
    tdf = taq["frame"]
    return {"sql": sql_queries(pl, hdf, tdf),
            "surface": surface_queries(pl, hdf, tdf),
            "twins": twin_frames(pl, hdf)}


def run_surface_only(args, torch, pl, TK, TP, TE, TH, TM):
    """--only-surface: phase 2 on phase 15's launches, then phase 15."""
    import numpy as np
    h2o = make_h2o_data(H2O_ROWS, args.seed)
    assert len(np.unique(h2o["v3"])) == H2O_ROWS, "v3 has ties"
    hdf = pl.DataFrame(h2o, device="cuda")
    taq = make_taq(args, torch, pl)
    sf = make_surface(args, torch, pl, hdf, taq)
    _, first_ms = check_recorded_kernels(
        args, torch, TK, TE, TM, TP,
        [(n, lf) for n, lf, _ in sf["sql"]] + sf["surface"])
    run_surface_phase(args, torch, TK, TP, TE, TH, TM, sf["sql"],
                      sf["surface"], sf["twins"], h2o, taq["data"],
                      taq["draws"], first_ms, [])


def first_fused_collect(torch, lf, TK, TP, TE, TH, TM):
    """The first collect of a query whose plan holds a fused chain: the
    chain runs eagerly and is captured. Returns (the result, the kernels'
    launches, {"first_collect_ms": host ms, capture included, fenced;
    "first_counts": the fused route's counts})."""
    from polaroid_tpu_torch.exec import compiled as CM
    reset_launches(TK, TP, TE, TH, TM)
    CM.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = lf.collect()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, read_launches(TK, TP, TE, TH, TM), {
        "first_collect_ms": ms, "first_counts": fused_counts()}


def traced_collect(lf, TK, TP, TE, TH, TM, tries: int = 2, **opts):
    """One collect of `lf` (with `opts`) under the profiler, `tries`
    times, each from counts set to 0; the profiler at times drops device
    events, so the trace with the most is kept. Returns that collect's
    (result, the wrappers' launches, the fused route's counts, trace);
    the trace's "launches" are the wrappers' kernels that ran on the
    card, in graphs too."""
    from polaroid_tpu_torch.exec import compiled as CM
    best = None
    for _ in range(tries):
        box = {}

        def one():
            reset_launches(TK, TP, TE, TH, TM)
            CM.reset_counts()
            box["out"] = lf.collect(**opts)
            box["host"] = read_launches(TK, TP, TE, TH, TM)
            box["fused"] = fused_counts()
        tr = trace_call(one, top_n=3)
        if best is None or tr["device_ops"] > best[3]["device_ops"]:
            best = (box["out"], box["host"], box["fused"], tr)
        del box
    return best


def kernel_counts(launches: dict) -> dict:
    """read_launches' kernels, without the count of fallbacks."""
    return {k: v for k, v in launches.items() if k != "fallbacks"}


def replayed_collects(args, torch, lf, launches, TK, TP, TE, TH, TM, check,
                      may_stay_eager=False):
    """The collects after the first: one more, traced and checked by
    `check`, with exactly one replay and no capture, whose kernels on
    the card (the trace's) are the first collect's launches; then
    --reps timed collects, one replay each. A chain that read a value
    back stays eager (allowed with `may_stay_eager`), and the op that
    read back is returned. Returns ({"replay_counts", "timed_counts",
    "replay_launches": the traced collect's kernels on the card,
    "host_launches": those its wrappers launched outside a graph,
    "nofuse"}, the timed collects' host ms)."""
    from polaroid_tpu_torch.exec import compiled as CM
    out, got, counts, tr = traced_collect(lf, TK, TP, TE, TH, TM)
    nofuse = dict(CM.NOFUSE)
    measured = tr["launches"]
    assert measured == kernel_counts(launches), f"a replayed collect ran " \
        f"{measured} on the card, the first launched {launches}"
    if counts["eager"]:
        assert may_stay_eager, f"the chain stayed eager: {nofuse}"
        assert got == launches, f"an eager collect launched {got}, the " \
            f"first {launches}"
        print(json.dumps({"phase": "nofuse", "ops": nofuse}))
    else:
        assert counts["replays"] == 1 and counts["captures"] == 0, \
            f"a collect after the first did not replay once: {counts}"
    check(out)
    del out
    CM.reset_counts()
    times = time_collects(lf, args.reps)
    reps = fused_counts()
    if not counts["eager"]:
        assert reps["replays"] == args.reps and reps["captures"] == 0, \
            f"{args.reps} collects: {reps}"
    return {"replay_counts": counts, "timed_counts": reps,
            "replay_launches": measured, "host_launches": got,
            "nofuse": nofuse if counts["eager"] else {}}, times


# --- phase 16: fused chains and the streaming engine ----------------------

N_SESSIONS = 10
STREAM_TOP_K = 100
STREAM_HEAD = 1_000_000
SECTORS = 11                 # GICS sectors of the symbol table
ROLL_W = 20                  # ST5's rolling window (rows)


def fused_counts():
    from polaroid_tpu_torch.exec import compiled as CM
    return {k: CM.COUNTS[k] for k in ("captures", "replays", "nofuse",
                                      "eager", "static_copy_bytes",
                                      "pool_bytes")}


def collect_eager(pl, lf):
    """The collect of `lf` with every fusable chain applied node by node:
    the executor's eager function, called directly on the optimized plan
    that `lf.collect()` runs (kept on the frame)."""
    from polaroid_tpu_torch.exec.executor import execute_eager
    from polaroid_tpu_torch.ops.compact import compact
    return pl.DataFrame._from_table(compact(execute_eager(lf._optimized(
        pl.CONFIG.engine_affinity))))


def time_calls(fn, reps: int):
    """Host ms of `reps` calls of fn(), each fenced."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def same_frames(name, got, want, f64_rtol, f32_ulps=1, sort_by=None):
    """`got` against `want`: the same columns, dtypes and row count; keys,
    integers, strings, booleans, extremes and nulls bit for bit; Float64
    within `f64_rtol` (a dict per column, or one number) and Float32
    within `f32_ulps` ulps (0: bit for bit). With `sort_by`, both are
    sorted by those columns first."""
    import numpy as np
    if sort_by:
        got, want = got.sort(sort_by), want.sort(sort_by)
    assert got.columns == want.columns, f"{name}: {got.columns} vs " \
        f"{want.columns}"
    assert got.height == want.height, f"{name}: {got.height} rows vs " \
        f"{want.height}"
    g, w = host_columns(got), host_columns(want)
    worst = {}
    for k in want.columns:
        (a, av), (b, bv) = g[k], w[k]
        assert a.dtype == b.dtype, f"{name}: {k} {a.dtype} vs {b.dtype}"
        va = np.ones(len(a), bool) if av is None else av
        vb = np.ones(len(b), bool) if bv is None else bv
        assert np.array_equal(va, vb), f"{name}: the nulls of {k} differ"
        a, b = a[vb], b[vb]
        if a.ndim > 1:
            a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
        u = f"u{a.itemsize}"
        if np.array_equal(a.view(u), b.view(u)):
            worst[k] = 0.0
            continue
        assert a.dtype.kind == "f", f"{name}: {k} differs"
        tol = f64_rtol.get(k, 1e-12) if isinstance(f64_rtol, dict) \
            else f64_rtol
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
        if a.dtype == np.float32:
            lim = f32_ulps * np.spacing(np.abs(b)).astype(np.float64)
        elif callable(tol):
            lim = tol(b)
        else:
            lim = tol * np.abs(b)
        ok = (d <= lim) | (np.isnan(a) & np.isnan(b))
        assert ok.all(), f"{name}: {k} differs by {float(d[~ok].max())} " \
            f"beyond its bound"
        worst[k] = float(d.max())
    return worst


def fused_vs_eager_queries(pl, df, qdf, tdf, jframes):
    """(name, lazy frame, Float64 bound, sort keys) of phase 16's G: the
    queries whose idle share PERF.md traces to host dispatch."""
    c = pl.col
    qf = qdf.lazy().filter(c("volume") > 1000)
    return [
        ("q1", q1_frame(pl, df), 1e-10, None),
        ("filter", df.lazy().filter(c("volume") > 1000).with_columns(
            (c("price") * c("volume")).alias("notional")), 0.0, None),
        ("ohlc", ohlc_frame(pl, df), 1e-12, None),
        ("J1", jframes["orders"].lazy().join(
            jframes["users"].lazy(), on="user_id").group_by("country").agg(
                pl.len().alias("n"), c("amount").sum().alias("s")), 1e-12,
         ["country"]),
        ("W4_rolling_mean", qf.select(c("price").rolling_mean(W_WINDOW)
                                      .alias("x")), 1e-12, None),
        ("W4_cum_sum", qf.select(c("price").cast(pl.Float64).cum_sum()
                                 .alias("x")), 1e-12, None),
        ("T4_sum_by", tdf.lazy().select(c("volume").rolling_sum_by(
            "ts", "1m").alias("x")), 1e-12, None),
    ]


def run_fused_vs_eager(args, torch, pl, queries):
    """G: each query through the fused route (a collect) and through the
    same chains applied node by node (the executor's eager function),
    the median of --reps of each, busy ms, device ops and idle share
    from a trace of each; their results held to each other. A chain that
    stays eager names the op that read back."""
    import statistics as st
    from polaroid_tpu_torch.exec import compiled as CM
    from polaroid_tpu_torch.exec.compiled import collect_fusable_chain, \
        plan_chain_fingerprint
    rows = []
    for name, lf, rtol, sort_by in queries:
        plan = lf._optimized(pl.CONFIG.engine_affinity)
        chains = []
        top = None
        stack = [plan]
        while stack:
            p = stack.pop()
            if p.kind in ("filter", "select", "with_columns", "group_by",
                          "sort"):
                chain, inp = collect_fusable_chain(p)
                if chain and (len(chain) >= 2 or
                              chain[-1].kind in ("group_by", "sort")):
                    chains.append(plan_chain_fingerprint(chain))
                    top = top or (chain, inp)
                    stack.append(inp)
                    continue
            stack.extend(p.inputs)
        CM.reset_counts()
        fused = lf.collect()
        first = fused_counts()
        eager = collect_eager(pl, lf)
        worst = same_frames(f"G {name}", fused, eager, rtol, 1, sort_by)
        CM.reset_counts()
        tf = time_collects(lf, args.reps)
        reps = fused_counts()
        again = lf.collect()
        same_frames(f"G {name} (replayed)", again, eager, rtol, 1, sort_by)
        del again, fused
        te = time_calls(lambda: collect_eager(pl, lf), args.reps)
        # the first trace after the timed collects at times lacks device
        # events; each route takes two and keeps the fuller
        trf = max((trace_collect(lf, top_n=3) for _ in range(2)),
                  key=lambda tr: tr["device_ops"])
        tre = max((trace_call(lambda: collect_eager(pl, lf), top_n=3)
                   for _ in range(2)), key=lambda tr: tr["device_ops"])
        nofuse = {fp: CM.NOFUSE[fp] for fp in chains if fp in CM.NOFUSE}
        # the first chain alone, on its input table: run_fused (a replay)
        # against apply_chain (node by node), host ms fenced
        chain_ms = None
        if top is not None:
            from polaroid_tpu_torch.exec.compiled import apply_chain, \
                run_fused
            from polaroid_tpu_torch.exec.executor import execute
            t_in = execute(top[1])
            run_fused(top[0], t_in)
            chain_ms = {
                "fused": st.median(time_calls(
                    lambda: run_fused(top[0], t_in), args.reps)),
                "eager": st.median(time_calls(
                    lambda: apply_chain(top[0], t_in), args.reps))}
            del t_in
        if chains and not nofuse:
            # one replay per chain per collect; a chain whose input each
            # collect makes anew (a join's output) is captured once more,
            # over buffers of its own, the first time other tensors come
            assert reps["replays"] == args.reps * len(chains) and \
                reps["captures"] <= len(chains), \
                f"G {name}: {reps} over {args.reps} collects"
        mf, me = st.median(tf), st.median(te)
        row = {"phase": "stream_G", "query": name,
               "fused_chains": len(chains),
               "nofuse": nofuse, "first_counts": first,
               "rep_counts": reps, "chain_ms": chain_ms,
               "largest_error": worst,
               "fused": {"median_ms": mf, "ms": tf,
                         "busy_ms": trf["device_busy_ms"],
                         "device_ops": trf["device_ops"],
                         "idle_share": 1 - trf["device_busy_ms"] / mf
                         if trf["device_ops"] else None, "top": trf["top"]},
               "eager": {"median_ms": me, "ms": te,
                         "busy_ms": tre["device_busy_ms"],
                         "device_ops": tre["device_ops"],
                         "idle_share": 1 - tre["device_busy_ms"] / me
                         if tre["device_ops"] else None, "top": tre["top"]}}
        print(json.dumps(row))
        rows.append(row)
    return rows


def day_frames(pl, torch, tdata):
    """The trades split by session into N_SESSIONS frames on the card,
    with the session's index as `day` (Int32); returns (the frames, the
    row offsets of the sessions)."""
    import numpy as np
    opens = np.array(SESSION_OPENS, dtype="datetime64[us]").astype(np.int64)
    day = np.searchsorted(opens, tdata["ts"], side="right") - 1
    cuts = np.searchsorted(day, np.arange(N_SESSIONS + 1))
    frames = []
    for i in range(N_SESSIONS):
        lo, hi = cuts[i], cuts[i + 1]
        cols = {k: v[lo:hi] for k, v in tdata.items() if k != "ts"}
        cols["ts"] = tdata["ts"][lo:hi].astype("datetime64[us]")
        cols["day"] = np.full(hi - lo, i, dtype=np.int32)
        frames.append(pl.DataFrame(cols, device="cuda"))
    return frames, cuts


def symbol_table(pl, seed: int):
    """1000 symbols with a sector (String, one of SECTORS) and a lot size
    (Int32, 1, 10 or 100), drawn from seed + 13."""
    import numpy as np
    rng = np.random.default_rng(seed + 13)
    sector = np.array([f"S{i:02d}" for i in range(SECTORS)])[
        rng.integers(0, SECTORS, N_SYMBOLS)]
    lot = np.array([1, 10, 100], dtype=np.int32)[rng.integers(0, 3,
                                                               N_SYMBOLS)]
    data = {"symbol": np.arange(N_SYMBOLS, dtype=np.uint32),
            "sector": sector, "lot": lot}
    return pl.DataFrame(data, device="cuda"), data


def _std_bound(n, s2, ddof=1):
    """|var - var'| for the decomposed variance (S2 - S^2/n)/(n - ddof)
    from f64 sums: each of S and S2 summed with atomics over the rows of
    one batch and once over the batches' partials (error at most
    (n + N_SESSIONS) 2^-53 S2, S^2/n <= S2 for positive values), the
    subtraction, and the two-pass variance it is held to (n 2^-53 S2)."""
    import numpy as np
    eps = 2.0 ** -53
    return (4 * (n + N_SESSIONS) + 8) * eps * s2 / np.maximum(n - ddof, 1)


def stream_queries(pl, u, sym):
    """(name, lazy frame over the union of day frames) of phase 16."""
    c = pl.col
    px = c("price").cast(pl.Float64)
    return {
        "ST1_vwap": u.group_by("symbol").agg(
            c("volume").sum().alias("vol"), pl.len().alias("n"),
            ((px * c("volume")).sum() / c("volume").sum()).alias("vwap"),
            c("price").min().alias("lo"), c("price").max().alias("hi"),
            px.mean().alias("mean"), px.std().alias("sd")),
        "ST2_head": u.filter(c("volume") > 1000).with_columns(
            (c("price") * c("volume")).alias("notional")).select(
                "ts", "symbol", "notional").head(STREAM_HEAD),
        "ST3_inner": u.join(sym.lazy(), on="symbol").group_by("sector").agg(
            c("volume").sum().alias("vol"),
            (c("lot") * c("volume")).sum().alias("shares"),
            pl.len().alias("n")),
        "ST3_left": u.join(sym.lazy(), on="symbol", how="left").group_by(
            "sector").agg(c("volume").sum().alias("vol"),
                          pl.len().alias("n")),
        "ST4_top_k": u.top_k(STREAM_TOP_K, by=c("price") * c("volume")),
        "ST4_unique": u.select("symbol", "day").unique(maintain_order=True),
        "ST4_row_index": u.with_row_index("i").select("i", "ts", "symbol"),
        "ST5_windows": u.with_columns(
            c("volume").cast(pl.Int64).cum_sum().alias("cv"),
            c("price").rolling_mean(ROLL_W).alias("rm"),
            c("price").shift(1).alias("prev")),
        "ST6_sort": u.sort(["price", "ts"], descending=[True, False]),
        "ST6_grace": u.with_row_index("rid").join(sym.lazy(), on="symbol",
                                                  how="left"),
    }


def stream_oracle(name, got, d, symd, cuts):
    """`got` (a collected frame) against numpy over the trades `d`."""
    import numpy as np
    g = {k: v for k, (v, _) in host_columns(got).items()}
    sym = d["symbol"].astype(np.int64)
    vol = d["volume"].astype(np.int64)
    price = d["price"]
    p64 = price.astype(np.float64)
    n = len(sym)
    if name == "ST1_vwap":
        cnt = np.bincount(sym, minlength=N_SYMBOLS)
        keys = np.nonzero(cnt)[0]
        assert np.array_equal(g["symbol"].astype(np.int64), keys)
        assert np.array_equal(g["n"], cnt[keys])
        assert np.array_equal(g["vol"], np.bincount(
            sym, weights=vol, minlength=N_SYMBOLS)[keys].astype(np.int64))
        s1 = np.bincount(sym, weights=p64, minlength=N_SYMBOLS)[keys]
        s2 = np.bincount(sym, weights=p64 * p64, minlength=N_SYMBOLS)[keys]
        pv = np.bincount(sym, weights=p64 * vol, minlength=N_SYMBOLS)[keys]
        vv = np.bincount(sym, weights=vol, minlength=N_SYMBOLS)[keys]
        lo = np.full(N_SYMBOLS, np.inf, np.float32)
        hi = np.full(N_SYMBOLS, -np.inf, np.float32)
        np.minimum.at(lo, sym, price)
        np.maximum.at(hi, sym, price)
        assert np.array_equal(g["lo"], lo[keys]) and \
            np.array_equal(g["hi"], hi[keys])
        c = cnt[keys]
        mean = s1 / c
        assert np.all(np.abs(g["mean"] - mean) <= 1e-12 * mean)
        assert np.all(np.abs(g["vwap"] - pv / vv) <= 1e-12 * pv / vv)
        order = np.argsort(sym, kind="stable")
        starts = np.searchsorted(sym[order], keys)
        dev = p64[order] - np.repeat(mean, c)
        var = np.add.reduceat(dev * dev, starts) / (c - 1)
        sd_bound = _std_bound(c, s2) / (2 * np.sqrt(var)) + \
            2.0 ** -52 * np.sqrt(var)
        assert np.all(np.abs(g["sd"] - np.sqrt(var)) <= sd_bound), \
            "ST1 std beyond its bound"
        return len(keys)
    if name == "ST2_head":
        live = np.nonzero(vol > 1000)[0][:STREAM_HEAD]
        assert np.array_equal(g["symbol"], d["symbol"][live])
        assert np.array_equal(g["ts"], d["ts"][live])
        assert np.array_equal(g["notional"], p64[live] * vol[live])
        return len(live)
    if name in ("ST3_inner", "ST3_left"):
        sec = symd["sector"][sym]
        names, inv = np.unique(sec, return_inverse=True)
        got = got.sort("sector")
        g = {k: v for k, (v, _) in host_columns(got).items()}
        sectors = got.get_column("sector").to_list()
        assert sectors == list(names), f"{name}: sectors {sectors}"
        assert np.array_equal(g["vol"], np.bincount(
            inv, weights=vol).astype(np.int64))
        assert np.array_equal(g["n"], np.bincount(inv))
        if "shares" in g:
            lots = symd["lot"][sym].astype(np.int64)
            assert np.array_equal(g["shares"], np.bincount(
                inv, weights=lots * vol).astype(np.int64))
        return len(names)
    if name == "ST4_top_k":
        key = p64 * vol
        want = np.sort(key)[::-1][:STREAM_TOP_K]
        got_key = g["price"].astype(np.float64) * g["volume"]
        assert np.array_equal(got_key, want), "ST4 top-k keys differ"
        return STREAM_TOP_K
    if name == "ST4_unique":
        day = np.repeat(np.arange(N_SESSIONS), np.diff(cuts))
        pairs = sym * N_SESSIONS + day
        _, first = np.unique(pairs, return_index=True)
        first = np.sort(first)
        assert np.array_equal(g["symbol"], d["symbol"][first])
        assert np.array_equal(g["day"], day[first].astype(np.int32))
        return len(first)
    if name == "ST4_row_index":
        assert np.array_equal(g["i"], np.arange(n, dtype=g["i"].dtype))
        assert np.array_equal(g["ts"], d["ts"])
        return n
    if name == "ST5_windows":
        assert np.array_equal(g["cv"], np.cumsum(vol))
        prev, pv = host_columns(got)["prev"]
        assert pv is not None and not pv[0] and pv[1:].all() and \
            np.array_equal(prev[1:], price[:-1]), "ST5 shift differs"
        cs = np.concatenate([[0.0], np.cumsum(p64)])
        rm = (cs[ROLL_W:] - cs[:-ROLL_W]) / ROLL_W
        got_rm = g["rm"][ROLL_W - 1:].astype(np.float64)
        bound = 2 * np.spacing(np.abs(rm).astype(g["rm"].dtype)) \
            .astype(np.float64) + ROLL_W * 2.0 ** -52 * np.abs(rm)
        assert np.all(np.abs(got_rm - rm) <= bound), "ST5 rolling mean"
        return n
    if name == "ST6_sort":
        order = np.lexsort((d["ts"], -p64))
        assert np.array_equal(g["price"], price[order])
        assert np.array_equal(g["ts"], d["ts"][order])
        return n
    if name == "ST6_grace":
        rid = g["rid"].astype(np.int64)
        order = np.argsort(rid)
        assert np.array_equal(rid[order], np.arange(n))
        assert np.array_equal(g["lot"][order], symd["lot"][sym])
        return n
    raise KeyError(name)


def run_stream_phase(args, torch, pl, TK, TP, TE, TH, TM, tdata, df, qdf,
                     jframes):
    """Phase 16: G, the fused route against the eager chain, then the
    streaming queries ST1-ST7 over the trades as a union of day frames.
    Returns (the wrappers' launches of each query's first collect, the
    kernels on the card in ST1's second collect, from its trace)."""
    import numpy as np
    from polaroid_tpu_torch.exec import compiled as CM
    from polaroid_tpu_torch.exec import streaming as ST
    t_phase = time.perf_counter()
    tdf = trades_frame(pl, tdata)
    run_fused_vs_eager(args, torch, pl, fused_vs_eager_queries(
        pl, df, qdf, tdf, jframes))
    runs, on_card = [], []
    del tdf
    print(json.dumps({"phase": "stream_G_seconds",
                      "seconds": time.perf_counter() - t_phase}))
    t0 = time.perf_counter()
    days, cuts = day_frames(pl, torch, tdata)
    print(json.dumps({"phase": "stream_data", "frames": len(days),
                      "rows": [int(x) for x in np.diff(cuts)],
                      "seconds": time.perf_counter() - t0}))
    sym, symd = symbol_table(pl, args.seed)
    u = pl.concat([d.lazy() for d in days])
    queries = stream_queries(pl, u, sym)
    # ST2 stops after two sessions; the joins also stream the symbol
    # table, one batch
    must_batches = {"ST2_head": 2, "ST3_inner": N_SESSIONS + 1,
                    "ST3_left": N_SESSIONS + 1, "ST6_grace": N_SESSIONS + 1}
    for name, lf in queries.items():
        opts = {}
        if name == "ST6_sort":
            # the sort keeps 4 batch_rows (half the trades) in memory,
            # then spills, and sorts buckets of about batch_rows
            opts = {"batch_rows": max(args.rows // 8, 1)}
        elif name == "ST6_grace":
            opts = {"join_build_budget_rows": N_SYMBOLS // 2}
        with pl.Config(**opts):
            ST.reset_counts()
            CM.reset_counts()
            reset_launches(TK, TP, TE, TH, TM)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if name == "ST1_vwap":
                # under the profiler, which sees the kernels the graphs'
                # replays run as well as those the wrappers launch
                box = {}
                first_trace = trace_call(lambda: box.setdefault(
                    "out", lf.collect(engine="streaming")), attempts=1)
                out = box.pop("out")
            else:
                out = lf.collect(engine="streaming")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            counts, joins = dict(ST.COUNTS), [dict(j) for j in ST.JOINS]
            fused = fused_counts()
            launches = read_launches(TK, TP, TE, TH, TM)
            if name == "ST1_vwap":
                _, again_host, again_fused, again_trace = traced_collect(
                    lf, TK, TP, TE, TH, TM, engine="streaming")
            times = time_calls(lambda: lf.collect(engine="streaming"),
                               1 if name.startswith("ST6") else
                               max(1, args.reps - 2))
        want_batches = must_batches.get(name, N_SESSIONS)
        assert counts["batches"] == want_batches, \
            f"{name}: {counts['batches']} batches, not {want_batches}"
        measured = {}
        if name == "ST1_vwap":
            measured = first_trace["launches"]
            # A runs on the card for every batch's partials, and its
            # launches are those of the first collect in the next one,
            # where every chain replays
            assert measured["seg_sum"] >= N_SESSIONS, \
                f"ST1 ran seg_sum {measured['seg_sum']} times on the card"
            assert again_trace["launches"] == measured, \
                f"ST1 ran {again_trace['launches']} on the card, its " \
                f"first collect {measured}"
            assert all(measured[k] >= v for k, v in
                       kernel_counts(launches).items()), \
                f"ST1's wrappers launched {launches}, the card ran {measured}"
            assert counts["partials"] == N_SESSIONS and \
                counts["merges"] == 1
            # the partial chain replays from the second batch on (the
            # merge is one chain more), and every chain in the next
            # collect; the merge's input is made anew by each collect,
            # so its first hit captures once more, over buffers of its
            # own
            assert fused["replays"] >= N_SESSIONS - 1, \
                f"ST1 replayed {fused['replays']} times"
            assert again_fused["replays"] == N_SESSIONS + 1 and \
                again_fused["captures"] <= 1, \
                f"ST1's second collect: {again_fused}"
            measured = {"first": measured, "next": again_trace["launches"],
                        "next_host": again_host}
        if name.startswith("ST3"):
            assert joins and joins[0]["build"] == "right" and \
                not joins[0]["swapped"] and not joins[0]["grace"], \
                f"{name}: the build side was {joins}"
        if name == "ST6_sort":
            assert counts["spills"] > 0, "ST6 sort did not spill"
        if name == "ST6_grace":
            assert joins and joins[0]["grace"] and counts["spills"] > 0, \
                f"ST6 grace join did not spill: {joins}"
        mem = lf.collect()
        mem_times = time_collects(lf, max(1, args.reps - 2))
        bounds = {}
        if name == "ST1_vwap":
            mv = host_columns(mem)
            c = mv["n"][0].astype(np.float64)
            s2 = mv["mean"][0] ** 2 * c + mv["sd"][0] ** 2 * (c - 1)
            var = mv["sd"][0] ** 2
            vb = _std_bound(c, s2)
            sd = mv["sd"][0]
            lim = vb / np.maximum(2 * sd, 1e-300) + 2.0 ** -52 * sd
            bounds = {"sd": lambda b, lim=lim: lim, "vwap": 1e-12,
                      "mean": 1e-12}
            del var
        sort_by = ["rid"] if name == "ST6_grace" else \
            ["sector"] if name.startswith("ST3") else None
        worst = same_frames(name, out, mem, bounds or 1e-12, 1, sort_by)
        got_sorted = out.sort("rid") if name == "ST6_grace" else out
        nout = stream_oracle(name, got_sorted, tdata, symd, cuts)
        del mem, got_sorted
        runs.append(launches)
        if measured:
            on_card.append(measured["next"])
        print(json.dumps({
            "phase": "stream", "query": name, "out_rows": nout,
            "batches": counts["batches"], "partials": counts["partials"],
            "merges": counts["merges"], "spills": counts["spills"],
            "spilled_bytes": counts["spilled_bytes"], "joins": joins,
            "fused": fused, "launches": launches,
            "launches_on_card": measured,
            "largest_error_vs_in_memory": worst, "first_ms": ms,
            "median_ms": statistics.median(times), "ms": times,
            "in_memory_median_ms": statistics.median(mem_times)}))
        del out
    # ST7: the surface (batches of 2^20 rows at 2^23)
    t1 = time.perf_counter()
    bs = max(args.rows // 8, 1)
    whole = u.collect()
    parts = list(u.collect_batches(batch_size=bs))
    assert len(parts) == -(-whole.height // bs)
    same_frames("ST7 collect_batches", pl.concat(parts), whole, 0.0)
    calls = []
    u.sink_batches(lambda b: calls.append(b.height) or len(calls) == 3,
                   batch_size=bs)
    assert calls == [bs] * 3, f"sink_batches called {calls}"
    q = queries["ST1_vwap"]
    fut = q.collect_async()
    same_frames("ST7 collect_async", fut.result(timeout=300), q.collect(),
                {"mean": 1e-12, "vwap": 1e-12, "sd": 1e-12})
    res, prof = q1_frame(pl, df).profile()
    nodes = prof.get_column("node").to_list()
    # the executor ran two nodes: the frame, and the fused chain under
    # the group-by
    assert len(nodes) == 2 and nodes[0].startswith("DF_SCAN") and \
        nodes[1].startswith("GROUP_BY"), nodes
    print(json.dumps({"phase": "stream", "query": "ST7_surface",
                      "batches": len(parts), "sink_calls": calls,
                      "profile": dict(zip(nodes, prof.get_column("ms")
                                          .to_list())),
                      "seconds": time.perf_counter() - t1}))
    del whole, parts, days, u
    print(json.dumps({"phase": "stream_seconds",
                      "seconds": time.perf_counter() - t_phase,
                      "cache": CM.cache_info(), "nofuse": dict(CM.NOFUSE)}))
    return runs, on_card


def run_stream_only(args, torch, pl, TK, TP, TE, TH, TM):
    """--only-stream: phase 2's checks on phase 16's launches, then phase
    16 alone; no result line."""
    t0 = time.perf_counter()
    data = make_q1_data(args.rows, args.seed)
    df = pl.DataFrame(data, device="cuda")
    qdf, _ = with_null_price(pl, df, data, args.seed)
    tdata = make_trades_data(args.rows, args.seed)
    jtables, jdicts = make_join_data(H2O_ROWS, args.seed)
    jframes = {k: v for k, v in join_frames(pl, jtables, jdicts,
                                            "cuda").items()
               if k in ("orders", "users")}
    del jtables
    print(json.dumps({"phase": "stream_only_data",
                      "seconds": time.perf_counter() - t0}))
    tdf = trades_frame(pl, tdata)
    check_recorded_kernels(args, torch, TK, TE, TM, TP, [
        (n, lf) for n, lf, *_ in fused_vs_eager_queries(
            pl, df, qdf, tdf, jframes)])
    del tdf
    run_stream_phase(args, torch, pl, TK, TP, TE, TH, TM, tdata, df, qdf,
                     jframes)


# --- phase 17: the distributed engine ---------------------------------------

DIST_SLOTS = 4              # the mesh's shard slots (2 x 2 for the 2-D mesh)
D0_ROWS = 1 << 22           # one shard's rows of the H2O frame
D0_AGGS = ["sum", "count", "min", "max"]


class DistQuery:
    """A lazy frame collected by the distributed engine on `mesh`, where
    the script calls .collect()."""

    def __init__(self, lf, mesh):
        self.lf, self.mesh = lf, mesh

    def collect(self):
        return self.lf.collect(engine="distributed", mesh=self.mesh)


class LocalGroupBy:
    """One slot's adaptive group-by over u32 keys (parallel/shuffle.py
    local_groupby), as a .collect()-able call."""

    def __init__(self, key, vals, valid):
        self.key, self.vals, self.valid = key, vals, valid

    def collect(self):
        from polaroid_tpu_torch.dtypes import UInt32
        from polaroid_tpu_torch.parallel import shuffle as SH
        return SH.local_groupby(self.key, self.vals, self.valid, D0_AGGS,
                                UInt32)


def dist_meshes(torch):
    """The 4-slot mesh (slot s on card s % cards) and its 2 x 2 twin."""
    from polaroid_tpu_torch.parallel.mesh import make_mesh, make_mesh2
    cards = torch.cuda.device_count()
    devs = [torch.device("cuda", s % cards) for s in range(DIST_SLOTS)]
    return (make_mesh(devices=devs),
            make_mesh2(2, DIST_SLOTS // 2, devices=devs))


def d0_calls(torch, h2o):
    """(name, adaptive route, host keys, host values, call) of D0: one
    shard's 2^22 rows of the H2O frame grouped by a u32 key over each
    route of the adaptive group-by."""
    import numpy as np
    n = D0_ROWS
    v = h2o["v3"][:n].astype(np.float32)
    tv = torch.from_numpy(v).cuda()
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    out = []
    for name, route, key in (
            ("D0_id1", "dense_1024", h2o["id1"][:n]),
            ("D0_id3_mod_5000", "dense_8192", h2o["id3"][:n] % 5000),
            ("D0_id3", "hash", h2o["id3"][:n]),
            ("D0_kf", "carry", h2o["kf"][:n])):
        key = key.astype(np.int64)
        out.append((name, route, key, v, LocalGroupBy(
            torch.from_numpy(key).cuda(), [tv] * 4, valid)))
    return out


D0_KERNELS = {"dense_1024": ("seg_sum", "seg_minmax"),
              "dense_8192": ("seg_sum", "seg_minmax"),
              "hash": ("bucket_exchange",),
              "carry": ("merge_sort", "compact_words")}


def check_local_groupby(name, out, key, v):
    """A D0 result against numpy: the group keys and counts exact, min
    and max bit for bit, the Float32 sums within one ulp of numpy's f64
    sums rounded to Float32."""
    import numpy as np
    gk, outs, gv = out
    gv = gv.cpu().numpy()
    keys = gk.cpu().numpy()[gv]
    order = np.argsort(keys, kind="stable")
    uk, inv = np.unique(key, return_inverse=True)
    assert np.array_equal(keys[order], uk), f"{name}: group keys"
    got = [o.cpu().numpy()[gv][order] for o in outs]
    s = np.bincount(inv, weights=v.astype(np.float64)).astype(np.float32)
    ulps = np.abs(got[0].astype(np.float64) - s) / np.spacing(np.abs(s))
    assert ulps.max() <= 1, f"{name}: sums {ulps.max()} ulp off"
    assert np.array_equal(got[1], np.bincount(inv)), f"{name}: counts"
    lo = np.full(len(uk), np.inf, np.float32)
    hi = np.full(len(uk), -np.inf, np.float32)
    np.minimum.at(lo, inv, v)
    np.maximum.at(hi, inv, v)
    assert np.array_equal(got[2], lo), f"{name}: min"
    assert np.array_equal(got[3], hi), f"{name}: max"
    return len(uk)


def dist_queries(pl, hdf, jframes):
    """(name, lazy frame, ROUTES it must take, kernels it must launch,
    oracle) of phase 17's D1-D4: the H2O group-bys, the sorts S1 and S2,
    U1 and the joins q2, q3, q5 and J1, as phases 6, 8, 9 and 10 write
    them."""
    h2o = {n: (keys, lf, order) for n, keys, lf, order in
           h2o_queries(pl, hdf)}
    carry = ("merge_sort", "compact_words")
    out = []
    for name in ("q2", "q3", "q5", "q7", "q10", "q6"):
        keys, lf, order = h2o[name]
        out.append((f"D1_{name}", lf,
                    {"exact" if name == "q6" else "sharded": 1}, carry,
                    ("h2o", name, keys, order)))
    out += [
        ("D2_S1", hdf.lazy().sort(["id1", "id2", "id3"],
                                  maintain_order=True),
         {"sample_sort": 1}, ("merge_sort",), ("sort", "S1")),
        ("D2_S2", hdf.lazy().sort("v3", descending=True,
                                  maintain_order=True),
         {"sample_sort": 1}, ("merge_sort",), ("sort", "S2")),
        ("D3_U1", hdf.lazy().unique(subset=["id1", "id2", "id4"],
                                    keep="first", maintain_order=True),
         {"distinct": 1}, ("merge_sort",), ("sorted_tier", "U1")),
    ]
    joins = {n: lf for n, lf, *_ in join_queries(pl, jframes)}
    for name in ("q2", "q3", "q5", "J1"):
        route = {"sharded_join": 1, "sharded": 1} if name == "J1" \
            else {"sharded_join": 1}
        out.append((f"D4_{name}", joins[name], route, carry,
                    ("join", name)))
    return out


def dist_reset(TK, TP, TE, TH, TM, D) -> None:
    reset_launches(TK, TP, TE, TH, TM)
    TH.ADAPTIVE_ROUTES.clear()
    D.reset_counts()


def prepare_dist(args, torch, pl, TK, TP, TE, TM, h2o, hdf, jframes):
    """Phase 17's meshes, D0 calls and D1-D4 queries, and phase 2's
    checks on every launch of one run of each (in the full script these
    run with phase 2's, while the profiler records: a trace taken after
    phase 16's untraced spills records nothing). Returns a dict."""
    mesh, mesh2 = dist_meshes(torch)
    calls = d0_calls(torch, h2o)
    queries = dist_queries(pl, hdf, jframes)
    t0 = time.perf_counter()
    recorded, first_ms = check_recorded_kernels(
        args, torch, TK, TE, TM, TP,
        [(n, call) for n, _, _, _, call in calls] +
        [(n, DistQuery(lf, mesh)) for n, lf, *_ in queries])
    return {"mesh": mesh, "mesh2": mesh2, "calls": calls,
            "queries": queries, "recorded": recorded, "first_ms": first_ms,
            "kernel_checks": time.perf_counter() - t0}


def run_dist_phase(args, torch, pl, TK, TP, TE, TH, TM, h2o, jtables, jdicts,
                   prep):
    """Phase 17: the distributed engine on a 4-slot mesh, after phase 2's
    checks (`prepare_dist`): dryrun_multichip(4), then each D0 call's and
    D1-D4 query's counted run, timed runs and a trace (and the in-memory
    collect's times beside a query's), then the oracles. Returns the
    counted runs' launches."""
    from polaroid_tpu_torch.entry import dryrun_multichip
    from polaroid_tpu_torch.exec import distributed as D
    mesh, mesh2 = prep["mesh"], prep["mesh2"]
    calls, queries, first_ms = prep["calls"], prep["queries"], \
        prep["first_ms"]
    cards = torch.cuda.device_count()
    print(json.dumps({"phase": "dist_mesh", "slots": mesh.size,
                      "devices": [str(d) for d in mesh.devices],
                      "mesh2": mesh2.shape, "cards": cards,
                      "peer_copies": cards > 1}))
    # D0: the reference's own certificate, on the 4-slot mesh and (its
    # last leg) the 2 x 2 one
    dist_reset(TK, TP, TE, TH, TM, D)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dryrun_multichip(DIST_SLOTS)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "dist", "query": "D0_dryrun_multichip",
                      "ms": (time.perf_counter() - t0) * 1e3,
                      "routes": dict(D.ROUTES), "counts": dict(D.COUNTS),
                      "launches": read_launches(TK, TP, TE, TH, TM)}))
    assert D.COUNTS["dropped"] == 0
    seconds = {"kernel_checks": prep["kernel_checks"]}
    t0 = time.perf_counter()
    runs, done = [], []
    for name, route, key, v, call in calls:
        dist_reset(TK, TP, TE, TH, TM, D)
        out = call.collect()
        launches = read_launches(TK, TP, TE, TH, TM)
        assert dict(TH.ADAPTIVE_ROUTES) == {route: 1}, \
            f"{name} took {dict(TH.ADAPTIVE_ROUTES)}, not {route}"
        for kernel in D0_KERNELS[route]:
            assert launches[kernel] >= 1, f"{name} did not launch {kernel}"
        runs.append(launches)
        tr = trace_collect(call, top_n=6)
        times = time_collects(call, args.reps)
        done.append((name, ("local", route, key, v), out, launches,
                     {"adaptive": route}, {}, times, None, tr))
    for name, lf, routes, must, oracle in queries:
        dq = DistQuery(lf, mesh)
        dist_reset(TK, TP, TE, TH, TM, D)
        out = dq.collect()
        launches = read_launches(TK, TP, TE, TH, TM)
        counts = dict(D.COUNTS)
        assert dict(D.ROUTES) == routes, \
            f"{name} took {dict(D.ROUTES)}, not {routes}"
        assert counts.get("dropped", 0) == 0, f"{name} dropped records"
        for kernel in must:
            assert launches[kernel] >= 1, f"{name} did not launch {kernel}"
        runs.append(launches)
        tr = trace_collect(dq, top_n=8)
        times = time_collects(dq, args.reps)
        mem_times = time_collects(lf, args.reps)
        done.append((name, oracle, out, launches, routes, counts, times,
                     (lf, mem_times), tr))
    seconds["collects"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the oracles, and the in-memory collect of each query, after every
    # trace
    for name, oracle, out, launches, routes, counts, times, mem, tr in done:
        med = statistics.median(times)
        rec = {"phase": "dist", "query": name, "slots": mesh.size,
               "routes": routes, "exchanges": counts.get("exchanges", 0),
               "bytes_between_slots": counts.get("bytes", 0),
               "per_dest_cap": counts.get("per_dest_cap", 0),
               "dropped": counts.get("dropped", 0), "launches": launches,
               "first_collect_ms": first_ms[name], "median_ms": med,
               "ms": times,
               # the busy ms of several cards' events overlap in time
               "idle_share": 1 - tr["device_busy_ms"] / med
               if tr["device_ops"] and cards == 1 else None, "trace": tr}
        kind = oracle[0]
        t1 = time.perf_counter()
        if kind == "local":
            rec["groups"] = check_local_groupby(name, out, oracle[2],
                                                oracle[3])
        else:
            lf, mem_times = mem
            rec["in_memory_median_ms"] = statistics.median(mem_times)
            rec["in_memory_ms"] = mem_times
            if kind == "h2o":
                _, q, keys, order = oracle
                rec["groups"] = check_h2o(q, out, h2o, keys, order)
                rec["vs_in_memory"] = same_frames(
                    name, out, lf.collect(), 1e-12,
                    sort_by=None if order else list(keys))
            elif kind == "sort":
                # bit for bit the in-memory sort (phase 8 holds that one
                # to numpy)
                rec["rows"] = out.height
                rec["vs_in_memory"] = same_frames(name, out, lf.collect(),
                                                  0.0, f32_ulps=0)
            elif kind == "sorted_tier":
                rec["rows"], _ = check_sorted_tier(oracle[1], out, h2o, {})
                rec["vs_in_memory"] = same_frames(name, out, lf.collect(),
                                                  0.0, f32_ulps=0)
            else:
                rec["rows"] = check_join(oracle[1], out, jtables, jdicts,
                                         any_order=True)
                keys = ["country"] if oracle[1] == "J1" else None
                if keys:
                    rec["vs_in_memory"] = same_frames(
                        name, out, lf.collect(), 1e-12, f32_ulps=1,
                        sort_by=keys)
        rec["check_seconds"] = time.perf_counter() - t1
        print(json.dumps(rec))
    del done
    seconds["oracles"] = time.perf_counter() - t0
    print(json.dumps({"phase": "dist_seconds", **seconds}))
    return runs


def run_dist_only(args, torch, pl, TK, TP, TE, TH, TM):
    """--only-dist: phase 17 alone (with its phase-2 checks); no result
    line."""
    t0 = time.perf_counter()
    h2o = make_h2o_data(H2O_ROWS, args.seed)
    hdf = pl.DataFrame(h2o, device="cuda")
    jtables, jdicts = make_join_data(H2O_ROWS, args.seed)
    jframes = join_frames(pl, jtables, jdicts, "cuda")
    print(json.dumps({"phase": "dist_only_data",
                      "seconds": time.perf_counter() - t0}))
    prep = prepare_dist(args, torch, pl, TK, TP, TE, TM, h2o, hdf, jframes)
    run_dist_phase(args, torch, pl, TK, TP, TE, TH, TM, h2o, jtables, jdicts,
                   prep)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1 << 23)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only-taq", action="store_true",
                    help="build, then phase 2 on phase 14's launches and "
                    "phase 14 alone; prints no result line")
    ap.add_argument("--only-surface", action="store_true",
                    help="build, then phase 2 on phase 15's launches and "
                    "phase 15 alone; prints no result line")
    ap.add_argument("--only-stream", action="store_true",
                    help="build, then phase 2 on phase 16's launches and "
                    "phase 16 alone; prints no result line")
    ap.add_argument("--only-dist", action="store_true",
                    help="build, then phase 17 (the distributed engine, "
                    "with phase 2's checks on its launches) alone; prints "
                    "no result line")
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
    from polaroid_tpu_torch.ops import exchange as TE
    from polaroid_tpu_torch.ops import hgroup as TH
    from polaroid_tpu_torch.ops import merge_sort as TM

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

    phase_seconds("1")
    if args.only_taq:
        run_taq_only(args, torch, pl, TK, TP, TE, TH, TM)
        return 0
    if args.only_surface:
        run_surface_only(args, torch, pl, TK, TP, TE, TH, TM)
        return 0
    if args.only_stream:
        run_stream_only(args, torch, pl, TK, TP, TE, TH, TM)
        phase_seconds("16")
        return 0
    if args.only_dist:
        run_dist_only(args, torch, pl, TK, TP, TE, TH, TM)
        phase_seconds("17")
        return 0

    # phase 10's data, made before the first trace: on the H100 hosts this
    # script was measured on, a trace taken more than several seconds
    # after the one before it records no device event, and none after it
    # does either, so no long host step runs between traces
    t0 = time.perf_counter()
    jtables, jdicts = make_join_data(H2O_ROWS, args.seed)
    jframes = join_frames(pl, jtables, jdicts, "cuda")
    print(json.dumps({"phase": "join_data", "rows": H2O_ROWS,
                      "seconds": time.perf_counter() - t0}))

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
    mm_max = check_seg_minmax(args, torch, TK, data, True)
    print(json.dumps({"phase": "kernel", **mm_max}))
    mm_pos = check_seg_minmax(args, torch, TK, data, False)
    print(json.dumps({"phase": "kernel", **mm_pos}))
    gat = check_gather(args, torch, TK)
    print(json.dumps({"phase": "kernel", **gat}))
    h2o = make_h2o_data(H2O_ROWS, args.seed)
    prep = TH.hash_prep(*h2o_key_code(torch, h2o, "id3"))
    exch = check_exchange(args, torch, TE, TH, prep)
    print(json.dumps({"phase": "kernel", **exch}))
    # kernel B at the hash tier's shapes: the group keys of the q3
    # layout (M = 25,165,824 slots, one word), and of the carry sort of
    # phase 7 (2^24 rows, 8 groups)
    lay = TH.hash_layout(prep)
    comp_hash = compare_compact(args, torch, TP, lay.start,
                                [TH._to_word(lay.h)])
    print(json.dumps({"phase": "kernel", "shape": "h2o_q3_layout",
                      **comp_hash}))
    sv, _, _, newg = TH.carry_sort(*h2o_key_code(torch, h2o, "kf"))
    comp_carry = compare_compact(args, torch, TP, newg,
                                 [TH._to_word(sv & TH.U32_MASK)])
    print(json.dumps({"phase": "kernel", "shape": "h2o_fallback_sort",
                      **comp_carry}))
    del prep, lay, sv, newg
    msort = check_merge_sort(args, torch, TM, h2o)
    print(json.dumps({"phase": "kernel", **msort}))
    # kernels E, F and B at every shape that phase 9's collects give them
    import numpy as np
    hdf = pl.DataFrame(h2o, device="cuda")
    ndf, valid = with_null_copies(pl, hdf, h2o, args.seed)
    recorded, _ = check_recorded_kernels(
        args, torch, TK, TE, TM, TP,
        [(name, lf) for name, lf, _ in sorted_tier_queries(pl, hdf, ndf)])
    # kernels A, E, F and B at every shape that phase 10's joins give
    # them (this is each join's first collect: its host ms is printed in
    # phase 10), and the kernel-level join at bench.py's shape
    jqueries = join_queries(pl, jframes)
    shapes, first_collect_ms = check_recorded_kernels(
        args, torch, TK, TE, TM, TP,
        [(name, lf) for name, lf, *_ in jqueries])
    for kernel, by_shape in shapes.items():
        recorded[kernel].update(by_shape)
    # kernels F and B at every shape that phase 11's windows give them
    df = pl.DataFrame(data, device="cuda")
    qdf, pricen_valid = with_null_price(pl, df, data, args.seed)
    wqueries = window_queries(pl, hdf, qdf)
    shapes, _ = check_recorded_kernels(
        args, torch, TK, TE, TM, TP,
        [(name, lf) for name, lf, _ in wqueries])
    for kernel, by_shape in shapes.items():
        recorded[kernel].update(by_shape)
    # kernels F, B and A at every shape that phase 12's time queries give
    # them (each query's first collect: its host ms is printed in phase 12)
    tdata = make_trades_data(args.rows, args.seed)
    tqueries = time_queries(pl, trades_frame(pl, tdata))
    shapes, time_first_ms = check_recorded_kernels(
        args, torch, TK, TE, TM, TP,
        [(name, lf) for name, lf, *_ in tqueries])
    for kernel, by_shape in shapes.items():
        recorded[kernel].update(by_shape)
    # kernels F and B at every shape that phase 13's joins and selects
    # give them (each query's first collect, as above)
    qdata = make_quotes_data(args.rows, args.seed)
    wdata = make_windows_data(args.seed)
    aqueries = asof_queries(pl, *asof_frames(pl, tdata, qdata, wdata))
    shapes, asof_first_ms = check_recorded_kernels(
        args, torch, TK, TE, TM, TP,
        [(name, lf) for name, lf, *_ in aqueries])
    for kernel, by_shape in shapes.items():
        recorded[kernel].update(by_shape)
    # kernels F, B, A and C at every shape that phase 14's string and
    # nested queries give them (each query's first collect, as above)
    taq = make_taq(args, torch, pl)
    shapes, taq_first_ms = check_recorded_kernels(
        args, torch, TK, TE, TM, TP,
        [(name, lf) for name, lf, *_ in taq["queries"]])
    for kernel, by_shape in shapes.items():
        recorded[kernel].update(by_shape)
    # kernels F, B, A, C and E at every shape that phase 15's SQL and
    # surface queries give them (each query's first collect, as above)
    t0 = time.perf_counter()
    sf = make_surface(args, torch, pl, hdf, taq)
    shapes, surface_first_ms = check_recorded_kernels(
        args, torch, TK, TE, TM, TP,
        [(n, lf) for n, lf, _ in sf["sql"]] + sf["surface"])
    for kernel, by_shape in shapes.items():
        recorded[kernel].update(by_shape)
    print(json.dumps({"phase": "surface_kernel_checks",
                      "seconds": time.perf_counter() - t0}))
    lookup = check_lookup_join(args, torch, TE)
    print(json.dumps({"phase": "kernel", "shape": "lookup_join_4m_x_1m",
                      **lookup}))
    # kernels A, B, C, E and F at every shape that phase 17's D0 calls and
    # distributed queries give them
    dist_prep = prepare_dist(args, torch, pl, TK, TP, TE, TM, h2o, hdf,
                             jframes)
    for kernel, by_shape in dist_prep["recorded"].items():
        recorded[kernel].update(by_shape)
    phase_seconds("2")

    # --- 3. q1 end to end ---------------------------------------------------
    # the first collect of each chain runs it eagerly and captures it;
    # every later collect replays the graph once, with the launches of
    # the first
    from polaroid_tpu_torch.exec import compiled as CM
    lf = q1_frame(pl, df)
    out, q1_launches, q1_first = first_fused_collect(torch, lf, TK, TP, TE,
                                                     TH, TM)
    assert q1_launches["seg_sum"] == 2, "q1 did not launch seg_sum twice"
    assert q1_launches["compact_words"] == 1, \
        "q1 did not launch compact_words once"
    ngroups = check_q1(out, data)
    q1_replay, times = replayed_collects(
        args, torch, lf, q1_launches, TK, TP, TE, TH, TM,
        check=lambda o: check_q1(o, data))
    print(json.dumps({"phase": "q1", "rows": args.rows, "groups": ngroups,
                      "launches": q1_launches, **q1_first, **q1_replay,
                      "median_ms": statistics.median(times),
                      "ms": times, "trace": trace_collect(lf)}))
    phase_seconds("3")

    # --- 4. filter -> with_columns -> collect -------------------------------
    lf2 = (df.lazy().filter(pl.col("volume") > 1000)
           .with_columns((pl.col("price") * pl.col("volume"))
                         .alias("notional")))
    TP.LAST_ROWS = 0
    out2, filter_launches, f_first = first_fused_collect(torch, lf2, TK, TP,
                                                         TE, TH, TM)
    assert filter_launches["compact_words"] > 0 and \
        TP.LAST_ROWS == df._table.capacity, \
        "the filter collect did not compact at full width"
    check_filter(out2, data)
    f_replay, times = replayed_collects(
        args, torch, lf2, filter_launches, TK, TP, TE, TH, TM,
        check=lambda o: check_filter(o, data))
    print(json.dumps({"phase": "filter_collect", "rows": args.rows,
                      "live": out2.height, "launches": filter_launches,
                      **f_first, **f_replay,
                      "median_ms": statistics.median(times), "ms": times,
                      "trace": trace_collect(lf2)}))
    phase_seconds("4")

    # --- 5. the per-symbol OHLC bar ----------------------------------------
    lf5 = ohlc_frame(pl, df)
    out5, ohlc_launches, o_first = first_fused_collect(torch, lf5, TK, TP,
                                                       TE, TH, TM)
    assert ohlc_launches["seg_minmax"] > 0, "ohlc did not launch seg_minmax"
    assert ohlc_launches["gather"] > 0, "ohlc did not launch gather"
    ngroups5 = check_ohlc(out5, data)
    o_replay, times = replayed_collects(
        args, torch, lf5, ohlc_launches, TK, TP, TE, TH, TM,
        check=lambda o: check_ohlc(o, data), may_stay_eager=True)
    print(json.dumps({"phase": "ohlc", "rows": args.rows, "groups": ngroups5,
                      "launches": ohlc_launches, **o_first, **o_replay,
                      "median_ms": statistics.median(times), "ms": times,
                      "trace": trace_collect(lf5)}))
    phase_seconds("5")

    # --- 6. the H2O group-by over large key domains ------------------------
    runs = [q1_launches, filter_launches, ohlc_launches]
    # the kernels that the traced collects after the first ran on the
    # card, where graphs replay them and no wrapper counts
    on_card = [q1_replay["replay_launches"], f_replay["replay_launches"],
               o_replay["replay_launches"]]
    for name, keys, lfq, order in h2o_queries(pl, hdf):
        reset_launches(TK, TP, TE, TH, TM)
        outq = lfq.collect()
        ql = read_launches(TK, TP, TE, TH, TM)
        assert ql["bucket_exchange"] >= 1, f"{name} did not launch the " \
            "exchange kernel"
        assert ql["fallbacks"] == 0, f"{name} took the fallback"
        ng = check_h2o(name, outq, h2o, keys, order)
        runs.append(ql)
        times = time_collects(lfq, args.reps)
        print(json.dumps({"phase": "h2o", "query": name,
                          "rows": H2O_ROWS, "groups": ng,
                          "launches": ql,
                          "median_ms": statistics.median(times), "ms": times,
                          "trace": trace_collect(lfq)}))

    phase_seconds("6")

    # --- 7. the carry-sort fallback ------------------------------------------
    lf7 = hdf.lazy().group_by("kf").agg(pl.col("v1").sum().alias("v1"),
                                        pl.col("v3").mean().alias("v3"),
                                        pl.len().alias("n"))
    reset_launches(TK, TP, TE, TH, TM)
    out7 = lf7.collect()
    fb_launches = read_launches(TK, TP, TE, TH, TM)
    assert fb_launches["fallbacks"] == 1, "phase 7 did not take the fallback"
    assert fb_launches["bucket_exchange"] == 0
    ng7 = check_h2o("fallback", out7, h2o, ("kf",), None)
    runs.append(fb_launches)
    times = time_collects(lf7, args.reps)
    print(json.dumps({"phase": "fallback", "rows": H2O_ROWS,
                      "groups": ng7, "launches": fb_launches,
                      "median_ms": statistics.median(times), "ms": times,
                      "trace": trace_collect(lf7)}))

    phase_seconds("7")

    # --- 8. device sorts at 10^7 rows ---------------------------------------
    sort_data = {**h2o, "id4n": h2o["id4"], "v3n": h2o["v3"]}
    assert len(np.unique(h2o["v3"])) == H2O_ROWS, "v3 has ties"
    # S5's input: the group-by alone, against the H2O oracle
    base = hdf.lazy().group_by("id3").agg(pl.col("v1").sum()).collect()
    check_h2o("S5_group_by", base, h2o, ("id3",), None)
    group_base = (base.get_column("id3").to_numpy(),
                  base.get_column("v1").to_numpy())
    for name, lfs in sort_queries(pl, hdf, ndf):
        reset_launches(TK, TP, TE, TH, TM)
        outs = lfs.collect()
        sl = read_launches(TK, TP, TE, TH, TM)
        if name == "S6":
            assert sl["merge_sort"] == 0, "S6 did not take the packed sort"
        else:
            assert sl["merge_sort"] >= 1, f"{name} did not launch merge_sort"
        if name == "S5":
            assert sl["bucket_exchange"] >= 1 and sl["fallbacks"] == 0, \
                "S5 did not group through the exchange"
        rows = check_sort(name, outs, sort_data if name == "S3" else h2o,
                          valid if name == "S3" else {}, group_base)
        runs.append(sl)
        times = time_collects(lfs, args.reps)
        print(json.dumps({"phase": "sort", "query": name,
                          "rows": H2O_ROWS, "out_rows": rows,
                          "launches": sl,
                          "median_ms": statistics.median(times), "ms": times,
                          "trace": trace_collect(lfs)}))

    phase_seconds("8")

    # --- 9. the sorted tier and the ordered aggregates at 10^7 rows ------
    for name, lfs, must in sorted_tier_queries(pl, hdf, ndf):
        reset_launches(TK, TP, TE, TH, TM)
        outs = lfs.collect()
        bl = read_launches(TK, TP, TE, TH, TM)
        for kernel in must:
            assert bl[kernel] >= 1, f"{name} did not launch {kernel}"
        assert bl["fallbacks"] == 0, f"{name} took the fallback"
        ng, errs = check_sorted_tier(name, outs, h2o, valid)
        runs.append(bl)
        times = time_collects(lfs, args.reps)
        print(json.dumps({"phase": "sorted_tier", "query": name,
                          "rows": H2O_ROWS, "out_rows": ng,
                          "launches": bl, "largest_error": errs,
                          "median_ms": statistics.median(times), "ms": times,
                          "trace": trace_collect(lfs)}))
    del ndf

    phase_seconds("9")

    # --- 10. joins: the H2O join suite and the orders x users pipeline --
    # every query's collects and trace first, the numpy oracles (seconds
    # of host work each) after them
    from polaroid_tpu_torch.ops import join as TJ
    results = []
    for name, lfj, route, want, sides in jqueries:
        reset_launches(TK, TP, TE, TH, TM)
        TJ.ROUTES.clear()
        outj = lfj.collect()
        jl = read_launches(TK, TP, TE, TH, TM)
        assert dict(TJ.ROUTES) == {route: 1}, \
            f"{name} took {dict(TJ.ROUTES)}, not {route}"
        for kernel, count in want.items():
            assert jl[kernel] == count, \
                f"{name} launched {kernel} {jl[kernel]} times, not {count}"
        assert jl["fallbacks"] == 0, f"{name} took the fallback"
        if name == "J1":
            assert jl["seg_sum"] >= 1, "J1 did not group on the dense tier"
        runs.append(jl)
        tr = trace_collect(lfj, top_n=12)
        times = time_collects(lfj, args.reps)
        results.append((name, outj, route, jl, sides, times, tr))
    for name, outj, route, jl, sides, times, tr in results:
        nout = check_join(name, outj, jtables, jdicts)
        med = statistics.median(times)
        print(json.dumps({
            "phase": "join", "query": name,
            "rows": [len(next(iter(jtables[t].values()))) for t in sides],
            "note": "bench.py's cut of the BASELINE.md pipeline: one group "
                    "key" if name == "J1" else "J1_1e7_NA_0_0",
            "out_rows": nout, "route": route, "launches": jl,
            "first_collect_ms": first_collect_ms[name],
            "median_ms": med, "ms": times,
            "note_ms": "the median is of warm collects: a later collect "
                       "of the same frames reuses what the first one "
                       "built on the host (a string key's merged "
                       "dictionary)",
            "idle_share": 1 - tr["device_busy_ms"] / med
            if tr["device_ops"] else None, "trace": tr}))
    del results

    phase_seconds("10")

    # --- 11. windows and .over() at 10^7 and 2^23 rows ------------------------
    # every query's collects and trace first (its result copied to the
    # host), the numpy oracles after them
    results = []
    for name, lfw, must in wqueries:
        reset_launches(TK, TP, TE, TH, TM)
        outw = lfw.collect()
        wl = read_launches(TK, TP, TE, TH, TM)
        for kernel in must:
            assert wl[kernel] >= 1, f"{name} did not launch {kernel}"
        assert wl["fallbacks"] == 0, f"{name} took the fallback"
        runs.append(wl)
        got = host_columns(outw)
        del outw
        tr = trace_collect(lfw, top_n=8)
        times = time_collects(lfw, args.reps)
        results.append((name, got, wl, times, tr))
    for name, got, wl, times, tr in results:
        nout, errs = check_window(name, got, h2o, data, pricen_valid)
        med = statistics.median(times)
        print(json.dumps({
            "phase": "window", "query": name,
            "rows": H2O_ROWS if name.startswith(("q8", "W1", "W2"))
            else args.rows, "out_rows": nout, "launches": wl,
            "largest_error": errs, "median_ms": med, "ms": times,
            "idle_share": 1 - tr["device_busy_ms"] / med
            if tr["device_ops"] else None, "trace": tr}))
    del results

    phase_seconds("11")

    # --- 12. time at 2^23 rows --------------------------------------------------
    run_time_phase(args, torch, TK, TP, TE, TH, TM, tqueries, tdata,
                   time_first_ms, runs)
    del tqueries

    phase_seconds("12")

    # --- 13. as-of and inequality joins and the select context -------------
    run_asof_phase(args, torch, TK, TP, TE, TH, TM, aqueries, tdata, qdata,
                   wdata, asof_first_ms, runs)
    del aqueries

    phase_seconds("13")

    # --- 14. strings and nested columns on the TAQ trades ------------------
    run_taq_phase(args, torch, TK, TP, TE, TH, TM, taq["queries"],
                  taq["data"], taq["draws"], taq_first_ms, taq["build_ms"],
                  runs)

    phase_seconds("14")

    # --- 15. SQL and the rest of the surface -----------------------------
    t0 = time.perf_counter()
    run_surface_phase(args, torch, TK, TP, TE, TH, TM, sf["sql"],
                      sf["surface"], sf["twins"], h2o, taq["data"],
                      taq["draws"], surface_first_ms, runs)
    del taq, sf
    print(json.dumps({"phase": "surface_seconds",
                      "seconds": time.perf_counter() - t0}))

    phase_seconds("15")

    # --- 16. fused chains and the streaming engine -------------------------
    stream_runs, stream_on_card = run_stream_phase(
        args, torch, pl, TK, TP, TE, TH, TM, tdata, df, qdf, jframes)
    runs += stream_runs
    on_card += stream_on_card
    phase_seconds("16")

    # --- 17. the distributed engine on a 4-slot mesh -----------------------
    runs += run_dist_phase(args, torch, pl, TK, TP, TE, TH, TM, h2o,
                           jtables, jdicts, dist_prep)
    phase_seconds("17")

    # --- result ---------------------------------------------------------------
    def launches(name):
        return sum(r[name] for r in runs)

    def replay_launches(name):
        return sum(r[name] for r in on_card)

    def entry(name, source, replaces, m):
        return {"name": name, "route": "cuda",
                "source": f"polaroid_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches(name),
                "replay_launches": replay_launches(name),
                "max_abs_err": m["max_abs_err"], "ms": m["kernel_ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": m["library_ms"]}

    def shape_entry(m):
        return {"ms": m["kernel_ms"],
                **{k: m[k] for k in ("plain_ms", "bound_ms", "library_ms",
                                     "trace_ms", "live", "digit_passes",
                                     "num_keys", "n", "slots", "mode",
                                     "perm_only_ms", "perm_only_bound_ms",
                                     "C", "G")
                 if k in m}}

    compact_entry = entry("compact_words", "compact.cu",
                          "polaroid_tpu/ops/pallas_partition.py:281",
                          comp_full)
    for shape, m in (("h2o_q3_layout", comp_hash),
                     ("h2o_fallback_sort", comp_carry),
                     *recorded["compact_words"].items()):
        compact_entry[shape] = shape_entry(m)
    msort_entry = entry("merge_sort", "radix_sort.cu",
                        "polaroid_tpu/ops/merge_sort.py:216", msort)
    for shape, m in recorded["merge_sort"].items():
        msort_entry[shape] = shape_entry(m)
    exch_entry = entry("bucket_exchange", "exchange.cu",
                       "polaroid_tpu/ops/exchange.py:116", exch)
    for shape, m in recorded["bucket_exchange"].items():
        exch_entry[shape] = shape_entry(m)
    exch_entry["lookup_join_4m_x_1m"] = {
        k: lookup[k] for k in ("ms", "exchange_device_ms")}
    seg_entry = entry("seg_sum", "seg_sum.cu",
                      "polaroid_tpu/ops/pallas_kernels.py:120", seg)
    for shape, m in recorded["seg_sum"].items():
        seg_entry[shape] = shape_entry(m)
    minmax_entry = entry("seg_minmax", "seg_minmax.cu",
                         "polaroid_tpu/ops/pallas_kernels.py:177", mm_max)
    for shape, m in recorded["seg_minmax"].items():
        minmax_entry[shape] = shape_entry(m)
    kernels = [
        seg_entry,
        compact_entry,
        minmax_entry,
        entry("gather", "gather.cu",
              "polaroid_tpu/ops/pallas_kernels.py:231", gat),
        exch_entry,
        msort_entry,
    ]
    print(json.dumps({"phase": "wall", "seconds":
                      time.perf_counter() - START}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
