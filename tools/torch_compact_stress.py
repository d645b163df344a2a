#!/usr/bin/env python3
"""Repeat chip_smoke.py's phase-2 checks of the compaction kernel (kernel
B, `compact_words`) many times on one CUDA card, and count what fails.

    python3 tools/torch_compact_stress.py [--iters 300] [--max-seconds 240]
                                          [--root .] [--out FILE.json]

Each iteration runs, for each of phase 2's four compaction shapes (q1's
2^23 rows of 4 f64 columns at 80% live, the 1024-group table, the H2O q3
layout's keys and the carry sort's keys), the same three steps as
chip_smoke.py's `compare_compact`: one call held bit for bit against the
plain version, back-to-back calls timed with CUDA events, and one call
under torch.profiler. It also checks and traces the segment min/max
(kernel C) at the OHLC shape. Nothing stops at the first fault: every
count or prefix that differs is recorded with where it differs, and
every trace is counted by how many device events it holds. The run
stops after --iters iterations or once --max-seconds have passed.

--root names the checkout whose `polaroid_tpu_torch` and `chip_smoke.py`
are imported (another commit unpacked beside this one, say). The summary
goes to standard output as one JSON line, and with --out the summary,
every fault and every timing to that file. Exits 1 if any check failed.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time


def compact_fault(torch, TP, mask, words):
    """None if one compact_words call matches the plain version, else
    what differs."""
    outs, cnt = TP.compact_words(mask, words)
    want, want_cnt = TP.compact_words_plain(mask, words)
    torch.cuda.synchronize()
    k, kw = int(cnt), int(want_cnt)
    if k != kw:
        return {"what": "count", "got": k, "want": kw}
    for i, (o, w) in enumerate(zip(outs, want)):
        bad = torch.nonzero(o[:k] != w[:k]).squeeze(1)
        if bad.numel():
            return {"what": "prefix", "word": i, "rows_differing":
                    int(bad.numel()), "first": int(bad[0]), "live": k}
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--max-seconds", type=float, default=240.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1 << 23)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_compact_stress: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke as CS
    from polaroid_tpu_torch.ops import cuda_build as B
    from polaroid_tpu_torch.ops import cuda_kernels as TK
    from polaroid_tpu_torch.ops import cuda_partition as TP
    from polaroid_tpu_torch.ops import hgroup as TH
    B.build(["compact", "seg_minmax"])

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)

    def cols(n, n8, n4, live):
        mask = torch.rand(n, generator=g, device=dev) < live
        c8 = [torch.randn(n, generator=g, device=dev, dtype=torch.float64)
              for _ in range(n8)]
        c4 = [torch.randn(n, generator=g, device=dev) for _ in range(n4)]
        return mask, [c.view(torch.int64) for c in c8] + c4

    h2o = CS.make_h2o_data(CS.H2O_ROWS, args.seed)
    lay = TH.hash_layout(TH.hash_prep(*CS.h2o_key_code(torch, h2o, "id3")))
    sv, _, _, newg = TH.carry_sort(*CS.h2o_key_code(torch, h2o, "kf"))
    shapes = {
        "q1_shape": cols(args.rows, 4, 0, 0.8),
        "groups": cols(1024, 3, 1, 0.98),
        "h2o_q3_layout": (lay.start, [TH._to_word(lay.h)]),
        "h2o_fallback_sort": (newg, [TH._to_word(sv & TH.U32_MASK)]),
    }
    data = CS.make_q1_data(args.rows, args.seed)
    sym = torch.from_numpy(data["symbol"].astype("int32")).to(dev)
    live = torch.from_numpy(data["volume"]).to(dev) > 1000
    gid = torch.where(live, sym + 1, torch.full_like(sym, 1024))
    price = torch.from_numpy(data["price"]).to(dev)

    def minmax():
        return TK.seg_minmax(price, gid, 1024, True, -float("inf"))

    faults = []
    traces = {k: collections.Counter() for k in [*shapes, "seg_minmax"]}
    ms = {k: [] for k in shapes}
    t0 = time.perf_counter()
    done = 0
    for it in range(args.iters):
        if time.perf_counter() - t0 > args.max_seconds:
            break
        done += 1
        for name, (mask, words) in shapes.items():
            f = compact_fault(torch, TP, mask, words)
            if f:
                faults.append({"iter": it, "shape": name, **f})

            def call(mask=mask, words=words):
                return TP.compact_words(mask, words)
            ms[name].append(CS.cuda_ms(call, args.reps))
            traces[name][CS.trace_call(call)["device_ops"]] += 1
        got = minmax()
        want = TK.seg_minmax_plain(price, gid, 1024, True, -float("inf"))
        if not torch.equal(got, want):
            faults.append({"iter": it, "shape": "seg_minmax_ohlc",
                           "what": "result"})
        traces["seg_minmax"][CS.trace_call(minmax)["device_ops"]] += 1
    summary = {
        "root": os.path.abspath(args.root), "iters": done,
        "seconds": time.perf_counter() - t0, "faults": len(faults),
        "fault_kinds": collections.Counter(
            f"{f['shape']}:{f['what']}" for f in faults),
        "first_faults": faults[:10],
        # device events per traced call -> how many traces held that many
        "trace_device_ops": {k: dict(v) for k, v in traces.items()},
        "ms_median": {k: sorted(v)[len(v) // 2] for k, v in ms.items()},
        "ms_max": {k: max(v) for k, v in ms.items()},
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({**summary, "faults_all": faults, "ms": ms}, fh)
    print(json.dumps(summary))
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
