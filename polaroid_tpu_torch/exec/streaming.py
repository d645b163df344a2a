"""Streaming (batched) executor.

The port of the JAX package's `exec/streaming.py` (the reference's
morsel-driven engine, `polars-stream/src/skeleton.rs:31`). Each input
of a union of in-memory frames streams as its own batch; elementwise
stages (filter/select/with_columns) run per batch through the fused
chain (`exec/compiled.run_fused`: on the card one graph replay per
batch), and breaker operators keep partial states:

  * group_by: per-batch partial aggregate states (sum/count/min/max/...)
    are stacked and aggregated again with a merge aggregate;
  * joins: sampled build-side selection with probe replay; builds past
    the row budget switch to grace-hash partitioned spill joins
    (inner/left/right/semi/anti/full, exact per partition);
  * sort: external sample sort with spill files, gated by a row budget
    (inputs that fit sort in memory with no disk traffic);
  * distinct: per-batch uniques with incremental folds; keep="none"
    materializes (a key seen once in each of two batches drops both);
  * stateful window exprs stream exactly (bounded-lookback tail replay,
    cum_* through carried device scalars); head() stops early.

Anything else materializes its child and runs in memory. File scans and
sinks come with Slice H (host IO): a plan that reaches one raises.

Spill files are the port's own: each batch's live rows as host tensors
(`torch.save`), with each String column's dictionary; partition ids are
hashed on the device (`ops/hashing.py`). Temporary directories are
removed when the stream ends.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..batch import Table
from ..config import CONFIG
from ..expr import meta
from ..expr.expr import Expr, col as _col
from ..ops.concat import vstack_tables
from ..plan import logical as L

# aggregations that decompose into (partial_agg, merge_agg) pairs
_DECOMPOSABLE = {
    "sum": ("sum", "sum"),
    "min": ("min", "min"),
    "max": ("max", "max"),
    "count": ("count", "sum"),
    "len": ("len", "sum"),
    "null_count": ("null_count", "sum"),
    "any": ("any", "any"),
    "all": ("all", "all"),
    "first": ("first", "first"),
    "last": ("last", "last"),
}

# per process: batches the sources yielded, per-batch partial group-bys,
# merges of partials, spill files written and their bytes
COUNTS: Dict[str, int] = {}
# one entry per streaming equi-join: {"how", "build": "left"|"right",
# "swapped", "grace"}
JOINS: List[dict] = []


def reset_counts() -> None:
    for k in ("batches", "partials", "merges", "spills", "spilled_bytes"):
        COUNTS[k] = 0
    JOINS.clear()


reset_counts()


def execute_streaming(plan: L.Plan) -> Table:
    from ..metrics import tracking
    with tracking(CONFIG.track_metrics or CONFIG.log_metrics) as qm:
        batches = []
        for t in _stream(plan):
            if qm is not None:
                _fence(t)
                m = qm.node("stream_output")
                m.batches += 1
                m.rows_out += t.count_rows()
            batches.append(t)
        if not batches:
            return _materialize(plan)
        out = batches[0] if len(batches) == 1 else vstack_tables(batches)
        if qm is not None and CONFIG.log_metrics:
            qm.print_report()
        return out


def _fence(t: Table) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _elem_ok(nd) -> bool:
    if nd.kind == "filter":
        return meta.is_elementwise(nd.predicate)
    return all(meta.is_elementwise(e) for e in nd.exprs)


def _per_batch(qm, name: str, fn, t: Table) -> Table:
    """fn(t), timed under `name` (fenced on the card) when tracking."""
    if qm is None:
        return fn(t)
    with qm.timed(name) as m:
        out = fn(t)
        _fence(out)
        m.batches += 1
    return out


def _stream(plan: L.Plan) -> Iterator[Table]:
    from ..metrics import current
    k = plan.kind

    if k in ("scan", "sink"):
        raise NotImplementedError(
            f"streaming plan node {k!r} is not ported yet: file scans and "
            "sinks come with Slice H (host IO)")

    if k == "df_scan":
        COUNTS["batches"] += 1
        yield plan.table
        return

    if k in ("select", "with_columns", "filter"):
        # pure-elementwise chains run as ONE fused chain per batch
        # (exec/compiled.run_fused: one graph replay on the card)
        chain = []
        node = plan
        while node.kind in ("select", "with_columns", "filter") and \
                _elem_ok(node):
            chain.append(node)
            node = node.input
        qm = current()
        if chain:
            chain.reverse()
            from .compiled import run_fused
            for t in _stream(node):
                yield _per_batch(qm, k, lambda b: run_fused(chain, b), t)
            return
        from ..api.frame import DataFrame
        stateful = None
        if k in ("select", "with_columns") and \
                any(not meta.is_elementwise(e) for e in plan.exprs):
            stateful = _StatefulWindowStreamer.try_build(plan.exprs, k)
            if stateful is None:
                yield _materialize(plan)
                return

        def step(t):
            if stateful is not None:
                return stateful.step(t)
            df = DataFrame._from_table(t)
            if k == "select":
                return df.select(plan.exprs)._table
            if k == "with_columns":
                return df.with_columns(plan.exprs)._table
            return df.filter(plan.predicate)._table
        for t in _stream(plan.input):
            yield _per_batch(qm, k, step, t)
        return

    if k == "group_by":
        t = _stream_group_by(plan)
        yield t if t is not None else _materialize(plan)
        return

    if k == "join" and plan.how in ("inner", "left", "semi", "anti") \
            and not plan.join_nulls:
        yield from _stream_join(plan)
        return

    if k == "join" and plan.how == "right" and not plan.join_nulls:
        yield from _stream_right_join(plan)
        return

    if k == "join" and plan.how == "full":
        yield from _stream_full_join(plan)
        return

    if k == "map_function" and plan.streamable:
        # exact per-batch maps (map_batches(streamable=True))
        qm = current()
        for t in _stream(plan.input):
            yield _per_batch(qm, plan.label, plan.fn, t)
        return

    if k == "union":
        for p in plan.inputs:
            yield from _stream(p)
        return

    if k == "slice" and plan.offset == 0 and plan.length is not None:
        remaining = plan.length
        from ..ops.compact import slice_rows
        for t in _stream(plan.input):
            n = t.count_rows()
            if n >= remaining:
                yield slice_rows(t, 0, remaining)
                return
            remaining -= n
            yield t
        return

    if k == "distinct" and plan.keep != "none":
        # two-phase dedupe: per-batch uniques + incremental folds keep
        # memory bounded by the output cardinality. keep="none" cannot
        # pre-dedupe per batch and materializes.
        from ..api.frame import DataFrame
        fold_budget = max(CONFIG.batch_rows * 2, 1)
        parts: List[Table] = []
        acc_rows = 0
        for t in _stream(plan.input):
            u = DataFrame._from_table(t).unique(
                subset=plan.subset, keep=plan.keep,
                maintain_order=True)._table
            parts.append(u)
            acc_rows += u.count_rows()
            if acc_rows > fold_budget and len(parts) > 1:
                folded = DataFrame._from_table(vstack_tables(parts)).unique(
                    subset=plan.subset, keep=plan.keep,
                    maintain_order=True)._table
                parts = [folded]
                acc_rows = folded.count_rows()
        if not parts:
            return
        merged = parts[0] if len(parts) == 1 else vstack_tables(parts)
        yield DataFrame._from_table(merged).unique(
            subset=plan.subset, keep=plan.keep,
            maintain_order=plan.maintain_order)._table
        return

    if k == "sort" and plan.slice_ is None:
        yield from _stream_sort_external(plan)
        return

    if k == "sort" and plan.slice_ is not None and plan.slice_[0] == 0:
        # streaming top-k: per-batch top-k partials, one final top-k
        kk = plan.slice_[1]
        parts = [_materialize(L.Sort(L.DataFrameScan(t), plan.by,
                                     plan.descending, plan.nulls_last,
                                     plan.maintain_order, (0, kk)))
                 for t in _stream(plan.input)]
        if not parts:
            return
        merged = parts[0] if len(parts) == 1 else vstack_tables(parts)
        yield _materialize(L.Sort(L.DataFrameScan(merged), plan.by,
                                  plan.descending, plan.nulls_last,
                                  plan.maintain_order, (0, kk)))
        return

    if k == "with_row_index":
        from ..api.frame import DataFrame
        off = plan.offset
        for t in _stream(plan.input):
            yield DataFrame._from_table(t).with_row_index(
                plan.name, off)._table
            off += t.count_rows()
        return

    yield _materialize(plan)


def _materialize(plan: L.Plan) -> Table:
    from .executor import execute
    return execute(plan)


def _stacked(parts: List[Table], plan: L.Plan) -> Table:
    if not parts:
        return _materialize(plan)
    return parts[0] if len(parts) == 1 else vstack_tables(parts)


# --- joins -------------------------------------------------------------------

def _stream_join(plan: L.Join) -> Iterator[Table]:
    """Streaming equi-join with a sampled build side (reference:
    `equi_join.rs:250` SampleState): batches are pulled from both sides,
    the smaller side first, until one side is exhausted or both pass
    `join_sample_limit` rows. The exhausted side becomes the build side:
    an inner join swaps sides freely (the user's column names and order
    restored afterwards); left/semi/anti build on the right. Sampled
    batches are replayed into the probe stream."""
    import itertools
    from ..metrics import current
    from ..ops.join import join_tables
    qm = current()
    record = {"how": plan.how, "build": "right", "swapped": False,
              "grace": False}
    JOINS.append(record)

    def probe_loop(probe_iter, build, swapped):
        lsch = list(plan.left.schema().keys())
        rsch = list(plan.right.schema().keys())
        coalesce = plan.coalesce if plan.coalesce is not None else True
        for t in probe_iter:
            if not swapped:
                yield _per_batch(qm, "join", lambda b: join_tables(
                    b, build, plan.left_on, plan.right_on, plan.how,
                    plan.suffix, plan.join_nulls, plan.coalesce), t)
                continue
            # inner join with sides swapped: probe batches are RIGHT
            # rows, the build is the sampled LEFT side. Join with a temp
            # suffix and no coalesce, then restore the user-facing names
            # and order (left columns, then right minus coalesced keys,
            # plan.suffix on a collision).
            raw = _per_batch(qm, "join", lambda b: join_tables(
                b, build, plan.right_on, plan.left_on, "inner", "__swapL",
                plan.join_nulls, False), t)
            rnames = set(rsch)
            sel, ren = [], {}
            for n in lsch:
                src = n if n not in rnames else f"{n}__swapL"
                sel.append(src)
                if src != n:
                    ren[src] = n
            skip = set(plan.right_on) if coalesce else set()
            for n in rsch:
                if n in skip:
                    continue
                out_name = f"{n}{plan.suffix}" if n in set(lsch) else n
                sel.append(n)
                if out_name != n:
                    ren[n] = out_name
            out = raw.select_columns(sel)
            yield out.rename(ren) if ren else out

    if plan.how != "inner":
        # build the right side under a row budget; past it, the
        # grace-hash partitioned spill join
        budget = CONFIG.join_build_budget_rows
        rit = _stream(plan.right)
        rbuf: List[Table] = []
        rrows = 0
        for t in rit:
            rbuf.append(t)
            rrows += t.count_rows()
            if rrows > budget:
                record["grace"] = True
                yield from _grace_join(plan, rbuf, rit)
                return
        yield from probe_loop(_stream(plan.left), _stacked(rbuf, plan.right),
                              False)
        return

    limit = CONFIG.join_sample_limit
    lit, rit = _stream(plan.left), _stream(plan.right)
    lbuf: List[Table] = []
    rbuf = []
    lrows = rrows = 0
    ldone = rdone = False
    while not (ldone or rdone) and (lrows <= limit or rrows <= limit):
        if rrows <= lrows:
            try:
                t = next(rit)
                rbuf.append(t)
                rrows += t.count_rows()
            except StopIteration:
                rdone = True
        else:
            try:
                t = next(lit)
                lbuf.append(t)
                lrows += t.count_rows()
            except StopIteration:
                ldone = True
    if not (ldone or rdone):
        # both sides passed the sample limit: neither fits as a build
        # side, so both spill
        record["grace"] = True
        yield from _grace_join(plan, rbuf, rit, lbuf, lit)
        return
    if ldone and (not rdone) and lrows < rrows + 1:
        # the left side is the smaller: swap (inner only)
        record.update(build="left", swapped=True)
        yield from probe_loop(itertools.chain(rbuf, rit),
                              _stacked(lbuf, plan.left), True)
        return
    # default: build = right (drain the rest if not exhausted)
    allr = rbuf + (list(rit) if not rdone else [])
    yield from probe_loop(itertools.chain(lbuf, lit),
                          _stacked(allr, plan.right), False)


def _stream_right_join(plan: L.Join) -> Iterator[Table]:
    """Streaming RIGHT join: every right row emits once (with its
    matches) and unmatched left rows never do, so right-joining each
    right batch against the whole left side is exact. The left side
    builds under the grace budget; past it, both sides spill."""
    from ..ops.join import join_tables
    budget = CONFIG.join_build_budget_rows
    JOINS.append({"how": "right", "build": "left", "swapped": False,
                  "grace": False})
    lit = _stream(plan.left)
    lbuf: List[Table] = []
    rows = 0
    for t in lit:
        lbuf.append(t)
        rows += t.count_rows()
        if rows > budget:
            JOINS[-1]["grace"] = True
            yield from _grace_join(plan, [], _stream(plan.right), lbuf, lit)
            return
    build = _stacked(lbuf, plan.left)
    for t in _stream(plan.right):
        yield join_tables(build, t, plan.left_on, plan.right_on, "right",
                          plan.suffix, plan.join_nulls, plan.coalesce)


def _stream_full_join(plan: L.Join) -> Iterator[Table]:
    """Streaming FULL join: the right side is the build, left batches
    join with how='left' (full-join naming kept through the coalesce
    flag), and the build rows no left key matched are emitted once at
    the end (reference: `equi_join.rs:1075` EmitUnmatchedBuild). Memory
    is the build, one batch and the distinct left keys."""
    from ..api.frame import DataFrame
    from ..ops.join import join_tables
    coalesce = plan.coalesce if plan.coalesce is not None else False
    budget = CONFIG.join_build_budget_rows
    JOINS.append({"how": "full", "build": "right", "swapped": False,
                  "grace": False})
    rit = _stream(plan.right)
    rbuf: List[Table] = []
    rrows = 0
    for t in rit:
        rbuf.append(t)
        rrows += t.count_rows()
        if rrows > budget:
            JOINS[-1]["grace"] = True
            yield from _grace_join(plan, rbuf, rit)
            return
    build = _stacked(rbuf, plan.right)
    key_parts: List[Table] = []
    for t in _stream(plan.left):
        yield join_tables(t, build, plan.left_on, plan.right_on, "left",
                          plan.suffix, plan.join_nulls, coalesce)
        # this batch's distinct keys, for the unmatched-build pass
        key_parts.append(DataFrame._from_table(t).select(
            [_col(n) for n in plan.left_on]).unique(
                maintain_order=False)._table)
    lsch = plan.left.schema()
    if key_parts:
        merged_keys = DataFrame._from_table(
            key_parts[0] if len(key_parts) == 1
            else vstack_tables(key_parts)).unique(
                maintain_order=False)._table
    else:
        merged_keys = _empty(lsch, plan.left_on, build.device)
    # build rows whose key matches nothing on the left
    unmatched = join_tables(build, merged_keys, plan.right_on, plan.left_on,
                            "anti", plan.suffix, plan.join_nulls, None)
    if unmatched.count_rows():
        # right-only rows with nulls on the left: an empty-left full join
        # gives exactly that shape, names and coalescing
        yield join_tables(_empty(lsch, list(lsch), build.device), unmatched,
                          plan.left_on, plan.right_on, "full", plan.suffix,
                          plan.join_nulls, coalesce)


def _empty(schema, names, device) -> Table:
    from ..api.frame import DataFrame
    return DataFrame({n: [] for n in names},
                     schema={n: schema[n] for n in names},
                     device=device)._table


def _key_hash_spec(plan: L.Join):
    """Per key position, the form both sides hash their values in, so
    that equal values hash equally whatever each side stores them as
    (Int32 on the left, Int64 on the right, ...)."""
    from ..dtypes import Boolean
    ls, rs = plan.left.schema(), plan.right.schema()
    spec = []
    for ln, rn in zip(plan.left_on, plan.right_on):
        ld, rd = ls[ln], rs[rn]
        if ld.is_float or rd.is_float:
            spec.append("float")
        elif (ld.is_integer or ld == Boolean or ld.is_temporal) and \
                (rd.is_integer or rd == Boolean or rd.is_temporal):
            spec.append("int")
        else:
            spec.append("object")
    return spec


_NULL_HASH = 0x7F4A7C15


def _dict_hashes(sdict, device) -> torch.Tensor:
    """crc32 of each dictionary entry (a hash that does not depend on the
    dictionary's codes or on the process), on the device."""
    import zlib
    vals = sdict.values if sdict is not None else []
    h = np.fromiter(
        (zlib.crc32(v.encode("utf-8") if isinstance(v, str) else bytes(v))
         for v in vals), dtype=np.int64, count=len(vals))
    return torch.from_numpy(h).to(device)


def _partition_ids(t: Table, key_names, spec, P: int) -> torch.Tensor:
    """Each row's partition in [0, P) from its key values, hashed on the
    device (`ops/hashing.py`); a null key hashes to a constant."""
    from ..dtypes import Float64, Int64
    from ..ops.hashing import combine_hashes, fmix32, hash_array
    h = None
    for n, kind in zip(key_names, spec):
        c = t.cols[n]
        if kind == "float":
            x = c.data.to(torch.float64)
            x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")),
                            x)
            hk = hash_array(x, Float64)
        elif kind == "int":
            hk = hash_array(c.data.to(torch.int64), Int64)
        elif c.sdict is not None and c.data is not None:
            table = _dict_hashes(c.sdict, c.data.device)
            codes = c.data.to(torch.int64)
            ok = (codes >= 0) & (codes < table.numel())
            hk = fmix32(table[codes.clamp(0, max(table.numel() - 1, 0))]
                        if table.numel() else torch.zeros_like(codes))
            hk = torch.where(ok, hk, torch.full_like(hk, _NULL_HASH))
        else:
            raise NotImplementedError(
                f"grace join on a {c.dtype!r} key is not supported")
        if c.validity is not None:
            hk = torch.where(c.validity, hk, torch.full_like(hk, _NULL_HASH))
        h = hk if h is None else combine_hashes(h, hk)
    return h % P


def _strip_dicts(m, path: str, dicts: dict):
    """A column's metadata with each String dictionary replaced by the
    key its values are saved under."""
    dtype, sdict, _, has, fields = m
    if sdict is not None:
        dicts[path] = sdict.values
    return (dtype, path if sdict is not None else None, None, has,
            None if fields is None else tuple(
                (fn, _strip_dicts(fm, f"{path}/{fn}", dicts))
                for fn, fm in fields))


def _restore_dicts(m, dicts: dict):
    from ..strings import StringDict
    dtype, key, _, has, fields = m
    return (dtype, None if key is None else StringDict(dicts[key]), None,
            has, None if fields is None else tuple(
                (fn, _restore_dicts(fm, dicts)) for fn, fm in fields))


def _spill(t: Table, path: str):
    """Write the table's live rows to `path` as host tensors, with its
    String dictionaries' values; returns the metadata (names and dtypes)
    that `_unspill` reads them back with."""
    from ..ops.compact import compact
    from .compiled import _flatten_table
    t = compact(t)
    n = t.count_rows()
    flat, (colmeta, _, _, _, _) = _flatten_table(t)
    dicts: dict = {}
    colmeta = tuple((name, _strip_dicts(m, name, dicts))
                    for name, m in colmeta)
    torch.save({"tensors": {k: x[:n].cpu() for k, x in flat.items()
                            if not k.startswith("__")},
                "dicts": dicts}, path)
    COUNTS["spills"] += 1
    COUNTS["spilled_bytes"] += os.path.getsize(path)
    return colmeta, n


def _unspill(path: str, colmeta, n: int, device) -> Table:
    from ..config import capacity_for
    from ..ops.compact import grow_to
    from .compiled import _unflatten_table
    obj = torch.load(path, weights_only=False)
    flat = {k: x.to(device) for k, x in obj["tensors"].items()}
    colmeta = tuple((name, _restore_dicts(m, obj["dicts"]))
                    for name, m in colmeta)
    t = _unflatten_table(flat, (colmeta, n, n, False, device))
    return grow_to(t, capacity_for(n))


class _SpillFile:
    """Tables spilled one file each, read back in the order written."""

    def __init__(self, tmp: str, tag: str):
        self.tmp = tmp
        self.tag = tag
        self.paths: List[tuple] = []

    def append(self, t: Table) -> None:
        path = os.path.join(self.tmp, f"{self.tag}_{len(self.paths)}.pt")
        self.paths.append((path, *_spill(t, path)))

    def batches(self, device) -> Iterator[Table]:
        for path, colmeta, n in self.paths:
            yield _unspill(path, colmeta, n, device)

    def read_all(self, device) -> Table:
        parts = list(self.batches(device))
        return parts[0] if len(parts) == 1 else vstack_tables(parts)


def _grace_join(plan: L.Join, rbuf: List[Table], rit,
                lbuf: Optional[List[Table]] = None, lit=None
                ) -> Iterator[Table]:
    """Grace-hash join: both sides are hash-partitioned by key into spill
    files, then each partition pair is joined on its own: key-disjoint
    partitions make per-partition inner/left/semi/anti/right/full joins
    exact subsets of the whole join. Memory is one build partition and
    one probe batch (the reference's partitioned BuildState,
    `equi_join.rs:420`, taken out of core)."""
    import itertools
    from ..ops.join import join_tables
    P = max(2, CONFIG.join_grace_partitions)
    spec = _key_hash_spec(plan)
    tmp = tempfile.mkdtemp(prefix="pt_gracejoin_")
    device = None
    try:
        def spill_side(batches, key_names, tag):
            nonlocal device
            files = [_SpillFile(tmp, f"{tag}{p}") for p in range(P)]
            for t in batches:
                device = t.device
                if t.count_rows() == 0:
                    continue
                pid = _partition_ids(t, key_names, spec, P)
                live = t.row_mask()
                for p in range(P):
                    part = t.with_valid(live & (pid == p), None)
                    if part.count_rows():
                        files[p].append(part)
            return [f if f.paths else None for f in files]

        rfiles = spill_side(itertools.chain(rbuf, rit), plan.right_on, "r")
        del rbuf
        lbatches = itertools.chain(lbuf or [], lit) if lit is not None \
            else _stream(plan.left)
        lfiles = spill_side(lbatches, plan.left_on, "l")
        del lbuf
        if device is None:
            return
        lsch, rsch = plan.left.schema(), plan.right.schema()
        for p in range(P):
            lf, rf = lfiles[p], rfiles[p]
            if plan.how == "right":
                # right partition batches against the whole left
                # partition (right rows each emit exactly once)
                if rf is None:
                    continue
                build_l = lf.read_all(device) if lf is not None else \
                    _empty(lsch, list(lsch), device)
                for rt in rf.batches(device):
                    yield join_tables(build_l, rt, plan.left_on,
                                      plan.right_on, "right", plan.suffix,
                                      plan.join_nulls, plan.coalesce)
                continue
            if lf is None and not (plan.how == "full" and rf is not None):
                continue
            build = rf.read_all(device) if rf is not None else \
                _empty(rsch, list(rsch), device)
            if plan.how == "full":
                # a full join needs both sides of the partition whole
                lt = lf.read_all(device) if lf is not None else \
                    _empty(lsch, list(lsch), device)
                yield join_tables(lt, build, plan.left_on, plan.right_on,
                                  "full", plan.suffix, plan.join_nulls,
                                  plan.coalesce)
                continue
            for lt in lf.batches(device):
                yield join_tables(lt, build, plan.left_on, plan.right_on,
                                  plan.how, plan.suffix, plan.join_nulls,
                                  plan.coalesce)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --- the external sort -------------------------------------------------------

def _spill_rows() -> int:
    """Rows the external sort keeps in memory before it spills:
    batch_rows·4, or batch_rows when the host has less memory available
    than the process holds (the native probes)."""
    rows = max(CONFIG.batch_rows * 4, 1)
    from ..native import available_memory, process_rss
    avail, rss = available_memory(), process_rss()
    if avail > 0 and rss > 0 and avail < rss:
        rows = max(CONFIG.batch_rows, 1)
    return rows


def _stream_sort_external(plan: L.Sort) -> Iterator[Table]:
    """External sample sort: a larger-than-memory ORDER BY in three
    passes. Pass 1 streams batches to spill files (once past the row
    budget) while it samples an orderable 64-bit code of each row's
    first sort key (`ops/keycode.py` words, with descending and
    nulls_last applied). Splitters from the samples cut the key range
    into row-disjoint buckets; pass 2 reads each spill back and routes
    its rows to per-bucket files; pass 3 sorts each bucket in memory by
    every key and yields the buckets in order. Rows with equal first
    keys share a bucket, batch order is kept into the buckets and the
    in-bucket sort is stable, so the result is the in-memory sort's."""
    from ..expr.eval import eval_expr
    from ..ops.keycode import encode_key_words

    if any(not meta.is_elementwise(e) for e in plan.by):
        yield _materialize(plan)
        return

    if plan.by[0].kind == "col" and \
            plan.input.schema().get(plan.by[0].attrs["name"]) is not None \
            and plan.input.schema()[plan.by[0].attrs["name"]].is_string:
        # a String key's codes index each batch's own dictionary, so
        # they do not order rows across batches
        yield _materialize(plan)
        return

    def batch_keyword(t: Table) -> torch.Tensor:
        """(capacity,) int64 with the order of the first sort key's code:
        the null word, then the value's code (a 64-bit code's low two bits
        dropped: rows that tie on what is left share a bucket)."""
        v = eval_expr(plan.by[0], t, "select")
        validity = v.validity if v.validity is not None else \
            torch.ones(v.data.shape[0], dtype=torch.bool,
                       device=v.data.device)
        words = encode_key_words(v.data, v.dtype, validity,
                                 bool(plan.descending[0]),
                                 bool(plan.nulls_last[0]))
        if len(words) == 3:
            acc = (words[0] << 62) | (words[1] << 30) | (words[2] >> 2)
            # unsigned order as signed: flip the top bit
            return acc ^ torch.iinfo(torch.int64).min
        return (words[0] << 32) | words[1]

    tmp = tempfile.mkdtemp(prefix="pt_extsort_")
    try:
        spill_rows = _spill_rows()
        spills = _SpillFile(tmp, "spill")
        samples: List[np.ndarray] = []
        inmem: List[Table] = []
        total = 0
        device = None
        for t in _stream(plan.input):
            n = t.count_rows()
            if n == 0:
                continue
            device = t.device
            kw = batch_keyword(t)[t.row_mask()]
            stride = max(1, n // 64)
            samples.append(kw[::stride].cpu().numpy())
            total += n
            if not spills.paths and total <= spill_rows:
                inmem.append(t)
                continue
            for tb in inmem:
                spills.append(tb)
            inmem.clear()
            spills.append(t)
        if not spills.paths:
            if not inmem:
                yield _materialize(plan)
                return
            # the whole input fit: one in-memory sort, no disk round trip
            yield _sort_in_memory(plan, _stacked(inmem, plan.input))
            return
        bucket_rows = max(CONFIG.batch_rows, 1)
        P = max(1, min(64, -(-total // bucket_rows)))
        if P == 1 or len(spills.paths) == 1:
            yield _sort_in_memory(plan, spills.read_all(device))
            return
        allsamp = np.sort(np.concatenate(samples))
        qs = (np.arange(1, P) * len(allsamp)) // P
        splitters = torch.from_numpy(np.unique(allsamp[qs])).to(device)
        nb = splitters.numel() + 1
        buckets = [_SpillFile(tmp, f"bucket{b}") for b in range(nb)]
        for t in spills.batches(device):
            bid = torch.searchsorted(splitters, batch_keyword(t),
                                     right=True)
            live = t.row_mask()
            for b in range(nb):
                part = t.with_valid(live & (bid == b), None)
                if part.count_rows():
                    buckets[b].append(part)
        for b in buckets:
            if b.paths:
                yield _sort_in_memory(plan, b.read_all(device))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _sort_in_memory(plan: L.Sort, t: Table) -> Table:
    return _materialize(L.Sort(L.DataFrameScan(t), plan.by, plan.descending,
                               plan.nulls_last, plan.maintain_order, None))


# --- stateful window streaming -----------------------------------------------
# Two mechanisms (the reference's streaming nodes for cum_agg and shift):
#   * bounded lookback (shift/diff/pct_change/rolling_* by row count):
#     each batch is evaluated on [tail of the previous input ++ batch]
#     and the tail rows are sliced off, exact for any expression tree
#     whose nodes are elementwise or bounded-lookback windows;
#   * cumulative ops (cum_sum/min/max/prod/count at the top of the
#     expression): evaluated per batch, then combined with a carried
#     device scalar.

_CUM_COMBINE = {"cum_sum": "add", "cum_count": "add", "cum_prod": "mul",
                "cum_min": "min", "cum_max": "max"}


def _expr_lookback(e: Expr):
    """Rows of history output row i can depend on; None = unbounded."""
    k = e.kind
    if k == "window":
        op = e.attrs.get("op")
        if op in ("shift", "diff", "pct_change"):
            n = e.attrs.get("n", 1)
            if n < 0:
                return None  # look-ahead is not supported
            base = n
        elif op in ("rolling_sum", "rolling_mean", "rolling_min",
                    "rolling_max", "rolling_std", "rolling_var",
                    "rolling_median", "rolling_quantile", "rolling_skew",
                    "rolling_kurtosis"):
            base = int(e.attrs.get("window_size", 1)) - 1
        else:
            return None
        inner = _expr_lookback(e.children[0])
        return None if inner is None else base + inner
    from ..expr.meta import _NON_ELEMENTWISE
    if k in _NON_ELEMENTWISE:
        return None  # any other stateful/global op: unbounded
    best = 0
    for c in e.children:
        lb = _expr_lookback(c)
        if lb is None:
            return None
        best = max(best, lb)
    return best


class _StatefulWindowStreamer:
    """Per-batch evaluation of a select/with_columns whose expressions
    are bounded-lookback windows and/or top-level cumulative ops."""

    def __init__(self, kind, exprs, lookback_exprs, cum_specs,
                 max_lookback):
        self.kind = kind
        self.exprs = exprs                    # the user's order
        self.lookback_exprs = lookback_exprs  # evaluated with the tail
        self.cum_specs = cum_specs            # [(expr, out_name, combine)]
        self.K = max_lookback
        self.tail = None                      # the last K input rows
        self.carry = {}                       # out_name -> device scalar

    @classmethod
    def try_build(cls, exprs, kind):
        lookback_exprs, cum_specs = [], []
        max_lb = 0
        for e in exprs:
            if meta.is_elementwise(e):
                lookback_exprs.append(e)
                continue
            core = e
            while core.kind == "alias":
                core = core.children[0]
            if core.kind == "window" and \
                    core.attrs.get("op") in _CUM_COMBINE and \
                    not core.attrs.get("reverse") and \
                    meta.is_elementwise(core.children[0]):
                cum_specs.append((e, meta.output_name(e),
                                  _CUM_COMBINE[core.attrs["op"]]))
                continue
            lb = _expr_lookback(e)
            if lb is None:
                return None
            max_lb = max(max_lb, lb)
            lookback_exprs.append(e)
        if max_lb > (1 << 22):
            return None  # the tail would defeat streaming
        return cls(kind, list(exprs), lookback_exprs, cum_specs, max_lb)

    def step(self, t: Table) -> Table:
        from ..api.frame import DataFrame
        from ..ops.compact import compact, shrink_to, slice_rows
        # the batch compact at its own capacity bucket, as the lookback
        # leg's output (sliced past the tail) comes out
        t = compact(t)
        t = shrink_to(t, t.count_rows())
        # lookback leg: evaluate on [tail ++ batch], slice the tail off
        if self.K > 0 and self.tail is not None:
            th = self.tail.count_rows()
            ext = vstack_tables([self.tail, t])
        else:
            th = 0
            ext = t
        df = DataFrame._from_table(ext)
        if self.kind == "select":
            out = df.select(self.lookback_exprs)._table if \
                self.lookback_exprs else None
        else:
            out = df.with_columns(self.lookback_exprs)._table
        if out is not None and th:
            out = slice_rows(out, th, None)
        if self.kind == "select" and out is None:
            out = slice_rows(ext, th, None).select_columns([])
        # cumulative leg: evaluate on the raw batch, combine with carry
        if self.cum_specs:
            raw = DataFrame._from_table(t)
            cum_out = raw.select([e for e, _, _ in self.cum_specs])._table
            mask = t.row_mask()
            for _, name, comb in self.cum_specs:
                c = cum_out.column(name)
                data, validity = c.data, c.validity
                carry = self.carry.get(name)
                if carry is None:
                    data2 = data
                elif comb == "add":
                    data2 = data + carry
                elif comb == "mul":
                    data2 = data * carry
                elif comb == "min":
                    data2 = torch.minimum(data, carry)
                else:
                    data2 = torch.maximum(data, carry)
                # the new carry: the last live, valid combined value
                ok = mask if validity is None else (mask & validity)
                idx = torch.arange(data2.shape[0], device=data2.device)
                last = torch.where(ok, idx, torch.full_like(idx, -1)).max()
                cand = data2[last.clamp(0, data2.shape[0] - 1)]
                keep = carry if carry is not None else \
                    _cum_identity(comb, data2)
                self.carry[name] = torch.where(last >= 0, cand, keep)
                from ..batch import Column
                cum_out = cum_out.with_column(name, Column(
                    c.dtype, data2, validity, c.sdict))
            for _, name, _ in self.cum_specs:
                out = out.with_column(name, cum_out.column(name))
            # restore the user's column order: the expressions' (select),
            # or the input's with new columns after it (with_columns)
            order = [] if self.kind == "select" else list(t.names)
            for e in self.exprs:
                nm = meta.output_name(e)
                if nm in out.cols and nm not in order:
                    order.append(nm)
            out = out.select_columns(order)
        if self.K > 0:
            total = ext.count_rows()
            self.tail = slice_rows(ext, max(total - self.K, 0), None)
        return out


def _cum_identity(comb: str, like: torch.Tensor) -> torch.Tensor:
    dt = like.dtype
    if comb == "add":
        v = 0
    elif comb == "mul":
        v = 1
    elif dt.is_floating_point:
        v = float("inf") if comb == "min" else float("-inf")
    else:
        info = torch.iinfo(dt)
        v = info.max if comb == "min" else info.min
    return torch.full((), v, dtype=dt, device=like.device)


# --- the streaming group-by --------------------------------------------------

def _decompose_aggs(aggs: List[Expr]):
    """Rewrite each aggregate into (partial exprs, merge exprs, final
    expr). Returns None if any aggregate does not decompose."""
    partials: List[Expr] = []
    finals: List[Expr] = []
    merges: List[Expr] = []
    counter = [0]

    def fresh(prefix):
        counter[0] += 1
        return f"__pt_{prefix}_{counter[0]}"

    def rec(e: Expr) -> Optional[Expr]:
        if e.kind == "agg":
            name = e.attrs["agg"]
            if name in _DECOMPOSABLE:
                p, m = _DECOMPOSABLE[name]
                nm = fresh(name)
                partials.append(Expr("agg", e.children, agg=p, **{
                    kk: v for kk, v in e.attrs.items() if kk != "agg"}).alias(nm))
                merges.append(Expr("agg", (_col(nm),), agg=m).alias(nm))
                return _col(nm)
            if name == "mean":
                from ..expr.expr import lit, when
                ns, nc = fresh("msum"), fresh("mcnt")
                partials.append(Expr("agg", e.children, agg="sum").alias(ns))
                partials.append(Expr("agg", e.children, agg="count").alias(nc))
                merges.append(Expr("agg", (_col(ns),), agg="sum").alias(ns))
                merges.append(Expr("agg", (_col(nc),), agg="sum").alias(nc))
                # all-null group: count==0 -> null, not 0/0=NaN
                return when(_col(nc) > 0).then(_col(ns) / _col(nc)) \
                    .otherwise(lit(None))
            if name in ("std", "var"):
                from ..expr.expr import lit, when
                ddof = e.attrs.get("ddof", 1)
                x = e.children[0]
                ns, ns2, nc = fresh("vsum"), fresh("vsq"), fresh("vcnt")
                partials.append(Expr("agg", (x,), agg="sum").alias(ns))
                partials.append(Expr("agg", ((x * x),), agg="sum").alias(ns2))
                partials.append(Expr("agg", (x,), agg="count").alias(nc))
                for nm in (ns, ns2, nc):
                    merges.append(Expr("agg", (_col(nm),), agg="sum").alias(nm))
                var = (_col(ns2) - _col(ns) * _col(ns) / _col(nc)) / \
                    (_col(nc) - ddof)
                out = var.sqrt() if name == "std" else var
                return when(_col(nc) > ddof).then(out).otherwise(lit(None))
            return None
        if e.kind == "table_len":
            nm = fresh("len")
            partials.append(Expr("table_len").alias(nm))
            merges.append(Expr("agg", (_col(nm),), agg="sum").alias(nm))
            return _col(nm)
        if e.kind in ("alias", "name_map"):
            inner = rec(e.children[0])
            if inner is None:
                return None
            return Expr(e.kind, (inner,), **e.attrs)
        if e.kind in ("binary", "unary", "cast"):
            new_children = []
            for c in e.children:
                if c.kind == "lit":
                    new_children.append(c)
                    continue
                r = rec(c)
                if r is None:
                    return None
                new_children.append(r)
            return Expr(e.kind, tuple(new_children), **e.attrs)
        if e.kind == "lit":
            return e
        return None

    for a in aggs:
        nm = meta.output_name(a)
        f = rec(a)
        if f is None:
            return None
        finals.append(f.alias(nm))
    return partials, merges, finals


def _stream_group_by(plan: L.GroupBy) -> Optional[Table]:
    ins = plan.input.schema()
    keys = meta.expand_exprs(plan.keys, ins)
    aggs = meta.expand_exprs(plan.aggs, ins)
    if any(not (k.kind == "col" or meta.is_elementwise(k)) for k in keys):
        return None
    dec = _decompose_aggs(aggs)
    if dec is None:
        return None
    partials, merges, finals = dec
    key_names = [meta.output_name(k) for k in keys]

    # the elementwise chain feeding the group-by runs in the per-batch
    # partial aggregate's fused chain: one graph replay per batch
    from ..metrics import current
    from .compiled import run_fused
    qm = current()
    chain: List[L.Plan] = []
    src = plan.input
    while src.kind in ("select", "with_columns", "filter") and \
            _elem_ok(src):
        chain.append(src)
        src = src.input
    chain.reverse()
    gnode = L.GroupBy(plan.input, list(keys), list(partials), False)
    partial_tables: List[Table] = []
    for t in _stream(src):
        COUNTS["partials"] += 1
        partial_tables.append(_per_batch(
            qm, "group_by_partial", lambda b: run_fused(chain + [gnode], b),
            t))
    if not partial_tables:
        return None
    if len(partial_tables) == 1:
        merged = partial_tables[0]
    else:
        COUNTS["merges"] += 1
        stacked = vstack_tables(partial_tables)
        merged = _per_batch(qm, "group_by_merge", lambda b: run_fused(
            [L.GroupBy(plan.input, [_col(n) for n in key_names],
                       list(merges), False)], b), stacked)
    from ..api.frame import DataFrame
    return DataFrame._from_table(merged).select(
        [_col(n) for n in key_names] + finals)._table
