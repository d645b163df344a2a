"""The distributed plan executor: row-sharded tables over a mesh of slots.

The port of the JAX package's `exec/distributed.py`. A sharded table is
the global table on the mesh's home device with a capacity that is a
multiple of S, so row block s is shard s. Elementwise stages (filter,
select, with_columns, windows, `.over()`) run on it through the frame
API, with their global meaning, as the JAX package's run under XLA's
SPMD partitioning. The breakers shard through `parallel/shuffle.py`:

  * group_by: per-slot partial aggregation, the exchange by key hash
    sized by an exact histogram, per-slot merge (`sharded`); aggregates
    that do not decompose move whole rows and aggregate whole groups
    (`exact`);
  * sort: a sample sort, whose splitters come from a sample of the
    packed key, its exchange sized by the exact histogram of the range
    partition, and a stable local sort per slot (`sample_sort`);
  * join: both sides exchanged by key hash, a merge join per slot
    (`sharded_join`); cross and as-of joins keep the left side sharded
    and run against the whole right side (`broadcast`);
  * distinct: rows exchanged by the packed subset key (`distinct`).

What does not shard runs in memory on the home device (`local`): plan
nodes the engine does not distribute, nested columns in a join or a
distinct, keys past 128 bits. Every route taken is counted in `ROUTES`;
`COUNTS` counts the exchanges, the bytes between slots, the largest
per-destination capacity and the records dropped (a result with drops
is refused).

Keys are packed into u64 words by bit budgets (`ops/keycode.py`): the
host reads each key column's code range once, the analogue of the
reference engine's sampling phase.
"""

from __future__ import annotations

import collections
from typing import List, Optional

import numpy as np
import torch

from ..batch import Column, Table, storage_torch_dtype
from ..config import capacity_for
from ..dtypes import Int64, UInt32, UInt64
from ..errors import ComputeError, InvalidOperationError
from ..expr import meta
from ..expr.eval import Val, eval_expr
from ..expr.expr import col as _col
from ..ops import compact as C
from ..ops.keycode import (U32, code_bits, column_bit_width,
                           decode_orderable, encode_orderable,
                           pack_keys_single_word, u64_to_signed,
                           unpack_keys_single_word)
from ..parallel import shuffle as SH
from ..parallel.mesh import Mesh, indexed_device, make_mesh
from ..plan import logical as L

__all__ = ["DistributedExecutor", "collect_distributed", "ROUTES",
           "COUNTS", "reset_counts"]

# route -> plan nodes that took it: "sharded" and "exact" (group-by),
# "sample_sort", "sharded_join", "broadcast" (cross and as-of joins),
# "distinct", "local" (run in memory); reset by callers that count them
ROUTES: collections.Counter = collections.Counter()
COUNTS = SH.COUNTS
_SIGN64 = -(1 << 63)


def reset_counts() -> None:
    ROUTES.clear()
    SH.reset_counts()


def _shard_table(t: Table, mesh: Mesh) -> Table:
    """The table on the mesh: its capacity padded to a multiple of S and
    its live rows as a mask. It must lie on the mesh's home device;
    nothing moves between devices silently."""
    if indexed_device(t.device) != mesh.home:
        raise ValueError(f"the frame lies on {t.device} and the mesh's home "
                         f"slot on {mesh.home}: build the mesh on the "
                         "frame's device")
    S = mesh.size
    cap = t.capacity
    if cap % S:
        t = C.grow_to(t, -(-cap // S) * S)
    return Table(list(t.names), dict(t.cols), t.capacity, None, t.row_mask(),
                 device=t.device)


def _full(v: Val, cap: int) -> torch.Tensor:
    return v.data if v.data.shape[0] == cap else v.data.expand(cap)


def _bit_budgets(key_vals: List[Val], cap: int):
    cols, dts, valids, bits, mins = [], [], [], [], []
    for v in key_vals:
        data = _full(v, cap)
        b, mn = column_bit_width(data, v.dtype, v.validity)
        cols.append(data)
        dts.append(v.dtype)
        valids.append(v.validity)
        bits.append(b)
        mins.append(mn)
    return cols, dts, valids, bits, mins


def _pack_key_vals(key_vals: List[Val], cap: int):
    """Exact u64 packing of key columns (one readback per column for its
    bit budget). Returns (packed, unpack_info)."""
    cols, dts, valids, bits, mins = _bit_budgets(key_vals, cap)
    if sum(bits) > 64:
        raise InvalidOperationError(
            f"distributed group keys need {sum(bits)} bits (> 64); "
            "reduce key cardinality or use the single-device engine")
    packed = pack_keys_single_word(cols, dts, valids, bits, mins)
    return packed, list(zip(key_vals, bits, mins))


def _pack_key_vals_wide(key_vals: List[Val], cap: int):
    """Two-word (<= 128-bit) exact packing: the key columns split
    greedily into a (hi, lo) u64 pair, lexicographic hi then lo. Returns
    (hi, lo, unpack_info_hi, unpack_info_lo)."""
    cols, dts, valids, bits, mins = _bit_budgets(key_vals, cap)
    split = used = 0
    for b in bits:
        if used + b > 64:
            break
        used += b
        split += 1
    if split == 0 or sum(bits[split:]) > 64:
        raise InvalidOperationError(
            f"distributed group keys need {sum(bits)} bits (> 128, or a "
            "single column over 64); reduce key cardinality or use the "
            "single-device engine")
    hi = pack_keys_single_word(cols[:split], dts[:split], valids[:split],
                               bits[:split], mins[:split])
    lo = pack_keys_single_word(cols[split:], dts[split:], valids[split:],
                               bits[split:], mins[split:])
    info = list(zip(key_vals, bits, mins))
    return hi, lo, info[:split], info[split:]


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical shift right of u64 bits held in int64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix128to64(hi: torch.Tensor, lo: torch.Tensor, salt: int
                ) -> torch.Tensor:
    """Salted 128 -> 64 bit mix (splitmix64's finalizer on each half),
    the JAX package's bits: int64 multiplies wrap as u64 ones do, and
    every right shift is masked. Not injective: callers check the data
    for collisions and re-salt."""
    m1 = u64_to_signed(0xBF58476D1CE4E5B9)
    m2 = u64_to_signed(0x94D049BB133111EB)

    def fmix64(x):
        x = (x ^ _srl(x, 30)) * m1
        x = (x ^ _srl(x, 27)) * m2
        return x ^ _srl(x, 31)
    s = 0x9E3779B97F4A7C15 * (salt + 1)
    return fmix64(hi ^ u64_to_signed(s)) ^ \
        u64_to_signed(0xA5A5A5A5A5A5A5A5) ^ fmix64(lo + u64_to_signed(s << 1))


def _collision_free(key64, hi, lo, mask) -> bool:
    """Whether key64 is injective over the live (hi, lo) pairs: sorted by
    key64, no two neighbours share it with different pairs (one
    readback). Dead rows take one sentinel triple and never flag."""
    full = torch.full_like(key64, -1)
    k = torch.where(mask, key64, full)
    sk, perm = torch.sort(k)
    h = torch.where(mask, hi, full)[perm]
    l2 = torch.where(mask, lo, full)[perm]
    bad = (sk[1:] == sk[:-1]) & ((h[1:] != h[:-1]) | (l2[1:] != l2[:-1]))
    return not bool(bad.any())


def _unpack_keys(packed: torch.Tensor, unpack_info) -> List[Val]:
    """Key columns (data + validity) from packed u64 group keys."""
    bits = [b for (_, b, _) in unpack_info]
    out = []
    for (v, b, mn), code in zip(unpack_info,
                                unpack_keys_single_word(packed, bits)):
        validity = code != 0
        u = code - 1 + u64_to_signed(mn)
        if code_bits(v.dtype) != 64:
            u = u & U32
        data = decode_orderable(u, v.dtype, False)
        out.append(Val(v.dtype, data,
                       validity if v.validity is not None else None,
                       v.sdict, False))
    return out


def _key_columns(keys, key_vals, gvalid):
    names, cols = [], {}
    for kx, kv in zip(keys, key_vals):
        nm = meta.output_name(kx)
        validity = kv.validity & gvalid if kv.validity is not None else None
        names.append(nm)
        cols[nm] = Column(kv.dtype, kv.data, validity, kv.sdict)
    return names, cols


def _by_first_row(res: Table, first: torch.Tensor) -> Table:
    """A group-by result with its groups in the order of their first
    rows (maintain_order=True)."""
    from ..ops.sort import sort_table
    order = Val(Int64, first.to(torch.int64), None, None, False)
    return sort_table(res, [order], [False], [False])


class DistributedExecutor:
    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh or make_mesh()
        self.S = self.mesh.size

    def execute(self, plan: L.Plan) -> Table:
        return self._exec(plan)

    def _local(self, plan: L.Plan) -> Table:
        from .executor import execute as exec_local
        ROUTES["local"] += 1
        return exec_local(plan)

    def _input(self, plan: L.Plan) -> Table:
        return _shard_table(self._exec(plan), self.mesh)

    def _exec(self, plan: L.Plan) -> Table:
        k = plan.kind
        if k in ("scan", "df_scan"):
            from .executor import execute as exec_local
            return _shard_table(exec_local(plan), self.mesh)
        if k in ("select", "with_columns", "filter"):
            t = self._exec(plan.input)
            from ..api.frame import DataFrame
            df = DataFrame._from_table(t)
            if k == "select":
                return df.select(plan.exprs)._table
            if k == "with_columns":
                return df.with_columns(plan.exprs)._table
            return df.filter(plan.predicate)._table
        if k == "group_by":
            return self._exec_group_by(plan)
        if k == "sort":
            return self._exec_sort(plan)
        if k == "join":
            return self._exec_join(plan)
        if k == "distinct":
            return self._exec_distinct(plan)
        if k == "slice":
            return C.slice_rows(self._exec(plan.input), plan.offset,
                                plan.length)
        if k == "union":
            from ..ops.concat import vstack_tables
            how = "vertical" if plan.how.startswith("vertical") \
                else "diagonal"
            ts = [self._exec(p) for p in plan.inputs]
            return _shard_table(vstack_tables([C.compact(t) for t in ts],
                                              how), self.mesh)
        if k == "map_function" and getattr(plan, "streamable", False):
            # a streamable map is exact per batch of left rows (the as-of
            # join: a lookup into its whole right side), so the left side
            # stays sharded and the map's build side is whole
            ROUTES["broadcast"] += 1
            return plan.fn(self._exec(plan.input))
        if k == "rename":
            return self._exec(plan.input).rename(plan.mapping, strict=False)
        if k == "drop":
            t = self._exec(plan.input)
            return t.drop_columns([n for n in plan.names if n in t.cols])
        return self._local(plan)

    # ------------------------------------------------------------------
    def _exec_group_by(self, plan: L.GroupBy) -> Table:
        from .streaming import _decompose_aggs
        t = self._input(plan.input)
        ins = dict(t.schema)
        keys = meta.expand_exprs(plan.keys, ins)
        aggs = meta.expand_exprs(plan.aggs, ins)
        dec = _decompose_aggs(aggs)
        if dec is not None:
            try:
                return self._exec_group_by_sharded(plan, t, keys, dec[0],
                                                   dec[2])
            except InvalidOperationError:
                pass
        # aggregates that do not decompose (median, quantile, n_unique,
        # first, last), and wide keys: whole rows to one slot per group
        try:
            return self._exec_group_by_exact(plan, t, keys, aggs)
        except InvalidOperationError:
            from ..ops.groupby import group_by_agg
            ROUTES["local"] += 1
            return group_by_agg(C.compact(t), keys, aggs,
                                plan.maintain_order)

    _EXACT_KINDS = {"sum", "min", "max", "count", "null_count", "any",
                    "all", "first", "last", "mean", "std", "var",
                    "median", "quantile", "n_unique"}

    def _exec_group_by_exact(self, plan, t, keys, aggs) -> Table:
        """The group-by of aggregates that do not decompose: rows (keys,
        the value columns they read, the global row index) exchanged by
        key hash so that every group lies whole on one slot, then
        aggregated exactly (`local_groupby_exact`)."""
        cap = t.capacity
        mask = t.row_mask()
        dev = t.device
        key_vals = [eval_expr(kx, t, "select") for kx in keys]
        wide = None
        try:
            packed, unpack_info = _pack_key_vals(key_vals, cap)
        except InvalidOperationError:
            # > 64 key bits: two-word packing, exchanged by a salted
            # 128 -> 64 mix checked collision-free on the data (re-salted
            # on a collision); the key words ride as first-aggregates
            hi, lo, info_hi, info_lo = _pack_key_vals_wide(key_vals, cap)
            packed = None
            for salt in range(8):
                cand = _mix128to64(hi, lo, salt)
                if _collision_free(cand, hi, lo, mask):
                    packed = cand
                    break
            if packed is None:
                raise InvalidOperationError(
                    "distributed wide-key group-by: no collision-free salt "
                    "found")
            wide = (hi, lo, info_hi, info_lo)

        ins = dict(t.schema)
        specs, out_names, out_dtypes, out_dicts = [], [], [], []
        vals, vvalids, vdicts = [], [], []
        vcache: dict = {}

        def value_index(inner) -> int:
            fp = inner.fingerprint()
            if fp not in vcache:
                v = eval_expr(inner, t, "agg")
                data = _full(v, cap)
                validity = v.valid_or_true()
                if validity.shape[0] != cap:
                    validity = validity.expand(cap)
                if v.live is not None:
                    validity = validity & v.live
                if data.dtype == torch.bool:
                    data = data.to(torch.int32)
                vcache[fp] = len(vals)
                vals.append(data.contiguous())
                vvalids.append(validity)
                vdicts.append(v.sdict)
            return vcache[fp]

        for a in aggs:
            e = a
            while e.kind in ("alias", "name_map"):
                e = e.children[0]
            sdict = None
            if e.kind == "table_len":
                specs.append({"kind": "len"})
            elif e.kind == "agg" and e.attrs.get("agg") in self._EXACT_KINDS:
                kind = e.attrs["agg"]
                inner = e.children[0]
                if not meta.is_elementwise(inner):
                    raise InvalidOperationError(
                        f"distributed exact agg over non-elementwise "
                        f"input {inner!r}")
                sp = {"kind": kind, "vi": value_index(inner)}
                if kind == "quantile":
                    sp["q"] = float(e.attrs.get("quantile",
                                                e.attrs.get("q", 0.5)))
                    sp["interp"] = e.attrs.get(
                        "interpolation", e.attrs.get("interp", "nearest"))
                if kind in ("std", "var"):
                    sp["ddof"] = int(e.attrs.get("ddof", 1))
                if kind in ("first", "last", "min", "max"):
                    sdict = vdicts[sp["vi"]]
                specs.append(sp)
            else:
                raise InvalidOperationError(
                    f"distributed exact agg {e.kind!r} not supported")
            out_names.append(meta.output_name(a))
            out_dtypes.append(meta.output_dtype(a, ins))
            out_dicts.append(sdict)

        n_user = len(specs)
        rowidx = torch.arange(cap, dtype=torch.int32, device=dev)
        if wide is not None:
            # the four u32 key words ride as first-aggregates (constant
            # within a group once collision-freedom is checked)
            for w64 in (wide[0], wide[1]):
                for shift in (32, 0):
                    vals.append((w64 >> shift) & U32)
                    vvalids.append(torch.ones(cap, dtype=torch.bool,
                                              device=dev))
                    specs.append({"kind": "first", "vi": len(vals) - 1})
        if plan.maintain_order:
            # each group's first row orders the result
            vals.append(rowidx)
            vvalids.append(torch.ones(cap, dtype=torch.bool, device=dev))
            specs.append({"kind": "first", "vi": len(vals) - 1})

        hist = SH.make_dest_hist(self.S)(packed, mask)
        per_dest = capacity_for(max(int(hist.max()), 1))
        fn = SH.make_sharded_groupby_exact(self.mesh, specs, len(vals),
                                           per_dest)
        outs = fn(packed, mask, rowidx, *vals, *vvalids)
        gkey, gvalid = outs[0], outs[1]
        _check_no_drops(outs[2], "group-by (exact)")
        flat = list(outs[3:])
        ROUTES["exact"] += 1

        out_cap = gkey.shape[0]
        if wide is not None:
            ws = [flat[2 * j] for j in range(n_user, n_user + 4)]
            key_out = _unpack_keys((ws[0] << 32) | ws[1], wide[2]) + \
                _unpack_keys((ws[2] << 32) | ws[3], wide[3])
        else:
            key_out = _unpack_keys(gkey, unpack_info)
        names, cols = _key_columns(keys, key_out, gvalid)
        for i, (nm, dt, sd) in enumerate(zip(out_names, out_dtypes,
                                             out_dicts)):
            data, ovalid = flat[2 * i], flat[2 * i + 1]
            stor = storage_torch_dtype(dt)
            if data.dtype != stor:
                data = data.to(stor)
            names.append(nm)
            cols[nm] = Column(dt, data, ovalid & gvalid, sd)
        res = Table(names, cols, out_cap, None, gvalid, device=dev)
        if plan.maintain_order:
            res = _by_first_row(res, flat[-2])
        return res

    def _exec_group_by_sharded(self, plan, t, keys, partials,
                               finals) -> Table:
        """The decomposable group-by: partial aggregates per slot,
        exchanged by key hash at the capacity of an exact histogram, and
        merged; the final expressions run over the merged partials."""
        cap = t.capacity
        mask = t.row_mask()
        dev = t.device
        ins = dict(t.schema)
        key_vals = [eval_expr(kx, t, "select") for kx in keys]
        packed, unpack_info = _pack_key_vals(key_vals, cap)

        agg_kinds, val_arrays = [], []
        # (name, kind, dtype, sdict, index of its valid-count partial)
        post = []

        def count_of(valid):
            return torch.where(valid, 1, 0).to(torch.int64).expand(cap)

        for p in partials:
            e = p.children[0] if p.kind == "alias" else p
            nm = meta.output_name(p)
            kind = e.attrs["agg"] if e.kind == "agg" else "len"
            out_dt = meta.output_dtype(p, ins)
            sdict, cnt_idx = None, None
            if kind == "len":
                # `expr.len()` counts the rows its operand keeps
                live = eval_expr(e.children[0], t, "agg").live \
                    if e.kind == "agg" else None
                val_arrays.append(torch.ones(cap, dtype=torch.int64,
                                             device=dev) if live is None
                                  else count_of(live))
                agg_kinds.append("sum")
            elif kind in ("count", "null_count", "sum", "min", "max",
                          "any", "all"):
                inner = eval_expr(e.children[0], t, "agg")
                valid = inner.valid_or_true()
                if inner.live is not None:
                    valid = valid & inner.live
                if kind in ("count", "null_count"):
                    val_arrays.append(count_of(valid if kind == "count"
                                               else ~valid))
                    agg_kinds.append("sum")
                elif kind == "sum":
                    # float partials add in f64, rounded once at the end
                    stor = storage_torch_dtype(out_dt)
                    data = _full(inner, cap).to(
                        torch.float64 if stor.is_floating_point else stor)
                    val_arrays.append(torch.where(
                        valid.expand(cap), data, data.new_zeros(())))
                    agg_kinds.append("sum")
                elif kind in ("min", "max"):
                    from ..expr.eval import _type_bounds
                    data = _full(inner, cap)
                    lo, hi = _type_bounds(data.dtype)
                    fill = hi if kind == "min" else lo
                    val_arrays.append(torch.where(valid.expand(cap), data,
                                                  torch.full_like(data, fill)))
                    agg_kinds.append(kind)
                    sdict = inner.sdict
                    # a group with no valid value gives null
                    cnt_idx = len(val_arrays)
                    val_arrays.append(count_of(valid))
                    agg_kinds.append("sum")
                else:  # any / all over the valid values
                    data = _full(inner, cap).to(torch.int32)
                    fill = 0 if kind == "any" else 1
                    val_arrays.append(torch.where(valid.expand(cap), data,
                                                  torch.full_like(data, fill)))
                    agg_kinds.append("max" if kind == "any" else "min")
            else:
                raise InvalidOperationError(
                    f"distributed agg {kind!r} not supported")
            post.append((nm, kind, out_dt, sdict, cnt_idx))
        first_idx = None
        if plan.maintain_order:
            # each group's first row orders the result
            first_idx = len(val_arrays)
            val_arrays.append(torch.arange(cap, dtype=torch.int64,
                                           device=dev))
            agg_kinds.append("min")

        # phase 1: partial aggregates and the exact (source, destination)
        # group counts; their max sizes phase 2's exchange
        p1 = SH.make_groupby_partials(self.mesh, agg_kinds)
        outs1 = p1(packed, mask, *val_arrays)
        per_dest = capacity_for(max(int(outs1[2].max()), 1))
        p2 = SH.make_groupby_merge(self.mesh, agg_kinds, per_dest)
        out = p2(outs1[0], outs1[1], *outs1[3:])
        gkey, gvalid = out[0], out[1]
        _check_no_drops(out[2], "group-by")
        parts = out[3:]
        ROUTES["sharded"] += 1

        out_cap = gkey.shape[0]
        names, cols = _key_columns(keys, _unpack_keys(gkey, unpack_info),
                                   gvalid)
        pi = 0
        for nm, kind, dt, sd, cnt_idx in post:
            arr = parts[pi]
            pi += 1
            validity = None
            if cnt_idx is not None:
                validity = parts[pi] > 0
                pi += 1
            if kind in ("any", "all"):
                arr = arr != 0
            arr = arr.to(storage_torch_dtype(dt))
            names.append(nm)
            cols[nm] = Column(dt, arr, validity, sd)
        merged = Table(names, cols, out_cap, None, gvalid, device=dev)
        from ..api.frame import DataFrame
        key_names = [meta.output_name(kx) for kx in keys]
        res = DataFrame._from_table(merged).select(
            [_col(n) for n in key_names] + finals)._table
        if first_idx is not None:
            res = _by_first_row(res, parts[first_idx])
        return res

    # ------------------------------------------------------------------
    def _exec_sort(self, plan: L.Sort) -> Table:
        """The sample sort: the sort keys packed into one u64 word
        (descending keys by their inverted codes, null placement in the
        packing), splitters from a sample of it, rows range-partitioned
        by them and sorted stably per slot, so slot order is the global
        order. The exchange capacity is the exact histogram's max (the
        JAX package sizes it at the whole table's capacity, S^2 times the
        table per mesh)."""
        t = self._input(plan.input)
        cap = t.capacity
        mask = t.row_mask()
        dev = t.device
        if any(t.cols[n].is_nested for n in t.names):
            return self._local_sort(plan, t)
        key_vals = [eval_expr(b, t, "select") for b in plan.by]
        cols, dts, valids, bits, mins = [], [], [], [], []
        for v, desc in zip(key_vals, plan.descending):
            data, dt = _full(v, cap), v.dtype
            if desc:
                data = encode_orderable(data, dt, descending=True)
                dt = UInt64 if code_bits(dt) == 64 else UInt32
            b, mn = column_bit_width(data, dt, v.validity)
            cols.append(data)
            dts.append(dt)
            valids.append(v.validity)
            bits.append(b)
            mins.append(mn)
        if sum(bits) > 64:
            return self._local_sort(plan, t, key_vals)
        packed = pack_keys_single_word(cols, dts, valids, bits, mins,
                                       nulls_last=list(plan.nulls_last))

        # splitters from a sample of up to 1024 rows (host)
        S = self.S
        pick = torch.from_numpy(np.linspace(0, cap - 1, min(1024, cap))
                                .astype(np.int64)).to(dev)
        samp = packed[pick].cpu().numpy().view(np.uint64)
        msk = mask[pick].cpu().numpy()
        samp = np.sort(samp[msk]) if msk.any() else np.zeros(1, np.uint64)
        q = np.linspace(0, len(samp) - 1, S + 1).astype(int)[1:-1]
        split = torch.from_numpy(samp[q].view(np.int64).copy()).to(dev)
        # the range partition, by unsigned order (the sign bit flipped)
        dest = torch.searchsorted(split ^ _SIGN64, packed ^ _SIGN64) \
            .clamp(0, S - 1)
        per_dest = capacity_for(max(int(SH.dest_hist(S, dest, mask).max()),
                                    1))

        names = list(t.names)
        pays, slots = [], []
        for n in names:
            c = t.cols[n]
            pays.append(c.data)
            if c.validity is not None:
                pays.append(c.validity)
            slots.append((n, c, c.validity is not None))
        route = SH._router(self.mesh, per_dest, with_overflow=True)
        blocks = SH._shard_all(self.mesh, dest, packed, mask, *pays)
        k2, p2, v2, dropped = route(
            blocks[0], blocks[1],
            [[b[s] for b in blocks[3:]] for s in range(S)], blocks[2])
        _check_no_drops(torch.stack([d.to(dev) for d in dropped]), "sort")

        def step(key, pay, valid):
            perm = _sorted_perm(valid, key)
            return [valid[perm]] + [p[perm] for p in pay]
        res = SH._columns(SH.map_slots(self.mesh, step, k2, p2, v2))
        flat = [SH.unshard_rows(self.mesh, r) for r in res]
        valid2 = flat[0]
        cols_out = {}
        li = 1
        for n, c, hasv in slots:
            data = flat[li]
            li += 1
            validity = None
            if hasv:
                validity = flat[li]
                li += 1
            cols_out[n] = Column(c.dtype, data, validity, c.sdict)
        ROUTES["sample_sort"] += 1
        out = C.compact(Table(names, cols_out, valid2.shape[0], None, valid2,
                              device=dev))
        if plan.slice_ is not None and plan.slice_[0] == 0:
            out = C.slice_rows(out, 0, plan.slice_[1])
        return out

    def _local_sort(self, plan: L.Sort, t: Table, key_vals=None) -> Table:
        """The whole table sorted on the home device. The keys are
        evaluated over `t` itself, whose live rows need not be a prefix,
        so `t` (not its compaction) is sorted: `sort_table` reads its row
        mask and puts the dead rows last."""
        from ..ops.sort import sort_table
        ROUTES["local"] += 1
        key_vals = key_vals or [eval_expr(b, t, "select") for b in plan.by]
        out = sort_table(t, key_vals, plan.descending, plan.nulls_last)
        if plan.slice_ is not None and plan.slice_[0] == 0:
            out = C.slice_rows(out, 0, plan.slice_[1])
        return out

    # ------------------------------------------------------------------
    def _exec_distinct(self, plan) -> Table:
        """DISTINCT: rows exchanged by the packed subset key (nulls group
        as values); each slot flags its representatives, keep first/last
        by a global row index that rides along."""
        t = self._input(plan.input)
        subset = plan.subset or list(t.names)
        if any(t.cols[n].is_nested for n in t.names):
            return self._local_distinct(plan, t)
        cap = t.capacity
        dev = t.device
        key_vals = []
        for n in subset:
            c = t.column(n)
            key_vals.append(Val(c.dtype, c.data, c.validity, c.sdict, False))
        try:
            packed, _ = _pack_key_vals(key_vals, cap)
        except InvalidOperationError:
            return self._local_distinct(plan, t)
        valid = t.row_mask()
        h = SH.make_dest_hist(self.S)(packed, valid)
        per_dest = capacity_for(max(int(h.max()), 1))
        # survivors per slot <= its intake: keep that many rows of each
        out_cap = capacity_for(max(int(h.sum(0).max()), 1))
        rowidx = torch.arange(cap, dtype=torch.int32, device=dev)
        pays, slots = _side_payloads(t, t.names)
        uq = SH.make_sharded_unique(self.mesh, per_dest, plan.keep,
                                    len(pays), out_cap=out_cap)
        outs = uq(packed, valid, rowidx, *pays)
        flag = outs[0]
        _check_no_drops(outs[1], "distinct")
        names, cols = _unslot(slots, list(outs[3:]))
        ROUTES["distinct"] += 1
        out = Table(names, cols, flag.shape[0], None, flag, device=dev)
        if plan.maintain_order:
            out = _by_first_row(out, outs[2])
        return out

    def _local_distinct(self, plan, t: Table) -> Table:
        from ..ops.groupby import unique_table
        ROUTES["local"] += 1
        return unique_table(C.compact(t), plan.subset, plan.keep,
                            plan.maintain_order)

    # ------------------------------------------------------------------
    def _exec_join(self, plan: L.Join) -> Table:
        how = "full" if plan.how == "outer" else plan.how
        coalesce = plan.coalesce if plan.coalesce is not None \
            else how != "full"
        if how == "cross":
            # the left side stays sharded, the right side is whole
            from .executor import execute as exec_local
            from ..ops.join import cross_join
            ROUTES["broadcast"] += 1
            return cross_join(self._exec(plan.left), exec_local(plan.right),
                              plan.suffix)
        if how == "full" and coalesce:
            # the sharded full join uncoalesced, then each key pair merged
            # (the left key where the left side matched, else the right
            # key) and the right key columns dropped
            unco = L.Join(plan.left, plan.right, plan.left_on,
                          plan.right_on, "full", plan.suffix,
                          plan.join_nulls, False, plan.maintain_order)
            t = self._exec_join(unco)
            lnames = list(plan.left.schema().keys())
            cols = dict(t.cols)
            names = list(t.names)
            ones = torch.ones(t.capacity, dtype=torch.bool, device=t.device)
            for lo, ro in zip(plan.left_on, plan.right_on):
                rname = ro if (ro not in lnames and ro != lo) \
                    else f"{ro}{plan.suffix}"
                lc, rc = cols[lo], cols[rname]
                lv = lc.validity if lc.validity is not None else ones
                rv = rc.validity if rc.validity is not None else ones
                data = torch.where(lv, lc.data, rc.data.to(lc.data.dtype))
                cols[lo] = Column(lc.dtype, data, lv | rv, lc.sdict)
                del cols[rname]
                names.remove(rname)
            return Table(names, cols, t.capacity, t._nrows, t.valid,
                         nrows_dev=t.nrows_dev, device=t.device)
        if how not in ("inner", "left", "right", "full", "semi", "anti"):
            return self._local(plan)
        lt = self._input(plan.left)
        rt = self._input(plan.right)
        from ..ops.join import _key_vals, _unify_keys
        lv, rv = _unify_keys(_key_vals(lt, plan.left_on),
                             _key_vals(rt, plan.right_on))
        capL, capR = lt.capacity, rt.capacity
        combo = []
        for a, b in zip(lv, rv):
            data = torch.cat([_full(a, capL), _full(b, capR)])
            validity = None
            if a.validity is not None or b.validity is not None:
                validity = torch.cat([a.valid_or_true().expand(capL),
                                      b.valid_or_true().expand(capR)])
            combo.append(Val(a.dtype, data, validity, a.sdict, False))
        if any(lt.cols[n].is_nested for n in lt.names) or \
                any(rt.cols[n].is_nested for n in rt.names):
            # nested payloads do not ride the 1-D exchange
            return self._local(plan)
        try:
            packed_all, _ = _pack_key_vals(combo, capL + capR)
        except InvalidOperationError:
            return self._local(plan)
        return self._sharded_join(plan, lt, rt, lv, rv, packed_all[:capL],
                                  packed_all[capL:])

    def _sharded_join(self, plan: L.Join, lt: Table, rt: Table, lv, rv,
                      lpacked, rpacked) -> Table:
        """The join matrix (inner/left/right/full/semi/anti): both sides
        exchanged by key hash at the capacities of exact histograms, a
        merge join per slot with its unmatched rows, the output capacity
        from a counting pass. Rows whose null keys match nothing (without
        join_nulls) skip the exchange and are appended where the join
        kind keeps them."""
        mesh = self.mesh
        S = self.S
        how = "full" if plan.how == "outer" else plan.how
        coalesce = plan.coalesce if plan.coalesce is not None \
            else how != "full"
        lkeyv, rkeyv = lt.row_mask(), rt.row_mask()
        if not plan.join_nulls:
            for v in lv:
                if v.validity is not None:
                    lkeyv = lkeyv & v.validity
            for v in rv:
                if v.validity is not None:
                    rkeyv = rkeyv & v.validity
        hist = SH.make_dest_hist(S)
        lh = hist(lpacked, lkeyv)
        rh = hist(rpacked, rkeyv)
        l_cap = capacity_for(max(int(lh.max()), 1))
        r_cap = capacity_for(max(int(rh.max()), 1))
        ROUTES["sharded_join"] += 1

        if how in ("semi", "anti"):
            pays, slots = _side_payloads(lt, lt.names)
            semi_cap = capacity_for(max(int(lh.sum(0).max()), 1))
            join = SH.make_sharded_semi(mesh, l_cap, r_cap, how, len(pays),
                                        out_cap=semi_cap)
            outs = join(lpacked, lkeyv, rpacked, rkeyv, *pays)
            flag = outs[0]
            _check_no_drops(outs[1], how)
            names, cols = _unslot(slots, list(outs[2:]))
            out = Table(names, cols, flag.shape[0], None, flag,
                        device=lt.device)
            if how == "anti" and not plan.join_nulls:
                # left rows with a null key match nothing: they survive
                # the anti join without entering the exchange
                lnull = lt.row_mask() & ~lkeyv
                out = self._append_rows(out, lt.with_valid(lnull, None))
            return out

        cnt = SH.make_sharded_join_count(mesh, l_cap, r_cap, how)
        out_cap = capacity_for(max(int(cnt(lpacked, lkeyv, rpacked,
                                           rkeyv).max()), 1))
        # a right join keeps the right side's key columns, the others the
        # left side's
        if how == "right":
            l_names = [n for n in lt.names
                       if not (coalesce and n in plan.left_on)]
            r_names = list(rt.names)
        else:
            l_names = list(lt.names)
            r_names = [n for n in rt.names
                       if not (coalesce and n in plan.right_on)]
        lpays, lslots = _side_payloads(lt, l_names)
        rpays, rslots = _side_payloads(rt, r_names)
        join = SH.make_sharded_join(mesh, len(lpays), len(rpays), l_cap,
                                    out_cap, r_per_dest_cap=r_cap, how=how)
        outs = join(lpacked, lkeyv, rpacked, rkeyv, *lpays, *rpays)
        jvalid, lmatch, rmatch = outs[1], outs[2], outs[3]
        _check_no_drops(outs[4], how)
        flat = list(outs[5:])
        names, cols = [], {}
        li = 0
        taken = set()
        mask_left = how in ("right", "full")
        mask_right = how in ("left", "full")
        for side, slots in (("l", lslots), ("r", rslots)):
            for n, dt, sd, hasv in slots:
                data = flat[li]
                li += 1
                validity = None
                if hasv:
                    validity = flat[li]
                    li += 1
                match = lmatch if side == "l" else rmatch
                if (side == "l" and mask_left) or (side == "r" and mask_right):
                    validity = match if validity is None \
                        else validity & match
                out_name = n if n not in taken else f"{n}{plan.suffix}"
                taken.add(out_name)
                names.append(out_name)
                cols[out_name] = Column(dt, data, validity, sd)
        out = Table(names, cols, jvalid.shape[0], None, jvalid,
                    device=lt.device)
        # the unmatched rows of null keys, which skipped the exchange
        if not plan.join_nulls:
            if how in ("left", "full"):
                lnull = lt.row_mask() & ~lkeyv
                out = self._append_rows(out, _rename_to(
                    lt.with_valid(lnull, None), lslots,
                    names[:len(lslots)]))
            if how in ("right", "full"):
                rnull = rt.row_mask() & ~rkeyv
                out = self._append_rows(out, _rename_to(
                    rt.with_valid(rnull, None), rslots,
                    names[len(lslots):]))
        return out

    def _append_rows(self, out: Table, extra: Table) -> Table:
        """`extra`'s live rows appended to `out` (columns it lacks are
        all null), the result on the mesh again."""
        from ..batch import _empty_column
        from ..ops.concat import vstack_tables
        ex = C.compact(extra.select_columns(
            [n for n in extra.names if n in out.cols]))
        if ex.count_rows() == 0:
            return out
        cols = dict(ex.cols)
        for n in out.names:
            if n not in cols:
                base = _empty_column(out.cols[n].dtype, ex.capacity,
                                     out.device)
                cols[n] = Column(base.dtype, base.data,
                                 torch.zeros(ex.capacity, dtype=torch.bool,
                                             device=out.device),
                                 out.cols[n].sdict, lengths=base.lengths,
                                 fields=base.fields)
        ex2 = Table(list(out.names), {n: cols[n] for n in out.names},
                    ex.capacity, ex._nrows, None, nrows_dev=ex.nrows_dev,
                    device=out.device)
        return _shard_table(vstack_tables([C.compact(out), ex2]), self.mesh)


def _sorted_perm(valid: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """The stable permutation that sorts a slot's rows by (dead, key as
    u64) (kernel F over three words, padded to a power of two)."""
    from ..ops.merge_sort import merge_sort_words
    n = key.shape[0]
    npad = 1 << max(n - 1, 0).bit_length()
    words = [(~valid).to(torch.int64), (key >> 32) & U32, key & U32]
    if npad != n:
        words = [torch.cat([w, w.new_full((npad - n,), U32)])
                 for w in words]
    # pads sort after every row (their dead word is all ones)
    return merge_sort_words(words, 3, perm_only=True)[0][:n]


def _side_payloads(t: Table, names):
    """A side's columns as exchange payloads: each column's data, and its
    validity where it has one. Returns (payloads, slots)."""
    pays, slots = [], []
    for n in names:
        c = t.cols[n]
        pays.append(c.data)
        hasv = c.validity is not None
        if hasv:
            pays.append(c.validity)
        slots.append((n, c.dtype, c.sdict, hasv))
    return pays, slots


def _unslot(slots, flat):
    """The columns back from payloads laid out by `_side_payloads`."""
    names, cols = [], {}
    li = 0
    for n, dt, sd, hasv in slots:
        data = flat[li]
        li += 1
        validity = None
        if hasv:
            validity = flat[li]
            li += 1
        names.append(n)
        cols[n] = Column(dt, data, validity, sd)
    return names, cols


def _check_no_drops(dropped: torch.Tensor, what: str) -> None:
    """Refuse a result whose exchange dropped records (a capacity sized
    too small would lose rows silently)."""
    total = int(dropped.sum())
    COUNTS["dropped"] += total
    if total:
        raise ComputeError(
            f"distributed {what}: shuffle overflow dropped {total} records "
            "(per-destination capacity undersized); this is an engine "
            "sizing bug")


def _rename_to(t: Table, slots, out_names) -> Table:
    """A side's payload columns renamed to the join output's names."""
    mapping = {n: out for (n, _, _, _), out in zip(slots, out_names)
               if n != out}
    t = t.select_columns([n for (n, _, _, _) in slots])
    return t.rename(mapping) if mapping else t


def collect_distributed(plan: L.Plan, mesh: Optional[Mesh] = None) -> Table:
    return DistributedExecutor(mesh).execute(plan)
