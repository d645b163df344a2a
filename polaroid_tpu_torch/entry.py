"""End-to-end certificates of the port's local and distributed surface.

The twins of the JAX package's driver entry points:

entry(): a forward step over the flagship pipeline, filter -> the
per-slot group-by (`parallel/shuffle.py` local_groupby), on tensors.

dryrun_multichip(n): the distributed surface on an n-slot mesh, each leg
against a host oracle: the sharded group-by per group, inner and left
joins with their row pairing, the wide-key group-by, the as-of join
(backward), the cross join, the coalesced full join, and (n even, >= 4)
the group-by on a 2 x n/2 mesh.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from .batch import resolve_device

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    """(fn, example_args): a forward step of the flagship pipeline, on
    the card unless `device` says otherwise."""
    dev = resolve_device(device)
    n = 8192

    def fn(price, volume, sym_code, valid):
        from .parallel.shuffle import local_groupby
        live = valid & (volume > 1000)
        notional = price * volume.to(price.dtype)
        gkey, (s_not, s_cnt, s_min, s_max), gvalid = local_groupby(
            sym_code.to(torch.int64), [notional, notional, price, price],
            live, ["sum", "count", "min", "max"])
        mean = s_not / s_cnt.clamp(min=1)
        return gkey, s_not, s_cnt, mean, s_min, s_max, gvalid

    rng = np.random.default_rng(0)
    price = torch.from_numpy(rng.uniform(1, 200, n).astype(np.float32))
    volume = torch.from_numpy(rng.integers(0, 5000, n))
    sym = torch.from_numpy(rng.integers(0, 64, n).astype(np.int32))
    valid = torch.ones(n, dtype=torch.bool)
    return fn, tuple(t.to(dev) for t in (price, volume, sym, valid))


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def dryrun_multichip(n_shards: int, device=None) -> None:
    """Run every leg of the distributed surface on an n_shards-slot mesh
    (all on `device` when given, else slot s on card s % cards) and hold
    each to its host oracle; raises AssertionError on a mismatch."""
    from . import LazyFrame, col
    from .parallel.mesh import make_mesh, make_mesh2
    from .parallel.shuffle import make_sharded_groupby, make_sharded_join

    mesh = make_mesh(n_shards, device=device)
    dev = mesh.home
    S = n_shards
    rows_per = 1024
    n = S * rows_per
    rng = np.random.default_rng(1)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # --- the group-by: partial aggregates, exchange, merge
    kh = rng.integers(0, 50, n).astype(np.int64)
    vh = rng.uniform(0, 10, n).astype(np.float32)
    mh = rng.uniform(size=n) > 0.1
    key, val, valid = put(kh), put(vh), put(mh)
    gb = make_sharded_groupby(mesh, ["sum", "count"], per_dest_cap=rows_per)
    gk, gv, dropped, s, c = gb(key, valid, val, val)
    assert int(dropped.sum()) == 0
    want = float(vh[mh].astype(np.float64).sum())
    gvh = _host(gv)
    np.testing.assert_allclose(float(_host(s)[gvh].sum()), want, rtol=1e-4)
    want_groups = {}
    for k, v, m in zip(kh.tolist(), vh.tolist(), mh.tolist()):
        if m:
            acc = want_groups.setdefault(k, [0.0, 0])
            acc[0] += v
            acc[1] += 1
    gk_h, s_h, c_h = _host(gk)[gvh], _host(s)[gvh], _host(c)[gvh]
    assert sorted(gk_h.tolist()) == sorted(want_groups), "group key sets"
    for k, sv, cv in zip(gk_h.tolist(), s_h.tolist(), c_h.tolist()):
        ws, wc = want_groups[k]
        assert cv == wc, (k, cv, wc)
        np.testing.assert_allclose(sv, ws, rtol=1e-4)

    # --- joins: inner, and left with its unmatched rows
    lkeys_h = rng.integers(0, 40, n).astype(np.int64)
    rk_h = rng.integers(0, 80, n).astype(np.int64)
    rvalid_h = rng.uniform(size=n) > 0.5
    lkey, rkey = put(lkeys_h), put(rk_h)
    lval = torch.arange(n, dtype=torch.int64, device=dev)
    rval = torch.arange(n, dtype=torch.int64, device=dev)
    lvalid = torch.ones(n, dtype=torch.bool, device=dev)
    rvalid = put(rvalid_h)
    rc = collections.Counter(rk_h[rvalid_h].tolist())
    by_key = collections.defaultdict(list)
    for k, v, m in zip(rk_h.tolist(), range(n), rvalid_h.tolist()):
        if m:
            by_key[k].append(v)
    for how, want_matches in (
            ("inner", sum(rc[k] for k in lkeys_h.tolist())),
            ("left", sum(max(rc[k], 1) for k in lkeys_h.tolist()))):
        out_cap = max(256 * rows_per, -(-(want_matches * 2) // S) * S)
        jn = make_sharded_join(mesh, 1, 1, per_dest_cap=n, out_cap=out_cap,
                               how=how)
        jk, jv, lm, rm, dropped, lo, ro = jn(lkey, lvalid, rkey, rvalid,
                                             lval, rval)
        assert int(dropped.sum()) == 0
        jvh = _host(jv)
        assert int(jvh.sum()) == want_matches, (how, int(jvh.sum()))
        if how == "left":
            n_un = int((jvh & ~_host(rm)).sum())
            assert n_un == sum(1 for k in lkeys_h.tolist() if rc[k] == 0)
        else:
            got_pairs = sorted(zip(_host(jk)[jvh].tolist(),
                                   _host(lo)[jvh].tolist(),
                                   _host(ro)[jvh].tolist()))
            want_pairs = sorted((k, i, r)
                                for i, k in enumerate(lkeys_h.tolist())
                                for r in by_key.get(k, ()))
            assert got_pairs == want_pairs, "inner join row pairing"

    def dist(lf):
        return lf.collect(engine="distributed", mesh=mesh)

    rng5 = np.random.default_rng(5)
    # (a) the wide-key group-by: two ~41-bit key columns take the salted
    # two-word route
    nw = 4 * rows_per
    base = 1 << 40
    k1 = rng5.integers(0, 1 << 10, nw).astype(np.int64) * (base >> 10)
    k2 = rng5.integers(0, 1 << 10, nw).astype(np.int64) * (base >> 10) \
        + base
    vw = rng5.integers(0, 100, nw).astype(np.int64)
    got_w = dist(LazyFrame({"k1": k1, "k2": k2, "v": vw}, device=dev)
                 .group_by(["k1", "k2"]).agg(
                     col("v").sum().alias("s"))) \
        .sort(["k1", "k2"]).to_dict()
    want_w = collections.Counter()
    for a_, b_, c_ in zip(k1.tolist(), k2.tolist(), vw.tolist()):
        want_w[(a_, b_)] += c_
    assert list(zip(got_w["k1"], got_w["k2"], got_w["s"])) == \
        sorted((a_, b_, s_) for (a_, b_), s_ in want_w.items()), \
        "wide-key group-by oracle"

    # (b) the as-of join, backward
    na, ma = 2048, 400
    trades_t = np.sort(rng5.integers(0, 100000, na))
    quotes_t = np.sort(rng5.integers(0, 100000, ma))
    px = rng5.uniform(1, 100, ma).round(3)
    got_a = dist(LazyFrame({"t": trades_t, "q": np.arange(na)}, device=dev)
                 .join_asof(LazyFrame({"t": quotes_t, "px": px}, device=dev),
                            on="t", strategy="backward")).to_dict()
    idx = np.searchsorted(quotes_t, trades_t, side="right") - 1
    want_px = [float(px[i]) if i >= 0 else None for i in idx]
    assert [None if v is None else round(float(v), 6)
            for v in got_a["px"]] == \
        [None if v is None else round(v, 6) for v in want_px], \
        "asof backward oracle"

    # (c) the cross join
    ca = rng5.integers(0, 100, 37).tolist()
    cb = rng5.integers(0, 100, 11).tolist()
    got_c = dist(LazyFrame({"a": ca}, device=dev).join(
        LazyFrame({"c": cb}, device=dev), how="cross")) \
        .sort(["a", "c"]).to_dict()
    assert list(zip(got_c["a"], got_c["c"])) == \
        sorted((x, y) for x in ca for y in cb), "cross oracle"

    # (d) the coalesced full join: the key set is the union, matched rows
    # pair up
    lk = rng5.integers(0, 60, 512)
    lv = np.arange(512)
    rk = rng5.integers(30, 90, 512)
    rv = np.arange(512) + 10000
    got_f = dist(LazyFrame({"k": lk, "lv": lv}, device=dev).join(
        LazyFrame({"k": rk, "rv": rv}, device=dev), on="k", how="full",
        coalesce=True)).to_dict()
    rby = collections.defaultdict(list)
    for k_, v_ in zip(rk.tolist(), rv.tolist()):
        rby[k_].append(v_)
    want_rows = []
    for k_, v_ in zip(lk.tolist(), lv.tolist()):
        want_rows += [(k_, v_, r_) for r_ in rby[k_]] or [(k_, v_, None)]
    lset = set(lk.tolist())
    for k_, vs in rby.items():
        if k_ not in lset:
            want_rows += [(k_, None, r_) for r_ in vs]
    assert sorted(zip(got_f["k"], got_f["lv"], got_f["rv"]), key=repr) == \
        sorted(want_rows, key=repr), "full-coalesce oracle"

    # --- the (hosts x chips) mesh: the group-by over the two-stage
    # exchange
    if n_shards >= 4 and n_shards % 2 == 0:
        mesh2 = make_mesh2(2, n_shards // 2, devices=mesh.devices)
        gb2 = make_sharded_groupby(mesh2, ["sum", "count"],
                                   per_dest_cap=rows_per)
        gk2, gv2, dropped2, s2, c2 = gb2(key, valid, val, val)
        assert int(dropped2.sum()) == 0
        np.testing.assert_allclose(float(_host(s2)[_host(gv2)].sum()), want,
                                   rtol=1e-4)
        assert sorted(_host(gk2)[_host(gv2)].tolist()) == \
            sorted(want_groups), "2-D mesh group key sets"
