"""Joins through the JAX package and through the port.

The same seeded numpy inputs go through `polaroid_tpu` (its CPU path:
the dense route where the key domains are small, the sort-merge routes
otherwise, with its Pallas merge-sort kernel in interpret mode) and
through `polaroid_tpu_torch` on the CPU (the card's routes, with the
kernels' plain versions). Values only move in a join, so every column is
compared bit for bit, Float64 too. Where the join order is unspecified
(expansions, the collocated route) both outputs are compared as row
multisets; the m:1 routes keep the left rows' order and are compared in
order. Each case asserts the route the port took (`join.ROUTES`).
"""

import functools
import struct

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
from polaroid_tpu_torch.ops import join as J
from polaroid_tpu_torch.testing import frame_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _fresh_reference_cache():
    """The JAX package's process-wide caches (its compiled chains, and
    its optimized plans keyed by the id of a table that may be freed)
    can hand this file's plans another frame's results; start the file
    with the first empty and keep the second from storing anything
    while it runs (`tests/test_torch_reference_caches.py`)."""
    from test_torch_reference_caches import fresh_reference_caches
    with fresh_reference_caches():
        yield


N = 2048
WORDS = [f"w{i:03d}" for i in range(60)]


def frames(cols, valid=None):
    """The same host data as a `polaroid_tpu` frame (nulls as None) and
    as the port's frame on the CPU."""
    valid = valid or {}
    rcols = {}
    for k, x in cols.items():
        if k in valid:
            rcols[k] = [(x[i].item() if hasattr(x[i], "item") else x[i])
                        if valid[k][i] else None for i in range(len(x))]
        else:
            rcols[k] = x
    tcols = {k: (list(x) if isinstance(x, np.ndarray) and x.dtype == object
                 else x) for k, x in cols.items()}
    tdf = frame_from_numpy(tcols, validity=valid, device="cpu")
    # a nullable column goes to the JAX package as a list: name its dtype
    schema = {k: getattr(ref, repr(tdf.schema[k])) for k in valid}
    return ref.DataFrame(rcols, schema=schema), tdf


def _cell(v):
    if isinstance(v, float):
        return ("f", struct.pack("<d", v))
    return (type(v).__name__, v)


def rows(df):
    d = df.to_dict()
    return list(d), [tuple(_cell(v) for v in r) for r in zip(*d.values())]


def same(got, want, ordered=False):
    """Schema, then rows bit for bit (as multisets unless `ordered`)."""
    assert {k: repr(v) for k, v in got.schema.items()} == \
        {k: repr(v) for k, v in want.schema.items()}
    gn, gr = rows(got)
    wn, wr = rows(want)
    assert gn == wn
    assert len(gr) == len(wr)
    if not ordered:
        gr, wr = sorted(gr, key=repr), sorted(wr, key=repr)
    assert gr == wr


def port_join(tl, tr, route, **kw):
    J.ROUTES.clear()
    out = tl.join(tr, **kw)
    assert dict(J.ROUTES) == {route: 1}, dict(J.ROUTES)
    return out


def _sides(n_left=N, n_right=N // 4, dom=300, seed=0, key_valid=False):
    """A left side with keys in [0, dom) and duplicates on both sides,
    payloads of several dtypes; nulls in the keys when `key_valid`."""
    rng = np.random.default_rng(seed)
    lcols = {"k": rng.integers(0, dom, n_left),
             "a": rng.normal(size=n_left),
             "s": np.array(WORDS, dtype=object)[rng.integers(0, 60, n_left)],
             "i": rng.integers(-50, 50, n_left).astype(np.int32)}
    rcols = {"k": rng.integers(0, dom, n_right),
             "b": rng.normal(size=n_right).astype(np.float32),
             "a": rng.normal(size=n_right)}
    lval = {"a": rng.random(n_left) < 0.9}
    rval = {"b": rng.random(n_right) < 0.9}
    if key_valid:
        lval["k"] = rng.random(n_left) < 0.9
        rval["k"] = rng.random(n_right) < 0.9
    return frames(lcols, lval), frames(rcols, rval)


EXPAND = {"inner": "dense_expand", "left": "dense_expand",
          "right": "sortmerge_expand", "full": "sortmerge_expand",
          "semi": "dense_semi_anti", "anti": "dense_semi_anti"}


@pytest.mark.parametrize("how", list(EXPAND))
@pytest.mark.parametrize("key_valid", [False, True])
def test_every_kind_over_duplicate_keys(how, key_valid):
    (rl, tl), (rr, tr) = _sides(seed=1, key_valid=key_valid)
    got = port_join(tl, tr, EXPAND[how], on="k", how=how)
    same(got, rl.join(rr, on="k", how=how), ordered=how in ("semi", "anti"))


@pytest.mark.parametrize("how", ["inner", "left", "full", "anti"])
def test_join_nulls_matches_nulls(how):
    (rl, tl), (rr, tr) = _sides(seed=2, key_valid=True)
    route = {"anti": "sortmerge_semi_anti"}.get(how, "sortmerge_expand")
    got = port_join(tl, tr, route, on="k", how=how, join_nulls=True)
    same(got, rl.join(rr, on="k", how=how, join_nulls=True),
         ordered=how == "anti")
    got = port_join(tl, tr, route, on="k", how=how, nulls_equal=True)
    same(got, rl.join(rr, on="k", how=how, nulls_equal=True),
         ordered=how == "anti")


def test_cross_join():
    (rl, tl), (rr, tr) = _sides(n_left=40, n_right=30, seed=3)
    tlm = tl.filter(pt.col("k") < 150)
    rlm = rl.filter(ref.col("k") < 150)
    got = port_join(tlm, tr, "cross", how="cross")
    same(got, rlm.join(rr, how="cross"), ordered=True)


def _keyed(dtype: str, n: int, rng, dom: int):
    """n keys of a dtype over about `dom` values, with the dtype's edge
    cases: negative and beyond-2^31 Int64, -0.0 and NaN Float64."""
    if dtype == "Int32":
        return (rng.integers(0, dom, n) - dom // 2).astype(np.int32)
    if dtype == "Int64":
        return rng.integers(0, dom, n) * (1 << 33) - (1 << 40)
    if dtype == "UInt32":
        return (rng.integers(0, dom, n) + (1 << 31) - 7).astype(np.uint32)
    if dtype == "Float64":
        x = rng.integers(0, dom, n) / 4.0
        x[:8] = [np.nan, -0.0, 0.0, np.nan, -0.0, 0.0, np.inf, -np.inf]
        return rng.permutation(x)
    if dtype == "String":
        return np.array(WORDS, dtype=object)[rng.integers(0, 60, n)]
    return rng.random(n) < 0.5


# (dtype, unique right keys?) -> the port's route for inner/left
KEY_ROUTES = {("Int32", True): "dense_m1", ("Int32", False): "dense_expand",
              ("Int64", True): "sortmerge_m1",
              ("Int64", False): "sortmerge_expand",
              ("UInt32", True): "dense_m1",
              ("UInt32", False): "dense_expand",
              ("Float64", True): "sortmerge_m1",
              ("Float64", False): "sortmerge_expand",
              ("String", True): "dense_m1",
              ("String", False): "dense_expand",
              ("Boolean", True): "dense_m1",
              ("Boolean", False): "dense_expand"}


@pytest.mark.parametrize("dtype", ["Int32", "Int64", "UInt32", "Float64",
                                   "String", "Boolean"])
@pytest.mark.parametrize("unique", [True, False])
@pytest.mark.parametrize("how", ["inner", "left"])
def test_key_dtypes(dtype, unique, how):
    rng = np.random.default_rng(len(dtype) * 2 + unique)
    lk = _keyed(dtype, N, rng, 200)
    # two Boolean keys: a few right rows keep the m:m output small
    rk = _keyed(dtype, 12 if dtype == "Boolean" else 600, rng, 200)
    if unique:
        if dtype == "Float64":
            rk = np.unique(rk.view(np.int64)).view(np.float64)
        else:
            rk = np.array(sorted(set(rk.tolist()), key=repr),
                          dtype=rk.dtype)
        rk = rng.permutation(rk)
    n_r = len(rk)
    lcols = {"k": lk, "a": rng.normal(size=N)}
    rcols = {"k": rk, "b": rng.integers(0, 9, n_r).astype(np.int32)}
    (rl, tl), (rr, tr) = frames(lcols), frames(rcols)
    got = port_join(tl, tr, KEY_ROUTES[dtype, unique], on="k", how=how)
    same(got, rl.join(rr, on="k", how=how), ordered=unique)


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi",
                                 "anti"])
def test_two_key_columns(how):
    rng = np.random.default_rng(5)
    lcols = {"k1": rng.integers(0, 8, N),
             "k2": np.array(WORDS, dtype=object)[rng.integers(0, 12, N)],
             "a": rng.normal(size=N)}
    rcols = {"k1": rng.integers(0, 8, 300),
             "k2": np.array(WORDS, dtype=object)[rng.integers(0, 12, 300)],
             "a": rng.normal(size=300)}
    (rl, tl) = frames(lcols, {"k2": rng.random(N) < 0.95})
    (rr, tr) = frames(rcols)
    got = port_join(tl, tr, EXPAND[how], on=["k1", "k2"], how=how)
    same(got, rl.join(rr, on=["k1", "k2"], how=how),
         ordered=how in ("semi", "anti"))
    if how == "inner":
        got = port_join(tl, tr, EXPAND[how], left_on=["k1", "k2"],
                        right_on=["k1", "k2"], suffix="_r")
        same(got, rl.join(rr, left_on=["k1", "k2"], right_on=["k1", "k2"],
                          suffix="_r"))


@pytest.mark.parametrize("how", ["inner", "left", "right", "full"])
@pytest.mark.parametrize("coalesce", [True, False])
def test_coalesce_and_suffix(how, coalesce):
    rng = np.random.default_rng(6)
    lcols = {"id": rng.integers(0, 100, 500), "v": rng.normal(size=500)}
    rcols = {"key": rng.integers(0, 100, 200), "v": rng.normal(size=200),
             "id": rng.integers(0, 5, 200)}
    (rl, tl), (rr, tr) = frames(lcols), frames(rcols)
    route = EXPAND[how]
    got = port_join(tl, tr, route, left_on="id", right_on="key", how=how,
                    coalesce=coalesce, suffix="_x")
    same(got, rl.join(rr, left_on="id", right_on="key", how=how,
                      coalesce=coalesce, suffix="_x"))


@pytest.mark.parametrize("validate,side_unique,ok", [
    ("1:1", "both", True), ("1:1", "left", False), ("1:m", "left", True),
    ("1:m", "right", False), ("m:1", "right", True), ("m:1", "left", False),
    ("m:m", "none", True)])
def test_validate(validate, side_unique, ok):
    rng = np.random.default_rng(7)
    lk = rng.permutation(500) if side_unique in ("both", "left") \
        else rng.integers(0, 100, 500)
    rk = rng.permutation(300) if side_unique in ("both", "right") \
        else rng.integers(0, 100, 300)
    (rl, tl) = frames({"k": lk, "a": np.arange(500)})
    (rr, tr) = frames({"k": rk, "b": np.arange(300)})
    if ok:
        same(tl.join(tr, on="k", validate=validate),
             rl.join(rr, on="k", validate=validate))
        lazy = tl.lazy().join(tr.lazy(), on="k", validate=validate)
        same(lazy.collect(), rl.join(rr, on="k"))
    else:
        with pytest.raises(pt.ComputeError, match="validation"):
            tl.join(tr, on="k", validate=validate)
        with pytest.raises(ref.ComputeError, match="validation"):
            rl.join(rr, on="k", validate=validate)
        with pytest.raises(pt.ComputeError, match="validation"):
            tl.lazy().join(tr.lazy(), on="k", validate=validate).collect()


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi",
                                 "anti", "cross"])
@pytest.mark.parametrize("empty", ["left", "right"])
def test_empty_side(how, empty):
    rng = np.random.default_rng(8)
    lcols = {"k": rng.integers(0, 20, 64), "a": rng.normal(size=64)}
    rcols = {"k": rng.integers(0, 20, 16), "b": rng.normal(size=16)}
    (rl, tl), (rr, tr) = frames(lcols), frames(rcols)
    if empty == "left":
        tl, rl = tl.filter(pt.col("k") < 0), rl.filter(ref.col("k") < 0)
    else:
        tr, rr = tr.filter(pt.col("k") < 0), rr.filter(ref.col("k") < 0)
    kw = {"how": how} if how == "cross" else {"on": "k", "how": how}
    same(tl.join(tr, **kw), rl.join(rr, **kw))


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi",
                                 "anti"])
def test_masked_inputs(how):
    (rl, tl), (rr, tr) = _sides(seed=9, key_valid=True)
    tlm = tl.filter(pt.col("i") > -20)
    rlm = rl.filter(ref.col("i") > -20)
    trm = tr.filter(pt.col("b") > -0.5)
    rrm = rr.filter(ref.col("b") > -0.5)
    got = port_join(tlm, trm, EXPAND[how], on="k", how=how)
    same(got, rlm.join(rrm, on="k", how=how))


def test_lazy_filter_above_join_is_pushed_down():
    (rl, tl), (rr, tr) = _sides(seed=10)
    q = tl.lazy().join(tr.lazy(), on="k", how="inner") \
        .filter((pt.col("i") > 0) & (pt.col("b") > 0))
    plan = q.explain()
    # both conjuncts went below the join, one to each side
    assert plan.index("FILTER") > plan.index("JOIN"), plan
    rq = rl.lazy().join(rr.lazy(), on="k", how="inner") \
        .filter((ref.col("i") > 0) & (ref.col("b") > 0))
    same(q.collect(), rq.collect())
    # left join: the right-side predicate stays above the join
    q = tl.lazy().join(tr.lazy(), on="k", how="left") \
        .filter(pt.col("b").is_null() | (pt.col("a") > 0))
    rq = rl.lazy().join(rr.lazy(), on="k", how="left") \
        .filter(ref.col("b").is_null() | (ref.col("a") > 0))
    same(q.collect(), rq.collect())


def test_self_join_shares_one_subplan():
    (rl, tl), _ = _sides(n_left=300, seed=11)
    lf = tl.lazy().filter(pt.col("i") > 0)
    q = lf.join(lf, on="k", how="inner")
    assert "CACHE" in q.explain()
    rlf = rl.lazy().filter(ref.col("i") > 0)
    same(q.collect(), rlf.join(rlf, on="k", how="inner").collect())


@pytest.mark.parametrize("unique", [True, False])
def test_join_then_group_by_and_sort(unique):
    rng = np.random.default_rng(12)
    lcols = {"user": rng.integers(0, 400, N), "amt": rng.normal(size=N)}
    rk = rng.permutation(400) if unique else rng.integers(0, 400, 400)
    rcols = {"user": rk, "country": rng.integers(0, 30, 400).astype(np.int32)}
    (rl, tl), (rr, tr) = frames(lcols), frames(rcols)
    q = tl.lazy().join(tr.lazy(), on="user").group_by("country").agg(
        pt.len().alias("n"), pt.col("amt").sum().alias("s"))
    rq = rl.lazy().join(rr.lazy(), on="user").group_by("country").agg(
        ref.len().alias("n"), ref.col("amt").sum().alias("s"))
    g, w = q.collect().sort("country"), rq.collect().sort("country")
    assert g.to_dict()["country"] == w.to_dict()["country"]
    assert g.to_dict()["n"] == w.to_dict()["n"]
    np.testing.assert_allclose(g.to_dict()["s"], w.to_dict()["s"],
                               rtol=1e-12)
    q = tl.lazy().join(tr.lazy(), on="user").sort(["country", "user", "amt"])
    rq = rl.lazy().join(rr.lazy(), on="user").sort(["country", "user",
                                                     "amt"])
    same(q.collect(), rq.collect(), ordered=True)


def test_key_stats_follow_the_live_rows():
    """Join a filtered frame, then the frame itself, on keys above the
    stats bucket (1024) against right keys 0..1023. The port's stats
    remember the live rows they were taken over; the JAX package caches
    the filtered frame's bounds on the shared Column and clips the later
    join's keys into the edge code, where they match key 1023: it returns
    all 3000 left rows, where 624 match (ROADMAP Queue 3)."""
    rng = np.random.default_rng(13)
    k = rng.integers(0, 5000, 3000)
    rk = rng.permutation(1024)
    (_, tl) = frames({"k": k, "a": np.arange(3000)})
    (_, tr) = frames({"k": rk, "b": rk * 10})
    first = tl.filter(pt.col("k") < 100).join(tr, on="k")
    out = port_join(tl, tr, "dense_m1", on="k").to_dict()
    lut = dict(zip(rk.tolist(), (rk * 10).tolist()))
    want = [(int(x), i, lut[int(x)]) for i, x in enumerate(k)
            if int(x) in lut]
    assert list(zip(out["k"], out["a"], out["b"])) == want
    assert len(want) == 624
    assert first.height == sum(1 for x, _, _ in want if x < 100)


@functools.lru_cache(maxsize=None)
def _phase10():
    """chip_smoke.py's join data (J1_1e7_NA_0_0's shape, seed 0) at
    2 * 10^5 rows, J1 at 2^17 orders x 2^16 users (the collocated
    route's key span must pass 2^16), on the CPU."""
    import chip_smoke as CS
    tables, dicts = CS.make_join_data(200_000, 0)
    j1 = CS.J1_ORDERS, CS.J1_USERS
    CS.J1_ORDERS, CS.J1_USERS = 1 << 17, 1 << 16
    try:
        small = CS.make_join_data(200_000, 0)[0]
    finally:
        CS.J1_ORDERS, CS.J1_USERS = j1
    tables["orders"], tables["users"] = small["orders"], small["users"]
    frames_ = CS.join_frames(pt, tables, dicts, "cpu")
    return CS, tables, dicts, frames_


@pytest.mark.parametrize("name", ["q1", "q2", "q3", "q4", "q5", "q5_full",
                                  "J1"])
def test_phase10_queries_match_their_oracles(name, monkeypatch):
    """chip_smoke.py's phase-10 queries on the CPU at 2 * 10^5 rows:
    each takes the route the smoke asserts on the card and passes the
    smoke's own numpy oracle, and gives the same bits again with every
    uninitialised torch allocation filled with garbage first (so no
    route reads memory it did not write)."""
    import torch
    from test_torch_sorted_groupby import _garbage
    CS, tables, dicts, f = _phase10()
    (lf, route), = [(q, r) for n, q, r, _, _ in CS.join_queries(pt, f)
                    if n == name]
    J.ROUTES.clear()
    out = lf.collect()
    assert dict(J.ROUTES) == {route: 1}
    assert CS.check_join(name, out, tables, dicts) > 0
    gen = torch.Generator().manual_seed(1)
    for alloc in ("empty", "empty_like", "empty_strided"):
        monkeypatch.setattr(torch, alloc, _garbage(getattr(torch, alloc),
                                                   gen))
    monkeypatch.setattr(torch.Tensor, "new_empty",
                        _garbage(torch.Tensor.new_empty, gen))
    again = CS.host_columns(lf.collect())
    monkeypatch.undo()
    for col, (data, validity) in CS.host_columns(out).items():
        assert data.tobytes() == again[col][0].tobytes(), col
        assert (validity is None) == (again[col][1] is None), col
        if validity is not None:
            assert np.array_equal(validity, again[col][1]), col


@pytest.mark.parametrize("key", ["uint32", "int64"])
def test_lookup_join_sorted_matches_jax(key):
    """The one-column lookup helper: (value, hit) aligned with the probe
    keys, through kernel F's plain version, against the JAX package's."""
    import jax.numpy as jnp
    import torch
    from polaroid_tpu.ops import join as RJ
    rng = np.random.default_rng(14)
    nb, npr = 700, 3000
    bkey = rng.permutation(5000)[:nb].astype(key)
    if key == "int64":
        bkey = bkey - 2500
    bval = rng.normal(size=nb).astype(np.float32)
    pkey = rng.choice(np.concatenate([bkey, bkey + 7000]), npr)
    tdt = pt.UInt32 if key == "uint32" else None
    gv, gh = J.lookup_join_sorted(torch.from_numpy(bkey.astype(np.int64)),
                                  torch.from_numpy(bval),
                                  torch.from_numpy(pkey.astype(np.int64)),
                                  key_dtype=tdt)
    wv, wh = RJ.lookup_join_sorted(jnp.asarray(bkey), jnp.asarray(bval),
                                   jnp.asarray(pkey))
    assert np.array_equal(gh.numpy(), np.asarray(wh))
    assert np.array_equal(gv.numpy().view(np.uint32),
                          np.asarray(wv).view(np.uint32))
    assert gh.sum() > 0 and (~gh).sum() > 0


def test_string_key_merges_follow_the_dictionaries():
    """A string key's dictionaries merge once per pair: a repeated join of
    the same frames reuses the left dictionary's last merge, a join with
    another right frame merges anew, and every answer matches the JAX
    package's."""
    rng = np.random.default_rng(15)
    words = np.array(WORDS, dtype=object)
    lcols = {"k": words[rng.integers(0, 40, N)], "a": rng.normal(size=N)}
    r1 = {"k": words[rng.permutation(60)[:30]],
          "b": rng.integers(0, 9, 30).astype(np.int32)}
    r2 = {"k": words[rng.permutation(60)[:45]],
          "b": rng.integers(0, 9, 45).astype(np.int32)}
    (rl, tl), (rr1, tr1), (rr2, tr2) = frames(lcols), frames(r1), frames(r2)
    ldict = tl._table.cols["k"].sdict
    got = port_join(tl, tr1, "dense_m1", on="k")
    first = ldict._last_merge
    assert first is not None and \
        first[0] == tr1._table.cols["k"].sdict.version
    same(got, rl.join(rr1, on="k"), ordered=True)
    same(port_join(tl, tr1, "dense_m1", on="k"), rl.join(rr1, on="k"),
         ordered=True)
    assert ldict._last_merge is first
    same(port_join(tl, tr2, "dense_m1", on="k"), rl.join(rr2, on="k"),
         ordered=True)
    assert ldict._last_merge[0] == tr2._table.cols["k"].sdict.version
    same(port_join(tl, tr1, "dense_m1", on="k"), rl.join(rr1, on="k"),
         ordered=True)
