"""The distributed engine of the port against in-memory collects.

Every query of tests/test_distributed.py goes through the port's
`collect(engine="distributed", mesh=make_mesh(8, device="cpu"))`, eight
shard slots on the CPU whose kernels run their plain versions, and is
held against the JAX package's in-memory collect and the port's own (the
JAX package's distributed programs cost seconds of `shard_map` compiles
each, so its builders are held to the port's in
tests/test_torch_parallel.py instead). Each query asserts the route its
breaker took. Tolerances: exact in keys, integers, strings, counts,
nulls and row sets; Float64 sums, means, std and quantiles within rtol
1e-12 (a decomposed aggregate adds its partials in another order).
Results are sorted where tests/test_distributed.py sorts them.
"""

import numpy as np
import pytest
import torch

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
from polaroid_tpu_torch.config import capacity_for
from polaroid_tpu_torch.exec import distributed as D
from polaroid_tpu_torch.parallel.mesh import make_mesh, make_mesh2


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


MESH = make_mesh(8, device="cpu")


def _lazy(pkg, data):
    return pkg.LazyFrame(data, device="cpu") if pkg is pt \
        else pkg.LazyFrame(data)


def _data():
    rng = np.random.default_rng(5)
    n = 4000
    return {"k": rng.integers(0, 40, n),
            "s": rng.choice(["aa", "bb", "cc", "dd"], n).tolist(),
            "v": rng.normal(0, 10, n),
            "w": rng.integers(-100, 100, n)}


DATA = _data()


def _join_data():
    rng = np.random.default_rng(11)
    n, m = 3000, 800
    lk = rng.integers(0, 600, n).astype(object)
    rk = rng.integers(0, 1000, m).astype(object)
    lk[rng.random(n) < 0.03] = None
    rk[rng.random(m) < 0.05] = None
    return ({"k": lk.tolist(), "lv": rng.uniform(0, 10, n).round(3).tolist()},
            {"k": rk.tolist(), "rv": rng.integers(-5, 5, m).tolist()})


LEFT, RIGHT = _join_data()


def _dist(lf, mesh=MESH):
    D.reset_counts()
    out = lf.collect(engine="distributed", mesh=mesh)
    assert D.COUNTS["dropped"] == 0
    return out


def _same(name, got: dict, want: dict, float_cols=()):
    assert list(got) == list(want), (name, list(got), list(want))
    for k in want:
        g, w = got[k], want[k]
        assert len(g) == len(w), (name, k)
        if k in float_cols:
            ga = np.array([np.nan if x is None else x for x in g], float)
            wa = np.array([np.nan if x is None else x for x in w], float)
            assert np.array_equal(np.isnan(ga), np.isnan(wa)), (name, k)
            ok = ~np.isnan(wa)
            np.testing.assert_allclose(ga[ok], wa[ok], rtol=1e-12,
                                       atol=1e-12, err_msg=f"{name} {k}")
        else:
            assert g == w, (name, k)


def _check(build, sort_keys=None, float_cols=(), route=None, *,
           frames=(DATA,), nulls_last=False, mesh=MESH):
    """build(pkg, *lazy frames) -> the query; its distributed collect
    held to both in-memory collects (each sorted by sort_keys, if
    given); `route` the ROUTES it must take."""
    q = build(pt, *[_lazy(pt, f) for f in frames])
    got = _dist(q, mesh)
    assert dict(D.ROUTES) == (route or {}), dict(D.ROUTES)
    mine = q.collect()
    theirs = build(ref, *[_lazy(ref, f) for f in frames]).collect()
    if sort_keys is not None:
        got = got.sort(sort_keys, nulls_last=nulls_last)
        mine = mine.sort(sort_keys, nulls_last=nulls_last)
        theirs = theirs.sort(sort_keys, nulls_last=nulls_last)
    got = got.to_dict()
    _same("in-memory", got, mine.to_dict(), float_cols)
    _same("reference", got, theirs.to_dict(), float_cols)
    return got


# ---------------------------------------------------------------------------
# group-bys
# ---------------------------------------------------------------------------

SHARDED = {"sharded": 1}
EXACT = {"exact": 1}


def test_groupby_int_key():
    _check(lambda pl, d: d.group_by("k").agg(
        pl.col("v").sum().alias("s"), pl.len().alias("n"),
        pl.col("w").min().alias("mn"), pl.col("w").max().alias("mx"),
        pl.col("v").mean().alias("m")), "k", ("s", "m"), SHARDED)


def test_groupby_string_key():
    _check(lambda pl, d: d.group_by("s").agg(
        pl.col("w").sum().alias("t"), pl.len().alias("n")), "s",
        route=SHARDED)


def test_groupby_multi_key():
    _check(lambda pl, d: d.group_by("k", "s").agg(
        pl.col("v").sum().alias("t")), ["k", "s"], ("t",), SHARDED)


def test_filter_then_groupby():
    _check(lambda pl, d: d.filter(pl.col("v") > 0)
           .with_columns((pl.col("v") * pl.col("w")).alias("vw"))
           .group_by("k").agg(pl.col("vw").sum().alias("t"),
                              pl.col("vw").count().alias("c")),
           "k", ("t",), SHARDED)


def test_groupby_std():
    _check(lambda pl, d: d.group_by("s").agg(
        pl.col("v").std().alias("sd"), pl.col("v").mean().alias("m")),
        "s", ("sd", "m"), SHARDED)


def test_groupby_exact_median_quantile():
    _check(lambda pl, d: d.group_by("k").agg(
        pl.col("v").median().alias("md"),
        pl.col("v").quantile(0.25, "linear").alias("q25"),
        pl.col("w").quantile(0.9, "lower").alias("q90l"),
        pl.col("v").quantile(0.5, "midpoint").alias("qm"),
        pl.col("v").quantile(0.75, "nearest").alias("qn")),
        "k", ("md", "q25", "qm", "qn", "q90l"), EXACT)


def test_groupby_exact_nunique_first_last():
    _check(lambda pl, d: d.group_by("s").agg(
        pl.col("w").n_unique().alias("nu"), pl.col("v").first().alias("f"),
        pl.col("v").last().alias("l")), "s", ("f", "l"), EXACT)


def test_groupby_exact_mixed_with_decomposable():
    _check(lambda pl, d: d.group_by("k").agg(
        pl.col("v").median().alias("md"), pl.col("v").sum().alias("sv"),
        pl.len().alias("n"), pl.col("w").min().alias("mn"),
        pl.col("v").mean().alias("mu"), pl.col("v").std().alias("sd")),
        "k", ("md", "sv", "mu", "sd"), EXACT)


def test_groupby_exact_with_nulls():
    rng = np.random.default_rng(11)
    n = 2000
    v = rng.normal(0, 5, n).tolist()
    for i in range(0, n, 7):
        v[i] = None
    data = {"k": rng.integers(0, 16, n).tolist(), "v": v}
    _check(lambda pl, d: d.group_by("k").agg(
        pl.col("v").median().alias("md"), pl.col("v").n_unique().alias("nu"),
        pl.col("v").first().alias("f")), "k", ("md", "f"), EXACT,
        frames=(data,))


def test_groupby_maintain_order_both_routes():
    """maintain_order=True: groups in the order of their first rows, on
    the sharded and the exact route."""
    for aggs, route in ((lambda pl: [pl.col("v").sum().alias("s")], SHARDED),
                        (lambda pl: [pl.col("v").first().alias("f")], EXACT)):
        _check(lambda pl, d: d.group_by("k", maintain_order=True)
               .agg(aggs(pl)), None, ("s", "f"), route)


def test_groupby_min_max_of_all_null_groups():
    data = {"k": [1, 1, 2, 2, 3], "x": [None, None, 4, None, 5],
            "s": ["b", None, None, None, "a"]}
    _check(lambda pl, d: d.group_by("k").agg(
        pl.col("x").min().alias("mn"), pl.col("x").max().alias("mx"),
        pl.col("s").max().alias("smax")), "k", route=SHARDED,
        frames=(data,))


def test_groupby_of_filtered_aggregates():
    """`expr.filter` inside an aggregate narrows sum, min, max and count
    alike on the sharded route."""
    _check(lambda pl, d: d.group_by("k").agg(
        pl.col("v").filter(pl.col("w") > 0).sum().alias("s"),
        pl.col("w").filter(pl.col("v") > 0).min().alias("mn"),
        pl.col("w").filter(pl.col("v") > 0).max().alias("mx"),
        pl.col("v").filter(pl.col("w") > 50).count().alias("c")),
        "k", ("s",), SHARDED)


def test_groupby_wide_keys():
    """Two ~41-bit key columns: the salted two-word route."""
    rng = np.random.default_rng(12)
    n = 4096
    base = 1 << 40
    data = {"k1": rng.integers(0, 1 << 12, n) * (base // (1 << 12)),
            "k2": rng.integers(0, 1 << 12, n) * (base // (1 << 12)) + base,
            "v": rng.normal(0, 5, n)}
    _check(lambda pl, d: d.group_by("k1", "k2").agg(
        pl.col("v").sum().alias("s"), pl.len().alias("n"),
        pl.col("v").median().alias("m")), ["k1", "k2"], ("s", "m"), EXACT,
        frames=(data,))


def test_union_then_groupby():
    _check(lambda pl, d: pl.concat([d.filter(pl.col("w") > 50),
                                    d.filter(pl.col("w") < -50)])
           .group_by("s").agg(pl.len().alias("n")), "s", route=SHARDED)


# ---------------------------------------------------------------------------
# sorts
# ---------------------------------------------------------------------------

SORT = {"sample_sort": 1}


def _check_sort(build, key_cols, frames=(DATA,), mesh=MESH):
    """A sort bit for bit against the port's stable in-memory sort, and
    its key columns (and its rows as a set) against the JAX package's."""
    q = build(pt, *[_lazy(pt, f) for f in frames])
    got = _dist(q, mesh)
    assert dict(D.ROUTES) == SORT, dict(D.ROUTES)
    got = got.to_dict()
    _same("in-memory", got, q.collect().to_dict())
    theirs = build(ref, *[_lazy(ref, f) for f in frames]).collect().to_dict()
    for k in key_cols:
        assert got[k] == theirs[k], k
    rows = sorted(zip(*[got[k] for k in got]), key=repr)
    assert rows == sorted(zip(*[theirs[k] for k in theirs]), key=repr)


def test_sort():
    _check_sort(lambda pl, d: d.sort("w", maintain_order=True), ["w"])


def test_sort_desc_and_top_k():
    _check_sort(lambda pl, d: d.sort("v", descending=True).head(25), ["v"])


def test_sort_multi_key():
    _check_sort(lambda pl, d: d.sort(["k", "w"], maintain_order=True),
                ["k", "w"])


@pytest.mark.parametrize("desc", [False, True])
def test_sort_nulls_last(desc):
    rng = np.random.default_rng(7)
    n = 1000
    v = rng.integers(0, 50, n).tolist()
    for i in range(0, n, 11):
        v[i] = None
    data = {"v": v, "x": list(range(n))}
    _check_sort(lambda pl, d: d.sort("v", descending=desc, nulls_last=True,
                                     maintain_order=True), ["v"],
                frames=(data,))


def test_sample_sort_sized_by_its_histogram_on_a_skewed_key():
    """90% of the rows share one key: the exchange capacity is the exact
    histogram's max (far below the JAX package's whole-table capacity),
    nothing is dropped, and the sort is the in-memory one."""
    rng = np.random.default_rng(13)
    n = 4096
    k = np.where(rng.uniform(size=n) < 0.9, 17, rng.integers(0, 1000, n))
    data = {"k": k, "x": np.arange(n)}
    _check_sort(lambda pl, d: d.sort("k", maintain_order=True), ["k"],
                frames=(data,))
    cap = capacity_for(n)
    assert 0 < D.COUNTS["per_dest_cap"] < cap
    # one source shard's rows, at most, for any destination
    assert D.COUNTS["per_dest_cap"] == capacity_for(cap // 8)


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------

JOIN = {"sharded_join": 1}


def _cmp_join(build):
    """The join's rows as a set (every column sorted, nulls last)."""
    q = build(pt, _lazy(pt, LEFT), _lazy(pt, RIGHT))
    cols = q.collect().columns
    _check(build, cols, ("lv",), JOIN, frames=(LEFT, RIGHT),
           nulls_last=True)


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi",
                                 "anti"])
def test_join_matrix(how):
    kw = {"coalesce": False} if how == "full" else {}
    _cmp_join(lambda pl, a, b: a.join(b, on="k", how=how, **kw))


@pytest.mark.parametrize("how", ["left", "full", "anti"])
def test_join_matrix_join_nulls(how):
    kw = {"coalesce": False} if how == "full" else {}
    _cmp_join(lambda pl, a, b: a.join(b, on="k", how=how, join_nulls=True,
                                      **kw))


def test_full_join_coalesced():
    _cmp_join(lambda pl, a, b: a.join(b, on="k", how="full", coalesce=True))


def test_join_then_groupby():
    dim = {"k": list(range(40)), "name": [f"g{i}" for i in range(40)]}
    _check(lambda pl, d, e: d.join(e, on="k").group_by("name")
           .agg(pl.len().alias("n")), "name",
           route={"sharded_join": 1, "sharded": 1}, frames=(DATA, dim))


def test_sharded_join_orders_users():
    rng = np.random.default_rng(6)
    n, m = 4000, 1500
    orders = {"user_id": rng.integers(0, 2000, n).tolist(),
              "amount": rng.uniform(1, 100, n).round(2).tolist(),
              "flag": (rng.random(n) > 0.5).tolist()}
    users = {"user_id": rng.choice(2000, m, replace=False).tolist(),
             "country": rng.choice(["CH", "DE", "FR"], m).tolist()}
    _check(lambda pl, a, b: a.join(b, on="user_id", how="inner"),
           ["user_id", "amount", "flag", "country"], ("amount",), JOIN,
           frames=(orders, users))


def test_join_nulls_strings_suffix():
    left = {"k": ["a", "b", None, "c", "a"], "v": [1, 2, 3, 4, 5]}
    right = {"k": ["a", "c", None], "v": [10, 20, 30]}
    for kw in ({}, {"join_nulls": True}, {"coalesce": False}):
        got = _check(lambda pl, a, b: a.join(b, on="k", how="inner", **kw),
                     ["k", "v"], route=JOIN, frames=(left, right),
                     nulls_last=True)
    assert "k_right" in got


def test_cross_join():
    left = {"a": [1, 2, 3, 4, 5], "b": ["x", "y", "z", "w", "v"]}
    right = {"c": [10, 20, 30]}
    got = _check(lambda pl, a, b: a.join(b, how="cross"), ["a", "c"],
                 route={"broadcast": 1}, frames=(left, right))
    assert len(got["a"]) == 15


def test_asof_join():
    rng = np.random.default_rng(9)
    n, m = 3000, 800
    trades = {"t": np.sort(rng.integers(0, 100000, n)).tolist(),
              "qty": rng.integers(1, 100, n).tolist()}
    quotes = {"t": np.sort(rng.integers(0, 100000, m)).tolist(),
              "px": rng.uniform(1, 100, m).round(3).tolist()}
    _check(lambda pl, a, b: a.join_asof(b, on="t", strategy="backward"),
           route={"broadcast": 1}, frames=(trades, quotes))


def test_asof_join_by():
    rng = np.random.default_rng(10)
    n, m = 3000, 900
    syms = ["A", "B", "C"]
    trades = {"s": rng.choice(syms, n).tolist(),
              "t": np.sort(rng.integers(0, 50000, n)).tolist(),
              "qty": rng.integers(1, 100, n).tolist()}
    quotes = {"s": rng.choice(syms, m).tolist(),
              "t": np.sort(rng.integers(0, 50000, m)).tolist(),
              "px": rng.uniform(1, 100, m).round(3).tolist()}
    _check(lambda pl, a, b: a.join_asof(b, on="t", by="s",
                                        strategy="backward"),
           route={"broadcast": 1}, frames=(trades, quotes))


# ---------------------------------------------------------------------------
# distinct, windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keep", ["any", "first", "last", "none"])
def test_distinct(keep):
    _check(lambda pl, d: d.unique(subset=["k", "s"], keep=keep),
           ["k", "s", "v"], ("v",), {"distinct": 1})


def test_distinct_maintain_order():
    _check(lambda pl, d: d.unique(subset=["k"], keep="first",
                                  maintain_order=True), None, ("v",),
           {"distinct": 1})


def test_window_over_partition():
    _check(lambda pl, d: d.with_columns(
        pl.col("v").sum().over("k").alias("ps"),
        pl.col("v").rank().over("k").alias("rk"),
        pl.col("v").cum_sum().over("k").alias("cs"),
        pl.col("v").shift(1).over("k").alias("sh"),
        pl.col("w").max().over(["k", "s"]).alias("mx2")),
        None, ("v", "ps", "cs", "sh"))


def test_rolling_and_rank_global():
    _check(lambda pl, d: d.sort("w", maintain_order=True).with_columns(
        pl.col("v").rolling_mean(7).alias("rm"),
        pl.col("v").rank("dense").alias("dr"),
        pl.col("v").cum_max().alias("cm")), None, ("v", "rm", "cm"), SORT)


# ---------------------------------------------------------------------------
# the mesh and the entry point
# ---------------------------------------------------------------------------

def test_engine_on_a_2d_mesh():
    rng = np.random.default_rng(3)
    n = 3000
    data = {"k": rng.integers(0, 50, n).tolist(),
            "v": rng.normal(0, 5, n).tolist()}
    dim = {"k": list(range(0, 100, 2)), "w": list(range(50))}
    m2 = make_mesh2(2, 4, device="cpu")
    _check(lambda pl, d: d.filter(pl.col("v") > -5).group_by("k").agg(
        pl.col("v").sum().alias("s"), pl.len().alias("c")), "k", ("s",),
        SHARDED, frames=(data,), mesh=m2)
    _check_sort(lambda pl, d: d.sort("v", descending=True), ["v"],
                frames=(data,), mesh=m2)
    _check(lambda pl, d, e: d.join(e, on="k", how="left"), ["k", "v"],
           ("v",), JOIN, frames=(data, dim), mesh=m2)


def test_shuffle_overflow_refused(monkeypatch):
    """A per-destination capacity forced too small: the exchange counts
    the drops and the engine refuses the result."""
    from polaroid_tpu_torch.errors import ComputeError
    monkeypatch.setattr(D, "capacity_for", lambda n: 1)
    rng = np.random.default_rng(3)
    lf = pt.LazyFrame({"k": rng.integers(0, 64, 512),
                       "v": rng.normal(0, 1, 512)}, device="cpu")
    with pytest.raises(ComputeError, match="overflow"):
        lf.group_by("k").agg(pt.col("v").median().alias("m")) \
            .collect(engine="distributed", mesh=MESH)


def test_engine_affinity_and_the_default_mesh(monkeypatch):
    """CONFIG.engine_affinity = "distributed" reaches the engine, whose
    default mesh (a slot per card) raises without a card; a mesh whose
    home slot is not the frame's device raises too."""
    lf = pt.LazyFrame({"k": [1, 2, 2]}, device="cpu").group_by("k") \
        .agg(pt.len())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pt.CONFIG, "engine_affinity", "distributed")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lf.collect()
    monkeypatch.setattr(pt.CONFIG, "engine_affinity", "auto")
    with pytest.raises(ValueError, match="home slot"):
        lf.collect(engine="distributed",
                   mesh=make_mesh(2, devices=["meta", "meta"]))


# ---------------------------------------------------------------------------
# sorts whose key needs more than 64 bits run on the home device
# ---------------------------------------------------------------------------

def _wide_sort_data():
    """A Float64 key of quarter units (any order of addition sums it
    exactly) beside an integer key, a join key and a list column."""
    rng = np.random.default_rng(21)
    n = 3000
    return {"f": (rng.integers(-400, 400, n) / 4.0),
            "v": rng.integers(-50, 50, n),
            "k": rng.integers(0, 300, n),
            "l": [[int(x), int(x) + 1] for x in rng.integers(0, 9, n)]}


WIDE = _wide_sort_data()
WIDE_DIM = {"k": np.arange(0, 300, 3), "g": np.arange(100) % 7}


def _wide_filter(d, e):
    return d.drop("l").filter(pt.col("v") > 0).sort("f", "v")


def _wide_join(d, e):
    return d.drop("l").join(e, on="k").sort("f", "g", "v")


def _wide_groupby(d, e):
    return d.group_by("k").agg(pt.col("f").sum().alias("sf"),
                               pt.col("v").sum().alias("sv")) \
        .sort("sf", "k")


def _wide_nested(d, e):
    return d.filter(pt.col("v") > 0).sort("f", maintain_order=True)


def _np_filter_sorted():
    keep = WIDE["v"] > 0
    f, v = WIDE["f"][keep], WIDE["v"][keep]
    order = np.lexsort((v, f))
    return {"f": f[order].tolist(), "v": v[order].tolist()}


@pytest.mark.parametrize("case, build, route, keys", [
    ("filter", _wide_filter, {"local": 1}, ["f", "v"]),
    ("join", _wide_join, {"sharded_join": 1, "local": 1}, ["f", "g", "v"]),
    ("groupby", _wide_groupby, {"sharded": 1, "local": 1}, ["sf", "k"]),
    ("nested", _wide_nested, {"local": 1}, ["f"]),
])
def test_sort_past_64_bits_after_a_breaker(case, build, route, keys):
    """A filter, a sharded join and a sharded group-by leave holes in the
    live rows; the sort past 64 bits that follows (a Float64 key plus
    one more), and the sort of a table with a List column, run on the
    home device and come back in numpy's stable order, equal to the
    port's in-memory collect."""
    lf = build(pt.LazyFrame(WIDE, device="cpu"),
               pt.LazyFrame(WIDE_DIM, device="cpu"))
    got = _dist(lf)
    assert dict(D.ROUTES) == route, dict(D.ROUTES)
    got = got.to_dict()
    assert got == lf.collect().to_dict()
    order = np.lexsort(tuple(np.asarray(got[k]) for k in reversed(keys)))
    assert np.array_equal(order, np.arange(len(order)))
    if case == "filter":
        assert {k: got[k] for k in ("f", "v")} == _np_filter_sorted()
    if case == "nested":
        keep = WIDE["v"] > 0
        order = np.argsort(WIDE["f"][keep], kind="stable")
        assert got["v"] == WIDE["v"][keep][order].tolist()
        assert got["l"] == [WIDE["l"][i] for i in
                            np.nonzero(keep)[0][order]]
