"""The streaming engine (`exec/streaming.py`) against the JAX package's.

Every branch of `_stream` the port keeps runs over a union of in-memory
frames (`concat` of lazy frames, each input one batch), made from numpy
seeds, through `collect(engine="streaming")` of both packages and the
port's in-memory collect. Keys, integers, strings, extremes and nulls
agree exactly; Float64 within rtol 1e-12 (a decomposed mean or sum adds
in another order), and a decomposed std or var within the bound of its
sum-of-squares formula. `batch_rows`, `join_sample_limit` and
`join_build_budget_rows` are set small where a test needs the spill
paths. Streamed file scans and sinks are held in tests/test_torch_io.py.
"""

import math

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
from polaroid_tpu_torch.exec import streaming as ST


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


SIZES = (150, 90, 210, 60)
REF_SIZES = (128, 128)
TAGS = np.array([f"t{i}" for i in range(8)])


def _part(seed, n, null_keys=False):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 20, n)
    x = rng.uniform(-50, 50, n)
    xm = rng.uniform(size=n) < 0.9
    km = rng.uniform(size=n) < 0.9 if null_keys else np.ones(n, bool)
    return {"id": (rng.permutation(n) + seed * 1000).tolist(),
            "k": [int(a) if m else None for a, m in zip(k, km)],
            "s": list(TAGS[rng.integers(0, len(TAGS), n)]),
            "x": [float(a) if m else None for a, m in zip(x, xm)],
            "v": rng.integers(0, 1000, n).tolist()}


def _parts(seed, sizes=SIZES, null_keys=False):
    return [_part(seed * 100 + i, n, null_keys) for i, n in enumerate(sizes)]


def _union(pkg, parts):
    kw = {"device": "cpu"} if pkg is pt else {}
    return pkg.concat([pkg.DataFrame(p, **kw).lazy() for p in parts])


def _dict(df, sort_by=None):
    d = df.to_dict()
    if sort_by:
        n = len(next(iter(d.values())))
        key = [d[c] for c in sort_by]
        order = sorted(range(n), key=lambda i: tuple(
            (v[i] is None, v[i] if v[i] is not None else 0) for v in key))
        d = {c: [v[i] for i in order] for c, v in d.items()}
    return d


def _same(got, want, what, bound=None):
    assert list(got) == list(want), (what, list(got), list(want))
    for c in want:
        a, b = got[c], want[c]
        assert len(a) == len(b), (what, c, len(a), len(b))
        if any(isinstance(y, float) for y in b if y is not None):
            for y, z in zip(a, b):
                assert (y is None) == (z is None), (what, c)
                if z is None or y == z or (math.isnan(z) and math.isnan(y)):
                    continue
                lim = bound[c](z) if bound and c in bound else 1e-12 * abs(z)
                assert abs(y - z) <= lim, (what, c, y, z)
        else:
            assert a == b, (what, c)


def _ref_streaming(lf):
    from polaroid_tpu.exec import compiled
    compiled._CACHE.clear()
    return lf.collect(engine="streaming")


def _check(make, seed, sort_by=None, bound=None, with_ref=True,
           null_keys=False, sizes=SIZES, ref_order=False):
    """make(pkg, union) -> lazy frame over the union of the seed's frames.
    The port's streaming collect against its in-memory collect, on frames
    of `sizes` rows; and, on frames of whole capacity buckets
    (REF_SIZES), also against the JAX package's streaming collect, whose
    cached programs keep the row count of the first batch of a capacity
    (ROADMAP Queue 3); with `ref_order`, in the port's column order.
    Returns the port's streaming result and counts on the `sizes`
    frames."""
    ST.reset_counts()
    parts = _parts(seed, sizes, null_keys)
    lf = make(pt, _union(pt, parts))
    got = lf.collect(engine="streaming")
    counts = dict(ST.COUNTS)
    _same(_dict(got, sort_by), _dict(lf.collect(), sort_by), "in-memory",
          bound)
    if with_ref:
        parts = _parts(seed, REF_SIZES, null_keys)
        lf = make(pt, _union(pt, parts))
        g = _dict(lf.collect(engine="streaming"), sort_by)
        _same(g, _dict(lf.collect(), sort_by), "in-memory", bound)
        r = _dict(_ref_streaming(make(ref, _union(ref, parts))), sort_by)
        if ref_order:
            r = {c: r[c] for c in g}
        _same(g, r, "jax streaming", bound)
    return got, counts


def test_group_by_decomposes_every_aggregate():
    def make(pl, u):
        c = pl.col
        return u.group_by("k").agg(
            pl.len().alias("n"), c("x").count().alias("cnt"),
            c("x").null_count().alias("nulls"), c("v").sum().alias("vs"),
            c("x").min().alias("lo"), c("x").max().alias("hi"),
            c("x").mean().alias("mean"), c("v").first().alias("first"),
            c("v").last().alias("last"),
            (c("x") * c("v")).sum().alias("xv"),
            ((c("x") * c("v")).sum() / c("v").sum()).alias("vwap"))
    got, counts = _check(make, 1, sort_by=["k"])
    assert counts["batches"] == len(SIZES)
    assert counts["partials"] == len(SIZES) and counts["merges"] == 1


def _var_bound(n_rows, scale):
    """|var - var'| for (S2 - S^2/n)/(n - 1) from f64 sums: a few
    n 2^-53 S2 over n - 1, S2 <= n scale^2."""
    return lambda z: 8 * n_rows * n_rows * scale ** 2 * 2.0 ** -53


def test_group_by_std_and_var_from_sums_of_squares():
    def make(pl, u):
        c = pl.col
        return u.group_by("s").agg(c("x").std().alias("sd"),
                                   c("x").var().alias("var"),
                                   c("x").mean().alias("m"))
    n = sum(SIZES)
    b = _var_bound(n, 50.0)
    _check(make, 2, sort_by=["s"],
           bound={"var": b, "sd": lambda z: b(z) / max(z, 1e-300)})


def test_elementwise_chain_then_head_stops_early():
    def make(pl, u):
        c = pl.col
        return u.filter(c("v") > 100).with_columns(
            (c("x") * 2).alias("x2")).select("k", "x2", "s").head(200)
    got, counts = _check(make, 3)
    assert got.height == 200
    # 150 + 90 rows, 90% of them past the filter, reach 200 in the second
    # or third batch, never the last
    assert counts["batches"] < len(SIZES)


def test_union_and_with_row_index():
    got, counts = _check(lambda pl, u: u.with_row_index("i"), 4)
    assert got.get_column("i").to_list() == list(range(sum(SIZES)))
    assert counts["batches"] == len(SIZES)


def test_top_k_and_bottom_k_across_batches():
    # tie-free keys: the JAX package's top_k is not stable
    _check(lambda pl, u: u.top_k(7, by="id"), 5)
    _check(lambda pl, u: u.bottom_k(5, by=["k", "id"]), 6)


@pytest.mark.parametrize("keep", ["first", "last"])
def test_distinct_folds_incrementally(monkeypatch, keep):
    monkeypatch.setattr(pt.CONFIG, "batch_rows", 64)
    monkeypatch.setattr(ref.CONFIG, "batch_rows", 64)
    _check(lambda pl, u: u.unique(subset=["k", "s"], keep=keep,
                                  maintain_order=True).select("k", "s", "v"),
           7, with_ref=keep == "first")


def test_distinct_keep_none_across_batches():
    parts = _parts(8)
    got, _ = _check(lambda pl, u: u.unique(subset=["k", "s"], keep="none")
                    .select("k", "s"), 8, sort_by=["k", "s"])
    seen = {}
    for p in parts:
        for a, b in zip(p["k"], p["s"]):
            seen[a, b] = seen.get((a, b), 0) + 1
    assert got.height == sum(1 for c in seen.values() if c == 1)


def test_stateful_windows_stream_across_batches():
    def make(pl, u):
        c = pl.col
        return u.with_columns(
            c("v").cum_sum().alias("cs"), c("v").cum_max().alias("cm"),
            c("x").rolling_mean(3).alias("rm"), c("v").shift(1).alias("sh"),
            c("v").diff().alias("d"), c("k").cast(pl.Float64)
            .pct_change().alias("pc"))
    # the JAX package puts the cumulative columns last (ROADMAP Queue 3)
    got, _ = _check(make, 9, ref_order=True)
    assert got.columns[-6:] == ["cs", "cm", "rm", "sh", "d", "pc"]


def test_stateful_select_keeps_the_users_order():
    def make(pl, u):
        c = pl.col
        return u.select(c("v").shift(2).alias("a"), c("v").cum_sum()
                        .alias("b"), (c("x") + 1).alias("c"))
    got, _ = _check(make, 10)
    assert got.columns == ["a", "b", "c"]


def test_map_function_streams_per_batch():
    sizes = []

    def make(pl, u):
        def fn(df):
            sizes.append(df.height)
            return df.with_columns((pl.col("v") + 1).alias("w"))
        return u.map_batches(fn, streamable=True)
    _check(make, 11, with_ref=False)
    # the stream's batches, then the in-memory collect's one table
    assert sizes == list(SIZES) + [sum(SIZES)]


def _right(pl, n=15, seed=12, strings=False):
    rng = np.random.default_rng(seed)
    keys = rng.permutation(25)[:n]
    d = {"k": keys.tolist(), "w": rng.integers(0, 9, n).tolist()}
    if strings:
        d["s"] = list(TAGS[rng.integers(0, len(TAGS), n)])
    kw = {"device": "cpu"} if pl is pt else {}
    return pl.DataFrame(d, **kw).lazy()


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti", "right",
                                 "full"])
def test_joins_against_a_small_build_side(how):
    # one JAX comparison per streaming join branch (inner/semi/anti share
    # left's, but left builds under the row budget)
    got, counts = _check(
        lambda pl, u: u.join(_right(pl), on="k", how=how), 13,
        with_ref=how in ("inner", "left", "right", "full"),
        sort_by=["k", "v", "x", "s"] if how not in ("right",) else
        ["k", "w", "v", "x"])
    record = ST.JOINS[0]
    assert not record["grace"]
    if how in ("inner", "left", "semi", "anti", "full"):
        assert record["build"] == "right"


def test_inner_join_swaps_to_the_smaller_left_side(monkeypatch):
    monkeypatch.setattr(pt.CONFIG, "join_sample_limit", 100)
    monkeypatch.setattr(ref.CONFIG, "join_sample_limit", 100)

    def make(pl, u):
        big = _union(pl, _parts(15))
        return u.select("k", "s", pl.col("v").alias("lv")).join(
            big, on="k", suffix="_r")
    got, _ = _check(make, 14, sort_by=["k", "s", "lv", "id", "x"],
                    sizes=(20, 15), with_ref=False)
    assert ST.JOINS[0]["build"] == "left" and ST.JOINS[0]["swapped"]
    assert got.columns == ["k", "s", "lv", "id", "s_r", "x", "v"]


def test_full_join_with_null_keys():
    _check(lambda pl, u: u.join(_right(pl, seed=17), on="k", how="full"),
           16, sort_by=["k", "k_right", "v", "x", "s"], null_keys=True)


@pytest.mark.parametrize("how", ["left", "full"])
def test_grace_join_with_string_keys(monkeypatch, how):
    monkeypatch.setattr(pt.CONFIG, "join_build_budget_rows", 6)
    monkeypatch.setattr(pt.CONFIG, "join_grace_partitions", 2)
    monkeypatch.setattr(ref.CONFIG, "join_build_budget_rows", 6)
    monkeypatch.setattr(ref.CONFIG, "join_grace_partitions", 2)

    def make(pl, u):
        return u.join(_right(pl, seed=18, strings=True), on=["s", "k"],
                      how=how)
    order = {"right": ["s", "k", "w", "v", "x"],
             "full": ["s", "k", "v", "x", "s_right", "k_right", "w"]}
    got, counts = _check(make, 19, sort_by=order.get(how, ["s", "k", "v",
                                                           "x"]),
                         with_ref=how == "left")
    assert counts["spills"] > 0 and counts["spilled_bytes"] > 0
    assert ST.JOINS[0]["grace"]


def test_both_sides_past_the_sample_limit_spill(monkeypatch):
    monkeypatch.setattr(pt.CONFIG, "join_sample_limit", 50)
    monkeypatch.setattr(ref.CONFIG, "join_sample_limit", 50)
    monkeypatch.setattr(pt.CONFIG, "join_grace_partitions", 2)
    monkeypatch.setattr(ref.CONFIG, "join_grace_partitions", 2)

    def make(pl, u):
        other = _union(pl, _parts(20, sizes=(64, 64))).select(
            "k", pl.col("v").alias("w"))
        return u.join(other, on="k")
    got, counts = _check(make, 21, sort_by=["id", "w"])
    assert ST.JOINS[0]["grace"] and counts["spills"] > 0


@pytest.mark.parametrize("desc,nulls_last", [(False, True), (True, False)])
def test_external_sort_with_nulls_spills(monkeypatch, desc, nulls_last):
    monkeypatch.setattr(pt.CONFIG, "batch_rows", 60)
    monkeypatch.setattr(ref.CONFIG, "batch_rows", 60)
    got, counts = _check(
        lambda pl, u: u.sort(["x", "v"], descending=[desc, False],
                             nulls_last=nulls_last, maintain_order=True),
        22, with_ref=desc)
    assert counts["spills"] > 0
    x = [a for a in got.get_column("x").to_list() if a is not None]
    assert x == sorted(x, reverse=desc)


def test_external_sort_fits_in_memory_without_spilling():
    got, counts = _check(lambda pl, u: u.sort("v", maintain_order=True),
                         23)
    assert counts["spills"] == 0


def test_engine_affinity_streams(monkeypatch):
    lf = _union(pt, _parts(25)).group_by("k").agg(pt.col("v").sum())
    ST.reset_counts()
    lf.collect()
    assert ST.COUNTS["batches"] == 0
    monkeypatch.setattr(pt.CONFIG, "engine_affinity", "streaming")
    lf.collect()
    assert ST.COUNTS["batches"] == len(SIZES)
    ST.reset_counts()
    lf.collect(engine="in-memory")
    assert ST.COUNTS["batches"] == 0
    monkeypatch.setattr(pt.CONFIG, "engine_affinity", "auto")
    lf.collect(streaming=True)
    assert ST.COUNTS["batches"] == len(SIZES)


@pytest.mark.parametrize("engine", ["in-memory", "streaming"])
def test_visualize_ir_prints_the_optimized_plan(monkeypatch, capsys, engine):
    lf = _union(pt, _parts(28)).filter(pt.col("v") > 10).select("k", "v")
    lf.collect(engine=engine)
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(pt.CONFIG, "visualize_ir", True)
    out = lf.collect(engine=engine)
    assert capsys.readouterr().out == lf._optimized(engine).describe() + "\n"
    monkeypatch.setattr(pt.CONFIG, "visualize_ir", False)
    assert out.to_dict() == lf.collect(engine=engine).to_dict()


def test_streaming_metrics_time_each_node(monkeypatch, capsys):
    monkeypatch.setattr(pt.CONFIG, "track_metrics", True)
    monkeypatch.setattr(pt.CONFIG, "log_metrics", True)
    from polaroid_tpu_torch import metrics
    seen = []
    orig = metrics.QueryMetrics.print_report

    def keep(self):
        seen.append(self.report())
        orig(self)
    monkeypatch.setattr(metrics.QueryMetrics, "print_report", keep)
    _union(pt, _parts(26)).filter(pt.col("v") > 10).collect(
        engine="streaming")
    nodes = {r["node"]: r for r in seen[0]}
    assert nodes["filter"]["batches"] == len(SIZES)
    assert nodes["stream_output"]["batches"] == len(SIZES)
    assert "[metrics]" in capsys.readouterr().out


def test_async_and_batched_collects():
    parts = _parts(27)
    lf = _union(pt, parts)
    whole = lf.collect()
    fut = lf.group_by("k").agg(pt.col("v").sum()).collect_async()
    assert _dict(fut.result(timeout=60), ["k"]) == _dict(
        lf.group_by("k").agg(pt.col("v").sum()).collect(), ["k"])
    futs = pt.collect_all_async([lf.head(3), lf.tail(2)])
    a, b = futs.result(timeout=60)
    assert a.to_dict() == whole.head(3).to_dict()
    assert b.to_dict() == whole.tail(2).to_dict()
    assert pt.collect_all_async([]).result() == []
    batches = list(lf.collect_batches(batch_size=100))
    n = sum(SIZES)
    assert [b.height for b in batches] == [100] * (n // 100) + [n % 100]
    assert pt.concat(batches).to_dict() == whole.to_dict()
    calls = []
    lf.sink_batches(lambda b: calls.append(b.height) or len(calls) == 2,
                    batch_size=250)
    assert calls == [250, 250]
