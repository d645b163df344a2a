"""The frame, lazy-frame and series helpers in the port against the JAX
package: pivot and unpivot, partition_by, transpose, the row index, drop/
rename/cast, the row and dict views, update, merge_sorted, the distinct
rows, the reductions and horizontal folds, the lazy frame's plan helpers
and the Series methods, each through both packages on the same data, and
the port's `testing` assertions themselves.

Tolerances: integers, strings, keys and row order exact; Float64 within
rtol 1e-12 between the packages."""

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
from polaroid_tpu_torch.testing import assert_frame_equal, \
    assert_frame_not_equal, assert_series_equal, assert_series_not_equal

N = 96


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


def _data():
    rng = np.random.default_rng(21)
    syms = ["AA", "BB", "CC", "DD"]
    return {"sym": [syms[i] for i in rng.integers(0, 4, N)],
            "ex": [["D", "N", "P"][i] for i in rng.integers(0, 3, N)],
            "vol": [int(v) for v in rng.integers(1, 500, N)],
            "px": [None if i % 17 == 4 else float(np.round(p, 2))
                   for i, p in enumerate(rng.uniform(10, 20, N))],
            "t": list(range(N))}


DATA = _data()
PDF = pt.DataFrame(DATA, device="cpu")
RDF = ref.DataFrame(DATA)


def same(build, **kw):
    got, want = build(pt, PDF), build(ref, RDF)
    if isinstance(want, ref.Series):
        assert_series_equal(got, want,
                            **({"rtol": 1e-12, "atol": 0.0} | kw))
    elif isinstance(want, ref.DataFrame):
        assert_frame_equal(got, want, **({"rtol": 1e-12, "atol": 0.0} | kw))
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-12, abs=0.0)
    else:
        assert got == want


FRAME_OPS = {
    "pivot_sum": lambda pl, df: df.pivot(
        "ex", index="sym", values="vol", aggregate_function="sum"),
    "pivot_first_two_values": lambda pl, df: df.pivot(
        "ex", index="sym", values=["vol", "px"]),
    "pivot_max_on_columns": lambda pl, df: df.pivot(
        "ex", index="sym", values="px", aggregate_function="max",
        on_columns=["P", "D"]),
    "unpivot": lambda pl, df: df.unpivot(["vol", "t"], index="sym"),
    "melt": lambda pl, df: df.select("sym", "vol").melt(index="sym"),
    "with_row_index": lambda pl, df: df.with_row_index("i", offset=3),
    "with_row_count": lambda pl, df: df.with_row_count(),
    "drop": lambda pl, df: df.drop("ex", "t"),
    "rename": lambda pl, df: df.rename({"vol": "v", "px": "p"}),
    "cast": lambda pl, df: df.cast({"vol": pl.Float64, "t": pl.Int32}),
    "limit": lambda pl, df: df.limit(7),
    "slice": lambda pl, df: df.slice(10, 20),
    "reverse": lambda pl, df: df.reverse(),
    "gather_every": lambda pl, df: df.gather_every(5, 2),
    "fill_nan": lambda pl, df: df.with_columns(
        (pl.col("px") / (pl.col("vol") % 3 - 1) * 0.0).alias("px"))
    .fill_nan(-1.0),
    "drop_nans": lambda pl, df: df.with_columns(
        (pl.col("px") / (pl.col("vol") % 3 - 1) * 0.0).alias("px"))
    .drop_nans(),
    "remove": lambda pl, df: df.remove(pl.col("vol") > 250),
    "product": lambda pl, df: df.select("vol", "t").head(6).product(),
    "quantile": lambda pl, df: df.select("vol", "px").quantile(0.25),
    "count": lambda pl, df: df.count(),
    "approx_n_unique": lambda pl, df: df.approx_n_unique(),
    "max_horizontal": lambda pl, df: df.select("vol", "t").max_horizontal(),
    "min_horizontal": lambda pl, df: df.select("vol", "t").min_horizontal(),
    "sum_horizontal": lambda pl, df: df.select("vol", "t").sum_horizontal(),
    "mean_horizontal": lambda pl, df: df.select("vol", "t")
    .mean_horizontal(),
    "fold": lambda pl, df: df.select("vol", "t").fold(lambda a, b: a + b),
    "is_duplicated": lambda pl, df: df.select("sym", "ex").is_duplicated(),
    "is_unique": lambda pl, df: df.select("sym", "ex").is_unique(),
    "n_unique": lambda pl, df: df.n_unique(["sym", "ex"]),
    "transpose": lambda pl, df: df.select("vol", "t").head(4).transpose(
        include_header=True),
    "unstack": lambda pl, df: df.select("vol").head(9).unstack(step=3),
    "to_dummies": lambda pl, df: df.select("sym", "vol").to_dummies("sym"),
    "to_dicts": lambda pl, df: df.head(5).to_dicts(),
    "rows_by_key": lambda pl, df: df.head(12).select("sym", "vol")
    .rows_by_key("sym"),
    "row": lambda pl, df: df.row(7),
    "item": lambda pl, df: df.item(3, "vol"),
    "get_columns": lambda pl, df: [s.to_list() for s in df.get_columns()],
    "get_column_index": lambda pl, df: df.get_column_index("px"),
    "to_series": lambda pl, df: df.to_series(2),
    "is_empty": lambda pl, df: (df.is_empty(), df.head(0).is_empty()),
    "equals": lambda pl, df: (df.equals(df), df.equals(df.head(3))),
    "insert_column": lambda pl, df: df.insert_column(
        1, df.get_column("t").alias("t2")),
    "replace_column": lambda pl, df: df.replace_column(
        2, df.get_column("t").alias("vol2")),
    "update": lambda pl, df: df.select("sym", "vol").update(
        df.select("sym", "vol").head(5).with_columns(
            pl.col("vol") * 10)),
    "merge_sorted": lambda pl, df: df.filter(pl.col("t") % 2 == 0)
    .merge_sorted(df.filter(pl.col("t") % 2 == 1), "t"),
    "corr": lambda pl, df: df.select("vol", "t").corr(),
    "partition_by": lambda pl, df: [p.rows() for p in df.partition_by(
        "sym", maintain_order=True)],
    "partition_by_dict": lambda pl, df: {
        k: v.height for k, v in df.partition_by("ex", as_dict=True).items()},
    "clear": lambda pl, df: df.clear(),
    "extend": lambda pl, df: df.head(3).clone().extend(df.tail(2)),
    "match_to_schema": lambda pl, df: df.select("vol", "sym")
    .match_to_schema({"vol": pl.Float64, "sym": pl.String}),
    "select_seq": lambda pl, df: df.select_seq("vol", (pl.col("t") + 1)),
    "pipe": lambda pl, df: df.pipe(lambda f, n: f.head(n), 4),
    "map_rows": lambda pl, df: df.select("vol", "t").head(5)
    .map_rows(lambda r: (r[0] + r[1],)),
    "map_columns": lambda pl, df: df.select("vol").head(5).map_columns(
        "vol", lambda s: s * 2),
}


@pytest.mark.parametrize("name", sorted(FRAME_OPS))
def test_frame_helper_matches_jax(name):
    same(FRAME_OPS[name])


LAZY_OPS = {
    "rename_drop": lambda pl, lf: lf.rename({"vol": "v"}).drop("ex"),
    "cast": lambda pl, lf: lf.cast({"t": pl.Float32}),
    "with_row_index": lambda pl, lf: lf.with_row_index(),
    "unpivot": lambda pl, lf: lf.unpivot(["vol"], index=["sym", "t"]),
    "pivot": lambda pl, lf: lf.pivot("ex", ["D", "N", "P"], index="sym",
                                     values="vol",
                                     aggregate_function="sum"),
    "merge_sorted": lambda pl, lf: lf.filter(pl.col("t") < 40).merge_sorted(
        lf.filter(pl.col("t") >= 40), "t"),
    "sum": lambda pl, lf: lf.sum(), "mean": lambda pl, lf: lf.mean(),
    "min": lambda pl, lf: lf.min(), "max": lambda pl, lf: lf.max(),
    "median": lambda pl, lf: lf.median(), "std": lambda pl, lf: lf.std(),
    "var": lambda pl, lf: lf.var(),
    "quantile": lambda pl, lf: lf.quantile(0.5),
    "null_count": lambda pl, lf: lf.null_count(),
    "count": lambda pl, lf: lf.count(),
    "gather_every": lambda pl, lf: lf.gather_every(7),
    "reverse": lambda pl, lf: lf.reverse(),
    "drop_nulls": lambda pl, lf: lf.drop_nulls(),
    "remove": lambda pl, lf: lf.remove(pl.col("ex") == "D"),
    "update": lambda pl, lf: lf.select("sym", "vol").update(
        lf.select("sym", "vol").head(3).with_columns(pl.col("vol") + 1)),
    "with_context": lambda pl, lf: lf.select("vol").with_context(
        lf.select(pl.col("t").alias("t2"))),
    "map_batches": lambda pl, lf: lf.map_batches(lambda df: df.head(3)),
    "sql": lambda pl, lf: lf.sql(
        "SELECT sym, SUM(vol) AS v FROM self GROUP BY sym ORDER BY sym"),
    "pipe": lambda pl, lf: lf.pipe(lambda f: f.select("t")),
    "clear": lambda pl, lf: lf.clear(),
}


@pytest.mark.parametrize("name", sorted(LAZY_OPS))
def test_lazy_helper_matches_jax(name):
    same(lambda pl, df: LAZY_OPS[name](pl, df.lazy()).collect())


def test_lazy_introspection_matches_jax():
    for pl, df in ((pt, PDF), (ref, RDF)):
        lf = df.lazy()
        assert lf.width == 5 and lf.collect_schema() == lf.schema
        assert [repr(d) for d in lf.dtypes] == \
            ["String", "String", "Int64", "Float64", "Int64"]
        assert lf.fetch(3).height == 3 and lf.describe().height == 9
        out, prof = lf.profile()
        assert out.height == N and prof.height >= 1
    assert_frame_equal(pt.collect_all([PDF.lazy().head(2)])[0],
                       ref.collect_all([RDF.lazy().head(2)])[0])


SERIES_OPS = {
    "head": lambda s: s.head(4), "tail": lambda s: s.tail(3),
    "limit": lambda s: s.limit(2), "slice": lambda s: s.slice(5, 4),
    "filter": lambda s: s.filter(s > 250),
    "value_counts": lambda s: (s % 5).value_counts(),
    "value_counts_sorted": lambda s: (s % 3).value_counts(sort=True),
    "search_sorted": lambda s: s.sort().search_sorted(250),
    "gather": lambda s: s.gather([3, 0, 7]),
    "gather_every": lambda s: s.gather_every(10),
    "append": lambda s: s.head(3).append(s.tail(2)),
    "extend_constant": lambda s: s.head(3).extend_constant(0, 2),
    "scatter": lambda s: s.head(6).scatter([1, 4], [-1, -2]),
    "set": lambda s: s.head(6).set(s.head(6) > 250, 0),
    "new_from_index": lambda s: s.new_from_index(2, 4),
    "zip_with": lambda s: s.head(5).zip_with(s.head(5) > 250,
                                            s.head(5) * 0),
    "is_sorted": lambda s: (s.is_sorted(), s.sort().is_sorted()),
    "unique": lambda s: (s % 7).unique().sort(),
    "n_unique": lambda s: s.n_unique(), "arg_max": lambda s: s.arg_max(),
    "arg_min": lambda s: s.arg_min(), "max": lambda s: s.max(),
    "min": lambda s: s.min(), "median": lambda s: s.median(),
    "std": lambda s: s.std(), "var": lambda s: s.var(),
    "quantile": lambda s: s.quantile(0.4), "count": lambda s: s.count(),
    "null_count": lambda s: s.null_count(), "first": lambda s: s.first(),
    "last": lambda s: s.last(), "item": lambda s: s.item(5),
    "entropy": lambda s: s.entropy(), "mode": lambda s: (s % 4).mode(),
    "abs": lambda s: (s - 250).abs(), "sqrt": lambda s: s.sqrt(),
    "exp": lambda s: (s / 100).exp(), "log": lambda s: s.log(),
    "round": lambda s: (s / 7).round(2), "clip": lambda s: s.clip(100, 300),
    "cast": lambda s: s.cast(ref.Float32 if isinstance(s, ref.Series)
                             else pt.Float32),
    "is_null": lambda s: s.is_null(), "is_not_null": lambda s:
    s.is_not_null(), "drop_nulls": lambda s: s.drop_nulls(),
    "map_elements": lambda s: s.head(5).map_elements(lambda v: v + 1),
    "reshape": lambda s: s.head(6).reshape((2, 3)),
    "to_dummies": lambda s: (s % 3).to_dummies(),
    "dot": lambda s: s.dot(s), "len": lambda s: (s.len(), len(s)),
    "has_nulls": lambda s: s.has_nulls(),
    "rename": lambda s: s.rename("x").name,
    "describe": lambda s: s.describe(),
    "equals": lambda s: (s.equals(s), s.series_equal(s.head(3))),
    "to_physical": lambda s: s.to_physical(),
    "via_expr": lambda s: s.cum_max(),
}


@pytest.mark.parametrize("name", sorted(SERIES_OPS))
def test_series_helper_matches_jax(name):
    same(lambda pl, df: SERIES_OPS[name](df.get_column("vol")))


def test_series_hist_counts_as_the_expression():
    """Series.hist bins as `Expr.hist` does (a value on an inner edge in
    the bin to its left), where the JAX package's Series.hist uses
    numpy's left-closed bins (ROADMAP Queue 3): its counts are held to
    the JAX package's Expr.hist."""
    s = PDF.get_column("vol")
    got = s.hist(bin_count=6)
    want = RDF.select(ref.col("vol").hist(bin_count=6,
                                          include_breakpoint=True)
                      .alias("vol")).unnest("vol")
    assert_frame_equal(got, want, rtol=1e-12, atol=0.0)


def test_frame_views_and_repr():
    text = repr(PDF.head(3))
    assert text.startswith("shape: (3, 5)") and "│ sym" in text
    assert repr(PDF.head(3)) == repr(RDF.head(3))
    assert PDF.glimpse(return_as_string=True).splitlines()[:2] == \
        ["Rows: 96", "Columns: 5"]
    assert pt.from_repr(text, device="cpu").rows() == PDF.head(3).rows()
    assert PDF["vol"].to_list() == DATA["vol"]
    assert PDF[["sym", "t"]].columns == ["sym", "t"]
    assert PDF[2:4].rows() == RDF[2:4].rows()
    t = PDF.to_torch("dict")
    assert t["vol"].tolist() == DATA["vol"]
    assert PDF.hash_rows().to_list() == PDF.hash_rows().to_list()
    assert PDF.estimated_size() > 0 and PDF.n_chunks() == 1


def test_constructors_match_jax():
    rows = [{"a": 1, "b": "x"}, {"a": 2, "c": 2.5}]
    assert_frame_equal(pt.from_dicts(rows, device="cpu"),
                       ref.from_dicts(rows))
    assert_frame_equal(pt.from_records([(1, "x"), (2, "y")],
                                       schema=["a", "b"], device="cpu"),
                       ref.DataFrame({"a": [1, 2], "b": ["x", "y"]}))
    arr = np.arange(6.0).reshape(3, 2)
    assert_frame_equal(pt.from_numpy(arr, device="cpu"),
                       ref.from_numpy(arr))
    import torch
    assert_frame_equal(pt.from_torch(torch.tensor(arr), device="cpu"),
                       ref.from_numpy(arr))
    ints = np.arange(-3, 3, dtype=np.int32)
    assert_frame_equal(pt.from_torch(torch.tensor(ints), schema=["k"],
                                     device="cpu"),
                       ref.from_numpy(ints, schema=["k"]))
    for name, args in (("int_range", (0, 5)), ("arange", (2, 9, 3)),
                       ("ones", (3,)), ("zeros", (2,)),
                       ("linear_space", (0.0, 1.0, 5))):
        kw = {"eager": True} if name in ("int_range", "arange") else {}
        assert getattr(pt, name)(*args, device="cpu", **kw).to_list() == \
            getattr(ref, name)(*args, **kw).to_list()
    assert pt.repeat("z", 3, eager=True, device="cpu").to_list() == \
        ["z"] * 3
    assert_frame_equal(pt.json_normalize({"a": {"b": 1, "c": 2}},
                                         device="cpu"),
                       ref.json_normalize({"a": {"b": 1, "c": 2}}))
    a, b = pt.align_frames(PDF.select("t", "vol").head(4),
                           PDF.select("t", "px").slice(2, 4), on="t")
    ra, rb = ref.align_frames(RDF.select("t", "vol").head(4),
                              RDF.select("t", "px").slice(2, 4), on="t")
    assert_frame_equal(a, ra)
    assert_frame_equal(b, rb)


def test_testing_assertions():
    a = PDF.head(4)
    assert_frame_equal(a, a.clone())
    assert_frame_not_equal(a, PDF.tail(4))
    assert_frame_equal(a, a.select(list(reversed(a.columns))),
                       check_column_order=False)
    with pytest.raises(AssertionError):
        assert_frame_equal(a, a.with_columns(pt.col("vol") + 1))
    s = a.get_column("px")
    assert_series_equal(s, s * 1.0000000001, rtol=1e-6)
    assert_series_not_equal(s, s * 2)
    with pytest.raises(AssertionError):
        assert_series_equal(s, s.rename("q"))
