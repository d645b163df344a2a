"""The rest of the expression surface in the port against the JAX
package: every select kind that raised before (the distinct flags,
arg_true, to_physical, extend_constant, append, business_day_count,
replace_strict, cut/qcut, hist, shrink_dtype, the type bounds, the
extension wrappers and the host UDFs), common subexpressions, group-level
when/then and map_groups, plugins, the top-level expression functions,
and the sampling kinds (whose draws cannot match JAX's PRNG: their
properties are held instead), each through both packages on the same
data, with nulls.

Tolerances: integers, booleans, strings, keys and row order exact;
Float64 within rtol 1e-12 between the packages."""

import datetime as dtm

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
from polaroid_tpu_torch.testing import assert_frame_equal, \
    assert_frame_not_equal, assert_series_equal, assert_series_not_equal

N = 160


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
    rng = np.random.default_rng(13)
    a = rng.integers(0, 12, N)
    f = np.round(rng.normal(50, 20, N), 3)
    words = ["ask", "bid", "mid", "trade", "quote"]
    d0 = dtm.date(2024, 3, 1)
    return {
        "a": [None if i % 11 == 3 else int(x) for i, x in enumerate(a)],
        "k": [int(x) for x in rng.integers(0, 5, N)],
        "f": [None if i % 13 == 5 else float(x) for i, x in enumerate(f)],
        "s": [words[i] for i in rng.integers(0, len(words), N)],
        "b": [bool(x) for x in rng.integers(0, 2, N)],
        "d1": [d0 + dtm.timedelta(days=int(x))
               for x in rng.integers(0, 30, N)],
        "d2": [d0 + dtm.timedelta(days=int(x))
               for x in rng.integers(10, 60, N)],
        "u": np.arange(N, dtype=np.int64) * 7 % N,
    }


DATA = _data()
PDF = pt.DataFrame(DATA, device="cpu")
RDF = ref.DataFrame(DATA)


def both(build):
    """build(pl, frame) through both packages: (port's, JAX's)."""
    return build(pt, PDF), build(ref, RDF)


def same(build, **kw):
    got, want = both(build)
    assert_frame_equal(got, want, **({"rtol": 1e-12, "atol": 0.0} | kw))


SELECT_KINDS = {
    "arg_true": lambda pl: pl.col("b").arg_true(),
    "is_duplicated_int": lambda pl: pl.col("a").is_duplicated(),
    "is_unique_float": lambda pl: pl.col("f").is_unique(),
    "is_first_distinct_str": lambda pl: pl.col("s").is_first_distinct(),
    "is_last_distinct_int": lambda pl: pl.col("a").is_last_distinct(),
    "is_unique_sum": lambda pl: pl.col("u").is_unique().sum(),
    "to_physical_date": lambda pl: pl.col("d1").to_physical(),
    "extend_constant": lambda pl: pl.col("a").extend_constant(99, 3),
    "extend_null": lambda pl: pl.col("f").extend_constant(None, 2),
    "append": lambda pl: pl.col("a").append(pl.col("k")),
    "append_str": lambda pl: pl.col("s").append(pl.lit("zz")),
    "business_days": lambda pl: pl.business_day_count("d1", "d2"),
    "map_elements": lambda pl: pl.col("a").map_elements(
        lambda x: x * 3 + 1, return_dtype=pl.Int64),
    "map_elements_str": lambda pl: pl.col("s").map_elements(
        lambda x: x.upper(), return_dtype=pl.String),
    "replace_strict": lambda pl: pl.col("k").replace_strict(
        [0, 1, 2], [10, 20, 30], default=-1),
    "replace_strict_str": lambda pl: pl.col("s").replace_strict(
        ["ask", "bid"], ["A", "B"], default="?"),
    "cut": lambda pl: pl.col("f").cut([30.0, 50.5, 70.0]),
    "cut_labels": lambda pl: pl.col("f").cut(
        [40.0, 60.0], labels=["lo", "mid", "hi"], left_closed=True),
    "qcut": lambda pl: pl.col("f").qcut(4),
    "qcut_list": lambda pl: pl.col("a").qcut([0.2, 0.5, 0.8]),
    "hist_count": lambda pl: pl.col("f").hist(bin_count=7),
    "hist_bins": lambda pl: pl.col("a").hist(bins=[0, 3, 6, 12]),
    "shrink_int": lambda pl: pl.col("a").shrink_dtype(),
    "shrink_float": lambda pl: pl.col("f").shrink_dtype(),
    "map_batches": lambda pl: pl.col("f").map_batches(lambda x: x * 2),
    "lower_bound": lambda pl: pl.col("a").lower_bound(),
    "upper_bound": lambda pl: pl.col("f").upper_bound(),
    "rolling_map": lambda pl: pl.col("f").rolling_map(
        lambda s: s.sum(), window_size=3),
    "arg_where": lambda pl: pl.arg_where(pl.col("b")),
    "coalesce": lambda pl: pl.coalesce("a", "k"),
    "max_horizontal": lambda pl: pl.max_horizontal("a", "k"),
    "min_horizontal": lambda pl: pl.min_horizontal("a", "f"),
    "sum_horizontal": lambda pl: pl.sum_horizontal("a", "k"),
    "mean_horizontal": lambda pl: pl.mean_horizontal("a", "f"),
    "any_horizontal": lambda pl: pl.any_horizontal(
        pl.col("b"), pl.col("k") > 3),
    "all_horizontal": lambda pl: pl.all_horizontal(
        pl.col("b"), pl.col("k") > 1),
    "fold": lambda pl: pl.fold(pl.lit(0), lambda acc, x: acc + x,
                               [pl.col("k"), pl.col("u")]),
    "reduce": lambda pl: pl.reduce(lambda acc, x: acc * x,
                                   [pl.col("k"), pl.col("u")]),
    "cum_fold": lambda pl: pl.cum_fold(pl.lit(1), lambda acc, x: acc + x,
                                       [pl.col("k"), pl.col("u")]),
    "cum_reduce": lambda pl: pl.cum_reduce(lambda acc, x: acc + x,
                                           [pl.col("k"), pl.col("u")]),
    "cum_sum_horizontal": lambda pl: pl.cum_sum_horizontal("k", "u"),
    "arctan2": lambda pl: pl.arctan2("f", "k"),
    "arctan2d": lambda pl: pl.arctan2d("k", "f"),
    "arg_sort_by": lambda pl: pl.arg_sort_by(["k", "u"]),
    "cum_sum": lambda pl: pl.cum_sum("k"),
    "cum_count": lambda pl: pl.cum_count("a"),
    "sum": lambda pl: pl.sum("k"), "mean": lambda pl: pl.mean("f"),
    "median": lambda pl: pl.median("f"), "std": lambda pl: pl.std("f"),
    "var": lambda pl: pl.var("f"), "min": lambda pl: pl.min("f"),
    "max": lambda pl: pl.max("a"), "count": lambda pl: pl.count("a"),
    "n_unique": lambda pl: pl.n_unique("s"),
    "quantile": lambda pl: pl.quantile("f", 0.3),
    "first": lambda pl: pl.first("s"), "last": lambda pl: pl.last("f"),
    "head": lambda pl: pl.head("a", 4), "tail": lambda pl: pl.tail("k", 3),
    "approx_n_unique": lambda pl: pl.approx_n_unique("k"),
}


@pytest.mark.parametrize("name", sorted(SELECT_KINDS))
def test_select_kind_matches_jax(name):
    same(lambda pl, df: df.select(SELECT_KINDS[name](pl).alias("o"))
         if not name.startswith(("cum_fold", "cum_reduce", "cum_sum_h",
                                 "hist"))
         else df.select(SELECT_KINDS[name](pl)))


@pytest.mark.parametrize("name", ["all", "exclude", "nth", "select",
                                  "sql_expr_cols", "len"])
def test_column_functions_match_jax(name):
    build = {"all": lambda pl, df: df.select(pl.all()),
             # the JAX package's pl.exclude raises (ROADMAP Queue 3)
             "exclude": lambda pl, df: df.select(
                 pl.exclude("s", "d1") if pl is pt
                 else pl.all().exclude("s", "d1")),
             "nth": lambda pl, df: df.select(pl.nth(2)),
             "select": lambda pl, df: pl.select(
                 pl.lit(3).alias("x"), pl.lit("y").alias("z"),
                 **({"device": "cpu"} if pl is pt else {})),
             "sql_expr_cols": lambda pl, df: df.select(
                 pl.sql_expr("k * 2 + u").alias("x")),
             "len": lambda pl, df: df.select(pl.len())}[name]
    same(build)


def test_cumulative_eval_matches_jax():
    """cumulative_eval evaluates its expression once per prefix (the JAX
    package's documented slow path, which compiles each prefix): against
    the JAX package on 8 rows, against Python on 24."""
    data = {"a": DATA["a"][:8]}
    got = pt.DataFrame(data, device="cpu").select(
        pt.col("a").cumulative_eval(pt.element().max()).alias("m"))
    want = ref.DataFrame(data).select(
        ref.col("a").cumulative_eval(ref.element().max()).alias("m"))
    assert_frame_equal(got, want, check_exact=True)
    f = DATA["f"][:24]
    out = pt.DataFrame({"f": f}, device="cpu").select(
        pt.col("f").cumulative_eval(pt.element().sum(), min_samples=3))
    # each row's prefix holds the rows up to it, nulls included
    assert out.get_column("f").to_list() == [
        None if k < 3 else pytest.approx(
            sum(x for x in f[:k] if x is not None), rel=1e-12)
        for k in range(1, len(f) + 1)]


def test_distinct_flags_over_a_struct():
    """The JAX package's flags take one column; the port's also a Struct
    of them (one row sort over every field), held to numpy."""
    out = PDF.select(pt.struct("k", "s").is_duplicated().alias("d"),
                     pt.struct("k", "s").is_first_distinct().alias("f"))
    code = [(k, s) for k, s in zip(DATA["k"], DATA["s"])]
    seen, first, count = set(), [], {}
    for c in code:
        first.append(c not in seen)
        seen.add(c)
        count[c] = count.get(c, 0) + 1
    assert out.get_column("d").to_list() == [count[c] > 1 for c in code]
    assert out.get_column("f").to_list() == first


def test_cse_shares_repeated_subexpressions():
    """Common subexpressions are evaluated once per select and
    with_columns (cse_rewrite/cse_scope), with the JAX package's
    results."""
    from polaroid_tpu_torch.expr.eval import cse_rewrite
    e = (pt.col("k") * 2 + 1)
    es, hit = cse_rewrite([e.alias("x"), (e * e).alias("y")])
    assert hit and "cse_cached" in es[0].fingerprint()
    same(lambda pl, df: df.select(
        (pl.col("k") * 2 + 1).alias("x"),
        ((pl.col("k") * 2 + 1) * (pl.col("k") * 2 + 1)).sum().alias("y")))
    same(lambda pl, df: df.with_columns(
        (pl.col("f") + pl.col("k")).alias("x"),
        (pl.col("f") + pl.col("k")).rank().alias("y")))
    # a window over partitions, and a list's elements, stay whole: their
    # insides are evaluated per partition or per element
    same(lambda pl, df: df.select(
        pl.col("u").rank().over("k").alias("x"),
        (pl.col("u").rank().over("k") * 2).alias("y"),
        pl.col("u").shift(1).over("s").alias("z")))
    lists = {"p": [[1, 2], [3]], "q": [[4], [5, 6, 7]]}
    got = pt.DataFrame(lists, device="cpu").select(
        pt.col("p").list.eval(pt.element() * 2).alias("p"),
        pt.col("q").list.eval(pt.element() * 2).alias("q"))
    assert got.to_dict() == {"p": [[2, 4], [6]], "q": [[8], [10, 12, 14]]}


def test_rle_and_categories_match_jax():
    same(lambda pl, df: df.select(pl.col("k").rle().alias("r")))
    same(lambda pl, df: df.select(
        pl.col("s").cast(pl.Categorical).cat.get_categories().alias("c")))


def test_ext_wrappers_match_jax():
    for pl, df in ((pt, PDF), (ref, RDF)):
        ext = pl.Extension("point", pl.Float64)
        out = df.select(pl.col("f").ext.to(ext).alias("w"),
                        pl.col("f").ext.to(ext).ext.storage().alias("s"))
        assert out.schema["w"] == ext and out.schema["s"] == pl.Float64
        assert out.get_column("s").to_list() == DATA["f"]
        with pytest.raises(Exception):
            df.select(pl.col("s").ext.to(ext))


def test_replace_strict_without_default_raises_as_jax():
    for pl, df in ((pt, PDF), (ref, RDF)):
        with pytest.raises(pl.InvalidOperationError):
            df.select(pl.col("k").replace_strict([0, 1], [5, 6]))
        with pytest.raises(pl.InvalidOperationError):
            df.select(pl.col("s").replace_strict(["ask"], ["A"]))


# --- group-level kinds -------------------------------------------------------

GROUP_AGGS = {
    "when_then": lambda pl: pl.when(pl.col("f").sum() >= 400)
    .then(pl.col("f").max()).otherwise(pl.col("f").min()),
    "when_chain": lambda pl: pl.when(pl.col("a").count() > 33).then(
        pl.lit("many")).when(pl.col("a").count() > 30).then(pl.lit("some"))
    .otherwise(pl.lit("few")),
    "when_null_otherwise": lambda pl: pl.when(pl.col("k").sum() > 100)
    .then(pl.col("u").max()),
    "map_groups_scalar": lambda pl: pl.map_groups(
        ["f"], lambda s: s[0].sum() + 1, returns_scalar=True),
    "map_groups_list": lambda pl: pl.map_groups(["u"], lambda s: s[0] * 2),
}


@pytest.mark.parametrize("key", ["k", "s"])
@pytest.mark.parametrize("name", sorted(GROUP_AGGS))
def test_group_level_kind_matches_jax(name, key):
    same(lambda pl, df: df.group_by(key).agg(
        GROUP_AGGS[name](pl).alias("x")).sort(key))


def test_plugins_match_jax():
    import polaroid_tpu.plugins as rplug
    import polaroid_tpu_torch.plugins as pplug
    outs = []
    for pl, plug, df in ((pt, pplug, PDF), (ref, rplug, RDF)):
        plug.register_plugin_callable("pt_triple", lambda d: d * 3)
        e = plug.register_plugin_function(function_name="pt_triple",
                                          args=["u"], is_elementwise=True)
        kw = {"device": "cpu"} if pl is pt else {}
        plug.register_plugin_callable(
            "pt_len", lambda s, pl=pl, kw=kw: pl.Series("n", [len(s)], **kw))
        g = plug.register_plugin_function(function_name="pt_len",
                                          args=["u"], returns_scalar=True)
        outs.append((df.select(e.alias("x")),
                     df.group_by("k").agg(g.alias("n")).sort("k")))
        with pytest.warns(DeprecationWarning):
            pl.col("u").register_plugin(lib="none.so", symbol="pt_triple",
                                        is_elementwise=True)
    assert_frame_equal(outs[0][0], outs[1][0], check_exact=True)
    assert_frame_equal(outs[0][1], outs[1][1], check_exact=True)


# --- sampling: properties, not values ---------------------------------------

@pytest.mark.parametrize("how", ["n", "fraction", "shuffle", "replace"])
def test_expr_sample_properties(how):
    kw = {"n": {"n": 40}, "fraction": {"fraction": 0.25},
          "shuffle": {"fraction": 1.0, "shuffle": True},
          "replace": {"n": 100, "with_replacement": True}}[how]
    kw = {**kw, "seed": 7}
    u = set(DATA["u"].tolist())
    out = PDF.select(pt.col("u").sample(**kw).alias("x"))
    vals = out.get_column("x").to_list()
    size = {"n": 40, "fraction": N // 4, "shuffle": N, "replace": 100}[how]
    assert len(vals) == size
    assert set(vals) <= u
    if how != "replace":
        assert len(set(vals)) == len(vals), "a row was drawn twice"
    again = PDF.select(pt.col("u").sample(**kw).alias("x"))
    assert again.get_column("x").to_list() == vals
    # the JAX package draws the same sizes from the same rows
    want = RDF.select(ref.col("u").sample(**kw).alias("x"))
    assert want.height == size


@pytest.mark.parametrize("how", ["frame_n", "frame_shuffle", "series",
                                 "global_seed", "list_sample"])
def test_other_sampling_properties(how):
    u = set(DATA["u"].tolist())
    if how == "frame_n":
        a = PDF.sample(25, seed=3)
        assert a.height == 25 and a.columns == PDF.columns
        us = a.get_column("u").to_list()
        assert len(set(us)) == 25 and set(us) <= u and us == sorted(
            us, key=DATA["u"].tolist().index)   # frame order kept
        assert_frame_equal(a, PDF.sample(25, seed=3), check_exact=True)
        assert_frame_not_equal(a, PDF.sample(25, seed=4))
    elif how == "frame_shuffle":
        a = PDF.shuffle(seed=5)
        assert sorted(a.get_column("u").to_list()) == sorted(u)
        assert a.rows() != PDF.rows()
    elif how == "series":
        s = PDF.get_column("u")
        a = s.sample(10, seed=1)
        assert len(a) == 10 and set(a.to_list()) <= u
        assert_series_equal(a, s.sample(10, seed=1))
        assert_series_not_equal(s.shuffle(seed=2), s)
    elif how == "global_seed":
        pt.set_random_seed(11)
        a = PDF.select(pt.col("u").sample(n=12).alias("x"))
        pt.set_random_seed(11)
        b = PDF.select(pt.col("u").sample(n=12).alias("x"))
        assert_frame_equal(a, b, check_exact=True)
        from polaroid_tpu_torch import config
        config.RANDOM_SEED = None
    else:
        df = pt.DataFrame({"l": [list(range(i, i + 6)) for i in range(30)]},
                          device="cpu")
        out = df.select(pt.col("l").list.sample(3, seed=9).alias("x"))
        for row, got in zip(df.get_column("l").to_list(),
                            out.get_column("x").to_list()):
            assert len(got) == 3 and len(set(got)) == 3 and set(got) <= \
                set(row)
        again = df.select(pt.col("l").list.sample(3, seed=9).alias("x"))
        assert_frame_equal(out, again, check_exact=True)


# --- datatype expressions and monads -------------------------------------------

@pytest.mark.parametrize("case", ["cast", "map_batches", "self_dtype",
                                  "struct_with_fields"])
def test_datatype_expr_matches_jax(case):
    if case == "struct_with_fields":
        for pl, df in ((pt, PDF), (ref, RDF)):
            dt = pl.struct_with_fields({"x": pl.Int32, "y": pl.dtype_of("f")}
                                       ).collect_dtype(dict(df.schema))
            assert repr(dt) == "Struct({'x': Int32, 'y': Float64})"
        return
    build = {
        "cast": lambda pl, df: df.lazy().with_columns(
            pl.col("f").cast(pl.dtype_of("k"), strict=False)).collect(),
        "map_batches": lambda pl, df: df.select(pl.col("k").map_batches(
            lambda x: x * 2, return_dtype=pl.dtype_of("u"))),
    }.get(case)
    if case == "self_dtype":
        # the JAX package's map_elements takes no dtype expression; the
        # port's resolves it to the input's dtype
        out = PDF.select(pt.col("a").map_elements(
            lambda x: x + 1, return_dtype=pt.self_dtype()))
        assert out.schema["a"] == pt.Int64
        assert out.get_column("a").to_list() == \
            [None if x is None else x + 1 for x in DATA["a"]]
        return
    same(build)


def test_monads_match_jax():
    from polaroid_tpu.monads import Lazy as RLazy, Option as ROption, \
        Result as RResult
    from polaroid_tpu_torch.monads import Lazy, Option, Result
    for R, O, L in ((Result, Option, Lazy), (RResult, ROption, RLazy)):
        assert R.ok(2).map(lambda x: x + 1).unwrap() == 3
        e = R.err("boom")
        assert e.is_err() and e.unwrap_or(9) == 9 and e.err_value() == "boom"
        assert R.ok(2).map(lambda x: 1 / 0).is_err()
        assert R.ok(2).and_then(lambda x: R.ok(x * 2)).unwrap() == 4
        assert O.some(5).filter(lambda x: x > 3).map(lambda x: x * 2) \
            .unwrap() == 10
        assert O.nothing().unwrap_or(7) == 7
        calls = []
        lz = L(lambda: calls.append(1) or 42)
        assert not lz.is_evaluated() and lz.force() == 42 == lz.force()
        assert calls == [1] and lz.map(lambda x: x + 1).force() == 43
