"""The select context (Slice E1) through the JAX package and the port.

The same seeded numpy columns (Float64 with nulls and a NaN, Float32,
Int32 with negatives, UInt32, Int64, Int8, Boolean, String) go through
`polaroid_tpu` (its CPU path) and `polaroid_tpu_torch` with
device="cpu": every aggregate over the whole column in a select and as a
scalar broadcast in `with_columns`, the unary math and bit counts, the
kinds `fill_nan`, `clip`, `is_in`, `is_between`, `replace`, `hash`,
`row_index`, `drop_nulls`, `gather_every`, a slice, `search_sorted`,
`sort_by` and `sort`, the group aggregates skew, kurtosis, nan_min,
nan_max, the bitwise ones and entropy on the dense, hash and sorted
tiers,
and the API: frames from Series, the frame reductions and `describe`,
`Series.mean`/`to_frame`, `LazyFrame.tail`/`slice`/`limit`/`first`/
`last` and `pl.exceptions`.

Tolerances: integer results, counts, min/max, first/last, order
statistics, hashes, bit counts and every null bit for bit; f64 sums and
means within 1e-12 of the mean of |x|, moments (var, std, skew,
kurtosis, entropy) within rtol 1e-10, a Float32 result within one ulp;
the float math within rtol 1e-13 (XLA's CPU `log1p` is 2e-14 from
numpy, torch's 2e-16). Where the port departs from the JAX package it is
held to numpy: several NaNs are one value to `n_unique`.
"""

import datetime as pydt
import math
import struct

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
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


N = 400


def _data():
    rng = np.random.default_rng(21)
    f = rng.normal(3, 10, N)
    f[7] = np.nan
    return {
        "f": f,
        "f32": rng.normal(0, 5, N).astype(np.float32),
        "i": rng.integers(-60, 60, N).astype(np.int32),
        "u": rng.integers(0, 1 << 20, N).astype(np.uint32),
        "l": rng.integers(-(1 << 40), 1 << 40, N),
        "b8": rng.integers(-128, 127, N).astype(np.int8),
        "k": rng.integers(0, 6, N),
        "bo": rng.random(N) > 0.4,
        "s": [f"w{x}" for x in rng.integers(0, 9, N)],
    }, {"f": rng.random(N) > 0.15, "i": rng.random(N) > 0.1}


DATA, VALID = _data()
# a key over a span past the dense tier's 4096 slots: the hash tier
DATA["h"] = DATA["k"] * 5000


def frames(cols=None, valid=None):
    """The same columns as a `polaroid_tpu` frame (its validity set on
    the table) and as the port's frame on the CPU."""
    import jax.numpy as jnp
    cols = DATA if cols is None else cols
    valid = VALID if valid is None else valid
    tdf = frame_from_numpy(cols, validity=valid, device="cpu")
    rdf = ref.DataFrame(dict(cols))
    for k, m in valid.items():
        vm = np.zeros(rdf._table.capacity, dtype=bool)
        vm[:len(m)] = m
        rdf._table.cols[k].validity = jnp.asarray(vm)
    return rdf, tdf


R, T = frames()


def _close(a, b, rtol):
    if a == b:
        return True
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return abs(a - b) <= rtol * max(1.0, abs(a))
    return a == b


def same(got, want, rtol=0.0):
    g, w = got.to_dict(), want.to_dict()
    assert list(g) == list(w), (list(g), list(w))
    for k in w:
        assert len(g[k]) == len(w[k]), k
        for a, b in zip(g[k], w[k]):
            if rtol == 0.0 and isinstance(b, float):
                assert struct.pack("<d", a) == struct.pack("<d", b) or (
                    math.isnan(a) and math.isnan(b)), (k, a, b)
            else:
                assert _close(a, b, rtol), (k, a, b)


def both(make, frame=None, rtol=0.0):
    r, t = (R, T) if frame is None else frame
    same(make(pt, t), make(ref, r), rtol)


NUMERIC = ["f", "f32", "i", "u", "l", "b8"]
EXACT_AGGS = ["len", "count", "null_count", "min", "max", "first", "last",
              "arg_min", "arg_max", "median", "n_unique", "mode",
              "nan_min", "nan_max"]
FLOAT_AGGS = ["sum", "mean", "std", "var", "skew", "kurtosis", "product"]


@pytest.mark.parametrize("agg", EXACT_AGGS + FLOAT_AGGS)
def test_aggregate_in_a_select(agg):
    cols = NUMERIC if agg not in ("product",) else ["i", "b8"]
    if agg in ("n_unique", "mode", "arg_min", "arg_max", "nan_min",
               "nan_max", "min", "max", "median"):
        # the NaN row: held to numpy in test_n_unique_counts_nans_once
        cols = [c for c in cols if c != "f"] + ["f32"]
    both(lambda m, d: d.select([getattr(m.col(c), agg)().alias(c)
                                for c in dict.fromkeys(cols)]),
         rtol=1e-10 if agg in FLOAT_AGGS else 0.0)


@pytest.mark.parametrize("interp", ["nearest", "linear", "lower", "higher",
                                    "midpoint"])
def test_quantile_in_a_select(interp):
    both(lambda m, d: d.select([m.col(c).quantile(0.3, interp).alias(c)
                                for c in ("f32", "i", "u", "l")]))


@pytest.mark.parametrize("agg", ["bitwise_and", "bitwise_or", "bitwise_xor"])
def test_bitwise_aggregates(agg):
    both(lambda m, d: d.select([getattr(m.col(c), agg)().alias(c)
                                for c in ("i", "u", "l", "b8", "bo")]))


def test_entropy_and_scalar_broadcast_in_with_columns():
    both(lambda m, d: d.select(m.col("u").entropy().alias("e"),
                               m.col("i").entropy(base=2).alias("e2"),
                               m.col("u").entropy(normalize=False)
                               .alias("e3")), rtol=1e-10)
    both(lambda m, d: d.with_columns(
        (m.col("f32") - m.col("f32").mean()).alias("dev"),
        (m.col("i") * m.col("l").max()).alias("scaled"),
        m.len().alias("n")), rtol=0.0)


def test_aggregates_over_filtered_rows_and_expr_filter():
    both(lambda m, d: d.filter(m.col("k") > 1).select(
        m.col("i").sum().alias("s"), m.col("f32").max().alias("mx"),
        m.col("u").filter(m.col("k") == 3).mean().alias("mf"),
        m.col("i").drop_nulls().first().alias("fd"), m.len().alias("n")),
        rtol=1e-12)


def test_n_unique_counts_nans_once():
    """A kept difference: several NaNs are one value (polars; the JAX
    package counts each NaN), held to numpy."""
    x = np.array([1.0, np.nan, 2.0, np.nan, 1.0, -0.0, 0.0])
    out = pt.DataFrame({"x": x}, device="cpu").select(
        pt.col("x").n_unique()).to_dict()
    assert out["x"] == [4]


UNARY = ["abs", "sign", "floor", "ceil", "sqrt", "cbrt", "exp", "log",
         "log1p", "log10", "sin", "cos", "tan", "arcsin", "arccos", "arctan",
         "sinh", "cosh", "tanh", "arcsinh", "arccosh", "arctanh", "cot",
         "degrees", "radians"]


@pytest.mark.parametrize("op", UNARY)
def test_unary_math(op):
    cols = ["f", "f32", "i"] if op in ("abs", "sign", "floor", "ceil") \
        else ["f", "i"]
    both(lambda m, d: d.select([
        getattr(m.col(c) / (10 if op.startswith("arc") else 1), op)()
        .alias(c) for c in cols]), rtol=1e-13)


def test_round_and_sig_figs():
    both(lambda m, d: d.select(
        m.col("f").round(2).alias("r2"), m.col("f").round(0).alias("r0"),
        m.col("f32").round(1).alias("r1"), m.col("i").round(1).alias("ri"),
        m.col("f").round_sig_figs(3).alias("sf")))


BITS = ["bitwise_count_ones", "bitwise_count_zeros", "bitwise_leading_ones",
        "bitwise_leading_zeros", "bitwise_trailing_ones",
        "bitwise_trailing_zeros"]


@pytest.mark.parametrize("op", BITS)
def test_bit_counts(op):
    both(lambda m, d: d.select([getattr(m.col(c), op)().alias(c)
                                for c in ("i", "u", "l", "b8", "bo")]))


def test_reinterpret():
    both(lambda m, d: d.select(
        m.col("i").reinterpret(signed=False).alias("iu"),
        m.col("b8").reinterpret(signed=False).alias("bu"),
        m.col("l").reinterpret(signed=False).alias("lu")))


def test_clip_fill_nan_and_the_float_tests():
    both(lambda m, d: d.select(
        m.col("f").clip(-5, 5).alias("c"), m.col("i").clip(-10).alias("ci"),
        m.col("f32").clip(upper_bound=1.5).alias("cu"),
        m.col("f").fill_nan(0.5).alias("fn"),
        m.col("f").is_nan().alias("nan"), m.col("f").is_finite()
        .alias("fin"), m.col("f").is_infinite().alias("inf"),
        m.col("i").is_not_nan().alias("inn")))


@pytest.mark.parametrize("closed", ["both", "left", "right", "none"])
def test_is_between(closed):
    both(lambda m, d: d.select(
        m.col("i").is_between(-5, 5, closed).alias("i"),
        m.col("f").is_between(m.col("f32"), 4.0, closed).alias("f"),
        m.col("s").is_between("w2", "w5", closed).alias("s")))


def test_is_in_and_replace():
    both(lambda m, d: d.select(
        m.col("i").is_in([1, 2, 3, -7]).alias("i"),
        m.col("i").is_in([1, None]).alias("in"),
        m.col("f32").is_in([]).alias("e"),
        m.col("s").is_in(["w1", "w4", "zz"]).alias("s"),
        m.col("i").replace([1, 2], [100, 200]).alias("r"),
        m.col("s").replace({"w1": "one", "w2": "w3"}).alias("rs")))


def test_hash():
    both(lambda m, d: d.select([m.col(c).hash(7).alias(c)
                                for c in ("f", "f32", "i", "u", "l", "b8",
                                          "bo")]))


def test_rows_of_their_own():
    """drop_nulls, gather_every and slices keep their own rows."""
    both(lambda m, d: d.select(m.col("i").drop_nulls().alias("d")))
    both(lambda m, d: d.filter(m.col("k") != 2).select(
        m.col("f32").gather_every(3, 1).alias("g")))
    both(lambda m, d: d.select(m.col("u").head(7).alias("h")))
    both(lambda m, d: d.select(m.col("u").tail(5).alias("t")))


def test_row_index_and_search_sorted():
    both(lambda m, d: d.filter(m.col("k") > 2).select(
        m.row_index().alias("r"), m.col("i")))
    srt = {"x": np.sort(DATA["l"]), "y": DATA["i"]}
    both(lambda m, d: d.select(
        m.col("x").search_sorted(0).alias("a"),
        m.col("x").search_sorted(DATA["l"][5], side="left").alias("b")),
        frame=frames(srt, {}))


@pytest.mark.parametrize("desc", [False, True])
def test_sort_by_and_sort(desc):
    both(lambda m, d: d.filter(m.col("k") != 1).select(
        m.col("f32").sort_by("k", descending=desc).alias("one"),
        m.col("u").sort_by("k", "l", descending=[desc, not desc])
        .alias("two"),
        m.col("f32").sort(descending=desc).alias("self"),
        m.row_index().sort_by("k", "u", descending=desc).alias("arg")))


GROUP_AGGS = [("skew", {}), ("kurtosis", {}), ("kurtosis", {"fisher": False,
                                                            "bias": False}),
              ("skew", {"bias": False}), ("nan_min", {}), ("nan_max", {}),
              ("entropy", {}), ("bitwise_and", {}), ("bitwise_or", {}),
              ("bitwise_xor", {})]


@pytest.mark.parametrize("agg,kw", GROUP_AGGS,
                         ids=[f"{a}{'-' + str(k) if k else ''}"
                              for a, k in GROUP_AGGS])
@pytest.mark.parametrize("key", ["k", "h", "f32"])
def test_group_aggregates(agg, kw, key):
    """On the dense tier (k), the hash tier (h) and the sorted tier (a
    float key)."""
    cols = ["i", "u", "l", "bo"] if agg.startswith("bitwise") else \
        ["f32", "i", "u"]
    rtol = 1e-10 if agg in ("skew", "kurtosis", "entropy") else 0.0
    both(lambda m, d: d.group_by(m.col(key).round(0).alias("g") if key ==
                                 "f32" else key).agg(
        [getattr(m.col(c), agg)(**kw).alias(c) for c in cols])
        .sort("g" if key == "f32" else key), rtol=rtol)


def test_frames_of_series_and_series_reductions():
    a = pt.Series("a", [1, 2, 3], device="cpu")
    b = pt.Series("b", [0.5, None, 2.5], device="cpu")
    df = pt.DataFrame([a, b])
    assert df.to_dict() == {"a": [1, 2, 3], "b": [0.5, None, 2.5]}
    assert pt.DataFrame(b).columns == ["b"]
    with pt.Config(device="cpu"):
        d = pt.DataFrame({"d": pt.date_range(
            pydt.date(2024, 1, 1), pydt.date(2024, 1, 3), eager=True),
            "v": [1, 2, 3]})
    assert d.height == 3 and d.columns == ["d", "v"]
    assert a.mean() == 2.0 and b.mean() == 1.5 and b.sum() == 3.0
    assert a.to_frame().to_dict() == {"a": [1, 2, 3]}
    assert a.to_frame("z").columns == ["z"]


def test_frame_reductions_and_describe():
    cols = {k: DATA[k] for k in ("f", "f32", "i", "u", "s")}
    valid = {"f": VALID["f"]}
    fr = frames(cols, valid)
    for meth in ("sum", "mean", "min", "max", "median", "null_count"):
        both(lambda m, d: getattr(d, meth)(), frame=fr, rtol=1e-12)
    # a Boolean column: the JAX package's min, max and median refuse it
    fr = frames({**cols, "bo": DATA["bo"]}, valid)
    both(lambda m, d: d.std(), frame=fr, rtol=1e-10)
    both(lambda m, d: d.drop_nulls(), frame=fr)
    both(lambda m, d: d.drop_nulls("f"), frame=fr)
    both(lambda m, d: d.tail(7), frame=fr)
    both(lambda m, d: d.describe(), frame=fr, rtol=1e-10)


@pytest.mark.parametrize("how", ["tail", "slice", "limit", "first", "last"])
def test_lazy_row_ops(how):
    call = {"tail": lambda lf: lf.tail(6), "slice": lambda lf: lf.slice(3, 5),
            "limit": lambda lf: lf.limit(4), "first": lambda lf: lf.first(),
            "last": lambda lf: lf.last()}[how]
    both(lambda m, d: call(d.lazy().filter(m.col("k") > 0)).collect())


def test_exceptions_namespace():
    E = pt.exceptions
    assert E.ColumnNotFoundError is pt.ColumnNotFoundError
    assert E.PolarsError is pt.PolaroidError
    assert issubclass(E.SchemaFieldNotFoundError, E.PolarsError)
    with pytest.raises(pt.exceptions.ColumnNotFoundError):
        T.select(pt.col("nope"))
