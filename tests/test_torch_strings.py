"""Strings (Slice E2) through the JAX package and the port.

The same seeded columns (words with spaces, case, digits, accents and
nulls; numbers, dates, times and JSON as text; bytes) go through
`polaroid_tpu` (its CPU path) and `polaroid_tpu_torch` with
device="cpu": every op of the `str` namespace, batched into a few
selects; casts between String and Float64, Int64, Boolean, Binary and
Categorical (strict and not); `concat_str` and `pl.format`; the `bin`
namespace; the cat namespace's string ops; and `chip_smoke.py`'s phase-14
P1 and P2 at 2^12 trades, against the JAX package and against their
numpy oracle. The numpy word-sort encoder of fixed-width unicode arrays
is held to `np.unique`, and a cast to String and `concat_str` are shown
to format each distinct value once.

Tolerances: strings, counts, integers, dates and every null exact;
parsed floats bit for bit; P1's Float32 mean within one ulp of the f64
mean (the oracle's bound). Where the port departs from the JAX package
it is held to Python or polars: a strptime to Datetime("ms") takes the
dtype's unit (the JAX package keeps "us").
"""

import math
import pathlib
import sys

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
from polaroid_tpu_torch.expr import eval as E
from polaroid_tpu_torch.strings import StringDict

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

N = 240
WORDS = ["apple pie", "Banana", "cherry  tart", " date ", "élan vital",
         "FIG", "grape-fruit", "", "kiwi 42", "lemon_7 x", "a1b2c3",
         "Mango Tango", "naïve café", "ab ab ab"]


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


def _col(rng, pool, null_frac=0.1):
    vals = [pool[i] for i in rng.integers(0, len(pool), N)]
    return [None if rng.random() < null_frac else v for v in vals]


def _data():
    rng = np.random.default_rng(31)
    return {
        "s": _col(rng, WORDS),
        "t": _col(rng, ["x", "yy", "zzz", "BRK A", "A.B"]),
        "num": _col(rng, ["1", "-23", "4.5", "abc", " 7", "1e3", "99",
                          "0.25"]),
        "ints": _col(rng, ["1", "-23", "7", "99", "1024"]),
        "day": _col(rng, ["20240304", "20240315", "19991231", "20000229"]),
        "clock": _col(rng, ["09:30:00", "16:00:00", "12:34:56"]),
        "stamp": _col(rng, ["2024-03-04T14:30:00", "1999-12-31T23:59:59"]),
        "js": _col(rng, ['{"a": 1, "b": "x"}', '{"a": 2, "b": null}',
                         "not json"]),
        "jl": _col(rng, ["[1, 2]", "[3]", "[]"]),
        "hex": _col(rng, ["6869", "414243", "zz"]),
        "f": [None if rng.random() < 0.1 else float(v)
              for v in np.round(rng.normal(0, 50, N), 3)],
        "i": [int(v) for v in rng.integers(-500, 500, N)],
        "b": [bool(v) for v in rng.random(N) > 0.5],
    }


DATA = _data()
R = ref.DataFrame(dict(DATA))
T = pt.DataFrame(dict(DATA), device="cpu")


def _eq(a, b, rtol=0.0):
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_eq(x, y, rtol) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(_eq(a[k], b[k], rtol) for k in a)
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or abs(a - b) <= rtol * abs(b)
    return a == b and type(a) is type(b) or (a == b and isinstance(a, int)
                                             and isinstance(b, int))


def same(got, want, rtol=0.0):
    g, w = got.to_dict(), want.to_dict()
    assert list(g) == list(w), (list(g), list(w))
    for k in w:
        assert len(g[k]) == len(w[k]), k
        for i, (a, b) in enumerate(zip(g[k], w[k])):
            assert _eq(a, b, rtol), (k, i, a, b)
    assert {k: _name(v) for k, v in got.schema.items()} == \
        {k: _name(v) for k, v in want.schema.items()}


def _name(dt) -> str:
    """A dtype's name (the JAX package gives some as the class)."""
    return repr(dt() if isinstance(dt, type) else dt)


def both(make, rtol=0.0):
    same(make(pt, T), make(ref, R), rtol)


def _ops(pl):
    c = pl.col
    return {
        "case": [c("s").str.to_uppercase().alias("up"),
                 c("s").str.to_lowercase().alias("lo"),
                 c("s").str.to_titlecase().alias("title"),
                 c("s").str.len_chars().alias("nc"),
                 c("s").str.len_bytes().alias("nb"),
                 c("s").str.reverse().alias("rev")],
        "strip": [c("s").str.strip_chars().alias("a"),
                  c("s").str.strip_chars_start().alias("b"),
                  c("s").str.strip_chars_end("e ").alias("c"),
                  c("s").str.strip_prefix("ap").alias("d"),
                  c("s").str.strip_suffix("ie").alias("e"),
                  c("t").str.zfill(5).alias("f"),
                  c("t").str.pad_start(6, "*").alias("g"),
                  c("t").str.pad_end(6).alias("h")],
        "match": [c("s").str.contains("an", literal=True).alias("a"),
                  c("s").str.contains(r"\d+").alias("b"),
                  c("s").str.starts_with("a").alias("c"),
                  c("s").str.ends_with("e").alias("d"),
                  c("s").str.count_matches("a", literal=True).alias("e"),
                  c("s").str.count_matches(r"[aeiou]").alias("f"),
                  c("s").str.find("a", literal=True).alias("g"),
                  c("s").str.find(r"\s").alias("h"),
                  c("s").str.contains_any(["pie", "FIG"]).alias("i"),
                  c("s").str.contains_any(["fig"], ascii_case_insensitive=True)
                  .alias("j")],
        "replace": [c("s").str.replace("a", "A", literal=True).alias("a"),
                    c("s").str.replace(r"(\w)(\d)", "$2$1").alias("b"),
                    c("s").str.replace_all("a", "-", literal=True)
                    .alias("c"),
                    c("s").str.replace_all(r"\s+", "_").alias("d"),
                    c("s").str.replace_many(["a", "e"], ["4", "3"])
                    .alias("e"),
                    c("s").str.slice(1, 3).alias("f"),
                    c("s").str.slice(-3).alias("g"),
                    c("s").str.head(2).alias("h"),
                    c("s").str.tail(2).alias("i"),
                    c("s").str.extract(r"(\w+) (\w+)", 2).alias("j")],
        "split": [c("s").str.split(" ").alias("a"),
                  c("s").str.extract_all(r"[a-z]+").alias("b"),
                  c("s").str.extract_many(["a", "ab"]).alias("c"),
                  c("s").str.find_many(["a", "b"]).alias("d"),
                  c("s").str.split_exact(" ", 1).alias("e"),
                  c("s").str.splitn(" ", 2).alias("f"),
                  c("s").str.extract_groups(r"(?P<w>\w+)\s(\w)")
                  .alias("g")],
        "parse": [c("ints").str.to_integer().alias("a"),
                  c("hex").str.to_integer(base=16).alias("b"),
                  c("num").str.to_decimal().alias("c"),
                  c("day").str.strptime(pl.Date, "%Y%m%d").alias("d"),
                  c("day").str.to_date("%Y%m%d").alias("e"),
                  c("stamp").str.to_datetime().alias("f"),
                  c("stamp").str.strptime(pl.Datetime("us"),
                                          "%Y-%m-%dT%H:%M:%S").alias("g"),
                  c("clock").str.to_time("%H:%M:%S").alias("h")],
        "encode": [c("s").str.encode("hex").alias("a"),
                   c("s").str.encode("base64").alias("b"),
                   c("hex").str.decode("hex").alias("c"),
                   c("s").str.escape_regex().alias("d"),
                   c("s").str.normalize("NFD").alias("e"),
                   c("js").str.json_path_match("$.a").alias("f"),
                   c("js").str.json_path_match("$.b").alias("g")],
    }


@pytest.mark.parametrize("group", ["case", "strip", "match", "replace",
                                   "split", "parse", "encode"])
def test_str_ops_match_jax(group):
    both(lambda pl, df: df.select(_ops(pl)[group]))


def test_str_json_decode_and_concat():
    both(lambda pl, df: df.select(pl.col("js").str.json_decode(),
                                  pl.col("jl").str.json_decode()))
    for delim in ("-", ""):
        both(lambda pl, df: df.select(
            pl.col("t").str.concat(delim).alias("j"),
            pl.col("s").str.join(delim, ignore_nulls=True).alias("k")))


def test_json_decode_nested_objects():
    # the JAX package cannot hold a struct inside a decoded struct
    # (its val_to_column reads the inner struct's data): held to json
    texts = ['{"a": 1, "b": {"c": "x"}}', None, '{"a": 2, "b": {"c": null}}',
             "not json", '{"a": 3, "b": {"c": "y"}}']
    df = pt.DataFrame({"js": texts}, device="cpu")
    got = df.select(pt.col("js").str.json_decode()).to_dict()["js"]
    import json
    assert got == [json.loads(t) if t not in (None, "not json") else None
                   for t in texts]


def test_str_ops_after_a_filter_and_in_a_group_by():
    both(lambda pl, df: df.filter(pl.col("i") > 0).select(
        pl.col("s").str.to_uppercase(), pl.col("s").str.len_chars()
        .alias("n")))
    both(lambda pl, df: df.with_columns(
        k=pl.col("t").str.to_lowercase()).group_by("k").agg(
        pl.col("i").sum()).sort("k"))


@pytest.mark.parametrize("dtype", ["Float64", "Int64", "Boolean"])
def test_cast_from_string(dtype):
    both(lambda pl, df: df.select(
        pl.col("ints").cast(getattr(pl, dtype), strict=False).alias("a"),
        pl.col("num").cast(getattr(pl, dtype), strict=False).alias("b")))
    both(lambda pl, df: df.select(pl.col("ints").cast(getattr(pl, dtype))))
    with pytest.raises(pt.InvalidOperationError):
        T.select(pt.col("num").cast(pt.Int64))


def test_cast_to_string():
    both(lambda pl, df: df.select(
        pl.col("f").cast(pl.String).alias("f"),
        pl.col("i").cast(pl.String).alias("i"),
        pl.col("b").cast(pl.String).alias("b"),
        pl.col("f").round(1).cast(pl.String).cast(pl.Float64).alias("rt"),
        pl.col("day").str.strptime(pl.Date, "%Y%m%d").cast(pl.String)
        .alias("d")))


def test_cast_to_string_formats_each_distinct_value_once():
    rows = 4096
    df = pt.DataFrame({"x": np.tile(np.array([1.5, -2.0, 3.25, 0.1, 7.0]),
                                    rows // 5 + 1)[:rows],
                       "s": np.array(["a", "b"])[np.arange(rows) % 2]},
                      device="cpu")
    before = E.FORMAT_CALLS[0]
    out = df.select(pt.col("x").cast(pt.String))
    # 5 values, and the padding rows' 0 when the capacity has any
    assert E.FORMAT_CALLS[0] - before <= 6
    assert out.to_dict()["x"][:5] == ["1.5", "-2.0", "3.25", "0.1", "7.0"]
    before = E.FORMAT_CALLS[0]
    out = df.select(pt.concat_str([pt.col("s"), pt.col("x")],
                                  separator="|").alias("v"))
    # the 5 floats (+ the padding's 0), then the 10 distinct (s, x)
    # pairs joined (+ the padding's)
    assert E.FORMAT_CALLS[0] - before <= 17
    assert out.to_dict()["v"][:3] == ["a|1.5", "b|-2.0", "a|3.25"]


def test_concat_str_and_format():
    both(lambda pl, df: df.select(
        pl.concat_str([pl.col("s"), pl.col("t")], separator="/")
        .alias("a"),
        pl.concat_str([pl.col("t"), pl.col("i"), pl.col("b")]).alias("b"),
        pl.concat_str(["t", pl.lit("!")], separator=" ").alias("c"),
        pl.format("{} has {}", pl.col("t"), pl.col("i")).alias("d")))


def test_string_comparisons_and_categorical():
    both(lambda pl, df: df.select(
        (pl.col("s") == pl.col("t")).alias("a"),
        (pl.col("s") < "c").alias("b"),
        (pl.col("t") >= pl.lit("yy")).alias("c"),
        pl.col("t").cast(pl.Categorical).cast(pl.String).alias("d"),
        pl.col("t").cast(pl.Categorical).cat.len_chars().alias("e"),
        pl.col("t").cast(pl.Categorical).cat.starts_with("z").alias("f")))


BYTES = [b"\x00ab", b"hello", b"\xff\xfe", None, b"", b"\x01\x02\x03\x04",
         b"abcd", b"hello"]


def _bin_frames():
    cols = {"b": BYTES, "k": list(range(len(BYTES)))}
    return ref.DataFrame(dict(cols)), pt.DataFrame(dict(cols), device="cpu")


def test_bin_namespace():
    r, t = _bin_frames()

    def ops(pl, df):
        c = pl.col("b")
        return df.select(c.bin.contains(b"ab").alias("a"),
                         c.bin.starts_with(b"he").alias("b"),
                         c.bin.ends_with(b"\x04").alias("c"),
                         c.bin.size().alias("d"),
                         c.bin.slice(1, 2).alias("e"),
                         c.bin.head(1).alias("f"),
                         c.bin.tail(2).alias("g"),
                         c.bin.encode("hex").alias("h"),
                         c.bin.encode("base64").alias("i"))
    same(ops(pt, t), ops(ref, r))
    same(t.select(pt.col("b").bin.encode("hex").str.decode("hex")
                  .alias("x")),
         r.select(ref.col("b").bin.encode("hex").str.decode("hex")
                  .alias("x")))
    assert t.schema["b"] == pt.Binary()
    assert t.to_dict()["b"] == BYTES


def test_binary_casts_and_reinterpret():
    r, t = _bin_frames()
    with pytest.raises(pt.InvalidOperationError):
        t.select(pt.col("b").cast(pt.String))
    four = {"b": [b"\x01\x00\x00\x00", b"\xff\xff\xff\xff", b"abcd"]}
    rf, tf = ref.DataFrame(dict(four)), pt.DataFrame(dict(four),
                                                     device="cpu")
    for e in (lambda pl: pl.col("b").bin.reinterpret(dtype=pl.Int32),
              lambda pl: pl.col("b").bin.reinterpret(
                  dtype=pl.UInt32, endianness="big")):
        same(tf.select(e(pt)), rf.select(e(ref)))
    # the invalid row filtered away, the strict cast holds: the JAX
    # package checks every dictionary entry and raises; held to polars
    out = t.filter(pt.col("k") != 2).select(
        pt.col("b").cast(pt.String).alias("s"),
        pt.col("b").cast(pt.String).cast(pt.Binary).alias("rt")).to_dict()
    kept = [b for k, b in enumerate(BYTES) if k != 2]
    assert out["s"] == [None if b is None else b.decode() for b in kept]
    assert out["rt"] == kept


def test_json_path_match_with_no_match_is_null():
    # the JAX package decodes an empty dictionary's codes as -1
    out = T.select(pt.col("js").str.json_path_match("$.b.c")).to_dict()
    assert out["js"] == [None] * N


def test_series_str_and_bin_namespaces():
    s = pt.Series("s", DATA["s"], device="cpu")
    w = ref.Series("s", DATA["s"])
    assert s.str.to_uppercase().to_list() == w.str.to_uppercase().to_list()
    assert s.str.len_chars().to_list() == w.str.len_chars().to_list()
    b = pt.Series("b", BYTES, device="cpu")
    assert b.bin.size().to_list() == ref.Series("b", BYTES).bin.size() \
        .to_list()


def test_fixed_width_unicode_encode_matches_np_unique():
    rng = np.random.default_rng(5)
    for pool in (["BRK A", "A", "ZZ", "", "AB", "é", "日本"],
                 ["x" * 20 + "b", "x" * 20 + "a", "x" * 20, "x" * 21, "y",
                  "x" * 17]):
        a = np.array(pool)[rng.integers(0, len(pool), 3000)]
        codes, sd = StringDict.encode(a)
        uniq, inv = np.unique(a, return_inverse=True)
        assert list(sd.values) == list(uniq)
        assert np.array_equal(codes, inv)
        m = rng.random(3000) > 0.3
        codes, sd = StringDict.encode(a, m)
        assert (codes[~m] == -1).all()
        assert list(sd.values[codes[m]]) == list(a[m])
        assert list(sd.values) == sorted(set(a[m].tolist()))


def test_dictionary_bounds():
    sd = StringDict(np.array(["a", "c", "e"], dtype=object))
    assert (sd.lower_bound("c"), sd.upper_bound("c")) == (1, 2)
    assert (sd.lower_bound("d"), sd.upper_bound("d")) == (2, 2)
    assert sd.find("e") == 2 and sd.find("b") is None
    assert list(sd.map_to_array(len, np.int64)) == [1, 1, 1]


# --- chip_smoke.py's phase 14: P1 and P2 at 2^12 trades ---------------------

def _taq():
    d, x = CS.make_taq_data(1 << 12, 0)
    cols = {k: d[k] for k in ("sym", "ex", "cond", "date", "price",
                              "volume")}
    cols["ts"] = d["ts"].astype("datetime64[us]")
    return d, x, ref.DataFrame(cols), CS.taq_frame(pt, d, "cpu")


TAQ = _taq()


@pytest.mark.parametrize("name", ["P1", "P2"])
def test_phase14_query_matches_jax_and_oracle(name):
    d, x, rdf, tdf = TAQ
    (lf,) = [q for n, q, *_ in CS.taq_queries(pt, tdf) if n == name]
    (lr,) = [q for n, q, *_ in CS.taq_queries(ref, rdf) if n == name]
    got, want = lf.collect(), lr.collect()
    CS.taq_oracle(name, CS._taq_cols(got), d, x)
    if name == "P1":
        got, want = got.sort(["day", "venue"]), want.sort(["day", "venue"])
    same(got, want)
