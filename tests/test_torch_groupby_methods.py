"""The group-by methods of `GroupBy` and `LazyGroupBy` through the JAX
package and the port.

`having`, `head`, `tail`, `all`, the iteration, `map_groups`/`apply`,
`len`, `count`, `sum`, `mean`, `min`, `max`, `first`, `last`, `median`,
`n_unique` and `quantile`, eager and lazy, on the same seeded data: 300
rows with a small-domain key `k` (the dense tier), two keys (`k`, `g`),
a String key `ks`, and Int32, Int64, Float64 (NaN and nulls), Boolean
and String (nulls) values; under `k`, the same frame after a filter
(masked rows) and after a sort (the capacity's pad); and 2^14 rows with a key of
6000 values (the hash tier). `polaroid_tpu` runs on its CPU path,
`polaroid_tpu_torch` with device="cpu" (the card's path, with the
kernels' plain versions); the decomposable methods also through the
port's `collect(engine="streaming")` over the frame cut into three
batches.

Kept differences, held to explicit values or numpy:
* `sum`, `mean`, `median` and `quantile` over a String column give that
  column as nulls in the port, as polars does; the JAX package does
  arithmetic on the dictionary codes (it sums ["a", "b"] to 1).
* `min` and `max` over a Boolean column: the JAX package raises, the
  port gives numpy's answer (False < True).

Tolerances: keys, integers, counts, min/max/first/last, n_unique, the
rows of head/tail/all/the iteration, medians and quantiles bit for bit
(NaN and -0.0 included); Float64 sums and means within 1e-12 of the
group's sum of |x| (both sides sum in f64 in another order).
"""

import math
import struct

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
from polaroid_tpu_torch.ops import hgroup as TH


@pytest.fixture(autouse=True, scope="module")
def _fresh_reference_cache():
    """The JAX package's process-wide caches can hand this file's plans
    another frame's results (`tests/test_torch_reference_caches.py`)."""
    from test_torch_reference_caches import fresh_reference_caches
    with fresh_reference_caches():
        yield


N = 300


def _data(n=N, seed=21):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 10, n)
    f[rng.random(n) < 0.08] = np.nan
    f[rng.integers(0, n, 4)] = -0.0
    b = (rng.random(n) < 0.5).tolist()
    s = [f"w{x}" for x in rng.integers(0, 9, n)]
    for i in np.flatnonzero(rng.random(n) < 0.1):
        s[i] = None
    return {"k": rng.integers(0, 7, n).tolist(),
            "g": rng.integers(0, 3, n).tolist(),
            "ks": [f"s{x}" for x in rng.integers(0, 5, n)],
            "i32": rng.integers(-100, 100, n).astype(np.int32),
            "i64": rng.integers(-10**12, 10**12, n).tolist(),
            "f": [None if m else x for x, m in zip(f.tolist(),
                                                   rng.random(n) < 0.1)],
            "b": b, "s": s}


DATA = _data()
HASH_N = 1 << 14


def _hash_data(seed=22):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 10, HASH_N)
    f[rng.random(HASH_N) < 0.05] = np.nan
    return {"h": rng.integers(0, 6000, HASH_N),
            "i64": rng.integers(-10**9, 10**9, HASH_N),
            "f": f}


HASH = _hash_data()


def _frame(pkg, d):
    return pkg.DataFrame(d, device="cpu") if pkg is pt else pkg.DataFrame(d)


def _frames(pkg):
    """{kind: eager frame}: the frame, after a filter that masks about a
    quarter of its rows, and sorted by i64."""
    df = _frame(pkg, DATA)
    return {"plain": df, "filter": df.filter(pkg.col("i32") > -50),
            "sort": df.sort("i64")}


REF_FRAMES = _frames(ref)
PT_FRAMES = _frames(pt)
KEYS = {"dense": ["k"], "two": ["k", "g"], "string": ["ks"]}

# method -> its arguments
METHODS = {"sum": (), "mean": (), "min": (), "max": (), "first": (),
           "last": (), "median": (), "n_unique": (), "quantile": (0.3,),
           "len": (), "count": (), "all": (), "head": (2,), "tail": (2,)}
# the String columns of these are nulls in the port (kept difference)
ARITH = {"sum", "mean", "median", "quantile"}
CLOSE = {"sum", "mean"}
# what the streaming engine decomposes batch by batch
STREAMED = ("sum", "mean", "min", "max", "len", "count", "first", "last")


def _bits(x):
    return struct.pack("<d", x)


def _same_value(g, w, close, scale, what):
    if w is None or g is None:
        assert g is None and w is None, what
    elif isinstance(w, list):
        assert isinstance(g, list) and len(g) == len(w), what
        for a, b in zip(g, w):
            _same_value(a, b, False, 0.0, what)
    elif isinstance(w, float):
        if close and not math.isnan(w):
            assert abs(g - w) <= 1e-12 * scale, (what, g, w)
        else:
            assert _bits(float(g)) == _bits(w), (what, g, w)
    else:
        assert g == w, (what, g, w)


def _same(got, want, what, close=(), scales=None, sort_by=None):
    """Column names, dtypes and values of two frames of either package;
    `close` columns within 1e-12 of `scales[col][row]`; rows ordered by
    `sort_by` first where given."""
    assert got.columns == want.columns, (what, got.columns, want.columns)
    assert [str(t) for t in got.dtypes] == [str(t) for t in want.dtypes], \
        (what, got.dtypes, want.dtypes)
    gd, wd = got.to_dict(), want.to_dict()
    if sort_by:
        gd, wd = _sorted(gd, sort_by), _sorted(wd, sort_by)
    for c in want.columns:
        assert len(gd[c]) == len(wd[c]), (what, c)
        for i, (g, w) in enumerate(zip(gd[c], wd[c])):
            scale = scales[c][i] if c in close else 0.0
            _same_value(g, w, c in close, scale, (what, c, i))


def _sorted(d, by):
    order = sorted(range(len(d[by[0]])),
                   key=lambda i: tuple((d[k][i] is None, d[k][i])
                                       for k in by))
    return {c: [v[i] for i in order] for c, v in d.items()}


def _abs_sums(pkg, df, keys, sort_by=None):
    """{col: per-group sum of |x|} of the Float64 and integer columns, in
    the order of the method's output, the bound of sum/mean."""
    out = df.group_by(keys, maintain_order=True).agg(
        [pkg.col(c).abs().sum().alias(c) for c in ("f", "i32", "i64")
         if c in df.columns]).to_dict()
    if sort_by:
        out = _sorted(out, sort_by)
    return out


def _close(method):
    """The columns held within a bound rather than bit for bit."""
    return {"f", "i32", "i64"} if method in CLOSE else ()


def _call(g, method, lazy, **collect):
    out = getattr(g, method)(*METHODS[method])
    return out.collect(**collect) if lazy else out


def _strings_null(out, method, keys):
    """The port's String value columns of an arithmetic method are nulls
    of String (kept difference); returns the other columns' names."""
    keep = []
    for c, t in zip(out.columns, out.dtypes):
        if c not in keys and method in ARITH and str(t) == "String":
            assert all(v is None for v in out.get_column(c).to_list()), c
        else:
            keep.append(c)
    return keep


VALUES = ["i32", "i64", "f", "b", "s"]


def _values(frame, keys):
    """The keys and the value columns (no other key column)."""
    return frame.select(keys + VALUES)


def _ref_result(method, keys, kind, frame):
    """The JAX package's eager result over the keys and VALUES; its
    Boolean min/max raise, so those two run without `b` (held to numpy
    in test_boolean_min_max)."""
    frame = _values(frame, keys)
    if method in ("min", "max"):
        frame = frame.drop("b")
    g = frame.group_by(keys, maintain_order=True)
    return _call(g, method, False)


# (frame kind, key): the holes of a filter and a sort under the dense
# key; the two keys and the String key on the plain frame
CASES = [("plain", "dense"), ("filter", "dense"), ("sort", "dense"),
         ("plain", "two"), ("plain", "string")]


@pytest.mark.parametrize("kind,keys", CASES)
@pytest.mark.parametrize("method", sorted(METHODS))
def test_method_matches_reference(method, kind, keys):
    """Each method, eager and lazy in the port, against the JAX package's
    eager result (maintain_order=True: the groups in the order of their
    first rows)."""
    k = KEYS[keys]
    want = _ref_result(method, k, kind, REF_FRAMES[kind])
    df = _values(PT_FRAMES[kind], k)
    scales = _abs_sums(pt, df, k) if method in CLOSE else None
    for lazy in (False, True):
        src = df.lazy() if lazy else df
        got = _call(src.group_by(k, maintain_order=True), method, lazy)
        if method in ("min", "max"):
            got = got.drop("b")
        cols = _strings_null(got, method, k)
        _same(got.select(cols), want.select(cols),
              (method, kind, keys, lazy), close=_close(method),
              scales=scales)


@pytest.mark.parametrize("method", ["sum", "mean", "median", "first",
                                    "n_unique", "len", "all", "head"])
def test_lazy_reference_agrees(method):
    """The JAX package's lazy form of a method gives its eager result,
    and the port's lazy form the same, over the String key after the
    filter."""
    k = KEYS["string"]
    rdf, pdf = (_values(f["filter"], k) for f in (REF_FRAMES, PT_FRAMES))
    want = _call(rdf.lazy().group_by(k, maintain_order=True), method, True)
    eager = _ref_result(method, k, "filter", rdf)
    _same(want, eager, ("ref lazy", method), close=_close(method),
          scales=_abs_sums(ref, rdf, k))
    got = _call(pdf.lazy().group_by(k, maintain_order=True), method, True)
    cols = _strings_null(got, method, k)
    _same(got.select(cols), want.select(cols), ("port lazy", method),
          close=_close(method), scales=_abs_sums(pt, pdf, k))


def _batches(pkg, kind):
    """The frame cut into three batches of 100, 90 and 110 rows (a lazy
    union), filtered as `kind` says."""
    base = _frame(pkg, DATA)
    lf = pkg.concat([base.slice(0, 100).lazy(), base.slice(100, 90).lazy(),
                     base.slice(190, 110).lazy()])
    return lf.filter(pkg.col("i32") > -50) if kind == "filter" else lf


@pytest.mark.parametrize("kind", ["plain", "filter"])
@pytest.mark.parametrize("method", STREAMED)
def test_streaming_matches_reference(method, kind):
    """collect(engine="streaming") over the frame cut into three batches
    against the JAX package's eager result; groups ordered by key (the
    streaming merge keeps no first-row order). The streaming engines of
    both packages count (len, count, a Boolean's sum) in Int64 where the
    in-memory group-by gives UInt32 (`test_streaming_counts_in_int64`);
    the JAX package's streaming collect of these batches is not the
    oracle: it counts 39 rows where a group has 41 (its compiled chains
    keep the first batch's row count)."""
    k = KEYS["dense"]
    want = _ref_result(method, k, kind, REF_FRAMES[kind])
    got = _call(_values(_batches(pt, kind), k).group_by(k), method, True,
                engine="streaming")
    if method in ("min", "max"):
        got = got.drop("b")
    cols = _strings_null(got, method, k)
    counts = {"len", "count"} if method in ("len", "count") else \
        {"b"} if method == "sum" else set()
    for c, t in zip(want.columns, want.dtypes):
        if c in counts:
            assert str(t) == "UInt32" and \
                str(got.schema[c]) == "Int64", (method, c)
            want = want.with_columns(ref.col(c).cast(ref.Int64))
    scales = _abs_sums(pt, PT_FRAMES[kind], k, sort_by=k) \
        if method in CLOSE else None
    _same(got.select(cols), want.select(cols), (method, kind, "streaming"),
          close=_close(method), scales=scales, sort_by=k)


def test_streaming_counts_in_int64():
    """The JAX package's streaming engine also gives len and a Boolean's
    sum as Int64 over batches."""
    for pkg in (ref, pt):
        out = _batches(pkg, "plain").group_by("k").agg(
            pkg.len(), pkg.col("b").sum()).collect(engine="streaming")
        assert [str(out.schema[c]) for c in ("len", "b")] == \
            ["Int64", "Int64"], pkg.__name__


@pytest.fixture(scope="module")
def hash_frames():
    return _frame(ref, HASH), _frame(pt, HASH)


@pytest.mark.parametrize("method", ["sum", "mean", "min", "max", "first",
                                    "last", "len", "n_unique", "median"])
def test_hash_tier_matches_reference(method, hash_frames, monkeypatch):
    """A key of 6000 values over 2^14 rows, eager and lazy: the port
    groups it on the hash tier (`hgroup.group_ids` is called); groups
    compared by key."""
    calls = []
    orig = TH.group_ids
    monkeypatch.setattr(TH, "group_ids",
                        lambda *a: calls.append(1) or orig(*a))
    rdf, pdf = hash_frames
    want = _call(rdf.group_by("h"), method, False)
    scales = _abs_sums(pt, pdf, ["h"], sort_by=["h"]) \
        if method in CLOSE else None
    for lazy in (False, True):
        calls.clear()
        src = pdf.lazy() if lazy else pdf
        got = _call(src.group_by("h"), method, lazy)
        assert calls, "the port did not take the hash tier"
        _same(got, want, (method, lazy), close=_close(method),
              scales=scales, sort_by=["h"])


@pytest.mark.parametrize("kind", ["plain", "filter", "sort"])
@pytest.mark.parametrize("keys", ["dense", "two"])
def test_having(kind, keys):
    """having() with two predicates, eager and lazy."""
    k = KEYS[keys]

    def q(pkg, g):
        c = pkg.col
        return g.having(c("i32").sum() > 0, c("i64").mean() > -2e11).agg(
            c("i64").sum(), c("f").mean().alias("fm"), pkg.len())
    want = q(ref, REF_FRAMES[kind].group_by(k, maintain_order=True))
    assert 0 < want.height
    df = PT_FRAMES[kind]
    for lazy in (False, True):
        g = (df.lazy() if lazy else df).group_by(k, maintain_order=True)
        got = q(pt, g)
        got = got.collect() if lazy else got
        assert not any(c.startswith("__pt_having") for c in got.columns)
        _same(got.drop("fm"), want.drop("fm"), ("having", kind, lazy))
        _same_fm(got, want, ("having fm", kind, lazy))


def _same_fm(got, want, what):
    """having's Float64 means within 1e-9: 1e-12 of 1000, above every
    group's sum of |f| (about 45 values of about 8)."""
    for g, w in zip(got.get_column("fm").to_list(),
                    want.get_column("fm").to_list()):
        if w is None or g is None or math.isnan(w):
            _same_value(g, w, False, 0.0, what)
        else:
            assert abs(g - w) <= 1e-12 * 1000, (what, g, w)


@pytest.mark.parametrize("keys,kind", [(k, f) for f, k in CASES])
def test_iteration_and_map_groups(kind, keys):
    """The (key, sub-frame) pairs in first-row order, and map_groups /
    apply / the lazy map_groups of the first two rows of each group."""
    k = KEYS[keys]
    rdf, pdf = REF_FRAMES[kind], PT_FRAMES[kind]
    want = list(rdf.group_by(k))
    got = list(pdf.group_by(k))
    assert [key for key, _ in got] == [key for key, _ in want]
    for (key, g), (_, w) in zip(got, want):
        _same(g, w, ("iter", kind, keys, key))

    def fn(df):
        return df.head(2)
    want = rdf.group_by(k).map_groups(fn)
    _same(pdf.group_by(k).map_groups(fn), want, ("map_groups", kind))
    _same(pdf.group_by(k).apply(fn), want, ("apply", kind))
    _same(pdf.lazy().group_by(k).map_groups(fn).collect(), want,
          ("lazy map_groups", kind))
    _same(pdf.lazy().group_by(k).apply(fn).collect(), want,
          ("lazy apply", kind))


def test_len_name_and_quantile_interpolations():
    """len(name) and quantile under every interpolation, eager and
    lazy."""
    rdf, pdf = REF_FRAMES["filter"], PT_FRAMES["filter"]
    _same(pdf.group_by("k", maintain_order=True).len("n"),
          rdf.group_by("k", maintain_order=True).len("n"), "len(n)")
    _same(pdf.lazy().group_by("k", maintain_order=True).len(name="n")
          .collect(),
          rdf.group_by("k", maintain_order=True).len("n"), "lazy len(n)")
    for how in ("nearest", "lower", "higher", "midpoint", "linear"):
        want = rdf.drop("s", "ks").group_by("k", maintain_order=True) \
            .quantile(0.7, how)
        for src in (pdf.drop("s", "ks"), pdf.drop("s", "ks").lazy()):
            got = src.group_by("k", maintain_order=True).quantile(
                0.7, interpolation=how)
            got = got if hasattr(got, "height") else got.collect()
            _same(got, want, ("quantile", how))


def test_string_values_under_arithmetic_are_null():
    """Kept difference: sum/mean/median/quantile over String,
    Categorical, Binary and List value columns give nulls of the
    column's dtype in the port (the JAX package sums ["a", "b"] to 1);
    min/max/first/last/n_unique keep their strings."""
    d = {"k": [1, 1, 2], "s": ["a", "b", "c"], "i": [1, 2, 3]}
    df = pt.DataFrame(d, device="cpu").with_columns(
        pt.col("s").cast(pt.Categorical).alias("c"),
        pt.col("s").cast(pt.Binary).alias("bin"))
    assert ref.DataFrame(d).group_by("k", maintain_order=True).sum() \
        .to_dict()["s"] == [1, 2]
    for src in (df, df.lazy()):
        for m, args in (("sum", ()), ("mean", ()), ("median", ()),
                        ("quantile", (0.5,))):
            out = getattr(src.group_by("k", maintain_order=True), m)(*args)
            out = out if hasattr(out, "height") else out.collect()
            got = out.to_dict()
            assert got["k"] == [1, 2]
            for c in ("s", "c", "bin"):
                assert got[c] == [None, None], (m, c)
            assert [str(out.schema[c]) for c in ("s", "c", "bin")] == [
                "String", "Categorical", "Binary"], m
        out = src.group_by("k", maintain_order=True).max()
        out = out if hasattr(out, "height") else out.collect()
        assert out.to_dict()["s"] == ["b", "c"]
    # List columns: the JAX package raises, the port gives nulls
    for pkg in (ref, pt):
        nested = _frame(pkg, d).group_by("k", maintain_order=True).all() \
            .with_columns(pkg.col("k").alias("k2"))
        for src in ((nested, nested.lazy()) if pkg is pt else (nested,)):
            g = src.group_by("k2", maintain_order=True)
            if pkg is ref:
                with pytest.raises(Exception):
                    g.sum()
                continue
            out = g.sum()
            out = out if hasattr(out, "height") else out.collect()
            assert out.columns == ["k2", "k", "s", "i"]
            assert [str(t) for t in out.dtypes] == [
                "Int64", "Int64", "List(String)", "List(Int64)"]
            assert out.to_dict() == {"k2": [1, 2], "k": [1, 2],
                                     "s": [None, None], "i": [None, None]}


@pytest.mark.parametrize("kind", ["plain", "filter", "sort"])
def test_boolean_min_max(kind):
    """Kept difference: min/max over a Boolean column (with nulls), which
    the JAX package refuses, are numpy's: the smallest and largest of the
    group's non-null values, null where there is none."""
    d = {"k": [1, 1, 1, 2, 2, 3, 3, 4] * 5,
         "b": [True, False, None, True, True, None, None, False] * 5,
         "v": list(range(40))}
    with pytest.raises(Exception):
        ref.DataFrame(d).group_by("k").min()
    df = pt.DataFrame(d, device="cpu")
    if kind == "filter":
        df = df.filter(pt.col("v") % 3 != 0)
    elif kind == "sort":
        df = df.sort("v", descending=True)
    host = df.to_dict()
    for lazy in (False, True):
        for m, fn in (("min", np.min), ("max", np.max)):
            g = (df.lazy() if lazy else df).group_by("k",
                                                    maintain_order=True)
            out = getattr(g, m)()
            out = out.collect() if lazy else out
            got = dict(zip(out.to_dict()["k"], out.to_dict()["b"]))
            for key in got:
                vals = [b for kk, b in zip(host["k"], host["b"])
                        if kk == key and b is not None]
                want = bool(fn(vals)) if vals else None
                assert got[key] == want, (m, kind, lazy, key)


# --- chip_smoke.py's phase 21 at 2 * 10^4 rows ------------------------------

PHASE21_ROWS = 20_000
PHASE21 = [f"{q}:{form}" for q in
           [f"dense_{m}" for m in ("sum", "mean", "len", "count", "min",
                                   "max", "first", "last", "median",
                                   "quantile", "n_unique")] +
           ["hash_sum", "hash_len", "head3", "tail3", "all", "having",
            "map_groups"] for form in ("eager", "lazy")] + \
    ["iter:eager", "dense_sum:streaming", "dense_len:streaming"]


@pytest.fixture(scope="module")
def phase21():
    import chip_smoke as CS
    h2o = CS.make_h2o_data(PHASE21_ROWS, 0)
    hdf = pt.DataFrame(h2o, device="cpu")
    o = CS.groupby_oracle(h2o)
    return CS, h2o, o, dict(CS.groupby_queries(pt, hdf, o["t"]))


def test_phase21_names(phase21):
    assert sorted(phase21[3]) == sorted(PHASE21)


@pytest.mark.parametrize("name", [q for q in PHASE21
                                  if not q.endswith(":lazy")])
def test_phase21_query_matches_its_oracle(name, phase21):
    """chip_smoke.py's phase-21 query on the H2O frame cut to 2 * 10^4
    rows, on the CPU, against the script's own numpy checks; the eager
    form only, which collects the lazy form's plan (the lazy forms are
    held to the eager ones by the tests above)."""
    CS, h2o, o, queries = phase21
    res = CS.check_groupby(name, queries[name].collect(), h2o, o)
    assert res
