"""Nested columns (Slice E2) through the JAX package and the port.

The same seeded List, Struct, List(Struct) and List(List) columns, with
null rows and null elements, go through `polaroid_tpu` (its CPU path)
and `polaroid_tpu_torch` with device="cpu": construction and the host
round trip; every op of the `list` namespace (reductions, positions,
transforms, sets, `eval`/`filter`, `join`, `to_struct`) and the
structural subset on nested inners; the `struct` namespace; `explode`
and `unnest` (frame, lazy and Series); implode and `agg_groups` on the
dense, hash and sorted tiers of the group-by, of flat, List and Struct
inputs, and a list op after an implode; `.over(mapping_strategy=
"join")`; concat of nested columns; `int_ranges`, `repeat_by`,
`concat_list`, `reshape`, `date_ranges` and list literals; and
`chip_smoke.py`'s phase-14 L1, L2 and L3 at 2^12 trades, against the
JAX package and their numpy oracle.

Tolerances: integers, strings, lengths, list elements and every null
exact; list means, sums, std and var in f64 within rtol 1e-12 of numpy.
Where the port departs from the JAX package it is held to numpy or
polars: the JAX package sums and averages a list in f32 (so it is met
within rtol 1e-6), and its `date_ranges` gives List(Int64) day counts
where polars and the port give List(Date).
"""

import datetime as pydt
import math
import pathlib
import sys

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402


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


N = 96


def _lists(rng, n, lo, hi, null_row=0.1, null_elem=0.1, kind="int"):
    out = []
    for _ in range(n):
        if rng.random() < null_row:
            out.append(None)
            continue
        k = int(rng.integers(0, 6))
        if kind == "int":
            vals = [int(v) for v in rng.integers(lo, hi, k)]
        elif kind == "float":
            vals = [float(v) for v in np.round(rng.uniform(lo, hi, k), 2)]
        elif kind == "bool":
            vals = [bool(v) for v in rng.random(k) > 0.5]
        else:
            vals = [["a", "bb", "c", "dd", "e"][i]
                    for i in rng.integers(0, 5, k)]
        out.append([None if rng.random() < null_elem else v for v in vals])
    return out


def _data():
    rng = np.random.default_rng(41)
    return {
        "k": [int(v) for v in rng.integers(0, 5, N)],
        "li": _lists(rng, N, -9, 9),
        "lf": _lists(rng, N, -5.0, 5.0, kind="float"),
        "ls": _lists(rng, N, 0, 0, kind="str"),
        "lb": _lists(rng, N, 0, 0, null_elem=0.0, kind="bool"),
        "ln": _lists(rng, N, 0, 9, null_row=0.0, null_elem=0.0),
        "x": [None if rng.random() < 0.1 else float(v)
              for v in np.round(rng.normal(0, 9, N), 2)],
        "s": [["p", "q", "r", None][i] for i in rng.integers(0, 4, N)],
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
        return a == b or abs(a - b) <= rtol * max(abs(b), 1e-300)
    return a == b


def _name(dt) -> str:
    return repr(dt() if isinstance(dt, type) else dt)


def same(got, want, rtol=0.0, schema=True):
    g, w = got.to_dict(), want.to_dict()
    assert list(g) == list(w), (list(g), list(w))
    for k in w:
        assert len(g[k]) == len(w[k]), (k, len(g[k]), len(w[k]))
        for i, (a, b) in enumerate(zip(g[k], w[k])):
            assert _eq(a, b, rtol), (k, i, a, b)
    if schema:
        assert {k: _name(v) for k, v in got.schema.items()} == \
            {k: _name(v) for k, v in want.schema.items()}


def both(make, rtol=0.0, frames=None):
    r, t = frames or (R, T)
    same(make(pt, t), make(ref, r), rtol)


def test_construction_and_round_trip():
    assert T.to_dict() == R.to_dict()
    assert {k: _name(v) for k, v in T.schema.items()} == \
        {k: _name(v) for k, v in R.schema.items()}


LIST_OPS = {
    "reduce": lambda pl: [
        pl.col("li").list.len().alias("a"), pl.col("li").list.sum()
        .alias("b"), pl.col("li").list.min().alias("c"),
        pl.col("li").list.max().alias("d"), pl.col("li").list.first()
        .alias("e"), pl.col("li").list.last().alias("f"),
        pl.col("li").list.get(1).alias("g"),
        pl.col("li").list.get(-1).alias("h"),
        pl.col("li").list.contains(3).alias("i"),
        pl.col("li").list.n_unique().alias("j"),
        pl.col("li").list.count_matches(2).alias("k"),
        pl.col("li").list.median().alias("l"),
        pl.col("ln").list.arg_min().alias("m"),
        pl.col("ln").list.arg_max().alias("n")],
    "floats": lambda pl: [
        pl.col("lf").list.max().alias("a"), pl.col("lf").list.min()
        .alias("b"), pl.col("lf").list.first().alias("c"),
        pl.col("lf").list.std().alias("d"), pl.col("lf").list.var(0)
        .alias("e")],
    "transform": lambda pl: [
        pl.col("li").list.reverse().alias("a"), pl.col("li").list.sort()
        .alias("b"), pl.col("li").list.sort(descending=True).alias("c"),
        pl.col("li").list.unique().alias("d"), pl.col("li").list.head(2)
        .alias("e"), pl.col("li").list.tail(2).alias("f"),
        pl.col("li").list.slice(1, 2).alias("g"),
        pl.col("li").list.slice(-2).alias("h"),
        pl.col("li").list.drop_nulls().alias("i"),
        pl.col("ln").list.diff().alias("j"),
        pl.col("ln").list.diff(null_behavior="drop").alias("k"),
        pl.col("li").list.shift().alias("l"),
        pl.col("li").list.gather([0, -1], null_on_oob=True).alias("m"),
        pl.col("li").list.gather_every(2).alias("n")],
    "strings": lambda pl: [
        pl.col("ls").list.len().alias("a"), pl.col("ls").list.first()
        .alias("b"), pl.col("ls").list.min().alias("c"),
        pl.col("ls").list.max().alias("d"),
        pl.col("ls").list.contains("bb").alias("e"),
        pl.col("ls").list.join("-").alias("f"),
        pl.col("ls").list.unique().alias("g"),
        pl.col("ls").list.count_matches("c").alias("h")],
    "bools": lambda pl: [pl.col("lb").list.any().alias("a"),
                         pl.col("lb").list.all().alias("b"),
                         pl.col("lb").list.sum().alias("c")],
    "eval": lambda pl: [
        pl.col("li").list.eval(pl.element() * 2).alias("a"),
        pl.col("li").list.filter(pl.element() > 0).alias("b"),
        pl.col("li").list.eval(pl.element().filter(pl.element() < 0))
        .alias("c"),
        pl.col("ln").list.to_struct(fields=["f0", "f1"]).alias("d")],
    "sets": lambda pl: [
        pl.col("ln").list.set_union(pl.col("ln").list.reverse()).alias("a"),
        pl.col("li").list.set_intersection(pl.col("ln")).alias("b"),
        pl.col("ln").list.set_difference(pl.col("li")).alias("c"),
        pl.col("ln").list.set_symmetric_difference(pl.col("li"))
        .alias("d"),
        pl.col("ls").list.set_union(pl.col("ls")).alias("e"),
        pl.col("li").list.concat(pl.col("ln")).alias("f")],
}


@pytest.mark.parametrize("group", sorted(LIST_OPS))
def test_list_ops_match_jax(group):
    # std and var: the JAX package takes the sum of squares less the
    # squared sum, the port the squared deviations (held to numpy below)
    both(lambda pl, df: df.select(LIST_OPS[group](pl)),
         rtol=1e-9 if group == "floats" else 0.0)


def _np_mean(row):
    vals = [v for v in row if v is not None] if row is not None else []
    return float(np.mean(vals)) if vals else None


def test_list_sum_and_mean_in_f64():
    # the JAX package accumulates a list's floats in f32
    got = T.select(pt.col("lf").list.mean().alias("m"),
                   pt.col("lf").list.sum().alias("s"),
                   pt.col("li").list.mean().alias("mi")).to_dict()
    want = R.select(ref.col("lf").list.mean().alias("m"),
                    ref.col("lf").list.sum().alias("s"),
                    ref.col("li").list.mean().alias("mi")).to_dict()
    for k, col in (("m", "lf"), ("s", "lf"), ("mi", "li")):
        for row, a, b in zip(DATA[col], got[k], want[k]):
            assert (a is None) == (b is None), (k, a, b)
            if a is not None:
                mag = max([abs(v) for v in row if v is not None] + [1.0])
                assert abs(a - b) <= 1e-6 * mag, (k, a, b)
    std = T.select(pt.col("lf").list.std().alias("d")).to_dict()["d"]
    for row, m, s, sd in zip(DATA["lf"], got["m"], got["s"], std):
        want_m = _np_mean(row)
        assert (m is None) == (want_m is None or row is None)
        if m is not None:
            vals = [v for v in row if v is not None]
            mag = max(sum(abs(v) for v in vals), 1.0)
            assert abs(m - want_m) <= 1e-12 * mag
            assert abs(s - math.fsum(vals)) <= 1e-12 * mag
            if len(vals) > 1:
                assert abs(sd - float(np.std(vals, ddof=1))) <= 1e-12 * mag


NESTED = {"ls": [[{"a": 1, "b": "x"}, {"a": 2, "b": "y"}], None, [],
                 [None, {"a": 5, "b": None}]],
          "ll": [[[1, 2], [3]], None, [[], [4, None, 6]], [None]],
          "i": [1, 2, 3, 4]}
NR, NT = ref.DataFrame(dict(NESTED)), pt.DataFrame(dict(NESTED),
                                                  device="cpu")


def test_nested_inners_structural_ops():
    both(lambda pl, df: df.select(
        pl.col("ls").list.len().alias("n"), pl.col("ll").list.len()
        .alias("m"), pl.col("ls").list.get(0).alias("g"),
        pl.col("ll").list.last().alias("l"),
        pl.col("ls").list.first().struct.field("a").alias("fa")),
        frames=(NR, NT))
    both(lambda pl, df: df.sort("i", descending=True), frames=(NR, NT))
    both(lambda pl, df: df.filter(pl.col("i") >= 3), frames=(NR, NT))
    both(lambda pl, df: df.head(2), frames=(NR, NT))
    for c in ("ls", "ll"):
        both(lambda pl, df: df.select(pl.col(c)).explode(c),
             frames=(NR, NT))


def test_explode_frame_lazy_series_and_select():
    both(lambda pl, df: df.select("k", "li").explode("li"))
    both(lambda pl, df: df.select("k", "ls", "x").explode("ls"))
    both(lambda pl, df: df.lazy().select("k", "li", "s").explode("li")
         .collect())
    both(lambda pl, df: df.select(pl.col("li").explode()))
    both(lambda pl, df: df.select("ln", pl.col("ln").list.reverse()
                                  .alias("r")).explode(["ln", "r"]))
    assert pt.Series("a", [[1, 2], None, []], device="cpu").explode() \
        .to_list() == [1, 2, None, None]
    with pytest.raises(pt.ShapeError):
        T.select("li", "ln").explode(["li", "ln"])


def test_lazy_explode_reads_only_the_columns_it_needs():
    lf = T.lazy().with_columns(c=pt.col("ls").list.len()).explode("li") \
        .group_by("li").agg(pt.col("c").sum())
    # the scan reads li and ls alone
    assert "DF_SCAN[2 cols]" in lf.explain()
    want = T.select("li", pt.col("ls").list.len().alias("c")).explode("li") \
        .group_by("li").agg(pt.col("c").sum()).sort("li")
    assert lf.collect().sort("li").to_dict() == want.to_dict()
    both(lambda pl, df: df.lazy().explode("li").select("li", "k").collect())


def test_struct_namespace_and_unnest():
    def make(pl, df):
        return df.select(pl.struct(["k", "x", "s"]).alias("st"),
                         pl.struct(a=pl.col("k") * 2, b=pl.col("s"))
                         .alias("named"))
    both(make)
    both(lambda pl, df: make(pl, df).select(
        pl.col("st").struct.field("x").alias("a"),
        pl.col("st").struct["s"].alias("b"),
        pl.col("st").struct.rename_fields(["p", "q", "r"]).alias("c"),
        pl.col("named").struct.prefix_fields("z_").alias("d"),
        pl.col("named").struct.suffix_fields("_z").alias("e"),
        pl.col("st").struct.json_encode().alias("f")))
    both(lambda pl, df: make(pl, df).unnest("st"))
    both(lambda pl, df: make(pl, df).lazy().unnest("named").collect())
    both(lambda pl, df: make(pl, df).select(
        pl.col("named").struct.unnest()))
    both(lambda pl, df: make(pl, df).select(
        pl.col("named").struct.with_fields(
            c=pl.field("a") + 1).alias("w")))
    assert T.to_struct("row").to_list()[0] == \
        {k: v[0] for k, v in DATA.items()}
    with pytest.raises(pt.DuplicateError):
        make(pt, T).with_columns(k=pt.lit(1)).unnest("st")


def _tier_frames():
    rng = np.random.default_rng(43)
    n = 300
    k = rng.integers(0, 7, n)
    cols = {"k": k, "h": k * 5000, "f": k.astype(np.float64) / 3,
            "v": rng.normal(0, 1, n), "s": np.array(list("abcde"))[
                rng.integers(0, 5, n)].tolist(),
            "i": rng.integers(-9, 9, n)}
    return ref.DataFrame(dict(cols)), pt.DataFrame(dict(cols), device="cpu")


TIERS = _tier_frames()


@pytest.mark.parametrize("key", ["k", "h", "f"])
@pytest.mark.parametrize("order", [True, False])
def test_implode_on_every_tier(key, order):
    def make(pl, df):
        out = (df.filter(pl.col("i") != 0)
               .with_columns(t=pl.struct(["i", "s"]),
                             l=pl.concat_list(["i", "i"]))
               .group_by(key, maintain_order=order)
               .agg(pl.col("v"), pl.col("s").alias("ss"),
                    pl.col("t"), pl.col("l"),
                    pl.col("i").implode().list.sort().alias("si"),
                    pl.len().alias("n")))
        return out if order else out.sort(key)
    both(make, frames=TIERS)
    # a filtered column without a reduction (the JAX package refuses
    # it): each group's kept values, in row order
    out = TIERS[1].group_by(key, maintain_order=True).agg(
        pt.col("i").alias("all"),
        pt.col("i").filter(pt.col("i") > 0).alias("pos")).to_dict()
    assert out["pos"] == [[v for v in a if v > 0] for a in out["all"]]


@pytest.mark.parametrize("key", ["k", "h", "f"])
def test_agg_groups_on_every_tier(key):
    both(lambda pl, df: df.group_by(key, maintain_order=True).agg(
        pl.col("v").agg_groups().alias("g"), pl.col("s")), frames=TIERS)


def test_agg_groups_and_select_implode():
    r, t = TIERS
    both(lambda pl, df: df.group_by("k", maintain_order=True).agg(
        pl.col("v").agg_groups().alias("g")), frames=TIERS)
    both(lambda pl, df: df.select(pl.col("i").implode(),
                                  pl.col("s").implode().alias("s")),
         frames=TIERS)
    both(lambda pl, df: df.filter(pl.col("k") > 3).select(
        pl.col("v").implode()), frames=TIERS)
    assert pt.Series("a", [1, None, 3], device="cpu").implode().to_list() \
        == [[1, None, 3]]


def test_over_mapping_join():
    both(lambda pl, df: df.select(
        pl.col("v").over("k", mapping_strategy="join").alias("a"),
        pl.col("s").over("k", mapping_strategy="join").alias("b"),
        pl.col("v").sum().over("k", mapping_strategy="join").alias("c")),
        frames=TIERS)


def test_concat_of_nested_columns():
    a = {"l": [[1, 2], [3]], "st": [{"a": 1, "b": "x"}, None],
         "ls": [["p"], ["q", "r"]], "ll": [[[1]], None]}
    b = {"l": [[4, 5, 6, 7, 8], None], "st": [{"a": 2, "b": "y"},
                                           {"a": None, "b": "z"}],
         "ls": [["z"], []], "ll": [[[2, 3], []], [[4]]]}
    ra, rb = ref.DataFrame(dict(a)), ref.DataFrame(dict(b))
    ta, tb = pt.DataFrame(dict(a), device="cpu"), \
        pt.DataFrame(dict(b), device="cpu")
    same(pt.concat([ta, tb]), ref.concat([ra, rb]))
    same(pt.concat([ta.lazy(), tb.lazy()]).collect(),
         ref.concat([ra.lazy(), rb.lazy()]).collect())
    same(pt.concat([ta, tb.select("l")], how="diagonal"),
         ref.concat([ra, rb.select("l")], how="diagonal"))


def test_ranges_repeat_concat_list_and_reshape():
    both(lambda pl, df: df.select(
        pl.int_ranges(pl.col("k"), pl.col("k") + 3).alias("a"),
        pl.int_ranges(0, pl.col("k"), 2).alias("b"),
        pl.col("s").repeat_by(pl.col("k")).alias("c"),
        pl.concat_list([pl.col("k"), pl.col("k") * 10]).alias("d"),
        pl.concat_list([pl.col("li"), pl.col("k")]).alias("e")))
    # strings: the JAX package keeps the first part's dictionary for
    # every part; held to the parts themselves
    got = T.select(pt.concat_list([pt.col("ls"), pt.col("s")]).alias("f"))
    assert got.to_dict()["f"] == [None if a is None else a + [b] for a, b
                                  in zip(DATA["ls"], DATA["s"])]
    # reshape (the JAX package broadcasts the 96 rows to the capacity of
    # 128 and fails): held to numpy
    out = T.select(pt.col("k").reshape((-1, 4))).to_dict()["k"]
    assert out == np.asarray(DATA["k"]).reshape(-1, 4).tolist()


def test_date_ranges_are_lists_of_dates():
    cols = {"a": [pydt.date(2024, 1, 30), pydt.date(2024, 2, 27)],
            "b": [pydt.date(2024, 2, 2), pydt.date(2024, 3, 1)]}
    t = pt.DataFrame(dict(cols), device="cpu")
    got = t.select(pt.date_ranges("a", "b").alias("r"))
    assert repr(got.schema["r"]) == "List(Date)"
    want = [[pydt.date(2024, 1, 30) + pydt.timedelta(days=i)
             for i in range(4)],
            [pydt.date(2024, 2, 27) + pydt.timedelta(days=i)
             for i in range(4)]]
    assert got.to_dict()["r"] == want
    # the JAX package's elements are the same days, as Int64 counts
    r = ref.DataFrame(dict(cols)).select(ref.date_ranges("a", "b")
                                         .alias("r")).to_dict()["r"]
    epoch = pydt.date(1970, 1, 1)
    assert r == [[(d - epoch).days for d in row] for row in want]
    got = t.select(pt.date_ranges("a", "b", "2d").alias("r")).to_dict()
    assert got["r"] == [row[::2] for row in want]
    ts = {"a": np.array(["2024-03-10T06:00", "2024-03-11T22:30"],
                        dtype="datetime64[us]")}
    ts["b"] = ts["a"] + np.timedelta64(150, "m")
    got = pt.DataFrame(ts, device="cpu").select(
        pt.datetime_ranges("a", "b", "1h").alias("r"))
    assert repr(got.schema["r"]) == "List(Datetime(us))"
    assert got.to_dict()["r"] == [
        [a + np.timedelta64(h, "h") for h in range(3)] for a in ts["a"]]


def test_list_literal():
    # a literal of the frame's length lines up with its rows (the JAX
    # package broadcasts it to the capacity: held to numpy)
    vals = np.arange(T.height) * 3
    assert T.with_columns(pt.lit(vals).alias("z")).to_dict()["z"] == \
        vals.tolist()
    assert T.select(pt.lit(np.array([1.5, 2.5, 4.0])).alias("z")) \
        .to_dict() == {"z": [1.5, 2.5, 4.0]}
    assert pt.DataFrame({"a": [1]}, device="cpu").select(
        pt.date_range(pydt.date(2024, 1, 1), pydt.date(2024, 1, 3))
        .alias("d")).to_dict()["d"] == [pydt.date(2024, 1, i)
                                        for i in (1, 2, 3)]


def test_series_list_and_struct_namespaces():
    s = pt.Series("a", [[3, 1], None, [2]], device="cpu")
    assert s.list.sort().to_list() == [[1, 3], None, [2]]
    assert s.list.len().to_list() == [2, None, 1]
    st = pt.Series("s", [{"a": 1, "b": "x"}, {"a": 2, "b": None}],
                   device="cpu")
    assert st.struct.field("b").to_list() == ["x", None]
    assert st.struct.unnest().to_dict() == {"a": [1, 2], "b": ["x", None]}


# --- chip_smoke.py's phase 14: L1, L2 and L3 at 2^12 trades -----------------

def _taq():
    d, x = CS.make_taq_data(1 << 12, 0)
    cols = {k: d[k] for k in ("sym", "ex", "cond", "date", "price",
                              "volume")}
    cols["ts"] = d["ts"].astype("datetime64[us]")
    return d, x, ref.DataFrame(cols), CS.taq_frame(pt, d, "cpu")


TAQ = _taq()


@pytest.mark.parametrize("name", ["L1", "L2", "L3"])
def test_phase14_query_matches_jax_and_oracle(name):
    d, x, rdf, tdf = TAQ
    (lf,) = [q for n, q, *_ in CS.taq_queries(pt, tdf) if n == name]
    (lr,) = [q for n, q, *_ in CS.taq_queries(ref, rdf) if n == name]
    got, want = lf.collect(), lr.collect()
    CS.taq_oracle(name, CS._taq_cols(got), d, x)
    if name == "L2":
        got, want = got.sort("codes"), want.sort("codes")
    # L1's list mean: the JAX package's is an f32 sum (held to numpy
    # within 1e-12 by the oracle above)
    same(got, want, rtol=1e-6 if name == "L1" else 0.0)
