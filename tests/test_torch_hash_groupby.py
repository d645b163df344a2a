"""Group-bys over large key domains (the hash tier) through the JAX
package and the port.

Key domains of 4097 to 2^32 slots: a dictionary-string key of 6000
values, and (int, int) keys with a span product of about 10^4, as
tests/test_hgroup.py builds them, on the same seeded numpy data (about
2 * 8192 + 777 rows), through `polaroid_tpu` (its CPU path: dense
scatter or sorted layout, true f64) and `polaroid_tpu_torch` with
device="cpu" (the card's path: hash exchange or carry-sort fallback,
with the kernels' plain versions). The hash tier emits hash order, so
rows are compared after sorting by key unless an order is asked for.
Tolerances: exact (bit for bit, NaN and -0.0 included) for keys,
counts, integer sums, min/max/first/last and row order; rtol 1e-12 for
Float64 sums, means, var and std (both sides sum in f64 in another
order); 2 float32 ulp for Float32 outputs.
"""

import functools
import math
import struct

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
from polaroid_tpu_torch.ops import hgroup as TH
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


N = 2 * 8192 + 777
NUNIQ = 6000
RESERVED = 857_579_651   # fmix32_inv(0xFFFFFFFF): hashes to the dead fill


@functools.lru_cache(maxsize=None)
def _data(seed: int = 31):
    rng = np.random.default_rng(seed)
    uniq = np.array([f"k{i:05d}" for i in range(NUNIQ)], dtype=object)
    sid = uniq[rng.integers(0, NUNIQ, N)]
    a = rng.integers(0, 100, N).astype(np.int32)
    b = rng.integers(0, 100, N).astype(np.int64)
    f64 = rng.uniform(0, 100, N)
    special = rng.integers(0, N, 40)
    f64[special] = np.array([np.nan, -0.0, 0.0, np.inf])[
        rng.integers(0, 4, 40)]
    f32 = rng.uniform(-100, 100, N).astype(np.float32)
    i64 = rng.integers(-10**12, 10**12, N)
    i32 = rng.integers(1, 16, N).astype(np.int32)
    valid = {"sid": rng.random(N) < 0.995, "b": rng.random(N) < 0.95,
             "f64": rng.random(N) < 0.9, "i64": rng.random(N) < 0.9}
    cols = {"sid": sid, "a": a, "b": b, "f64": f64, "f32": f32,
            "i64": i64, "i32": i32}
    return cols, valid


def _frames(cols=None, valid=None):
    if cols is None:
        cols, valid = _data()
    rcols = {}
    for k, x in cols.items():
        if k in valid:
            rcols[k] = [(x[i].item() if hasattr(x[i], "item") else x[i])
                        if valid[k][i] else None for i in range(len(x))]
        else:
            rcols[k] = x
    tcols = {k: (list(x) if x.dtype == object else x)
             for k, x in cols.items()}
    return ref.DataFrame(rcols), frame_from_numpy(tcols, validity=valid,
                                                  device="cpu")


def _bits(x: float) -> bytes:
    return struct.pack("<d", x)


def _sorted_rows(d: dict, keys):
    """Rows as tuples, sorted by the key columns (None first)."""
    names = list(d)
    rows = list(zip(*[d[k] for k in names]))
    ki = [names.index(k) for k in keys]
    return names, sorted(rows, key=lambda r: tuple(
        (r[i] is not None, r[i]) for i in ki))


def _compare(got, want, keys, f32_cols=(), close=(), ordered=False):
    """Row by row: exact (bit for bit for floats) unless the column is in
    `close` (rtol 1e-12) or `f32_cols` (2 float32 ulp)."""
    assert {k: repr(v) for k, v in got.schema.items()} == \
        {k: repr(v) for k, v in want.schema.items()}
    g, w = got.to_dict(), want.to_dict()
    if ordered:
        names = list(w)
        gr = list(zip(*[g[k] for k in names]))
        wr = list(zip(*[w[k] for k in names]))
    else:
        names, gr = _sorted_rows(g, keys)
        _, wr = _sorted_rows(w, keys)
    assert len(gr) == len(wr)
    for rg, rw in zip(gr, wr):
        for name, x, y in zip(names, rg, rw):
            what = (name, rw)
            if x is None or y is None:
                assert x is None and y is None, what
            elif name in close or name in f32_cols:
                if math.isnan(y):
                    assert math.isnan(x), what
                elif math.isinf(y):
                    assert x == y, what
                elif name in f32_cols:
                    tol = 2 * float(np.spacing(np.float32(abs(y))))
                    assert abs(x - y) <= tol, what
                else:
                    assert abs(x - y) <= 1e-12 * abs(y), what
            elif isinstance(y, float):
                assert _bits(x) == _bits(y), what
            else:
                assert x == y, what
    return g


def _count_fallbacks(fn):
    TH.FALLBACKS = 0
    out = fn()
    return out, TH.FALLBACKS


_AGGS = {
    "f64": ["len", "count", "null_count", "sum", "mean", "min", "max",
            "var", "std", "first", "last"],
    "f32": ["count", "sum", "mean", "min", "max", "var", "std", "first",
            "last"],
    "i64": ["count", "null_count", "sum", "mean", "min", "max", "std",
            "first", "last"],
    "i32": ["sum", "min", "max", "mean", "first", "last"],
}


def _agg_exprs(pl, col):
    out = []
    for a in _AGGS[col]:
        if a == "len":
            out.append(pl.len().alias("n"))
        else:
            out.append(getattr(pl.col(col), a)().alias(f"{col}_{a}"))
    return out


def _tolerances(col):
    close = {f"{col}_{a}" for a in ("mean", "var", "std")}
    if col == "f64":
        close.add("f64_sum")
    return (close, ()) if col != "f32" else \
        (set(), {f"f32_{a}" for a in ("sum", "mean", "var", "std")})


@pytest.mark.parametrize("col", sorted(_AGGS))
@pytest.mark.parametrize("keys", [("sid",), ("a", "b")])
def test_aggregates_match_reference(keys, col):
    """Every aggregate of each value column, grouped by a 6001-slot
    string key (nulls included) or an (Int32, nullable Int64) key pair
    of about 12769 slots."""
    rdf, tdf = _frames()

    def q(pl, df):
        return (df.lazy().filter(pl.col("i32") > 2)
                .group_by(*keys).agg(*_agg_exprs(pl, col)).collect())

    got, fb = _count_fallbacks(lambda: q(pt, tdf))
    assert fb == 0
    close, f32 = _tolerances(col)
    g = _compare(got, q(ref, rdf), keys, f32_cols=f32, close=close)
    assert None in g[keys[-1]]  # a null key is a group of its own


def test_max_minus_min_and_dtypes():
    rdf, tdf = _frames()

    def q(pl, df):
        return (df.lazy().group_by("a", "b")
                .agg((pl.col("i32").max() - pl.col("i32").min())
                     .alias("rng"),
                     (pl.col("f64").max() - pl.col("f32").min())
                     .alias("mix"),
                     pl.col("i64").sum().alias("s64"),
                     pl.len().alias("n"))
                .collect())

    got = q(pt, tdf)
    assert {k: repr(v) for k, v in got.schema.items()}["rng"] == "Int32"
    _compare(got, q(ref, rdf), ("a", "b"))


def test_maintain_order_and_trailing_sort():
    rdf, tdf = _frames()

    def first_order(pl, df):
        return df.group_by("sid", maintain_order=True).agg(
            pl.col("f64").sum().alias("s"), pl.col("i64").max().alias("mx"),
            pl.col("f32").last().alias("l"))

    got = first_order(pt, tdf)
    _compare(got, first_order(ref, rdf), ("sid",), close={"s"},
             ordered=True)
    cols, valid = _data()
    keys = [s if ok else None for s, ok in zip(cols["sid"], valid["sid"])]
    assert got.to_dict()["sid"] == list(dict.fromkeys(keys))

    def key_order(pl, df):
        return (df.lazy().group_by("a", "b")
                .agg(pl.col("i32").sum().alias("s"), pl.len().alias("n"))
                .sort("a", "b").collect())

    g = _compare(key_order(pt, tdf), key_order(ref, rdf), ("a", "b"),
                 ordered=True)
    pairs = list(zip(g["a"], g["b"]))
    assert pairs == sorted(pairs, key=lambda p: (p[0], p[1] is not None,
                                                 p[1] or 0))


def _skewed_frames(reserved: bool):
    rng = np.random.default_rng(8)
    n = N
    if reserved:
        k = rng.integers(0, 10**6, n)
        k[17] = RESERVED - 1    # key code RESERVED (the stats base is 0)
        k[0] = 0
    else:
        # 8 keys over a span above 4096: every (block, bucket) cell holds
        # about 1024 rows, past CAP
        k = (rng.integers(0, 8, n) * 10_000).astype(np.int64)
    cols = {"k": k, "v": rng.integers(-50, 50, n).astype(np.int32),
            "x": rng.normal(size=n)}
    return _frames(cols, {"x": rng.random(n) < 0.9})


@pytest.mark.parametrize("reserved", [False, True])
def test_fallback_matches_reference(reserved):
    """A key whose cells overflow CAP, or whose code hashes to the dead
    fill, takes the carry-sort fallback, with the same results."""
    rdf, tdf = _skewed_frames(reserved)

    def q(pl, df):
        return (df.lazy().group_by("k")
                .agg(pl.col("v").sum().alias("s"),
                     pl.col("x").mean().alias("m"),
                     pl.col("x").max().alias("mx"),
                     pl.col("v").first().alias("f"), pl.len().alias("n"))
                .collect())

    got, fb = _count_fallbacks(lambda: q(pt, tdf))
    assert fb == 1
    g = _compare(got, q(ref, rdf), ("k",), close={"m"})
    if reserved:
        assert RESERVED - 1 in g["k"]


def test_domain_edges(monkeypatch):
    """A span product of 4081 slots stays dense, 4097 takes the hash
    tier; a float key and a domain above 2^32 take the sorted tier, and a
    median runs on the hash tier's group ids."""
    calls = []
    orig = TH.group_ids
    monkeypatch.setattr(TH, "group_ids",
                        lambda *a: calls.append(1) or orig(*a))
    rng = np.random.default_rng(9)
    n = 3000
    # integer-key stats bucket the max up to 16 m - 1: a max of 4079
    # spans 4081 slots (with the null slot), one of 4080 spans 4097
    for top, hashed in ((4079, False), (4080, True)):
        k = rng.integers(0, top + 1, n)
        k[:2] = [0, top]
        df = pt.DataFrame({"k": k}, device="cpu")
        calls.clear()
        out = df.lazy().group_by("k").agg(pt.len().alias("n")).collect()
        d = out.to_dict()
        assert sorted(d["k"]) == np.unique(k).tolist()
        assert dict(zip(d["k"], d["n"])) == dict(
            zip(*np.unique(k, return_counts=True)))
        assert len(calls) == int(hashed)
    df = pt.DataFrame({"k": np.array([1 << 33, 0, 1 << 33]),
                       "f": [0.5, 1.5, 2.5]}, device="cpu")
    calls.clear()
    out = df.lazy().group_by("k").agg(pt.len().alias("n")).collect()
    assert out.to_dict() == {"k": [0, 1 << 33], "n": [1, 2]}
    out = df.lazy().group_by("f").agg(pt.len().alias("n")).collect()
    assert out.to_dict() == {"f": [0.5, 1.5, 2.5], "n": [1, 1, 1]}
    out = df.lazy().group_by("k").agg(pt.col("f").median()).collect()
    assert out.to_dict() == {"k": [0, 1 << 33], "f": [1.5, 1.5]}
    assert not calls
    k = rng.integers(0, 5000, n)
    df = pt.DataFrame({"k": k, "f": rng.normal(size=n)}, device="cpu")
    out = df.lazy().group_by("k").agg(pt.col("f").median()).collect()
    assert len(calls) == 1
    f = df.to_dict()["f"]
    want = {g: np.median([x for x, kk in zip(f, k) if kk == g])
            for g in np.unique(k)}
    got = dict(zip(*out.to_dict().values()))
    assert got.keys() == want.keys()
    assert all(abs(got[g] - want[g]) <= 1e-12 * abs(want[g]) for g in want)
