"""Dense-tier group-by aggregates through the JAX package and the port.

min/max/first/last/any/all/var/std, the per-symbol OHLC bar query and
group_by(maintain_order=True), on the same seeded numpy data (about
5,000 rows), through `polaroid_tpu` (its CPU path: true f64, scatter
segment reductions) and `polaroid_tpu_torch` with device="cpu" (the
card's path, with the kernels' plain versions). Tolerances: exact (bit
for bit, NaN and -0.0 included) for min/max/first/last/any/all, counts
and row order; rtol 1e-10 for Float64 var/std (both sides take two f64
passes, summing in another order); one float32 ulp for Float32 outputs.
"""

import functools
import math
import struct

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
from polaroid_tpu_torch.ops import cuda_kernels as TK
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


N = 5000
SYMS = [f"S{i:02d}" for i in range(30)]
SOLO = ["SOLO1", "SOLO2", "SOLO3"]   # one row each
ALLNULL = "ZNULL"                    # every nullable value column null
U63 = 1 << 63


@functools.lru_cache(maxsize=None)
def _data(seed: int = 21):
    """Host columns and their non-null masks."""
    rng = np.random.default_rng(seed)
    sym = np.array([SYMS[i] for i in rng.integers(0, len(SYMS), N)],
                   dtype=object)
    sym[rng.integers(0, N, 12)] = ALLNULL
    solo_rows = rng.choice(N, len(SOLO), replace=False)
    sym[solo_rows] = SOLO
    sym_valid = rng.uniform(size=N) < 0.96
    sym_valid[solo_rows] = True
    f64 = rng.normal(scale=50, size=N)
    special = rng.integers(0, N, 60)
    f64[special] = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf])[
        rng.integers(0, 5, 60)]
    f32 = rng.uniform(-100, 100, N).astype(np.float32)
    f32[rng.integers(0, N, 20)] = np.float32(-0.0)
    i32 = rng.integers(-1_000_000, 1_000_000, N).astype(np.int32)
    # UInt64 on both sides of 2^63
    u64 = rng.integers(0, 1 << 62, N, dtype=np.uint64) + \
        np.where(rng.uniform(size=N) < 0.5, np.uint64(U63), np.uint64(0))
    b = rng.uniform(size=N) < 0.7
    s = np.array([f"v{i:03d}" for i in rng.integers(0, 400, N)],
                 dtype=object)
    v = rng.integers(0, 1000, N)
    v[solo_rows] = 500
    v[sym == ALLNULL] = 500
    nulls = sym == ALLNULL
    valid = {
        "sym": sym_valid,
        "f64": (rng.uniform(size=N) < 0.9) & ~nulls,
        "b": (rng.uniform(size=N) < 0.9) & ~nulls,
        "s": (rng.uniform(size=N) < 0.9) & ~nulls,
    }
    cols = {"sym": sym, "f64": f64, "f32": f32, "i32": i32, "u64": u64,
            "b": b, "s": s, "v": v}
    return cols, valid


def _frames():
    cols, valid = _data()
    rcols = {}
    for k, x in cols.items():
        if k in valid:
            rcols[k] = [(x[i].item() if hasattr(x[i], "item") else x[i])
                        if valid[k][i] else None for i in range(N)]
        else:
            rcols[k] = x
    tcols = {k: (list(x) if x.dtype == object else x)
             for k, x in cols.items()}
    return ref.DataFrame(rcols), frame_from_numpy(tcols, validity=valid,
                                                  device="cpu")


def _bits(x: float) -> bytes:
    return struct.pack("<d", x)


def _same(got, want, what):
    """Exact, bit for bit for floats (NaN and -0.0 included)."""
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None or g is None:
            assert g is None and w is None, (what, i, g, w)
        elif isinstance(w, float):
            assert _bits(g) == _bits(w), (what, i, g, w)
        else:
            assert g == w, (what, i, g, w)


def _close(got, want, what, f32: bool):
    """rtol 1e-10 (Float64) or one float32 ulp (Float32); NaN as NaN."""
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None or g is None:
            assert g is None and w is None, (what, i, g, w)
        elif math.isnan(w):
            assert math.isnan(g), (what, i, g, w)
        elif f32:
            assert abs(g - w) <= float(np.spacing(np.float32(abs(w)))), \
                (what, i, g, w)
        else:
            assert abs(g - w) <= 1e-10 * abs(w), (what, i, g, w)


_EXACT = {"min", "max", "first", "last", "any", "all"}
_MATRIX = {
    "f64": ["min", "max", "first", "last", "var0", "var1", "std0", "std1"],
    "f32": ["min", "max", "first", "last", "var0", "var1", "std0", "std1"],
    "i32": ["min", "max", "first", "last", "var0", "var1", "std0", "std1"],
    "u64": ["min", "max", "first", "last", "var0", "std1"],
    "b": ["any", "all", "first", "last", "var1", "std0"],
    "s": ["min", "max", "first", "last"],
}


def _agg(pl, c: str, a: str):
    e = pl.col(c)
    if a[:3] in ("var", "std"):
        return getattr(e, a[:3])(ddof=int(a[3])).alias(f"{c}_{a}")
    return getattr(e, a)().alias(f"{c}_{a}")


def _compare(got, want):
    assert {k: repr(v) for k, v in got.schema.items()} == \
        {k: repr(v) for k, v in want.schema.items()}
    g, w = got.to_dict(), want.to_dict()
    for k in w:
        if k.rsplit("_", 1)[-1] in _EXACT or "_" not in k:
            _same(g[k], w[k], k)
        else:
            _close(g[k], w[k], k, repr(want.schema[k]) == "Float32")


@pytest.mark.parametrize("col", sorted(_MATRIX))
def test_aggregate_matrix_matches_reference(col):
    """group_by(nullable string key, maintain_order=True) after a filter:
    rows in first-occurrence order, every aggregate of the column."""
    rdf, tdf = _frames()

    def q(pl, df):
        return (df.lazy().filter(pl.col("v") > 100)
                .group_by("sym", maintain_order=True)
                .agg(pl.len().alias("n"),
                     *[_agg(pl, col, a) for a in _MATRIX[col]])
                .collect())

    want, got = q(ref, rdf), q(pt, tdf)
    _compare(got, want)
    syms = got.to_dict()["sym"]
    assert None in syms and set(SOLO) <= set(syms) and ALLNULL in syms


def test_eager_maintain_order_matches_reference():
    rdf, tdf = _frames()

    def q(pl, df):
        return df.group_by("sym", maintain_order=True).agg(
            pl.col("f64").first().alias("f64_first"),
            pl.col("s").max().alias("s_max"),
            pl.col("f32").std().alias("f32_std1"),
            pl.col("v").sum().alias("vsum"))

    want, got = q(ref, rdf), q(pt, tdf)
    _compare(got, want)
    # the order is that of each key's first row, null key included
    cols, valid = _data()
    keys = [s if ok else None for s, ok in zip(cols["sym"], valid["sym"])]
    assert got.to_dict()["sym"] == list(dict.fromkeys(keys))


def test_key_order_without_maintain_order():
    rdf, tdf = _frames()

    def q(pl, df):
        return (df.lazy().group_by("sym")
                .agg(pl.col("i32").min().alias("i32_min"),
                     pl.col("u64").max().alias("u64_max"),
                     pl.col("b").all().alias("b_all"))
                .sort("sym").collect())

    _compare(q(pt, tdf), q(ref, rdf))


def _ohlc(pl, df):
    return (df.lazy().filter(pl.col("volume") > 1000)
            .group_by("symbol", maintain_order=True)
            .agg(pl.col("price").first().alias("open"),
                 pl.col("price").max().alias("high"),
                 pl.col("price").min().alias("low"),
                 pl.col("price").last().alias("close"),
                 pl.col("volume").sum().alias("vol"),
                 pl.col("price").std().alias("sd"),
                 pl.len().alias("n"))
            .collect())


@pytest.mark.parametrize("key", ["u32", "str"])
def test_ohlc_matches_reference(key):
    """The per-symbol OHLC bar on the bench's column types (f32 price,
    int32 volume) and against a numpy oracle of first-occurrence order."""
    rng = np.random.default_rng(5)
    if key == "u32":
        sym = rng.integers(0, 1000, N).astype(np.uint32)
    else:
        sym = np.array([SYMS[i] for i in rng.integers(0, len(SYMS), N)],
                       dtype=object)
    data = {"symbol": sym if key == "u32" else list(sym),
            "price": rng.uniform(1, 200, N).astype(np.float32),
            "volume": rng.integers(0, 5000, N).astype(np.int32)}
    want = _ohlc(ref, ref.DataFrame(data))
    got = _ohlc(pt, pt.DataFrame(data, device="cpu"))
    assert {k: repr(v) for k, v in got.schema.items()} == {
        "symbol": "UInt32" if key == "u32" else "String", "open": "Float32",
        "high": "Float32", "low": "Float32", "close": "Float32",
        "vol": "Int64", "sd": "Float32", "n": "UInt32"}
    g, w = got.to_dict(), want.to_dict()
    for k in ("symbol", "open", "high", "low", "close", "vol", "n"):
        _same(g[k], w[k], k)
    _close(g["sd"], w["sd"], "sd", f32=True)
    live = data["volume"] > 1000
    order = list(dict.fromkeys(np.asarray(sym)[live].tolist()))
    assert g["symbol"] == order


def test_uint64_min_max_across_the_sign_bit():
    """UInt64 is held in int64, where values >= 2^63 are negative: min
    and max must still order them unsigned, as the JAX package does."""
    k = np.array([0, 0, 1, 1, 2, 2, 3, 3], dtype=np.int8)
    u = np.array([1, U63 + 5, U63 - 1, (1 << 64) - 1, 7, 0, U63, 3],
                 dtype=np.uint64)

    def q(pl, df):
        return df.group_by("k", maintain_order=True).agg(
            pl.col("u").min().alias("mn"), pl.col("u").max().alias("mx"),
            pl.col("u").std().alias("sd"))

    want = q(ref, ref.DataFrame({"k": k, "u": u})).to_dict()
    got = q(pt, pt.DataFrame({"k": k, "u": u}, device="cpu")).to_dict()
    assert got["mn"] == want["mn"] == [1, U63 - 1, 0, 3]
    assert got["mx"] == want["mx"] == [U63 + 5, (1 << 64) - 1, 7, U63]
    _close(got["sd"], want["sd"], "sd", f32=False)


def test_nan_and_signed_zero_min_max():
    k = np.array([0, 0, 1, 1, 2, 2, 3, 3, 4], dtype=np.int8)
    x = np.array([np.nan, 1.0, -0.0, 0.0, 0.0, -0.0, np.inf, -np.inf, -np.nan])

    def q(pl, df):
        return df.group_by("k", maintain_order=True).agg(
            pl.col("x").min().alias("mn"), pl.col("x").max().alias("mx"))

    want = q(ref, ref.DataFrame({"k": k, "x": x})).to_dict()
    got = q(pt, pt.DataFrame({"k": k, "x": x}, device="cpu")).to_dict()
    _same(got["mn"], want["mn"], "mn")
    _same(got["mx"], want["mx"], "mx")
    assert [math.copysign(1, v) for v in got["mn"][1:3]] == [-1, -1]
    assert [math.copysign(1, v) for v in got["mx"][1:3]] == [1, 1]
    assert math.isnan(got["mn"][4]) and math.copysign(1, got["mn"][4]) < 0


def test_boolean_min_max():
    """Boolean min/max (the JAX package's dense path raises on them): min
    is False where the group holds a False, max True where it holds a
    True; a group of nulls gives null."""
    df = pt.DataFrame({"k": np.array([0, 0, 1, 1, 2, 2], dtype=np.int8),
                       "b": [True, False, True, True, None, None]},
                      device="cpu")
    out = df.group_by("k", maintain_order=True).agg(
        pt.col("b").min().alias("mn"), pt.col("b").max().alias("mx"))
    assert out.to_dict() == {"k": [0, 1, 2], "mn": [False, True, None],
                             "mx": [True, True, None]}


def test_single_row_and_all_null_groups():
    rdf, tdf = _frames()

    def q(pl, df):
        return (df.lazy().filter(pl.col("sym").is_not_null())
                .group_by("sym", maintain_order=True)
                .agg(pl.col("f64").std().alias("sd"),
                     pl.col("f64").var(ddof=0).alias("v0"),
                     pl.col("f64").min().alias("mn"),
                     pl.col("f64").first().alias("f"),
                     pl.col("b").any().alias("any"),
                     pl.col("b").all().alias("all"),
                     pl.col("s").last().alias("sl"), pl.len().alias("n"))
                .collect())

    g = q(pt, tdf).to_dict()
    _compare(q(pt, tdf), q(ref, rdf))
    rows = {s: i for i, s in enumerate(g["sym"])}
    for s in SOLO:  # one row: std (ddof 1) null, var (ddof 0) zero
        i = rows[s]
        assert g["n"][i] == 1 and g["sd"][i] is None
        assert g["v0"][i] in (0.0, None)
    i = rows[ALLNULL]  # no non-null value: null, except any/all
    assert g["sd"][i] is None and g["v0"][i] is None
    assert g["mn"][i] is None and g["f"][i] is None and g["sl"][i] is None
    assert g["any"][i] is False and g["all"][i] is True


def test_ohlc_collect_takes_the_kernels_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers run their plain versions and count no
    launch; the path still reaches seg_minmax and gather (a spy on the
    wrappers' plain versions counts their calls)."""
    calls = {"seg_minmax": 0, "gather": 0}
    orig = TK.seg_minmax_plain, TK.gather_plain

    def mm(*a, **k):
        calls["seg_minmax"] += 1
        return orig[0](*a, **k)

    def ga(*a, **k):
        calls["gather"] += 1
        return orig[1](*a, **k)

    rng = np.random.default_rng(1)
    data = {"symbol": rng.integers(0, 50, 3000).astype(np.uint32),
            "price": rng.uniform(1, 200, 3000).astype(np.float32),
            "volume": rng.integers(0, 5000, 3000).astype(np.int32)}
    TK.MINMAX_LAUNCHES = TK.GATHER_LAUNCHES = 0
    try:
        TK.seg_minmax_plain, TK.gather_plain = mm, ga
        _ohlc(pt, pt.DataFrame(data, device="cpu"))
    finally:
        TK.seg_minmax_plain, TK.gather_plain = orig
    # group_start (open), high, low and the last row (close); one mean
    assert calls == {"seg_minmax": 4, "gather": 1}
    assert TK.MINMAX_LAUNCHES == TK.GATHER_LAUNCHES == 0
