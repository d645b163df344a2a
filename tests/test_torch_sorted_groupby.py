"""The sorted tier of the group-by, and the aggregates that need each
group's values in order, through the JAX package and the port.

Median and quantile (every interpolation), n_unique, arg_min/arg_max,
mode, product, corr/cov and aggregates of `expr.filter(pred)`, over the
dense tier (an Int64 key with stats), the hash tier (a dictionary-string
key of 6000 values) and the sorted tier (float, computed and redefined
integer keys, and three Int64 keys of more than 2^32 slots), on the same
seeded numpy data (2 * 8192 + 777 rows) through `polaroid_tpu` (its CPU
path: true f64) and `polaroid_tpu_torch` with device="cpu" (the card's
path, with the kernels' plain versions). Rows are compared in key order:
the dense and sorted tiers emit it, the hash tier's rows are sorted by
key first. chip_smoke.py's phase-9 queries also run here, at 2 * 10^5
rows against the smoke's own oracles, with and without garbage in every
uninitialised allocation.

Tolerances: exact for keys (bit for bit), counts, integer results,
order statistics (lower, higher and nearest quantiles, mode, arg_min,
arg_max, n_unique) and row order; rtol 1e-12 for Float64 sums, means,
cov and the linear and midpoint quantiles (both sides use the same
formula in f64; the JAX package sums the two interpolation terms in a
scatter); 1e-12 absolute for corr. `product` is held to numpy, where the
JAX package divides a running cumprod (ROADMAP Queue 3).
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
INTERPS = ("linear", "lower", "higher", "midpoint", "nearest")
# the key of each tier: Int64 with stats (dense, 41 slots), a string of
# 6000 values (hash), a Float64 (sorted)
TIER_KEYS = {"dense": "k", "hash": "sid", "sorted": "fk"}
SPECIAL = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf])


@functools.lru_cache(maxsize=None)
def _data(seed: int = 41):
    rng = np.random.default_rng(seed)
    uniq = np.array([f"k{i:05d}" for i in range(NUNIQ)], dtype=object)
    f64 = rng.uniform(-100, 100, N)
    f64[rng.integers(0, N, 60)] = SPECIAL[rng.integers(0, 5, 60)]
    fk = rng.integers(-20, 20, N) / 4.0
    fk[rng.integers(0, N, 30)] = SPECIAL[rng.integers(0, 5, 30)]
    cols = {
        "sid": uniq[rng.integers(0, NUNIQ, N)],
        "k": rng.integers(0, 40, N),
        "fk": fk,
        "fk32": (rng.integers(0, 30, N) / 2).astype(np.float32),
        "a": rng.integers(-500, 500, N).astype(np.int32),
        # three Int64 keys whose span product is far above 2^32
        "b1": rng.integers(0, 4, N) * 10**7,
        "b2": rng.integers(0, 3, N) * 10**7 - 5,
        "b3": rng.integers(0, 3, N) * 3 * 10**6,
        "f64": f64,
        "f32": rng.uniform(-100, 100, N).astype(np.float32),
        "i32": rng.integers(-50, 50, N).astype(np.int32),
        "i64": rng.integers(-10**12, 10**12, N),
        "w": rng.normal(size=N),
    }
    valid = {"sid": rng.random(N) < 0.995, "fk": rng.random(N) < 0.97,
             "f64": rng.random(N) < 0.9, "i64": rng.random(N) < 0.9,
             "w": rng.random(N) < 0.93}
    return cols, valid


@functools.lru_cache(maxsize=None)
def _default_frames():
    return frames(*_data())


def frames(cols=None, valid=None):
    """The same host data as a `polaroid_tpu` frame (nulls as None) and
    as the port's frame on the CPU (the default data's built once)."""
    if cols is None:
        return _default_frames()
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


def _same(x, y, close: bool, absolute: bool = False) -> bool:
    if x is None or y is None:
        return x is None and y is None
    if isinstance(y, float):
        if math.isnan(y) or math.isnan(x):
            return math.isnan(x) and math.isnan(y)
        if close and not math.isinf(y):
            tol = 1e-12 if absolute else 1e-12 * abs(y)
            return abs(x - y) <= tol
    return x == y


def check(got, want, keys, close=(), absolute=(), ordered=True):
    """Row by row: keys bit for bit, the `close` columns within rtol
    1e-12 (`absolute`: within 1e-12), every other column exact (NaN
    equal to NaN). Unordered results are sorted by their keys first."""
    assert {k: repr(v) for k, v in got.schema.items()} == \
        {k: repr(v) for k, v in want.schema.items()}
    g, w = got.to_dict(), want.to_dict()
    names = list(w)
    assert list(g) == names
    gr = list(zip(*[g[k] for k in names]))
    wr = list(zip(*[w[k] for k in names]))
    if not ordered:
        ki = [names.index(k) for k in keys]

        def order(r):
            return tuple((r[i] is not None, r[i]) for i in ki)
        gr, wr = sorted(gr, key=order), sorted(wr, key=order)
    assert len(gr) == len(wr)
    for rg, rw in zip(gr, wr):
        for name, x, y in zip(names, rg, rw):
            if name in keys and isinstance(y, float):
                assert _bits(x) == _bits(y), (name, rw)
            else:
                assert _same(x, y, name in close or name in absolute,
                             name in absolute), (name, rg, rw)
    return g


@pytest.mark.parametrize("col", ["f64", "f32", "i32", "i64"])
@pytest.mark.parametrize("tier", sorted(TIER_KEYS))
def test_quantiles_match_reference(tier, col):
    """median and quantile(q) with every interpolation, of Float64 (NaN,
    -0.0, +-inf, nulls), Float32, Int32 and nullable Int64 values, on
    each tier."""
    rdf, tdf = frames()
    key = TIER_KEYS[tier]

    def q(pl, df):
        c = pl.col(col)
        return (df.lazy().group_by(key)
                .agg(c.median().alias("med"),
                     *[c.quantile(0.3, i).alias(i) for i in INTERPS],
                     c.quantile(0.9, "nearest").alias("q9"),
                     c.quantile(0.5, "midpoint").alias("mid5"))
                .collect())

    check(q(pt, tdf), q(ref, rdf), (key,),
          close={"med", "linear", "midpoint", "mid5"},
          ordered=tier != "hash")


@pytest.mark.parametrize("tier", sorted(TIER_KEYS))
def test_ordered_aggregates_match_reference(tier):
    """n_unique, arg_min, arg_max and mode of Float64 (NaN, -0.0, +-inf,
    nulls), Int32, a nullable Int64 and a string, on each tier."""
    rdf, tdf = frames()
    key = TIER_KEYS[tier]
    other = "sid" if key != "sid" else "k"

    def q(pl, df):
        c = pl.col
        return (df.lazy().group_by(key)
                .agg(c("f64").n_unique().alias("nu_f64"),
                     c("i32").n_unique().alias("nu_i32"),
                     c("i64").n_unique().alias("nu_i64"),
                     c(other).n_unique().alias("nu_other"),
                     c("f64").arg_min().alias("amin_f64"),
                     c("f64").arg_max().alias("amax_f64"),
                     c("i32").arg_max().alias("amax_i32"),
                     c("i64").arg_min().alias("amin_i64"),
                     c("i32").mode().alias("mode_i32"),
                     c("f64").mode().alias("mode_f64"))
                .collect())

    check(q(pt, tdf), q(ref, rdf), (key,), ordered=tier != "hash")


@pytest.mark.parametrize("tier", sorted(TIER_KEYS))
def test_corr_cov_and_filtered_aggregates_match_reference(tier):
    """pl.corr, pl.cov and corr ** 2 (the optimizer's fused form) with
    nulls, and aggregates of col(x).filter(pred), on each tier."""
    rdf, tdf = frames()
    key = TIER_KEYS[tier]

    def q(pl, df):
        c = pl.col
        return (df.lazy().group_by(key)
                .agg(pl.corr("f64", "w").alias("r"),
                     (pl.corr("i32", "w") ** 2).alias("r2"),
                     pl.cov("i64", "w").alias("cv"),
                     c("f64").filter(c("i32") > 0).sum().alias("fs"),
                     c("i32").filter(c("w") > 0).sum().alias("fi"),
                     c("w").filter(c("i32") < 10).mean().alias("fm"),
                     c("i64").filter(c("a") > 0).count().alias("fc"),
                     c("i32").filter(c("f64") > 0).max().alias("fx"),
                     c("w").filter(c("a") > 100).first().alias("ff"),
                     c("w").sum().alias("ws"))
                .collect())

    check(q(pt, tdf), q(ref, rdf), (key,), close={"cv", "fs", "fm", "ws"},
          absolute={"r", "r2"}, ordered=tier != "hash")


_KEYED = {
    "float64": lambda pl, df: df.lazy().group_by("fk"),
    "float32": lambda pl, df: df.lazy().group_by("fk32"),
    "computed": lambda pl, df: df.lazy().group_by(
        (pl.col("a") % 13).alias("m")),
    "redefined": lambda pl, df: df.lazy().with_columns(
        (pl.col("k") * 3).alias("k")).group_by("k"),
    "three_int64": lambda pl, df: df.lazy().group_by("b1", "b2", "b3"),
    "float_and_computed": lambda pl, df: df.lazy().group_by(
        "fk", (pl.col("a") // 100).alias("d")),
    "filtered_float64": lambda pl, df: df.lazy().filter(
        pl.col("i32") > 0).group_by("fk"),
}
_KEY_NAMES = {"float64": ("fk",), "float32": ("fk32",), "computed": ("m",),
              "redefined": ("k",), "three_int64": ("b1", "b2", "b3"),
              "float_and_computed": ("fk", "d"), "filtered_float64": ("fk",)}


@pytest.mark.parametrize("keys", sorted(_KEYED))
def test_sorted_tier_keys_match_reference(keys):
    """Float64 (NaN, -0.0, +-inf, nulls) and Float32 keys, a computed and
    a redefined integer key, three Int64 keys of more than 2^32 slots, a
    mix, and a Float64 key over a filtered frame: the sorted tier, in
    ascending key order with nulls first, as the JAX package's sorted
    layout."""
    rdf, tdf = frames()

    def q(pl, df):
        c = pl.col
        return (_KEYED[keys](pl, df)
                .agg(pl.len().alias("n"), c("f64").sum().alias("s"),
                     c("i32").mean().alias("m_i32"),
                     c("i64").min().alias("mn"), c("f64").max().alias("mx"),
                     c("w").first().alias("first"),
                     c("i32").last().alias("last"),
                     c("f64").median().alias("med"))
                .collect())

    check(q(pt, tdf), q(ref, rdf), _KEY_NAMES[keys],
          close={"s", "m_i32", "med"})


def test_sorted_tier_maintain_order_and_trailing_sort():
    """maintain_order=True orders the sorted tier's groups by their first
    row; a trailing sort by the keys (dropped by the optimizer) and one
    after a median (kept) give ascending key order."""
    rdf, tdf = frames()

    def first_order(pl, df):
        return df.group_by("fk", maintain_order=True).agg(
            pl.col("i32").sum().alias("s"), pl.len().alias("n"))

    g = check(first_order(pt, tdf), first_order(ref, rdf), ("fk",))
    cols, valid = _data()
    keys = [struct.pack("<d", x) if ok else None
            for x, ok in zip(cols["fk"], valid["fk"])]
    assert [None if x is None else _bits(x) for x in g["fk"]] == \
        list(dict.fromkeys(keys))

    for agg in ("sum", "median"):
        def key_order(pl, df):
            return (df.lazy().group_by((pl.col("a") % 7).alias("m"), "k")
                    .agg(getattr(pl.col("w"), agg)().alias("x"))
                    .sort("m", "k").collect())

        g = check(key_order(pt, tdf), key_order(ref, rdf), ("m", "k"),
                  close={"x"})
        pairs = list(zip(g["m"], g["k"]))
        assert pairs == sorted(pairs)


def test_nullable_key_and_values_on_the_dense_tier():
    """A nullable key with stats (the dense tier, null slot included):
    the median of a nullable Float64, a nearest quantile, n_unique and
    arg_max, as phase 9's N1 runs them."""
    cols, valid = _data()
    cols = dict(cols, kn=cols["k"], vn=cols["f64"])
    valid = dict(valid, kn=np.random.default_rng(5).random(N) < 0.95)
    rdf, tdf = frames(cols, valid)

    def q(pl, df):
        c = pl.col
        return (df.lazy().group_by("kn")
                .agg(c("f64").median().alias("med"),
                     c("w").quantile(0.9, "nearest").alias("q9"),
                     c("i64").n_unique().alias("nu"),
                     c("i32").arg_max().alias("am"))
                .collect())

    g = check(q(pt, tdf), q(ref, rdf), ("kn",), close={"med"})
    assert g["kn"][0] is None


def test_product_over_each_groups_own_rows_not_a_cumprod_ratio():
    """product is each group's own product, held to numpy. The JAX
    package divides one running cumprod (a zero in an earlier group
    makes every later one NaN, and an Int32 overflow makes it 0):
    over g = [0,0,1,1,2,2], v = [0,1,2,3,4,5] it gives [0, nan, nan]
    and [0, 0, 0]; the answer is [0, 6, 20]."""
    g = np.array([0, 0, 1, 1, 2, 2], dtype=np.int32)
    v = np.arange(6.0)
    df = pt.DataFrame({"g": g, "v": v, "i": v.astype(np.int32)},
                      device="cpu")
    out = df.group_by("g").agg(pt.col("v").product(),
                               pt.col("i").product()).to_dict()
    assert out == {"g": [0, 1, 2], "v": [0.0, 6.0, 20.0], "i": [0, 6, 20]}
    rdf = ref.DataFrame({"g": g, "v": v})
    r = rdf.group_by("g").agg(ref.col("v").product()).sort("g")
    assert r.to_dict()["v"][0] == 0.0 and math.isnan(r.to_dict()["v"][1])

    cols, valid = _data()
    rng = np.random.default_rng(3)
    i32 = rng.integers(1, 200, N).astype(np.int32)
    f64 = rng.uniform(0.5, 1.5, N)
    f32 = rng.uniform(0.8, 1.25, N).astype(np.float32)
    k = cols["k"]
    f64[np.flatnonzero(k == 0)[0]] = 0.0           # a zero, group 0
    vf = valid["f64"]
    tdf = frame_from_numpy({"k": k, "i32": i32, "i64": cols["i64"],
                            "f64": f64, "f32": f32},
                           validity={"f64": vf}, device="cpu")
    got = tdf.group_by("k").agg(
        *[pt.col(c).product() for c in ("i32", "i64", "f64", "f32")]
    ).to_dict()
    assert got["k"] == list(range(40))
    with np.errstate(over="ignore"):
        for j, kk in enumerate(got["k"]):
            sel = k == kk
            # Int32: the int64 product (wrapping) cut to 32 bits
            assert got["i32"][j] == np.int64(
                np.prod(i32[sel].astype(np.int64))).astype(np.int32)
            assert got["i64"][j] == np.prod(cols["i64"][sel])
            want = np.prod(f64[sel & vf])
            assert got["f64"][j] == want if want == 0 else \
                abs(got["f64"][j] - want) <= 1e-12 * abs(want)
            # Float32: the f64 product rounded once (one f32 ulp)
            w32 = np.float32(np.prod(f32[sel].astype(np.float64)))
            assert abs(got["f32"][j] - w32) <= np.spacing(w32)
    assert got["f64"][0] == 0.0
    # every group's Int32 product overflows 32 (and 64) bits
    assert all(math.prod(i32[k == kk].tolist()) >= 2**64
               for kk in range(40))


def test_uint64_order_statistics_above_2_63():
    """UInt64 values at or above 2^63 (held in int64) keep their unsigned
    order in median, quantile, arg_max and mode, and product wraps
    modulo 2^64 (the JAX package wraps them through int64, as its
    mean: ROADMAP Queue 3)."""
    u = np.array([2**63 + 5, 1, 2**64 - 1, 7, 3, 2**64 - 1],
                 dtype=np.uint64)
    df = pt.DataFrame({"k": np.array([3, 1, 3, 2, 1, 3]), "u": u},
                      device="cpu")
    out = df.group_by("k").agg(
        pt.col("u").median().alias("med"),
        pt.col("u").quantile(0.5, "lower").alias("lo"),
        pt.col("u").arg_max().alias("am"), pt.col("u").mode().alias("mo"),
        pt.col("u").product().alias("p")).sort("k").to_dict()
    big = [2**63 + 5, 2**64 - 1, 2**64 - 1]
    assert out["med"] == [2.0, 7.0, float(2**64 - 1)]
    assert out["lo"] == [1.0, 7.0, float(2**64 - 1)]
    assert out["am"] == [1, 0, 1]
    assert out["mo"] == [1, 7, 2**64 - 1]
    assert out["p"] == [3, 7, math.prod(big) % 2**64]


def test_hash_tier_median_sorts_once_more(monkeypatch):
    """A median over the hash tier groups its key through the exchange,
    then sorts (group id, value): H2O q6's route."""
    calls = []
    orig = TH.group_ids
    monkeypatch.setattr(TH, "group_ids",
                        lambda *a: calls.append(1) or orig(*a))
    rdf, tdf = frames()

    def q(pl, df):
        return (df.lazy().group_by("sid", "k")
                .agg(pl.col("w").median().alias("med"),
                     pl.col("w").std().alias("sd"))
                .collect())

    check(q(pt, tdf), q(ref, rdf), ("sid", "k"), close={"med", "sd"},
          ordered=False)
    assert len(calls) == 1


def test_expr_filter_outside_an_aggregation_raises():
    """col(x).filter(pred) in a select: Slice E1 has landed, and the
    select compacts to the rows where the predicate holds (it raised
    before, rather than return every row)."""
    df = pt.DataFrame({"x": np.arange(6)}, device="cpu")
    out = df.select(pt.col("x").filter(pt.col("x") > 2))
    assert out.to_dict() == {"x": [3, 4, 5]}


@functools.lru_cache(maxsize=None)
def _phase9_frames(rows: int = 200_000):
    """chip_smoke.py's H2O frame (G1, seed 0) and its null copies, on the
    CPU, at 2 * 10^5 rows (every (id4, id5) group holds at least 5 rows,
    so q6's std is defined in each)."""
    import chip_smoke as CS
    h2o = CS.make_h2o_data(rows, 0)
    hdf = pt.DataFrame(h2o, device="cpu")
    ndf, valid = CS.with_null_copies(pt, hdf, h2o, 0)
    return CS, h2o, hdf, ndf, valid


def _garbage(alloc, gen):
    """`alloc` whose result is filled with garbage first: NaN or the
    dtype's largest finite value for floats, random bits for integers,
    random bools."""
    import torch

    def filled(*args, **kwargs):
        t = alloc(*args, **kwargs)
        if t.is_floating_point():
            t.copy_(torch.where(torch.rand(t.shape, generator=gen) < 0.5,
                                float("nan"), torch.finfo(t.dtype).max)
                    .to(t.dtype))
        elif t.dtype == torch.bool:
            t.copy_(torch.rand(t.shape, generator=gen) < 0.5)
        else:
            t.copy_(torch.randint(-2**31, 2**31 - 1, t.shape,
                                  generator=gen).to(t.dtype))
        return t
    return filled


@pytest.mark.parametrize("name", ["q6", "q9", "q10_full", "K1", "N1",
                                  "U1"])
def test_phase9_queries_read_no_unwritten_memory(name, monkeypatch):
    """chip_smoke.py's phase-9 queries on the CPU at 2 * 10^5 rows,
    against the smoke's own numpy oracles, twice: as they run, and with
    every uninitialised torch allocation (empty, empty_like,
    empty_strided, new_empty) filled with garbage first. Both runs pass
    their oracle and agree bit for bit, so no query reads memory that it
    did not write. The oracle's largest errors print under -s."""
    import torch
    CS, h2o, hdf, ndf, valid = _phase9_frames()
    lf = {q: f for q, f, _ in CS.sorted_tier_queries(pt, hdf, ndf)}[name]

    def run():
        out = lf.collect()
        _, errs = CS.check_sorted_tier(name, out, h2o, valid)
        return CS.host_columns(out), errs

    plain, errs = run()
    gen = torch.Generator().manual_seed(1)
    for alloc in ("empty", "empty_like", "empty_strided"):
        monkeypatch.setattr(torch, alloc, _garbage(getattr(torch, alloc),
                                                   gen))
    monkeypatch.setattr(torch.Tensor, "new_empty",
                        _garbage(torch.Tensor.new_empty, gen))
    garbage, _ = run()
    monkeypatch.undo()
    assert plain.keys() == garbage.keys()
    for col, (data, validity) in plain.items():
        g_data, g_validity = garbage[col]
        assert data.tobytes() == g_data.tobytes(), col
        assert (validity is None) == (g_validity is None), col
        if validity is not None:
            assert np.array_equal(validity, g_validity), col
    print(name, errs)
