"""Grouped windows, `expr.over()`, through the JAX package and the port.

Aggregates broadcast to rows (and combinations of them), shift, diff,
pct_change, the cumulative ops, rank with every method (the fused route
and the general one, against each other with forced ties), fills,
rolling and ewm windows and reverse, each over partitions of one or two
keys, a nullable key and a String key, `order_by` with `descending` and
`nulls_last`, and `mapping_strategy="explode"`, over the same seeded
numpy columns (Int32, Int64, UInt32, Float32 and Float64 with 10%
nulls; the floats with NaN, -0.0 and 0.0) through `polaroid_tpu` and
`polaroid_tpu_torch` on the CPU, after a filter and without one; then
chip_smoke.py's phase-11 queries (H2O q8, W1-W4) at 2 * 10^4 rows
against the smoke's numpy oracles, q8, W1 and W3 also against the JAX
package, and q8, W1 and W3's rolling std with garbage in every
uninitialised allocation.

Tolerances, with u the unit roundoff of the result's type: bit for bit
for integers, counts, ranks, shifts, fills, min/max, first/last and the
nulls; cum_sum over a partition of n rows within 4·n·u·Σ|x| of the
partition; sums and means of a partition within 4·n·u·Σ|x| of it; the
ewm and pct_change within 64·u of the column's largest |x|; rolling
sums and means within 4·w·u·Σ|x| of the window, the rolling variance
within 8·w·u of the window's Σx² (std on the squares).

The JAX package's partitioned rolling windows take prefix sums over
each partition, so one NaN turns every later window of its partition
NaN, and its partitioned cum ops ignore `reverse`: both are held to a
numpy oracle per partition instead.
"""

import functools

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


N = 500
DTYPES = {"Int32": np.int32, "Int64": np.int64, "UInt32": np.uint32,
          "Float32": np.float32, "Float64": np.float64}
CASES = [(dt, True) for dt in DTYPES] + [("Float64", False)]
WORDS = np.array(["ash", "elm", "fir", "oak"], dtype=object)


def frames(cols, valid):
    rcols = {}
    for k, x in cols.items():
        if k in valid:
            rcols[k] = [x[i].item() if hasattr(x[i], "item") else x[i]
                        for i in range(len(x))]
            rcols[k] = [v if valid[k][i] else None
                        for i, v in enumerate(rcols[k])]
        elif isinstance(x, np.ndarray) and x.dtype == object:
            rcols[k] = list(x)
        else:
            rcols[k] = x
    tcols = {k: list(x) if isinstance(x, np.ndarray) and x.dtype == object
             else x for k, x in cols.items()}
    tdf = frame_from_numpy(tcols, validity=valid, device="cpu")
    schema = {k: getattr(ref, repr(tdf.schema[k])) for k in cols}
    return ref.DataFrame(rcols, schema=schema), tdf


@functools.lru_cache(maxsize=None)
def _data(dt: str, seed: int = 5):
    rng = np.random.default_rng(seed)
    if dt.startswith("Float"):
        x = rng.normal(0, 10, N).round(1)
        special = np.array([np.nan, -0.0, 0.0])
        x[rng.integers(0, N, N // 30)] = special[rng.integers(0, 3,
                                                              N // 30)]
    else:
        x = rng.integers(-20 if dt[0] == "I" else 0, 20, N)
    cols = {"x": x.astype(DTYPES[dt]),
            "k": rng.integers(0, 7, N).astype(np.int32),
            "k2": rng.integers(0, 3, N).astype(np.int64),
            "kn": rng.integers(0, 5, N).astype(np.int32),
            "s": WORDS[rng.integers(0, len(WORDS), N)],
            "t": rng.integers(0, 40, N).astype(np.int32),
            "f": rng.random(N) < 0.7}
    valid = {"x": rng.random(N) >= 0.1, "kn": rng.random(N) >= 0.15,
             "t": rng.random(N) >= 0.1}
    return cols, valid


def _c(m):
    return m.col("x")


# name -> (expression builder over a package module, tolerance class)
OVER = {
    "sum": (lambda m: _c(m).sum().over("k"), "sum"),
    "mean2": (lambda m: _c(m).mean().over("k", "k2"), "sum"),
    "len_nullable": (lambda m: m.len().over("kn"), "exact"),
    "min_nullable": (lambda m: _c(m).min().over("kn"), "exact"),
    "max_str": (lambda m: _c(m).max().over("s"), "exact"),
    "count": (lambda m: _c(m).count().over("k", "s"), "exact"),
    "combo": (lambda m: (_c(m).max() - _c(m).min() + 1).over("k"),
              "exact"),
    "centered": (lambda m: _c(m) - _c(m).mean().over("k"), "sum"),
    "first_ordered": (lambda m: _c(m).first().over("k", order_by="t"),
                      "exact"),
    "last_ordered": (lambda m: _c(m).last().over("k", order_by="t"),
                     "exact"),
    "shift": (lambda m: _c(m).shift(1).over("k"), "exact"),
    "shift_back": (lambda m: _c(m).shift(-2).over("k", "k2"), "exact"),
    "shift_fill": (lambda m: _c(m).shift(1, fill_value=0).over("kn"),
                   "exact"),
    "diff": (lambda m: _c(m).diff().over("s"), "exact"),
    "pct_change": (lambda m: _c(m).pct_change().over("k"), "exact"),
    "cum_sum": (lambda m: _c(m).cum_sum().over("k"), "cum"),
    "cum_min": (lambda m: _c(m).cum_min().over("kn"), "exact"),
    "cum_max": (lambda m: _c(m).cum_max().over("k", "s"), "exact"),
    "cum_count": (lambda m: _c(m).cum_count().over("k"), "exact"),
    "cum_sum_ordered": (lambda m: _c(m).cum_sum().over("k", order_by="t"),
                        "cum"),
    "cum_sum_desc_nl": (lambda m: _c(m).cum_sum().over(
        "k", order_by="t", descending=True, nulls_last=True), "cum"),
    "shift_ordered_desc": (lambda m: _c(m).shift(1).over(
        "k2", order_by="t", descending=True), "exact"),
    "rank": (lambda m: _c(m).rank().over("k"), "exact"),
    "rank_ordinal": (lambda m: _c(m).rank("ordinal").over("k"), "exact"),
    "rank_min_desc": (lambda m: _c(m).rank("min", descending=True)
                      .over("k", "k2"), "exact"),
    "rank_max": (lambda m: _c(m).rank("max").over("kn"), "exact"),
    "rank_dense": (lambda m: _c(m).rank("dense").over("s"), "exact"),
    "forward_fill": (lambda m: _c(m).forward_fill().over("k"), "exact"),
    "backward_fill": (lambda m: _c(m).backward_fill().over("kn"),
                      "exact"),
    "ewm_mean": (lambda m: _c(m).ewm_mean(alpha=0.3).over("k"), "scale"),
    "reverse": (lambda m: _c(m).reverse().over("k"), "exact"),
}


def _f(vals):
    return np.array([np.nan if v is None else float(v) for v in vals])


def _group_ids(cols, valid, keys, live):
    """Each live row's partition id (a null key is a value of its own)."""
    code = np.zeros(int(live.sum()), dtype=np.int64)
    for k in keys:
        v = cols[k][live]
        if v.dtype == object:
            v = np.searchsorted(WORDS, v)
        v = v.astype(np.int64) + 1
        if k in valid:
            v = np.where(valid[k][live], v, 0)
        code = code * 1000 + v
    return code


def _bound(kind, dt, x, xv, gid):
    u = 2.0 ** -24 if dt == "Float32" else 2.0 ** -53
    ax = np.where(xv & ~np.isnan(x.astype(np.float64)),
                  np.abs(x.astype(np.float64)), 0.0)
    if kind in ("sum", "cum"):
        _, inv, cnt = np.unique(gid, return_inverse=True,
                                return_counts=True)
        tot = np.bincount(inv, weights=ax)
        return 4 * cnt[inv] * u * tot[inv] + 1e-300
    return np.full(len(x), 64 * u * (ax.max() if ax.size else 0.0))


def _compare(name, want, got, kind, bound=None):
    assert len(got) == len(want), name
    wn = np.array([v is None for v in want])
    gn = np.array([v is None for v in got])
    assert np.array_equal(gn, wn), f"{name}: nulls differ at " \
        f"{np.flatnonzero(gn != wn)[:5].tolist()}"
    w, g = _f(want)[~wn], _f(got)[~gn]
    nan = np.isnan(w)
    assert np.array_equal(np.isnan(g), nan), f"{name}: NaNs differ"
    w, g = w[~nan], g[~nan]
    if kind == "exact":
        assert np.array_equal(g, w), f"{name}: differs at " \
            f"{np.flatnonzero(g != w)[:5].tolist()}"
        return
    b = bound[~wn][~nan]
    if kind == "std":
        g, w = g * g, w * w
        b = b + 4 * np.abs(w) * 2.0 ** -23
    bad = np.abs(g - w) > b
    assert not bad.any(), f"{name}: outside its bound at " \
        f"{np.flatnonzero(bad)[:5].tolist()}"


@functools.lru_cache(maxsize=None)
def _results(dt: str, filtered: bool):
    cols, valid = _data(dt)
    r, t = frames(cols, valid)
    if filtered:
        r, t = r.filter(ref.col("f")), t.filter(pt.col("f"))
    # one select per expression: the JAX package's select would share a
    # common aggregate between expressions (cse_cached), which its
    # .over() does not take
    want = {n: r.select(OVER[n][0](ref).alias(n)).to_dict()[n]
            for n in OVER}
    got = t.select([OVER[n][0](pt).alias(n) for n in OVER]).to_dict()
    return want, got


_KEYS = {"sum": ("k",), "mean2": ("k", "k2"), "centered": ("k",),
         "cum_sum": ("k",), "cum_sum_ordered": ("k",),
         "cum_sum_desc_nl": ("k",)}


@pytest.mark.parametrize("name,dt,filtered", [
    (n, dt, f) for dt, f in CASES for n in OVER])
def test_over_op_matches_jax(name, dt, filtered):
    want, got = _results(dt, filtered)
    kind = OVER[name][1]
    bound = None
    if kind != "exact":
        cols, valid = _data(dt)
        live = cols["f"] if filtered else np.ones(N, dtype=bool)
        gid = _group_ids(cols, valid, _KEYS.get(name, ("k",)), live)
        bound = _bound(kind, dt, cols["x"][live], valid["x"][live], gid)
    _compare(name, want[name], got[name], kind, bound)


# --- partitioned rolling windows and reversed cum ops: numpy oracle ----------

def _oracle_rolling(x, xv, gid, w, min_p, op, ddof=1):
    """Each row's trailing window of its partition's rows, as polars
    defines it: nulls left out, NaN propagating."""
    n = len(x)
    out = np.full(n, np.nan)
    ok = np.zeros(n, dtype=bool)
    mag = np.zeros((2, n))      # each window's Σ|x| and Σx² (NaN left out)
    for g in np.unique(gid):
        rows = np.flatnonzero(gid == g)
        for j, i in enumerate(rows):
            win = rows[max(0, j - w + 1):j + 1]
            vals = x[win][xv[win]].astype(np.float64)
            fin = vals[~np.isnan(vals)]
            mag[:, i] = np.abs(fin).sum(), (fin * fin).sum()
            if len(vals) < min_p or (op in ("std", "var")
                                     and len(vals) <= ddof):
                continue
            ok[i] = True
            if op == "sum":
                out[i] = vals.sum()
            elif op == "mean":
                out[i] = vals.mean()
            elif op == "min":
                out[i] = vals.min()
            elif op == "max":
                out[i] = vals.max()
            else:
                out[i] = vals.var(ddof=ddof)
    return out, ok, mag


ROLLING = {
    "rolling_sum": (lambda m: _c(m).rolling_sum(3, min_samples=1)
                    .over("k"), 3, 1, "sum"),
    "rolling_mean": (lambda m: _c(m).rolling_mean(4).over("k", "s"), 4, 4,
                     "mean"),
    "rolling_min": (lambda m: _c(m).rolling_min(3).over("kn"), 3, 3,
                    "min"),
    "rolling_max": (lambda m: _c(m).rolling_max(4, min_samples=2)
                    .over("k"), 4, 2, "max"),
    "rolling_var": (lambda m: _c(m).rolling_var(4).over("k"), 4, 4, "var"),
    "rolling_std": (lambda m: _c(m).rolling_std(5, min_samples=3)
                    .over("k"), 5, 3, "std"),
}


@pytest.mark.parametrize("name,dt", [(n, dt) for dt in DTYPES
                                     for n in ROLLING])
def test_rolling_over_matches_numpy(name, dt):
    build, w, min_p, op = ROLLING[name]
    cols, valid = _data(dt)
    _, t = frames(cols, valid)
    live = cols["f"]
    got = t.filter(pt.col("f")).select(build(pt).alias("r")).to_dict()["r"]
    x, xv = cols["x"][live], valid["x"][live]
    keys = {"rolling_mean": ("k", "s"), "rolling_min": ("kn",)}.get(
        name, ("k",))
    gid = _group_ids(cols, valid, keys, live)
    want, ok, mag = _oracle_rolling(x, xv, gid, w, min_p,
                                    "var" if op == "std" else op)
    if op == "std":
        want = np.sqrt(want)
    exact = op in ("min", "max")
    u = 2.0 ** -24 if dt == "Float32" else 2.0 ** -53
    if op in ("sum", "mean"):
        bound = 4 * w * u * mag[0] + 1e-300
    else:
        bound = 8 * w * u * mag[1] + 1e-300
    if dt != "Float64" and not exact:
        # a Float32 result is the f32 rounding of its f64 value
        bound = bound + 2.0 ** -23 * np.nan_to_num(np.abs(want)) * (
            1 + 2 * np.nan_to_num(np.abs(want)) * (op == "std"))
    _compare(name, [float(v) if k else None for v, k in zip(want, ok)],
             got, "exact" if exact else op if op == "std" else "sum",
             bound)


@pytest.mark.parametrize("op", ["cum_sum", "cum_max", "cum_count"])
def test_reversed_cum_over_matches_numpy(op):
    cols, valid = _data("Int64")
    _, t = frames(cols, valid)
    got = t.select(getattr(_c(pt), op)(reverse=True).over("k")
                   .alias("r")).to_dict()["r"]
    x, xv, k = cols["x"], valid["x"], cols["k"]
    want = [None] * N
    for g in np.unique(k):
        rows = np.flatnonzero(k == g)[::-1]
        acc, cnt = None, 0
        for i in rows:
            if xv[i]:
                cnt += 1
                acc = int(x[i]) if acc is None else (
                    acc + int(x[i]) if op == "cum_sum" else
                    max(acc, int(x[i])))
            want[i] = cnt if op == "cum_count" else (
                None if not xv[i] else acc)
    assert got == want


# --- rank: the fused route against the general one, with forced ties --------

@pytest.mark.parametrize("method", ["average", "min", "max", "dense",
                                    "ordinal"])
@pytest.mark.parametrize("desc", [False, True])
def test_fused_and_general_rank_over_agree(method, desc):
    """A Float64 value with nulls is three words and takes the general
    route (a second sort); the same values without the null word (nulls
    as NaN-free fill values, then masked) take the fused route: the
    valid rows' ranks agree, and both match a stable numpy oracle. The
    values repeat (forced ties)."""
    rng = np.random.default_rng(11)
    n = 700
    k = rng.integers(0, 9, n).astype(np.int32)
    v = rng.integers(0, 12, n).astype(np.float64) / 4
    nulls = rng.random(n) < 0.15
    df = frame_from_numpy({"k": k, "v": v, "w": v}, validity={"v": ~nulls},
                          device="cpu")
    e = pt.col("v").rank(method, descending=desc).over("k")
    general = df.select(e.alias("r")).to_dict()["r"]
    fused = df.filter(~pt.col("v").is_null()).select(
        pt.col("w").rank(method, descending=desc).over("k").alias("r")) \
        .to_dict()["r"]
    valid_rows = np.flatnonzero(~nulls)
    assert [general[i] for i in valid_rows] == fused
    assert all(general[i] is None for i in np.flatnonzero(nulls))
    # numpy: sort by (k, value), ties by row
    want = [None] * n
    for g in np.unique(k):
        rows = [i for i in range(n) if k[i] == g and not nulls[i]]
        order = sorted(rows, key=lambda i: (-v[i] if desc else v[i], i))
        vals = [v[i] for i in order]
        for pos, i in enumerate(order):
            first = vals.index(v[i])
            last = len(vals) - 1 - vals[::-1].index(v[i])
            want[i] = {"ordinal": pos + 1, "min": first + 1,
                       "max": last + 1,
                       "dense": len(set(vals[:first])) + 1,
                       "average": (first + last) / 2 + 1}[method]
    assert general == want


def test_explode_matches_jax():
    cols, valid = _data("Int64")
    r, t = frames(cols, valid)
    for build in (lambda m: _c(m).shift(1).over("k",
                                                mapping_strategy="explode"),
                  lambda m: _c(m).sum().over("kn",
                                             mapping_strategy="explode")):
        want = r.select(build(ref).alias("e")).to_dict()
        got = t.select(build(pt).alias("e")).to_dict()
        assert got == want


def test_explode_outside_a_select_raises():
    cols, valid = _data("Int64")
    _, t = frames(cols, valid)
    with pytest.raises(pt.InvalidOperationError):
        t.with_columns(_c(pt).sum().over("k", mapping_strategy="explode"))


# --- what this slice leaves out ---------------------------------------------

@pytest.mark.parametrize("build,slice_", [
    (lambda: pt.col("x").sum().over("k", mapping_strategy="join"),
     "Slice E"),
    (lambda: pt.col("x").rolling_sum_by("t", 3).over("k"), "Slice D2"),
    (lambda: pt.col("x").rolling_mean_by("t", 3), "Slice D2"),
    (lambda: pt.col("x").ewm_mean_by("t", half_life=2.0), "Slice D2"),
    (lambda: pt.col("x").interpolate_by("t"), "Slice D2"),
    (lambda: pt.col("x").rolling_map(sum, 3), "Slice E"),
    (lambda: pt.col("x").cumulative_eval(pt.col("x").sum()), "Slice E"),
])
def test_left_out_windows_raise(build, slice_):
    df = pt.DataFrame({"x": np.arange(8.0), "k": np.arange(8) % 2,
                       "t": np.arange(8)}, device="cpu")
    if slice_ == "Slice D2":
        # Slice D2 has landed: these windows evaluate now (held against
        # the JAX package in tests/test_torch_temporal_window.py)
        out = df.select(build().alias("r"))
        assert out.height == 8 and out.to_dict()["r"][-1] is not None
        return
    if build().attrs.get("op") == "rolling_map":
        # Slice E3 has landed: the host UDF windows evaluate now (held
        # against the JAX package in tests/test_torch_surface_exprs.py)
        out = df.select(build().alias("r"))
        assert out.height == 8 and out.to_dict()["r"][-1] is not None
        return
    if build().kind == "cumulative_eval":
        # Slice E3 has landed: an expression that names a column rather
        # than pl.element() is refused, as in the JAX package
        with pytest.raises(pt.ColumnNotFoundError):
            df.select(build().alias("r"))
        return
    if build().attrs.get("mapping_strategy") == "join":
        # Slice E2 has landed: the join mapping evaluates now (held
        # against the JAX package in tests/test_torch_nested.py)
        out = df.select(build().alias("r"))
        assert out.to_dict()["r"] == [[12.0], [16.0]] * 4
        return
    with pytest.raises(NotImplementedError, match=slice_):
        df.select(build().alias("r"))


def test_iejoin_plan_node_names_its_slice():
    """Slice D3 has landed: the executor runs an iejoin node (the pairs
    held to numpy here, and to the JAX package in
    tests/test_torch_iejoin.py)."""
    from polaroid_tpu_torch.exec import executor as X
    from polaroid_tpu_torch.plan import logical as L
    a, b = np.arange(8), np.array([2, 5])
    left = pt.DataFrame({"a": a}, device="cpu")._table
    right = pt.DataFrame({"b": b}, device="cpu")._table
    node = L.IEJoin(L.DataFrameScan(left), L.DataFrameScan(right),
                    [(pt.col("a"), "lt", pt.col("b"))], [], "_right")
    out = pt.DataFrame._from_table(X.execute(node)).to_dict()
    want = sorted((i, j) for i in a for j in b if i < j)
    assert sorted(zip(out["a"], out["b"])) == want


# --- chip_smoke.py's phase 11 at 2 * 10^4 rows ------------------------------

ROWS = 20_000


@functools.lru_cache(maxsize=None)
def _phase11(rows: int = ROWS):
    import chip_smoke as CS
    h2o = CS.make_h2o_data(rows, 0)
    q1 = CS.make_q1_data(rows, 0)
    hdf = pt.DataFrame(h2o, device="cpu")
    qdf, pv = CS.with_null_price(pt, pt.DataFrame(q1, device="cpu"), q1, 0)
    return CS, h2o, q1, hdf, qdf, pv


def _phase11_query(name):
    CS, h2o, q1, hdf, qdf, pv = _phase11()
    return {q: lf for q, lf, _ in CS.window_queries(pt, hdf, qdf)}[name]


PHASE11 = ["q8", "W1_center", "W1_sum", "W1_len", "W2_cum_sum",
           "W2_shift", "W2_diff", "W2_rank_dense", "W2_cum_sum_ordered",
           "W3_pct_change", "W3_rolling_mean", "W3_rolling_std",
           "W3_cum_sum", "W3_ewm_mean", "W3_forward_fill",
           "W4_rolling_mean", "W4_rolling_max", "W4_cum_sum", "W4_rank",
           "W4_forward_fill"]


@pytest.mark.parametrize("name", PHASE11)
def test_phase11_query_matches_its_oracle(name):
    CS, h2o, q1, hdf, qdf, pv = _phase11()
    out = _phase11_query(name).collect()
    nout, errs = CS.check_window(name, CS.host_columns(out), h2o, q1, pv)
    assert nout == out.height
    print(name, errs)


def _ref_phase11(name):
    """The same phase-11 query through the JAX package (q8, W1, W3)."""
    CS, h2o, q1, hdf, qdf, pv = _phase11()
    if name.startswith(("q8", "W1")):
        rdf = ref.DataFrame(h2o)
    else:
        price = q1["price"]
        rdf = ref.DataFrame({**q1, "pricen": [
            float(p) if ok else None for p, ok in zip(price, pv)]},
            schema={"pricen": ref.Float32, "symbol": ref.UInt32})
    return {q: lf for q, lf, _ in CS.window_queries(ref, rdf, rdf)}[name]


@pytest.mark.parametrize("name", [n for n in PHASE11
                                  if n.startswith(("q8", "W1", "W3"))])
def test_phase11_query_matches_jax(name):
    got = _phase11_query(name).collect().to_dict()
    want = _ref_phase11(name).collect().to_dict()
    assert list(got) == list(want)
    for k in want:
        g, w = _f(got[k]), _f(want[k])
        assert np.array_equal(np.isnan(g), np.isnan(w)), (name, k)
        ok = ~np.isnan(w)
        if name in ("W1_center", "W3_rolling_mean", "W3_rolling_std",
                    "W3_ewm_mean", "W3_pct_change"):
            # float results: f64 within 1e-12 of the value's magnitude,
            # Float32 within 2^-20 of it
            rtol = 2.0 ** -20 if name.startswith("W3") else 1e-12
            scale = np.abs(w[ok]) + (np.abs(_f(CS_v3())[ok])
                                     if name == "W1_center" else 0)
            assert np.all(np.abs(g[ok] - w[ok]) <= rtol * scale), (name, k)
        else:
            assert np.array_equal(g[ok], w[ok]), (name, k)


def CS_v3():
    return _phase11()[1]["v3"]


def _garbage(alloc, gen):
    """`alloc` whose result is filled with garbage first (as
    test_torch_sorted_groupby.py's guard): NaN or the largest finite
    value for floats, random bits for integers, random bools."""
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


@pytest.mark.parametrize("name", ["q8", "W1_center", "W1_sum", "W1_len",
                                  "W3_rolling_std"])
def test_phase11_queries_read_no_unwritten_memory(name, monkeypatch):
    """The query against its oracle twice: as it runs, and with every
    uninitialised torch allocation (empty, empty_like, empty_strided,
    new_empty) filled with garbage first; both agree bit for bit, so no
    window reads memory that it did not write."""
    import torch
    CS, h2o, q1, hdf, qdf, pv = _phase11()
    lf = _phase11_query(name)

    def run():
        out = lf.collect()
        CS.check_window(name, CS.host_columns(out), h2o, q1, pv)
        return CS.host_columns(out)

    plain = run()
    gen = torch.Generator().manual_seed(1)
    for alloc in ("empty", "empty_like", "empty_strided"):
        monkeypatch.setattr(torch, alloc, _garbage(getattr(torch, alloc),
                                                   gen))
    monkeypatch.setattr(torch.Tensor, "new_empty",
                        _garbage(torch.Tensor.new_empty, gen))
    garbage = run()
    monkeypatch.undo()
    assert plain.keys() == garbage.keys()
    for col, (data, validity) in plain.items():
        g_data, g_validity = garbage[col]
        assert data.tobytes() == g_data.tobytes(), col
        assert (validity is None) == (g_validity is None), col
        if validity is not None:
            assert np.array_equal(validity, g_validity), col


@pytest.mark.parametrize("window", ["cum_sum", "over"])
def test_filter_stays_above_a_window(window):
    """A filter on a column that a with_columns passes through is not
    pushed below a window (or an .over()) that the node computes: the
    window reads the rows the filter would remove. The JAX package's
    optimizer pushes it down (ROADMAP Queue 3)."""
    df = pt.DataFrame({"a": [1, 2, 3, 4, 5], "k": [0, 1, 0, 1, 0]},
                      device="cpu")
    e = pt.col("a").cum_sum() if window == "cum_sum" \
        else pt.col("a").sum().over("k")
    eager = df.with_columns(e.alias("c")).filter(pt.col("a") > 2)
    lazy = df.lazy().with_columns(e.alias("c")) \
        .filter(pt.col("a") > 2).collect()
    want = [6, 10, 15] if window == "cum_sum" else [9, 6, 9]
    assert eager.to_dict()["c"] == want
    assert lazy.to_dict()["c"] == want
