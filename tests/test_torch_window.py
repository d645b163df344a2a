"""Order-dependent window expressions through the JAX package and the port.

Every window op of the port (shift, diff, pct_change, the cumulative
ops, fixed-size rolling windows with quantiles, ranks, moments and
cov/corr, the ewm family, rank, fills, interpolate, reverse, rle_id,
peaks, fill_null with a value and every strategy, arg_sort) runs over
the same seeded numpy columns (Int32, Int64, UInt32, Float32 and
Float64, with 10% nulls; the floats with NaN, -0.0 and 0.0) through
`polaroid_tpu` (its CPU path) and `polaroid_tpu_torch` with
device="cpu" (the card's path with the kernels' plain versions), with
a filter before the window and without one.

Tolerances, with u the unit roundoff of the result's type (2^-53 for
Float64, 2^-24 for Float32):
* bit for bit: integers, counts, ranks, shifts, diffs, pct_change,
  fills, min/max, order statistics, rolling ranks, peaks, rle ids, the
  nulls of every result;
* cum_sum and cum_prod: within 4·n·u·Σ|x| of the column's n rows (a
  product: of the partial product's magnitude);
* rolling sums and means: within 4·w·u·Σ|x| of the window's w rows
  (rtol 4·w·u where the values are of one sign), ewm and interpolate:
  within 64·u of the column's largest |x|;
* rolling and ewm var/std: the variance within 8·w·u of the window's Σx²
  (ewm: of the column's largest x²), compared on the squares for std;
* skew, kurtosis, corr and cov (cancelling sums of powers): within
  2^-30·(1 + |value|).

`rank` differs from the JAX package where its values hold NaN (the JAX
package sorts NaN after the nulls, and last again when descending) and
in descending UInt32 ranks (it negates the unsigned values), so ranks
are held to a numpy oracle (NaN the largest value, -0.0 equal to 0.0,
ordinal ties by row) and to the JAX package on the columns where it is
right. Every op that this slice leaves out raises NotImplementedError
naming its slice.
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


N = 600
W = 5
DTYPES = {"Int32": np.int32, "Int64": np.int64, "UInt32": np.uint32,
          "Float32": np.float32, "Float64": np.float64}
# (dtype, filtered): every dtype behind a filter (the live order is a
# compaction), two of them without (the identity)
CASES = [(dt, True) for dt in DTYPES] + [("Int32", False),
                                         ("Float64", False)]


def frames(cols, valid):
    """The same host columns as a JAX-package frame and a port frame on
    the CPU."""
    rcols = {}
    for k, x in cols.items():
        if k in valid:
            rcols[k] = [x[i].item() if valid[k][i] else None
                        for i in range(len(x))]
        else:
            rcols[k] = x
    tdf = frame_from_numpy(cols, validity=valid, device="cpu")
    schema = {k: getattr(ref, repr(tdf.schema[k])) for k in cols}
    return ref.DataFrame(rcols, schema=schema), tdf


@functools.lru_cache(maxsize=None)
def _data(dt: str, seed: int = 3):
    rng = np.random.default_rng(seed)
    if dt.startswith("Float"):
        x = rng.normal(0, 10, N).round(1)
        special = np.array([np.nan, -0.0, 0.0])
        x[rng.integers(0, N, N // 30)] = special[rng.integers(0, 3,
                                                              N // 30)]
    else:
        x = rng.integers(-20 if dt[0] == "I" else 0, 20, N)
    cols = {"x": x.astype(DTYPES[dt]), "y": rng.normal(size=N),
            "f": rng.random(N) < 0.7}
    return cols, {"x": rng.random(N) >= 0.1}


def _c(m):
    return m.col("x")


# name -> (expression builder over a package module, tolerance class)
OPS = {
    "shift": (lambda m: _c(m).shift(1), "exact"),
    "shift_back": (lambda m: _c(m).shift(-2), "exact"),
    "shift_fill": (lambda m: _c(m).shift(1, fill_value=0), "exact"),
    "diff": (lambda m: _c(m).diff(), "exact"),
    "pct_change": (lambda m: _c(m).pct_change(), "exact"),
    "cum_sum": (lambda m: _c(m).cum_sum(), "cum"),
    "cum_sum_rev": (lambda m: _c(m).cum_sum(reverse=True), "cum"),
    "cum_min": (lambda m: _c(m).cum_min(), "exact"),
    "cum_max": (lambda m: _c(m).cum_max(), "exact"),
    "cum_max_rev": (lambda m: _c(m).cum_max(reverse=True), "exact"),
    "cum_count": (lambda m: _c(m).cum_count(), "exact"),
    "rolling_sum": (lambda m: _c(m).rolling_sum(W), "window"),
    "rolling_mean": (lambda m: _c(m).rolling_mean(W, min_samples=2),
                     "window"),
    "rolling_min": (lambda m: _c(m).rolling_min(W), "exact"),
    "rolling_max": (lambda m: _c(m).rolling_max(W, min_samples=1),
                    "exact"),
    "rolling_std": (lambda m: _c(m).rolling_std(W + 1), "std"),
    "rolling_var": (lambda m: _c(m).rolling_var(W + 1, ddof=0), "var"),
    "rolling_median": (lambda m: _c(m).rolling_median(W), "scale"),
    "rolling_q_linear": (lambda m: _c(m).rolling_quantile(
        0.3, "linear", W), "scale"),
    "rolling_q_nearest": (lambda m: _c(m).rolling_quantile(
        0.3, "nearest", W), "exact"),
    "rolling_q_lower": (lambda m: _c(m).rolling_quantile(0.6, "lower", W),
                        "exact"),
    "rolling_q_higher": (lambda m: _c(m).rolling_quantile(
        0.6, "higher", W), "exact"),
    "rolling_q_midpoint": (lambda m: _c(m).rolling_quantile(
        0.5, "midpoint", W), "scale"),
    "rolling_skew": (lambda m: _c(m).rolling_skew(W + 1), "moment"),
    "rolling_kurtosis": (lambda m: _c(m).rolling_kurtosis(W + 1),
                         "moment"),
    "rolling_rank": (lambda m: _c(m).rolling_rank(W), "exact"),
    "rolling_rank_max": (lambda m: _c(m).rolling_rank(W, "max", True),
                         "exact"),
    "ewm_mean": (lambda m: _c(m).ewm_mean(alpha=0.3), "scale"),
    "ewm_std": (lambda m: _c(m).ewm_std(alpha=0.3), "ewm_var"),
    "ewm_var": (lambda m: _c(m).ewm_var(alpha=0.3, bias=True), "ewm_var"),
    "forward_fill": (lambda m: _c(m).forward_fill(), "exact"),
    "backward_fill": (lambda m: _c(m).backward_fill(), "exact"),
    "interpolate": (lambda m: _c(m).interpolate(), "scale"),
    "reverse": (lambda m: _c(m).reverse(), "exact"),
    "rle_id": (lambda m: _c(m).rle_id(), "exact"),
    "peak_min": (lambda m: _c(m).peak_min(), "exact"),
    "peak_max": (lambda m: _c(m).peak_max(), "exact"),
    "arg_sort": (lambda m: _c(m).arg_sort(descending=True,
                                          nulls_last=True), "exact"),
    "fill_forward": (lambda m: _c(m).fill_null(strategy="forward"),
                     "exact"),
    "fill_backward": (lambda m: _c(m).fill_null(strategy="backward"),
                      "exact"),
    "fill_mean": (lambda m: _c(m).fill_null(strategy="mean"), "scale"),
    "fill_min": (lambda m: _c(m).fill_null(strategy="min"), "exact"),
    "fill_max": (lambda m: _c(m).fill_null(strategy="max"), "exact"),
    "fill_zero": (lambda m: _c(m).fill_null(strategy="zero"), "exact"),
    "fill_one": (lambda m: _c(m).fill_null(strategy="one"), "exact"),
    "fill_value": (lambda m: _c(m).fill_null(3), "exact"),
    "rolling_cov": (lambda m: m.rolling_cov("x", "y", window_size=W),
                    "moment"),
    "rolling_corr": (lambda m: m.rolling_corr("x", "y", window_size=W),
                     "moment"),
}


@functools.lru_cache(maxsize=None)
def _results(dt: str, filtered: bool):
    """Every op of OPS over one (dtype, filter) case, in one select per
    package: ({name: values} from the JAX package, the same from the
    port, the live rows' x values, their validity, the live y)."""
    cols, valid = _data(dt)
    r, t = frames(cols, valid)
    live = cols["f"] if filtered else np.ones(N, dtype=bool)
    if filtered:
        r, t = r.filter(ref.col("f")), t.filter(pt.col("f"))
    names = list(OPS)
    want = r.select([OPS[n][0](ref).alias(n) for n in names]).to_dict()
    got = t.select([OPS[n][0](pt).alias(n) for n in names]).to_dict()
    return want, got, cols["x"][live], valid["x"][live]


def _f(vals):
    return np.array([np.nan if v is None else float(v) for v in vals])


def _window_sums(x, xv, w, power=1):
    """Each row's Σ|x|^power over its trailing window of w rows."""
    a = np.where(xv & ~np.isnan(x.astype(np.float64)),
                 np.abs(x.astype(np.float64)) ** power, 0.0)
    return np.convolve(a, np.ones(w))[:len(a)]


def _bound(kind, name, dt, x, xv):
    """The absolute bound of each row of one op's result (see the
    module docstring), or None for bit for bit."""
    u = 2.0 ** -24 if dt == "Float32" else 2.0 ** -53
    ax = np.abs(np.where(xv, x.astype(np.float64), 0.0))
    big = np.nanmax(ax) if ax.size else 0.0
    n = len(x)
    if kind == "exact":
        return None
    if kind == "cum":
        return np.full(n, 4 * n * u * np.nansum(ax))
    if kind == "window":
        return 4 * W * u * _window_sums(x, xv, W) + 1e-300
    if kind in ("var", "std"):
        return 8 * (W + 1) * u * _window_sums(x, xv, W + 1, 2) + 1e-300
    if kind == "ewm_var":
        return np.full(n, 8 * n * u * big * big)
    if kind == "scale":
        return np.full(n, 64 * u * big)
    return None  # moment: relative, below


def _check(name, want, got, dt, x, xv):
    kind = OPS[name][1]
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
    if kind == "moment":
        bad = np.abs(g - w) > 2.0 ** -30 * (1 + np.abs(w))
    else:
        bound = _bound(kind, name, dt, x, xv)[~wn][~nan]
        if kind == "std":
            g, w = g * g, w * w
            bound = bound + 4 * np.abs(w) * 2.0 ** -23
        bad = np.abs(g - w) > bound
    assert not bad.any(), f"{name}: outside its bound at " \
        f"{np.flatnonzero(bad)[:5].tolist()}"


@pytest.mark.parametrize("name,dt,filtered", [
    (n, dt, f) for dt, f in CASES for n in OPS])
def test_window_op_matches_jax(name, dt, filtered):
    want, got, x, xv = _results(dt, filtered)
    _check(name, want[name], got[name], dt, x, xv)


# --- rank: every method against numpy, and against the JAX package ----------

METHODS = ["average", "min", "max", "dense", "ordinal"]


def _rank_oracle(x, xv, method, desc):
    """Ranks of the valid values by an independent rule: ascending by
    value with NaN after every number (descending: before), -0.0 equal
    to 0.0, ordinal ties by row; ties for the other methods are equal
    values (NaN equals nothing)."""
    x = x.astype(np.float64)
    rows = np.flatnonzero(xv)
    nan = np.isnan(x)
    val = np.where(nan, 0.0, x)
    if desc:
        keys = (rows, -val[rows], ~nan[rows])
    else:
        keys = (rows, val[rows], nan[rows])
    order = rows[np.lexsort(keys)]
    vals = x[order]
    out = [None] * len(x)
    n = len(order)
    same = np.r_[False, vals[1:] == vals[:-1]]
    start = np.zeros(n, dtype=np.int64)
    for i in range(1, n):
        start[i] = start[i - 1] if same[i] else i
    end = np.zeros(n, dtype=np.int64)
    end[-1:] = n - 1
    for i in range(n - 2, -1, -1):
        end[i] = end[i + 1] if same[i + 1] else i
    dense = np.cumsum(~same)
    for i, r in enumerate(order):
        out[r] = {"ordinal": i + 1, "min": start[i] + 1, "max": end[i] + 1,
                  "dense": int(dense[i]),
                  "average": (start[i] + end[i]) / 2 + 1}[method]
    return out


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_rank_matches_numpy(dt, method, desc):
    cols, valid = _data(dt)
    _, t = frames(cols, valid)
    live = cols["f"]
    got = t.filter(pt.col("f")).select(
        pt.col("x").rank(method, descending=desc).alias("r")) \
        .to_dict()["r"]
    want = _rank_oracle(cols["x"][live], valid["x"][live], method, desc)
    assert got == [None if w is None else (float(w) if method == "average"
                                           else int(w)) for w in want]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_rank_matches_jax(dt, method):
    """Against the JAX package where its rank is right: no NaN in the
    values (they become nulls here) and no descending UInt32."""
    cols, valid = _data(dt)
    x = cols["x"]
    xv = valid["x"]
    if dt.startswith("Float"):
        xv = xv & ~np.isnan(x)
    r, t = frames({"x": x, "f": cols["f"]}, {"x": xv})
    for desc in ((False,) if dt == "UInt32" else (False, True)):
        want = r.filter(ref.col("f")).select(
            ref.col("x").rank(method, descending=desc).alias("r")) \
            .to_dict()["r"]
        got = t.filter(pt.col("f")).select(
            pt.col("x").rank(method, descending=desc).alias("r")) \
            .to_dict()["r"]
        assert got == want, (dt, method, desc)


def test_series_and_frame_window_methods():
    """The Series and DataFrame methods route to the same expressions."""
    s = pt.Series("a", [3.0, None, 1.0, 3.0, 2.0], device="cpu")
    assert s.shift(1).to_list() == [None, 3.0, None, 1.0, 3.0]
    assert s.cum_sum().to_list() == [3.0, None, 4.0, 7.0, 9.0]
    assert s.rank("min").to_list() == [3, None, 1, 3, 2]
    assert s.forward_fill().to_list() == [3.0, 3.0, 1.0, 3.0, 2.0]
    assert s.rolling_max(2).to_list() == [None, None, None, 3.0, 3.0]
    df = pt.DataFrame({"a": [1, None, 3], "b": [1.0, None, 4.0]},
                      device="cpu")
    assert df.shift(1).to_dict() == {"a": [None, 1, None],
                                     "b": [None, 1.0, None]}
    assert df.interpolate().to_dict()["b"] == [1.0, 2.5, 4.0]
    assert df.fill_null(strategy="forward").to_dict() == \
        {"a": [1, 1, 3], "b": [1.0, 1.0, 4.0]}
    lazy = df.lazy().fill_null(0).shift(-1).collect().to_dict()
    assert lazy == {"a": [0, 3, None], "b": [0.0, 4.0, None]}
