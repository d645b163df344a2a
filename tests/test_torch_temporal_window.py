"""Temporal windows through the JAX package and the port.

`group_by_dynamic` (every `closed`, overlapping periods, month windows, a
Date and an integer index, offsets), `rolling` (eager and lazy, grouped
and not), `upsample`, every `rolling_*_by` over the whole column and
`.over()` a partition (forced ties of the `by` column, nulls, every
`closed`, a calendar period), `ewm_mean_by`, `interpolate_by`, the five
`timeseries` functions and `when/then` run over the same seeded numpy
columns through `polaroid_tpu` (its CPU path) and `polaroid_tpu_torch`
with device="cpu", and `chip_smoke.py`'s phase-12 queries at 2^14 rows
against its numpy oracles.

Tolerances, with u = 2^-53 and n the column's rows:
* bit for bit: keys, counts, lengths, integer sums, min, max, first,
  last, ranks, quantiles (selected elements; linear ones interpolate two
  selected elements the same way), every null;
* float sums and means: within 4·n·u·Σ|x| of the column (the JAX
  package's prefix-sum bound; the port sums each window by itself, held
  to numpy within 2·⌈log2 w⌉·u·Σ|x| of its w rows in
  `tests/test_torch_range_agg.py`), plus one ulp of a Float32 result;
  variances within 8·n·u·Σx² of the column (std on the squares);
* ewm_mean_by and interpolate_by: within 64·u of the column's largest
  |x| (the ewm recurrence reassociated); a Float32 ewm within
  8·log2(n)·2^-24 of it (the JAX package runs it in f32, the port in
  f64).

Where the port departs from the JAX package the result is held to numpy:
a Datetime index moved by an offset (the JAX package's temporal
arithmetic refuses its Int64 offset), `pl.len()` in a rolling
aggregation (the JAX package takes only column aggregates there), and
`rolling(closed="both"/"none")` (the JAX package searches the lower
bound on the other side). Every part of the API this slice leaves out
raises NotImplementedError naming its slice (or, once that slice has
landed, runs as in the JAX package).
"""

import datetime as pydt
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu.timeseries as RTS
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
SEC = 1_000_000
T0 = 1_709_563_800 * SEC            # 2024-03-04T14:50Z


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    # whole seconds over 25 minutes: many ties
    ts = T0 + np.sort(rng.integers(0, 1500, N)) * SEC
    price = rng.uniform(1, 200, N)
    x32 = rng.normal(0, 10, N).astype(np.float32)
    return {
        "ts": ts.astype("datetime64[us]"),
        "d": (np.sort(rng.integers(19000, 19200, N))).astype(
            "datetime64[D]"),
        "i": np.sort(rng.integers(0, 300, N)),
        "symbol": rng.integers(0, 4, N).astype(np.uint32),
        "price": price,
        "x32": x32,
        "volume": rng.integers(0, 5000, N).astype(np.int32),
    }, {"price": rng.uniform(size=N) > 0.1}


def frames(cols, valid):
    tdf = frame_from_numpy(cols, validity=valid, device="cpu")
    rdf = ref.DataFrame(dict(cols))
    for k, m in valid.items():
        c = rdf._table.cols[k]
        vm = np.zeros(c.data.shape[0], dtype=bool)
        vm[:len(m)] = m
        c.validity = jnp.asarray(vm)
    return rdf, tdf


def _storage(df):
    t = df._table
    mask = _np(t.row_mask()).astype(bool)
    out = {}
    for k in t.names:
        c = t.cols[k]
        if c.dtype.is_string:
            out[k] = (repr(c.dtype), np.asarray(df.get_column(k).to_list(),
                                                dtype=object), None)
            continue
        out[k] = (repr(c.dtype), _np(c.data)[mask],
                  None if c.validity is None else _np(c.validity)[mask])
    return out


def _bounds(x, valid=None):
    x = np.asarray(x, dtype=np.float64)
    if valid is not None:
        x = x[valid]
    x = x[np.isfinite(x)]
    n = max(len(x), 1)
    return 4 * n * 2.0 ** -53 * np.abs(x).sum(), \
        8 * n * 2.0 ** -53 * (x * x).sum(), np.abs(x).max(initial=0)


def same(r, t, tol=None, squares=()):
    """The two frames' columns on their storage: dtype, nulls and values;
    `tol` gives an absolute bound per float column (none: bit for bit),
    `squares` the std columns compared on their squares."""
    tol = tol or {}
    rs, ts = _storage(r), _storage(t)
    assert list(rs) == list(ts)
    for k in rs:
        rd, rv, rval = rs[k]
        td, tv, tval = ts[k]
        assert rd == td, (k, rd, td)
        rm = np.ones(len(rv), bool) if rval is None else rval
        tm = np.ones(len(tv), bool) if tval is None else tval
        assert len(rv) == len(tv), (k, len(rv), len(tv))
        assert np.array_equal(rm, tm), k
        a, b = rv[rm], tv[tm]
        if k in tol:
            a64, b64 = a.astype(np.float64), b.astype(np.float64)
            if k in squares:
                a64, b64 = a64 * a64, b64 * b64
            bound = tol[k] + (np.spacing(np.abs(a).astype(np.float32))
                              * (2 * np.abs(a64) + 1) if a.dtype ==
                              np.float32 else 0)
            both_nan = np.isnan(a64) & np.isnan(b64)
            assert np.all((np.abs(a64 - b64) <= bound) | both_nan), \
                (k, np.abs(a64 - b64).max())
        elif a.dtype.kind == "f":
            assert np.array_equal(a, b, equal_nan=True), k
        elif a.dtype.kind == "O":
            assert list(a) == list(b), k
        else:
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), k


# ---------------------------------------------------------------------------
# group_by_dynamic
# ---------------------------------------------------------------------------

def _aggs(m):
    return [m.col("price").sum().alias("s"), m.col("price").max()
            .alias("mx"), m.col("volume").sum().alias("v"),
            m.col("x32").first().alias("f"), m.col("price").count()
            .alias("c")]


DYNAMIC = [
    ("ts", "2m", None, "left"), ("ts", "2m", "5m", "left"),
    ("ts", "1m", "3m", "right"), ("ts", "3m", "3m", "both"),
    ("ts", "2m", "3m", "none"), ("d", "1w", None, "left"),
    ("d", "1mo", "2mo", "left"), ("d", "5d", "12d", "right"),
    ("i", "7i", None, "left"), ("i", "5i", "12i", "both"),
]


@pytest.mark.parametrize("index,every,period,closed", DYNAMIC)
@pytest.mark.parametrize("lazy", [False, True])
def test_group_by_dynamic_matches_jax(data, index, every, period, closed,
                                      lazy):
    cols, valid = data
    r, t = frames(cols, valid)
    if lazy:
        r, t = r.lazy(), t.lazy()

    def q(df, m):
        out = df.group_by_dynamic(index, every=every, period=period,
                                  closed=closed, group_by="symbol") \
            .agg(*_aggs(m))
        return out.collect() if lazy else out
    sb, _, _ = _bounds(cols["price"], valid["price"])
    same(q(r, ref), q(t, pt), tol={"s": sb})


@pytest.mark.parametrize("every,offset", [("2m", "30s"), ("1d", "3d")])
def test_group_by_dynamic_offset_against_numpy(data, every, offset):
    """The window starts moved by `offset`: trunc(t - offset) + offset."""
    cols, valid = data
    _, t = frames(cols, valid)
    index = "ts" if every == "2m" else "d"
    out = t.group_by_dynamic(index, every=every, offset=offset).agg(
        pt.col("volume").sum().alias("v"), pt.len().alias("n"))
    st = _storage(out)
    x = cols[index].astype(np.int64)
    step, off = (120 * SEC, 30 * SEC) if index == "ts" else (1, 3)
    start = (x - off) // step * step + off
    keys, inv = np.unique(start, return_inverse=True)
    assert np.array_equal(st[index][1], keys)
    assert np.array_equal(st["n"][1], np.bincount(inv))
    assert np.array_equal(st["v"][1], np.bincount(
        inv, cols["volume"].astype(np.float64)).astype(np.int64))


# ---------------------------------------------------------------------------
# rolling and upsample
# ---------------------------------------------------------------------------

def _roll_aggs(m):
    return [m.col("volume").sum().alias("v"), m.col("price").mean()
            .alias("m"), m.col("price").max().alias("mx"),
            m.col("price").min().alias("mn"), m.col("price").std()
            .alias("sd"), m.col("x32").var().alias("var"),
            m.col("price").first().alias("f"), m.col("price").last()
            .alias("l"), m.col("price").count().alias("c"),
            m.col("x32").len().alias("n")]


@pytest.mark.parametrize("closed", ["right", "left"])
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
def test_rolling_matches_jax(data, closed, grouped, lazy):
    cols, valid = data
    r, t = frames(cols, valid)
    if lazy:
        r, t = r.lazy(), t.lazy()
    gb = "symbol" if grouped else None

    def q(df, m):
        out = df.rolling("ts", period="2m", group_by=gb, closed=closed) \
            .agg(*_roll_aggs(m))
        return out.collect() if lazy else out
    sb, vb, _ = _bounds(cols["price"], valid["price"])
    _, vb32, _ = _bounds(cols["x32"])
    same(q(r, ref), q(t, pt), tol={"m": sb, "sd": vb, "var": vb32},
         squares=("sd",))


@pytest.mark.parametrize("closed", ["both", "none"])
def test_rolling_closed_edges_against_numpy(data, closed):
    """Windows [t - period, t] ("both") and (t - period, t] cut at the row
    ("none": the row itself and its earlier ties stay in, as every
    rolling window holds its own row), with pl.len()."""
    cols, valid = data
    _, t = frames(cols, valid)
    out = t.rolling("ts", period="2m", group_by="symbol", closed=closed) \
        .agg(pt.col("volume").sum().alias("v"), pt.len().alias("n"))
    st = _storage(out)
    ts, sym, vol = cols["ts"].astype(np.int64), cols["symbol"], \
        cols["volume"]
    for i in range(N):
        same_sym = sym == sym[i]
        lo_ok = ts >= ts[i] - 120 * SEC if closed == "both" else \
            ts > ts[i] - 120 * SEC
        hi_ok = ts <= ts[i] if closed == "both" else \
            (ts < ts[i]) | (np.arange(N) <= i) & (ts == ts[i])
        win = same_sym & lo_ok & hi_ok
        assert st["n"][1][i] == win.sum(), i
        assert st["v"][1][i] == vol[win].astype(np.int64).sum(), i


def test_upsample_matches_jax():
    ts = np.array(["2024-01-01T00:00", "2024-01-01T00:10",
                   "2024-01-01T01:00"], dtype="datetime64[us]")
    cols = {"ts": ts, "v": np.array([1, 2, 3])}
    r, t = frames(cols, {})
    same(r.upsample("ts", every="15m"), t.upsample("ts", every="15m"))


def _month_grid(start: pydt.datetime, end: pydt.datetime, months: int):
    """start moved by k * months whole months (a day past the month's end
    is its last day), for every k that stays at or before end."""
    import calendar
    out, k = [], 0
    while True:
        total = start.year * 12 + start.month - 1 + k * months
        y, m = divmod(total, 12)
        d = min(start.day, calendar.monthrange(y, m + 1)[1])
        t = start.replace(year=y, month=m + 1, day=d)
        if t > end:
            return out
        out.append(t)
        k += 1


@pytest.mark.parametrize("every,months", [("1mo", 1), ("1q", 3),
                                          ("1y", 12)])
@pytest.mark.parametrize("kind", ["datetime", "date"])
def test_upsample_calendar_every_steps_whole_months(every, months, kind):
    """A calendar `every` steps the first time by whole months, each point
    from the first (day 31 or the month's last day), held to the
    calendar: the JAX package steps a Datetime by 1 µs and a Date by one
    day here (ROADMAP Queue 3)."""
    start = pydt.datetime(2024, 1, 31, 9, 30)
    end = pydt.datetime(2024, 12, 31, 9, 30) if months == 1 else \
        pydt.datetime(2027, 2, 28, 9, 30)
    if kind == "date":
        start, end = start.replace(hour=0, minute=0), \
            end.replace(hour=0, minute=0)
    grid = _month_grid(start, end, months)
    unit = "D" if kind == "date" else "us"
    mid = grid[1] if len(grid) > 2 else grid[-1]
    ts = np.array([start, mid, end], dtype=f"datetime64[{unit}]")
    df = pt.DataFrame({"t": ts, "v": np.array([1, 2, 3])}, device="cpu")
    out = df.upsample("t", every=every).to_dict()
    want = np.array(grid, dtype=f"datetime64[{unit}]")
    got = np.array(out["t"], dtype=f"datetime64[{unit}]")
    assert np.array_equal(got, want)
    if kind == "datetime" and months == 1:
        assert len(got) == 12 and all(
            g.day in (31, 29, 30) for g in grid)
    v = {t: i + 1 for i, t in enumerate(ts.tolist())}
    assert out["v"] == [v.get(t) for t in want.tolist()]


def test_upsample_calendar_every_on_a_date_quarter_of_months():
    """A Date column over 2024-01-31..04-30 by "1mo": four rows, not the
    91 daily rows a fixed step gave."""
    ts = np.array(["2024-01-31", "2024-04-30"], dtype="datetime64[D]")
    df = pt.DataFrame({"t": ts, "v": np.array([1, 2])}, device="cpu")
    out = df.upsample("t", every="1mo").to_dict()
    assert [str(x) for x in out["t"]] == ["2024-01-31", "2024-02-29",
                                          "2024-03-31", "2024-04-30"]
    assert out["v"] == [1, None, None, 2]


# ---------------------------------------------------------------------------
# range windows by a companion column
# ---------------------------------------------------------------------------

BY_OPS = {
    "sum": lambda c, b, p, kw: c.rolling_sum_by(b, p, **kw),
    "mean": lambda c, b, p, kw: c.rolling_mean_by(b, p, **kw),
    "min": lambda c, b, p, kw: c.rolling_min_by(b, p, **kw),
    "max": lambda c, b, p, kw: c.rolling_max_by(b, p, **kw),
    "std": lambda c, b, p, kw: c.rolling_std_by(b, p, **kw),
    "var": lambda c, b, p, kw: c.rolling_var_by(b, p, **kw),
    "median": lambda c, b, p, kw: c.rolling_median_by(b, p, **kw),
    "quantile_lower": lambda c, b, p, kw: c.rolling_quantile_by(
        b, p, 0.3, "lower", **kw),
    "quantile_linear": lambda c, b, p, kw: c.rolling_quantile_by(
        b, p, 0.7, "linear", **kw),
    "rank": lambda c, b, p, kw: c.rolling_rank_by(b, p, **kw),
    "rank_min": lambda c, b, p, kw: c.rolling_rank_by(b, p, "min", **kw),
}
BY_CASES = [("price", "ts", "3m", "right"), ("price", "ts", "90s", "both"),
            ("x32", "ts", "2m", "left"), ("volume", "ts", "4m", "none"),
            ("price", "d", "1mo", "right"), ("x32", "i", "10i", "right")]


@pytest.mark.parametrize("col,by,period,closed", BY_CASES)
@pytest.mark.parametrize("over", [False, True])
def test_rolling_by_matches_jax(data, col, by, period, closed, over):
    cols, valid = data
    r, t = frames(cols, valid)
    period = int(period[:-1]) if period.endswith("i") else period

    def q(m):
        out = []
        for name, fn in BY_OPS.items():
            e = fn(m.col(col), by, period, {"closed": closed,
                                            "min_samples": 2})
            out.append((e.over("symbol") if over else e).alias(name))
        return out
    sb, vb, _ = _bounds(cols[col], valid.get(col))
    tol = {"mean": sb, "std": vb, "var": vb}
    if col != "volume":             # integer sums are exact
        tol["sum"] = sb
    same(r.select(*q(ref)), t.select(*q(pt)), tol=tol, squares=("std",))


@pytest.mark.parametrize("col", ["price", "x32"])
def test_ewm_mean_by_and_interpolate_by_match_jax(data, col):
    cols, valid = data
    r, t = frames(cols, valid)

    def q(m):
        return [m.col(col).ewm_mean_by("ts", half_life="45s").alias("e"),
                m.col(col).ewm_mean_by("i", half_life=7.5).alias("ei"),
                m.col(col).interpolate_by("i").alias("ip")]
    _, _, mx = _bounds(cols[col], valid.get(col))
    # the JAX package runs a Float32 recurrence in f32 (the port in f64)
    b = 64 * 2.0 ** -53 * mx if col == "price" else \
        8 * np.log2(N) * 2.0 ** -24 * mx
    same(r.select(*q(ref)), t.select(*q(pt)),
         tol={"e": b, "ei": b, "ip": b})


# ---------------------------------------------------------------------------
# timeseries and when/then
# ---------------------------------------------------------------------------

def _ts_queries(m, TS, lf):
    return {
        "vwap": TS.vwap(lf, by="symbol", time_column="ts"),
        "vwap_every": TS.vwap(lf, by="symbol", every="2m", time_column="ts"),
        "twap": TS.twap(lf, time_column="ts", by="symbol"),
        "twap_every": TS.twap(lf, time_column="ts", every="5m"),
        "ohlcv": TS.resample_ohlcv(lf, every="1m", time_column="ts",
                                   by="symbol"),
        "session": lf.select("ts", TS.session_id("ts")),
        "filter": TS.filter_trading_hours(lf, "us", "ts"),
        "filter_europe": TS.filter_trading_hours(lf, "europe", "ts"),
    }


@pytest.mark.parametrize("name", ["vwap", "vwap_every", "twap", "twap_every",
                                  "ohlcv", "session", "filter",
                                  "filter_europe"])
def test_timeseries_match_jax(data, name):
    cols, valid = data
    r, t = frames(cols, {})
    rq = _ts_queries(ref, RTS, r.lazy())[name].collect()
    tq = _ts_queries(pt, pt.timeseries, t.lazy())[name].collect()
    if name.startswith("twap"):
        key = "symbol" if name == "twap" else "ts"
        rq, tq = rq.sort(key), tq.sort(key)
    prices = cols["price"]
    rel = 1e-12 * np.abs(prices).max()
    same(rq, tq, tol={"vwap": rel, "twap": rel, "price": 0})


WHEN = {
    "numeric": lambda m: m.when(m.col("price") > 100).then(m.col("volume"))
    .when(m.col("price") > 50).then(m.col("x32")).otherwise(m.lit(-1)),
    "string": lambda m: m.when(m.col("volume") > 2500).then(m.lit("hi"))
    .otherwise(m.lit("lo")),
    "null_branch": lambda m: m.when(m.col("price") < 20).then(m.lit(None))
    .otherwise(m.col("price")),
    "no_otherwise": lambda m: m.when(m.col("symbol") == 2)
    .then(m.col("volume")).otherwise(None),
    "temporal": lambda m: m.when(m.col("volume") > 100).then(m.col("ts"))
    .otherwise(m.lit(pydt.datetime(2000, 1, 1))),
}


@pytest.mark.parametrize("name", sorted(WHEN))
def test_when_then_matches_jax(data, name):
    cols, valid = data
    r, t = frames(cols, valid)
    same(r.select(WHEN[name](ref).alias("x")),
         t.select(WHEN[name](pt).alias("x")))


def test_left_out_parts_raise_naming_their_slice(data):
    cols, valid = data
    _, t = frames(cols, valid)
    c = pt.col
    # Slice D3 has landed: the as-of and inequality joins run (held to
    # the JAX package in tests/test_torch_asof.py and
    # tests/test_torch_iejoin.py)
    n = t.height
    for call in (lambda: t.join_asof(t, on="ts"),
                 lambda: t.lazy().join_asof(t.lazy(), on="ts").collect()):
        assert call().height == n
    for call in (lambda: t.join_where(t, c("i") < c("i")),
                 lambda: t.lazy().join_where(t.lazy(), c("i") < c("i"))
                 .collect()):
        assert call().height == 0
    # Slice E2 has landed: a cast to String and the str namespace run
    # (held to the JAX package in tests/test_torch_strings.py); str ops
    # on a number are refused as they are there
    assert t.select(c("ts").cast(pt.String)).height == n
    with pytest.raises(pt.InvalidOperationError):
        t.select(c("price").str.to_datetime())
    # Slice E3 has landed: these run as in the JAX package (held to it in
    # tests/test_torch_surface_exprs.py): rolling_map evaluates; a
    # row-level when/then in a group-by (a list per group against an
    # integer) and a cumulative_eval that names a column rather than
    # pl.element() are refused as they are there
    assert t.select(c("price").rolling_map(sum, 3)).height == n
    with pytest.raises(pt.SchemaError):
        t.group_by("symbol").agg(
            pt.when(c("price") > 1).then(1).otherwise(0).alias("x"))
    with pytest.raises(pt.ColumnNotFoundError):
        t.select(c("price").cumulative_eval(c("price").sum()))


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 12 at a small size
# ---------------------------------------------------------------------------

def test_phase12_queries_against_their_oracles():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as CS
    d = CS.make_trades_data(1 << 14, 0)
    for name, lf, _, _ in CS.time_queries(pt, CS.trades_frame(pt, d, "cpu")):
        CS.check_time(name, CS.decoded_columns(lf.collect()), d)
