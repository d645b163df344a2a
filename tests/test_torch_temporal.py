"""Temporal values through the JAX package and the port.

The civil calendar (`ops/temporal.py`) over every day of 1900–2100 and
epochs of every unit on both sides of 1970, time zones (`ops/tzdata.py`:
America/New_York at both of its 2024 DST edges, Europe/London, a fixed
offset), and in the expression evaluator: temporal casts, literals
(datetime, date, timedelta, np.datetime64), arithmetic and compares,
every `dt` op (`expr/dt.py`), `pl.datetime` from expressions, and the
temporal `diff`/`shift`. The same seeded numpy columns go through
`polaroid_tpu` (its CPU path) and `polaroid_tpu_torch` with
device="cpu"; every result is compared on its storage, bit for bit (all
of it is integer arithmetic), with its dtype and nulls.

Held against numpy instead of the JAX package: the week truncation of a
Datetime, which the port starts on Monday (as the JAX package's Date
truncation does) and the JAX package on Thursday (epoch-aligned weeks),
and the frame round trip of Date, Datetime(unit, tz) and Duration
columns.
"""

import datetime as pydt

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
from polaroid_tpu.ops import temporal as TJ
from polaroid_tpu.ops import tzdata as ZJ
from polaroid_tpu_torch.ops import temporal as T
from polaroid_tpu_torch.ops import tzdata as Z
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


N = 512
D1900 = -25567                  # 1900-01-01
D2100 = 47482                   # 2100-12-31
DAY_US = 86_400_000_000
EDGES_US = [1710054000_000_000, 1730613600_000_000]   # 2024 US DST edges


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the civil calendar
# ---------------------------------------------------------------------------

def test_civil_calendar_1900_2100_matches_jax_and_python():
    days = np.arange(D1900, D2100 + 1, dtype=np.int32)
    y, m, d = (_np(a) for a in T.days_to_civil(torch.from_numpy(days)))
    yj, mj, dj = (np.asarray(a) for a in TJ.days_to_civil(jnp.asarray(days)))
    assert np.array_equal(y, yj) and np.array_equal(m, mj) and \
        np.array_equal(d, dj)
    back = _np(T.civil_to_days(*(torch.from_numpy(a) for a in (y, m, d))))
    assert np.array_equal(back, days)
    for name in ("weekday", "ordinal_day", "iso_week"):
        got = _np(getattr(T, name)(torch.from_numpy(days)))
        want = np.asarray(getattr(TJ, name)(jnp.asarray(days)))
        assert np.array_equal(got, want), name
    # against Python's own calendar, every 97th day
    for i in range(0, len(days), 97):
        dd = pydt.date(1970, 1, 1) + pydt.timedelta(days=int(days[i]))
        iso = dd.isocalendar()
        assert (y[i], m[i], d[i]) == (dd.year, dd.month, dd.day)
        assert _np(T.weekday(torch.tensor([days[i]])))[0] == iso[2]
        assert _np(T.iso_week(torch.tensor([days[i]])))[0] == iso[1]


@pytest.mark.parametrize("unit", ["ms", "us", "ns"])
def test_epoch_split_floors_before_1970(unit):
    rng = np.random.default_rng(1)
    per_day = T.per_day(unit)
    span = 90 * 365 * per_day if unit != "ns" else 200 * per_day
    x = np.r_[rng.integers(-span, span, N), [-1, 0, 1, -per_day,
                                            -per_day - 1, per_day - 1]]
    xt = torch.from_numpy(x)
    assert np.array_equal(_np(T.epoch_to_days(xt, unit)),
                          np.asarray(TJ.epoch_to_days(jnp.asarray(x), unit)))
    tod = _np(T.time_of_day(xt, unit))
    assert np.array_equal(tod, np.asarray(TJ.time_of_day(jnp.asarray(x),
                                                         unit)))
    assert (tod >= 0).all() and (tod < per_day).all()


EVERIES = ["1ms", "15s", "1m", "90m", "1h", "1d", "3d", "1mo", "3mo", "1q",
           "1y"]


@pytest.mark.parametrize("every", EVERIES)
def test_truncate_matches_jax(every):
    rng = np.random.default_rng(2)
    x = rng.integers(-70 * 365 * DAY_US, 130 * 365 * DAY_US, N)
    got = _np(T.truncate_epoch(torch.from_numpy(x), "us", every))
    want = np.asarray(TJ.truncate_epoch(jnp.asarray(x), "us", every))
    assert np.array_equal(got, want)
    days = rng.integers(D1900, D2100, N).astype(np.int32)
    got = _np(T.truncate_days(torch.from_numpy(days), every))
    want = np.asarray(TJ.truncate_days(jnp.asarray(days), every))
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64))


@pytest.mark.parametrize("every", ["1w", "2w"])
def test_week_truncation_starts_on_monday(every):
    """Kept difference: a Datetime's week starts on Monday, as a Date's
    (the JAX package truncates a Datetime to Thursdays)."""
    rng = np.random.default_rng(3)
    x = np.r_[rng.integers(-70 * 365 * DAY_US, 130 * 365 * DAY_US, N),
              [1710147600_000_000]]               # 2024-03-11T09:00, Monday
    got = _np(T.truncate_epoch(torch.from_numpy(x), "us", every))
    step = int(every[0]) * 7 * DAY_US
    monday = -3 * DAY_US                           # 1969-12-29
    want = (x - monday) // step * step + monday
    assert np.array_equal(got, want)
    assert got[-1] == 1710115200_000_000           # 2024-03-11T00:00
    assert np.asarray(TJ.truncate_epoch(jnp.asarray(x[-1:]), "us", "1w"))[0] \
        == 1709769600_000_000                      # 2024-03-07, Thursday
    days = (x // DAY_US).astype(np.int32)
    assert np.array_equal(_np(T.truncate_days(torch.from_numpy(days), every)),
                          (got // DAY_US).astype(np.int32))


@pytest.mark.parametrize("every", ["3mo", "1y", "2d"])
def test_parse_every(every):
    assert T.parse_every(every) == TJ.parse_every(every)


# ---------------------------------------------------------------------------
# time zones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tz", ["America/New_York", "Europe/London", "UTC",
                                "+05:30", "-04:00"])
def test_offset_table_and_lookups_match_jax(tz):
    for a, b in zip(Z.offset_table(tz), ZJ.offset_table(tz)):
        assert np.array_equal(a, b)
    rng = np.random.default_rng(4)
    x = np.r_[rng.integers(-60 * 365 * DAY_US, 100 * 365 * DAY_US, N),
              [e + k for e in EDGES_US for k in (-3_600_000_000, -1, 0, 1,
                                                 3_600_000_000)]]
    xt = torch.from_numpy(x)
    for kw in ({}, {"dst_only": True}, {"base_only": True}):
        got = _np(Z.utc_offset(xt, "us", tz, **kw))
        want = np.asarray(ZJ.utc_offset(jnp.asarray(x), "us", tz, **kw))
        assert np.array_equal(got, want), kw
    assert np.array_equal(_np(Z.localize(xt, "us", tz)),
                          np.asarray(ZJ.localize(jnp.asarray(x), "us", tz)))
    assert np.array_equal(_np(Z.delocalize(xt, "us", tz)),
                          np.asarray(ZJ.delocalize(jnp.asarray(x), "us",
                                                   tz)))


# ---------------------------------------------------------------------------
# the evaluator: frames through both packages
# ---------------------------------------------------------------------------

def _storage(df):
    """{column: (dtype repr, live values, validity)} read off the frame's
    table: the storage, so a temporal value is compared as its count."""
    t = df._table
    mask = _np(t.row_mask()).astype(bool)
    out = {}
    for k in t.names:
        c = t.cols[k]
        if c.dtype.is_string:
            vals = np.asarray(df.get_column(k).to_list(), dtype=object)
            valid = None
        else:
            vals = _np(c.data)[mask]
            valid = None if c.validity is None else _np(c.validity)[mask]
        out[k] = (repr(c.dtype), vals, valid)
    return out


def _same(r, t):
    rs, ts = _storage(r), _storage(t)
    assert list(rs) == list(ts)
    for k in rs:
        rd, rv, rval = rs[k]
        td, tv, tval = ts[k]
        assert rd == td, (k, rd, td)
        rmask = np.ones(len(rv), bool) if rval is None else rval
        tmask = np.ones(len(tv), bool) if tval is None else tval
        assert np.array_equal(rmask, tmask), k
        a, b = rv[rmask], tv[tmask]
        if a.dtype.kind == "f":
            assert np.array_equal(a, b, equal_nan=True), k
        elif a.dtype.kind == "O":
            assert list(a) == list(b), k
        else:
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), k


def _data(seed=5):
    rng = np.random.default_rng(seed)
    us = rng.integers(-70 * 365 * DAY_US, 130 * 365 * DAY_US, N)
    us[:4] = [-1, 0, 1, EDGES_US[0]]
    cols = {
        "t": us.astype("datetime64[us]"),
        "tms": (us // 1000).astype("datetime64[ms]"),
        "d": (us // DAY_US).astype("datetime64[D]"),
        "dur": rng.integers(-10 * DAY_US, 10 * DAY_US, N)
        .astype("timedelta64[us]"),
        "i": rng.integers(-5, 6, N),
        "f": rng.normal(0, 3, N),
    }
    valid = {"t": rng.uniform(size=N) > 0.1}
    return cols, valid


def frames(cols, valid=None):
    """The same numpy columns as a JAX-package frame and a port frame on
    the CPU; a nullable column gets the same validity mask on both (set
    on the JAX package's column: its constructor would take nullable
    temporals as Python objects, through a float timestamp)."""
    valid = valid or {}
    tdf = frame_from_numpy(cols, validity=valid, device="cpu")
    rdf = ref.DataFrame(dict(cols))
    for k, m in valid.items():
        c = rdf._table.cols[k]
        vm = np.zeros(c.data.shape[0], dtype=bool)
        vm[:len(m)] = m
        c.validity = jnp.asarray(vm)
    return rdf, tdf


def _ref_dtype(dt):
    name = repr(dt).split("(")[0]
    if name == "Datetime":
        return ref.Datetime(dt.time_unit, dt.time_zone)
    return ref.Duration(dt.time_unit)


def both(pkg_exprs, cols=None, valid=None, how="select"):
    if cols is None:
        cols, valid = _data()
    r, t = frames(cols, valid)
    return (getattr(r, how)(*pkg_exprs(ref)),
            getattr(t, how)(*pkg_exprs(pt)))


CASTS = [("t", "Date"), ("t", "Datetime_ms"), ("t", "Datetime_ns"),
         ("tms", "Datetime_us"), ("d", "Datetime_us"), ("d", "Datetime_ms"),
         ("dur", "Duration_ms"), ("dur", "Duration_ns"), ("t", "Int64"),
         ("d", "Int32"), ("i", "Datetime_us"), ("i", "Date"),
         ("i", "Duration_us"), ("dur", "Int64"), ("t", "Float64")]


def _dtype(m, spec):
    name, _, unit = spec.partition("_")
    return getattr(m, name)(unit) if unit else getattr(m, name)


@pytest.mark.parametrize("src,dst", CASTS)
def test_casts_match_jax(src, dst):
    _same(*both(lambda m: [m.col(src).cast(_dtype(m, dst)).alias("x")]))


LITERALS = [pydt.datetime(2001, 2, 3, 4, 5, 6, 789000), pydt.date(1955, 7, 1),
            pydt.timedelta(days=3, seconds=7, microseconds=11)]


@pytest.mark.parametrize("value", LITERALS, ids=["datetime", "date",
                                                 "timedelta"])
def test_literals_and_compares_match_jax(value):
    col = {pydt.datetime: "t", pydt.date: "d", pydt.timedelta: "dur"}[
        type(value)]

    def q(m):
        c, v = m.col(col), m.lit(value)
        return [c.eq(v).alias("eq"), (c < v).alias("lt"),
                (c >= v).alias("ge"), v.alias("lit")]
    _same(*both(q))


def test_numpy_datetime64_literal():
    cols, valid = _data()
    _, t = frames(cols, valid)
    v = np.datetime64("2001-02-03T04:05:06.789", "us")
    out = t.select((pt.col("t") - pt.lit(v, dtype=pt.Datetime("us")))
                   .alias("x"))
    got = _storage(out)["x"]
    want = cols["t"].astype(np.int64) - v.astype(np.int64)
    assert got[0] == "Duration(us)"
    assert np.array_equal(got[1][valid["t"]], want[valid["t"]])


ARITH = {
    "dt_minus_dt": lambda c, m: c("t") - c("tms"),
    "date_minus_date": lambda c, m: c("d") - c("d").reverse(),
    "dt_plus_dur": lambda c, m: c("t") + c("dur"),
    "dt_minus_dur": lambda c, m: c("tms") - c("dur"),
    "dur_plus_dt": lambda c, m: c("dur") + c("t"),
    "date_plus_dur": lambda c, m: c("d") + c("dur"),
    "date_minus_dur": lambda c, m: c("d") - c("dur"),
    "dur_plus_dur": lambda c, m: c("dur") + c("dur").reverse(),
    "dur_minus_dur": lambda c, m: c("dur") - c("dur").reverse(),
    "dur_times": lambda c, m: c("dur") * c("f"),
    "dur_div": lambda c, m: c("dur") / 3,
    "dur_floordiv": lambda c, m: c("dur") // 7,
    "dur_div_dur": lambda c, m: c("dur") / c("dur").reverse(),
    "dt_lt_dt": lambda c, m: c("t") < c("tms"),
    "date_ge_dt": lambda c, m: c("d").cast(m.Datetime("us")) >= c("t"),
}


@pytest.mark.parametrize("name", sorted(ARITH))
def test_arithmetic_matches_jax(name):
    _same(*both(lambda m: [ARITH[name](m.col, m).alias("x")]))


DT_OPS = ["year", "quarter", "month", "day", "is_leap_year", "iso_year",
          "month_start", "month_end", "century", "millennium",
          "days_in_month", "ordinal_day", "weekday", "week", "hour",
          "minute", "second", "millisecond", "microsecond", "nanosecond",
          "date", "time", "is_business_day", "datetime"]


@pytest.mark.parametrize("col", ["t", "tms", "d"])
def test_every_dt_field_matches_jax(col):
    def q(m):
        return [getattr(m.col(col).dt, op)().alias(op) for op in DT_OPS
                if not (col == "d" and op in ("time", "datetime"))]
    _same(*both(q))


DT_CALLS = {
    "epoch_us": lambda c: c.dt.epoch("us"),
    "epoch_ms": lambda c: c.dt.epoch("ms"),
    "epoch_s": lambda c: c.dt.epoch("s"),
    "epoch_d": lambda c: c.dt.epoch("d"),
    "timestamp_ns": lambda c: c.dt.timestamp("ns"),
    "truncate_90m": lambda c: c.dt.truncate("90m"),
    "truncate_3mo": lambda c: c.dt.truncate("3mo"),
    "add_business_days_4": lambda c: c.dt.add_business_days(4),
    "add_business_days_-7": lambda c: c.dt.add_business_days(-7),
    "replace": lambda c: c.dt.replace(year=2000, day=9),
    "with_time_unit": lambda c: c.dt.with_time_unit("ms"),
    "cast_time_unit": lambda c: c.dt.cast_time_unit("ns"),
}


@pytest.mark.parametrize("name", sorted(DT_CALLS))
def test_dt_calls_match_jax(name):
    _same(*both(lambda m: [DT_CALLS[name](m.col("t")).alias("x"),
                           DT_CALLS[name](m.col("d")).alias("y")]
                if name.startswith(("epoch", "add_", "replace", "truncate"))
                else [DT_CALLS[name](m.col("t")).alias("x")]))


@pytest.mark.parametrize("op", ["total_days", "total_hours", "total_minutes",
                                "total_seconds", "total_milliseconds",
                                "total_microseconds", "total_nanoseconds"])
def test_duration_totals_match_jax(op):
    _same(*both(lambda m: [getattr(m.col("dur").dt, op)().alias("x"),
                           getattr((m.col("t") - m.col("tms")).dt, op)()
                           .alias("y")]))


def test_strftime_matches_jax():
    _same(*both(lambda m: [m.col("t").dt.strftime("%Y-%m-%d %H:%M")
                           .alias("x"),
                           m.col("d").dt.strftime("%d/%m/%Y").alias("y")]))


ZONES = ["America/New_York", "Europe/London", "+05:30"]


@pytest.mark.parametrize("tz", ZONES)
def test_time_zones_match_jax(tz):
    def q(m):
        u = m.col("t").dt.replace_time_zone("UTC")
        z = u.dt.convert_time_zone(tz)
        w = m.col("t").dt.replace_time_zone(tz)
        return [z.alias("z"), z.dt.hour().alias("h"), z.dt.day().alias("d"),
                z.dt.weekday().alias("wd"), z.dt.truncate("1d").alias("tr"),
                z.dt.month_start().alias("ms"),
                z.dt.base_utc_offset().alias("base"),
                z.dt.dst_offset().alias("dst"), w.alias("w"),
                w.dt.minute().alias("wm"),
                w.dt.replace_time_zone(None).alias("naive"),
                w.dt.convert_time_zone("UTC").dt.hour().alias("uh")]
    _same(*both(q))


def test_new_york_dst_edges():
    """The local hour at both 2024 DST edges of America/New_York: UTC - 5
    h before 2024-03-10T07:00Z and before 2024-11-03T06:00Z after the
    summer, UTC - 4 h between."""
    x = np.array([e + k for e in EDGES_US for k in
                  (-3_600_000_001, -1, 0, 1, 3_600_000_000)], np.int64)
    cols = {"t": x.astype("datetime64[us]")}
    r, t = frames(cols)

    def q(m):
        z = m.col("t").dt.replace_time_zone("UTC") \
            .dt.convert_time_zone("America/New_York")
        return [z.dt.hour().alias("h"), z.dt.dst_offset().alias("dst")]
    _same(r.select(*q(ref)), t.select(*q(pt)))
    got = _storage(t.select(*q(pt)))["h"][1]
    in_summer = (x >= EDGES_US[0]) & (x < EDGES_US[1])
    want = (x // 3_600_000_000 - np.where(in_summer, 4, 5)) % 24
    assert np.array_equal(got.astype(np.int64), want)


def test_datetime_components_match_jax():
    rng = np.random.default_rng(6)
    cols = {"y": rng.integers(1900, 2101, N), "mo": rng.integers(1, 13, N),
            "dd": rng.integers(1, 29, N)}

    def q(m):
        return [m.datetime("y", "mo", "dd", hour=7, minute=5, second=3,
                           microsecond=11).alias("x"),
                m.datetime(m.col("y"), 2, m.col("dd"), time_unit="ms")
                .alias("z")]
    _same(*both(q, cols, {}))


@pytest.mark.parametrize("op", ["shift", "diff"])
@pytest.mark.parametrize("col", ["t", "d", "dur"])
def test_temporal_shift_and_diff_match_jax(op, col):
    """shift and diff of temporal columns, plain and `.over()`. A diff
    over partitions is a Duration, as the plain diff (the JAX package's
    keeps the column's Date or Datetime dtype there), so it is held
    against numpy."""
    cols, valid = _data()
    g = np.arange(N) % 7
    cols["g"] = g

    def q(m):
        c = m.col(col)
        if op == "shift":
            return [c.shift(1).alias("x"), c.shift(2).over("g").alias("y")]
        return [c.diff().alias("x")]
    _same(*both(q, cols, valid))
    if op == "shift":
        return
    _, t = frames(cols, valid)
    got = _storage(t.select(pt.col(col).diff(2).over("g").alias("y")))["y"]
    x = cols[col].astype(np.int64)
    ok = valid.get(col, np.ones(N, bool))
    prev = np.r_[np.zeros(14, np.int64), x[:-14]]
    pok = np.r_[np.zeros(14, bool), ok[:-14]]
    want_valid = ok & pok
    scale = 86_400_000 if col == "d" else 1
    assert got[0] == ("Duration(ms)" if col == "d" else "Duration(us)")
    assert np.array_equal(got[2], want_valid)
    assert np.array_equal(got[1][want_valid],
                          ((x - prev) * scale)[want_valid])


def test_frame_round_trip_keeps_temporal_storage():
    cols, _ = _data()
    cols["tz"] = cols["t"]
    t = frame_from_numpy(cols, device="cpu",
                         schema={"tz": pt.Datetime("us", "Asia/Tokyo")})
    st = _storage(t)
    assert st["tz"][0] == "Datetime(us, Asia/Tokyo)"
    for k in ("t", "tms", "d", "dur", "tz"):
        assert np.array_equal(st[k][1].astype(np.int64),
                              cols[k].astype(np.int64)), k
        host = t.get_column(k).to_numpy()
        assert np.array_equal(host.astype(cols[k].dtype).astype(np.int64),
                              cols[k].astype(np.int64)), k


def test_series_dt_and_functions(monkeypatch):
    monkeypatch.setattr(pt.CONFIG, "device", "cpu")
    s = pt.Series("t", np.array(["1969-12-31T23:00", "2024-03-11T09:30"],
                                dtype="datetime64[us]"), device="cpu")
    assert s.dt.hour().to_list() == [23, 9]
    assert s.dt.weekday().to_list() == [3, 1]
    r = ref.date_range(pydt.date(2024, 1, 30), pydt.date(2024, 6, 1), "1mo",
                       eager=True).to_list()
    assert pt.date_range(pydt.date(2024, 1, 30), pydt.date(2024, 6, 1),
                         "1mo", eager=True).to_list() == r
    r = ref.datetime_range(pydt.datetime(2024, 1, 1), pydt.datetime(2024, 1, 2),
                           "5h", closed="left", eager=True).to_list()
    assert pt.datetime_range(pydt.datetime(2024, 1, 1),
                             pydt.datetime(2024, 1, 2), "5h", closed="left",
                             eager=True).to_list() == r
    assert pt.time_range(interval="5h", eager=True).to_list() == \
        ref.time_range(interval="5h", eager=True).to_list()
    cols = {"e": np.array([0, 86_400, -1])}
    _same(*both(lambda m: [m.from_epoch("e", "s").alias("a"),
                           m.from_epoch(m.col("e"), "ms").alias("b"),
                           m.lit(1).alias("n"),
                           m.duration(days=2, hours=3).alias("c"),
                           m.date(2020, 2, 29).alias("d")], cols, {}))
    # Slice E2 has landed: the per-row ranges are List columns, a cast to
    # String and the str namespace run (held against the JAX package in
    # tests/test_torch_nested.py and tests/test_torch_strings.py)
    for fn in (pt.date_ranges, pt.datetime_ranges):
        assert fn("a", "b").kind == "alias"
    assert frame_from_numpy(cols, device="cpu").select(
        pt.col("e").cast(pt.String)).to_dict() == \
        {"e": ["0", "86400", "-1"]}
    with pytest.raises(pt.InvalidOperationError):
        frame_from_numpy(cols, device="cpu").select(
            pt.col("e").str.strptime(pt.Date, "%Y"))
