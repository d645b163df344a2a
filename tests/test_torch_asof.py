"""As-of joins through the JAX package and through the port.

The same seeded numpy inputs go through `polaroid_tpu` (its CPU path)
and through `polaroid_tpu_torch` with device="cpu" (the card's routes,
with the kernels' plain versions): every strategy, with and without
`by`, with and without a tolerance (an int, a float, a `timedelta`, a
duration string), over Int64, Float64 and Datetime keys, eager and lazy.
Values only move in an as-of join, so every column is compared bit for
bit, Float64 too, in the left rows' order. Int64 and Datetime keys take
the packed layout (one `torch.sort` of the (group, key offset) word),
Float64 keys the kernel-F layout with the segmented search.

Where the port departs from the JAX package, it is held to numpy: a null
key on either side, or a null `by` value, never matches (polars'
semantics; the JAX package searches the raw key data, ROADMAP Queue 3).

The slice as a whole: `chip_smoke.py`'s phase-13 queries at 2^12 trades
against its numpy oracles, and A1 -> X1 against the JAX package.
"""

import datetime as pydt
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
from polaroid_tpu_torch.testing import frame_from_numpy

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
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


NL, NR = 700, 400
T0 = np.datetime64("2024-03-04T14:30", "us")


def _keys(kind, rng, n, signed=False):
    lo = -300 if signed else 0
    if kind == "int":
        return np.sort(rng.integers(lo, 300, n))
    if kind == "float":
        return np.sort(rng.uniform(lo, 300, n).round(1))
    return T0 + np.sort(rng.integers(0, 600, n)) * np.timedelta64(1, "s")


def sides(kind, seed=3, signed=False):
    """(left, right) columns: sorted keys with ties across and within the
    sides, a 5-value `by` column and payloads (the right one clashing
    with a left name)."""
    rng = np.random.default_rng(seed)
    left = {"t": _keys(kind, rng, NL, signed), "s": rng.integers(0, 5, NL),
            "a": rng.normal(size=NL)}
    right = {"t": _keys(kind, rng, NR, signed), "s": rng.integers(0, 5, NR),
             "b": rng.normal(size=NR), "a": rng.integers(0, 9, NR)}
    return left, right


def _cell(v):
    if isinstance(v, float):
        return struct.pack("<d", v)
    return v


def same(got, want):
    g, w = got.to_dict(), want.to_dict()
    assert list(g) == list(w)
    for k in w:
        assert [_cell(x) for x in g[k]] == [_cell(x) for x in w[k]], k


TOLERANCES = {"int": [None, 3], "float": [None, 2.5],
              "datetime": [None, pydt.timedelta(seconds=4), "3s"]}
CASES = [(kind, tol) for kind, tols in TOLERANCES.items() for tol in tols]


@pytest.mark.parametrize("strategy", ["backward", "forward", "nearest"])
@pytest.mark.parametrize("by", [None, "s"])
@pytest.mark.parametrize("kind,tol", CASES,
                         ids=[f"{k}-{t}" for k, t in CASES])
def test_join_asof_matches_jax(strategy, by, kind, tol):
    """Keys of one sign: the JAX package's `by` form reads the keys'
    orderable codes as int64, which orders keys of both signs wrongly
    (held to numpy below)."""
    left, right = sides(kind)
    kw = dict(on="t", by=by, strategy=strategy, tolerance=tol)
    tl = pt.DataFrame(left, device="cpu")
    tr = pt.DataFrame(right, device="cpu")
    got = tl.join_asof(tr, **kw)
    same(tl.lazy().join_asof(tr.lazy(), **kw).collect(), got)
    if kind == "float" and by and strategy == "nearest":
        # the JAX package's `by` form measures the distance between
        # orderable codes, not values: held to numpy (a kept difference)
        match = _numpy_asof(left["t"], [True] * NL, list(left["s"]),
                            right["t"], [True] * NR, list(right["s"]),
                            strategy)
        b = [None if j is None else right["b"][j] for j in match]
        if tol is not None:
            b = [x if j is not None and abs(left["t"][i] - right["t"][j])
                 <= tol else None for i, (x, j) in enumerate(zip(b, match))]
        assert got.to_dict()["b"] == b
        return
    same(got, ref.DataFrame(left).join_asof(ref.DataFrame(right), **kw))


@pytest.mark.parametrize("strategy", ["backward", "nearest"])
def test_left_on_right_on_by_left_by_right_and_suffix(strategy):
    left, right = sides("int", seed=5)
    right = {"u": right["t"], "g": right["s"], "b": right["b"],
             "a": right["a"]}
    kw = dict(left_on="t", right_on="u", by_left="s", by_right="g",
              strategy=strategy, suffix="_q")
    want = ref.DataFrame(left).join_asof(ref.DataFrame(right), **kw)
    got = pt.DataFrame(left, device="cpu").join_asof(
        pt.DataFrame(right, device="cpu"), **kw)
    assert "a_q" in got.columns and "u" in got.columns
    same(got, want)


def test_filtered_sides_match_jax():
    """Both sides behind a filter: the port compacts them first."""
    left, right = sides("datetime", seed=7)
    want = (ref.DataFrame(left).lazy().filter(ref.col("a") > 0)
            .join_asof(ref.DataFrame(right).lazy()
                       .filter(ref.col("b") < 0.5), on="t", by="s")
            .collect())
    got = (pt.DataFrame(left, device="cpu").lazy().filter(pt.col("a") > 0)
           .join_asof(pt.DataFrame(right, device="cpu").lazy()
                      .filter(pt.col("b") < 0.5), on="t", by="s")
           .collect())
    same(got, want)


def _numpy_asof(lk, lv, lby, rk, rv, rby, strategy):
    """The polars as-of join by brute force: each valid left key's
    backward/forward/nearest valid right key with an equal, valid `by`
    value; the last of equal keys backward, the first forward."""
    out = []
    for i in range(len(lk)):
        if not lv[i]:
            out.append(None)
            continue
        cand = [j for j in range(len(rk)) if rv[j] and rby[j] is not None
                and lby[i] is not None and rby[j] == lby[i]]
        back = [j for j in cand if rk[j] <= lk[i]]
        fwd = [j for j in cand if rk[j] >= lk[i]]
        b = max(back, key=lambda j: (rk[j], j)) if back else None
        f = min(fwd, key=lambda j: (rk[j], j)) if fwd else None
        if strategy == "backward":
            out.append(b)
        elif strategy == "forward":
            out.append(f)
        elif b is None or f is None:
            out.append(b if f is None else f)
        else:
            out.append(b if lk[i] - rk[b] <= rk[f] - lk[i] else f)
    return out


@pytest.mark.parametrize("strategy", ["backward", "forward", "nearest"])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_null_keys_and_by_values_never_match(strategy, kind):
    """A kept difference: null keys and null `by` values take no part
    (held to numpy; the JAX package matches them)."""
    rng = np.random.default_rng(11)
    n, m = 60, 40
    left, right = sides(kind, seed=13)
    left = {k: v[:n] for k, v in left.items()}
    right = {k: v[:m] for k, v in right.items()}
    lv, rv = rng.random(n) > 0.2, rng.random(m) > 0.2
    lbv, rbv = rng.random(n) > 0.1, rng.random(m) > 0.1
    tl = frame_from_numpy(left, validity={"t": lv, "s": lbv}, device="cpu")
    tr = frame_from_numpy(right, validity={"t": rv, "s": rbv}, device="cpu")
    got = tl.join_asof(tr, on="t", by="s", strategy=strategy).to_dict()
    lby = [int(x) if ok else None for x, ok in zip(left["s"], lbv)]
    rby = [int(x) if ok else None for x, ok in zip(right["s"], rbv)]
    match = _numpy_asof(left["t"], lv, lby, right["t"], rv, rby, strategy)
    assert got["b"] == [None if j is None else right["b"][j] for j in match]
    # and without `by`
    got = tl.join_asof(tr, on="t", strategy=strategy).to_dict()
    ones = [0] * max(n, m)
    match = _numpy_asof(left["t"], lv, ones, right["t"], rv, ones, strategy)
    assert got["b"] == [None if j is None else right["b"][j] for j in match]


@pytest.mark.parametrize("strategy", ["backward", "forward", "nearest"])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_by_form_orders_keys_of_both_signs_by_value(strategy, kind):
    """A kept difference: with `by`, keys of both signs and the nearest
    of two Float64 keys by their values (held to numpy). The JAX package
    compares the orderable u64 codes as int64 (`asof.py:120-150`), so a
    negative key sorts after a positive one, and measures the nearest
    match between codes."""
    left, right = sides(kind, seed=17, signed=True)
    got = pt.DataFrame(left, device="cpu").join_asof(
        pt.DataFrame(right, device="cpu"), on="t", by="s",
        strategy=strategy).to_dict()
    ones = [True] * NL
    match = _numpy_asof(left["t"], ones, list(left["s"]), right["t"],
                        [True] * NR, list(right["s"]), strategy)
    assert got["b"] == [None if j is None else right["b"][j] for j in match]


def test_tolerance_kinds_and_refusals():
    left, right = sides("datetime")
    tl = pt.DataFrame(left, device="cpu")
    tr = pt.DataFrame(right, device="cpu")
    a = tl.join_asof(tr, on="t", tolerance="2s").to_dict()["b"]
    b = tl.join_asof(tr, on="t", tolerance=pydt.timedelta(seconds=2)) \
        .to_dict()["b"]
    c = tl.join_asof(tr, on="t", tolerance=2_000_000).to_dict()["b"]
    assert a == b == c and any(x is None for x in a)
    with pytest.raises(pt.ComputeError, match="calendar"):
        tl.join_asof(tr, on="t", tolerance="1mo")
    with pytest.raises(pt.ComputeError, match="strategy"):
        tl.join_asof(tr, on="t", strategy="sideways")
    assert pt.exceptions.ComputeError is pt.ComputeError


@pytest.mark.parametrize("strategy", ["backward", "nearest"])
def test_date_keys_take_a_tolerance_in_days(strategy):
    """A kept difference: a `timedelta` or duration tolerance on Date keys
    counts whole days (held to numpy). The JAX package scales it to
    microseconds whatever the key, so a Date key's tolerance never
    binds."""
    rng = np.random.default_rng(19)
    lk = np.sort(rng.integers(0, 400, 90)).astype("datetime64[D]")
    rk = np.sort(rng.integers(0, 400, 40)).astype("datetime64[D]")
    b = rng.normal(size=40)
    tl = pt.DataFrame({"d": lk}, device="cpu")
    tr = pt.DataFrame({"d": rk, "b": b}, device="cpu")
    ones = [True] * 90
    match = _numpy_asof(lk.astype(np.int64), ones, [0] * 90,
                        rk.astype(np.int64), [True] * 40, [0] * 40,
                        strategy)
    want = [None if j is None or abs(int(lk[i].astype(np.int64))
                                     - int(rk[j].astype(np.int64))) > 3
            else b[j] for i, j in enumerate(match)]
    for tol in (pydt.timedelta(days=3), "3d"):
        got = tl.join_asof(tr, on="d", strategy=strategy, tolerance=tol)
        assert got.to_dict()["b"] == want


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

ROWS = 1 << 12
# 1000 symbols over ten sessions hold few quotes at this size: the test's
# tolerance is long enough that most trades match
TOL_US = 600_000_000


@pytest.fixture(scope="module")
def phase13():
    td = CS.make_trades_data(ROWS, 0)
    qd = CS.make_quotes_data(ROWS, 0)
    wd = CS.make_windows_data(0, 64)
    return td, qd, wd


@pytest.mark.parametrize("i", range(6))
def test_phase13_queries_against_their_oracles(phase13, i):
    td, qd, wd = phase13
    name, lf, _, _ = CS.asof_queries(
        pt, *CS.asof_frames(pt, td, qd, wd, device="cpu"),
        tolerance_us=TOL_US)[i]
    got = CS.host_columns(lf.collect())
    want, valid, tol = CS.asof_oracle(name, td, qd, wd, got, TOL_US)
    n, _ = CS.compare_columns(name, got, want, valid, tol)
    assert n > 0


def test_a1_to_x1_matches_jax(phase13):
    """A1 and the TCA select over it through both packages."""
    td, qd, wd = phase13
    rf = [ref.DataFrame({k: (v.astype("datetime64[us]") if k in times
                             else v) for k, v in d.items()})
          for d, times in ((td, ("ts",)), (qd, ("ts",)),
                           (wd, ("start", "end")))]
    rq = {name: lf for name, lf, _, _ in
          CS.asof_queries(ref, *rf, tolerance_us=TOL_US)}
    tq = {name: lf for name, lf, _, _ in CS.asof_queries(
        pt, *CS.asof_frames(pt, td, qd, wd, device="cpu"),
        tolerance_us=TOL_US)}
    same(tq["A1_backward"].collect(), rq["A1_backward"].collect())
    g = tq["X1_tca"].collect().to_dict()
    w = rq["X1_tca"].collect().to_dict()
    assert list(g) == list(w)
    # dev_max: the JAX package pushes the filter below the with_columns
    # that takes the mean (held to numpy in the oracle test above and in
    # test_filter_stays_above_an_aggregate)
    assert g["n"] == w["n"]
    for k in ("slip_mean", "slip_vw", "slip_skew"):
        assert g[k][0] == pytest.approx(w[k][0], rel=1e-10, abs=1e-10), k


def test_filter_stays_above_an_aggregate():
    """A kept difference: a filter over a with_columns that takes an
    aggregate stays above it, so the aggregate reads every row (held to
    numpy). The JAX package's optimizer pushes the filter below, and its
    mean reads the kept rows only."""
    rng = np.random.default_rng(0)
    p = rng.uniform(0, 10, 20).astype(np.float32)
    v = rng.integers(0, 10, 20)
    out = (pt.DataFrame({"p": p, "v": v}, device="cpu").lazy()
           .with_columns((pt.col("p") - pt.col("p").mean()).alias("d"))
           .filter(pt.col("v") > 5).select(pt.col("d").abs().max())
           .collect().to_dict())
    mean = np.float32(p.astype(np.float64).sum() / len(p))
    assert out["d"] == [float(np.abs(p - mean)[v > 5].max())]
