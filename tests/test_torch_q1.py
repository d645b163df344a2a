"""The headline query through the JAX package and through the port.

filter -> with_columns -> group_by -> agg(len, count, sum, mean) -> collect,
on the same seeded numpy data (about 5,000 rows), through `polaroid_tpu`
(its CPU path: true f64, scatter segment sums) and `polaroid_tpu_torch`
with device="cpu" (the card's path, with the kernels' plain versions).
Rows are sorted by key before comparing. Counts are exact; f64 sums and
means agree within rtol 1e-10 (both sides accumulate in f64, in another
order).
"""

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


N = 5000
SYMS = [f"S{i:02d}" for i in range(40)]


def _data(key: str, seed: int = 11):
    rng = np.random.default_rng(seed)
    if key == "u32":
        sym = rng.integers(0, 1000, N).astype(np.uint32)
        sym_valid = None
    else:
        sym = [SYMS[i] for i in rng.integers(0, len(SYMS), N)]
        sym_valid = rng.uniform(size=N) < 0.95
    price = rng.uniform(1, 200, N)
    price_valid = rng.uniform(size=N) < 0.9
    volume = rng.integers(0, 5000, N)
    return sym, sym_valid, price, price_valid, volume


def _frames(key: str):
    sym, sym_valid, price, price_valid, volume = _data(key)
    ref_sym = sym if sym_valid is None else \
        [s if ok else None for s, ok in zip(sym, sym_valid)]
    rdf = ref.DataFrame({
        "symbol": ref_sym,
        "price": [float(p) if ok else None
                  for p, ok in zip(price, price_valid)],
        "volume": volume})
    validity = {"price": price_valid}
    if sym_valid is not None:
        validity["symbol"] = sym_valid
    tdf = frame_from_numpy({"symbol": sym, "price": price, "volume": volume},
                           validity=validity, device="cpu")
    return rdf, tdf


def _q1(pl, df):
    return (df.lazy()
            .filter(pl.col("volume") > 1000)
            .with_columns((pl.col("price") * pl.col("volume"))
                          .alias("notional"))
            .group_by("symbol")
            .agg(pl.len().alias("n"),
                 pl.col("price").count().alias("cnt"),
                 pl.col("notional").sum().alias("total"),
                 pl.col("price").mean().alias("avg"))
            .collect())


def _close(got, want, rtol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g is not None and abs(g - w) <= rtol * abs(w), (g, w)


@pytest.mark.parametrize("key", ["u32", "str"])
def test_q1_matches_reference(key):
    rdf, tdf = _frames(key)
    want = _q1(ref, rdf).sort("symbol")
    got = _q1(pt, tdf).sort("symbol")
    assert {k: repr(v) for k, v in got.schema.items()} == \
        {k: repr(v) for k, v in want.schema.items()}
    w, g = want.to_dict(), got.to_dict()
    assert g["symbol"] == w["symbol"]
    assert g["n"] == w["n"]
    assert g["cnt"] == w["cnt"]
    assert any(a != b for a, b in zip(g["n"], g["cnt"]))  # nulls counted
    _close(g["total"], w["total"], 1e-10)
    _close(g["avg"], w["avg"], 1e-10)


@pytest.mark.parametrize("key", ["u32", "str"])
def test_filter_with_columns_collect_exact(key):
    rdf, tdf = _frames(key)

    def q(pl, df):
        return (df.lazy().filter(pl.col("volume") > 1000)
                .with_columns((pl.col("price") * pl.col("volume"))
                              .alias("notional"))
                .collect())

    w, g = q(ref, rdf).to_dict(), q(pt, tdf).to_dict()
    assert g == w


def test_eager_group_by_and_head_match_reference():
    rdf, tdf = _frames("str")

    def q(pl, df):
        return df.filter(pl.col("volume") > 2500).group_by("symbol").agg(
            pl.col("volume").sum().alias("vsum"),
            pl.col("price").null_count().alias("nulls")).sort("symbol")

    assert q(pt, tdf).to_dict() == q(ref, rdf).to_dict()
    assert tdf.head(7).to_dict() == rdf.head(7).to_dict()
    assert tdf.shape == rdf.shape


def test_sort_after_group_by_is_elided():
    rdf, tdf = _frames("u32")

    def q(pl, df):
        return (df.lazy().group_by("symbol").agg(pl.len().alias("n"))
                .sort("symbol").collect())

    assert q(pt, tdf).to_dict() == q(ref, rdf).to_dict()


@pytest.mark.parametrize("agg", ["median", "n_unique", "arg_max",
                                 "product"])
def test_aggregates_of_later_slices_raise(agg):
    """The aggregates that the sorted tier brought (they raised before
    it) now answer: median, n_unique and arg_max as the JAX package
    does, product as numpy does over each group's own rows (the JAX
    package's cumprod ratio overflows across these 5000 prices: ROADMAP
    Queue 3)."""
    rdf, tdf = _frames("u32")

    def q(pl, df):
        return (df.lazy().group_by("symbol")
                .agg(getattr(pl.col("price"), agg)().alias("x"))
                .sort("symbol").collect().to_dict())

    got = q(pt, tdf)
    if agg == "product":
        sym, _, price, price_valid, _ = _data("u32")
        want = [float(np.prod(price[(sym == k) & price_valid]))
                for k in got["symbol"]]
        assert got["symbol"] == sorted(set(sym.tolist()))
        np.testing.assert_allclose(got["x"], want, rtol=1e-12)
        return
    want = q(ref, rdf)
    assert got["symbol"] == want["symbol"]
    if agg == "median":
        np.testing.assert_allclose(np.array(got["x"], dtype=float),
                                   np.array(want["x"], dtype=float),
                                   rtol=1e-12)
    else:
        assert got["x"] == want["x"]


def test_layouts_of_later_slices_raise():
    """The layouts that raised before the sorted tier now answer: a
    100k-key domain (the hash tier) and a Float64 key, alone and with
    maintain_order (the sorted tier), against numpy."""
    rng = np.random.default_rng(2)
    df = pt.DataFrame({"k": rng.integers(0, 100_000, 1000),
                       "f": rng.normal(size=1000)}, device="cpu")
    # a 100k-key domain takes the hash tier now
    out = df.lazy().group_by("k").agg(pt.len().alias("n")).collect()
    keys, counts = np.unique(df.to_dict()["k"], return_counts=True)
    assert dict(zip(*out.to_dict().values())) == dict(zip(keys, counts))
    f = np.array(df.to_dict()["f"])
    fk = (f * 2).round() / 2 + 0.0      # repeated Float64 keys, no -0.0
    dff = pt.DataFrame({"f": fk}, device="cpu")
    got = dff.lazy().group_by("f").agg(pt.len().alias("n")).collect()
    keys, counts = np.unique(fk, return_counts=True)
    assert got.to_dict() == {"f": keys.tolist(), "n": counts.tolist()}
    got = dff.group_by("f", maintain_order=True).agg(pt.len().alias("n"))
    assert got.to_dict()["f"] == list(dict.fromkeys(fk.tolist()))
    # a sort no group-by makes redundant runs on the device (Slice B3)
    got = df.lazy().sort("f").collect().to_dict()["f"]
    assert got == [f[i] for i in np.argsort(f, kind="stable")]


def test_key_stats_follow_the_live_rows():
    """A filtered frame shares its Column objects with the frame it came
    from; the integer-key stats taken over the filtered rows must not be
    reused for the whole frame (the JAX package reuses them: ROADMAP
    Queue 3)."""
    k = np.arange(1000) % 500
    df = pt.DataFrame({"k": k, "v": np.ones(1000)}, device="cpu")
    small = df.filter(pt.col("k") < 50)
    a = small.lazy().group_by("k").agg(pt.len().alias("n")).collect()
    assert a.to_dict() == {"k": list(range(50)), "n": [2] * 50}
    b = df.lazy().group_by("k").agg(pt.len().alias("n")).collect()
    assert b.to_dict() == {"k": list(range(500)), "n": [2] * 500}
    head = df.head(10)  # same capacity bucket: shares the Column objects
    c = head.lazy().group_by("k").agg(pt.len().alias("n")).collect()
    assert c.to_dict() == {"k": list(range(10)), "n": [1] * 10}
    assert df.lazy().group_by("k").agg(pt.len()).collect().height == 500
    # and back to the filtered frame, after stats over a row count
    assert small.lazy().group_by("k").agg(pt.len()).collect().height == 50


def test_q1_after_the_window_tests_in_one_process():
    """The order that once failed: every test of test_torch_over.py, then
    q1 against the JAX package, in one process. The JAX package's
    compile cache (`polaroid_tpu/exec/compiled.py`'s `_CACHE`) handed
    the String-key q1 a UInt32 `symbol` after those tests; each port
    test file now clears that cache when it starts."""
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly",
         "tests/test_torch_over.py",
         "tests/test_torch_q1.py::test_q1_matches_reference"],
        cwd=root, capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
