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


@pytest.mark.parametrize("agg", ["min", "max", "var", "std"])
def test_aggregates_of_later_slices_raise(agg):
    _, tdf = _frames("u32")
    e = getattr(pt.col("price"), agg)()
    with pytest.raises(NotImplementedError, match="Slice A2"):
        tdf.lazy().group_by("symbol").agg(e).collect()


def test_layouts_of_later_slices_raise():
    rng = np.random.default_rng(2)
    df = pt.DataFrame({"k": rng.integers(0, 100_000, 1000),
                       "f": rng.normal(size=1000)}, device="cpu")
    with pytest.raises(NotImplementedError, match="Slice B"):
        df.lazy().group_by("k").agg(pt.len()).collect()  # 100k-key domain
    with pytest.raises(NotImplementedError, match="Slice B"):
        df.lazy().group_by("f").agg(pt.len()).collect()  # float key
    with pytest.raises(NotImplementedError, match="Slice A2"):
        df.group_by("k", maintain_order=True).agg(pt.len())


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
