"""Expression and plan serialization of the port against the JAX
package's.

The same expression or plan, built with each package's API, serializes
to the same JSON text (`Expr.serialize`, `LazyFrame.serialize`; the
format is the JAX package's, `PLAN_FORMAT_VERSION` 1, an in-memory
frame's rows as Arrow IPC in base64). Each package's text deserializes
in the other: an expression to the same fingerprint, a plan to one that
collects the same result (exact in keys, integers and strings; Float64
aggregates within rtol 1e-12). The expressions and plans are the
queries of `chip_smoke.py`'s phases 6-15 (H2O group-bys, sorts, joins,
windows, time, as-of keys, strings, lists, SQL twins) at a small size.
"""

import datetime as dt
import json

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt


@pytest.fixture(autouse=True, scope="module")
def _fresh_reference_cache():
    """The JAX package's process-wide caches can hand this file's plans
    another frame's results (`tests/test_torch_reference_caches.py`)."""
    from test_torch_reference_caches import fresh_reference_caches
    with fresh_reference_caches():
        yield


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

EXPRS = {
    # phase 6: the H2O group-by aggregates
    "sum_v1": lambda pl: pl.col("v1").sum().alias("v1"),
    "mean_v3": lambda pl: pl.col("v3").mean().alias("v3"),
    "range_v1_v2": lambda pl: (pl.col("v1").max() - pl.col("v2").min())
    .alias("range_v1_v2"),
    "std_v3": lambda pl: pl.col("v3").std().alias("sd_v3"),
    "first_last": lambda pl: pl.col("v3").first().alias("first"),
    "len": lambda pl: pl.len().alias("count"),
    # phase 7-9: sorted tier, medians, quantiles, corr
    "median": lambda pl: pl.col("v3").median().alias("median_v3"),
    "quantile": lambda pl: pl.col("v3").quantile(0.9, "linear"),
    "corr2": lambda pl: (pl.corr("v1", "v2") ** 2).alias("r2"),
    "n_unique": lambda pl: pl.col("id3").n_unique(),
    "mod_key": lambda pl: (pl.col("id3") % 1000).alias("k"),
    "arg_max": lambda pl: pl.col("v3").arg_max(),
    # phase 3-5: q1 and the OHLC bar
    "notional": lambda pl: (pl.col("price") * pl.col("volume"))
    .alias("notional"),
    "filter_pred": lambda pl: (pl.col("volume") > 1000)
    & (pl.col("price") < 150.5),
    "ohlc_open": lambda pl: pl.col("price").first().alias("open"),
    "ohlc_high": lambda pl: pl.col("price").max().alias("high"),
    "count": lambda pl: pl.col("price").count().alias("cnt"),
    # phase 10: joins' post-filters
    "is_null": lambda pl: pl.col("v2").is_null(),
    "is_in": lambda pl: pl.col("id1").is_in([1, 5, 9]),
    "is_between": lambda pl: pl.col("v3").is_between(10.0, 20.0,
                                                      closed="left"),
    # phase 11: windows
    "rank_over": lambda pl: pl.col("v3").rank("ordinal", descending=True)
    .over("id6").alias("r"),
    "sum_over": lambda pl: pl.col("v1").sum().over(["id1", "id2"]),
    "cum_sum_over": lambda pl: pl.col("v2").cum_sum().over("id4"),
    "rolling_mean": lambda pl: pl.col("price").rolling_mean(20),
    "rolling_std": lambda pl: pl.col("price").rolling_std(20),
    "ewm_mean": lambda pl: pl.col("price").ewm_mean(alpha=0.1),
    "pct_change": lambda pl: pl.col("price").pct_change().over("symbol"),
    "shift_fill": lambda pl: pl.col("v1").shift(1).fill_null(0),
    "forward_fill": lambda pl: pl.col("price").forward_fill(),
    # phase 12: time
    "truncate": lambda pl: pl.col("ts").dt.truncate("1m").alias("minute"),
    "hour": lambda pl: pl.col("ts").dt.hour(),
    "convert_tz": lambda pl: pl.col("ts").dt.convert_time_zone(
        "America/New_York"),
    "cast_date": lambda pl: pl.col("ts").cast(pl.Date),
    "cast_dt": lambda pl: pl.col("d").cast(pl.Datetime("us", "UTC")),
    "lit_date": lambda pl: pl.col("d") >= pl.lit(dt.date(2024, 3, 5)),
    "lit_datetime": lambda pl: pl.col("ts") < dt.datetime(2024, 3, 4, 15),
    "lit_duration": lambda pl: pl.col("ts") + dt.timedelta(seconds=90),
    "vwap": lambda pl: ((pl.col("price") * pl.col("size")).sum()
                        / pl.col("size").sum()).alias("vwap"),
    "rolling_by": lambda pl: pl.col("price").rolling_mean_by(
        "ts", window_size="5m"),
    # phase 13: TCA
    "tca_slippage": lambda pl: ((pl.col("price") - pl.col("mid"))
                                / pl.col("mid") * 1e4).alias("bps"),
    "abs_clip": lambda pl: pl.col("x").abs().clip(0.0, 5.0),
    "sqrt_log": lambda pl: pl.col("x").sqrt().log1p(),
    # phase 14: strings and lists
    "str_contains": lambda pl: pl.col("sym").str.contains("A"),
    "str_slice": lambda pl: pl.col("cond").str.slice(1, 2),
    "str_upper": lambda pl: pl.col("sym").str.to_uppercase(),
    "str_replace": lambda pl: pl.col("sym").str.replace(" ", "."),
    "str_len": lambda pl: pl.col("sym").str.len_chars(),
    "concat_str": lambda pl: pl.concat_str([pl.col("sym"), pl.col("ex")],
                                           separator="-"),
    "implode": lambda pl: pl.col("price").implode(),
    "list_len": lambda pl: pl.col("lst").list.len(),
    "list_sum": lambda pl: pl.col("lst").list.sum(),
    "explode": lambda pl: pl.col("lst").explode(),
    # phase 15: the surface
    "when": lambda pl: pl.when(pl.col("v1") > 3).then(pl.lit("hi"))
    .otherwise(pl.lit("lo")).alias("band"),
    "cast_i64": lambda pl: pl.col("v1").cast(pl.Int64),
    "cast_u32": lambda pl: pl.col("v2").cast(pl.UInt32, strict=False),
    "coalesce": lambda pl: pl.coalesce(pl.col("a"), pl.col("b"), 0),
    "sum_horizontal": lambda pl: pl.sum_horizontal("v1", "v2"),
    "cut": lambda pl: pl.col("v3").cut([25.0, 50.0, 100.0]),
    "is_duplicated": lambda pl: pl.col("id3").is_duplicated(),
    "filter_agg": lambda pl: pl.col("v3").filter(pl.col("v1") > 2).sum(),
    "sort_by": lambda pl: pl.col("v3").sort_by("v1", descending=True),
    "top_k": lambda pl: pl.col("v3").top_k(5),
    "null_lit": lambda pl: pl.lit(None).alias("nothing"),
    "float_lit": lambda pl: pl.col("v3") * 0.5 + 1e-300,
    "neg_int": lambda pl: pl.col("v1") - (-(2**62)),
}


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_expression_json_is_the_references(name):
    mine = EXPRS[name](pt)
    theirs = EXPRS[name](ref)
    text = mine.serialize()
    assert text == theirs.serialize()
    back = pt.Expr.deserialize(theirs.serialize())
    assert back.fingerprint() == mine.fingerprint()
    assert back.serialize() == text
    assert ref.Expr.deserialize(text).fingerprint() == theirs.fingerprint()


def test_expression_serde_refuses_callables():
    e = pt.col("a").map_batches(lambda s: s)
    with pytest.raises(pt.ComputeError, match="callable"):
        e.serialize()


def test_enough_expressions():
    assert len(EXPRS) >= 40


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def _h2o(n: int = 2000, seed: int = 4):
    rng = np.random.default_rng(seed)
    d = {k: rng.integers(1, 11, n).astype(np.int32)
         for k in ("id1", "id2", "id4", "id5")}
    d["id3"] = rng.integers(1, 200, n).astype(np.int32)
    d["id6"] = rng.integers(1, 200, n).astype(np.int32)
    d["v1"] = rng.integers(1, 6, n).astype(np.int32)
    d["v2"] = rng.integers(1, 16, n).astype(np.int32)
    d["v3"] = rng.uniform(0, 100, n)
    return d


H2O = _h2o()
DIM = {"id1": np.arange(1, 11, dtype=np.int32),
       "name": np.array([f"n{i}" for i in range(10)])}


def _frames(pl):
    kw = {"device": "cpu"} if pl is pt else {}
    return pl.LazyFrame(H2O, **kw), pl.LazyFrame(DIM, **kw)


PLANS = {
    "q2": lambda pl, h, d: h.group_by("id1", "id2").agg(
        pl.col("v1").sum().alias("v1")),
    "q3": lambda pl, h, d: h.group_by("id3").agg(
        pl.col("v1").sum().alias("v1"), pl.col("v3").mean().alias("v3")),
    "q5": lambda pl, h, d: h.group_by("id6").agg(
        pl.col("v1").sum(), pl.col("v2").sum(), pl.col("v3").sum()),
    "q7": lambda pl, h, d: h.group_by("id3").agg(
        (pl.col("v1").max() - pl.col("v2").min()).alias("range_v1_v2")),
    "q10": lambda pl, h, d: h.group_by("id1", "id2", "id4").agg(
        pl.col("v3").sum().alias("v3"), pl.len().alias("count")),
    "q6": lambda pl, h, d: h.group_by("id4", "id5", maintain_order=True)
    .agg(pl.col("v3").std().alias("sd_v3")),
    "q1_filter": lambda pl, h, d: h.filter(pl.col("v1") > 2).with_columns(
        (pl.col("v3") * pl.col("v2")).alias("x")).select("id1", "x"),
    "sort_s1": lambda pl, h, d: h.sort("v3", descending=True).head(50),
    "sort_multi": lambda pl, h, d: h.sort(["id1", "v3"],
                                          maintain_order=True),
    "join": lambda pl, h, d: h.join(d, on="id1", how="left"),
    "unique": lambda pl, h, d: h.unique(subset=["id1", "id2"],
                                        keep="first", maintain_order=True),
    "rename_drop": lambda pl, h, d: h.rename({"v1": "w1"}).drop("v2")
    .with_row_index("i").slice(10, 20),
    "union": lambda pl, h, d: pl.concat([h.head(5), h.tail(5)]),
}


def _same_result(got, want):
    g, w = got.to_dict(), want.to_dict()
    assert list(g) == list(w)
    for k in w:
        if got.schema[k] == pt.Float64:
            np.testing.assert_allclose(
                np.array(g[k], float), np.array(w[k], float), rtol=1e-12)
        else:
            assert g[k] == w[k], k


def _sorted(df):
    return df.sort(df.columns)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_json_is_the_references_and_collects_in_both(name):
    mine = PLANS[name](pt, *_frames(pt))
    theirs = PLANS[name](ref, *_frames(ref))
    text = mine.serialize()
    assert text == theirs.serialize()
    assert json.loads(text)["v"] == 1
    # the JAX package's text in the port, the port's in the JAX package
    ordered = name in ("sort_s1", "sort_multi", "unique", "rename_drop",
                       "union", "q6", "q1_filter")
    got = pt.LazyFrame.deserialize(theirs.serialize(),
                                   device="cpu").collect()
    want = mine.collect()
    _same_result(got if ordered else _sorted(got),
                 want if ordered else _sorted(want))
    back = ref.LazyFrame.deserialize(text).collect()
    direct = theirs.collect()
    a = pt.from_arrow(back.to_arrow(), device="cpu")
    b = pt.from_arrow(direct.to_arrow(), device="cpu")
    _same_result(a if ordered else _sorted(a), b if ordered else _sorted(b))


def test_file_scan_plans(tmp_path):
    p = str(tmp_path / "h.parquet")
    pt.DataFrame(H2O, device="cpu").write_parquet(p)

    def q(pl, **kw):
        return pl.scan_parquet(p, **kw).filter(pl.col("v1") >= 4) \
            .group_by("id1").agg(pl.col("v3").sum().alias("s"))
    text = q(pt, device="cpu").serialize()
    assert text == q(ref).serialize()
    got = pt.LazyFrame.deserialize(text, device="cpu").collect().sort("id1")
    _same_result(got, q(ref).collect().sort("id1"))


def test_dataframe_serialize_is_arrow_ipc():
    df = pt.DataFrame(H2O, device="cpu").head(30)
    data = df.serialize()
    back = ref.DataFrame.deserialize(data)
    assert back.to_dict() == df.to_dict()
    mine = pt.DataFrame.deserialize(ref.DataFrame(H2O).head(30).serialize(),
                                    device="cpu")
    assert mine.to_dict() == df.to_dict()


def test_enough_plans():
    assert len(PLANS) + 1 >= 10
