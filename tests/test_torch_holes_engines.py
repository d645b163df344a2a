"""The length-changing select kinds after the eager `DataFrame.filter`,
`collect(engine="streaming")` over a concat of filtered frames and
`collect(engine="distributed")` on a 4-slot CPU mesh, the port against
the JAX package (tests/torch_holes.py says how, and with which
tolerances); each row of the fault's reproductions as a named case; and
the kept differences, each held to numpy and shown on the JAX package:
`hist` after a filter, a length-changing expression in `with_columns`,
`sample` after a filter and a streamed group-by's sum of a `shift`; the
kinds over the rows a kind made (a sample, an array literal) after a
filter; and
chip_smoke.py's phase 20 at small sizes against its numpy oracles."""

import collections

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
from torch_holes import A, KINDS, SHORT, SOURCES as FRAMES, \
    _clear_reference_chains, check_guard, check_repaired, eager, \
    guard_cases, hist_oracle, lazy, repaired_cases, run, same, \
    source_frame


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


SOURCES = ("eager", "streaming", "distributed")


@pytest.mark.parametrize("src,kind,ctx", repaired_cases(SOURCES))
def test_repaired_kind(src, kind, ctx):
    check_repaired(src, kind, ctx)


@pytest.mark.parametrize("src,kind", guard_cases(SOURCES))
def test_guard_kind(src, kind):
    check_guard(src, kind)


# --- the reproductions of the fault, one case each ---------------------------

def _select_after(src, kinds):
    """[(the port's rows, the JAX package's)] of a select of each kind
    after the source."""
    return [(run(pt, src, lambda f, k=k: f.select(KINDS[k](pt))).to_dict(),
             run(ref, src, lambda f, k=k: f.select(KINDS[k](ref))).to_dict())
            for k in kinds]


def _pairs(row):
    three = ("filter_num", "drop_nulls", "drop_nans")
    above = lambda P, f: f.filter(P.col("i") > -2)      # noqa: E731
    if row == "short_frame_drop_nans":
        return _select_after("short", ["drop_nans"])
    if row == "short_frame_shift_drop_nulls":
        return _select_after("short", ["drop_nulls"])
    if row == "filter_then_expr_filter":
        def lazy_filter(P):
            if P is ref:
                _clear_reference_chains()
            return above(P, lazy(P, A)).select(
                KINDS["filter_num"](P)).collect().to_dict()
        return [(lazy_filter(pt), lazy_filter(ref))]
    if row == "eager_filter_then_expr_filter":
        return [tuple(above(P, eager(P, A)).select(
            KINDS["filter_num"](P)).to_dict() for P in (pt, ref))]
    if row == "series_of_a_filtered_frame_shift_drop_nulls":
        return [tuple({"i": above(P, eager(P, A))["i"].shift(1)
                       .drop_nulls().to_list()} for P in (pt, ref))]
    if row == "inner_join":
        return _select_after("join_inner", three)
    if row == "group_by":
        return _select_after("group_by_dense", three)
    if row == "sort_unique_head_concat":
        return [p for src in ("sort", "unique", "head", "concat")
                for p in _select_after(src, three)]
    assert row == "streaming_concat_of_filtered_frames"
    return _select_after("streaming", ["drop_nulls", "drop_nans"])


@pytest.mark.parametrize("row", [
    "short_frame_drop_nans", "short_frame_shift_drop_nulls",
    "filter_then_expr_filter", "eager_filter_then_expr_filter",
    "series_of_a_filtered_frame_shift_drop_nulls", "inner_join",
    "group_by", "sort_unique_head_concat",
    "streaming_concat_of_filtered_frames"])
def test_reproduction(row):
    """The port gives the JAX package's row count and rows; before the
    repair it also returned pad rows, masked rows or dead slots."""
    for i, (got, want) in enumerate(_pairs(row)):
        same(got, want, None, (row, i))


# --- kept differences ---------------------------------------------------------

def test_hist_after_a_filter_gives_numpys_bins():
    """4 bins over the rows of a filter that masks row slots 0 and 2: the
    port gives numpy's four counts; the JAX package drops the bins whose
    row slots are dead in the filtered frame."""
    def masked(P):
        _clear_reference_chains()
        return lazy(P, A).filter(~P.col("r").is_in([A["r"][0], A["r"][2]]))

    def hist(P):
        return masked(P).select(KINDS["hist"](P)).collect().to_dict()["f"]
    assert hist(pt) == hist_oracle(masked(ref).collect().to_dict())
    assert len(hist(ref)) == 2


def test_with_columns_refuses_a_length_changing_expression():
    """polars refuses `with_columns(col.head(2))`; so does the port. The
    JAX package silently accepts it."""
    with pytest.raises(pt.exceptions.InvalidOperationError):
        eager(pt, SHORT).with_columns(pt.col("i").head(2))
    assert eager(ref, SHORT).with_columns(ref.col("i").head(2)).height == 40


# --- kinds over the rows a kind made, after a filter that masks slot 0 -------

def _slot0_dead(P, d):
    """The frame of `d` without the rows whose r is its first row's: row
    slot 0 is dead, and a kind that makes new rows writes its first one
    there."""
    return lazy(P, d).filter(P.col("r") != d["r"][0])


def _sample(P, then=lambda x: x):
    x = then(P.col("i").sample(n=10, seed=0))
    return _slot0_dead(P, A).select(x.alias("x")).collect().to_dict()["x"]


# a kind over a sample's rows -> (the kind, its answer over those rows)
OVER_A_SAMPLE = {
    "drop_nulls": (lambda x: x.drop_nulls(),
                   lambda s: [v for v in s if v is not None]),
    "gather_every": (lambda x: x.gather_every(2), lambda s: s[::2]),
    "slice": (lambda x: x.slice(1, 4), lambda s: s[1:5]),
    "sum": (lambda x: x.sum(), lambda s: [sum(v for v in s if v is not None)]),
    "str_join": (lambda x: x.cast(pt.String).str.join("|"),
                 lambda s: ["|".join(str(v) for v in s if v is not None)]),
}


def test_kinds_over_the_rows_a_kind_made_after_a_filter():
    """After a filter that masks row slot 0, the rows that `sample(n=10)`
    and an array literal make lie in slots the row mask holds dead; a
    kind over them reads their own rows, not the frame's.
    - `sample(n=10)` gives 10 of the frame's values (numpy's multiset of
      them); the JAX package, which ANDs the row mask onto the sampled
      slots, gives 9 (a kept difference).
    - drop_nulls, gather_every, a slice, sum and str.join of the sample
      give their answer over the sample's 10 rows.
    - `lit(array with a NaN).drop_nans()` on a frame at the literal's
      capacity gives numpy's two values; the JAX package refuses the
      literal."""
    got = _sample(pt)
    left = collections.Counter(
        i for i, r in zip(A["i"], A["r"]) if r != A["r"][0])
    left.subtract(got)
    assert len(got) == 10 and min(left.values()) >= 0, got
    _clear_reference_chains()
    assert len(_sample(ref)) == 9
    for kind, (then, oracle) in OVER_A_SAMPLE.items():
        assert _sample(pt, then) == oracle(got), kind
    arr = np.array([1.0, np.nan, 3.0])
    lit = _slot0_dead(pt, SHORT).select(
        pt.lit(arr).drop_nans().alias("x")).collect().to_dict()
    assert lit == {"x": arr[~np.isnan(arr)].tolist()}
    _clear_reference_chains()
    with pytest.raises(TypeError):
        _slot0_dead(ref, SHORT).select(
            ref.lit(arr).drop_nans().alias("x")).collect()


def test_streamed_group_by_of_a_shift_sees_the_whole_column():
    """A group-by's sum of `shift(1).drop_nulls()` over a concat, streamed:
    the port does not decompose it by batch (a batch's first row would
    lose the row before it), and gives numpy's sums over the whole
    column; the JAX package's streaming engine gives per-batch shifts."""
    rows = source_frame("concat")
    prev = [None] + rows["i"][:-1]
    want = [sum(v for g, v in zip(rows["g"], prev) if g == k and v is not None)
            for k in range(3)]

    def q(P):
        return lambda f: f.group_by("g").agg(
            KINDS["drop_nulls"](P).sum().alias("x")).sort("g")
    got = run(pt, "streaming", q(pt)).to_dict()
    assert got == {"g": [0, 1, 2], "x": want}
    _clear_reference_chains()
    jax_streamed = q(ref)(FRAMES["concat"][0](ref)).collect(
        engine="streaming")
    assert jax_streamed.to_dict()["x"] != want


# --- chip_smoke.py's phase 20 ----------------------------------------------

def test_phase20_queries_against_their_oracles():
    """chip_smoke.py's phase 20 at small sizes on the CPU (the H2O frame
    at 2*10^4 rows, J1's x and small at 2*10^4, 2^14 trades in 10 day
    frames): every query after every breaker against its numpy oracle,
    rows bit for bit, sums within 1e-12 of the sum of |x|."""
    import chip_smoke as CS
    h2o = CS.make_h2o_data(20_000, 0)
    hdf = pt.DataFrame(h2o, device="cpu")
    jtables, jdicts = CS.make_join_data(20_000, 0)
    jframes = CS.join_frames(pt, {k: jtables[k] for k in ("x", "small")},
                             jdicts, "cpu")
    tdata = CS.make_trades_data(1 << 14, 0)
    days, _ = CS.day_frames(pt, None, tdata, device="cpu")
    for src, lf0, engine, a, b, cut in CS.holes_sources(pt, hdf, jframes,
                                                        days):
        x, k = CS.holes_base(src, lf0, engine, a, b, h2o, jtables, tdata)
        rows, sums = CS.holes_oracle(x, k, cut)
        for kind, lf in CS.holes_queries(pt, lf0, a, b, cut):
            CS.check_holes(f"{src}:{kind}", kind,
                           CS.EngineQuery(lf, engine).collect(), rows, sums)
