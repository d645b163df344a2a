"""Every public expression name of the port, with an expression that runs
it, the frame it reads and how its result is held (shared by
tests/test_torch_expr_catalog*.py, tests/test_torch_cuda_exprs.py and
chip_smoke.py's phase 22, which loads this file by its path; it imports
numpy and torch, and neither package).

An entry is `Entry(name, source, family, build, ...)`:
* `name`: the public name it runs, qualified by its class: "Expr.abs",
  "str.contains", "dt.year", "list.sum" (the `arr` namespace is the same
  class), "struct.field", "cat.slice", "name.suffix", "bin.size", and
  "top.fold" for a top-level function; `also` names the other names the
  same expression runs (an alias, a round trip);
* `source`: the frame it reads. "num" is H2O's G1_1e7_1e2_0_0 under the
  names of `NUM_COLUMNS` (i = id4, j = v1, k = v2, g = id6, x = v3), run
  as built and with i and x nullable (`NUM_NULL_COLUMNS`: id4n and v3n);
  "taq" is the TAQ trades (sym, ex, cond, date, price, volume, ts) with
  the columns of `taq_derived` added (a categorical, a binary, lists, an
  array, a struct, a date, a zoned datetime, a duration, a time, JSON
  and hex strings);
* `family`: how the card's result is held to its oracle (`TOLERANCE`);
* `build(pl)`: the expression, from the package module `pl`;
* `context`: "select" (one lazy `select` of the expression, collected),
  "eager" (`DataFrame.select`: the lazy plan cannot type it, in either
  package) or "group_by" (an `agg` by j with maintain_order=True);
* `host`: a host UDF (a Python function called on the host, once a row,
  a batch or a group): it runs on the first `HOST_PREFIX` rows only, or
  `HOST_SERIES_PREFIX` where it builds a Series a row (`prefix`);
* `numpy`: the name of a closed form in `NUMPY_ORACLES` that phase 22
  uses in place of the port's CPU collect (`NUMPY_OF` assigns them).

A SCAN entry's bound is sized to its statistic (`scan_bound`:
`SCAN_SCALE` where both sides run the port's code, `NUMPY_SCAN` where
numpy's form is the oracle).

`cols` (the input columns an entry reads) is the expression's root
names. `EXCLUDED` names what has no entry and why; `VARIANTS` the extra
runs: `.over()` with a Float64 and a String key, `cum_*` over
partitions, and the time zones besides New York. `HOLE_FILTERS` is the
breaker one entry of each family also runs after.
"""

from __future__ import annotations

import datetime as _dt
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

# the frames' columns: the catalog's name -> the H2O column it is
NUM_COLUMNS = {"i": "id4", "j": "v1", "k": "v2", "g": "id6", "x": "v3"}
# the same with i and x nullable (chip_smoke.py's with_null_copies)
NUM_NULL_COLUMNS = {**NUM_COLUMNS, "i": "id4n", "x": "v3n"}
# rows of the host UDFs' prefix: a function called once a value, a batch
# or a group takes HOST_PREFIX rows; one called once a row over a Series
# built for that row (rolling_map's windows, cumulative_eval's prefixes)
# HOST_SERIES_PREFIX: a host Series a row takes about 0.4 ms (2^10 rows
# took 0.39 s a collect of rolling_map beside an NVIDIA H100 80GB HBM3,
# 700.00 W; 2^16 would take about 25 s)
HOST_PREFIX = 1 << 16
HOST_SERIES_PREFIX = 1 << 8
# the share of null rows in i and x of the nullable frame
NULL_SHARE = 0.05

EXACT = "exact"     # bit for bit: integers, booleans, strings, dates,
#                     times, nulls, row counts and order; floats that are
#                     moved, not computed
FLOAT = "float"     # elementwise: Float64 within rtol 1e-12, Float32
#                     within one ulp
SCAN = "scan"       # sums over a window or a prefix, and statistics of
#                     them: within the bound of the statistic
#                     (`scan_bound`)
SAMPLE = "sample"   # random draws: held to their properties (`check`)
REFUSED = "refused"  # no evaluation in either package: the card raises
#                      what the CPU raises (its class and message)

TOLERANCE = {EXACT: "bit for bit",
             FLOAT: "Float64 rtol 1e-12; Float32 one ulp",
             SCAN: "against the port's CPU collect rtol 1e-12 with a "
                   "floor of 1e-12 of the statistic's scale; against "
                   "numpy's form its worst case (c*n*2^-53*S over the "
                   "partition, prefix or window summed; c = 4); a Float32 "
                   "result one ulp more (scan_bound)",
             SAMPLE: "properties: length, membership, permutation",
             REFUSED: "the same error class and message as the CPU's"}
SCAN_C = 4.0


class Entry(NamedTuple):
    name: str
    source: str
    family: str
    build: Callable
    context: str = "select"
    host: bool = False
    numpy: Optional[str] = None
    also: Tuple[str, ...] = ()
    check: Optional[str] = None     # SAMPLE: the property held

    @property
    def prefix(self) -> Optional[int]:
        """The rows a host UDF runs on (None: the whole frame)."""
        if not self.host:
            return None
        return HOST_SERIES_PREFIX if self.name in (
            "Expr.rolling_map", "Expr.cumulative_eval") else HOST_PREFIX

    def cols(self, pl):
        """The input columns the expression reads (its root names; none
        where building it is refused or makes no expression)."""
        try:
            return sorted(set(self.build(pl).meta.root_names()))
        except Exception:
            if self.family != REFUSED:
                raise
            return []


ENTRIES: dict = {}


def _add(name, source, family, build, **kw):
    assert name not in ENTRIES, name
    ENTRIES[name] = Entry(name, source, family, build, **kw)


# --- helpers the expressions share ---------------------------------------

def _nan(pl):
    """x with NaN where x < 50 (a square root of a negative)."""
    return (pl.col("x") - 50).sqrt()


def _sign(pl):
    """+1 or -1 by j's parity: an exact product of 10^7 rows."""
    return pl.col("j") % 2 * 2 - 1


def _udf_triple(s):
    return s * 3


# --- Expr, over the numeric frame ----------------------------------------

def _num_exprs():
    N, T = "num", "taq"
    rows = [
        ("abs", EXACT, lambda pl: (pl.col("x") - 50).abs()),
        ("add", FLOAT, lambda pl: pl.col("x").add(pl.col("k"))),
        ("alias", EXACT, lambda pl: pl.col("x").alias("y")),
        ("all", EXACT, lambda pl: (pl.col("j") > 0).all()),
        ("and_", EXACT, lambda pl: (pl.col("j") > 2).and_(pl.col("k") > 5)),
        ("any", EXACT, lambda pl: (pl.col("j") > 4).any()),
        ("append", EXACT, lambda pl: pl.col("i").append(pl.col("j"))),
        ("approx_n_unique", EXACT, lambda pl: pl.col("g").approx_n_unique()),
        ("arccos", FLOAT, lambda pl: (pl.col("x") / 100).arccos()),
        ("arccosh", FLOAT, lambda pl: (pl.col("x") + 1).arccosh()),
        ("arcsin", FLOAT, lambda pl: (pl.col("x") / 100).arcsin()),
        ("arcsinh", FLOAT, lambda pl: pl.col("x").arcsinh()),
        ("arctan", FLOAT, lambda pl: pl.col("x").arctan()),
        ("arctanh", FLOAT, lambda pl: (pl.col("x") / 101).arctanh()),
        ("arg_max", EXACT, lambda pl: pl.col("x").arg_max()),
        ("arg_min", EXACT, lambda pl: pl.col("x").arg_min()),
        ("arg_sort", EXACT, lambda pl: pl.col("x").arg_sort()),
        ("arg_true", EXACT, lambda pl: (pl.col("j") == 3).arg_true()),
        ("arg_unique", EXACT, lambda pl: pl.col("i").arg_unique()),
        ("backward_fill", EXACT, lambda pl: pl.col("i").backward_fill()),
        ("bitwise_and", EXACT, lambda pl: pl.col("g").bitwise_and()),
        ("bitwise_or", EXACT, lambda pl: pl.col("g").bitwise_or()),
        ("bitwise_xor", EXACT, lambda pl: pl.col("g").bitwise_xor()),
        ("bitwise_count_ones", EXACT,
         lambda pl: pl.col("g").bitwise_count_ones()),
        ("bitwise_count_zeros", EXACT,
         lambda pl: pl.col("g").bitwise_count_zeros()),
        ("bitwise_leading_ones", EXACT,
         lambda pl: (-pl.col("g")).bitwise_leading_ones()),
        ("bitwise_leading_zeros", EXACT,
         lambda pl: pl.col("g").bitwise_leading_zeros()),
        ("bitwise_trailing_ones", EXACT,
         lambda pl: pl.col("g").bitwise_trailing_ones()),
        ("bitwise_trailing_zeros", EXACT,
         lambda pl: pl.col("g").bitwise_trailing_zeros()),
        ("bottom_k", EXACT, lambda pl: pl.col("x").bottom_k(100)),
        ("bottom_k_by", EXACT, lambda pl: pl.col("g").bottom_k_by("x", 100)),
        ("cast", EXACT, lambda pl: pl.col("x").cast(pl.Float32)),
        ("cbrt", FLOAT, lambda pl: pl.col("x").cbrt()),
        ("ceil", EXACT, lambda pl: pl.col("x").ceil()),
        ("clip", EXACT, lambda pl: pl.col("x").clip(10, 90)),
        ("cos", FLOAT, lambda pl: pl.col("x").cos()),
        ("cosh", FLOAT, lambda pl: (pl.col("x") / 50).cosh()),
        ("cot", FLOAT, lambda pl: (pl.col("x") + 1).cot()),
        ("count", EXACT, lambda pl: pl.col("x").count()),
        ("cum_count", EXACT, lambda pl: pl.col("i").cum_count()),
        ("cum_max", EXACT, lambda pl: pl.col("x").cum_max()),
        ("cum_min", EXACT, lambda pl: pl.col("x").cum_min(reverse=True)),
        ("cum_prod", EXACT, lambda pl: _sign(pl).cum_prod()),
        ("cum_sum", SCAN, lambda pl: pl.col("x").cum_sum()),
        ("cut", EXACT, lambda pl: pl.col("x").cut([25.0, 50.0, 75.0])),
        ("degrees", FLOAT, lambda pl: pl.col("x").degrees()),
        ("diff", FLOAT, lambda pl: pl.col("x").diff()),
        ("dot", SCAN, lambda pl: pl.col("x").dot(pl.col("k"))),
        ("drop_nans", FLOAT, lambda pl: _nan(pl).drop_nans()),
        ("drop_nulls", EXACT, lambda pl: pl.col("x").drop_nulls()),
        ("entropy", SCAN, lambda pl: pl.col("x").entropy()),
        ("eq", EXACT, lambda pl: pl.col("j").eq(pl.col("k"))),
        ("eq_missing", EXACT, lambda pl: pl.col("i").eq_missing(pl.col("k"))),
        ("ewm_mean", SCAN, lambda pl: pl.col("x").ewm_mean(alpha=0.1)),
        ("ewm_std", SCAN, lambda pl: pl.col("x").ewm_std(alpha=0.1)),
        ("ewm_var", SCAN, lambda pl: pl.col("x").ewm_var(alpha=0.1)),
        ("exclude", EXACT, lambda pl: pl.all().exclude("x", "g")),
        ("exp", FLOAT, lambda pl: (pl.col("x") / 10).exp()),
        ("extend_constant", EXACT,
         lambda pl: pl.col("i").extend_constant(7, 5)),
        ("fill_nan", FLOAT, lambda pl: _nan(pl).fill_nan(-1.0)),
        ("fill_null", EXACT, lambda pl: pl.col("i").fill_null(0)),
        ("filter", EXACT, lambda pl: pl.col("x").filter(pl.col("j") > 2)),
        ("first", EXACT, lambda pl: pl.col("x").first()),
        ("flatten", EXACT, lambda pl: pl.col("i").implode().flatten()),
        ("floor", EXACT, lambda pl: pl.col("x").floor()),
        ("floordiv", EXACT, lambda pl: pl.col("g").floordiv(pl.col("k"))),
        ("forward_fill", EXACT, lambda pl: pl.col("i").forward_fill()),
        ("gather", REFUSED,
         lambda pl: pl.col("x").gather([0, 5, 10, 100, 4000])),
        ("gather_every", EXACT, lambda pl: pl.col("x").gather_every(7, 3)),
        ("ge", EXACT, lambda pl: pl.col("x").ge(50.0)),
        ("get", REFUSED, lambda pl: pl.col("x").get(3)),
        ("gt", EXACT, lambda pl: pl.col("x").gt(pl.col("k"))),
        ("has_nulls", EXACT, lambda pl: pl.col("i").has_nulls()),
        ("hash", EXACT, lambda pl: pl.col("g").hash(42)),
        ("head", EXACT, lambda pl: pl.col("x").head(100)),
        ("hist", EXACT, lambda pl: pl.col("x").hist(bin_count=16)),
        ("implode", EXACT, lambda pl: pl.col("i").implode()),
        ("index_of", EXACT, lambda pl: pl.col("g").index_of(77)),
        ("interpolate", FLOAT, lambda pl: pl.col("i").interpolate()),
        ("interpolate_by", FLOAT,
         lambda pl: pl.col("x").interpolate_by("g")),
        ("is_between", EXACT, lambda pl: pl.col("x").is_between(10, 20)),
        ("is_close", EXACT,
         lambda pl: (pl.col("x") / 7 * 7).is_close(pl.col("x"))),
        ("is_duplicated", EXACT, lambda pl: pl.col("g").is_duplicated()),
        ("is_finite", EXACT, lambda pl: (1 / pl.col("x").floor()).is_finite()),
        ("is_first_distinct", EXACT,
         lambda pl: pl.col("i").is_first_distinct()),
        ("is_in", EXACT, lambda pl: pl.col("g").is_in([1, 2, 3, 77, 5000])),
        ("is_infinite", EXACT,
         lambda pl: (1 / pl.col("x").floor()).is_infinite()),
        ("is_last_distinct", EXACT,
         lambda pl: pl.col("i").is_last_distinct()),
        ("is_nan", EXACT, lambda pl: _nan(pl).is_nan()),
        ("is_not_nan", EXACT, lambda pl: _nan(pl).is_not_nan()),
        ("is_not_null", EXACT, lambda pl: pl.col("x").is_not_null()),
        ("is_null", EXACT, lambda pl: pl.col("i").is_null()),
        ("is_unique", EXACT, lambda pl: pl.col("g").is_unique()),
        ("item", EXACT, lambda pl: pl.col("x").max().item()),
        ("kurtosis", SCAN, lambda pl: pl.col("x").kurtosis()),
        ("last", EXACT, lambda pl: pl.col("x").last()),
        ("le", EXACT, lambda pl: pl.col("j").le(pl.col("k"))),
        ("len", EXACT, lambda pl: pl.col("x").len()),
        ("limit", EXACT, lambda pl: pl.col("x").limit(100)),
        ("log", FLOAT, lambda pl: (pl.col("x") + 1).log()),
        ("log10", FLOAT, lambda pl: (pl.col("x") + 1).log10()),
        ("log1p", FLOAT, lambda pl: pl.col("x").log1p()),
        ("lower_bound", EXACT, lambda pl: pl.col("x").lower_bound()),
        ("lt", EXACT, lambda pl: pl.col("x").lt(50.0)),
        ("max", EXACT, lambda pl: pl.col("x").max()),
        ("mean", SCAN, lambda pl: pl.col("x").mean()),
        ("median", EXACT, lambda pl: pl.col("x").median()),
        ("min", EXACT, lambda pl: pl.col("x").min()),
        ("mod", EXACT, lambda pl: pl.col("g").mod(pl.col("k"))),
        ("mode", EXACT, lambda pl: pl.col("j").mode()),
        ("mul", FLOAT, lambda pl: pl.col("x").mul(pl.col("k"))),
        ("n_unique", EXACT, lambda pl: pl.col("g").n_unique()),
        ("name_keep", EXACT, lambda pl: (pl.col("x") * 1).name_keep()),
        ("nan_max", FLOAT, lambda pl: _nan(pl).nan_max()),
        ("nan_min", FLOAT, lambda pl: _nan(pl).nan_min()),
        ("ne", EXACT, lambda pl: pl.col("j").ne(pl.col("k"))),
        ("ne_missing", EXACT, lambda pl: pl.col("i").ne_missing(pl.col("k"))),
        ("neg", EXACT, lambda pl: pl.col("x").neg()),
        ("not_", EXACT, lambda pl: (pl.col("j") > 2).not_()),
        ("null_count", EXACT, lambda pl: pl.col("i").null_count()),
        ("or_", EXACT, lambda pl: (pl.col("j") > 4).or_(pl.col("k") < 2)),
        ("over", SCAN, lambda pl: pl.col("x").sum().over("j")),
        ("pct_change", FLOAT, lambda pl: pl.col("x").pct_change()),
        ("peak_max", EXACT, lambda pl: pl.col("x").peak_max()),
        ("peak_min", EXACT, lambda pl: pl.col("x").peak_min()),
        ("pipe", FLOAT, lambda pl: pl.col("x").pipe(lambda e, n: e * n, 3)),
        ("pow", FLOAT, lambda pl: pl.col("x").pow(1.5)),
        ("product", EXACT, lambda pl: _sign(pl).product()),
        ("qcut", EXACT, lambda pl: pl.col("x").qcut(4)),
        ("quantile", EXACT, lambda pl: pl.col("x").quantile(0.9)),
        ("radians", FLOAT, lambda pl: pl.col("x").radians()),
        ("rank", EXACT, lambda pl: pl.col("x").rank()),
        ("rechunk", EXACT, lambda pl: pl.col("x").rechunk()),
        ("reinterpret", EXACT,
         lambda pl: pl.col("g").cast(pl.Int64).reinterpret(signed=False)),
        ("repeat_by", EXACT, lambda pl: pl.col("k").repeat_by("j")),
        ("replace", EXACT, lambda pl: pl.col("j").replace([1, 2], [10, 20])),
        ("replace_strict", EXACT,
         lambda pl: pl.col("j").replace_strict([1, 2, 3, 4], [40, 30, 20, 10],
                                               default=0)),
        ("reshape", EXACT, lambda pl: pl.col("x").reshape((-1, 2))),
        ("reverse", EXACT, lambda pl: pl.col("x").reverse()),
        ("rle", EXACT, lambda pl: pl.col("j").rle()),
        ("rle_id", EXACT, lambda pl: pl.col("j").rle_id()),
        ("rolling_kurtosis", SCAN, lambda pl: pl.col("x").rolling_kurtosis(20)),
        ("rolling_max", EXACT, lambda pl: pl.col("x").rolling_max(20)),
        ("rolling_mean", SCAN, lambda pl: pl.col("x").rolling_mean(20)),
        ("rolling_median", EXACT, lambda pl: pl.col("x").rolling_median(20)),
        ("rolling_min", EXACT, lambda pl: pl.col("x").rolling_min(20)),
        ("rolling_quantile", EXACT,
         lambda pl: pl.col("x").rolling_quantile(0.25, window_size=20)),
        ("rolling_rank", FLOAT, lambda pl: pl.col("x").rolling_rank(20)),
        ("rolling_skew", SCAN, lambda pl: pl.col("x").rolling_skew(20)),
        ("rolling_std", SCAN, lambda pl: pl.col("x").rolling_std(20)),
        ("rolling_sum", SCAN, lambda pl: pl.col("x").rolling_sum(20)),
        ("rolling_var", SCAN, lambda pl: pl.col("x").rolling_var(20)),
        ("round", FLOAT, lambda pl: pl.col("x").round(2)),
        ("round_sig_figs", FLOAT, lambda pl: pl.col("x").round_sig_figs(3)),
        ("search_sorted", EXACT,
         lambda pl: pl.col("x").sort().search_sorted(50.0)),
        ("set_sorted", EXACT, lambda pl: pl.col("g").sort().set_sorted()),
        ("shift", EXACT, lambda pl: pl.col("x").shift(3)),
        ("shrink_dtype", EXACT, lambda pl: pl.col("g").shrink_dtype()),
        ("sign", EXACT, lambda pl: (pl.col("x") - 50).sign()),
        ("sin", FLOAT, lambda pl: pl.col("x").sin()),
        ("sinh", FLOAT, lambda pl: (pl.col("x") / 50).sinh()),
        ("skew", SCAN, lambda pl: pl.col("x").skew()),
        ("slice", EXACT, lambda pl: pl.col("x").slice(100, 1000)),
        ("sort", EXACT, lambda pl: pl.col("x").sort(descending=True)),
        ("sort_by", EXACT, lambda pl: pl.col("i").sort_by("x")),
        ("sqrt", FLOAT, lambda pl: pl.col("x").sqrt()),
        ("std", SCAN, lambda pl: pl.col("x").std()),
        ("sub", FLOAT, lambda pl: pl.col("x").sub(pl.col("k"))),
        ("sum", SCAN, lambda pl: pl.col("x").sum()),
        ("tail", EXACT, lambda pl: pl.col("x").tail(100)),
        ("tan", FLOAT, lambda pl: (pl.col("x") / 70).tan()),
        ("tanh", FLOAT, lambda pl: (pl.col("x") / 50).tanh()),
        ("to_physical", EXACT, lambda pl: pl.col("x").cut([50.0])
         .to_physical()),
        ("top_k", EXACT, lambda pl: pl.col("x").top_k(100)),
        ("top_k_by", EXACT, lambda pl: pl.col("g").top_k_by("x", 100)),
        ("truediv", FLOAT, lambda pl: pl.col("x").truediv(pl.col("k"))),
        ("unique", REFUSED, lambda pl: pl.col("i").unique()),
        ("unique_counts", REFUSED, lambda pl: pl.col("i").unique_counts()),
        ("upper_bound", EXACT, lambda pl: pl.col("x").upper_bound()),
        ("value_counts", REFUSED, lambda pl: pl.col("i").value_counts()),
        ("var", SCAN, lambda pl: pl.col("x").var()),
        ("where", EXACT, lambda pl: pl.col("x").where(pl.col("j") > 2)),
        ("xor", EXACT, lambda pl: pl.col("j").xor(pl.col("k"))),
    ]
    for name, family, build in rows:
        _add(f"Expr.{name}", N, family, build,
             context="eager" if name == "reshape" else "select")
    _add("Expr.agg_groups", N, EXACT, lambda pl: pl.col("k").agg_groups(),
         context="group_by")
    _add("Expr.sample", N, SAMPLE,
         lambda pl: pl.col("x").sample(fraction=0.25, seed=7),
         check="subset")
    _add("Expr.shuffle", N, SAMPLE, lambda pl: pl.col("x").shuffle(seed=7),
         check="permutation")
    _add("Expr.serialize", N, SCAN, lambda pl: pl.Expr.deserialize(
        (pl.col("x") * 2).sum().serialize()),
         also=("Expr.deserialize", "Expr.from_json"))
    # host UDFs: a Python function on the host
    _add("Expr.map_elements", N, EXACT, lambda pl: pl.col("j").map_elements(
        lambda v: v * 3 + 1, return_dtype=pl.Int64), host=True)
    _add("Expr.map_batches", N, FLOAT,
         lambda pl: pl.col("x").map_batches(_udf_triple), host=True)
    _add("Expr.rolling_map", N, FLOAT, lambda pl: pl.col("x").rolling_map(
        lambda s: s.max() - s.min(), window_size=5), host=True)
    _add("Expr.inspect", N, EXACT, lambda pl: pl.col("j").inspect("{}"),
         host=True)
    _add("Expr.cumulative_eval", N, EXACT, lambda pl: pl.col("j")
         .cumulative_eval(pl.element().max() - pl.element().min()),
         host=True)
    _add("Expr.register_plugin", N, EXACT, lambda pl: _plugin(pl),
         host=True)
    # Expr over the trades: a sorted time column and a String key
    _add("Expr.ewm_mean_by", T, SCAN,
         lambda pl: pl.col("price").ewm_mean_by("ts", half_life="5m"))
    _add("Expr.rolling", T, EXACT,
         lambda pl: pl.col("volume").sum().rolling("ts", period="5m"))
    for agg in ("sum", "mean", "min", "max", "std", "var", "median"):
        fam = EXACT if agg in ("min", "max", "median") else SCAN
        _add(f"Expr.rolling_{agg}_by", T, fam, lambda pl, a=agg: getattr(
            pl.col("price"), f"rolling_{a}_by")("ts", "5m"))
    _add("Expr.rolling_quantile_by", T, EXACT,
         lambda pl: pl.col("price").rolling_quantile_by("ts", "5m",
                                                        quantile=0.25))
    _add("Expr.rolling_rank_by", T, FLOAT,
         lambda pl: pl.col("price").rolling_rank_by("ts", "5m"))
    _add("Expr.explode", T, EXACT, lambda pl: pl.col("lst").explode())


def _plugin(pl):
    """A registered Python plugin (three times its input) called through
    the deprecated `Expr.register_plugin`."""
    import importlib
    import warnings
    plug = importlib.import_module(pl.__name__ + ".plugins")
    plug.register_plugin_callable("catalog_triple", _udf_triple)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return pl.col("j").register_plugin(
            lib="none.so", symbol="catalog_triple", is_elementwise=True)


# --- str, dt, list, struct, cat, bin, name -------------------------------

def _str_exprs():
    s = [
        ("concat", lambda pl: pl.col("ex").str.concat("-")),
        ("contains", lambda pl: pl.col("sym").str.contains("A[B-D]")),
        ("contains_any", lambda pl: pl.col("sym").str.contains_any(
            ["A", "ZZ"])),
        ("count_matches", lambda pl: pl.col("cond").str.count_matches(
            "@", literal=True)),
        ("decode", lambda pl: pl.col("hx").str.decode("hex")),
        ("encode", lambda pl: pl.col("sym").str.encode("base64")),
        ("ends_with", lambda pl: pl.col("sym").str.ends_with("A")),
        ("escape_regex", lambda pl: pl.col("cond").str.escape_regex()),
        ("explode", lambda pl: pl.col("sym").str.explode()),
        ("extract", lambda pl: pl.col("sym").str.extract(r"(\w+) (\w)", 2)),
        ("extract_all", lambda pl: pl.col("cond").str.extract_all(r"[A-Z]")),
        ("extract_groups", lambda pl: pl.col("sym").str.extract_groups(
            r"(?P<root>[A-Z]+) ?(?P<cls>[AB])?")),
        ("extract_many", lambda pl: pl.col("sym").str.extract_many(
            ["A", "B"])),
        ("find", lambda pl: pl.col("sym").str.find("A", literal=True)),
        ("find_many", lambda pl: pl.col("sym").str.find_many(["A", "B"])),
        ("head", lambda pl: pl.col("sym").str.head(2)),
        ("join", lambda pl: pl.col("ex").str.join("")),
        ("json_decode", lambda pl: pl.col("js").str.json_decode()),
        ("json_path_match", lambda pl: pl.col("js").str.json_path_match(
            "$.v")),
        ("len_bytes", lambda pl: pl.col("sym").str.len_bytes()),
        ("len_chars", lambda pl: pl.col("sym").str.len_chars()),
        ("normalize", lambda pl: pl.col("sym").str.normalize("NFKD")),
        ("pad_end", lambda pl: pl.col("sym").str.pad_end(6, "*")),
        ("pad_start", lambda pl: pl.col("sym").str.pad_start(6, "0")),
        ("replace", lambda pl: pl.col("sym").str.replace(" ", "/",
                                                         literal=True)),
        ("replace_all", lambda pl: pl.col("cond").str.replace_all(
            "@", "a", literal=True)),
        ("replace_many", lambda pl: pl.col("cond").str.replace_many(
            ["@", "F"], ["a", "f"])),
        ("reverse", lambda pl: pl.col("sym").str.reverse()),
        ("slice", lambda pl: pl.col("sym").str.slice(1, 2)),
        ("split", lambda pl: pl.col("cond").str.split(" ")),
        ("split_exact", lambda pl: pl.col("sym").str.split_exact(" ", 1)),
        ("splitn", lambda pl: pl.col("sym").str.splitn(" ", 2)),
        ("starts_with", lambda pl: pl.col("sym").str.starts_with("A")),
        ("strip_chars", lambda pl: pl.col("cond").str.strip_chars()),
        ("strip_chars_end", lambda pl: pl.col("cond").str.strip_chars_end(
            " I")),
        ("strip_chars_start", lambda pl: pl.col("cond").str
         .strip_chars_start("@")),
        ("strip_prefix", lambda pl: pl.col("sym").str.strip_prefix("A")),
        ("strip_suffix", lambda pl: pl.col("sym").str.strip_suffix(" A")),
        ("strptime", lambda pl: pl.col("date").str.strptime(pl.Date,
                                                            "%Y%m%d")),
        ("tail", lambda pl: pl.col("sym").str.tail(2)),
        ("to_date", lambda pl: pl.col("date").str.to_date("%Y%m%d")),
        ("to_datetime", lambda pl: pl.col("date").str.to_datetime("%Y%m%d")),
        ("to_decimal", lambda pl: pl.col("date").str.to_decimal()),
        ("to_integer", lambda pl: pl.col("date").str.to_integer()),
        ("to_lowercase", lambda pl: pl.col("sym").str.to_lowercase()),
        ("to_time", lambda pl: pl.col("ts").dt.truncate("1s")
         .dt.strftime("%H:%M:%S").str.to_time("%H:%M:%S")),
        ("to_titlecase", lambda pl: pl.col("sym").str.to_titlecase()),
        ("to_uppercase", lambda pl: pl.col("sym").str.to_lowercase()
         .str.to_uppercase()),
        ("zfill", lambda pl: pl.col("sym").str.zfill(6)),
    ]
    for name, build in s:
        _add(f"str.{name}", "taq", EXACT, build)


def _dt_exprs():
    ts, tz, d = "ts", "tsz", "d"
    rows = [
        ("add_business_days", lambda pl: pl.col(d).dt.add_business_days(3)),
        ("base_utc_offset", lambda pl: pl.col(tz).dt.base_utc_offset()),
        ("cast_time_unit", lambda pl: pl.col(ts).dt.cast_time_unit("ms")),
        ("century", lambda pl: pl.col(d).dt.century()),
        ("combine", lambda pl: pl.col(d).dt.combine(pl.col("tm"))),
        ("convert_time_zone", lambda pl: pl.col(tz).dt.convert_time_zone(
            "Asia/Tokyo")),
        ("date", lambda pl: pl.col(tz).dt.date()),
        ("datetime", lambda pl: pl.col(tz).dt.datetime()),
        ("day", lambda pl: pl.col(ts).dt.day()),
        ("days_in_month", lambda pl: pl.col(d).dt.days_in_month()),
        ("dst_offset", lambda pl: pl.col(tz).dt.dst_offset()),
        ("epoch", lambda pl: pl.col(ts).dt.epoch("s")),
        ("hour", lambda pl: pl.col(tz).dt.hour()),
        ("is_business_day", lambda pl: pl.col(d).dt.is_business_day()),
        ("is_leap_year", lambda pl: pl.col(d).dt.is_leap_year()),
        ("iso_year", lambda pl: pl.col(ts).dt.iso_year()),
        ("microsecond", lambda pl: pl.col(ts).dt.microsecond()),
        ("millennium", lambda pl: pl.col(d).dt.millennium()),
        ("millisecond", lambda pl: pl.col(ts).dt.millisecond()),
        ("minute", lambda pl: pl.col(ts).dt.minute()),
        ("month", lambda pl: pl.col(ts).dt.month()),
        ("month_end", lambda pl: pl.col(ts).dt.month_end()),
        ("month_start", lambda pl: pl.col(tz).dt.month_start()),
        ("nanosecond", lambda pl: pl.col(ts).dt.nanosecond()),
        ("offset_by", lambda pl: pl.col(ts).dt.offset_by("-1mo3d2h")),
        ("ordinal_day", lambda pl: pl.col(ts).dt.ordinal_day()),
        ("quarter", lambda pl: pl.col(d).dt.quarter()),
        ("replace", lambda pl: pl.col(ts).dt.replace(day=1, hour=0)),
        ("replace_time_zone", lambda pl: pl.col(ts).dt.replace_time_zone(
            "America/New_York")),
        ("round", lambda pl: pl.col(ts).dt.round("15m")),
        ("second", lambda pl: pl.col(ts).dt.second()),
        ("strftime", lambda pl: pl.col(d).dt.strftime("%a %d %b %Y %j")),
        ("time", lambda pl: pl.col(tz).dt.time()),
        ("timestamp", lambda pl: pl.col(ts).dt.timestamp("ms")),
        ("to_string", lambda pl: pl.col(tz).dt.truncate("1m").dt.to_string(
            "%Y-%m-%d %H:%M:%S")),
        ("total_days", lambda pl: pl.col("dur").dt.total_days()),
        ("total_hours", lambda pl: pl.col("dur").dt.total_hours()),
        ("total_microseconds", lambda pl: pl.col("dur").dt
         .total_microseconds()),
        ("total_milliseconds", lambda pl: pl.col("dur").dt
         .total_milliseconds()),
        ("total_minutes", lambda pl: pl.col("dur").dt.total_minutes()),
        ("total_nanoseconds", lambda pl: pl.col("dur").dt
         .total_nanoseconds()),
        ("total_seconds", lambda pl: pl.col("dur").dt.total_seconds()),
        ("truncate", lambda pl: pl.col(ts).dt.truncate("1h")),
        ("week", lambda pl: pl.col(ts).dt.week()),
        ("weekday", lambda pl: pl.col(ts).dt.weekday()),
        ("with_time_unit", lambda pl: pl.col(ts).dt.with_time_unit("ns")),
        ("year", lambda pl: pl.col(ts).dt.year()),
    ]
    for name, build in rows:
        _add(f"dt.{name}", "taq",
             REFUSED if name in ("offset_by", "round") else EXACT, build)


def _list_exprs():
    L, S = "lst", "ls"
    e = lambda pl: pl.element()  # noqa: E731
    rows = [
        ("agg", EXACT, lambda pl: pl.col(L).list.agg(e(pl) * 3)),
        ("all", EXACT, lambda pl: pl.col(L).list.eval(e(pl) > 0).list.all()),
        ("any", EXACT, lambda pl: pl.col(L).list.eval(e(pl) > 2).list.any()),
        ("arg_max", EXACT, lambda pl: pl.col(L).list.arg_max()),
        ("arg_min", EXACT, lambda pl: pl.col(L).list.arg_min()),
        ("concat", EXACT, lambda pl: pl.col(L).list.concat(pl.col(L))),
        ("contains", EXACT, lambda pl: pl.col(L).list.contains(2)),
        ("count_matches", EXACT, lambda pl: pl.col(L).list.count_matches(1)),
        ("diff", EXACT, lambda pl: pl.col(L).list.diff()),
        ("drop_nulls", EXACT, lambda pl: pl.col(L).list.gather(
            [0, 3], null_on_oob=True).list.drop_nulls()),
        ("eval", EXACT, lambda pl: pl.col(L).list.eval(e(pl) * 2 + 1)),
        ("explode", EXACT, lambda pl: pl.col(L).list.explode()),
        ("filter", EXACT, lambda pl: pl.col(L).list.filter(e(pl) > 1)),
        ("first", EXACT, lambda pl: pl.col(L).list.first()),
        ("gather", EXACT, lambda pl: pl.col(L).list.gather(
            [0, 2], null_on_oob=True)),
        ("gather_every", EXACT, lambda pl: pl.col(L).list.gather_every(2)),
        ("get", EXACT, lambda pl: pl.col(L).list.get(0)),
        ("head", EXACT, lambda pl: pl.col(L).list.head(2)),
        ("item", EXACT, lambda pl: pl.col(L).list.head(1).list.item(
            allow_empty=True)),
        ("join", EXACT, lambda pl: pl.col(S).list.join("-")),
        ("last", EXACT, lambda pl: pl.col(L).list.last()),
        ("len", EXACT, lambda pl: pl.col(L).list.len()),
        ("max", EXACT, lambda pl: pl.col(L).list.max()),
        ("mean", FLOAT, lambda pl: pl.col(L).list.mean()),
        ("median", FLOAT, lambda pl: pl.col(L).list.median()),
        ("min", EXACT, lambda pl: pl.col(L).list.min()),
        ("n_unique", EXACT, lambda pl: pl.col(L).list.n_unique()),
        ("reverse", EXACT, lambda pl: pl.col(L).list.reverse()),
        ("set_difference", EXACT, lambda pl: pl.col(L).list.set_difference(
            pl.col(L).list.eval(e(pl) + 1))),
        ("set_intersection", EXACT, lambda pl: pl.col(L).list
         .set_intersection(pl.col(L).list.eval(e(pl) + 1))),
        ("set_symmetric_difference", EXACT, lambda pl: pl.col(L).list
         .set_symmetric_difference(pl.col(L).list.eval(e(pl) + 1))),
        ("set_union", EXACT, lambda pl: pl.col(L).list.set_union(
            pl.col(L).list.eval(e(pl) + 1))),
        ("shift", EXACT, lambda pl: pl.col(L).list.shift(1)),
        ("slice", EXACT, lambda pl: pl.col(L).list.slice(1, 2)),
        ("sort", EXACT, lambda pl: pl.col(L).list.sort(descending=True)),
        ("std", FLOAT, lambda pl: pl.col(L).list.std()),
        ("sum", EXACT, lambda pl: pl.col(L).list.sum()),
        ("tail", EXACT, lambda pl: pl.col(L).list.tail(2)),
        ("to_array", EXACT, lambda pl: pl.col(L).list.head(1).list.to_array(
            1)),
        ("to_list", EXACT, lambda pl: pl.col("arr").arr.to_list()),
        ("to_struct", EXACT, lambda pl: pl.col(L).list.to_struct(
            fields=["a", "b", "c"])),
        ("unique", EXACT, lambda pl: pl.col(L).list.unique()),
        ("var", FLOAT, lambda pl: pl.col(L).list.var()),
    ]
    for name, family, build in rows:
        _add(f"list.{name}", "taq", family, build)
    _add("list.sample", "taq", SAMPLE,
         lambda pl: pl.col(L).list.sample(n=1, seed=7), check="list_member")


def _other_namespaces():
    T = "taq"
    st = [("field", lambda pl: pl.col("st").struct.field("price")),
          ("json_encode", lambda pl: pl.struct(
              "ex", pl.col("volume") % 100).struct.json_encode()),
          ("prefix_fields", lambda pl: pl.col("st").struct.prefix_fields(
              "p_")),
          ("rename_fields", lambda pl: pl.col("st").struct.rename_fields(
              ["a", "b", "c"])),
          ("suffix_fields", lambda pl: pl.col("st").struct.suffix_fields(
              "_s")),
          ("unnest", lambda pl: pl.col("st").struct.unnest()),
          ("with_fields", lambda pl: pl.col("st").struct.with_fields(
              (pl.col("st").struct.field("volume") * 2).alias("v2")))]
    for name, build in st:
        _add(f"struct.{name}", T, EXACT, build, context="eager" if name in (
            "prefix_fields", "suffix_fields") else "select")
    cat = [("ends_with", lambda pl: pl.col("ct").cat.ends_with("A")),
           ("get_categories", lambda pl: pl.col("ct").cat.get_categories()),
           ("len_bytes", lambda pl: pl.col("ct").cat.len_bytes()),
           ("len_chars", lambda pl: pl.col("ct").cat.len_chars()),
           ("set_ordering", lambda pl: pl.col("ct").cat.set_ordering(
               "lexical").sort()),
           ("slice", lambda pl: pl.col("ct").cat.slice(0, 2)),
           ("starts_with", lambda pl: pl.col("ct").cat.starts_with("A")),
           ("to_local", lambda pl: pl.col("ct").cat.to_local())]
    for name, build in cat:
        _add(f"cat.{name}", T, EXACT, build)
    b = [("contains", lambda pl: pl.col("bn").bin.contains(b"F")),
         ("decode", lambda pl: pl.col("hx").cast(pl.Binary).bin.decode(
             "hex")),
         ("encode", lambda pl: pl.col("bn").bin.encode("hex")),
         ("ends_with", lambda pl: pl.col("bn").bin.ends_with(b"I")),
         ("head", lambda pl: pl.col("bn").bin.head(2)),
         ("reinterpret", lambda pl: pl.col("bn").bin.reinterpret(
             dtype=pl.Int32)),
         ("size", lambda pl: pl.col("bn").bin.size()),
         ("slice", lambda pl: pl.col("bn").bin.slice(1, 2)),
         ("starts_with", lambda pl: pl.col("bn").bin.starts_with(b"@")),
         ("tail", lambda pl: pl.col("bn").bin.tail(2))]
    for name, build in b:
        _add(f"bin.{name}", T, EXACT, build)
    nm = [("keep", "num", lambda pl: (pl.col("x") + 1).alias("z").name.keep()),
          ("map", "num", lambda pl: pl.col("x").name.map(str.upper)),
          ("map_fields", T, lambda pl: pl.col("st").name.map_fields(
              str.upper)),
          ("prefix", "num", lambda pl: pl.col("x").name.prefix("p_")),
          ("prefix_fields", T, lambda pl: pl.col("st").name.prefix_fields(
              "p_")),
          ("replace", "num", lambda pl: pl.col("x").name.replace("x", "z")),
          ("suffix", "num", lambda pl: pl.col("x").name.suffix("_s")),
          ("suffix_fields", T, lambda pl: pl.col("st").name.suffix_fields(
              "_s")),
          ("to_lowercase", "num", lambda pl: pl.col("x").name.suffix("_S")
           .name.to_lowercase()),
          ("to_uppercase", "num", lambda pl: pl.col("x").name.to_uppercase())]
    for name, src, build in nm:
        _add(f"name.{name}", src, EXACT, build, context="eager" if name.endswith(
            "_fields") else "select")


# --- the top-level functions that build an expression ---------------------

def _top_exprs():
    N, T = "num", "taq"
    d0, d1 = _dt.date(2024, 1, 1), _dt.date(2024, 12, 31)
    rows = [
        ("all", N, EXACT, lambda pl: pl.all()),
        ("all_horizontal", N, EXACT, lambda pl: pl.all_horizontal(
            pl.col("j") > 1, pl.col("k") > 3)),
        ("any", N, EXACT, lambda pl: pl.any(pl.col("j") > 4)),
        ("any_horizontal", N, EXACT, lambda pl: pl.any_horizontal(
            pl.col("j") > 4, pl.col("i") < 3)),
        ("approx_n_unique", N, EXACT, lambda pl: pl.approx_n_unique("g")),
        ("arange", N, EXACT, lambda pl: pl.arange(0, 1000)),
        ("arctan2", N, FLOAT, lambda pl: pl.arctan2("x", "k")),
        ("arctan2d", N, FLOAT, lambda pl: pl.arctan2d("k", "x")),
        ("arg_sort_by", N, EXACT, lambda pl: pl.arg_sort_by(["j", "x"])),
        ("arg_where", N, EXACT, lambda pl: pl.arg_where(pl.col("j") == 3)),
        ("business_day_count", T, EXACT, lambda pl: pl.business_day_count(
            "d", pl.col("d") + pl.duration(days=10))),
        ("coalesce", N, EXACT, lambda pl: pl.coalesce("i", "j")),
        ("col", N, EXACT, lambda pl: pl.col("x")),
        ("concat_arr", T, EXACT, lambda pl: pl.concat_arr(
            "volume", pl.col("volume") * 2)),
        ("concat_list", T, EXACT, lambda pl: pl.concat_list(
            "volume", pl.col("volume") % 7)),
        ("concat_str", T, EXACT, lambda pl: pl.concat_str(
            ["sym", "ex"], separator="-")),
        ("corr", N, SCAN, lambda pl: pl.corr("x", "k")),
        ("count", N, EXACT, lambda pl: pl.count("x")),
        ("cov", N, SCAN, lambda pl: pl.cov("x", "k")),
        ("cum_count", N, EXACT, lambda pl: pl.cum_count("i")),
        ("cum_fold", N, EXACT, lambda pl: pl.cum_fold(
            pl.lit(0), lambda a, b: a + b, [pl.col("j"), pl.col("k")])),
        ("cum_reduce", N, EXACT, lambda pl: pl.cum_reduce(
            lambda a, b: a * b, [pl.col("j"), pl.col("k")])),
        ("cum_sum", N, SCAN, lambda pl: pl.cum_sum("x")),
        ("cum_sum_horizontal", N, EXACT, lambda pl: pl.cum_sum_horizontal(
            "j", "k")),
        ("date", N, EXACT, lambda pl: pl.date(2024, pl.col("j"),
                                              pl.col("k"))),
        ("date_range", N, EXACT, lambda pl: pl.date_range(d0, d1, "1d")),
        ("date_ranges", T, EXACT, lambda pl: pl.date_ranges(
            "d", pl.col("d") + pl.duration(days=3))),
        ("datetime", N, EXACT, lambda pl: pl.datetime(2024, 3, 10, 7, 30)),
        ("datetime_range", N, EXACT, lambda pl: pl.datetime_range(
            _dt.datetime(2024, 3, 1), _dt.datetime(2024, 3, 15), "1h")),
        ("datetime_ranges", T, EXACT, lambda pl: pl.datetime_ranges(
            "ts", pl.col("ts") + pl.duration(hours=3), "1h")),
        ("duration", T, EXACT, lambda pl: pl.col("dur") + pl.duration(
            days=1, hours=2, minutes=3)),
        ("element", T, EXACT, lambda pl: pl.col("lst").list.eval(
            pl.element() % 2 == 0)),
        ("exclude", N, EXACT, lambda pl: pl.exclude("x", "g")),
        ("field", T, EXACT, lambda pl: pl.col("st").struct.with_fields(
            (pl.field("volume") + 1).alias("w"))),
        ("first", N, EXACT, lambda pl: pl.first("x")),
        ("fold", N, EXACT, lambda pl: pl.fold(
            pl.lit(0), lambda a, b: a + b, [pl.col("j"), pl.col("k")])),
        ("format", N, EXACT, lambda pl: pl.format("{}-{}", "j", "k")),
        ("from_epoch", N, EXACT, lambda pl: pl.from_epoch("g",
                                                          time_unit="s")),
        ("groups", N, EXACT, lambda pl: _groups(pl), ),
        ("head", N, EXACT, lambda pl: pl.head("x", 10)),
        ("implode", N, EXACT, lambda pl: pl.implode("i")),
        ("int_range", N, EXACT, lambda pl: pl.int_range(0, 1000, 3)),
        ("int_ranges", N, EXACT, lambda pl: pl.int_ranges(0, "j")),
        ("last", N, EXACT, lambda pl: pl.last("x")),
        ("len", N, EXACT, lambda pl: pl.len()),
        ("linear_space", N, REFUSED, lambda pl: pl.linear_space(0, 1, 1000)),
        ("linear_spaces", N, REFUSED, lambda pl: pl.linear_spaces(
            0, pl.col("j"), 4)),
        ("lit", N, EXACT, lambda pl: pl.lit(3)),
        ("max", N, EXACT, lambda pl: pl.max("x")),
        ("max_horizontal", N, EXACT, lambda pl: pl.max_horizontal("x", "k")),
        ("mean", N, SCAN, lambda pl: pl.mean("x")),
        ("mean_horizontal", N, FLOAT, lambda pl: pl.mean_horizontal(
            "x", "k")),
        ("median", N, EXACT, lambda pl: pl.median("x")),
        ("min", N, EXACT, lambda pl: pl.min("x")),
        ("min_horizontal", N, EXACT, lambda pl: pl.min_horizontal("x", "k")),
        ("n_unique", N, EXACT, lambda pl: pl.n_unique("g")),
        ("nth", N, EXACT, lambda pl: pl.nth(2)),
        ("quantile", N, EXACT, lambda pl: pl.quantile("x", 0.25)),
        ("reduce", N, EXACT, lambda pl: pl.reduce(
            lambda a, b: a * b, [pl.col("j"), pl.col("k")])),
        ("repeat", N, EXACT, lambda pl: pl.repeat(7, 100)),
        ("rolling_corr", N, SCAN, lambda pl: pl.rolling_corr(
            "x", "k", window_size=20)),
        ("rolling_cov", N, SCAN, lambda pl: pl.rolling_cov(
            "x", "k", window_size=20)),
        ("row_index", N, EXACT, lambda pl: pl.row_index()),
        ("sql_expr", N, FLOAT, lambda pl: pl.sql_expr("x * 2 + k")),
        ("std", N, SCAN, lambda pl: pl.std("x")),
        ("struct", N, EXACT, lambda pl: pl.struct("j", "k")),
        ("sum", N, SCAN, lambda pl: pl.sum("x")),
        ("sum_horizontal", N, FLOAT, lambda pl: pl.sum_horizontal("x", "k")),
        ("tail", N, EXACT, lambda pl: pl.tail("x", 10)),
        ("time", N, EXACT, lambda pl: pl.time(9, 30, 15)),
        ("time_range", N, EXACT, lambda pl: pl.time_range(
            _dt.time(9, 30), _dt.time(16, 0), "1m")),
        ("time_ranges", N, REFUSED, lambda pl: pl.time_ranges(
            _dt.time(9, 30), _dt.time(16, 0), "1m")),
        ("var", N, SCAN, lambda pl: pl.var("x")),
        ("when", N, FLOAT, lambda pl: pl.when(pl.col("j") > 2).then(
            pl.col("x")).otherwise(pl.col("k"))),
    ]
    for name, src, family, build in rows:
        _add(f"top.{name}", src, family, build,
             context="group_by" if name == "groups" else "select")
    _add("top.map_batches", N, FLOAT, lambda pl: pl.map_batches(
        "x", lambda s: s * 2), host=True)
    _add("top.map_groups", N, EXACT, lambda pl: pl.map_groups(
        ["k"], lambda s: s[0].max(), returns_scalar=True),
         context="group_by", host=True)


def _groups(pl):
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return pl.groups("k")


_num_exprs()
_str_exprs()
_dt_exprs()
_list_exprs()
_other_namespaces()
_top_exprs()


# names with no entry, each with its reason
EXCLUDED = {
    # namespace accessors: their names are entries of their own (`arr` is
    # the `list` class; `ext` wraps extension dtypes, not a counted class)
    **{f"Expr.{ns}": "namespace accessor"
       for ns in ("str", "dt", "list", "arr", "struct", "cat", "name",
                  "bin", "ext")},
    "Expr.meta": "the meta namespace inspects the expression tree on the "
                 "host and does no device work",
    "Expr.fingerprint": "the expression's text on the host, no device work",
    "Expr.kind": "an attribute of the expression tree, no device work",
    "Expr.children": "an attribute of the expression tree, no device work",
    "Expr.attrs": "an attribute of the expression tree, no device work",
    "top.ones": "builds a Series (eager by default), not an expression; "
                "both packages refuse a Series as a literal",
    "top.zeros": "builds a Series (eager by default), not an expression; "
                 "both packages refuse a Series as a literal",
    # the top-level functions that build no expression
    **{f"top.{n}": "builds no expression (a frame, a setting or a string)"
       for n in ("align_frames", "build_info", "collect_all",
                 "collect_all_async", "concat", "disable_string_cache",
                 "enable_string_cache", "escape_regex", "explain_all",
                 "from_dict", "from_dicts", "from_numpy", "from_records",
                 "from_repr", "from_torch", "get_index_type",
                 "json_normalize", "read_delta", "scan_delta", "select",
                 "set_random_seed", "show_versions", "sql",
                 "thread_pool_size", "threadpool_size", "union",
                 "using_string_cache")},
}

# the modules whose public functions are the top-level expression
# functions
TOP_MODULES = ("api.functions", "expr.expr")


# --- the extra runs -------------------------------------------------------

# (key, source, family, build): .over() with H2O's v3 (Float64) and TAQ's
# sym (String) as the key, cum_* over partitions, and each time zone
ZONES = ("America/New_York", "Europe/London", "Asia/Tokyo",
         "Australia/Sydney")


def _zoned(pl, zone):
    return pl.col("ts").dt.replace_time_zone("UTC").dt.convert_time_zone(
        zone)


def _variants():
    out = [
        ("over_float_key", "num", EXACT,
         lambda pl: pl.col("k").sum().over("x")),
        ("over_float_key_rank", "num", EXACT,
         lambda pl: pl.col("j").rank("ordinal").over("x")),
        ("over_string_key", "taq", SCAN,
         lambda pl: pl.col("price").mean().over("sym")),
        ("over_string_key_cum_sum", "taq", EXACT,
         lambda pl: pl.col("volume").cum_sum().over("sym")),
        ("cum_sum_over", "num", SCAN,
         lambda pl: pl.col("x").cum_sum().over("j")),
        ("cum_max_over", "num", EXACT,
         lambda pl: pl.col("x").cum_max().over("j")),
        ("cum_min_over", "num", EXACT,
         lambda pl: pl.col("x").cum_min().over("i")),
        ("cum_prod_over", "num", EXACT,
         lambda pl: _sign(pl).cum_prod().over("i")),
        ("cum_count_over", "num", EXACT,
         lambda pl: pl.col("x").cum_count().over("j")),
    ]
    for z in ZONES:
        tag = z.split("/")[1].lower()
        out += [
            (f"{tag}_hour", "taq", EXACT,
             lambda pl, z=z: _zoned(pl, z).dt.hour()),
            (f"{tag}_strftime", "taq", EXACT,
             lambda pl, z=z: _zoned(pl, z).dt.truncate("1m").dt.strftime(
                 "%Y-%m-%d %H:%M %z")),
            (f"{tag}_truncate_day", "taq", EXACT,
             lambda pl, z=z: _zoned(pl, z).dt.truncate("1d")),
            (f"{tag}_truncate_month", "taq", EXACT,
             lambda pl, z=z: _zoned(pl, z).dt.truncate("1mo")),
            (f"{tag}_month_end", "taq", EXACT,
             lambda pl, z=z: _zoned(pl, z).dt.month_end()),
            (f"{tag}_dst_offset", "taq", EXACT,
             lambda pl, z=z: _zoned(pl, z).dt.dst_offset()),
        ]
    return [Entry(f"variant.{k}", s, f, b) for k, s, f, b in out]


VARIANTS = _variants()

# the breaker that leaves holes: one entry of each family runs after it
HOLE_FILTERS = {"num": lambda pl: pl.col("j") > 2,
                "taq": lambda pl: pl.col("volume") % 5 > 2}
HOLE_ENTRIES = ("Expr.fill_null", "Expr.sin", "Expr.cum_sum",
                "Expr.rolling_quantile", "Expr.rle_id", "Expr.sample",
                "Expr.over", "Expr.rolling_sum_by", "str.starts_with",
                "dt.month_end", "list.sum", "struct.field", "cat.len_chars",
                "bin.size", "top.fold")


# --- the frames -----------------------------------------------------------

def taq_derived(pl):
    """The columns the catalog's TAQ entries read besides the trades'
    own: ct (sym as Categorical), bn (cond as Binary: 4 bytes), hx (sym
    in hex), js (a JSON object per row), lst (List[Int64] of 1-4
    elements), ls (List[String]: cond split at blanks), arr
    (Array[Int64, 3]), st (Struct of sym, price, volume), d (the Date),
    tsz (ts as an instant in America/New_York), dur (a Duration), tm (a
    Time)."""
    c = pl.col
    return [
        c("sym").cast(pl.Categorical).alias("ct"),
        c("cond").cast(pl.Binary).alias("bn"),
        c("sym").str.encode("hex").alias("hx"),
        pl.format('{{"v": {}, "x": "{}"}}', c("volume") % 100, c("ex"))
        .alias("js"),
        pl.int_ranges(c("volume") % 3, c("volume") % 3 + 1
                      + c("volume") % 4).alias("lst"),
        c("cond").str.split(" ").alias("ls"),
        pl.concat_list(c("volume").cast(pl.Int64), c("volume") % 7,
                       c("volume") // 3).list.to_array(3).alias("arr"),
        pl.struct("sym", "price", "volume").alias("st"),
        c("ts").dt.date().alias("d"),
        _zoned(pl, "America/New_York").alias("tsz"),
        (c("ts") - c("ts").min()).alias("dur"),
        c("ts").dt.time().alias("tm"),
    ]


SESSION_OPENS = ["2024-03-04T14:30", "2024-03-05T14:30", "2024-03-06T14:30",
                 "2024-03-07T14:30", "2024-03-08T14:30", "2024-03-11T13:30",
                 "2024-03-12T13:30", "2024-03-13T13:30", "2024-03-14T13:30",
                 "2024-03-15T13:30"]
SESSION_MS = 23_400_000


def num_data(n: int, seed: int):
    """n rows in H2O's G1_1e7_1e2_0_0 distributions under the catalog's
    names (id4 as i, v1 as j, v2 as k, id6 as g over n / 100 values, v3
    as x) and the validity of the nullable i and x."""
    rng = np.random.default_rng(seed)
    big = max(n // 100, 1)
    cols = {"i": rng.integers(1, 101, n, dtype=np.int32),
            "j": rng.integers(1, 6, n, dtype=np.int32),
            "k": rng.integers(1, 16, n, dtype=np.int32),
            "g": rng.integers(1, big + 1, n, dtype=np.int32),
            "x": rng.uniform(0, 100, n)}
    valid = {c: rng.uniform(size=n) >= NULL_SHARE for c in ("i", "x")}
    return cols, valid


def taq_data(n: int, seed: int):
    """n trades in the TAQ layout of chip_smoke.py's make_taq_data, at a
    small size: sym (tickers, some with a share class), ex, cond, date,
    price (Float32), volume (Int32), ts (Datetime("us"), ascending over
    the 10 sessions of 2024-03-04..15)."""
    rng = np.random.default_rng(seed)
    tickers = np.array(["AAPL", "BRK A", "BRK B", "IBM", "A", "GE", "ZZ",
                        "MSFT", "ABCD", "BA"])
    venues = np.array(list("ABCDHIJKLMNPUVXZ"))
    cp = np.where(rng.random((n, 4)) < 0.5, ord("@"), ord(" ")).astype(
        np.uint32)
    cp[:, 1] = np.where(rng.random(n) < 0.3, ord("F"), cp[:, 1])
    cp[:, 3] = np.where(rng.random(n) < 0.45, ord("I"), cp[:, 3])
    ms = np.sort(rng.integers(0, len(SESSION_OPENS) * SESSION_MS, n))
    opens = np.array(SESSION_OPENS, dtype="datetime64[us]").astype(np.int64)
    ts = opens[ms // SESSION_MS] + (ms % SESSION_MS) * 1000
    days = np.array([d[:10].replace("-", "") for d in SESSION_OPENS])
    return {"sym": tickers[rng.integers(0, len(tickers), n)],
            "ex": venues[rng.integers(0, len(venues), n)],
            "cond": np.ascontiguousarray(cp).view("<U4").ravel(),
            "date": days[ms // SESSION_MS],
            "price": rng.uniform(1, 200, n).astype(np.float32),
            "volume": rng.integers(0, 5000, n).astype(np.int32),
            "ts": ts.astype("datetime64[us]")}


def host_lists(cols: dict, valid: Optional[dict] = None) -> dict:
    """numpy columns as Python lists, None where `valid` says null (a
    frame either package builds the same way)."""
    out = {}
    for name, a in cols.items():
        vals = a.tolist()
        if valid and name in valid:
            vals = [v if ok else None for v, ok in zip(vals, valid[name])]
        out[name] = vals
    return out


# --- numpy's closed forms -------------------------------------------------
# Each takes a frame's host columns (`Host`) and gives one leaf (values,
# validity or None), a dict of leaves (".len"/".values" of a list), or a
# `Coded` string column; nulls as the port treats them: sorts put them
# first, top_k/bottom_k skip them, ranks and windows leave them null, a
# null key is a partition of its own. What several forms share (x's
# order, a window's order statistics, a zone's offsets) is made once a
# frame (`Host.shared`).

class Host(dict):
    """A frame's host columns: {name: numpy array} for the trades,
    {name: (values, validity or None)} for the numeric frames; `shared`
    keeps what several closed forms of one frame read."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.memo = {}

    def shared(self, key, make):
        if key not in self.memo:
            self.memo[key] = make()
        return self.memo[key]

    def rows(self, keep) -> "Host":
        """The columns over the rows `keep` holds (a breaker's)."""
        return Host({k: v[keep] if not isinstance(v, tuple) else (
            v[0][keep], None if v[1] is None else v[1][keep])
            for k, v in self.items()})


_US_HOUR = 3_600_000_000
_US_DAY = 24 * _US_HOUR


def _vv(col):
    """(values, validity) of a host column in either form."""
    if isinstance(col, tuple):
        vals, valid = col
    else:
        vals, valid = np.asarray(col), None
    return vals, (np.ones(len(vals), bool) if valid is None else valid)


def _nullable(vals, valid):
    return vals, (None if valid is None or valid.all() else valid)


def _dt64(ts):
    return np.asarray(ts).astype("datetime64[us]")


def _runs(keys):
    """The distinct values of a sorted int64 array and each row's index
    into them (one pass, no sort)."""
    assert (keys[1:] >= keys[:-1]).all(), "keys are not sorted"
    new = np.r_[True, keys[1:] != keys[:-1]]
    return keys[new], np.cumsum(new) - 1


def _ts(cols):
    """The trades' instants as int64 microseconds (ascending)."""
    return cols.shared("ts", lambda: _dt64(cols["ts"]).astype(np.int64))


def _days(cols):
    """(distinct days as datetime.date, each row's index into them) of
    the trades' instants (naive, UTC)."""
    def make():
        d, inv = _runs(_ts(cols) // _US_DAY)
        return [_dt.date(1970, 1, 1) + _dt.timedelta(days=int(x))
                for x in d], inv
    return cols.shared("days", make)


def _by_day(cols, fn, dtype=np.int64):
    days, inv = _days(cols)
    return np.array([fn(d) for d in days], dtype=dtype)[inv]


def _np_year(cols):
    return _by_day(cols, lambda d: d.year)


def _np_month(cols):
    return _by_day(cols, lambda d: d.month)


def _np_day(cols):
    return _by_day(cols, lambda d: d.day)


def _np_weekday(cols):
    return _by_day(cols, lambda d: d.isoweekday())


def _np_iso_year(cols):
    return _by_day(cols, lambda d: d.isocalendar()[0])


def _np_week(cols):
    return _by_day(cols, lambda d: d.isocalendar()[1])


def _days_in_month(d):
    nxt = (d.replace(day=28) + _dt.timedelta(days=4)).replace(day=1)
    return (nxt - _dt.timedelta(days=1)).day


def _np_month_end(cols):
    """ts rolled forward to its month's last day, its time kept."""
    shift = _by_day(cols, lambda d: _days_in_month(d) - d.day)
    return _ts(cols) + shift * _US_DAY


def _np_strftime(cols):
    """"%a %d %b %Y %j" of each row's day, formatted once a distinct day
    (the values are a dictionary's)."""
    days, inv = _days(cols)
    return Coded(inv, [d.strftime("%a %d %b %Y %j") for d in days])


# --- a zone's local times: an offset a distinct UTC hour (every offset
# change of these zones falls on a whole UTC hour)

def _zone_of(name):
    from zoneinfo import ZoneInfo
    return ZoneInfo(name)


def _local_offset_us(naive_us: int, zone) -> int:
    """The zone's UTC offset at a local wall time (the earlier of two)."""
    t = _dt.datetime(1970, 1, 1) + _dt.timedelta(microseconds=naive_us)
    return int(t.replace(tzinfo=zone).utcoffset() // _dt.timedelta(
        microseconds=1))


def _zone_hours(cols, zone_name):
    """(each distinct UTC hour's start and its local start in the zone,
    as int64 microseconds; each row's index into them)."""
    def make():
        zone = _zone_of(zone_name)
        hours, inv = _runs(_ts(cols) // _US_HOUR)
        utc = hours * _US_HOUR
        off = np.array([int(_dt.datetime.fromtimestamp(
            int(h) * 3600, _dt.timezone.utc).astimezone(zone).utcoffset()
            // _dt.timedelta(microseconds=1)) for h in hours], np.int64)
        return utc, utc + off, inv
    return cols.shared(("zone", zone_name), make)


def _zoned_map(cols, zone_name, local_fn):
    """Each row's instant moved by `local_fn` in local time: local_fn
    takes a distinct hour's local start (a naive datetime) and gives the
    local start of the hour its rows move to; the result is that local
    time (the row's minutes kept) back in UTC."""
    def make():
        zone = _zone_of(zone_name)
        utc, local, inv = _zone_hours(cols, zone_name)
        out = np.empty(len(utc), np.int64)
        epoch = _dt.datetime(1970, 1, 1)
        for i, lh in enumerate(local.tolist()):
            moved = local_fn(epoch + _dt.timedelta(microseconds=lh))
            m = int((moved - epoch) // _dt.timedelta(microseconds=1))
            out[i] = m - _local_offset_us(m, zone) - utc[i]
        return out, inv
    return cols.shared(("zoned", zone_name, local_fn), make)


def _moved(cols, zone_name, local_fn, keep_minutes=True):
    shift, inv = _zoned_map(cols, zone_name, local_fn)
    ts = _ts(cols)
    if keep_minutes:
        return ts + shift[inv]
    return (ts // _US_HOUR) * _US_HOUR + shift[inv]


def _start_of_day(t):
    return t.replace(hour=0)


def _start_of_month(t):
    return t.replace(day=1, hour=0)


def _to_month_end(t):
    return t.replace(day=_days_in_month(t.date()))


def _to_month_start(t):
    return t.replace(day=1)


def _np_zone(zone_name, kind):
    def run(cols):
        if kind == "hour":
            utc, local, inv = _zone_hours(cols, zone_name)
            return (local // _US_HOUR % 24)[inv]
        if kind == "truncate_day":
            return _moved(cols, zone_name, _start_of_day, False)
        if kind == "truncate_month":
            return _moved(cols, zone_name, _start_of_month, False)
        if kind == "month_end":
            return _moved(cols, zone_name, _to_month_end)
        if kind == "month_start":
            return _moved(cols, zone_name, _to_month_start)
        assert kind == "strftime"
        # the local wall time formatted: both packages give %z as ""
        zone = _zone_of(zone_name)
        mins, inv = _runs(_ts(cols) // 60_000_000)
        return Coded(inv, [_dt.datetime.fromtimestamp(
            int(m) * 60, _dt.timezone.utc).astimezone(zone).replace(
                tzinfo=None).strftime("%Y-%m-%d %H:%M %z") for m in mins])
    return run


# --- strings, by their distinct values

def _ascii_codes(arr):
    """(codes, distinct strings) of a fixed-width ASCII numpy string array
    of at most 8 characters, with one integer sort."""
    a = np.ascontiguousarray(np.asarray(arr))
    width = a.dtype.itemsize // 4
    assert a.dtype.kind == "U" and width <= 8
    chars = a.view(np.uint32).reshape(len(a), width).astype(np.uint64)
    assert (chars < 128).all()
    key = np.zeros(len(a), np.uint64)
    for c in range(width):
        key = (key << np.uint64(8)) | chars[:, c]
    distinct, first, inv = np.unique(key, return_index=True,
                                     return_inverse=True)
    return inv.ravel(), a[first].tolist()


def _np_list_join(cols):
    """cond split at blanks, joined by "-": cond with "-" for each
    blank."""
    codes, texts = cols.shared("cond", lambda: _ascii_codes(cols["cond"]))
    return Coded(codes, [t.replace(" ", "-") for t in texts])


def _np_json_encode(cols):
    """The object {"ex": ex, "volume": volume % 100} of each row."""
    import json
    ex_code, ex = cols.shared("ex", lambda: _ascii_codes(cols["ex"]))
    code = ex_code.astype(np.int64) * 100 + np.asarray(cols["volume"]) % 100
    seen = np.flatnonzero(np.bincount(code))
    slot = np.zeros(seen[-1] + 1, np.int64)
    slot[seen] = np.arange(len(seen))
    return Coded(slot[code], [json.dumps({"ex": ex[c // 100],
                                          "volume": int(c % 100)})
                              for c in seen.tolist()])


# --- the trades' lists: lst is int_ranges(v % 3, v % 3 + 1 + v % 4), the
# run of L = 1 + v % 4 integers from a = v % 3 (v the volume)

def _lst(cols):
    def make():
        v = np.asarray(cols["volume"]).astype(np.int64)
        return v % 3, 1 + v % 4
    return cols.shared("lst", make)


def _ranges(start, length):
    """The flattened lists of `length[i]` consecutive integers from
    `start[i]`."""
    offs = np.cumsum(length) - length
    return np.arange(int(length.sum())) - np.repeat(offs - start, length)


def _list_leaves(start, length):
    return {".len": (length, None), ".values": (_ranges(start, length),
                                                None)}


def _np_set_union(cols):
    """lst with lst + 1: a .. a + L."""
    a, n = _lst(cols)
    return _list_leaves(a, n + 1)


def _np_set_intersection(cols):
    """a + 1 .. a + L - 1."""
    a, n = _lst(cols)
    return _list_leaves(a + 1, n - 1)


def _np_set_difference(cols):
    """lst less lst + 1: [a]."""
    a, n = _lst(cols)
    return _list_leaves(a, np.ones_like(n))


def _np_set_symmetric_difference(cols):
    """[a, a + L]."""
    a, n = _lst(cols)
    return {".len": (np.full_like(n, 2), None),
            ".values": (np.stack([a, a + n], 1).ravel(), None)}


def _np_list_concat(cols):
    """lst with itself: each run twice."""
    a, n = _lst(cols)
    return _list_leaves(np.repeat(a, 2), np.repeat(n, 2)) | {
        ".len": (2 * n, None)}


def _np_list_unique(cols):
    a, n = _lst(cols)
    return _list_leaves(a, n)


def _np_list_n_unique(cols):
    return _lst(cols)[1]


def _np_list_explode(cols):
    a, n = _lst(cols)
    return _ranges(a, n)


def _np_list_sort_desc(cols):
    a, n = _lst(cols)
    return {".len": (n, None),
            ".values": (2 * np.repeat(a, n) + np.repeat(n, n) - 1
                        - _ranges(a, n), None)}


def _np_list_median(cols):
    a, n = _lst(cols)
    return a + (n - 1) / 2.0


# --- the numeric frames

def _x_order(cols):
    """x's order as the port sorts it, (its null rows first in row order
    and then its valid rows by value, the valid values in order): x has
    no two equal valid values at these sizes (checked), so numpy's
    unstable sort gives the stable order."""
    def make():
        vals, valid = _vv(cols["x"])
        idx = np.flatnonzero(valid)
        o = idx[np.argsort(vals[idx])]
        s = vals[o]
        assert not (s[1:] == s[:-1]).any(), "x has equal values"
        return np.concatenate([np.flatnonzero(~valid), o]), s
    return cols.shared("x_order", make)


def _np_sort_desc(cols):
    """x.sort(descending=True): the nulls, then the valid values down."""
    order, s = _x_order(cols)
    nulls = len(order) - len(s)
    vals = np.concatenate([cols["x"][0][order[:nulls]], s[::-1]])
    return _nullable(vals, np.arange(len(order)) >= nulls)


def _np_arg_sort(cols):
    return _x_order(cols)[0].astype(np.uint32)


def _np_sort_by(cols):
    order, _ = _x_order(cols)
    vals, valid = _vv(cols["i"])
    return _nullable(vals[order], valid[order])


def _k_rows(cols, k, largest):
    order, s = _x_order(cols)
    valid_rows = order[len(order) - len(s):]
    return valid_rows[::-1][:k] if largest else valid_rows[:k]


def _np_top_k(cols):
    return cols["x"][0][_k_rows(cols, 100, True)]


def _np_bottom_k(cols):
    return cols["x"][0][_k_rows(cols, 100, False)]


def _np_top_k_by(cols):
    return cols["g"][0][_k_rows(cols, 100, True)]


def _np_bottom_k_by(cols):
    return cols["g"][0][_k_rows(cols, 100, False)]


def _np_search_sorted(cols):
    order, s = _x_order(cols)
    return np.array([len(order) - len(s) + np.searchsorted(s, 50.0)],
                    dtype=np.uint32)


def _np_rank(cols):
    """The average rank of each valid value (a tie-free rank is its
    position among the valid values)."""
    order, s = _x_order(cols)
    rank = np.zeros(len(order))
    rank[order[len(order) - len(s):]] = np.arange(1, len(s) + 1)
    return _nullable(rank, _vv(cols["x"])[1])


def _np_arg_sort_by(cols):
    """arg_sort_by(["j", "x"]): x's order, stably by j (a radix sort of
    its 8-bit codes)."""
    order, _ = _x_order(cols)
    j = cols["j"][0][order]
    return order[np.argsort((j - j.min()).astype(np.uint8),
                            kind="stable")].astype(np.uint32)


def _np_quantile(q, interp="nearest"):
    def run(cols):
        s = _x_order(cols)[1]
        pos = q * (len(s) - 1)
        if interp == "nearest":
            val = s[int(np.round(pos))]
        else:
            lo, hi = s[int(np.floor(pos))], s[int(np.ceil(pos))]
            val = (lo + hi) / 2 if q == 0.5 else \
                lo * (1 - (pos - np.floor(pos))) + hi * (pos - np.floor(pos))
        return np.array([val])
    return run


def _key_groups(cols, key):
    """The rows grouped by a small integer key (under 256 values; a null
    key is a group of its own, first): (the rows in stable key order,
    each group's [start, end) in it), by one radix sort."""
    def make():
        vals, valid = _vv(cols[key])
        v = vals.astype(np.int64)
        code = np.where(valid, v - v.min() + 1, 0)
        assert code.max() < 256
        order = np.argsort(code.astype(np.uint8), kind="stable")
        counts = np.bincount(code)
        return order, np.concatenate([[0], np.cumsum(counts[counts > 0])])
    return cols.shared(("groups", key), make)


def _seg_accumulate(cols, key, x, ufunc):
    """A running ufunc of x that restarts at each group of `key`, in row
    order."""
    order, bounds = _key_groups(cols, key)
    xs = x[order]
    for a, b in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        ufunc.accumulate(xs[a:b], out=xs[a:b])
    out = np.empty_like(xs)
    out[order] = xs
    return out


def _np_cum_over(col, key, ufunc, fill):
    def run(cols):
        vals, valid = _vv(cols[col])
        return _nullable(_seg_accumulate(cols, key, np.where(valid, vals,
                                                             fill), ufunc),
                         valid)
    return run


def _np_cum_prod_over(cols):
    v = (cols["j"][0] % 2 * 2 - 1).astype(np.int64)
    return _seg_accumulate(cols, "i", v, np.multiply)


def _np_cum_count_over(cols):
    _, valid = _vv(cols["x"])
    return _seg_accumulate(cols, "j", valid.astype(np.uint32), np.add)


def _np_over_sum_j(cols):
    """x.sum().over("j"): each row its partition's sum (nulls skipped)."""
    xv, xm = _vv(cols["x"])
    j = cols["j"][0].astype(np.int64)
    sums = np.bincount(j, weights=np.where(xm, xv, 0.0))
    return sums[j]


def _np_over_float_key(cols):
    """k.sum().over("x"): x has no ties among its valid values, so each
    valid row is a partition of its own; the null rows are one."""
    kv = cols["k"][0].astype(np.int64)
    _, xm = _vv(cols["x"])
    out = kv.copy()
    out[~xm] = kv[~xm].sum()
    return out


def _np_over_float_key_rank(cols):
    """j.rank("ordinal").over("x"): 1 in a singleton partition; the null
    rows' ordinal ranks of j among themselves."""
    jv = cols["j"][0]
    _, xm = _vv(cols["x"])
    out = np.ones(len(jv), np.uint32)
    idx = np.flatnonzero(~xm)
    r = np.empty(len(idx), np.uint32)
    r[np.argsort(jv[idx], kind="stable")] = np.arange(1, len(idx) + 1)
    out[idx] = r
    return out


def _np_cum_extreme(ufunc, fill, reverse=False):
    def run(cols):
        vals, valid = _vv(cols["x"])
        x = np.where(valid, vals, fill)
        out = ufunc.accumulate(x[::-1])[::-1] if reverse else \
            ufunc.accumulate(x)
        return _nullable(out, valid)
    return run


def _np_implode(cols):
    vals, valid = _vv(cols["i"])
    return {".len": (np.array([len(vals)], np.int64), None),
            ".values": _nullable(vals, valid)}


def _np_flatten(cols):
    return _nullable(*_vv(cols["i"]))


def _first_last(cols, key):
    order, bounds = _key_groups(cols, key)
    return order[bounds[:-1]], order[bounds[1:] - 1]


def _marks(n, rows):
    out = np.zeros(n, bool)
    out[rows] = True
    return out


def _np_arg_unique(cols):
    return np.sort(_first_last(cols, "i")[0]).astype(np.uint32)


def _np_is_first_distinct(cols):
    return _marks(len(cols["i"][0]), _first_last(cols, "i")[0])


def _np_is_last_distinct(cols):
    return _marks(len(cols["i"][0]), _first_last(cols, "i")[1])


def _np_counts(cols, col):
    v = cols[col][0].astype(np.int64)
    return np.bincount(v)[v]


def _np_is_duplicated(cols):
    return _np_counts(cols, "g") > 1


def _np_is_unique(cols):
    return _np_counts(cols, "g") == 1


def _ewm_sums(cols, alpha):
    """The weighted sums of ewm_* with adjust=True over x's valid values
    (a null row stays null and does not age the weights), by scipy's
    linear filter: (weights, weights squared, values, squares)."""
    def make():
        from scipy.signal import lfilter
        vals, valid = _vv(cols["x"])
        v = vals[valid]
        a = [1.0, -(1.0 - alpha)]
        return (lfilter([1.0], a, np.ones(len(v))),
                lfilter([1.0], [1.0, -(1.0 - alpha) ** 2], np.ones(len(v))),
                lfilter([1.0], a, v), lfilter([1.0], a, v * v))
    return cols.shared(("ewm", alpha), make)


def _np_ewm(kind, alpha=0.1):
    """ewm_mean/var/std(alpha), var and std unbiased."""
    def run(cols):
        sw, sw2, sx, sxx = _ewm_sums(cols, alpha)
        mean = sx / sw
        out = mean
        if kind != "mean":
            biased = sxx / sw - mean * mean
            den = sw * sw - sw2
            with np.errstate(divide="ignore", invalid="ignore"):
                var = np.where(den > 0, biased * sw * sw / den, 0.0)
            out = np.sqrt(np.maximum(var, 0.0)) if kind == "std" else var
        vals, valid = _vv(cols["x"])
        full = np.zeros(len(vals))
        full[valid] = out
        return _nullable(full, valid)
    return run


def _window_order(cols, w=20):
    """Each row's trailing window of w rows of x, sorted, and the average
    rank of its last value among it; whether it holds w valid rows."""
    def make():
        from numpy.lib.stride_tricks import sliding_window_view
        vals, valid = _vv(cols["x"])
        ok = np.zeros(len(vals), bool)
        ok[w - 1:] = sliding_window_view(valid, w).all(axis=1)
        win = sliding_window_view(vals, w)
        last = win[:, -1:]
        rank = (win < last).sum(axis=1) + ((win == last).sum(axis=1) + 1) / 2
        return ok, np.sort(win, axis=1), rank
    return cols.shared(("window_order", w), make)


def _np_rolling(kind, w=20):
    """rolling_median(w) (linear), rolling_quantile(0.25, w) (nearest:
    the order statistic round(0.25 (w - 1)) = 5) and rolling_rank(w)
    (average); a window with a null is null."""
    assert w == 20

    def run(cols):
        ok, srt, rank = _window_order(cols, w)
        val = {"median": (srt[:, 9] + srt[:, 10]) / 2,
               "quantile": srt[:, 5], "rank": rank}[kind]
        out = np.zeros(len(ok))
        out[w - 1:] = val
        return _nullable(out, ok)
    return run


def _np_agg_groups(cols):
    """k.agg_groups() by j (maintain_order): each group's row indices."""
    order, bounds = _key_groups(cols, "j")
    firsts = order[bounds[:-1]]
    seq = np.argsort(firsts)
    j = cols["j"][0]
    return {"j": (j[firsts[seq]], None),
            "k.len": (np.diff(bounds)[seq].astype(np.int64), None),
            "k.values": (np.concatenate([order[bounds[s]:bounds[s + 1]]
                                         for s in seq]).astype(np.uint32),
                         None)}


def _np_date(cols):
    """pl.date(2024, j, k): days since 1970-01-01."""
    j, k = cols["j"][0].astype(np.int64), cols["k"][0].astype(np.int64)
    first = np.array([(_dt.date(2024, m, 1) - _dt.date(1970, 1, 1)).days
                      for m in range(1, 13)], np.int64)
    return first[j - 1] + k - 1


# --- more closed forms: the numeric frame's row and bit operations, the
# trades' calendar fields and lists (each one numpy pass or a few)

def _c(cols, name):
    return _vv(cols[name])


def _np_set_sorted(cols):
    return np.sort(cols["g"][0])


def _np_n_unique(cols):
    return np.array([np.count_nonzero(np.bincount(cols["g"][0]))])


def _np_rle_id(cols):
    j = cols["j"][0]
    return np.cumsum(np.r_[False, j[1:] != j[:-1]])


def _np_rle(cols):
    j = cols["j"][0]
    start = np.flatnonzero(np.r_[True, j[1:] != j[:-1]])
    return {".len": (np.diff(np.r_[start, len(j)]), None),
            ".value": (j[start], None)}


def _np_format(cols):
    """format("{}-{}", j, k): j and k (1..5, 1..15) as one code."""
    code = cols["j"][0].astype(np.int64) * 16 + cols["k"][0]
    return Coded(code, [f"{c // 16}-{c % 16}" for c in range(6 * 16)])


def _np_fill(forward):
    def run(cols):
        vals, valid = _c(cols, "i")
        n = len(vals)
        if forward:
            at = np.maximum.accumulate(np.where(valid, np.arange(n), -1))
        else:
            at = np.minimum.accumulate(np.where(valid, np.arange(n),
                                                n)[::-1])[::-1]
        ok = (at >= 0) & (at < n)
        return _nullable(vals[np.clip(at, 0, n - 1)], ok)
    return run


def _np_interpolate(cols):
    """i linearly between its valid neighbours, Float64; the nulls before
    the first valid row and after the last stay null."""
    vals, valid = _c(cols, "i")
    idx = np.flatnonzero(valid)
    out = np.interp(np.arange(len(vals)), idx, vals[idx].astype(np.float64))
    ok = valid.copy()
    ok[idx[0]:idx[-1] + 1] = True
    return _nullable(out, ok)


def _np_is_close(cols):
    """(x / 7 * 7).is_close(x): rel_tol 1e-9."""
    x, valid = _c(cols, "x")
    a = x / 7 * 7
    return _nullable(np.abs(a - x) <= 1e-9 * np.maximum(np.abs(a),
                                                         np.abs(x)), valid)


def _bit_length(v):
    """The bit length of non-negative int64 values under 2^53."""
    v = np.asarray(v, np.int64)
    return np.where(v > 0, np.frexp(v.astype(np.float64))[1], 0)


def _np_bits(kind):
    """The bit counts of g (positive, in its dtype's width) or of -g."""
    def run(cols):
        bits = cols["g"][0].dtype.itemsize * 8
        g = cols["g"][0].astype(np.int64)
        if kind == "count_ones":
            v = g.astype(np.uint32)
            v = v - ((v >> 1) & 0x55555555)
            v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
            v = (v + (v >> 4)) & 0x0F0F0F0F
            return (v * 0x01010101 & 0xFFFFFFFF) >> 24
        if kind == "count_zeros":
            return bits - _np_bits("count_ones")(cols)
        if kind == "leading_zeros":
            return bits - _bit_length(g)
        if kind == "leading_ones":        # of -g: ~(-g) is g - 1
            return bits - _bit_length(g - 1)
        if kind == "trailing_zeros":
            return _bit_length(g & -g) - 1
        assert kind == "trailing_ones"    # of g: the trailing zeros of ~g
        ng = ~g
        return _bit_length(ng & -ng) - 1
    return run


def _np_rows(col, pick):
    def run(cols):
        vals, valid = _c(cols, col)
        return _nullable(pick(vals), pick(valid))
    return run


def _np_shift3(cols):
    vals, valid = _c(cols, "x")
    return _nullable(np.r_[np.zeros(3), vals[:-3]],
                     np.r_[np.zeros(3, bool), valid[:-3]])


def _np_append(cols):
    vals, valid = _c(cols, "i")
    j = cols["j"][0]
    return _nullable(np.r_[vals, j], np.r_[valid, np.ones(len(j), bool)])


def _np_extend_constant(cols):
    vals, valid = _c(cols, "i")
    return _nullable(np.r_[vals, np.full(5, 7, vals.dtype)],
                     np.r_[valid, np.ones(5, bool)])


def _np_filter_x(cols):
    keep = cols["j"][0] > 2
    vals, valid = _c(cols, "x")
    return _nullable(vals[keep], valid[keep])


def _np_cum_count(cols):
    return np.cumsum(_c(cols, "i")[1])


def _np_sign_prod(cum):
    """_sign(j) (+1 or -1 by j's parity): its running or whole product."""
    def run(cols):
        neg = cols["j"][0] % 2 == 0
        if cum:
            return np.where(np.cumsum(neg) % 2 == 1, -1, 1)
        return np.array([-1 if int(neg.sum()) % 2 else 1])
    return run


def _np_repeat_by(cols):
    j, k = cols["j"][0].astype(np.int64), cols["k"][0]
    return {".len": (j, None), ".values": (np.repeat(k, j), None)}


def _np_reshape(cols):
    vals, valid = _c(cols, "x")
    return {".len": (np.full(len(vals) // 2, 2), None),
            ".values": _nullable(vals, valid)}


def _np_mode(cols):
    return np.array([np.argmax(np.bincount(cols["j"][0]))])


def _np_index_of(cols):
    hit = np.flatnonzero(cols["g"][0] == 77)
    return (np.array([hit[0]]), None) if len(hit) else \
        (np.zeros(1), np.zeros(1, bool))


def _np_arg_extreme(largest):
    def run(cols):
        vals, valid = _c(cols, "x")
        fill = -np.inf if largest else np.inf
        x = np.where(valid, vals, fill)
        return np.array([np.argmax(x) if largest else np.argmin(x)])
    return run


def _np_diff(cols):
    vals, valid = _c(cols, "x")
    return _nullable(np.r_[0.0, vals[1:] - vals[:-1]],
                     np.r_[False, valid[1:] & valid[:-1]])


def _np_fill_nan(cols):
    vals, valid = _c(cols, "x")
    with np.errstate(invalid="ignore"):
        r = np.sqrt(vals - 50)
    return _nullable(np.where(np.isnan(r), -1.0, r), valid)


def _np_int_ranges(cols):
    j = cols["j"][0].astype(np.int64)
    return _list_leaves(np.zeros_like(j), j)


# the trades' calendar: naive ts, its Date d, its New York instant tsz

def _np_ts_field(kind):
    def run(cols):
        t = _ts(cols)
        return {"minute": lambda: t // 60_000_000 % 60,
                "second": lambda: t // 1_000_000 % 60,
                "millisecond": lambda: t // 1000 % 1000,
                "microsecond": lambda: t % 1_000_000,
                "nanosecond": lambda: t % 1_000_000 * 1000,
                "epoch": lambda: t // 1_000_000,
                "timestamp": lambda: t // 1000,
                "cast_time_unit": lambda: t // 1000,
                "with_time_unit": lambda: t,
                "truncate": lambda: t - t % _US_HOUR,
                "to_time": lambda: t % _US_DAY // 1_000_000
                * 1_000_000_000}[kind]()
    return run


def _np_day_field(kind):
    def run(cols):
        return _by_day(cols, {
            "days_in_month": _days_in_month,
            "century": lambda d: (d.year - 1) // 100 + 1,
            "millennium": lambda d: (d.year - 1) // 1000 + 1,
            "is_leap_year": lambda d: d.year % 4 == 0 and (
                d.year % 100 != 0 or d.year % 400 == 0),
            "ordinal_day": lambda d: d.timetuple().tm_yday,
            "quarter": lambda d: (d.month - 1) // 3 + 1}[kind])
    return run


def _np_replace_day1_hour0(cols):
    """ts.dt.replace(day=1, hour=0): the minutes on kept."""
    t = _ts(cols)
    day = _by_day(cols, lambda d: d.day)
    return t - (day - 1) * _US_DAY - t % _US_DAY // _US_HOUR * _US_HOUR


def _np_ny(kind):
    """tsz (ts in America/New_York): its local date, time (ns), naive
    local datetime, minutes as text, base and DST offsets (ms)."""
    def run(cols):
        z = "America/New_York"
        utc, local, inv = _zone_hours(cols, z)
        t = _ts(cols)
        loc = t + (local - utc)[inv]
        if kind == "date":
            return loc // _US_DAY
        if kind == "time":
            return loc % _US_DAY * 1000
        if kind == "datetime":             # the instant, its zone kept
            return t
        if kind == "to_string":
            mins, mi = _runs(loc // 60_000_000)
            epoch = _dt.datetime(1970, 1, 1)
            return Coded(mi, [(epoch + _dt.timedelta(minutes=int(m)))
                              .strftime("%Y-%m-%d %H:%M:%S") for m in mins])
        raise AssertionError(kind)
    return run


def _np_dst(zone_name, kind="dst"):
    """The zone's DST offset (or its base offset) in ms, an hour at a
    time."""
    def run(cols):
        zone = _zone_of(zone_name)
        utc, _, inv = _zone_hours(cols, zone_name)

        def ms(h):
            t = _dt.datetime.fromtimestamp(int(h) // _US_HOUR * 3600,
                                           _dt.timezone.utc).astimezone(zone)
            d = t.dst() if kind == "dst" else t.utcoffset() - t.dst()
            return int(d // _dt.timedelta(milliseconds=1))
        return np.array([ms(h) for h in utc], np.int64)[inv]
    return run


def _np_list(kind):
    """A list op of lst (the run of L integers from a) from a and L."""
    def run(cols):
        a, n = _lst(cols)
        if kind in ("mean", "var", "std"):
            if kind == "mean":
                return a + (n - 1) / 2.0
            var = n * (n + 1) / 12.0
            return _nullable(var if kind == "var" else np.sqrt(var), n > 1)
        if kind in ("first", "get", "min", "item"):
            return a
        if kind in ("last", "max"):
            return a + n - 1
        if kind == "arg_min":
            return np.zeros_like(n)
        if kind == "arg_max":
            return n - 1
        if kind == "len":
            return n
        if kind == "contains":
            return (a <= 2) & (2 < a + n)
        if kind == "count_matches":
            return ((a <= 1) & (1 < a + n)).astype(np.int64)
        if kind == "all":
            return a > 0
        if kind == "any":
            return a + n - 1 > 2
        if kind == "eval":
            return _map_values(_list_leaves(a, n), lambda v: 2 * v + 1)
        if kind == "agg":
            return _map_values(_list_leaves(a, n), lambda v: 3 * v)
        if kind == "element":
            return _map_values(_list_leaves(a, n), lambda v: v % 2 == 0)
        if kind == "filter":
            lo = np.maximum(a, 2)
            return _list_leaves(lo, np.maximum(a + n - lo, 0))
        if kind == "head":
            return _list_leaves(a, np.minimum(n, 2))
        if kind == "tail":
            m = np.minimum(n, 2)
            return _list_leaves(a + n - m, m)
        if kind == "slice":
            return _list_leaves(a + 1, np.clip(n - 1, 0, 2))
        if kind in ("diff", "shift"):
            first = np.zeros(int(n.sum()), bool)
            first[np.cumsum(n) - n] = True
            vals = np.where(first, 0, np.ones(len(first), np.int64)) \
                if kind == "diff" else _ranges(a, n) - 1
            return {".len": (n, None), ".values": (vals, ~first)}
        if kind == "gather":
            third = n > 2
            vals = np.stack([a, a + 2], 1).ravel()
            ok = np.stack([np.ones_like(third), third], 1).ravel()
            return {".len": (np.full_like(n, 2), None),
                    ".values": (vals, ok)}
        if kind == "drop_nulls":
            m = 1 + (n > 3)
            vals = np.stack([a, a + 3], 1).ravel()
            keep = np.stack([np.ones_like(n, bool), n > 3], 1).ravel()
            return {".len": (m, None), ".values": (vals[keep], None)}
        if kind == "to_array":
            return {".len": (np.ones_like(n), None), ".values": (a, None)}
        if kind == "to_struct":
            out = {".valid": (np.ones(len(n), bool), None)}
            for i, f in enumerate("abc"):
                out["." + f] = _nullable(a + i, n > i)
            return out
        raise AssertionError(kind)
    return run


def _map_values(leaves, fn):
    (vals, valid) = leaves[".values"]
    return {**leaves, ".values": (fn(vals), valid)}


def _np_arr_to_list(cols):
    v = np.asarray(cols["volume"]).astype(np.int64)
    return {".len": (np.full_like(v, 3), None),
            ".values": (np.stack([v, v % 7, v // 3], 1).ravel(), None)}


def _np_concat_list(cols):
    v = np.asarray(cols["volume"]).astype(np.int64)
    return {".len": (np.full_like(v, 2), None),
            ".values": (np.stack([v, v % 7], 1).ravel(), None)}


def _np_date_ranges(cols):
    """date_ranges(d, d + 3 days): the 4 days from each row's."""
    d = _ts(cols) // _US_DAY
    return _list_leaves(d, np.full_like(d, 4))


def _np_datetime_ranges(cols):
    """datetime_ranges(ts, ts + 3h, "1h"): 4 instants an hour apart."""
    t = _ts(cols)
    return {".len": (np.full_like(t, 4), None),
            ".values": ((t[:, None] + _US_HOUR * np.arange(4)).ravel(),
                        None)}


MORE_ORACLES = {
    "set_sorted": _np_set_sorted, "n_unique": _np_n_unique,
    "rle_id": _np_rle_id, "rle": _np_rle, "format": _np_format,
    "forward_fill": _np_fill(True), "backward_fill": _np_fill(False),
    "interpolate": _np_interpolate, "is_close": _np_is_close,
    **{f"bitwise_{k}": _np_bits(k)
       for k in ("count_ones", "count_zeros", "leading_zeros",
                 "leading_ones", "trailing_zeros", "trailing_ones")},
    "head_x": _np_rows("x", lambda a: a[:100]),
    "tail_x": _np_rows("x", lambda a: a[-100:]),
    "slice_x": _np_rows("x", lambda a: a[100:1100]),
    "gather_every_x": _np_rows("x", lambda a: a[3::7]),
    "reverse_x": _np_rows("x", lambda a: a[::-1]),
    "head10_x": _np_rows("x", lambda a: a[:10]),
    "tail10_x": _np_rows("x", lambda a: a[-10:]),
    "shift3": _np_shift3, "append": _np_append,
    "extend_constant": _np_extend_constant, "filter_x": _np_filter_x,
    "cum_count": _np_cum_count, "cum_prod": _np_sign_prod(True),
    "product": _np_sign_prod(False), "repeat_by": _np_repeat_by,
    "reshape": _np_reshape, "mode": _np_mode, "index_of": _np_index_of,
    "arg_max": _np_arg_extreme(True), "arg_min": _np_arg_extreme(False),
    "diff": _np_diff, "fill_nan": _np_fill_nan,
    "int_ranges": _np_int_ranges,
    **{f"dt_{k}": _np_ts_field(k)
       for k in ("minute", "second", "millisecond", "microsecond",
                 "nanosecond", "epoch", "timestamp", "cast_time_unit",
                 "with_time_unit", "truncate", "to_time")},
    **{f"dt_{k}": _np_day_field(k)
       for k in ("days_in_month", "century", "millennium", "is_leap_year",
                 "ordinal_day", "quarter")},
    "dt_replace": _np_replace_day1_hour0,
    **{f"ny_{k}": _np_ny(k) for k in ("date", "time", "datetime",
                                      "to_string")},
    "ny_base_utc_offset": _np_dst("America/New_York", "base"),
    **{f"{z.split('/')[1].lower()}_dst_offset": _np_dst(z)
       for z in ("America/New_York", "Europe/London", "Asia/Tokyo",
                 "Australia/Sydney")},
    **{f"list_{k}": _np_list(k)
       for k in ("mean", "var", "std", "first", "get", "min", "item",
                 "last", "max", "arg_min", "arg_max", "len", "contains",
                 "count_matches", "all", "any", "eval", "agg", "element",
                 "filter", "head", "tail", "slice", "diff", "shift",
                 "gather", "drop_nulls", "to_array", "to_struct")},
    "arr_to_list": _np_arr_to_list, "concat_list": _np_concat_list,
    "date_ranges": _np_date_ranges, "datetime_ranges": _np_datetime_ranges,
}

MORE_OF = {
    "Expr.set_sorted": "set_sorted", "Expr.n_unique": "n_unique",
    "top.n_unique": "n_unique", "Expr.approx_n_unique": "n_unique",
    "top.approx_n_unique": "n_unique", "Expr.rle_id": "rle_id",
    "Expr.rle": "rle", "top.format": "format",
    "Expr.forward_fill": "forward_fill",
    "Expr.backward_fill": "backward_fill",
    "Expr.interpolate": "interpolate", "Expr.is_close": "is_close",
    **{f"Expr.bitwise_{k}": f"bitwise_{k}"
       for k in ("count_ones", "count_zeros", "leading_zeros",
                 "leading_ones", "trailing_zeros", "trailing_ones")},
    "Expr.head": "head_x", "Expr.limit": "head_x", "Expr.tail": "tail_x",
    "Expr.slice": "slice_x", "Expr.gather_every": "gather_every_x",
    "Expr.reverse": "reverse_x", "top.head": "head10_x",
    "top.tail": "tail10_x", "Expr.shift": "shift3",
    "Expr.append": "append", "Expr.extend_constant": "extend_constant",
    "Expr.filter": "filter_x", "Expr.cum_count": "cum_count",
    "top.cum_count": "cum_count", "Expr.cum_prod": "cum_prod",
    "Expr.product": "product", "Expr.repeat_by": "repeat_by",
    "Expr.reshape": "reshape", "Expr.mode": "mode",
    "Expr.index_of": "index_of", "Expr.arg_max": "arg_max",
    "Expr.arg_min": "arg_min", "Expr.diff": "diff",
    "Expr.fill_nan": "fill_nan", "top.int_ranges": "int_ranges",
    **{f"dt.{k}": f"dt_{k}"
       for k in ("minute", "second", "millisecond", "microsecond",
                 "nanosecond", "epoch", "timestamp", "cast_time_unit",
                 "with_time_unit", "truncate", "days_in_month", "century",
                 "millennium", "is_leap_year", "ordinal_day", "quarter",
                 "replace")},
    "str.to_time": "dt_to_time",
    **{f"dt.{k}": f"ny_{k}" for k in ("date", "time", "datetime",
                                      "to_string", "base_utc_offset")},
    "dt.dst_offset": "new_york_dst_offset",
    **{f"variant.{z}_dst_offset": f"{z}_dst_offset"
       for z in ("new_york", "london", "tokyo", "sydney")},
    **{f"list.{k}": f"list_{k}"
       for k in ("mean", "var", "std", "first", "get", "min", "item",
                 "last", "max", "arg_min", "arg_max", "len", "contains",
                 "count_matches", "all", "any", "eval", "agg", "filter",
                 "head", "tail", "slice", "diff", "shift", "gather",
                 "drop_nulls", "to_array", "to_struct")},
    "top.element": "list_element", "list.to_list": "arr_to_list",
    "top.concat_list": "concat_list", "top.date_ranges": "date_ranges",
    "top.datetime_ranges": "datetime_ranges",
}


NUMPY_ORACLES = {
    "year": _np_year, "month": _np_month, "day": _np_day,
    "weekday": _np_weekday, "iso_year": _np_iso_year, "week": _np_week,
    "month_end": _np_month_end, "strftime": _np_strftime,
    "hour": _np_zone("America/New_York", "hour"),
    "month_start": _np_zone("America/New_York", "month_start"),
    "list_join": _np_list_join, "json_encode": _np_json_encode,
    "set_union": _np_set_union, "set_intersection": _np_set_intersection,
    "set_difference": _np_set_difference,
    "set_symmetric_difference": _np_set_symmetric_difference,
    "list_concat": _np_list_concat, "list_unique": _np_list_unique,
    "list_n_unique": _np_list_n_unique, "list_explode": _np_list_explode,
    "list_sort": _np_list_sort_desc, "list_median": _np_list_median,
    "sort": _np_sort_desc, "arg_sort": _np_arg_sort,
    "top_k": _np_top_k, "bottom_k": _np_bottom_k,
    "top_k_by": _np_top_k_by, "bottom_k_by": _np_bottom_k_by,
    "sort_by": _np_sort_by, "search_sorted": _np_search_sorted,
    "rank": _np_rank, "arg_sort_by": _np_arg_sort_by,
    "over": _np_over_sum_j,
    "over_float_key": _np_over_float_key,
    "over_float_key_rank": _np_over_float_key_rank,
    "cum_sum_over": _np_cum_over("x", "j", np.add, 0.0),
    "cum_max_over": _np_cum_over("x", "j", np.maximum, -np.inf),
    "cum_min_over": _np_cum_over("x", "i", np.minimum, np.inf),
    "cum_prod_over": _np_cum_prod_over,
    "cum_count_over": _np_cum_count_over,
    "cum_sum": _np_cum_extreme(np.add, 0.0),
    "cum_max": _np_cum_extreme(np.maximum, -np.inf),
    "cum_min": _np_cum_extreme(np.minimum, np.inf, True),
    "implode": _np_implode, "flatten": _np_flatten,
    "arg_unique": _np_arg_unique,
    "is_first_distinct": _np_is_first_distinct,
    "is_last_distinct": _np_is_last_distinct,
    "is_duplicated": _np_is_duplicated, "is_unique": _np_is_unique,
    "median": _np_quantile(0.5, "linear"),
    "quantile_0.9": _np_quantile(0.9), "quantile_0.25": _np_quantile(0.25),
    "ewm_mean": _np_ewm("mean"), "ewm_var": _np_ewm("var"),
    "ewm_std": _np_ewm("std"),
    "rolling_median": _np_rolling("median"),
    "rolling_quantile": _np_rolling("quantile"),
    "rolling_rank": _np_rolling("rank"),
    "agg_groups": _np_agg_groups, "date": _np_date, **MORE_ORACLES,
    **{f"{z.split('/')[1].lower()}_{k}": _np_zone(z, k)
       for z in ("America/New_York", "Europe/London", "Asia/Tokyo",
                 "Australia/Sydney")
       for k in ("hour", "strftime", "truncate_day", "truncate_month",
                 "month_end")},
}

# the entries held to numpy's closed form in phase 22 (the CPU tests hold
# each form to the port's CPU result)
NUMPY_OF = {
    "Expr.sort": "sort", "Expr.arg_sort": "arg_sort", "Expr.top_k": "top_k",
    "Expr.bottom_k": "bottom_k", "Expr.top_k_by": "top_k_by",
    "Expr.bottom_k_by": "bottom_k_by", "Expr.sort_by": "sort_by",
    "Expr.search_sorted": "search_sorted", "Expr.rank": "rank",
    "top.arg_sort_by": "arg_sort_by", "Expr.over": "over",
    "variant.over_float_key": "over_float_key",
    "variant.over_float_key_rank": "over_float_key_rank",
    "variant.cum_sum_over": "cum_sum_over",
    "variant.cum_max_over": "cum_max_over",
    "variant.cum_min_over": "cum_min_over",
    "variant.cum_prod_over": "cum_prod_over",
    "variant.cum_count_over": "cum_count_over",
    "Expr.cum_max": "cum_max", "Expr.cum_min": "cum_min",
    "Expr.cum_sum": "cum_sum", "top.cum_sum": "cum_sum",
    "Expr.implode": "implode", "top.implode": "implode",
    "Expr.flatten": "flatten", "Expr.arg_unique": "arg_unique",
    "Expr.is_first_distinct": "is_first_distinct",
    "Expr.is_last_distinct": "is_last_distinct",
    "Expr.is_duplicated": "is_duplicated", "Expr.is_unique": "is_unique",
    "Expr.median": "median", "top.median": "median",
    "Expr.quantile": "quantile_0.9", "top.quantile": "quantile_0.25",
    "Expr.ewm_mean": "ewm_mean", "Expr.ewm_var": "ewm_var",
    "Expr.ewm_std": "ewm_std", "Expr.rolling_median": "rolling_median",
    "Expr.rolling_quantile": "rolling_quantile",
    "Expr.rolling_rank": "rolling_rank", "Expr.agg_groups": "agg_groups",
    "top.groups": "agg_groups", "top.date": "date",
    "dt.year": "year", "dt.month": "month", "dt.day": "day",
    "dt.hour": "hour", "dt.weekday": "weekday", "dt.strftime": "strftime",
    "dt.iso_year": "iso_year", "dt.week": "week",
    "dt.month_end": "month_end", "dt.month_start": "month_start",
    "list.join": "list_join", "struct.json_encode": "json_encode",
    "list.set_union": "set_union", "list.set_intersection":
    "set_intersection", "list.set_difference": "set_difference",
    "list.set_symmetric_difference": "set_symmetric_difference",
    "list.concat": "list_concat", "list.unique": "list_unique",
    "list.n_unique": "list_n_unique", "list.explode": "list_explode",
    "list.sort": "list_sort", "list.median": "list_median", **MORE_OF,
    **{f"variant.{z}_{k}": f"{z}_{k}"
       for z in ("new_york", "london", "tokyo", "sydney")
       for k in ("hour", "strftime", "truncate_day", "truncate_month",
                 "month_end")},
}


def numpy_form(entry: Entry, cols: Host, hole: bool = False):
    """numpy's closed form of an entry over a frame's host columns (after
    the breaker with `hole`)."""
    if hole:
        cols = cols.rows(HOLE_ROWS[entry.source](cols))
    return NUMPY_ORACLES[entry.numpy](cols)


def host_columns(source: str, cols: dict, valid: Optional[dict] = None):
    """A frame's host columns as its source's closed forms read them."""
    if source == "taq":
        return Host(cols)
    return Host({k: (v, None if valid is None else valid.get(k))
                 for k, v in cols.items()})


def numpy_leaves(entry: Entry, got: dict, out) -> dict:
    """numpy's closed form (`numpy_form`'s result) as the leaves of the
    card's result `got`, in the card's dtypes where they are integers or
    booleans."""
    keys = [k for k in got if k != "__schema__"]
    if isinstance(out, dict):
        if all(k.startswith(".") for k in out):
            (name,) = {k.split(".")[0] for k in keys}
            out = {name + k: v for k, v in out.items()}
    else:
        (k,) = keys
        out = {k: out if isinstance(out, tuple) else (out, None)}
    res = {"__schema__": got["__schema__"]}
    for k, (vals, valid) in out.items():
        g, _ = got[k]
        if valid is not None:
            valid = np.ascontiguousarray(valid)
        if not isinstance(vals, Coded):
            vals = np.ascontiguousarray(vals)
            if torch.is_tensor(g) and not g.is_floating_point():
                vals = torch.as_tensor(vals).to(g.dtype)
        res[k] = (vals, valid)
    return res


# --- running an entry and holding its result -----------------------------

class EagerQuery:
    """An eager `DataFrame.select` with the `collect()` of a lazy frame."""

    def __init__(self, frame, exprs):
        self.frame, self.exprs = frame, exprs

    def collect(self):
        return self.frame.select(self.exprs)


def query(pl, entry: Entry, frame, hole: bool = False):
    """The entry's query over `frame` (a DataFrame of the package `pl`):
    an object whose `collect()` runs it. A host UDF reads the frame's
    first `entry.prefix` rows; with `hole`, the source's breaker
    (`HOLE_FILTERS`) runs first."""
    if entry.prefix is not None:
        frame = frame.head(entry.prefix)
    e = entry.build(pl)
    if entry.context == "eager":
        if hole:
            frame = frame.filter(HOLE_FILTERS[entry.source](pl))
        return EagerQuery(frame, e)
    lf = frame.lazy()
    if hole:
        lf = lf.filter(HOLE_FILTERS[entry.source](pl))
    if entry.context == "group_by":
        return lf.group_by("j", maintain_order=True).agg(e)
    return lf.select(e)


def refusal(pl, entry: Entry, frame, hole: bool = False) -> str:
    """The error class and message a REFUSED entry raises, building or
    collecting (it must raise)."""
    try:
        query(pl, entry, frame, hole).collect()
    except Exception as exc:    # the refusal is the result held
        return f"{type(exc).__name__}: {exc}"
    raise AssertionError(f"{entry.name} was not refused")


class Coded:
    """String (Categorical, Binary) values as codes (a tensor) into their
    column's dictionary (numpy, on the host): two such are compared by
    mapping each dictionary onto the sorted union of both (a
    Categorical's keeps its categories' order, not sorted)."""

    __slots__ = ("codes", "values")

    def __init__(self, codes, values):
        self.codes = torch.as_tensor(codes)
        self.values = np.asarray(values, dtype=object)

    @property
    def shape(self):
        return tuple(self.codes.shape)

    def __len__(self):
        return len(self.codes)

    def __getitem__(self, i):
        return Coded(self.codes[i], self.values)

    def ranks(self, union: np.ndarray) -> torch.Tensor:
        """Each row's string as its position in `union` (sorted, holding
        every string of the dictionary); -1 where the code is outside the
        dictionary."""
        codes = self.codes.to(torch.int64)
        if len(self.values) == 0:
            return torch.full_like(codes, -1)
        rank = torch.as_tensor(np.searchsorted(union, self.values),
                               dtype=torch.int64, device=codes.device)
        inside = (codes >= 0) & (codes < len(self.values))
        return torch.where(inside, rank[codes.clamp(0, len(rank) - 1)], -1)


class on_device:
    """The port's default device set to `device` while a query is built
    and collected (what an expression makes on its own goes there)."""

    def __init__(self, pl, device):
        self.pl, self.device = pl, device

    def __enter__(self):
        self.saved = self.pl.CONFIG.device
        self.pl.CONFIG.device = self.device

    def __exit__(self, *exc):
        self.pl.CONFIG.device = self.saved


class quiet:
    """stdout silenced and DeprecationWarning ignored (`inspect` prints;
    `groups` and `register_plugin` are deprecated)."""

    def __enter__(self):
        import contextlib
        import io
        import warnings
        self.stack = contextlib.ExitStack()
        self.stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
        self.stack.enter_context(warnings.catch_warnings())
        warnings.simplefilter("ignore", DeprecationWarning)

    def __exit__(self, *exc):
        self.stack.close()


def leaves(out) -> dict:
    """A collected port frame as tensors on its device over its live
    rows, one per leaf: {path: (values, validity or None)}. A String,
    Categorical or Binary column is `Coded` by its dictionary; a List
    column gives its lengths (".len"), its elements in row order
    (".values", only those inside each length) and their validity; a
    Struct its fields by name."""
    t = out._table
    n = t.count_rows()
    live = t.valid

    def rows(x):
        return x[:n] if live is None else x[:live.shape[0]][live]
    res = {}

    def walk(path, c):
        valid = None if c.validity is None else rows(c.validity)
        if c.lengths is not None:
            lens = rows(c.lengths).to(torch.int64)
            res[path + ".len"] = (lens, valid)
            if c.data is None and c.fields:
                for k, f in c.fields.items():
                    walk(f"{path}.{k}", f)
                return
            data = rows(c.data)
            inside = torch.arange(data.shape[1], device=data.device)[
                None, :] < lens[:, None]
            if valid is not None:
                inside &= valid[:, None]
            ev = None if c.elem_valid is None else rows(c.elem_valid)[inside]
            vals = data[inside]
            if c.sdict is not None:
                vals = Coded(vals, c.sdict.values)
            res[path + ".values"] = (vals, ev)
            return
        if c.fields is not None:
            if valid is not None:
                res[path + ".valid"] = (valid, None)
            for k, f in c.fields.items():
                walk(f"{path}.{k}", f)
            return
        vals = rows(c.data)
        if c.sdict is not None:
            vals = Coded(vals, c.sdict.values)
        res[path] = (vals, valid)

    for name in t.names:
        walk(name, t.cols[name])
    res["__schema__"] = (np.array([f"{k}: {v!r}" for k, v in
                                   t.schema.items()], dtype=object), None)
    return res


def _valid_or_none(m):
    if m is None:
        return None
    m = torch.as_tensor(m)
    return None if bool(m.all()) else m


# --- the SCAN bounds -------------------------------------------------------
# A SCAN entry held to the port's CPU collect runs the port's same code on
# both devices, in another order of summation: its error is within
#   1e-12 |want| + 1e-12 s
# with s the statistic's own scale (`SCAN_SCALE`): the largest |term| for a
# sum, mean or window of them, the variance for var, sigma for std,
# sigma_x sigma_y for cov; for a dimensionless statistic (skew, kurtosis,
# corr, entropy) 0.1 over a column and 10 over each row's window (floors
# of 1e-13 and 1e-11: the errors of an NVIDIA H100 80GB HBM3, 700.00 W,
# measured at 10^7 rows were at most 1.8e-15 and 2.0e-12).
# A SCAN entry held to numpy's closed form (another algorithm) is held to
# the worst case of its statistic (`NUMPY_SCAN`), with c = SCAN_C, eps =
# 2^-53 and, at each row, n the terms summed and S their sum of |t|:
#   partition_sum  c n_p eps S_p   (the row's partition: its n and S)
#   prefix         c n_i eps S_i   (row i's prefix: its n and S so far)
#   ewm_mean       c eps M / a^2   (M = max|x|: the recurrences' errors
#   ewm_var        c eps M^2 / a^2  decay by 1 - a a row)
#   ewm_std        ewm_var's bound / (2 std)
# A Float32 result adds one float32 ulp of the oracle's value (the port
# sums in float64 and rounds once).

SCAN_SCALE = {
    **dict.fromkeys(("Expr.cum_sum", "top.cum_sum", "Expr.sum", "top.sum",
                     "Expr.mean", "top.mean", "Expr.over",
                     "Expr.rolling_sum", "Expr.rolling_mean",
                     "variant.cum_sum_over"), ("term", "x")),
    "Expr.serialize": ("term", "2x"), "Expr.dot": ("term", "xk"),
    "variant.over_string_key": ("term", "price"),
    "Expr.ewm_mean_by": ("term", "price"),
    **dict.fromkeys(("Expr.rolling_sum_by", "Expr.rolling_mean_by"),
                    ("term", "price")),
    "Expr.rolling_var_by": ("var", "price"),
    "Expr.rolling_std_by": ("sd", "price"),
    **dict.fromkeys(("Expr.var", "top.var", "Expr.rolling_var",
                     "Expr.ewm_var"), ("var", "x")),
    **dict.fromkeys(("Expr.std", "top.std", "Expr.rolling_std",
                     "Expr.ewm_std"), ("sd", "x")),
    "Expr.ewm_mean": ("term", "x"),
    **dict.fromkeys(("top.cov", "top.rolling_cov"), ("cov", "xk")),
    **dict.fromkeys(("Expr.skew", "Expr.kurtosis", "Expr.entropy"),
                    ("ratio", "x")),
    "top.corr": ("ratio", "xk"),
    **dict.fromkeys(("Expr.rolling_skew", "Expr.rolling_kurtosis"),
                    ("window_ratio", "x")),
    "top.rolling_corr": ("window_ratio", "xk"),
}
NUMPY_SCAN = {
    "Expr.over": ("partition_sum", "x"),
    "variant.cum_sum_over": ("prefix", "x"),
    "Expr.cum_sum": ("prefix", "x"), "top.cum_sum": ("prefix", "x"),
    "Expr.ewm_mean": ("ewm_mean", "x"), "Expr.ewm_var": ("ewm_var", "x"),
    "Expr.ewm_std": ("ewm_std", "x"),
}
SAME_RTOL = 1e-12
# the SCAN entries' windows: (t - 5m, t] of the trades' ts; the ewm's a
EWM_ALPHA = 0.1

# the rows the breaker keeps, on the host
HOLE_ROWS = {"num": lambda cols: _vv(cols["j"])[0] > 2,
             "taq": lambda cols: _vv(cols["volume"])[0] % 5 > 2}


def _terms(cols, which, keep):
    """The terms a SCAN entry sums and their validity, in float64, over
    the rows `keep` holds (None: all)."""
    def col(name):
        vals, valid = _vv(cols[name])
        if keep is not None:
            vals, valid = vals[keep], valid[keep]
        return vals.astype(np.float64), valid
    if which == "xk":
        (x, xv), (k, kv) = col("x"), col("k")
        return x * k, xv & kv
    if which == "2x":
        x, xv = col("x")
        return 2 * x, xv
    return col(which)


def _same_scale(kind, which, cols, keep):
    """The statistic's own scale (`SCAN_SCALE`)."""
    if kind in ("ratio", "window_ratio"):
        return 0.1 if kind == "ratio" else 10.0
    if kind == "cov":
        x, xv = _terms(cols, "x", keep)
        k, kv = _terms(cols, "k", keep)
        return float(np.std(x[xv]) * np.std(k[kv]))
    t, valid = _terms(cols, which, keep)
    t = t[valid]
    if kind == "term":
        return float(np.abs(t).max()) if len(t) else 0.0
    var = float(np.var(t)) if len(t) else 0.0
    return var if kind == "var" else var ** 0.5


def _numpy_scale(entry, cols, kind, which, keep):
    """Each row's worst-case bound of a SCAN entry held to numpy's form
    (`NUMPY_SCAN`; the std kinds before their division)."""
    t, valid = _terms(cols, which, keep)
    a = np.where(valid, np.abs(t), 0.0)
    c, eps = SCAN_C, 2.0 ** -53
    if kind == "prefix":
        return c * eps * np.cumsum(valid) * np.cumsum(a)
    if kind == "partition_sum":
        j = _vv(cols["j"])[0].astype(np.int64)
        if keep is not None:
            j = j[keep]
        n = np.bincount(j, weights=valid.astype(np.float64))
        return c * eps * (n * np.bincount(j, weights=a))[j]
    m = float(a.max()) if len(a) else 0.0
    return c * eps * (m if kind == "ewm_mean" else m * m) / EWM_ALPHA ** 2


def scan_bound(entry: Entry, cols: Host, hole: bool = False,
               numpy: bool = False):
    """The bound of a SCAN entry's result over a frame's host columns (its
    rows after the breaker with `hole`), held to the port's CPU collect,
    or with `numpy` to numpy's closed form: a function of the oracle's
    values (a float tensor) giving the largest error allowed at each
    row."""
    keep = HOLE_ROWS[entry.source](cols) if hole else None
    if numpy:
        kind, which = NUMPY_SCAN[entry.name]
        scale = _numpy_scale(entry, cols, kind, which, keep)
        root = kind.endswith("std")
    else:
        kind, which = SCAN_SCALE[entry.name]
        floor = SAME_RTOL * _same_scale(kind, which, cols, keep)

    def bound(b: torch.Tensor) -> torch.Tensor:
        b64 = b.double()
        if numpy:
            lim = torch.as_tensor(scale, dtype=torch.float64).to(b.device)
            if root:
                lim = lim / (2 * b64.abs())
            lim = lim.expand_as(b64)
        else:
            lim = SAME_RTOL * b64.abs() + floor
        if b.dtype == torch.float32:
            lim = lim + _ulp32(b)
        return lim
    return bound


def _on(x, like):
    """A leaf's values (numpy, a tensor or Coded) where `like` lies."""
    if isinstance(x, Coded):
        return Coded(x.codes.to(like.device), x.values)
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
    return torch.as_tensor(x).to(like.device)


def compare(entry: Entry, got: dict, want: dict, bound=None) -> float:
    """`got` (leaves of the card's result) against `want` (the oracle's:
    tensors, numpy arrays or Coded), on got's device: the same leaves,
    lengths and nulls; values bit for bit but where the entry's family
    allows a float error (FLOAT: Float64 rtol 1e-12, Float32 one ulp;
    SCAN: `bound`, from `scan_bound`). Returns the largest error."""
    assert sorted(got) == sorted(want), \
        f"{entry.name}: leaves {sorted(got)} vs {sorted(want)}"
    worst = 0.0
    for k in want:
        if k == "__schema__":
            assert list(got[k][0]) == list(want[k][0]), \
                f"{entry.name}: schema {got[k][0]} vs {want[k][0]}"
            continue
        (a, av), (b, bv) = got[k], want[k]
        assert tuple(a.shape) == tuple(b.shape), \
            f"{entry.name}: {k} {tuple(a.shape)} vs {tuple(b.shape)}"
        like = a.codes if isinstance(a, Coded) else a
        b = _on(b, like)
        av, bv = _valid_or_none(av), _valid_or_none(bv)
        ones = torch.ones(len(a), dtype=torch.bool, device=like.device)
        va = ones if av is None else av.to(like.device)
        vb = ones if bv is None else _on(bv, like)
        assert torch.equal(va, vb), f"{entry.name}: the nulls of {k} differ"
        if isinstance(a, Coded) or isinstance(b, Coded):
            assert isinstance(a, Coded) and isinstance(b, Coded), \
                f"{entry.name}: {k} is a string on one side only"
            union = np.unique(np.concatenate([a.values, b.values]))
            assert torch.equal(a.ranks(union)[vb], b.ranks(union)[vb]), \
                f"{entry.name}: {k} differs"
            continue
        assert a.dtype == b.dtype, f"{entry.name}: {k} {a.dtype} vs {b.dtype}"
        lim = bound(b)[vb] if entry.family == SCAN and \
            b.is_floating_point() else None
        a, b = a[vb], b[vb]
        if not a.is_floating_point():
            assert torch.equal(a, b), f"{entry.name}: {k} differs"
            continue
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        if bool(same.all()):
            continue
        assert entry.family in (FLOAT, SCAN), \
            f"{entry.name}: {k} differs ({int((~same).sum())} values)"
        d = torch.where(same, 0.0, (a.double() - b.double()).abs())
        if entry.family == FLOAT:
            lim = 1e-12 * b.double().abs() if b.dtype == torch.float64 \
                else _ulp32(b)
        ok = d <= lim
        assert bool(ok.all()), (f"{entry.name}: {k} differs by "
                                f"{float(d[~ok].max())} beyond its bound")
        worst = max(worst, float(d.max()))
    return worst


def _ulp32(b: torch.Tensor) -> torch.Tensor:
    """One float32 ulp at each |b|, in float64, where b lies."""
    x = b.abs().to(torch.float32)
    up = torch.nextafter(x, torch.full_like(x, float("inf")))
    return (up.double() - x.double()).to(b.device)


def check_sample(entry: Entry, got: dict, source: dict) -> None:
    """A SAMPLE entry's draw against its input's values (`source`: the
    input's leaves over the same rows), where the leaves lie: `subset`
    draws a quarter of the column's rows, each a value of it;
    `permutation` all of them; `list_member` one element of each row's
    list."""
    (out_name,) = [k for k in got if k != "__schema__" and
                   not k.endswith(".len")]
    vals, valid = got[out_name]
    if entry.check == "list_member":
        lens, _ = got[out_name[:-len(".values")] + ".len"]
        src_lens, _ = source["lst.len"]
        src_vals, _ = source["lst.values"]
        assert torch.equal(lens, src_lens.clamp(max=1)), \
            f"{entry.name}: lengths"
        assert len(vals) == len(src_lens), f"{entry.name}: a row drew none"
        starts = torch.cumsum(src_lens, 0) - src_lens
        hit = torch.zeros(len(vals), dtype=torch.bool, device=vals.device)
        for i in range(int(src_lens.max())):
            at = (starts + torch.clamp(src_lens - 1, max=i)).clamp(
                max=len(src_vals) - 1)
            hit |= (i < src_lens) & (src_vals[at] == vals)
        assert bool(hit.all()), \
            f"{entry.name}: {int((~hit).sum())} drawn values not in their list"
        return
    src, sv = next(iter(v for k, v in source.items() if k != "__schema__"))
    have = torch.sort(src[sv] if sv is not None else src).values
    draw = vals[valid] if valid is not None else vals
    if entry.check == "permutation":
        assert len(vals) == len(src), f"{entry.name}: length"
        assert torch.equal(torch.sort(draw).values, have), \
            f"{entry.name}: values"
        return
    assert len(vals) == int(0.25 * len(src)), f"{entry.name}: length"
    pos = torch.searchsorted(have, draw).clamp(max=len(have) - 1)
    assert bool((have[pos] == draw).all()), \
        f"{entry.name}: a drawn value is not in the column"


for _name, _form in NUMPY_OF.items():
    if _name in ENTRIES:
        ENTRIES[_name] = ENTRIES[_name]._replace(numpy=_form)
VARIANTS = [v._replace(numpy=NUMPY_OF[v.name]) if v.name in NUMPY_OF
            else v for v in VARIANTS]
