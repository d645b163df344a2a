"""The port's elementwise expressions against the JAX package's.

Each expression runs through `polaroid_tpu` and `polaroid_tpu_torch`
(device="cpu") over the same seeded frame with nulls; results compare
exactly (both compute in the same dtypes, one elementwise op at a time).
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


N = 300


def _frames():
    rng = np.random.default_rng(21)
    a = rng.integers(-50, 50, N)
    b = rng.integers(-5, 6, N).astype(np.int32)
    x = rng.normal(size=N)
    f = rng.normal(size=N).astype(np.float32)
    p = rng.uniform(size=N) < 0.5
    q = rng.uniform(size=N) < 0.5
    s = [f"k{i}" for i in rng.integers(0, 6, N)]
    valid = {"x": rng.uniform(size=N) < 0.8, "p": rng.uniform(size=N) < 0.7,
             "q": rng.uniform(size=N) < 0.7, "s": rng.uniform(size=N) < 0.9}

    def nulls(name, vals):
        return [v if ok else None
                for v, ok in zip(vals, valid[name])]

    rdf = ref.DataFrame({
        "a": a, "b": b, "x": nulls("x", [float(v) for v in x]), "f": f,
        "p": nulls("p", [bool(v) for v in p]),
        "q": nulls("q", [bool(v) for v in q]), "s": nulls("s", s)})
    tdf = frame_from_numpy({"a": a, "b": b, "x": x, "f": f, "p": p, "q": q,
                            "s": s}, validity=valid, device="cpu")
    return rdf, tdf


def _same(got: dict, want: dict) -> bool:
    """Equal dicts of columns, NaN equal to NaN (0/0 in truediv)."""
    def eq(a, b):
        return a == b or (isinstance(a, float) and isinstance(b, float)
                          and a != a and b != b)
    return got.keys() == want.keys() and all(
        len(got[k]) == len(want[k]) and all(map(eq, got[k], want[k]))
        for k in want)


EXPRS = {
    "add": lambda pl: pl.col("a") + pl.col("b"),
    "sub_lit": lambda pl: pl.col("a") - 7,
    "mul_float": lambda pl: pl.col("x") * pl.col("a"),
    "mixed_f32": lambda pl: pl.col("f") * pl.col("b"),
    "truediv": lambda pl: pl.col("a") / pl.col("b"),
    "floordiv": lambda pl: pl.col("a") // pl.col("b"),
    "mod": lambda pl: pl.col("a") % pl.col("b"),
    "fma": lambda pl: pl.col("a") * pl.col("b") + pl.col("x"),
    "neg_abs": lambda pl: (-pl.col("x")).abs(),
    "cmp": lambda pl: pl.col("x") > pl.col("f"),
    "and": lambda pl: pl.col("p") & pl.col("q"),
    "or": lambda pl: pl.col("p") | pl.col("q"),
    "xor": lambda pl: pl.col("p") ^ pl.col("q"),
    "not": lambda pl: ~pl.col("p"),
    "is_null": lambda pl: pl.col("x").is_null(),
    "cast_i32": lambda pl: pl.col("a").cast(pl.Int32),
    "cast_f32": lambda pl: pl.col("x").cast(pl.Float32),
    "cast_bool": lambda pl: pl.col("b").cast(pl.Boolean),
    "str_eq": lambda pl: pl.col("s") == "k3",
    "str_lt": lambda pl: pl.col("s") < "k2",
}


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_with_columns_matches_reference(name):
    rdf, tdf = _frames()

    def q(pl, df):
        return df.lazy().with_columns(EXPRS[name](pl).alias("out")) \
            .select("a", "out").collect()

    want, got = q(ref, rdf), q(pt, tdf)
    assert repr(got.schema["out"]) == repr(want.schema["out"])
    assert _same(got.to_dict(), want.to_dict())


@pytest.mark.parametrize("name", ["cmp", "and", "str_eq", "is_null"])
def test_filter_matches_reference(name):
    rdf, tdf = _frames()
    want = rdf.filter(EXPRS[name](ref)).to_dict()
    got = tdf.filter(EXPRS[name](pt)).to_dict()
    assert got == want


def test_select_scalar_len():
    rdf, tdf = _frames()
    want = rdf.filter(ref.col("a") > 0).select(ref.len()).to_dict()
    got = tdf.filter(pt.col("a") > 0).select(pt.len()).to_dict()
    assert got == want
