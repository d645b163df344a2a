"""DataFrame.unique and LazyFrame.unique through the JAX package and the
port.

Every `keep` ("any", "first", "last", "none") with and without
`maintain_order`, over one key, several keys with nulls, a Float64 key
(NaN, -0.0, +-inf) and every column, eager and lazy (after a filter), on
the same seeded numpy data (2 * 8192 + 777 rows) through `polaroid_tpu`
(its CPU path) and `polaroid_tpu_torch` with device="cpu" (the sorted
tier's row sort, with the kernels' plain versions). Both return the
chosen rows in the frame's order: compared exactly, row for row, Float64
values bit for bit.
"""

import functools
import struct

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


N = 2 * 8192 + 777
KEEPS = ("any", "first", "last", "none")
SUBSETS = {"one": ["a"], "nullable_pair": ["a", "s"], "float": ["f"],
           "all": None}


@functools.lru_cache(maxsize=None)
def _frames(seed: int = 51):
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i:03d}" for i in range(300)], dtype=object)
    f = rng.integers(0, 2000, N) / 8.0
    f[rng.integers(0, N, 20)] = np.array(
        [np.nan, -0.0, 0.0, np.inf, -np.inf])[rng.integers(0, 5, 20)]
    cols = {"a": rng.integers(0, 700, N).astype(np.int32),
            "s": words[rng.integers(0, 300, N)],
            "f": f,
            "b": rng.integers(0, 3, N).astype(np.int64)}
    valid = {"s": rng.random(N) < 0.95}
    rcols = {k: ([x if ok else None for x, ok in zip(v, valid[k])]
                 if k in valid else v) for k, v in cols.items()}
    tcols = {k: (list(v) if v.dtype == object else v)
             for k, v in cols.items()}
    return ref.DataFrame(rcols), frame_from_numpy(tcols, validity=valid,
                                                  device="cpu")


def _rows(df):
    d = df.to_dict()
    return [tuple(struct.pack("<d", x) if isinstance(x, float) else x
                  for x in row) for row in zip(*d.values())]


@pytest.mark.parametrize("maintain_order", [False, True])
@pytest.mark.parametrize("keep", KEEPS)
@pytest.mark.parametrize("subset", sorted(SUBSETS))
def test_unique_matches_reference(subset, keep, maintain_order):
    rdf, tdf = _frames()
    sub = SUBSETS[subset]
    got = tdf.unique(subset=sub, keep=keep, maintain_order=maintain_order)
    want = rdf.unique(subset=sub, keep=keep, maintain_order=maintain_order)
    assert _rows(got) == _rows(want)
    if subset == "one" and keep != "none":
        assert got.height == len(np.unique(tdf.to_dict()["a"]))


@pytest.mark.parametrize("keep", KEEPS)
def test_lazy_unique_after_a_filter(keep):
    """The distinct node of a lazy plan, over a masked (filtered) frame."""
    rdf, tdf = _frames()

    def q(pl, df):
        return (df.lazy().filter(pl.col("b") > 0)
                .unique(subset=["a", "s"], keep=keep, maintain_order=True)
                .select("a", "s", "b").collect())

    assert _rows(q(pt, tdf)) == _rows(q(ref, rdf))


def test_unique_rejects_an_unknown_keep():
    _, tdf = _frames()
    with pytest.raises(pt.ComputeError):
        tdf.unique(subset="a", keep="middle")
