"""Concatenation through the JAX package and through the port.

`concat` (vertical, vertical_relaxed, diagonal, horizontal), `vstack`,
`hstack` and the lazy union, over the same seeded numpy frames in both
packages (the port on the CPU): string columns with different
dictionaries, nulls, masked inputs and supertype casts. Every column is
compared exactly, in order.
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


def frames(cols, valid=None):
    valid = valid or {}
    rcols = {k: [x[i].item() if hasattr(x[i], "item") else x[i]
                 for i in range(len(x))] if k in valid else x
             for k, x in cols.items()}
    for k in valid:
        rcols[k] = [v if valid[k][i] else None for i, v in
                    enumerate(rcols[k])]
    tcols = {k: (list(x) if isinstance(x, np.ndarray) and x.dtype == object
                 else x) for k, x in cols.items()}
    tdf = frame_from_numpy(tcols, validity=valid, device="cpu")
    schema = {k: getattr(ref, repr(tdf.schema[k])) for k in valid}
    return ref.DataFrame(rcols, schema=schema), tdf


def _part(seed, n, words, i_dtype=np.int64, extra=None):
    rng = np.random.default_rng(seed)
    cols = {"i": rng.integers(-100, 100, n).astype(i_dtype),
            "x": rng.normal(size=n),
            "s": np.array(words, dtype=object)[rng.integers(0, len(words),
                                                            n)]}
    valid = {"x": rng.random(n) < 0.8, "s": rng.random(n) < 0.9}
    if extra:
        cols[extra] = rng.integers(0, 5, n).astype(np.int32)
    return frames(cols, valid)


def same(got, want):
    assert {k: repr(v) for k, v in got.schema.items()} == \
        {k: repr(v) for k, v in want.schema.items()}
    assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("how", ["vertical", "vertical_relaxed",
                                 "diagonal", "horizontal"])
def test_concat_matches_jax(how):
    a = _part(0, 300, ["pear", "fig", "kiwi"])
    b = _part(1, 200, ["apple", "fig", "plum", "lime"],
              i_dtype=np.int32 if how == "vertical_relaxed" else np.int64,
              extra="e" if how == "diagonal" else None)
    c = _part(2, 150, ["date"])
    if how == "horizontal":
        # distinct names; unequal lengths pad with nulls in neither
        # package, so the frames are the same height
        b = frames({"y": np.arange(300), "t": np.array(["q"] * 300,
                                                        dtype=object)})
        got = pt.concat([a[1], b[1]], how=how)
        want = ref.concat([a[0], b[0]], how=how)
    else:
        got = pt.concat([a[1], b[1], c[1]], how=how)
        want = ref.concat([a[0], b[0], c[0]], how=how)
    same(got, want)


def test_vertical_concat_rejects_other_schemas():
    a = _part(0, 30, ["a"])
    b = _part(1, 30, ["b"], extra="e")
    with pytest.raises(pt.SchemaError):
        pt.concat([a[1], b[1]])


def test_vstack_and_hstack_of_masked_frames():
    (ra, ta), (rb, tb) = _part(3, 500, ["u", "v"]), _part(4, 400, ["v", "w"])
    ta, ra = ta.filter(pt.col("i") > 0), ra.filter(ref.col("i") > 0)
    same(ta.vstack(tb), ra.vstack(rb))
    (rc, tc) = frames({"z": np.arange(500) * 3})
    tz = tc.filter(pt.col("z") % 2 == 0)
    rz = rc.filter(ref.col("z") % 2 == 0)
    tb2, rb2 = tb.filter(pt.col("i") < 100), rb.filter(ref.col("i") < 100)
    # hstack of two compacted frames of equal height
    same(tz.head(250).hstack(tb2.head(250)), rz.head(250).hstack(
        rb2.head(250)))


def test_lazy_union_with_a_filter_above():
    (ra, ta), (rb, tb) = _part(5, 400, ["m", "n"]), _part(6, 300, ["n", "o"])
    q = pt.concat([ta.lazy(), tb.lazy()]).filter(pt.col("x") > 0)
    rq = ref.concat([ra.lazy(), rb.lazy()]).filter(ref.col("x") > 0)
    assert "UNION" in q.explain()
    same(q.collect(), rq.collect())
    q = pt.concat([ta.lazy(), tb.lazy()], how="diagonal") \
        .group_by("s").agg(pt.len().alias("n")).sort("s")
    rq = ref.concat([ra.lazy(), rb.lazy()], how="diagonal") \
        .group_by("s").agg(ref.len().alias("n")).sort("s")
    same(q.collect(), rq.collect())


def test_lazy_horizontal_concat():
    """A lazy horizontal concat is an hconcat node in the port; the JAX
    package's `concat` makes it a diagonal union (its lazy branch passes
    every `how` to the union node), so the port is held against the
    eager horizontal concat."""
    (ra, ta) = _part(7, 200, ["r"])
    (rb, tb) = frames({"y": np.arange(200)})
    got = pt.concat([ta.lazy(), tb.lazy()], how="horizontal").collect()
    same(got, ref.concat([ra, rb], how="horizontal"))
