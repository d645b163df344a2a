"""Range reductions and the wavelet tree through the JAX package and the
port.

The port's `ops/range_agg.py` and `ops/wavelet.py` against the JAX
package's functions of the same names, called directly on the same
seeded numpy inputs (the port's on CPU tensors):
* the sparse table's min and max over every range: bit for bit;
* `prefix_range_sum` (the JAX package's method, kept): integers bit for
  bit, floats within the reference's own bound, 4·n·2^-53·Σ|x| of the
  whole column;
* `range_sum` over sum levels (the port's windows): integers bit for
  bit; floats within 2·⌈log2 w⌉·2^-53·Σ|x| of each range's own w rows,
  held against numpy (the JAX package has no such function), and a NaN
  spoils only the ranges that hold it;
* `segmented_searchsorted` with both sides, in full and stopped at the
  longest segment, and one `torch.searchsorted` over (segment, offset)
  keys (the partitioned windows' search): bit for bit;
* the wavelet tree's level tables, `wavelet_select` and
  `wavelet_count_lt`: bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polaroid_tpu.ops import range_agg as RJ
from polaroid_tpu.ops import wavelet as WJ
from polaroid_tpu_torch.ops import range_agg as R
from polaroid_tpu_torch.ops import wavelet as W


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


N = 1000


def _ranges(rng, n, longest):
    lo = rng.integers(0, n, n)
    hi = np.minimum(lo + rng.integers(0, longest + 1, n), n)
    return lo, hi


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32,
                                   np.float64])
@pytest.mark.parametrize("kind", ["min", "max"])
def test_sparse_table_matches_jax(dtype, kind):
    rng = np.random.default_rng(1)
    x = (rng.normal(0, 100, N)).astype(dtype)
    lo, hi = _ranges(rng, N, 300)
    empty = np.array(-7, dtype=dtype)
    want = np.asarray(RJ.range_query(RJ.build_sparse(jnp.asarray(x), kind),
                                     jnp.asarray(lo), jnp.asarray(hi), kind,
                                     empty))
    levels = R.build_sparse(_t(x), kind, R.levels_for(int((hi - lo).max())))
    got = R.range_query(levels, _t(lo), _t(hi), kind, empty.item()).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_prefix_range_sum_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 100, N).astype(dtype)
    lo, hi = _ranges(rng, N, 200)
    want = np.asarray(RJ.prefix_range_sum(jnp.asarray(x), jnp.asarray(lo),
                                          jnp.asarray(hi)))
    got = R.prefix_range_sum(_t(x), _t(lo), _t(hi)).numpy()
    if dtype == np.int64:
        assert np.array_equal(got, want)
    else:
        bound = 4 * N * 2.0 ** -53 * np.abs(x).sum()
        assert np.all(np.abs(got - want) <= bound)


def _numpy_sums(x, lo, hi):
    return np.array([x[a:b].sum(dtype=np.float64 if x.dtype.kind == "f"
                                else np.int64) for a, b in zip(lo, hi)])


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
@pytest.mark.parametrize("longest", [1, 7, 64, 300])
def test_range_sum_is_window_local(dtype, longest):
    rng = np.random.default_rng(3 + longest)
    x = rng.normal(0, 1e6, N).astype(dtype)
    lo, hi = _ranges(rng, N, longest)
    levels = R.build_sum_levels(_t(x), R.levels_for(longest))
    got = R.range_sum(levels, _t(lo), _t(hi)).numpy()
    want = _numpy_sums(x, lo, hi)
    if dtype == np.int64:
        assert np.array_equal(got, want)
        # the JAX package's prefix difference agrees for integers
        assert np.array_equal(got, np.asarray(RJ.prefix_range_sum(
            jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi))))
        return
    w = np.maximum(hi - lo, 1)
    absum = _numpy_sums(np.abs(x), lo, hi)
    bound = 2 * np.ceil(np.log2(w)) * 2.0 ** -53 * absum
    assert np.all(np.abs(got - want) <= bound)


def test_range_sum_confines_nan_to_its_windows():
    """A NaN spoils only the ranges that hold it (the JAX package's
    prefix difference spoils every later range)."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, N)
    x[100] = np.nan
    lo, hi = _ranges(rng, N, 50)
    got = R.range_sum(R.build_sum_levels(_t(x), R.levels_for(50)),
                      _t(lo), _t(hi)).numpy()
    holds = (lo <= 100) & (100 < hi)
    assert np.isnan(got[holds]).all()
    assert np.isfinite(got[~holds]).all()
    ref = np.asarray(RJ.prefix_range_sum(jnp.asarray(x), jnp.asarray(lo),
                                         jnp.asarray(hi)))
    assert np.isnan(ref[(lo > 100) & (hi > lo)]).all()


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("stop_early", [False, True])
def test_segmented_searchsorted_matches_jax(side, stop_early):
    rng = np.random.default_rng(5)
    sizes = rng.integers(1, 40, 60)
    starts = np.r_[0, np.cumsum(sizes)[:-1]]
    n = int(sizes.sum())
    # ascending within each segment, with ties
    vals = np.concatenate([np.sort(rng.integers(0, 30, s)) for s in sizes])
    seg = np.repeat(np.arange(len(sizes)), sizes)
    gs, ge = starts[seg], (starts + sizes)[seg]
    q = rng.integers(-2, 32, n)
    want = np.asarray(RJ.segmented_searchsorted(
        jnp.asarray(vals), jnp.asarray(gs), jnp.asarray(ge), jnp.asarray(q),
        side))
    got = R.segmented_searchsorted(
        _t(vals), _t(gs), _t(ge), _t(q), side,
        int(sizes.max()) if stop_early else None).numpy()
    assert np.array_equal(got, want)
    # one searchsorted over (segment id, offset) keys gives the same
    key = (seg.astype(np.int64) << 20) | (vals + 1)
    qk = (seg.astype(np.int64) << 20) | np.clip(q + 1, 0, 32)
    keyed = torch.searchsorted(_t(key), _t(qk), right=side == "right").numpy()
    assert np.array_equal(keyed, want)


@pytest.mark.parametrize("n", [1, 2, 37, 513])
def test_wavelet_matches_jax(n):
    rng = np.random.default_rng(6 + n)
    ranks = rng.permutation(n).astype(np.int32)
    tj = WJ.build_wavelet(jnp.asarray(ranks))
    tt = W.build_wavelet(_t(ranks))
    assert len(tj) == len(tt)
    for (zj, cj), (zt, ct) in zip(tj, tt):
        assert np.array_equal(np.asarray(zj), zt.numpy())
        assert int(cj) == int(ct)
    lo = rng.integers(0, n, 4 * n)
    hi = np.minimum(lo + 1 + rng.integers(0, n, 4 * n), n)
    k = (rng.uniform(size=4 * n) * (hi - lo)).astype(np.int64)
    want = np.asarray(WJ.wavelet_select(tj, jnp.asarray(lo, jnp.int32),
                                        jnp.asarray(hi, jnp.int32),
                                        jnp.asarray(k, jnp.int32)))
    got = W.wavelet_select(tt, _t(lo), _t(hi), _t(k)).numpy()
    assert np.array_equal(got, want)
    # the k-th smallest rank of each range, by numpy
    assert np.array_equal(got, [np.sort(ranks[a:b])[kk]
                                for a, b, kk in zip(lo, hi, k)])
    key = rng.integers(0, n + 1, 4 * n)
    want = np.asarray(WJ.wavelet_count_lt(tj, jnp.asarray(lo, jnp.int32),
                                          jnp.asarray(hi, jnp.int32),
                                          jnp.asarray(key, jnp.int32)))
    got = W.wavelet_count_lt(tt, _t(lo), _t(hi), _t(key)).numpy()
    assert np.array_equal(got, want)
