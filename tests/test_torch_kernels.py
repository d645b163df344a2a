"""The port's kernels (plain versions, on the CPU) against the JAX
package's Pallas kernels run in interpret mode.

polaroid_tpu_torch.ops.cuda_kernels.seg_sum      vs  pallas_kernels.onehot_seg_sum
polaroid_tpu_torch.ops.cuda_kernels.seg_minmax   vs  pallas_kernels.onehot_seg_minmax
                                                     (and jax.ops.segment_min/max)
polaroid_tpu_torch.ops.cuda_kernels.gather       vs  pallas_kernels.onehot_gather
polaroid_tpu_torch.ops.cuda_partition.compact_words vs pallas_partition.compact_words

On a CPU tensor each wrapper runs its plain PyTorch version; the CUDA
kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from polaroid_tpu.ops import pallas_kernels as PK
from polaroid_tpu.ops import pallas_partition as PP
from polaroid_tpu_torch.batch import Column, Table
from polaroid_tpu_torch.dtypes import Float64, Int64
from polaroid_tpu_torch.ops import compact as TC
from polaroid_tpu_torch.ops import cuda_kernels as TK
from polaroid_tpu_torch.ops import cuda_partition as TP


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


@pytest.mark.parametrize("n,G", [(64, 7), (1000, 130), (8192, 1000),
                                 (512, 4096)])
def test_seg_sum_matches_pallas(n, G):
    rng = np.random.default_rng(n + G)
    gid = rng.integers(-1, G + 2, n).astype(np.int32)
    ones = np.ones(n, np.float32)
    vals = np.stack([ones, rng.normal(size=n).astype(np.float32),
                     rng.uniform(-50, 50, n).astype(np.float32)])
    want = np.asarray(PK.onehot_seg_sum(jnp.asarray(vals), jnp.asarray(gid),
                                        G), dtype=np.float64)
    got = TK.seg_sum(torch.from_numpy(vals), torch.from_numpy(gid), G)
    assert got.dtype == torch.float64 and tuple(got.shape) == (3, G)
    got = got.numpy()
    # counts exact
    np.testing.assert_array_equal(got[0], want[0])
    # the JAX kernel accumulates in f32: hold each group's sum to 1e-5 of
    # the group's sum of |v|
    sel = (gid >= 0) & (gid < G)
    for c in (1, 2):
        mag = np.zeros(G)
        np.add.at(mag, gid[sel], np.abs(vals[c][sel]).astype(np.float64))
        assert np.all(np.abs(got[c] - want[c]) <= 1e-5 * mag + 1e-6)


def test_seg_sum_plain_is_exact_f64():
    rng = np.random.default_rng(5)
    n, G = 3000, 50
    gid = rng.integers(-3, G + 3, n).astype(np.int32)
    v = rng.normal(size=(2, n))
    got = TK.seg_sum(torch.from_numpy(v), torch.from_numpy(gid), G).numpy()
    sel = (gid >= 0) & (gid < G)
    for c in range(2):
        want = np.bincount(gid[sel], weights=v[c][sel], minlength=G)
        np.testing.assert_allclose(got[c], want, rtol=1e-12, atol=1e-12)


def test_seg_sum_checks_inputs_and_counts_no_cpu_launch():
    TK.LAUNCHES = 0
    v = torch.ones(2, 10)
    g = torch.zeros(10, dtype=torch.int32)
    TK.seg_sum(v, g, 4)
    assert TK.LAUNCHES == 0  # the CPU takes the plain version
    with pytest.raises(TypeError):
        TK.seg_sum(v.to(torch.int32), g, 4)
    with pytest.raises(TypeError):
        TK.seg_sum(v, g.to(torch.int64), 4)
    with pytest.raises(ValueError):
        TK.seg_sum(v, g, TK.MAX_GROUPS + 1)
    with pytest.raises(ValueError):
        TK.seg_sum(v.t().contiguous().t(), g, 4)


@pytest.mark.parametrize("G", [7, 300, 1024, 4096])
@pytest.mark.parametrize("is_max", [False, True])
def test_seg_minmax_matches_pallas(G, is_max):
    """f32 with an infinite identity: the TPU kernel's contract."""
    rng = np.random.default_rng(G + is_max)
    n = 3000
    x = rng.normal(scale=100, size=n).astype(np.float32)
    gid = rng.integers(-2, G + 3, n).astype(np.int32)
    ident = -np.inf if is_max else np.inf
    want = np.asarray(PK.onehot_seg_minmax(jnp.asarray(x), jnp.asarray(gid),
                                           G, is_max, float(ident)))
    got = TK.seg_minmax(torch.from_numpy(x), torch.from_numpy(gid), G,
                        is_max, ident)
    assert got.dtype == torch.float32 and tuple(got.shape) == (G,)
    # exact, empty groups included (the identity)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("G", [7, 300, 1024, 4096])
def test_gather_matches_pallas(G):
    rng = np.random.default_rng(G)
    n = 2500
    table = rng.normal(scale=1e3, size=G).astype(np.float32)
    gid = rng.integers(-3, G + 3, n).astype(np.int32)
    want = np.asarray(PK.onehot_gather(jnp.asarray(table), jnp.asarray(gid)))
    got = TK.gather(torch.from_numpy(table), torch.from_numpy(gid))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n,)
    # the TPU kernel's f32 MXU product, within 1e-6 relative
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    out = (gid < 0) | (gid >= G)
    assert np.all(got.numpy()[out] == 0)


def _specials(dt, n, gid, rng):
    """n values of dtype dt with the awkward ones mixed in: NaN (+NaN in
    groups of even id, -NaN in odd ones), -0.0/+0.0 and +-inf for floats;
    the type's extremes for ints."""
    if np.dtype(dt).kind == "f":
        x = rng.normal(scale=10, size=n).astype(dt)
        sp = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf], dt)
        pos = rng.integers(0, n, n // 20)
        x[pos] = sp[rng.integers(0, len(sp), len(pos))]
        odd = (gid % 2 == 1) & np.isnan(x)
        x[odd] = -x[odd]
        return x, -np.inf, np.inf
    info = np.iinfo(dt)
    x = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    x[:4] = [info.min, info.max, 0, -1]
    return x, info.min, info.max


@pytest.mark.parametrize("dt", [np.float64, np.float32, np.int32, np.int64])
def test_seg_minmax_plain_bit_exact_vs_jax(dt):
    """The plain version against jax.ops.segment_min/max on the CPU (the
    JAX package's CPU path), bit for bit: NaN propagates for min and max
    with its sign, -0.0 orders below +0.0."""
    rng = np.random.default_rng(np.dtype(dt).itemsize)
    n, G = 4000, 53
    gid = rng.integers(-2, G + 2, n).astype(np.int32)
    x, lo, hi = _specials(dt, n, gid, rng)
    seg = np.where((gid >= 0) & (gid < G), gid, G)
    u = f"u{np.dtype(dt).itemsize}"
    for is_max, f in ((False, jax.ops.segment_min),
                      (True, jax.ops.segment_max)):
        want = np.asarray(f(jnp.asarray(x), jnp.asarray(seg),
                            num_segments=G + 1))[:G]
        got = TK.seg_minmax(torch.from_numpy(x), torch.from_numpy(gid), G,
                            is_max, lo if is_max else hi).numpy()
        assert got.dtype == want.dtype
        assert np.array_equal(got.view(u), want.view(u)), is_max
        if np.dtype(dt).kind == "f":
            assert np.isnan(got).any()
            z = TK.seg_minmax(torch.tensor([0.0, -0.0, -0.0, 0.0],
                                           dtype=torch.from_numpy(x).dtype),
                              torch.tensor([0, 0, 1, 1], dtype=torch.int32),
                              2, is_max, lo if is_max else hi)
            assert z.tolist() == [0.0, 0.0]
            assert torch.signbit(z).tolist() == [not is_max] * 2


def test_seg_minmax_and_gather_check_inputs_and_count_no_cpu_launch():
    TK.MINMAX_LAUNCHES = TK.GATHER_LAUNCHES = 0
    x = torch.arange(10, dtype=torch.float32)
    g = torch.zeros(10, dtype=torch.int32)
    assert TK.seg_minmax(x, g, 3, True, -1.0).tolist() == [9.0, -1.0, -1.0]
    assert TK.gather(x[:3].double(), g).tolist() == [0.0] * 10
    assert TK.MINMAX_LAUNCHES == TK.GATHER_LAUNCHES == 0
    with pytest.raises(TypeError):
        TK.seg_minmax(x.to(torch.int16), g, 3, True, 0)
    with pytest.raises(TypeError):
        TK.seg_minmax(x, g.long(), 3, True, 0.0)
    with pytest.raises(ValueError):
        TK.seg_minmax(x, g, TK.MAX_GROUPS + 1, True, 0.0)
    with pytest.raises(ValueError):
        TK.seg_minmax(x, g, 3, False, float("nan"))
    with pytest.raises(TypeError):
        TK.gather(x[:3].to(torch.int32), g)
    with pytest.raises(TypeError):
        TK.gather(x[:3], g.long())
    with pytest.raises(ValueError):
        TK.gather(x[::2], g)


def _mask(kind, n, rng):
    if kind == "live":
        return np.ones(n, bool)
    if kind == "dead":
        return np.zeros(n, bool)
    return rng.uniform(size=n) < 0.37


@pytest.mark.parametrize("n", [16384, 32768])
@pytest.mark.parametrize("kind", ["live", "dead", "random"])
def test_compact_words_matches_pallas(n, kind):
    rng = np.random.default_rng(n)
    m = _mask(kind, n, rng)
    w0 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    w1 = rng.normal(size=n).astype(np.float32)
    w2 = np.arange(n, dtype=np.int32)
    res = PP.compact_words(jnp.asarray(m), [jnp.asarray(w0), jnp.asarray(w1),
                                            jnp.asarray(w2)])
    assert res is not None
    want, want_cnt = res
    outs, cnt = TP.compact_words(
        torch.from_numpy(m),
        [torch.from_numpy(w0.view(np.int32)), torch.from_numpy(w1),
         torch.from_numpy(w2)])
    assert cnt.dtype == torch.int64 and cnt.dim() == 0
    k = int(cnt)
    assert k == int(want_cnt) == int(m.sum())
    got = [outs[0].numpy().view(np.uint32), outs[1].numpy(), outs[2].numpy()]
    for g, w in zip(got, want):
        # the live prefix, bit for bit
        assert np.array_equal(g[:k].view(np.uint32),
                              np.asarray(w)[:k].view(np.uint32))


@pytest.mark.parametrize("n", [1, 5, 1023, 1025, 3000])
def test_compact_words_any_length(n):
    rng = np.random.default_rng(n)
    m = rng.uniform(size=n) < 0.5
    w = np.arange(n, dtype=np.int32)
    outs, cnt = TP.compact_words(torch.from_numpy(m), [torch.from_numpy(w)])
    assert int(cnt) == int(m.sum())
    assert np.array_equal(outs[0].numpy()[:int(cnt)], w[m])


def test_compact_words_strided_halves_share_one_buffer():
    x = torch.arange(10, dtype=torch.int64) * (1 << 40) + 7
    halves = x.view(torch.int32)
    m = torch.tensor([True, False] * 5)
    outs, cnt = TP.compact_words(m, [halves[0::2], halves[1::2]])
    back = outs[0].as_strided((10, 2), (2, 1)).view(torch.int64).view(10)
    assert torch.equal(back[:int(cnt)], x[m])


def test_compact_f64_roundtrip_bit_exact():
    """NaN, signed zeros and subnormals survive the compaction bit for
    bit."""
    special = np.array([np.nan, -0.0, 0.0, 5e-324, -2.2e-308, np.inf,
                        -np.inf, 1.0 / 3.0, -1e300], dtype=np.float64)
    rng = np.random.default_rng(9)
    vals = np.concatenate([special, rng.normal(size=300)])
    n = len(vals)
    keep = rng.uniform(size=n) < 0.6
    keep[:len(special)] = True
    t = Table.from_dict({"x": vals}, {"x": Float64}, device="cpu")
    masked = t.with_valid(torch.from_numpy(
        np.concatenate([keep, np.zeros(t.capacity - n, bool)])), None)
    out = TC.compact(masked)
    assert out.valid is None and int(out.nrows_dev) == int(keep.sum())
    got = out.cols["x"].data[:int(keep.sum())].numpy()
    assert got.dtype == np.float64
    assert np.array_equal(got.view(np.uint64), vals[keep].view(np.uint64))


def test_compact_words_takes_8_byte_words():
    """8-byte words, beside 4-byte and strided ones; 2-byte words are
    refused."""
    x = torch.tensor([-(1 << 63), (1 << 63) - 1, 0, -1, 1 << 40, 7])
    f = torch.tensor([float("nan"), -0.0, 0.0, 5e-324, float("inf"), 1.5],
                     dtype=torch.float64)
    m = torch.tensor([True, False, True, True, False, True])
    words = [x, f.view(torch.int64), x.view(torch.int32)[1::2],
             torch.arange(6, dtype=torch.int32)]
    outs, cnt = TP.compact_words(m, words)
    assert int(cnt) == 4 and outs[0].dtype == torch.int64
    assert torch.equal(outs[0][:4], x[m])
    assert torch.equal(outs[1][:4], f.view(torch.int64)[m])
    assert torch.equal(outs[2][:4], x.view(torch.int32)[1::2][m])
    assert outs[3][:4].tolist() == [0, 2, 3, 5]
    with pytest.raises(TypeError):
        TP.compact_words(m, [x.to(torch.int16)])


def test_compact_words_mirrors_views_by_byte_offset():
    """Words of one storage at a nonzero offset, 8 bytes wide beside its
    4-byte halves: the halves' outputs share one buffer at the inputs'
    byte offsets, and the 8-byte word, which overlaps both, gets its
    own; every prefix is right."""
    base = torch.arange(12, dtype=torch.int64) * (1 << 33) - 5
    x = base[2:]
    halves = x.view(torch.int32)
    m = torch.tensor([True, False, True, True, False, True, False, False,
                      True, True])
    outs, cnt = TP.compact_words(m, [x, halves[1::2], halves[0::2]])
    k = int(cnt)
    assert k == 6 and torch.equal(outs[0][:k], x[m])
    assert torch.equal(outs[1][:k], halves[1::2][m])
    assert torch.equal(outs[2][:k], halves[0::2][m])
    assert outs[1].untyped_storage().data_ptr() == \
        outs[2].untyped_storage().data_ptr() != \
        outs[0].untyped_storage().data_ptr()
    back = outs[2].as_strided((10, 2), (2, 1)).view(torch.int64).view(10)
    assert torch.equal(back[:k], x[m])


@pytest.mark.parametrize("kind", ["random", "live"])
def test_compact_8_byte_columns_with_nulls_match_pallas(kind):
    """Float64 (NaN, -0.0, subnormals, infinities) and Int64 (extremes)
    columns with nulls: the port compacts each column as one 8-byte word
    and each validity as a 4-byte word; the JAX package's compact_words
    takes the columns as their 4-byte halves. The live prefixes agree bit
    for bit."""
    n = 16384
    rng = np.random.default_rng(16)
    m = _mask(kind, n, rng)
    f = rng.normal(size=n)
    f[:7] = [np.nan, -np.nan, -0.0, 0.0, 5e-324, np.inf, -np.inf]
    i = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    i[:2] = [-(1 << 63), (1 << 63) - 1]
    valid = {"f": rng.uniform(size=n) < 0.8, "i": rng.uniform(size=n) < 0.7}
    t = Table.from_dict({"f": f, "i": i}, {"f": Float64, "i": Int64},
                        device="cpu", validity=valid)
    keep = np.zeros(t.capacity, bool)
    keep[:n] = m
    out = TC.compact(t.with_valid(torch.from_numpy(keep), None))
    halves = []
    for x in (f, i):
        u = x.view(np.uint32)
        halves += [jnp.asarray(u[0::2]), jnp.asarray(u[1::2])]
    res = PP.compact_words(jnp.asarray(m), halves + [
        jnp.asarray(valid["f"].astype(np.int32)),
        jnp.asarray(valid["i"].astype(np.int32))])
    assert res is not None
    want, want_cnt = res
    k = int(want_cnt)
    assert out.count_rows() == k == int(m.sum())
    want = [np.asarray(w)[:k] for w in want]
    for c, (lo, hi), v in (("f", want[0:2], want[4]),
                           ("i", want[2:4], want[5])):
        col = out.cols[c]
        got = col.data[:k].numpy().view(np.uint32)
        assert np.array_equal(got[0::2], lo.view(np.uint32))
        assert np.array_equal(got[1::2], hi.view(np.uint32))
        assert np.array_equal(col.validity[:k].numpy(), v != 0)


def test_compact_keeps_validity_and_narrow_columns():
    n = 200
    rng = np.random.default_rng(3)
    cols = {"b": rng.uniform(size=n) < 0.5,
            "i8": rng.integers(-100, 100, n).astype(np.int8),
            "f": rng.normal(size=n).astype(np.float32)}
    valid = {"f": rng.uniform(size=n) < 0.8}
    t = Table.from_dict(cols, device="cpu", validity=valid)
    keep = rng.uniform(size=t.capacity) < 0.5
    keep[n:] = False
    out = TC.compact(t.with_valid(torch.from_numpy(keep), None))
    k = int(keep[:n].sum())
    assert out.count_rows() == k
    assert np.array_equal(out.cols["b"].data[:k].numpy(), cols["b"][keep[:n]])
    assert out.cols["i8"].data.dtype == torch.int8
    assert np.array_equal(out.cols["i8"].data[:k].numpy(),
                          cols["i8"][keep[:n]])
    assert np.array_equal(out.cols["f"].validity[:k].numpy(),
                          valid["f"][keep[:n]])
    assert isinstance(out.cols["f"], Column)
