"""The port's kernels (plain versions, on the CPU) against the JAX
package's Pallas kernels run in interpret mode.

polaroid_tpu_torch.ops.cuda_kernels.seg_sum      vs  pallas_kernels.onehot_seg_sum
polaroid_tpu_torch.ops.cuda_partition.compact_words vs pallas_partition.compact_words

On a CPU tensor each wrapper runs its plain PyTorch version; the CUDA
kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polaroid_tpu.ops import pallas_kernels as PK
from polaroid_tpu.ops import pallas_partition as PP
from polaroid_tpu_torch.batch import Column, Table
from polaroid_tpu_torch.dtypes import Float64
from polaroid_tpu_torch.ops import compact as TC
from polaroid_tpu_torch.ops import cuda_kernels as TK
from polaroid_tpu_torch.ops import cuda_partition as TP


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
    """NaN, signed zeros and subnormals survive the two-word compaction
    bit for bit."""
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
