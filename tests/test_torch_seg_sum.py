"""Kernel A's counting mode and launch plan on the CPU.

`seg_sum(vals, gid, G, count=True)` puts each group's count of ids in
[0, G) before the sums: on a CPU tensor it is the plain version, held
here bit for bit to the old call over a row of ones and to the JAX
package's `onehot_seg_sum` (Pallas, interpret mode) over such a row;
`seg_sum_plan` is pure Python and is held to what csrc/seg_sum.cu takes.
The kernel itself is held to the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polaroid_tpu.ops import pallas_kernels as PK
from polaroid_tpu_torch.ops import cuda_kernels as TK
from polaroid_tpu_torch.ops.groupby import GroupContext, HashGroupContext


@pytest.fixture(autouse=True, scope="module")
def _fresh_reference_cache():
    """The JAX package's process-wide caches start empty and store
    nothing while this file runs (`tests/test_torch_reference_caches.py`)."""
    from test_torch_reference_caches import fresh_reference_caches
    with fresh_reference_caches():
        yield


def _inputs(n, G, C, dtype, seed):
    rng = np.random.default_rng(seed)
    gid = rng.integers(-3, G + 3, n).astype(np.int32)
    vals = rng.uniform(-50, 50, (C, n)).astype(dtype)
    return torch.from_numpy(vals), torch.from_numpy(gid)


@pytest.mark.parametrize("C", [0, 1, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,G", [(1, 1), (777, 7), (5000, 1024),
                                 (3000, 8192)])
def test_count_equals_a_row_of_ones(C, dtype, n, G):
    """Row 0 of the counting mode, and every row after it, equal the old
    call over a row of ones put first, bit for bit (ids outside [0, G)
    included, and C = 0)."""
    vals, gid = _inputs(n, G, C, dtype, n + G + C)
    got = TK.seg_sum(vals, gid, G, count=True)
    ones = torch.ones((1, n), dtype=vals.dtype)
    want = TK.seg_sum(torch.cat([ones, vals]), gid, G)
    assert got.dtype == torch.float64 and tuple(got.shape) == (C + 1, G)
    assert torch.equal(got, want)
    assert torch.equal(TK.seg_sum_plain(vals, gid, G, True), want)
    live = gid[(gid >= 0) & (gid < G)].long()
    assert torch.equal(got[0], torch.bincount(live, minlength=G).double())


@pytest.mark.parametrize("C", [0, 2])
@pytest.mark.parametrize("n,G", [(64, 7), (1000, 130), (8192, 1000),
                                 (512, 4096)])
def test_count_matches_pallas(C, n, G):
    """The counting mode against the JAX package's kernel over a row of
    ones put first: counts exact, sums within 1e-5 of each group's sum of
    |v| (the JAX kernel accumulates in f32)."""
    rng = np.random.default_rng(n + G + C)
    gid = rng.integers(-1, G + 2, n).astype(np.int32)
    vals = np.stack([rng.normal(size=n).astype(np.float32),
                     rng.uniform(-50, 50, n).astype(np.float32)])[:C]
    ones = np.ones((1, n), np.float32)
    want = np.asarray(PK.onehot_seg_sum(
        jnp.asarray(np.concatenate([ones, vals])), jnp.asarray(gid), G),
        dtype=np.float64)
    got = TK.seg_sum(torch.from_numpy(np.ascontiguousarray(vals)).reshape(
        C, n), torch.from_numpy(gid), G, count=True).numpy()
    assert got.shape == (C + 1, G)
    np.testing.assert_array_equal(got[0], want[0])
    sel = (gid >= 0) & (gid < G)
    for c in range(C):
        mag = np.zeros(G)
        np.add.at(mag, gid[sel], np.abs(vals[c][sel]).astype(np.float64))
        assert np.all(np.abs(got[c + 1] - want[c + 1]) <= 1e-5 * mag + 1e-6)


def test_no_row_and_no_count_is_refused():
    gid = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError):
        TK.seg_sum(torch.empty((0, 10)), gid, 4)
    assert TK.seg_sum(torch.empty((0, 10)), gid, 4, count=True).shape == \
        (1, 4)


def _check_plan(p, C, G, count, sms, n):
    copy = G * (8 * p.cols + 4 * count)
    assert p.launches == 1
    assert p.smem == p.replicas * copy <= 232448
    assert p.cmax in (0, 1, 2, 4, 8) and p.cols <= p.cmax
    # each column in exactly one column group, no group empty
    assert (p.groups - 1) * p.cols < max(C, 1) <= max(p.groups * p.cols, 1)
    assert (p.cols == 0) == (C == 0) and (C > 0 or p.groups == 1)
    assert p.threads % 32 == 0 and p.threads <= TK._SEG_THREADS
    assert p.private == (p.replicas == p.threads // 32)
    assert p.blocks % p.groups == 0 and p.blocks >= p.groups
    assert p.blocks <= max(p.groups, sms - sms % p.groups)
    assert (p.aggregate_at == 0) == (C == 0)


@pytest.mark.parametrize("C,count", [(C, count) for C in range(10)
                                     for count in (False, True)
                                     if C or count])
def test_plan_fits_and_covers_every_column(C, count):
    """For every G of 1..8192: the plan fits one block's 227 KB of shared
    memory, takes each column in exactly one column group, makes one
    launch, and the blocks it asks for fit the card; at n = 1, 2^21 and
    2^25 rows and 132 or 8 SMs. (The values' item size does not enter
    the plan: the partials are f64 whatever the values.)"""
    for G in range(1, TK.MAX_GROUPS + 1):
        for sms, n in ((132, 1 << 21), (132, 1), (8, 1 << 25)):
            _check_plan(TK.seg_sum_plan(C, G, count, sms, n),
                        C, G, count, sms, n)


def test_plan_words_carry_the_plan():
    p = TK.seg_sum_plan(2, 1024, True, 132, 1 << 23)
    w = list(TK._seg_words(p, True, 2, 1024, True))
    assert w == [1, p.cmax, 2, 1024, p.cols, p.groups, p.replicas,
                 1 | (2 if p.private else 0) | (p.aggregate_at << 8),
                 p.threads, p.blocks, p.smem]


@pytest.mark.parametrize("ctx_kind", ["dense", "hash"])
def test_group_sums_count_equals_a_row_of_ones(ctx_kind):
    """GroupContext.sums(rows, count=True), on the dense tier's kernel A
    and the hash tier's scatters: the count row first, then the sums,
    each equal to the old call with a row of ones put first."""
    rng = np.random.default_rng(3)
    cap, G = 4000, 300
    gid = torch.from_numpy(rng.integers(0, G + 1, cap).astype(np.int32))
    live = gid < G
    ctx = GroupContext(gid, live, cap, None, G) if ctx_kind == "dense" \
        else HashGroupContext(gid, live, cap, None, None, None)
    rows = [torch.from_numpy(rng.normal(size=cap).astype(np.float32)),
            torch.from_numpy(rng.normal(size=cap))]
    got = ctx.sums(rows, count=True)
    want = ctx.sums([torch.ones(cap, dtype=torch.float32)] + rows)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    (alone,) = ctx.sums([], count=True)
    assert torch.equal(alone, want[0])
