"""The hash-exchange group-by through the JAX package and the port.

fmix32 and its inverse, the bucket exchange, `precheck`,
`hash_groupby_u32` and the carry-sort fallback, on the same seeded numpy
data (about 2 * 8192 + 777 rows, as tests/test_hgroup.py), through
`polaroid_tpu` on the CPU (its Pallas exchange in interpret mode) and
`polaroid_tpu_torch` on the CPU (the kernel's plain version). Tolerances:
exact for hashes, layouts, keys, counts, integer sums, min/max and the
lower, higher and nearest quantiles; f32 sums within 1e-2 + 1e-4 |w|
(the JAX CPU path accumulates those in f32, the port in f64); f64 sums
of squares and products within rtol 1e-9; linear and midpoint
quantiles within 4 f32 ulp of the values' largest magnitude
(interpolated in f32 there, in f64 here).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polaroid_tpu.ops import exchange as EX
from polaroid_tpu.ops import hgroup as HG
from polaroid_tpu.ops.hashing import _fmix32
from polaroid_tpu.parallel import shuffle as SH
from polaroid_tpu_torch.ops import exchange as TE
from polaroid_tpu_torch.ops import hgroup as TH
from polaroid_tpu_torch.ops.hashing import fmix32


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


N = 2 * EX.S + 777
EDGES = np.array([0, 1, 2, 1 << 31, (1 << 31) - 1, (1 << 32) - 1,
                  0x85EBCA6B, 0xFFFF0000], dtype=np.uint32)


def _u32(rng, n):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def _t(x: np.ndarray) -> torch.Tensor:
    """u32 words as the port holds them: non-negative int64."""
    return torch.from_numpy(x.astype(np.int64))


def test_geometry_matches_jax():
    assert (TE.S, TE.K, TE.CAP) == (EX.S, EX.K, EX.CAP)
    assert TH.out_capacity(N) == HG.out_capacity(N)


def test_fmix32_and_inverse_bit_exact():
    rng = np.random.default_rng(1)
    x = np.concatenate([EDGES, _u32(rng, 5000)])
    want = np.asarray(_fmix32(jnp.asarray(x)))
    got = fmix32(_t(x))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    want_inv = np.asarray(HG.fmix32_inv(jnp.asarray(x)))
    got_inv = TH.fmix32_inv(_t(x))
    assert np.array_equal(got_inv.numpy(), want_inv.astype(np.int64))
    assert np.array_equal(TH.fmix32_inv(got).numpy(), x.astype(np.int64))
    # int64 inputs outside [0, 2^32) hash as their low 32 bits, as a cast
    # to uint32 does
    neg = torch.tensor([-1, -(1 << 31), (1 << 40) + 5])
    assert fmix32(neg).tolist() == fmix32(neg & 0xFFFFFFFF).tolist()


def _exchange_input(rng, B):
    n = B * EX.S
    h = _u32(rng, n)
    h[rng.random(n) < 0.1] = 0xFFFFFFFF          # about 10% dead rows
    hb = np.sort(h.reshape(B, EX.S), axis=1)
    v = _u32(rng, n).reshape(B, EX.S)
    digit = (hb >> 27).astype(np.int64)
    live = hb != 0xFFFFFFFF
    counts = np.zeros((B, EX.K), np.int32)
    for b in range(B):
        counts[b] = np.bincount(digit[b][live[b]], minlength=EX.K)
    starts = np.concatenate([np.zeros((B, 1), np.int32),
                             np.cumsum(counts, 1)[:, :-1]], 1).astype(np.int32)
    return hb.reshape(-1), v.reshape(-1), starts, counts


def test_bucket_exchange_plain_matches_pallas():
    rng = np.random.default_rng(2)
    B = 3
    hb, v, starts, counts = _exchange_input(rng, B)
    assert counts.max() <= EX.CAP
    fills = (0xFFFFFFFF, 0)
    want = EX.bucket_exchange(jnp.asarray(starts), jnp.asarray(counts),
                              [jnp.asarray(hb), jnp.asarray(v)], fills=fills)
    TE.EXCHANGE_LAUNCHES = 0
    got = TE.bucket_exchange(torch.from_numpy(starts),
                             torch.from_numpy(counts),
                             [torch.from_numpy(hb.view(np.int32)),
                              torch.from_numpy(v.view(np.int32))], fills)
    assert TE.EXCHANGE_LAUNCHES == 0  # the CPU takes the plain version
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == (EX.K,
                                                             B * EX.CAP)
        # every slot, pads included, bit for bit
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(w))


def test_bucket_exchange_cuts_runs_at_cap():
    """A run longer than CAP is cut at CAP, as the TPU kernel clamps."""
    B = 1
    w = np.arange(EX.S, dtype=np.int32)
    counts = np.zeros((B, EX.K), np.int32)
    counts[0, :3] = [500, 10, EX.CAP]
    starts = np.concatenate([[0], np.cumsum(counts[0])[:-1]]) \
        .astype(np.int32)[None]
    (out,) = TE.bucket_exchange(torch.from_numpy(starts),
                                torch.from_numpy(counts),
                                [torch.from_numpy(w)], (7,))
    out = out.numpy()
    assert np.array_equal(out[0], np.arange(EX.CAP))
    assert np.array_equal(out[1, :10], np.arange(500, 510))
    assert (out[1, 10:] == 7).all() and (out[3:] == 7).all()
    assert np.array_equal(out[2], np.arange(510, 510 + EX.CAP))


def test_bucket_exchange_checks_inputs():
    s = torch.zeros((2, EX.K), dtype=torch.int32)
    w = torch.zeros(2 * EX.S, dtype=torch.int32)
    with pytest.raises(TypeError):
        TE.bucket_exchange(s.long(), s, [w], (0,))
    with pytest.raises(TypeError):
        TE.bucket_exchange(s, s, [w[:-1]], (0,))
    with pytest.raises(TypeError):
        TE.bucket_exchange(s, s, [w.long()], (0,))
    with pytest.raises(ValueError):
        TE.bucket_exchange(s, s, [w], (0, 1))


def _keys_with_cell(rows_in_cell: int, rng):
    """Two blocks of keys: in block 0 bucket 0 holds exactly
    `rows_in_cell` live rows and the other 31 buckets share the rest;
    block 1 is uniform."""
    top = np.concatenate([np.zeros(rows_in_cell, np.uint64),
                          rng.integers(1, EX.K, EX.S - rows_in_cell)
                          .astype(np.uint64)])
    h0 = (top << np.uint64(27)) | rng.integers(0, 1 << 27, EX.S) \
        .astype(np.uint64)
    h = np.concatenate([h0, _u32(rng, EX.S).astype(np.uint64)])
    h = np.minimum(h, 0xFFFFFFFE).astype(np.uint32)  # never the fill
    return np.asarray(HG.fmix32_inv(jnp.asarray(h)))


@pytest.mark.parametrize("case", ["uniform", "heavy8", "reserved",
                                  "cap384", "cap385"])
def test_precheck_matches_jax(case):
    rng = np.random.default_rng(3)
    valid = rng.random(N) > 0.15
    if case == "uniform":
        key = _u32(rng, N)
    elif case == "heavy8":
        key = (rng.integers(0, 8, N) * 500_000_011).astype(np.uint32)
    elif case == "reserved":
        key = _u32(rng, N)
        key[5] = int(HG.fmix32_inv(jnp.uint32(0xFFFFFFFF)))
        valid[5] = True
    else:
        key = _keys_with_cell(int(case[3:]), rng)
        valid = np.ones(key.shape[0], bool)
    want = bool(HG.precheck(jnp.asarray(key), jnp.asarray(valid)))
    got = TH.precheck(_t(key), torch.from_numpy(valid))
    assert got.dtype == torch.bool and bool(got) == want
    prep = TH.hash_prep(_t(key), torch.from_numpy(valid))
    expect = {"uniform": True, "heavy8": False, "reserved": False,
              "cap384": True, "cap385": False}[case]
    assert want == expect
    if case.startswith("cap"):
        assert int(prep.counts.max()) == int(case[3:])


def _hash_groupby_input(nkeys, seed):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, nkeys, N).astype(np.uint32)
    # keys near 4e9 prove the layout does not depend on the key range
    key[key % 7 == 0] += np.uint32(4_000_000_000 - nkeys)
    f = rng.normal(0, 10, N).astype(np.float32)
    i = rng.integers(-1000, 1000, N).astype(np.int32)
    valid = rng.random(N) > 0.15
    return key, f, i, valid


@pytest.mark.parametrize("nkeys", [2000, 5000, 200_000])
def test_hash_groupby_u32_matches_jax(nkeys):
    key, f, i, valid = _hash_groupby_input(nkeys, nkeys)
    aggs = ["count", "sum", "sum", "min", "max", "min", "max", "sumsq"]
    jv = [f, f, i, f, f, i, i, f]
    sd = [None, None, jnp.dtype(jnp.int64), None, None, None, None,
          jnp.dtype(jnp.float64)]
    wk, wo, wv, wok = HG.hash_groupby_u32(
        jnp.asarray(key), [jnp.asarray(x) for x in jv], jnp.asarray(valid),
        aggs, scan_dtypes=sd)
    td = [None if d is None else {jnp.dtype(jnp.int64): torch.int64,
                                  jnp.dtype(jnp.float64): torch.float64}[d]
          for d in sd]
    gk, go, gv, ok = TH.hash_groupby_u32(
        _t(key), [torch.from_numpy(x) for x in jv], torch.from_numpy(valid),
        aggs, scan_dtypes=td)
    assert bool(wok) and bool(ok)
    wv = np.asarray(wv)
    m = gv.numpy()
    assert np.array_equal(m, wv)                      # slot for slot
    assert np.array_equal(gk.numpy()[m], np.asarray(wk)[m].astype(np.int64))
    w = [np.asarray(x)[m] for x in wo]
    g = [x.numpy()[m] for x in go]
    assert np.array_equal(g[0], w[0])                 # count
    s = w[1].astype(np.float64)
    assert np.all(np.abs(g[1] - s) <= 1e-2 + 1e-4 * np.abs(s))
    assert g[2].dtype == np.int64 and np.array_equal(g[2], w[2])
    for j in (3, 4, 5, 6):                            # min / max, exact
        assert g[j].dtype == w[j].dtype and np.array_equal(g[j], w[j])
    np.testing.assert_allclose(g[7], w[7], rtol=1e-9)
    # against the keys themselves
    live = valid
    assert set(gk.numpy()[m].tolist()) == set(key[live].astype(np.int64)
                                              .tolist())


@pytest.mark.parametrize("nkeys", [2000, 200_000])
def test_hash_groupby_u32_sumprod_and_quantile_match_jax(nkeys):
    """"sumprod" (a pair of columns) and ("quantile", q, interp) with
    every interpolation. Order statistics are exact; the JAX CPU path
    interpolates in f32 and the port in f64, rounded once, so linear and
    midpoint agree within 4 f32 ulp of the column's largest magnitude;
    sumprod as sum and sumsq."""
    key, f, i, valid = _hash_groupby_input(nkeys, nkeys + 1)
    g = np.random.default_rng(nkeys).normal(0, 3, N).astype(np.float32)
    quants = [("quantile", 0.5, "linear"), ("quantile", 0.3, "lower"),
              ("quantile", 0.3, "higher"), ("quantile", 0.7, "midpoint"),
              ("quantile", 0.5, "nearest"), ("quantile", 0.9, "linear"),
              ("quantile", 0.25, "nearest")]
    aggs = ["sumprod", "sumprod", "sumprod"] + quants
    jv = [(f, g), (f, g), (i, i)] + [f] * 5 + [i] * 2
    sd = [None, jnp.dtype(jnp.float64), jnp.dtype(jnp.int64)] + \
        [None] * len(quants)
    wk, wo, wv, wok = HG.hash_groupby_u32(
        jnp.asarray(key), [tuple(jnp.asarray(y) for y in x)
                           if isinstance(x, tuple) else jnp.asarray(x)
                           for x in jv], jnp.asarray(valid),
        aggs, scan_dtypes=sd)
    td = [None, torch.float64, torch.int64] + [None] * len(quants)
    gk, go, gv, ok = TH.hash_groupby_u32(
        _t(key), [tuple(torch.from_numpy(y) for y in x)
                  if isinstance(x, tuple) else torch.from_numpy(x)
                  for x in jv], torch.from_numpy(valid), aggs,
        scan_dtypes=td)
    assert bool(wok) and bool(ok)
    m = gv.numpy()
    assert np.array_equal(m, np.asarray(wv))
    assert np.array_equal(gk.numpy()[m], np.asarray(wk)[m].astype(np.int64))
    w = [np.asarray(x)[m] for x in wo]
    got = [x.numpy()[m] for x in go]
    s = w[0].astype(np.float64)
    assert np.all(np.abs(got[0] - s) <= 1e-2 + 1e-4 * np.abs(s))
    np.testing.assert_allclose(got[1], w[1], rtol=1e-9)
    assert got[2].dtype == np.int64 and np.array_equal(got[2], w[2])
    for j, a in enumerate(aggs[3:], 3):
        assert got[j].dtype == w[j].dtype == np.float32, a
        if a[2] in ("linear", "midpoint"):
            x = jv[j]
            tol = 4 * np.spacing(np.float32(np.abs(x).max()))
            assert np.all(np.abs(got[j] - w[j]) <= tol), a
        else:
            assert np.array_equal(got[j], w[j]), a


def test_hash_groupby_u32_refuses_later_aggregates():
    """Every aggregate of the JAX contract is ported (sumprod and
    quantile came with the sorted tier); one outside it is refused."""
    key, f, _, valid = _hash_groupby_input(100, 0)
    with pytest.raises(ValueError, match="contract"):
        TH.hash_groupby_u32(_t(key), [torch.from_numpy(f)],
                            torch.from_numpy(valid), ["median"])


@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_carry_fallback_matches_jax(kind):
    rng = np.random.default_rng(11)
    if kind == "uniform":
        key = rng.integers(0, 3000, N).astype(np.uint32)
    else:
        key = (rng.integers(0, 6, N) * 700_000_003).astype(np.uint32)
    f = rng.normal(0, 10, N).astype(np.float32)
    i = rng.integers(-1000, 1000, N).astype(np.int32)
    valid = rng.random(N) > 0.1
    aggs = ["sum", "count", "min", "max", "sum"]
    jv = [f, f, f, i, i]
    wk, wo, wv = SH._local_groupby_carry(
        jnp.asarray(key), [jnp.asarray(x) for x in jv], jnp.asarray(valid),
        aggs)
    gk, go, gv = TH.local_groupby_carry(
        _t(key), [torch.from_numpy(x) for x in jv], torch.from_numpy(valid),
        aggs)
    wm, gm = np.asarray(wv), gv.numpy()
    assert wm.sum() == gm.sum() == len(np.unique(key[valid]))
    wo_ = np.argsort(np.asarray(wk)[wm], kind="stable")
    go_ = np.argsort(gk.numpy()[gm], kind="stable")
    assert np.array_equal(np.asarray(wk)[wm][wo_].astype(np.int64),
                          gk.numpy()[gm][go_])
    w = [np.asarray(x)[wm][wo_] for x in wo]
    g = [x.numpy()[gm][go_] for x in go]
    s = w[0].astype(np.float64)
    assert np.all(np.abs(g[0] - s) <= 1e-2 + 1e-4 * np.abs(s))
    for j in (1, 2, 3, 4):
        assert g[j].dtype == w[j].dtype and np.array_equal(g[j], w[j]), j


def test_group_ids_take_the_fallback_only_when_refused():
    rng = np.random.default_rng(4)
    valid = torch.from_numpy(rng.random(N) > 0.2)
    fast = _t(rng.integers(0, 5000, N).astype(np.uint32))
    slow = _t((rng.integers(0, 8, N) * 500_000_011).astype(np.uint32))
    TH.FALLBACKS = 0
    for key, fallbacks in ((fast, 0), (slow, 1)):
        gid, codes, ngroups = TH.group_ids(key, valid)
        assert TH.FALLBACKS == fallbacks
        k = int(ngroups)
        assert k == len(torch.unique(key[valid]))
        # each live row's group holds its key; dead rows are outside
        assert torch.equal(codes[gid[valid].long()], key[valid])
        assert bool((gid[~valid] == N).all())
        assert bool((codes[k:] == 1 << 32).all())
