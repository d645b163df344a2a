"""The distributed units of the port against the JAX package.

The same seeded numpy inputs go through the JAX package on its 8-device
CPU mesh (`shard_map` programs built here around its per-shard
functions, or its own builders) and through the port on a mesh of 8 CPU
slots (`make_mesh(8, device="cpu")`), each of whose kernels runs its
plain version there. Tolerances: exact (bit for bit) for the key
packing, every exchanged buffer, drop counts, group keys, counts,
integer sums, min/max and join row pairs; f64 sums within rtol 1e-12;
f32 sums within 1e-4 relative (the JAX CPU path adds them in f32, the
port in f64).
"""

import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from polaroid_tpu.ops import hgroup as RHG
from polaroid_tpu.ops import keycode as RKC
from polaroid_tpu.parallel import mesh as RM
from polaroid_tpu.parallel import shuffle as RSH
from polaroid_tpu_torch import dtypes as DT
from polaroid_tpu_torch.ops import hgroup as TH
from polaroid_tpu_torch.ops import keycode as KC
from polaroid_tpu_torch.parallel import mesh as TMESH
from polaroid_tpu_torch.parallel import shuffle as SH


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


S = 8


@pytest.fixture(scope="module")
def rmesh():
    return RM.make_mesh(S)


@pytest.fixture(scope="module")
def tmesh():
    return TMESH.make_mesh(S, device="cpu")


def _i64(x: np.ndarray) -> torch.Tensor:
    """u64 (or smaller) numpy values as the port holds them: int64 bits."""
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.uint64)
                            .view(np.int64))


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _ref_sharded(mesh, step, n_in, n_out, spec=None):
    spec = spec or P(RM.AXIS)
    return jax.jit(shard_map(step, mesh=mesh, in_specs=(spec,) * n_in,
                             out_specs=(spec,) * n_out))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_mesh_layouts():
    m = TMESH.make_mesh(8, device="cpu")
    assert m.size == 8 and m.shape == {"shards": 8}
    assert m.home == torch.device("cpu")
    assert not TMESH.is_mesh_2d(m) and TMESH.total_shards(m) == 8
    m2 = TMESH.make_mesh2(2, 4, device="cpu")
    assert m2.shape == {"hosts": 2, "chips": 4}
    assert TMESH.is_mesh_2d(m2) and TMESH.total_shards(m2) == 8
    m3 = TMESH.make_mesh(devices=["cpu"] * 3)
    assert m3.size == 3


def test_default_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TMESH.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TMESH.make_mesh2(2, 2)


def test_run_sharded_splits_and_concatenates(tmesh):
    x = torch.arange(64)
    blocks = SH.shard_rows(tmesh, x)
    assert [b.data_ptr() for b in blocks] == \
        [x[i * 8:].data_ptr() for i in range(8)]     # views on one device
    out = SH.run_sharded(tmesh, lambda b: (b * 2, b[:1]), x)
    assert torch.equal(out[0], x * 2)
    assert torch.equal(out[1], x[::8])
    with pytest.raises(ValueError, match="multiple"):
        SH.shard_rows(tmesh, torch.arange(60))


# ---------------------------------------------------------------------------
# the bit-budget key packing
# ---------------------------------------------------------------------------

def _key_columns(rng, n):
    """(name, numpy values, port dtype) of every key dtype."""
    return [
        ("i8", rng.integers(-128, 128, n).astype(np.int8), DT.Int8),
        ("i16", rng.integers(-3000, 3000, n).astype(np.int16), DT.Int16),
        ("i32", rng.integers(-2**31, 2**31, n).astype(np.int32), DT.Int32),
        ("i64", rng.integers(-2**40, 2**40, n).astype(np.int64), DT.Int64),
        ("u8", rng.integers(0, 256, n).astype(np.uint8), DT.UInt8),
        ("u32", rng.integers(0, 2**32, n).astype(np.uint32), DT.UInt32),
        ("u64", rng.integers(0, 2**63, n).astype(np.uint64) * 2 + 1,
         DT.UInt64),
        ("f32", rng.normal(0, 1e3, n).astype(np.float32), DT.Float32),
        ("f64", np.concatenate([[-0.0, 0.0, np.inf, -np.inf],
                                rng.normal(0, 1e6, n - 4)]), DT.Float64),
        ("bool", rng.uniform(size=n) > 0.5, DT.Boolean),
    ]


def _storage(x: np.ndarray, dt) -> torch.Tensor:
    from polaroid_tpu_torch.batch import storage_torch_dtype
    if dt == DT.UInt64:
        return _i64(x)
    return torch.from_numpy(np.ascontiguousarray(x).astype(
        torch.empty(0, dtype=storage_torch_dtype(dt)).numpy().dtype))


@pytest.mark.parametrize("nulls", [False, True])
def test_column_bit_width_and_packing_bit_exact(nulls):
    rng = np.random.default_rng(3)
    n = 300
    for name, x, dt in _key_columns(rng, n):
        valid = rng.uniform(size=n) > 0.2 if nulls else None
        rb, rmn = RKC.column_bit_width(
            jnp.asarray(x), None if valid is None else jnp.asarray(valid))
        tb, tmn = KC.column_bit_width(
            _storage(x, dt), dt,
            None if valid is None else torch.from_numpy(valid))
        assert (tb, tmn) == (int(rb), int(rmn)), name
    # several columns in one word, nulls first and last
    cols = _key_columns(rng, n)
    picks = [c for c in cols if c[0] in ("i8", "u8", "bool", "f32")]
    valids = [rng.uniform(size=n) > 0.3 if nulls else None for _ in picks]
    for nulls_last in ([False] * 4, [True, False, True, True]):
        rbits, rmins, tbits, tmins = [], [], [], []
        for (_, x, dt), v in zip(picks, valids):
            b, mn = RKC.column_bit_width(
                jnp.asarray(x), None if v is None else jnp.asarray(v))
            rbits.append(int(b))
            rmins.append(jnp.uint64(int(mn)))
            b2, mn2 = KC.column_bit_width(
                _storage(x, dt), dt,
                None if v is None else torch.from_numpy(v))
            tbits.append(b2)
            tmins.append(mn2)
        assert rbits == tbits
        ref = np.asarray(RKC.pack_keys_single_word(
            [jnp.asarray(x) for _, x, _ in picks],
            [None if v is None else jnp.asarray(v) for v in valids],
            rbits, rmins, nulls_last=nulls_last))
        got = KC.pack_keys_single_word(
            [_storage(x, dt) for _, x, dt in picks],
            [dt for _, _, dt in picks],
            [None if v is None else torch.from_numpy(v) for v in valids],
            tbits, tmins, nulls_last=nulls_last)
        assert np.array_equal(_u64(got), ref)
        ru = RKC.unpack_keys_single_word(jnp.asarray(ref), rbits)
        tu = KC.unpack_keys_single_word(got, tbits)
        for a, b in zip(ru, tu):
            assert np.array_equal(np.asarray(a), _u64(b))


@pytest.mark.parametrize("top", [53, 63])
def test_bit_width_of_spans_near_2_53_and_2_63(top):
    """Spans around 2^top: the port's width is exact, (span + 1)
    .bit_length(), everywhere. The JAX package takes ceil(log2(span + 2))
    in f64, which agrees below 2^top - 1 and counts one bit too few from
    there to where log2 resolves past the integer (at span 2^top - 1 and
    2^top itself, among others): too few for the code span + 1 (kept in
    ROADMAP Queue 3)."""
    base = np.uint64(7)
    for d in (-(1 << 12), -3, -2, -1, 0, 1, 2, 1 << 12):
        span = (1 << top) + d
        x = np.array([base, base + np.uint64(span)], dtype=np.uint64)
        rb, _ = RKC.column_bit_width(jnp.asarray(x), None)
        tb, tmn = KC.column_bit_width(_i64(x), DT.UInt64, None)
        exact = (span + 1).bit_length()
        assert tb == exact and tmn == 7
        if d < -1:
            assert int(rb) == exact, d
        else:
            assert int(rb) in (exact - 1, exact), d
        if d in (-1, 0):
            assert int(rb) == exact - 1     # the JAX package's undercount


def test_pack_refuses_more_than_64_bits():
    with pytest.raises(ValueError, match="exceeds 64"):
        KC.pack_keys_single_word([torch.zeros(2, dtype=torch.int64)] * 2,
                                 [DT.Int64] * 2, [None, None], [40, 30],
                                 [0, 0])


# ---------------------------------------------------------------------------
# exchanges
# ---------------------------------------------------------------------------

def _exchange_inputs(n, seed):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 2**63, n).astype(np.uint64) * 2 + 1
    dest = rng.integers(0, S, n).astype(np.uint32)
    dest[:40] = 3          # shard 0 sends 40+ records to shard 3
    valid = rng.uniform(size=n) > 0.2
    pay_f = rng.normal(size=n)
    pay_i = rng.integers(-9, 9, n).astype(np.int32)
    return key, dest, valid, pay_f, pay_i


def _port_exchange(tmesh, two_d, key, dest, valid, pay_f, pay_i, P_):
    d, k, v, pf, pi = SH._shard_all(
        tmesh, torch.from_numpy(dest.astype(np.int64)), _i64(key),
        torch.from_numpy(valid), torch.from_numpy(pay_f),
        torch.from_numpy(pay_i))
    pays = [[a, b] for a, b in zip(pf, pi)]
    if two_d:
        out = SH.exchange_records_2d(d, k, pays, v, 2, 4, P_,
                                     tmesh.devices, with_overflow=True)
    else:
        out = SH.exchange_records(d, k, pays, v, S, P_, tmesh.devices,
                                  with_overflow=True)
    rk, rp, rv, dr = out
    return (_u64(torch.cat(rk)), torch.cat([p[0] for p in rp]).numpy(),
            torch.cat([p[1] for p in rp]).numpy(), torch.cat(rv).numpy(),
            torch.stack(dr).numpy())


@pytest.mark.parametrize("two_d", [False, True])
def test_exchange_records_bit_exact(rmesh, tmesh, two_d):
    """Every exchanged buffer (keys, both payloads, validity, the zero
    fills) and each shard's drop count, with shard 0's destination 3
    over its capacity."""
    n, P_ = S * 64, 16
    key, dest, valid, pay_f, pay_i = _exchange_inputs(n, 0)
    if two_d:
        m2 = RM.make_mesh2(2, 4)
        spec = P((RM.HOST_AXIS, RM.CHIP_AXIS))

        def step(d, k, pf, pi, v):
            k2, p2, v2, dr = RSH.exchange_records_2d(
                d, k, [pf, pi], v, 2, 4, P_, RM.HOST_AXIS, RM.CHIP_AXIS,
                with_overflow=True)
            return k2, p2[0], p2[1], v2, dr[None]
        fn = _ref_sharded(m2, step, 5, 5, spec)
    else:
        def step(d, k, pf, pi, v):
            k2, p2, v2, dr = RSH.exchange_records(
                d, k, [pf, pi], v, S, P_, RM.AXIS, with_overflow=True)
            return k2, p2[0], p2[1], v2, dr[None]
        fn = _ref_sharded(rmesh, step, 5, 5)
    rk, rpf, rpi, rv, rd = [np.asarray(x) for x in fn(
        jnp.asarray(dest), jnp.asarray(key), jnp.asarray(pay_f),
        jnp.asarray(pay_i), jnp.asarray(valid))]
    gk, gpf, gpi, gv, gd = _port_exchange(tmesh, two_d, key, dest, valid,
                                          pay_f, pay_i, P_)
    assert np.array_equal(gk, rk)
    assert np.array_equal(gpf.view(np.uint64), rpf.view(np.uint64))
    assert np.array_equal(gpi, rpi)
    assert np.array_equal(gv, rv)
    assert np.array_equal(gd, rd) and gd.sum() > 0


def test_exchange_by_hash_routes_as_the_reference(rmesh, tmesh):
    n, P_ = S * 64, 64
    key, _, valid, pay_f, _ = _exchange_inputs(n, 1)

    def step(k, p, v):
        k2, p2, v2 = RSH.exchange_by_hash(k, [p], v, S, P_)
        return k2, p2[0], v2
    rk, rp, rv = [np.asarray(x) for x in _ref_sharded(rmesh, step, 3, 3)(
        jnp.asarray(key), jnp.asarray(pay_f), jnp.asarray(valid))]
    k, p, v = SH._shard_all(tmesh, _i64(key), torch.from_numpy(pay_f),
                            torch.from_numpy(valid))
    gk, gp, gv = SH.exchange_by_hash(k, [[b] for b in p], v, S, P_,
                                     tmesh.devices)
    assert np.array_equal(_u64(torch.cat(gk)), rk)
    assert np.array_equal(torch.cat([x[0] for x in gp]).numpy(), rp)
    assert np.array_equal(torch.cat(gv).numpy(), rv)
    # a join's row shuffle is this exchange
    sk, _, sv = SH.shuffle_rows_step(k, [[b] for b in p], v, S, P_,
                                     tmesh.devices)
    assert all(torch.equal(a, b) for a, b in zip(sk, gk))
    assert all(torch.equal(a, b) for a, b in zip(sv, gv))


# ---------------------------------------------------------------------------
# local group-bys
# ---------------------------------------------------------------------------

def test_local_groupby_matches_reference():
    rng = np.random.default_rng(4)
    n = 1024
    key = rng.integers(0, 61, n).astype(np.uint64) * 2**40
    valid = rng.uniform(size=n) > 0.15
    vf = rng.normal(0, 10, n)
    vi = rng.integers(-50, 50, n).astype(np.int32)
    aggs = ["sum", "count", "min", "max", "sum"]
    ref = RSH.local_groupby(jnp.asarray(key), [jnp.asarray(v) for v in
                                               (vf, vf, vi, vi, vi)],
                            jnp.asarray(valid), aggs)
    got = SH.local_groupby(_i64(key), [torch.from_numpy(v) for v in
                                       (vf, vf, vi, vi, vi)],
                           torch.from_numpy(valid), aggs)
    rv, gv = np.asarray(ref[2]), got[2].numpy()
    assert np.array_equal(rv, gv)
    assert np.array_equal(np.asarray(ref[0])[rv], _u64(got[0])[gv])
    rs, gs = np.asarray(ref[1][0])[rv], got[1][0].numpy()[gv]
    np.testing.assert_allclose(gs, rs, rtol=1e-12)
    for r, g in zip(ref[1][1:], got[1][1:]):
        assert np.array_equal(np.asarray(r)[rv], g.numpy()[gv])


def _adaptive_inputs(case, n=2 * 8192):
    rng = np.random.default_rng(7)
    valid = rng.uniform(size=n) > 0.1
    if case == "dense_1024":
        key = rng.integers(5000, 5000 + 900, n)
    elif case == "dense_8192":
        key = rng.integers(100, 100 + 5000, n)
    elif case == "hash":
        key = rng.integers(0, 1 << 32, n)
    else:   # two keys far apart: each bucket cell holds over CAP rows
        key = rng.choice([7, 123456789], n)
    return (key.astype(np.uint32), valid,
            rng.normal(0, 10, n).astype(np.float32))


_REF_ADAPTIVE = []


def _ref_adaptive(key, vals, valid, aggs):
    """The JAX package's adaptive group-by under one jit (every case has
    the same shapes, so its four branches compile once)."""
    if not _REF_ADAPTIVE:
        def f(k, vs, m):
            return RHG.adaptive_local_groupby(
                k, list(vs), m, aggs,
                lambda: RSH._local_groupby_carry(k, list(vs), m, aggs))
        _REF_ADAPTIVE.append(jax.jit(f))
    return _REF_ADAPTIVE[0](key, tuple(vals), valid)


@pytest.mark.parametrize("case", ["dense_1024", "dense_8192", "hash",
                                  "carry"])
def test_adaptive_local_groupby_routes_match_reference(case):
    """Each route of the adaptive group-by, called directly: the JAX
    package on its CPU branches, the port on its kernels' plain
    versions; the same slot layout, keys and counts exact, f32 sums
    within 1e-4 relative, min/max bit for bit. On the dense routes the
    JAX package's CPU branch shifts min and max by one slot (its
    `_seg_unsorted_dense` keeps the dead rows' id -1), so there they are
    held to numpy (ROADMAP Queue 3)."""
    key, valid, v = _adaptive_inputs(case)
    aggs = ["sum", "count", "min", "max"]
    ref = _ref_adaptive(jnp.asarray(key), [jnp.asarray(v)] * 4,
                        jnp.asarray(valid), aggs)
    TH.ADAPTIVE_ROUTES.clear()
    tk = torch.from_numpy(key.astype(np.int64))
    tvals = [torch.from_numpy(v)] * 4
    tvalid = torch.from_numpy(valid)
    got = TH.adaptive_local_groupby(
        tk, tvals, tvalid, aggs,
        lambda: SH._local_groupby_carry(tk, tvals, tvalid, aggs, DT.UInt32))
    assert dict(TH.ADAPTIVE_ROUTES) == {case: 1}
    rv, gv = np.asarray(ref[2]), got[2].numpy()
    assert np.array_equal(rv, gv)
    gkeys = got[0].numpy()[gv]
    assert np.array_equal(np.asarray(ref[0])[rv].astype(np.int64), gkeys)
    np.testing.assert_allclose(got[1][0].numpy()[gv],
                               np.asarray(ref[1][0])[rv], rtol=1e-4,
                               atol=1e-3)
    assert np.array_equal(np.asarray(ref[1][1])[rv], got[1][1].numpy()[gv])
    lo = {int(k): np.inf for k in gkeys}
    hi = {int(k): -np.inf for k in gkeys}
    for k, x in zip(key[valid].tolist(), v[valid].tolist()):
        lo[k], hi[k] = min(lo[k], x), max(hi[k], x)
    for i, oracle in ((2, lo), (3, hi)):
        want = np.array([oracle[int(k)] for k in gkeys], np.float32)
        assert np.array_equal(got[1][i].numpy()[gv], want)
        if not case.startswith("dense"):
            assert np.array_equal(np.asarray(ref[1][i])[rv], want)


# ---------------------------------------------------------------------------
# sharded builders against the JAX package's
# ---------------------------------------------------------------------------

ROWS = 1024


def _groups(k, gv, *outs):
    gv = np.asarray(gv)
    keys = np.asarray(k)[gv]
    return {int(kk): tuple(np.asarray(o)[gv][i] for o in outs)
            for i, kk in enumerate(keys.view(np.uint64))}


def _group_inputs(seed):
    rng = np.random.default_rng(seed)
    n = S * ROWS
    key = rng.integers(0, 3000, n).astype(np.uint64) * 977
    val = rng.normal(0, 10, n)
    valid = rng.uniform(size=n) > 0.1
    return key, val, valid


def _same_groups(rgot, tgot):
    assert set(rgot) == set(tgot)
    for k in rgot:
        rs, rc = rgot[k]
        ts, tc = tgot[k]
        assert rc == tc
        np.testing.assert_allclose(ts, rs, rtol=1e-12)


def test_make_sharded_groupby_matches_reference(rmesh, tmesh):
    key, val, valid = _group_inputs(0)
    sh = NamedSharding(rmesh, P(RM.AXIS))
    put = lambda a: jax.device_put(jnp.asarray(a), sh)    # noqa: E731
    gk, gv, dr, s, c = RSH.make_sharded_groupby(rmesh, ["sum", "count"],
                                                ROWS)(put(key), put(valid),
                                                      put(val), put(val))
    tk, tv, td, ts, tc = SH.make_sharded_groupby(tmesh, ["sum", "count"],
                                                 ROWS)(
        _i64(key), torch.from_numpy(valid), torch.from_numpy(val),
        torch.from_numpy(val))
    assert np.array_equal(td.numpy(), np.asarray(dr))
    # every group on the same slot as in the JAX package
    assert np.array_equal(tv.numpy(), np.asarray(gv))
    assert np.array_equal(_u64(tk)[tv.numpy()], np.asarray(gk)[np.asarray(gv)])
    _same_groups(_groups(gk, gv, s, c), _groups(_u64(tk), tv, ts, tc))


def test_groupby_partials_and_merge_match_reference(rmesh, tmesh):
    key, val, valid = _group_inputs(1)
    sh = NamedSharding(rmesh, P(RM.AXIS))
    put = lambda a: jax.device_put(jnp.asarray(a), sh)    # noqa: E731
    o1 = RSH.make_groupby_partials(rmesh, ["sum", "count"])(
        put(key), put(valid), put(val), put(val))
    t1 = SH.make_groupby_partials(tmesh, ["sum", "count"])(
        _i64(key), torch.from_numpy(valid), torch.from_numpy(val),
        torch.from_numpy(val))
    assert np.array_equal(t1[2].numpy(), np.asarray(o1[2]))
    per_dest = int(np.asarray(o1[2]).max())
    from polaroid_tpu_torch.config import capacity_for
    per_dest = capacity_for(per_dest)
    r = RSH.make_groupby_merge(rmesh, ["sum", "count"], per_dest)(
        o1[0], o1[1], *o1[3:])
    t = SH.make_groupby_merge(tmesh, ["sum", "count"], per_dest)(
        t1[0], t1[1], *t1[3:])
    assert int(t[2].sum()) == 0 == int(np.asarray(r[2]).sum())
    assert np.array_equal(t[1].numpy(), np.asarray(r[1]))
    _same_groups(_groups(r[0], r[1], r[3], r[4]),
                 _groups(_u64(t[0]), t[1], t[3], t[4]))


def test_2d_mesh_equals_1d_mesh(tmesh):
    """The (hosts x chips) mesh's two-stage exchange gives the flat
    mesh's groups, and the JAX package's 2-D builder's."""
    key, val, valid = _group_inputs(2)
    args = (_i64(key), torch.from_numpy(valid), torch.from_numpy(val),
            torch.from_numpy(val))
    a = SH.make_sharded_groupby(tmesh, ["sum", "count"], ROWS)(*args)
    m2 = TMESH.make_mesh2(2, 4, device="cpu")
    b = SH.make_sharded_groupby_2d(m2, ["sum", "count"], ROWS)(*args)
    assert int(a[2].sum()) == 0 == int(b[2].sum())
    ga = _groups(_u64(a[0]), a[1], a[3], a[4])
    gb = _groups(_u64(b[0]), b[1], b[3], b[4])
    _same_groups(ga, gb)
    rm2 = RM.make_mesh2(2, 4)
    sh = NamedSharding(rm2, P((RM.HOST_AXIS, RM.CHIP_AXIS)))
    put = lambda x: jax.device_put(jnp.asarray(x), sh)    # noqa: E731
    r = RSH.make_sharded_groupby_2d(rm2, ["sum", "count"], ROWS)(
        put(key), put(valid), put(val), put(val))
    assert np.array_equal(b[1].numpy(), np.asarray(r[1]))
    _same_groups(_groups(r[0], r[1], r[3], r[4]), gb)


@pytest.mark.parametrize("how", ["inner", "left"])
def test_make_sharded_join_matches_reference(rmesh, tmesh, how):
    rng = np.random.default_rng(5)
    n = S * ROWS
    lkey = rng.integers(0, 300, n).astype(np.uint64)
    rkey = rng.integers(0, 600, n).astype(np.uint64)
    rvalid = rng.uniform(size=n) > 0.5
    lvalid = np.ones(n, bool)
    lval = np.arange(n, dtype=np.int64)
    rval = np.arange(n, dtype=np.int64) * 10
    out_cap = 16 * ROWS
    sh = NamedSharding(rmesh, P(RM.AXIS))
    put = lambda a: jax.device_put(jnp.asarray(a), sh)    # noqa: E731
    r = RSH.make_sharded_join(rmesh, 1, 1, per_dest_cap=ROWS,
                              out_cap=out_cap, how=how)(
        put(lkey), put(lvalid), put(rkey), put(rvalid), put(lval),
        put(rval))
    t = SH.make_sharded_join(tmesh, 1, 1, per_dest_cap=ROWS,
                             out_cap=out_cap, how=how)(
        _i64(lkey), torch.from_numpy(lvalid), _i64(rkey),
        torch.from_numpy(rvalid), torch.from_numpy(lval),
        torch.from_numpy(rval))
    assert int(t[4].sum()) == 0 == int(np.asarray(r[4]).sum())
    for a, b in zip(r[:4], t[:4]):
        b = _u64(b) if b.dtype == torch.int64 else b.numpy()
        assert np.array_equal(np.asarray(a), b)
    jv = t[1].numpy()
    for a, b in zip(r[5:], t[5:]):
        assert np.array_equal(np.asarray(a)[jv], b.numpy()[jv])
    # the row pairs, against the host
    rc = collections.defaultdict(list)
    for k, v, m in zip(rkey.tolist(), rval.tolist(), rvalid.tolist()):
        if m:
            rc[k].append(v)
    want = sorted((k, lv, rv) for k, lv in zip(lkey.tolist(), lval.tolist())
                  for rv in (rc[k] or ([None] if how == "left" else [])))
    rm = t[3].numpy()[jv]
    got = sorted((int(k), int(lv), int(rv) if m else None) for k, lv, rv, m
                 in zip(_u64(t[0])[jv], t[5].numpy()[jv], t[6].numpy()[jv],
                        rm))
    assert got == want


@pytest.mark.parametrize("keep", ["first", "none"])
def test_make_sharded_unique_matches_reference(rmesh, tmesh, keep):
    rng = np.random.default_rng(6)
    n = S * ROWS
    key = rng.integers(0, 2000, n).astype(np.uint64)
    valid = rng.uniform(size=n) > 0.1
    rowidx = np.arange(n, dtype=np.int32)
    pay = rng.normal(size=n)
    sh = NamedSharding(rmesh, P(RM.AXIS))
    put = lambda a: jax.device_put(jnp.asarray(a), sh)    # noqa: E731
    r = RSH.make_sharded_unique(rmesh, ROWS, keep, 1, out_cap=2 * ROWS)(
        put(key), put(valid), put(rowidx), put(pay))
    t = SH.make_sharded_unique(tmesh, ROWS, keep, 1, out_cap=2 * ROWS)(
        _i64(key), torch.from_numpy(valid), torch.from_numpy(rowidx),
        torch.from_numpy(pay))
    assert int(t[1].sum()) == 0 == int(np.asarray(r[1]).sum())
    for a, b in zip((r[0], r[2], r[3]), (t[0], t[2], t[3])):
        assert np.array_equal(np.asarray(a), b.numpy())
    # against the host: the representative rows
    first = {}
    cnt = collections.Counter(key[valid].tolist())
    for i in np.flatnonzero(valid):
        first.setdefault(int(key[i]), i)
    want = sorted(i for k, i in first.items()
                  if keep == "first" or cnt[k] == 1)
    assert sorted(t[2].numpy()[t[0].numpy()].tolist()) == want


def test_mix128to64_matches_reference():
    from polaroid_tpu.exec import distributed as RD
    from polaroid_tpu_torch.exec import distributed as TD
    rng = np.random.default_rng(8)
    hi = rng.integers(0, 2**63, 500).astype(np.uint64) * 2 + 1
    lo = rng.integers(0, 2**63, 500).astype(np.uint64) * 3
    for salt in (0, 1, 7):
        ref = np.asarray(RD._mix128to64(jnp.asarray(hi), jnp.asarray(lo),
                                        salt))
        got = TD._mix128to64(_i64(hi), _i64(lo), salt)
        assert np.array_equal(_u64(got), ref)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_entry_step_matches_reference():
    import __graft_entry__ as ge
    from polaroid_tpu_torch.entry import entry
    rfn, rargs = ge.entry()
    tfn, targs = entry(device="cpu")
    for a, b in zip(rargs, targs):
        assert np.array_equal(np.asarray(a), b.numpy())
    ref = [np.asarray(x) for x in rfn(*rargs)]
    got = [x.numpy() for x in tfn(*targs)]
    gv = got[-1]
    assert np.array_equal(ref[-1], gv)
    assert np.array_equal(ref[0][gv].astype(np.int64), got[0][gv])
    assert np.array_equal(ref[2][gv], got[2][gv])
    for i in (1, 3):
        np.testing.assert_allclose(got[i][gv], ref[i][gv], rtol=1e-4)
    for i in (4, 5):
        assert np.array_equal(ref[i][gv], got[i][gv])


def test_dryrun_multichip_on_8_cpu_slots():
    from polaroid_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(8, device="cpu")
