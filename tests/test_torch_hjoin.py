"""The collocated hash join through the JAX package and through the port.

`mix31` is held bit for bit; `lookup_join_collocated` and
`collocated_join` are called directly in both packages on the CPU (the
JAX side runs its Pallas exchange kernel in interpret mode, as
`tests/test_hjoin.py` does; the port runs kernel E's plain version) and
compared as row multisets, since rows come out in collocated order. The
three refusals (`ok` False) are checked to fall through to another route
with the right answer, and the port's own differences from the JAX
package's collocated route (null keys of a left join, the key whose w is
the pad word, Float32 -0.0) are held against the JAX package's CPU join.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polaroid_tpu as ref
from polaroid_tpu.ops import hjoin as RH
from polaroid_tpu.ops import join as RJ
import polaroid_tpu_torch as pt
from polaroid_tpu_torch.ops import hjoin as TH
from polaroid_tpu_torch.ops import join as TJ
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


M31 = (1 << 31) - 1


def test_mix31_matches_jax_and_inverts():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, M31 + 1, 4000),
                        [0, 1, M31, M31 - 1, 1 << 30]]).astype(np.uint32)
    got = TH.mix31(torch.from_numpy(x.astype(np.int64)))
    want = np.asarray(RH.mix31(jnp.asarray(x)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert np.array_equal(TH.mix31_inv(got).numpy(), x.astype(np.int64))
    back = np.asarray(RH.mix31_inv(jnp.asarray(want)))
    assert np.array_equal(TH.mix31_inv(got).numpy(), back.astype(np.int64))


def _lookup_rows(pidx, value, hit, live):
    p, v, h, lv = (np.asarray(a) for a in (pidx, value, hit, live))
    return sorted((int(p[i]), struct.pack("<f", v[i]), bool(h[i]))
                  for i in np.nonzero(lv)[0])


@pytest.mark.parametrize("case", ["unique", "skewed"])
def test_lookup_join_collocated_matches_jax(case):
    rng = np.random.default_rng(1)
    nb, npr = 4096, 5 * 8192
    bkey = rng.permutation(200_000)[:nb].astype(np.uint32)
    bval = rng.normal(size=nb).astype(np.float32)
    pkey = rng.integers(0, 200_000, npr).astype(np.uint32)
    if case == "skewed":
        # one build key on every 100th probe row: about 82 in each
        # block's cell (under CAP), a run of 410 in its bucket row, longer
        # than the JAX package's 256-row ladder
        pkey[::100] = bkey[7]
    t = TH.lookup_join_collocated(torch.from_numpy(bkey.astype(np.int64)),
                                  torch.from_numpy(bval),
                                  torch.from_numpy(pkey.astype(np.int64)))
    r = RH.lookup_join_collocated(jnp.asarray(bkey), jnp.asarray(bval),
                                  jnp.asarray(pkey))
    assert bool(t[4]) and bool(r[4])
    got = _lookup_rows(*t[:4])
    assert got == _lookup_rows(*r[:4])
    # and against the values: every probe row once, hit iff its key is built
    lut = dict(zip(bkey.tolist(), bval.tolist()))
    assert [p for p, _, _ in got] == list(range(npr))
    for p, v, h in got:
        assert h == (int(pkey[p]) in lut)
        if h:
            assert v == struct.pack("<f", lut[int(pkey[p])])


def _tables(lcols, rcols, lvalid=None, rvalid=None):
    """The two sides as JAX and port tables, with both packages' unified
    key Vals and masks, as join_tables hands them to collocated_join."""
    def both(cols, valid):
        valid = valid or {}
        rc = {k: [x[i].item() if valid[k][i] else None
                  for i in range(len(x))] if k in valid else x
              for k, x in cols.items()}
        tdf = frame_from_numpy(cols, validity=valid, device="cpu")
        schema = {k: getattr(ref, repr(tdf.schema[k])) for k in valid}
        return ref.DataFrame(rc, schema=schema)._table, tdf._table
    (rl, tl), (rr, tr) = both(lcols, lvalid), both(rcols, rvalid)
    rlv, rrv = RJ._unify_keys(RJ._key_vals(rl, ["k"]),
                              RJ._key_vals(rr, ["k"]))
    tlv, trv = TJ._unify_keys(TJ._key_vals(tl, ["k"]),
                              TJ._key_vals(tr, ["k"]))

    def mask(t, v):
        m = t.row_mask()
        return m if v[0].validity is None else m & v[0].validity
    return ((rl, rr, rlv, rrv, mask(rl, rlv), mask(rr, rrv)),
            (tl, tr, tlv, trv, mask(tl, tlv), mask(tr, trv)))


def _live_rows(t, names, valid=None):
    valid = np.ones(t.capacity, bool) if valid is None else np.asarray(valid)
    out = []
    datas = {n: (np.asarray(t.cols[n].data),
                 None if t.cols[n].validity is None
                 else np.asarray(t.cols[n].validity)) for n in names}
    for i in np.nonzero(valid)[0]:
        row = []
        for n in names:
            d, v = datas[n]
            row.append(None if v is not None and not v[i]
                       else d[i].tobytes())
        out.append(tuple(row))
    return sorted(out, key=repr)


def _collocated_both(lcols, rcols, how, lvalid=None, rvalid=None):
    (R, T) = _tables(lcols, rcols, lvalid, rvalid)
    rres = RH.collocated_join(R[0], R[1], ["k"], ["k"], how, "_right", True,
                              R[2], R[3], R[4], R[5])
    tres = TH.collocated_join(T[0], T[1], ["k"], ["k"], how, "_right", True,
                              T[2], T[3], T[4], T[5])
    return rres, tres


def _rows_of(table, valid=None):
    """Live rows of a table of either package as tuples of raw bytes
    (None for null)."""
    names = list(table.names)
    if valid is None:
        n = table.count_rows() if hasattr(table, "count_rows") else None
        valid = np.arange(table.capacity) < n
    return _live_rows(table, names, valid)


CAPL, CAPR = 3 * 8192, 8192


def _sides(seed: int):
    """Left keys over 150,000 values, unique right keys over 200,000
    (a span past the dense route's 2^16), and payloads of three dtypes,
    one nullable: every direct call shares this layout, so the JAX
    package compiles its collocated program once per key dtype and
    kind."""
    rng = np.random.default_rng(seed)
    lcols = {"k": rng.integers(0, 150_000, CAPL).astype(np.int32),
             "lv": rng.normal(size=CAPL),
             "li": rng.integers(0, 9, CAPL).astype(np.int32)}
    rcols = {"k": rng.permutation(200_000)[:CAPR].astype(np.int32),
             "rv": rng.normal(size=CAPR).astype(np.float32)}
    return lcols, rcols, {"rv": rng.random(CAPR) < 0.9}


@pytest.mark.parametrize("how,key", [("inner", "Int32"), ("left", "Int32"),
                                     ("inner", "Int64")])
def test_collocated_join_matches_jax(how, key):
    lcols, rcols, rvalid = _sides(2)
    if key == "Int64":
        # negative keys: both sides ride one word (key - min)
        lcols["k"] = lcols["k"].astype(np.int64) - 20_000
        rcols["k"] = rcols["k"].astype(np.int64) - 20_000
    (rt, rok), (tt, tok) = _collocated_both(lcols, rcols, how,
                                            rvalid=rvalid)
    assert bool(rok) and bool(tok)
    assert list(tt.names) == list(rt.names) == ["k", "lv", "li", "rv"]
    assert _rows_of(tt) == _rows_of(rt, rt.valid)


def _refused_and_falls_through(lcols, rcols, rvalid):
    """Both packages' collocated joins refuse (`ok` False), and the
    port's join_tables takes another route and matches the JAX
    package's CPU join; returns that route."""
    rres, tres = _collocated_both(lcols, rcols, "inner", rvalid=rvalid)
    assert (bool(rres[1]), bool(tres[1])) == (False, False)
    rr = {k: [v.item() if ok else None for v, ok in zip(x, rvalid[k])]
          if k in rvalid else x for k, x in rcols.items()}
    rdr = ref.DataFrame(rr, schema={"rv": ref.Float32})
    tdr = frame_from_numpy(rcols, validity=rvalid, device="cpu")
    TJ.ROUTES.clear()
    got = frame_from_numpy(lcols, device="cpu").join(tdr, on="k")
    want = ref.DataFrame(lcols).join(rdr, on="k")
    assert sorted(zip(*got.to_dict().values()), key=repr) == \
        sorted(zip(*want.to_dict().values()), key=repr)
    return dict(TJ.ROUTES)


def test_refuses_a_key_past_31_bits():
    """A negative Int32 key: its u32 word is above 2^31 - 1."""
    lcols, rcols, rvalid = _sides(3)
    rcols["k"][5] = -12
    lcols["k"][:50] = -12
    assert _refused_and_falls_through(lcols, rcols, rvalid) == \
        {"dense_m1": 1}


def test_refuses_a_duplicate_right_key():
    lcols, rcols, rvalid = _sides(4)
    rcols["k"][100] = rcols["k"][200]
    assert _refused_and_falls_through(lcols, rcols, rvalid) == \
        {"dense_expand": 1}


def test_refuses_a_cell_past_cap():
    lcols, rcols, rvalid = _sides(5)
    lcols["k"][8192:8192 + 1000] = rcols["k"][9]  # 1000 rows in one cell
    assert _refused_and_falls_through(lcols, rcols, rvalid) == \
        {"dense_m1": 1}


def _join_both(lcols, rcols, how, lvalid=None, route="collocated"):
    """join_tables in both packages (the JAX package's CPU routes), the
    port asserted to take `route`; rows compared as multisets of raw
    bytes."""
    lvalid = lvalid or {}
    rl = {k: [x[i].item() if lvalid[k][i] else None for i in range(len(x))]
          if k in lvalid else x for k, x in lcols.items()}
    tl = frame_from_numpy(lcols, validity=lvalid, device="cpu")
    schema = {k: getattr(ref, repr(tl.schema[k])) for k in lvalid}
    rdf = ref.DataFrame(rl, schema=schema)
    tr = frame_from_numpy(rcols, device="cpu")
    TJ.ROUTES.clear()
    got = tl.join(tr, on="k", how=how)
    assert dict(TJ.ROUTES) == {route: 1}
    want = rdf.join(ref.DataFrame(rcols), on="k", how=how)
    g, w = got.to_dict(), want.to_dict()
    assert list(g) == list(w)

    def rws(d):
        return sorted((tuple(struct.pack("<d", v) if isinstance(v, float)
                             else v for v in r) for r in zip(*d.values())),
                      key=repr)
    assert rws(g) == rws(w)
    return got


def test_left_join_keeps_null_key_rows():
    """The JAX package's collocated route drops them (its probe rows are
    the key-valid ones); its CPU route, and the port, keep them."""
    lcols, rcols, _ = _sides(6)
    lvalid = {"k": np.random.default_rng(6).random(CAPL) < 0.9}
    out = _join_both(lcols, rcols, "left", lvalid)
    assert out.height == CAPL
    R, _ = _tables(lcols, rcols, lvalid)
    rt, rok = RH.collocated_join(R[0], R[1], ["k"], ["k"], "left", "_right",
                                 True, R[2], R[3], R[4], R[5])
    assert bool(rok) and int(np.asarray(rt.valid).sum()) < CAPL


def test_key_whose_w_is_the_pad_word_joins():
    k = int(RH.mix31_inv(jnp.uint32(M31)))     # mix31(k) << 1 | 1 == FILL
    rng = np.random.default_rng(7)
    n = 3 * 8192
    lk = rng.integers(0, 150_000, n).astype(np.int32)
    rk = rng.permutation(200_000)[:8192].astype(np.int32)
    rk[0], lk[:5] = k, k
    out = _join_both({"k": lk, "a": np.arange(n)},
                     {"k": rk, "b": np.arange(8192)}, "inner")
    assert (np.asarray(out.to_dict()["k"]) == k).sum() == 5


@pytest.mark.parametrize("neg_zero", [False, True])
def test_float32_keys_join_on_their_bits(neg_zero):
    """NaN and 0.0 keys join by their bits on the collocated route; a
    -0.0 key (sign bit set: past 31 bits) is refused and the sort-merge
    route joins it apart from 0.0, as the JAX package's CPU join does
    (its collocated route would call -0.0 and 0.0 one key)."""
    rng = np.random.default_rng(8)
    n = 3 * 8192
    rk = (rng.permutation(200_000)[:8192] / 8).astype(np.float32)
    lk = rk[rng.integers(0, 8192, n)]
    rk[:2] = [0.0, np.nan]
    lk[:40] = -0.0 if neg_zero else 0.0
    lk[40:80] = np.nan
    out = _join_both({"k": lk, "a": np.arange(n)},
                     {"k": rk, "b": np.arange(8192)}, "inner",
                     route="sortmerge_m1" if neg_zero else "collocated")
    zeros = (np.asarray(out.to_dict()["a"]) < 40).sum()
    assert zeros == (0 if neg_zero else 40)


@pytest.mark.parametrize("after", ["sort", "group_by"])
def test_sort_and_group_by_after_a_collocated_join(after):
    rng = np.random.default_rng(9)
    n = 3 * 8192
    lcols = {"k": rng.integers(0, 150_000, n).astype(np.int32),
             "a": rng.normal(size=n),
             "g": rng.integers(0, 7, n).astype(np.int32)}
    rcols = {"k": rng.permutation(200_000)[:8192].astype(np.int32),
             "b": rng.integers(0, 100, 8192)}
    tl = frame_from_numpy(lcols, device="cpu").lazy()
    tr = frame_from_numpy(rcols, device="cpu").lazy()
    rl, rr = ref.DataFrame(lcols).lazy(), ref.DataFrame(rcols).lazy()
    TJ.ROUTES.clear()
    if after == "sort":
        got = tl.join(tr, on="k").sort(["b", "k", "a"]).collect()
        want = rl.join(rr, on="k").sort(["b", "k", "a"]).collect()
        assert got.to_dict() == want.to_dict()
    else:
        got = tl.join(tr, on="k").group_by("g", "b").agg(
            pt.len().alias("n"), pt.col("a").min().alias("lo")) \
            .sort(["g", "b"]).collect()
        want = rl.join(rr, on="k").group_by("g", "b").agg(
            ref.len().alias("n"), ref.col("a").min().alias("lo")) \
            .sort(["g", "b"]).collect()
        assert got.to_dict() == want.to_dict()
    assert dict(TJ.ROUTES) == {"collocated": 1}
