"""Device sorts through the JAX package and through the port.

The same seeded numpy inputs go through `polaroid_tpu` (its CPU path:
`lax.sort`, the f64 keys ordered by their full 64-bit encoding, and the
Pallas merge-sort kernel in interpret mode) and through
`polaroid_tpu_torch` on the CPU (the wrappers' plain versions). Every
comparison is exact: key words, permutations and every output column bit
for bit. Where the reference's unstable sort may order ties its own way
(`maintain_order=False`, `top_k`), the keys are tie-free or only the key
words are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polaroid_tpu as ref
from polaroid_tpu.ops import fused_sort as RF
from polaroid_tpu.ops import keycode as RK
from polaroid_tpu.ops import merge_sort as RM
import polaroid_tpu_torch as pt
from polaroid_tpu_torch import dtypes as D
from polaroid_tpu_torch.batch import Column
from polaroid_tpu_torch.ops import fused_sort as TF
from polaroid_tpu_torch.ops import keycode as TK
from polaroid_tpu_torch.ops import merge_sort as TM


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


U32 = 0xFFFFFFFF
DTYPES = ["Int8", "Int16", "Int32", "Int64", "UInt8", "UInt16", "UInt32",
          "UInt64", "Float32", "Float64", "Boolean"]


def _values(name: str, n: int, rng) -> np.ndarray:
    """n host values of a logical dtype: extremes, ties, and for floats
    NaN of both signs, -0.0, 0.0 and +-inf."""
    npdt = np.dtype(D.physical_numpy_dtype(getattr(D, name)))
    if name == "Boolean":
        return rng.uniform(size=n) < 0.5
    if npdt.kind == "f":
        x = (rng.normal(size=n) * 100).astype(npdt)
        x[:6] = [np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf]
        x[6:40] = x[40:74]                          # ties
        return rng.permutation(x)
    info = np.iinfo(npdt)
    x = rng.integers(info.min, info.max, n, dtype=npdt, endpoint=True)
    x[:4] = [info.min, info.max, 0, 1]
    x[4:40] = x[40:76]
    if name == "UInt64":
        x[40:60] = (1 << 63) + np.arange(20, dtype=np.uint64)
    return rng.permutation(x)


def _port(x: np.ndarray, name: str) -> torch.Tensor:
    """The port's storage tensor of host values (UInt64 as wrapped int64,
    UInt32 in int64, UInt16 in int32)."""
    return Column.from_host(x, dtype=getattr(D, name),
                            device="cpu").data[:len(x)]


def _u64(t) -> np.ndarray:
    """A port code or word (int64) or a JAX one as uint64 bits."""
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.uint64) if a.dtype == np.int64 else a.astype(np.uint64)


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(f"u{a.itemsize}") if a.dtype.kind == "f" else a


@pytest.mark.parametrize("name", DTYPES)
def test_encode_decode_orderable_match_reference(name):
    rng = np.random.default_rng(DTYPES.index(name))
    x = _values(name, 500, rng)
    data = _port(x, name)
    dt = getattr(D, name)
    for desc in (False, True):
        got = TK.encode_orderable(data, dt, desc)
        want = RK.encode_orderable(jnp.asarray(x), desc)
        assert np.array_equal(_u64(got), _u64(want)), desc
        back = TK.decode_orderable(got, dt, desc)
        assert back.dtype == data.dtype
        assert np.array_equal(_bits(back), _bits(data)), desc
    # the codes order the values as numpy does (NaN last, -0.0 == 0.0)
    if name.startswith("Float"):
        fin = ~np.isnan(x)
        code = _u64(TK.encode_orderable(data, dt))[fin]
        assert np.array_equal(np.sort(x[fin]), x[fin][np.argsort(code)])


@pytest.mark.parametrize("name", DTYPES + ["String"])
@pytest.mark.parametrize("nulls_last", [False, True])
def test_encode_key_words_match_reference(name, nulls_last):
    rng = np.random.default_rng(7 + len(name))
    n = 512
    valid = rng.uniform(size=n) < 0.8
    if name == "String":
        words = ["pear", "apple", "fig", "kiwi", "date", "plum", "lime"]
        vals = [words[i] if ok else None
                for i, ok in zip(rng.integers(0, len(words), n), valid)]
        col = Column.from_host(vals, dtype=D.String, device="cpu")
        data = col.data[:n]
        host = data.numpy()
    else:
        host = _values(name, n, rng)
        data = _port(host, name)
    dt = getattr(D, name) if name != "String" else D.String
    for desc in (False, True):
        got = TK.encode_key_words(data, dt, torch.from_numpy(valid), desc,
                                  nulls_last)
        want = RK.encode_key_words(jnp.asarray(host), jnp.asarray(valid),
                                   desc, nulls_last)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(_u64(g), _u64(w)), desc
    if name == "String":
        # sorted dictionary codes: the words order the strings, nulls
        # first or last
        ws = TK.encode_key_words(data, dt, torch.from_numpy(valid), False,
                                 nulls_last)
        perm = TM.merge_sort_words_plain(ws, len(ws))[len(ws)].numpy()
        got = [vals[i] for i in perm]
        live = sorted(v for v in vals if v is not None)
        nulls = [None] * (n - len(live))
        assert got == (live + nulls if nulls_last else nulls + live)


@pytest.mark.parametrize("name", DTYPES)
def test_u32_words_match_reference(name):
    rng = np.random.default_rng(30 + DTYPES.index(name))
    x = _values(name, 300, rng)
    data = _port(x, name)
    dt = getattr(D, name)
    got = TK.col_to_u32_words(data, dt)
    want = RK.col_to_u32_words(jnp.asarray(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(_u64(g), _u64(w))
    back = TK.col_from_u32_words(got, dt)
    assert back.dtype == data.dtype
    assert np.array_equal(_bits(back), _bits(data))


def _key_words(n, nk, rng, hi=37):
    return [rng.integers(0, hi, n).astype(np.uint32) for _ in range(nk)]


@pytest.mark.parametrize("n", [1 << 13, 1 << 14])
@pytest.mark.parametrize("nk", [1, 2, 3])
def test_merge_sort_words_plain_matches_reference(n, nk):
    """Stable: every word, the injected index included, bit for bit
    against the JAX kernel (interpret mode past its 8192-row base)."""
    rng = np.random.default_rng(n + nk)
    keys = _key_words(n, nk, rng)
    keys[0][: n // 8] = U32                      # the all-ones key word
    pay = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    want = RM.merge_sort_words([jnp.asarray(k) for k in keys] +
                               [jnp.asarray(pay)], nk, stable=True)
    before = TM.LAUNCHES
    got = TM.merge_sort_words([torch.from_numpy(w.astype(np.int64))
                               for w in keys + [pay]], nk, stable=True)
    assert TM.LAUNCHES == before          # the CPU runs the plain version
    assert len(got) == len(want) == nk + 2
    for g, w in zip(got, want):
        assert np.array_equal(_u64(g), _u64(w))


def test_merge_sort_words_extremes_match_reference():
    """All-equal key words and all-ones words, n = 2^14."""
    n = 1 << 14
    rng = np.random.default_rng(1)
    k0 = np.full(n, 7, np.uint32)
    k1 = np.where(rng.uniform(size=n) < 0.5, U32, 0).astype(np.uint32)
    want = RM.merge_sort_words([jnp.asarray(k0), jnp.asarray(k1)], 2)
    got = TM.merge_sort_words_plain(
        [torch.from_numpy(k.astype(np.int64)) for k in (k0, k1)], 2)
    for g, w in zip(got, want):
        assert np.array_equal(_u64(g), _u64(w))


def test_merge_sort_words_unstable_keys_match_reference():
    """stable=False: the key words agree, and the payload is permuted
    with them (each row's payload is its key's own)."""
    n = 1 << 13
    rng = np.random.default_rng(2)
    keys = _key_words(n, 2, rng, hi=5)
    pay = (keys[0].astype(np.uint64) * 7 + keys[1]).astype(np.uint32)
    want = RM.merge_sort_words([jnp.asarray(w) for w in keys + [pay]], 2,
                               stable=False)
    got = TM.merge_sort_words_plain(
        [torch.from_numpy(w.astype(np.int64)) for w in keys + [pay]], 2,
        stable=False)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(_u64(g), _u64(w))


def _radix_keys(kind: str, n: int, nk: int, rng) -> list:
    """nk u32 key words of one kind: random small values, two bins (the
    dead-row word), one value for every row, or full 32-bit values."""
    if kind == "random":
        return _key_words(n, nk, rng, hi=1000)
    if kind == "two_bins":
        return [np.where(rng.uniform(size=n) < 0.6, 0, 1).astype(np.uint32)
                for _ in range(nk)]
    if kind == "all_equal":
        return [np.full(n, v, np.uint32) for v in (7, U32, 0)[:nk]]
    return [rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
            for _ in range(nk)]


RADIX_KINDS = ["random", "two_bins", "all_equal", "full_32_bit"]


@pytest.mark.parametrize("kind", RADIX_KINDS)
@pytest.mark.parametrize("n", [1, 2, 1 << 12])
def test_digit_histograms_plain_match_bincount(kind, n):
    rng = np.random.default_rng(n + len(kind))
    keys = _radix_keys(kind, n, 3, rng)
    got = TM.digit_histograms_plain(
        [torch.from_numpy(k.astype(np.int64)) for k in keys], 2)
    assert got.shape == (2, 4, 256) and got.dtype == torch.int32
    for w in range(2):
        for d in range(4):
            want = np.bincount((keys[w] >> np.uint32(8 * d)) & 255,
                               minlength=256)
            assert np.array_equal(got[w, d].numpy(), want), (w, d)
    # the CPU wrapper is the plain version
    assert torch.equal(TM.digit_histograms(
        [torch.from_numpy(k.astype(np.int64)) for k in keys], 2), got)


@pytest.mark.parametrize("kind", RADIX_KINDS)
@pytest.mark.parametrize("n", [1, 2, 1 << 12])
def test_radix_plan_matches_brute_force(kind, n):
    """The passes are every (word, digit) whose rows take more than one
    value, last word and lowest digit first, with each digit value's
    first slot; running them as stable numpy sorts gives the plain
    version's permutation."""
    rng = np.random.default_rng(3 * n + len(kind))
    nk = 3
    keys = _radix_keys(kind, n, nk, rng)
    hist = TM.digit_histograms_plain(
        [torch.from_numpy(k.astype(np.int64)) for k in keys], nk)
    passes, bases = TM.radix_plan(hist, n)
    digits = {(w, d): (keys[w] >> np.uint32(8 * d)) & 255
              for w in range(nk) for d in range(4)}
    want = [(w, d) for w in (2, 1, 0) for d in range(4)
            if len(np.unique(digits[w, d])) > 1]
    assert passes == want
    if kind == "all_equal" or n == 1:
        assert passes == []
    if kind == "full_32_bit" and n > 2:
        assert len(passes) == 4 * nk
    assert bases.shape == (len(passes), 256) and bases.dtype == torch.int32
    for p, wd in enumerate(passes):
        brute = [(digits[wd] < v).sum() for v in range(256)]
        assert np.array_equal(bases[p].numpy(), brute), wd
    perm = np.arange(n)
    for w, d in passes:
        perm = perm[np.argsort(digits[w, d][perm], kind="stable")]
    plain = TM.merge_sort_words_plain(
        [torch.from_numpy(k.astype(np.int64)) for k in keys], nk)
    assert np.array_equal(perm, plain[nk].numpy())


def test_merge_sort_words_perm_only_on_cpu():
    """perm_only returns the stable permutation alone, the plain one."""
    n = 1 << 12
    rng = np.random.default_rng(11)
    words = [torch.from_numpy(w.astype(np.int64))
             for w in _key_words(n, 3, rng, hi=7)]
    got = TM.merge_sort_words(words, 2, stable=False, perm_only=True)
    assert len(got) == 1
    assert torch.equal(got[0], TM.merge_sort_words_plain(words, 2)[2])


def test_lex_sort_indices_matches_reference():
    """Key words and a tail word sorted stably; the permutation is the
    kernel's injected index."""
    n = 1 << 12
    rng = np.random.default_rng(6)
    keys = _key_words(n, 2, rng, hi=9)
    tail = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    wk, wt, wp = RK.lex_sort_indices([jnp.asarray(k) for k in keys],
                                     [jnp.asarray(tail)])
    gk, gt, gp = TK.lex_sort_indices(
        [torch.from_numpy(k.astype(np.int64)) for k in keys],
        [torch.from_numpy(tail.astype(np.int64))])
    for g, w in zip(gk + gt, wk + wt):
        assert np.array_equal(_u64(g), _u64(w))
    assert np.array_equal(gp.numpy(), np.asarray(wp).astype(np.int64))


SORT_OPS_CASES = [
    ([np.uint32], [np.float32, np.int64]),
    ([np.int32, np.float32], [np.int32]),
    ([np.float64], [np.uint32]),
]


@pytest.mark.parametrize("case", range(len(SORT_OPS_CASES)))
@pytest.mark.parametrize("n", [1 << 12, 3000])
def test_sort_ops_matches_lax_sort(case, n):
    """The dtype matrix of the JAX package's merge-sort tests, at a
    power-of-two length and at a padded one."""
    keys, pays = SORT_OPS_CASES[case]
    rng = np.random.default_rng(case * 10 + n)
    ops = []
    for dt in keys + pays:
        if np.issubdtype(dt, np.floating):
            ops.append(rng.normal(0, 50, n).astype(dt))
        else:
            lo = -100 if np.issubdtype(dt, np.signedinteger) else 0
            ops.append(rng.integers(lo, 100, n).astype(dt))
    nk = len(keys)
    port_ops = [torch.from_numpy(o.astype(np.int64) if o.dtype == np.uint32
                                 else o) for o in ops]
    dts = [D.dtype_from_numpy(o.dtype) for o in ops]
    want = jax.lax.sort(tuple(jnp.asarray(o) for o in ops), num_keys=nk,
                        is_stable=True)
    for stable in (True, False):
        got = TM.sort_ops(port_ops, nk, is_stable=stable, dtypes=dts)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            if i >= nk and not stable:
                break                    # tie order is not a contract
            g = g.numpy()
            w = np.asarray(w)
            assert np.array_equal(g.view(f"u{g.itemsize}"),
                                  w.astype(g.dtype).view(f"u{g.itemsize}"))


def test_fused_sorts_match_reference():
    n = 5000
    rng = np.random.default_rng(4)
    key = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    key[:300] = U32
    key[300:2500] = rng.integers(0, 40, 2200)            # ties
    key[2500:2600] = (1 << 31) + rng.integers(0, 3, 100)  # top bit set
    cargo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    live = rng.uniform(size=n) < 0.8
    perm = rng.permutation(n).astype(np.uint32)

    def t(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64))

    def eq(got, want):
        for g, w in zip(got, want):
            assert np.array_equal(_u64(g), _u64(w))

    for lv in (None, live):
        eq(TF.fused_sort_kv(t(key), t(cargo),
                            None if lv is None else torch.from_numpy(lv)),
           RF.fused_sort_kv(jnp.asarray(key), jnp.asarray(cargo),
                            None if lv is None else jnp.asarray(lv)))
        eq(TF.fused_argsort(t(key),
                            None if lv is None else torch.from_numpy(lv)),
           RF.fused_argsort(jnp.asarray(key),
                            None if lv is None else jnp.asarray(lv)))
    eq(TF.fused_argsort_dead_key(torch.from_numpy(~live), t(key)),
       RF.fused_argsort_dead_key(jnp.asarray(~live), jnp.asarray(key)))
    eq([TF.apply_perm_u32(t(perm), t(cargo))],
       [RF.apply_perm_u32(jnp.asarray(perm), jnp.asarray(cargo))])


# --- frames -------------------------------------------------------------

N = 3000
WORDS = ["ant", "bee", "cat", "dog", "eel", "fox", "gnu", "hen", "ibis"]


def _frame_data(seed=5):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 100, N)
    f[:6] = [np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf]
    return {
        "r": np.arange(N, dtype=np.int64),
        "k": rng.integers(-3, 4, N).astype(np.int8),
        "i": rng.integers(-1000, 1000, N).astype(np.int32),
        "f": rng.permutation(f),
        "u": rng.integers(0, np.iinfo(np.uint64).max, N, dtype=np.uint64,
                          endpoint=True),
        "u32": rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32),
        "b": rng.uniform(size=N) < 0.5,
        "g": rng.integers(0, 20_000, N).astype(np.int32),
        "s": [WORDS[j] if ok else None for j, ok in
              zip(rng.integers(0, len(WORDS), N), rng.uniform(size=N) < 0.9)],
        "ni": [int(v) if ok else None for v, ok in
               zip(rng.integers(0, 40, N), rng.uniform(size=N) < 0.85)],
    }


@pytest.fixture(scope="module")
def frames():
    data = _frame_data()
    return ref.DataFrame(data), pt.DataFrame(data, device="cpu")


def _same(got, want):
    assert {k: repr(v) for k, v in got.schema.items()} == \
        {k: repr(v) for k, v in want.schema.items()}
    g, w = got.to_dict(), want.to_dict()
    assert list(g) == list(w)
    for c in w:
        # repr tells -0.0 from 0.0 and prints every NaN alike
        assert [repr(x) for x in g[c]] == [repr(x) for x in w[c]], c


FRAME_QUERIES = {
    "multi_key": lambda pl, df: df.sort(
        ["k", "f"], descending=[False, True], maintain_order=True),
    "string_desc_nulls_first": lambda pl, df: df.sort(
        "s", descending=True, maintain_order=True),
    "nulls_last": lambda pl, df: df.sort(
        ["ni", "i"], nulls_last=True, maintain_order=True),
    "nulls_per_key": lambda pl, df: df.sort(
        ["s", "ni"], descending=[False, True], nulls_last=[True, False],
        maintain_order=True),
    "u64": lambda pl, df: df.sort("u", maintain_order=True),
    "u32_desc_one_word": lambda pl, df: df.sort(
        "u32", descending=True, maintain_order=True),
    "bool_i8": lambda pl, df: df.sort(["b", "k"], maintain_order=True),
    "f64_tie_free_default": lambda pl, df: df.sort("f"),
    "masked": lambda pl, df: df.filter(pl.col("i") > 0).sort(
        ["k", "u32"], maintain_order=True),
    "lazy_masked": lambda pl, df: df.lazy().filter(pl.col("i") < 100)
    .sort("f", descending=True).collect(),
    "lazy_multi": lambda pl, df: df.lazy().sort(
        ["b", "s", "i"], descending=[True, False, False], nulls_last=True,
        maintain_order=True).collect(),
    "sort_head": lambda pl, df: df.lazy().sort("f").head(5).collect(),
    "top_k": lambda pl, df: df.top_k(7, by="f"),
    "bottom_k": lambda pl, df: df.bottom_k(7, by="f"),
    "top_k_multi": lambda pl, df: df.top_k(
        5, by=["k", "f"], descending=[False, True]),
    "lazy_top_k": lambda pl, df: df.lazy().top_k(4, by="u").collect(),
    "lazy_bottom_k_masked": lambda pl, df: df.lazy()
    .filter(pl.col("i") > -500).bottom_k(6, by=["k", "f"]).collect(),
    "group_by_then_sort": lambda pl, df: df.lazy().group_by("k")
    .agg(pl.col("i").sum().alias("si")).sort("si", descending=True)
    .collect(),
    "hash_group_by_then_sort": lambda pl, df: df.lazy().group_by("g")
    .agg(pl.col("i").sum().alias("si"), pl.len().alias("n"))
    .sort(["si", "g"], descending=[True, False]).collect(),
}


@pytest.mark.parametrize("query", list(FRAME_QUERIES))
def test_frame_sorts_match_reference(frames, query):
    rdf, tdf = frames
    q = FRAME_QUERIES[query]
    _same(q(pt, tdf), q(ref, rdf))


@pytest.mark.parametrize("col", ["f", "ni", "s"])
def test_series_sort_matches_reference(col):
    data = _frame_data(9)[col]
    rs, ts = ref.Series(col, data), pt.Series(col, data, device="cpu")
    for desc in (False, True):
        g, w = ts.sort(descending=desc).to_list(), \
            rs.sort(descending=desc).to_list()
        assert [repr(x) for x in g] == [repr(x) for x in w], desc


def test_lazy_sort_default_is_not_maintain_order():
    """The reference's default: `maintain_order=False` on the plan node."""
    lf = pt.DataFrame({"a": [3, 1, 2]}, device="cpu").lazy()
    assert lf.sort("a")._plan.maintain_order is False
    assert lf.sort("a", maintain_order=True)._plan.maintain_order is True


@pytest.mark.parametrize("query,want", [
    (lambda lf: lf.top_k(3, by="a").head(5), [9, 8, 7]),
    (lambda lf: lf.top_k(3, by="a").head(2), [9, 8]),
    (lambda lf: lf.bottom_k(3, by="a").head(5), [1, 2, 3]),
], ids=["top_k_head_longer", "top_k_head_shorter", "bottom_k_head_longer"])
def test_top_k_then_head_keeps_the_shorter_length(query, want):
    """A head after top_k/bottom_k keeps at most k rows: held against the
    values, since the reference's optimizer gives the head's length."""
    lf = pt.DataFrame({"a": [5, 3, 9, 1, 7, 2, 8]}, device="cpu").lazy()
    assert query(lf).collect().get_column("a").to_list() == want
