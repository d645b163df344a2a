"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip without an NVIDIA GPU (as on a CPU-only test
host). Run them on a machine with a card and nvcc, without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import polaroid_tpu_torch as pt
from polaroid_tpu_torch.testing import frame_from_numpy
from polaroid_tpu_torch.ops import cuda_build as B
from polaroid_tpu_torch.ops import cuda_kernels as TK
from polaroid_tpu_torch.ops import cuda_partition as TP
from polaroid_tpu_torch.ops import exchange as TE
from polaroid_tpu_torch.ops import hgroup as TH
from polaroid_tpu_torch.ops import merge_sort as TM
from polaroid_tpu_torch.exec import compiled as CM
from polaroid_tpu_torch.exec.executor import execute_eager
from polaroid_tpu_torch.ops.compact import compact
from polaroid_tpu_torch.plan.optimizer import optimize

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("C,n,G,dtype", [
    (1, 1, 1, torch.float32), (3, 1000, 130, torch.float32),
    (4, 100_000, 1024, torch.float64), (9, 4097, 4096, torch.float64)])
def test_seg_sum_kernel_matches_plain(dev, C, n, G, dtype):
    g = torch.Generator().manual_seed(n)
    gid = torch.randint(-2, G + 2, (n,), generator=g, dtype=torch.int32)
    vals = torch.randn(C, n, generator=g, dtype=torch.float64).to(dtype)
    before = TK.LAUNCHES
    got = TK.seg_sum(vals.to(dev), gid.to(dev), G)
    torch.cuda.synchronize()
    assert TK.LAUNCHES > before
    want = TK.seg_sum_plain(vals, gid, G)
    mag = TK.seg_sum_plain(vals.abs(), gid, G)
    assert torch.all((got.cpu() - want).abs() <= 1e-12 * mag + 1e-300)


@pytest.mark.parametrize("n", [1, 1000, 1025, 1 << 16, 100_003])
def test_compact_kernel_matches_plain(dev, n):
    g = torch.Generator().manual_seed(n)
    mask = torch.rand(n, generator=g) < 0.4
    x = torch.randn(n, generator=g, dtype=torch.float64)
    words = [torch.arange(n, dtype=torch.int32),
             torch.randn(n, generator=g)] + list(x.view(torch.int32).view(
                 n, 2).unbind(1))
    outs, cnt = TP.compact_words(mask.to(dev), [w.to(dev) for w in words])
    want, want_cnt = TP.compact_words_plain(mask, words)
    k = int(cnt)
    assert k == int(want_cnt)
    for o, w in zip(outs, want):
        assert torch.equal(o[:k].cpu().view(torch.int32),
                           w[:k].view(torch.int32))


def _compact_vs_plain(dev, mask, words_on):
    """compact_words on the card against its plain version on the CPU:
    the count and every word's live prefix bit for bit, the outputs
    strided as their words; one launch for up to 32 words. words_on(d)
    gives the words on device d."""
    before = TP.LAUNCHES
    outs, cnt = TP.compact_words(mask.to(dev), words_on(dev))
    want, want_cnt = TP.compact_words_plain(mask, words_on("cpu"))
    k = int(cnt)
    assert k == int(want_cnt)
    assert TP.LAUNCHES - before == -(-len(want) // TP.MAX_WORDS)
    for o, w in zip(outs, want):
        assert o.dtype == w.dtype and o.stride() == w.stride()
        assert torch.equal(o[:k].cpu(), w[:k])


def _mixed_words(n, g):
    """words_on for a 4-byte word, both strided halves of an f64 column,
    an f64 and an int64 column as 8-byte words, and a 4-byte word with
    stride 3."""
    x = torch.randn(n, generator=g, dtype=torch.float64)
    wide = torch.randint(-(1 << 62), 1 << 62, (n,), generator=g,
                         dtype=torch.int64)
    s3 = torch.randint(0, 1 << 30, (3 * n,), generator=g, dtype=torch.int32)

    def on(d):
        xd = x.to(d)
        halves = xd.view(torch.int32)
        return [torch.arange(n, dtype=torch.int32, device=d), halves[0::2],
                halves[1::2], xd.view(torch.int64), wide.to(d),
                s3.to(d)[::3]]
    return on


@pytest.mark.parametrize("kind,n", [
    ("sparse", (1 << 22) + 13), ("sparse", (3 << 22) + 5),
    ("random", (3 << 22) + 5), ("dead", 100_003), ("live", 100_003),
    ("last_only", 3 * 8192 + 1), ("last_only", 1 << 20),
    ("random", 8192), ("random", 8191), ("random", 1)])
def test_compact_kernel_masks(dev, kind, n):
    """Look-back over a long chain of nearly empty tiles (density 1e-5),
    tiles of several 8192-row chunks (3 * 2^22 rows: sparse, and dense
    enough that a tile's list of live rows fills and is copied out more
    than once), all dead, all live, only the last row live, and
    chunk-sized edges, with 4-byte, strided and 8-byte words."""
    g = torch.Generator().manual_seed(n)
    if kind == "sparse":
        mask = torch.rand(n, generator=g) < 1e-5
    elif kind in ("dead", "live", "last_only"):
        mask = torch.full((n,), kind == "live")
        mask[-1] = kind != "dead"
    else:
        mask = torch.rand(n, generator=g) < 0.5
    _compact_vs_plain(dev, mask, _mixed_words(n, g))


def test_compact_kernel_many_words_and_calls(dev):
    """W = 40 (two launches, the second reading the first's offsets), an
    unaligned mask view, and many calls in a row on one scratch, their
    sizes shrinking and growing; after them the scratch is all zero."""
    g = torch.Generator().manual_seed(40)
    n = 70_001
    mask = torch.rand(n, generator=g) < 0.3
    words = [torch.randint(-(1 << 31), 1 << 31, (n,), generator=g,
                           dtype=torch.int64 if i % 3 == 0 else torch.int32)
             for i in range(40)]
    _compact_vs_plain(dev, mask, lambda d: [w.to(d) for w in words])
    big = torch.rand(n + 5, generator=g) < 0.5
    unaligned = big.to(dev)[5:]
    assert unaligned.data_ptr() % 16
    outs, cnt = TP.compact_words(unaligned, [words[1].to(dev)])
    assert int(cnt) == int(big[5:].sum())
    assert torch.equal(outs[0][:int(cnt)].cpu(), words[1][big[5:]])
    for i in range(50):
        m = (1 << (i % 7)) * 5000 + i
        mk = torch.rand(m, generator=g) < (0.9 if i % 2 else 0.001)
        _compact_vs_plain(dev, mk, lambda d: [
            torch.arange(m, dtype=torch.int64, device=d)])
    torch.cuda.synchronize()
    assert not B._SCRATCH[("compact", torch.cuda.current_device(),
                           torch.cuda.current_stream().cuda_stream)].any()


def test_compact_kernel_graph_replay(dev):
    """A launch captured in a CUDA graph and replayed over new masks: each
    replay finds the scratch as the first launch did."""
    g = torch.Generator().manual_seed(7)
    n = (1 << 20) + 3
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    word = torch.randint(-(1 << 62), 1 << 62, (n,), generator=g,
                         dtype=torch.int64).to(dev)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        TP.compact_words(mask, [word])  # the scratch of stream s
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s):
            (out,), cnt = TP.compact_words(mask, [word])
    for density in (0.5, 1e-4, 0.0, 1.0, 0.3):
        m = torch.rand(n, generator=g) < density
        mask.copy_(m.to(dev))
        graph.replay()
        torch.cuda.synchronize()
        k = int(cnt)
        assert k == int(m.sum())
        assert torch.equal(out[:k].cpu(), word.cpu()[m])


def _minmax_input(n, G, dtype, g):
    """Values with NaN (+NaN in groups of even id, -NaN in odd ones),
    -0.0/+0.0 and +-inf mixed in (floats) or the type's extremes (ints),
    and ids in [-2, G + 2)."""
    gid = torch.randint(-2, G + 2, (n,), generator=g, dtype=torch.int32)
    if dtype.is_floating_point:
        x = (torch.randn(n, generator=g, dtype=torch.float64) * 100).to(dtype)
        sp = torch.tensor([float("nan"), -0.0, 0.0, float("inf"),
                           -float("inf")], dtype=dtype)
        pos = torch.randint(0, n, (max(n // 20, 1),), generator=g)
        x[pos] = sp[torch.randint(0, 5, (pos.numel(),), generator=g)]
        odd = (gid % 2 == 1) & torch.isnan(x)
        x[odd] = -x[odd]
        return x, gid, -float("inf"), float("inf")
    info = torch.iinfo(dtype)
    x = torch.randint(info.min, info.max, (n,), generator=g, dtype=dtype)
    x[:min(n, 2)] = torch.tensor([info.min, info.max][:min(n, 2)],
                                 dtype=dtype)
    return x, gid, info.min, info.max


@pytest.mark.parametrize("n,G", [(1, 1), (1000, 7), (4097, 300),
                                 (1 << 16, 1024), (100_003, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int32, torch.int64])
def test_seg_minmax_kernel_matches_plain(dev, n, G, dtype):
    """Bit for bit, NaN (with its sign) and -0.0 included."""
    g = torch.Generator().manual_seed(n + G)
    x, gid, lo, hi = _minmax_input(n, G, dtype, g)
    kt = {torch.float32: torch.int32, torch.float64: torch.int64}.get(
        dtype, dtype)
    for is_max in (False, True):
        ident = lo if is_max else hi
        before = TK.MINMAX_LAUNCHES
        got = TK.seg_minmax(x.to(dev), gid.to(dev), G, is_max, ident)
        torch.cuda.synchronize()
        assert TK.MINMAX_LAUNCHES == before + 1
        want = TK.seg_minmax_plain(x, gid, G, is_max, ident)
        assert got.dtype == dtype
        assert torch.equal(got.cpu().view(kt), want.view(kt)), is_max


def test_seg_minmax_kernel_views_and_scratch_reset(dev):
    """Unaligned x and gid views (scalar head), n not a multiple of 4,
    G = MAX_GROUPS, and calls that alternate types, ops and G on one
    scratch, each bit for bit against the plain version; after them the
    scratch is all zero."""
    g = torch.Generator().manual_seed(11)
    n = 200_003
    cases = []
    for dtype in (torch.float32, torch.float64, torch.int32, torch.int64):
        x, gid, lo, hi = _minmax_input(n + 3, TK.MAX_GROUPS, dtype, g)
        cases.append((dtype, x, gid, lo, hi))
    kt = {torch.float32: torch.int32, torch.float64: torch.int64}
    for rep in range(3):
        for i, (dtype, x, gid, lo, hi) in enumerate(cases):
            G = (TK.MAX_GROUPS, 5, 1000)[(rep + i) % 3]
            # offsets of 0 to 3 rows into the card's copies: unaligned starts
            xo, go = (rep + i) % 4, (rep + 2 * i) % 4
            xd, gd = x.to(dev)[xo:xo + n], gid.to(dev)[go:go + n]
            xc, gc = x[xo:xo + n], gid[go:go + n]
            for is_max in (True, False):
                ident = lo if is_max else hi
                got = TK.seg_minmax(xd, gd, G, is_max, ident)
                want = TK.seg_minmax_plain(xc, gc, G, is_max, ident)
                k = kt.get(dtype, dtype)
                assert torch.equal(got.cpu().view(k), want.view(k)), \
                    (dtype, G, is_max, xo, go)
    torch.cuda.synchronize()
    assert not B._SCRATCH[("seg_minmax", torch.cuda.current_device(),
                           torch.cuda.current_stream().cuda_stream)].any()


@pytest.mark.parametrize("n,G", [(1, 1), (1000, 7), (4097, 300),
                                 (1 << 16, 1024), (100_003, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gather_kernel_matches_plain(dev, n, G, dtype):
    g = torch.Generator().manual_seed(n + G)
    table = torch.randn(G, generator=g, dtype=torch.float64).to(dtype)
    gid = torch.randint(-3, G + G // 4 + 3, (n,), generator=g,
                        dtype=torch.int32)
    before = TK.GATHER_LAUNCHES
    got = TK.gather(table.to(dev), gid.to(dev))
    torch.cuda.synchronize()
    assert TK.GATHER_LAUNCHES == before + 1
    assert torch.equal(got.cpu(), TK.gather_plain(table, gid))


def test_ohlc_on_card_matches_cpu(dev):
    """The per-symbol OHLC bar with maintain_order=True, on the card
    against the CPU run, with the kernels' launches during one collect."""
    rng = np.random.default_rng(6)
    n = 50_000
    data = {"symbol": rng.integers(0, 1000, n).astype(np.uint32),
            "price": rng.uniform(1, 200, n).astype(np.float32),
            "volume": rng.integers(0, 5000, n).astype(np.int32)}

    def ohlc(device):
        df = pt.DataFrame(data, device=device)
        return (df.lazy().filter(pt.col("volume") > 1000)
                .group_by("symbol", maintain_order=True)
                .agg(pt.col("price").first().alias("open"),
                     pt.col("price").max().alias("high"),
                     pt.col("price").min().alias("low"),
                     pt.col("price").last().alias("close"),
                     pt.col("volume").sum().alias("vol"),
                     pt.col("price").std().alias("sd"),
                     pt.len().alias("n"))
                .collect().to_dict())

    TK.LAUNCHES = TK.MINMAX_LAUNCHES = TK.GATHER_LAUNCHES = 0
    TP.LAUNCHES = 0
    got = ohlc("cuda")
    # seg_sum: group counts, the stash (len, count and sum of price), the
    # squared deviations; seg_minmax: first row, high, low, last row
    assert (TK.LAUNCHES, TK.MINMAX_LAUNCHES, TK.GATHER_LAUNCHES,
            TP.LAUNCHES) == (3, 4, 1, 0)
    want = ohlc("cpu")
    for k in ("symbol", "open", "high", "low", "close", "vol", "n"):
        assert got[k] == want[k], k
    sd_w = np.asarray(want["sd"], dtype=np.float32)
    assert np.all(np.abs(np.asarray(got["sd"], dtype=np.float32) - sd_w)
                  <= np.spacing(sd_w))


def test_q1_on_card_matches_cpu(dev):
    rng = np.random.default_rng(4)
    n = 50_000
    data = {"symbol": rng.integers(0, 1000, n).astype(np.uint32),
            "price": rng.uniform(1, 200, n),
            "volume": rng.integers(0, 5000, n)}

    def q1(device):
        df = pt.DataFrame(data, device=device)
        return (df.lazy().filter(pt.col("volume") > 1000)
                .with_columns((pt.col("price") * pt.col("volume"))
                              .alias("notional"))
                .group_by("symbol")
                .agg(pt.len().alias("n"),
                     pt.col("notional").sum().alias("total"),
                     pt.col("price").mean().alias("avg"))
                .collect().to_dict())

    TK.LAUNCHES = TP.LAUNCHES = 0
    got = q1("cuda")
    assert TK.LAUNCHES == 2 and TP.LAUNCHES == 1
    want = q1("cpu")
    assert got["symbol"] == want["symbol"] and got["n"] == want["n"]
    np.testing.assert_allclose(got["total"], want["total"], rtol=1e-12)
    np.testing.assert_allclose(got["avg"], want["avg"], rtol=1e-12)


@pytest.mark.parametrize("B,dead,overflow", [(1, 0.0, False),
                                             (3, 0.1, False),
                                             (64, 0.4, True)])
def test_bucket_exchange_kernel_matches_plain(dev, B, dead, overflow):
    """Bit for bit, pads included; with `overflow` some runs pass CAP and
    are cut, and some extents are out of range and clamped."""
    g = torch.Generator().manual_seed(B)
    n = B * TE.S
    h = torch.randint(0, 1 << 32, (n,), generator=g, dtype=torch.int64)
    h[torch.rand(n, generator=g) < dead] = TH.FILL
    if overflow:
        h[: n // 2] = h[: n // 2] & ~(0x1F << 27)   # bucket 0 heavy
    prep_h = h.view(B, TE.S).sort(dim=1).values
    digit = torch.where(prep_h != TH.FILL, prep_h >> 27,
                        torch.full_like(prep_h, TE.K))
    counts = torch.stack([torch.bincount(d, minlength=TE.K + 1)[:TE.K]
                          for d in digit]).to(torch.int32)
    starts = (torch.cumsum(counts, 1) - counts).to(torch.int32)
    if overflow:
        starts[0, 5] = -3
        starts[1, 7] = TE.S + 10
        counts[2, 9] = -1
    words = [TH._to_word(prep_h.reshape(-1)),
             torch.randint(-(1 << 31), 1 << 31, (n,), generator=g,
                           dtype=torch.int32)]
    fills = (TH.FILL, 0x7F00FF01)
    before = TE.EXCHANGE_LAUNCHES
    got = TE.bucket_exchange(starts.to(dev), counts.to(dev),
                             [w.to(dev) for w in words], fills)
    torch.cuda.synchronize()
    assert TE.EXCHANGE_LAUNCHES == before + 1
    want = TE.bucket_exchange_plain(starts, counts, words, fills)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_hash_groupby_on_card_matches_cpu(dev):
    """A 10^5-key group-by (the hash tier) on the card against the CPU
    run, the fast path and the fallback."""
    rng = np.random.default_rng(7)
    n = 100_000
    data = {"k": rng.integers(1, 100_001, n).astype(np.int32),
            "s": ((rng.integers(0, 8, n)) * 10_000).astype(np.int32),
            "v": rng.integers(1, 6, n).astype(np.int32),
            "x": rng.uniform(0, 100, n)}

    def q(device, key):
        df = pt.DataFrame(data, device=device)
        return (df.lazy().group_by(key)
                .agg(pt.col("v").sum().alias("vs"),
                     pt.col("x").mean().alias("xm"),
                     pt.col("x").max().alias("xx"), pt.len().alias("n"))
                .sort(key).collect().to_dict())

    for key, fallbacks in (("k", 0), ("s", 1)):
        TE.EXCHANGE_LAUNCHES = 0
        TH.FALLBACKS = 0
        got = q("cuda", key)
        assert TH.FALLBACKS == fallbacks
        assert (TE.EXCHANGE_LAUNCHES > 0) == (fallbacks == 0)
        want = q("cpu", key)
        for c in (key, "vs", "xx", "n"):
            assert got[c] == want[c], c
        np.testing.assert_allclose(got["xm"], want["xm"], rtol=1e-12)


def _sort_words(n, nk, npay, g):
    """nk key words with ties and about 10% all-ones words, and npay
    payload words, u32 values in int64 (CPU)."""
    keys = [torch.randint(0, 37, (n,), generator=g) for _ in range(nk)]
    keys[0][torch.rand(n, generator=g) < 0.1] = 0xFFFFFFFF
    pays = [torch.randint(0, 1 << 32, (n,), generator=g)
            for _ in range(npay)]
    return keys + pays


@pytest.mark.parametrize("n", [1 << 10, 1 << 12, 1 << 13, 1 << 16, 1 << 20])
@pytest.mark.parametrize("W", [2, 5, 9])
def test_merge_sort_kernel_matches_plain(dev, n, W):
    """Stable, bit for bit, the injected index included. W counts the
    kernel's words: nk keys, the index and the payloads. n runs below,
    at and above the shared-memory tile (4096 rows at these W; W = 5 and
    9 need more than 48 KB of shared memory)."""
    nk = {2: 1, 5: 3, 9: 4}[W]
    g = torch.Generator().manual_seed(n + W)
    words = _sort_words(n, nk, W - nk - 1, g)
    before = TM.LAUNCHES
    got = TM.merge_sort_words([w.to(dev) for w in words], nk, stable=True)
    torch.cuda.synchronize()
    assert TM.LAUNCHES == before + 1
    want = TM.merge_sort_words_plain(words, nk, stable=True)
    assert len(got) == len(want) == W
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n,W", [(1, 2), (2, 3), (1 << 16, 20), (1 << 17, 32)])
def test_merge_sort_kernel_edges(dev, n, W):
    """One and two rows, and word counts whose tile is smaller than 4096
    rows (W = 20: 2048, W = 32: 1024)."""
    g = torch.Generator().manual_seed(W)
    words = _sort_words(n, 2, W - 3, g)
    got = TM.merge_sort_words([w.to(dev) for w in words], 2)
    want = TM.merge_sort_words_plain(words, 2)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("fill", [7, 0xFFFFFFFF])
def test_merge_sort_kernel_all_equal_keys(dev, fill):
    """Every key alike: the stable order is the input order."""
    n = 1 << 16
    key = torch.full((n,), fill, dtype=torch.int64)
    pay = torch.randint(0, 1 << 32, (n,),
                        generator=torch.Generator().manual_seed(3))
    out = TM.merge_sort_words([key.to(dev), pay.to(dev)], 1)
    assert torch.equal(out[0].cpu(), key)
    assert torch.equal(out[1].cpu(), torch.arange(n))
    assert torch.equal(out[2].cpu(), pay)


def test_merge_sort_kernel_unstable(dev):
    """stable=False: the key words agree with the plain version, and a
    payload that is a function of the keys comes along with them."""
    n = 1 << 16
    g = torch.Generator().manual_seed(5)
    keys = _sort_words(n, 2, 0, g)
    pay = (keys[0] * 41 + keys[1]) & 0xFFFFFFFF
    got = TM.merge_sort_words([w.to(dev) for w in keys + [pay]], 2,
                              stable=False)
    want = TM.merge_sort_words_plain(keys + [pay], 2, stable=False)
    assert len(got) == 3
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def _radix_words(n, kind, g):
    """Two key words and a payload (CPU): `skewed` puts 60% of the rows in
    one digit bin of every digit; `trivial_beside_full` gives a first word
    whose every digit is one value beside a full 32-bit second word;
    `one_digit` a first word whose only varying digit is its second byte
    (its pass gathers that byte's copy) beside a full second word."""
    pay = torch.randint(0, 1 << 32, (n,), generator=g)
    full = torch.randint(0, 1 << 32, (n,), generator=g)
    if kind == "skewed":
        keys = [full, torch.randint(0, 1 << 32, (n,), generator=g)]
        for k in keys:
            k[torch.rand(n, generator=g) < 0.6] = 0x5A5A5A5A
        return keys + [pay]
    if kind == "one_digit":
        return [(torch.randint(0, 5, (n,), generator=g) << 8) | 0x80000001,
                full, pay]
    return [torch.full((n,), 0x80000001), full, pay]


RADIX_PASSES = {"skewed": 8, "trivial_beside_full": 4, "one_digit": 5}


@pytest.mark.parametrize("kind", list(RADIX_PASSES))
@pytest.mark.parametrize("n", [1 << 11, 1 << 12, 1 << 13, 1 << 22])
def test_radix_sort_kernel_digits(dev, kind, n):
    """Bit for bit against the plain version at n below one 3840-row tile,
    just above it (a second tile of 256 rows), at a few tiles and at about
    a thousand; the passes run are radix_plan's."""
    g = torch.Generator().manual_seed(n + len(kind))
    words = _radix_words(n, kind, g)
    got = TM.merge_sort_words([w.to(dev) for w in words], 2)
    torch.cuda.synchronize()
    passes, _ = TM.radix_plan(TM.digit_histograms_plain(words, 2), n)
    assert TM.PASSES == len(passes) == RADIX_PASSES[kind]
    want = TM.merge_sort_words_plain(words, 2)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n", [1, 2, 1 << 20, 1 << 22])
def test_radix_histogram_kernel_matches_plain(dev, n):
    """Hot bins (a two-valued word), full 32-bit values and a constant
    word, counted exactly; n = 1 and 2 leave most lanes idle."""
    g = torch.Generator().manual_seed(n)
    words = [(torch.rand(n, generator=g) < 0.4).long(),
             torch.randint(0, 1 << 32, (n,), generator=g),
             torch.full((n,), 0xFFFFFFFF)]
    got = TM.digit_histograms([w.to(dev) for w in words], 3)
    assert torch.equal(got.cpu(), TM.digit_histograms_plain(words, 3))


@pytest.mark.parametrize("n", [1, 1 << 12, 1 << 20])
def test_radix_sort_perm_only(dev, n):
    """perm_only: the permutation alone, equal to the plain version's."""
    g = torch.Generator().manual_seed(n)
    words = _sort_words(n, 3, 2, g)
    got = TM.merge_sort_words([w.to(dev) for w in words], 3, perm_only=True)
    assert len(got) == 1 and got[0].dtype == torch.int64
    assert torch.equal(got[0].cpu(), TM.merge_sort_words_plain(words, 3)[3])


def test_sorts_on_card_match_cpu(dev):
    """Multi-key sorts with nulls, top_k and bottom_k on the card against
    the CPU run, with kernel F's launches; a one-word key takes the
    packed torch.sort instead."""
    rng = np.random.default_rng(8)
    n = 70_000
    f = rng.normal(size=n)
    data = {"a": rng.integers(0, 50, n).astype(np.int32), "f": f,
            "u": rng.integers(0, np.iinfo(np.uint64).max, n, dtype=np.uint64,
                              endpoint=True),
            "r": np.arange(n)}
    valid = {"a": rng.uniform(size=n) < 0.95}

    def run(device):
        df = frame_from_numpy(data, validity=valid, device=device)
        lf = df.lazy()
        return [
            lf.sort(["a", "f"], descending=[True, False], nulls_last=True,
                    maintain_order=True).collect().to_dict(),
            df.sort("u", maintain_order=True).to_dict(),
            lf.filter(pt.col("r") % 3 == 0).top_k(9, by="f").collect()
            .to_dict(),
            df.bottom_k(9, by=["a", "f"]).to_dict(),
        ]

    TM.LAUNCHES = 0
    got = run("cuda")
    assert TM.LAUNCHES == 4
    assert got == run("cpu")
    TM.LAUNCHES = 0
    df = pt.DataFrame({"k": data["a"], "r": data["r"]}, device="cuda")
    out = df.sort("k", maintain_order=True).to_dict()
    assert TM.LAUNCHES == 0
    assert out["r"] == np.argsort(data["a"], kind="stable").tolist()


def test_sorted_tier_group_by_on_card_matches_cpu(dev):
    """The sorted tier on the card against the CPU run: a Float64 key, a
    computed Int32 key and three keys above 2^32 slots (kernel F), and a
    Float32 key (one packed torch.sort), with median, quantile, n_unique,
    arg_max, mode, product and corr ** 2 (of integers, whose sums are
    exact in f64 in any order); and a median over the dense tier's
    ids."""
    rng = np.random.default_rng(9)
    n = 60_000
    data = {"f": rng.integers(0, 300, n) / 4.0,
            "g": (rng.integers(0, 200, n) / 2).astype(np.float32),
            "a": rng.integers(0, 5000, n).astype(np.int32),
            "b": rng.integers(0, 3, n) * 10**7,
            "v": rng.normal(size=n), "w": rng.uniform(0.99, 1.01, n),
            "i": rng.integers(-20, 20, n).astype(np.int32)}
    valid = {"v": rng.uniform(size=n) < 0.9}

    def q(device, keys):
        df = frame_from_numpy(data, validity=valid, device=device)
        c = pt.col
        return (df.lazy().group_by(*keys)
                .agg(c("v").median().alias("med"),
                     c("v").quantile(0.3, "lower").alias("q3"),
                     c("i").n_unique().alias("nu"),
                     c("v").arg_max().alias("am"),
                     c("i").mode().alias("mo"),
                     c("w").product().alias("p"),
                     c("i").product().alias("ip"),
                     (pt.corr("i", "a") ** 2).alias("r2"),
                     pt.len().alias("n"))
                .collect().to_dict())

    # a computed key carries the validity of the modulo's zero guard, so
    # it sorts a null word beside its code: kernel F; the Float32 key is
    # one word: the packed torch.sort
    computed = (pt.col("a") % 17).cast(pt.Int32).alias("m")
    for keys, f_launches in ((["f"], 1), (["g"], 0), ([computed], 1),
                             (["b", "a", "f"], 1)):
        TM.LAUNCHES = 0
        TP.LAUNCHES = 0
        got = q("cuda", keys)
        # kernel F: the row sort over more than one key word, and the
        # (group id, Float64 value) sort of the median and the quantile
        assert TM.LAUNCHES == f_launches + 2, keys
        assert TP.LAUNCHES >= 1
        want = q("cpu", keys)
        for c in got:
            if c in ("med", "p", "r2"):
                # None (a group with no valid value) compares as NaN
                np.testing.assert_allclose(
                    np.array(got[c], dtype=float),
                    np.array(want[c], dtype=float), rtol=1e-12,
                    atol=1e-12 if c == "r2" else 0)
            else:
                assert got[c] == want[c], c
    df = frame_from_numpy(data, validity=valid, device="cuda")
    TK.LAUNCHES = 0
    got = df.group_by("i").agg(pt.col("v").median()).sort("i").to_dict()
    assert TK.LAUNCHES >= 1            # the dense tier's counts
    want = frame_from_numpy(data, validity=valid, device="cpu").group_by(
        "i").agg(pt.col("v").median()).sort("i").to_dict()
    assert got["i"] == want["i"]
    np.testing.assert_allclose(got["v"], want["v"], rtol=1e-12)


@pytest.mark.parametrize("tier", ["dense", "hash", "sorted"])
def test_float_corr_on_card_within_its_conditioning(dev, tier):
    """corr and corr ** 2 of random floats on the card against the CPU
    run, on each tier, within a bound set by the formula's conditioning.
    Each of corr's sums (n, sx, sy, sxx, syy, sxy) is an f64 sum in an
    order that the card's scatters pick, so each lies within
    g = (m + 2) 2^-53 of sum |t| of its exact value (m the group's
    rows); num = n sxy - sx sy then lies within
    2 g (n sum|xy| + sum|x| sum|y|), dx = n sxx - sx^2 within
    2 g (n sum x^2 + (sum|x|)^2), and so corr within
    d = dnum / sqrt(dx dy) + |corr| (ddx / dx + ddy / dy) / 2 + 4 u |corr|
    and corr ** 2 within 2 |corr| d + d^2 of the exact value: two runs
    differ by at most twice that. y near 1 makes dy cancel (its
    condition number is about 2 / var(y), 6e4 here), which is where a
    fixed 1e-12 fails."""
    rng = np.random.default_rng(11)
    n = 50_000
    k = rng.integers(0, 40, n)
    x = rng.normal(size=n)
    y = rng.uniform(0.99, 1.01, n)
    valid = {"x": rng.uniform(size=n) < 0.9, "y": rng.uniform(size=n) < 0.95}
    key = {"dense": k, "hash": k * 1000, "sorted": k / 4.0}[tier]
    data = {"key": key, "x": x, "y": y}

    def q(device):
        df = frame_from_numpy(data, validity=valid, device=device)
        return (df.lazy().group_by("key")
                .agg(pt.corr("x", "y").alias("r"),
                     (pt.corr("x", "y") ** 2).alias("r2"))
                .sort("key").collect().to_dict())

    TK.LAUNCHES = TE.EXCHANGE_LAUNCHES = TH.FALLBACKS = TP.LAUNCHES = 0
    got = q("cuda")
    # 40 keys over a span of 39,002 slots: the hash tier, whose exchange
    # cells overflow, so it takes the carry-sort fallback
    launched = {"dense": TK.LAUNCHES,
                "hash": TE.EXCHANGE_LAUNCHES + TH.FALLBACKS,
                "sorted": TP.LAUNCHES}[tier]
    assert launched >= 1, tier
    want = q("cpu")
    assert got["key"] == want["key"] == sorted(set(key.tolist()))
    u = 2.0 ** -53
    both = valid["x"] & valid["y"]
    worst = 0.0
    for j, kk in enumerate(got["key"]):
        sel = both & (key == kk)
        a, b = x[sel], y[sel]
        m = int(sel.sum())
        g = (m + 2) * u
        sa, sb = np.abs(a).sum(), np.abs(b).sum()
        dx = m * (a * a).sum() - a.sum() ** 2
        dy = m * (b * b).sum() - b.sum() ** 2
        dnum = 2 * g * (m * np.abs(a * b).sum() + sa * sb)
        ddx = 2 * g * (m * (a * a).sum() + sa * sa)
        ddy = 2 * g * (m * (b * b).sum() + sb * sb)
        r = abs(want["r"][j])
        d = dnum / np.sqrt(dx * dy) + r * (ddx / dx + ddy / dy) / 2 \
            + 4 * u * r
        assert abs(got["r"][j] - want["r"][j]) <= 2 * d, (tier, kk)
        bound = 2 * (2 * r * d + d * d)
        assert abs(got["r2"][j] - want["r2"][j]) <= bound, (tier, kk)
        worst = max(worst, abs(got["r2"][j] - want["r2"][j]) / bound)
    print(f"corr {tier}: largest |r2 card - r2 cpu| / bound {worst:.3g}, "
          f"largest |r2 card - r2 cpu| "
          f"{max(abs(p - w) for p, w in zip(got['r2'], want['r2'])):.3g}")


def test_unique_on_card_matches_cpu(dev):
    """unique over two keys (kernel F) and one Int32 key (the packed
    torch.sort), with every keep, on the card against the CPU run."""
    rng = np.random.default_rng(10)
    n = 80_000
    data = {"a": rng.integers(0, 300, n).astype(np.int32),
            "b": rng.integers(0, 50, n), "r": np.arange(n)}
    for keep in ("any", "first", "last", "none"):
        for subset in (["a", "b"], "a"):
            TM.LAUNCHES = 0
            got = pt.DataFrame(data, device="cuda").unique(
                subset=subset, keep=keep, maintain_order=True).to_dict()
            assert TM.LAUNCHES == (1 if subset == ["a", "b"] else 0)
            want = pt.DataFrame(data, device="cpu").unique(
                subset=subset, keep=keep, maintain_order=True).to_dict()
            assert got == want, (keep, subset)


def test_collocated_exchange_on_card_matches_plain(dev):
    """Kernel E at the join's layout (w and the row word, the probe side
    three times the build side), bit for bit against its plain version
    on the inputs the collocated join gave it; and the kernel-level join
    on the card against the CPU run, as row multisets."""
    from polaroid_tpu_torch.ops import hjoin as TJH
    g = torch.Generator().manual_seed(3)
    nb, npr = 1 << 16, 3 << 16
    bkey = torch.randperm(1 << 20, generator=g)[:nb]
    bval = torch.rand(nb, generator=g)
    pkey = torch.randint(0, 1 << 20, (npr,), generator=g)
    pkey[::97] = bkey[5]                 # a run longer than 256 rows
    TE.RECORD = []
    try:
        got = TJH.lookup_join_collocated(bkey.to(dev), bval.to(dev),
                                         pkey.to(dev))
        torch.cuda.synchronize()
        rec = TE.RECORD
    finally:
        TE.RECORD = None
    assert len(rec) == 1 and bool(got[4])
    starts, counts, words, fills = rec[0]
    for a, b in zip(TE.bucket_exchange(starts, counts, words, fills),
                    TE.bucket_exchange_plain(starts.cpu(), counts.cpu(),
                                             [w.cpu() for w in words],
                                             fills)):
        assert torch.equal(a.cpu(), b)
    want = TJH.lookup_join_collocated(bkey, bval, pkey)

    def rows(out):
        pidx, value, hit, live = (t.cpu() for t in out[:4])
        return sorted(zip(pidx[live].tolist(), value[live].tolist(),
                          hit[live].tolist()))
    assert rows(got) == rows(want)


def test_merge_sort_kernel_at_the_full_joins_shape(dev):
    """Kernel F over 2^25 rows, the merged sort of H2O q5_full (capL +
    capR = 2^24 + 2^24): (dead, key, side tag) with the side row riding
    along, every word bit for bit against the plain version."""
    n = 1 << 25
    g = torch.Generator(device=dev).manual_seed(4)
    dead = (torch.rand(n, generator=g, device=dev) < 0.4).to(torch.int64)
    key = torch.randint(0, 11_000_000, (n,), generator=g, device=dev)
    tag = (torch.arange(n, device=dev) >= n // 2).to(torch.int64)
    side = torch.arange(n, device=dev) & ((n // 2) - 1)
    words = [dead, key, tag, side]
    before = TM.LAUNCHES
    got = TM.merge_sort_words(words, 3)
    torch.cuda.synchronize()
    assert TM.LAUNCHES == before + 1
    want = TM.merge_sort_words_plain(words, 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    perm = TM.merge_sort_words(words, 3, perm_only=True)[0]
    assert torch.equal(perm, want[3])


def test_joins_on_card_match_cpu(dev):
    """Every join route on the card against the CPU run (rows as
    multisets; the m:1 routes in order), with the route the same on
    both devices."""
    from polaroid_tpu_torch.ops import join as TJ
    rng = np.random.default_rng(11)
    n = 1 << 15
    left = {"k": rng.integers(0, 300_000, n).astype(np.int32),
            "w": rng.integers(0, 300, n), "f": rng.normal(size=n),
            "a": rng.normal(size=n)}
    rk = rng.permutation(300_000)[:1 << 14].astype(np.int32)
    right = {"k": rk, "w": rk.astype(np.int64) % 300,
             "f": np.round(rng.normal(size=1 << 14), 1),
             "b": rng.integers(0, 9, 1 << 14).astype(np.int32)}
    cases = [("k", "inner", "collocated"), ("k", "left", "collocated"),
             ("w", "inner", "dense_expand"), ("w", "semi", "dense_semi_anti"),
             ("f", "inner", "sortmerge_expand"),
             ("f", "anti", "sortmerge_semi_anti"),
             ("k", "full", "sortmerge_expand")]
    for key, how, route in cases:
        outs = []
        for device in ("cuda", "cpu"):
            lf = frame_from_numpy(left, device=device)
            rf = frame_from_numpy(right, device=device)
            TJ.ROUTES.clear()
            out = lf.join(rf, on=key, how=how).to_dict()
            assert dict(TJ.ROUTES) == {route: 1}, (key, how, device)
            outs.append(sorted(zip(*out.values()), key=repr))
        assert outs[0] == outs[1], (key, how)
    # the sort-merge m:1 route, in left order
    uk = {"f": np.unique(right["f"]), "c": np.arange(len(np.unique(
        right["f"])))}
    outs = []
    for device in ("cuda", "cpu"):
        TJ.ROUTES.clear()
        outs.append(frame_from_numpy(left, device=device).join(
            frame_from_numpy(uk, device=device), on="f").to_dict())
        assert dict(TJ.ROUTES) == {"sortmerge_m1": 1}
    assert outs[0] == outs[1]


PHASE11 = ["q8", "W1_center", "W1_sum", "W1_len", "W2_cum_sum",
           "W2_shift", "W2_diff", "W2_rank_dense", "W2_cum_sum_ordered",
           "W3_pct_change", "W3_rolling_mean", "W3_rolling_std",
           "W3_cum_sum", "W3_ewm_mean", "W3_forward_fill",
           "W4_rolling_mean", "W4_rolling_max", "W4_cum_sum", "W4_rank",
           "W4_forward_fill"]


def _phase11_frames(device, rows=1 << 16):
    import chip_smoke as CS
    h2o = CS.make_h2o_data(rows, 0)
    q1 = CS.make_q1_data(rows, 0)
    hdf = pt.DataFrame(h2o, device=device)
    qdf, pv = CS.with_null_price(pt, pt.DataFrame(q1, device=device), q1,
                                 0)
    queries = {n: (lf, must) for n, lf, must in
               CS.window_queries(pt, hdf, qdf)}
    return CS, h2o, q1, pv, queries


@pytest.mark.parametrize("name", PHASE11)
def test_window_query_on_card_matches_cpu(dev, name):
    """chip_smoke.py's phase-11 query at 2^16 rows on the card: the
    kernels of its route launched (F and B where the smoke asserts
    them), the smoke's numpy oracle met, and the columns the oracle
    holds bit for bit equal to the CPU run's."""
    CS, h2o, q1, pv, cuda_q = _phase11_frames("cuda")
    _, _, _, _, cpu_q = _phase11_frames("cpu")
    lf, must = cuda_q[name]
    TM.LAUNCHES = TP.LAUNCHES = 0
    got = CS.host_columns(lf.collect())
    torch.cuda.synchronize()
    launches = {"merge_sort": TM.LAUNCHES, "compact_words": TP.LAUNCHES}
    for kernel in must:
        assert launches[kernel] >= 1, (name, kernel, launches)
    _, errs = CS.check_window(name, got, h2o, q1, pv)
    want = CS.host_columns(cpu_q[name][0].collect())
    for k, (data, validity) in want.items():
        if k not in errs:
            assert got[k][0].tobytes() == data.tobytes(), (name, k)
        assert (validity is None) == (got[k][1] is None), (name, k)
        if validity is not None:
            assert np.array_equal(validity, got[k][1]), (name, k)


def _recorded(lf):
    """The inputs of every kernel-F and kernel-B launch of one collect."""
    TM.RECORD, TP.RECORD = [], []
    try:
        lf.collect()
        torch.cuda.synchronize()
        return TM.RECORD, TP.RECORD
    finally:
        TM.RECORD = TP.RECORD = None


@pytest.mark.parametrize("name", ["T2_overlap", "T3_rolling"])
def test_time_route_kernels_match_plain(dev, name):
    """Kernels F and B on the inputs chip_smoke.py's phase-12 query gave
    them at 2^18 trades: T2's sort of the expanded rows (each fanned out
    to 6 candidate windows, 2^21 slots over 4 words) and T3's sort of
    (dead, symbol, ts), each bit for bit against its plain version; and
    the query's result against the smoke's numpy oracle."""
    import chip_smoke as CS
    d = CS.make_trades_data(1 << 18, 0)
    queries = {n: lf for n, lf, *_ in
               CS.time_queries(pt, CS.trades_frame(pt, d, "cuda"))}
    sorts, compactions = _recorded(queries[name])
    assert sorts and compactions
    if name == "T2_overlap":
        assert sorts[0][0][0].shape[0] == 1 << 21
    for words, nk, stable, perm_only in sorts:
        want = TM.merge_sort_words_plain(words, nk)
        got = TM.merge_sort_words(words, nk, stable=stable,
                                  perm_only=perm_only)
        if perm_only:
            assert torch.equal(got[0], want[nk])
        else:
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    for mask, words in compactions:
        outs, cnt = TP.compact_words(mask, words)
        wouts, wcnt = TP.compact_words_plain(mask.cpu(),
                                             [w.cpu() for w in words])
        k = int(cnt)
        assert k == int(wcnt)
        for o, w in zip(outs, wouts):
            assert torch.equal(o[:k].cpu(), w[:k])
    CS.check_time(name, CS.decoded_columns(queries[name].collect()), d)


@pytest.mark.parametrize("name", ["A1_backward", "I1_windows"])
def test_asof_route_kernels_match_plain(dev, name):
    """Kernels F and B on the inputs chip_smoke.py's phase-13 query gave
    them at 2^18 trades and quotes: A1's B over the run starts of the
    2^19-row (symbol) layout of both sides, I1's two F sorts of the 1024
    windows' (dead, hi, lo) words, each bit for bit against its plain
    version; and the query's result against the smoke's numpy oracle."""
    import chip_smoke as CS
    rows = 1 << 18
    td, qd = CS.make_trades_data(rows, 0), CS.make_quotes_data(rows, 0)
    wd = CS.make_windows_data(0)
    queries = {n: lf for n, lf, *_ in CS.asof_queries(
        pt, *CS.asof_frames(pt, td, qd, wd, "cuda"))}
    sorts, compactions = _recorded(queries[name])
    if name == "I1_windows":
        assert len(sorts) == 2 and not compactions
        assert all(w[0][0].shape[0] == 1024 and w[1] == 3 for w in sorts)
    else:
        assert not sorts and compactions
        assert compactions[0][0].shape[0] == 1 << 19
    for words, nk, stable, perm_only in sorts:
        want = TM.merge_sort_words_plain([w.cpu() for w in words], nk)
        got = TM.merge_sort_words(words, nk, stable=stable,
                                  perm_only=perm_only)
        assert torch.equal(got[0].cpu(), want[nk])
    for mask, words in compactions:
        outs, cnt = TP.compact_words(mask, words)
        wouts, wcnt = TP.compact_words_plain(mask.cpu(),
                                             [w.cpu() for w in words])
        k = int(cnt)
        assert k == int(wcnt)
        for o, w in zip(outs, wouts):
            assert torch.equal(o[:k].cpu(), w[:k])
    got = CS.host_columns(queries[name].collect())
    want, valid, tol = CS.asof_oracle(name, td, qd, wd, got)
    CS.compare_columns(name, got, want, valid, tol)


@pytest.mark.parametrize("every", ["1mo", "1q", "1y"])
def test_upsample_calendar_grid_on_card(dev, every):
    """upsample with a calendar `every` on the card: the same grid as on
    the CPU, each point whole months from the first."""
    ts = np.array(["2024-01-31T09:30", "2024-05-31T09:30",
                   "2026-12-31T09:30"], dtype="datetime64[us]")
    cols = {"t": ts, "v": np.array([1, 2, 3])}
    got = pt.DataFrame(cols, device="cuda").upsample("t", every=every)
    want = pt.DataFrame(cols, device="cpu").upsample("t", every=every)
    assert got.device.type == "cuda"
    assert got.to_dict() == want.to_dict()
    assert str(got.to_dict()["t"][1])[:10] == {
        "1mo": "2024-02-29", "1q": "2024-04-30", "1y": "2025-01-31"}[every]


@pytest.mark.parametrize("name", ["L1", "L2", "L3"])
def test_implode_and_explode_launches_on_card(dev, name):
    """chip_smoke.py's phase-14 L1 (implode of a flat, a String and a
    Struct column on the dense tier), L2 (an explode, then a dense
    group-by) and L3 (L1 exploded back to rows) at 2^16 trades on the
    card: the kernels each launches (L1 and L3: A for the group counts
    and C for each group's first sorted slot; L2: A, and B for the
    collect's compaction), every A and C launch held to its plain
    version, and the result against the smoke's numpy oracle."""
    import chip_smoke as CS
    d, x = CS.make_taq_data(1 << 16, 0)
    queries = {n: (lf, must) for n, lf, must, _ in
               CS.taq_queries(pt, CS.taq_frame(pt, d, "cuda"))}
    lf, must = queries[name]
    CS.reset_launches(TK, TP, TE, TH, TM)
    TK.RECORD, TK.MINMAX_RECORD = [], []
    try:
        out = lf.collect()
        sums, extremes = TK.RECORD, TK.MINMAX_RECORD
    finally:
        TK.RECORD = TK.MINMAX_RECORD = None
    launched = CS.read_launches(TK, TP, TE, TH, TM)
    for kernel in must:
        assert launched[kernel] >= 1, kernel
    assert launched["bucket_exchange"] == 0 and launched["merge_sort"] == 0
    for vals, gid, G, count in sums:
        got = TK.seg_sum(vals, gid, G, count)
        want = TK.seg_sum_plain(vals, gid, G, count)
        assert torch.allclose(got, want, rtol=1e-12, atol=0)
    for xs, gid, G, is_max, ident in extremes:
        assert torch.equal(TK.seg_minmax(xs, gid, G, is_max, ident),
                           TK.seg_minmax_plain(xs, gid, G, is_max, ident))
    assert (len(extremes) > 0) == (name != "L2")
    CS.taq_oracle(name, CS._taq_cols(out), d, x)


# --- fused chains: CUDA graphs (exec/compiled.py) ---------------------------

def _cuda_frame(seed, n=5000):
    rng = np.random.default_rng(seed)
    return frame_from_numpy({
        "symbol": rng.integers(0, 300, n).astype(np.uint32),
        "price": rng.uniform(1, 200, n).astype(np.float32),
        "volume": rng.integers(0, 5000, n).astype(np.int32)},
        device="cuda")


def _q1(df):
    c = pt.col
    return df.lazy().filter(c("volume") > 1000).with_columns(
        (c("price") * c("volume")).alias("notional")).group_by("symbol").agg(
            pt.len().alias("n"), c("notional").sum().alias("total"),
            c("price").mean().alias("avg"))


def test_replay_over_new_inputs_of_one_key(dev):
    CM.clear_cache()
    CM.reset_counts()
    frames = [_cuda_frame(s) for s in (1, 2, 3)]
    for df in frames:
        got = _q1(df).collect().sort("symbol").to_dict()
        want = pt.DataFrame._from_table(compact(execute_eager(optimize(
            _q1(df)._plan)))).sort("symbol").to_dict()
        assert got["symbol"] == want["symbol"] and got["n"] == want["n"]
        np.testing.assert_allclose(got["total"], want["total"], rtol=1e-12)
    # first sight, then a capture over buffers of its own, then a copy
    assert CM.COUNTS["captures"] == 2 and CM.COUNTS["replays"] == 2
    assert CM.COUNTS["static_copy_bytes"] > 0 and not CM.NOFUSE


def test_outputs_survive_the_next_replay(dev):
    CM.clear_cache()
    a, b = _cuda_frame(4), _cuda_frame(5)
    _q1(a).collect()
    first = _q1(a).collect()
    kept = first.to_dict()
    _q1(b).collect()
    _q1(b).collect()
    assert first.to_dict() == kept


def test_graph_counts_its_launches(dev):
    """The wrappers count the first collect's launches and none of a
    replay's (a capture runs nothing, a replay launches from the graph);
    the card runs the first collect's kernels in every replay, as a
    trace of it shows."""
    import chip_smoke as CS
    from polaroid_tpu_torch.ops import cuda_kernels as TK
    from polaroid_tpu_torch.ops import cuda_partition as TP
    CM.clear_cache()
    df = _cuda_frame(6)
    counts = []
    for _ in range(3):
        a, b = TK.LAUNCHES, TP.LAUNCHES
        _q1(df).collect()
        counts.append((TK.LAUNCHES - a, TP.LAUNCHES - b))
    assert counts[0][0] > 0 and counts[0][1] > 0
    assert counts[1] == counts[2] == (0, 0)
    tr = CS.trace_call(lambda: _q1(df).collect())
    assert (tr["launches"]["seg_sum"], tr["launches"]["compact_words"]) \
        == counts[0]


def test_a_graph_keeps_no_freed_frame_alive(dev):
    """A graph captured over a frame's own tensors holds them weakly:
    deleting the frame gives its memory back, and a new frame of the
    same key is captured again over buffers of the graph's own."""
    import gc
    CM.clear_cache()
    torch.cuda.synchronize()
    df = _cuda_frame(10, n=1 << 20)
    nbytes = sum(c.data.untyped_storage().nbytes()
                 for c in df._table.cols.values())
    _q1(df).collect()
    _q1(df).collect()
    assert CM.cache_info()["graphs"] == 1
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    del df
    gc.collect()
    torch.cuda.synchronize()
    assert held - torch.cuda.memory_allocated() >= nbytes
    CM.reset_counts()
    other = _cuda_frame(11, n=1 << 20)
    for _ in range(2):
        got = _q1(other).collect().sort("symbol").to_dict()
        want = pt.DataFrame._from_table(compact(execute_eager(optimize(
            _q1(other)._plan)))).sort("symbol").to_dict()
        assert got["symbol"] == want["symbol"] and got["n"] == want["n"]
        np.testing.assert_allclose(got["total"], want["total"], rtol=1e-12)
    assert CM.COUNTS["captures"] == 1 and CM.COUNTS["replays"] == 2


def test_a_concurrent_sync_leaves_the_chain_captured(dev):
    """Another thread's syncs while a chain is first seen are not the
    chain's: it is captured, not marked no-fuse."""
    import threading
    CM.clear_cache()
    CM.reset_counts()
    df = _cuda_frame(12)
    stop = threading.Event()
    synced = []

    def other():
        x = torch.ones(1, device=dev)
        while not stop.is_set():
            synced.append(int(x.sum()))
    th = threading.Thread(target=other)
    th.start()
    try:
        while not synced:
            pass
        _q1(df).collect()
    finally:
        stop.set()
        th.join()
    assert CM.COUNTS["captures"] == 1 and not CM.NOFUSE


def test_capture_of_a_c_and_d_alone(dev):
    """Kernels A, C and D captured alone and replayed over new inputs
    equal their plain versions."""
    from polaroid_tpu_torch.ops import cuda_build as B
    from polaroid_tpu_torch.ops import cuda_kernels as TK
    n, G = 100_000, 1000
    g = torch.Generator(device=dev).manual_seed(7)
    vals = torch.rand((2, n), generator=g, device=dev, dtype=torch.float64)
    gid = torch.randint(0, G, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    x = torch.rand(n, generator=g, device=dev)
    table = torch.rand(G, generator=g, device=dev, dtype=torch.float64)
    # warm up (libraries, scratch) on the side stream, then capture
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        TK.seg_sum(vals, gid, G)
        TK.seg_minmax(x, gid, G, True, float("-inf"))
        TK.gather(table, gid)
    torch.cuda.current_stream().wait_stream(s)
    B.prepare_scratch(gid.device, s.cuda_stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        a = TK.seg_sum(vals, gid, G)
        c = TK.seg_minmax(x, gid, G, True, float("-inf"))
        d = TK.gather(table, gid)
    for seed in (8, 9):
        g.manual_seed(seed)
        vals.copy_(torch.rand((2, n), generator=g, device=dev,
                              dtype=torch.float64))
        x.copy_(torch.rand(n, generator=g, device=dev))
        gid.copy_(torch.randint(0, G, (n,), generator=g, device=dev,
                                dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want = TK.seg_sum_plain(vals, gid, G)
        assert torch.allclose(a, want, rtol=1e-12, atol=1e-9)
        assert torch.equal(c, TK.seg_minmax_plain(x, gid, G, True,
                                                  float("-inf")))
        assert torch.equal(d, TK.gather_plain(table, gid))


# --- kernels A and C at the adaptive group-by's 8192 groups ---------------

@pytest.mark.parametrize("C", [1, 3, 4, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_seg_sum_kernel_at_8192_groups(dev, C, dtype):
    """G = MAX_GROUPS = 8192: 3 rows of partials fit a block's shared
    memory, so C = 4 and 7 take several column groups, in the launches
    the plan gives (one)."""
    G, n = TK.MAX_GROUPS, (1 << 20) + 3
    assert G == 8192
    g = torch.Generator().manual_seed(C)
    gid = torch.randint(-2, G + 2, (n,), generator=g, dtype=torch.int32)
    vals = torch.randn(C, n, generator=g, dtype=torch.float64).to(dtype)
    plan = TK.seg_sum_plan(C, G, False, TK._sm_count(dev), n)
    assert plan.groups == -(-C // 3)
    before = TK.LAUNCHES
    got = TK.seg_sum(vals.to(dev), gid.to(dev), G)
    torch.cuda.synchronize()
    assert TK.LAUNCHES - before == plan.launches
    want = TK.seg_sum_plain(vals, gid, G)
    mag = TK.seg_sum_plain(vals.abs(), gid, G)
    assert torch.all((got.cpu() - want).abs() <= 1e-12 * mag + 1e-300)


def _seg_sum_vs_plain(dev, vals, gid, G, count):
    """Kernel A on the card against its plain version on the CPU: one
    launch a call, the count row exact, each sum within 2 * n_g * 2^-53 *
    sum|v| of its group (the order of the additions varies)."""
    before = TK.LAUNCHES
    got = TK.seg_sum(vals.to(dev), gid.to(dev), G, count)
    torch.cuda.synchronize()
    assert TK.LAUNCHES - before == 1
    C, n = vals.shape
    assert tuple(got.shape) == (C + count, G)
    want = TK.seg_sum_plain(vals, gid, G, count)
    mag = TK.seg_sum_plain(vals.abs(), gid, G, count)
    n_g = TK.seg_sum_plain(torch.ones((1, n), dtype=torch.float64), gid, G)
    got = got.cpu()
    if count:
        assert torch.equal(got[0], want[0])
    assert torch.all((got - want).abs() <= 2 * n_g * 2.0 ** -53 * mag)


@pytest.mark.parametrize("keys,n,G,C,dtype,count", [
    # every row in one group: every slot a butterfly
    ("one", 1 << 20, 1024, 2, torch.float64, True),
    ("one", 100_003, 7, 1, torch.float32, False),
    # L2's six hot codes of 128, small
    ("hot6", 1 << 20, 128, 0, torch.float32, True),
    ("hot6", 1 << 20, 128, 1, torch.float32, True),
    ("hot6", 1 << 20, 128, 3, torch.float64, False),
    # one row; rows not a multiple of a block's chunk; runs of one group
    ("uniform", 1, 8192, 2, torch.float32, True),
    ("uniform", 1024 * 8 * 3 + 7, 300, 2, torch.float64, True),
    ("runs", 1 << 18, 1000, 2, torch.float32, True),
])
def test_seg_sum_kernel_hot_keys(dev, keys, n, G, C, dtype, count):
    g = torch.Generator().manual_seed(n + G + C)
    if keys == "one":
        gid = torch.full((n,), G // 2, dtype=torch.int32)
    elif keys == "hot6":
        codes = torch.randperm(G, generator=g)[:6]
        gid = codes[torch.randint(0, 6, (n,), generator=g)].to(torch.int32)
    elif keys == "runs":
        gid = (torch.arange(n) // 300 % (G + 5) - 2).to(torch.int32)
    else:
        gid = torch.randint(-2, G + 2, (n,), generator=g, dtype=torch.int32)
    vals = torch.randn(C, n, generator=g, dtype=torch.float64).to(dtype)
    _seg_sum_vs_plain(dev, vals, gid, G, count)


@pytest.mark.parametrize("C", range(1, 8))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_seg_sum_kernel_at_8192_groups_counting(dev, C, dtype):
    """G = 8192 at C = 1..7 with the count row (in the first column
    group), ids outside [0, G) among them."""
    G, n = TK.MAX_GROUPS, (1 << 19) + 11
    g = torch.Generator().manual_seed(100 + C)
    gid = torch.randint(-2, G + 2, (n,), generator=g, dtype=torch.int32)
    vals = torch.randn(C, n, generator=g, dtype=torch.float64).to(dtype)
    _seg_sum_vs_plain(dev, vals, gid, G, True)


@pytest.mark.parametrize("C", [0, 4])
@pytest.mark.parametrize("G", [1, 1024, 8192])
def test_seg_sum_kernel_counting_mode(dev, C, G):
    """The counting mode with no value row and with four: row 0 counts the
    ids in [0, G), exactly the old call over a row of ones."""
    n = 300_001
    g = torch.Generator().manual_seed(C + G)
    gid = torch.randint(-3, G + 3, (n,), generator=g, dtype=torch.int32)
    vals = torch.randn(C, n, generator=g, dtype=torch.float64)
    _seg_sum_vs_plain(dev, vals, gid, G, True)
    ones = torch.cat([torch.ones((1, n), dtype=torch.float64), vals]).to(dev)
    assert torch.equal(TK.seg_sum(vals.to(dev), gid.to(dev), G, True)[0],
                       TK.seg_sum(ones, gid.to(dev), G)[0])


def test_seg_sum_plan_fits_the_card(dev):
    """Every plan's block fits an SM of the card: the occupancy the card
    reports for its threads and shared memory is at least one."""
    import ctypes
    lib = TK._seg_lib()
    sms = TK._sm_count(dev)
    for C in range(10):
        for G in (1, 128, 1024, 2048, 4096, 8192):
            for count in (False, True):
                if not (C or count):
                    continue
                p = TK.seg_sum_plan(C, G, count, sms, 1 << 22)
                for f64 in (0, 1):
                    b = ctypes.c_int()
                    assert lib.pt_seg_sum_occupancy(
                        f64, p.cmax, p.threads, p.smem, ctypes.byref(b)) == 0
                    assert b.value >= 1, (C, G, count, p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int32, torch.int64])
def test_seg_minmax_kernel_at_8192_groups(dev, dtype):
    """Bit for bit at G = 8192 (2 x 8192 keys and NaN patterns in shared
    memory: 128 KB for 8-byte types)."""
    G, n = TK.MAX_GROUPS, (1 << 20) + 5
    g = torch.Generator().manual_seed(8192)
    x, gid, lo, hi = _minmax_input(n, G, dtype, g)
    kt = {torch.float32: torch.int32, torch.float64: torch.int64}.get(
        dtype, dtype)
    for is_max in (False, True):
        ident = lo if is_max else hi
        got = TK.seg_minmax(x.to(dev), gid.to(dev), G, is_max, ident)
        want = TK.seg_minmax_plain(x, gid, G, is_max, ident)
        assert torch.equal(got.cpu().view(kt), want.view(kt)), is_max


# --- Slice G: the adaptive local group-by and the distributed engine --------

@pytest.mark.parametrize("route", ["dense_1024", "dense_8192", "hash",
                                   "carry"])
def test_adaptive_local_groupby_on_card_matches_cpu(dev, route):
    """Each route of `local_groupby` over u32 keys on the card (kernels
    A and C, E and B, or F and B) against the same call on the CPU."""
    from polaroid_tpu_torch.dtypes import UInt32
    from polaroid_tpu_torch.parallel import shuffle as SH
    n = 1 << 16
    g = np.random.default_rng(3)
    key = {"dense_1024": g.integers(10, 1000, n),
           "dense_8192": g.integers(10, 8000, n),
           "hash": g.integers(0, 1 << 32, n),
           "carry": g.choice([7, 123456789], n)}[route]
    valid = torch.from_numpy(g.uniform(size=n) > 0.1)
    v = torch.from_numpy(g.normal(0, 10, n).astype(np.float32))
    aggs = ["sum", "count", "min", "max"]
    k = torch.from_numpy(key.astype(np.int64))
    TH.ADAPTIVE_ROUTES.clear()
    got = SH.local_groupby(k.to(dev), [v.to(dev)] * 4, valid.to(dev), aggs,
                           UInt32)
    assert dict(TH.ADAPTIVE_ROUTES) == {route: 1}
    want = SH._local_groupby_carry(k, [v] * 4, valid, aggs, UInt32)
    gv, wv = got[2].cpu(), want[2]
    gk = got[0].cpu()[gv]
    order = torch.argsort(gk)
    assert torch.equal(gk[order], want[0][wv])
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        a = a.cpu()[gv][order]
        if i == 0:
            assert torch.allclose(a, b[wv], rtol=1e-5, atol=1e-3)
        else:
            assert torch.equal(a, b[wv])


@pytest.mark.parametrize("cards", ["one", "every"])
def test_distributed_collect_on_a_4_slot_card_mesh(dev, cards):
    """The engine on 4 slots of one card (or slot s on card s % cards,
    where the exchange copies blocks between cards) against 4 slots on
    the CPU: the sharded and exact group-bys, the sample sort, a join
    and a distinct."""
    from polaroid_tpu_torch.exec import distributed as D
    from polaroid_tpu_torch.parallel.mesh import make_mesh
    n_cards = torch.cuda.device_count()
    if cards == "every" and n_cards < 2:
        pytest.skip("needs two or more CUDA devices")
    g = np.random.default_rng(4)
    n = 1 << 14
    data = {"k": g.integers(0, 500, n), "s": g.integers(0, 7, n),
            "v": g.normal(0, 10, n)}
    dim = {"k": np.arange(0, 1000, 3), "w": np.arange(334)}
    card = make_mesh(devices=[torch.device("cuda", 0)] * 4) \
        if cards == "one" else make_mesh(4)
    cpu = make_mesh(4, device="cpu")
    c = pt.col
    queries = [
        (lambda d, e: d.group_by("k").agg(c("v").sum(), pt.len()), "k"),
        (lambda d, e: d.group_by("k", "s").agg(c("v").median()),
         ["k", "s"]),
        (lambda d, e: d.sort(["s", "k"], maintain_order=True), None),
        (lambda d, e: d.join(e, on="k", how="left"), ["k", "v"]),
        (lambda d, e: d.unique(subset=["k", "s"], keep="first",
                               maintain_order=True), None),
    ]
    for build, keys in queries:
        out = {}
        for mesh, device in ((card, "cuda"), (cpu, "cpu")):
            q = build(pt.LazyFrame(data, device=device),
                      pt.LazyFrame(dim, device=device))
            D.reset_counts()
            r = q.collect(engine="distributed", mesh=mesh)
            assert D.COUNTS["dropped"] == 0 and "local" not in D.ROUTES
            out[device] = (r.sort(keys) if keys else r).to_dict()
        for col in out["cpu"]:
            a, b = out["cuda"][col], out["cpu"][col]
            if col == "v":
                np.testing.assert_allclose(
                    np.array(a, float), np.array(b, float), rtol=1e-12)
            else:
                assert a == b, col
