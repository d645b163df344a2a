"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip without an NVIDIA GPU (as on a CPU-only test
host). Run them on a machine with a card and nvcc, without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import polaroid_tpu_torch as pt
from polaroid_tpu_torch.ops import cuda_kernels as TK
from polaroid_tpu_torch.ops import cuda_partition as TP

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
