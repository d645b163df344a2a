"""`chip_smoke.py`'s oracles sort by torch.sort passes (on the card from
2^16 keys on): lexsort, argsort and searchsorted held to numpy's
permutations and positions on the CPU, at 2^17 keys of every key dtype,
with ties, NaN, -0.0, both infinities and unsigned 64-bit words past
2^63. The script makes the same check on the card before its phases."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402


@pytest.mark.parametrize("dtype", CS.ORACLE_SORT_DTYPES)
def test_oracle_sorts_match_numpy(dtype):
    assert CS.check_oracle_sorts("cpu", n=1 << 17, seed=3,
                                 dtypes=(dtype,)) == [dtype]


def test_oracle_sort_keys_hold_the_hard_values():
    rng = np.random.default_rng(0)
    f = CS.oracle_sort_keys("float64", 1 << 16, rng)
    assert np.isnan(f).any() and (np.signbit(f) & (f == 0)).any()
    assert np.isinf(f).any() and len(np.unique(f)) < len(f) // 100
    u = CS.oracle_sort_keys("uint64", 1 << 16, rng)
    assert (u >= np.uint64(1 << 63)).any() and (u < np.uint64(1 << 63)).any()


def test_small_inputs_sort_by_numpy():
    x = np.array([3.0, np.nan, -0.0, 0.0, 1.0])
    assert CS._oracle_device(len(x), None) is None
    assert np.array_equal(CS.argsort(x), np.argsort(x, kind="stable"))
