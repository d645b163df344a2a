"""Inequality joins (`join_where`) through the JAX package and the port.

The same seeded numpy inputs go through `polaroid_tpu` (its CPU path)
and through `polaroid_tpu_torch` with device="cpu" (kernel F's plain
version for the sorts, the wavelet tree of `ops/wavelet.py`): one
predicate with each of lt/le/gt/ge, two predicates with each op in each
position, three (the third filters the pairs), a predicate written
right to left, nulls in the keys, Int64, Float64 and Datetime keys, a
name clash that takes the suffix, and a predicate that does not split
into one side each (the cross join and filter). The port enumerates the
pairs in the JAX package's order, so every column is compared bit for
bit, row order included. `chip_smoke.py`'s I1 query at 2^12 trades is
held to its numpy oracle in tests/test_torch_asof.py.
"""

import struct

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
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


NL, NR = 300, 90
OPS = ["lt", "le", "gt", "ge"]
_CMP = {"lt": "__lt__", "le": "__le__", "gt": "__gt__", "ge": "__ge__"}


def _keys(kind, rng, n):
    if kind == "int":
        return rng.integers(-40, 40, n)
    if kind == "float":
        return rng.normal(0, 20, n).round(1)
    return np.datetime64("2024-03-04T14:30", "us") + \
        rng.integers(0, 80, n) * np.timedelta64(1, "s")


def tables(kind="int", seed=1):
    rng = np.random.default_rng(seed)
    left = {"x": _keys(kind, rng, NL), "y": _keys(kind, rng, NL),
            "v": rng.normal(size=NL)}
    right = {"lo": _keys(kind, rng, NR), "hi": _keys(kind, rng, NR),
             "v": rng.integers(0, 100, NR), "w": rng.normal(size=NR)}
    return left, right


def _pred(m, a, op, b):
    return getattr(m.col(a), _CMP[op])(m.col(b))


def _cell(v):
    return struct.pack("<d", v) if isinstance(v, float) else v


def same(got, want):
    g, w = got.to_dict(), want.to_dict()
    assert list(g) == list(w)
    for k in w:
        assert [_cell(x) for x in g[k]] == [_cell(x) for x in w[k]], k


def both(left, right, preds, lazy=False, valid=None):
    """join_where through both packages: preds is a list of (left name,
    op, right name) or a function of the module."""
    mk = (lambda m: [_pred(m, *p) for p in preds]) if isinstance(
        preds, list) else preds
    rl, rr = ref.DataFrame(left), ref.DataFrame(right)
    tl = frame_from_numpy(left, validity=(valid or {}).get("l"),
                          device="cpu")
    tr = frame_from_numpy(right, validity=(valid or {}).get("r"),
                          device="cpu")
    if valid:
        for t, r in ((tl, rl), (tr, rr)):
            for k, c in t._table.cols.items():
                if c.validity is not None:
                    import jax.numpy as jnp
                    vm = np.zeros(r._table.capacity, dtype=bool)
                    vm[:t.height] = c.validity.numpy()[:t.height]
                    r._table.cols[k].validity = jnp.asarray(vm)
    if lazy:
        got = tl.lazy().join_where(tr.lazy(), *mk(pt)).collect()
    else:
        got = tl.join_where(tr, *mk(pt))
    return got, rl.join_where(rr, *mk(ref))


ONE = [("int", op) for op in OPS] + [("float", "lt"), ("float", "ge"),
                                     ("datetime", "le"), ("datetime", "gt")]
# every op in each position twice, every op beside every other once
TWO = [("lt", "lt"), ("le", "ge"), ("gt", "le"), ("ge", "gt"), ("lt", "ge"),
       ("le", "lt"), ("gt", "gt"), ("ge", "le")]


@pytest.mark.parametrize("kind,op", ONE)
def test_one_predicate(op, kind):
    left, right = tables(kind)
    same(*both(left, right, [("x", op, "lo")]))


@pytest.mark.parametrize("op1,op2", TWO)
def test_two_predicates(op1, op2):
    left, right = tables("int", seed=2)
    same(*both(left, right, [("x", op1, "lo"), ("y", op2, "hi")],
               lazy=op1 == op2))


@pytest.mark.parametrize("kind", ["float", "datetime"])
def test_two_predicates_other_keys(kind):
    left, right = tables(kind, seed=3)
    same(*both(left, right, [("x", "ge", "lo"), ("x", "lt", "hi")]))


@pytest.mark.parametrize("ops", [("gt", "le", "lt"), ("ge", "ge", "ge"),
                                 ("lt", "gt", "le")])
def test_three_predicates_filter_the_pairs(ops):
    left, right = tables("int", seed=4)
    same(*both(left, right, [("x", ops[0], "lo"), ("y", ops[1], "hi"),
                             ("y", ops[2], "lo")]))


def test_predicate_written_right_to_left_and_suffix():
    """`lo > x` is `x < lo`; the right `v` clashes and becomes `v_right`,
    and a predicate may name it so."""
    left, right = tables("int", seed=5)
    got, want = both(left, right, lambda m: [
        m.col("lo") > m.col("x"), m.col("v_right") < 50])
    assert "v_right" in got.columns
    same(got, want)


def test_nulls_in_the_keys_match_nothing():
    left, right = tables("int", seed=6)
    rng = np.random.default_rng(7)
    valid = {"l": {"x": rng.random(NL) > 0.2},
             "r": {"hi": rng.random(NR) > 0.2}}
    same(*both(left, right, [("x", "le", "lo"), ("y", "gt", "hi")],
               valid=valid))


def test_no_decomposable_predicate_is_a_cross_join_and_filter():
    left, right = tables("int", seed=8)
    left = {k: v[:40] for k, v in left.items()}
    right = {k: v[:30] for k, v in right.items()}
    same(*both(left, right, lambda m: [
        (m.col("x") + m.col("lo")) > 3], lazy=True))
