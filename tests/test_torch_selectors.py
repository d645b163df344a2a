"""`pl.selectors` in the port against the JAX package's: every selector,
its set algebra and its use as an expression, on one frame of every
flat dtype, through both packages (column names and values exact;
Float64 results within rtol 1e-12)."""

import datetime as dtm

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu.selectors as rcs
import polaroid_tpu_torch as pt
import polaroid_tpu_torch.selectors as pcs
from polaroid_tpu_torch.testing import assert_frame_equal


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


def _data():
    return {"abc": [1, 2, 3], "xyz": [1.5, 2.5, None],
            "flag": [True, False, True], "name": ["a", "b", "a"],
            "d": [dtm.date(2024, 1, 1)] * 3,
            "ts": [dtm.datetime(2024, 1, 1, 9, 30)] * 3,
            "u8": np.array([1, 2, 3], dtype=np.uint8),
            "f32": np.array([0.5, 1.5, 2.5], dtype=np.float32),
            "9lives": [7, 8, 9]}


def _frames():
    return ref.DataFrame(_data()), pt.DataFrame(_data(), device="cpu")


SELECTORS = {
    "all": lambda cs: cs.all(), "first": lambda cs: cs.first(),
    "last": lambda cs: cs.last(), "numeric": lambda cs: cs.numeric(),
    "float": lambda cs: cs.float(), "integer": lambda cs: cs.integer(),
    "signed": lambda cs: cs.signed_integer(),
    "unsigned": lambda cs: cs.unsigned_integer(),
    "boolean": lambda cs: cs.boolean(), "string": lambda cs: cs.string(),
    "date": lambda cs: cs.date(), "datetime": lambda cs: cs.datetime(),
    "temporal": lambda cs: cs.temporal(),
    "by_dtype": lambda cs: cs.by_dtype(
        pt.Int64 if cs is pcs else ref.Int64),
    "by_name": lambda cs: cs.by_name("abc", "name"),
    "by_index": lambda cs: cs.by_index(0, -1),
    "starts_with": lambda cs: cs.starts_with("a", "x"),
    "ends_with": lambda cs: cs.ends_with("g"),
    "contains": lambda cs: cs.contains("y"),
    "matches": lambda cs: cs.matches("^[an]"),
    "alpha": lambda cs: cs.alpha(), "alphanumeric": lambda cs:
    cs.alphanumeric(), "digit": lambda cs: cs.digit(),
    "exclude": lambda cs: cs.exclude("abc", "d"),
    "or": lambda cs: cs.numeric() | cs.boolean(),
    "and": lambda cs: cs.numeric() & cs.by_name("abc"),
    "minus": lambda cs: cs.numeric() - cs.by_name("abc"),
    "not": lambda cs: ~cs.numeric(),
}


@pytest.mark.parametrize("name", sorted(SELECTORS))
def test_selector_picks_the_same_columns(name):
    rdf, pdf = _frames()
    build = SELECTORS[name]
    want = rdf.select(build(rcs))
    got = pdf.select(build(pcs))
    assert got.columns == want.columns
    assert_frame_equal(got, want, check_exact=True)


@pytest.mark.parametrize("case", ["sum", "lazy_mul", "group_by", "expand",
                                  "expand_schema"])
def test_selector_as_expression(case):
    rdf, pdf = _frames()
    if case == "sum":
        got = pdf.select(pcs.numeric().sum())
        want = rdf.select(rcs.numeric().sum())
    elif case == "lazy_mul":
        got = pdf.lazy().select(pcs.float() * 2).collect()
        want = rdf.lazy().select(rcs.float() * 2).collect()
    elif case == "group_by":
        got = pdf.group_by("name").agg(pcs.integer().sum()).sort("name")
        want = rdf.group_by("name").agg(rcs.integer().sum()).sort("name")
    elif case == "expand":
        assert pcs.expand_selector(pdf, pcs.numeric()) == \
            rcs.expand_selector(rdf, rcs.numeric())
        return
    else:
        assert pcs.expand_selector(dict(pdf.schema), pcs.string()) == \
            rcs.expand_selector(dict(rdf.schema), rcs.string()) == ("name",)
        return
    assert_frame_equal(got, want, rtol=1e-12, atol=0.0)
