"""The length-changing select kinds after a hash-tier group-by, a sort
after a filter, unique(maintain_order=True), head after a filter and a
concat of filtered frames, the port against the JAX package
(tests/torch_holes.py says how, and with which tolerances)."""

import pytest

from torch_holes import check_guard, check_repaired, guard_cases, \
    repaired_cases


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


SOURCES = ("group_by_hash", "sort", "unique", "head", "concat")


@pytest.mark.parametrize("src,kind,ctx", repaired_cases(SOURCES))
def test_repaired_kind(src, kind, ctx):
    check_repaired(src, kind, ctx)


@pytest.mark.parametrize("src,kind", guard_cases(SOURCES))
def test_guard_kind(src, kind):
    check_guard(src, kind)
