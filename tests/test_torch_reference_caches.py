"""The JAX package's process-wide caches, made safe for the port's
differential tests.

`polaroid_tpu/exec/compiled.py`'s `_CACHE` keeps compiled programs that
an earlier test file can leave stale for a later one's plans. And
`polaroid_tpu/api/lazyframe.py`'s `_OPT_CACHE` keys optimized plans by
the `id()` of their frames' tables while it keeps only a projected copy
of each table: once a frame is freed, a new frame whose table takes the
same id is handed the old frame's optimized plan, and with it the old
data (`tests/test_torch_q1.py::test_q1_matches_reference[str]` read the
`[u32]` case's UInt32 symbol so). A port test module runs inside
`fresh_reference_caches()`: the compile cache emptied when it starts
and when it ends, and the optimizer cache keeping nothing while it
runs; the test below holds the JAX package to a new frame's own data on
a freed table's id inside it. The compile cache keys a program by its
chain and the table's layout, not its row count, and the program keeps
the row count of its first table: `tests/test_server.py`'s SQL over 500
rows counted 300 when it ran in a worker after
`tests/test_torch_server.py` had run the same SQL over 300 rows. The JAX
package itself is not changed.
"""

import contextlib
from collections import OrderedDict


class _KeepsNothing(OrderedDict):
    def __setitem__(self, key, value):
        pass


@contextlib.contextmanager
def fresh_reference_caches():
    from polaroid_tpu.api import lazyframe
    from polaroid_tpu.exec import compiled
    compiled._CACHE.clear()
    saved = lazyframe._OPT_CACHE
    lazyframe._OPT_CACHE = _KeepsNothing()
    try:
        yield
    finally:
        lazyframe._OPT_CACHE = saved
        compiled._CACHE.clear()


def test_reference_frame_on_a_freed_tables_id_gets_its_own_result():
    """Inside `fresh_reference_caches()` the JAX package answers a new
    frame whose table takes a freed table's id with the new frame's own
    data (outside it, its optimizer cache can hand back the freed
    frame's); the programs it compiled inside are gone when it ends."""
    import gc

    import polaroid_tpu as ref
    from polaroid_tpu.batch import Table
    from polaroid_tpu.exec import compiled

    def q(df):
        return df.lazy().filter(ref.col("v") > 0).select("k", "v") \
            .collect().to_dict()
    with fresh_reference_caches():
        old = ref.DataFrame({"k": [1, 2, 3], "v": [1, 2, 3],
                             "z": [0, 0, 0]})
        proto = ref.DataFrame({"k": [7, 8, 9], "v": [4, 5, 6],
                               "z": [1, 1, 1]})._table
        assert q(old) == {"k": [1, 2, 3], "v": [1, 2, 3]}
        freed = id(old._table)
        del old
        gc.collect()
        keep = []
        for _ in range(200_000):
            t = Table(list(proto.names), dict(proto.cols), proto.capacity, 3)
            if id(t) == freed:
                break
            keep.append(t)
        assert q(ref.DataFrame._from_table(t)) == {"k": [7, 8, 9],
                                                   "v": [4, 5, 6]}
        assert compiled._CACHE
    assert not compiled._CACHE
