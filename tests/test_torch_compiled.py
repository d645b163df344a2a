"""The fused chain (`exec/compiled.py`) against the JAX package's.

The chain fingerprints and the cache key's table part are the JAX
package's on the same plans and data; on the CPU `run_fused` applies the
chain node by node and gives what the executor's eager function gives;
the first-sight logic marks a chain that read back as no-fuse, names the
op and runs it eagerly from then on, and raises on any other error;
`LazyFrame.profile` times the nodes the JAX package's executor times.
The graphs themselves are captured and replayed on the card by the
`cuda` tests of `tests/test_torch_cuda.py`.
"""

import warnings

import numpy as np
import pytest
import torch

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
from polaroid_tpu_torch.exec import compiled as CM
from polaroid_tpu_torch.exec.executor import execute, execute_eager
from polaroid_tpu_torch.ops.compact import compact
from polaroid_tpu_torch.plan.optimizer import optimize


@pytest.fixture(autouse=True, scope="module")
def _fresh_reference_cache():
    """The JAX package's process-wide caches (its compiled chains, and
    its optimized plans keyed by the id of a table that may be freed)
    can hand this file's plans another frame's results; start the file
    with the first empty and keep the second from storing anything
    while it runs (`tests/test_torch_reference_caches.py`)."""
    CM.clear_cache()
    from test_torch_reference_caches import fresh_reference_caches
    with fresh_reference_caches():
        yield


N = 600


def _data(seed=3):
    rng = np.random.default_rng(seed)
    return {"symbol": rng.integers(0, 40, N).astype(np.int64),
            "price": rng.uniform(1, 200, N),
            "volume": rng.integers(0, 5000, N).astype(np.int64),
            "tag": [f"t{i}" for i in rng.integers(0, 7, N)]}


def _frames(seed=3):
    d = _data(seed)
    return ref.DataFrame(d), pt.DataFrame(d, device="cpu"), d


def _queries(pl):
    c = pl.col
    return {
        "q1": lambda lf: lf.filter(c("volume") > 1000).with_columns(
            (c("price") * c("volume")).alias("notional")).group_by(
                "symbol").agg(pl.len().alias("n"),
                              c("notional").sum().alias("total"),
                              c("price").mean().alias("avg")),
        "chain": lambda lf: lf.filter(c("price") > 50).with_columns(
            (c("price") * 2).alias("p2")).select("symbol", "p2", "tag"),
        "ordered": lambda lf: lf.filter(c("volume") > 100).group_by(
            "symbol", maintain_order=True).agg(c("price").max().alias("hi")),
        "sort": lambda lf: lf.with_columns((c("price") - 1).alias("q"))
        .sort("q"),
        "string_key": lambda lf: lf.with_columns(
            (c("volume") * 2).alias("v2")).group_by("tag").agg(
                c("v2").sum().alias("s")),
    }


QUERIES = sorted(_queries(pt))


def _chain(pkg, lf):
    plan = pkg.plan.optimizer.optimize(lf._plan)
    return pkg.exec.compiled.collect_fusable_chain(plan)


@pytest.mark.parametrize("name", QUERIES)
def test_chain_fingerprints_match_jax(name):
    import polaroid_tpu.exec.compiled  # noqa: F401
    import polaroid_tpu.plan.optimizer  # noqa: F401
    import polaroid_tpu_torch.plan.optimizer  # noqa: F401
    rdf, tdf, _ = _frames()
    rchain, rinp = _chain(ref, _queries(ref)[name](rdf.lazy()))
    tchain, tinp = _chain(pt, _queries(pt)[name](tdf.lazy()))
    assert [n.kind for n in tchain] == [n.kind for n in rchain]
    assert CM.plan_chain_fingerprint(tchain) == \
        ref.exec.compiled.plan_chain_fingerprint(rchain)
    assert tinp.kind == rinp.kind


def _normalized_key(key):
    """A table key with each dictionary version as whether there is one
    (the two packages number their dictionaries apart)."""
    items, cap, live = key
    return (tuple((n, dt, v, bool(ver), st) for n, dt, v, ver, st in items),
            cap, live)


@pytest.mark.parametrize("name", QUERIES)
def test_table_keys_match_jax(name):
    from polaroid_tpu.exec import compiled as RC
    rdf, tdf, _ = _frames()
    rchain, rinp = _chain(ref, _queries(ref)[name](rdf.lazy()))
    tchain, tinp = _chain(pt, _queries(pt)[name](tdf.lazy()))
    RC._ensure_groupby_stats(rchain, rinp.table)
    CM._ensure_groupby_stats(tchain, tinp.table)
    assert _normalized_key(CM._table_key(tinp.table)) == \
        _normalized_key(RC._table_key(rinp.table))


@pytest.mark.parametrize("name", QUERIES)
def test_cpu_run_fused_is_node_by_node(name):
    _, tdf, _ = _frames(seed=5)
    lf = _queries(pt)[name](tdf.lazy())
    plan = optimize(lf._plan)
    chain, inp = CM.collect_fusable_chain(plan)
    assert len(chain) >= 2 or chain[-1].kind in CM.BREAKERS
    got = compact(CM.run_fused(chain, inp.table)).to_numpy_dict()
    t = inp.table
    for node in chain:
        t = CM._apply_node(node, t)
    want = compact(t).to_numpy_dict()
    eager = compact(execute_eager(plan)).to_numpy_dict()
    fused = compact(execute(plan)).to_numpy_dict()
    for other in (want, eager, fused):
        assert got.keys() == other.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], other[k])


@pytest.mark.parametrize("name", QUERIES)
def test_cpu_collect_matches_jax(name):
    rdf, tdf, _ = _frames(seed=9)
    r = _queries(ref)[name](rdf.lazy()).collect().to_dict()
    t = _queries(pt)[name](tdf.lazy()).collect().to_dict()
    assert r.keys() == t.keys()
    keys = [k for k in r if isinstance(r[k][0], str) or k == "symbol"]
    order_r = sorted(range(len(next(iter(r.values())))),
                     key=lambda i: tuple(r[k][i] for k in keys))
    order_t = sorted(range(len(next(iter(t.values())))),
                     key=lambda i: tuple(t[k][i] for k in keys))
    for k in r:
        a = [r[k][i] for i in order_r]
        b = [t[k][i] for i in order_t]
        if a and isinstance(a[0], float):
            np.testing.assert_allclose(b, a, rtol=1e-12)
        else:
            assert a == b, k


# --- the first-sight logic, with the card's parts stood in for -------------

class _Fake:
    """A masked table that claims to lie on the card, so that run_fused
    takes its CUDA route; the eager run, the capture and the node
    application are stood in for by the test."""

    def __init__(self, monkeypatch):
        _, tdf, _ = _frames()
        lf = _queries(pt)["chain"](tdf.lazy())
        self.chain, inp = CM.collect_fusable_chain(optimize(lf._plan))
        t = inp.table
        self.table = t.with_valid(t.row_mask(), None)
        self.table.device = torch.device("cuda", 0)
        self.applied = []
        self.captured = []
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(CM, "_apply_node", lambda node, t: (
            self.applied.append(node.kind), t)[1])
        monkeypatch.setattr(CM, "_capture", lambda *a: (
            self.captured.append(a), (_ for _ in ()).throw(
                AssertionError("captured"))))
        CM.clear_cache()
        CM.reset_counts()


def test_readback_chain_is_marked_nofuse_and_runs_eagerly(monkeypatch):
    f = _Fake(monkeypatch)
    site = "polaroid_tpu_torch/ops/merge_sort.py:121"
    monkeypatch.setattr(CM, "run_detecting_readbacks",
                        lambda fn: ("first result", site))
    assert CM.run_fused(f.chain, f.table) == "first result"
    fp = CM.plan_chain_fingerprint(f.chain)
    assert CM.NOFUSE == {fp: site}
    assert CM.COUNTS["nofuse"] == 1 and not f.captured
    # from then on the chain runs node by node on the caller's table
    out = CM.run_fused(f.chain, f.table)
    assert out is f.table and f.applied == [n.kind for n in f.chain]
    assert CM.COUNTS["eager"] == 1 and CM.COUNTS["captures"] == 0
    assert CM.cache_info()["nofuse"] == 1


def test_error_other_than_a_readback_raises(monkeypatch):
    f = _Fake(monkeypatch)

    def broken(fn):
        raise RuntimeError("seg_sum launch: CUDA error 1")
    monkeypatch.setattr(CM, "run_detecting_readbacks", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        CM.run_fused(f.chain, f.table)
    assert not CM.NOFUSE and CM.cache_info() == {
        "graphs": 0, "nofuse": 0, "pool_bytes": 0}
    # a capture that fails raises too, and marks nothing
    monkeypatch.setattr(CM, "run_detecting_readbacks",
                        lambda fn: ("first result", None))
    with pytest.raises(AssertionError, match="captured"):
        CM.run_fused(f.chain, f.table)
    assert len(f.captured) == 1 and not CM.NOFUSE
    assert CM.cache_info()["graphs"] == 0


def test_detector_names_a_sync_and_passes_other_warnings(monkeypatch):
    modes = []
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)

    def prototype_notice():
        # what torch says the first time the mode is set: not a sync
        warnings.warn("Synchronization debug mode is a prototype feature "
                      "and does not yet detect all synchronizing "
                      "operations")
        return 1
    with pytest.warns(UserWarning, match="prototype"):
        out, site = CM.run_detecting_readbacks(prototype_notice)
    assert out == 1 and site is None and modes == ["warn", 0]

    def synced():
        warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("called a synchronizing CUDA operation")
        return 2
    out, site = CM.run_detecting_readbacks(synced)
    assert out == 2 and site is not None and "test_torch_compiled" in site


def test_launch_counts_and_records_carry_to_replays():
    """The counters and input records that a capture takes back (it runs
    no kernel), in the wrappers' own names; a replay adds to none of
    them, so what it launched is read from a trace of the card
    (`test_graph_counts_its_launches` in `tests/test_torch_cuda.py`)."""
    from polaroid_tpu_torch.ops import cuda_kernels, cuda_partition
    names = {(m, a) for m, a in CM._COUNTERS}
    assert ("cuda_kernels", "LAUNCHES") in names
    assert ("cuda_partition", "LAUNCHES") in names
    for m, a in CM._COUNTERS:
        assert isinstance(getattr(CM._module(m), a), int)
    for m, a in CM._RECORDS:
        assert hasattr(CM._module(m), a)
    assert cuda_kernels.RECORD is None and cuda_partition.RECORD is None
    assert "launches" not in CM._Graph.__slots__


def test_another_threads_sync_is_not_the_chains(monkeypatch):
    """torch's sync debug mode and the warning hook are the process's: a
    sync in another thread while a chain is first seen is not the
    chain's, which is still captured, and that thread's own warnings go
    on to the hook that was in place."""
    import threading
    f = _Fake(monkeypatch)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    shown = []
    monkeypatch.setattr(warnings, "showwarning",
                        lambda message, *a, **k: shown.append(str(message)))

    def node(n, t):
        def other():
            warnings.warn("count_rows called a synchronizing CUDA "
                          "operation")
            warnings.warn("the other thread's own warning")
        th = threading.Thread(target=other)
        th.start()
        th.join()
        f.applied.append(n.kind)
        return t
    monkeypatch.setattr(CM, "_apply_node", node)
    captured = []
    monkeypatch.setattr(CM, "_capture", lambda entry, nodes, *a:
                        captured.append(nodes))
    CM.run_fused(f.chain, f.table)
    assert captured == [f.chain] and not CM.NOFUSE
    assert CM.COUNTS["nofuse"] == 0 and CM.cache_info()["graphs"] == 1
    assert shown == ["the other thread's own warning"] * len(f.chain)
    # a sync of the detecting thread's own still marks the chain
    out, site = CM.run_detecting_readbacks(lambda: warnings.warn(
        "int() called a synchronizing CUDA operation"))
    assert site is not None and "test_torch_compiled" in site


def test_graph_metadata_holds_no_live_row_tensor():
    """Cached stats name the live rows they were taken over; where that
    is the caller's mask (or device row count), the graph's metadata
    drops it, so a cached graph keeps no frame alive. A host row count
    stays, and the caller's column keeps its stats."""
    _, tdf, _ = _frames(seed=17)
    t = tdf._table
    mask = t.row_mask() & (t.cols["volume"].data > 100)
    m = t.with_valid(mask, None)
    m.cols["symbol"].stats = {"min": 0, "max": 47, "over": mask}
    m.cols["volume"].stats = {"min": 0, "max": 5007, "over": N}
    _, _, in_meta = CM._graph_input(m)
    kept = dict(CM._strip_live(in_meta)[0])
    assert kept["symbol"][2] == {"min": 0, "max": 47}
    assert kept["volume"][2] == {"min": 0, "max": 5007, "over": N}
    assert m.cols["symbol"].stats["over"] is mask


@pytest.mark.parametrize("build", ["q1", "join", "sort_head"])
def test_profile_nodes_match_jax(build):
    rdf, tdf, _ = _frames(seed=13)

    def make(pl, df):
        lf = _queries(pl)["q1"](df.lazy())
        if build == "join":
            other = df.lazy().group_by("symbol").agg(
                pl.col("volume").max().alias("vmax"))
            lf = lf.join(other, on="symbol")
        elif build == "sort_head":
            lf = lf.sort("total").head(5)
        return lf
    _, rprof = make(ref, rdf).profile()
    out, tprof = make(pt, tdf).profile()
    assert tprof.get_column("node").to_list() == \
        rprof.get_column("node").to_list()
    assert all(ms >= 0 for ms in tprof.get_column("ms").to_list())
    assert out.height == make(pt, tdf).collect().height


def test_a_new_frame_on_a_freed_tables_id_gets_its_own_result():
    """The port keeps each optimized plan on its lazy frame, so a frame
    whose table takes a freed table's id gets its own data. (The JAX
    package's process-wide optimizer cache, keyed by that id, hands it
    the freed frame's result: `tests/test_torch_reference_caches.py`.)"""
    import gc
    from polaroid_tpu_torch.batch import Table

    def q(df):
        return df.lazy().filter(pt.col("v") > 0).select("k", "v") \
            .collect().to_dict()
    old = pt.DataFrame({"k": [1, 2, 3], "v": [1, 2, 3], "z": [0, 0, 0]},
                       device="cpu")
    proto = pt.DataFrame({"k": [7, 8, 9], "v": [4, 5, 6], "z": [1, 1, 1]},
                         device="cpu")._table
    assert q(old) == {"k": [1, 2, 3], "v": [1, 2, 3]}
    freed = id(old._table)
    del old
    gc.collect()
    keep = []
    for _ in range(200_000):
        t = Table(list(proto.names), dict(proto.cols), proto.capacity, 3,
                  device=proto.device)
        if id(t) == freed:
            break
        keep.append(t)
    new = pt.DataFrame._from_table(t)
    assert q(new) == {"k": [7, 8, 9], "v": [4, 5, 6]}
