"""Fused chains: a chain of plan nodes captured once as a CUDA graph and
replayed.

The port of the JAX package's `exec/compiled.py`. There, a chain of
filter/select/with_columns nodes, optionally under a group_by or an
unsliced sort, traces into one jitted program over the table's flat
arrays. Here the same chain is captured into one `torch.cuda.CUDAGraph`
and replayed: the host issues one launch where it issued every op of
every node.

The cache key is the JAX package's: (the chain's fingerprint, the
input's schema with validity, dictionary versions, integer key stats,
capacity and live kind), plus the device and the shapes and strides of
the input's tensors. The host row count of a compact table is not in
the key: inside the graph it is a device scalar, so batches of one
capacity but different lengths share one graph.

On CUDA:
* first sight of a key: the chain runs eagerly, on the table as the
  graph will see it, under torch's sync debug mode. That run gives the
  result and warms the caching allocator. If it read a value back to
  the host (`.cpu()`, `int(tensor)`, `nonzero`, a pageable copy ...),
  the key is marked no-fuse with the op that read back, and the chain
  runs eagerly from then on. Otherwise the chain is captured over the
  input's own tensors, on a side stream, into a private memory pool;
  the host metadata of the output (dtypes, dictionaries, stats) is kept.
  The graph holds the caller's tensors only by weak references, so a
  cached graph never keeps a freed frame on the card.
* a hit: the new table's tensors are copied into the graph's inputs
  (skipped for a tensor that already is the captured one, as when the
  same frame is collected again; the first hit with other tensors, or
  after the captured ones were freed, captures again over buffers of
  the graph's own), the graph replays, and the outputs come back as
  clones, since the next replay writes over the graph's buffers.
Any other error, in the eager run, the capture or a replay, raises: a
chain never becomes eager for any reason but a detected readback.

On the CPU the nodes are applied in order (`apply_chain`).

The kernels count their launches in Python, where the wrapper launches
its kernel: a capture launches nothing (its counts are taken back) and a
replay launches its kernels from the graph, so neither counts. What a
replay ran on the card is read from a trace of it.
"""

from __future__ import annotations

import os
import threading
import warnings
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

from ..batch import Column, Table
from ..errors import ComputeError
from ..expr import meta
from ..plan import logical as L

_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
FUSABLE = ("filter", "select", "with_columns")
BREAKERS = ("group_by", "sort")
# the most graphs kept, and the most bytes their private pools and their
# own input buffers may hold together (the oldest go first)
MAX_ENTRIES = 512
BUDGET_BYTES = 8 << 30

# per process: graphs captured, replays, chains marked no-fuse, eager
# runs of no-fuse chains, bytes copied into graph inputs, bytes the
# cached graphs hold, graphs evicted
COUNTS: Dict[str, int] = {}
# chain fingerprint -> the op (file:line in the package) that read back
NOFUSE: Dict[str, str] = {}
_LOCK = threading.RLock()
# device index -> (capture stream, event of the last replay): replays of
# every graph on a device are ordered, so graphs may share the capture
# stream's kernel scratch
_STREAMS: Dict[int, torch.cuda.Stream] = {}
_LAST: Dict[int, torch.cuda.Event] = {}

# the kernel wrappers' launch counts and input records (module, name):
# a capture launches nothing, so what it counted and recorded is taken
# back
_COUNTERS = (("cuda_kernels", "LAUNCHES"),
             ("cuda_kernels", "MINMAX_LAUNCHES"),
             ("cuda_kernels", "GATHER_LAUNCHES"),
             ("cuda_partition", "LAUNCHES"),
             ("exchange", "EXCHANGE_LAUNCHES"), ("merge_sort", "LAUNCHES"),
             ("hgroup", "FALLBACKS"))
_RECORDS = (("cuda_kernels", "RECORD"), ("cuda_kernels", "MINMAX_RECORD"),
            ("cuda_partition", "RECORD"), ("exchange", "RECORD"),
            ("merge_sort", "RECORD"))
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reset_counts() -> None:
    for k in ("captures", "replays", "nofuse", "eager", "static_copy_bytes",
              "evictions"):
        COUNTS[k] = 0
    COUNTS["pool_bytes"] = sum(e.nbytes for e in _CACHE.values()
                               if isinstance(e, _Graph))


reset_counts()


def clear_cache(nofuse: bool = True) -> None:
    """Drop every cached graph and, with `nofuse`, every no-fuse mark."""
    with _LOCK:
        if torch.cuda.is_initialized() and any(
                isinstance(e, _Graph) for e in _CACHE.values()):
            # a pool goes back to the allocator: no replay may still run
            torch.cuda.synchronize()
        for k in [k for k, e in _CACHE.items()
                  if nofuse or isinstance(e, _Graph)]:
            del _CACHE[k]
        if nofuse:
            NOFUSE.clear()
        COUNTS["pool_bytes"] = 0


# the top node of a chain -> its fingerprint (a cached optimized plan
# hands the executor the same nodes on every collect)
_FINGERPRINTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _fingerprint(nodes: List[L.Plan]) -> str:
    ids = tuple(map(id, nodes))
    hit = _FINGERPRINTS.get(nodes[-1])
    if hit is None or hit[0] != ids:
        hit = _FINGERPRINTS[nodes[-1]] = (ids, plan_chain_fingerprint(nodes))
    return hit[1]


def plan_chain_fingerprint(nodes: List[L.Plan]) -> str:
    parts = []
    for n in nodes:
        if n.kind == "filter":
            parts.append(f"F({n.predicate.fingerprint()})")
        elif n.kind in ("select", "with_columns"):
            parts.append(f"{n.kind}({';'.join(e.fingerprint() for e in n.exprs)})")
        elif n.kind == "group_by":
            parts.append(
                f"G({';'.join(e.fingerprint() for e in n.keys)}|"
                f"{';'.join(e.fingerprint() for e in n.aggs)}|{n.maintain_order})")
        elif n.kind == "sort":
            parts.append(
                f"S({';'.join(e.fingerprint() for e in n.by)}|"
                f"{n.descending}|{n.nulls_last}|{n.maintain_order}|"
                f"{n.slice_})")
        else:
            raise ComputeError(f"unfusable node {n.kind}")
    return "→".join(parts)


def _table_key(t: Table) -> tuple:
    items = []
    for n in t.names:
        c = t.cols[n]
        st = None
        if c.stats is not None:
            st = (c.stats.get("min"), c.stats.get("max"))
        items.append((n, repr(c.dtype), c.validity is not None,
                      c.sdict.version if c.sdict is not None else 0, st))
    # live-state shape is part of the key: masked / compact / deferred
    # inputs flatten to different tensor sets, and the cached output
    # metadata must match the capture that produced it
    live_kind = ("masked" if t.valid is not None else
                 "deferred" if t._nrows is None and t.nrows_dev is not None
                 else "compact")
    return (tuple(items), t.capacity, live_kind)


def collect_fusable_chain(plan: L.Plan) -> Tuple[List[L.Plan], L.Plan]:
    """Walk down from `plan` gathering a fusable suffix ending at the
    chain's input. Returns (nodes bottom-up order, input plan)."""
    chain: List[L.Plan] = []
    cur = plan
    if cur.kind == "group_by" or (
            cur.kind == "sort" and cur.slice_ is None):
        # sort with a fused top-k slice needs the host-synced compact path
        chain.append(cur)
        cur = cur.input
    while cur.kind in FUSABLE:
        chain.append(cur)
        cur = cur.input
    chain.reverse()
    return chain, cur


# --- eager application ------------------------------------------------------

def _ensure_groupby_stats(nodes: List[L.Plan], table: Table) -> None:
    """Host pre-pass: cache bucketed min/max on integer key columns so the
    group-by can take the dense O(n) path. One device sync per column,
    amortized across calls (stats live on the Column object).

    Tables that share a Column may have different live rows (a filter or
    head() keeps the Column objects), so the stats remember the live rows
    they were taken over and are taken again for others. The JAX package
    reuses them for any table, and then groups keys outside the cached
    range into the edge slot (ROADMAP Queue 3)."""
    from ..ops.join import minmax_masked
    live = table.live_key()
    redefined = set()
    for node in nodes:
        if node.kind in ("select", "with_columns"):
            for e in node.exprs:
                # a bare col passes through unchanged — stats stay valid
                if e.kind != "col":
                    redefined.add(meta.output_name(e))
        if node.kind != "group_by":
            continue
        for ke in node.keys:
            e = ke
            while e.kind == "alias":
                e = e.children[0]
            if e.kind != "col":
                continue
            name = e.attrs["name"]
            if name in redefined or name not in table.cols:
                continue
            c = table.cols[name]
            if not c.dtype.is_integer:
                continue
            over = c.stats["over"] if c.stats is not None else None
            if over is live or (type(over) is int and type(live) is int
                                 and over == live):
                continue
            mask = table.row_mask()
            if c.validity is not None:
                mask = mask & c.validity
            mn, mx = minmax_masked(c.data, mask)
            # bucket bounds so stats stay stable across similar batches
            B = 16
            c.stats = {"min": (mn // B) * B, "max": ((mx // B) + 1) * B - 1,
                       "over": live}


def _apply_node(node: L.Plan, table: Table) -> Table:
    from ..api.frame import DataFrame
    k = node.kind
    if k == "filter":
        return DataFrame._from_table(table).filter(node.predicate)._table
    if k == "select":
        return DataFrame._from_table(table).select(node.exprs)._table
    if k == "with_columns":
        return DataFrame._from_table(table).with_columns(node.exprs)._table
    if k == "group_by":
        from ..ops.groupby import group_by_agg
        ins = dict(table.schema)
        return group_by_agg(table, meta.expand_exprs(node.keys, ins),
                            meta.expand_exprs(node.aggs, ins),
                            node.maintain_order)
    if k == "sort":
        from ..expr.eval import eval_expr
        from ..ops.sort import sort_table
        vals = [eval_expr(b, table, "select") for b in node.by]
        return sort_table(table, vals, node.descending, node.nulls_last,
                          node.maintain_order)
    raise ComputeError(k)


def apply_chain(nodes: List[L.Plan], table: Table) -> Table:
    """The chain applied node by node, eagerly, after the stats pre-pass
    has seen its input."""
    _ensure_groupby_stats(nodes, table)
    for node in nodes:
        table = _apply_node(node, table)
    return table


# --- flat tensors ------------------------------------------------------------

_SEP = "\x00"


def _flatten_column(path: str, c: Column, flat: Dict[str, torch.Tensor]):
    has = []
    for tag, x in (("d", c.data), ("v", c.validity), ("l", c.lengths),
                   ("e", c.elem_valid)):
        if x is not None:
            flat[f"{tag}:{path}"] = x
            has.append(tag)
    fields = None if c.fields is None else tuple(
        (fn, _flatten_column(f"{path}{_SEP}{fn}", f, flat))
        for fn, f in c.fields.items())
    return (c.dtype, c.sdict, c.stats, tuple(has), fields)


def _unflatten_column(path: str, m, flat: Dict[str, torch.Tensor]) -> Column:
    dtype, sdict, stats, has, fields = m

    def get(tag):
        return flat[f"{tag}:{path}"] if tag in has else None
    return Column(dtype, get("d"), get("v"), sdict, stats, get("l"),
                  get("e"), None if fields is None else {
                      fn: _unflatten_column(f"{path}{_SEP}{fn}", fm, flat)
                      for fn, fm in fields})


def _flatten_table(t: Table):
    """(flat tensors, metadata): the metadata carries everything that is
    not a device tensor."""
    flat: Dict[str, torch.Tensor] = {}
    colmeta = tuple((n, _flatten_column(n, t.cols[n], flat))
                    for n in t.names)
    if t.valid is not None:
        flat["__valid"] = t.valid
    elif t._nrows is None and t.nrows_dev is not None:
        flat["__nrows_dev"] = t.nrows_dev
    return flat, (colmeta, t.capacity, t._nrows, t.valid is not None,
                  t.device)


def _unflatten_table(flat: Dict[str, torch.Tensor], metadata) -> Table:
    colmeta, capacity, nrows, has_valid, device = metadata
    cols = {n: _unflatten_column(n, m, flat) for n, m in colmeta}
    return Table([n for n, _ in colmeta], cols, capacity, nrows,
                 flat.get("__valid") if has_valid else None,
                 nrows_dev=flat.get("__nrows_dev"), device=device)


def _graph_input(table: Table):
    """(flat tensors, host row count or None, metadata) of the table as a
    graph sees it: a masked table without its host count, a compact one
    with its count as the device scalar "__nrows_dev" (which the graph
    owns), a deferred one as it is."""
    flat, (colmeta, cap, nrows, has_valid, device) = _flatten_table(table)
    host_n = None
    if not has_valid and nrows is not None:
        host_n = nrows
    return flat, host_n, (colmeta, cap, None, has_valid, device)


def _layout_key(flat: Dict[str, torch.Tensor], host_n, device) -> tuple:
    return (str(device), host_n is not None, tuple(
        (k, x.dtype, tuple(x.shape), x.stride()) for k, x in flat.items()))


# --- readback detection ------------------------------------------------------

def _site(filename: str, lineno: int) -> str:
    try:
        rel = os.path.relpath(filename, os.path.dirname(_PKG))
    except ValueError:
        rel = filename
    return f"{rel}:{lineno}"


def run_detecting_readbacks(fn):
    """(fn(), the first op that synchronized with the host, as file:line
    of the innermost frame in the package, or None), from torch's sync
    debug mode: it flags `.item()`, `.cpu()` and `int(tensor)`,
    `nonzero` and what calls it, and copies between the host's pageable
    memory and the card.

    The mode and the warning hook are the process's: only this thread's
    syncs are fn's. Another thread's warnings go on to the hook that was
    in place, its syncs too where the mode was already on (they were
    raised only because this call turned it on, else)."""
    import traceback
    sites: List[str] = []
    other = []
    me = threading.get_ident()
    prev = torch.cuda.get_sync_debug_mode()
    shown = warnings.showwarning

    def hook(message, category, filename, lineno, file=None, line=None):
        # torch's text for a flagged op (the mode's own first-use notice
        # says "synchronizing operations" and is not one)
        sync = "called a synchronizing CUDA operation" in str(message)
        if threading.get_ident() != me:
            if not sync or prev:
                shown(message, category, filename, lineno, file, line)
            return
        if not sync:
            other.append((message, category, filename, lineno))
            return
        if sites:
            return
        # the innermost frames in the package, up to the chain's own
        # application (`_apply_node`)
        frames = []
        for fr in reversed(traceback.extract_stack()[:-1]):
            path = os.path.abspath(fr.filename)
            if fr.name in ("hook", "run_detecting_readbacks"):
                continue
            if path.startswith(_PKG + os.sep):
                frames.append(_site(path, fr.lineno))
                if fr.name == "_apply_node" or len(frames) == 4:
                    break
        sites.append(" < ".join(frames) or _site(filename, lineno))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    for message, category, filename, lineno in other:
        warnings.warn_explicit(message, category, filename, lineno)
    return out, (sites[0] if sites else None)


# --- the graphs --------------------------------------------------------------

def _module(name: str):
    import importlib
    pkg = __package__.rsplit(".", 1)[0]
    return importlib.import_module(f"{pkg}.ops.{name}")


def _counter_values() -> List[int]:
    return [getattr(_module(m), a) for m, a in _COUNTERS]


def _record_lists() -> List[Optional[list]]:
    return [getattr(_module(m), a) for m, a in _RECORDS]


class _NoFuse:
    __slots__ = ("site",)

    def __init__(self, site: str):
        self.site = site


def _strip_column(m):
    dtype, sdict, stats, has, fields = m
    if stats is not None and isinstance(stats.get("over"), torch.Tensor):
        stats = {k: v for k, v in stats.items() if k != "over"}
    return (dtype, sdict, stats, has, None if fields is None else
            tuple((fn, _strip_column(f)) for fn, f in fields))


def _strip_live(metadata):
    """The metadata without the live-row tensors that cached stats name
    (`Table.live_key`): a graph must not keep the caller's mask alive.
    Only a join reads them, and no chain holds one."""
    colmeta, *rest = metadata
    return (tuple((n, _strip_column(m)) for n, m in colmeta), *rest)


class _Graph:
    """One captured chain: the graph; its inputs, as weak references to
    the caller's tensors with their addresses, or as buffers of its own
    once other tensors came; its output tensors and metadata, and how to
    rebuild an output that is a caller's tensor passed through."""

    __slots__ = ("graph", "static", "refs", "nrows", "host_n", "out_flat",
                 "out_alias", "out_meta", "nbytes", "in_meta")

    def __init__(self, in_meta):
        self.in_meta = _strip_live(in_meta)
        self.graph = None
        self.static = None
        self.refs = None
        self.nbytes = 0


def _stream_of(device: torch.device) -> torch.cuda.Stream:
    s = _STREAMS.get(device.index)
    if s is None:
        s = _STREAMS[device.index] = torch.cuda.Stream(device)
    return s


def _capture(entry: _Graph, nodes: List[L.Plan],
             flat: Dict[str, torch.Tensor], owned: bool,
             host_n: Optional[int], device: torch.device) -> None:
    """Capture `nodes` over `flat`: the caller's tensors, or (`owned`)
    buffers that the graph keeps."""
    from ..ops.cuda_build import prepare_scratch
    stream = _stream_of(device)
    prepare_scratch(device, stream.cuda_stream)
    static = dict(flat)
    nrows = None
    if host_n is not None:
        nrows = torch.full((), host_n, dtype=torch.int64, device=device)
        static["__nrows_dev"] = nrows
    counts0 = _counter_values()
    lists = _record_lists()
    lens0 = [None if r is None else len(r) for r in lists]
    graph = torch.cuda.CUDAGraph()
    reserved0 = torch.cuda.memory_reserved(device)
    cur = torch.cuda.current_stream(device)
    stream.wait_stream(cur)
    try:
        with torch.cuda.device(device), torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                t = _unflatten_table(static, entry.in_meta)
                for node in nodes:
                    t = _apply_node(node, t)
                out_flat, out_meta = _flatten_table(t)
            except BaseException:
                try:
                    graph.capture_end()
                except BaseException:
                    pass
                raise
            with warnings.catch_warnings():
                # a chain that only renames or passes columns through
                # launches nothing: its graph is empty, and replays as such
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                graph.capture_end()
    finally:
        # a capture runs no kernel: what the wrappers counted and
        # recorded while it was made is taken back
        for (m, a), c0 in zip(_COUNTERS, counts0):
            setattr(_module(m), a, c0)
        for r, n0 in zip(lists, lens0):
            if r is not None:
                del r[n0:]
    cur.wait_stream(stream)
    storages = {x.untyped_storage().data_ptr(): k for k, x in flat.items()}
    entry.out_flat, entry.out_alias = {}, {}
    for k, x in out_flat.items():
        src = storages.get(x.untyped_storage().data_ptr())
        if src is not None and not owned:
            # a caller's tensor passed through: rebuilt from the caller's
            # tensor on each replay, never held
            entry.out_alias[k] = (src, tuple(x.shape), x.stride(),
                                  x.storage_offset())
        else:
            entry.out_flat[k] = x
    entry.graph = graph
    entry.static = static if owned else None
    entry.refs = None if owned else {
        k: (weakref.ref(x), x.data_ptr()) for k, x in flat.items()}
    entry.nrows = nrows
    entry.host_n = host_n
    entry.out_meta = _strip_live(out_meta)
    pool = max(torch.cuda.memory_reserved(device) - reserved0, 0)
    own = sum(x.untyped_storage().nbytes() for x in static.values()) \
        if owned else 0
    entry.nbytes = pool + own
    COUNTS["captures"] += 1


def _captured_inputs(entry: _Graph, flat: Dict[str, torch.Tensor]) -> bool:
    """Whether `flat` holds the very tensors the graph was captured over,
    all still alive."""
    for k, x in flat.items():
        ref, ptr = entry.refs[k]
        if ref() is None or x.data_ptr() != ptr:
            return False
    return True


def _replay(entry: _Graph, nodes: List[L.Plan],
            flat: Dict[str, torch.Tensor], host_n: Optional[int],
            device: torch.device) -> Table:
    cur = torch.cuda.current_stream(device)
    last = _LAST.get(device.index)
    if last is not None:
        cur.wait_event(last)
    if entry.refs is not None and not _captured_inputs(entry, flat):
        # other tensors than the captured ones, or those were freed:
        # capture again over buffers of the graph's own, which later
        # hits copy into
        static = {k: x.clone() for k, x in flat.items()}
        COUNTS["static_copy_bytes"] += sum(x.nbytes for x in static.values())
        COUNTS["pool_bytes"] -= entry.nbytes
        _capture(entry, nodes, static, True, host_n, device)
        COUNTS["pool_bytes"] += entry.nbytes
    else:
        if entry.static is not None:
            for k, x in flat.items():
                dst = entry.static[k]
                if x.data_ptr() != dst.data_ptr():
                    dst.copy_(x)
                    COUNTS["static_copy_bytes"] += x.nbytes
        if host_n is not None and host_n != entry.host_n:
            entry.nrows.fill_(host_n)
            entry.host_n = host_n
    entry.graph.replay()
    COUNTS["replays"] += 1
    # the graph's own buffers are written again by the next replay (or
    # the next hit's copy), so they come back as clones
    out = {k: x.clone() for k, x in entry.out_flat.items()}
    for k, (src, shape, stride, offset) in entry.out_alias.items():
        x = flat[src]
        out[k] = x if (tuple(x.shape), x.stride(), x.storage_offset()) == \
            (shape, stride, offset) else x.as_strided(shape, stride, offset)
    done = torch.cuda.Event()
    done.record(cur)
    _LAST[device.index] = done
    return _unflatten_table(out, entry.out_meta)


def _evict() -> None:
    total = COUNTS["pool_bytes"]
    if len(_CACHE) <= MAX_ENTRIES and total <= BUDGET_BYTES:
        return
    torch.cuda.synchronize()
    while _CACHE and (len(_CACHE) > MAX_ENTRIES or total > BUDGET_BYTES):
        _, e = _CACHE.popitem(last=False)
        if isinstance(e, _Graph):
            total -= e.nbytes
            COUNTS["evictions"] += 1
    COUNTS["pool_bytes"] = total


def cache_info() -> Dict[str, object]:
    """The cache's graphs, no-fuse marks and the bytes the graphs hold."""
    graphs = [e for e in _CACHE.values() if isinstance(e, _Graph)]
    return {"graphs": len(graphs),
            "nofuse": sum(isinstance(e, _NoFuse) for e in _CACHE.values()),
            "pool_bytes": sum(e.nbytes for e in graphs)}


def run_fused(nodes: List[L.Plan], table: Table) -> Table:
    """Execute a fusable chain: on CUDA through its captured graph (module
    docstring), on the CPU node by node."""
    if table.device.type != "cuda":
        return apply_chain(nodes, table)
    _ensure_groupby_stats(nodes, table)
    device = table.device
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    fp = _fingerprint(nodes)
    flat, host_n, in_meta = _graph_input(table)
    key = (fp, _table_key(table), _layout_key(flat, host_n, device))
    with _LOCK:
        hit = _CACHE.get(key)
        if hit is not None:
            _CACHE.move_to_end(key)
        if isinstance(hit, _NoFuse):
            COUNTS["eager"] += 1
            t = table
            for node in nodes:
                t = _apply_node(node, t)
            return t
        if hit is not None:
            return _replay(hit, nodes, flat, host_n, device)
        # first sight: the eager run on the table as the graph sees it
        seen = dict(flat)
        if host_n is not None:
            seen["__nrows_dev"] = torch.full((), host_n, dtype=torch.int64,
                                             device=device)
        twin = _unflatten_table(seen, in_meta)

        def eager():
            t = twin
            for node in nodes:
                t = _apply_node(node, t)
            return t
        out, site = run_detecting_readbacks(eager)
        if site is not None:
            _CACHE[key] = _NoFuse(site)
            NOFUSE[fp] = site
            COUNTS["nofuse"] += 1
            _evict()
            return out
        entry = _Graph(in_meta)
        _capture(entry, nodes, flat, False, host_n, device)
        _CACHE[key] = entry
        COUNTS["pool_bytes"] += entry.nbytes
        _evict()
        return out
