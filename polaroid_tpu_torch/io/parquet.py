"""Parquet IO (host side, on pyarrow).

The port of the JAX package's `io/parquet.py`: projection and predicate
pushdown into the decoder, row-group streaming for scans larger than
memory, multi-file (glob, hive directory) scans read concurrently, and
statistics-based row-group skipping. pyarrow's C++ decodes; this module
does the pushdown plumbing and the host -> device copies of each column
(`io/arrow_interop.py`). pyarrow is imported inside each function, so
without it a call raises `ModuleNotFoundError` naming pyarrow.
"""

from __future__ import annotations

import concurrent.futures as _fut
import glob as _glob
import os as _os
import queue as _queue
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Sequence

from ..batch import Table, resolve_device
from ..config import capacity_for
from ..errors import NoDataError
from .arrow_interop import column_from_arrow, table_from_arrow, \
    table_to_arrow

# a single-file read of at least this many cells (rows x columns) reads,
# converts and copies its columns on a thread pool
OVERLAP_CELLS = 1 << 22


def _expand_paths(source) -> List[str]:
    if isinstance(source, (list, tuple)):
        out = []
        for s in source:
            out.extend(_expand_paths(s))
        return out
    s = str(source)
    if "://" in s:
        from .remote import remote_glob
        return remote_glob(s) if any(ch in s for ch in "*?[") else [s]
    if any(ch in s for ch in "*?["):
        paths = sorted(_glob.glob(s))
        if not paths:
            raise NoDataError(f"no files match {s!r}")
        return paths
    return [s]


def _is_local_dir(source) -> bool:
    return isinstance(source, (str, Path)) and "://" not in str(source) \
        and _os.path.isdir(str(source))


def _dict_read_cols(schema, cols) -> List[str]:
    """String and binary columns to read as DictionaryArrays: Parquet
    pages are dictionary-encoded by default, so the encoded form skips
    hashing every row again (`StringDict.encode_dictionary`)."""
    import pyarrow as pa
    out = []
    for nm in (cols if cols else schema.names):
        idx = schema.get_field_index(nm)
        if idx < 0:
            continue
        t = schema.field(idx).type
        if pa.types.is_string(t) or pa.types.is_large_string(t) or \
                pa.types.is_binary(t) or pa.types.is_large_binary(t):
            out.append(nm)
    return out


def _read_one(p: str, columns, filters, forced_out=None):
    import pyarrow as pa
    import pyarrow.parquet as pq
    cols = list(columns) if columns else None

    def rd(src, **kw):
        try:
            sch = pq.read_schema(src, **kw)
            dict_cols = _dict_read_cols(sch, cols)
        except (pa.ArrowException, OSError):
            dict_cols = None
        try:
            t = pq.read_table(src, columns=cols, filters=filters,
                              read_dictionary=dict_cols or None, **kw)
            if dict_cols and forced_out is not None:
                forced_out.extend(dict_cols)
            return t
        except (pa.ArrowException, OSError):
            if not dict_cols:
                raise
            return pq.read_table(src, columns=cols, filters=filters, **kw)

    if "://" in p:
        from .remote import localize, resolve_filesystem
        local = localize(p)  # the remote-file cache when PT_FILE_CACHE=1
        if "://" not in local:
            return rd(local)
        fs, inner = resolve_filesystem(p)
        return rd(inner, filesystem=fs)
    return rd(p)


def read_parquet_arrow(source, columns: Optional[Sequence[str]] = None,
                       filters=None, n_rows: Optional[int] = None,
                       forced_out=None):
    import pyarrow as pa
    import pyarrow.dataset as pads
    import pyarrow.parquet as pq
    if hasattr(source, "read") or isinstance(source, (bytes, bytearray)):
        if isinstance(source, (bytes, bytearray)):
            import io as _io
            source = _io.BytesIO(source)
        t = pq.read_table(source, columns=list(columns) if columns else None,
                          filters=filters)
    elif _is_local_dir(source):
        # a hive-partitioned directory: the partition keys become columns
        ds = pads.dataset(str(source), format="parquet", partitioning="hive")
        t = ds.to_table(columns=list(columns) if columns else None,
                        filter=filters if not isinstance(filters, list)
                        else None)
    else:
        paths = _expand_paths(source)
        if len(paths) == 1:
            t = _read_one(paths[0], columns, filters, forced_out)
        else:
            # files read concurrently on pyarrow's C++ (GIL released)
            with _fut.ThreadPoolExecutor(max_workers=min(len(paths), 16)) \
                    as ex:
                parts = list(ex.map(lambda p: _read_one(
                    p, columns, filters, forced_out), paths))
            t = pa.concat_tables(parts, promote_options="permissive")
    if n_rows is not None:
        t = t.slice(0, n_rows)
    return t


def read_parquet_table(source, columns=None, filters=None, n_rows=None,
                       device=None) -> Table:
    device = resolve_device(device)
    t = _read_parquet_table_overlapped(source, columns, filters, n_rows,
                                       device)
    if t is not None:
        return t
    forced: list = []
    at = read_parquet_arrow(source, columns, filters, n_rows, forced)
    return table_from_arrow(at, string_cols=frozenset(forced), device=device)


def _read_parquet_table_overlapped(source, columns, filters, n_rows,
                                   device) -> Optional[Table]:
    """A single local file read column by column on a thread pool, so
    that pyarrow's decompression (GIL released) overlaps the device
    copies of columns already done. None for multi-file, remote,
    filtered, directory and small reads (under OVERLAP_CELLS cells)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    if filters is not None or hasattr(source, "read") or \
            isinstance(source, (bytes, bytearray)):
        return None
    s = str(source)
    if "://" in s or any(ch in s for ch in "*?[") or _os.path.isdir(s):
        return None
    try:
        md = pq.read_metadata(s)
    except (pa.ArrowException, OSError):
        return None
    total = md.num_rows
    schema = md.schema.to_arrow_schema()
    names = list(columns) if columns else list(schema.names)
    if len(names) < 2 or total * len(names) < OVERLAP_CELLS:
        return None
    n = total if n_rows is None else min(n_rows, total)
    cap = capacity_for(n)

    def one(nm: str):
        dict_cols = _dict_read_cols(schema, [nm])
        forced = bool(dict_cols)
        try:
            col = pq.read_table(s, columns=[nm],
                                read_dictionary=dict_cols or None).column(0)
        except (pa.ArrowException, OSError):
            forced = False
            col = pq.read_table(s, columns=[nm]).column(0)
        if n != total:
            col = col.slice(0, n)
        return column_from_arrow(col, cap, as_string=forced, device=device)

    with _fut.ThreadPoolExecutor(max_workers=min(len(names), 8)) as ex:
        conv = list(ex.map(one, names))
    return Table(names, dict(zip(names, conv)), cap, n, None, device=device)


def scan_row_groups(source, columns: Optional[Sequence[str]] = None,
                    filters=None, batch_rows: int = 1 << 21,
                    prefetch: int = 2) -> Iterator:
    """A (multi-)file scan as Arrow tables of about `batch_rows` rows,
    decoded on a worker thread `prefetch` tables ahead of the consumer;
    the worker's error re-raises in the consumer."""
    import pyarrow as pa
    import pyarrow.dataset as pads
    import pyarrow.parquet as pq
    paths = _expand_paths(source) if not _is_local_dir(source) \
        else [str(source)]
    local_simple = (filters is None and len(paths) == 1
                    and "://" not in str(paths[0])
                    and not _os.path.isdir(str(paths[0])))
    if local_simple:
        # one local file: its row groups through pyarrow's column-parallel
        # reader, with dictionary-coded string columns
        pf = pq.ParquetFile(paths[0])
        dict_cols = _dict_read_cols(pf.schema_arrow, columns)
        if dict_cols:
            pf = pq.ParquetFile(paths[0], read_dictionary=dict_cols)

        def gen():
            buf, rows = [], 0
            for i in range(pf.metadata.num_row_groups):
                t = pf.read_row_group(
                    i, columns=list(columns) if columns else None,
                    use_threads=True)
                # whole row groups up to twice the target; beyond that,
                # slices of the target, so memory stays bounded
                pieces = [t] if t.num_rows <= 2 * batch_rows else \
                    [t.slice(o, batch_rows)
                     for o in range(0, t.num_rows, batch_rows)]
                for piece in pieces:
                    if piece.num_rows == 0:
                        continue
                    buf.append(piece)
                    rows += piece.num_rows
                    if rows >= batch_rows:
                        yield pa.concat_tables(buf) if len(buf) > 1 \
                            else buf[0]
                        buf, rows = [], 0
            if buf:
                yield pa.concat_tables(buf) if len(buf) > 1 else buf[0]
    else:
        if paths and "://" in str(paths[0]):
            from .remote import resolve_filesystem
            fs, _ = resolve_filesystem(paths[0])
            ds = pads.dataset([str(p).split("://", 1)[1] for p in paths],
                              format="parquet", filesystem=fs)
        elif _is_local_dir(source):
            ds = pads.dataset(str(source), format="parquet",
                              partitioning="hive")
        else:
            ds = pads.dataset(paths, format="parquet")
        batches = ds.scanner(columns=list(columns) if columns else None,
                             filter=filters,
                             batch_size=batch_rows).to_batches()

        def gen():
            buf, rows = [], 0
            for b in batches:
                if b.num_rows == 0:
                    continue
                buf.append(b)
                rows += b.num_rows
                if rows >= batch_rows:
                    yield pa.Table.from_batches(buf)
                    buf, rows = [], 0
            if buf:
                yield pa.Table.from_batches(buf)

    yield from prefetched(gen(), prefetch)


def prefetched(it: Iterator, depth: int = 2) -> Iterator:
    """`it` run on a worker thread through a queue of `depth` items: the
    host decodes item k+1 while the consumer works on item k. An error
    in the worker re-raises in the consumer."""
    q: "_queue.Queue" = _queue.Queue(maxsize=max(1, depth))
    done = object()
    stop = threading.Event()

    def worker():
        try:
            for x in it:
                if stop.is_set():
                    return
                q.put((None, x))
            q.put((None, done))
        except BaseException as e:  # handed to the consumer
            q.put((e, None))

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    try:
        while True:
            err, item = q.get()
            if err is not None:
                raise err
            if item is done:
                return
            yield item
    finally:
        # a consumer that stops early (head) lets the worker end
        stop.set()
        while th.is_alive():
            try:
                q.get_nowait()
            except _queue.Empty:
                th.join(0.01)


def parquet_schema(source):
    import pyarrow.dataset as pads
    import pyarrow.parquet as pq
    if _is_local_dir(source):
        return pads.dataset(str(source), format="parquet",
                            partitioning="hive").schema
    p = _expand_paths(source)[0]
    if "://" in str(p):
        from .remote import resolve_filesystem
        fs, inner = resolve_filesystem(p)
        return pq.read_schema(inner, filesystem=fs)
    return pq.read_schema(p)


def _parquet_file(p: str):
    import pyarrow.parquet as pq
    if "://" in str(p):
        from .remote import resolve_filesystem
        fs, inner = resolve_filesystem(p)
        opener = getattr(fs, "open_input_file", None)
        return pq.ParquetFile(opener(inner) if opener is not None
                              else fs.open(inner, "rb"))
    return pq.ParquetFile(p)


def parquet_num_rows(source) -> int:
    if _is_local_dir(source):
        import pyarrow.dataset as pads
        return pads.dataset(str(source), format="parquet",
                            partitioning="hive").count_rows()
    return sum(_parquet_file(p).metadata.num_rows
               for p in _expand_paths(source))


def write_parquet(df, file, compression: str = "zstd",
                  compression_level: Optional[int] = None,
                  statistics: bool = True, row_group_size=None,
                  partition_by=None, **kw) -> None:
    import pyarrow.dataset as pads
    import pyarrow.parquet as pq
    at = table_to_arrow(df._table)
    if partition_by:
        # a hive-partitioned dataset, one directory per key
        cols = [partition_by] if isinstance(partition_by, str) \
            else list(partition_by)
        pads.write_dataset(
            at, str(file), format="parquet",
            partitioning=pads.partitioning(at.select(cols).schema,
                                           flavor="hive"),
            existing_data_behavior="overwrite_or_ignore",
            file_options=pads.ParquetFileFormat().make_write_options(
                compression=compression))
        return
    # 4M-row groups: pyarrow's default 128k-row groups give each group its
    # own dictionary page, which a read must unify again
    kwargs = dict(compression=compression,
                  compression_level=compression_level,
                  write_statistics=statistics,
                  row_group_size=row_group_size or (1 << 22),
                  # large dictionaries stay dictionary-encoded
                  dictionary_pagesize_limit=kw.pop(
                      "dictionary_pagesize_limit", 1 << 26),
                  data_page_size=kw.pop("data_page_size", 1 << 21))
    if hasattr(file, "write"):
        pq.write_table(at, file, **kwargs)
        return
    s = str(file)
    if "://" in s:
        from .remote import resolve_filesystem
        fs, inner = resolve_filesystem(s)
        pq.write_table(at, inner, filesystem=fs, **kwargs)
    else:
        pq.write_table(at, s, **kwargs)
