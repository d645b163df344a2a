"""The top-level readers, scans and IO helpers (parity target:
`py-polars/src/polars/io/`, as the JAX package's `api/functions.py` and
`api/lazyframe.py` hold them). Each reader puts its frame on `device`
(default `Config.device`); a scan's rows go there when it runs. The
Parquet, CSV, IPC, NDJSON and Arrow paths need pyarrow, imported when
they run; Avro and JSON need none. The not-bundled stubs raise as the
JAX package's do."""

from __future__ import annotations

import builtins
from typing import Optional

from ..plan import logical as L


def _df(t):
    from .frame import DataFrame
    return DataFrame._from_table(t)


def _lazy(plan):
    from .lazyframe import LazyFrame
    return LazyFrame._from_plan(plan)


# --- Arrow and pandas --------------------------------------------------------

def from_arrow(data, device=None):
    """A pyarrow Table as a DataFrame."""
    from ..io.arrow_interop import table_from_arrow
    return _df(table_from_arrow(data, device=device))


def from_pandas(df, device=None):
    from .frame import DataFrame
    return DataFrame(df, device=device)


def from_dataframe(df, *, allow_copy: bool = True, device=None):
    """The dataframe-interchange protocol, through pyarrow."""
    import pyarrow.interchange as pai
    return from_arrow(pai.from_dataframe(df, allow_copy=allow_copy),
                      device=device)


# --- readers ---------------------------------------------------------------

def read_parquet(source, columns=None, n_rows=None, device=None, **kw):
    from ..io.parquet import read_parquet_table
    return _df(read_parquet_table(source, columns=columns, n_rows=n_rows,
                                  device=device))


def read_csv(source, device=None, **kw):
    from ..io.csv import read_csv_table
    return _df(read_csv_table(source, device=device, **kw))


def read_ipc(source, device=None, **kw):
    from ..io.ipc import read_ipc_table
    return _df(read_ipc_table(source, device=device, **kw))


def read_ipc_stream(source, device=None, **kw):
    """An Arrow IPC stream (not the file format)."""
    from ..io.ipc import read_ipc_stream_table
    return _df(read_ipc_stream_table(source, device=device))


def read_json(source, device=None, **kw):
    from ..io.json_io import read_json_table
    return _df(read_json_table(source, device=device))


def read_ndjson(source, device=None, **kw):
    from ..io.json_io import read_ndjson_table
    return _df(read_ndjson_table(source, device=device))


def read_avro(source, columns=None, n_rows=None, device=None):
    """An Avro object container file (the port's own codec, no
    pyarrow; `io/avro.py`)."""
    from ..io.avro import read_avro as _ra
    return _ra(source, columns=columns, n_rows=n_rows, device=device)


def read_ipc_schema(source) -> dict:
    from ..io.ipc import read_ipc_schema as _rs
    return _rs(source)


def read_parquet_schema(source) -> dict:
    import pyarrow.parquet as pq
    from ..io.arrow_interop import dtype_from_arrow
    sch = pq.read_schema(str(source))
    return {n: dtype_from_arrow(sch.field(n).type) for n in sch.names}


def read_parquet_metadata(source) -> dict:
    import pyarrow.parquet as pq
    md = pq.read_metadata(str(source))
    return {"num_rows": md.num_rows, "num_columns": md.num_columns,
            "num_row_groups": md.num_row_groups,
            "created_by": md.created_by,
            "format_version": md.format_version}


class BatchedCsvReader:
    """A CSV file read a few batches at a time (py-polars'
    `read_csv_batched`)."""

    def __init__(self, source, batch_size: int, device=None):
        import pyarrow.csv as pacsv
        opts = pacsv.ReadOptions(
            block_size=builtins.max(int(batch_size), 1) * 64)
        self._reader = pacsv.open_csv(str(source), read_options=opts)
        self._done = False
        self._device = device

    def next_batches(self, n: int):
        import pyarrow as pa
        if self._done:
            return None
        out = []
        for _ in range(n):
            try:
                b = self._reader.read_next_batch()
            except StopIteration:
                self._done = True
                break
            out.append(from_arrow(pa.Table.from_batches([b]),
                                  device=self._device))
        return out or None


def read_csv_batched(source, *, batch_size: int = 50_000, device=None,
                     **kw):
    return BatchedCsvReader(source, batch_size, device)


# --- scans -----------------------------------------------------------------

def scan_parquet(source, n_rows: Optional[int] = None, device=None,
                 **options):
    return _lazy(L.Scan("parquet", source, n_rows=n_rows, options=options,
                        device=device))


def scan_csv(source, has_header: bool = True, separator: str = ",",
             n_rows: Optional[int] = None, null_values=None, device=None,
             **options):
    opts = {"has_header": has_header, "separator": separator,
            "null_values": null_values, **options}
    return _lazy(L.Scan("csv", source, n_rows=n_rows, options=opts,
                        device=device))


def scan_ipc(source, n_rows: Optional[int] = None, device=None, **options):
    return _lazy(L.Scan("ipc", source, n_rows=n_rows, options=options,
                        device=device))


def scan_ndjson(source, n_rows: Optional[int] = None, device=None,
                **options):
    return _lazy(L.Scan("ndjson", source, n_rows=n_rows, options=options,
                        device=device))


def scan_pyarrow_dataset(ds, *, allow_pyarrow_filter: bool = True,
                         device=None):
    """A lazy frame over a pyarrow dataset, read through the dataset's
    own pushdown."""
    return from_arrow(ds.to_table(), device=device).lazy()


def _norm_schema(schema):
    from ..dtypes import DataType
    items = schema.items() if isinstance(schema, dict) else list(schema)
    return {nm: d() if isinstance(d, type) and issubclass(d, DataType)
            else d for nm, d in items}


def register_io_source(callable_, *, schema, device=None):
    """A custom source in the lazy engine: `callable_(with_columns,
    predicate, n_rows, batch_size)` yields DataFrames, run when the plan
    is collected."""
    from .frame import DataFrame
    declared = _norm_schema(schema)

    def run(_t):
        frames = list(callable_(None, None, None, None))
        if not frames:
            return DataFrame(schema=declared, device=device)._table
        out = frames[0]
        for f in frames[1:]:
            out = out.vstack(f)
        return out._table

    empty = L.DataFrameScan(DataFrame(schema=declared, device=device)._table)
    return _lazy(L.MapFunction(empty, run, schema_fn=lambda _s: dict(
        declared), label="io_source"))


def defer(function, *, schema, validate_schema: bool = True, device=None):
    """An eager function that makes a DataFrame, run when the plan is
    collected (py-polars' `pl.defer`)."""
    declared = _norm_schema(schema) if not callable(schema) else None

    def source(with_columns, predicate, n_rows, batch_size):
        df = function()
        if validate_schema:
            got = dict(df.schema)
            want = declared if declared is not None else \
                _norm_schema(schema())
            if list(got) != list(want) or builtins.any(
                    repr(got[k]) != repr(want[k]) for k in want):
                from ..errors import SchemaError
                raise SchemaError(
                    f"defer: schema mismatch (declared {want}, got {got})")
        yield df

    sch = declared if declared is not None else _norm_schema(schema())
    return register_io_source(source, schema=sch, device=device)


# --- not bundled -------------------------------------------------------------

def read_excel(source, **kw):
    raise ModuleNotFoundError(
        "read_excel requires fastexcel/openpyxl, which are not bundled")


def read_ods(source, **kw):
    raise ModuleNotFoundError(
        "read_ods requires an ods engine, which is not bundled")


def read_database(query, connection, **kw):
    raise ModuleNotFoundError(
        "read_database requires a database driver, which is not bundled")


def read_database_uri(query, uri, **kw):
    raise ModuleNotFoundError(
        "read_database_uri requires connectorx/adbc, which is not bundled")


def read_clipboard(**kw):
    raise OSError("no clipboard available in a headless environment")


def scan_iceberg(source, **kw):
    raise ModuleNotFoundError(
        "scan_iceberg requires pyiceberg, which is not bundled")


class Catalog:
    def __init__(self, *a, **kw):
        raise ModuleNotFoundError(
            "Catalog requires a Unity/REST catalog client, not bundled")


# --- options and partitioning -------------------------------------------------

class CompatLevel:
    @classmethod
    def newest(cls):
        return cls()

    @classmethod
    def oldest(cls):
        return cls()


class ScanCastOptions:
    """A scan's cast policy (taken; scans upcast by the supertype
    rules)."""

    def __init__(self, **kw) -> None:
        self.options = kw


class KeyedPartition:
    """One key=value pair of a partition (py-polars'
    `io/partition.py:26`)."""

    def __init__(self, name: str, str_value: str, raw_value) -> None:
        self.name = name
        self.str_value = str_value
        self.raw_value = raw_value

    def hive_name(self) -> str:
        return f"{self.name}={self.str_value}"


class BasePartitionContext:
    """The context of a partition file's creation (py-polars'
    `io/partition.py:103`)."""

    def __init__(self, file_idx: int, file_path, full_path) -> None:
        self.file_idx = file_idx
        self.file_path = file_path
        self.full_path = full_path


class KeyedPartitionContext(BasePartitionContext):
    """The context of a keyed partition's creation (py-polars'
    `io/partition.py:55`)."""

    def __init__(self, file_idx: int, part_idx: int, in_part_idx: int,
                 keys, file_path, full_path) -> None:
        super().__init__(file_idx, file_path, full_path)
        self.part_idx = part_idx
        self.in_part_idx = in_part_idx
        self.keys = keys

    def hive_dirs(self):
        from pathlib import Path
        p = Path(self.keys[0].hive_name())
        for key in self.keys[1:]:
            p = p / key.hive_name()
        return p


class PartitionByKey:
    """A partitioned sink: hive-style key directories
    (`write_parquet(partition_by=...)`)."""

    def __init__(self, base_path, *, by, include_key: bool = True,
                 **kw) -> None:
        self.base_path = str(base_path)
        self.by = [by] if isinstance(by, str) else [
            b if isinstance(b, str) else str(b) for b in by]
        self.include_key = include_key


class PartitionMaxSize:
    """A partitioned sink: files of at most `max_size` rows."""

    def __init__(self, base_path, *, max_size: int, **kw) -> None:
        self.base_path = str(base_path)
        self.max_size = int(max_size)


class PartitionParted(PartitionByKey):
    """PartitionByKey for data already sorted by the key."""


# --- credential providers (py-polars' names; the working providers are
# `io/credentials.py`'s, which the remote paths use) -----------------------

class CredentialProvider:
    pass


class CredentialProviderFunction(CredentialProvider):
    def __init__(self, function=None, **kw):
        self.function = function


CredentialProviderFunctionReturn = dict


class CredentialProviderAWS(CredentialProvider):
    def __init__(self, *a, **kw):
        raise ModuleNotFoundError("AWS credential chains require boto3, "
                                  "not bundled")


class CredentialProviderAzure(CredentialProvider):
    def __init__(self, *a, **kw):
        raise ModuleNotFoundError("Azure credential chains require "
                                  "azure-identity, not bundled")


class CredentialProviderGCP(CredentialProvider):
    def __init__(self, *a, **kw):
        raise ModuleNotFoundError("GCP credential chains require "
                                  "google-auth, not bundled")
