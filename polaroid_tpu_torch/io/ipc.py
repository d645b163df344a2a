"""Arrow IPC (Feather V2) IO: the port of the JAX package's `io/ipc.py`
(the reference's `polars-io/src/ipc/`), with the IPC stream format
beside the file format. pyarrow is imported inside the functions."""

from __future__ import annotations

import io as _io

from ..batch import Table
from .arrow_interop import table_from_arrow, table_to_arrow


def read_ipc_table(source, columns=None, n_rows=None, device=None) -> Table:
    import pyarrow as pa
    import pyarrow.ipc as paipc
    if hasattr(source, "read") or isinstance(source, (bytes, bytearray)):
        if isinstance(source, (bytes, bytearray)):
            source = _io.BytesIO(source)
        t = paipc.open_file(source).read_all()
    else:
        with pa.memory_map(str(source), "r") as f:
            t = paipc.open_file(f).read_all()
    if columns:
        t = t.select(list(columns))
    if n_rows is not None:
        t = t.slice(0, n_rows)
    return table_from_arrow(t, device=device)


def write_ipc(df, file, compression: str = "zstd") -> None:
    import pyarrow as pa
    import pyarrow.ipc as paipc
    at = table_to_arrow(df._table)
    opts = paipc.IpcWriteOptions(
        compression=compression if compression else None)
    if hasattr(file, "write"):
        with paipc.new_file(file, at.schema, options=opts) as w:
            w.write_table(at)
        return
    with pa.OSFile(str(file), "wb") as f:
        with paipc.new_file(f, at.schema, options=opts) as w:
            w.write_table(at)


def read_ipc_stream_table(source, device=None) -> Table:
    """An Arrow IPC stream (not the file format)."""
    import pyarrow.ipc as paipc
    if isinstance(source, (bytes, bytearray)):
        source = _io.BytesIO(source)
    elif not hasattr(source, "read"):
        source = str(source)
    return table_from_arrow(paipc.open_stream(source).read_all(),
                            device=device)


def write_ipc_stream(df, file) -> None:
    import pyarrow as pa
    import pyarrow.ipc as paipc
    at = table_to_arrow(df._table)
    sink = file if hasattr(file, "write") else pa.OSFile(str(file), "wb")
    with paipc.new_stream(sink, at.schema) as w:
        w.write_table(at)
    if not hasattr(file, "write"):
        sink.close()


def read_ipc_schema(source) -> dict:
    import pyarrow.ipc as paipc
    from .arrow_interop import dtype_from_arrow
    with open(source, "rb") if isinstance(source, str) else source as f:
        sch = paipc.open_file(f).schema
    return {n: dtype_from_arrow(sch.field(n).type) for n in sch.names}
