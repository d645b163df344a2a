"""CSV IO (pyarrow's C++ parser on the host).

The port of the JAX package's `io/csv.py` (the reference's
`polars-io/src/csv/` reader and writer options). pyarrow (and pandas,
for the writer) are imported inside the functions.
"""

from __future__ import annotations

import io as _io
from typing import Optional

from ..batch import Table
from .arrow_interop import table_from_arrow, table_to_arrow


def _strip_comments(source, prefix: str):
    """Drop full lines starting with `prefix` (pyarrow has no comment
    support; polars-io csv read_options comment_prefix)."""
    if hasattr(source, "read"):
        raw = source.read()
        if isinstance(raw, str):
            raw = raw.encode()
    else:
        with open(str(source), "rb") as f:
            raw = f.read()
    p = prefix.encode()
    kept = b"\n".join(ln for ln in raw.split(b"\n")
                      if not ln.lstrip().startswith(p))
    return _io.BytesIO(kept)


def read_csv_table(source, has_header: bool = True, separator: str = ",",
                   columns=None, n_rows: Optional[int] = None,
                   schema_overrides=None, try_parse_dates: bool = False,
                   null_values=None, comment_prefix=None,
                   skip_rows: int = 0, new_columns=None,
                   quote_char: str = '"', ignore_errors: bool = False,
                   truncate_ragged_lines: bool = False, device=None,
                   **kw) -> Table:
    import pyarrow.csv as pacsv
    if isinstance(source, str) and "\n" in source:
        source = _io.BytesIO(source.encode())
    if comment_prefix:
        source = _strip_comments(source, comment_prefix)
    read_opts = pacsv.ReadOptions(autogenerate_column_names=not has_header,
                                  skip_rows=skip_rows)
    parse_kw = dict(delimiter=separator)
    if quote_char is not None:
        parse_kw["quote_char"] = quote_char
    if ignore_errors or truncate_ragged_lines:
        parse_kw["invalid_row_handler"] = lambda row: "skip"
    parse_opts = pacsv.ParseOptions(**parse_kw)
    conv = {}
    if null_values is not None:
        conv["null_values"] = ([null_values] if isinstance(null_values, str)
                               else list(null_values))
        conv["strings_can_be_null"] = True
    if schema_overrides:
        from ..dtypes import DataType
        from .arrow_interop import dtype_to_arrow
        conv["column_types"] = {
            k: dtype_to_arrow(v() if isinstance(v, type)
                              and issubclass(v, DataType) else v)
            for k, v in dict(schema_overrides).items()}
    convert_opts = pacsv.ConvertOptions(**conv)
    t = pacsv.read_csv(str(source) if not hasattr(source, "read") else source,
                       read_options=read_opts, parse_options=parse_opts,
                       convert_options=convert_opts)
    if not has_header:
        t = t.rename_columns([f"column_{i+1}" for i in range(t.num_columns)])
    if new_columns:
        names = list(new_columns)
        cur = list(t.column_names)
        t = t.rename_columns(names + cur[len(names):])
    if columns:
        t = t.select(list(columns))
    if n_rows is not None:
        t = t.slice(0, n_rows)
    return table_from_arrow(t, device=device)


def write_csv(df, file=None, separator: str = ",",
              include_header: bool = True, null_value: str = "",
              line_terminator: str = "\n", float_precision=None,
              quote_char: str = '"', **kw):
    """Minimal-quoting writer (polars quote_style='necessary'); floats
    keep their ".0" like polars. Rides pandas' C writer."""
    import pandas  # noqa: F401  (the writer below needs it)
    at = table_to_arrow(df._table)
    pdf = at.to_pandas()
    ffmt = None
    if float_precision is not None:
        ffmt = f"%.{float_precision}f"
    out = pdf.to_csv(None, sep=separator, index=False,
                     header=include_header, na_rep=null_value,
                     float_format=ffmt, lineterminator=line_terminator,
                     quotechar=quote_char)
    if file is None:
        return out
    if hasattr(file, "write"):
        try:
            file.write(out)
        except TypeError:  # binary buffer (BytesIO / "wb" handle)
            file.write(out.encode())
    else:
        with open(str(file), "w", newline="") as f:
            f.write(out)
    return None


def scan_csv_batches(source, batch_rows: int = 1 << 21,
                     has_header: bool = True, separator: str = ",",
                     null_values=None, **_kw):
    """Stream a CSV file as arrow tables of ~batch_rows rows (pyarrow's
    incremental reader; reference: polars-io streaming CSV source,
    `polars-stream/src/nodes/io_sources/csv`)."""
    import pyarrow as pa
    import pyarrow.csv as pacsv
    # blocks of about 32 bytes a row, between 16 KiB and pyarrow's 1 MiB,
    # so that a small batch size streams small batches
    read_opts = pacsv.ReadOptions(
        autogenerate_column_names=not has_header,
        block_size=min(1 << 20, max(1 << 14, 32 * int(batch_rows))))
    parse_opts = pacsv.ParseOptions(delimiter=separator)
    conv = {}
    if null_values is not None:
        conv["null_values"] = ([null_values] if isinstance(null_values, str)
                               else list(null_values))
        conv["strings_can_be_null"] = True
    reader = pacsv.open_csv(
        str(source) if not hasattr(source, "read") else source,
        read_options=read_opts, parse_options=parse_opts,
        convert_options=pacsv.ConvertOptions(**conv))
    buf, rows = [], 0
    for batch in reader:
        if batch.num_rows == 0:
            continue
        buf.append(batch)
        rows += batch.num_rows
        if rows >= batch_rows:
            yield pa.Table.from_batches(buf)
            buf, rows = [], 0
    if buf:
        yield pa.Table.from_batches(buf)
