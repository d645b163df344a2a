"""JSON and NDJSON IO: the port of the JAX package's `io/json_io.py`
(the reference's `polars-json`). The NDJSON reader is pyarrow's,
imported inside it; the JSON reader and both writers need no pyarrow."""

from __future__ import annotations

import io as _io
import json as _json

import numpy as np

from ..batch import Table
from .arrow_interop import table_from_arrow


def read_ndjson_table(source, n_rows=None, device=None) -> Table:
    import pyarrow.json as pajson
    if isinstance(source, str) and "\n" in source:
        source = _io.BytesIO(source.encode())
    elif isinstance(source, bytes):
        source = _io.BytesIO(source)
    t = pajson.read_json(source if hasattr(source, "read") else str(source))
    if n_rows is not None:
        t = t.slice(0, n_rows)
    return table_from_arrow(t, device=device)


def read_json_table(source, device=None) -> Table:
    if hasattr(source, "read"):
        data = _json.load(source)
    elif isinstance(source, (str,)) and source.strip().startswith(("[", "{")):
        data = _json.loads(source)
    else:
        with open(source) as f:
            data = _json.load(f)
    if isinstance(data, dict):
        data = [data]
    cols = {}
    for row in data:
        for k in row:
            cols.setdefault(k, [])
    for row in data:
        for k in cols:
            cols[k].append(row.get(k))
    return Table.from_dict(cols, device=device)


def write_ndjson(df, file=None):
    d = df._table.to_numpy_dict()
    names = list(d.keys())
    n = len(d[names[0]]) if names else 0
    lines = []
    for i in range(n):
        row = {}
        for k in names:
            v = d[k][i]
            if isinstance(v, np.generic):
                v = v.item()
            elif v is not None and not isinstance(v, (int, float, str, bool)):
                v = str(v)
            row[k] = v
        lines.append(_json.dumps(row))
    out = "\n".join(lines) + ("\n" if lines else "")
    if file is None:
        return out
    with open(file, "w") as f:
        f.write(out)
    return None


def write_json(df, file=None):
    """The rows as one JSON array of objects (values JSON cannot hold
    as their strings)."""
    s = _json.dumps(list(df.iter_rows(named=True)), default=str)
    if file is None:
        return s
    with open(file, "w") as f:
        f.write(s)
    return None
