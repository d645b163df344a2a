"""Avro Object Container Files: reader and writer, on numpy alone.

The port of the JAX package's `io/avro.py` (the reference's own codec,
`polars-io/src/avro/`): the OCF layout (magic, metadata map, sync
markers), zigzag varints, and the null and deflate codecs (snappy when
the `snappy` module is there). It needs no pyarrow, so it runs on a
machine without one.

`read_avro` decodes the rows cell by cell, as the JAX package's reader
does, into one Python list per field, and builds the port's `Table`
straight from them, with the dtypes the JAX package's `_arrow_type`
gives them, copied to the device; a string column's sorted dictionary
comes from one dict of its distinct values and one sort of them.
`write_avro` encodes column by column with numpy (a varint or a
dictionary entry's bytes per row) and interleaves the rows' fields with
one scatter, so that no Python object is made per row. Where the JAX
package's writer goes through Python floats (times, timestamps) the
port's is exact.

Supported schemas: records of null/boolean/int/long/float/double/bytes/
string/enum/fixed, nullable unions (["null", T] in either order), the
logical types date, time-millis, time-micros, timestamp-millis and
timestamp-micros, and arrays (List columns).
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..errors import ComputeError, SchemaError

MAGIC = b"Obj\x01"

# ---------------------------------------------------------------------------
# the primitive binary codec (Avro 1.11, "Binary encoding")


def _zigzag_decode(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _write_long(buf: bytearray, v: int) -> None:
    n = ((int(v) << 1) ^ (int(v) >> 63)) & ((1 << 64) - 1)
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


class _Reader:
    __slots__ = ("b", "pos")

    def __init__(self, data: bytes):
        self.b = data
        self.pos = 0

    def long(self) -> int:
        shift = acc = 0
        b, pos = self.b, self.pos
        while True:
            byte = b[pos]
            pos += 1
            acc |= (byte & 0x7F) << shift
            if byte < 0x80:
                break
            shift += 7
        self.pos = pos
        return _zigzag_decode(acc)

    def bytes_(self) -> bytes:
        n = self.long()
        out = self.b[self.pos:self.pos + n]
        self.pos += n
        return out

    def fixed(self, n: int) -> bytes:
        out = self.b[self.pos:self.pos + n]
        self.pos += n
        return out

    def map_(self) -> Dict[str, bytes]:
        out: Dict[str, bytes] = {}
        while True:
            n = self.long()
            if n == 0:
                return out
            if n < 0:  # a block with its byte size
                n = -n
                self.long()
            for _ in range(n):
                k = self.bytes_().decode("utf-8")
                out[k] = self.bytes_()


# ---------------------------------------------------------------------------
# the schema


class _Field:
    __slots__ = ("name", "kind", "nullable", "null_first", "logical",
                 "symbols", "size", "items")

    def __init__(self, name, kind, nullable=False, null_first=True,
                 logical=None, symbols=None, size=0, items=None):
        self.name = name
        self.kind = kind          # a primitive's name, "enum", "fixed", "array"
        self.nullable = nullable  # the union ["null", kind]
        self.null_first = null_first
        self.logical = logical    # date, time-millis, ..., timestamp-micros
        self.symbols = symbols    # an enum's symbols
        self.size = size          # a fixed's size
        self.items = items        # an array's element _Field


def _parse_type(name: str, t: Any) -> _Field:
    nullable, null_first = False, True
    if isinstance(t, list):  # a union
        branches = [b for b in t if b != "null"]
        if len(branches) != 1 or "null" not in t:
            raise SchemaError(f"unsupported avro union for {name!r}: {t}")
        nullable, null_first = True, t[0] == "null"
        t = branches[0]
    logical = None
    if isinstance(t, dict):
        logical = t.get("logicalType")
        kind = t["type"]
        if kind == "enum":
            return _Field(name, "enum", nullable, null_first,
                          symbols=list(t["symbols"]))
        if kind == "fixed":
            return _Field(name, "fixed", nullable, null_first,
                          size=int(t["size"]))
        if kind == "array":
            return _Field(name, "array", nullable, null_first,
                          items=_parse_type(name + "[]", t["items"]))
        t = kind
    if t not in ("null", "boolean", "int", "long", "float", "double",
                 "bytes", "string"):
        raise SchemaError(f"unsupported avro type for {name!r}: {t}")
    return _Field(name, t, nullable, null_first, logical=logical)


def _parse_schema(js: Any) -> List[_Field]:
    if isinstance(js, (str, bytes)):
        js = json.loads(js)
    if js.get("type") != "record":
        raise SchemaError("avro top-level schema must be a record")
    return [_parse_type(f["name"], f["type"]) for f in js["fields"]]


# ---------------------------------------------------------------------------
# read


def _decode_value(r: _Reader, f: _Field):
    """One value of `f`'s kind."""
    k = f.kind
    if k == "boolean":
        r.pos += 1
        return r.b[r.pos - 1] != 0
    if k in ("int", "long"):
        return r.long()
    if k == "float":
        r.pos += 4
        return struct.unpack_from("<f", r.b, r.pos - 4)[0]
    if k == "double":
        r.pos += 8
        return struct.unpack_from("<d", r.b, r.pos - 8)[0]
    if k == "string":
        return r.bytes_().decode("utf-8")
    if k == "bytes":
        return r.bytes_()
    if k == "enum":
        return f.symbols[r.long()]
    if k == "fixed":
        return r.fixed(f.size)
    if k == "array":
        out = []
        while True:
            n = r.long()
            if n == 0:
                return out
            if n < 0:
                n = -n
                r.long()  # the block's byte size
            for _ in range(n):
                out.append(_decode_cell(r, f.items))
    if k == "null":
        return None
    raise SchemaError(f"unsupported avro kind {k!r}")


def _decode_cell(r: _Reader, f: _Field):
    if f.nullable:
        branch = r.long()
        if branch == (0 if f.null_first else 1):
            return None
    return _decode_value(r, f)


def _decompress(block: bytes, codec: str) -> bytes:
    if codec in ("", "null"):
        return block
    if codec == "deflate":
        return zlib.decompress(block, -15)
    if codec == "snappy":
        try:
            import snappy  # type: ignore
        except ImportError as e:
            raise ComputeError(
                "avro file uses snappy codec; snappy module not available"
            ) from e
        return snappy.decompress(block[:-4])  # a trailing crc32
    raise ComputeError(f"unsupported avro codec {codec!r}")


def _read_stream(source) -> bytes:
    if hasattr(source, "read"):
        return source.read()
    if isinstance(source, (bytes, bytearray)):
        return bytes(source)
    with open(str(source), "rb") as fh:
        return fh.read()


def read_avro_columns(source, columns: Optional[List[str]] = None,
                      n_rows: Optional[int] = None
                      ) -> List[Tuple[_Field, list]]:
    """Decode an OCF into (field, Python values with None for a null) of
    each kept field, in file order."""
    data = _read_stream(source)
    if data[:4] != MAGIC:
        raise ComputeError("not an avro object container file")
    r = _Reader(data)
    r.pos = 4
    meta = r.map_()
    sync = r.fixed(16)
    codec = meta.get("avro.codec", b"null").decode()
    fields = _parse_schema(meta["avro.schema"])
    want = set(columns) if columns is not None else None
    cols = [(f, []) for f in fields]
    keep = [want is None or f.name in want for f in fields]
    total = 0
    while r.pos < len(r.b) and (n_rows is None or total < n_rows):
        count = r.long()
        size = r.long()
        block = _decompress(r.fixed(size), codec)
        if r.fixed(16) != sync:
            raise ComputeError("avro sync marker mismatch (corrupt file)")
        if n_rows is not None:
            count = min(count, n_rows - total)
        br = _Reader(block)
        for _ in range(count):
            for (f, vals), k in zip(cols, keep):
                v = _decode_cell(br, f)
                if k:
                    vals.append(v)
        total += count
    return [c for c, k in zip(cols, keep) if k]


def _distinct_codes(vals: list) -> Tuple[np.ndarray, np.ndarray]:
    """(codes: each value's rank among the distinct values, NULL_CODE for
    a None; the distinct values, sorted), by one dict and one sort of
    its keys."""
    from ..strings import NULL_CODE
    seen: Dict[Any, int] = {}
    first = np.array([-1 if v is None else seen.setdefault(v, len(seen))
                      for v in vals], np.int64)
    keys = np.empty(len(seen), dtype=object)
    keys[:] = list(seen)
    order = np.argsort(keys, kind="stable")
    rank = np.empty(len(keys) + 1, np.int32)
    rank[order] = np.arange(len(keys))
    rank[-1] = NULL_CODE
    return rank[first], keys[order]


# logical types: (the port's dtype, the factor to its unit)
_LOGICAL = {"date": ("Date", 1), "time-millis": ("Time", 1_000_000),
            "time-micros": ("Time", 1_000),
            "timestamp-millis": ("Datetime:ms", 1),
            "timestamp-micros": ("Datetime:us", 1)}


def _dtype_of(f: _Field):
    """The dtype the JAX package's `_arrow_type` gives a field."""
    from ..dtypes import (Binary, Boolean, Date, Datetime, Float32, Float64,
                          Int32, Int64, List as ListT, String, Time)
    if f.logical in _LOGICAL:
        name = _LOGICAL[f.logical][0]
        return {"Date": Date, "Time": Time}.get(name) or \
            Datetime(name.split(":")[1])
    if f.kind == "array":
        return ListT(_dtype_of(f.items))
    return {"boolean": Boolean, "int": Int32, "long": Int64,
            "float": Float32, "double": Float64, "string": String,
            "enum": String, "bytes": Binary(), "fixed": Binary(),
            "null": Boolean}[f.kind]


def _column(f: _Field, vals: list, cap: int, device):
    from ..batch import Column, _list_column_from_host
    from ..strings import NULL_CODE, StringDict
    dt = _dtype_of(f)
    if f.kind == "array":
        return _list_column_from_host(vals, dt, cap).map_rows(
            lambda x: x.to(device))
    if not dt.is_string:
        scale = _LOGICAL.get(f.logical, (None, 1))[1]
        if scale != 1:
            vals = [None if v is None else v * scale for v in vals]
        return Column.from_host(vals, dt, cap, device)
    codes, uniq = _distinct_codes(vals)
    data = np.full(cap, NULL_CODE, np.int32)
    data[:len(vals)] = codes
    valid = None
    if (codes == NULL_CODE).any():
        m = np.zeros(cap, bool)
        m[:len(vals)] = codes != NULL_CODE
        valid = torch.from_numpy(m).to(device)
    return Column(dt, torch.from_numpy(data).to(device), valid,
                  StringDict(uniq))


def read_avro(source, columns: Optional[List[str]] = None,
              n_rows: Optional[int] = None, device=None):
    """An Avro OCF as a DataFrame on `device` (the reference's
    `polars-io/src/avro/read.rs`)."""
    from ..api.frame import DataFrame
    from ..batch import Table, resolve_device
    from ..config import capacity_for
    device = resolve_device(device)
    decoded = read_avro_columns(source, columns, n_rows)
    n = len(decoded[0][1]) if decoded else 0
    cap = capacity_for(n)
    names = [f.name for f, _ in decoded]
    cols = {f.name: _column(f, vals, cap, device) for f, vals in decoded}
    return DataFrame._from_table(Table(names, cols, cap, n, None,
                                       device=device))


# ---------------------------------------------------------------------------
# write


def _avro_type_of(col) -> Any:
    from ..dtypes import Datetime, Duration
    dt = col.dtype
    name = repr(dt)
    if name in ("Int8", "Int16", "Int32", "UInt8", "UInt16"):
        return "int"
    if name in ("Int64", "UInt32", "UInt64") or isinstance(dt, Duration):
        return "long"
    simple = {"Float32": "float", "Float64": "double", "Boolean": "boolean",
              "String": "string", "Categorical": "string", "Binary": "bytes"}
    if name in simple:
        return simple[name]
    if name == "Date":
        return {"type": "int", "logicalType": "date"}
    if name == "Time":
        return {"type": "long", "logicalType": "time-micros"}
    if isinstance(dt, Datetime):
        return {"type": "long", "logicalType": "timestamp-millis"
                if dt.time_unit == "ms" else "timestamp-micros"}
    raise SchemaError(f"cannot write dtype {name} to avro")


def _avro_schema_for(t) -> dict:
    fields = []
    for nm in t.names:
        col = t.cols[nm]
        at = _avro_type_of(col)
        fields.append({"name": nm, "type": ["null", at]
                       if col.validity is not None else at})
    return {"type": "record", "name": "polaroid", "fields": fields}


def _varints(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Zigzag varints of int64 values: ((n, 10) uint8 bytes, lengths)."""
    x = x.astype(np.int64, copy=False)
    zz = ((x << 1) ^ (x >> 63)).view(np.uint64)
    lens = np.ones(len(x), np.int64)
    for j in range(1, 10):
        lens += zz >= np.uint64(1 << (7 * j))
    mat = np.empty((len(x), 10), np.uint8)
    for j in range(10):
        b = ((zz >> np.uint64(7 * j)) & np.uint64(0x7F)).astype(np.uint8)
        mat[:, j] = np.where(j < lens - 1, b | 0x80, b)
    return mat, lens


class _Pieces:
    """Per-row byte pieces of the fields in order; `assemble` writes each
    row's pieces one after another with one scatter per piece."""

    def __init__(self, n: int):
        self.n = n
        self.items: list = []  # (flat uint8 source, source offsets, lengths)

    def fixed(self, mat: np.ndarray, lens: Optional[np.ndarray] = None):
        """Row i's bytes are mat[i, :lens[i]] (all of the row if None)."""
        w = mat.shape[1]
        ln = np.full(self.n, w, np.int64) if lens is None else lens
        self.items.append((np.ascontiguousarray(mat).reshape(-1),
                           np.arange(self.n, dtype=np.int64) * w, ln))

    def gathered(self, flat: np.ndarray, offs: np.ndarray, lens: np.ndarray):
        self.items.append((flat, offs, lens))

    def assemble(self) -> bytes:
        total = np.zeros(self.n, np.int64)
        for _, _, ln in self.items:
            total += ln
        row0 = np.cumsum(total) - total
        out = np.empty(int(total.sum()), np.uint8)
        at = row0.copy()
        for flat, offs, ln in self.items:
            k = int(ln.sum())
            if k:
                rows = np.repeat(np.arange(self.n), ln)
                within = np.arange(k) - np.repeat(np.cumsum(ln) - ln, ln)
                out[at[rows] + within] = flat[offs[rows] + within]
            at += ln
        return out.tobytes()


def _encode_rows(t, n: int) -> bytes:
    """The rows of a compact table (n live) in Avro's binary encoding."""
    from ..batch import _host_logical
    from ..dtypes import Datetime
    pieces = _Pieces(n)
    for nm in t.names:
        col = t.cols[nm]
        dt = col.dtype
        if col.is_nested:
            raise SchemaError(f"cannot write dtype {dt!r} to avro")
        kind = _avro_type_of(col)
        data = col.data[:n].cpu().numpy()
        valid = col.validity[:n].cpu().numpy() \
            if col.validity is not None else None
        if valid is not None:
            # the union branch: null first (zigzag 0), the value (2)
            pieces.fixed(np.where(valid, 2, 0).astype(np.uint8)[:, None])
        live = np.ones(n, bool) if valid is None else valid
        name = repr(dt)
        if name in ("String", "Categorical", "Binary"):
            vals = col.sdict.values if col.sdict is not None else \
                np.array([], dtype=object)
            enc = [v.encode("utf-8") if isinstance(v, str) else bytes(v)
                   for v in vals]
            lmat, llen = _varints(np.array([len(e) for e in enc], np.int64))
            entries = [lmat[i, :llen[i]].tobytes() + e
                       for i, e in enumerate(enc)]
            elen = np.array([len(e) for e in entries], np.int64)
            eoff = np.cumsum(elen) - elen
            flat = np.frombuffer(b"".join(entries) or b"\0", np.uint8)
            codes = data.astype(np.int64)
            ok = live & (codes >= 0)
            safe = np.where(ok, codes, 0)
            pieces.gathered(flat, np.where(ok, eoff[safe] if len(eoff)
                                           else 0, 0),
                            np.where(ok, elen[safe] if len(elen) else 0, 0))
        elif kind in ("float", "double"):
            w = 4 if kind == "float" else 8
            mat = np.ascontiguousarray(data.astype("<f4" if w == 4
                                                   else "<f8")) \
                .view(np.uint8).reshape(n, w)
            pieces.fixed(mat, np.where(live, w, 0))
        elif kind == "boolean":
            pieces.fixed(data.astype(np.uint8)[:, None],
                         live.astype(np.int64))
        else:
            v = _host_logical(dt, data).astype(np.int64) \
                if name != "UInt64" else data.view(np.int64)
            if name == "Time":
                v = v // 1000  # ns -> time-micros
            elif isinstance(dt, Datetime) and dt.time_unit == "ns":
                v = v // 1000  # ns -> timestamp-micros
            mat, lens = _varints(v)
            pieces.fixed(mat, np.where(live, lens, 0))
    return pieces.assemble()


def write_avro(df, file, compression: str = "uncompressed",
               sync: bytes = b"polaroid-tpu-ocf") -> None:
    """A DataFrame as an Avro OCF of one block (the reference's
    `polars-io/src/avro/write.rs`; codecs null and deflate, and snappy
    when the `snappy` module is there)."""
    from ..ops.compact import compact
    codec = {"uncompressed": "null", "null": "null", "deflate": "deflate",
             "snappy": "snappy"}.get(compression)
    if codec is None:
        raise ComputeError(f"unsupported avro compression {compression!r}")
    if len(sync) != 16:
        raise ComputeError("an avro sync marker has 16 bytes")
    t = compact(df._table)
    js = _avro_schema_for(t)
    n = t.count_rows()
    body = _encode_rows(t, n)

    header = bytearray(MAGIC)
    meta = {"avro.schema": json.dumps(js).encode(),
            "avro.codec": codec.encode()}
    _write_long(header, len(meta))
    for k, v in meta.items():
        _write_long(header, len(k.encode()))
        header += k.encode()
        _write_long(header, len(v))
        header += v
    _write_long(header, 0)
    header += sync

    payload = body
    if codec == "deflate":
        co = zlib.compressobj(9, zlib.DEFLATED, -15)
        payload = co.compress(body) + co.flush()
    elif codec == "snappy":
        try:
            import snappy  # type: ignore
        except ImportError as e:
            raise ComputeError("snappy module not available") from e
        payload = snappy.compress(body) + struct.pack(">I", zlib.crc32(body))

    out = bytearray(header)
    _write_long(out, n)
    _write_long(out, len(payload))
    out += payload
    out += sync
    if hasattr(file, "write"):
        file.write(bytes(out))
    else:
        with open(str(file), "wb") as fh:
            fh.write(bytes(out))
