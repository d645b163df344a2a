"""The port's host IO against the JAX package's, on the CPU.

Every reader and writer both ways: the JAX package writes and the port
reads (held to the JAX package's read of the same file), and the port
writes and the JAX package reads (held to the frame written). Small
frames from a seed cover every dtype: UInt64 at and above 2^63, NaN next
to null, +-0.0, Datetime in each unit and with a zone, Date, Time,
Duration, Decimal, dictionary strings, Binary, List and Struct. Values
are compared exactly (floats by their bits, temporals by their integer
counts). Then the Parquet scan's pushdowns (projection, predicate with
the JAX package's filter and residual, hive directories, globs, n_rows,
FAST_COUNT, the overlapped per-column read), the headline query from a
Parquet file, the SQL table functions, streamed scans and sinks over
several batches, the Arrow and pandas interop, and `remote()`.

Kept differences (the port is exact, the JAX package is not; held to
the Arrow source): an Int64 column with nulls and values past 2^53
(the JAX package goes through float64), Time32 and Time64 in ms or us,
and timestamps and durations in seconds (it stores their counts
unscaled), and Avro times and timestamps the JAX package's writer
rounds through Python floats.
"""

import decimal
import io
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
from polaroid_tpu_torch.exec import streaming as PS
from polaroid_tpu_torch.io import parquet as PQ


@pytest.fixture(autouse=True, scope="module")
def _fresh_reference_cache():
    """The JAX package's process-wide caches can hand this file's plans
    another frame's results (`tests/test_torch_reference_caches.py`)."""
    from test_torch_reference_caches import fresh_reference_caches
    with fresh_reference_caches():
        yield


@pytest.fixture
def on_cpu():
    with pt.Config(device="cpu"):
        yield


# ---------------------------------------------------------------------------
# exact comparison of Arrow data
# ---------------------------------------------------------------------------

def _canon(col):
    """An Arrow column as comparable host values: nulls as None, floats
    by their bit patterns, temporals by their integer counts."""
    col = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    t = col.type
    if pa.types.is_dictionary(t):
        col = col.cast(t.value_type)
        t = col.type
    valid = np.asarray(col.is_valid())
    if pa.types.is_floating(t):
        bits = np.asarray(col.fill_null(0)).view(
            np.int32 if t == pa.float32() else np.int64)
        vals = bits.tolist()
    elif pa.types.is_temporal(t):
        phys = pa.int32() if t in (pa.date32(), pa.time32("s"),
                                   pa.time32("ms")) else pa.int64()
        vals = np.asarray(col.cast(phys).fill_null(0)).tolist()
    else:
        return str(t), col.to_pylist()
    return str(t), [v if ok else None for v, ok in zip(vals, valid)]


def _same_arrow(got, want, skip=()):
    assert got.column_names == want.column_names
    for name in got.column_names:
        if name in skip:
            continue
        assert _canon(got.column(name)) == _canon(want.column(name)), name


def _same_frames(got, want, skip=()):
    """A port frame and a JAX package frame, through Arrow."""
    _same_arrow(got.to_arrow(), want.to_arrow(), skip)


# ---------------------------------------------------------------------------
# the data
# ---------------------------------------------------------------------------

N = 64


def _every_dtype(seed: int = 3) -> pa.Table:
    rng = np.random.default_rng(seed)
    n = N
    f = rng.normal(size=n)
    f[:4] = [np.nan, 0.0, -0.0, np.inf]
    fnull = np.zeros(n, bool)
    fnull[4:9] = True
    t0 = 1_709_562_600_123_456_789
    s = rng.choice(["AAPL", "MSFT", "é€", ""], n).astype(object)
    s[rng.uniform(size=n) < 0.1] = None
    lst = [None if i % 7 == 3 else
           [int(x) for x in rng.integers(-5, 5, i % 4)] for i in range(n)]
    lst[5] = [1, None, 3]
    return pa.table({
        "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8)),
        "i16": pa.array(rng.integers(-2**15, 2**15, n).astype(np.int16)),
        "i32": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                        mask=rng.uniform(size=n) < 0.1),
        "i64": pa.array(rng.integers(-2**62, 2**62, n)),
        "u8": pa.array(rng.integers(0, 256, n).astype(np.uint8)),
        "u16": pa.array(rng.integers(0, 2**16, n).astype(np.uint16)),
        "u32": pa.array(rng.integers(0, 2**32, n).astype(np.uint32)),
        "u64": pa.array(np.concatenate([
            np.array([2**63, 2**64 - 1, 2**63 + 12345], np.uint64),
            rng.integers(0, 2**63, n - 3).astype(np.uint64)])),
        "f32": pa.array(rng.normal(size=n).astype(np.float32)),
        "f64": pa.array(f, mask=fnull),
        "b": pa.array(rng.uniform(size=n) < 0.5,
                      mask=rng.uniform(size=n) < 0.1),
        "s": pa.array(list(s), pa.large_string()),
        "sdict": pa.array(list(s)).dictionary_encode(),
        "bin": pa.array([None if i % 9 == 0 else bytes([i, 255 - i, 0])
                         for i in range(n)], pa.large_binary()),
        "ts_ns_tz": pa.array(t0 + np.arange(n) * 1_000_003,
                             pa.timestamp("ns", "America/New_York")),
        "ts_us": pa.array((t0 // 1000) + np.arange(n) * 7,
                          pa.timestamp("us"),
                          mask=rng.uniform(size=n) < 0.1),
        "ts_ms_tz": pa.array((t0 // 10**6) + np.arange(n),
                             pa.timestamp("ms", "UTC")),
        "date": pa.array(19_700 + np.arange(n, dtype=np.int32), pa.date32()),
        "time": pa.array(34_200_000_000_001 + np.arange(n) * 999,
                         pa.time64("ns")),
        "dur_us": pa.array(np.arange(n) * -1_001, pa.duration("us")),
        "dur_ns": pa.array(np.arange(n) * 3, pa.duration("ns")),
        "dec": pa.array([None if i % 5 == 0 else
                         decimal.Decimal(f"{i}.25") for i in range(n)],
                        pa.decimal128(10, 2)),
        "nul": pa.nulls(n),
        "lst": pa.array(lst, pa.large_list(pa.int64())),
        "lst_s": pa.array([None if x is None else [str(v) for v in x]
                           for x in lst]),
        "st": pa.array([None if i % 6 == 1 else
                        {"x": i, "y": None if i % 4 == 0 else f"k{i % 3}"}
                        for i in range(n)]),
    })


# Parquet, IPC, CSV, NDJSON and Avro each hold a subset
EVERY = _every_dtype()


def _pair(at: pa.Table):
    return ref.from_arrow(at), pt.from_arrow(at, device="cpu")


# ---------------------------------------------------------------------------
# Arrow interop
# ---------------------------------------------------------------------------

def test_from_arrow_matches_reference_and_round_trips():
    rdf, tdf = _pair(EVERY)
    assert {k: repr(v) for k, v in tdf.schema.items()} == \
        {k: repr(v) for k, v in rdf.schema.items()}
    _same_frames(tdf, rdf)
    # the port's own round trip keeps every value of the source
    back = tdf.to_arrow()
    for name in EVERY.column_names:
        want = EVERY.column(name)
        if name == "sdict":
            want = want.cast(pa.large_string())
        elif name == "dec":
            want = want.cast(pa.float64())
        elif name == "nul":
            want = pa.array([None] * N, pa.bool_())
        if name in ("lst_s", "st"):
            assert back.column(name).to_pylist() == want.to_pylist(), name
        else:
            assert _canon(back.column(name))[1] == _canon(want)[1], name


def test_uint64_past_2_63_and_nan_beside_null():
    tdf = pt.from_arrow(EVERY, device="cpu")
    u = tdf["u64"].to_list()
    assert u[:3] == [2**63, 2**64 - 1, 2**63 + 12345]
    f = tdf["f64"].to_list()
    assert np.isnan(f[0]) and f[4] is None
    assert np.signbit(f[2]) and not np.signbit(f[1])
    assert tdf.select(pt.col("f64").is_null().sum()).item() == 5
    assert tdf.select(pt.col("f64").is_nan().sum()).item() == 1


def test_kept_differences_hold_to_the_arrow_source():
    at = pa.table({
        "i64n": pa.array([None, 2**62 + 1, -(2**60) - 3], pa.int64()),
        "t32": pa.array([1_000, None, 86_399_999], pa.time32("ms")),
        "t64us": pa.array([1, 2, 86_399_999_999], pa.time64("us")),
        "ts_s": pa.array([1_709_562_600, 0, -1], pa.timestamp("s")),
        "dur_s": pa.array([1, -2, 3], pa.duration("s")),
        "d64": pa.array([86_400_000 * 19_000, 0, -86_400_000],
                        pa.date64()),
    })
    tdf = pt.from_arrow(at, device="cpu")
    assert repr(tdf.schema["ts_s"]) == repr(pt.Datetime("us"))
    d = tdf.to_arrow()
    assert d.column("i64n").to_pylist() == [None, 2**62 + 1, -(2**60) - 3]
    assert _canon(d.column("t32"))[1] == [1_000_000_000, None,
                                          86_399_999_000_000]
    assert _canon(d.column("t64us"))[1] == [1_000, 2_000,
                                            86_399_999_999_000]
    assert _canon(d.column("ts_s"))[1] == [1_709_562_600_000_000, 0,
                                           -1_000_000]
    assert _canon(d.column("dur_s"))[1] == [1_000_000, -2_000_000,
                                            3_000_000]
    assert _canon(d.column("d64"))[1] == [86_400_000 * 19_000, 0,
                                          -86_400_000]


def test_pandas_interop_and_the_interchange_protocol():
    pdf = EVERY.select(["i32", "u64", "f64", "s", "date"]).to_pandas()
    tdf, rdf = pt.from_pandas(pdf, device="cpu"), ref.from_pandas(pdf)
    assert repr(tdf.to_dict()) == repr(rdf.to_dict())
    back = tdf.to_pandas()
    assert back.shape == pdf.shape and list(back.columns) == \
        list(pdf.columns)
    assert repr(pt.DataFrame(pdf, device="cpu").to_dict()) == \
        repr(tdf.to_dict())
    small = pt.from_arrow(EVERY.select(["i64", "s", "f32"]), device="cpu")
    via = pt.from_dataframe(small.to_arrow(), device="cpu")
    _same_arrow(via.to_arrow(), small.to_arrow())
    s = small["s"]
    assert s.to_arrow().to_pylist() == s.to_list()
    assert s.to_pandas().tolist() == ref.from_arrow(
        EVERY.select(["s"]))["s"].to_pandas().tolist()
    assert s.to_pandas().name == "s"


def test_table_to_arrow_exports_only_live_rows():
    tdf = pt.from_arrow(EVERY, device="cpu")
    rdf = ref.from_arrow(EVERY)
    kept = tdf.filter(pt.col("i8") > 0)
    want = rdf.filter(ref.col("i8") > 0)
    assert kept._table.valid is not None  # holes before the export
    _same_frames(kept, want)


@pytest.mark.parametrize("case", ["nulls", "no_validity", "all_null",
                                  "empty_dictionary", "binary", "filtered"])
def test_string_columns_export_by_take(case):
    """`to_arrow` builds a String or Binary column by one Arrow `take` of
    the dictionary by the codes; the array equals the one of a Python
    value per row, nulls (from the validity or a negative code) and an
    empty dictionary included."""
    from polaroid_tpu_torch.io.arrow_interop import dtype_to_arrow
    rng = np.random.default_rng(11)
    n = 1000
    vals = np.array([f"sym{i:03d}" for i in range(37)], dtype=object)
    s = vals[rng.integers(0, 37, n)]
    if case == "binary":
        s = np.array([x.encode() for x in s], dtype=object)
    if case in ("nulls", "binary", "filtered"):
        s[rng.random(n) < 0.2] = None
    if case == "all_null":
        s[:] = None
    if case == "empty_dictionary":
        s = s[:0]
    df = pt.DataFrame({"s": list(s), "k": np.arange(len(s))}, device="cpu")
    if case == "filtered":
        df = df.filter(pt.col("k") % 3 != 0)
    c = df._table.cols["s"]
    if case == "no_validity":
        # nulls carried by negative codes alone
        c.data[5:9] = -1
        assert c.validity is None
    got = df.to_arrow().column("s").combine_chunks()
    t = pt.ops.compact.compact(df._table)
    m = t.count_rows()
    col = t.cols["s"]
    codes = col.data[:m].numpy()
    if col.validity is not None:
        codes = np.where(col.validity[:m].numpy(), codes, -1)
    want = pa.array(col.sdict.decode(codes) if col.sdict is not None
                    else np.full(m, None, object),
                    type=dtype_to_arrow(col.dtype))
    assert got.type == want.type
    assert got.equals(want)
    assert got.null_count == int((codes < 0).sum())


# ---------------------------------------------------------------------------
# each format, both ways
# ---------------------------------------------------------------------------

# what each format keeps of EVERY
PARQUET_COLS = [c for c in EVERY.column_names]
IPC_COLS = [c for c in EVERY.column_names]
CSV_COLS = ["i8", "i32", "i64", "u16", "f64", "s", "b"]
NDJSON_COLS = ["i32", "i64", "f32", "s", "b", "lst"]
AVRO_COLS = ["i8", "i32", "i64", "u16", "f32", "f64", "b", "s", "sdict",
             "bin", "date", "ts_ms_tz"]


def _read_both(fn_name, path, **kw):
    return (getattr(pt, fn_name)(path, device="cpu", **kw),
            getattr(ref, fn_name)(path, **kw))


@pytest.mark.parametrize("fmt", ["parquet", "ipc", "ipc_stream", "csv",
                                 "ndjson", "avro", "avro_deflate", "json"])
def test_reference_writes_port_reads(tmp_path, fmt):
    cols = {"parquet": PARQUET_COLS, "ipc": IPC_COLS,
            "ipc_stream": IPC_COLS, "csv": CSV_COLS, "ndjson": NDJSON_COLS,
            "json": CSV_COLS, "avro": AVRO_COLS,
            "avro_deflate": AVRO_COLS}[fmt]
    rdf = ref.from_arrow(EVERY.select(cols))
    path = str(tmp_path / f"f.{fmt}")
    if fmt.startswith("avro"):
        rdf.write_avro(path, compression="deflate" if "deflate" in fmt
                       else "uncompressed")
        fmt = "avro"
    else:
        getattr(rdf, f"write_{fmt}")(path)
    got, want = _read_both(f"read_{fmt}", path)
    assert {k: repr(v) for k, v in got.schema.items()} == \
        {k: repr(v) for k, v in want.schema.items()}
    _same_frames(got, want)


@pytest.mark.parametrize("fmt", ["parquet", "ipc", "ipc_stream", "csv",
                                 "ndjson", "avro", "avro_deflate", "json"])
def test_port_writes_reference_reads(tmp_path, fmt):
    cols = {"parquet": PARQUET_COLS, "ipc": IPC_COLS,
            "ipc_stream": IPC_COLS, "csv": CSV_COLS, "ndjson": NDJSON_COLS,
            "json": CSV_COLS, "avro": AVRO_COLS,
            "avro_deflate": AVRO_COLS}[fmt]
    at = EVERY.select(cols)
    tdf, rdf = pt.from_arrow(at, device="cpu"), ref.from_arrow(at)
    path = str(tmp_path / f"f.{fmt}")
    if fmt.startswith("avro"):
        comp = "deflate" if "deflate" in fmt else "uncompressed"
        tdf.write_avro(path, compression=comp)
        mine = str(tmp_path / "ref.avro")
        rdf.write_avro(mine, compression=comp)
        fmt = "avro"
    else:
        getattr(tdf, f"write_{fmt}")(path)
        mine = str(tmp_path / f"ref.{fmt}")
        getattr(rdf, f"write_{fmt}")(mine)
    got = getattr(ref, f"read_{fmt}")(path)
    want = getattr(ref, f"read_{fmt}")(mine)
    assert {k: repr(v) for k, v in got.schema.items()} == \
        {k: repr(v) for k, v in want.schema.items()}
    _same_frames(pt.from_arrow(got.to_arrow(), device="cpu"), want)


def test_avro_bytes_equal_the_reference_writers():
    """Where the JAX package's Avro writer is exact (no time or
    timestamp), the port's writes the same bytes."""
    cols = ["i8", "i32", "i64", "u16", "f32", "f64", "b", "s", "sdict",
            "bin", "date"]
    at = EVERY.select(cols)
    for comp in ("uncompressed", "deflate"):
        a, b = io.BytesIO(), io.BytesIO()
        pt.from_arrow(at, device="cpu").write_avro(a, compression=comp)
        ref.from_arrow(at).write_avro(b, compression=comp)
        assert a.getvalue() == b.getvalue(), comp


def test_avro_times_and_timestamps_exact():
    """The port writes times (time-micros) and timestamps by integer
    division (the JAX package rounds them through Python floats) and
    durations as longs (the JAX package's writer cannot)."""
    at = pa.table({
        "t": pa.array([1, 999, 86_399_999_999_999], pa.time64("ns")),
        "ts_us": pa.array([1_709_562_600_123_457, -1, 0],
                          pa.timestamp("us")),
        "ts_ms": pa.array([1_709_562_600_123, -1, None],
                          pa.timestamp("ms")),
        "ts_ns": pa.array([1_709_562_600_123_456_789, -1, 5],
                          pa.timestamp("ns")),
        "dur": pa.array([-3, None, 7], pa.duration("us"))})
    buf = io.BytesIO()
    pt.from_arrow(at, device="cpu").write_avro(buf)
    got = ref.read_avro(io.BytesIO(buf.getvalue())).to_arrow()
    assert _canon(got.column("t"))[1] == [0, 0, 86_399_999_999_000]
    assert _canon(got.column("ts_us"))[1] == [1_709_562_600_123_457, -1, 0]
    assert _canon(got.column("ts_ms"))[1] == [1_709_562_600_123, -1, None]
    assert _canon(got.column("ts_ns"))[1] == [1_709_562_600_123_456, -1, 0]
    assert got.column("dur").to_pylist() == [-3, None, 7]
    mine = pt.read_avro(io.BytesIO(buf.getvalue()), device="cpu")
    _same_arrow(mine.to_arrow(), got)


def test_avro_enum_fixed_arrays_and_column_subsets():
    """A file with an enum, a fixed, a nullable array and a null field
    (written by hand: neither package writes them) read by both."""
    from polaroid_tpu_torch.io.avro import MAGIC, _write_long
    import json
    schema = {"type": "record", "name": "r", "fields": [
        {"name": "e", "type": {"type": "enum", "name": "E",
                               "symbols": ["lo", "hi", "mid"]}},
        {"name": "x", "type": {"type": "fixed", "name": "F", "size": 2}},
        {"name": "a", "type": ["null", {"type": "array", "items": "long"}]},
        {"name": "z", "type": "null"},
        {"name": "d", "type": ["double", "null"]}]}
    rows = [(1, b"ab", [1, -2], 0.5), (0, b"\x00\xff", None, None),
            (1, b"zz", [], -0.0)]
    body = bytearray()
    for e, x, a, d in rows:
        _write_long(body, e)
        body += x
        if a is None:
            _write_long(body, 0)
        else:
            _write_long(body, 1)
            if a:
                _write_long(body, len(a))
                for v in a:
                    _write_long(body, v)
            _write_long(body, 0)
        if d is None:
            _write_long(body, 1)
        else:
            _write_long(body, 0)
            body += np.float64(d).tobytes()
    sync = b"0123456789abcdef"
    out = bytearray(MAGIC)
    _write_long(out, 1)
    for k, v in (("avro.schema", json.dumps(schema).encode()),):
        _write_long(out, len(k))
        out += k.encode()
        _write_long(out, len(v))
        out += v
    _write_long(out, 0)
    out += sync
    _write_long(out, len(rows))
    _write_long(out, len(body))
    out += body + sync
    data = bytes(out)
    got = pt.read_avro(data, device="cpu")
    want = ref.read_avro(data)
    assert {k: repr(v) for k, v in got.schema.items()} == \
        {k: repr(v) for k, v in want.schema.items()}
    _same_frames(got, want)
    sub = pt.read_avro(data, columns=["d", "e"], n_rows=2, device="cpu")
    _same_frames(sub, ref.read_avro(data, columns=["d", "e"], n_rows=2))


def test_avro_long_strings_dedupe_by_dict():
    """Long strings, strings that differ only by trailing NULs, empty
    strings, non-ASCII and nulls: the distinct values of a string
    column, deduplicated by one dict, sort as the JAX package's read
    sorts them, and bytes columns keep their byte order."""
    rng = np.random.default_rng(11)
    words = ["x" * 5000, "x" * 4999 + "y", "a", "a\0", "a\0\0", "",
             "é€", "zz", "Z"]
    s = np.array(words, dtype=object)[rng.integers(0, len(words), N)]
    s[rng.uniform(size=N) < 0.15] = None
    b = [None if v is None else v.encode("utf-8")[::-1] for v in s]
    at = pa.table({"s": pa.array(s.tolist(), pa.string()),
                   "b": pa.array(b, pa.binary())})
    buf = io.BytesIO()
    ref.from_arrow(at).write_avro(buf)
    data = buf.getvalue()
    got = pt.read_avro(data, device="cpu")
    _same_frames(got, ref.read_avro(data))
    assert got._table.cols["s"].sdict.values.tolist() == \
        sorted({v for v in s if v is not None})
    assert got._table.cols["b"].sdict.values.tolist() == \
        sorted({v for v in b if v is not None})


def test_json_and_csv_options(tmp_path):
    tdf = pt.from_arrow(EVERY.select(CSV_COLS), device="cpu")
    rdf = ref.from_arrow(EVERY.select(CSV_COLS))
    assert tdf.write_json() == rdf.write_json()
    assert tdf.write_ndjson() == rdf.write_ndjson()
    assert tdf.write_csv(separator=";", null_value="NA") == \
        rdf.write_csv(separator=";", null_value="NA")
    text = rdf.write_csv(separator=";")
    got = pt.read_csv(io.BytesIO(text.encode()), separator=";",
                      columns=["s", "i64"], n_rows=10, device="cpu")
    want = ref.read_csv(io.BytesIO(text.encode()), separator=";",
                        columns=["s", "i64"], n_rows=10)
    _same_frames(got, want)
    path = tmp_path / "c.csv"
    path.write_text("# a comment\nk,v\n1,x\n# more\n2,\n")
    got, want = _read_both("read_csv", str(path), comment_prefix="#",
                           null_values="")
    _same_frames(got, want)
    got, want = _read_both("read_csv", str(path), comment_prefix="#",
                           has_header=False, skip_rows=1,
                           schema_overrides={"column_1": pt.Int32})
    assert got.to_dict() == {"column_1": [1, 2], "column_2": ["x", ""]}
    assert got.to_dict() == want.to_dict()


def test_schemas_metadata_and_batched_csv(tmp_path):
    rdf = ref.from_arrow(EVERY.select(PARQUET_COLS))
    p = str(tmp_path / "m.parquet")
    rdf.write_parquet(p)
    sch = pt.read_parquet_schema(p)
    assert {k: repr(v) for k, v in sch.items()} == \
        {k: repr(v) for k, v in ref.read_parquet_schema(p).items()}
    assert pt.read_parquet_metadata(p) == ref.read_parquet_metadata(p)
    q = str(tmp_path / "m.ipc")
    rdf.write_ipc(q)
    assert {k: repr(v) for k, v in pt.read_ipc_schema(q).items()} == \
        {k: repr(v) for k, v in ref.read_ipc_schema(q).items()}
    c = str(tmp_path / "b.csv")
    ref.from_arrow(EVERY.select(CSV_COLS)).write_csv(c)
    mine = pt.read_csv_batched(c, batch_size=8, device="cpu")
    theirs = ref.read_csv_batched(c, batch_size=8)
    while True:
        a, b = mine.next_batches(3), theirs.next_batches(3)
        assert (a is None) == (b is None)
        if a is None:
            break
        assert [x.to_dict() for x in a] == [x.to_dict() for x in b]


def test_stubs_raise_as_the_reference_does():
    for name, args in (("read_excel", ("x",)), ("read_ods", ("x",)),
                       ("read_database", ("q", None)),
                       ("read_database_uri", ("q", "u")),
                       ("scan_iceberg", ("x",)), ("Catalog", ()),
                       ("CredentialProviderAWS", ()),
                       ("CredentialProviderAzure", ()),
                       ("CredentialProviderGCP", ())):
        with pytest.raises(ModuleNotFoundError):
            getattr(pt, name)(*args)
        with pytest.raises(ModuleNotFoundError):
            getattr(ref, name)(*args)
    with pytest.raises(OSError):
        pt.read_clipboard()
    df = pt.DataFrame({"a": [1]}, device="cpu")
    for name in ("write_excel", "write_iceberg"):
        with pytest.raises(ModuleNotFoundError):
            getattr(df, name)("x")
    with pytest.raises(ModuleNotFoundError):
        df.write_database("t", None)
    with pytest.raises(OSError):
        df.write_clipboard()
    assert isinstance(pt.CompatLevel.newest(), pt.CompatLevel)
    assert pt.ScanCastOptions(x=1).options == {"x": 1}
    assert pt.CredentialProviderFunction(len).function is len
    kp = pt.KeyedPartition("k", "1", 1)
    ctx = pt.KeyedPartitionContext(0, 0, 0, [kp, pt.KeyedPartition(
        "s", "a", "a")], "f", "/f")
    assert str(ctx.hive_dirs()) == "k=1/s=a"


# ---------------------------------------------------------------------------
# Parquet scans
# ---------------------------------------------------------------------------

def _scan_data(n: int = 4096, seed: int = 9):
    rng = np.random.default_rng(seed)
    sym = np.array([f"S{i:02d}" for i in range(40)])
    return pa.table({
        "symbol": pa.array(sym[rng.integers(0, 40, n)]),
        "price": pa.array(rng.uniform(1, 200, n),
                          mask=rng.uniform(size=n) < 0.1),
        "volume": pa.array(rng.integers(0, 5000, n)),
        "day": pa.array(rng.integers(0, 4, n).astype(np.int32)),
    })


SCAN = _scan_data()


@pytest.fixture(scope="module")
def scan_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("scan") / "t.parquet"
    pq.write_table(SCAN, str(p), row_group_size=1024)
    return str(p)


def _collect_both(build, src, **kw):
    got = build(pt, pt.scan_parquet(src, device="cpu", **kw)).collect()
    want = build(ref, ref.scan_parquet(src, **kw)).collect()
    return got, want


def _q1(pl, lf):
    return (lf.filter(pl.col("volume") > 1000)
            .with_columns((pl.col("price") * pl.col("volume"))
                          .alias("notional"))
            .group_by("symbol")
            .agg(pl.len().alias("n"),
                 pl.col("price").count().alias("cnt"),
                 pl.col("notional").sum().alias("total"),
                 pl.col("price").mean().alias("avg"))
            .sort("symbol"))


def test_headline_query_from_parquet(tmp_path):
    """The headline query of the bench over a Parquet file of 2^12 rows,
    held as tests/test_torch_q1.py holds q1: counts exact, f64 sums and
    means within rtol 1e-10."""
    p = str(tmp_path / "q1.parquet")
    pq.write_table(SCAN, p)
    got, want = _collect_both(_q1, p)
    g, w = got.to_dict(), want.to_dict()
    assert g["symbol"] == w["symbol"]
    assert g["n"] == w["n"] and g["cnt"] == w["cnt"]
    for k in ("total", "avg"):
        np.testing.assert_allclose(g[k], w[k], rtol=1e-10)


def test_projection_pushdown(scan_file):
    lf = pt.scan_parquet(scan_file, device="cpu").select("volume", "symbol")
    plan = lf.explain()
    assert "π=2" in plan, plan
    got, want = _collect_both(lambda pl, d: d.select("volume", "symbol"),
                              scan_file)
    _same_frames(got, want)


PREDICATES = {
    "cmp": lambda pl: (pl.col("volume") > 1000) & (pl.col("day") != 2),
    "in_between": lambda pl: pl.col("symbol").is_in(["S01", "S07"])
    | pl.col("volume").is_between(10, 20),
    "null": lambda pl: pl.col("price").is_null() | ~(pl.col("day") == 0),
    "residual": lambda pl: ((pl.col("price") * 2) > 150)
    & (pl.col("volume") < 4000),
    "str_cmp": lambda pl: pl.col("symbol") >= "S30",
}


@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_predicate_pushdown(scan_file, name):
    """The pushed predicate splits into the same pyarrow filter and
    residual as the JAX package's, and the scan's rows are its."""
    from polaroid_tpu.exec.scan_predicate import to_arrow_filter as rsplit
    from polaroid_tpu_torch.exec.scan_predicate import to_arrow_filter
    pred_pt, pred_ref = PREDICATES[name](pt), PREDICATES[name](ref)
    mf, mr = to_arrow_filter(pred_pt)
    tf, tr = rsplit(pred_ref)
    assert str(mf) == str(tf)
    assert repr(mr) == repr(tr)
    lf = pt.scan_parquet(scan_file, device="cpu").filter(pred_pt)
    assert "σ" in lf.explain()
    got, want = _collect_both(lambda pl, d: d.filter(PREDICATES[name](pl)),
                              scan_file)
    _same_frames(got, want)


def test_hive_directories_globs_and_n_rows(tmp_path):
    tdf = pt.from_arrow(SCAN, device="cpu")
    rdf = ref.from_arrow(SCAN)
    tdf.write_parquet(str(tmp_path / "mine"), partition_by="day")
    rdf.write_parquet(str(tmp_path / "theirs"), partition_by="day")
    assert sorted(os.listdir(tmp_path / "mine")) == \
        sorted(os.listdir(tmp_path / "theirs")) == \
        ["day=0", "day=1", "day=2", "day=3"]
    for d in ("mine", "theirs"):
        src = str(tmp_path / d)
        got, want = _collect_both(
            lambda pl, f: f.filter(pl.col("volume") < 300)
            .sort("symbol", "volume", "price"), src)
        _same_frames(got, want)
        assert repr(got.schema["day"]) == repr(want.schema["day"])
    for i in range(3):
        pq.write_table(SCAN.slice(i * 1000, 1000),
                       str(tmp_path / f"part-{i}.parquet"))
    glob = str(tmp_path / "part-*.parquet")
    got, want = _collect_both(lambda pl, f: f, glob)
    _same_frames(got, want)
    got, want = _collect_both(lambda pl, f: f.head(1500), glob)
    assert got.height == 1500
    _same_frames(got, want)
    lf = pt.scan_parquet(glob, device="cpu", n_rows=77)
    got = lf.collect()
    _same_frames(got, ref.scan_parquet(glob, n_rows=77).collect())
    _same_frames(pt.read_parquet(glob, n_rows=5, device="cpu"),
                 ref.read_parquet(glob, n_rows=5))
    _same_frames(pt.read_parquet([str(tmp_path / "part-2.parquet")],
                                 columns=["price"], device="cpu"),
                 ref.read_parquet([str(tmp_path / "part-2.parquet")],
                                  columns=["price"]))


def test_fast_count(scan_file):
    lf = pt.scan_parquet(scan_file, device="cpu").select(pt.len())
    assert "FAST_COUNT" in lf.explain()
    got = lf.collect()
    want = ref.scan_parquet(scan_file).select(ref.len()).collect()
    assert got.to_dict() == want.to_dict() == {"len": [SCAN.num_rows]}
    assert repr(got.schema["len"]) == repr(want.schema["len"])
    head = pt.scan_parquet(scan_file, device="cpu").head(10) \
        .select(pt.len().alias("n")).collect()
    assert head.to_dict() == {"n": [10]}


def test_overlapped_per_column_read(scan_file, monkeypatch):
    """A single file read column by column on a thread pool, reached at
    a small size by lowering its threshold."""
    calls = []
    real = PQ._read_parquet_table_overlapped

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append(out is not None)
        return out
    monkeypatch.setattr(PQ, "_read_parquet_table_overlapped", spy)
    monkeypatch.setattr(PQ, "OVERLAP_CELLS", 1 << 10)
    got = pt.read_parquet(scan_file, device="cpu")
    assert calls == [True]
    _same_frames(got, ref.read_parquet(scan_file))
    got = pt.read_parquet(scan_file, columns=["symbol", "price"], n_rows=99,
                          device="cpu")
    assert calls == [True, True]
    _same_frames(got, ref.read_parquet(scan_file, columns=["symbol", "price"],
                                       n_rows=99))
    assert got._table.cols["symbol"].sdict is not None


def test_sql_table_functions(tmp_path, on_cpu):
    p = str(tmp_path / "s.parquet")
    pq.write_table(SCAN, p)
    c = str(tmp_path / "s.csv")
    ref.from_arrow(SCAN).write_csv(c)
    j = str(tmp_path / "s.ndjson")
    ref.from_arrow(SCAN.slice(0, 200)).write_ndjson(j)
    i = str(tmp_path / "s.ipc")
    ref.from_arrow(SCAN).write_ipc(i)
    for q in (f"SELECT symbol, SUM(volume) AS v FROM read_parquet('{p}') "
              f"WHERE day = 1 GROUP BY symbol ORDER BY symbol",
              f"SELECT day, COUNT(*) AS n FROM read_csv('{c}') "
              f"GROUP BY day ORDER BY day",
              f"SELECT * FROM read_ndjson('{j}') WHERE volume > 4000 "
              f"ORDER BY volume",
              f"SELECT symbol, price FROM read_json('{j}') LIMIT 5",
              f"SELECT MAX(price) AS m FROM read_ipc('{i}')"):
        got = pt.sql(q).collect()
        want = ref.sql(q).collect()
        assert got.device.type == "cpu"
        _same_frames(got, want)


# ---------------------------------------------------------------------------
# streamed scans and sinks
# ---------------------------------------------------------------------------

@pytest.fixture
def small_batches(monkeypatch):
    """Batches of 512 rows: the files below hold whole 512-row groups, so
    every batch fills its capacity bucket (the JAX package's streaming
    chains keep the first batch's row count; ROADMAP Queue 3)."""
    from polaroid_tpu.config import CONFIG as RC
    monkeypatch.setattr(pt.CONFIG, "batch_rows", 512)
    monkeypatch.setattr(RC, "batch_rows", 512)


@pytest.fixture(scope="module")
def stream_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("stream") / "s.parquet"
    pq.write_table(SCAN, str(p), row_group_size=512)
    return str(p)


STREAMED = {
    "groupby": lambda pl, lf: lf.filter(pl.col("volume") > 500)
    .group_by("symbol").agg(pl.col("volume").sum().alias("v"),
                            pl.len().alias("n")),
    "elementwise": lambda pl, lf: lf.with_columns(
        (pl.col("price") * 2).alias("p2")).select("symbol", "p2", "day"),
    "pushed": lambda pl, lf: lf.filter((pl.col("day") == 1)
                                       & (pl.col("price") * 3 > 100)),
    "head": lambda pl, lf: lf.head(1100),
}


@pytest.mark.parametrize("name", sorted(STREAMED))
@pytest.mark.parametrize("fmt", ["parquet", "csv"])
def test_streamed_scans(stream_file, tmp_path, small_batches, name, fmt):
    src = stream_file
    if fmt == "csv":
        src = str(tmp_path / "s.csv")
        ref.from_arrow(SCAN).write_csv(src)
        scan_pt = pt.scan_csv(src, device="cpu")
        scan_ref = ref.scan_csv(src)
    else:
        scan_pt = pt.scan_parquet(src, device="cpu")
        scan_ref = ref.scan_parquet(src)
    q = STREAMED[name](pt, scan_pt)
    PS.reset_counts()
    got = q.collect(engine="streaming")
    assert PS.COUNTS["batches"] >= 2
    if name == "groupby":
        assert PS.COUNTS["partials"] >= 2
    order = ["symbol"] if name == "groupby" else []
    mem = q.collect()
    # a string column read as a dictionary stays String, as in the
    # in-memory collect and the scan's schema
    assert got.schema["symbol"] == mem.schema["symbol"] == \
        q.collect_schema()["symbol"] == pt.String
    if order:
        # a streamed len() merges its partials by a sum: Int64 in both
        # packages, where the in-memory one is UInt32
        mem = mem.with_columns(pt.col("n").cast(pt.Int64)).sort(order)
        _same_frames(got.sort(order), mem)
    else:
        _same_frames(got, mem)
    if fmt == "parquet":
        want = STREAMED[name](ref, scan_ref).collect(engine="streaming")
        if order:
            got, want = got.sort(order), want.sort(order)
        _same_frames(got, want)


@pytest.mark.parametrize("fmt", ["parquet", "csv", "ipc", "ndjson"])
def test_streamed_sinks(stream_file, tmp_path, small_batches, fmt):
    q = lambda pl, lf: lf.filter(pl.col("volume") > 2500).select(  # noqa
        "symbol", "volume", "day")
    target = str(tmp_path / f"out.{fmt}")
    PS.reset_counts()
    getattr(q(pt, pt.scan_parquet(stream_file, device="cpu")),
            f"sink_{fmt}")(target)
    assert PS.COUNTS["batches"] >= 2
    back = getattr(ref, f"read_{fmt}")(target)
    want = q(ref, ref.scan_parquet(stream_file)).collect()
    assert back.to_dict() == want.to_dict()


def test_partitioned_sinks(stream_file, tmp_path):
    lf = pt.scan_parquet(stream_file, device="cpu")
    lf.sink_parquet(pt.PartitionByKey(str(tmp_path / "k"), by="day"))
    assert sorted(os.listdir(tmp_path / "k")) == \
        ["day=0", "day=1", "day=2", "day=3"]
    back = ref.read_parquet(str(tmp_path / "k"))
    assert back.height == SCAN.num_rows
    lf.sink_parquet(pt.PartitionMaxSize(str(tmp_path / "m"), max_size=1500))
    files = sorted(os.listdir(tmp_path / "m"))
    assert files == ["00000000.parquet", "00000001.parquet",
                     "00000002.parquet"]
    _same_frames(pt.read_parquet(str(tmp_path / "m" / "*.parquet"),
                                 device="cpu"), ref.from_arrow(SCAN))


def test_a_worker_error_reraises_in_the_consumer():
    def source():
        yield 1
        raise ValueError("decoder failed")
    it = PS._pipeline_prefetch(source())
    assert next(it) == 1
    with pytest.raises(ValueError, match="decoder failed"):
        next(it)


def test_a_scan_error_reaches_collect(tmp_path):
    bad = tmp_path / "bad.parquet"
    bad.write_bytes(b"not parquet at all")
    with pytest.raises(pa.ArrowInvalid):
        pt.scan_parquet(str(bad), device="cpu").collect(engine="streaming")


# ---------------------------------------------------------------------------
# sources, remote()
# ---------------------------------------------------------------------------

def test_io_sources_defer_and_datasets():
    import pyarrow.dataset as pads

    def src(with_columns, predicate, n_rows, batch_size):
        yield pt.DataFrame({"a": [1, 2]}, device="cpu")
        yield pt.DataFrame({"a": [3]}, device="cpu")
    lf = pt.register_io_source(src, schema={"a": pt.Int64}, device="cpu")
    assert lf.collect().to_dict() == {"a": [1, 2, 3]}
    d = pt.defer(lambda: pt.DataFrame({"x": [1.5]}, device="cpu"),
                 schema={"x": pt.Float64}, device="cpu")
    assert d.collect().to_dict() == {"x": [1.5]}
    bad = pt.defer(lambda: pt.DataFrame({"x": [1]}, device="cpu"),
                   schema={"x": pt.Float64}, device="cpu")
    with pytest.raises(pt.SchemaError):
        bad.collect()
    ds = pads.dataset(SCAN)
    got = pt.scan_pyarrow_dataset(ds, device="cpu").filter(
        pt.col("day") == 3).collect()
    want = ref.scan_pyarrow_dataset(ds).filter(ref.col("day") == 3).collect()
    _same_frames(got, want)


def test_remote_without_a_context_is_the_distributed_collect():
    from polaroid_tpu_torch.exec import distributed as D
    from polaroid_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(8, device="cpu")
    lf = pt.from_arrow(SCAN, device="cpu").lazy().group_by("symbol").agg(
        pt.col("volume").sum().alias("v")).sort("symbol")
    D.reset_counts()
    got = lf.remote().collect(mesh=mesh)
    routes = dict(D.ROUTES)
    assert routes and D.COUNTS["dropped"] == 0
    D.reset_counts()
    assert got.to_dict() == lf.collect(engine="distributed",
                                       mesh=mesh).to_dict()
    assert dict(D.ROUTES) == routes
    assert got.to_dict() == lf.collect().to_dict()
    assert lf.remote().show(3).height == 3
    # a context is a server (tests/test_torch_server.py): where none
    # listens, the call fails rather than running on the engine here
    import grpc
    with pytest.raises(grpc.RpcError):
        lf.remote("127.0.0.1:1").collect()


def test_remote_files_through_fsspec_memory(tmp_path, monkeypatch):
    monkeypatch.setenv("PT_FILE_CACHE", "0")
    tdf = pt.from_arrow(SCAN.slice(0, 100), device="cpu")
    tdf.write_parquet("memory://pt_io/t.parquet")
    _same_frames(pt.read_parquet("memory://pt_io/t.parquet", device="cpu"),
                 ref.read_parquet("memory://pt_io/t.parquet"))
    got = pt.scan_parquet("memory://pt_io/t.parquet", device="cpu") \
        .filter(pt.col("day") == 2).collect(engine="streaming")
    _same_frames(got, ref.scan_parquet("memory://pt_io/t.parquet")
                 .filter(ref.col("day") == 2).collect())
