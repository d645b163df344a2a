"""Remote DataFrame client (gRPC).

The port of the JAX package's `client.py`: handle-based lazy remote
frames; `.collect()` streams Arrow IPC back into a local DataFrame on
the client's device (`RemoteClient(device=...)`, CUDA unless the caller
asks for the CPU). It speaks the same messages as the JAX package's
server and client, so either side may be either package. grpc and
pyarrow are imported when a client is made and when rows cross the wire.
Async variant in `aio_client.py`.
"""

from __future__ import annotations

import io
import json
from typing import Dict, List, Optional

from .batch import resolve_device
from .expr.serde import exprs_to_obj
from .expr.expr import Expr, col as _col

_SERVICE = "polaroid.DataFrameService"
_CHANNEL_OPTIONS = [("grpc.max_receive_message_length", 64 << 20),
                    ("grpc.max_send_message_length", 64 << 20)]


def _to_exprs(args) -> List[Expr]:
    out = []
    for a in args:
        if isinstance(a, Expr):
            out.append(a)
        elif isinstance(a, str):
            out.append(_col(a))
        else:
            from .expr.expr import lit
            out.append(lit(a))
    return out


def _ipc_bytes(df) -> bytes:
    """A frame as one Arrow IPC stream (compacted on its device first)."""
    import pyarrow as pa
    at = df.to_arrow()
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, at.schema) as w:
        for b in at.to_batches(max_chunksize=65536):
            w.write_batch(b)
    return sink.getvalue()


def _frame_of_ipc(buf: io.BytesIO, device):
    """The frame of a Collect stream's bytes, on `device`."""
    import pyarrow as pa
    from .api.frame import DataFrame
    buf.seek(0)
    if buf.getbuffer().nbytes == 0:
        return DataFrame(device=device)
    with pa.ipc.open_stream(buf) as r:
        at = r.read_all()
    return DataFrame(at, device=device)


class RemoteClient:
    def __init__(self, address: str = "localhost:50051",
                 channel=None, device=None):
        import grpc
        from .server import polaroid_pb2 as pb
        self.device = resolve_device(device)
        self._pb = pb
        self._channel = channel or grpc.insecure_channel(
            address, options=_CHANNEL_OPTIONS)
        self._stubs = {}

    def _unary(self, name, req_t, resp_t):
        key = name
        if key not in self._stubs:
            self._stubs[key] = self._channel.unary_unary(
                f"/{_SERVICE}/{name}",
                request_serializer=req_t.SerializeToString,
                response_deserializer=resp_t.FromString)
        return self._stubs[key]

    def _call(self, name, req, resp_t):
        return self._unary(name, type(req), resp_t)(req)

    # --- entry points ---------------------------------------------------
    def read_parquet(self, path: str, columns=None, n_rows: int = 0,
                     **options) -> "RemoteFrame":
        return self._read(path, "parquet", columns, n_rows, options)

    def read_csv(self, path: str, columns=None, n_rows: int = 0,
                 **options) -> "RemoteFrame":
        return self._read(path, "csv", columns, n_rows, options)

    def read_ipc(self, path: str, columns=None, n_rows: int = 0) -> "RemoteFrame":
        return self._read(path, "ipc", columns, n_rows, {})

    def read_ndjson(self, path: str, n_rows: int = 0) -> "RemoteFrame":
        return self._read(path, "ndjson", None, n_rows, {})

    def _read(self, path, fmt, columns, n_rows, options) -> "RemoteFrame":
        pb = self._pb
        resp = self._call("ReadFile", pb.ReadFileRequest(
            path=path, format=fmt, columns=list(columns or []),
            n_rows=n_rows, options_json=json.dumps(options) if options else ""),
            pb.HandleResponse)
        return RemoteFrame(self, resp.handle, json.loads(resp.schema_json))

    def sql(self, query: str) -> "RemoteFrame":
        pb = self._pb
        resp = self._call("Sql", pb.SqlRequest(query=query), pb.HandleResponse)
        return RemoteFrame(self, resp.handle, json.loads(resp.schema_json))

    def execute_plan(self, lf) -> "RemoteFrame":
        """Ship a locally-built LazyFrame's plan to the server."""
        from .plan.serde import plan_to_dict
        pb = self._pb
        resp = self._call("ExecutePlan", pb.PlanRequest(
            plan_json=json.dumps(plan_to_dict(lf._plan))), pb.HandleResponse)
        return RemoteFrame(self, resp.handle, json.loads(resp.schema_json))

    def upload(self, df) -> "RemoteFrame":
        pb = self._pb
        data = _ipc_bytes(df)

        def gen():
            step = 1 << 20
            for off in range(0, max(len(data), 1), step):
                yield pb.ArrowBatch(data=data[off:off + step],
                                    last=off + step >= len(data))
        stub = self._channel.stream_unary(
            f"/{_SERVICE}/Upload",
            request_serializer=pb.ArrowBatch.SerializeToString,
            response_deserializer=pb.HandleResponse.FromString)
        resp = stub(gen())
        return RemoteFrame(self, resp.handle, json.loads(resp.schema_json))

    def heartbeat(self) -> dict:
        pb = self._pb
        r = self._call("Heartbeat", pb.HeartbeatRequest(client_id="py"),
                       pb.HeartbeatResponse)
        return {"ok": r.ok, "server_time_ms": r.server_time_ms,
                "active_handles": r.active_handles}

    def list_handles(self) -> List[str]:
        pb = self._pb
        return list(self._call("ListHandles", pb.HandleRequest(handle=""),
                               pb.ListHandlesResponse).handles)

    def close(self):
        self._channel.close()


class RemoteFrame:
    """A lazy frame living on the server, addressed by handle."""

    def __init__(self, client: RemoteClient, handle: str,
                 schema: Dict[str, str]):
        self._c = client
        self.handle = handle
        self._schema = schema

    @property
    def schema(self) -> Dict[str, str]:
        return dict(self._schema)

    @property
    def columns(self) -> List[str]:
        return list(self._schema)

    def _wrap(self, resp) -> "RemoteFrame":
        return RemoteFrame(self._c, resp.handle, json.loads(resp.schema_json))

    def _exprs_op(self, rpc: str, exprs) -> "RemoteFrame":
        pb = self._c._pb
        resp = self._c._call(rpc, pb.ExprOpRequest(
            handle=self.handle,
            exprs_json=json.dumps(exprs_to_obj(_to_exprs(exprs)))),
            pb.HandleResponse)
        return self._wrap(resp)

    def filter(self, *predicates) -> "RemoteFrame":
        return self._exprs_op("Filter", predicates)

    def select(self, *exprs) -> "RemoteFrame":
        return self._exprs_op("Select", exprs)

    def with_columns(self, *exprs) -> "RemoteFrame":
        return self._exprs_op("WithColumns", exprs)

    def group_by(self, *keys, maintain_order: bool = False) -> "RemoteGroupBy":
        return RemoteGroupBy(self, _to_exprs(keys), maintain_order)

    def join(self, other: "RemoteFrame", on=None, how: str = "inner", *,
             left_on=None, right_on=None, suffix: str = "_right",
             join_nulls: bool = False) -> "RemoteFrame":
        pb = self._c._pb
        if on is not None:
            left_on = right_on = [on] if isinstance(on, str) else list(on)
        resp = self._c._call("Join", pb.JoinRequest(
            left=self.handle, right=other.handle,
            left_on=list(left_on or []), right_on=list(right_on or []),
            how=how, suffix=suffix, join_nulls=join_nulls), pb.HandleResponse)
        return self._wrap(resp)

    def sort(self, by, *more_by, descending=False, nulls_last=False
             ) -> "RemoteFrame":
        pb = self._c._pb
        keys = _to_exprs((by,) + more_by)
        nk = len(keys)
        desc = descending if isinstance(descending, (list, tuple)) \
            else [descending] * nk
        nl = nulls_last if isinstance(nulls_last, (list, tuple)) \
            else [nulls_last] * nk
        resp = self._c._call("Sort", pb.SortRequest(
            handle=self.handle, by_json=json.dumps(exprs_to_obj(keys)),
            descending=list(desc), nulls_last=list(nl)), pb.HandleResponse)
        return self._wrap(resp)

    def head(self, n: int = 5) -> "RemoteFrame":
        return self.slice(0, n)

    def limit(self, n: int = 5) -> "RemoteFrame":
        return self.slice(0, n)

    def slice(self, offset: int, length: Optional[int] = None) -> "RemoteFrame":
        pb = self._c._pb
        resp = self._c._call("Slice", pb.SliceRequest(
            handle=self.handle, offset=offset,
            length=-1 if length is None else length), pb.HandleResponse)
        return self._wrap(resp)

    def unique(self, subset=None, keep: str = "any",
               maintain_order: bool = False) -> "RemoteFrame":
        pb = self._c._pb
        sub = [subset] if isinstance(subset, str) else list(subset or [])
        resp = self._c._call("Unique", pb.UniqueRequest(
            handle=self.handle, subset=sub, keep=keep,
            maintain_order=maintain_order), pb.HandleResponse)
        return self._wrap(resp)

    def rename(self, mapping: Dict[str, str]) -> "RemoteFrame":
        pb = self._c._pb
        resp = self._c._call("Rename", pb.RenameRequest(
            handle=self.handle, mapping_json=json.dumps(mapping)),
            pb.HandleResponse)
        return self._wrap(resp)

    def count_rows(self) -> int:
        pb = self._c._pb
        return self._c._call("CountRows", pb.HandleRequest(handle=self.handle),
                             pb.HandleResponse).num_rows

    def collect(self):
        """Stream the materialized frame back as a DataFrame on the
        client's device."""
        pb = self._c._pb
        stub = self._c._channel.unary_stream(
            f"/{_SERVICE}/Collect",
            request_serializer=pb.HandleRequest.SerializeToString,
            response_deserializer=pb.ArrowBatch.FromString)
        buf = io.BytesIO()
        for msg in stub(pb.HandleRequest(handle=self.handle)):
            buf.write(msg.data)
        return _frame_of_ipc(buf, self._c.device)

    def to_pandas(self):
        return self.collect().to_pandas()

    def release(self) -> None:
        pb = self._c._pb
        self._c._call("ReleaseHandle", pb.HandleRequest(handle=self.handle),
                      pb.StatusResponse)

    def __repr__(self):
        return f"RemoteFrame({self.handle[:8]}…, cols={self.columns})"


class RemoteGroupBy:
    def __init__(self, frame: RemoteFrame, keys: List[Expr],
                 maintain_order: bool):
        self._f = frame
        self._keys = keys
        self._maintain_order = maintain_order

    def agg(self, *aggs) -> RemoteFrame:
        pb = self._f._c._pb
        resp = self._f._c._call("GroupByAgg", pb.GroupByRequest(
            handle=self._f.handle,
            keys_json=json.dumps(exprs_to_obj(self._keys)),
            aggs_json=json.dumps(exprs_to_obj(_to_exprs(aggs))),
            maintain_order=self._maintain_order), pb.HandleResponse)
        return self._f._wrap(resp)


def connect(address: str = "localhost:50051", device=None) -> RemoteClient:
    return RemoteClient(address, device=device)
