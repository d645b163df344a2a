"""gRPC DataFrame service.

The port of the JAX package's `server/service.py`: handle-based remote
frames over gRPC with Arrow IPC streaming at Collect/Upload, the same 19
RPCs over the same messages (`polaroid_pb2`, the same descriptor), so a
client of either package talks to a server of either. Service
registration uses grpc generic handlers over protoc-generated messages
(no grpc_tools codegen needed).

Frame ops stay LAZY server-side (a handle wraps a LazyFrame); the plan
executes only at Collect/CountRows. Every frame the service builds lives
on its device (`DataFrameService(device=...)`, CUDA unless the caller
asks for the CPU): file scans, the in-memory frames of a shipped plan,
uploads. A plan executes under the process's lock
(`handles.EXEC_LOCK`), so concurrent requests give what a sequential
run gives; decoding, building uploaded frames, IPC framing and the wire
run on the worker threads at once. An error in a request, a CUDA out-of-memory error included,
comes back as its status: the server goes on, and nothing is retried on
another device.
"""

from __future__ import annotations

import io
import json
import time
from concurrent import futures
from typing import Iterator, Optional

import grpc

from . import polaroid_pb2 as pb
from .handles import EXEC_LOCK, HandleManager
from ..batch import resolve_device
from ..errors import PolaroidError

_SERVICE = "polaroid.DataFrameService"
_CHUNK_ROWS = 65536


class DataFrameService:
    def __init__(self, ttl_s: float = 3600.0, device=None):
        self.device = resolve_device(device)
        self.handles = HandleManager(ttl_s)
        self.started = time.time()

    # --- helpers --------------------------------------------------------
    def _lazy(self, handle: str):
        lf = self.handles.get(handle)
        from ..api.frame import DataFrame
        if isinstance(lf, DataFrame):
            return lf.lazy()
        return lf

    def _register(self, lf) -> pb.HandleResponse:
        h = self.handles.create(lf)
        schema = {k: repr(v) for k, v in lf.schema.items()}
        return pb.HandleResponse(handle=h, num_rows=-1,
                                 schema_json=json.dumps(schema))

    def _collect(self, handle: str):
        lf = self._lazy(handle)
        with EXEC_LOCK:
            return lf.collect()

    # --- RPC implementations --------------------------------------------
    def ReadFile(self, req: pb.ReadFileRequest, ctx) -> pb.HandleResponse:
        from ..api.io import scan_csv, scan_ipc, scan_ndjson, scan_parquet
        opts = json.loads(req.options_json) if req.options_json else {}
        scan = {"parquet": scan_parquet, "csv": scan_csv, "ipc": scan_ipc,
                "ndjson": scan_ndjson}.get(req.format or "parquet")
        if scan is None:
            raise PolaroidError(f"unknown format {req.format!r}")
        lf = scan(req.path, n_rows=req.n_rows or None, device=self.device,
                  **opts)
        if req.columns:
            lf = lf.select(list(req.columns))
        return self._register(lf)

    def Sql(self, req: pb.SqlRequest, ctx) -> pb.HandleResponse:
        from ..sql.context import SQLContext
        sctx = SQLContext(device=self.device)
        for h in self.handles.list():
            try:
                sctx.register(f"h_{h.replace('-', '')}", self.handles.get(h))
            except Exception:
                pass
        # also allow read_parquet()-style table functions in the query
        lf = sctx.execute(req.query)
        return self._register(lf)

    def ExecutePlan(self, req: pb.PlanRequest, ctx) -> pb.HandleResponse:
        """Ship a whole serialized lazy plan (the cloud-plan parity hook):
        its scans and in-memory frames land on the service's device."""
        from ..api.lazyframe import LazyFrame
        from ..plan.serde import plan_from_dict
        plan = plan_from_dict(json.loads(req.plan_json), self.device)
        return self._register(LazyFrame._from_plan(plan))

    def Filter(self, req: pb.ExprOpRequest, ctx) -> pb.HandleResponse:
        from ..expr.serde import exprs_from_obj
        exprs = exprs_from_obj(json.loads(req.exprs_json))
        lf = self._lazy(req.handle)
        for e in exprs:
            lf = lf.filter(e)
        return self._register(lf)

    def Select(self, req: pb.ExprOpRequest, ctx) -> pb.HandleResponse:
        from ..expr.serde import exprs_from_obj
        exprs = exprs_from_obj(json.loads(req.exprs_json))
        return self._register(self._lazy(req.handle).select(exprs))

    def WithColumns(self, req: pb.ExprOpRequest, ctx) -> pb.HandleResponse:
        from ..expr.serde import exprs_from_obj
        exprs = exprs_from_obj(json.loads(req.exprs_json))
        return self._register(self._lazy(req.handle).with_columns(exprs))

    def GroupByAgg(self, req: pb.GroupByRequest, ctx) -> pb.HandleResponse:
        from ..expr.serde import exprs_from_obj
        keys = exprs_from_obj(json.loads(req.keys_json))
        aggs = exprs_from_obj(json.loads(req.aggs_json))
        lf = self._lazy(req.handle)
        return self._register(
            lf.group_by(keys, maintain_order=req.maintain_order).agg(aggs))

    def Join(self, req: pb.JoinRequest, ctx) -> pb.HandleResponse:
        lf = self._lazy(req.left)
        rf = self._lazy(req.right)
        out = lf.join(rf, left_on=list(req.left_on) or None,
                      right_on=list(req.right_on) or None,
                      how=req.how or "inner",
                      suffix=req.suffix or "_right",
                      join_nulls=req.join_nulls)
        return self._register(out)

    def Sort(self, req: pb.SortRequest, ctx) -> pb.HandleResponse:
        from ..expr.serde import exprs_from_obj
        by = exprs_from_obj(json.loads(req.by_json))
        lf = self._lazy(req.handle)
        desc = list(req.descending) or False
        nl = list(req.nulls_last) or False
        return self._register(lf.sort(by, descending=desc, nulls_last=nl))

    def Slice(self, req: pb.SliceRequest, ctx) -> pb.HandleResponse:
        length = None if req.length < 0 else req.length
        return self._register(self._lazy(req.handle).slice(req.offset, length))

    def Unique(self, req: pb.UniqueRequest, ctx) -> pb.HandleResponse:
        return self._register(self._lazy(req.handle).unique(
            subset=list(req.subset) or None, keep=req.keep or "any",
            maintain_order=req.maintain_order))

    def Rename(self, req: pb.RenameRequest, ctx) -> pb.HandleResponse:
        return self._register(
            self._lazy(req.handle).rename(json.loads(req.mapping_json)))

    def GetSchema(self, req: pb.HandleRequest, ctx) -> pb.SchemaResponse:
        lf = self._lazy(req.handle)
        schema = {k: repr(v) for k, v in lf.schema.items()}
        return pb.SchemaResponse(schema_json=json.dumps(schema))

    def CountRows(self, req: pb.HandleRequest, ctx) -> pb.HandleResponse:
        df = self._collect(req.handle)
        return pb.HandleResponse(handle=req.handle, num_rows=df.height,
                                 schema_json=json.dumps(
                                     {k: repr(v) for k, v in df.schema.items()}))

    def Collect(self, req: pb.HandleRequest, ctx) -> Iterator[pb.ArrowBatch]:
        """The result as one Arrow IPC stream (batches of 65,536 rows,
        the schema even for no rows), framed into 1 MiB messages. The
        plan runs and `to_arrow` compacts on the device, under
        EXEC_LOCK; the IPC encoding runs after."""
        import pyarrow as pa
        lf = self._lazy(req.handle)
        with EXEC_LOCK:
            at = lf.collect().to_arrow()
        del lf
        sink = io.BytesIO()
        with pa.ipc.new_stream(sink, at.schema) as w:
            for batch in at.to_batches(max_chunksize=_CHUNK_ROWS):
                w.write_batch(batch)
        del at
        data = sink.getvalue()
        # frame into ~1MB gRPC messages
        step = 1 << 20
        for off in range(0, max(len(data), 1), step):
            chunk = data[off:off + step]
            yield pb.ArrowBatch(data=chunk, last=off + step >= len(data))

    def Upload(self, request_iterator, ctx) -> pb.HandleResponse:
        import pyarrow as pa
        buf = io.BytesIO()
        for msg in request_iterator:
            buf.write(msg.data)
        buf.seek(0)
        with pa.ipc.open_stream(buf) as r:
            at = r.read_all()
        from ..api.frame import DataFrame
        return self._register(DataFrame(at, device=self.device).lazy())

    def ReleaseHandle(self, req: pb.HandleRequest, ctx) -> pb.StatusResponse:
        ok = self.handles.release(req.handle)
        return pb.StatusResponse(ok=ok, message="" if ok else "not found")

    def ListHandles(self, req: pb.HandleRequest, ctx) -> pb.ListHandlesResponse:
        return pb.ListHandlesResponse(handles=self.handles.list())

    def Heartbeat(self, req: pb.HeartbeatRequest, ctx) -> pb.HeartbeatResponse:
        return pb.HeartbeatResponse(ok=True,
                                    server_time_ms=int(time.time() * 1000),
                                    active_handles=len(self.handles))


_RPCS = {
    "ReadFile": (pb.ReadFileRequest, pb.HandleResponse, "unary"),
    "Sql": (pb.SqlRequest, pb.HandleResponse, "unary"),
    "ExecutePlan": (pb.PlanRequest, pb.HandleResponse, "unary"),
    "Filter": (pb.ExprOpRequest, pb.HandleResponse, "unary"),
    "Select": (pb.ExprOpRequest, pb.HandleResponse, "unary"),
    "WithColumns": (pb.ExprOpRequest, pb.HandleResponse, "unary"),
    "GroupByAgg": (pb.GroupByRequest, pb.HandleResponse, "unary"),
    "Join": (pb.JoinRequest, pb.HandleResponse, "unary"),
    "Sort": (pb.SortRequest, pb.HandleResponse, "unary"),
    "Slice": (pb.SliceRequest, pb.HandleResponse, "unary"),
    "Unique": (pb.UniqueRequest, pb.HandleResponse, "unary"),
    "Rename": (pb.RenameRequest, pb.HandleResponse, "unary"),
    "GetSchema": (pb.HandleRequest, pb.SchemaResponse, "unary"),
    "CountRows": (pb.HandleRequest, pb.HandleResponse, "unary"),
    "Collect": (pb.HandleRequest, pb.ArrowBatch, "server_stream"),
    "Upload": (pb.ArrowBatch, pb.HandleResponse, "client_stream"),
    "ReleaseHandle": (pb.HandleRequest, pb.StatusResponse, "unary"),
    "ListHandles": (pb.HandleRequest, pb.ListHandlesResponse, "unary"),
    "Heartbeat": (pb.HeartbeatRequest, pb.HeartbeatResponse, "unary"),
}


def _wrap(fn):
    """A port error as INVALID_ARGUMENT, any other as INTERNAL (a
    streaming RPC's errors rise in its generator, outside this)."""
    def handler(req, ctx):
        try:
            return fn(req, ctx)
        except PolaroidError as e:
            ctx.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        except Exception as e:
            ctx.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")
    return handler


def make_server(service: Optional[DataFrameService] = None,
                max_workers: int = 8, device=None) -> grpc.Server:
    """A gRPC server (not started, no port yet) over `service`, else a
    new `DataFrameService(device=device)`."""
    svc = service or DataFrameService(device=device)
    handlers = {}
    for name, (req_t, resp_t, kind) in _RPCS.items():
        fn = _wrap(getattr(svc, name))
        if kind == "unary":
            h = grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=req_t.FromString,
                response_serializer=resp_t.SerializeToString)
        elif kind == "server_stream":
            h = grpc.unary_stream_rpc_method_handler(
                fn, request_deserializer=req_t.FromString,
                response_serializer=resp_t.SerializeToString)
        else:
            h = grpc.stream_unary_rpc_method_handler(
                fn, request_deserializer=req_t.FromString,
                response_serializer=resp_t.SerializeToString)
        handlers[name] = h
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers),
                         options=[("grpc.max_receive_message_length", 64 << 20),
                                  ("grpc.max_send_message_length", 64 << 20)])
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_SERVICE, handlers),))
    server._polaroid_service = svc  # for tests/introspection
    return server


def serve(bind: str = "0.0.0.0:50051",
          http_bind: Optional[str] = "0.0.0.0:9000",
          block: bool = True, device=None):
    """Start gRPC (+ optional HTTP /exec) servers over one service on
    `device` (CUDA unless the caller asks for the CPU)."""
    import os
    bind = os.environ.get("PT_BIND_ADDRESS", bind)
    server = make_server(device=device)
    port = server.add_insecure_port(bind)
    server.start()
    httpd = None
    if http_bind:
        from .http_api import start_http
        http_bind = os.environ.get("PT_HTTP_BIND_ADDRESS", http_bind)
        host, p = http_bind.rsplit(":", 1)
        httpd = start_http(host, int(p), server._polaroid_service)
    if block:
        server.wait_for_termination()
    return server, port, httpd
