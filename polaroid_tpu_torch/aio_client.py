"""Async remote DataFrame client (grpc.aio).

The port of the JAX package's `aio_client.py`: the same handle-based
surface as `client.py`, awaitable, for many requests in flight at once.
`collect()` builds the frame on the client's device
(`AsyncRemoteClient(device=...)`, CUDA unless the caller asks for the
CPU).
"""

from __future__ import annotations

import io
import json
from typing import Dict, List

from .batch import resolve_device
from .client import (_CHANNEL_OPTIONS, _SERVICE, _frame_of_ipc, _to_exprs)
from .expr.serde import exprs_to_obj


class AsyncRemoteClient:
    def __init__(self, address: str = "localhost:50051", device=None):
        import grpc.aio
        from .server import polaroid_pb2 as pb
        self.device = resolve_device(device)
        self._pb = pb
        self._channel = grpc.aio.insecure_channel(
            address, options=_CHANNEL_OPTIONS)
        self._stubs: Dict[str, object] = {}

    def _unary(self, name, req_t, resp_t):
        if name not in self._stubs:
            self._stubs[name] = self._channel.unary_unary(
                f"/{_SERVICE}/{name}",
                request_serializer=req_t.SerializeToString,
                response_deserializer=resp_t.FromString)
        return self._stubs[name]

    async def _call(self, name, req, resp_t):
        return await self._unary(name, type(req), resp_t)(req)

    async def read_parquet(self, path: str, columns=None, n_rows: int = 0
                           ) -> "AsyncRemoteFrame":
        pb = self._pb
        resp = await self._call("ReadFile", pb.ReadFileRequest(
            path=path, format="parquet", columns=list(columns or []),
            n_rows=n_rows), pb.HandleResponse)
        return AsyncRemoteFrame(self, resp.handle, json.loads(resp.schema_json))

    async def sql(self, query: str) -> "AsyncRemoteFrame":
        pb = self._pb
        resp = await self._call("Sql", pb.SqlRequest(query=query),
                                pb.HandleResponse)
        return AsyncRemoteFrame(self, resp.handle, json.loads(resp.schema_json))

    async def heartbeat(self) -> dict:
        pb = self._pb
        r = await self._call("Heartbeat", pb.HeartbeatRequest(client_id="aio"),
                             pb.HeartbeatResponse)
        return {"ok": r.ok, "active_handles": r.active_handles}

    async def close(self):
        await self._channel.close()


class AsyncRemoteFrame:
    def __init__(self, client: AsyncRemoteClient, handle: str,
                 schema: Dict[str, str]):
        self._c = client
        self.handle = handle
        self._schema = schema

    @property
    def columns(self) -> List[str]:
        return list(self._schema)

    def _wrap(self, resp) -> "AsyncRemoteFrame":
        return AsyncRemoteFrame(self._c, resp.handle,
                                json.loads(resp.schema_json))

    async def _exprs_op(self, rpc: str, exprs) -> "AsyncRemoteFrame":
        pb = self._c._pb
        resp = await self._c._call(rpc, pb.ExprOpRequest(
            handle=self.handle,
            exprs_json=json.dumps(exprs_to_obj(_to_exprs(exprs)))),
            pb.HandleResponse)
        return self._wrap(resp)

    async def filter(self, *predicates) -> "AsyncRemoteFrame":
        return await self._exprs_op("Filter", predicates)

    async def select(self, *exprs) -> "AsyncRemoteFrame":
        return await self._exprs_op("Select", exprs)

    async def group_by_agg(self, keys, aggs,
                           maintain_order: bool = False) -> "AsyncRemoteFrame":
        pb = self._c._pb
        resp = await self._c._call("GroupByAgg", pb.GroupByRequest(
            handle=self.handle,
            keys_json=json.dumps(exprs_to_obj(_to_exprs(keys))),
            aggs_json=json.dumps(exprs_to_obj(_to_exprs(aggs))),
            maintain_order=maintain_order), pb.HandleResponse)
        return self._wrap(resp)

    async def head(self, n: int = 5) -> "AsyncRemoteFrame":
        pb = self._c._pb
        resp = await self._c._call("Slice", pb.SliceRequest(
            handle=self.handle, offset=0, length=n), pb.HandleResponse)
        return self._wrap(resp)

    async def collect(self):
        pb = self._c._pb
        stub = self._c._channel.unary_stream(
            f"/{_SERVICE}/Collect",
            request_serializer=pb.HandleRequest.SerializeToString,
            response_deserializer=pb.ArrowBatch.FromString)
        buf = io.BytesIO()
        async for msg in stub(pb.HandleRequest(handle=self.handle)):
            buf.write(msg.data)
        return _frame_of_ipc(buf, self._c.device)

    async def release(self) -> None:
        pb = self._c._pb
        await self._c._call("ReleaseHandle",
                            pb.HandleRequest(handle=self.handle),
                            pb.StatusResponse)


def connect_async(address: str = "localhost:50051",
                  device=None) -> AsyncRemoteClient:
    return AsyncRemoteClient(address, device=device)
