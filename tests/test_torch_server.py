"""The port's gRPC server, clients and HTTP /exec against the JAX
package's, on the CPU over real sockets on 127.0.0.1.

One server of each package runs for the module (the port's on the CPU).
The same script of requests, one for every RPC of `_RPCS`, goes to both
from each package's client: the four pairings of client and server
return the same frames (keys, integers, strings and nulls exactly,
Float64 within rtol 1e-12), schemas, counts and statuses. The port's
generated messages carry the reference's descriptor byte for byte. Bad
requests give the same status code RPC by RPC; a CUDA out-of-memory
error in a request comes back as INTERNAL and the server goes on.
/exec answers with the reference's JSON. The async client, 8 threads on
one handle against a sequential run, and `LazyFrame.remote(context)`
by client and by address string complete the file.
"""

import asyncio
import concurrent.futures as futures
import json
import math
import urllib.error
import urllib.parse
import urllib.request

import grpc
import numpy as np
import pytest
import torch

import polaroid_tpu as ref
import polaroid_tpu_torch as pt


@pytest.fixture(autouse=True, scope="module")
def _fresh_reference_cache():
    """The JAX package's process-wide caches can hand this file's plans
    another frame's results (`tests/test_torch_reference_caches.py`)."""
    from test_torch_reference_caches import fresh_reference_caches
    with fresh_reference_caches():
        yield


def _start(server):
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return server, port


@pytest.fixture(scope="module")
def servers():
    from polaroid_tpu.server.service import make_server as ref_make
    from polaroid_tpu_torch.server.service import make_server as pt_make
    out = {"ref": _start(ref_make()), "pt": _start(pt_make(device="cpu"))}
    yield out
    for server, _ in out.values():
        server.stop(0)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One small frame (Int64 key, Float64 with NaN-free values, a
    String with nulls, a Boolean) in Parquet, CSV, IPC and NDJSON,
    written by the JAX package."""
    d = tmp_path_factory.mktemp("srv")
    rng = np.random.default_rng(17)
    n = 300
    s = rng.choice(["a", "bb", "ccc"], n).astype(object)
    s[rng.random(n) < 0.1] = None
    df = ref.DataFrame({"k": rng.integers(0, 6, n), "v": rng.uniform(0, 10, n),
                        "s": s.tolist(), "b": (rng.random(n) < 0.5).tolist()})
    out = {"parquet": str(d / "t.parquet"), "csv": str(d / "t.csv"),
           "ipc": str(d / "t.arrow"), "ndjson": str(d / "t.ndjson")}
    df.write_parquet(out["parquet"])
    df.write_csv(out["csv"])
    df.write_ipc(out["ipc"])
    df.write_ndjson(out["ndjson"])
    return out


PKGS = {"ref": ref, "pt": pt}


def _client(side: str, port: int):
    if side == "ref":
        from polaroid_tpu.client import connect
        return connect(f"127.0.0.1:{port}")
    from polaroid_tpu_torch.client import connect
    return connect(f"127.0.0.1:{port}", device="cpu")


def _canon(df):
    """A collected frame as (columns, schema, rows sorted): rows as
    tuples with None for null, so results in any row order compare."""
    d = df.to_dict()
    cols = list(d)
    rows = list(zip(*d.values())) if cols else []
    key = [tuple((v is None, "" if v is None else str(v)) for v in r)
           for r in rows]
    rows = [r for _, r in sorted(zip(key, rows), key=lambda kr: kr[0])]
    return cols, {k: repr(v) for k, v in df.schema.items()}, rows


def _same(got, want, what):
    gc, gs, gr = got
    wc, ws, wr = want
    assert gc == wc and gs == ws, (what, gc, gs, wc, ws)
    assert len(gr) == len(wr), (what, len(gr), len(wr))
    for g, w in zip(gr, wr):
        for a, b in zip(g, w):
            if isinstance(b, float) and not math.isnan(b):
                assert a is not None and abs(a - b) <= 1e-12 * abs(b), \
                    (what, g, w)
            else:
                assert a == b or (a != a and b != b), (what, g, w)


def _script(client, pkg, files, lazy_plan):
    """Every RPC of `_RPCS` once or more through `client`; the frames
    collected, the schemas, counts and statuses returned."""
    c = pkg.col
    pb = client._pb
    out = {}
    rf = client.read_parquet(files["parquet"])
    out["schema"] = rf.schema
    out["parquet"] = _canon(rf.collect())
    out["csv"] = _canon(client.read_csv(files["csv"]).collect())
    out["ipc"] = _canon(client.read_ipc(files["ipc"], columns=["k", "s"])
                        .collect())
    out["ndjson"] = _canon(client.read_ndjson(files["ndjson"]).collect())
    out["filter"] = _canon(rf.filter(c("v") > 5.0, c("b")).collect())
    out["select"] = _canon(rf.select((c("v") * 2).alias("v2"), "s")
                           .collect())
    wc = rf.with_columns((c("k") + 1).alias("k1"))
    out["with_columns"] = _canon(wc.collect())
    out["group_by"] = _canon(rf.group_by("k", "s").agg(
        c("v").sum().alias("sv"), pkg.len().alias("n")).collect())
    dim = client.upload(pkg.DataFrame({"k": [0, 1, 2, 3, 4],
                                       "name": ["z", "y", None, "w", "v"]},
                                      **({"device": "cpu"} if pkg is pt
                                         else {})))
    out["upload"] = _canon(dim.collect())
    out["join"] = _canon(rf.join(dim, on="k", how="left").collect())
    out["sort"] = rf.sort("k", "v", descending=[True, False]) \
        .select("k", "v").collect().to_dict()
    out["slice"] = rf.sort("v").slice(10, 5).collect().to_dict()
    out["head"] = rf.sort("v").head(3).collect().to_dict()
    out["unique"] = _canon(rf.unique(subset=["k", "s"], keep="first",
                                     maintain_order=True)
                           .select("k", "s").collect())
    out["rename"] = _canon(rf.rename({"v": "value"}).select("value")
                           .collect())
    out["get_schema"] = json.loads(client._call(
        "GetSchema", pb.HandleRequest(handle=wc.handle),
        pb.SchemaResponse).schema_json)
    out["count_rows"] = rf.filter(c("k") > 2).count_rows()
    out["sql"] = _canon(client.sql(
        f"SELECT k, COUNT(*) AS n FROM read_parquet('{files['parquet']}') "
        "GROUP BY k ORDER BY k").collect())
    out["plan"] = _canon(client.execute_plan(lazy_plan).collect())
    handles = client.list_handles()
    out["listed"] = dim.handle in handles and rf.handle in handles
    st = client._call("ReleaseHandle", pb.HandleRequest(handle=dim.handle),
                      pb.StatusResponse)
    st2 = client._call("ReleaseHandle", pb.HandleRequest(handle=dim.handle),
                       pb.StatusResponse)
    out["release"] = (st.ok, st.message, st2.ok, st2.message)
    out["released_listed"] = dim.handle in client.list_handles()
    hb = client.heartbeat()
    out["heartbeat"] = hb["ok"] and hb["active_handles"] >= 1
    return out


def _plan(pkg, files):
    kw = {"device": "cpu"} if pkg is pt else {}
    return (pkg.scan_parquet(files["parquet"], **kw)
            .filter(pkg.col("v") > 3.0)
            .group_by("k").agg(pkg.col("v").mean().alias("m"),
                               pkg.len().alias("n")))


@pytest.fixture(scope="module")
def runs(servers, files):
    """The script through each client to each server."""
    out = {}
    for cside in ("ref", "pt"):
        for sside in ("ref", "pt"):
            client = _client(cside, servers[sside][1])
            try:
                out[(cside, sside)] = _script(client, PKGS[cside], files,
                                              _plan(PKGS[cside], files))
            finally:
                client.close()
    return out


def test_descriptor_is_the_references():
    from polaroid_tpu.server import polaroid_pb2 as rpb
    from polaroid_tpu_torch.server import polaroid_pb2 as ppb
    assert ppb.DESCRIPTOR.serialized_pb == rpb.DESCRIPTOR.serialized_pb
    for name in ("ReadFileRequest", "HandleResponse", "ArrowBatch",
                 "HeartbeatResponse"):
        msg = getattr(ppb, name)()
        assert getattr(rpb, name).FromString(msg.SerializeToString()) == \
            getattr(rpb, name)()


def test_rpc_tables_match():
    from polaroid_tpu.server import service as RS
    from polaroid_tpu_torch.server import service as PS
    assert list(PS._RPCS) == list(RS._RPCS)
    for name, (req, resp, kind) in RS._RPCS.items():
        preq, presp, pkind = PS._RPCS[name]
        assert (preq.DESCRIPTOR.full_name, presp.DESCRIPTOR.full_name,
                pkind) == (req.DESCRIPTOR.full_name,
                           resp.DESCRIPTOR.full_name, kind)


@pytest.mark.parametrize("pair", [("pt", "pt"), ("pt", "ref"), ("ref", "pt")],
                         ids=lambda p: f"{p[0]}_client-{p[1]}_server")
def test_every_rpc_matches_the_reference(runs, pair):
    got, want = runs[pair], runs[("ref", "ref")]
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, tuple) and len(w) == 3 and isinstance(w[1], dict):
            _same(g, w, k)
        elif k in ("sort", "slice", "head"):
            assert list(g) == list(w), k
            for col in w:
                _same(([col], {}, [(x,) for x in g[col]]),
                      ([col], {}, [(x,) for x in w[col]]), f"{k}.{col}")
        else:
            assert g == w, (k, g, w)
    assert want["release"] == (True, "", False, "not found")
    assert want["listed"] and not want["released_listed"]


@pytest.mark.parametrize("cside", ["pt", "ref"])
def test_empty_result_keeps_its_schema(servers, files, cside):
    """A Collect of no rows sends the schema and no batch (kept
    difference: the JAX package's server fails to encode an empty String
    column, `polaroid_tpu/io/arrow_interop.py:329`, and answers UNKNOWN)."""
    pkg = PKGS[cside]
    client = _client(cside, servers["pt"][1])
    try:
        rf = client.read_parquet(files["parquet"])
        out = rf.filter(pkg.col("v") > 100.0).collect()
    finally:
        client.close()
    assert out.height == 0
    assert {k: repr(v) for k, v in out.schema.items()} == {
        "k": "Int64", "v": "Float64", "s": "String", "b": "Boolean"}


def _codes(client, files):
    """The status code of a bad request to each RPC (OK where the RPC
    answers it)."""
    pb = client._pb
    bogus = "not-a-handle"

    def code(fn):
        try:
            fn()
        except grpc.RpcError as e:
            return e.code().name
        return "OK"

    def unary(name, req, resp):
        return lambda: client._call(name, req, resp)

    def collect():
        stub = client._channel.unary_stream(
            "/polaroid.DataFrameService/Collect",
            request_serializer=pb.HandleRequest.SerializeToString,
            response_deserializer=pb.ArrowBatch.FromString)
        return list(stub(pb.HandleRequest(handle=bogus)))

    def upload():
        stub = client._channel.stream_unary(
            "/polaroid.DataFrameService/Upload",
            request_serializer=pb.ArrowBatch.SerializeToString,
            response_deserializer=pb.HandleResponse.FromString)
        return stub(iter([pb.ArrowBatch(data=b"not arrow", last=True)]))

    h = pb.HandleResponse
    from polaroid_tpu_torch.expr.serde import exprs_to_obj
    expr = json.dumps(exprs_to_obj([pt.col("k")]))
    return {
        "ReadFile": code(unary("ReadFile", pb.ReadFileRequest(
            path=files["parquet"], format="xlsx"), h)),
        "Sql": code(unary("Sql", pb.SqlRequest(query="SELEC nope"), h)),
        "ExecutePlan": code(unary("ExecutePlan", pb.PlanRequest(
            plan_json="{not json"), h)),
        "Filter": code(unary("Filter", pb.ExprOpRequest(
            handle=bogus, exprs_json=expr), h)),
        "Select": code(unary("Select", pb.ExprOpRequest(
            handle=bogus, exprs_json=expr), h)),
        "WithColumns": code(unary("WithColumns", pb.ExprOpRequest(
            handle=bogus, exprs_json=expr), h)),
        "GroupByAgg": code(unary("GroupByAgg", pb.GroupByRequest(
            handle=bogus, keys_json=expr, aggs_json=expr), h)),
        "Join": code(unary("Join", pb.JoinRequest(left=bogus, right=bogus),
                           h)),
        "Sort": code(unary("Sort", pb.SortRequest(handle=bogus,
                                                  by_json=expr), h)),
        "Slice": code(unary("Slice", pb.SliceRequest(handle=bogus), h)),
        "Unique": code(unary("Unique", pb.UniqueRequest(handle=bogus), h)),
        "Rename": code(unary("Rename", pb.RenameRequest(
            handle=bogus, mapping_json="{}"), h)),
        "GetSchema": code(unary("GetSchema", pb.HandleRequest(handle=bogus),
                                pb.SchemaResponse)),
        "CountRows": code(unary("CountRows", pb.HandleRequest(handle=bogus),
                                h)),
        "Collect": code(collect),
        "Upload": code(upload),
        "ReleaseHandle": code(unary("ReleaseHandle", pb.HandleRequest(
            handle=bogus), pb.StatusResponse)),
        "ListHandles": code(unary("ListHandles", pb.HandleRequest(),
                                  pb.ListHandlesResponse)),
        "Heartbeat": code(unary("Heartbeat", pb.HeartbeatRequest(),
                                pb.HeartbeatResponse)),
    }


def test_status_codes_match_rpc_by_rpc(servers, files):
    from polaroid_tpu_torch.server.service import _RPCS
    got = {}
    for side in ("ref", "pt"):
        client = _client("pt", servers[side][1])
        try:
            got[side] = _codes(client, files)
        finally:
            client.close()
    assert list(got["pt"]) == list(_RPCS)
    assert got["pt"] == got["ref"]
    assert got["pt"]["Filter"] == "INVALID_ARGUMENT"
    assert got["pt"]["ExecutePlan"] == "INTERNAL"
    assert got["pt"]["Collect"] == "UNKNOWN"


def test_out_of_memory_is_a_status_and_the_server_goes_on(
        servers, files, monkeypatch):
    from polaroid_tpu_torch.api.lazyframe import LazyFrame
    client = _client("pt", servers["pt"][1])
    try:
        rf = client.read_parquet(files["parquet"])

        def oom(self, *a, **kw):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        with monkeypatch.context() as m:
            m.setattr(LazyFrame, "collect", oom)
            with pytest.raises(grpc.RpcError) as e:
                rf.count_rows()
            assert e.value.code() == grpc.StatusCode.INTERNAL
            assert "OutOfMemoryError" in e.value.details()
        assert client.heartbeat()["ok"]
        assert rf.count_rows() == 300
    finally:
        client.close()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/exec",
                                 data=body.encode(), method="POST")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _same_json(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k != "dataset":
            assert got[k] == want[k], (k, got[k], want[k])
    assert len(got["dataset"]) == len(want["dataset"])
    for g, w in zip(got["dataset"], want["dataset"]):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert type(a) is float and abs(a - b) <= 1e-12 * abs(b), \
                    (g, w)
            else:
                assert type(a) is type(b) and a == b, (g, w)


def test_http_exec_json_matches_the_reference(servers, files):
    from polaroid_tpu.server.http_api import start_http as ref_http
    from polaroid_tpu_torch.server.http_api import start_http as pt_http
    svc = {s: servers[s][0]._polaroid_service for s in ("ref", "pt")}
    httpd = {"ref": ref_http("127.0.0.1", 0, svc["ref"]),
             "pt": pt_http("127.0.0.1", 0, svc["pt"])}
    port = {s: h.server_address[1] for s, h in httpd.items()}
    p = files["parquet"]
    # the same frame under a handle in each service
    handle = {}
    for s, pkg in PKGS.items():
        kw = {"device": "cpu"} if pkg is pt else {}
        handle[s] = svc[s].handles.create(
            pkg.DataFrame({"a": [3, 1, 2], "t": ["x", None, "z"],
                           "f": [0.5, None, 2.25]}, **kw))
    try:
        for s in port:
            assert _get(port[s], "/ping") == (200, {"status": "ok"})
            assert _get(port[s], "/nope")[0] == 404
        queries = [
            f"SELECT k, COUNT(*) AS n, SUM(v) AS sv, MIN(s) AS ms "
            f"FROM read_parquet('{p}') GROUP BY k ORDER BY k",
            f"SELECT s, b, v FROM read_parquet('{p}') WHERE v > 9.5 "
            "ORDER BY v",
            "SELECT a, t, f FROM {h} ORDER BY a"]
        for q in queries:
            out = {}
            for s in port:
                qs = q.format(h="h_" + handle[s].replace("-", ""))
                st, body = _get(port[s], "/exec?query="
                                + urllib.parse.quote(qs))
                assert st == 200, body
                body["query"] = q
                st2, body2 = _post(port[s], json.dumps({"query": qs}))
                body2["query"] = q
                assert (st2, body2) == (st, body)
                out[s] = body
            _same_json(out["pt"], out["ref"])
        for s in port:
            st, body = _get(port[s], "/exec?query="
                            + urllib.parse.quote("SELECT nope FROM missing"))
            assert st == 400 and "error" in body
            assert _get(port[s], "/exec")[0] == 400
    finally:
        for s in port:
            svc[s].handles.release(handle[s])
            httpd[s].shutdown()


def test_async_client(servers, files):
    from polaroid_tpu_torch.aio_client import connect_async
    p = files["parquet"]
    want = ref.read_parquet(p).filter(ref.col("v") > 5.0).group_by("k") \
        .agg(ref.len().alias("n")).sort("k").to_dict()

    async def run(port):
        c = connect_async(f"127.0.0.1:{port}", device="cpu")
        assert (await c.heartbeat())["ok"]
        rf = await c.read_parquet(p)
        f = await rf.filter(pt.col("v") > 5.0)
        g = await f.group_by_agg(["k"], [pt.len().alias("n")])
        out = await g.collect()
        assert out.device.type == "cpu"
        assert out.sort("k").to_dict() == want
        h = await (await rf.select("k")).head(4)
        assert (await h.collect()).height == 4
        frames = await asyncio.gather(*[
            c.sql(f"SELECT COUNT(*) c FROM read_parquet('{p}')")
            for _ in range(8)])
        outs = await asyncio.gather(*[f.collect() for f in frames])
        assert all(o.item() == 300 for o in outs)
        await asyncio.gather(*[f.release() for f in frames])
        await c.close()

    for side in ("pt", "ref"):
        asyncio.run(run(servers[side][1]))


def test_eight_threads_on_one_handle_equal_sequential(servers, files):
    client = _client("pt", servers["pt"][1])
    c = pt.col
    try:
        rf = client.read_parquet(files["parquet"])
        queries = [
            lambda: rf.group_by("k").agg(c("v").sum().alias("v")),
            lambda: rf.group_by("k", "s").agg(c("v").mean().alias("m"),
                                              pt.len().alias("n")),
            lambda: rf.filter(c("b")).group_by("s").agg(
                c("v").max().alias("mx"), c("k").sum().alias("ks"))]

        def run_all():
            return [_canon(q().collect()) for q in queries]
        seq = run_all()
        with futures.ThreadPoolExecutor(8) as ex:
            outs = list(ex.map(lambda _: run_all(), range(8)))
        for out in outs:
            for g, w in zip(out, seq):
                assert g == w
    finally:
        client.close()


def test_remote_context_by_client_and_by_address(servers, files):
    from polaroid_tpu_torch.client import connect
    port = servers["pt"][1]
    lf = _plan(pt, files)
    want = _canon(lf.collect())
    svc = servers["pt"][0]._polaroid_service
    before = len(svc.handles)
    client = connect(f"127.0.0.1:{port}", device="cpu")
    try:
        got = lf.remote(client).collect()
        assert got.device.type == "cpu"
        _same(_canon(got), want, "remote(client)")
    finally:
        client.close()
    with pt.Config(device="cpu"):
        got = lf.remote(f"127.0.0.1:{port}").collect()
    _same(_canon(got), want, "remote(address)")
    mem = pt.DataFrame({"a": [1, 2, 2]}, device="cpu").lazy() \
        .group_by("a").agg(pt.len().alias("n"))
    got = mem.remote(f"127.0.0.1:{port}").collect()
    assert got.device.type == "cpu"
    assert got.sort("a").to_dict() == {"a": [1, 2], "n": [1, 2]}
    # the calls released the handles they made
    assert len(svc.handles) == before
    # the JAX package's server answers the port's plans too
    got = lf.remote(f"127.0.0.1:{servers['ref'][1]}").collect()
    _same(_canon(got), want, "remote(address of the JAX package's server)")
