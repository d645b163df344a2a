"""The port's hybrid storage and network sources against the JAX
package's, on the CPU with local servers only.

Hybrid storage: a round trip through the RAM tier and, after the cache
entry is deleted, the cold Parquet tier, and SQL over the stored keys,
each held to the JAX package's frames; an LRU sized below two frames
evicts. Sources: the same WebSocket ticks and REST polls batched by both
packages give the same frames; the token bucket's burst and refill.
"""

import asyncio
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt


@pytest.fixture(autouse=True, scope="module")
def _fresh_reference_cache():
    """The JAX package's process-wide caches can hand this file's plans
    another frame's results (`tests/test_torch_reference_caches.py`)."""
    from test_torch_reference_caches import fresh_reference_caches
    with fresh_reference_caches():
        yield


def _data():
    rng = np.random.default_rng(5)
    s = rng.choice(["eu", "us", "apac"], 200).astype(object)
    s[::17] = None
    return {"a": rng.integers(-50, 50, 200), "v": rng.uniform(0, 1, 200),
            "r": s.tolist(), "t": np.arange(200).astype("datetime64[us]")}


def _hybrid(side, root, **kw):
    if side == "ref":
        from polaroid_tpu.storage import HybridStorage
        return HybridStorage(str(root), **kw)
    from polaroid_tpu_torch.storage import HybridStorage
    return HybridStorage(str(root), device="cpu", **kw)


def _frame(side, data):
    return ref.DataFrame(data) if side == "ref" else \
        pt.DataFrame(data, device="cpu")


def _hybrid_run(side, root):
    hs = _hybrid(side, root / side, cache_bytes=10 << 20)
    df = _frame(side, _data())
    hs.store("trades/day1", df)
    hs.store("sales", _frame(side, {"r": ["eu", "us", "eu"],
                                    "v": [1.0, 2.0, 3.0]}))
    hit = hs.load("trades/day1")
    st = hs.stats()
    hs.cache.delete("trades/day1")
    cold = hs.load("trades/day1")
    again = hs.load("trades/day1")
    st2 = hs.stats()
    q = hs.query("SELECT r, SUM(v) AS t, COUNT(*) AS n FROM sales "
                 "GROUP BY r ORDER BY r")
    q2 = hs.query('SELECT r, MAX(a) AS m FROM "trades/day1" '
                  "WHERE v > 0.5 GROUP BY r ORDER BY r") \
        if side == "pt" else None
    out = {"hit": hit.to_dict(), "cold": cold.to_dict(),
           "again": again.to_dict(), "keys": hs.list_keys(),
           "stats": (st["cache_hits"], st2["cache_hits"],
                     st2["cache_misses"], st2["stores"], st2["loads"]),
           "query": q.to_dict(), "want": df.to_dict()}
    if side == "pt":
        assert hit.device.type == "cpu" and cold.device.type == "cpu"
        out["q2"] = q2.to_dict()
    assert hs.delete("sales") and not hs.delete("sales")
    return out


def test_hybrid_storage_matches_the_reference(tmp_path):
    want = _hybrid_run("ref", tmp_path)
    got = _hybrid_run("pt", tmp_path)
    for k in ("hit", "cold", "again", "keys", "stats", "query"):
        assert got[k] == want[k], k
    assert got["hit"] == got["want"]
    assert got["stats"] == (1, 2, 1, 2, 3)
    assert got["query"] == {"r": ["eu", "us"], "t": [4.0, 2.0], "n": [2, 1]}
    # the second query against numpy
    d = _data()
    expect = {}
    for r, a, v in zip(d["r"], d["a"], d["v"]):
        if v > 0.5:
            expect[r] = max(expect.get(r, -10**9), int(a))
    assert dict(zip(got["q2"]["r"], got["q2"]["m"])) == expect
    assert len(got["q2"]["r"]) == len(expect)


def test_missing_key_raises(tmp_path):
    hs = _hybrid("pt", tmp_path)
    with pytest.raises(pt.NoDataError):
        hs.load("nope")


def test_lru_sized_below_two_frames_evicts(tmp_path):
    from polaroid_tpu_torch.storage import MemoryCacheBackend
    df = _frame("pt", _data())
    probe = MemoryCacheBackend(64 << 20, device="cpu")
    size = probe.store("x", df)
    cache = MemoryCacheBackend(size + size // 2, device="cpu")
    cache.store("one", df)
    cache.store("two", df)
    assert cache.load("one") is None
    assert cache.load("two").to_dict() == df.to_dict()
    st = cache.stats()
    assert st["evictions"] == 1 and st["entries"] == 1


def test_rate_limiter():
    from polaroid_tpu_torch.sources import TokenBucketRateLimiter
    rl = TokenBucketRateLimiter(rate=1000.0, capacity=5)
    ok = sum(rl.try_acquire() for _ in range(10))
    assert 5 <= ok <= 7  # capacity burst (+ tokens replenished meanwhile)
    time.sleep(0.01)
    assert rl.try_acquire()

    async def paced():
        slow = TokenBucketRateLimiter(rate=50.0, capacity=1)
        t0 = time.monotonic()
        for _ in range(4):
            await slow.acquire()
        return time.monotonic() - t0
    assert asyncio.run(paced()) >= 3 / 50 * 0.9


def _ws_frames(side):
    import websockets
    if side == "ref":
        from polaroid_tpu.sources import WebSocketSource, collect_stream
        kw = {}
    else:
        from polaroid_tpu_torch.sources import WebSocketSource, collect_stream
        kw = {"device": "cpu"}

    async def run():
        async def handler(ws):
            for i in range(10):
                msg = {"tick": i, "px": 100.0 + i}
                if i % 4 == 3:
                    msg["sym"] = "X"
                await ws.send(json.dumps(msg))
            await asyncio.sleep(0.1)

        async with websockets.serve(handler, "127.0.0.1", 0) as server:
            port = server.sockets[0].getsockname()[1]
            src = WebSocketSource(f"ws://127.0.0.1:{port}", batch_rows=4,
                                  **kw)
            df = await collect_stream(src, max_batches=3)
            return df, src.rows_received
    return asyncio.run(run())


def test_websocket_source_matches_the_reference():
    want, wn = _ws_frames("ref")
    got, gn = _ws_frames("pt")
    assert got.device.type == "cpu"
    assert (gn, got.height) == (wn, want.height) == (10, 10)
    assert {k: repr(v) for k, v in got.schema.items()} == \
        {k: repr(v) for k, v in want.schema.items()}
    assert got.to_dict() == want.to_dict()


def _rest_frames(side):
    if side == "ref":
        from polaroid_tpu.sources import (RestSource, TokenBucketRateLimiter,
                                          collect_stream)
        kw = {}
    else:
        from polaroid_tpu_torch.sources import (RestSource,
                                                TokenBucketRateLimiter,
                                                collect_stream)
        kw = {"device": "cpu"}
    counter = {"n": 0}

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            counter["n"] += 1
            body = json.dumps([{"poll": counter["n"], "v": 1.5},
                               {"poll": counter["n"], "v": None}]).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    try:
        src = RestSource(f"http://127.0.0.1:{port}/data", interval_s=0.01,
                         rate_limiter=TokenBucketRateLimiter(500.0, 2),
                         batch_rows=4, max_polls=5, flush_interval=3600.0,
                         **kw)
        return asyncio.run(collect_stream(src, max_batches=2))
    finally:
        httpd.shutdown()


def test_rest_source_matches_the_reference():
    want = _rest_frames("ref")
    got = _rest_frames("pt")
    assert got.device.type == "cpu"
    assert got.height == want.height == 8
    assert got.to_dict() == want.to_dict()
    assert got.to_dict()["poll"] == [1, 1, 2, 2, 3, 3, 4, 4]
