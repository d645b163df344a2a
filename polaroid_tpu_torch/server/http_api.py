"""HTTP SQL API: QuestDB-style /exec endpoint.

The port of the JAX package's `server/http_api.py`: GET /ping,
GET|POST /exec?query=<sql> returning
{"query", "columns": [{"name","type"}], "dataset": [[...]], "count"}.
Stdlib ThreadingHTTPServer — no framework dependency, and neither grpc
nor protobuf: this module runs where they are not installed.

The query runs through the port's `SQLContext` on the service's device
(the handles' frames are registered as `h_<handle without dashes>`),
under the process's plan lock (`handles.EXEC_LOCK`); the rows are read back
to the host for the JSON.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .handles import EXEC_LOCK


def _rows_to_json(df):
    d = df._table.to_numpy_dict()
    names = list(d.keys())
    cols = [{"name": n, "type": repr(df.schema[n])} for n in names]
    n = len(d[names[0]]) if names else 0
    dataset = []
    for i in range(n):
        row = []
        for k in names:
            v = d[k][i]
            if isinstance(v, np.generic):
                v = v.item()
            elif v is not None and not isinstance(v, (int, float, str, bool)):
                v = str(v)
            row.append(v)
        dataset.append(row)
    return cols, dataset, n


class _Handler(BaseHTTPRequestHandler):
    service = None  # injected

    def log_message(self, fmt, *args):  # silence default stderr logging
        pass

    def _send(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _exec(self, query: Optional[str]) -> None:
        if not query:
            self._send(400, {"error": "missing query parameter"})
            return
        try:
            from ..sql.context import SQLContext
            svc = self.service
            ctx = SQLContext(device=svc.device if svc is not None else None)
            if svc is not None:
                for h in svc.handles.list():
                    ctx.register(f"h_{h.replace('-', '')}",
                                 svc.handles.get(h))
            with EXEC_LOCK:
                df = ctx.execute(query, eager=True)
            cols, dataset, n = _rows_to_json(df)
            del df
            self._send(200, {"query": query, "columns": cols,
                             "dataset": dataset, "count": n})
        except Exception as e:
            self._send(400, {"query": query,
                             "error": f"{type(e).__name__}: {e}"})

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        if parsed.path == "/ping":
            self._send(200, {"status": "ok"})
            return
        if parsed.path == "/exec":
            q = urllib.parse.parse_qs(parsed.query).get("query", [None])[0]
            self._exec(q)
            return
        self._send(404, {"error": "not found"})

    def do_POST(self):
        parsed = urllib.parse.urlparse(self.path)
        if parsed.path != "/exec":
            self._send(404, {"error": "not found"})
            return
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length).decode() if length else ""
        q = None
        if body:
            try:
                q = json.loads(body).get("query")
            except json.JSONDecodeError:
                q = body
        if q is None:
            q = urllib.parse.parse_qs(parsed.query).get("query", [None])[0]
        self._exec(q)


def start_http(host: str, port: int, service=None) -> ThreadingHTTPServer:
    """Serve /ping and /exec on a daemon thread; `service` (a
    `DataFrameService` or anything with `device` and `handles`) gives the
    device and the frames that queries can name."""
    handler = type("Handler", (_Handler,), {"service": service})
    httpd = ThreadingHTTPServer((host, port), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd
