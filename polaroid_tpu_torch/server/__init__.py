"""The server: gRPC (`service.py`) and HTTP /exec (`http_api.py`) over
handles (`handles.py`). `serve` is imported on first use, so that the
HTTP API and the handles run where grpc is not installed."""


def __getattr__(name):
    if name == "serve":
        from .service import serve
        return serve
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
