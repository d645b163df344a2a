"""The port stands alone: it imports neither JAX nor the JAX package, and
it never runs on the CPU unless the caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import polaroid_tpu_torch as pt
from polaroid_tpu_torch.testing import frame_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "polaroid_tpu_torch"


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or \
        name == "polaroid_tpu" or name.startswith("polaroid_tpu.")


def test_import_loads_no_jax_module():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import polaroid_tpu_torch\n"
        "import polaroid_tpu_torch.exec.executor\n"
        "import polaroid_tpu_torch.exec.compiled\n"
        "import polaroid_tpu_torch.exec.streaming\n"
        "import polaroid_tpu_torch.metrics\n"
        "import polaroid_tpu_torch.native\n"
        "import polaroid_tpu_torch.ops.cuda_build\n"
        "import polaroid_tpu_torch.ops.nested\n"
        "import polaroid_tpu_torch.expr.nested\n"
        "import polaroid_tpu_torch.expr.str\n"
        "import polaroid_tpu_torch.expr.misc\n"
        "import polaroid_tpu_torch.sql.context\n"
        "import polaroid_tpu_torch.sql.parser\n"
        "import polaroid_tpu_torch.sql.translate\n"
        "import polaroid_tpu_torch.selectors\n"
        "import polaroid_tpu_torch.datatype_expr\n"
        "import polaroid_tpu_torch.monads\n"
        "import polaroid_tpu_torch.plugins\n"
        "import polaroid_tpu_torch.api.fmt\n"
        "import polaroid_tpu_torch.parallel.mesh\n"
        "import polaroid_tpu_torch.parallel.shuffle\n"
        "import polaroid_tpu_torch.exec.distributed\n"
        "import polaroid_tpu_torch.entry\n"
        "import polaroid_tpu_torch.api.io\n"
        "import polaroid_tpu_torch.exec.scan_predicate\n"
        "import polaroid_tpu_torch.expr.serde\n"
        "import polaroid_tpu_torch.plan.serde\n"
        "import polaroid_tpu_torch.io.arrow_interop\n"
        "import polaroid_tpu_torch.io.avro\n"
        "import polaroid_tpu_torch.io.credentials\n"
        "import polaroid_tpu_torch.io.csv\n"
        "import polaroid_tpu_torch.io.file_cache\n"
        "import polaroid_tpu_torch.io.ipc\n"
        "import polaroid_tpu_torch.io.json_io\n"
        "import polaroid_tpu_torch.io.parquet\n"
        "import polaroid_tpu_torch.io.remote\n"
        "import polaroid_tpu_torch.server\n"
        "import polaroid_tpu_torch.server.handles\n"
        "import polaroid_tpu_torch.server.http_api\n"
        "import polaroid_tpu_torch.server.polaroid_pb2\n"
        "import polaroid_tpu_torch.server.service\n"
        "import polaroid_tpu_torch.client\n"
        "import polaroid_tpu_torch.aio_client\n"
        "import polaroid_tpu_torch.storage\n"
        "import polaroid_tpu_torch.lakehouse\n"
        "import polaroid_tpu_torch.sources\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m == 'jax' or m.startswith('jax.')"
        " or m == 'polaroid_tpu' or m.startswith('polaroid_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_no_jax_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = {"a": np.arange(4)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.DataFrame(data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.LazyFrame(data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        frame_from_numpy(data)
    for build, arg in ((pt.from_torch, torch.arange(4)),
                       (pt.from_numpy, np.arange(4)),
                       (pt.from_dicts, [{"a": 1}])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(arg)
    df = pt.DataFrame(data, device="cpu")
    assert df.device.type == "cpu" and df.height == 4
    with pt.Config(device="cpu"):
        assert pt.DataFrame(data).device.type == "cpu"
    with pytest.raises(RuntimeError):
        pt.DataFrame(data)


def test_runs_without_pyarrow_pandas_or_fsspec(tmp_path):
    """With pyarrow, pandas and fsspec unimportable (as on the card's
    machine), the port imports, writes and reads Avro, serializes
    expressions and runs `remote()`; a Parquet read raises
    ModuleNotFoundError naming pyarrow."""
    code = (
        "import sys, importlib.abc\n"
        "BLOCK = ('pyarrow', 'pandas', 'fsspec')\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in BLOCK:\n"
        "            raise ModuleNotFoundError(f'No module named {name!r}',"
        " name=name)\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "import polaroid_tpu_torch as pl\n"
        "from polaroid_tpu_torch.parallel.mesh import make_mesh\n"
        "df = pl.DataFrame({'t': np.arange(5).astype('datetime64[us]'),\n"
        "                   's': ['a', 'b', None, 'a', 'c'],\n"
        "                   'p': [1.5, -0.0, float('nan'), None, 2.0],\n"
        "                   'n': np.arange(5)}, device='cpu')\n"
        f"path = {str(tmp_path / 'x.avro')!r}\n"
        "df.write_avro(path, compression='deflate')\n"
        "back = pl.read_avro(path, device='cpu')\n"
        "assert repr(back.to_dict()) == repr(df.to_dict()), back\n"
        "e = (pl.col('p') * 2).sum().over('s').alias('q')\n"
        "assert pl.Expr.deserialize(e.serialize()).fingerprint() == "
        "e.fingerprint()\n"
        "lf = df.lazy().group_by('s').agg(pl.col('n').sum())\n"
        "got = lf.remote().collect(mesh=make_mesh(2, device='cpu'))\n"
        "assert got.sort('s').to_dict() == lf.collect().sort('s')"
        ".to_dict()\n"
        "try:\n"
        "    pl.read_parquet('x.parquet', device='cpu')\n"
        "except ModuleNotFoundError as exc:\n"
        "    assert 'pyarrow' in str(exc), exc\n"
        "else:\n"
        "    raise AssertionError('read_parquet ran without pyarrow')\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in BLOCK]\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", \
        r.stdout + r.stderr


def test_runs_without_grpc_protobuf_websockets_or_aiohttp():
    """With grpc, protobuf, websockets and aiohttp unimportable, the port
    imports, the handles and the HTTP /exec API serve a frame, the
    lakehouse and the sources' modules import; the gRPC server, the
    client and a WebSocket source raise ModuleNotFoundError naming the
    package they need."""
    code = (
        "import sys, importlib.abc, json, urllib.request, urllib.parse\n"
        "BLOCK = ('grpc', 'google.protobuf', 'websockets', 'aiohttp')\n"
        "def blocked(name):\n"
        "    return any(name == b or name.startswith(b + '.')"
        " for b in BLOCK)\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if blocked(name):\n"
        "            raise ModuleNotFoundError(f'No module named {name!r}',"
        " name=name)\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        "import types, asyncio\n"
        "import polaroid_tpu_torch as pl\n"
        "import polaroid_tpu_torch.server\n"
        "import polaroid_tpu_torch.lakehouse, polaroid_tpu_torch.sources\n"
        "from polaroid_tpu_torch.server.handles import HandleManager\n"
        "from polaroid_tpu_torch.server.http_api import start_http\n"
        "hm = HandleManager()\n"
        "h = hm.create(pl.DataFrame({'a': [1, 2, 2]}, device='cpu'))\n"
        "svc = types.SimpleNamespace(handles=hm, device='cpu')\n"
        "httpd = start_http('127.0.0.1', 0, svc)\n"
        "q = urllib.parse.quote(f'SELECT a, COUNT(*) AS n FROM "
        "h_{h.replace(\"-\", \"\")} GROUP BY a ORDER BY a')\n"
        "port = httpd.server_address[1]\n"
        "with urllib.request.urlopen(f'http://127.0.0.1:{port}/exec?"
        "query={q}') as r:\n"
        "    body = json.load(r)\n"
        "httpd.shutdown()\n"
        "assert body['dataset'] == [[1, 1], [2, 2]], body\n"
        "for mod, need in (('polaroid_tpu_torch.server.service', 'grpc'),\n"
        "                  ('polaroid_tpu_torch.server.polaroid_pb2',"
        " 'google.protobuf')):\n"
        "    try:\n"
        "        __import__(mod)\n"
        "    except ModuleNotFoundError as exc:\n"
        "        assert need in str(exc), exc\n"
        "    else:\n"
        "        raise AssertionError(mod)\n"
        "from polaroid_tpu_torch.client import RemoteClient\n"
        "try:\n"
        "    RemoteClient('127.0.0.1:1', device='cpu')\n"
        "except ModuleNotFoundError as exc:\n"
        "    assert 'grpc' in str(exc), exc\n"
        "else:\n"
        "    raise AssertionError('RemoteClient ran without grpc')\n"
        "from polaroid_tpu_torch.sources import WebSocketSource, "
        "collect_stream\n"
        "src = WebSocketSource('ws://127.0.0.1:1', device='cpu')\n"
        "try:\n"
        "    asyncio.run(collect_stream(src, 1))\n"
        "except ModuleNotFoundError as exc:\n"
        "    assert 'websockets' in str(exc), exc\n"
        "else:\n"
        "    raise AssertionError('WebSocketSource ran without websockets')\n"
        "assert not [m for m in sys.modules if blocked(m)]\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", \
        r.stdout + r.stderr
