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
