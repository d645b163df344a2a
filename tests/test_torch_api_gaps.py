"""List literals with None, and the small API gaps, through the JAX
package and the port.

* `lit([... None ...])` in a select: the port builds the literal as a
  Series is built (its dtype from the values that are not None, Boolean
  where all are None, an explicit `dtype` first) with a null for each
  None; the JAX package refuses all five kinds (TypeError or
  ValueError). Kept difference: the port is held to explicit values and
  numpy (`is_null`, `drop_nulls`, `sum`), on a frame of as many rows and
  on one of another length.
* `SELECT * FROM read_ipc(...)` then `.select("a")`: both packages
  refuse it with the same ComputeError (a hazard of the reference that
  the port keeps); `SELECT *` over a registered table works in both.
* `Config.set_verbose`, `DataFrame(strict=False)` and
  `LazyFrame.join(allow_parallel=False)`: accepted by both, with the
  same (no) effect on the result.
"""

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


# (values, the port's dtype, the non-null values as numpy gives them)
LITERALS = {
    "int": ([1, None, 3], "Int64", np.array([1, 3])),
    "str": (["a", None, "c"], "String", np.array(["a", "c"], dtype=object)),
    "float": ([1.5, None, 2.5], "Float64", np.array([1.5, 2.5])),
    "bool": ([True, None, False], "Boolean", np.array([True, False])),
    "none": ([None, None, None], "Boolean", np.array([], dtype=bool)),
}


@pytest.mark.parametrize("rows", [3, 5])
@pytest.mark.parametrize("kind", sorted(LITERALS))
def test_list_literal_with_none(kind, rows):
    values, dtype, present = LITERALS[kind]
    with pytest.raises((TypeError, ValueError)):
        ref.DataFrame({"a": [1, 2, 3]}).select(ref.lit(values).alias("x"))
    df = pt.DataFrame({"a": list(range(rows))}, device="cpu")
    out = df.select(pt.lit(values).alias("x"))
    assert str(out.schema["x"]) == dtype
    assert out.to_dict() == {"x": values}
    nulls = [v is None for v in values]
    assert df.select(pt.lit(values).alias("x").is_null()).to_dict() == \
        {"x": nulls}
    kept = df.select(pt.lit(values).alias("x").drop_nulls()).to_dict()["x"]
    assert kept == present.tolist()
    if dtype != "String":
        (total,) = df.select(pt.lit(values).alias("x").sum()) \
            .to_dict()["x"]
        assert total == np.sum(present)
    else:
        assert df.select(pt.lit(values).alias("x").len()).to_dict() == \
            {"x": [3]}


def test_list_literal_dtype_wins():
    df = pt.DataFrame({"a": [1, 2, 3]}, device="cpu")
    out = df.select(pt.lit([1, None, 3], dtype=pt.Float64).alias("x"))
    assert str(out.schema["x"]) == "Float64"
    assert out.to_dict() == {"x": [1.0, None, 3.0]}
    out = df.select(pt.lit([None, None, None], dtype=pt.Int32).alias("x"))
    assert str(out.schema["x"]) == "Int32"
    assert out.to_dict() == {"x": [None, None, None]}
    # a literal without None is as it was: no validity
    out = df.select(pt.lit([4, 5, 6]).alias("x"))
    assert out.to_dict() == {"x": [4, 5, 6]}
    assert out._table.cols["x"].validity is None


def test_select_star_from_table_function_refused_alike(tmp_path):
    """Both packages refuse `.select("a")` after `SELECT *` from a table
    function alike; `SELECT *` over a registered table works in both."""
    path = str(tmp_path / "t.arrow")
    ref.DataFrame({"a": [1, 2], "b": [3, 4]}).write_ipc(path)
    errors = []
    for pkg in (ref, pt):
        lf = pkg.SQLContext().execute(f"SELECT * FROM read_ipc('{path}')")
        with pytest.raises(Exception) as e:
            lf.select("a").collect()
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1]
    assert errors[0][0] == "ComputeError"
    for pkg, kw in ((ref, {}), (pt, {"device": "cpu"})):
        ctx = pkg.SQLContext()
        ctx.register("t", pkg.DataFrame({"a": [1, 2], "b": [3, 4]}, **kw))
        out = ctx.execute("SELECT * FROM t").select("a").collect()
        assert out.to_dict() == {"a": [1, 2]}


def test_config_set_verbose():
    for cfg in (ref.Config, pt.Config):
        was = cfg.verbose
        try:
            assert cfg.set_verbose() is not None
            assert cfg.verbose is True
            cfg.set_verbose(False)
            assert cfg.verbose is False
            with cfg(verbose=True):
                assert cfg.verbose is True
            assert cfg.verbose is False
        finally:
            cfg.verbose = was


def test_config_reads_pt_verbose(monkeypatch):
    from polaroid_tpu_torch.config import Config
    monkeypatch.setenv("PT_VERBOSE", "1")
    assert Config().verbose is True
    monkeypatch.setenv("PT_VERBOSE", "0")
    assert Config().verbose is False


def test_strict_and_allow_parallel_accepted():
    d = {"k": [1, 2, 3], "v": [1.5, 2.5, 3.5]}
    r = {"k": [3, 1], "w": [10, 20]}
    want = ref.DataFrame(d, strict=False).lazy().join(
        ref.DataFrame(r).lazy(), on="k", allow_parallel=False).collect()
    got = pt.DataFrame(d, strict=False, device="cpu").lazy().join(
        pt.DataFrame(r, device="cpu").lazy(), on="k",
        allow_parallel=False).collect()
    assert got.sort("k").to_dict() == want.sort("k").to_dict()
    assert pt.DataFrame(d, strict=True, device="cpu").to_dict() == d
