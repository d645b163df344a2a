"""What of the JAX package's public surface the port still lacks.

The public names (no leading underscore) of `polaroid_tpu` at its top
level and on `DataFrame`, `LazyFrame` and `Series` that
`polaroid_tpu_torch` does not have yet, recorded as literal lists. The
test fails if the port loses a name it has, and if a name recorded here
turns up in the port while still listed: each slice that ports a name
takes it off its list, so the lists shrink on purpose, and "the port
has all that the JAX package has" is these lists being empty, as they
are now. Every module file of the JAX package has its counterpart in the
port too (`test_every_module_has_a_counterpart`). `NEVER` holds the
names the port never takes: `to_jax` (on `DataFrame` and `Series`)
hands the data to JAX, and the port imports no JAX. (`Expr` has every
name.)
"""

import types

import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt

# every name is ported: the lists stay, empty, so that a name the JAX
# package gains shows up here
TOP: list = []

DATAFRAME: list = []

LAZYFRAME: list = []

SERIES: list = []

# names the port never takes: `to_jax` hands the data to JAX, and the
# port imports no JAX (tests/test_torch_isolation.py)
NEVER = {"DataFrame": ["to_jax"], "Series": ["to_jax"]}


SURFACES = {"top level": (ref, pt, TOP),
            "DataFrame": (ref.DataFrame, pt.DataFrame, DATAFRAME),
            "LazyFrame": (ref.LazyFrame, pt.LazyFrame, LAZYFRAME),
            "Series": (ref.Series, pt.Series, SERIES)}


# the reference's public modules (`pl.selectors`, ...); its other
# submodules show up as attributes only once something imports them, so
# they are not part of the surface
MODULES = {"datatype_expr", "monads", "plugins", "selectors"}


def _public(obj):
    return {n for n in dir(obj) if not n.startswith("_") and (
        n in MODULES or not isinstance(getattr(obj, n), types.ModuleType))}


@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_port_keeps_every_name_it_has(surface):
    jax_side, port, missing = SURFACES[surface]
    never = set(NEVER.get(surface, ()))
    lost = sorted(n for n in _public(jax_side) - set(missing) - never
                  if not hasattr(port, n))
    assert not lost, f"{surface}: the port lost {lost}"


@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_missing_names_are_still_missing(surface):
    jax_side, port, missing = SURFACES[surface]
    never = NEVER.get(surface, [])
    ported = sorted(n for n in missing + never if hasattr(port, n))
    assert not ported, f"{surface}: take {ported} off the list"
    assert len(set(missing)) == len(missing)
    assert not set(missing) & set(never)
    assert set(missing) | set(never) <= _public(jax_side)


def test_expr_has_every_name():
    assert not sorted(n for n in _public(ref.Expr)
                      if not hasattr(pt.Expr, n))


# the JAX package's Pallas modules and the port's CUDA ones
RENAMED = {"ops/pallas_kernels.py": "ops/cuda_kernels.py",
           "ops/pallas_partition.py": "ops/cuda_partition.py"}


def test_every_module_has_a_counterpart():
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    ref_files = sorted(str(p.relative_to(root / "polaroid_tpu"))
                       for p in (root / "polaroid_tpu").rglob("*.py"))
    assert "server/service.py" in ref_files and len(ref_files) > 80
    missing = [f for f in ref_files if not
               (root / "polaroid_tpu_torch" / RENAMED.get(f, f)).exists()]
    assert not missing, f"no counterpart in the port: {missing}"
