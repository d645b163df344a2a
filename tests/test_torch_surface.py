"""What of the JAX package's public surface the port still lacks.

The public names (no leading underscore) of `polaroid_tpu` that
`polaroid_tpu_torch` does not have yet, recorded as literal lists, on
every surface of `SURFACES`: the top level; `DataFrame`, `LazyFrame`,
`Series` and `Expr`; the group-by objects (`GroupBy`, `LazyGroupBy`,
and what `group_by_dynamic` and `rolling` return, eager and lazy);
`Config` (the settings object, its attributes included) and
`SQLContext`; and the namespaces of `Expr` (`str`, `dt`, `list`, `arr`,
`struct`, `cat`, `bin`, `name`, `meta`) and of `Series` (the same but
`name`, which is the series' name, and `meta`, which a series has not).
The test fails if the port loses a name it has, and if a name recorded
here turns up in the port while still listed: each slice that ports a
name takes it off its list, so the lists shrink on purpose, and "the
port has all that the JAX package has" is these lists being empty, as
they are now. `test_port_accepts_the_reference_parameter_names` holds
every public callable on those surfaces to the JAX package's parameter
names, save the renames of `RENAMED_PARAMS`. Every module file of the
JAX package has its counterpart in the port too
(`test_every_module_has_a_counterpart`). `NEVER` holds the names the
port never takes: `to_jax` (on `DataFrame` and `Series`) hands the data
to JAX, and the port imports no JAX; four settings of `Config` have no
counterpart in the port, each with its reason there.
"""

import datetime
import inspect
import types

import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
from polaroid_tpu import config as ref_config
from polaroid_tpu_torch import config as pt_config

# every name is ported: the lists stay, empty, so that a name the JAX
# package gains shows up here (the other surfaces' lists, below, too)
TOP: list = []

DATAFRAME: list = []

LAZYFRAME: list = []

SERIES: list = []

# names the port never takes: `to_jax` hands the data to JAX, and the
# port imports no JAX (tests/test_torch_isolation.py); of the settings,
# `strict_f64` keeps Float64 in f64 where the JAX package would downcast
# it for a TPU, and the port always keeps it (the card computes Float64
# natively); `groupby_strategy`
# picks a group-by tier, where the port has one chooser (the key stats);
# `panic_on_err` raises on lossy ops, where the port makes none that
# would warn; `max_buckets` bounds the capacity buckets, which the port
# leaves unbounded
NEVER = {"DataFrame": ["to_jax"], "Series": ["to_jax"],
         "Config": ["strict_f64", "groupby_strategy", "panic_on_err",
                    "max_buckets"]}


SURFACES = {"top level": (ref, pt, TOP),
            "DataFrame": (ref.DataFrame, pt.DataFrame, DATAFRAME),
            "LazyFrame": (ref.LazyFrame, pt.LazyFrame, LAZYFRAME),
            "Series": (ref.Series, pt.Series, SERIES)}


def _objects(pkg, config):
    """The group-by, settings, SQL and namespace surfaces of `pkg` (the
    objects that the API hands out are made on a one-row frame; the
    namespaces of a series are objects whose operations the expression
    namespaces define)."""
    kw = {"device": "cpu"} if pkg is pt else {}
    df = pkg.DataFrame({"t": [datetime.datetime(2024, 1, 1)], "a": [1]},
                       **kw)
    lf = df.lazy()
    s = pkg.Series("a", [1], **kw)
    out = {
        "GroupBy": type(df.group_by("a")),
        "LazyGroupBy": type(lf.group_by("a")),
        "DataFrame.group_by_dynamic": type(df.group_by_dynamic(
            "t", every="1d")),
        "DataFrame.rolling": type(df.rolling("t", period="1d")),
        "LazyFrame.group_by_dynamic": type(lf.group_by_dynamic(
            "t", every="1d")),
        "LazyFrame.rolling": type(lf.rolling("t", period="1d")),
        "Config": config.CONFIG,
        "SQLContext": pkg.SQLContext,
        "Expr": pkg.Expr,
    }
    for ns in ("str", "dt", "list", "arr", "struct", "cat", "bin", "name",
               "meta"):
        out[f"Expr.{ns}"] = type(getattr(pkg.col("a"), ns))
    for ns in ("str", "dt", "list", "arr", "struct", "cat", "bin"):
        out[f"Series.{ns}"] = getattr(s, ns)
    return out


_REF_OBJECTS = _objects(ref, ref_config)
_PT_OBJECTS = _objects(pt, pt_config)
# every name on these surfaces is ported (empty lists, as above)
SURFACES.update({k: (_REF_OBJECTS[k], _PT_OBJECTS[k], [])
                 for k in _REF_OBJECTS})


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


# the parameters that the port names as polars does where the JAX package
# names them otherwise: {(surface, callable): {reference name: port name}}.
# A positional call works in both packages.
RENAMED_PARAMS = {
    # polars' Series.round(decimals)
    ("Series", "round"): {"d": "decimals"},
    # polars' Series.map_elements(function)
    ("Series", "map_elements"): {"fn": "function"},
    # polars' from_arrow(data)
    ("top level", "from_arrow"): {"at": "data"},
}


def _signature(f):
    try:
        return inspect.signature(f)
    except (TypeError, ValueError):
        return None


def _named(sig):
    """{name: parameter} of the parameters a caller may pass by name, and
    whether the signature takes any keyword (**kwargs)."""
    ps = sig.parameters.values()
    return ({p.name: p for p in ps if p.kind in (
        p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)},
        any(p.kind is p.VAR_KEYWORD for p in ps))


@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_port_accepts_the_reference_parameter_names(surface):
    """Every public callable of the JAX package's surface takes each of
    its parameter names in the port too, by the same name or through
    **kwargs, but for the renames of `RENAMED_PARAMS`, which the port
    takes under polars' name instead."""
    jax_side, port, _ = SURFACES[surface]
    never = set(NEVER.get(surface, ()))
    refused = []
    for n in sorted(_public(jax_side) - never):
        f = getattr(jax_side, n)
        if isinstance(f, types.ModuleType) or not callable(f):
            continue
        want, got = _signature(f), _signature(getattr(port, n))
        if want is None or got is None:
            continue
        names, any_kw = _named(got)
        renames = RENAMED_PARAMS.get((surface, n), {})
        for p in _named(want)[0]:
            if p in renames:
                assert p not in names and renames[p] in names, \
                    f"{surface}.{n}: the rename {p} -> {renames[p]} is stale"
            elif p != "self" and p not in names and not any_kw:
                refused.append(f"{n}({p}=)")
    assert not refused, f"{surface}: the port refuses {refused}"


def test_renamed_params_name_real_callables():
    """Each rename names a callable of its surface and a parameter of the
    JAX package's signature."""
    for (surface, n), renames in RENAMED_PARAMS.items():
        jax_side, port, _ = SURFACES[surface]
        want = _named(_signature(getattr(jax_side, n)))[0]
        assert set(renames) <= set(want), (surface, n)
        assert callable(getattr(port, n))


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
