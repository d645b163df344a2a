"""What of the JAX package's public surface the port still lacks.

The public names (no leading underscore) of `polaroid_tpu` at its top
level and on `DataFrame`, `LazyFrame` and `Series` that
`polaroid_tpu_torch` does not have yet, recorded as literal lists. The
test fails if the port loses a name it has, and if a name recorded here
turns up in the port while still listed: each slice that ports a name
takes it off its list, so the lists shrink on purpose, and "the port
has all that the JAX package has" is these lists being empty. What is
left needs files, serialization, pyarrow or pandas, and comes with the
slice ROADMAP.md names. `NEVER` holds the names the
port never takes: `to_jax` (on `DataFrame` and `Series`) hands the data
to JAX, and the port imports no JAX. (`Expr` has every name.)
"""

import types

import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt

# what is left needs files, serialization, pyarrow or pandas (Slice H:
# host IO and services); ROADMAP.md names the slice of each
TOP = """
BasePartitionContext Catalog CompatLevel CredentialProvider
CredentialProviderAWS CredentialProviderAzure CredentialProviderFunction
CredentialProviderFunctionReturn CredentialProviderGCP KeyedPartition
KeyedPartitionContext PartitionByKey PartitionMaxSize PartitionParted
ScanCastOptions defer from_arrow from_dataframe
from_pandas read_avro read_clipboard read_csv read_csv_batched
read_database read_database_uri read_delta read_excel read_ipc
read_ipc_schema read_ipc_stream read_json read_ndjson read_ods
read_parquet read_parquet_metadata read_parquet_schema
register_io_source scan_csv scan_delta scan_iceberg scan_ipc
scan_ndjson scan_parquet scan_pyarrow_dataset
""".split()

DATAFRAME = """
deserialize serialize to_arrow to_pandas write_avro write_clipboard
write_csv write_database write_delta write_excel write_iceberg
write_ipc write_ipc_stream write_json write_ndjson write_parquet
""".split()

LAZYFRAME = """
deserialize remote serialize sink_csv sink_ipc sink_ndjson
sink_parquet
""".split()

SERIES = """
to_arrow to_pandas
""".split()

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
