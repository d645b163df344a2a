"""What of the JAX package's public surface the port still lacks.

The public names (no leading underscore) of `polaroid_tpu` at its top
level and on `DataFrame`, `LazyFrame` and `Series` that
`polaroid_tpu_torch` does not have yet, recorded as literal lists. The
test fails if the port loses a name it has, and if a name recorded here
turns up in the port while still listed: each slice that ports a name
takes it off its list, so the lists shrink on purpose, and "the port
has all that the JAX package has" is these lists being empty. (`Expr`
has every name; evaluation of the kinds not ported yet raises, see
ROADMAP.md.)
"""

import types

import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt

TOP = """
BaseExtension BasePartitionContext Catalog Categories CompatLevel
CredentialProvider CredentialProviderAWS CredentialProviderAzure
CredentialProviderFunction CredentialProviderFunctionReturn
CredentialProviderGCP DataTypeExpr Decimal Extension Float16
GPUEngine Int128 KeyedPartition KeyedPartitionContext NoDataError
Object OutOfBoundsError PartitionByKey PartitionMaxSize
PartitionParted QueryOptFlags SQLContext SQLInterfaceError
SQLSyntaxError ScanCastOptions Schema StringCache UInt128 Unknown
align_frames all all_horizontal any any_horizontal approx_n_unique
arange arctan2 arctan2d arg_sort_by arg_where build_info
business_day_count coalesce collect_all collect_all_async
concat_arr count cum_count cum_fold cum_reduce cum_sum
cum_sum_horizontal datatype_expr defer disable_string_cache
dtype_of enable_string_cache exclude explain_all first fold
from_arrow from_dataframe from_dicts from_numpy from_pandas
from_records from_repr from_torch get_extension_type
get_index_type groups head int_range json_normalize last
linear_space linear_spaces map_batches map_groups max
max_horizontal mean mean_horizontal median min min_horizontal
monads n_unique nth ones plugins quantile read_avro read_clipboard
read_csv read_csv_batched read_database read_database_uri
read_delta read_excel read_ipc read_ipc_schema read_ipc_stream
read_json read_ndjson read_ods read_parquet read_parquet_metadata
read_parquet_schema reduce register_extension_type
register_io_source repeat scan_csv scan_delta scan_iceberg
scan_ipc scan_ndjson scan_parquet scan_pyarrow_dataset select
selectors self_dtype set_random_seed show_versions sql sql_expr
std struct_with_fields sum sum_horizontal tail thread_pool_size
threadpool_size union unregister_extension_type using_string_cache
var zeros
""".split()

DATAFRAME = """
approx_n_unique cast clear clone collect_schema corr count
deserialize drop drop_in_place drop_nans equals estimated_size
extend fill_nan flags fold gather_every get_column_index
get_columns glimpse hash_rows insert_column is_duplicated is_empty
is_unique item iter_columns iter_rows iter_slices limit
map_columns map_rows match_to_schema max_horizontal
mean_horizontal melt merge_sorted min_horizontal n_chunks n_unique
partition_by pipe pivot plot product quantile rechunk remove
rename replace_column reverse row rows_by_key sample select_seq
serialize set_sorted show shrink_to_fit shuffle slice sql style
sum_horizontal to_arrow to_dicts to_dummies to_init_repr to_jax
to_pandas to_series to_torch transpose unpivot unstack update
with_columns_seq with_row_count with_row_index write_avro
write_clipboard write_csv write_database write_delta write_excel
write_iceberg write_ipc write_ipc_stream write_json write_ndjson
write_parquet
""".split()

LAZYFRAME = """
approx_n_unique cache cast clear clone collect_async
collect_batches collect_schema count describe deserialize drop
drop_nans drop_nulls dtypes fetch fill_nan gather_every inspect
map_batches match_to_schema max mean median melt merge_sorted min
null_count optimized_plan pipe pipe_with_schema pivot profile
quantile remote remove rename reverse select_seq serialize
set_sorted show show_graph sink_batches sink_csv sink_ipc
sink_ndjson sink_parquet sql std sum unpivot update var width
with_columns_seq with_context with_row_count with_row_index
""".split()

SERIES = """
abs append arg_max arg_min cast chunk_lengths clear clip clone
count describe dot drop_nans drop_nulls entropy equals
estimated_size exp ext extend extend_constant filter first flags
gather gather_every get_chunks has_nulls has_validity head hist
is_empty is_not_null is_null is_sorted item last len limit log
map_elements max median min mode n_chunks n_unique new_from_index
null_count plot quantile rechunk rename reshape round sample
scatter search_sorted series_equal set shrink_to_fit shuffle slice
sqrt std tail to_arrow to_dummies to_init_repr to_jax to_pandas
to_physical to_torch unique unique_counts value_counts var
zip_with
""".split()


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
    lost = sorted(n for n in _public(jax_side) - set(missing)
                  if not hasattr(port, n))
    assert not lost, f"{surface}: the port lost {lost}"


@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_missing_names_are_still_missing(surface):
    jax_side, port, missing = SURFACES[surface]
    ported = sorted(n for n in missing if hasattr(port, n))
    assert not ported, f"{surface}: take {ported} off the list"
    assert len(set(missing)) == len(missing)
    assert set(missing) <= _public(jax_side)


def test_expr_has_every_name():
    assert not sorted(n for n in _public(ref.Expr)
                      if not hasattr(pt.Expr, n))
