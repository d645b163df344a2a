"""The SQL front end in the port against the JAX package's: every query
of the JAX package's `tests/test_sql.py` through both packages on the
same frames, and `chip_smoke.py`'s phase-15 SQL queries (the H2O
group-by suite as its SQL solutions write it, and the TAQ off-exchange
share) at 2*10^4 H2O rows and 2^12 trades, through both packages and
against the chip script's numpy checkers.

Tolerances: integers, keys, strings and row order exact; Float64 within
rtol 1e-12 between the packages (the phase-9/11 checkers' own bounds
against numpy); the SQL results against their API twins bit for bit."""

import pathlib
import sys

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
from polaroid_tpu_torch.testing import assert_frame_equal

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _fresh_reference_cache():
    """The JAX package's process-wide caches (its compiled chains, and
    its optimized plans keyed by the id of a table that may be freed)
    can hand this file's plans another frame's results; start the file
    with the first empty and keep the second from storing anything
    while it runs (`tests/test_torch_reference_caches.py`)."""
    from test_torch_reference_caches import fresh_reference_caches
    with fresh_reference_caches():
        yield


SALES = {"region": ["eu", "us", "eu", "us", "apac", "eu"],
         "amount": [100.0, 200.0, 150.0, 50.0, 300.0, None],
         "qty": [1, 2, 3, 4, 5, 6],
         "product": ["widget", "gadget", "widget", "widget", "gizmo",
                     "gadget"]}
REGIONS = {"region": ["eu", "us", "apac"],
           "name": ["Europe", "United States", "Asia Pacific"]}
T = {"k": ["a", "a", "b"], "v": [1.0, 4.0, 9.0], "i": [3, 6, 4],
     "s": ["foo-bar", "baz-qux", "x-y"],
     "d": ["2024-02-15", "2024-03-01", "2024-01-05"]}
W = {"g": ["a", "a", "b", "b", "b"], "v": [3, 1, 5, 2, 4]}
W2 = {"g": ["a", "b", "a", "b"], "t": [2, 1, 1, 2], "x": [1., 2., 3., 4.]}


def _ctx(pl, device=None):
    kw = {} if device is None else {"device": device}
    return pl.SQLContext(
        sales=pl.DataFrame(SALES, **kw), regions=pl.DataFrame(REGIONS, **kw),
        t=pl.DataFrame(T, **kw), w=pl.DataFrame(W, **kw),
        df=pl.DataFrame(W2, **kw), one=pl.DataFrame({"v": [1, 2, 3]}, **kw))


# every query of tests/test_sql.py (the file-reading table function is
# test_table_function_names_its_slice below)
QUERIES = {
    "select_where": "SELECT product, amount FROM sales WHERE amount > 100",
    "star_limit": "SELECT * FROM sales LIMIT 2",
    "arithmetic_alias": "SELECT qty * 2 AS dq, amount / 2 half FROM sales "
                        "LIMIT 1",
    "group_by_agg": "SELECT region, COUNT(*) AS n, SUM(amount) AS total, "
                    "AVG(amount) AS avg_amt FROM sales GROUP BY region "
                    "ORDER BY region",
    "having": "SELECT region, SUM(qty) AS tq FROM sales GROUP BY region "
              "HAVING SUM(qty) > 5 ORDER BY tq DESC",
    "join": "SELECT s.product, r.name, s.amount FROM sales s JOIN regions r "
            "ON s.region = r.region WHERE s.amount >= 200 ORDER BY s.amount",
    "left_join_using": "SELECT region, name FROM regions LEFT JOIN sales "
                       "USING (region) WHERE qty = 5",
    "case_when": "SELECT product, CASE WHEN amount >= 200 THEN 'big' "
                 "WHEN amount >= 100 THEN 'mid' ELSE 'small' END AS size "
                 "FROM sales WHERE amount IS NOT NULL ORDER BY amount",
    "in_between": "SELECT qty FROM sales WHERE region IN ('eu','apac') AND "
                  "qty BETWEEN 2 AND 6 ORDER BY qty",
    "like_distinct": "SELECT DISTINCT product FROM sales WHERE product LIKE "
                     "'g%' ORDER BY product",
    "nulls_last": "SELECT amount FROM sales ORDER BY amount DESC NULLS LAST "
                  "LIMIT 3",
    "union": "SELECT region FROM sales WHERE qty > 4 UNION SELECT region "
             "FROM sales WHERE qty < 2",
    "union_all": "SELECT region FROM sales WHERE qty = 1 UNION ALL SELECT "
                 "region FROM sales WHERE qty = 1",
    "cte": "WITH big AS (SELECT * FROM sales WHERE amount > 100) SELECT "
           "region, COUNT(*) AS n FROM big GROUP BY region ORDER BY region",
    "subquery": "SELECT * FROM (SELECT qty FROM sales WHERE qty <= 2) t "
                "ORDER BY qty",
    "scalar_functions": "SELECT UPPER(product) AS up, LENGTH(product) AS ln,"
                        " ROUND(amount / 7, 1) AS r FROM sales WHERE qty = 1",
    "count_distinct": "SELECT COUNT(DISTINCT region) AS nr FROM sales",
    "cast_coalesce": "SELECT CAST(qty AS DOUBLE) AS q, COALESCE(amount, 0.0) "
                     "AS amt FROM sales WHERE qty >= 5 ORDER BY qty",
    "cast_colons": "SELECT qty::float8 AS q FROM sales LIMIT 1",
    "show_tables": "SHOW TABLES",
    "group_by_ordinal": "SELECT region, MAX(amount) - MIN(amount) AS rng "
                        "FROM sales WHERE amount IS NOT NULL GROUP BY 1 "
                        "ORDER BY 1",
    "anti_join": "SELECT region FROM regions ANTI JOIN sales ON "
                 "regions.region = sales.region",
    "semi_join": "SELECT r.region FROM regions r SEMI JOIN sales s ON "
                 "r.region = s.region ORDER BY region",
    "window_functions": "SELECT g, v, SUM(v) OVER (PARTITION BY g) AS total,"
                        " ROW_NUMBER() OVER (PARTITION BY g ORDER BY v) AS "
                        "rn, RANK() OVER (PARTITION BY g ORDER BY v DESC) "
                        "AS rk, LAG(v) OVER (PARTITION BY g) AS prev FROM w "
                        "ORDER BY g, v",
    "global_window": "SELECT v, SUM(v) OVER () AS s FROM one",
    "mod_div": "SELECT mod(i, 2) AS m, div(i, 2) AS d FROM t",
    "bit_and_or": "SELECT k, bit_and(i) AS ba, bit_or(i) AS bo FROM t "
                  "GROUP BY k ORDER BY k",
    "bit_count": "SELECT bit_count(i) AS bc FROM t",
    "left_right_strpos": "SELECT left(s, 3) AS l, right(s, 3) AS r, "
                         "strpos(s, 'bar') AS p FROM t",
    "split_part": "SELECT split_part(s, '-', 1) AS p FROM t",
    "regexp_like": "SELECT regexp_like(s, '^f') AS r FROM t",
    "concat_ws": "SELECT concat_ws('_', k, s) AS c FROM t",
    "concat_op": "SELECT k || s AS c FROM t",
    "array_agg_quantile": "SELECT k, array_agg(v) AS aa, "
                          "quantile_cont(v, 0.5) AS qc FROM t GROUP BY k "
                          "ORDER BY k",
    "if": "SELECT if(v > 2, 'big', 'small') AS f FROM t",
    "ifnull_nullif": "SELECT ifnull(nullif(v, 1.0), -1) AS n FROM t",
    "strftime": "SELECT strftime(to_date(d), '%Y/%m') AS f FROM t",
    "string_to_array": "SELECT array_to_string(string_to_array(s, '-'), '+')"
                       " AS a FROM t",
    "cbrt": "SELECT cbrt(v) AS c FROM t",
    "first_value": "SELECT first_value(v) OVER (PARTITION BY k) AS f FROM t",
    "window_order_by": "SELECT g, LAG(x, 1) OVER (PARTITION BY g ORDER BY t)"
                       " AS lx, LEAD(x, 1) OVER (PARTITION BY g ORDER BY t) "
                       "AS ld, FIRST_VALUE(x) OVER (PARTITION BY g ORDER BY "
                       "t DESC) AS fv FROM df",
}
UNORDERED = {"union"}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_sql_query_matches_jax(name):
    got = _ctx(pt, "cpu").execute(QUERIES[name], eager=True)
    want = _ctx(ref).execute(QUERIES[name], eager=True)
    assert_frame_equal(got, want, rtol=1e-12, atol=0.0,
                       check_row_order=name not in UNORDERED)


@pytest.mark.parametrize("how", ["lazy", "pl_sql", "frame_sql",
                                 "lazy_sql", "no_from", "sql_expr"])
def test_sql_entry_points(how):
    sales = pt.DataFrame(SALES, device="cpu")
    rsales = ref.DataFrame(SALES)
    q = "SELECT region, SUM(qty) AS q FROM {} GROUP BY region ORDER BY region"
    if how == "lazy":
        lf = _ctx(pt, "cpu").execute("SELECT region FROM sales LIMIT 2")
        assert isinstance(lf, pt.LazyFrame) and lf.collect().height == 2
        return
    if how == "pl_sql":
        got = pt.sql(q.format("sales"), eager=True)
        want = ref.SQLContext(sales=rsales).execute(q.format("sales"),
                                                    eager=True)
    elif how == "frame_sql":
        got = sales.sql(q.format("self"))
        want = rsales.sql(q.format("self"))
    elif how == "lazy_sql":
        got = sales.lazy().sql(q.format("self")).collect()
        want = rsales.lazy().sql(q.format("self")).collect()
    elif how == "no_from":
        # the frame of a query without FROM goes where the registered
        # frames are
        got = pt.SQLContext(s=sales).execute(
            "SELECT 1 + 2 AS x, 'hi' AS s", eager=True)
        assert got.device.type == "cpu"
        want = ref.SQLContext().execute("SELECT 1 + 2 AS x, 'hi' AS s",
                                        eager=True)
    else:
        e = pt.sql_expr("qty * 2 + 1")
        got = sales.select(e.alias("x"))
        want = rsales.select(ref.sql_expr("qty * 2 + 1").alias("x"))
    assert_frame_equal(got, want, check_exact=True)


def test_table_function_names_its_slice():
    ctx = pt.SQLContext(s=pt.DataFrame(SALES, device="cpu"))
    with pytest.raises(NotImplementedError, match="Slice H"):
        ctx.execute("SELECT SUM(a) AS s FROM read_parquet('f.parquet')")


@pytest.mark.parametrize("query,error", [
    ("SELEC x FROM sales", "SQLSyntaxError"),
    ("SELECT x FROM nowhere", "SQLInterfaceError")])
def test_sql_errors_match_jax(query, error):
    for pl, ctx in ((pt, _ctx(pt, "cpu")), (ref, _ctx(ref))):
        with pytest.raises(getattr(pl, error)):
            ctx.execute(query, eager=True)


# --- chip_smoke.py's phase 15: the SQL queries at a small size --------------

def _h2o():
    """G1-shaped data at 2*10^4 rows, with id2, id4 and id5 over 10
    values, so that q6's and q9's groups hold many rows."""
    h = CS.make_h2o_data(20_000, 0)
    rng = np.random.default_rng(5)
    for k in ("id2", "id4", "id5"):
        h[k] = rng.integers(1, 11, len(h[k]), dtype=np.int32)
    return h


H2O = _h2o()
TAQ = CS.make_taq_data(1 << 12, 0)


def _frames(pl, device=None):
    kw = {} if device is None else {"device": device}
    hdf = pl.DataFrame(H2O, **kw)
    d = TAQ[0]
    cols = {k: d[k] for k in ("sym", "ex", "cond", "date", "price",
                              "volume")}
    cols["ts"] = d["ts"].astype("datetime64[us]")
    return hdf, pl.DataFrame(cols, **kw)


PT_FRAMES = _frames(pt, "cpu")
REF_FRAMES = _frames(ref)


@pytest.mark.parametrize("name", [n for n, _, _ in CS.SQL_H2O] +
                         ["sql_trf"])
def test_phase15_sql_matches_jax_oracle_and_twin(name):
    (lf, ms) = [(q, m) for n, q, m in CS.sql_queries(pt, *PT_FRAMES)
                if n == name][0]
    got = lf.collect()
    CS.sql_oracle(name, got, H2O, *TAQ)
    (lr,) = [q for n, q, _ in CS.sql_queries(ref, *REF_FRAMES) if n == name]
    want = lr.collect()
    keys = dict((n, k) for n, _, k in CS.SQL_H2O).get(name)
    ordered = name in ("sql_q8", "sql_trf")
    if name == "sql_trf":
        # at this size many symbols tie (a share of 0 or 1), and the 20
        # that a tie admits may differ: the shares must not
        got, want = got.select("trf_share"), want.select("trf_share")
    elif not ordered:
        got, want = got.sort(list(keys)), want.sort(list(keys))
    assert_frame_equal(got, want, rtol=1e-12, atol=0.0)
    twins = CS.twin_frames(pt, PT_FRAMES[0])
    if name in twins:
        CS.check_twin(name, CS.host_columns(got),
                      CS.host_columns(twins[name].collect()))
