"""The SQL front end of the port (``TorchSession.sql``) on the CPU against
the JAX package's ``TpuSession.sql`` on the same tables, and against the
port's own DataFrame forms.

Three layers, as in the reference's tests/test_sql_frontend.py:
- constructs: each SQL construct the port runs, through both packages'
  ``sql()``;
- the corpus: the 22 texts of ``scale_test.sql_texts`` at
  ``scale_test_specs(0.02)``, seeds 0 and 1, and TPC-H ``Q1_SQL`` and
  ``Q3_SQL`` (dense and sparse keys): each against the reference's SQL
  form and the port's DSL form, with the same exec class tree as the DSL
  form;
- what raises: each construct the port lacks raises NotImplementedError
  naming itself while lowering (the joins and the bare LIMIT, which once
  raised at collect, and UNION, the FROM-less SELECT, unary minus and %,
  which once raised while lowered, now match the reference).

Comparators, named per test: ``scale_test.tables_differ`` (bitwise, in
order), ``tables_differ_unordered`` (a bitwise row multiset, for unsorted
group-by output) and ``tables_close`` (rtol 1e-9, only where f64 sums
add in another order). The port's SQL form against its DSL form is
bitwise: on the CPU both run the same execs on the same inputs."""

import numpy as np
import pytest
import torch

import scale_test
from scale_test import tables_close, tables_differ, tables_differ_unordered
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.models import tpch as jtpch
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.sql import registry as jregistry
from spark_rapids_tpu.sql.errors import SqlAnalysisError as JSqlAnalysisError
from spark_rapids_tpu.sql.errors import SqlParseError as JSqlParseError
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.models import corpus as tcorpus
from spark_rapids_tpu_torch.models import tpch as ttpch
from spark_rapids_tpu_torch.ops.expr import col, lit
from spark_rapids_tpu_torch.overrides.rules import convert
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.plan import nodes as TP
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.sql import registry as tregistry
from spark_rapids_tpu_torch.sql.errors import SqlAnalysisError, SqlParseError

SPARSE_KEYS = {"c_custkey", "o_orderkey", "o_custkey", "l_orderkey"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clear_blocklists():
    """Speculation blocklists are process-wide in both packages."""
    jspec._BLOCKLIST.clear()
    tspec.clear_blocklist()
    yield
    jspec._BLOCKLIST.clear()
    tspec.clear_blocklist()


def _arrays_of(t):
    return (list(t.names), [c.dtype.simple_string() for c in t.columns],
            [(c.data, c.validity) for c in t.columns])


def _reference_table(names, type_names, arrays) -> JHostTable:
    # a NULL literal's column is 'void', which parse_type does not name
    return JHostTable(list(names), [
        JHostColumn(JT.NULL if t == "void" else JT.parse_type(t), d, v)
        for t, (d, v) in zip(type_names, arrays)])


def _as_reference(t) -> JHostTable:
    return _reference_table(*t.to_arrays())


# ---------------------------------------------------------------------------
# constructs
# ---------------------------------------------------------------------------

_T = (["id", "k", "v", "d"], ["bigint", "string", "double", "date"], [
    (np.arange(1, 9, dtype=np.int64), np.ones(8, bool)),
    (np.array(["a", "b", "a", "c", "b", "a", None, "c"], dtype=object),
     np.array([1, 1, 1, 1, 1, 1, 0, 1], bool)),
    (np.array([10.0, 20.0, 30.0, 40.0, 0.0, 60.0, 70.0, 80.0]),
     np.array([1, 1, 1, 1, 0, 1, 1, 1], bool)),
    (np.arange(0, 800, 100, dtype=np.int32), np.ones(8, bool))])
_U = (["k", "w"], ["string", "double"], [
    (np.array(["a", "b", "d"], dtype=object), np.ones(3, bool)),
    (np.array([1.0, 2.0, 3.0]), np.ones(3, bool))])
_TA = (["id", "x"], ["bigint", "double"], [
    (np.array([1, 2], dtype=np.int64), np.ones(2, bool)),
    (np.array([1.0, 2.0]), np.ones(2, bool))])
_TB = (["id", "x"], ["bigint", "double"], [
    (np.array([1, 2], dtype=np.int64), np.ones(2, bool)),
    (np.array([10.0, 20.0]), np.ones(2, bool))])


@pytest.fixture(scope="module")
def s():
    """(port session, reference session), each with temp views t, u, ta and
    tb over the same arrays."""
    ts, js = TorchSession(device="cpu"), TpuSession()
    for name, arrays in (("t", _T), ("u", _U), ("ta", _TA), ("tb", _TB)):
        tfrom(host_table_from_arrays(*arrays), ts) \
            .create_or_replace_temp_view(name)
        jfrom(_reference_table(*arrays), js).create_or_replace_temp_view(name)
    return ts, js


def _both(s, sql):
    ts, js = s
    got = _as_reference(ts.sql(sql).collect_table())
    return got, js.sql(sql).collect_table()


def check(s, sql, comparator=tables_differ):
    got, ref = _both(s, sql)
    assert got.num_rows > 0, sql
    assert comparator(got, ref) is None, sql


# (sql, comparator): every construct the port runs, against the
# reference's sql() result
CONSTRUCTS = {
    "select star": ("SELECT * FROM t", tables_differ),
    "projection arithmetic alias": (
        "SELECT id, v * 2 + 1 AS dv, v / 4 FROM t", tables_differ),
    "comparisons and logic": (
        "SELECT id FROM t WHERE (v > 15 AND v <= 60) OR NOT (id < 5) "
        "OR v <> 30", tables_differ),
    "is null": ("SELECT id FROM t WHERE v IS NULL", tables_differ),
    "is not null": ("SELECT id FROM t WHERE k IS NOT NULL", tables_differ),
    "null-safe equal": (
        "SELECT id, k <=> 'a' AS ka, v <=> 20.0 AS v20 FROM t",
        tables_differ),
    "between": ("SELECT id FROM t WHERE id BETWEEN 2 AND 5", tables_differ),
    "not between": ("SELECT id FROM t WHERE id NOT BETWEEN 2 AND 5",
                    tables_differ),
    "in list": ("SELECT id FROM t WHERE k IN ('a', 'c')", tables_differ),
    "not in list": ("SELECT id FROM t WHERE id NOT IN (1, 3, 5)",
                    tables_differ),
    "searched case": (
        "SELECT id, CASE WHEN v > 50 THEN 'hi' WHEN v > 20 THEN 'mid' "
        "ELSE 'lo' END AS b FROM t", tables_differ),
    "simple case": (
        "SELECT id, CASE k WHEN 'a' THEN 1 WHEN 'b' THEN 2 END AS c FROM t",
        tables_differ),
    "cast": ("SELECT CAST(v AS INT) AS iv, CAST(id AS DOUBLE) AS dv, "
             "CAST(id AS DECIMAL(12, 2)) AS cv FROM t", tables_differ),
    "literals": (
        "SELECT 1 AS a, 1.5 AS b, '[x]' AS c, TRUE AS d, NULL AS e, "
        "2.5BD AS f, 3L AS g, 4D AS h, -7 AS i FROM t WHERE id = 1",
        tables_differ),
    "date literal": ("SELECT id FROM t WHERE d <= DATE '1970-07-20'",
                     tables_differ),
    "conditional functions": (
        "SELECT coalesce(v, 0.0) AS cv, nvl(v, 0) AS nv, ifnull(v, -1.5) "
        "AS iv, nanvl(v, 0.0) AS nn, greatest(v, 25.0) AS g, least(id, 3) "
        "AS l, if(id > 4, k, 'z') AS f FROM t", tables_differ),
    "null functions": (
        "SELECT id FROM t WHERE isnan(v) OR isnull(k) OR NOT isnotnull(v)",
        tables_differ),
    "hash": ("SELECT hash(id, k) AS h, hash(v) AS hv FROM t", tables_differ),
    "group by aggregates": (
        "SELECT k, SUM(v) AS sv, COUNT(v) AS cv, COUNT(*) AS c, AVG(v) AS av, "
        "MIN(v) AS mn, MAX(v) AS mx FROM t GROUP BY k",
        tables_differ_unordered),
    "moments": (
        "SELECT k, STDDEV(v) AS sd, VARIANCE(v) AS var, VAR_POP(v) AS vp, "
        "STDDEV_POP(v) AS sp FROM t GROUP BY k", tables_close),
    "global aggregate": ("SELECT SUM(v) AS sv, COUNT(*) AS n FROM t",
                         tables_differ),
    "group by ordinal": (
        "SELECT k AS grp, SUM(v) AS sv FROM t GROUP BY 1",
        tables_differ_unordered),
    "group by alias": (
        "SELECT k AS grp, SUM(v) AS sv FROM t GROUP BY grp",
        tables_differ_unordered),
    "expression over aggregates": (
        "SELECT k, SUM(v) / COUNT(v) + 1 AS m FROM t GROUP BY k",
        tables_close),
    "having": ("SELECT k, SUM(v) AS sv FROM t GROUP BY k HAVING SUM(v) > 40",
               tables_differ_unordered),
    "having over an alias": (
        "SELECT k, SUM(v) AS sv FROM t GROUP BY k HAVING sv > 40",
        tables_differ_unordered),
    "having over a hidden aggregate": (
        "SELECT k FROM t GROUP BY k HAVING COUNT(*) >= 2",
        tables_differ_unordered),
    "distinct": ("SELECT DISTINCT k FROM t", tables_differ_unordered),
    "order by": ("SELECT id, v FROM t ORDER BY v DESC NULLS LAST, id",
                 tables_differ),
    "order by ordinal": ("SELECT id, v FROM t ORDER BY 2 DESC NULLS LAST",
                         tables_differ),
    "order by a hidden input column": (
        "SELECT k FROM t WHERE v IS NOT NULL ORDER BY v DESC",
        tables_differ),
    "order by limit": ("SELECT id, v FROM t ORDER BY v DESC LIMIT 3",
                       tables_differ),
    "row_number window": (
        "SELECT id, ROW_NUMBER() OVER (PARTITION BY k ORDER BY v) AS rn "
        "FROM t", tables_differ),
    "rank windows": (
        "SELECT id, RANK() OVER (PARTITION BY k ORDER BY v DESC) AS r, "
        "DENSE_RANK() OVER (PARTITION BY k ORDER BY v DESC) AS dr FROM t",
        tables_differ),
    "window group limit": (
        "SELECT * FROM (SELECT id, k, ROW_NUMBER() OVER (PARTITION BY k "
        "ORDER BY id DESC) AS rn FROM t) WHERE rn <= 1", tables_differ),
    "lag and lead windows": (
        "SELECT id, LAG(v) OVER (PARTITION BY k ORDER BY id) AS pv, "
        "LEAD(d, 2) OVER (PARTITION BY k ORDER BY id) AS nd, "
        "LAG(id, 1, -1) OVER (PARTITION BY k ORDER BY id) AS pid FROM t",
        tables_differ),
    "nth_value and percent_rank windows": (
        "SELECT id, NTH_VALUE(v, 2) OVER (PARTITION BY k ORDER BY id) AS nv,"
        " PERCENT_RANK() OVER (PARTITION BY k ORDER BY v) AS pr FROM t",
        tables_differ),
    "aggregate windows over frames": (
        "SELECT id, SUM(id) OVER (PARTITION BY k ORDER BY id ROWS BETWEEN "
        "UNBOUNDED PRECEDING AND CURRENT ROW) AS s, COUNT(*) OVER "
        "(PARTITION BY k ORDER BY d) AS c, MAX(v) OVER (PARTITION BY k "
        "ORDER BY id ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS m, "
        "AVG(v) OVER (PARTITION BY k) AS a FROM t", tables_differ),
    "windows without partition by": (
        "SELECT id, MIN(v) OVER (ORDER BY id) AS m, ROW_NUMBER() OVER "
        "(ORDER BY v DESC, id) AS rn, RANK() OVER (PARTITION BY k ORDER BY "
        "id) AS r FROM t", tables_differ),
    "cte": ("WITH big AS (SELECT * FROM t WHERE v > 25), "
            "two AS (SELECT k FROM big) "
            "SELECT k, COUNT(*) AS c FROM two GROUP BY k",
            tables_differ_unordered),
    "subquery in from": (
        "SELECT kk FROM (SELECT k AS kk, v FROM t) WHERE v > 25",
        tables_differ),
    "inner join using": ("SELECT id, v, w FROM t JOIN u USING (k)",
                         tables_differ_unordered),
    "inner join on": ("SELECT id, v, w FROM t JOIN u ON t.k = u.k",
                      tables_differ_unordered),
    "qualified refs across same-named columns": (
        "SELECT a.x, b.x FROM ta a JOIN tb b ON a.id = b.id ORDER BY a.id",
        tables_differ),
    "star over a join with same-named columns": (
        "SELECT * FROM ta a JOIN tb b ON a.id = b.id",
        tables_differ_unordered),
    "repartition hint": (
        "SELECT /*+ REPARTITION(4, k) */ k, COUNT(*) AS c FROM t GROUP BY k",
        tables_differ_unordered),
    "coalesce hint": (
        "SELECT /*+ COALESCE(2) */ k, COUNT(*) AS c FROM t GROUP BY k",
        tables_differ_unordered),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTS))
def test_construct_matches_reference(s, name):
    sql, comparator = CONSTRUCTS[name]
    check(s, sql, comparator)


def test_literal_types(s):
    ts, _ = s
    df = ts.sql("SELECT 1 AS a, 1.5 AS b, 2.5BD AS f, 3L AS g FROM t "
                "WHERE id = 1")
    # the lexer types 1.5 as a double and 3L as an int, as the reference
    # does (Spark: a decimal(2,1) and a bigint); 2.5BD is decimal(2,1),
    # stored unscaled
    from spark_rapids_tpu_torch import types as T
    assert dict(df.schema) == {"a": T.INT, "b": T.DOUBLE,
                               "f": T.DecimalType(2, 1), "g": T.INT}
    assert df.collect() == [(1, 1.5, 25, 3)]


def test_order_by_matches_the_dsl_sort(s):
    ts, _ = s
    got = ts.sql("SELECT id, v FROM t ORDER BY v DESC NULLS LAST, id")
    want = ts.table("t").select(col("id"), col("v")).sort(
        TP.SortOrder(col("v"), ascending=False, nulls_first=False),
        TP.SortOrder(col("id"), ascending=True))
    assert got.collect() == want.collect()


def test_hints_plan_the_dsl_exchange(s):
    """REPARTITION(n, cols) is the DSL's repartition(n, *cols) (hash);
    COALESCE(n) a round-robin repartition(n), which the exchange has."""
    ts, _ = s

    def exchange(df):
        node = df.plan
        while not isinstance(node, TP.Exchange):
            node = node.children[0]
        return node

    h = exchange(ts.sql("SELECT /*+ REPARTITION(4, k) */ k FROM t"))
    d = exchange(ts.table("t").repartition(4, "k"))
    assert (h.partitioning, h.num_partitions) == ("hash", 4)
    assert [x.key() for x in h.keys] == [x.key() for x in d.keys]
    c = exchange(ts.sql("SELECT /*+ COALESCE(2) */ k FROM t"))
    assert (c.partitioning, c.num_partitions, c.keys) == ("roundrobin", 2, [])


def test_create_drop_temp_view(s):
    ts, js = s
    for sess in (ts, js):
        sess.sql("CREATE TEMP VIEW big AS SELECT * FROM t WHERE v > 25")
    got, ref = _both(s, "SELECT COUNT(*) AS n FROM big")
    assert tables_differ(got, ref) is None
    assert got.columns[0].data.tolist() == [5]
    assert "big" in ts.catalog.list_tables()
    assert len(ts.table("big").collect()) == 5
    for sess in (ts, js):
        sess.sql("CREATE OR REPLACE TEMP VIEW big AS SELECT * FROM t "
                 "WHERE v > 55")
    got, ref = _both(s, "SELECT COUNT(*) AS n FROM big")
    assert tables_differ(got, ref) is None
    assert got.columns[0].data.tolist() == [3]
    with pytest.raises(SqlAnalysisError, match="already exists"):
        ts.sql("CREATE TEMP VIEW big AS SELECT * FROM t")
    for sess in (ts, js):
        sess.sql("DROP VIEW big")
    assert "big" not in ts.catalog.list_tables()
    with pytest.raises(SqlAnalysisError, match="not found"):
        ts.sql("DROP VIEW big")
    ts.sql("DROP VIEW IF EXISTS big")
    with pytest.raises(SqlAnalysisError, match="not found"):
        ts.sql("SELECT * FROM big")


def test_view_holds_the_plan_not_the_name():
    ts = TorchSession(device="cpu")

    def src(n):
        tfrom(host_table_from_arrays(
            ["x"], ["bigint"], [(np.arange(n, dtype=np.int64),
                                 np.ones(n, bool))]), ts) \
            .create_or_replace_temp_view("src")

    src(3)
    ts.sql("CREATE TEMP VIEW snap AS SELECT * FROM src")
    src(10)
    assert ts.sql("SELECT COUNT(*) AS n FROM snap").collect() == [(3,)]
    assert ts.sql("SELECT COUNT(*) AS n FROM src").collect() == [(10,)]


def test_f_expr(s):
    ts, _ = s
    got = ts.table("t").select(TF.expr("v * 2 + id").alias("e"))
    want = ts.table("t").select((col("v") * lit(2) + col("id")).alias("e"))
    assert tables_differ(_as_reference(got.collect_table()),
                         _as_reference(want.collect_table())) is None


def test_global_registered_function(s):
    ts, _ = s
    TF.register_sql_function("twice", lambda e: e * lit(2))
    try:
        got = ts.sql("SELECT twice(v) AS p FROM t").collect_table()
    finally:
        TF.unregister_sql_function("twice")
    want = ts.table("t").select((col("v") * lit(2)).alias("p"))
    assert tables_differ(_as_reference(got),
                         _as_reference(want.collect_table())) is None
    with pytest.raises(SqlAnalysisError, match="undefined function"):
        ts.sql("SELECT twice(v) AS p FROM t")


# parse and analysis errors: the same class, position and caret as the
# reference's
ERRORS = {
    "incomplete where": "SELECT id FROM t WHERE",
    "dangling comma": "SELECT id,\nFROM t",
    "order without by": "SELECT id FROM t ORDER id",
    "trailing tokens": "SELECT id FROM t garbage extra",
    "unterminated string": "SELECT 'oops FROM t",
    "exists subquery": "SELECT id FROM t WHERE EXISTS (SELECT 1 FROM u)",
    "backwards frame": "SELECT SUM(v) OVER (ORDER BY id ROWS UNBOUNDED "
                       "FOLLOWING) FROM t",
    "hint argument": "SELECT /*+ REPARTITION('8', k) */ k FROM t",
    "unknown column": "SELECT nope FROM t",
    "unknown table": "SELECT * FROM no_such_table",
    "undefined function": "SELECT frobnicate(id) FROM t",
    "arity": "SELECT coalesce() FROM t",
    "not grouped": "SELECT k, v FROM t GROUP BY k",
    "standalone interval": "SELECT INTERVAL 3 DAYS FROM t",
    "window inside an expression": "SELECT ROW_NUMBER() OVER (ORDER BY id) "
                                   "+ 1 FROM t",
    "in subquery under or": "SELECT id FROM t WHERE k IN (SELECT k FROM u) "
                            "OR v > 5",
    "unknown hint": "SELECT /*+ BROADCAST(u) */ id FROM t",
    "count distinct": "SELECT COUNT(DISTINCT k) FROM t",
    "bad ordinal": "SELECT id FROM t ORDER BY 3",
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_errors_match_reference(s, name):
    ts, js = s
    sql = ERRORS[name]
    with pytest.raises((JSqlParseError, JSqlAnalysisError)) as jerr:
        js.sql(sql)
    want = SqlParseError if isinstance(jerr.value, JSqlParseError) \
        else SqlAnalysisError
    with pytest.raises(want) as terr:
        ts.sql(sql)
    assert (terr.value.line, terr.value.col) == (jerr.value.line,
                                                  jerr.value.col)
    assert terr.value.raw_msg.split("(")[0] == \
        jerr.value.raw_msg.split("(")[0]
    assert "^" in str(terr.value)


def test_error_positions(s):
    ts, _ = s
    with pytest.raises(SqlParseError) as ei:
        ts.sql("SELECT id FROM t WHERE")
    assert ei.value.line == 1 and ei.value.col >= 23
    with pytest.raises(SqlAnalysisError) as ei:
        ts.sql("SELECT nope FROM t")
    assert "cannot resolve column 'nope'" in str(ei.value)
    assert (ei.value.line, ei.value.col) == (1, 8)


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------

#: constructs whose plan node or expression the port lacks: lowering
#: raises NotImplementedError naming the construct
LOWERING_RAISES = {
    "mixed-type case": ("SELECT CASE WHEN id > 3 THEN 1 ELSE 2.5 END AS c "
                        "FROM t", "CaseWhen over values of types"),
}

#: constructs that raised NotImplementedError while lowered until the port
#: had UNION, the FROM-less SELECT's range, the unary and modular
#: arithmetic, the string, date and hash functions with LIKE, RLIKE,
#: || and DATE +/- INTERVAL, and lag/lead: each now lowers as in the
#: reference and matches its sql() result under the comparator named
LOWERED_NOW = {
    "union all": ("SELECT k FROM t UNION ALL SELECT k FROM u", tables_differ),
    "union distinct": ("SELECT k FROM t UNION SELECT k FROM u",
                       tables_differ_unordered),
    "select without from": ("SELECT 1 AS a", tables_differ),
    "unary minus": ("SELECT -id AS n FROM t", tables_differ),
    "remainder": ("SELECT v % 3 AS r FROM t", tables_differ),
    "date plus interval": ("SELECT d + INTERVAL 3 DAYS AS d2 FROM t",
                           tables_differ),
    "date minus interval": ("SELECT d - INTERVAL 1 WEEK AS d3 FROM t",
                            tables_differ),
    "like": ("SELECT id FROM t WHERE k LIKE 'a%'", tables_differ),
    "rlike": ("SELECT id FROM t WHERE k RLIKE '[ab]'", tables_differ),
    "concat operator": ("SELECT k || '_x' AS kk FROM t", tables_differ),
    "unported builtin (strings)": ("SELECT upper(k) AS uk FROM t",
                                   tables_differ),
    "unported builtin (datetime)": ("SELECT year(d) AS y FROM t",
                                    tables_differ),
    "unported builtin (xxhash64)": ("SELECT xxhash64(id) AS x FROM t",
                                    tables_differ),
    "unported builtin (window)": (
        "SELECT LAG(v, 1) OVER (ORDER BY id) AS pv FROM t", tables_differ),
}


#: constructs that raised NotImplementedError until the port had their
#: source (Delta, [12b]): each now raises the reference's own error for
#: the input given, in both packages
RAISES_AS_REFERENCE = {
    "create view using": (
        "CREATE TEMP VIEW pq USING delta OPTIONS (path '/data/pq')",
        "no delta log at /data/pq"),
}


@pytest.mark.parametrize("name", sorted({**LOWERING_RAISES, **LOWERED_NOW,
                                         **RAISES_AS_REFERENCE}))
def test_unported_construct_raises_when_lowered(s, name):
    """A construct the port lacks raises naming itself; one it has since
    ported (``LOWERED_NOW``) is held to the reference's sql() result, or,
    where the input has no answer (``RAISES_AS_REFERENCE``), to its
    error."""
    if name in RAISES_AS_REFERENCE:
        from spark_rapids_tpu.errors import ColumnarProcessingError as JCPE
        from spark_rapids_tpu_torch.errors import ColumnarProcessingError
        sql, match = RAISES_AS_REFERENCE[name]
        with pytest.raises(ColumnarProcessingError, match=match):
            s[0].sql(sql)
        with pytest.raises(JCPE, match=match):
            s[1].sql(sql)
        return
    if name in LOWERED_NOW:
        sql, comparator = LOWERED_NOW[name]
        check(s, sql, comparator)
        return
    sql, match = LOWERING_RAISES[name]
    with pytest.raises(NotImplementedError, match=match):
        s[0].sql(sql)


def test_unported_registrations_raise(s):
    """A Hive UDF (a pandas UDF in the reference) still raises naming
    itself; a session function resolves in SQL and equals the reference's
    (``tables_differ``); a Delta table with no log raises the
    reference's error (the port's at registration, where it builds the
    scan to check the options; the reference's when read)."""
    with pytest.raises(NotImplementedError, match="hive_udf.py.*pandas"):
        tregistry.register_hive_udf("sql_t_upper", str.upper, "string")
    s[0].catalog.register_function("plus_one", lambda e: e + lit(1))
    from spark_rapids_tpu.ops.expr import lit as jlit
    s[1].catalog.register_function("plus_one", lambda e: e + jlit(1))
    check(s, "SELECT id, plus_one(id) AS p FROM t")
    from spark_rapids_tpu.errors import ColumnarProcessingError as JCPE
    from spark_rapids_tpu_torch.errors import ColumnarProcessingError
    with pytest.raises(ColumnarProcessingError, match="no delta log"):
        s[0].catalog.register_table("pq", "delta", "/data/pq")
    # the reference registers lazily and raises when the table is read
    s[1].catalog.register_table("pq", "delta", "/data/pq")
    with pytest.raises(JCPE, match="no delta log"):
        s[1].sql("SELECT * FROM pq").collect()


#: constructs that raised NotImplementedError at collect until the port
#: had the execs of every join type and of a bare LIMIT: each now lowers
#: as in the reference and matches its sql() result under the comparator
#: named (the row multiset where the join's output order is not defined)
COLLECT_RAISES = {
    "left join": ("SELECT id, w FROM t LEFT JOIN u USING (k)",
                  tables_differ_unordered),
    "right join": ("SELECT id, w FROM t RIGHT JOIN u USING (k)",
                   tables_differ_unordered),
    "full join": ("SELECT k FROM t FULL JOIN u USING (k)",
                  tables_differ_unordered),
    "left semi join": ("SELECT id FROM t LEFT SEMI JOIN u USING (k)",
                       tables_differ),
    "left anti join": ("SELECT id FROM t LEFT ANTI JOIN u USING (k)",
                       tables_differ),
    "cross join": ("SELECT id, w FROM t CROSS JOIN u",
                   tables_differ_unordered),
    "join condition": ("SELECT id, w FROM t JOIN u ON t.k = u.k AND v > w",
                       tables_differ_unordered),
    "in subquery": ("SELECT id FROM t WHERE k IN (SELECT k FROM u)",
                    tables_differ),
    "not in subquery": ("SELECT id FROM t WHERE id NOT IN (SELECT id FROM ta)",
                        tables_differ),
    "scalar subquery": ("SELECT id FROM t WHERE v > (SELECT AVG(v) FROM t)",
                        tables_differ),
    "bare limit": ("SELECT id FROM t LIMIT 2", tables_differ),
}


@pytest.mark.parametrize("name", sorted(COLLECT_RAISES))
def test_unported_exec_raises_at_collect(s, name):
    """Once raising at collect; now each construct against the
    reference's sql() result."""
    sql, comparator = COLLECT_RAISES[name]
    check(s, sql, comparator)


# ---------------------------------------------------------------------------
# the registry and the copied texts
# ---------------------------------------------------------------------------

#: builtins the port's registry has beyond the reference's (which has
#: these functions in functions.py only)
PORT_ONLY_BUILTINS = {"input_file_name", "input_file_block_start",
                      "input_file_block_length"}


def test_registry_names_equal_the_reference_builtins():
    ported, unported = set(tregistry._build_table()), set(tregistry.UNPORTED)
    reference = set(jregistry._build_table())
    assert not ported & unported
    assert not PORT_ONLY_BUILTINS & reference
    assert ported | unported == reference | PORT_ONLY_BUILTINS


def test_copied_texts_equal_the_reference():
    assert tcorpus.sql_texts() == scale_test.sql_texts()
    assert ttpch.Q1_SQL == jtpch.Q1_SQL
    assert ttpch.Q3_SQL == jtpch.Q3_SQL


# ---------------------------------------------------------------------------
# the corpus and TPC-H q1/q3 from SQL text
# ---------------------------------------------------------------------------

SF = 0.02
SEEDS = (0, 1)
#: the corpus's f64-sum queries (tables_close against the reference, as
#: tests/test_torch_corpus_wide.py does); the rest compare bitwise
F64_SUMS = ("q1", "q2", "q3", "q4", "q9", "q10", "q12", "q14", "q15",
            "q17", "q19")
#: unsorted group-by outputs, where the two packages may emit groups in
#: another order
UNORDERED = ("q7",)

_TABLES = {}


def _tables(seed):
    """(port tables, reference tables), generated once per seed."""
    if seed not in _TABLES:
        tabs = tcorpus.corpus_tables(SF, seed)
        _TABLES[seed] = (tabs, {n: _as_reference(t)
                                for n, t in tabs.items()})
    return _TABLES[seed]


def _exec_tree(df):
    def walk(e):
        return (type(e).__name__, tuple(walk(c) for c in e.children))
    sess = df.session
    return walk(convert(df.plan, sess.conf, sess.device))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", tcorpus.CORPUS)
def test_corpus_sql_matches_reference_and_dsl(name, seed):
    ttabs, jtabs = _tables(seed)
    ref = scale_test.build_sql_queries(TpuSession(), jtabs)[name]() \
        .collect_table()
    tsess = TorchSession(device="cpu")
    sql_df = tcorpus.build_sql_queries(tsess, ttabs)[name]()
    dsl_df = tcorpus.build_queries(tsess, ttabs)[name]()
    assert _exec_tree(sql_df) == _exec_tree(dsl_df)
    got = _as_reference(sql_df.collect_table())
    assert got.num_rows > 0
    tspec.clear_blocklist()
    assert tables_differ(got, _as_reference(dsl_df.collect_table())) is None
    if name in F64_SUMS:
        assert tables_close(got, ref, rtol=1e-9) is None
    elif name in UNORDERED:
        assert tables_differ_unordered(got, ref) is None
    else:
        assert tables_differ(got, ref) is None


@pytest.mark.parametrize("seed", SEEDS)
def test_conditional_query_matches_reference(seed):
    """chip_smoke.py's conditional query (a string CASE group key, CASE
    counts, COALESCE over IF, GREATEST under MAX) over the corpus's
    lineitem: counts and int64 sums bitwise, the f64 sum within rtol 1e-9
    (tables_close)."""
    from chip_smoke import CONDITIONAL_SQL
    ttabs, jtabs = _tables(seed)
    js, ts = TpuSession(), TorchSession(device="cpu")
    jfrom(jtabs["lineitem"], js).create_or_replace_temp_view("lineitem")
    tfrom(ttabs["lineitem"], ts).create_or_replace_temp_view("lineitem")
    ref = js.sql(CONDITIONAL_SQL).collect_table()
    got = _as_reference(ts.sql(CONDITIONAL_SQL).collect_table())
    assert got.column("flag_class").data.tolist() == [
        "S00000000", "S00000001", "flag0", "rest"]
    assert tables_close(got, ref, rtol=1e-9) is None
    exact = [n for n in got.names if n != "kept_price"]
    assert tables_differ(
        JHostTable(exact, [got.column(n) for n in exact]),
        JHostTable(exact, [ref.column(n) for n in exact])) is None


def test_q1_sql_matches_dataframe_and_reference():
    table = jtpch.lineitem_table(20000, seed=3)
    ref = jtpch.q1_sql(TpuSession(), table).collect_table()
    ttable = host_table_from_arrays(*_arrays_of(table))
    tsess = TorchSession(device="cpu")
    sql_df = ttpch.q1_sql(tsess, ttable)
    dsl_df = ttpch.q1_dataframe(tsess, ttable)
    assert _exec_tree(sql_df) == _exec_tree(dsl_df)
    got = _as_reference(sql_df.collect_table())
    assert got.num_rows == 6
    assert tables_differ(got, _as_reference(dsl_df.collect_table())) is None
    assert tables_close(got, ref, rtol=1e-9) is None


def _sparse(arrays_of_table):
    names, types, arrays = arrays_of_table
    return names, types, [
        ((d.astype(np.int64) * 0x9E3779B1) & ((1 << 40) - 1), v)
        if n in SPARSE_KEYS else (d, v) for n, (d, v) in zip(names, arrays)]


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_q3_sql_matches_dataframe_and_reference(form):
    """Q3_SQL against q3_dataframe (the same exec tree, result and
    metrics, replays included) and, for the dense form, against the
    reference's Q3_SQL. The sparse form's DSL result is held to the
    reference at these inputs by tests/test_torch_q3.py (its reference
    runs the hash probe in interpret mode, the slowest run here)."""
    tabs = [_arrays_of(t) for t in jtpch.q3_tables(40000, seed=1)]
    if form == "sparse":
        tabs = [_sparse(t) for t in tabs]
    ttabs = [host_table_from_arrays(*t) for t in tabs]
    tsess = TorchSession(device="cpu")
    sql_df = ttpch.q3_sql(tsess, *ttabs)
    dsl_df = ttpch.q3_dataframe(tsess, *ttabs)
    assert _exec_tree(sql_df) == _exec_tree(dsl_df)
    got = _as_reference(sql_df.collect_table())
    m_sql = tsess.last_metrics()
    assert got.num_rows == 10
    if form == "sparse":
        assert m_sql["speculationReplays"] >= 1
        assert m_sql["hashProbeBatches"] >= 1
    else:
        assert m_sql["directJoinBatches"] == 2
    tspec.clear_blocklist()
    want = _as_reference(dsl_df.collect_table())
    m_dsl = tsess.last_metrics()
    assert tables_differ(got, want) is None
    assert m_sql == m_dsl
    if form == "sparse":
        return
    ref = jtpch.q3_sql(TpuSession(), *[_reference_table(*t) for t in tabs]) \
        .collect_table()
    assert tables_close(got, ref, rtol=1e-9) is None
    exact = ["l_orderkey", "n"]
    assert tables_differ(
        JHostTable(exact, [got.column(n) for n in exact]),
        JHostTable(exact, [ref.column(n) for n in exact])) is None


def test_sql_dataframe_is_bound_to_the_session():
    ts = TorchSession(device="cpu")
    tfrom(host_table_from_arrays(*_T), ts).create_or_replace_temp_view("t")
    df = ts.sql("SELECT id FROM t WHERE d > DATE '1970-01-02'")
    assert df.session is ts and ts.device.type == "cpu"
    assert df.columns == ["id"]
    assert df.collect() == [(i,) for i in range(2, 9)]
