"""The port's set and source operators and FIRST/LAST, on the CPU against
the JAX package's TpuSession on the same numpy inputs: UNION ALL (strings
with their own dictionaries in each arm, masked and prefix arms), UNION
DISTINCT, spark.range (one batch, and several through the plan node's
batch size), the FROM-less SELECT, Sample (the same rows as the
reference, bit for bit, over several batches and behind a filter),
``cache()`` (the child runs once), Expand through its plan node, and
FIRST/LAST with and without ``ignore_nulls`` on the no-sort,
sort-segment and global layouts, also over many batches with the
aggregate's coalesce target at 1 byte (every batch a partial; the merge
keeps batch order) against the reference's one-batch answer.

Comparators: ``scale_test.tables_differ`` (bitwise, in order) where the
output order is defined (a union's arms in order, a sample, a sorted
result, a projection); ``tables_differ_unordered`` (a bitwise row
multiset) for group-by output."""

import datetime

import numpy as np
import pytest
import torch

from scale_test import tables_differ, tables_differ_unordered
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.ops.expr import lit as jlit
from spark_rapids_tpu.plan import DataFrame as JDataFrame
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.plan import nodes as JP
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.execs import basic as xbasic
from spark_rapids_tpu_torch.execs.basic import TpuFilterExec, TpuScanExec
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.ops.expr import lit as tlit
from spark_rapids_tpu_torch.plan import DataFrame as TDataFrame
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.plan import nodes as TP
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.session import TorchSession


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clear_blocklists():
    jspec._BLOCKLIST.clear()
    tspec.clear_blocklist()
    yield
    jspec._BLOCKLIST.clear()
    tspec.clear_blocklist()


def _reference_table(names, type_names, arrays) -> JHostTable:
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(t), d, np.asarray(v, dtype=bool))
        for t, (d, v) in zip(type_names, arrays)])


def _as_reference(t) -> JHostTable:
    return _reference_table(*t.to_arrays())


class _Api:
    """One package's entry points, so one query text builds both forms."""

    def __init__(self, frm, DataFrame, P, F, col, lit, session):
        self.frm, self.DataFrame, self.P = frm, DataFrame, P
        self.F, self.col, self.lit, self.session = F, col, lit, session

    def df(self, arrays, num_batches=1):
        table = (host_table_from_arrays(*arrays) if self.P is TP
                 else _reference_table(*arrays))
        return self.frm(table, self.session, num_batches)


def _apis(conf=None):
    return (_Api(tfrom, TDataFrame, TP, TF, tcol, tlit,
                 TorchSession(conf, device="cpu")),
            _Api(jfrom, JDataFrame, JP, JF, jcol, jlit, TpuSession(conf)))


def _both(query, conf=None):
    """(port result as a reference table, reference result) of
    ``query(api)``."""
    port, ref = _apis(conf)
    return (_as_reference(query(port).collect_table()),
            query(ref).collect_table())


def _facts(seed=0, n=600):
    """A fact table: a small int key, a string key (null on some rows), a
    double, a decimal(15,2), a bigint with nulls and a date."""
    rng = np.random.default_rng(seed)
    words = np.array(["AIR", "MAIL", "RAIL", "SHIP", "TRUCK"], dtype=object)
    return (["k", "s", "x", "d", "v", "t"],
            ["bigint", "string", "double", "decimal(15,2)", "bigint",
             "date"],
            [(rng.integers(0, 6, n).astype(np.int64), np.ones(n, bool)),
             (words[rng.integers(0, 5, n)], rng.random(n) > 0.1),
             (rng.standard_normal(n) * 100.0, rng.random(n) > 0.05),
             (rng.integers(-10 ** 9, 10 ** 9, n), rng.random(n) > 0.1),
             (rng.integers(-50, 50, n).astype(np.int64),
              rng.random(n) > 0.3),
             (rng.integers(9000, 11000, n).astype(np.int32),
              np.ones(n, bool))])


def _day(n: int) -> datetime.date:
    return datetime.date(1970, 1, 1) + datetime.timedelta(days=n)


def _check(got, ref, comparator=tables_differ):
    assert got.num_rows > 0
    assert comparator(got, ref) is None, comparator(got, ref)


# ---------------------------------------------------------------------------
# UNION
# ---------------------------------------------------------------------------

def test_union_all_keeps_both_arms_in_order():
    """A filtered (masked) arm, then a prefix arm over another table whose
    string dictionary differs: rows in arm order, strings decoded through
    each arm's dictionary, the first arm's names."""
    a, b = _facts(1, 300), _facts(2, 200)

    def q(api):
        left = api.df(a).filter(api.col("x") > api.lit(0.0)).select(
            "k", "s", "d")
        right = api.df(b).select("k", "s", "d")
        return left.union(right)

    _check(*_both(q))


def test_union_feeds_an_aggregate_and_a_sort():
    """UNION ALL of two date-filtered arms, then SUM and COUNT per string
    key (the port's O4a); and the same union sorted."""
    f = _facts(3)

    def arms(api):
        d = api.df(f, num_batches=2)
        return (d.filter(api.col("t") < api.lit(_day(9500))).union(
            d.filter(api.col("t") >= api.lit(_day(10500)))))

    _check(*_both(lambda api: arms(api).group_by("s").agg(
        api.F.sum("d").alias("sd"), api.F.count("*").alias("n"),
        api.F.sum("v").alias("sv"))), tables_differ_unordered)
    _check(*_both(lambda api: arms(api).sort("t", "k", "x")))


@pytest.mark.parametrize("distinct", [False, True], ids=["all", "distinct"])
def test_union_from_sql(distinct):
    """UNION ALL and UNION (DISTINCT) of two order filters through both
    packages' sql(), and COUNT(*) of the distinct keys (the port's O4b)."""
    f = _facts(4)
    op = "UNION" if distinct else "UNION ALL"
    text = (f"SELECT COUNT(*) AS n FROM (SELECT k FROM f WHERE x > 50.0 {op} "
            "SELECT k FROM f WHERE v < 0)")
    rows = (f"SELECT k, s FROM f WHERE x > 50.0 {op} SELECT k, s FROM f "
            "WHERE v < 0")
    port, ref = _apis()
    for api in (port, ref):
        api.df(f).create_or_replace_temp_view("f")
    for sql, comparator in ((text, tables_differ),
                            (rows, tables_differ_unordered if distinct
                             else tables_differ)):
        _check(_as_reference(port.session.sql(sql).collect_table()),
               ref.session.sql(sql).collect_table(), comparator)


def test_union_schema_mismatch_raises():
    port, _ = _apis()
    f = _facts(5, 10)
    with pytest.raises(Exception, match="UNION schema mismatch"):
        port.df(f).select("k").union(port.df(f).select("x"))


# ---------------------------------------------------------------------------
# range and the FROM-less SELECT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start,end,step,batch_rows", [
    (0, 1000, 1, 1 << 20), (5, -333, -7, 1 << 20), (0, 1000, 3, 64),
    (-500, 500, 1, 128), (10, 10, 1, 1 << 20)])
def test_range_matches_the_reference(start, end, step, batch_rows):
    """spark.range's rows (in order), and sum(id % 7), max(-id) and count
    over them, in one batch and in several; an empty range yields one
    empty batch (count 0, the rest null)."""
    def rng_df(api):
        return api.DataFrame(api.P.RangeNode(start, end, step, batch_rows),
                             api.session)

    got, ref = _both(rng_df)
    assert tables_differ(got, ref) is None
    _check(*_both(lambda api: rng_df(api).agg(
        api.F.sum(api.col("id") % api.lit(7)).alias("s"),
        api.F.max(-api.col("id")).alias("m"),
        api.F.count("*").alias("n"))))


def test_session_range():
    port, ref = _apis()
    got = port.session.range(3, 40, 4).collect()
    assert got == ref.session.range(3, 40, 4).collect()
    assert port.session.range(5).collect() == [(i,) for i in range(5)]


@pytest.mark.parametrize("sql", [
    "SELECT 1 + 2, abs(-3), -(4)",
    "SELECT 1 + 2 AS a, abs(-3) AS b, -(4) AS c, 7 % 3 AS d",
    "SELECT -(2.5) AS x, abs(-0.25) AS y"])
def test_select_without_from(sql):
    """Over the reference's one-row range: same names, types and values."""
    port, ref = _apis()
    _check(_as_reference(port.session.sql(sql).collect_table()),
           ref.session.sql(sql).collect_table())


# ---------------------------------------------------------------------------
# sample and cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_batches", [1, 3])
@pytest.mark.parametrize("fraction,seed", [(0.01, 7), (0.3, 0), (0.9, 5)])
def test_sample_keeps_the_reference_rows(num_batches, fraction, seed):
    """The same rows as the reference's sample, bit for bit, in order:
    each batch draws from one seeded numpy stream; behind a filter the
    draw is over the filter's compacted rows."""
    f = _facts(6, 2000)

    def q(api):
        return api.df(f, num_batches).sample(fraction, seed=seed)

    _check(*_both(q))
    _check(*_both(lambda api: api.df(f, num_batches).filter(
        api.col("x") > api.lit(0.0)).sample(fraction, seed=seed)))


def test_sample_then_aggregate():
    """The corpus q1's aggregate over a 1% sample (the port's O7)."""
    f = _facts(7, 5000)
    _check(*_both(lambda api: api.df(f).sample(0.01, seed=7).group_by(
        "s").agg(api.F.sum("v").alias("sv"), api.F.count("*").alias("n"),
                 api.F.sum("d").alias("sd"))), tables_differ_unordered)


def test_cache_runs_its_child_once():
    """Two group-bys over one cached filter: the reference's answers, and
    the second query scans the kept table (no filter exec in its plan)."""
    f = _facts(8)
    port, ref = _apis()
    outs = []
    for api in (port, ref):
        c = api.df(f).filter(api.col("x") > api.lit(10.0)).cache()
        first = c.group_by("k").agg(api.F.count("*").alias("n"),
                                    api.F.max("d").alias("m"))
        second = c.group_by("s").agg(api.F.sum("v").alias("sv"))
        outs.append((first.collect_table(), second.collect_table(), c))
    (t1, t2, tc), (j1, j2, _) = outs
    _check(_as_reference(t1), j1, tables_differ_unordered)
    _check(_as_reference(t2), j2, tables_differ_unordered)
    kept = tc.plan._table
    assert kept is not None
    tc.group_by("k").agg(TF.count("*")).collect_table()
    assert tc.plan._table is kept

    def execs(e):
        yield e
        for c in e.children:
            yield from execs(c)

    tree = list(execs(port.session._last_root))
    assert any(isinstance(e, TpuScanExec) for e in tree)
    assert not any(isinstance(e, TpuFilterExec) for e in tree)


# ---------------------------------------------------------------------------
# Expand, through its plan node
# ---------------------------------------------------------------------------

def test_expand_through_its_plan_node():
    """Each row through two projections (the shape Spark gives ROLLUP:
    (k, s) and (k, NULL)), then a group-by over them; and Expand's rows
    themselves, sorted."""
    f = _facts(9)

    def expand(api):
        d = api.df(f).filter(api.col("v") > api.lit(0))
        projections = [
            [api.col("k"), api.col("s"), api.col("d"), api.lit(0)],
            [api.col("k"), api.lit(None).cast("string"), api.col("d"),
             api.lit(1)]]
        return api.DataFrame(api.P.Expand(d.plan, projections,
                                          ["k", "s", "d", "gid"]),
                             api.session)

    _check(*_both(lambda api: expand(api).group_by("k", "s", "gid").agg(
        api.F.sum("d").alias("sd"), api.F.count("*").alias("n"))),
        tables_differ_unordered)
    _check(*_both(lambda api: expand(api).sort("gid", "k", "s", "d")))


# ---------------------------------------------------------------------------
# FIRST / LAST
# ---------------------------------------------------------------------------

LAYOUTS = {"no-sort": None,
           "sort-segment": {"spark.rapids.tpu.agg.maxDictGroups": "0"},
           "global": None}


def _picks(api):
    F, col = api.F, api.col
    return [F.first("v").alias("fv"), F.last("v").alias("lv"),
            F.first("v", True).alias("fvn"), F.last("v", True).alias("lvn"),
            F.first("s").alias("fs"), F.last("s", True).alias("lsn"),
            F.first("d").alias("fd"), F.last("x").alias("lx"),
            F.first(col("d") * col("d")).alias("fdd"),
            F.last("t", True).alias("lt")]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_first_last_match_the_reference(layout):
    """FIRST/LAST of bigint (nulls), string, decimal(15,2), DECIMAL128,
    double and date, with and without ignore_nulls, grouped by an int
    key (no-sort or sort-segment) or global."""
    f = _facts(10)

    def q(api):
        d = api.df(f)
        if layout == "global":
            return d.agg(*_picks(api))
        return d.group_by("k").agg(*_picks(api))

    _check(*_both(q, LAYOUTS[layout]), tables_differ_unordered)


@pytest.mark.parametrize("layout", ["no-sort", "sort-segment", "global"])
def test_first_last_over_many_batches(layout, monkeypatch):
    """Six input batches, the port's coalesce target at 1 byte: each batch
    aggregates to a partial and the merge's FIRST/LAST over the
    partials, in batch order, equal the reference's one-batch answer."""
    f = _facts(11, 900)
    monkeypatch.setattr(xbasic, "BATCH_SIZE_BYTES", 1)
    port, ref = _apis(LAYOUTS[layout])

    def q(api):
        d = api.df(f, num_batches=6).filter(api.col("x") > api.lit(-50.0))
        if layout == "global":
            return d.agg(*_picks(api), api.F.count("*").alias("n"))
        return d.group_by("s").agg(*_picks(api), api.F.count("*").alias("n"))

    got = q(port).collect_table()
    assert port.session.last_metrics().get("partialAggBatches") == 6
    _check(_as_reference(got), q(ref).collect_table(),
           tables_differ_unordered)


def test_first_last_from_sql():
    """first(x) and last(x) resolve through the registry (ignore_nulls
    false, as the reference's). FIRST and LAST are keywords of both
    packages' parser (NULLS FIRST), so the calls quote their names."""
    f = _facts(12)
    port, ref = _apis()
    for api in (port, ref):
        api.df(f).create_or_replace_temp_view("f")
    sql = ("SELECT k, `first`(v) AS fv, `last`(s) AS ls, count(*) AS n "
           "FROM f GROUP BY k")
    _check(_as_reference(port.session.sql(sql).collect_table()),
           ref.session.sql(sql).collect_table(), tables_differ_unordered)
