"""The port's user surface beyond the query operators, held against the JAX
package's on the same numpy inputs: ``GroupedData.pivot``, the device
export ``DataFrame.to_device_arrays``, ``DataFrame.explain`` (its SQL
header, ``CollectLimit[n]``), ``spark.rapids.sql.mode=explainOnly``,
``create_dataframe``, ``set_conf``, ``from_pydict``/``to_pydict``, the
table and column helpers, and the knobs ``spark.rapids.sql.batchSizeBytes``,
``spark.rapids.tpu.scan.deviceCache``, ``spark.rapids.tpu.agg.fuseInput``
and ``spark.rapids.sql.nestedLoopJoin.pairBudget``.

Comparators, named per test: ``tables_close`` (rtol 1e-9) for f64 sums
the packages add in different orders, ``tables_differ_unordered`` for a
result whose row order is the group emission's, ``tables_differ`` for
the rest; device arrays compare as numpy over their live rows.
"""

import re

import numpy as np
import pytest

from scale_test import tables_close, tables_differ, tables_differ_unordered
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.ops.expr import lit as jlit
from spark_rapids_tpu.plan import dataframe as jdataframe
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.ops.expr import lit as tlit
from spark_rapids_tpu_torch.plan import dataframe as tdataframe
from spark_rapids_tpu_torch.session import TorchSession
from tests.torch_service_util import as_reference, reset_process_state


class _Api:
    def __init__(self, col, lit, F, session):
        self.col, self.lit, self.F, self.session = col, lit, F, session


PORT = _Api(tcol, tlit, TF, lambda conf=None: TorchSession(conf,
                                                           device="cpu"))
REF = _Api(jcol, jlit, JF, lambda conf=None: TpuSession(conf))


@pytest.fixture(autouse=True)
def _clean_state():
    reset_process_state()
    yield
    reset_process_state()


def _data(n=2000, seed=1):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 5, n).astype(np.int64),
            "p": np.array(["x", "y", "z"], dtype=object)[
                rng.integers(0, 3, n)],
            "q": rng.integers(0, 3, n).astype(np.int64),
            "v": rng.random(n)}


def _both(build, data, conf=None, num_batches=1):
    """(port result as the reference's HostTable, reference result)."""
    got = build(PORT, PORT.session(conf).create_dataframe(
        data, num_batches=num_batches)).collect_table()
    want = build(REF, REF.session(conf).create_dataframe(
        data, num_batches=num_batches)).collect_table()
    return as_reference(got), want


def _ref_metric(session, name, op=""):
    """A metric of the reference's ``last_metrics()`` text, on the line of
    exec ``op`` when one is named."""
    m = re.search(rf"{op}[^\n]*\b{name}=(\d+)", str(session.last_metrics()))
    return int(m.group(1)) if m else 0


# --- pivot --------------------------------------------------------------------

def test_pivot():
    """The reference's first pivot case: one sum per pivot value
    (``tables_close``: f64 sums)."""
    got, want = _both(lambda a, df: df.group_by("k").pivot(
        "p", ["x", "y"]).agg(a.F.sum(a.col("v"))).sort("k"), _data())
    assert list(got.names) == ["k", "x", "y"]
    assert tables_close(got, want, rtol=1e-9) is None


def test_pivot_multiple_aggs():
    """The reference's second case: labels ``v_name`` for several
    aggregates (``tables_differ_unordered``: exact values)."""
    data = {"k": np.asarray([0, 0, 1], dtype=np.int64),
            "p": np.array(["x", "y", "x"], dtype=object),
            "v": np.asarray([1.0, 2.0, 3.0])}
    got, want = _both(lambda a, df: df.group_by("k").pivot(
        "p", ["x", "y"]).agg(a.F.sum(a.col("v")).alias("s"),
                             a.F.count(a.col("v")).alias("c")), data)
    assert list(got.names) == ["k", "x_s", "x_c", "y_s", "y_c"]
    assert tables_differ_unordered(got, want) is None


def test_pivot_count_star_counts_matching_rows():
    """``count(*)`` in a pivot counts the rows of each pivot value
    (``tables_differ_unordered``), checked against numpy too."""
    data = _data(500, 3)
    got, want = _both(lambda a, df: df.group_by("k").pivot(
        "p", ["x", "z"]).agg(a.F.count().alias("n"),
                             a.F.max(a.col("q")).alias("m")), data)
    assert tables_differ_unordered(got, want) is None
    rows = {r[0]: r for r in zip(*[c.to_pylist() for c in got.columns])}
    for k in range(5):
        sel = data["k"] == k
        assert rows[k][1] == int((sel & (data["p"] == "x")).sum())
        assert rows[k][3] == int((sel & (data["p"] == "z")).sum())


def test_pivot_on_an_integer_column():
    """A numeric pivot column (the values are ints) with sums of doubles
    and counts (``tables_close`` for the sums)."""
    got, want = _both(lambda a, df: df.group_by("p").pivot(
        "q", [0, 2]).agg(a.F.sum(a.col("v")).alias("s"),
                         a.F.count().alias("n")).sort("p"), _data())
    assert list(got.names) == ["p", "0_s", "0_n", "2_s", "2_n"]
    assert tables_close(got, want, rtol=1e-9) is None


# --- the device export ---------------------------------------------------------

def _export_both(build, data, num_batches=1):
    pdf = build(PORT, PORT.session().create_dataframe(
        data, num_batches=num_batches))
    rdf = build(REF, REF.session().create_dataframe(
        data, num_batches=num_batches))
    return pdf.to_device_arrays(), rdf.to_device_arrays()


def _live(arrays, n):
    """{name: (data, validity[, dictionary])} as numpy over n live rows."""
    out = {}
    for name, parts in arrays.items():
        data = np.asarray(parts[0].cpu() if hasattr(parts[0], "cpu")
                          else parts[0])[:n]
        valid = np.asarray(parts[1].cpu() if hasattr(parts[1], "cpu")
                           else parts[1])[:n]
        out[name] = (data, valid) + tuple(parts[2:])
    return out


def test_to_device_arrays_matches_the_reference():
    """A filtered projection over several batches: the port's tensors
    stay on its device and equal the reference's arrays over the live
    rows; a string column exports codes and its dictionary."""
    (parr, pn), (rarr, rn) = _export_both(
        lambda a, df: df.filter(a.col("q") > a.lit(0)).select(
            "k", "p", (a.col("v") * a.lit(2.0)).alias("w")),
        _data(), num_batches=3)
    assert pn == rn
    assert all(t.device.type == "cpu" for parts in parr.values()
               for t in parts[:2])
    got, want = _live(parr, pn), _live(rarr, rn)
    assert sorted(got) == sorted(want) == ["k", "p", "w"]
    for name in ("k", "w"):
        assert np.array_equal(got[name][0], want[name][0]), name
        assert np.array_equal(got[name][1], want[name][1]), name
    # strings: codes into each package's sorted dictionary
    assert len(got["p"]) == len(want["p"]) == 3
    decode = lambda c, d: [d[i] for i in c]  # noqa: E731
    assert decode(got["p"][0], got["p"][2]) == decode(want["p"][0],
                                                      want["p"][2])
    assert list(got["p"][2]) == sorted(got["p"][2])


def test_to_device_arrays_of_an_aggregate_equals_collect():
    """The export of a group-by equals its ``collect_table`` row for row
    (the same plan, nothing downloaded on the way)."""
    s = TorchSession(device="cpu")
    df = s.create_dataframe(_data()).group_by("k").agg(
        TF.sum("v").alias("s"), TF.count().alias("n"))
    arrays, n = df.to_device_arrays()
    table = df.collect_table()
    assert n == table.num_rows == 5
    for name, c in zip(table.names, table.columns):
        assert np.array_equal(arrays[name][0][:n].numpy(), c.data), name


def test_to_device_arrays_without_a_session():
    """A session-less frame runs on the CPU route and uploads once, to
    the device asked for; the reference's session-less export gives the
    same arrays."""
    data = {"a": np.arange(10, dtype=np.int64),
            "s": np.array(list("abcdeabcde"), dtype=object)}
    pdf = tdataframe.from_pydict(data).filter(tcol("a") > tlit(3))
    rdf = jdataframe.from_pydict(data).filter(jcol("a") > jlit(3))
    (parr, pn), (rarr, rn) = pdf.to_device_arrays(device="cpu"), \
        rdf.to_device_arrays()
    assert pn == rn == 6
    got, want = _live(parr, pn), _live(rarr, rn)
    assert np.array_equal(got["a"][0], want["a"][0])
    assert [got["s"][2][i] for i in got["s"][0]] == \
        [want["s"][2][i] for i in want["s"][0]]


# --- explain and explainOnly ----------------------------------------------------

def test_explain_equals_the_reference():
    """``DataFrame.explain``: the tagged tree, ``CollectLimit[n]`` for an
    unordered limit, equal to the reference's text."""
    def q(a, s):
        return s.create_dataframe(_data(100)).filter(
            a.col("k") > a.lit(1)).select("k", "v").limit(7)
    got = q(PORT, PORT.session()).explain()
    want = q(REF, REF.session()).explain()
    assert "CollectLimit[7]" in got
    assert got == want


def test_explain_sql_header_and_the_unsessioned_tree():
    """A SQL-made frame's explain is headed by its text on one line; a
    session-less frame's is its plan tree."""
    text = "SELECT k,\n   v FROM t\n WHERE k > 2 LIMIT 3"
    ps, rs = PORT.session(), REF.session()
    ps.create_dataframe(_data(50)).create_or_replace_temp_view("t")
    rs.create_dataframe(_data(50)).create_or_replace_temp_view("t")
    got, want = ps.sql(text).explain(), rs.sql(text).explain()
    assert got.splitlines()[0] == "-- SQL: SELECT k, v FROM t WHERE k > 2 " \
        "LIMIT 3"
    assert got == want
    data = {"a": np.arange(4, dtype=np.int64)}
    assert tdataframe.from_pydict(data).limit(2).explain() == \
        jdataframe.from_pydict(data).limit(2).explain()


def test_explain_only_runs_on_the_route_with_the_tags(capsys):
    """explainOnly: the plan is tagged and printed, runs wholly on the CPU
    route with no kernel launch, ``last_meta`` holds the tags, and the
    answer is the reference's (``tables_differ_unordered``)."""
    conf = {"spark.rapids.sql.mode": "explainOnly",
            "spark.rapids.sql.explain": "ALL"}
    got, want = _both(lambda a, df: df.filter(a.col("q") > a.lit(0))
                      .group_by("k").agg(a.F.sum(a.col("q")).alias("s")),
                      _data(), conf)
    assert tables_differ_unordered(got, want) is None
    out = capsys.readouterr().out
    assert "Aggregate" in out and "Filter" in out
    s = TorchSession(conf, device="cpu")
    s.create_dataframe(_data(100)).group_by("k").agg(
        TF.count().alias("n")).collect()
    assert s.last_meta is not None and s.last_meta.can_run_on_gpu
    assert s.last_dispatches == 0
    from spark_rapids_tpu_torch.execs.base import CpuRootExec
    assert isinstance(s._last_root, CpuRootExec)
    # the mode is case-insensitive; an unknown mode raises
    assert TorchSession({"spark.rapids.sql.mode": "EXPLAINONLY"},
                        device="cpu").conf.is_explain_only
    with pytest.raises(ValueError):
        TorchSession({"spark.rapids.sql.mode": "sometimes"},
                     device="cpu").conf.is_explain_only


# --- create_dataframe, set_conf and the helpers -----------------------------------

def test_create_dataframe_from_a_dict_and_a_table():
    """A dict (lists, numpy arrays, dtypes) and a HostTable, one or
    several batches: the reference's tables (``tables_differ``)."""
    data = {"i": [1, None, 3], "s": ["a", None, "c"],
            "d": np.asarray([0.5, 1.5, 2.5]),
            "t": np.asarray([1, 2, 3], dtype=np.int32)}
    for nb in (1, 2):
        got = TorchSession(device="cpu").create_dataframe(
            data, dtypes={"i": TT.LONG}, num_batches=nb).collect_table()
        want = TpuSession().create_dataframe(
            data, dtypes={"i": JT.LONG}, num_batches=nb).collect_table()
        assert tables_differ(want, as_reference(got)) is None
    table = HostTable.from_pydict({"x": [1, 2]})
    assert TorchSession(device="cpu").create_dataframe(table).collect() == \
        [(1,), (2,)]
    with pytest.raises(TypeError):
        TorchSession(device="cpu").create_dataframe([1, 2])


def test_create_dataframe_refuses_pandas_by_name():
    class DataFrame:  # stands in for a pandas frame (pandas is not used)
        pass
    DataFrame.__module__ = "pandas.core.frame"
    with pytest.raises(NotImplementedError, match="pandas"):
        TorchSession(device="cpu").create_dataframe(DataFrame())


def test_set_conf():
    """``set_conf`` changes the next query's conf and returns the session;
    an unknown key raises, as at construction."""
    s = TorchSession(device="cpu")
    assert s.set_conf("spark.sql.ansi.enabled", "true") is s
    from spark_rapids_tpu_torch.conf import ANSI_ENABLED
    assert s.conf.get_entry(ANSI_ENABLED) is True
    with pytest.raises(NotImplementedError):
        s.set_conf("spark.no.such.key", "1")
    js = TpuSession().set_conf("spark.sql.ansi.enabled", "true")
    assert js.conf.to_dict()["spark.sql.ansi.enabled"] == \
        s.conf.to_dict()["spark.sql.ansi.enabled"] == "true"


def test_from_pydict_and_to_pydict():
    data = {"a": [3, None, 1], "b": ["x", "y", None]}
    got = tdataframe.from_pydict(data, session=TorchSession(device="cpu"))
    want = jdataframe.from_pydict(data, session=TpuSession())
    assert got.to_pydict() == want.to_pydict() == data


def test_table_and_column_helpers():
    """HostTable.from_pydict/to_pydict/concat/column/num_columns,
    HostColumn.from_pylist/from_numpy/null_count/all_valid and
    DeviceTable.column/schema/num_columns against the reference's."""
    import datetime as dt
    data = {"i": [1, None, 3], "s": ["a", None, "c"],
            "d": [dt.date(2020, 1, 2), None, dt.date(1969, 12, 31)],
            "t": [dt.datetime(2020, 1, 2, 3, 4, 5), None, None],
            "f": [1.5, 2.5, None]}
    got = HostTable.from_pydict(data)
    want = JHostTable.from_pydict(data)
    assert tables_differ(want, as_reference(got)) is None
    # to_pylist gives a date or timestamp as its internal value in the
    # port (the reference converts it): the other columns compare as dicts
    plain = ("i", "s", "f")
    assert {k: v for k, v in got.to_pydict().items() if k in plain} == \
        {k: v for k, v in want.to_pydict().items() if k in plain}
    assert got.num_columns == want.num_columns == 5
    assert got.column("s").to_pylist() == want.column("s").to_pylist()
    both = HostTable.concat([got, got])
    assert tables_differ(JHostTable.concat([want, want]),
                         as_reference(both)) is None
    for vals in ([1, None, 2], [None, None], ["q", "r"]):
        c, j = HostColumn.from_pylist(vals), JHostColumn.from_pylist(vals)
        assert type(c.dtype).__name__ == type(j.dtype).__name__
        assert c.null_count == j.null_count
        assert c.all_valid == j.all_valid
        assert c.to_pylist() == j.to_pylist()
    arr = np.asarray([1, 2, 3], dtype=np.int16)
    c, j = HostColumn.from_numpy(arr), JHostColumn.from_numpy(arr)
    assert c.dtype.simple_string() == j.dtype.simple_string() == "smallint"
    assert c.null_count == 0 and c.all_valid
    # an array of a plain dtype as a list column, typed alike
    c = HostColumn.from_pylist(np.asarray([1, 2], dtype=np.int32))
    j = JHostColumn.from_pylist(np.asarray([1, 2], dtype=np.int32))
    assert c.dtype.simple_string() == j.dtype.simple_string()
    from spark_rapids_tpu_torch.columnar.table import upload_host_table
    dev = upload_host_table(got, "cpu")
    assert dev.num_columns == 5
    assert [(n, t.simple_string()) for n, t in dev.schema()] == \
        [(n, t.simple_string()) for n, t in want.schema()]
    assert dev.column("i") is dev.columns[0]


# --- the knobs -------------------------------------------------------------------

def test_batch_size_bytes_forces_several_batches():
    """A batch target of 2 KiB: the aggregate's input stays in its 4
    batches (4 partial aggregates, as the reference's), with the answer
    of one batch (``tables_close``: f64 sums in another order)."""
    conf = {"spark.rapids.sql.batchSizeBytes": "2048"}
    data = _data(3000)
    ps, rs = PORT.session(conf), REF.session(conf)
    got = ps.create_dataframe(data, num_batches=4).group_by("k").agg(
        TF.sum("v").alias("s"), TF.count().alias("n")).collect_table()
    want = rs.create_dataframe(data, num_batches=4).group_by("k").agg(
        JF.sum("v").alias("s"), JF.count().alias("n")).collect_table()
    assert ps.last_metrics()["partialAggBatches"] == \
        _ref_metric(rs, "partialAggBatches") == 4
    one = PORT.session().create_dataframe(data, num_batches=4).group_by(
        "k").agg(TF.sum("v").alias("s"), TF.count().alias("n"))
    assert tables_close(as_reference(got), want, rtol=1e-9) is None
    assert tables_close(as_reference(got),
                        as_reference(one.collect_table()), rtol=1e-9) is None


def test_scan_device_cache_off_keeps_nothing():
    """``scan.deviceCache=false``: the scan lands afresh every query and
    leaves no device image on its host columns (on: it keeps one)."""
    def images(table):
        return sum(1 for c in table.columns for k in c._cache
                   if isinstance(k, tuple) and k[0] == "device")
    for flag, want in (("false", 0), ("true", 2)):
        table = HostTable.from_pydict({"a": np.arange(50),
                                       "b": np.arange(50) * 2})
        s = TorchSession({"spark.rapids.tpu.scan.deviceCache": flag},
                         device="cpu")
        df = s.create_dataframe(table)
        for _ in range(2):
            assert df.select((tcol("a") + tcol("b")).alias("c")).count() == 50
        assert images(table) == want


def test_fuse_input_off_plans_the_unfused_aggregate():
    """``agg.fuseInput=false``: the filter and the projection stay execs
    of their own below the aggregate; the answer is the fused one's and
    the reference's (``tables_differ_unordered``: exact counts and
    integer sums)."""
    from spark_rapids_tpu_torch.execs.basic import TpuFilterExec

    def q(a, df):
        return df.filter(a.col("q") > a.lit(0)).select(
            "k", (a.col("q") * a.lit(2)).alias("w")).group_by("k").agg(
            a.F.sum(a.col("w")).alias("s"), a.F.count().alias("n"))

    def execs(root):
        out, stack = [], [root]
        while stack:
            e = stack.pop()
            out.append(type(e).__name__)
            stack.extend(e.children)
        return out
    off = {"spark.rapids.tpu.agg.fuseInput": "false"}
    got, want = _both(q, _data(), off)
    assert tables_differ_unordered(got, want) is None
    s = TorchSession(off, device="cpu")
    q(PORT, s.create_dataframe(_data())).collect()
    assert "TpuFilterExec" in execs(s._last_root)
    s = TorchSession(device="cpu")
    fused = q(PORT, s.create_dataframe(_data())).collect_table()
    assert TpuFilterExec.__name__ not in execs(s._last_root)
    assert tables_differ_unordered(as_reference(fused), got) is None


def test_pair_budget_sets_the_nested_loop_tiles():
    """``nestedLoopJoin.pairBudget`` from the conf tiles the nested-loop
    join as the module constant does: 1024 pairs over 128 build slots
    are 8-row tiles, 64 of them over 512 probe rows, as many as the
    reference's join emits batches; the answer is the reference's (``tables_differ_unordered``)."""
    rng = np.random.default_rng(4)
    left = {"a": rng.integers(0, 100, 500).astype(np.int64)}
    right = {"rv": rng.integers(0, 100, 100).astype(np.int64)}
    conf = {"spark.rapids.sql.nestedLoopJoin.pairBudget": "1024"}

    def q(a, s):
        return s.create_dataframe(left).join(
            s.create_dataframe(right), on=a.col("a") < a.col("rv"))
    ps, rs = PORT.session(conf), REF.session(conf)
    got, want = q(PORT, ps).collect_table(), q(REF, rs).collect_table()
    assert tables_differ_unordered(as_reference(got), want) is None
    assert ps.last_metrics()["nestedLoopTiles"] == 64
    # the reference counts no tiles: its join emits one batch a tile
    assert _ref_metric(rs, "numOutputBatches", "TpuNestedLoopJoin") == 64
    ps = PORT.session()
    q(PORT, ps).collect()
    assert ps.last_metrics()["nestedLoopTiles"] == 1


def test_collect_limit_plans_and_kill_switch():
    """An unordered ``limit`` plans CollectLimit in both packages, runs as
    the Limit exec, and has a kill switch of its own
    (``tables_differ``)."""
    from spark_rapids_tpu_torch.plan import nodes as TP
    data = _data(300)
    got, want = _both(lambda a, df: df.select("k", "v").limit(11), data,
                      num_batches=3)
    assert tables_differ(want, got) is None
    s = TorchSession({"spark.rapids.sql.exec.CollectLimit": "false"},
                     device="cpu")
    df = s.create_dataframe(data).limit(5)
    assert isinstance(df.plan, TP.CollectLimit)
    assert df.count() == 5
    from spark_rapids_tpu_torch.obs.events import collect_fallbacks
    assert [f["op"] for f in collect_fallbacks(s.last_meta)] == [
        "CollectLimit"]


def test_every_new_key_folds_into_the_fingerprint():
    """None of the keys is result-neutral for the executable cache."""
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.plan.fingerprint import plan_fingerprints
    plan = TorchSession(device="cpu").create_dataframe(
        {"a": np.arange(3)}).plan
    base = plan_fingerprints(plan, RapidsConf())
    for key, value in (("spark.sql.ansi.enabled", "true"),
                       ("spark.rapids.sql.mode", "explainOnly"),
                       ("spark.rapids.sql.batchSizeBytes", "4096"),
                       ("spark.rapids.tpu.scan.deviceCache", "false"),
                       ("spark.rapids.tpu.agg.fuseInput", "false"),
                       ("spark.rapids.sql.nestedLoopJoin.pairBudget",
                        "1024")):
        fp = plan_fingerprints(plan, RapidsConf({key: value}))
        assert fp[0] != base[0] and fp[1] != base[1], key
