"""The per-operator CPU route (overrides/rules.py's tags, plan/nodes.py's
``execute_cpu``, execs/base.py's transitions, session.py) against the
JAX package's on the same seeded rows.

* Every plan node forced onto the route by its kill switch
  (``spark.rapids.sql.exec.<Node>=false``): the result equals the
  reference's CPU route (``TpuSession({"spark.rapids.sql.enabled":
  "false"})``) and the port's device path, and the node is the one
  fallback reported.
* Mid-plan transitions both ways: a host node between device nodes
  downloads (``d2hTime``) and uploads (``h2dTime``).
* ``spark.rapids.sql.enabled=false`` over q1, q3 and four corpus queries
  equals the device path, and reports no fallback (nothing is tagged).
* ``explain`` in each mode and the event record's ``fallbacks`` equal the
  reference's, "TPU" read as "GPU".

Comparators: ``tests/torch_nested.py::nested_differ`` (exact; the row
multiset where a join or a group-by orders rows by its own route) against
the reference, ``scale_test.tables_close`` (f64 sums rtol 1e-9, rows as a
multiset) between the port's two routes."""

import json
import os

import numpy as np
import pytest

from scale_test import tables_close
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.obs.events import collect_fallbacks
from spark_rapids_tpu_torch.session import TorchSession
from tests.torch_nested import PORT, REF, as_reference, nested_differ, tables

OFF = {"spark.rapids.sql.enabled": "false"}


def _data(n=240, seed=21):
    rng = np.random.default_rng(seed)

    def nulls(vals, p=0.1):
        return [None if rng.random() < p else v for v in vals]
    return tables([
        ("k", TT.INT, nulls(rng.integers(0, 9, n).tolist())),
        ("g", TT.STRING, nulls([f"g{x}" for x in rng.integers(0, 5, n)])),
        ("v", TT.LONG, nulls(rng.integers(-1000, 1000, n).tolist())),
        ("x", TT.DOUBLE, nulls((rng.standard_normal(n) * 10).tolist())),
        ("arr", TT.ArrayType(TT.INT), nulls([
            rng.integers(0, 9, rng.integers(0, 4)).tolist()
            for _ in range(n)])),
    ])


def _expand(a, df):
    """An Expand node (no DSL builds one): (k, v) and (k, -v)."""
    nodes = a.P
    return df._wrap(nodes.Expand(
        df.plan, [[a.col("k"), a.col("v")], [a.col("k"), -a.col("v")]],
        ["k", "v"]))


def _win(a):
    return a.W.partition_by("g").order_by("v")


#: node -> (query over an api and a DataFrame, rows as a multiset?)
QUERIES = {
    "LocalScan": (lambda a, df: df.select("k", "v"), False),
    "RangeNode": (lambda a, df: df.session.range(0, 50, 3).select(
        (a.col("id") * a.lit(2)).alias("d")), False),
    "Project": (lambda a, df: df.select(
        (a.col("v") + a.col("k")).alias("s"), a.F.upper("g").alias("u")),
        False),
    "Filter": (lambda a, df: df.select("k", "v", "x").filter(
        a.col("x") > a.lit(0.0)), False),
    "Aggregate": (lambda a, df: df.group_by("g").agg(
        a.F.sum("v").alias("sv"), a.F.count().alias("c"),
        a.F.max("x").alias("mx")), True),
    "Sort": (lambda a, df: df.select("k", "v").sort("v", "k"), False),
    # df.limit plans CollectLimit; SQL's and the DSL's LIMIT node is Limit
    "Limit": (lambda a, df: type(df)(a.P.Limit(df.select("k", "v").plan,
                                               17), df.session), False),
    "CollectLimit": (lambda a, df: df.select("k", "v").limit(17), False),
    "Union": (lambda a, df: df.select("k").union(df.select("k")), False),
    "Expand": (lambda a, df: _expand(a, df.select("k", "v")), False),
    "Join": (lambda a, df: df.select("k", "v").join(
        df.select(a.col("k"), a.col("x")).filter(a.col("x") > a.lit(5.0)),
        on="k"), True),
    "Generate": (lambda a, df: df.select(
        "k", a.F.explode("arr").alias("e")), False),
    "Sample": (lambda a, df: df.select("v").sample(0.3, seed=5), False),
    "TakeOrderedAndProject": (lambda a, df: df.select("k", "v").sort(
        "v").limit(9), False),
    "WindowNode": (lambda a, df: df.select("g", "v").with_windows(
        r=a.F.row_number().over(_win(a))), False),
    "WindowGroupLimit": (lambda a, df: df.select("g", "v").with_windows(
        r=a.F.rank().over(_win(a))).filter(a.col("r") <= a.lit(2)), False),
    "Exchange": (lambda a, df: df.select("k", "v").repartition(4, "k"),
                 True),
}


def _api(api):
    """The api namespace with its plan-node module and Window."""
    import types
    if api is PORT:
        from spark_rapids_tpu_torch.plan import nodes
    else:
        from spark_rapids_tpu.plan import nodes
    return types.SimpleNamespace(**vars(api), P=nodes)


def _run(api, conf, node, tabs):
    a = _api(api)
    if api is PORT:
        sess = TorchSession(conf, device="cpu")
        df = PORT.frm(tabs[1], sess)
    else:
        sess = TpuSession(conf)
        df = REF.frm(tabs[0], sess)
    got = QUERIES[node][0](a, df).collect_table()
    return got, sess


@pytest.mark.parametrize("node", list(QUERIES))
def test_each_node_on_the_route_by_its_kill_switch(node):
    tabs = _data()
    got, ts = _run(PORT, {f"spark.rapids.sql.exec.{node}": "false"}, node,
                   tabs)
    fallbacks = collect_fallbacks(ts.last_meta)
    assert [f["op"] for f in fallbacks] == [node], fallbacks
    assert fallbacks[0]["reasons"] == [f"exec {node} is disabled by conf"]
    ordered = not QUERIES[node][1]
    want, _ = _run(REF, OFF, node, tabs)
    diff = nested_differ(want, got, ordered)
    assert diff is None, diff
    dev, ds = _run(PORT, None, node, tabs)
    assert collect_fallbacks(ds.last_meta) == []
    if node != "Generate":
        assert tables_close(as_reference(dev), as_reference(got),
                            rtol=1e-9) is None


def test_a_file_scan_on_the_route(tmp_path):
    """A disabled Parquet scan reads on the route; the device nodes above
    it get its batches through an upload."""
    from spark_rapids_tpu_torch.io.parquet import write_parquet
    _, tt = _data()
    flat = type(tt)(list(tt.names[:4]), list(tt.columns[:4]))
    path = write_parquet(flat, str(tmp_path / "t"))
    ts = TorchSession({"spark.rapids.sql.exec.ParquetScanNode": "false"},
                      device="cpu")
    got = ts.read_parquet(*path).group_by("g").agg(
        PORT.F.sum("v").alias("s")).collect_table()
    assert [f["op"] for f in collect_fallbacks(ts.last_meta)] == [
        "ParquetScanNode"]
    assert ts.last_timings()["h2dTime"] > 0
    dev = TorchSession(device="cpu").read_parquet(*path).group_by("g").agg(
        PORT.F.sum("v").alias("s")).collect_table()
    assert tables_close(as_reference(got), as_reference(dev)) is None


def test_mid_plan_transitions_both_ways():
    """Device scan and project, a host filter, a device aggregate: one
    download and one upload, their times in ``last_timings``; the result
    equals the reference's."""
    tabs = _data()

    def q(a, df):
        return df.select((a.col("v") * a.lit(2)).alias("w"), "g", "x") \
            .filter(a.col("x") > a.lit(1.0)).group_by("g").agg(
                a.F.sum("w").alias("s"))
    ts = TorchSession({"spark.rapids.sql.exec.Filter": "false"},
                      device="cpu")
    got = q(PORT, PORT.frm(tabs[1], ts)).collect_table()
    t = ts.last_timings()
    assert t["h2dTime"] > 0 and t["d2hTime"] > 0
    assert ts.last_metrics()["h2dBatches"] == 1
    from spark_rapids_tpu_torch.overrides.rules import collect_cpu_nodes
    assert collect_cpu_nodes(ts._last_root) == ["Filter"]
    want = q(REF, REF.frm(tabs[0], TpuSession())).collect_table()
    assert nested_differ(want, got, ordered=False) is None


def test_a_host_root_and_a_host_leaf():
    """A root on the route (its device children downloaded) and a leaf on
    the route (uploaded for the device nodes above it)."""
    tabs = _data()
    for conf, cpu_nodes in (({"spark.rapids.sql.exec.Sort": "false"},
                             ["Sort"]),
                            ({"spark.rapids.sql.exec.LocalScan": "false"},
                             ["LocalScan"])):
        ts = TorchSession(conf, device="cpu")
        got = PORT.frm(tabs[1], ts).select("k", "v").filter(
            PORT.col("v") > PORT.lit(0)).sort("v", "k").collect_table()
        from spark_rapids_tpu_torch.overrides.rules import collect_cpu_nodes
        assert collect_cpu_nodes(ts._last_root) == cpu_nodes
        want = REF.frm(tabs[0], TpuSession(OFF)).select("k", "v").filter(
            REF.col("v") > REF.lit(0)).sort("v", "k").collect_table()
        assert nested_differ(want, got) is None


def test_sql_enabled_false_over_q1_q3():
    from spark_rapids_tpu_torch.models.tpch import (
        lineitem_table,
        q1_dataframe,
        q3_dataframe,
        q3_tables,
    )
    li = lineitem_table(4000, seed=3)
    q3 = q3_tables(4000, seed=3)
    for build in (lambda s: q1_dataframe(s, li),
                  lambda s: q3_dataframe(s, *q3)):
        off = TorchSession(OFF, device="cpu")
        got = build(off).collect_table()
        assert off.last_meta is None
        from spark_rapids_tpu_torch.execs.base import CpuRootExec
        assert isinstance(off._last_root, CpuRootExec)
        dev = build(TorchSession(device="cpu")).collect_table()
        assert tables_close(as_reference(got), as_reference(dev)) is None


@pytest.mark.parametrize("name", ["q3", "q5", "q10", "q18"])
def test_sql_enabled_false_over_corpus_queries(name):
    from spark_rapids_tpu_torch.models.corpus import (
        build_queries,
        corpus_tables,
    )
    t = corpus_tables(0.01, 7)
    off = TorchSession(OFF, device="cpu")
    got = build_queries(off, t)[name]().collect_table()
    dev = build_queries(TorchSession(device="cpu"), t)[name]().collect_table()
    assert got.num_rows == dev.num_rows
    assert tables_close(as_reference(got), as_reference(dev)) is None


def _marks(text):
    """(indent, mark, reasons) of each line of an explain."""
    out = []
    for line in text.splitlines():
        body = line.lstrip(" ")
        reasons = line.split("<--", 1)[1].strip() if "<--" in line else ""
        out.append((len(line) - len(body), body[:1], reasons))
    return out


@pytest.mark.parametrize("mode", ["NONE", "NOT_ON_GPU", "ALL"])
def test_explain_and_fallbacks_equal_the_reference(mode, tmp_path, capsys):
    """explain() in each mode (every line's indent, mark and reasons),
    the plan printed at execute under NOT_ON_GPU and ALL (its CPU-route
    lines), and the event record's fallbacks: the reference's, TPU read
    as GPU."""
    tabs = _data()
    conf = {"spark.rapids.sql.exec.Filter": "false",
            "spark.rapids.sql.expression.Upper": "false",
            "spark.rapids.sql.explain": mode}

    def q(a, df):
        return df.select("k", a.F.upper("g").alias("u"), "v").filter(
            a.col("v") > a.lit(0)).group_by("k").agg(
            a.F.count().alias("c"))
    js = TpuSession(conf)
    jdf = q(REF, REF.frm(tabs[0], js))
    tconf = dict(conf, **{"spark.rapids.sql.eventLog.enabled": "true",
                          "spark.rapids.sql.eventLog.dir":
                              str(tmp_path / "ev")})
    ts = TorchSession(tconf, device="cpu")
    tdf = q(PORT, PORT.frm(tabs[1], ts))
    want = js.explain(jdf.plan).replace("TPU", "GPU")
    got = ts.explain(tdf)
    assert _marks(got) == _marks(want)
    capsys.readouterr()
    jdf.collect_table()
    printed_ref = capsys.readouterr().out.replace("TPU", "GPU")
    tdf.collect_table()
    printed = capsys.readouterr().out
    # the executed plan is the pruned one, whose projections the two
    # packages' pruning places apart: the nodes on the route and their
    # reasons agree
    assert [m[1:] for m in _marks(printed) if m[1] == "!"] == \
        [m[1:] for m in _marks(printed_ref) if m[1] == "!"]
    if mode == "NONE":
        assert printed == ""
    from spark_rapids_tpu.obs.events import collect_fallbacks as jcollect
    want_fb = [{"op": f["op"], "reasons": [r.replace("TPU", "GPU")
                                           for r in f["reasons"]]}
               for f in jcollect(js._last_meta)]
    record = ts.last_event_record
    assert record["fallbacks"] == want_fb == collect_fallbacks(ts.last_meta)
    (path,) = [os.path.join(r, f) for r, _, fs in os.walk(tmp_path / "ev")
               for f in fs]
    with open(path) as f:
        assert json.loads(f.readline())["fallbacks"] == want_fb


def _host_form_data(n=200, seed=23):
    rng = np.random.default_rng(seed)

    def nulls(vals, p=0.1):
        return [None if rng.random() < p else v for v in vals]
    digits = [str(x) for x in rng.integers(-50, 50, n)]
    digits[::17] = ["x1"] * len(digits[::17])  # unparsable: null
    return tables([
        ("d", TT.DATE, nulls(rng.integers(9000, 9012, n).tolist())),
        ("s", TT.STRING, nulls(digits)),
        ("a", TT.STRING, nulls([f"a{x}" for x in rng.integers(0, 6, n)])),
        ("b", TT.STRING, nulls([f"b{x}" for x in rng.integers(0, 4, n)])),
        ("v", TT.LONG, nulls(rng.integers(-99, 99, n).tolist())),
    ])


#: a form only the CPU route evaluates inside a node the column pruning
#: rebuilds (grouping key, aggregate input, sort key): the node the route
#: runs, and the query, over an api and a DataFrame (rows as a multiset?)
HOST_FORMS = {
    "group_by_cast_date_as_string": ("Aggregate", lambda a, df: df.group_by(
        a.col("d").cast("string").alias("ds")).agg(
        a.F.count().alias("c"), a.F.sum("v").alias("sv")), True),
    "sum_of_cast_string_as_int": ("Aggregate", lambda a, df: df.group_by(
        "a").agg(a.F.sum(a.col("s").cast("int")).alias("si")), True),
    "sort_by_concat": ("Sort", lambda a, df: df.select("a", "b", "v").sort(
        a.F.concat(a.col("a"), a.col("b")), "v"), False),
}


@pytest.mark.parametrize("case", list(HOST_FORMS))
def test_host_forms_in_rebuilt_nodes_take_the_route(case):
    """A cast to or from a string or a two-column concat keeps its tag
    through the column pruning's rebuild: the node runs on the route,
    explain marks it so, and the result equals the reference's."""
    from spark_rapids_tpu_torch.overrides.rules import collect_cpu_nodes
    node, build, unordered = HOST_FORMS[case]
    jt, tt = _host_form_data()
    ts = TorchSession(device="cpu")
    df = build(PORT, PORT.frm(tt, ts))
    text = ts.explain(df)
    assert any(line.lstrip().startswith(f"! {node}[")
               for line in text.splitlines()), text
    got = df.collect_table()
    assert node in collect_cpu_nodes(ts._last_root)
    assert node in [f["op"] for f in collect_fallbacks(ts.last_meta)]
    want = build(REF, REF.frm(jt, TpuSession(OFF))).collect_table()
    diff = nested_differ(want, got, ordered=not unordered)
    assert diff is None, diff


@pytest.mark.parametrize("text", [
    "SELECT CAST(d AS STRING) AS ds, COUNT(*) AS c FROM hf "
    "GROUP BY CAST(d AS STRING)",
    "SELECT a, SUM(CAST(s AS INT)) AS si FROM hf GROUP BY a",
    "SELECT a, b, v FROM hf ORDER BY CONCAT(a, b), v",
])
def test_host_forms_in_sql_group_by_and_order_by(text):
    jt, tt = _host_form_data()
    js, ts = TpuSession(OFF), TorchSession(device="cpu")
    REF.frm(jt, js).create_or_replace_temp_view("hf")
    PORT.frm(tt, ts).create_or_replace_temp_view("hf")
    got = ts.sql(text).collect_table()
    assert collect_fallbacks(ts.last_meta) != []
    want = js.sql(text).collect_table()
    diff = nested_differ(want, got, ordered="ORDER BY" in text)
    assert diff is None, diff


@pytest.mark.parametrize("key, known", [
    ("spark.rapids.sql.exec.Filter", True),
    ("spark.rapids.sql.exec.ParquetScanNode", True),
    ("spark.rapids.sql.expression.Upper", True),
    ("spark.rapids.sql.exec.Fliter", False),
    ("spark.rapids.sql.expression.Uper", False),
])
def test_a_kill_switch_must_name_an_operator(key, known):
    """A kill switch naming no plan node or expression raises as any key
    the port does not know: a misspelt one would leave its operator on
    the device."""
    from spark_rapids_tpu_torch.conf import RapidsConf
    if known:
        assert not RapidsConf({key: "false"}).is_op_enabled(
            *key.split(".")[3:])
    else:
        with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
            RapidsConf({key: "false"})
