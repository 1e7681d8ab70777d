"""AQE's runtime build and the cost-based optimizer of the PyTorch port
(``execs/broadcast.py::TpuAdaptiveBuildExec``, the join planning of
``overrides/rules.py``, ``overrides/optimizer.py``) against the reference
on the same numpy inputs: the cases of ``tests/test_broadcast_nlj.py:126-
200`` (a build without a static estimate converts to a broadcast at run
time, a large one stays on the shuffled path) with the decision, its
metrics and ``describe()``; the corpus queries whose build is an
aggregate (q10, q17, q22 over ``golden_tables(0.002)``) plan the adaptive
build in both packages; and the four cases of ``tests/test_cbo.py``.
Results compare with ``scale_test.tables_differ_unordered`` (a join's
rows, bit for bit), ``tables_close`` at rtol 1e-9 (the corpus's f64 sums)
and row counts; a plan's route by its CPU-route nodes."""

import numpy as np
import pytest
import torch

from scale_test import build_queries as jbuild_queries
from scale_test import tables_close, tables_differ_unordered
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.execs.broadcast import (
    TpuAdaptiveBuildExec as JAdaptive,
)
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.ops.expr import lit as jlit
from spark_rapids_tpu.overrides import wrap_plan as jwrap_plan
from spark_rapids_tpu.overrides.optimizer import apply_cbo as japply_cbo
from spark_rapids_tpu.overrides.rules import apply_overrides
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.plan import nodes as JP
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.execs.basic import TpuCoalesceExec
from spark_rapids_tpu_torch.execs.broadcast import TpuAdaptiveBuildExec
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.models import corpus as tcorpus
from spark_rapids_tpu_torch.ops.expr import col, lit
from spark_rapids_tpu_torch.overrides import rules as R
from spark_rapids_tpu_torch.overrides.optimizer import (
    apply_cbo,
    estimate_rows,
)
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.plan import nodes as P
from spark_rapids_tpu_torch.session import TorchSession

NO_CACHE = {"spark.rapids.sql.executableCache.enabled": "false"}
CPU = torch.device("cpu")


def _both(names, types, arrays):
    """The same columns as a port and a reference HostTable."""
    t = host_table_from_arrays(names, types, arrays)
    return t, JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), c.data, c.validity)
        for ty, c in zip(types, t.columns)])


def _as_reference(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


def _find(root, cls):
    """Every node of class ``cls`` in an exec tree of either package
    (through the transitions' sources, as ``lore._iter_tree`` walks)."""
    out, stack = [], [root]
    while stack:
        e = stack.pop()
        if isinstance(e, cls):
            out.append(e)
        stack.extend(getattr(e, "children", ()))
        stack.extend(getattr(e, a) for a in ("tpu_exec", "source",
                                             "cpu_node")
                     if getattr(e, a, None) is not None)
    return out


def _ones(n):
    return np.ones(n, dtype=np.bool_)


def _aqe_tables(n_big, n_small, seed, big_keys):
    rng = np.random.default_rng(seed)
    big = _both(["k", "v"], ["bigint", "double"], [
        (rng.integers(0, big_keys, n_big), _ones(n_big)),
        (rng.standard_normal(n_big), _ones(n_big))])
    small = _both(["k", "w"], ["bigint", "bigint"], [
        (np.arange(n_small), _ones(n_small)),
        (np.arange(n_small) * 10, _ones(n_small))])
    return big, small


def _hidden_join(Pmod, api_col, big, small):
    """An inner join on ``k`` whose build scan hides its static estimate,
    so the planner cannot prove the build broadcastable."""
    scan = Pmod.LocalScan([small])
    scan.estimate_bytes = lambda: None
    return Pmod.Join(Pmod.LocalScan([big]), scan, "inner",
                     [api_col("k")], [api_col("k")])


@pytest.mark.parametrize("threshold,converted", [
    (None, True), (64, False)], ids=["->broadcast", "->shuffle"])
def test_aqe_build_decides_from_the_measured_bytes(threshold, converted):
    """The reference's ``test_aqe_runtime_broadcast_conversion`` and
    ``test_aqe_large_build_stays_shuffle``: planned undecided, the build
    under the default threshold converts to a broadcast (metric
    ``aqeBroadcastConverted`` 1), one past a 64-byte threshold stays on
    the shuffled path; both packages decide alike and join the same
    rows."""
    (tbig, jbig), (tsmall, jsmall) = _aqe_tables(5000, 50, 0, 50)
    conf = {} if threshold is None else {
        "spark.rapids.sql.broadcastSizeBytes": str(threshold)}
    rs = TpuSession({**NO_CACHE, **conf})
    jexec, _ = apply_overrides(_hidden_join(JP, jcol, jbig, jsmall), rs.conf)
    jab = _find(jexec, JAdaptive)[0]
    assert jab.converted is None
    want = JHostTable.concat(list(jexec.execute_cpu()))
    assert jab.converted is converted

    ts = TorchSession({**NO_CACHE, **conf}, device="cpu")
    plan = _hidden_join(P, col, tbig, tsmall)
    root = R.convert(plan, ts.conf, CPU)
    ab = _find(root, TpuAdaptiveBuildExec)[0]
    assert ab.converted is None
    assert ab.describe() == jab.describe().replace(
        "->broadcast", "undecided").replace("->shuffle", "undecided")
    got = ts.execute(plan)
    ab = _find(ts._last_root, TpuAdaptiveBuildExec)[0]
    assert ab.converted is converted
    assert ab.describe() == jab.describe() == (
        "TpuAdaptiveBuild[->broadcast]" if converted
        else "TpuAdaptiveBuild[->shuffle]")
    assert got.num_rows == want.num_rows == 5000
    assert tables_differ_unordered(_as_reference(got), want) is None
    m = ab.metrics
    assert m.get("aqeBroadcastConverted", 0) == \
        jab.metrics.get("aqeBroadcastConverted", 0) == int(converted)
    assert m["aqeMeasuredBuildBytes"] > (0 if converted else 64)


def test_a_converted_build_is_cached_for_the_next_execution():
    """A converted build keeps its table: the join's next execution
    (a replay of the same tree) reads the cached batch without running
    the build's child again."""
    (tbig, _), (tsmall, _) = _aqe_tables(500, 20, 1, 20)
    ts = TorchSession(NO_CACHE, device="cpu")
    plan = _hidden_join(P, col, tbig, tsmall)
    first = ts.execute(plan)
    ab = _find(ts._last_root, TpuAdaptiveBuildExec)[0]
    calls = []
    child = ab.children[0]
    orig = child.spillable_batches
    child.spillable_batches = lambda: calls.append(1) or orig()
    again = ts.placement.drain(ts._last_root)
    assert calls == [] and ab.converted is True
    assert tables_differ_unordered(_as_reference(again),
                                   _as_reference(first)) is None


def test_adaptive_off_plans_the_single_batch_build():
    """With ``spark.rapids.sql.adaptive.enabled`` false both packages
    coalesce the build into one batch, as before AQE."""
    (tbig, jbig), (tsmall, jsmall) = _aqe_tables(300, 20, 2, 20)
    off = {"spark.rapids.sql.adaptive.enabled": "false"}
    jexec, _ = apply_overrides(_hidden_join(JP, jcol, jbig, jsmall),
                               TpuSession({**NO_CACHE, **off}).conf)
    assert _find(jexec, JAdaptive) == []
    ts = TorchSession({**NO_CACHE, **off}, device="cpu")
    root = R.convert(_hidden_join(P, col, tbig, tsmall), ts.conf, CPU)
    assert _find(root, TpuAdaptiveBuildExec) == []
    assert any(c.require_single for c in _find(root, TpuCoalesceExec))


def test_the_event_record_counts_the_conversion(tmp_path):
    """The event record's ``aqe`` reads the converted build
    (obs/events.py::collect_aqe)."""
    (tbig, _), (tsmall, _) = _aqe_tables(400, 20, 3, 20)
    ts = TorchSession({**NO_CACHE,
                       "spark.rapids.sql.eventLog.enabled": "true",
                       "spark.rapids.sql.eventLog.dir": str(tmp_path)},
                      device="cpu")
    ts.execute(_hidden_join(P, col, tbig, tsmall))
    assert ts.last_event_record["aqe"] == {"broadcastConversions": 1,
                                           "coalescedPartitions": 0}


# -- the corpus's aggregate builds -----------------------------------------

_GOLDEN = {}


def _golden():
    """golden_tables(0.002) in both packages (the port's datagen makes the
    reference's arrays, tests/test_torch_corpus.py)."""
    if not _GOLDEN:
        from spark_rapids_tpu.lint.golden import golden_tables
        jtabs = golden_tables(0.002)
        ttabs = {}
        for name, t in jtabs.items():
            ttabs[name] = host_table_from_arrays(
                list(t.names), [c.dtype.simple_string() for c in t.columns],
                [(c.data, c.validity) for c in t.columns])
        _GOLDEN.update(j=jtabs, t=ttabs)
    return _GOLDEN["j"], _GOLDEN["t"]


def test_the_corpus_plans_the_adaptive_build_where_the_reference_does():
    """Over the converted corpus both packages plan
    ``TpuAdaptiveBuildExec`` for exactly q10, q17 and q22, whose build is
    an aggregate (no static estimate)."""
    jtabs, ttabs = _golden()
    rs, ts = TpuSession(NO_CACHE), TorchSession(NO_CACHE, device="cpu")
    jq, tq = jbuild_queries(rs, jtabs), tcorpus.build_queries(ts, ttabs)
    jhave, thave = set(), set()
    for name in sorted(tq):
        jexec, _ = apply_overrides(jq[name]().plan, rs.conf)
        if _find(jexec, JAdaptive):
            jhave.add(name)
        if _find(R.convert(tq[name]().plan, ts.conf, CPU),
                 TpuAdaptiveBuildExec):
            thave.add(name)
    assert thave == jhave == {"q10", "q17", "q22"}


@pytest.mark.parametrize("name", ["q10", "q17", "q22"])
def test_the_adaptive_corpus_queries_match_the_reference(name):
    """q10, q17 and q22 through the adaptive build answer as the
    reference (f64 sums within 1e-9), each build converted to a
    broadcast at this size."""
    jtabs, ttabs = _golden()
    ts = TorchSession(NO_CACHE, device="cpu")
    got = tcorpus.build_queries(ts, ttabs)[name]().collect_table()
    want = jbuild_queries(TpuSession(NO_CACHE), jtabs)[name]() \
        .collect_table()
    assert tables_close(_as_reference(got), want, rtol=1e-9) is None
    builds = _find(ts._last_root, TpuAdaptiveBuildExec)
    assert builds and all(b.converted for b in builds)
    assert ts.last_metrics()["aqeBroadcastConverted"] == len(builds)


# -- the cost-based optimizer -----------------------------------------------

CBO = {"spark.rapids.sql.optimizer.enabled": "true"}


def _x_table(n, seed=1):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.1
    return _both(["x"], ["int"], [(rng.integers(-1000, 1000, n), valid)])


def _on_device(meta_fn, cbo_fn, plan, conf) -> tuple:
    meta = meta_fn(plan, conf)
    cbo_fn(meta, conf)
    return meta


def test_tiny_plan_reverts_to_cpu():
    """A 50-row filter: both optimizers put the plan on the CPU route with
    a reason naming CBO, and the port's answer equals the reference's."""
    tt, jt = _x_table(50)
    ts, rs = TorchSession(CBO, device="cpu"), TpuSession(CBO)
    tdf = tfrom(tt, ts).filter(col("x") > lit(0))
    jdf = jfrom(jt, rs).filter(jcol("x") > jlit(0))
    tmeta = _on_device(R.wrap_plan, apply_cbo, tdf.plan, ts.conf)
    jmeta = _on_device(jwrap_plan, japply_cbo, jdf.plan, rs.conf)
    assert not tmeta.can_run_on_gpu and not jmeta.can_run_on_tpu
    assert tmeta.reasons == jmeta.reasons
    assert tmeta.reasons[0].startswith("CBO: est. CPU cost")
    got = tdf.collect_table()
    assert R.collect_cpu_nodes(ts._last_root) == ["Filter", "LocalScan"]
    assert got.num_rows == jdf.count() == int(
        ((jt.columns[0].data > 0) & jt.columns[0].validity).sum())


def test_large_plan_stays_on_device():
    tt, jt = _x_table(2_000_000)
    ts, rs = TorchSession(CBO, device="cpu"), TpuSession(CBO)
    tmeta = _on_device(R.wrap_plan, apply_cbo,
                       tfrom(tt, ts).filter(col("x") > lit(0)).plan,
                       ts.conf)
    jmeta = _on_device(jwrap_plan, japply_cbo,
                       jfrom(jt, rs).filter(jcol("x") > jlit(0)).plan,
                       rs.conf)
    assert tmeta.can_run_on_gpu and jmeta.can_run_on_tpu


def test_disabled_by_default():
    tt, jt = _x_table(50)
    ts, rs = TorchSession(device="cpu"), TpuSession()
    tdf = tfrom(tt, ts).filter(col("x") > lit(0))
    assert _on_device(R.wrap_plan, apply_cbo, tdf.plan,
                      ts.conf).can_run_on_gpu
    assert _on_device(jwrap_plan, japply_cbo,
                      jfrom(jt, rs).filter(jcol("x") > jlit(0)).plan,
                      rs.conf).can_run_on_tpu
    tdf.collect_table()
    assert R.collect_cpu_nodes(ts._last_root) == []


def test_unknown_stats_left_alone():
    """A join has no row estimate: neither optimizer touches the plan."""
    rng = np.random.default_rng(3)
    tl, jl = _both(["k"], ["int"], [(rng.integers(0, 5, 40), _ones(40))])
    tr, jr = _both(["k"], ["int"], [(rng.integers(0, 5, 20), _ones(20))])
    ts, rs = TorchSession(CBO, device="cpu"), TpuSession(CBO)
    tplan = tfrom(tl, ts).join(tfrom(tr, ts), on="k", how="inner").plan
    jplan = jfrom(jl, rs).join(jfrom(jr, rs), on="k", how="inner").plan
    assert estimate_rows(tplan) is None
    assert _on_device(R.wrap_plan, apply_cbo, tplan, ts.conf).can_run_on_gpu
    assert _on_device(jwrap_plan, japply_cbo, jplan, rs.conf).can_run_on_tpu
