"""The port's query envelope against the reference: the profiler's range
parsing and query index, LORE ids, the event record's shape, the span
tracer, the metrics level, the dispatch count, the asynchronous result
fetch, the launch helper's fault points and LORE's dump and replay.

Comparators: ``scale_test.tables_differ`` (bitwise) for results; the
record's shape is compared key for key against the reference's golden
record (``tests/golden_eventlog.json``) after both are reduced to their
keys and value types; counts are exact."""

import json
import os

import numpy as np
import pytest
import torch

from scale_test import tables_differ
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu import lore as jlore
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.overrides import apply_overrides
from spark_rapids_tpu.runtime.profiler import parse_ranges as jparse_ranges
from spark_rapids_tpu.session import TpuSession
from scale_test import build_queries as jbuild_queries
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch import kernels as K
from spark_rapids_tpu_torch import lore as tlore
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.errors import DeviceLostError
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.models import corpus as tcorpus
from spark_rapids_tpu_torch.models.tpch import lineitem_table, q1_dataframe
from spark_rapids_tpu_torch.obs import spans as tspans
from spark_rapids_tpu_torch.ops.expr import col, lit
from spark_rapids_tpu_torch.overrides.rules import convert
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.plan.executable_cache import EXEC_CACHE
from spark_rapids_tpu_torch.runtime import faults as tfaults
from spark_rapids_tpu_torch.runtime import profiler as tprof
from spark_rapids_tpu_torch.runtime.health import HEALTH
from spark_rapids_tpu_torch.runtime.host_alloc import PinnedMemoryPool
from spark_rapids_tpu_torch.session import TorchSession

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_eventlog.json")


@pytest.fixture(autouse=True)
def _clean_process_state():
    """The fault registry, the breaker, the health monitor and the
    executable cache are process-wide."""
    yield
    tfaults.FAULTS.disarm()
    tfaults.CIRCUIT_BREAKER.reset()
    HEALTH.reset()
    EXEC_CACHE.clear()


def _cpu(conf=None):
    return TorchSession(conf, device="cpu")


def _kv(n=200):
    return {"k": np.array(["a", "b", "a", "c"] * (n // 4), dtype=object),
            "v": np.arange(n, dtype=np.int64)}


def _kv_table(n=200):
    d = _kv(n)
    return host_table_from_arrays(
        ["k", "v"], ["string", "bigint"],
        [(d["k"], np.ones(n, bool)), (d["v"], np.ones(n, bool))])


def _agg_df(s, t):
    return (tfrom(t, s).filter(col("v") > lit(10))
            .group_by("k").agg(TF.sum("v").alias("sv")))


# -- the profiler -----------------------------------------------------------

RANGE_SPECS = ["1-3,8", "", "5", " 0-1 , 4 ", "0-0", "2,2,3"]
BAD_SPECS = ["5-", "-3", "1-x", "x", "7-3", "-2"]


@pytest.mark.parametrize("spec", RANGE_SPECS)
def test_parse_ranges_matches_the_reference(spec):
    assert tprof.parse_ranges(spec) == jparse_ranges(spec)


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_malformed_ranges_raise_naming_the_key_in_both(bad):
    for parse in (tprof.parse_ranges, jparse_ranges):
        with pytest.raises(ValueError,
                           match="spark.rapids.profile.queryRanges"):
            parse(bad)


def test_profiler_validates_ranges_when_built():
    with pytest.raises(ValueError, match="spark.rapids.profile.queryRanges"):
        tprof.TorchProfiler(RapidsConf(
            {"spark.rapids.profile.queryRanges": "1-x"}), "cpu")


def test_nested_query_burns_no_index():
    p = tprof.TorchProfiler(RapidsConf(), "cpu")
    with p.profile_query() as outer:
        assert outer is None            # disabled
        with p.profile_query() as nested:
            assert nested is None
        assert p._query_index == 1
    with p.profile_query():
        pass
    assert p._query_index == 2


def test_profiled_query_writes_only_its_range(tmp_path):
    """Three queries with queryRanges "1": one trace directory, query_1,
    with the trace and the operator table; the engine's operators show as
    named ranges (record_function) in the trace."""
    s = _cpu({"spark.rapids.profile.enabled": "true",
              "spark.rapids.profile.pathPrefix": str(tmp_path),
              "spark.rapids.profile.queryRanges": "1"})
    t = lineitem_table(2000, seed=1)
    for _ in range(3):
        q1_dataframe(s, t).collect_table()
    assert sorted(os.listdir(tmp_path)) == ["query_1"]
    d = tmp_path / "query_1"
    assert {"trace.json", "ops.txt"} <= set(os.listdir(d))
    events = json.load(open(d / "trace.json"))["traceEvents"]
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert {"TpuHashAggregateExec", "onehot_partials", "gather_compact",
            "sort_with_payload"} <= names
    assert s.profiler.sessions_written == 1


def test_op_range_calls_no_nvtx_on_a_cpu_build(monkeypatch):
    """This torch has no CUDA: its torch.cuda.nvtx raises when called, so
    op_range must not reach it."""
    assert not torch.cuda.is_available()

    def boom(*a, **k):
        raise AssertionError("NVTX called on a CPU-only build")

    monkeypatch.setattr(torch.cuda.nvtx, "range_push", boom)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", boom)
    with tprof.op_range("x"):
        pass
    q1_dataframe(_cpu(), lineitem_table(500, seed=2)).collect_table()


# -- LORE ids ---------------------------------------------------------------

def test_lore_ids_match_the_reference_on_the_corpus():
    """Both number the converted tree pre-order from 1; the reference's
    root is its DeviceToHost transition, which the port has not, so a
    port id is the reference's less one. Where the two trees have the
    same execs (by class, in pre-order) the ids agree, over at least half
    the corpus."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_corpus import _tables
    jt, pt = _tables(0.01, 7)
    js, ts = TpuSession(), _cpu()
    jq, tq = jbuild_queries(js, jt), tcorpus.build_queries(ts, pt)
    same = 0
    for name in tcorpus.CORPUS:
        jex, _ = apply_overrides(jq[name]().plan, js.conf)
        jlore.assign_lore_ids(jex)
        jtree = [(type(e).__name__, e._lore_id)
                 for e in jlore._iter_tree(jex)]
        assert jtree[0] == ("DeviceToHost", 1)
        tex = convert(tq[name]().plan, ts.conf, ts.device)
        ttree = [(type(e).__name__, e._lore_id)
                 for e in tlore._iter_tree(tex)]
        assert [i for _, i in ttree] == list(range(1, len(ttree) + 1))
        ref = [(c, i - 1) for c, i in jtree[1:]]
        if [c for c, _ in ref] == [c for c, _ in ttree]:
            assert ttree == ref, name
            same += 1
    assert same >= len(tcorpus.CORPUS) // 2


# -- the event record -------------------------------------------------------

#: fields of subsystems the port lacks (the mesh, the cluster), written as
#: the reference writes them while that subsystem is idle, and fields of
#: subsystems that are live but quiet outside a service, a Delta commit or
#: a stream (the streaming fields and commitRetries, live since [12b]:
#: tests/test_torch_streaming.py holds them under a stream)
IDLE_FIELDS = {
    "tenant": None, "pool": None, "queueWaitS": None, "cacheHit": False,
    "quarantined": False, "workerRestarts": 0, "meshShape": None,
    "iciBytes": 0, "shardSkew": 0.0, "meshDegradations": 0,
    "shardRetries": 0, "gatherChecksFailed": 0, "hostTopology": None,
    "hostsLost": 0, "hostRelands": 0, "dcnExchanges": 0, "hostScans": {},
    "commitRetries": 0, "microBatches": 0, "mvRefreshes": 0,
    "mvIncrementalRefreshes": 0, "mvFullRecomputes": 0, "sinkCommits": 0,
    "sinkReplays": 0, "mvEpoch": None, "fallbacks": [],
}


def _plan_shape(node):
    """A plan tree's node keys and metric-entry keys over all its nodes
    (the two trees differ in depth: the reference's root is its
    DeviceToHost transition)."""
    keys, entry = set(), set()
    stack = [node]
    while stack:
        n = stack.pop()
        keys |= set(n)
        for v in n["metrics"].values():
            entry |= set(v)
        stack.extend(n["children"])
    return sorted(keys), sorted(entry)


def _shape(obj, key=None):
    """Keys and value kinds only; the plan tree by ``_plan_shape``."""
    if key == "plan":
        return _plan_shape(obj)
    if isinstance(obj, dict):
        if key in ("scopes", "recovery", "faultFires", "demotions",
                   "hostScans", "byCategoryS", "workerByCategoryS"):
            return "map"
        return {k: _shape(v, k) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        return "list"
    if isinstance(obj, bool) or obj is None:
        return type(obj).__name__
    if isinstance(obj, (int, float)):
        return "number"
    return type(obj).__name__


def _run_logged(tmp_path, tag="golden"):
    s = _cpu({"spark.rapids.sql.eventLog.enabled": "true",
              "spark.rapids.sql.eventLog.dir": str(tmp_path)})
    s.next_query_tag = tag
    got = _agg_df(s, _kv_table()).collect_table()
    return s, got


def test_event_record_has_the_reference_golden_shape(tmp_path):
    s, got = _run_logged(tmp_path)
    lines = open(s.last_event_path).read().strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    golden = json.load(open(GOLDEN))
    assert rec["schema"] == 11 and rec["event"] == "queryCompleted"
    assert _shape(rec) == _shape(golden)
    for k, v in IDLE_FIELDS.items():
        assert rec[k] == v == golden[k], k
    # the port pads nothing for a compiler (dispatch.py)
    assert rec["padWasteRows"] == 0 and rec["compileMs"] == 0.0
    assert rec["queryTag"] == "golden" and rec["healthState"] == "HEALTHY"
    root = rec["plan"]
    assert root["loreId"] == 1
    assert root["metrics"]["numOutputRows"]["value"] == got.num_rows == 3
    assert root["metrics"]["opTime"]["kind"] == "timing"
    assert rec["spans"]["attributedS"] > 0 and rec["wallS"] > 0
    assert set(rec["phasesS"]) == {"planS", "executeS", "collectS"}


def test_event_log_disabled_writes_nothing(tmp_path):
    s = _cpu({"spark.rapids.sql.eventLog.dir": str(tmp_path)})
    _agg_df(s, _kv_table()).collect_table()
    assert s.last_event_path is None and s.last_event_record is None
    assert list(tmp_path.iterdir()) == []


def test_sql_text_and_tag_recorded(tmp_path):
    s = _cpu({"spark.rapids.sql.eventLog.enabled": "true",
              "spark.rapids.sql.eventLog.dir": str(tmp_path)})
    tfrom(_kv_table(), s).create_or_replace_temp_view("t")
    s.sql("SELECT k, SUM(v) AS sv FROM t GROUP BY k").collect_table()
    assert "SUM(v)" in s.last_event_record["sqlText"]
    assert s.last_event_record["queryTag"] is None


def test_trace_file_and_span_summary(tmp_path):
    s = _cpu({"spark.rapids.trace.enabled": "true",
              "spark.rapids.trace.dir": str(tmp_path)})
    _agg_df(s, _kv_table()).collect_table()
    files = os.listdir(tmp_path)
    assert files == ["query_0.trace.json"]
    trace = json.load(open(tmp_path / files[0]))
    cats = {e.get("cat") for e in trace["traceEvents"]}
    assert {"phase", "exec", "kernel"} <= cats
    assert s.last_event_record["spans"]["spanCount"] > 0


def test_union_seconds_and_deferred_rows_in_one_fetch(monkeypatch):
    assert tspans.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    from spark_rapids_tpu_torch import dispatch
    fetches = []
    real = dispatch.host_fetch
    monkeypatch.setattr(dispatch, "host_fetch",
                        lambda v: fetches.append(len(v)) or real(v))

    class E:
        def __init__(self, counts):
            self.children = ()
            self._obs_pending_rows = [torch.tensor(c) for c in counts]
            self.metrics = {}

        def add_metric(self, k, v):
            self.metrics[k] = self.metrics.get(k, 0) + v

    a, b = E([1, 2]), E([5])
    a.children = (b,)
    tspans.finalize_observation(a)
    assert fetches == [3]
    assert a.metrics["numOutputRows"] == 3 and b.metrics["numOutputRows"] == 5


def test_nested_execute_rides_the_outer_envelope(tmp_path):
    """A cached relation materializes through a nested execute: one
    record, one query index."""
    s = _cpu({"spark.rapids.sql.eventLog.enabled": "true",
              "spark.rapids.sql.eventLog.dir": str(tmp_path)})
    cached = tfrom(_kv_table(), s).cache()
    cached.group_by("k").agg(TF.count("v").alias("n")).collect_table()
    recs = [json.loads(x) for x in open(s.last_event_path)]
    assert len(recs) == 1 and recs[0]["queryIndex"] == 0


# -- the metrics level, dispatches, async fetch ------------------------------

def test_metrics_level_essential_drops_moderate_metrics():
    t = lineitem_table(2000, seed=3)
    s = _cpu({"spark.rapids.sql.metrics.level": "ESSENTIAL"})
    q1_dataframe(s, t).collect_table()
    names = {k for e in tlore._iter_tree(s._last_root) for k in e.metrics}
    assert "opTime" in names and "scanCacheHit" not in names
    s = _cpu()
    q1_dataframe(s, t).collect_table()
    q1_dataframe(s, t).collect_table()
    assert "numOutputRows" in s._last_root.metrics
    with pytest.raises(ValueError, match="metrics.level"):
        q1_dataframe(_cpu({"spark.rapids.sql.metrics.level": "ALL"}),
                     t).collect_table()


def test_dispatches_count_the_hand_written_kernels_deviation():
    """Deviation: ``dispatches`` counts the hand-written kernels' calls
    (their launches on the card, their plain versions here), where the
    reference counts every jitted program it dispatches. q1: the partial
    sums, the group compaction and the sort, once each."""
    t = lineitem_table(2000, seed=4)
    s = _cpu()
    q1_dataframe(s, t).collect_table()
    assert s.last_dispatches == 3
    assert s._last_root.metrics["dispatches"] == 3
    jt = JHostTable(list(t.names), [
        JHostColumn(JT.parse_type(c.dtype.simple_string()), c.data,
                    c.validity) for c in t.columns])
    from spark_rapids_tpu.models.tpch import q1_dataframe as jq1
    js = TpuSession()
    jq1(js, jt).collect_table()
    assert js.last_dispatches != s.last_dispatches


@pytest.mark.parametrize("pool", [0, 64 << 20])
def test_async_fetch_is_bit_identical(pool):
    """With a pinned pool the root's download is enqueued and resolved
    (``asyncFetchBatches``, ``resultFetchTime``); without one, or with the
    flag off, it is the synchronous download (``asyncFetchSynchronous``
    counts the first)."""
    t = lineitem_table(3000, seed=5)
    base = {"spark.rapids.memory.pinnedPool.size": str(pool)}
    on = _cpu(base)
    off = _cpu(dict(base, **{"spark.rapids.sql.asyncResultFetch": "false"}))
    on.runtime  # noqa: B018 (the pool)
    got = tfrom(t, on).filter(col("l_quantity") > lit(10.0)) \
        .collect_table()
    # read before the other session's run checks the same tree out
    m, timings = on.last_metrics(), on.last_timings()
    if pool:
        assert PinnedMemoryPool.get() is not None
        assert m["asyncFetchBatches"] == 1 and "resultFetchTime" in timings
        assert "asyncFetchSynchronous" not in m
    else:
        assert m["asyncFetchSynchronous"] == 1
    want = tfrom(t, off).filter(col("l_quantity") > lit(10.0)) \
        .collect_table()
    assert tables_differ(got, want) is None
    assert "asyncFetchSynchronous" not in off.last_metrics()


def test_async_fetch_spans_several_staging_buffers():
    """A result larger than one staging buffer spreads over several,
    every stream's parts in order."""
    from spark_rapids_tpu_torch.columnar.table import (
        enqueue_download,
        upload_host_table,
    )
    t = lineitem_table(300, seed=6)
    dev = upload_host_table(t, torch.device("cpu"))
    pool = PinnedMemoryPool(64 * 4096, buffer_bytes=4096)
    pending = enqueue_download(dev, pool)
    assert pending is not None and len(pending._bufs) > 1
    got = pending.resolve()
    assert tables_differ(got, dev.to_host()) is None
    assert len(pool._free) == 64
    small = PinnedMemoryPool(4096, buffer_bytes=4096)
    assert enqueue_download(dev, small) is None and len(small._free) == 1


# -- the launch helper's fault points ----------------------------------------

def test_device_lost_at_a_kernel_walks_the_device_loss_recovery():
    t = lineitem_table(2000, seed=7)
    want = q1_dataframe(_cpu(), t).collect_table()
    before = HEALTH.snapshot()["deviceReinits"]
    s = _cpu({"spark.rapids.test.faults": "device.lost:device_lost:1"})
    with pytest.raises(DeviceLostError):
        q1_dataframe(s, t).collect_table()
    assert HEALTH.snapshot()["deviceReinits"] == before + 1
    assert tfaults.FAULTS.counters() == {"device.lost": 1}
    tfaults.FAULTS.disarm()
    assert tables_differ(q1_dataframe(_cpu(), t).collect_table(),
                         want) is None


@pytest.mark.parametrize("op", [None, "sort_with_payload"])
def test_a_crash_at_a_kernel_replays_once(op):
    t = lineitem_table(2000, seed=8)
    want = q1_dataframe(_cpu(), t).collect_table()
    point = "dispatch.kernel" + (f"@{op}" if op else "")
    s = _cpu({"spark.rapids.test.faults": f"{point}:crash:1"})
    got = q1_dataframe(s, t).collect_table()
    assert tables_differ(got, want) is None
    assert s.last_metrics()["runtimeFaultReplays"] == 1
    assert sum(tfaults.FAULTS.counters().values()) == 1
    assert {"dispatch.kernel", "device.lost"} <= set(tfaults.FAULT_POINTS)
    assert tfaults.FAULT_POINTS["dispatch.kernel"][0].endswith(
        "kernels/__init__.py")


def test_the_launch_helper_fires_once_per_call(monkeypatch):
    seen = []
    real = tfaults.fault_point
    monkeypatch.setattr(tfaults, "fault_point",
                        lambda name, op=None, data=None:
                        seen.append((name, op)) or real(name, op, data))
    x = torch.ones(8, 1, dtype=torch.float64)
    gid = torch.zeros(8, dtype=torch.int32)
    from spark_rapids_tpu_torch.kernels.segreduce import onehot_partials
    onehot_partials(x, gid, 1, 1, 8)
    # the reference's order (dispatch.py): the wedge stalls between the
    # kernel point and the device loss
    assert seen == [("dispatch.kernel", "onehot_partials"),
                    ("dispatch.wedge", "onehot_partials"),
                    ("device.lost", "onehot_partials")]
    # the CPU takes the plain version: no launch
    assert K.launch_counts()["onehot_partials"] == 0


# -- LORE dump and replay ----------------------------------------------------

def test_lore_dump_and_replay_equal_the_operator(tmp_path):
    t = _kv_table(400)
    s = _cpu({"spark.rapids.sql.lore.idsToDump": "1",
              "spark.rapids.sql.lore.dumpPath": str(tmp_path)})
    want = _agg_df(_cpu(), t).collect_table()
    got = _agg_df(s, t).collect_table()
    assert tables_differ(got, want) is None
    d = tmp_path / "lore-1"
    meta = json.load(open(d / "meta.json"))
    assert meta["exec_class"] == "TpuHashAggregateExec"
    assert os.listdir(d / "input-0") == ["batch-0.parquet"]
    replayed = tlore.replay(str(d), device="cpu")
    assert tables_differ(replayed, want) is None


def test_lore_without_a_dump_path_raises():
    with pytest.raises(ValueError, match="dumpPath"):
        _agg_df(_cpu({"spark.rapids.sql.lore.idsToDump": "1"}),
                _kv_table()).collect_table()
