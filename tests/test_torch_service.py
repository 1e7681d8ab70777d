"""The port's query service (``service/*``) on the CPU, against the JAX
package's ``QueryService`` over ``TpuSession`` where both can be run on
the same inputs:

* concurrent submissions of corpus queries (``datagen.scale_test_specs
  (0.02)``, seed 0, two tenants, four workers) in both packages. Each
  port result is held against its serial run with
  ``scale_test.tables_differ`` (bitwise: on the CPU ``index_add_`` adds in
  row order, so even the loadtest's named f64 sums repeat), and against
  the reference's concurrent result with the corpus runner's comparators
  (tests/test_torch_corpus_wide.py): ``tables_differ`` for the exact
  queries, ``tables_close`` (rtol 1e-9) only for the queries whose f64
  sums the two packages add in another order (q1, q3);
* ``parse_pools`` and ``parse_tenant_weights`` on the same specs;
* one worker's admission order for a fixed submission sequence, with the
  charges set by hand (the pick and the clocks, not a measured wall);
* the handle's state machine;
* the event record's service fields and the cache-hit record, against
  the reference's golden record's keys;
* the introspection documents' keys, and ``render_top`` of one document
  through both renderers, compared as strings.

The port's own lifecycle (cancellation at a batch boundary, deadlines,
queue depth, the memory gate, the result cache) is driven through a scan
gate (tests/torch_service_util.py): hand-offs are Events, never sleeps,
and every wait is bounded."""

import json
import urllib.request
from collections import deque

import numpy as np
import pytest
import torch

from scale_test import build_queries as jbuild_queries
from scale_test import tables_close, tables_differ
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.service import QueryService as JQueryService
from spark_rapids_tpu.service.query import QueryHandle as JQueryHandle
from spark_rapids_tpu.service.scheduler import (
    parse_pools as jparse_pools,
    parse_tenant_weights as jparse_tenant_weights,
)
from spark_rapids_tpu.tools import top as jtop
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.errors import (
    QueryCancelledError,
    QueryRejectedError,
    QueryTimeoutError,
)
from spark_rapids_tpu_torch.models import corpus as tcorpus
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.service import QueryService, QueryState
from spark_rapids_tpu_torch.service.query import QueryHandle
from spark_rapids_tpu_torch.service.scheduler import (
    parse_pools,
    parse_tenant_weights,
)
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.tools import top as ttop
from tests.torch_service_util import (
    WAIT_S,
    ScanGate,
    as_reference,
    key_shape,
    kv_table,
    per_test_timeout,
    port_table,
    reference_table,
    reset_process_state,
)

SF = 0.02
SEED = 0
#: the corpus queries of the concurrent comparison, by the comparator
#: that holds the port's result to the reference's
EXACT = ("q5", "q6", "q13", "q18")
F64_SUMS = ("q1", "q3")
TENANTS = 2
WORKERS = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean_state():
    reset_process_state()
    with per_test_timeout():
        yield
    reset_process_state()


def _cpu_service(conf=None, **kw):
    return QueryService(dict(conf or {}), device="cpu", **kw)


def _gated_query(svc, batches: int = 8):
    """A filter and group-by over ``batches`` scan batches (the gate holds
    the second landing)."""
    t = port_table(kv_table())
    df = tfrom(t, svc.session, num_batches=batches)
    return df.filter(tcol("v") > -900).group_by("k").agg(
        TF.sum("v").alias("s"), TF.count("v").alias("n"))


def _fast_query(svc, table, lo=0):
    return tfrom(table, svc.session).filter(tcol("v") > lo).group_by(
        "k").agg(TF.count("v").alias("c"))


# -- concurrent results against serial runs and the reference -----------------

def _tables():
    """(port tables, reference tables) of the corpus, made per test: a
    module-level cache would keep their device images accounted in both
    packages' memory arbiters for the worker's later test files."""
    tabs = tcorpus.corpus_tables(SF, SEED)
    return tabs, {n: as_reference(t) for n, t in tabs.items()}


def test_concurrent_results_match_serial_and_the_reference():
    ttabs, jtabs = _tables()
    names = F64_SUMS + EXACT
    serial_q = tcorpus.build_queries(TorchSession(device="cpu"), ttabs)
    serial = {n: serial_q[n]().collect_table() for n in names}
    with _cpu_service(max_concurrent=WORKERS) as svc:
        q = tcorpus.build_queries(svc.session, ttabs)
        port = [(n, svc.submit(q[n](), tenant=f"t{t}", tag=n))
                for t in range(TENANTS) for n in names]
        for _, h in port:
            assert h.wait(WAIT_S) and h.state == QueryState.FINISHED, h.error
    # counted after the handle turns FINISHED: read once the workers ended
    assert svc.stats()["finished"] == len(port)
    with JQueryService({"spark.rapids.service.maxConcurrentQueries":
                        str(WORKERS)}) as jsvc:
        jq = jbuild_queries(jsvc.session, jtabs)
        ref = [(n, jsvc.submit(jq[n](), tenant=f"t{t}", tag=n))
               for t in range(TENANTS) for n in names]
        for _, h in ref:
            assert h.wait(WAIT_S) and h.state == "FINISHED", h.error
    want = {n: h.result_table for n, h in ref}
    for n, h in port:
        got = as_reference(h.result_table)
        # concurrency changes no bit of the port's own result
        assert tables_differ(got, as_reference(serial[n])) is None, n
        if n in EXACT:
            assert tables_differ(got, want[n]) is None, n
        else:
            assert tables_close(got, want[n], rtol=1e-9) is None, n


# -- pools, weights and the pick ----------------------------------------------

SPECS = ["a;b:weight=2", " x:weight=0.5 ; y ", "default", "a;a",
         "a:weight=0", "", "a:weight=high", "a:wt=2", ":weight=1"]
WEIGHT_SPECS = ["x=2, y=0.5", "", "x", "x=fast", "x=0", "=1", "a=1,b=3"]


def _outcome(fn, spec):
    try:
        return ("ok", dict(fn(spec)))
    except Exception as exc:
        return ("raises", type(exc).__name__)


@pytest.mark.parametrize("spec", SPECS)
def test_parse_pools_matches_the_reference(spec):
    assert _outcome(parse_pools, spec) == _outcome(jparse_pools, spec)


@pytest.mark.parametrize("spec", WEIGHT_SPECS)
def test_parse_tenant_weights_matches_the_reference(spec):
    assert _outcome(parse_tenant_weights, spec) == \
        _outcome(jparse_tenant_weights, spec)


#: a fixed submission sequence of (pool, tenant), and the charge (seconds)
#: of each pick in turn, set by hand
SEQUENCE = [("a", "t1"), ("a", "t2"), ("b", "t1"), ("a", "t1"),
            ("b", "t3"), ("b", "t3"), ("a", "t2"), ("b", "t1"),
            ("a", "t3"), ("b", "t1")]
CHARGES = [0.30, 0.10, 0.50, 0.20, 0.40, 0.10, 0.25, 0.05, 0.60, 0.15]
WFQ_CONF = {"spark.rapids.service.pools": "a:weight=3;b",
            "spark.rapids.service.tenantWeights": "t1=2,t3=0.5"}


def _admission_order(svc, handle_cls):
    """Queue SEQUENCE by hand under the scheduler's lock (its one worker
    cannot pick meanwhile), then pick everything, charging CHARGES."""
    handles = []
    with svc._cond:
        for pool, tenant in SEQUENCE:
            h = handle_cls(tenant=tenant, pool=pool, tag=None,
                           sql_text=None, plan=None, deadline=None)
            svc._activate_locked(pool, tenant)
            svc._queues.setdefault((pool, tenant), deque()).append(h)
            svc._queued_per_pool[pool] += 1
            handles.append(h)
        order = []
        for charge in CHARGES:
            h = svc._pick_locked()
            order.append(handles.index(h))
            svc._charge_locked(h, charge)
        assert svc._pick_locked() is None
        clocks = ({p: round(c, 9) for p, c in svc._pool_clock.items()},
                  {k: round(c, 9) for k, c in svc._tenant_clock.items()})
    return order, clocks


def test_admission_order_matches_the_reference():
    with _cpu_service(WFQ_CONF, max_concurrent=1) as svc:
        got = _admission_order(svc, QueryHandle)
    with JQueryService(dict(WFQ_CONF), max_concurrent=1) as jsvc:
        want = _admission_order(jsvc, JQueryHandle)
    assert got == want
    assert sorted(got[0]) == list(range(len(SEQUENCE)))


def _walk(handle_cls):
    """The transitions' results and states of two handles."""
    out = []
    h = handle_cls(tenant="t", pool="p", tag="x", sql_text=None, plan=None,
                   deadline=None)
    out.append(h.state)
    for st in (QueryState.ADMITTED, QueryState.RUNNING):
        out.append((st, h._transition(st), h.state, h.done))
    out.append(("finish", h._transition(QueryState.FINISHED, result="r"),
                h.state, h.done, h.result(0)))
    # terminal states latch
    out.append(("cancel", h._transition(QueryState.CANCELLED), h.state,
                h.cancel()))
    out.append((h.latency_s is not None, h.run_s is not None,
                h.queue_wait_s is not None))
    g = handle_cls(tenant="t", pool="p", tag=None, sql_text=None,
                   plan=None, deadline=None)
    out.append(("cancel queued", g.cancel(), g.state,
                g.scope.cancelled.is_set()))
    out.append(("to cancelled", g._transition(QueryState.CANCELLED),
                g.state, g.run_s, g._transition(QueryState.RUNNING)))
    return out


def test_handle_state_machine_matches_the_reference():
    assert _walk(QueryHandle) == _walk(JQueryHandle)


# -- the event record and the introspection documents -------------------------

def _records(directory):
    out = []
    for p in sorted(directory.glob("*.jsonl")):
        out += [json.loads(line) for line in p.read_text().splitlines()]
    return sorted(out, key=lambda r: r["queryIndex"])


SERVICE_FIELDS = ("tenant", "pool", "queueWaitS", "cacheHit", "quarantined",
                  "workerRestarts")


def _run_logged(svc, df_of, directory):
    h1 = svc.submit(df_of(), tenant="alice", tag="first")
    assert h1.wait(WAIT_S) and h1.error is None, h1.error
    h2 = svc.submit(df_of(), tenant="bob", tag="second")
    assert h2.wait(WAIT_S) and h2.error is None, h2.error
    assert (h1.cache_hit, h2.cache_hit) == (False, True)
    return _records(directory)


def test_event_record_service_fields_match_the_reference(tmp_path):
    golden = json.load(open(__file__.replace(
        "test_torch_service.py", "golden_eventlog.json")))
    spec = kv_table(512)
    logs = {}
    for name in ("port", "ref"):
        d = tmp_path / name
        conf = {"spark.rapids.sql.eventLog.enabled": "true",
                "spark.rapids.sql.eventLog.dir": str(d)}
        if name == "port":
            with _cpu_service(conf) as svc:
                t = port_table(spec)
                logs[name] = _run_logged(svc, lambda: tfrom(
                    t, svc.session).group_by("k").agg(
                    TF.sum("v").alias("s")), d)
        else:
            with JQueryService(conf) as jsvc:
                t = reference_table(spec)
                logs[name] = _run_logged(jsvc, lambda: jfrom(
                    t, jsvc.session).group_by("k").agg(
                    JF.sum("v").alias("s")), d)
    for recs in logs.values():
        assert [r["queryTag"] for r in recs] == ["first", "second"]
        assert [set(r) for r in recs] == [set(golden)] * 2
    for i, (mine, ref) in enumerate(zip(logs["port"], logs["ref"])):
        assert {k: (type(mine[k]).__name__, mine[k] if k != "queueWaitS"
                    else None) for k in SERVICE_FIELDS} == \
            {k: (type(ref[k]).__name__, ref[k] if k != "queueWaitS"
                 else None) for k in SERVICE_FIELDS}, i
        assert mine["tenant"] == ("alice", "bob")[i]
        assert mine["cacheHit"] is (i == 1)
    hit = logs["port"][1]
    # nothing executed on a cache serve
    assert hit["compileMs"] == 0.0 and hit["oomRetries"] == 0 \
        and hit["meshShape"] is None


#: document keys whose own keys are names (pools, tenants, scopes)
VARIABLE_KEYS = ("poolClocks", "tenantClocks", "queued", "tenants",
                 "pools", "scopes", "deltas")


def _top_doc(svc, df_of):
    h = svc.submit(df_of(), tenant="alice")
    assert h.wait(WAIT_S) and h.error is None, h.error
    url = f"http://127.0.0.1:{svc.introspect_port}"
    docs = {}
    for route in ("/top", "/health", "/topology", "/stats", "/slo",
                  "/queries", "/streams", "/telemetry?n=2"):
        with urllib.request.urlopen(url + route, timeout=WAIT_S) as r:
            docs[route] = json.loads(r.read().decode())
    return docs


def test_introspection_documents_match_the_reference():
    conf = {"spark.rapids.service.introspect.enabled": "true",
            "spark.rapids.obs.telemetry.enabled": "false"}
    spec = kv_table(256)
    with _cpu_service(conf) as svc:
        t = port_table(spec)
        got = _top_doc(svc, lambda: tfrom(t, svc.session).group_by(
            "k").agg(TF.count("v").alias("c")))
    with JQueryService(dict(conf)) as jsvc:
        jt = reference_table(spec)
        want = _top_doc(jsvc, lambda: jfrom(jt, jsvc.session).group_by(
            "k").agg(JF.count("v").alias("c")))
    for route in got:
        assert key_shape(got[route], maps=VARIABLE_KEYS) == \
            key_shape(want[route], maps=VARIABLE_KEYS), route
    assert got["/streams"] == {"streams": []}
    assert got["/top"]["health"]["state"] == "HEALTHY"
    # one document through both renderers, compared as strings
    for doc in (got["/top"], want["/top"]):
        assert ttop.render_top(doc) == jtop.render_top(doc)


# -- the port's lifecycle -----------------------------------------------------

def test_running_query_cancels_at_a_batch_boundary(monkeypatch):
    gate = ScanGate(monkeypatch, at=2)
    with _cpu_service() as svc:
        h = svc.submit(_gated_query(svc))
        gate.wait_entered()
        assert h.state == QueryState.RUNNING
        assert h.cancel()
        gate.release.set()
        assert h.wait(WAIT_S) and h.state == QueryState.CANCELLED
        with pytest.raises(QueryCancelledError):
            h.result(0)
        # stopped at the next pull: the other six batches never landed
        assert gate.calls == 2 and h.scope.checks > 0
    assert svc.stats()["cancelled"] == 1


def test_queued_query_cancels_without_running(monkeypatch):
    gate = ScanGate(monkeypatch, at=1)
    with _cpu_service(max_concurrent=1) as svc:
        blocker = svc.submit(_gated_query(svc))
        gate.wait_entered()
        queued = svc.submit(_gated_query(svc))
        assert queued.cancel()
        assert queued.wait(WAIT_S) and queued.state == QueryState.CANCELLED
        assert queued.start_t is None
        gate.release.set()
        assert blocker.wait(WAIT_S) and blocker.state == QueryState.FINISHED


def test_running_deadline_times_out(monkeypatch):
    import time
    gate = ScanGate(monkeypatch, at=2)
    with _cpu_service() as svc:
        h = svc.submit(_gated_query(svc), timeout_ms=60_000)
        gate.wait_entered()
        h.scope.deadline = time.monotonic() - 1.0  # expired, by hand
        gate.release.set()
        assert h.wait(WAIT_S) and h.state == QueryState.TIMED_OUT
        with pytest.raises(QueryTimeoutError):
            h.result(0)
    assert svc.stats()["timed_out"] == 1


def test_queued_deadline_times_out_without_running(monkeypatch):
    import time
    gate = ScanGate(monkeypatch, at=1)
    with _cpu_service(max_concurrent=1) as svc:
        blocker = svc.submit(_gated_query(svc))
        gate.wait_entered()
        queued = svc.submit(_gated_query(svc), timeout_ms=60_000)
        queued.scope.deadline = time.monotonic() - 1.0
        # the sweeper expires it while the only worker is held
        assert queued.wait(WAIT_S) and queued.state == QueryState.TIMED_OUT
        assert queued.start_t is None and blocker.state == "RUNNING"
        gate.release.set()
        assert blocker.wait(WAIT_S)


def test_queue_full_rejection_with_retry_after(monkeypatch):
    gate = ScanGate(monkeypatch, at=1)
    with _cpu_service({"spark.rapids.service.queueDepth": "1"},
                      max_concurrent=1) as svc:
        running = svc.submit(_gated_query(svc))
        gate.wait_entered()
        queued = svc.submit(_gated_query(svc))
        with pytest.raises(QueryRejectedError) as ei:
            svc.submit(_gated_query(svc))
        assert ei.value.retry_after_ms >= 50
        assert svc.stats()["rejected"] == 1
        gate.release.set()
        for h in (running, queued):
            assert h.wait(WAIT_S) and h.state == QueryState.FINISHED


def test_memory_gate_holds_admission_until_nothing_runs(monkeypatch):
    import threading
    gate = ScanGate(monkeypatch, at=1)
    consulted = threading.Event()
    conf = {"spark.rapids.service.admission.maxDeviceBytes": "1"}
    with _cpu_service(conf, max_concurrent=2) as svc:
        def probe():
            consulted.set()
            return 10 ** 12  # far over the mark
        svc._memory_probe = probe
        h1 = svc.submit(_gated_query(svc))
        gate.wait_entered()
        h2 = svc.submit(_gated_query(svc))
        assert consulted.wait(WAIT_S)
        # a worker was free, and the gate held h2
        assert h2.state == QueryState.QUEUED
        assert svc.stats()["heldForMemory"] >= 1
        gate.release.set()
        # forward progress once nothing runs
        assert h2.wait(WAIT_S) and h2.state == QueryState.FINISHED
        assert h2.start_t >= h1.end_t


def test_memory_probe_reads_the_ledger_not_the_allocator(monkeypatch):
    from spark_rapids_tpu_torch.runtime.memory import MEMORY
    from spark_rapids_tpu_torch.service.scheduler import (
        _default_memory_probe,
    )
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda *a: (_ for _ in ()).throw(
                            AssertionError("the allocator was read")))
    assert _default_memory_probe() >= MEMORY.occupancy() >= 0


def test_result_cache_hit_is_bit_identical_and_lru_bounded():
    t = port_table(kv_table(512))
    with _cpu_service() as svc:
        h1 = svc.submit(_fast_query(svc, t), tenant="a")
        t1 = h1.result(WAIT_S)
        h2 = svc.submit(_fast_query(svc, t), tenant="b")
        t2 = h2.result(WAIT_S)
        assert (h1.cache_hit, h2.cache_hit) == (False, True)
        assert tables_differ(as_reference(t1), as_reference(t2)) is None
        st = svc.result_cache.stats()
        assert (st["hits"], st["misses"]) == (1, 1)
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    from spark_rapids_tpu_torch import types as T
    small = HostTable(["v"], [HostColumn(T.LONG,
                                         np.arange(100, dtype=np.int64))])
    from spark_rapids_tpu_torch.service import ResultCache
    cache = ResultCache(max_bytes=int(small.nbytes() * 2.5))
    assert cache.put("a", small) and cache.put("b", small) \
        and cache.put("c", small)
    assert cache.evictions == 1 and cache.entry_count == 2
    assert cache.get("a") is None and cache.get("c") is not None
    big = HostTable(["v"], [HostColumn(T.LONG,
                                       np.arange(10 ** 5, dtype=np.int64))])
    assert not cache.put("huge", big)


def test_cache_invalidated_on_temp_view_mutation():
    t = port_table(kv_table(256))
    with _cpu_service() as svc:
        tfrom(t, svc.session).create_or_replace_temp_view("kv")
        sql = "SELECT k, COUNT(v) AS c FROM kv GROUP BY k"
        a = svc.submit(sql).result(WAIT_S)
        # re-registering the view bumps the epoch: no stale serve
        tfrom(t, svc.session).create_or_replace_temp_view("kv")
        h = svc.submit(sql)
        b = h.result(WAIT_S)
        assert not h.cache_hit
        assert svc.result_cache.stats()["invalidations"] == 1
        assert tables_differ(as_reference(a), as_reference(b)) is None


@pytest.mark.filterwarnings("ignore:UDF <lambda> does not compile")
def test_uncacheable_plans_never_cache():
    t = port_table(kv_table(256))
    # a row-wise Python UDF (the compiler rejects str()): its closure is
    # plan state no fingerprint can prove stable
    from spark_rapids_tpu_torch import types as T
    plus = TF.udf(lambda v: len(str(v)), T.LONG)
    with _cpu_service() as svc:
        def q():
            return tfrom(t, svc.session).select(plus(tcol("v")).alias(
                "w")).agg(TF.sum("w").alias("s"))
        hs = [svc.submit(q()) for _ in range(2)]
        for h in hs:
            assert h.wait(WAIT_S) and h.error is None, h.error
            assert not h.cache_hit
        assert svc.result_cache.stats()["entries"] == 0


def test_cancellation_reads_the_scope_of_a_reused_tree(monkeypatch):
    """A tree converted and cached outside the service still honours the
    service's cancel when the service checks it out."""
    t = port_table(kv_table())
    with _cpu_service() as svc:
        build = lambda: tfrom(t, svc.session, num_batches=8).group_by(
            "k").agg(TF.count("v").alias("c"))
        want = build().collect_table()      # fills the executable cache
        assert svc.session.last_executable_cache_hit is False
        gate = ScanGate(monkeypatch, at=2)
        h = svc.submit(build())
        gate.wait_entered()
        h.cancel()
        gate.release.set()
        assert h.wait(WAIT_S) and h.state == QueryState.CANCELLED
        monkeypatch.undo()
        again = svc.submit(build()).result(WAIT_S)
        assert tables_differ(as_reference(again), as_reference(want)) \
            is None


def test_service_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryService({})
    with _cpu_service() as svc:
        assert svc.session.device.type == "cpu"
        assert svc.streams() == []

        class _Stream:
            name = "s"

            def describe(self):
                return {"name": self.name, "state": "RUNNING"}

            def stop(self, wait=True):
                pass

        # the stream registry and the MV registry run ([12b] streaming)
        svc.register_stream(_Stream())
        assert svc.streams() == [{"name": "s", "state": "RUNNING"}]
        svc.unregister_stream("s")
        assert svc.streams() == []
        mvs = svc.mv_registry()
        assert mvs is svc.mv_registry() and mvs.names() == []


# -- the loadtest and its comparator ------------------------------------------

def test_loadtest_on_the_cpu_holds_every_result_and_its_close_columns():
    """The deviation pinned: on the card the named f64 sums vary in their
    last bits (``index_add_``'s atomics), so ``tools loadtest`` holds them
    within rtol 1e-9. On the CPU the plain version adds in row order, and
    the concurrent results equal the serial ones bit for bit, those
    columns included."""
    from spark_rapids_tpu_torch.tools.loadtest import (
        CLOSE_COLUMNS,
        run_loadtest,
    )
    names = ["q3", "q10", "q15", "q17"]
    assert all(CLOSE_COLUMNS[n] for n in names)
    rep = run_loadtest(sf=SF, seed=SEED, queries=names, concurrency=WORKERS,
                       tenants=TENANTS, device="cpu", timeout_s=WAIT_S)
    assert rep["ok"] and rep["allIdentical"], rep["mismatches"]
    assert rep["backend"] == "cpu" and rep["submissions"] == 8
    assert rep["closeColumns"] == {n: list(CLOSE_COLUMNS[n]) for n in names}
    # the same stream run bitwise: serial against the service, no rtol
    ttabs = tcorpus.corpus_tables(SF, SEED)
    serial_q = tcorpus.build_queries(TorchSession(device="cpu"), ttabs)
    with _cpu_service(max_concurrent=WORKERS) as svc:
        q = tcorpus.build_queries(svc.session, ttabs)
        hs = [(n, svc.submit(q[n]())) for n in names for _ in range(2)]
        for n, h in hs:
            assert h.wait(WAIT_S) and h.error is None, h.error
            assert tables_differ(as_reference(h.result_table), as_reference(
                serial_q[n]().collect_table())) is None, n


def test_loadtest_comparator_holds_only_the_named_columns_within_rtol():
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    from spark_rapids_tpu_torch.tools.loadtest import result_differs

    def table(keys, spend, items):
        return HostTable(["o_custkey", "spend", "items"], [
            HostColumn(T.LONG, np.array(keys, dtype=np.int64)),
            HostColumn(T.DOUBLE, np.array(spend)),
            HostColumn(T.LONG, np.array(items, dtype=np.int64))])

    want = table([3, 1, 2], [10.0, 7.5, 7.25], [4, 2, 9])
    one_ulp = np.nextafter(7.5, 8.0)
    # a last-bit change of the named sum, and the rows it reorders
    assert result_differs("q3", want, table([1, 3, 2], [one_ulp, 10.0,
                                                        7.25],
                                            [2, 4, 9])) is None
    assert "beyond rtol" in result_differs(
        "q3", want, table([3, 1, 2], [10.0, 7.5 * (1 + 1e-6), 7.25],
                          [4, 2, 9]))
    # every other column stays bitwise
    assert result_differs("q3", want, table([3, 1, 2], [10.0, 7.5, 7.25],
                                            [4, 3, 9])) is not None
    # and a query that names no column is bitwise throughout
    assert result_differs("q5", want, table([3, 1, 2], [10.0, one_ulp,
                                                        7.25],
                                            [4, 2, 9])) is not None


def test_counters_hold_under_more_workers_than_cores():
    """More workers than cores, a short switch interval: every lifecycle
    counter, the SLO window and the result cache's hits and misses add up
    to the submissions (a lost update under the scheduler's lock would
    break one of the sums)."""
    import os
    import sys
    n_workers = (os.cpu_count() or 4) + 2
    t = port_table(kv_table(64))
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_service(max_concurrent=n_workers,
                          queue_depth=128) as svc:
            hs = [svc.submit(_fast_query(svc, t, lo=i % 5),
                             tenant=f"t{i % 3}") for i in range(96)]
            for h in hs:
                assert h.wait(WAIT_S) and h.state == QueryState.FINISHED
        # after the workers are joined: a handle turns FINISHED before
        # its worker leaves the running count
        st = svc.stats()
        slo = svc.slo_snapshot()
    finally:
        sys.setswitchinterval(before)
    assert (st["submitted"], st["finished"], st["running"]) == (96, 96, 0)
    assert sum(e["count"] for e in slo["tenants"].values()) == 96
    rc = st["resultCache"]
    assert rc["hits"] + rc["misses"] == 96 and rc["entries"] == 5
    assert sum(h.cache_hit for h in hs) == rc["hits"]
