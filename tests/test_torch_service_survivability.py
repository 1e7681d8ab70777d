"""The port's service survivability on the CPU: device loss under the
service (requeue against the recovered device, and after the CPU-only
latch the replay on the CPU route), the watchdog's hard wall limit over a
``dispatch.wedge`` (the abandoned worker replaced, the next query served),
a ``service.worker_crash`` (respawn and requeue), the quarantine at
admission reached through the memory ladder's ``chunk`` rung (one
flight-recorder bundle per strike), DEGRADED shedding of the lowest-weight
pool, and the concurrent chaos loadtest.

Faults are armed by count, never by probability. The wedge's stall waits
on an Event the test sets (``faults.time`` replaced for the test), and
hand-offs are Events with bounded waits (tests/torch_service_util.py).

Comparators: ``scale_test.tables_differ`` (bitwise) against the query's
serial run on the device path; ``tables_close`` (rtol 1e-9) for q1 after
the ``chunk`` rung, whose chunked scan adds q1's f64 sums in other blocks;
the CPU route's result against the reference's CPU oracle
(``TpuSession({"spark.rapids.sql.enabled": "false"})``) with
``scale_test.tables_differ_unordered`` (a bitwise row multiset: the
query sums integers, and the routes may emit its groups in another
order)."""

import threading

import pytest
import torch

from scale_test import tables_differ
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.errors import (
    HardTimeoutError,
    QueryQuarantinedError,
    QueryRejectedError,
)
from spark_rapids_tpu_torch.models.tpch import lineitem_table, q1_dataframe
from spark_rapids_tpu_torch.obs.telemetry import flush_incidents
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.runtime import faults as tfaults
from spark_rapids_tpu_torch.runtime.faults import FAULTS
from spark_rapids_tpu_torch.runtime.health import HEALTH, QUARANTINE
from spark_rapids_tpu_torch.service import QueryService, QueryState
from spark_rapids_tpu_torch.session import TorchSession
from tests.torch_service_util import (
    WAIT_S,
    ScanGate,
    as_reference,
    kv_table,
    per_test_timeout,
    port_table,
    reference_table,
    reset_process_state,
)


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


def _svc(conf=None, **kw):
    conf = dict(conf or {})
    conf.setdefault("spark.rapids.service.resultCache.enabled", "false")
    return QueryService(conf, device="cpu", **kw)


def _q1_table(rows=2000, seed=4):
    return lineitem_table(rows, seed)


def _serial_q1(table):
    return as_reference(q1_dataframe(TorchSession(device="cpu"),
                                     table).collect_table())


def _finished(h):
    assert h.wait(WAIT_S), f"{h} did not end"
    assert h.state == QueryState.FINISHED, h.error
    return as_reference(h.result_table)


def test_device_loss_requeues_against_the_recovered_device(tmp_path):
    t = _q1_table()
    want = _serial_q1(t)
    conf = {"spark.rapids.test.faults": "device.lost:device_lost:1",
            "spark.rapids.obs.flightRecorder.dir": str(tmp_path)}
    with _svc(conf) as svc:
        h = svc.submit(q1_dataframe(svc.session, t))
        assert tables_differ(_finished(h), want) is None
        assert h.requeues == 1 and svc.stats()["requeued"] == 1
        assert HEALTH.snapshot()["deviceReinits"] == 1
        assert HEALTH.cpu_only_reason() is None
    bundles = [p.name for p in tmp_path.glob("incident-*.json")]
    assert any(n.endswith("-backend.ladder.json") for n in bundles)


def test_after_the_latch_the_replay_answers_on_the_cpu_route():
    from scale_test import tables_differ_unordered
    spec = kv_table(1024)
    t = port_table(spec)
    conf = {"spark.rapids.test.faults": "device.lost:device_lost:1",
            "spark.rapids.service.deviceLoss.maxReinits": "1"}
    want = jfrom(reference_table(spec), TpuSession(
        {"spark.rapids.sql.enabled": "false"})).group_by("k").agg(
        JF.sum("v").alias("s"), JF.count("v").alias("n"),
        JF.max("v").alias("m")).collect_table()
    with _svc(conf) as svc:
        # MAX launches fused_minmax, where the loss is injected
        h = svc.submit(tfrom(t, svc.session).group_by("k").agg(
            TF.sum("v").alias("s"), TF.count("v").alias("n"),
            TF.max("v").alias("m")))
        got = _finished(h)
        assert HEALTH.cpu_only_reason() is not None
        assert h.requeues == 1
        assert svc.health()["state"] == "CPU_ONLY"
        # the replay's root is a host plan: no device exec ran it
        assert not svc.session._last_root.runs_on_device
    # group order may differ between the routes: a bitwise row multiset
    assert tables_differ_unordered(got, want) is None


class _StallClock:
    """Stands in for ``faults.time``: a wedge's sleep waits on ``release``
    (every other attribute is the real module's)."""

    def __init__(self):
        import time
        self._time = time
        self.stalled = threading.Event()
        self.release = threading.Event()

    def sleep(self, _seconds):
        self.stalled.set()
        self.release.wait(WAIT_S)

    def __getattr__(self, name):
        return getattr(self._time, name)


def test_watchdog_abandons_a_wedged_worker_and_the_next_q1_is_served(
        monkeypatch):
    clock = _StallClock()
    monkeypatch.setattr(tfaults, "time", clock)
    t = _q1_table()
    want = _serial_q1(t)
    conf = {"spark.rapids.test.faults": "dispatch.wedge:wedge:1",
            "spark.rapids.service.hardTimeoutMs": "100"}
    try:
        with _svc(conf, max_concurrent=2) as svc:
            h = svc.submit(q1_dataframe(svc.session, t))
            assert clock.stalled.wait(WAIT_S)
            assert h.wait(WAIT_S) and h.state == QueryState.TIMED_OUT
            with pytest.raises(HardTimeoutError):
                h.result(0)
            health = svc.health()
            assert (health["workersLost"], health["workersRespawned"]) \
                == (1, 1)
            assert health["workerCount"] == 2
            assert svc.stats()["hardTimeouts"] == 1
            nxt = svc.submit(q1_dataframe(svc.session, t))
            assert tables_differ(_finished(nxt), want) is None
            # the abandoned thread ends when its launch returns
            clock.release.set()
    finally:
        clock.release.set()


def test_worker_crash_respawns_and_requeues():
    t = _q1_table()
    want = _serial_q1(t)
    with _svc({"spark.rapids.test.faults":
               "service.worker_crash:crash:1"}) as svc:
        h = svc.submit(q1_dataframe(svc.session, t))
        assert tables_differ(_finished(h), want) is None
        assert h.requeues == 1
        stats = svc.stats()
        assert (stats["workersLost"], stats["workersRespawned"],
                stats["requeued"]) == (1, 1, 1)
        assert svc.health()["workerCount"] == 4
        assert QUARANTINE.snapshot()["strikes"] == 1


def test_chunk_rung_strikes_quarantine_the_template_at_admission(tmp_path):
    """Each q1 takes exactly one ``chunk`` rung (6 injected reserve OOMs:
    the retries, the ladder's ``retry``, then ``chunk``): one strike and
    one quarantine bundle per run; at maxStrikes=2 the third submission
    is refused with the strikes."""
    from spark_rapids_tpu_torch.columnar.table import evict_device_caches
    from spark_rapids_tpu_torch.tools.incident import (
        load_bundles,
        render_incident,
    )
    t = _q1_table(3000, 6)
    want = _serial_q1(t)
    conf = {"spark.rapids.test.faults": "mem.reserve:oom:6",
            "spark.rapids.service.quarantine.maxStrikes": "2",
            "spark.rapids.obs.flightRecorder.dir": str(tmp_path)}
    with _svc(conf, max_concurrent=1) as svc:
        for i in range(2):
            # a cold scan reserves (a cached one lands nothing), and the
            # count re-arms
            evict_device_caches()
            FAULTS.disarm()
            h = svc.submit(q1_dataframe(svc.session, t))
            got = _finished(h)
            m = svc.session.last_metrics()
            assert m["memoryChunkedReexecutions"] == 1, m
            from scale_test import tables_close
            assert tables_close(got, want, rtol=1e-9) is None
        with pytest.raises(QueryQuarantinedError) as ei:
            svc.submit(q1_dataframe(svc.session, t))
        assert len(ei.value.strikes) == 2
        assert all("chunk" in s for s in ei.value.strikes)
        assert svc.stats()["quarantineRejected"] == 1
    flush_incidents()
    bundles = load_bundles(str(tmp_path))
    kinds = [b["kind"] for b in bundles]
    assert kinds.count("quarantine") == 2
    assert [b["action"] for b in bundles if b["kind"] == "quarantine"] \
        == ["strike", "quarantined"]
    assert kinds.count("memory.ladder") == 4
    text = render_incident(bundles)
    assert text.startswith(f"Incident bundles: {len(bundles)}")
    assert "kind=quarantine action=quarantined" in text
    assert "faultPoint=mem.reserve" in text


def test_degraded_sheds_the_lowest_weight_pool(monkeypatch):
    gate = ScanGate(monkeypatch, at=1)
    spec = kv_table(2048)
    t = port_table(spec)
    conf = {"spark.rapids.service.pools": "hi:weight=3;lo"}
    with _svc(conf, max_concurrent=2) as svc:
        def q():
            return tfrom(t, svc.session, num_batches=4).group_by("k").agg(
                TF.count("v").alias("c"))
        running = svc.submit(q(), pool="hi")
        gate.wait_entered()
        with svc._cond:
            svc._degraded_pending = svc._DEGRADE_CLEAR_SUCCESSES
        assert svc.health()["state"] == "DEGRADED"
        assert svc.health()["shedPool"] == "lo"
        with pytest.raises(QueryRejectedError, match="DEGRADED") as ei:
            svc.submit(q(), pool="lo")
        assert ei.value.retry_after_ms > 0
        other = svc.submit(q(), pool="hi")
        gate.release.set()
        for h in (running, other):
            assert h.wait(WAIT_S) and h.state == QueryState.FINISHED
    # completed queries pay the latch down (counted after each handle
    # turns FINISHED: read once the workers ended)
    assert svc.health()["state"] == "HEALTHY"


def test_concurrent_chaos_loadtest_holds_every_result(monkeypatch):
    """The seeded service chaos schedule (two worker crashes, two device
    losses, one wedged launch) over a corpus slice at four workers: every
    submission terminal, every FINISHED result held against its serial
    run, failures typed, recovery bounded, and health back to HEALTHY.
    The wedge stalls until the run has ended (``_StallClock``), so only
    the watchdog can end its query."""
    from spark_rapids_tpu_torch.tools import loadtest as L
    clock = _StallClock()
    monkeypatch.setattr(tfaults, "time", clock)
    settings = dict(L.service_chaos_settings(4))
    settings["spark.rapids.service.hardTimeoutMs"] = "5000"
    monkeypatch.setattr(L, "service_chaos_settings", lambda c: settings)
    try:
        rep = L.run_loadtest(sf=0.01, seed=3, queries=["q1", "q6", "q13"],
                             concurrency=4, tenants=3, chaos=True,
                             device="cpu", timeout_s=WAIT_S)
    finally:
        clock.release.set()
    assert rep["ok"], (rep["failures"], rep["mismatches"])
    c = rep["chaos"]
    assert c["faultFires"].get("service.worker_crash") == 2
    assert c["faultFires"].get("device.lost") == 2
    assert c["faultFires"].get("dispatch.wedge") == 1
    assert c["recovery"]["hardTimeouts"] >= 1
    assert not c["hungSubmissions"] and not c["boundsViolations"]
    assert c["returnedToHealthy"]
    assert rep["backend"] == "cpu"
