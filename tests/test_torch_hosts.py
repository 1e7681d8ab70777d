"""The port's multi-process cluster (runtime/cluster.py, cluster_exec.py,
io/common.py's cluster route, the host ladder of runtime/health.py) with
2 REAL executor subprocesses (``python -m
spark_rapids_tpu_torch.runtime.cluster_exec``) against the JAX package.

Comparators:
- scans and aggregates: ``scale_test.tables_differ`` (bitwise, in order)
  against the reference's single-process scan of the same files;
- the host ladder: its rungs and counters equal to the reference's walk
  of the same losses; the error types classified as the reference's."""

import os
import time

import numpy as np
import pytest
import torch

from scale_test import tables_differ
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.runtime import faults as jfaults
from spark_rapids_tpu.runtime import health as jhealth
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.errors import (
    DeviceLostError,
    HostLostError,
    MeshDeviceLostError,
)
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.obs.metrics import scopes_snapshot
from spark_rapids_tpu_torch.plan.executable_cache import EXEC_CACHE
from spark_rapids_tpu_torch.runtime import faults as tfaults
from spark_rapids_tpu_torch.runtime import health as thealth
from spark_rapids_tpu_torch.runtime.cluster import (
    CLUSTER,
    ClusterDriver,
    _recv_msg,
    _send_msg,
    spawn_executor,
)
from spark_rapids_tpu_torch.session import TorchSession

pytestmark = [pytest.mark.multihost, pytest.mark.chaos]

_HB_MS = 200


def _reset():
    for pkg in (jfaults, tfaults):
        pkg.FAULTS.disarm()
        pkg.CIRCUIT_BREAKER.reset()
    for pkg in (jhealth, thealth):
        pkg.HEALTH.reset()
        pkg.QUARANTINE.reset()
    CLUSTER.restore()
    EXEC_CACHE.clear()


@pytest.fixture(autouse=True)
def _clean_host_state():
    _reset()
    yield
    _reset()


def _wait_for(predicate, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return predicate()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A Parquet table in 4 files (row slices in order), written by the
    port's writer; the file paths in order."""
    base = tmp_path_factory.mktemp("hosts_corpus")
    n = 800
    rng = np.random.default_rng(4)
    t = host_table_from_arrays(
        ["k", "v", "x", "d"], ["string", "bigint", "double", "date"],
        [(np.array([f"k{i % 7}" for i in range(n)], dtype=object),
          rng.random(n) > 0.05),
         (np.arange(n, dtype=np.int64), np.ones(n, bool)),
         (np.arange(n, dtype=np.float64) * 0.5, rng.random(n) > 0.05),
         (rng.integers(0, 20000, n).astype(np.int32), np.ones(n, bool))])
    s = TorchSession(device="cpu")
    from spark_rapids_tpu_torch.plan import from_host_table
    paths = []
    for i in range(4):
        d = str(base / f"c{i:03d}")
        from_host_table(t.slice(i * 200, 200), s).write_parquet(d)
        paths += sorted(os.path.join(d, f) for f in os.listdir(d)
                        if f.endswith(".parquet"))
    return paths


@pytest.fixture(scope="module")
def cluster2():
    """A driver and 2 REAL executor subprocesses, attached; every
    executor is killed in the finally, whatever happened."""
    driver = ClusterDriver(2, RapidsConf({
        "spark.rapids.cluster.heartbeatIntervalMs": str(_HB_MS),
        "spark.rapids.cluster.missedBeats": "150"}))
    executors = {}
    try:
        for i in range(2):
            executors[f"h{i}"] = spawn_executor(
                driver.address, f"h{i}", heartbeat_ms=_HB_MS)
        driver.wait_ready(2, timeout_s=90.0)
        CLUSTER.attach_driver(driver)
        yield driver, executors
    finally:
        CLUSTER.attach_driver(None)
        driver.shutdown()
        for h in executors.values():
            try:
                h.terminate()
            except Exception:
                pass
        TorchSession(device="cpu").placement.prepare()


def _session(extra=None):
    conf = {"spark.rapids.cluster.enabled": "true",
            "spark.rapids.cluster.hosts": "2",
            "spark.rapids.cluster.heartbeatIntervalMs": str(_HB_MS),
            "spark.rapids.cluster.missedBeats": "150"}
    conf.update(extra or {})
    return TorchSession(conf, device="cpu")


def _agg(s, paths):
    F = TF if isinstance(s, TorchSession) else JF
    return (s.read_parquet(*paths).group_by("k")
            .agg(F.sum("v").alias("sv"), F.sum("x").alias("sx"),
                 F.count("v").alias("n"), F.max("d").alias("md")))


def _ref(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


_EXPECTED = {}


def _expected(paths, what):
    if what not in _EXPECTED:
        js = TpuSession()
        _EXPECTED[what] = (js.read_parquet(*paths).collect_table()
                           if what == "scan"
                           else _agg(js, paths).collect_table())
    return _EXPECTED[what]


def _cluster_scope():
    return dict(scopes_snapshot().get("cluster", {}))


def test_by_host_scan_matches_the_reference_single_process(cluster2, corpus,
                                                           tmp_path):
    s = _session({"spark.rapids.sql.eventLog.enabled": "true",
                  "spark.rapids.sql.eventLog.dir": str(tmp_path)})
    before = _cluster_scope()
    got = s.read_parquet(*corpus).collect_table()
    assert tables_differ(_ref(got), _expected(corpus, "scan")) is None
    got_agg = _agg(s, corpus).collect_table()
    assert tables_differ(_ref(got_agg), _expected(corpus, "agg")) is None
    after = _cluster_scope()
    # one batch a file, every file through an executor, twice
    assert after.get("hostShardsLanded", 0) - before.get(
        "hostShardsLanded", 0) == 8
    rec = s.last_event_record
    assert rec["hostTopology"] == "2"
    assert rec["hostsLost"] == 0 and rec["hostRelands"] == 0
    assert sorted(rec["hostScans"]) == ["h0", "h1"]
    assert sum(v["files"] for v in rec["hostScans"].values()) == 4


def test_executors_import_nothing_forbidden_and_make_no_cuda_call(cluster2):
    driver, executors = cluster2
    for host in ("h0", "h1"):
        ch = driver._channel(host)
        with ch.lock:
            _send_msg(ch.sock, {"type": "ping"})
            reply, _ = _recv_msg(ch.sock)
        assert reply["host"] == host
        assert reply["cudaInitialized"] is False
        assert reply["forbiddenModules"] == []
        assert reply["pid"] == executors[host].proc.pid


@pytest.mark.parametrize("point", ["host.dispatch", "host.shard.land"])
def test_host_loss_walks_the_ladder_and_converges(cluster2, corpus, point):
    """device_lost twice at a host.* point: the typed HostLostError walks
    retry then re-land on the survivor; the result is unchanged, the
    replay's scan re-lands the marked host's files (the sweep restores a
    re-land rung's host only after a scan has routed around it), the
    ladder's counters are the reference's walk, and the marked host
    (whose process never died) is restored by the sweep."""
    s = _session({"spark.rapids.test.faults": f"{point}:device_lost:2:3"})
    before = _cluster_scope()
    got = _agg(s, corpus).collect_table()
    assert tables_differ(_ref(got), _expected(corpus, "agg")) is None
    snap = thealth.HEALTH.host_snapshot()
    assert snap["hostsLost"] == 2
    after = _cluster_scope()
    assert after.get("hostsLost", 0) - before.get("hostsLost", 0) == 1
    assert after.get("hostRelands", 0) - before.get("hostRelands", 0) >= 1
    assert s.last_metrics()["runtimeFaultReplays"] == 0
    assert _wait_for(
        lambda: not CLUSTER.health_snapshot()["lostHosts"], 20.0), \
        CLUSTER.health_snapshot()
    # the reference's ladder over the same two losses
    from spark_rapids_tpu.conf import RapidsConf as JConf
    from spark_rapids_tpu.errors import HostLostError as JHL
    jconf = JConf({"spark.rapids.cluster.enabled": "true",
                   "spark.rapids.cluster.hosts": "2"})
    TpuSession({"spark.rapids.cluster.enabled": "true",
                "spark.rapids.cluster.hosts": "2"}).placement.prepare()
    jwalk = [jhealth.HEALTH.on_host_loss(JHL("x"), jconf) for _ in range(2)]
    assert jwalk == ["retry", "reland"]
    jsnap = jhealth.HEALTH.host_snapshot()
    assert (jsnap["hostsLost"], jsnap["hostShrinks"]) == (
        snap["hostsLost"], snap["hostShrinks"])


def test_corrupt_frame_relands_from_the_intact_copy(cluster2, corpus):
    s = _session({"spark.rapids.test.faults": "host.shard.land:corrupt:2:5"})
    before = _cluster_scope()
    got = _agg(s, corpus).collect_table()
    assert tables_differ(_ref(got), _expected(corpus, "agg")) is None
    after = _cluster_scope()
    assert after.get("hostShardRetries", 0) - before.get(
        "hostShardRetries", 0) == 2
    assert tfaults.FAULTS.counters()["host.shard.land"] == 2


def test_dropped_heartbeats_are_counted(cluster2):
    """A fault at the driver's receipt of a beat drops it (counted); the
    host stays registered (the window is far wider than 3 beats)."""
    tfaults.FAULTS.arm("host.heartbeat:device_lost:3:9")
    before = _cluster_scope()
    assert _wait_for(lambda: _cluster_scope().get(
        "executorBeatsDropped", 0) - before.get("executorBeatsDropped", 0)
        >= 3, 10.0)


def test_mesh_exchange_across_host_groups_fires_the_dcn_point(cluster2,
                                                              corpus):
    """With 8 logical devices, two hosts own 4 each: a mesh exchange over
    all 8 crosses host groups (dcnExchanges); a host loss there walks
    the host ladder and the query converges."""
    from spark_rapids_tpu_torch.parallel import mesh as tmesh
    tmesh.declare_logical_devices(8, ["cpu"])
    try:
        s = _session({"spark.rapids.mesh.enabled": "true",
                      "spark.rapids.test.faults":
                          "host.dcn.exchange:device_lost:1:2"})
        before = _cluster_scope()
        got = s.read_parquet(*corpus).repartition(8, "k").group_by(
            "k").agg(TF.sum("v").alias("sv")).collect_table()
        js = TpuSession()
        want = js.read_parquet(*corpus).repartition(8, "k").group_by(
            "k").agg(JF.sum("v").alias("sv")).collect_table()
        assert tables_differ(_ref(got), want) is None
        after = _cluster_scope()
        assert after.get("dcnExchanges", 0) - before.get(
            "dcnExchanges", 0) == 1
        assert thealth.HEALTH.host_snapshot()["hostsLost"] == 1
        assert CLUSTER.device_host_map() == {i: i // 4 for i in range(8)}
    finally:
        tmesh.reset_logical_devices()
        tmesh.MESH.restore()
        TorchSession(device="cpu").placement.prepare()


def test_sigkill_is_detected_and_the_executor_rejoins(cluster2, corpus):
    """A real SIGKILL: the beat connection's EOF declares the host lost
    at once, scans re-land its files on the survivor with the same
    result, and a respawned executor rejoins at full strength."""
    driver, executors = cluster2
    t0 = time.monotonic()
    executors["h1"].terminate()
    assert _wait_for(
        lambda: "h1" in CLUSTER.health_snapshot()["lostHosts"], 30.0)
    detect_s = time.monotonic() - t0
    before = _cluster_scope()
    got = _agg(_session(), corpus).collect_table()
    assert tables_differ(_ref(got), _expected(corpus, "agg")) is None
    assert _cluster_scope().get("hostRelands", 0) - before.get(
        "hostRelands", 0) >= 1
    assert CLUSTER.topology_str() == "1/2"
    executors["h1"] = spawn_executor(driver.address, "h1",
                                     heartbeat_ms=_HB_MS)
    assert _wait_for(
        lambda: not CLUSTER.health_snapshot()["lostHosts"], 60.0)
    assert CLUSTER.topology_str() == "2"
    got2 = _agg(_session(), corpus).collect_table()
    assert tables_differ(_ref(got2), _expected(corpus, "agg")) is None
    assert detect_s < 10.0


def test_missed_beat_sweep_declares_the_host_lost():
    from spark_rapids_tpu_torch.shuffle.transport import PeerInfo
    drv = ClusterDriver(3, RapidsConf({
        "spark.rapids.cluster.heartbeatIntervalMs": "100",
        "spark.rapids.cluster.missedBeats": "2"}))
    prev = CLUSTER.driver()  # the module's cluster, if it runs
    try:
        CLUSTER.attach_driver(drv)
        _session({"spark.rapids.cluster.hosts": "3"}).placement.prepare()
        drv._hb.register_executor(PeerInfo(executor_id="h2"))
        time.sleep(0.5)
        drv.sweep_once()
        assert _wait_for(
            lambda: "h2" in CLUSTER.health_snapshot()["lostHosts"], 10.0)
    finally:
        drv.shutdown()
        CLUSTER.attach_driver(prev)


def test_error_types_are_classified_as_the_references():
    from spark_rapids_tpu.errors import HostLostError as JHL
    from spark_rapids_tpu.errors import MeshDeviceLostError as JMDL
    for point, port_type, ref_type in (
            ("host.dispatch", HostLostError, JHL),
            ("mesh.gather", MeshDeviceLostError, JMDL)):
        tfaults.FAULTS.arm(f"{point}:device_lost:1:1")
        jfaults.FAULTS.arm(f"{point}:device_lost:1:1")
        with pytest.raises(port_type) as ei:
            tfaults.fault_point(point)
        with pytest.raises(ref_type):
            jfaults.fault_point(point)
        assert isinstance(ei.value, DeviceLostError)
        other = MeshDeviceLostError if port_type is HostLostError \
            else HostLostError
        assert not isinstance(ei.value, other)
        tfaults.FAULTS.disarm()
        jfaults.FAULTS.disarm()


def test_host_ladder_rungs_match_the_reference():
    """retry, reland, shrink (maxHostLosses 1), a fresh ladder, then the
    single-process latch and the escalation: the port's walk is the
    reference's, and a cluster-native success resets it."""
    from spark_rapids_tpu.conf import RapidsConf as JConf
    from spark_rapids_tpu.errors import HostLostError as JHL
    from spark_rapids_tpu.runtime.cluster import CLUSTER as JCLUSTER
    drv = ClusterDriver(2)
    prev = CLUSTER.driver()  # the module's cluster, if it runs
    try:
        CLUSTER.attach_driver(drv)
        _session().placement.prepare()
        TpuSession({"spark.rapids.cluster.enabled": "true",
                    "spark.rapids.cluster.hosts": "2"}).placement.prepare()
        tconf = RapidsConf({"spark.rapids.cluster.maxHostLosses": "1"})
        jconf = JConf({"spark.rapids.cluster.maxHostLosses": "1"})
        twalk = [thealth.HEALTH.on_host_loss(
            HostLostError("x", host_id="h1"), tconf, torch.device("cpu"))
            for _ in range(6)]
        jwalk = [jhealth.HEALTH.on_host_loss(JHL("x", host_id="h1"), jconf)
                 for _ in range(6)]
        assert twalk[:6] == ["retry", "reland", "shrink", "retry", "reland",
                             "single_process"]
        assert jwalk == twalk
        assert CLUSTER.health_snapshot()["singleProcessReason"]
        thealth.HEALTH.reset()
        CLUSTER.restore()
        assert thealth.HEALTH.on_host_loss(HostLostError("x"), tconf) == \
            "retry"
        thealth.HEALTH.note_success(cluster_native=True)
        assert thealth.HEALTH.on_host_loss(HostLostError("x"), tconf) == \
            "retry"
    finally:
        CLUSTER.attach_driver(prev)
        drv.shutdown()
        JCLUSTER.restore()
        jhealth.HEALTH.reset()
        TpuSession().placement.prepare()


def test_unroutable_scans_stay_local_and_count_fallbacks(cluster2,
                                                         tmp_path):
    """A hive-partitioned Parquet path cannot be split by host (partition
    inference must see every file): the scan stays local, counts
    clusterScanFallbacks, and equals the reference's scan."""
    from spark_rapids_tpu_torch.plan import from_host_table
    n = 60
    t = host_table_from_arrays(
        ["p", "v"], ["bigint", "bigint"],
        [(np.arange(n, dtype=np.int64) % 3, np.ones(n, bool)),
         (np.arange(n, dtype=np.int64), np.ones(n, bool))])
    out = str(tmp_path / "hive")
    from_host_table(t, TorchSession(device="cpu")).write_parquet(
        out, partition_by=["p"])
    before = _cluster_scope()
    got = _session().read_parquet(out).collect_table()
    after = _cluster_scope()
    assert after.get("clusterScanFallbacks", 0) - before.get(
        "clusterScanFallbacks", 0) == 1
    assert after.get("hostShardsLanded", 0) == before.get(
        "hostShardsLanded", 0)
    want = TpuSession().read_parquet(out).collect_table()
    assert tables_differ(_ref(got), want) is None

