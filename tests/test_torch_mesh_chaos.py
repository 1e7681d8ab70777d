"""The port's mesh under seeded faults (the ``mesh.*`` fault points, the
checked gathers of parallel/exchange.py and execs/mesh.py, and the mesh
ladder of runtime/health.py) on 8 logical CPU devices, each scenario run
on both packages (the JAX package on its 8-device mesh) with the same
schedule.

Comparators:
- results: ``scale_test.tables_differ`` against the fault-free run of the
  same package (bitwise, in order);
- counters: the ``mesh`` scope's change (gatherChecksFailed,
  shardRetries, iciExchanges), the fault fires, the replays and the mesh
  ladder's snapshot (meshDeviceLost, meshShrinks, meshDegradations),
  equal to the reference's."""

import numpy as np
import pytest
import torch

from scale_test import tables_differ
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.parallel.mesh import MESH as JMESH
from spark_rapids_tpu.runtime import faults as jfaults
from spark_rapids_tpu.runtime import health as jhealth
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.errors import (
    DeviceLostError,
    HostLostError,
    MeshDeviceLostError,
    MeshGatherError,
)
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.obs.metrics import scopes_snapshot
from spark_rapids_tpu_torch.parallel import mesh as tmesh
from spark_rapids_tpu_torch.plan import from_host_table
from spark_rapids_tpu_torch.plan.executable_cache import EXEC_CACHE
from spark_rapids_tpu_torch.runtime import faults as tfaults
from spark_rapids_tpu_torch.runtime import health as thealth
from spark_rapids_tpu_torch.session import TorchSession

pytestmark = [pytest.mark.multichip, pytest.mark.chaos]

MESH = {"spark.rapids.mesh.enabled": "true"}


def _reset():
    for pkg in (jfaults, tfaults):
        pkg.FAULTS.disarm()
        pkg.CIRCUIT_BREAKER.reset()
    for pkg in (jhealth, thealth):
        pkg.HEALTH.reset()
        pkg.QUARANTINE.reset()
    JMESH.restore("test")
    tmesh.MESH.restore("test")
    EXEC_CACHE.clear()


@pytest.fixture(scope="module", autouse=True)
def _eight_logical_devices():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    tmesh.declare_logical_devices(8, ["cpu"])
    yield
    tmesh.reset_logical_devices()
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean_state():
    _reset()
    yield
    _reset()
    TorchSession(device="cpu").placement.prepare()  # the mesh off again
    TpuSession().placement.prepare()


def _data(n=600):
    return {"k": [f"k{i % 7}" for i in range(n)],
            "v": np.arange(n, dtype=np.int64),
            "x": (np.arange(n, dtype=np.float64) * 0.5)}


def _port_df(s):
    d = _data()
    n = len(d["v"])
    return from_host_table(host_table_from_arrays(
        ["k", "v", "x"], ["string", "bigint", "double"],
        [(np.array(d["k"], dtype=object), np.ones(n, bool)),
         (d["v"], np.ones(n, bool)), (d["x"], np.ones(n, bool))]), s)


def _agg(s):
    if isinstance(s, TorchSession):
        return _port_df(s).group_by("k").agg(
            TF.sum("x").alias("sx"), TF.count("v").alias("c"))
    return s.create_dataframe(_data()).group_by("k").agg(
        JF.sum("x").alias("sx"), JF.count("v").alias("c"))


def _exchange(s):
    if isinstance(s, TorchSession):
        return _port_df(s).repartition(8, "k").group_by("k").agg(
            TF.sum("v").alias("s"))
    return s.create_dataframe(_data()).repartition(8, "k").group_by(
        "k").agg(JF.sum("v").alias("s"))


def _jscope():
    from spark_rapids_tpu.obs.metrics import scopes_snapshot as jsnap
    return dict(jsnap().get("mesh", {}))


def _tscope():
    return dict(scopes_snapshot().get("mesh", {}))


def _delta(before, after):
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in set(after) | set(before)
            if after.get(k, 0) != before.get(k, 0)}


_COUNTERS = ("gatherChecksFailed", "shardRetries", "iciExchanges")


def _run_both(query, faults, extra=None):
    """(port delta, reference delta, port replays, reference replays,
    port fires, reference fires) of ``query`` under ``faults``, each
    result held against its package's fault-free run."""
    out = []
    for Session, scope, pkg in ((TorchSession, _tscope, tfaults),
                                (TpuSession, _jscope, jfaults)):
        kw = {"device": "cpu"} if Session is TorchSession else {}
        expected = query(Session(**kw)).collect_table()
        s = Session({**MESH, **(extra or {}),
                     "spark.rapids.test.faults": faults}, **kw)
        before = scope()
        got = query(s).collect_table()
        assert tables_differ(expected if Session is TpuSession else
                             _ref(expected), got if Session is TpuSession
                             else _ref(got)) is None
        d = _delta(before, scope())
        replays = (s.last_metrics()["runtimeFaultReplays"]
                   if Session is TorchSession else s.last_fault_replays)
        out.append(({k: d.get(k, 0) for k in _COUNTERS}, int(replays),
                    dict(pkg.FAULTS.counters())))
    return out


def _ref(t):
    """A port HostTable as the reference's (for tables_differ)."""
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.columnar import HostColumn as JHostColumn
    from spark_rapids_tpu.columnar import HostTable as JHostTable
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


@pytest.mark.parametrize("point,query", [
    ("mesh.shard.put", _agg), ("mesh.ici.exchange", _exchange),
    ("mesh.gather", _agg), ("mesh.dict.upload", _exchange)])
@pytest.mark.parametrize("kind", ["crash", "slow"])
def test_every_mesh_point_with_crash_and_slow(point, query, kind):
    """A crash replays the query, a stall only delays it: the same result,
    replays and fires as the reference's."""
    (td, tr, tf), (jd, jr, jf) = _run_both(query, f"{point}:{kind}:1:11")
    assert tf.get(point) == jf.get(point) == 1
    assert tr == jr == (1 if kind == "crash" else 0)
    assert td == jd


@pytest.mark.parametrize("point,query,counts", [
    ("mesh.ici.exchange", _exchange, {"gatherChecksFailed": 1,
                                      "shardRetries": 1,
                                      "iciExchanges": 1}),
    ("mesh.gather", _agg, {"gatherChecksFailed": 1, "shardRetries": 1,
                           "iciExchanges": 0})])
def test_corrupt_gathers_trip_their_check_and_reland(point, query, counts):
    """A corrupted count read (the exchange) or landed copy (the re-land)
    is caught by its checksum and read or re-landed again from the intact
    source, with no query replay."""
    (td, tr, _), (jd, jr, _) = _run_both(query, f"{point}:corrupt:1:12")
    assert td == jd == counts
    assert tr == jr == 0


def test_gather_check_exhaustion_raises_typed():
    s = TorchSession({**MESH, "spark.rapids.mesh.maxShardRetries": "1",
                      "spark.rapids.sql.runtimeFallback.enabled": "false",
                      "spark.rapids.test.faults":
                          "mesh.gather:corrupt:99:14"}, device="cpu")
    with pytest.raises(MeshGatherError):
        _agg(s).collect_table()


@pytest.mark.parametrize("point,query", [
    ("mesh.gather", _agg), ("mesh.ici.exchange", _exchange),
    ("mesh.shard.put", _agg), ("mesh.dict.upload", _exchange)])
def test_device_lost_walks_the_ladder_to_a_shrink_and_restores(point,
                                                               query):
    """device_lost x3 at a mesh point: retry, a single-device replay
    (the demotion in explain), then a shrink onto 7 logical devices;
    results unchanged throughout, the ladder's counters the reference's,
    and the mesh back at 8 after restore."""
    faults = f"{point}:device_lost:3:15"
    snaps = []
    for Session, H, M, pkg in ((TorchSession, thealth, tmesh.MESH, tfaults),
                               (TpuSession, jhealth, JMESH, jfaults)):
        kw = {"device": "cpu"} if Session is TorchSession else {}
        expected = query(Session(**kw)).collect_table()
        s = Session({**MESH, "spark.rapids.test.faults": faults}, **kw)
        for _ in range(3):
            got = query(s).collect_table()
            assert tables_differ(
                *(( _ref(expected), _ref(got)) if Session is TorchSession
                  else (expected, got))) is None
        snap = M.health_snapshot()
        assert snap["shape"] == "7" and len(snap["excludedDeviceIds"]) == 1
        assert "mesh degraded" in (snap["degradedReason"] or "")
        assert H.HEALTH.state() == "HEALTHY"
        explain = s.explain(query(s).plan)
        assert "mesh degraded" in explain and "7-device" in explain
        snaps.append((H.HEALTH.mesh_snapshot(), pkg.FAULTS.counters()))
        M.restore("test")
        s.placement.prepare()
        assert M.health_snapshot()["shape"] == "8"
    assert snaps[0] == snaps[1]
    assert snaps[0][0]["meshShrinks"] == 1
    assert snaps[0][0]["meshDeviceLost"] == 3


def test_ladder_exhaustion_latches_cpu_only():
    """No shrink budget and one reinit: repeated partial losses latch the
    CPU-only mode, and the query still completes, with the latch's
    reason in explain."""
    from spark_rapids_tpu_torch.runtime.health import HEALTH
    s = TorchSession({**MESH, "spark.rapids.mesh.degrade.maxShrinks": "0",
                      "spark.rapids.service.deviceLoss.maxReinits": "1",
                      "spark.rapids.test.faults":
                          "mesh.gather:device_lost:6:16"}, device="cpu")
    got1 = _agg(s).collect_table()
    assert HEALTH.state() == "HEALTHY"
    got2 = _agg(s).collect_table()
    assert HEALTH.state() == "CPU_ONLY"
    expected = _agg(TorchSession(device="cpu")).collect_table()
    assert tables_differ(_ref(expected), _ref(got2)) is None
    assert sorted(got1.columns[0].data) == sorted(expected.columns[0].data)
    assert "CPU-only mode latched" in s.explain(_agg(s).plan)


def test_typed_errors_and_the_ladder_rungs():
    """device_lost at a mesh.* point is the PARTIAL MeshDeviceLostError
    (a DeviceLostError, never a HostLostError), and the ladder's rungs
    are the reference's: retry, single_device, shrink, then the
    device-loss ladder once the shrink budget is spent."""
    from spark_rapids_tpu.errors import MeshDeviceLostError as JMDL
    tfaults.FAULTS.arm("mesh.gather:device_lost:1:1")
    with pytest.raises(MeshDeviceLostError) as ei:
        tfaults.fault_point("mesh.gather")
    assert isinstance(ei.value, DeviceLostError)
    assert not isinstance(ei.value, HostLostError)
    assert ei.value.device_id is None
    TorchSession(dict(MESH), device="cpu").placement.prepare()
    TpuSession(dict(MESH)).placement.prepare()
    from spark_rapids_tpu.conf import RapidsConf as JConf
    from spark_rapids_tpu_torch.conf import RapidsConf as TConf
    tconf = TConf({**MESH, "spark.rapids.mesh.degrade.maxShrinks": "1"})
    jconf = JConf({**MESH, "spark.rapids.mesh.degrade.maxShrinks": "1"})
    twalk = [thealth.HEALTH.on_mesh_device_loss(
        MeshDeviceLostError("x"), tconf, torch.device("cpu"))
        for _ in range(6)]
    jwalk = [jhealth.HEALTH.on_mesh_device_loss(JMDL("x"), jconf)
             for _ in range(6)]
    assert twalk == jwalk
    assert twalk[:4] == ["retry", "single_device", "shrink", "retry"]
    assert thealth.HEALTH.mesh_snapshot() == jhealth.HEALTH.mesh_snapshot()


def test_the_idle_values_are_written_while_off():
    """With the cluster and the mesh off, the health document's sections
    are the idle values (runtime/health.py IDLE_*), generations aside."""
    from spark_rapids_tpu_torch.parallel.mesh import MESH
    from spark_rapids_tpu_torch.runtime.health import (
        IDLE_HOST_LADDER,
        IDLE_HOSTS,
        IDLE_MESH,
        IDLE_MESH_LADDER,
        consistent_topology_snapshot,
    )
    TorchSession(device="cpu").placement.prepare()
    topo = consistent_topology_snapshot()

    def strip(d):
        return {k: v for k, v in d.items() if k != "generation"}
    assert strip(topo["mesh"]) == strip({**IDLE_MESH, **IDLE_MESH_LADDER})
    assert strip(topo["hosts"]) == strip({**IDLE_HOSTS, **IDLE_HOST_LADDER})
    from spark_rapids_tpu_torch.runtime.cluster import CLUSTER
    assert MESH.shape_str() is None and CLUSTER.topology_str() is None
