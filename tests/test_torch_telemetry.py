"""The port's telemetry ring and flight recorder (``obs/telemetry.py``) on
the CPU, against the JAX package's where both can be run on the same
inputs:

* a sample's keys and its per-scope deltas; the ring's bound, its JSONL
  export and the background sampler (counted through an Event, no sleep);
* the sampler is passive: with every synchronizing torch call and CUDA
  query made to raise, and in a process latched CPU-only, it samples;
* an incident bundle's keys against the reference's bundle of the same
  trigger, ``fault_domain`` on the same kinds, and ``render_incident`` of
  the port's bundles through both renderers, compared as strings;
* one bundle per ladder action (the memory ladder's rungs, a device
  loss), pruning to ``maxBundles``, nothing when disabled;
* ``tools top`` and ``tools incident`` through the CLI over a live
  service and a bundle directory.

Deviation pinned here: ``_kernel_demotions`` gives ``{}`` (the port
demotes no kernel: a hand-written kernel launches or raises), so a
bundle's ``demotions`` hold only the circuit breaker's."""

import json
import threading

import pytest
import torch

from spark_rapids_tpu.obs import telemetry as jtel
from spark_rapids_tpu.tools import incident as jincident
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.errors import DeviceLostError, FatalDeviceOOM
from spark_rapids_tpu_torch.obs import telemetry as ttel
from spark_rapids_tpu_torch.obs.metrics import metric_scope
from spark_rapids_tpu_torch.runtime.health import HEALTH
from spark_rapids_tpu_torch.tools import __main__ as tmain
from spark_rapids_tpu_torch.tools import incident as tincident
from tests.torch_service_util import (
    WAIT_S,
    key_shape,
    per_test_timeout,
    reset_process_state,
)


@pytest.fixture(autouse=True)
def _clean_state():
    reset_process_state()
    ttel.TELEMETRY.stop()
    ttel.TELEMETRY.reset()
    with per_test_timeout():
        yield
    ttel.TELEMETRY.stop()
    ttel.TELEMETRY.reset()
    reset_process_state()


def _conf(tmp_path, **extra):
    conf = {"spark.rapids.obs.flightRecorder.dir": str(tmp_path)}
    conf.update({f"spark.rapids.obs.{k.replace('_', '.')}": str(v)
                 for k, v in extra.items()})
    return conf


# -- the ring -----------------------------------------------------------------

def test_sample_keys_and_deltas():
    scope = metric_scope("health")
    assert ttel.TELEMETRY.sample_once()["deltas"] == {}  # no baseline yet
    scope.add("quarantineStrikes", 3)
    s = ttel.TELEMETRY.sample_once()
    assert s["deltas"]["health"]["quarantineStrikes"] == 3
    assert ttel.TELEMETRY.sample_once()["deltas"].get("health", {}).get(
        "quarantineStrikes") is None
    scope.add("quarantineStrikes", -3)
    ref = jtel.TelemetryRing().sample_once()
    assert set(s) == set(ref)
    assert (s["meshShape"], s["hostTopology"]) == (None, None)
    assert s["health"] == "HEALTHY"
    assert ttel.TELEMETRY.stats()["errors"] == 0


def test_ring_bound_export_and_background_sampler(tmp_path):
    ring = ttel.TelemetryRing()
    ring.configure(RapidsConf({"spark.rapids.obs.telemetry.ringSize": "3"}))
    for _ in range(5):
        ring.sample_once()
    assert len(ring.tail()) == 3 and ring.stats()["samples"] == 5
    assert ring.tail(0) == [] and len(ring.tail(2)) == 2
    path = ring.export_jsonl(str(tmp_path / "t" / "ring.jsonl"))
    assert [json.loads(x)["t"] for x in open(path)] == \
        [s["t"] for s in ring.tail()]
    # the background sampler: eight samples in all, counted by an Event
    got = threading.Event()
    real = ring.sample_once

    def counted():
        out = real()
        if ring.stats()["samples"] >= 8:
            got.set()
        return out

    ring.sample_once = counted
    ring.configure(RapidsConf({
        "spark.rapids.obs.telemetry.enabled": "true",
        "spark.rapids.obs.telemetry.intervalMs": "10",
        "spark.rapids.obs.telemetry.ringSize": "3"}))
    try:
        assert ring.enabled and got.wait(WAIT_S)
    finally:
        ring.stop()
    assert not ring.enabled


def _forbid_device_calls(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the sampler touched the device")
    for name in ("synchronize", "mem_get_info", "memory_reserved",
                 "memory_allocated", "current_stream", "device_count",
                 "get_device_name", "is_available"):
        monkeypatch.setattr(torch.cuda, name, boom)
    monkeypatch.setattr(torch.Tensor, "item", boom)
    monkeypatch.setattr(torch.Tensor, "cpu", boom)
    monkeypatch.setattr(torch.Tensor, "tolist", boom)


def test_sampler_is_passive_even_in_a_latched_process(monkeypatch):
    ttel.TELEMETRY.sample_once()
    HEALTH.on_device_loss(DeviceLostError("injected device loss at "
                                          "device.lost"),
                          RapidsConf({"spark.rapids.service.deviceLoss."
                                      "maxReinits": "1",
                                      "spark.rapids.obs.flightRecorder."
                                      "enabled": "false"}),
                          torch.device("cpu"))
    assert HEALTH.cpu_only_reason() is not None
    _forbid_device_calls(monkeypatch)
    s = ttel.TELEMETRY.sample_once()
    assert s is not None and s["health"] == "CPU_ONLY"
    assert ttel.TELEMETRY.stats()["errors"] == 0


# -- the flight recorder ------------------------------------------------------

#: bundle keys whose own keys are names (scopes, points, templates)
VARIABLE_KEYS = ("scopes", "faultFires", "recovery", "demotions", "deltas",
                 "extra")


def test_bundle_keys_match_the_reference(tmp_path):
    reason = "RetryOOM: injected device OOM at mem.reserve"
    path = ttel.record_incident("memory.ladder", "chunk", reason,
                                conf=RapidsConf(_conf(tmp_path / "p")),
                                error=FatalDeviceOOM(reason))
    from spark_rapids_tpu.conf import RapidsConf as JRapidsConf
    jpath = jtel.record_incident(
        "memory.ladder", "chunk", reason,
        conf=JRapidsConf({"spark.rapids.obs.flightRecorder.dir":
                          str(tmp_path / "r")}),
        error=FatalDeviceOOM(reason))
    got, want = json.load(open(path)), json.load(open(jpath))
    assert key_shape(got, maps=VARIABLE_KEYS) == \
        key_shape(want, maps=VARIABLE_KEYS)
    for k in ("schema", "faultDomain", "kind", "action", "reason",
              "errorType", "faultPoint"):
        assert got[k] == want[k], k
    # the reference's mesh and cluster idle, less their generations
    # (process state that other tests of the worker may have moved)
    for k in ("mesh", "cluster"):
        assert {n: v for n, v in got[k].items() if n != "generation"} == \
            {n: v for n, v in want[k].items() if n != "generation"}, k
    assert got["faultPoint"] == "mem.reserve"
    assert got["health"]["meshLadder"] == want["health"]["meshLadder"]
    assert got["health"]["hostLadder"] == want["health"]["hostLadder"]
    # the pinned deviation: no kernel demotions in the port
    assert ttel._kernel_demotions() == {}


@pytest.mark.parametrize("kind", ["host.ladder", "mesh.ladder",
                                  "memory.ladder", "stream.sink",
                                  "backend.ladder", "quarantine", "other"])
def test_fault_domain_matches_the_reference(kind):
    assert ttel.fault_domain(kind) == jtel.fault_domain(kind)


def test_one_bundle_per_ladder_action_and_the_renderers(tmp_path):
    conf = RapidsConf(_conf(tmp_path))
    exc = FatalDeviceOOM("device OOM persisted after 2 spill-retries")
    exc.__cause__ = RuntimeError("injected device OOM at mem.reserve")
    actions = [HEALTH.on_memory_pressure(exc, conf) for _ in range(3)]
    assert actions == ["retry", "chunk", "abort"]
    HEALTH.on_device_loss(DeviceLostError("injected device loss at "
                                          "device.lost[fused_minmax]"),
                          conf, torch.device("cpu"))
    bundles = tincident.load_bundles(str(tmp_path))
    assert [(b["kind"], b["action"]) for b in bundles] == \
        [("memory.ladder", a) for a in actions] + \
        [("backend.ladder", "DEGRADED")]
    assert [b["faultPoint"] for b in bundles] == \
        ["mem.reserve"] * 3 + ["device.lost"]
    seqs = [b["seq"] for b in bundles]
    assert seqs == sorted(seqs) and len(set(seqs)) == 4
    # the same bundles through both renderers, as strings
    assert tincident.render_incident(bundles) == \
        jincident.render_incident(bundles)
    assert tincident.render_incident(bundles, last=1) == \
        jincident.render_incident(bundles, last=1)


def test_pruning_and_the_disabled_recorder(tmp_path):
    conf = RapidsConf(_conf(tmp_path / "a", flightRecorder_maxBundles=2))
    for i in range(4):
        assert ttel.record_incident("quarantine", "strike", f"r{i}",
                                    conf=conf) is not None
    names = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert len(names) == 2 and names[-1].endswith("-quarantine.json")
    off = RapidsConf(_conf(tmp_path / "b", flightRecorder_enabled="false"))
    assert ttel.record_incident("quarantine", "strike", "r", conf=off) \
        is None
    assert not (tmp_path / "b").exists()


def test_quarantine_strike_records_asynchronously(tmp_path):
    from spark_rapids_tpu_torch.runtime.health import QUARANTINE
    ttel.TELEMETRY.configure(RapidsConf(_conf(tmp_path)))
    assert QUARANTINE.strike("tmpl", "device loss at device.lost", 2) \
        is False
    assert QUARANTINE.strike("tmpl", "device loss at device.lost", 2)
    ttel.flush_incidents()
    bundles = tincident.load_bundles(str(tmp_path))
    assert [(b["kind"], b["action"], b["extra"]["strikes"])
            for b in bundles] == [("quarantine", "strike", 1),
                                  ("quarantine", "quarantined", 2)]
    ttel.TELEMETRY.configure(RapidsConf({}))


# -- the tools over a live service and a bundle directory ---------------------

def test_tools_top_and_incident_through_the_cli(tmp_path, capsys):
    from spark_rapids_tpu_torch import functions as TF
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.service import QueryService
    from tests.torch_service_util import kv_table, port_table
    t = port_table(kv_table(256))
    conf = _conf(tmp_path, telemetry_enabled="true",
                 telemetry_intervalMs=20)
    conf["spark.rapids.service.introspect.enabled"] = "true"
    with QueryService(conf, device="cpu") as svc:
        # the SLO window takes a handle just after it turns FINISHED
        noted = threading.Event()
        real_note = svc._note_finished

        def note(handle):
            real_note(handle)
            noted.set()

        svc._note_finished = note
        h = svc.submit(from_host_table(t, svc.session).group_by("k").agg(
            TF.count("v").alias("c")), tenant="alice")
        assert h.wait(WAIT_S) and h.error is None and noted.wait(WAIT_S)
        assert tmain.main(["top", "--port", str(svc.introspect_port)]) == 0
        out = capsys.readouterr().out
        assert out.startswith("Service: HEALTHY   workers 4")
        assert "tenant default/alice" in out
        assert tmain.main(["top", "--port", str(svc.introspect_port),
                           "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["telemetry"]["sampler"]["enabled"] is True
    ttel.record_incident("quarantine", "strike", "device loss at "
                         "device.lost", conf=RapidsConf(conf))
    assert tmain.main(["incident", str(tmp_path), "--last", "1"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("Incident bundles: 1")
    assert "faultPoint=device.lost" in out
