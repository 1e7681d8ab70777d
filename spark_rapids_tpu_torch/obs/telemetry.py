"""Continuous telemetry ring and the flight recorder (port of
``spark_rapids_tpu/obs/telemetry.py``).

The per-query surface (event log, spans, metrics) cannot see the live
state between queries: when the device is lost or the memory ladder
walks a rung mid-serve, the reason is scattered across process-wide
counters nobody sampled at the time. This module is the between-queries
half of observability:

* :class:`TelemetryRing` / the process-wide :data:`TELEMETRY`: a PASSIVE
  background sampler. Every ``spark.rapids.obs.telemetry.intervalMs`` it
  records one bounded sample (the per-scope DELTAS of every metric scope,
  the health state, the fault fires and the memory arbiter's occupancy)
  into a bounded ring, exportable as JSONL. Sampling never perturbs
  execution: it reads only snapshot surfaces that bound their own lock
  hold to a dict copy, and makes no device call at all (no ``.item()``,
  ``.cpu()``, ``torch.cuda.synchronize()`` or ``mem_get_info``), so a
  process latched CPU-only makes no CUDA call through it either.
* **Flight recorder** (:func:`record_incident`): every degradation-ladder
  action (``backend.ladder``, ``memory.ladder``) and every quarantine
  strike dumps one bounded INCIDENT BUNDLE (JSON) to
  ``spark.rapids.obs.flightRecorder.dir``: the trigger (kind, action,
  error, the fault point parsed from an injected error), the ladder and
  fault-point state, health, the telemetry tail, recent event-record
  summaries and the live query table of every registered QueryService.
  ``python -m spark_rapids_tpu_torch.tools incident`` renders them.
  Bundles are pruned to ``flightRecorder.maxBundles``, and recording is
  best-effort: an unwritable directory never masks the recovery it
  documents.

As the reference writes them with the mesh and the cluster off (ROADMAP
item 11): ``meshShape`` and ``hostTopology`` are null, and the bundle's
``mesh``, ``cluster`` and ladder sections hold their idle values. The
port has no kernel demotion (a hand-written kernel fails, never gives way
to another route), so the bundle's ``demotions`` hold only the circuit
breaker's (``_kernel_demotions`` gives ``{}``).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional

from spark_rapids_tpu_torch.conf import (  # noqa: F401 (re-exports)
    FLIGHT_RECORDER_DIR,
    FLIGHT_RECORDER_ENABLED,
    FLIGHT_RECORDER_MAX_BUNDLES,
    FLIGHT_RECORDER_TELEMETRY_TAIL,
    TELEMETRY_ENABLED,
    TELEMETRY_INTERVAL_MS,
    TELEMETRY_RING_SIZE,
    RapidsConf,
)
from spark_rapids_tpu_torch.lockorder import ordered_lock
from spark_rapids_tpu_torch.obs.metrics import scopes_snapshot


def _scope_delta(before: Optional[Dict[str, dict]],
                 after: Dict[str, dict]) -> Dict[str, dict]:
    """Per-scope numeric deltas between two scopes_snapshot() calls (the
    event log's ``scope_delta``), with no movement before a baseline."""
    if before is None:
        return {}
    from spark_rapids_tpu_torch.obs.events import scope_delta
    return scope_delta(before, after)


class TelemetryRing:
    """The process-wide passive sampler. ``configure(conf)`` is cheap when
    nothing changed; the session and the query service both call it, so
    whichever comes first starts the sampler, and the flight recorder
    takes the same conf's settings for trigger sites without a conf."""

    def __init__(self):
        self._lock = ordered_lock("obs.telemetry.ring")
        self._cfg = None
        self._interval_s = 0.5
        self._ring: deque = deque(maxlen=720)
        self._prev_scopes: Optional[Dict[str, dict]] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._samples = 0
        self._errors = 0

    # -- configuration --------------------------------------------------------
    def configure(self, conf: RapidsConf) -> None:
        enabled = bool(conf.get_entry(TELEMETRY_ENABLED))
        interval = int(conf.get_entry(TELEMETRY_INTERVAL_MS))
        size = max(1, int(conf.get_entry(TELEMETRY_RING_SIZE)))
        _configure_flight_recorder(conf)
        key = (enabled, interval, size)
        start = stop = False
        with self._lock:
            if key == self._cfg:
                return
            self._cfg = key
            self._interval_s = max(0.01, interval / 1000.0)
            if size != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=size)
            # a thread told to stop may linger in its last wait: a
            # disable-then-enable must start a fresh one (each loop holds
            # its own stop event)
            alive = (self._thread is not None and self._thread.is_alive()
                     and not self._stop.is_set())
            if enabled and not alive:
                self._stop = threading.Event()
                self._thread = threading.Thread(
                    target=self._loop, args=(self._stop,),
                    name="rapids-telemetry-sampler", daemon=True)
                start = True
            elif not enabled and alive:
                stop = True
        if start:
            self._thread.start()
        if stop:
            self._stop.set()

    @property
    def enabled(self) -> bool:
        with self._lock:
            return bool(self._cfg and self._cfg[0])

    def stop(self) -> None:
        """Stop the sampler thread and forget the conf (the next
        ``configure`` starts afresh)."""
        with self._lock:
            self._cfg = None
            self._stop.set()
            thread = self._thread
        if thread is not None:
            thread.join(timeout=5)

    # -- sampling -------------------------------------------------------------
    def _loop(self, stop: threading.Event) -> None:
        while True:
            with self._lock:
                interval = self._interval_s
            if stop.wait(interval):
                return
            self.sample_once()

    def sample_once(self) -> Optional[dict]:
        """One sample: per-scope deltas since the previous sample plus
        the health view. Every read is a bounded host-side snapshot; no
        device call, no query-path lock."""
        try:
            from spark_rapids_tpu_torch.runtime.faults import FAULTS
            from spark_rapids_tpu_torch.runtime.health import HEALTH
            from spark_rapids_tpu_torch.runtime.memory import MEMORY
            snap = scopes_snapshot()
            mem = MEMORY.snapshot()
            sample = {
                "t": round(time.time(), 3),
                "deltas": _scope_delta(self._prev_scopes, snap),
                "health": HEALTH.state(),
                "meshShape": None,
                "hostTopology": None,
                "faultFires": sum(FAULTS.counters().values()),
                "memOccupancy": mem["occupancyBytes"],
                "memBudget": mem["budgetBytes"],
            }
            with self._lock:
                self._prev_scopes = snap
                self._ring.append(sample)
                self._samples += 1
            return sample
        except Exception:
            with self._lock:
                self._errors += 1
            return None

    # -- reads ----------------------------------------------------------------
    def tail(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            samples = list(self._ring)
        if n is None:
            return samples
        n = int(n)
        return samples[-n:] if n > 0 else []  # [-0:] would be ALL

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": bool(self._cfg and self._cfg[0]),
                "intervalMs": int(self._interval_s * 1000),
                "ringSize": self._ring.maxlen,
                "samples": self._samples,
                "buffered": len(self._ring),
                "errors": self._errors,
            }

    def export_jsonl(self, path: str) -> str:
        """Dump the current ring, one sample per line."""
        samples = self.tail()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            for s in samples:
                f.write(json.dumps(s, sort_keys=True) + "\n")
        return path

    def reset(self) -> None:
        """Test support: drop buffered samples and the delta baseline."""
        with self._lock:
            self._ring.clear()
            self._prev_scopes = None
            self._samples = 0
            self._errors = 0


TELEMETRY = TelemetryRing()


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

#: registered QueryServices (weak: a shut-down service drops out); the
#: recorder snapshots their live query tables
_SERVICES: "weakref.WeakSet" = weakref.WeakSet()
_SERVICES_LOCK = ordered_lock("obs.telemetry.services")


def register_service(service) -> None:
    """Called by QueryService.__init__ so that incident bundles embed the
    live query table of every service of the process."""
    with _SERVICES_LOCK:
        _SERVICES.add(service)


#: process defaults for trigger sites without a conf (quarantine strikes),
#: refreshed by TELEMETRY.configure
_FR_LOCK = ordered_lock("obs.flightrec")
_FR_STATE = {
    "enabled": bool(FLIGHT_RECORDER_ENABLED.default),
    "dir": str(FLIGHT_RECORDER_DIR.default),
    "max_bundles": int(FLIGHT_RECORDER_MAX_BUNDLES.default),
    "tail": int(FLIGHT_RECORDER_TELEMETRY_TAIL.default),
}
_FR_SEQ = [0]

#: the fault-point pattern injected errors carry ("injected device loss at
#: device.lost[onehot_partials]"), parsed into the bundle's fault point
_FAULT_POINT_RE = re.compile(r"\bat ([a-z][a-z0-9_]*(?:\.[a-z0-9_]+)+)")

#: bundle-kind prefix -> fault domain; everything else is the service
#: plane's (the backend ladder, the quarantine)
_FAULT_DOMAIN_PREFIXES = (
    ("host.", "host"),
    ("mesh.", "mesh"),
    ("memory.", "memory"),
    ("stream.", "stream"),
)


def fault_domain(kind: str) -> str:
    kind = str(kind)
    for prefix, domain in _FAULT_DOMAIN_PREFIXES:
        if kind.startswith(prefix):
            return domain
    return "service"


def _configure_flight_recorder(conf: RapidsConf) -> None:
    with _FR_LOCK:
        _FR_STATE.update(_settings_of(conf))


def _settings_of(conf: RapidsConf) -> dict:
    return {
        "enabled": bool(conf.get_entry(FLIGHT_RECORDER_ENABLED)),
        "dir": str(conf.get_entry(FLIGHT_RECORDER_DIR)),
        "max_bundles": int(conf.get_entry(FLIGHT_RECORDER_MAX_BUNDLES)),
        "tail": int(conf.get_entry(FLIGHT_RECORDER_TELEMETRY_TAIL)),
    }


def _recorder_settings(conf: Optional[RapidsConf]) -> dict:
    if conf is not None:
        try:
            return _settings_of(conf)
        except Exception:
            pass
    with _FR_LOCK:
        return dict(_FR_STATE)


def _active_query_tables() -> List[dict]:
    """Live query tables of every registered service. NON-BLOCKING: a
    quarantine strike is recorded while the scheduler's condition lock
    may be held, so a busy service reports its table unavailable."""
    out: List[dict] = []
    with _SERVICES_LOCK:
        services = list(_SERVICES)
    for svc in services:
        try:
            table = svc.query_table(blocking=False)
        except Exception:
            table = None
        out.append({"pools": sorted(getattr(svc, "pools", {})),
                    "queries": table,
                    "available": table is not None})
    return out


def _prune_bundles(directory: str, max_bundles: int) -> None:
    names = sorted(n for n in os.listdir(directory)
                   if n.startswith("incident-") and n.endswith(".json"))
    for n in names[:max(0, len(names) - max_bundles)]:
        try:
            os.unlink(os.path.join(directory, n))
        except OSError:
            pass


def build_bundle(kind: str, action: str, reason: str, seq: int,
                 tail: int, error: Optional[BaseException] = None,
                 extra: Optional[dict] = None) -> dict:
    """One incident bundle's document (the reference's schema 2)."""
    from spark_rapids_tpu_torch.runtime.faults import (
        CIRCUIT_BREAKER,
        FAULTS,
        RECOVERY,
    )
    from spark_rapids_tpu_torch.runtime.health import (
        HEALTH,
        IDLE_HOST_LADDER,
        IDLE_HOSTS,
        IDLE_MESH,
        IDLE_MESH_LADDER,
        QUARANTINE,
    )
    reason = str(reason)
    m = _FAULT_POINT_RE.search(reason)
    snap = HEALTH.snapshot()
    bundle = {
        "schema": 2,
        "seq": seq,
        "faultDomain": fault_domain(kind),
        "kind": str(kind),
        "action": str(action),
        "reason": reason[:2000],
        "errorType": type(error).__name__ if error is not None else None,
        "faultPoint": m.group(1) if m else None,
        "wallClock": round(time.time(), 3),
        "pid": os.getpid(),
        "health": {
            "state": HEALTH.state(),
            "cpuOnlyReason": HEALTH.cpu_only_reason(),
            "backend": {k: snap[k] for k in (
                "deviceLost", "deviceReinits", "consecutiveLosses")},
            "meshLadder": dict(IDLE_MESH_LADDER),
            "hostLadder": dict(IDLE_HOST_LADDER),
            "memoryLadder": {k: snap[k] for k in (
                "memoryPressureEvents", "memoryConsecutive",
                "memoryChunkedReexecutions", "memoryCpuDemotions")},
        },
        "mesh": dict(IDLE_MESH),
        "cluster": dict(IDLE_HOSTS),
        "memory": _memory_snapshot(),
        "quarantine": QUARANTINE.snapshot(),
        "demotions": {**CIRCUIT_BREAKER.demoted_ops(),
                      **_kernel_demotions()},
        "recovery": RECOVERY.snapshot(),
        "faultFires": FAULTS.counters(),
        "scopes": scopes_snapshot(),
        "telemetry": {
            "sampler": TELEMETRY.stats(),
            "tail": TELEMETRY.tail(tail),
        },
        "recentEvents": _recent_event_summaries(),
        "activeQueries": _active_query_tables(),
    }
    if extra:
        bundle["extra"] = extra
    return bundle


def record_incident(kind: str, action: str, reason: str,
                    conf: Optional[RapidsConf] = None,
                    error: Optional[BaseException] = None,
                    extra: Optional[dict] = None) -> Optional[str]:
    """Dump one incident bundle; returns its path (None when disabled or
    the dump failed: recording never raises into a recovery path).
    Callers must not hold the health or quarantine locks (the bundle
    re-reads their snapshots)."""
    try:
        settings = _recorder_settings(conf)
        if not settings["enabled"]:
            return None
        # the sequence id is allocated before the bundle is built and
        # embedded in it: a reader can match bundles to ladder actions
        # one for one even when wall clocks collide
        with _FR_LOCK:
            _FR_SEQ[0] += 1
            seq = _FR_SEQ[0]
        bundle = build_bundle(kind, action, reason, seq, settings["tail"],
                              error=error, extra=extra)
        directory = settings["dir"]
        os.makedirs(directory, exist_ok=True)
        safe_kind = re.sub(r"[^A-Za-z0-9._-]", "_", str(kind))
        path = os.path.join(
            directory,
            f"incident-{int(time.time() * 1000):013d}-{seq:06d}-"
            f"{safe_kind}.json")
        with open(path, "w") as f:
            json.dump(bundle, f, sort_keys=True, default=str)
        _prune_bundles(directory, settings["max_bundles"])
        return path
    except Exception:
        return None  # the black box never takes the plane down


#: threads of record_incident_async still writing (joined by
#: ``flush_incidents``)
_PENDING: "weakref.WeakSet" = weakref.WeakSet()


def record_incident_async(kind: str, action: str, reason: str,
                          conf: Optional[RapidsConf] = None,
                          error: Optional[BaseException] = None,
                          extra: Optional[dict] = None) -> None:
    """Fire-and-forget :func:`record_incident` on a short-lived daemon
    thread, for trigger sites under a hot lock (the quarantine strike
    records while the scheduler's condition lock is held)."""
    try:
        t = threading.Thread(
            target=record_incident,
            args=(kind, action, reason),
            kwargs={"conf": conf, "error": error, "extra": extra},
            name="rapids-flightrec-dump", daemon=True)
        with _FR_LOCK:
            _PENDING.add(t)
        t.start()
    except Exception:
        pass  # a failed thread spawn must not mask the strike


def flush_incidents(timeout_s: float = 10.0) -> None:
    """Wait for the asynchronous bundle writes started so far."""
    with _FR_LOCK:
        threads = list(_PENDING)
    for t in threads:
        if t.ident is not None:
            t.join(timeout_s)


def _recent_event_summaries() -> List[dict]:
    from spark_rapids_tpu_torch.obs.events import recent_records
    return recent_records()


def _kernel_demotions() -> Dict[str, str]:
    """The reference's Pallas kernel demotions. The port demotes no
    kernel: a hand-written kernel launches or raises."""
    return {}


def _memory_snapshot() -> dict:
    from spark_rapids_tpu_torch.runtime.memory import MEMORY
    return MEMORY.snapshot()
