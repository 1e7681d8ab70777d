"""Device health monitor: device-loss recovery and the memory degradation
ladder (port of the parts of ``spark_rapids_tpu/runtime/health.py`` that a
single card needs).

* **Device loss.** A fatal device error (``crash_handler.
  is_fatal_device_error``, classified apart from the per-operator
  KernelCrashError the circuit breaker owns) is counted, the device caches
  and the cached broadcast batches are dropped, and the context is probed
  with a tiny op and ``torch.cuda.synchronize()``. When the probe passes
  (a transient or injected loss) the monitor counts a re-initialisation
  and the next query runs on the card. When it fails, or after
  ``spark.rapids.service.deviceLoss.maxReinits`` consecutive losses, the
  process latches CPU-only mode, as the reference's does: the failing
  query raises DeviceLostError, and every later query runs wholly on the
  CPU route (``PlanMeta.tag`` gives every node :meth:`cpu_only_reason`).
  CUDA cannot re-create a context in the process after a sticky error,
  so a latched process makes no CUDA call (the session's CPU-only path,
  session.py).
* **Memory ladder.** A FatalDeviceOOM that escaped the retry framework
  walks one rung per escalation: ``retry`` (evict the device caches, spill
  the whole device tier, replay at the same shape), then ``chunk`` (replay
  with the scans chunked at half the scan chunk share), then
  ``cpu_demote``: the attributed operator (``fault_op``) trips the
  circuit breaker at threshold 1 and the replay plans it onto the CPU
  route. Without an attributed operator the rung is ``abort``: the
  session re-raises the FatalDeviceOOM. Any completed query resets the
  ladder.

* **Poison-query quarantine** (:class:`QuarantineRegistry`): a query
  template (``plan/fingerprint.py::template_fingerprint``) that keeps
  killing the device or forcing the memory ladder past its plain retry
  collects strikes (the session strikes on the ``chunk``, ``cpu_demote``
  and ``abort`` rungs, the query service on a worker's death or a device
  loss under it); at ``spark.rapids.service.quarantine.
  maxStrikes`` it is quarantined, and ``explain`` names it a poison
  suspect. The service scheduler refuses a quarantined template at
  admission (service/scheduler.py), and the worker and device kills it
  sees strike too.

* **Flight recorder.** Every ladder action (``backend.ladder`` for a
  device loss, ``memory.ladder`` for a memory rung) dumps one incident
  bundle (obs/telemetry.py ``record_incident``) after the monitor's lock
  is released; every quarantine strike dumps one on a short-lived thread
  (``record_incident_async``: the scheduler strikes under its condition
  lock). Recording is best-effort: it never masks the recovery.

* **Mesh ladder** (``on_mesh_device_loss``, a MeshDeviceLostError: one
  logical device of the mesh lost, the process's device alive): ``retry``
  on the unchanged mesh, then ``single_device`` (the replay lands with the
  mesh suppressed, parallel/mesh.py ``suppressed_mesh``), then ``shrink``
  (the mesh excludes the logical id, ``spark.rapids.mesh.degrade.
  maxShrinks`` times), then the device-loss ladder above. Bundles:
  ``mesh.ladder``.
* **Host ladder** (``on_host_loss``, a HostLostError: a cluster executor
  process lost): ``retry``, then ``reland`` (the host is marked lost and
  the replay's scans re-land its files on the survivors), then ``shrink``
  (the host leaves the topology, ``spark.rapids.cluster.maxHostLosses``
  times), then ``single_process`` (every scan local until a host
  rejoins), then the device-loss ladder. Bundles: ``host.ladder``.

Counters live in the ``health`` metric scope under the reference's names:
``deviceLost``, ``deviceReinits``, ``memoryPressure``,
``memoryChunkedReexecutions``, ``memoryCpuDemotions``, ``meshDeviceLost``,
``meshDegradations``, ``meshShrinks``, ``quarantineStrikes`` and
``quarantinedTemplates``."""

from __future__ import annotations

from typing import Dict, List, Optional

from spark_rapids_tpu_torch.conf import (  # noqa: F401 (re-export)
    DEVICE_LOSS_MAX_REINITS,
    QUARANTINE_MAX_STRIKES,
)
from spark_rapids_tpu_torch.errors import FatalDeviceOOM
from spark_rapids_tpu_torch.lockorder import ordered_lock
from spark_rapids_tpu_torch.obs.metrics import metric_scope, register_metric

register_metric("deviceLost", "count", "ESSENTIAL",
                "fatal device errors observed (each drops the device "
                "caches and probes the context, or latches the process)")
register_metric("deviceReinits", "count", "ESSENTIAL",
                "device losses after which the context probe passed and "
                "the next query ran on the card")
register_metric("memoryPressure", "count", "ESSENTIAL",
                "FatalDeviceOOM escalations the memory degradation ladder "
                "handled (each walks one rung: full-spill retry, chunked "
                "re-execution, abort)")
register_metric("memoryChunkedReexecutions", "count", "ESSENTIAL",
                "query replays forced onto chunked scans by the memory "
                "ladder's 'chunk' rung")
register_metric("memoryCpuDemotions", "count", "ESSENTIAL",
                "operators the memory ladder's 'cpu_demote' rung moved onto "
                "the CPU route through the circuit breaker")
register_metric("meshDeviceLost", "count", "ESSENTIAL",
                "partial device losses observed (one logical device of the "
                "mesh lost, the process's device alive; the mesh ladder)")
register_metric("meshDegradations", "count", "ESSENTIAL",
                "times the mesh ladder demoted mesh execution (a "
                "single-device replay or a shrink)")
register_metric("meshShrinks", "count", "ESSENTIAL",
                "mesh reconfigurations onto the surviving logical devices "
                "(bounded by spark.rapids.mesh.degrade.maxShrinks)")
register_metric("quarantineStrikes", "count", "MODERATE",
                "poison-query strikes recorded against query templates")
register_metric("quarantinedTemplates", "count", "ESSENTIAL",
                "query templates currently quarantined")


def _first_line(exc: BaseException) -> str:
    return str(exc).splitlines()[0] if str(exc) else type(exc).__name__


def _record_ladder_incident(kind: str, action: str, exc: BaseException,
                            conf) -> None:
    """The flight recorder's hook of every ladder action, called after
    the monitor's lock is released (the bundle re-reads the health
    snapshot); best-effort."""
    try:
        from spark_rapids_tpu_torch.obs.telemetry import record_incident
        reason = f"{type(exc).__name__}: {_first_line(exc)}"
        cause = exc.__cause__
        if cause is not None and str(cause):
            # a wrapped escalation (a FatalDeviceOOM from a RetryOOM)
            # names the injected fault point only in its cause
            reason += f" (cause: {_first_line(cause)})"
        record_incident(kind, action, reason, conf=conf, error=exc)
    except Exception:
        pass


def _probe_context(device) -> Optional[str]:
    """None when a tiny op on ``device`` completes, else why not."""
    import torch
    try:
        x = torch.ones(8, device=device)
        x.add_(1)
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        return None
    except Exception as e:  # a poisoned context raises here
        return f"{type(e).__name__}: {_first_line(e)}"


def evict_device_state() -> None:
    """Drop every cache that holds device memory: the scan's device images,
    the cached broadcast batches and the mesh's interned dictionaries."""
    from spark_rapids_tpu_torch.columnar.table import evict_device_caches
    from spark_rapids_tpu_torch.execs.broadcast import evict_broadcast_caches
    from spark_rapids_tpu_torch.parallel.exchange import clear_mesh_caches
    for fn in (evict_device_caches, evict_broadcast_caches,
               clear_mesh_caches):
        try:
            fn()
        except Exception:
            pass  # recovery never raises


class DeviceHealthMonitor:
    """Process-wide device health state (the card is shared by every
    session of the process, like the circuit breaker)."""

    def __init__(self):
        self._lock = ordered_lock("health.monitor")
        self._metrics = metric_scope("health")
        self.reset()

    # -- the latch ------------------------------------------------------------
    def cpu_only_reason(self) -> Optional[str]:
        """The latch's reason once the process latched CPU-only mode (every
        operator's tag then), else None."""
        return self._cpu_only_reason

    def state(self) -> str:
        """HEALTHY, DEGRADED or CPU_ONLY from the device's view alone (the
        query service folds its own worker losses in)."""
        if self._cpu_only_reason is not None:
            return "CPU_ONLY"
        if self._consecutive_losses > 0:
            return "DEGRADED"
        return "HEALTHY"

    # -- device loss ----------------------------------------------------------
    def on_device_loss(self, exc: BaseException, conf, device,
                       report: Optional[str] = None) -> str:
        """One fatal device error: count it, drop the device caches, probe
        the context. Returns ``"DEGRADED"`` (the next query runs on the
        card) or ``"CPU_ONLY"`` (the process latched). Records a
        ``backend.ladder`` incident bundle."""
        state = self._on_device_loss_inner(exc, conf, device, report)
        _record_ladder_incident("backend.ladder", state, exc, conf)
        return state

    def _on_device_loss_inner(self, exc, conf, device, report) -> str:
        max_reinits = int(conf.get_entry(DEVICE_LOSS_MAX_REINITS))
        with self._lock:
            self._losses += 1
            self._consecutive_losses += 1
            n = self._consecutive_losses
            self._metrics.add("deviceLost", 1)
            if self._cpu_only_reason is not None:
                return "CPU_ONLY"
        evict_device_state()
        # every cached converted tree may hold the lost context's state
        from spark_rapids_tpu_torch.plan.executable_cache import EXEC_CACHE
        EXEC_CACHE.invalidate_all()
        probe = _probe_context(device)
        with self._lock:
            if probe is None and n < max_reinits:
                self._reinits += 1
                self._metrics.add("deviceReinits", 1)
                return "DEGRADED"
            why = (f"the context probe failed ({probe})" if probe
                   else f"{n} consecutive device losses "
                        f"(spark.rapids.service.deviceLoss.maxReinits="
                        f"{max_reinits})")
            self._cpu_only_reason = (
                f"device health: CPU-only mode latched after {why} (last: "
                f"{type(exc).__name__}: {_first_line(exc)}; crash report "
                f"{report or 'not written'})")
            return "CPU_ONLY"

    def note_success(self, mesh_native: bool = False,
                     cluster_native: bool = False) -> None:
        """A query completed: the consecutive-loss budget and the memory
        ladder refill; the mesh ladder only on a mesh-NATIVE success and
        the host ladder only on a cluster-native one (a suppressed replay
        proves nothing about the mesh or the hosts)."""
        if (self._consecutive_losses or self._mem_consecutive
                or (mesh_native and self._mesh_consecutive)
                or (cluster_native and self._host_consecutive)):
            with self._lock:
                self._consecutive_losses = 0
                self._mem_consecutive = 0
                if mesh_native:
                    self._mesh_consecutive = 0
                if cluster_native:
                    self._host_consecutive = 0

    # -- the mesh ladder ------------------------------------------------------
    def on_mesh_device_loss(self, exc: BaseException, conf,
                            device=None) -> str:
        """One partial device loss (a ``mesh.*`` point's device_lost):
        ``retry``, ``single_device``, ``shrink`` (at most ``spark.rapids.
        mesh.degrade.maxShrinks`` times), then the device-loss ladder's
        ``DEGRADED`` or ``CPU_ONLY``. Records a ``mesh.ladder`` bundle."""
        action = self._on_mesh_device_loss_inner(exc, conf, device)
        _record_ladder_incident("mesh.ladder", action, exc, conf)
        return action

    def _on_mesh_device_loss_inner(self, exc, conf, device) -> str:
        from spark_rapids_tpu_torch.conf import MESH_DEGRADE_MAX_SHRINKS
        from spark_rapids_tpu_torch.parallel.mesh import MESH
        max_shrinks = int(conf.get_entry(MESH_DEGRADE_MAX_SHRINKS))
        with self._lock:
            if self._cpu_only_reason is not None:
                return "CPU_ONLY"
            self._mesh_losses += 1
            self._mesh_consecutive += 1
            n = self._mesh_consecutive
            self._metrics.add("meshDeviceLost", 1)
            if n == 1:
                return "retry"
            if n == 2:
                self._mesh_degradations += 1
                self._metrics.add("meshDegradations", 1)
                return "single_device"
            # reserve the shrink slot under the lock: two workers must not
            # both pass the budget check
            budget = self._mesh_shrinks < max(0, max_shrinks)
            if budget:
                self._mesh_shrinks += 1
        shrunk = False
        if budget:
            reason = (f"mesh degraded after {n} consecutive mesh-device "
                      f"losses (last: {type(exc).__name__}: "
                      f"{_first_line(exc)})")
            shrunk = MESH.shrink_excluding(getattr(exc, "device_id", None),
                                           reason)
            if not shrunk:
                with self._lock:
                    self._mesh_shrinks -= 1  # nothing to shrink
        if shrunk:
            with self._lock:
                self._mesh_degradations += 1
                # a fresh ladder for the smaller mesh
                self._mesh_consecutive = 0
                self._metrics.add("meshShrinks", 1)
                self._metrics.add("meshDegradations", 1)
            return "shrink"
        return self.on_device_loss(exc, conf, device)

    def mesh_demotion_note(self) -> str:
        """The reason a single-device replay carries (explain, the
        exchange's demotion)."""
        with self._lock:
            return (f"mesh degraded to single-device landing after "
                    f"{self._mesh_consecutive} consecutive mesh-device "
                    f"losses")

    def mesh_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return self._mesh_snapshot_locked()

    def _mesh_snapshot_locked(self) -> Dict[str, int]:
        return {"meshDeviceLost": self._mesh_losses,
                "meshConsecutiveLosses": self._mesh_consecutive,
                "meshShrinks": self._mesh_shrinks,
                "meshDegradations": self._mesh_degradations}

    # -- the host ladder ------------------------------------------------------
    def on_host_loss(self, exc: BaseException, conf, device=None) -> str:
        """One host loss (a ``host.*`` point's device_lost, a dead
        dispatch socket, the sweep's verdict): ``retry``, ``reland``,
        ``shrink`` (at most ``spark.rapids.cluster.maxHostLosses``
        times), ``single_process``, then the device-loss ladder. Records
        a ``host.ladder`` bundle."""
        action = self._on_host_loss_inner(exc, conf, device)
        _record_ladder_incident("host.ladder", action, exc, conf)
        return action

    def _on_host_loss_inner(self, exc, conf, device) -> str:
        from spark_rapids_tpu_torch.conf import CLUSTER_MAX_HOST_LOSSES
        from spark_rapids_tpu_torch.runtime.cluster import CLUSTER
        max_losses = int(conf.get_entry(CLUSTER_MAX_HOST_LOSSES))
        host_id = getattr(exc, "host_id", None)
        already_latched = (
            CLUSTER.health_snapshot()["singleProcessReason"] is not None)
        budget = False
        with self._lock:
            if self._cpu_only_reason is not None:
                return "CPU_ONLY"
            self._host_losses += 1
            self._host_consecutive += 1
            n = self._host_consecutive
            if not already_latched and n >= 3:
                budget = self._host_shrinks < max(0, max_losses)
                if budget:
                    self._host_shrinks += 1
        if already_latched:
            # hosts keep being lost with the cluster out of the picture:
            # the device-loss ladder owns it
            return self.on_device_loss(exc, conf, device)
        reason = (f"cluster degraded after {n} consecutive host losses "
                  f"(last: {type(exc).__name__}: {_first_line(exc)})")
        if n == 1:
            return "retry"
        if n == 2:
            CLUSTER.mark_host_lost(host_id, reason, reland=True)
            return "reland"
        if budget:
            if CLUSTER.shrink_excluding(host_id, reason):
                with self._lock:
                    self._host_consecutive = 0  # a fresh ladder
                return "shrink"
            with self._lock:
                self._host_shrinks -= 1  # nothing to shrink
        CLUSTER.latch_single_process(
            f"cluster latched single-process after {n} consecutive "
            f"host losses (last: {type(exc).__name__}: {_first_line(exc)})")
        return "single_process"

    def host_demotion_note(self) -> str:
        with self._lock:
            return (f"cluster degraded after {self._host_consecutive} "
                    f"consecutive host losses")

    def host_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return self._host_snapshot_locked()

    def _host_snapshot_locked(self) -> Dict[str, int]:
        return {"hostsLost": self._host_losses,
                "hostConsecutiveLosses": self._host_consecutive,
                "hostShrinks": self._host_shrinks}

    # -- the memory ladder ----------------------------------------------------
    def on_memory_pressure(self, exc: BaseException, conf) -> str:
        """One FatalDeviceOOM that escaped the retry framework: the rung
        the session takes (``retry``, ``chunk``, then ``cpu_demote`` for
        an error that carries ``fault_op``, else ``abort``). Records a
        ``memory.ladder`` incident bundle."""
        action = self._on_memory_pressure_inner(exc)
        _record_ladder_incident("memory.ladder", action, exc, conf)
        return action

    def _on_memory_pressure_inner(self, exc: BaseException) -> str:
        from spark_rapids_tpu_torch.columnar.table import evict_device_caches
        with self._lock:
            self._mem_events += 1
            self._mem_consecutive += 1
            n = self._mem_consecutive
            self._metrics.add("memoryPressure", 1)
        if n == 1:
            # the most room before the same-shape replay
            try:
                from spark_rapids_tpu_torch.runtime.spill import BufferCatalog
                evict_device_caches()
                BufferCatalog.get().spill_all_device()
            except Exception:
                pass  # recovery never raises
            return "retry"
        if n == 2:
            with self._lock:
                self._mem_chunked += 1
                self._metrics.add("memoryChunkedReexecutions", 1)
            try:
                # a cached unchunked image would serve the replay the very
                # batch that did not fit
                evict_device_caches()
            except Exception:
                pass
            return "chunk"
        op = getattr(exc, "fault_op", None)
        if op is None:
            return "abort"
        from spark_rapids_tpu_torch.runtime.faults import CIRCUIT_BREAKER
        # one recorded failure at threshold 1 trips the breaker: the
        # replay's tag moves the operator onto the CPU route
        CIRCUIT_BREAKER.record_failure(op, exc, max_failures=1)
        with self._lock:
            self._mem_cpu_demotions += 1
            self._metrics.add("memoryCpuDemotions", 1)
        return "cpu_demote"

    @staticmethod
    def abort_error(exc: BaseException) -> FatalDeviceOOM:
        """The ``abort`` rung's FatalDeviceOOM: ``exc``'s message and
        ``fault_op``, after the ladder's rungs."""
        op = getattr(exc, "fault_op", None)
        err = FatalDeviceOOM(
            f"{exc}; memory ladder exhausted (retry, chunk) and no "
            "operator to demote onto the CPU route")
        err.fault_op = op
        return err

    # -- introspection --------------------------------------------------------
    def generation(self) -> int:
        """Device losses seen: a tree converted under an older generation
        never returns to the executable cache."""
        return self._losses

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "deviceLost": self._losses,
                "deviceReinits": self._reinits,
                "consecutiveLosses": self._consecutive_losses,
                "latched": self._cpu_only_reason is not None,
                "cpuOnlyReason": self._cpu_only_reason,
                "memoryPressureEvents": self._mem_events,
                "memoryConsecutive": self._mem_consecutive,
                "memoryChunkedReexecutions": self._mem_chunked,
                "memoryCpuDemotions": self._mem_cpu_demotions,
            }

    def reset(self) -> None:
        with self._lock:
            self._losses = 0
            self._reinits = 0
            self._consecutive_losses = 0
            self._cpu_only_reason: Optional[str] = None
            self._mem_events = 0
            self._mem_consecutive = 0
            self._mem_chunked = 0
            self._mem_cpu_demotions = 0
            self._mesh_consecutive = 0
            self._mesh_losses = 0
            self._mesh_shrinks = 0
            self._mesh_degradations = 0
            self._host_consecutive = 0
            self._host_losses = 0
            self._host_shrinks = 0


HEALTH = DeviceHealthMonitor()


class QuarantineRegistry:
    """Strike ledger per query TEMPLATE (literal-stripped structural
    fingerprint): a template that repeatedly kills the device, or drives
    the memory ladder past its plain retry, is the prime poison suspect
    whatever its literals. A plan too dynamic to fingerprint cannot be
    quarantined (its runs are independent: it hits no cache either)."""

    def __init__(self):
        self._lock = ordered_lock("health.quarantine")
        self._metrics = metric_scope("health")
        #: template_fp -> ordered strike reasons
        self._strikes: Dict[str, List[str]] = {}
        self._quarantined: Dict[str, List[str]] = {}

    def strike(self, template_fp: Optional[str], reason: str,
               max_strikes: int) -> bool:
        """Record one kill against ``template_fp``; True when this strike
        quarantined the template."""
        if template_fp is None:
            return False
        with self._lock:
            history = self._strikes.setdefault(template_fp, [])
            history.append(reason)
            strikes = len(history)
            self._metrics.add("quarantineStrikes", 1)
            quarantined = (template_fp not in self._quarantined
                           and strikes >= max(1, int(max_strikes)))
            if quarantined:
                self._quarantined[template_fp] = list(history)
                self._metrics.add("quarantinedTemplates", 1)
        # the bundle outside the registry's lock (it re-reads this
        # registry's snapshot) and on its own thread: the scheduler
        # strikes under its condition lock, and a slow bundle directory
        # must not stall submit, pick and finish
        try:
            from spark_rapids_tpu_torch.obs.telemetry import (
                record_incident_async,
            )
            record_incident_async(
                "quarantine", "quarantined" if quarantined else "strike",
                reason, extra={"template": template_fp, "strikes": strikes})
        except Exception:
            pass
        return quarantined

    def is_quarantined(self, template_fp: Optional[str]
                       ) -> Optional[List[str]]:
        """The strike history when quarantined, else None."""
        if template_fp is None:
            return None
        with self._lock:
            history = self._quarantined.get(template_fp)
            return list(history) if history is not None else None

    def strike_count(self, template_fp: Optional[str]) -> int:
        if template_fp is None:
            return 0
        with self._lock:
            return len(self._strikes.get(template_fp, ()))

    def history(self, template_fp: Optional[str]) -> List[str]:
        if template_fp is None:
            return []
        with self._lock:
            return list(self._strikes.get(template_fp, ()))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "templatesWithStrikes": len(self._strikes),
                "strikes": sum(len(v) for v in self._strikes.values()),
                "quarantined": len(self._quarantined),
            }

    def reset(self) -> None:
        with self._lock:
            n = len(self._quarantined)
            self._strikes = {}
            self._quarantined = {}
            if n:
                self._metrics.add("quarantinedTemplates", -n)


QUARANTINE = QuarantineRegistry()


#: the mesh and host sections as written while the mesh and the cluster
#: are off (their runtimes report these values then)
IDLE_MESH = {"enabled": False, "shape": None, "declaredShape": None,
             "excludedDeviceIds": [], "degradedReason": None,
             "generation": 0}
IDLE_MESH_LADDER = {"meshDeviceLost": 0, "meshConsecutiveLosses": 0,
                    "meshShrinks": 0, "meshDegradations": 0}
IDLE_HOSTS = {"enabled": False, "declaredHosts": 0, "liveHosts": [],
              "lostHosts": [], "excludedHosts": [],
              "singleProcessReason": None, "degradedReason": None,
              "generation": 0}
IDLE_HOST_LADDER = {"hostsLost": 0, "hostConsecutiveLosses": 0,
                    "hostShrinks": 0}


def consistent_topology_snapshot() -> dict:
    """One coherent view of the device health, the quarantine ledger and
    the memory arbiter, the mesh and the cluster, taken with their locks
    held together so that the sections cannot tear against each other
    (the reference's shared-topology path). ``QueryService.health()`` and
    the ``/topology`` route read it. The locks nest in declared ascending
    rank, as the reference's do: cluster.runtime(300) ->
    health.monitor(400) -> health.quarantine(410) -> mesh.runtime(530) ->
    memory.arbiter(740, the port's reentrant lock, so ``MEMORY.snapshot()``
    may re-take it inside the nest)."""
    from spark_rapids_tpu_torch.parallel.mesh import MESH
    from spark_rapids_tpu_torch.runtime.cluster import CLUSTER
    from spark_rapids_tpu_torch.runtime.memory import MEMORY
    with CLUSTER._lock:
        with HEALTH._lock:
            with QUARANTINE._lock:
                with MESH._lock:
                    with MEMORY._lock:
                        return _topology_locked(CLUSTER, MESH, MEMORY)


def _topology_locked(cluster, mesh, memory) -> dict:
    """The snapshot's sections, read with every owning lock held."""
    return {
        "generation": HEALTH._losses,
        "state": HEALTH.state(),
        "cpuOnlyReason": HEALTH.cpu_only_reason(),
        "backend": {
            "deviceLost": HEALTH._losses,
            "deviceReinits": HEALTH._reinits,
            "consecutiveLosses": HEALTH._consecutive_losses,
        },
        "hosts": {**cluster._health_snapshot_locked(),
                  **HEALTH._host_snapshot_locked()},
        "mesh": {**mesh._health_snapshot_locked(),
                 **HEALTH._mesh_snapshot_locked()},
        "memory": {
            **memory.snapshot(),
            "memoryPressureEvents": HEALTH._mem_events,
            "memoryConsecutive": HEALTH._mem_consecutive,
            "memoryChunkedReexecutions": HEALTH._mem_chunked,
            "memoryCpuDemotions": HEALTH._mem_cpu_demotions,
        },
        "quarantine": {
            "templatesWithStrikes": len(QUARANTINE._strikes),
            "strikes": sum(len(v) for v in QUARANTINE._strikes.values()),
            "quarantined": len(QUARANTINE._quarantined),
        },
    }
