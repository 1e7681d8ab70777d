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
  collects strikes (the session strikes on the ``chunk`` and ``abort``
  rungs and on device loss); at ``spark.rapids.service.quarantine.
  maxStrikes`` it is quarantined, and ``explain`` names it a poison
  suspect. Refusing a quarantined template at admission is the service
  scheduler's, and the flight recorder's incident bundle is
  ``obs/telemetry.py``'s: both wait for item 12.

Not ported here: the mesh and host ladders (ROADMAP item 11). Counters
live in the ``health`` metric scope under the reference's names:
``deviceLost``, ``deviceReinits``, ``memoryPressure``,
``memoryChunkedReexecutions``, ``memoryCpuDemotions``,
``quarantineStrikes`` and ``quarantinedTemplates``."""

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
register_metric("quarantineStrikes", "count", "MODERATE",
                "poison-query strikes recorded against query templates")
register_metric("quarantinedTemplates", "count", "ESSENTIAL",
                "query templates currently quarantined")


def _first_line(exc: BaseException) -> str:
    return str(exc).splitlines()[0] if str(exc) else type(exc).__name__


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
    """Drop every cache that holds device memory: the scan's device images
    and the cached broadcast batches."""
    from spark_rapids_tpu_torch.columnar.table import evict_device_caches
    from spark_rapids_tpu_torch.execs.broadcast import evict_broadcast_caches
    for fn in (evict_device_caches, evict_broadcast_caches):
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

    # -- the latch -------------------------------------------------------------
    def cpu_only_reason(self) -> Optional[str]:
        """The latch's reason once the process latched CPU-only mode (every
        operator's tag then), else None."""
        return self._cpu_only_reason

    # -- device loss ----------------------------------------------------------
    def on_device_loss(self, exc: BaseException, conf, device,
                       report: Optional[str] = None) -> str:
        """One fatal device error: count it, drop the device caches, probe
        the context. Returns ``"DEGRADED"`` (the next query runs on the
        card) or ``"CPU_ONLY"`` (the process latched)."""
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

    def note_success(self) -> None:
        """A query completed: the consecutive-loss budget and the memory
        ladder refill."""
        if self._consecutive_losses or self._mem_consecutive:
            with self._lock:
                self._consecutive_losses = 0
                self._mem_consecutive = 0

    # -- the memory ladder ------------------------------------------------------
    def on_memory_pressure(self, exc: BaseException, conf) -> str:
        """One FatalDeviceOOM that escaped the retry framework: the rung
        the session takes (``retry``, ``chunk``, then ``cpu_demote`` for
        an error that carries ``fault_op``, else ``abort``)."""
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

    # -- introspection ----------------------------------------------------------
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
            self._metrics.add("quarantineStrikes", 1)
            quarantined = (template_fp not in self._quarantined
                           and len(history) >= max(1, int(max_strikes)))
            if quarantined:
                self._quarantined[template_fp] = list(history)
                self._metrics.add("quarantinedTemplates", 1)
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
