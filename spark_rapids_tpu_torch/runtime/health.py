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
  process latches: every later execute raises DeviceLostError naming the
  latch and the crash report. CUDA cannot re-create a context in the
  process after a sticky error, so there is no in-process backend
  re-initialisation; the reference latches CPU-only mode instead, and the
  port has no CPU route (ROADMAP item 9c).
* **Memory ladder.** A FatalDeviceOOM that escaped the retry framework
  walks one rung per escalation: ``retry`` (evict the device caches, spill
  the whole device tier, replay at the same shape), then ``chunk`` (replay
  with the scans chunked at half the scan chunk share), then ``abort``:
  the session re-raises the FatalDeviceOOM naming the rung the reference
  would take (``cpu_demote``, onto its CPU path). Any completed query
  resets the ladder.

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
``memoryChunkedReexecutions``, ``quarantineStrikes`` and
``quarantinedTemplates``."""

from __future__ import annotations

from typing import Dict, List, Optional

from spark_rapids_tpu_torch.conf import (  # noqa: F401 (re-export)
    DEVICE_LOSS_MAX_REINITS,
    QUARANTINE_MAX_STRIKES,
)
from spark_rapids_tpu_torch.errors import DeviceLostError, FatalDeviceOOM
from spark_rapids_tpu_torch.lockorder import ordered_lock
from spark_rapids_tpu_torch.obs.metrics import metric_scope, register_metric
from spark_rapids_tpu_torch.runtime.faults import CPU_ROUTE_ITEM

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
    def latch_reason(self) -> Optional[str]:
        return self._latch_reason

    def check_latch(self) -> None:
        """Raise the latch's DeviceLostError once the process latched."""
        reason = self._latch_reason
        if reason is not None:
            raise DeviceLostError(reason)

    # -- device loss ----------------------------------------------------------
    def on_device_loss(self, exc: BaseException, conf, device,
                       report: Optional[str] = None) -> str:
        """One fatal device error: count it, drop the device caches, probe
        the context. Returns ``"DEGRADED"`` (the next query runs on the
        card) or ``"LATCHED"``."""
        max_reinits = int(conf.get_entry(DEVICE_LOSS_MAX_REINITS))
        with self._lock:
            self._losses += 1
            self._consecutive_losses += 1
            n = self._consecutive_losses
            self._metrics.add("deviceLost", 1)
            if self._latch_reason is not None:
                return "LATCHED"
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
            self._latch_reason = (
                f"device health: the process latched after {why}; last "
                f"loss {type(exc).__name__}: {_first_line(exc)}; crash "
                f"report {report or 'not written'}. CUDA cannot re-create "
                "a context in this process: restart it (the reference "
                "latches CPU-only mode instead, which is not ported: "
                f"{CPU_ROUTE_ITEM})")
            return "LATCHED"

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
        the session takes (``retry``, ``chunk`` or ``abort``)."""
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
        return "abort"

    @staticmethod
    def abort_error(exc: BaseException) -> FatalDeviceOOM:
        """The ``abort`` rung's FatalDeviceOOM: ``exc``'s message and
        ``fault_op``, naming the rung the reference would take."""
        op = getattr(exc, "fault_op", None)
        err = FatalDeviceOOM(
            f"{exc}; memory ladder exhausted (retry, chunk): the "
            f"reference's cpu_demote rung would move "
            f"{op or 'the operator'} to its CPU path, which is not ported "
            f"({CPU_ROUTE_ITEM})")
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
                "latched": self._latch_reason is not None,
                "memoryPressureEvents": self._mem_events,
                "memoryConsecutive": self._mem_consecutive,
                "memoryChunkedReexecutions": self._mem_chunked,
            }

    def reset(self) -> None:
        with self._lock:
            self._losses = 0
            self._reinits = 0
            self._consecutive_losses = 0
            self._latch_reason: Optional[str] = None
            self._mem_events = 0
            self._mem_consecutive = 0
            self._mem_chunked = 0


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
