"""Worker watchdog: hard wall limits and a self-healing worker pool (port
of ``spark_rapids_tpu/service/watchdog.py``).

Reference: Spark's executor heartbeat and task reaper
(``spark.task.reaper.*``): the driver kills tasks that blow their wall
budget and replaces executors that stop heartbeating. This service's
workers are threads over ONE shared session, so the analog is in-process:

* **Hard wall limit** (``spark.rapids.service.hardTimeoutMs``). The
  cooperative deadline fires at exec-boundary batch pulls; a worker stuck
  INSIDE one launch (the ``dispatch.wedge`` fault, which stalls on the
  host side of a kernel launch) never reaches the next pull, so that
  deadline cannot fire. The watchdog sweeps RUNNING queries against the
  hard limit and, past it, ABANDONS the worker: the handle fails with
  :class:`~spark_rapids_tpu_torch.errors.HardTimeoutError`, a replacement
  worker spawns so that pool capacity holds, and the abandoned thread
  exits on its own if the launch ever returns. Python threads cannot be
  killed, only disowned.
* **What it cannot end.** A kernel that really hangs on the card cannot
  be ended from the process: CUDA offers no preemption a process can ask
  for, and every later launch on the legacy stream queues behind it. The
  watchdog frees the pool's capacity (the replacement worker plans and
  queues work), but the card stays busy until the kernel ends or the
  process exits.
* **Liveness backstop.** A worker thread that died without running the
  scheduler's own death handling (which catches everything, so something
  catastrophic happened) is detected dead, its handle failed, and a
  replacement spawned.

The lifecycle counters ``workersLost``, ``workersRespawned`` and
``hardTimeouts`` live in the ``health`` metric scope beside the
device-loss counters (runtime/health.py).
"""

from __future__ import annotations

import threading
import time

from spark_rapids_tpu_torch.conf import (  # noqa: F401 (re-export)
    SERVICE_HARD_TIMEOUT_MS as HARD_TIMEOUT_MS,
)
from spark_rapids_tpu_torch.errors import HardTimeoutError, WorkerLostError
from spark_rapids_tpu_torch.obs.metrics import register_metric
from spark_rapids_tpu_torch.service.query import QueryState

register_metric("workersLost", "count", "ESSENTIAL",
                "service workers that died or were abandoned by the "
                "watchdog (hard wall-limit breach)")
register_metric("workersRespawned", "count", "ESSENTIAL",
                "replacement service workers spawned so pool capacity "
                "holds through worker loss")
register_metric("hardTimeouts", "count", "ESSENTIAL",
                "queries failed by the watchdog's hard wall limit "
                "(spark.rapids.service.hardTimeoutMs)")


class _Worker:
    """One pool worker's bookkeeping: the thread, the handle it runs
    (None between queries), and the ``lost`` flag the watchdog sets when
    it abandons the worker (the worker's loop then exits without touching
    the running count, which the watchdog already corrected)."""

    __slots__ = ("thread", "handle", "lost", "name")

    def __init__(self, name: str):
        self.thread: threading.Thread = None
        self.handle = None
        self.lost = False
        self.name = name

    def __repr__(self):
        return (f"_Worker({self.name}, lost={self.lost}, "
                f"handle={self.handle})")


class WorkerWatchdog:
    """Sweeper thread over the service's worker pool. Pool state is read
    and corrected under the service's condition lock; handle transitions
    happen under each handle's own lock (handle locks never take the
    scheduler's, so there is no ordering cycle)."""

    def __init__(self, service):
        self.service = service
        self.hard_timeout_ms = int(service.conf.get_entry(HARD_TIMEOUT_MS))
        self._thread = threading.Thread(
            target=self._loop, name="rapids-svc-watchdog", daemon=True)
        self._thread.start()

    def join(self, timeout: float = 5.0) -> None:
        self._thread.join(timeout)

    def _loop(self):
        svc = self.service
        while True:
            with svc._cond:
                if svc._shutdown:
                    return
                self._sweep_locked()
                svc._cond.wait(timeout=svc._SWEEP_INTERVAL_S)

    def _sweep_locked(self):
        svc = self.service
        now = time.monotonic()
        for w in list(svc._workers):
            if w.lost:
                continue
            h = w.handle
            if not w.thread.is_alive():
                # the worker loop's death handling catches BaseException:
                # a dead thread with lost unset means something killed it
                # outside that net; the thread is gone either way
                self._abandon_locked(
                    w, h, WorkerLostError(
                        f"service worker {w.name} died unexpectedly"),
                    QueryState.FAILED, count="failed",
                    require_transition=False)
            elif (h is not None and self.hard_timeout_ms > 0
                    and h.start_t is not None
                    and h.state == QueryState.RUNNING
                    and (now - h.start_t) * 1000.0 > self.hard_timeout_ms):
                self._abandon_locked(
                    w, h, HardTimeoutError(
                        f"query {h.query_id} exceeded the hard wall limit "
                        f"({self.hard_timeout_ms}ms) - worker {w.name} "
                        "abandoned (stalled inside a launch?)"),
                    QueryState.TIMED_OUT, count="timed_out",
                    require_transition=True)

    def _abandon_locked(self, w, handle, error, terminal, count: str,
                        require_transition: bool):
        """Fail ``handle`` with ``error`` and mark ``w`` lost (it leaves
        its loop without decrementing the running count, corrected here);
        spawn a replacement. With ``require_transition`` the whole
        abandonment is gated on WINNING the handle's terminal transition:
        a query that completed between the sweep's read and this call
        keeps its healthy worker. Caller holds the condition lock."""
        svc = self.service
        transitioned = (handle._transition(terminal, error=error)
                        if handle is not None else False)
        if require_transition and not transitioned:
            return  # the query finished: the worker is fine
        if transitioned:
            svc.counters[count] += 1
            if count == "timed_out":
                svc._health_metrics.add("hardTimeouts", 1)
                svc.counters["hardTimeouts"] += 1
            # if the stalled launch ever returns, the next boundary aborts
            # the (already failed) query at once
            handle.scope.cancel()
            svc._strike_locked(handle, str(error))
        w.lost = True
        if handle is not None:
            svc._running -= 1
        svc._note_worker_lost_locked(w)
        svc._cond.notify_all()
