"""Task semaphore limiting concurrent device users (port of
``spark_rapids_tpu/runtime/semaphore.py``; reference: GpuSemaphore.scala,
which bounds how many tasks hold the device at once
(``spark.rapids.sql.concurrentGpuTasks``), tracks wait time and dumps
stacks when an acquisition stalls). A "task" is a query thread: the
session's drain runs under the semaphore (runtime/placement.py), so
concurrent queries do not exhaust the card."""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Dict, Optional

from spark_rapids_tpu_torch.errors import SemaphoreTimeoutError
from spark_rapids_tpu_torch.obs.metrics import metric_scope, register_metric
from spark_rapids_tpu_torch.lockorder import ordered_condition, ordered_lock

# acquisition accounting lives in the registry's ``semaphore`` scope
# (obs/metrics.py); the session diffs it per query
register_metric("acquireWaitTime", "timing", "ESSENTIAL",
                "wall time queries spent waiting for a device "
                "concurrency slot (TpuSemaphore)")
register_metric("acquires", "count", "ESSENTIAL",
                "TpuSemaphore slot acquisitions (first acquisition per "
                "holder; reentrant re-entries not counted)")
register_metric("acquireTimeouts", "count", "ESSENTIAL",
                "TpuSemaphore acquisitions abandoned on timeout "
                "(SemaphoreTimeoutError)")


class TpuSemaphore:
    _instance: Optional["TpuSemaphore"] = None
    _instance_lock = ordered_lock("semaphore.instance")

    def __init__(self, max_tasks: int, stall_dump_seconds: float = 60.0):
        self.max_tasks = max_tasks
        self.stall_dump_seconds = stall_dump_seconds
        self._lock = ordered_condition("semaphore.cond")
        self._holders: Dict[int, int] = {}  # thread id -> reentrant depth
        self._metrics = metric_scope("semaphore")
        self.total_wait_seconds = 0.0
        self.acquire_count = 0
        self.timeout_count = 0
        #: the most holders seen at once since the last reset_peak()
        self.peak_holders = 0

    @classmethod
    def initialize(cls, max_tasks: int) -> "TpuSemaphore":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = TpuSemaphore(max_tasks)
            elif cls._instance.max_tasks != max_tasks:
                # adjust the LIVE semaphore in place: holders/waiters carry
                # over so the concurrency cap is never bypassed
                inst = cls._instance
                with inst._lock:
                    inst.max_tasks = max_tasks
                    inst._lock.notify_all()
            return cls._instance

    @classmethod
    def current(cls) -> Optional["TpuSemaphore"]:
        return cls._instance

    def acquire_if_necessary(self, timeout: Optional[float] = None):
        """Reentrant per thread (a task that already holds it proceeds)."""
        tid = threading.get_ident()
        t0 = time.perf_counter()
        deadline = None if timeout is None else t0 + timeout
        with self._lock:
            if tid in self._holders:
                self._holders[tid] += 1
                return
            dumped = False
            while len(self._holders) >= self.max_tasks:
                remaining = None if deadline is None else deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    self.timeout_count += 1
                    self._metrics.add("acquireTimeouts", 1)
                    self._metrics.add("acquireWaitTime",
                                      time.perf_counter() - t0)
                    raise SemaphoreTimeoutError(
                        f"TpuSemaphore: {self.max_tasks} tasks already on "
                        f"device after waiting "
                        f"{time.perf_counter() - t0:.3f}s")
                waited = time.perf_counter() - t0
                if not dumped and waited > self.stall_dump_seconds:
                    self._dump_stacks()
                    dumped = True
                self._lock.wait(timeout=min(remaining or 1.0, 1.0))
            self._holders[tid] = 1
            self.peak_holders = max(self.peak_holders, len(self._holders))
            self.acquire_count += 1
            waited = time.perf_counter() - t0
            self.total_wait_seconds += waited
            self._metrics.add("acquires", 1)
            self._metrics.add("acquireWaitTime", waited)

    def release_if_held(self):
        tid = threading.get_ident()
        with self._lock:
            depth = self._holders.get(tid)
            if depth is None:
                return
            if depth > 1:
                self._holders[tid] = depth - 1
            else:
                del self._holders[tid]
                self._lock.notify_all()

    def _dump_stacks(self):
        """Deadlock diagnostics (reference: dumpStackTracesOnFailureToAcquire)."""
        frames = sys._current_frames()
        print("TpuSemaphore: stalled acquisition; holder stacks:", file=sys.stderr)
        for tid in self._holders:
            frame = frames.get(tid)
            if frame:
                traceback.print_stack(frame, file=sys.stderr)

    def reset_peak(self) -> None:
        with self._lock:
            self.peak_holders = len(self._holders)

    @property
    def holders(self) -> int:
        with self._lock:
            return len(self._holders)


class acquired:
    """Context manager: with acquired(sem): ... (no-op when sem is None)."""

    def __init__(self, sem: Optional[TpuSemaphore]):
        self.sem = sem

    def __enter__(self):
        if self.sem is not None:
            self.sem.acquire_if_necessary()
        return self.sem

    def __exit__(self, *exc):
        if self.sem is not None:
            self.sem.release_if_held()
        return False
