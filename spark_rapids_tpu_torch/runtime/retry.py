"""OOM retry framework (port of ``spark_rapids_tpu/runtime/retry.py``;
reference: RmmRapidsRetryIterator.scala's withRetry / withRetryNoSplit,
which catch GpuRetryOOM / GpuSplitAndRetryOOM from the RmmSpark per-thread
state machine; on a retry the thread spills and replays, on a split the
input halves and both halves replay; RmmSpark.forceRetryOOM injects them
in tests).

A real allocation failure on the card arrives as
``torch.cuda.OutOfMemoryError``. Its handler evicts the scan's device
cache, spills the catalog, returns torch's cached free blocks to the
device (``torch.cuda.empty_cache``) and replays; the arbiter's budget
(runtime/memory.py) raises RetryOOM the same way. An OOM that outlives
every retry and split raises ``FatalDeviceOOM``: nothing moves the query
to the CPU."""

from __future__ import annotations

import contextvars
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Union

import torch

from spark_rapids_tpu_torch.columnar import DeviceTable, bucket_for
from spark_rapids_tpu_torch.errors import (
    CpuRetryOOM,
    FatalDeviceOOM,
    RetryOOM,
    SplitAndRetryOOM,
)
from spark_rapids_tpu_torch.lockorder import ordered_lock
from spark_rapids_tpu_torch.runtime.speculation import guard_attempt
from spark_rapids_tpu_torch.runtime.spill import BufferCatalog, SpillableBatch


def is_device_oom(exc: BaseException) -> bool:
    """True for a retryable allocation failure: torch's CUDA
    OutOfMemoryError, the RetryOOM family, or a host CpuRetryOOM (the
    reference routes it through the same framework)."""
    return isinstance(exc, (RetryOOM, SplitAndRetryOOM, CpuRetryOOM,
                            torch.cuda.OutOfMemoryError))


class RetryStateMachine:
    """Per-thread injected-OOM bookkeeping (RmmSpark thread state analog).

    ``force_retry_oom(n)`` arms n RetryOOM throws at the next n retry
    blocks of the calling thread; ``force_split_and_retry_oom(n)`` does
    the same for the split escalation."""

    def __init__(self):
        self._local = threading.local()

    def _state(self):
        st = getattr(self._local, "st", None)
        if st is None:
            st = self._local.st = {"retry": 0, "split": 0}
        return st

    def force_retry_oom(self, num_ooms: int = 1):
        self._state()["retry"] += num_ooms

    def force_split_and_retry_oom(self, num_ooms: int = 1):
        self._state()["split"] += num_ooms

    def maybe_inject(self):
        st = self._state()
        if st["retry"] > 0:
            st["retry"] -= 1
            raise RetryOOM("injected RetryOOM (test)")
        if st["split"] > 0:
            st["split"] -= 1
            raise SplitAndRetryOOM("injected SplitAndRetryOOM (test)")

    @staticmethod
    def note_retry():
        from spark_rapids_tpu_torch.runtime.memory import MEM_SCOPE
        MEM_SCOPE.add("oomRetries", 1)

    @staticmethod
    def note_split():
        from spark_rapids_tpu_torch.runtime.memory import MEM_SCOPE
        MEM_SCOPE.add("splitRetries", 1)

    def clear(self):
        self._local.st = None


RMM_TPU = RetryStateMachine()

#: spark.rapids.memory.gpu.oomMaxRetries, set per query by the session so
#: every retry site (execs hold no conf) honors it
MAX_RETRIES_VAR = contextvars.ContextVar("rapids_torch_oom_max_retries",
                                         default=2)


def split_device_table_in_half(dt: DeviceTable) -> List[DeviceTable]:
    """Halve a batch by rows (splitSpillableInHalfByRows analog): a masked
    batch compacts to its prefix first, then each half copies into a
    table at its own capacity bucket. Reads the row count on the host,
    which only a retry path does."""
    dt = dt.compacted()
    n = dt.num_rows
    if n < 2:
        raise FatalDeviceOOM(
            f"cannot split a {n}-row batch further (GpuSplitAndRetryOOM at "
            "floor)")
    if any(c.is_nested for c in dt.columns):
        raise FatalDeviceOOM(
            "cannot split a batch that holds nested columns (their element "
            "buffers are not row-split)")
    first = n // 2
    outs = []
    for start, cnt in ((0, first), (first, n - first)):
        cap = bucket_for(cnt)
        cols = []
        for c in dt.columns:
            data = torch.zeros((cap,) + tuple(c.data.shape[1:]),
                               dtype=c.data.dtype, device=dt.device)
            data[:cnt] = c.data[start:start + cnt]
            validity = torch.zeros(cap, dtype=torch.bool, device=dt.device)
            validity[:cnt] = c.validity[start:start + cnt]
            cols.append(c.with_arrays(data, validity))
        outs.append(DeviceTable(dt.names, cols, cnt, cap, dt.device))
    return outs


SpillableOrTable = Union[SpillableBatch, DeviceTable]


def _as_spillable(x: SpillableOrTable, catalog: BufferCatalog
                  ) -> SpillableBatch:
    if isinstance(x, SpillableBatch):
        return x
    return SpillableBatch(x, catalog)


class DeviceMemoryEventHandler:
    """Allocation-failure callback (DeviceMemoryEventHandler.scala
    analog): spill synchronously and say whether a replay is worthwhile.
    Replays stop when a spill pass frees nothing twice in a row on the
    same catalog. After a real CUDA OOM the caching allocator still holds
    the freed blocks: ``empty_cache`` hands them back before the
    replay."""

    def __init__(self, catalog: Optional[BufferCatalog] = None):
        self._default_catalog = catalog
        self._lock = ordered_lock("memory.retry_handler")
        self.alloc_failure_count = 0
        self.spilled_bytes = 0
        self.spill_crashes = 0
        self._fruitless: dict = {}

    def on_alloc_failure(self, catalog: Optional[BufferCatalog] = None,
                         real_oom: bool = False) -> bool:
        from spark_rapids_tpu_torch.columnar.table import evict_device_caches
        catalog = catalog or self._default_catalog or BufferCatalog.get()
        evict_device_caches()
        try:
            freed = catalog.synchronous_spill(1 << 62)
        except Exception:
            # the spill pass itself failed: what it freed stays freed, the
            # failure is counted, and the replay (bounded by the caller's
            # retries) goes ahead
            with self._lock:
                self.spill_crashes += 1
            freed = 0
        if real_oom and torch.cuda.is_available():
            torch.cuda.empty_cache()
        with self._lock:
            self.alloc_failure_count += 1
            self.spilled_bytes += freed
            key = id(catalog)
            if freed > 0:
                self._fruitless[key] = 0
                return True
            n = self._fruitless.get(key, 0) + 1
            self._fruitless[key] = n
            return n < 2

    def reset_fruitless(self, catalog: BufferCatalog):
        """At a retry block's entry: a new operator's pressure is a fresh
        situation."""
        with self._lock:
            self._fruitless.pop(id(catalog), None)


DEVICE_MEMORY_EVENT_HANDLER = DeviceMemoryEventHandler()


def _free_memory_for(exc: BaseException, catalog: BufferCatalog) -> bool:
    """Route the spill to the exhausted tier: a host OOM pushes the host
    tier to disk; a device OOM takes the device demotion chain."""
    if isinstance(exc, CpuRetryOOM):
        catalog.spill_host_to_disk()
        return True
    return DEVICE_MEMORY_EVENT_HANDLER.on_alloc_failure(
        catalog, real_oom=isinstance(exc, torch.cuda.OutOfMemoryError))


def with_retry(
    inputs: Union[SpillableOrTable, Sequence[SpillableOrTable]],
    fn: Callable[[DeviceTable], object],
    *,
    splittable: bool = True,
    max_retries: Optional[int] = None,
    catalog: Optional[BufferCatalog] = None,
) -> Iterator[object]:
    """Run ``fn`` over input batch(es), surviving device OOM.

    Per attempt the injection hook fires first, then ``fn`` runs over the
    pinned input; on an OOM the catalog spills and the SAME input replays
    (up to ``max_retries``), then the input splits in half by rows and
    both halves replay (when ``splittable``). One result per final
    (possibly split) input batch. Reference: withRetry(spillable)(fn),
    RmmRapidsRetryIterator.scala:62; withRetryNoSplit :126."""
    catalog = catalog or BufferCatalog.get()
    if max_retries is None:
        max_retries = MAX_RETRIES_VAR.get()
    DEVICE_MEMORY_EVENT_HANDLER.reset_fruitless(catalog)
    if isinstance(inputs, (SpillableBatch, DeviceTable)):
        inputs = [inputs]
    stack: List[SpillableBatch] = [_as_spillable(x, catalog)
                                   for x in reversed(list(inputs))]
    sb = None
    try:
        while stack:
            sb = stack.pop()
            attempts = 0
            while True:
                try:
                    RMM_TPU.maybe_inject()
                    with sb.pinned_batch() as dt:
                        result = [guard_attempt(lambda: fn(dt))]
                    # this frame lives on while the consumer runs: it
                    # must not keep the input or the output alive
                    del dt
                    sb.release()
                    sb = None
                    yield result.pop()
                    break
                except Exception as exc:
                    oom = is_device_oom(exc)
                    escalate = isinstance(exc, SplitAndRetryOOM) or (
                        oom and attempts >= max_retries)
                    if oom and not escalate:
                        attempts += 1
                        RMM_TPU.note_retry()
                        if _free_memory_for(exc, catalog):
                            continue
                        escalate = True
                    if escalate:
                        tier = ("host" if isinstance(exc, CpuRetryOOM)
                                else "device")
                        if not splittable:
                            raise FatalDeviceOOM(
                                f"{tier} OOM and operator cannot split its "
                                "input") from exc
                        RMM_TPU.note_split()
                        _free_memory_for(exc, catalog)
                        with sb.pinned_batch() as dt:
                            halves = split_device_table_in_half(dt)
                        del dt
                        sb.release()
                        sb = None
                        for h in reversed(halves):
                            stack.append(_as_spillable(h, catalog))
                        break
                    raise
    finally:
        # abandonment (a LIMIT upstream), a fatal OOM or any error: drop
        # every input still registered
        if sb is not None:
            sb.release()
        for pending in stack:
            pending.release()


def with_retry_no_split(
    inputs: Union[SpillableOrTable, Sequence[SpillableOrTable]],
    fn: Callable[[DeviceTable], object],
    *,
    max_retries: Optional[int] = None,
    catalog: Optional[BufferCatalog] = None,
) -> Iterator[object]:
    return with_retry(inputs, fn, splittable=False, max_retries=max_retries,
                      catalog=catalog)


def retry_block(fn: Callable[[], object], *, max_retries: Optional[int] = None,
                catalog: Optional[BufferCatalog] = None) -> object:
    """Retry a device computation that has no single input batch (joins,
    merges): spill-and-replay only, no split. A replay runs inside
    ``guard_attempt``, so it neither validates nor clears the flags of
    the speculation attempt around it."""
    catalog = catalog or BufferCatalog.get()
    if max_retries is None:
        max_retries = MAX_RETRIES_VAR.get()
    DEVICE_MEMORY_EVENT_HANDLER.reset_fruitless(catalog)
    attempts = 0
    while True:
        try:
            RMM_TPU.maybe_inject()
            return guard_attempt(fn)
        except Exception as exc:
            if is_device_oom(exc) and attempts < max_retries:
                attempts += 1
                RMM_TPU.note_retry()
                # replay even when the pass freed nothing: the replays are
                # bounded by max_retries, and a blocked reservation (or an
                # injected OOM) can succeed without new spillables
                _free_memory_for(exc, catalog)
                continue
            if is_device_oom(exc):
                tier = "host" if isinstance(exc, CpuRetryOOM) else "device"
                raise FatalDeviceOOM(
                    f"{tier} OOM persisted after {attempts} spill-retries"
                ) from exc
            raise
