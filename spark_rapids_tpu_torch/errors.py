"""Engine error types (the subset of ``spark_rapids_tpu/errors.py`` that
the ported path raises), with the reference's OOM and retry protocol:
RetryOOM / SplitAndRetryOOM / CpuRetryOOM / CpuSplitAndRetryOOM /
FatalDeviceOOM, the reference's names for spark-rapids-jni's GpuRetryOOM
family, raised by the memory arbiter's budget (runtime/memory.py) and by
the test injection hooks (runtime/retry.py); a real allocation failure on
the card arrives as ``torch.cuda.OutOfMemoryError`` and the retry
framework treats it as a RetryOOM."""

from __future__ import annotations


class RapidsTpuError(Exception):
    """Base for all engine errors."""


class RetryOOM(RapidsTpuError):
    """Device allocation failed; caller should spill and replay the same
    input (reference: GpuRetryOOM)."""


class SplitAndRetryOOM(RapidsTpuError):
    """Device allocation failed and replay alone will not help; caller
    should split the input (halve rows) and replay (reference:
    GpuSplitAndRetryOOM)."""


class CpuRetryOOM(RapidsTpuError):
    """Host allocation failed; spill host buffers and replay."""


class CpuSplitAndRetryOOM(RapidsTpuError):
    """Host allocation failed; split input and replay."""


class FatalDeviceOOM(RapidsTpuError):
    """Unrecoverable device OOM after retries exhausted (reference:
    GpuOOM). Nothing runs the query elsewhere: it fails."""


class ColumnarProcessingError(RapidsTpuError):
    """An operator failed on device in a way that is not an OOM."""


class SemaphoreTimeoutError(RapidsTpuError, TimeoutError):
    """TpuSemaphore acquisition timed out: ``max_tasks`` queries already
    hold the device and none released within the caller's timeout."""


class KernelCrashError(ColumnarProcessingError):
    """A device kernel failed with a non-OOM runtime fault (an injected
    ``crash`` fault, runtime/faults.py). Carries ``fault_op``, the
    plan-node class of the nearest enclosing operator, which feeds the
    circuit breaker; the session replays the query on it."""


class SpillCorruptionError(KernelCrashError):
    """A disk-tier spill frame failed its CRC footer on unspill (bit rot,
    a torn write, an injected ``mem.unspill`` corruption). The corrupt
    frame is dropped, never served; a KernelCrashError on purpose, as in
    the reference, so that a query replay re-lands the data."""


class ShuffleFetchError(ColumnarProcessingError):
    """A shuffle block fetch failed in a retryable way (a peer's error
    frame, a short transfer, an exhausted bounce pool, an injected
    ``fetch`` fault): the fetch-retry loop replays it with backoff before
    the map output is declared lost."""


class ShuffleTransportError(ShuffleFetchError):
    """The transport connection itself failed (a socket error, a peer's
    disconnect, an injected ``disconnect`` fault); the connection is
    evicted so that the retry reconnects."""


class CorruptFrameError(ShuffleFetchError):
    """A serialized frame failed its integrity checks (bad TPAK magic or
    version, a CRC mismatch, a truncated buffer). Retryable: its source
    (the catalog's blob, the shuffle file, the upstream lineage) is
    intact."""


class MapOutputLostError(RapidsTpuError):
    """A shuffle map output is unreachable: a fetch exhausted its retries
    or its peer was evicted. Carries ``executor_id`` (the lost peer, ''
    when local) and ``map_ids`` (None: unknown, recompute every map). The
    exchange recomputes the missing maps from the retained plan."""

    def __init__(self, message: str, executor_id: str = "",
                 map_ids=None):
        super().__init__(message)
        self.executor_id = executor_id
        self.map_ids = None if map_ids is None else sorted(set(map_ids))


class PlanVerificationError(RapidsTpuError):
    """A converted plan violated a structural invariant
    (spark.rapids.sql.planVerify.mode=error). Carries the structured
    diagnostics in ``.diagnostics``; the message lists rule id + plan
    path per finding."""

    def __init__(self, diagnostics):
        self.diagnostics = list(diagnostics)
        super().__init__(
            "plan verification failed:\n" +
            "\n".join(f"  {d}" for d in self.diagnostics))


class DeviceLostError(RapidsTpuError):
    """The device was lost mid-query: an injected ``device_lost`` fault,
    or a fatal CUDA error classified by
    ``runtime.crash_handler.is_fatal_device_error``. By the time the
    caller sees it, the health monitor (runtime/health.py) has written a
    crash report, dropped the device caches and probed the context: the
    next query runs on the card, or, once the process latched, raises
    this again naming the latch."""


class MeshDeviceLostError(DeviceLostError):
    """A PARTIAL device loss: one logical device of the mesh died while the
    process's device as a whole is alive (an injected ``device_lost`` at a
    ``mesh.*`` point). Recovery walks the mesh ladder
    (runtime/health.py ``on_mesh_device_loss``: retry, a single-device
    replay, a shrink excluding the device, then the device-loss ladder).
    ``device_id`` is the logical id when known (None: the ladder excludes
    the mesh's last device)."""

    def __init__(self, message: str, device_id=None):
        super().__init__(message)
        self.device_id = device_id


class HostLostError(DeviceLostError):
    """A whole executor process of the cluster died or went unreachable (a
    dead dispatch socket, a missed-heartbeat eviction, an injected
    ``device_lost`` at a ``host.*`` point). Recovery walks the host ladder
    (runtime/health.py ``on_host_loss``: retry, re-land on the survivors,
    shrink, single process, then the device-loss ladder). ``host_id`` is
    the host when known (None: the ladder marks the last usable one)."""

    def __init__(self, message: str, host_id=None):
        super().__init__(message)
        self.host_id = host_id


class MeshGatherError(KernelCrashError):
    """The row-count and checksum check at a mesh gather boundary (the
    re-land, or the exchange's count read) kept failing past
    ``spark.rapids.mesh.maxShardRetries`` re-gathers. A KernelCrashError
    on purpose: the sharded source is intact, so a query replay re-lands
    it rather than serving wrong rows."""


class WorkerLostError(RapidsTpuError):
    """The service worker running this query died (its runner raised
    outside the query) or was abandoned by the watchdog. The pool spawned
    a replacement; the query was requeued up to its replay budget before
    this error surfaced."""


class QueryRejectedError(RapidsTpuError):
    """The query service refused admission: the pool's queue is at
    ``spark.rapids.service.queueDepth``, or a DEGRADED service sheds the
    pool. Carries ``retry_after_ms``, the service's hint of when capacity
    is likely free (HTTP 429's Retry-After)."""

    def __init__(self, message: str, retry_after_ms: int = 100):
        super().__init__(message)
        self.retry_after_ms = int(retry_after_ms)


class QueryCancelledError(RapidsTpuError):
    """The query was cancelled through ``QueryHandle.cancel()``: raised
    between batches at the exec boundary (service/query.py
    ``install_cancellation``), so a running plan stops at its next pull."""


class QueryTimeoutError(RapidsTpuError):
    """The query's deadline (submit time plus its timeout) expired, while
    queued or between batches while running."""


class HardTimeoutError(QueryTimeoutError):
    """The watchdog's hard wall limit (``spark.rapids.service.
    hardTimeoutMs``) expired while the query was RUNNING. The cooperative
    deadline fires at batch pulls, so a worker stalled inside one launch
    never sees it: the watchdog abandons that worker, spawns a
    replacement and fails the handle with this error."""


class QueryQuarantinedError(RapidsTpuError):
    """The query's template is quarantined: plans of its structural
    fingerprint killed workers or the device, or drove the memory ladder
    past its plain retry, ``spark.rapids.service.quarantine.maxStrikes``
    times, so the service refuses it. Carries ``strikes``, the recorded
    reasons."""

    def __init__(self, message: str, strikes=None):
        super().__init__(message)
        self.strikes = list(strikes or ())
