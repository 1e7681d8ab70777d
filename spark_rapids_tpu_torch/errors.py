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
    """A block fetch failed in a retryable way (an injected ``fetch``
    fault)."""


class ShuffleTransportError(ShuffleFetchError):
    """The transport connection itself failed (an injected
    ``disconnect`` fault)."""


class DeviceLostError(RapidsTpuError):
    """The device was lost mid-query: an injected ``device_lost`` fault,
    or a fatal CUDA error classified by
    ``runtime.crash_handler.is_fatal_device_error``. By the time the
    caller sees it, the health monitor (runtime/health.py) has written a
    crash report, dropped the device caches and probed the context: the
    next query runs on the card, or, once the process latched, raises
    this again naming the latch."""
