"""Host memory arbiter and pinned staging pool (port of
``spark_rapids_tpu/runtime/host_alloc.py``; reference: HostAlloc.scala
and PinnedMemoryPool).

``HostMemoryArbiter`` has the reference's semantics: allocations past the
limit first free host memory (the spill catalog's host tier goes to
disk), then wait a bounded time for other tasks to release, then raise
``CpuRetryOOM``, which the retry framework handles like a device OOM.
Its consumers are the reference's two: the spill catalog, where every
host copy of a spilled batch holds a grant (runtime/spill.py), and the
shuffle manager, whose serialized map output holds one until it is
flushed, when it is written and when it is rewritten for recovery
(shuffle/manager.py ``write_partitions``, ``rewrite_map``).
``PinnedMemoryPool`` hands out page-locked torch buffers
(``torch.empty(..., dtype=torch.uint8, pin_memory=True)``) for
device-to-host spill copies (``spark.rapids.memory.pinnedPool.size``);
when it is exhausted, or a request is larger than its buffers, callers
allocate unpooled, as the reference's do."""

from __future__ import annotations

from typing import Optional

import torch

from spark_rapids_tpu_torch.errors import ColumnarProcessingError, CpuRetryOOM
from spark_rapids_tpu_torch.lockorder import ordered_condition, ordered_lock


class HostAllocation:
    """Grant handle; ``release`` returns the bytes to the arbiter. Usable
    as a context manager."""

    def __init__(self, arbiter: "HostMemoryArbiter", nbytes: int):
        self.arbiter = arbiter
        self.nbytes = nbytes
        self._released = False

    def release(self):
        if not self._released:
            self._released = True
            self.arbiter._release(self.nbytes)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class HostMemoryArbiter:
    """Process-wide host-memory budget (HostAlloc analog)."""

    _instance: Optional["HostMemoryArbiter"] = None
    _instance_lock = ordered_lock("host_alloc.instance")

    def __init__(self, limit_bytes: int):
        self.limit_bytes = limit_bytes
        self._used = 0
        self._cv = ordered_condition("host_alloc.cv")
        self.alloc_count = 0
        self.blocked_count = 0
        self.spill_triggered_count = 0

    @classmethod
    def get(cls) -> "HostMemoryArbiter":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = HostMemoryArbiter(4 << 30)
            return cls._instance

    @classmethod
    def reset(cls, limit_bytes: int) -> "HostMemoryArbiter":
        with cls._instance_lock:
            cls._instance = HostMemoryArbiter(limit_bytes)
            return cls._instance

    @property
    def used_bytes(self) -> int:
        with self._cv:
            return self._used

    def _release(self, nbytes: int):
        with self._cv:
            self._used -= nbytes
            self._cv.notify_all()

    def _try_free_host_memory(self) -> int:
        """Demote the spill catalog's host tier to disk."""
        from spark_rapids_tpu_torch.runtime.spill import BufferCatalog
        self.spill_triggered_count += 1
        return BufferCatalog.get().spill_host_to_disk()

    def alloc(self, nbytes: int, timeout_s: float = 10.0) -> HostAllocation:
        """Grant ``nbytes`` of host budget. A request of the whole limit or
        more is granted alone (it must not deadlock); a contended request
        spills the host tier, then waits, then raises CpuRetryOOM."""
        if nbytes < 0:
            raise ColumnarProcessingError("negative host allocation")
        with self._cv:
            self.alloc_count += 1
            if nbytes >= self.limit_bytes or \
                    self._used + nbytes <= self.limit_bytes:
                self._used += nbytes
                return HostAllocation(self, nbytes)
        self._try_free_host_memory()
        with self._cv:
            if self._used + nbytes <= self.limit_bytes:
                self._used += nbytes
                return HostAllocation(self, nbytes)
            self.blocked_count += 1
            ok = self._cv.wait_for(
                lambda: self._used + nbytes <= self.limit_bytes,
                timeout=timeout_s)
            if not ok:
                raise CpuRetryOOM(
                    f"host memory exhausted: want {nbytes}B, "
                    f"{self._used}/{self.limit_bytes}B in use")
            self._used += nbytes
            return HostAllocation(self, nbytes)


class PinnedMemoryPool:
    """Page-locked staging buffers for device-to-host copies. A fixed
    number of ``buffer_bytes`` buffers; ``acquire`` returns None when the
    pool is empty or the request is larger than a buffer, and the caller
    copies unpooled."""

    _instance: Optional["PinnedMemoryPool"] = None
    _instance_lock = ordered_lock("pinned_pool.instance")

    def __init__(self, total_bytes: int, buffer_bytes: int = 64 << 20):
        self.buffer_bytes = int(buffer_bytes)
        n = max(int(total_bytes) // self.buffer_bytes, 0)
        pin = torch.cuda.is_available()
        self._free = [torch.empty(self.buffer_bytes, dtype=torch.uint8,
                                  pin_memory=pin) for _ in range(n)]
        self._lock = ordered_lock("pinned_pool")
        self.total_buffers = n
        self.hits = 0
        self.misses = 0

    @classmethod
    def initialize(cls, total_bytes: int, buffer_bytes: int = 64 << 20
                   ) -> Optional["PinnedMemoryPool"]:
        with cls._instance_lock:
            old = cls._instance
            if old is not None and total_bytes > 0 and \
                    old.total_buffers * old.buffer_bytes == \
                    (total_bytes // buffer_bytes) * buffer_bytes and \
                    old.buffer_bytes == buffer_bytes:
                return old  # same size: keep the pinned pages
            cls._instance = (PinnedMemoryPool(total_bytes, buffer_bytes)
                             if total_bytes > 0 else None)
            return cls._instance

    @classmethod
    def get(cls) -> Optional["PinnedMemoryPool"]:
        return cls._instance

    def acquire(self, nbytes: int) -> Optional[torch.Tensor]:
        """A page-locked uint8 buffer of ``buffer_bytes``, or None."""
        with self._lock:
            if nbytes > self.buffer_bytes or not self._free:
                self.misses += 1
                return None
            self.hits += 1
            return self._free.pop()

    def release(self, buf: torch.Tensor):
        with self._lock:
            if len(self._free) >= self.total_buffers:
                raise ColumnarProcessingError(
                    "double release of pinned buffer")
            self._free.append(buf)
