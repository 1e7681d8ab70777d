"""Spillable shuffle buffer catalogs (port of
``spark_rapids_tpu/shuffle/catalogs.py``; the spark-rapids
``ShuffleBufferCatalog`` and ``ShuffleReceivedBufferCatalog``).

The P2P writer keeps its map output resident as packed TPAK blobs (already
compressed by the resolved codec) instead of writing shuffle files. The
write-side catalog bounds the host-resident total and demotes the
least-recently-touched blobs to disk files; serving a spilled blob reads
it back from disk. The read-side catalog hands fetched blocks to the
reader in arrival order."""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from spark_rapids_tpu_torch.errors import ColumnarProcessingError

BlockId = Tuple[int, int, int]  # (shuffle_id, map_id, partition_id)


class _CachedBlob:
    __slots__ = ("block_id", "data", "disk_path", "length", "last_touch",
                 "lock")

    def __init__(self, block_id: BlockId, data: bytes):
        self.block_id = block_id
        self.data: Optional[bytes] = data
        self.disk_path: Optional[str] = None
        self.length = len(data)
        self.last_touch = time.monotonic()
        self.lock = threading.Lock()


class ShuffleBufferCatalog:
    """Write-side catalog of cached shuffle blocks for one executor."""

    def __init__(self, host_limit_bytes: int = 1 << 30,
                 disk_dir: Optional[str] = None):
        self.host_limit_bytes = host_limit_bytes
        self.disk_dir = disk_dir or tempfile.mkdtemp(
            prefix="rapids_tpu_shufcache_")
        self._lock = threading.RLock()
        self._blobs: Dict[BlockId, _CachedBlob] = {}
        self._host_bytes = 0
        self.spill_count = 0
        self.spilled_bytes = 0

    # -- write side ---------------------------------------------------------
    def add_block(self, block_id: BlockId, data: bytes):
        with self._lock:
            if block_id in self._blobs:
                raise ColumnarProcessingError(
                    f"duplicate shuffle block {block_id}")
            self._blobs[block_id] = _CachedBlob(block_id, data)
            self._host_bytes += len(data)
        self._enforce_limit()

    def block_length(self, block_id: BlockId) -> Optional[int]:
        with self._lock:
            blob = self._blobs.get(block_id)
            return None if blob is None else blob.length

    def blocks_for_partition(self, shuffle_id: int, partition_id: int,
                             map_ids: Optional[List[int]] = None
                             ) -> List[Tuple[BlockId, int]]:
        """(block_id, length) for every cached block of a reduce partition,
        in map order — the metadata-response payload."""
        with self._lock:
            out = []
            for bid, blob in self._blobs.items():
                sid, mid, pid = bid
                if sid == shuffle_id and pid == partition_id and (
                        map_ids is None or mid in map_ids):
                    out.append((bid, blob.length))
            out.sort(key=lambda x: x[0][1])
            return out

    # -- serve side ---------------------------------------------------------
    def get_block(self, block_id: BlockId) -> bytes:
        """Blob bytes, faulting back from disk when spilled."""
        with self._lock:
            blob = self._blobs.get(block_id)
        if blob is None:
            raise ColumnarProcessingError(
                f"unknown shuffle block {block_id}")
        with blob.lock:
            blob.last_touch = time.monotonic()
            if blob.data is not None:
                return blob.data
            assert blob.disk_path is not None
            with open(blob.disk_path, "rb") as f:
                data = f.read()
            if len(data) != blob.length:
                raise ColumnarProcessingError(
                    f"shuffle block {block_id} truncated on disk")
            # serve from disk without re-admitting to the host tier (a hot
            # re-read pattern would thrash; the reference keeps spilled
            # buffers in their tier until explicitly unspilled)
            return data

    # -- spill --------------------------------------------------------------
    def _enforce_limit(self):
        with self._lock:
            if self._host_bytes <= self.host_limit_bytes:
                return
            order = sorted(self._blobs.values(), key=lambda b: b.last_touch)
        for blob in order:
            with blob.lock:
                if blob.data is None:
                    continue
                fd, path = tempfile.mkstemp(
                    prefix=f"shufblk_{blob.block_id[0]}_", suffix=".bin",
                    dir=self.disk_dir)
                with os.fdopen(fd, "wb") as f:
                    f.write(blob.data)
                blob.disk_path = path
                freed = len(blob.data)
                blob.data = None
            with self._lock:
                self._host_bytes -= freed
                self.spill_count += 1
                self.spilled_bytes += freed
                if self._host_bytes <= self.host_limit_bytes:
                    return

    @property
    def host_bytes(self) -> int:
        with self._lock:
            return self._host_bytes

    def remove_block(self, block_id: BlockId):
        """Withdraw one block (failed-attempt cleanup — P2PWriteHandle)."""
        with self._lock:
            blob = self._blobs.pop(block_id, None)
        if blob is None:
            return
        # blob.lock orders against a concurrent _enforce_limit spill of
        # this blob (it flips data->disk and decrements _host_bytes)
        with blob.lock:
            if blob.data is not None:
                with self._lock:
                    self._host_bytes -= len(blob.data)
                blob.data = None
            if blob.disk_path and os.path.exists(blob.disk_path):
                os.unlink(blob.disk_path)

    # -- lifecycle ----------------------------------------------------------
    def remove_shuffle(self, shuffle_id: int):
        with self._lock:
            doomed = [self._blobs.pop(bid) for bid in list(self._blobs)
                      if bid[0] == shuffle_id]
        for blob in doomed:
            with blob.lock:
                if blob.data is not None:
                    with self._lock:
                        self._host_bytes -= len(blob.data)
                    blob.data = None
                if blob.disk_path and os.path.exists(blob.disk_path):
                    os.unlink(blob.disk_path)


class ShuffleReceivedBufferCatalog:
    """Read-side registry of fetched blocks awaiting deserialization
    (ShuffleReceivedBufferCatalog analog). Bounded only by the consumer:
    the client hands blobs over as they complete and the reader iterator
    drains them in arrival order."""

    def __init__(self):
        self._lock = threading.Condition()
        self._queue: List[Tuple[BlockId, bytes]] = []
        self._expected: Optional[int] = None
        self._received = 0
        self._error: Optional[str] = None

    def expect(self, n: int):
        with self._lock:
            self._expected = n
            self._lock.notify_all()

    def add(self, block_id: BlockId, data: bytes):
        with self._lock:
            self._queue.append((block_id, data))
            self._received += 1
            self._lock.notify_all()

    def fail(self, message: str):
        with self._lock:
            self._error = message
            self._lock.notify_all()

    def drain(self, timeout: float = 300.0) -> Iterator[Tuple[BlockId, bytes]]:
        """Yield blocks as they arrive until all expected ones came in."""
        deadline = time.monotonic() + timeout
        yielded = 0
        while True:
            with self._lock:
                while (not self._queue and self._error is None
                       and (self._expected is None
                            or yielded + len(self._queue) < self._expected)):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._lock.wait(
                            timeout=min(remaining, 5.0)):
                        if time.monotonic() >= deadline:
                            raise ColumnarProcessingError(
                                "timed out waiting for shuffle blocks")
                if self._error is not None:
                    raise ColumnarProcessingError(
                        f"shuffle fetch failed: {self._error}")
                if self._queue:
                    item = self._queue.pop(0)
                else:
                    return  # all expected blocks yielded
            yielded += 1
            yield item
            if self._expected is not None and yielded >= self._expected:
                return
