"""Spill framework: spillable batches and the tiered buffer catalog (port
of ``spark_rapids_tpu/runtime/spill.py``; reference:
SpillableColumnarBatch.scala, RapidsBufferCatalog's DEVICE -> HOST ->
DISK demotion chain, SpillPriorities).

A DeviceTable's tensors free when the last reference drops, so spilling
is a raw copy of every buffer to the host and dropping the device
reference. The catalog keeps every registered spillable in priority
order and demotes device -> host -> disk until a byte target is met; the
host tier is bounded by ``spark.rapids.memory.host.spillStorageSize``
and overflows to disk frames with a CRC32 footer.

A spill carries everything a port DeviceTable holds: each column's data
(DECIMAL128 limb pairs included) and validity, its string dictionary,
sort flag and domain, the ``live`` mask of a masked batch, the row count
(a host int, or a device scalar that is copied with the buffers and
lands as a device scalar again), the capacity and the ``split_group``
token. The unspilled table is bit-identical in layout and padding, so a
kernel replaying over it gives the never-spilled answer.

Each host copy holds a grant of the host arbiter
(``spark.rapids.memory.host.limit``, runtime/host_alloc.py) while it
lives. Device-to-host copies go through the page-locked pool
(runtime/host_alloc.py) when it has a buffer: chunks are copied with
``non_blocking=True`` into two alternating pinned buffers and an event is
waited on before the host reads each chunk into its pageable
destination; without a buffer the copy is a plain (pageable) one."""

from __future__ import annotations

import atexit
import glob
import itertools
import os
import pickle
import struct
import tempfile
import time
import weakref
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import DeviceColumn, DeviceTable
from spark_rapids_tpu_torch.errors import (
    ColumnarProcessingError,
    SpillCorruptionError,
)
from spark_rapids_tpu_torch.lockorder import ordered_lock, ordered_rlock
from spark_rapids_tpu_torch.runtime.faults import fault_point
from spark_rapids_tpu_torch.obs.metrics import metric_scope, register_metric

TIER_DEVICE = "DEVICE"
TIER_HOST = "HOST"
TIER_DISK = "DISK"

#: CRC32 footer width on disk-tier spill frames
_CRC_LEN = 4

register_metric("spillDeviceCount", "count", "MODERATE",
                "device-to-host spill demotions")
register_metric("spillDiskCount", "count", "MODERATE",
                "host-to-disk spill demotions")
register_metric("spillDeviceBytes", "bytes", "MODERATE",
                "device bytes spilled to the host tier")
register_metric("spillDiskBytes", "bytes", "MODERATE",
                "host bytes spilled to the disk tier")
register_metric("spillTime", "timing", "MODERATE",
                "wall time of spill passes that freed bytes")


def _byte_view(t: torch.Tensor) -> torch.Tensor:
    """A flat uint8 view of a contiguous tensor's bytes."""
    return t.reshape(-1).view(torch.uint8)


def device_to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy. A CUDA tensor goes through the
    pinned pool's buffers when one is free (chunked, ``non_blocking``,
    an event waited on before each chunk's host read), else a pageable
    copy; a CPU tensor is cloned."""
    if t.device.type != "cuda":
        return t.detach().clone().numpy()
    from spark_rapids_tpu_torch.runtime.host_alloc import PinnedMemoryPool
    t = t.contiguous()
    out = torch.empty(t.shape, dtype=t.dtype)
    pool = PinnedMemoryPool.get()
    nbytes = t.numel() * t.element_size()
    bufs = []
    if pool is not None and nbytes:
        for _ in range(2):
            b = pool.acquire(min(nbytes, pool.buffer_bytes))
            if b is not None:
                bufs.append(b)
    if not bufs:
        out.copy_(t)
        return out.numpy()
    try:
        src, dst = _byte_view(t), _byte_view(out)
        step = bufs[0].numel()
        pending = []  # (event, buffer, start, length)
        for i, a in enumerate(range(0, nbytes, step)):
            n = min(step, nbytes - a)
            buf = bufs[i % len(bufs)]
            if len(pending) == len(bufs):
                ev, pb, pa, pn = pending.pop(0)
                ev.synchronize()
                dst[pa:pa + pn].copy_(pb[:pn])
            buf[:n].copy_(src[a:a + n], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            pending.append((ev, buf, a, n))
        for ev, pb, pa, pn in pending:
            ev.synchronize()
            dst[pa:pa + pn].copy_(pb[:pn])
    finally:
        for b in bufs:
            pool.release(b)
    return out.numpy()


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``. To a CUDA device the bytes go through the
    pinned pool's buffers when one is free (each chunk copied into a
    pinned buffer, then uploaded ``non_blocking``; a buffer is reused
    only after its upload's event), else a pageable copy."""
    if not a.flags["C_CONTIGUOUS"]:
        a = np.ascontiguousarray(a)
    src = torch.from_numpy(a)
    if device.type != "cuda":
        return src.clone()
    from spark_rapids_tpu_torch.runtime.host_alloc import PinnedMemoryPool
    out = torch.empty(src.shape, dtype=src.dtype, device=device)
    pool = PinnedMemoryPool.get()
    nbytes = src.numel() * src.element_size()
    bufs = []
    if pool is not None and nbytes:
        for _ in range(2):
            b = pool.acquire(min(nbytes, pool.buffer_bytes))
            if b is not None:
                bufs.append(b)
    if not bufs:
        out.copy_(src)
        return out
    try:
        s, d = _byte_view(src), _byte_view(out)
        step = bufs[0].numel()
        events = [None] * len(bufs)
        for i, lo in enumerate(range(0, nbytes, step)):
            n = min(step, nbytes - lo)
            j = i % len(bufs)
            if events[j] is not None:
                events[j].synchronize()
            bufs[j][:n].copy_(s[lo:lo + n])
            d[lo:lo + n].copy_(bufs[j][:n], non_blocking=True)
            events[j] = torch.cuda.Event()
            events[j].record()
        for ev in events:
            if ev is not None:
                ev.synchronize()
    finally:
        for b in bufs:
            pool.release(b)
    return out


def _map_data(data, fn):
    """``fn`` of a column's data tensor, or of each buffer of a nested
    holder (the same holder over the results)."""
    from spark_rapids_tpu_torch.columnar.nested import NestedData
    if isinstance(data, NestedData):
        return data.map(fn)
    return fn(data)


class _RawSpill:
    """Raw-buffer host copy of a spilled DeviceTable: the exact device
    arrays as numpy, no decode and re-encode (a round trip through a
    HostTable would compact a masked batch and change the accumulation
    order of a kernel replaying over it)."""

    __slots__ = ("names", "cols", "live", "nrows", "nrows_known",
                 "capacity", "split_group")

    def __init__(self, names, cols, live, nrows, nrows_known, capacity,
                 split_group):
        self.names = names
        #: [(dtype, data, validity, dictionary, dict_sorted, domain)]
        self.cols = cols
        self.live = live
        self.nrows = nrows
        self.nrows_known = nrows_known
        self.capacity = capacity
        self.split_group = split_group

    def nbytes(self) -> int:
        total = 0 if self.live is None else self.live.nbytes
        for _dt, data, validity, _d, _s, _dom in self.cols:
            total += data.nbytes + validity.nbytes
        return total

    def to_device(self, device: torch.device) -> DeviceTable:
        cols = [DeviceColumn(dt, _map_data(data, lambda a: host_to_device(
                                 a, device)),
                             host_to_device(validity, device),
                             dictionary=dictionary, dict_sorted=srt,
                             domain=domain)
                for dt, data, validity, dictionary, srt, domain
                in self.cols]
        live = None if self.live is None else host_to_device(self.live,
                                                             device)
        if self.nrows_known:
            nrows = int(self.nrows)
        else:
            nrows = host_to_device(np.asarray(self.nrows, dtype=np.int32),
                                   device)
        out = DeviceTable(self.names, cols, nrows, self.capacity, device,
                          live=live)
        if not self.nrows_known:
            out._nrows_host = None
        out.split_group = self.split_group
        return out

    def to_host_table(self):
        """The table's live rows as a HostTable, decoded from the raw
        buffers on the host (no device work): a masked batch keeps the
        rows its ``live`` mask marks, a prefix batch its first rows."""
        from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
        from spark_rapids_tpu_torch.columnar.nested import (
            NestedData,
            element_total,
        )
        if self.live is not None:
            rows = np.flatnonzero(self.live)
        else:
            rows = np.arange(int(self.nrows))
        cols = []
        for dt, data, validity, dictionary, srt, domain in self.cols:
            if isinstance(data, NestedData):
                # nested columns live in prefix batches only
                n = len(rows)
                total = 0 if element_total(data, n) is None else int(
                    element_total(data, n))
                cols.append(HostColumn(dt, data.head(n, total).map(
                    np.ascontiguousarray), np.ascontiguousarray(
                        validity[:n])))
                continue
            proto = DeviceColumn(dt, None, None, dictionary=dictionary,
                                 dict_sorted=srt, domain=domain)
            cols.append(proto.decode_host(
                data[rows], np.ascontiguousarray(validity[rows])))
        return HostTable(self.names, cols)

    @staticmethod
    def from_device(table: DeviceTable) -> "_RawSpill":
        cols = [(c.dtype, _map_data(c.data, device_to_host),
                 device_to_host(c.validity),
                 c.dictionary, c.dict_sorted, c.domain)
                for c in table.columns]
        live = None if table.live is None else device_to_host(table.live)
        known = table._nrows_host is not None
        nrows = (table._nrows_host if known
                 else device_to_host(table.nrows_dev))
        return _RawSpill(table.names, cols, live, nrows, known,
                         table.capacity, table.split_group)


def _host_alloc(nbytes: int):
    """A grant of ``nbytes`` of host memory for a spill's host copy
    (``spark.rapids.memory.host.limit``): past the limit the host arbiter
    first moves the catalog's host tier to disk, then waits, then raises
    CpuRetryOOM, which the retry framework handles like a device OOM."""
    from spark_rapids_tpu_torch.runtime.host_alloc import HostMemoryArbiter
    return HostMemoryArbiter.get().alloc(nbytes)


def _check_spill_crc(frame: bytes):
    """Split a disk spill frame into (body, crc_ok)."""
    if len(frame) < _CRC_LEN:
        return b"", False
    body, footer = frame[:-_CRC_LEN], frame[-_CRC_LEN:]
    return body, struct.pack("<I", zlib.crc32(body)) == footer


# Spill priorities (reference: SpillPriorities.scala): lower value spills
# first. Inputs buffered for later re-reads spill before active ones.
PRIORITY_INPUT = 0
PRIORITY_SHUFFLE = 10
PRIORITY_ACTIVE = 100


class SpillableBatch:
    """Handle that makes a batch spillable while not actively in use.

    ``get()`` brings it back to the device (unspill) and returns the
    DeviceTable; ``release()`` unregisters it from the catalog."""

    _ids = itertools.count()

    def __init__(self, table: DeviceTable, catalog: "BufferCatalog",
                 priority: int = PRIORITY_INPUT):
        self.id = next(SpillableBatch._ids)
        self.priority = priority
        self.catalog = catalog
        self.device = table.device
        self._device: Optional[DeviceTable] = table
        self._host: Optional[_RawSpill] = None
        self._disk_path: Optional[str] = None
        self._split_group = table.split_group
        self._device_bytes = table.device_nbytes()
        # the arbiter accounts every spillable's resident table (kernel
        # outputs registered here never went through a landing); a spill
        # drops the reference, which releases the bytes
        from spark_rapids_tpu_torch.runtime.memory import MEMORY
        MEMORY.account(table)
        self._host_bytes = 0
        #: the host arbiter's grant for the host copy (runtime/host_alloc)
        self._host_grant = None
        self._lock = ordered_rlock("spill.batch")
        self._pinned = 0
        self.last_touch = time.monotonic()
        catalog.register(self)

    # -- state (lock-free reads: the catalog's spill walk reads them while
    # other threads hold batch locks mid-unspill; a stale read costs at
    # most a wasted spill attempt, which re-checks under a non-blocking
    # acquire) --------------------------------------------------------------
    @property
    def tier(self) -> str:
        if self._device is not None:
            return TIER_DEVICE
        if self._host is not None:
            return TIER_HOST
        return TIER_DISK

    @property
    def device_bytes(self) -> int:
        return self._device_bytes if self._device is not None else 0

    @property
    def host_bytes(self) -> int:
        return self._host_bytes if self._host is not None else 0

    # -- access -------------------------------------------------------------
    def get(self) -> DeviceTable:
        """The table on the device (unspilling as needed); touches the
        LRU order."""
        from spark_rapids_tpu_torch.runtime.memory import MEMORY
        with self._lock:
            self.last_touch = time.monotonic()
            if self._device is None:
                # pinned across the rebuild: accounting the landing may
                # run a spill pass, which must not demote THIS batch
                self._pinned += 1
                try:
                    payload = self._ensure_host_locked()
                    dt = payload.to_device(self.device)
                    dt.split_group = self._split_group
                    MEMORY.account(dt)
                    self._device = dt
                    self._device_bytes = dt.device_nbytes()
                    self._drop_host_locked()
                    self.catalog.on_unspill(self)
                finally:
                    self._pinned -= 1
            return self._device

    def get_host(self):
        """The batch as a HostTable without bringing a spilled payload
        back to the device (a resident one downloads)."""
        with self._lock:
            if self._device is not None:
                return self._device.to_host()
            return self._ensure_host_locked().to_host_table()

    def _ensure_host_locked(self) -> _RawSpill:
        if self._host is None:
            if self._disk_path is None:
                raise ColumnarProcessingError(
                    "spillable batch lost all tiers")
            with open(self._disk_path, "rb") as f:
                frame = f.read()
            # an injected corruption flips frame bytes before the CRC
            # check, as bit rot or a torn write would (under the batch's
            # lock, the region a real unspill runs in)
            frame = fault_point("mem.unspill", data=frame)
            grant = _host_alloc(len(frame))
            body, crc_ok = _check_spill_crc(frame)
            path = self._disk_path
            os.unlink(path)
            self.catalog._untrack_disk_file(path)
            self._disk_path = None
            if not crc_ok:
                # the corrupt frame is dropped, never unpickled
                self.catalog._metrics.add("spillCorruptions", 1)
                from spark_rapids_tpu_torch.runtime.memory import MEM_SCOPE
                MEM_SCOPE.add("spillCorruptions", 1)
                grant.release()
                raise SpillCorruptionError(
                    f"disk spill frame {os.path.basename(path)} failed its "
                    "CRC footer on unspill; the corrupt bytes were dropped")
            try:
                self._host = pickle.loads(body)
            except BaseException:
                grant.release()
                raise
            self._host_grant = grant
            # the split token is an identity: the unpickled copy is not it
            self._host.split_group = self._split_group
            self._host_bytes = self._host.nbytes()
        return self._host

    def _drop_host_locked(self) -> None:
        """Drop the host copy and return its bytes to the host arbiter."""
        self._host = None
        self._host_bytes = 0
        if self._host_grant is not None:
            self._host_grant.release()
            self._host_grant = None

    def pin(self):
        """While pinned the catalog does not spill this batch."""
        with self._lock:
            self._pinned += 1

    def unpin(self):
        with self._lock:
            self._pinned -= 1

    @property
    def pinned(self) -> bool:
        return self._pinned > 0

    # -- demotion -----------------------------------------------------------
    def spill_to_host(self) -> int:
        """DEVICE -> HOST; returns device bytes freed. Non-blocking on the
        batch lock: a batch another thread is using is not idle."""
        if not self._lock.acquire(blocking=False):
            return 0
        try:
            if self._device is None or self._pinned:
                return 0
            # the spill-failure injection ('crash'), under the batch's
            # lock: the demotion dies and the buffer stays on the device
            fault_point("mem.spill")
            freed = self._device_bytes
            live = self._device.live
            grant = _host_alloc(
                freed + (0 if live is None else live.nbytes))
            try:
                self._host = _RawSpill.from_device(self._device)
            except BaseException:
                grant.release()
                raise
            self._host_grant = grant
            self._host_bytes = self._host.nbytes()
            self._device = None
            self._device_bytes = 0
            return freed
        finally:
            self._lock.release()

    def spill_to_disk(self) -> int:
        """HOST -> DISK; returns host bytes freed. Non-blocking on the
        batch lock like :meth:`spill_to_host`."""
        if not self._lock.acquire(blocking=False):
            return 0
        try:
            if self._host is None or self._pinned:
                return 0
            freed = self._host_bytes
            # the pid in the name: the exit sweep removes this process's
            # files only
            fd, path = tempfile.mkstemp(
                prefix=f"rapids_torch_spill_{os.getpid()}_{self.id}_",
                suffix=".bin", dir=self.catalog.disk_dir)
            body = pickle.dumps(self._host, protocol=pickle.HIGHEST_PROTOCOL)
            with os.fdopen(fd, "wb") as f:
                f.write(body + struct.pack("<I", zlib.crc32(body)))
            self._disk_path = path
            self.catalog._track_disk_file(path)
            self._drop_host_locked()
            return freed
        finally:
            self._lock.release()

    def release(self):
        with self._lock:
            self.catalog.unregister(self)
            self._device = None
            self._drop_host_locked()
            if self._disk_path:
                self.catalog._untrack_disk_file(self._disk_path)
                if os.path.exists(self._disk_path):
                    os.unlink(self._disk_path)
            self._disk_path = None

    def pinned_batch(self) -> "_PinnedBatch":
        """``with sb.pinned_batch() as dt:`` the table, pinned while the
        block runs."""
        return _PinnedBatch(self)


class _PinnedBatch:
    """The context manager of :meth:`SpillableBatch.pinned_batch`."""

    __slots__ = ("sb",)

    def __init__(self, sb: SpillableBatch):
        self.sb = sb

    def __enter__(self) -> DeviceTable:
        self.sb.pin()
        try:
            return self.sb.get()
        except BaseException:
            self.sb.unpin()
            raise

    def __exit__(self, *exc):
        self.sb.unpin()
        return False


#: the operator-facing name (the join build and the aggregate partials)
SpillableDeviceTable = SpillableBatch


class BufferCatalog:
    """Central registry of spillables across tiers (RapidsBufferCatalog
    analog). ``synchronous_spill`` demotes the lowest-priority, least
    recently used device buffers until the byte target frees."""

    _instance: Optional["BufferCatalog"] = None
    _instance_lock = ordered_lock("spill.catalog.instance")

    _SCOPE_KEYS = {"spill_device_count": "spillDeviceCount",
                   "spill_disk_count": "spillDiskCount",
                   "device_spilled_bytes": "spillDeviceBytes",
                   "disk_spilled_bytes": "spillDiskBytes"}

    #: every catalog constructed (weak), for the exit sweep of disk files
    _all_catalogs: "weakref.WeakSet" = weakref.WeakSet()
    _all_catalogs_lock = ordered_lock("spill.catalog.registry")

    def __init__(self, host_limit_bytes: int = 2 << 30,
                 disk_dir: Optional[str] = None):
        self._lock = ordered_rlock("spill.catalog")
        self._buffers: Dict[int, SpillableBatch] = {}
        self.host_limit_bytes = host_limit_bytes
        self.disk_dir = disk_dir
        self._metrics = metric_scope("spill")
        self._disk_files: set = set()
        self.spill_device_count = 0
        self.spill_disk_count = 0
        self.device_spilled_bytes = 0
        self.disk_spilled_bytes = 0
        with BufferCatalog._all_catalogs_lock:
            BufferCatalog._all_catalogs.add(self)

    def _bump(self, attr: str, n) -> None:
        with self._lock:
            setattr(self, attr, getattr(self, attr) + n)
        self._metrics.add(self._SCOPE_KEYS[attr], n)
        if attr == "device_spilled_bytes":
            from spark_rapids_tpu_torch.runtime.memory import MEM_SCOPE
            MEM_SCOPE.add("spillBytes", n)

    def _track_disk_file(self, path: str) -> None:
        with self._lock:
            self._disk_files.add(path)

    def _untrack_disk_file(self, path: str) -> None:
        with self._lock:
            self._disk_files.discard(path)

    @classmethod
    def get(cls) -> "BufferCatalog":
        if cls._instance is None:
            with cls._instance_lock:
                if cls._instance is None:
                    cls._instance = BufferCatalog()
        return cls._instance

    @classmethod
    def reset(cls, host_limit_bytes: int = 2 << 30, disk_dir=None):
        with cls._instance_lock:
            cls._instance = BufferCatalog(host_limit_bytes, disk_dir)
            return cls._instance

    def register(self, sb: SpillableBatch):
        with self._lock:
            self._buffers[sb.id] = sb

    def unregister(self, sb: SpillableBatch):
        with self._lock:
            self._buffers.pop(sb.id, None)

    def on_unspill(self, sb: SpillableBatch):
        from spark_rapids_tpu_torch.runtime.memory import MEM_SCOPE
        MEM_SCOPE.add("unspills", 1)

    # -- accounting ---------------------------------------------------------
    def device_bytes(self) -> int:
        """Device-resident bytes of the registered batches (the service's
        admission gate reads it beside the arbiter's ledger)."""
        with self._lock:
            return sum(b.device_bytes for b in self._buffers.values())

    def host_bytes(self) -> int:
        with self._lock:
            return sum(b.host_bytes for b in self._buffers.values())

    def buffers(self) -> List[SpillableBatch]:
        with self._lock:
            return list(self._buffers.values())

    def _spill_order(self) -> List[SpillableBatch]:
        return sorted(self.buffers(),
                      key=lambda b: (b.priority, b.last_touch))

    # -- the demotion chain -------------------------------------------------
    def synchronous_spill(self, target_bytes: int) -> int:
        """Free at least ``target_bytes`` of device memory by demoting
        device -> host (then host -> disk past the host tier's limit).
        Returns bytes freed (reference: synchronousSpill)."""
        freed = 0
        t0 = time.monotonic()
        for sb in self._spill_order():
            if freed >= target_bytes:
                break
            if sb.tier == TIER_DEVICE and not sb.pinned:
                got = sb.spill_to_host()
                if got:
                    freed += got
                    self._bump("spill_device_count", 1)
                    self._bump("device_spilled_bytes", got)
        self._enforce_host_limit()
        if freed:
            self._metrics.add("spillTime", time.monotonic() - t0)
        return freed

    def _enforce_host_limit(self):
        if self.host_bytes() <= self.host_limit_bytes:
            return
        for sb in self._spill_order():
            if sb.tier == TIER_HOST and not sb.pinned:
                got = sb.spill_to_disk()
                if got:
                    self._bump("spill_disk_count", 1)
                    self._bump("disk_spilled_bytes", got)
            if self.host_bytes() <= self.host_limit_bytes:
                break

    def spill_all_device(self) -> int:
        return self.synchronous_spill(1 << 62)

    def spill_host_to_disk(self) -> int:
        """Demote the whole host tier to disk (the host arbiter's hook);
        returns host bytes freed."""
        freed = 0
        t0 = time.monotonic()
        for sb in self._spill_order():
            if sb.tier == TIER_HOST and not sb.pinned:
                got = sb.spill_to_disk()
                if got:
                    freed += got
                    self._bump("spill_disk_count", 1)
                    self._bump("disk_spilled_bytes", got)
        if freed:
            self._metrics.add("spillTime", time.monotonic() - t0)
        return freed

    # -- teardown -----------------------------------------------------------
    def shutdown(self) -> int:
        """Release every registered spillable and remove the disk files
        this catalog wrote. Returns files removed."""
        for sb in self.buffers():
            sb.release()
        return self._sweep_disk_files(prefix_sweep=False)

    def _sweep_disk_files(self, prefix_sweep: bool = False) -> int:
        with self._lock:
            paths = list(self._disk_files)
            self._disk_files.clear()
            disk_dir = self.disk_dir
        if prefix_sweep and disk_dir:
            paths.extend(glob.glob(os.path.join(
                disk_dir, f"rapids_torch_spill_{os.getpid()}_*.bin")))
        removed = 0
        for p in set(paths):
            try:
                os.unlink(p)
                removed += 1
            except OSError:
                pass
        return removed


@atexit.register
def _atexit_spill_sweep() -> None:
    """Remove whatever disk-tier files survive at process exit."""
    with BufferCatalog._all_catalogs_lock:
        catalogs = list(BufferCatalog._all_catalogs)
    for cat in catalogs:
        try:
            cat._sweep_disk_files(prefix_sweep=True)
        except Exception:
            pass  # exit paths never raise
