"""Device memory arbiter: out-of-core execution under a hard device budget
(port of ``spark_rapids_tpu/runtime/memory.py``).

spark-rapids enforces its budget at the allocator (RMM's pool sized to
``spark.rapids.memory.gpu.allocFraction``); here, as in the JAX package,
another allocator owns the card (torch's caching allocator), so the
budget is an engine-side ledger one layer up. Every device LANDING (a
scan's column upload, ``upload_host_table``) and every registered
spillable is accounted against a conf-driven byte budget:

* **reserve -> land -> account**: a landing reserves its ESTIMATED bytes
  first, spilling idle spillables and evicting the scan's device cache
  when the reservation would cross the budget, and raises
  :class:`RetryOOM` into the retry framework when spilling cannot make
  room; the landed object is then accounted at its ACTUAL bytes for as
  long as it lives (a weak reference's callback releases them).
* **storage, not views**: the ledger counts each torch STORAGE once,
  however many accounted tables or columns hold it. The masked views of
  one exchange split (``DeviceTable.split_group``) share their buffers; a
  ledger by view would count one split k times and raise where the
  reference does not.
* **chunked scans**: :func:`scan_chunks` bounds one scan batch to
  ``spark.rapids.memory.device.scanChunkFraction`` of the budget.
* **zero violations**: an account that still exceeds the budget after a
  synchronous spill pass counts ``budgetViolations``.

One ordering differs from the reference: ``account`` makes room BEFORE it
adds bytes that would cross the budget (a kernel output registered as a
spillable has no reservation), so the peak never includes an excess that
the spill pass then removes; the violations and the spills are the
reference's.
"""

from __future__ import annotations

import contextlib
import contextvars
import weakref
from typing import Dict, Optional

from spark_rapids_tpu_torch.conf import (
    DEVICE_BUDGET_BYTES,
    DEVICE_SCAN_CHUNK_FRACTION,
)
from spark_rapids_tpu_torch.errors import RetryOOM
from spark_rapids_tpu_torch.lockorder import ordered_rlock
from spark_rapids_tpu_torch.obs.metrics import metric_scope, register_metric

register_metric("oomRetries", "count", "ESSENTIAL",
                "spill-and-replay retries the OOM retry framework "
                "performed (RetryOOM survived: injected or real)")
register_metric("splitRetries", "count", "ESSENTIAL",
                "split-and-retry escalations: an input batch halved by "
                "rows and both halves replayed")
register_metric("spillBytes", "bytes", "ESSENTIAL",
                "device bytes freed by spill demotions")
register_metric("unspills", "count", "ESSENTIAL",
                "spilled batches brought back to the device")
register_metric("spillCorruptions", "count", "ESSENTIAL",
                "disk-tier spill frames whose CRC footer failed on "
                "unspill")
register_metric("scanChunks", "count", "MODERATE",
                "bounded partitions chunked scans landed in place of "
                "over-budget single batches")
register_metric("arbiterSpills", "count", "MODERATE",
                "synchronous spill passes the memory arbiter ran to fit a "
                "reservation under the device budget")
register_metric("budgetRaises", "count", "MODERATE",
                "reservations the arbiter refused with RetryOOM after "
                "spilling could not make room")
register_metric("budgetViolations", "count", "ESSENTIAL",
                "accounted landings that exceeded the device budget even "
                "after a synchronous spill pass")

#: the process-wide ``memory`` scope (retry.py and spill.py add to it)
MEM_SCOPE = metric_scope("memory")

_FORCED_CHUNK_BYTES: contextvars.ContextVar[Optional[int]] = \
    contextvars.ContextVar("rapids_torch_forced_chunk_bytes", default=None)


@contextlib.contextmanager
def forced_chunking(nbytes: int):
    """Chunk every scan of this thread to at most ``nbytes`` of estimated
    device memory while the block runs."""
    token = _FORCED_CHUNK_BYTES.set(max(1, int(nbytes)))
    try:
        yield
    finally:
        _FORCED_CHUNK_BYTES.reset(token)


def forced_chunk_bytes() -> Optional[int]:
    return _FORCED_CHUNK_BYTES.get()


def _device_row_bytes(dtype) -> int:
    """Device bytes of one row of ``dtype`` in the port's layout: the
    data word plus a validity byte. Strings land as int32 dictionary
    codes, DECIMAL128 as a (capacity, 2) int64 limb pair, everything else
    as its numpy storage type. This agrees with the reference's table for
    every flat type (its TPU split of doubles into two f32 words is still
    8 bytes a row); an array, struct or map column takes the reference's
    8 + 1 (its row's offset or field words; a landing adds its host
    elements' bytes, ``DeviceColumn.from_host``)."""
    from spark_rapids_tpu_torch import types as T
    if isinstance(dtype, (T.ArrayType, T.StructType, T.MapType)):
        return 8 + 1
    if isinstance(dtype, T.StringType):
        return 4 + 1
    if T.is_dec128(dtype):
        return 16 + 1
    return int(dtype.np_dtype.itemsize) + 1


def estimate_device_nbytes(host, capacity: Optional[int] = None) -> int:
    """Estimated device bytes of a HostTable landed at ``capacity`` (its
    rows' bucket when None)."""
    if not host.columns:
        return 0
    if capacity is None:
        from spark_rapids_tpu_torch.columnar.column import bucket_for
        capacity = bucket_for(max(host.num_rows, 1))
    return sum(_device_row_bytes(c.dtype) for c in host.columns) * capacity


def _column_storages(c) -> tuple:
    """A DeviceColumn's (storage key, bytes) pairs, cached on it (its
    tensors never change): every buffer of its data (a nested column's
    offsets, elements and element validity each once) and its
    validity."""
    m = c.storages
    if m is None:
        dev = c.validity.device
        out = []
        for t in c.leaves() + (c.validity,):
            st = t.untyped_storage()
            out.append(((dev, st.data_ptr()), st.nbytes()))
        m = c.storages = tuple(out)
    return m


def tensor_storages(obj) -> Dict[tuple, int]:
    """{storage key: storage bytes} of a DeviceTable's or a DeviceColumn's
    data and validity tensors, from tensor metadata only (no device
    work). A view's key is its base storage's, so views of one buffer
    share one entry."""
    out: Dict[tuple, int] = {}
    for c in (obj.columns if hasattr(obj, "columns") else (obj,)):
        out.update(_column_storages(c))
    return out


class MemoryReservation:
    """Short-lived grant covering one landing: ``MEMORY.account(obj,
    reservation)`` converts it into ledger bytes; ``release()`` returns
    the estimate (the landing failed)."""

    __slots__ = ("arbiter", "nbytes", "_done")

    def __init__(self, arbiter: "MemoryArbiter", nbytes: int):
        self.arbiter = arbiter
        self.nbytes = int(nbytes)
        self._done = False

    def release(self) -> None:
        if not self._done:
            self._done = True
            self.arbiter._release_reserved(self.nbytes)


class MemoryArbiter:
    """Process-wide device-byte budget and landing ledger. Occupancy is
    the reserved bytes plus the bytes of every storage a live accounted
    object holds."""

    def __init__(self):
        # reentrant: a table's release (``_drop``) runs wherever the
        # garbage collector frees it, and that may be inside this very
        # lock on the same thread (a collection triggered by an
        # allocation in ``account``)
        self._lock = ordered_rlock("memory.arbiter")
        self._cfg = None
        self._budget = 0
        self._chunk_fraction = float(DEVICE_SCAN_CHUNK_FRACTION.default)
        self._reserved = 0
        #: token -> (the storage keys of one accounted object, the weak
        #: reference whose callback drops them)
        self._ledger: Dict[int, tuple] = {}
        #: storage key -> [bytes, live accounted objects holding it]
        self._storages: Dict[tuple, list] = {}
        self._ledger_total = 0
        self._by_obj_id: Dict[int, int] = {}
        self._next_token = 0
        self._peak = 0
        self._violations = 0
        self._metrics = MEM_SCOPE

    # -- configuration -------------------------------------------------------
    def configure(self, conf) -> None:
        """Cheap when unchanged; the session calls it per query."""
        budget = int(conf.get_entry(DEVICE_BUDGET_BYTES))
        fraction = float(conf.get_entry(DEVICE_SCAN_CHUNK_FRACTION))
        key = (budget, fraction)
        with self._lock:
            if key == self._cfg:
                return
            self._cfg = key
            self._budget = budget if budget > 0 else self._backend_budget()
            self._chunk_fraction = min(max(fraction, 0.001), 1.0)

    @staticmethod
    def _backend_budget() -> int:
        """The device manager's budget; the reference's default when no
        manager has started (or it runs on the CPU)."""
        from spark_rapids_tpu_torch.runtime.device_manager import (
            _DEFAULT_HBM_BYTES,
            TpuDeviceManager,
        )
        mgr = TpuDeviceManager.current()
        if mgr is not None and mgr.info is not None:
            return int(mgr.info.hbm_limit_bytes)
        return int(_DEFAULT_HBM_BYTES)

    def budget_bytes(self) -> int:
        with self._lock:
            if self._budget <= 0:
                self._budget = self._backend_budget()
            return self._budget

    def scan_chunk_bytes(self) -> int:
        """The largest estimated device size one scan batch may land as:
        the forced override of this thread, else budget x
        scanChunkFraction."""
        forced = _FORCED_CHUNK_BYTES.get()
        if forced is not None:
            return forced
        budget = self.budget_bytes()
        with self._lock:
            return max(1, int(budget * self._chunk_fraction))

    # -- accounting ----------------------------------------------------------
    def occupancy(self) -> int:
        """Reserved plus ledger bytes: what the service's admission gate
        and its DEGRADED check read (never the caching allocator's
        ``memory_reserved``, which keeps freed blocks)."""
        with self._lock:
            return self._reserved + self._ledger_total

    def _note_peak_locked(self) -> None:
        occ = self._reserved + self._ledger_total
        if occ > self._peak:
            self._peak = occ

    def _release_reserved(self, nbytes: int) -> None:
        with self._lock:
            self._reserved -= nbytes

    def _drop(self, token: int, obj_id: int) -> None:
        with self._lock:
            keys, _ = self._ledger.pop(token, ((), None))
            for key in keys:
                ent = self._storages.get(key)
                if ent is None:
                    continue
                ent[1] -= 1
                if ent[1] <= 0:
                    del self._storages[key]
                    self._ledger_total -= ent[0]
            if self._by_obj_id.get(obj_id) == token:
                self._by_obj_id.pop(obj_id, None)

    def _spill_for(self, need: int) -> int:
        """One synchronous make-room pass: the scan's device cache first,
        then idle spillables through the catalog tiers. Returns catalog
        bytes freed (cache evictions release through their weak
        references' callbacks)."""
        from spark_rapids_tpu_torch.columnar.table import evict_device_caches
        from spark_rapids_tpu_torch.runtime.spill import BufferCatalog
        self._metrics.add("arbiterSpills", 1)
        evict_device_caches()
        return BufferCatalog.get().synchronous_spill(max(need, 1))

    def reserve(self, nbytes: int, label: str = "") -> MemoryReservation:
        """Grant ``nbytes`` of device budget for an imminent landing.
        Over budget: spill idle catalog entries; still over: raise
        RetryOOM (the retry framework spills more and replays, then
        splits, then the memory ladder takes the attempt)."""
        from spark_rapids_tpu_torch.runtime.faults import fault_point
        fault_point("mem.reserve", op=label or None)
        nbytes = max(0, int(nbytes))
        budget = self.budget_bytes()
        with self._lock:
            occ = self._reserved + self._ledger_total
            if occ + nbytes <= budget:
                self._reserved += nbytes
                self._note_peak_locked()
                return MemoryReservation(self, nbytes)
        self._spill_for(occ + nbytes - budget)
        with self._lock:
            occ = self._reserved + self._ledger_total
            if occ + nbytes <= budget:
                self._reserved += nbytes
                self._note_peak_locked()
                return MemoryReservation(self, nbytes)
        self._metrics.add("budgetRaises", 1)
        raise RetryOOM(
            f"device budget exhausted: want {nbytes}B"
            + (f" for {label}" if label else "")
            + f", {occ}/{budget}B accounted; spilling freed no room")

    def _new_bytes_locked(self, storages) -> int:
        return sum(n for key, n in storages.items()
                   if key not in self._storages)

    def account(self, obj, reservation: Optional[MemoryReservation] = None):
        """Record one live DeviceTable or DeviceColumn against the budget
        (the bytes of the storages no other accounted object holds yet;
        released by a weak reference's callback when the object dies).
        Consumes ``reservation``; when the new bytes would cross the
        budget, a spill pass makes room before they are added. An account
        that still exceeds the budget after a spill pass counts a
        violation. Returns ``obj``."""
        if reservation is not None:
            reservation.release()
        storages = tensor_storages(obj)
        budget = None
        with self._lock:
            if id(obj) in self._by_obj_id:
                return obj  # already accounted (a cache re-serve)
            budget = self._budget if self._budget > 0 else None
            if budget is None or (self._reserved + self._ledger_total
                                  + self._new_bytes_locked(storages)
                                  <= budget):
                # the common case: one pass under the lock
                self._add_locked(obj, storages)
                return obj
            need = (self._reserved + self._ledger_total
                    + self._new_bytes_locked(storages) - budget)
        self._spill_for(need)
        with self._lock:
            self._add_locked(obj, storages)
            occ = self._reserved + self._ledger_total
        if occ > budget:
            self._spill_for(occ - budget)
            with self._lock:
                occ = self._reserved + self._ledger_total
                if occ > budget:
                    self._violations += 1
                    self._metrics.add("budgetViolations", 1)
        return obj

    def _add_locked(self, obj, storages) -> None:
        self._next_token += 1
        token = self._next_token
        for key, n in storages.items():
            ent = self._storages.get(key)
            if ent is None:
                self._storages[key] = [n, 1]
                self._ledger_total += n
            else:
                ent[1] += 1
        # a weak reference whose callback releases the bytes when the
        # object dies (cheaper than a weakref.finalize per batch); the
        # ledger keeps it alive
        ref = weakref.ref(obj, lambda _r, t=token, i=id(obj):
                          self._drop(t, i))
        self._ledger[token] = (storages, ref)
        self._by_obj_id[id(obj)] = token
        self._note_peak_locked()

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> dict:
        budget = self.budget_bytes()
        with self._lock:
            ledger = self._ledger_total
            return {
                "budgetBytes": budget,
                "occupancyBytes": self._reserved + ledger,
                "ledgerBytes": ledger,
                "reservedBytes": self._reserved,
                "peakBytes": self._peak,
                "accountedTables": len(self._ledger),
                "budgetViolations": self._violations,
            }

    def peak_bytes(self) -> int:
        with self._lock:
            return self._peak

    def reset_peak(self) -> None:
        """Start a new peak at the current occupancy (the session calls
        it at each query's start, so ``peak_bytes`` is the query's)."""
        with self._lock:
            self._peak = self._reserved + self._ledger_total

    def reset(self) -> None:
        """Test support: drop the ledger and the peak and force a
        reconfigure. The dropped entries' callbacks go with them."""
        with self._lock:
            self._cfg = None
            self._budget = 0
            self._reserved = 0
            self._ledger = {}
            self._storages = {}
            self._ledger_total = 0
            self._by_obj_id = {}
            self._peak = 0
            self._violations = 0


MEMORY = MemoryArbiter()


def scan_chunks(host) -> list:
    """Split one scan host batch into bounded partitions so that no
    landing exceeds its device-budget share (the chunked out-of-core
    scan). Returns ``[host]`` when the batch fits. Chunk rows align down
    to a capacity bucket, so a concatenation of the chunks re-buckets to
    about the unchunked capacity."""
    from spark_rapids_tpu_torch.columnar.column import MIN_BUCKET, bucket_for
    limit = MEMORY.scan_chunk_bytes()
    n = host.num_rows
    if n <= MIN_BUCKET or not host.columns:
        return [host]
    cap = bucket_for(n)
    est = estimate_device_nbytes(host, cap)
    if est <= limit:
        return [host]
    per_row = max(est / cap, 1e-9)
    rows = max(MIN_BUCKET, int(limit / per_row))
    bucket = MIN_BUCKET
    while bucket * 2 <= rows:
        bucket *= 2
    rows = bucket
    chunks = [host.slice(i, min(rows, n - i)) for i in range(0, n, rows)]
    MEM_SCOPE.add("scanChunks", len(chunks))
    return chunks
