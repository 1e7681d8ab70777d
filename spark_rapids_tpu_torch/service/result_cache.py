"""Plan-fingerprint result cache (port of
``spark_rapids_tpu/service/result_cache.py``).

Spark's ``CACHE TABLE`` caches the INPUT of a query; a serving layer wants
to cache its OUTPUT, so that the same SQL (or DSL plan) from another
tenant does not run q1 again over an unchanged warehouse. The cache keys
on the plan's canonical structural fingerprint
(``plan/fingerprint.py::fingerprint``: expression trees by their
structural form, in-memory tables by identity, file scans by path list)
with the result-affecting conf folded in, so two structurally identical
queries hit whichever tenant built them.

Correctness over hit rate:

* a plan the fingerprint cannot prove stable (a UDF closure, a
  WriteFiles node) is uncacheable: a miss, never a wrong hit;
* every catalog mutation and every write bumps the process-wide
  invalidation epoch (``bump_invalidation_epoch``); an entry remembers
  the epoch vector (global plus one per table its plan read,
  ``epoch_snapshot(plan_table_ids(plan))``) it was filled under, and a
  stale entry is dropped on lookup, never served;
* the LRU is bounded by ``spark.rapids.service.resultCache.maxBytes`` of
  ``HostTable.nbytes()``.

Hit, miss, eviction and invalidation counters live in the ``resultCache``
metric scope.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from spark_rapids_tpu_torch.lockorder import ordered_lock
from spark_rapids_tpu_torch.obs.metrics import metric_scope, register_metric
from spark_rapids_tpu_torch.plan.fingerprint import (  # noqa: F401
    GLOBAL_EPOCH_KEY,
    bump_invalidation_epoch,
    epoch_snapshot,
    epochs_current,
    fingerprint,
    invalidation_epoch,
    plan_table_ids,
)

register_metric("resultCacheHits", "count", "ESSENTIAL",
                "service queries served from the plan-fingerprint cache")
register_metric("resultCacheMisses", "count", "ESSENTIAL",
                "service queries that executed (fingerprint absent, stale, "
                "or plan uncacheable)")
register_metric("resultCacheEvictions", "count", "ESSENTIAL",
                "entries evicted by the LRU byte bound")
register_metric("resultCacheInvalidations", "count", "ESSENTIAL",
                "stale entries dropped on lookup after an epoch bump")
register_metric("resultCacheBytes", "bytes", "MODERATE",
                "bytes currently held by the result cache")


class _Entry:
    __slots__ = ("table", "nbytes", "epochs", "event_record")

    def __init__(self, table, nbytes: int, epochs: dict, event_record):
        self.table = table
        self.nbytes = nbytes
        #: the epoch VECTOR the result was computed under: stale when any
        #: component moved, so a write to an unrelated table leaves the
        #: entry serving
        self.epochs = epochs
        self.event_record = event_record

    @property
    def epoch(self) -> int:
        """The global component."""
        return self.epochs.get(GLOBAL_EPOCH_KEY, 0)


class ResultCache:
    """LRU HostTable cache bounded by bytes. Thread-safe; an entry filled
    under an older epoch is dropped on lookup."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._lock = ordered_lock("service.result_cache")
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._bytes = 0
        self._metrics = metric_scope("resultCache")
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def _account_miss(self):
        self.misses += 1
        self._metrics.add("resultCacheMisses", 1)

    def get(self, key: Optional[str]):
        """The cached entry (``.table``, ``.event_record``) for ``key``, or
        None. A None key (an uncacheable plan) counts a miss."""
        with self._lock:
            if key is None:
                self._account_miss()
                return None
            e = self._entries.get(key)
            if e is not None and not epochs_current(e.epochs):
                del self._entries[key]
                self._bytes -= e.nbytes
                self._metrics.add("resultCacheBytes", -e.nbytes)
                self.invalidations += 1
                self._metrics.add("resultCacheInvalidations", 1)
                e = None
            if e is None:
                self._account_miss()
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            self._metrics.add("resultCacheHits", 1)
            return e

    def put(self, key: Optional[str], table, event_record=None,
            epochs: Optional[dict] = None) -> bool:
        """Insert a result. ``epochs`` is the epoch vector the result was
        COMPUTED under, taken by the caller before execution (a write that
        landed meanwhile then stales the entry at its first lookup);
        default the current state. A result over ``max_bytes`` is not
        cached. Returns whether it was stored."""
        if key is None or table is None:
            return False
        nbytes = int(table.nbytes())
        if nbytes > self.max_bytes:
            return False
        if epochs is None:
            epochs = epoch_snapshot()
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
                self._metrics.add("resultCacheBytes", -old.nbytes)
            while self._bytes + nbytes > self.max_bytes and self._entries:
                _, victim = self._entries.popitem(last=False)
                self._bytes -= victim.nbytes
                self._metrics.add("resultCacheBytes", -victim.nbytes)
                self.evictions += 1
                self._metrics.add("resultCacheEvictions", 1)
            self._entries[key] = _Entry(table, nbytes, epochs, event_record)
            self._bytes += nbytes
            self._metrics.add("resultCacheBytes", nbytes)
        return True

    def clear(self) -> None:
        with self._lock:
            self._metrics.add("resultCacheBytes", -self._bytes)
            self._entries.clear()
            self._bytes = 0

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def entry_count(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "invalidations": self.invalidations,
                    "entries": len(self._entries), "bytes": self._bytes}
