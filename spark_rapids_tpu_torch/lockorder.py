"""Lock registry, rank hierarchy and opt-in runtime lock witness (port of
``spark_rapids_tpu/lockorder.py``).

The runtime's locks follow one ordering contract, which this module makes
a machine-checked artifact:

* :data:`LOCK_ORDER` — THE single ordered hierarchy. Every
  ``threading.Lock/RLock/Condition/Semaphore`` constructed in the
  concurrent packages (``runtime/``, ``service/``, ``parallel/``,
  ``obs/``, ``io/``, ``columnar/``, ``streaming/``), and every lock built
  through a factory anywhere in the port, is declared here with a NAME, a
  RANK and its construction SITE, and is constructed through the
  :func:`ordered_lock` family, so the declaration cannot drift from the
  object it describes (lint rule RL-LOCK-DECL audits both directions).

* **The ordering contract**: a thread that blocking-acquires lock B while
  holding lock A must have ``rank(A) < rank(B)``: acquisition strictly
  ascends the hierarchy. Non-blocking acquires (``acquire(blocking=
  False)``) are exempt: a try-acquire cannot deadlock, and the spill
  walk relies on exactly that escape. The static half
  (``lint/concurrency.py``, RL-LOCK-ORDER) builds the held->acquired edge
  graph over a bounded call graph; the runtime half is the WITNESS below.

* **Lock witness** (``spark.rapids.lint.lockWitness``, default off): when
  armed, the factories return thin instrumented wrappers that record each
  thread's acquisitions and raise :class:`LockOrderViolation` on a rank
  inversion, or on a blocking re-acquire of a non-reentrant lock the
  thread already holds (a self-deadlock), where the static pass's bounded
  call graph cannot see (dynamic dispatch, callbacks). Arming is a
  CONSTRUCTION-TIME election: locks built while the witness is armed are
  instrumented, locks built before stay raw, so a disarmed process pays
  nothing on any acquire. ``TorchSession`` and ``QueryService`` arm or
  disarm it from their conf (:func:`configure`) before they build their
  own locks.

Names the port shares with the reference keep the reference's rank and
kind, except the entries of :data:`DEVIATIONS`; the port's own locks rank
inside the band where they are taken. ``spark_rapids_tpu_torch/docs/
LOCKS.md`` is generated from this registry (``python -m
spark_rapids_tpu_torch.lint --write-docs``) and drift-checked by the lint
(RA-DOC-DRIFT-LOCKS).
"""

from __future__ import annotations

import threading
import traceback
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.conf import LOCK_WITNESS


class LockOrderViolation(RuntimeError):
    """A thread blocking-acquired a declared lock out of rank order (or
    re-acquired a non-reentrant lock it already holds). Raised by the
    armed witness INSTEAD of deadlocking; carries the held chain."""


class LockDeclError(RuntimeError):
    """A lock factory was called with an undeclared name, or the declared
    kind does not match the requested primitive."""


@dataclass(frozen=True)
class LockDecl:
    """One declared lock: its place in the single total order.

    ``site`` is ``<repo-relative module>:<qualified attribute>``, the one
    construction site RL-LOCK-DECL pins the declaration to
    (``Class._attr`` for instance and class locks, the bare global name
    for module-level locks). ``guards`` documents the state the lock
    protects (LOCKS.md column)."""

    name: str
    rank: int
    site: str
    kind: str  # Lock | RLock | Condition | Semaphore
    guards: str

    @property
    def module(self) -> str:
        return self.site.rsplit(":", 1)[0]

    @property
    def attr(self) -> str:
        """The attribute basename at the construction site."""
        return self.site.rsplit(":", 1)[1].rsplit(".", 1)[-1]


_P = "spark_rapids_tpu_torch/"

#: THE ordered lock hierarchy. Ranks ascend from orchestrators (held
#: longest, acquired first) down to leaf bookkeeping locks (held for a
#: dict update, acquired under everything). Bands of 100 group the
#: layers; gaps leave room to insert without renumbering. A thread holding
#: rank R may blocking-acquire ranks > R only.
_DECLS: Tuple[LockDecl, ...] = (
    # -- streaming drivers (outermost: they submit queries and commits) --
    LockDecl("streaming.query", 100,
             _P + "streaming/query.py:StreamingQuery._lock",
             "Lock", "stream lifecycle: status, trigger thread, last "
                     "batch/offset bookkeeping"),
    LockDecl("streaming.mv.registry", 110,
             _P + "streaming/mv.py:MaterializedViewRegistry._lock",
             "Lock", "registered views + per-table staleness marks"),
    LockDecl("streaming.mv.refresh", 120,
             _P + "streaming/mv.py:MaterializedView._refresh_lock",
             "Lock", "one refresh (incremental or full recompute) at a "
                     "time per view"),
    LockDecl("service.mesh_gate", 150,
             _P + "service/scheduler.py:QueryService._mesh_gate",
             "Lock", "exclusive mesh occupancy: one multi-device launch at "
                     "a time when the service drives a mesh or cluster "
                     "topology; single-device services never construct "
                     "it. Ranks BELOW the service band because it is held "
                     "across the whole launch window, inside which ladder "
                     "incident capture reads scheduler and handle state"),
    # -- query service -------------------------------------------------
    LockDecl("service.scheduler.cond", 200,
             _P + "service/scheduler.py:QueryService._cond",
             "Condition", "queues, WFQ clocks, worker pool, lifecycle "
                          "counters, SLO window, degradation latch: ALL "
                          "scheduler state"),
    LockDecl("service.scheduler.streams", 210,
             _P + "service/scheduler.py:QueryService._streams_lock",
             "Lock", "registered streaming tenants (name -> stream)"),
    LockDecl("service.handle", 220,
             _P + "service/query.py:QueryHandle._lock",
             "Lock", "per-handle state machine + result/error slot (the "
                     "watchdog's _cond -> handle order is the canonical "
                     "ranked pair)"),
    LockDecl("service.handle.seq", 230,
             _P + "service/query.py:QueryHandle._seq_lock",
             "Lock", "process-wide query id sequence"),
    LockDecl("service.result_cache", 240,
             _P + "service/result_cache.py:ResultCache._lock",
             "Lock", "fingerprint -> cached result entries + byte "
                     "accounting"),
    # -- session and plan caches (port only) ---------------------------
    LockDecl("session.obs", 250,
             _P + "session.py:TorchSession._obs_lock",
             "Lock", "one session's observation slot: query sequence, "
                     "event writer, the shared metrics mirror. Above the "
                     "service's mesh gate, which a service worker holds "
                     "while its session executes"),
    LockDecl("executable_cache", 260,
             _P + "plan/executable_cache.py:ExecutableCache._lock",
             "Lock", "fingerprint -> converted executable variants, their "
                     "checkouts and hit/miss counters"),
    LockDecl("fingerprint.epoch", 270,
             _P + "plan/fingerprint.py:_EPOCH_LOCK",
             "Lock", "the invalidation epoch of temp views and tables"),
    LockDecl("fingerprint.table_tokens", 280,
             _P + "plan/fingerprint.py:_TABLE_TOKEN_LOCK",
             "Lock", "host table identity -> stable fingerprint token"),
    # -- cluster runtime ----------------------------------------------
    LockDecl("cluster.runtime", 300,
             _P + "runtime/cluster.py:ClusterRuntime._lock",
             "Lock", "host topology: declared/live/lost/excluded hosts, "
                     "generation"),
    LockDecl("cluster.driver", 310,
             _P + "runtime/cluster.py:ClusterDriver._lock",
             "Lock", "executor registry, beat ledger, data channels"),
    LockDecl("cluster.channel", 320,
             _P + "runtime/cluster.py:_HostChannel.lock",
             "Lock", "one in-flight wire request per host data channel "
                     "(socket send/recv serialized under it BY DESIGN: "
                     "allowlisted in the effect lint)"),
    # -- health / recovery --------------------------------------------
    LockDecl("health.monitor", 400,
             _P + "runtime/health.py:DeviceHealthMonitor._lock",
             "Lock", "loss streaks, reinit/ladder slot reservation, "
                     "backend generation"),
    LockDecl("health.quarantine", 410,
             _P + "runtime/health.py:QuarantineRegistry._lock",
             "Lock", "per-template strike history + quarantine set"),
    LockDecl("memory.retry_handler", 420,
             _P + "runtime/retry.py:DeviceMemoryEventHandler._lock",
             "Lock", "OOM-retry state: spill attempt counters per "
                     "allocation failure"),
    # -- device managers ----------------------------------------------
    LockDecl("device.manager.instance", 500,
             _P + "runtime/device_manager.py:"
                  "TpuDeviceManager._instance_lock",
             "Lock", "singleton construction of the device manager"),
    LockDecl("semaphore.instance", 510,
             _P + "runtime/semaphore.py:TpuSemaphore._instance_lock",
             "Lock", "singleton construction / live resize of the task "
                     "semaphore"),
    LockDecl("semaphore.cond", 520,
             _P + "runtime/semaphore.py:TpuSemaphore._lock",
             "Condition", "device concurrency slots: holder map + waiter "
                          "wakeups"),
    LockDecl("mesh.runtime", 530,
             _P + "parallel/mesh.py:MeshRuntime._lock",
             "Lock", "mesh topology config, generation, identity token"),
    LockDecl("mesh.logical", 535,
             _P + "parallel/mesh.py:_LOGICAL_LOCK",
             "Lock", "the declared logical devices of a one-card mesh"),
    LockDecl("mesh.dict_intern", 540,
             _P + "parallel/exchange.py:_DICT_INTERN_LOCK",
             "Lock", "replicated-dictionary intern table + MeshExchange "
                     "cache (epoch-guarded late-publish rejection)"),
    LockDecl("profiler", 550,
             _P + "runtime/profiler.py:TorchProfiler._lock",
             "Lock", "profiler session state + sample buffers"),
    LockDecl("profiler.recording", 555,
             _P + "runtime/profiler.py:_RECORDING_LOCK",
             "Lock", "the process's one torch.profiler recording"),
    LockDecl("profiler.nvtx", 560,
             _P + "runtime/profiler.py:_NVTX_LOCK",
             "Lock", "the NVTX range switch and its users' count"),
    # -- device memory / spill, with the host arbiter under the batch ---
    LockDecl("spill.batch", 710,
             _P + "runtime/spill.py:SpillableBatch._lock",
             "RLock", "one batch's tier payloads + pin count. BELOW the "
                      "host arbiter, the catalog and the device arbiter: "
                      "get()/spill hold it while taking a host grant and "
                      "registering bytes; the reverse direction (catalog "
                      "spill walk -> batch) is non-blocking by contract"),
    LockDecl("host_alloc.instance", 712,
             _P + "runtime/host_alloc.py:HostMemoryArbiter._instance_lock",
             "Lock", "singleton construction of the host arbiter"),
    LockDecl("host_alloc.cv", 714,
             _P + "runtime/host_alloc.py:HostMemoryArbiter._cv",
             "Condition", "host memory budget waits/wakeups (a leaf: "
                          "nothing is acquired under it; the host-tier "
                          "spill runs outside it)"),
    LockDecl("pinned_pool.instance", 716,
             _P + "runtime/host_alloc.py:PinnedMemoryPool._instance_lock",
             "Lock", "singleton construction of the pinned pool"),
    LockDecl("pinned_pool", 718,
             _P + "runtime/host_alloc.py:PinnedMemoryPool._lock",
             "Lock", "pinned-buffer freelist"),
    LockDecl("spill.catalog", 720,
             _P + "runtime/spill.py:BufferCatalog._lock",
             "RLock", "spillable registry, disk-file tracking, spill "
                      "counters"),
    LockDecl("spill.catalog.instance", 725,
             _P + "runtime/spill.py:BufferCatalog._instance_lock",
             "Lock", "singleton construction/reset of the catalog. ABOVE "
                     "spill.batch: a batch unspill's device landing "
                     "accounts through the arbiter, whose spill pass "
                     "reaches BufferCatalog.get() with the batch RLock "
                     "still held. __init__ must NOT re-take it"),
    LockDecl("spill.catalog.registry", 730,
             _P + "runtime/spill.py:BufferCatalog._all_catalogs_lock",
             "Lock", "weak set of every catalog (atexit sweep)"),
    LockDecl("memory.arbiter", 740,
             _P + "runtime/memory.py:MemoryArbiter._lock",
             "RLock", "device budget ledger: reservations, per-table "
                      "bytes, peak. Never held across a spill pass "
                      "(_spill_for runs outside it)"),
    # -- io ------------------------------------------------------------
    LockDecl("io.committer.jobs", 800,
             _P + "io/committer.py:_ACTIVE_LOCK",
             "Lock", "process-wide in-flight WriteJob registry (crash "
                     "sweep reads it)"),
    LockDecl("io.filecache", 810,
             _P + "io/filecache.py:_FileCache._lock",
             "Lock", "scan file-cache entries + byte accounting"),
    LockDecl("io.scan.parquet", 820,
             _P + "io/parquet.py:ParquetScanNode._lock",
             "Lock", "one Parquet scan node's footer and row-group plan "
                     "memo"),
    LockDecl("io.scan.orc", 830,
             _P + "io/orc.py:OrcScanNode._lock",
             "Lock", "one ORC scan node's footer memo"),
    LockDecl("io.scan.csv", 840,
             _P + "io/csv.py:CsvScanNode._lock",
             "Lock", "one CSV scan node's decoded-file memo"),
    LockDecl("io.scan.json", 850,
             _P + "io/json.py:JsonScanNode._lock",
             "Lock", "one JSON scan node's decoded-file memo"),
    # -- fault injection / speculation (taken deep inside anything) ----
    LockDecl("faults.registry", 900,
             _P + "runtime/faults.py:FaultRegistry._lock",
             "Lock", "armed fault schedule + fire counters (fault_point "
                     "runs under locks across the engine, so this must "
                     "rank ABOVE every subsystem lock: acquired last)"),
    LockDecl("faults.recovery", 910,
             _P + "runtime/faults.py:RecoveryStats._lock",
             "Lock", "recovery action counters"),
    LockDecl("faults.breaker", 920,
             _P + "runtime/faults.py:CircuitBreaker._lock",
             "Lock", "per-op failure counts + demotion reasons"),
    LockDecl("speculation.blocklist", 930,
             _P + "runtime/speculation.py:_BLOCKLIST_LOCK",
             "Lock", "process-wide speculation blocklist"),
    # -- observability (leaf: every layer records into these) ----------
    LockDecl("obs.events.writer", 1000,
             _P + "obs/events.py:QueryEventWriter._lock",
             "Lock", "event-log file append + record sequence"),
    LockDecl("obs.events.recent", 1010,
             _P + "obs/events.py:_RECENT_LOCK",
             "Lock", "bounded recent-record ring (flight-recorder "
                     "summaries)"),
    LockDecl("obs.spans", 1020,
             _P + "obs/spans.py:SpanTracer._lock",
             "Lock", "span buffer + lane bookkeeping"),
    LockDecl("obs.telemetry.services", 1030,
             _P + "obs/telemetry.py:_SERVICES_LOCK",
             "Lock", "weak registry of live query services"),
    LockDecl("obs.telemetry.ring", 1040,
             _P + "obs/telemetry.py:TelemetryRing._lock",
             "Lock", "sampler config + bounded sample ring"),
    LockDecl("obs.flightrec", 1050,
             _P + "obs/telemetry.py:_FR_LOCK",
             "Lock", "incident bundle sequence + prune bookkeeping "
                     "(recording reads live surfaces only through "
                     "non-blocking/snapshot APIs)"),
    LockDecl("obs.metrics.spec", 1060,
             _P + "obs/metrics.py:_SPEC_LOCK",
             "Lock", "metric spec registry"),
    LockDecl("obs.metrics.scopes", 1070,
             _P + "obs/metrics.py:_SCOPE_LOCK",
             "Lock", "scope-name -> LockedMetricSet registry"),
    LockDecl("obs.metrics.scope", 1080,
             _P + "obs/metrics.py:LockedMetricSet._lock",
             "Lock", "one metric scope's counters: THE leaf lock, metric "
                     "adds happen under everything above"),
)

#: name -> declaration (THE registry; insertion order == rank order)
LOCK_ORDER: Dict[str, LockDecl] = {d.name: d for d in _DECLS}

#: the names shared with the reference whose rank or kind differs in the
#: port, each with its reason (every other shared name keeps both)
DEVIATIONS: Dict[str, str] = {
    "memory.arbiter":
        "an RLock (the reference's is a Lock): an accounted table's "
        "weakref release callback takes the arbiter's lock, and the "
        "garbage collector can run it inside an arbiter call on the same "
        "thread",
    "host_alloc.instance":
        "rank 712 (the reference's 600): every host copy of a spilled "
        "batch holds a host grant, taken and returned with the batch's "
        "RLock held (the reference's spill charges no host arbiter), and "
        "a batch's unspill accounts its landing through the device "
        "arbiter, whose spill pass demotes other batches to the host "
        "with that RLock still held, so the host band ranks above "
        "spill.batch and below the catalog",
    "host_alloc.cv":
        "rank 714 (the reference's 610): see host_alloc.instance. The "
        "grant's bounded wait (HostMemoryArbiter.alloc's timeout, then "
        "CpuRetryOOM) can run under a batch RLock: nothing is acquired "
        "under the condition, so the wait cannot close a cycle",
    "pinned_pool.instance":
        "rank 716 (the reference's 620): the band moves with the host "
        "arbiter's",
    "pinned_pool":
        "rank 718 (the reference's 630): a spill's device-to-host copy "
        "takes the pinned buffers with the batch's RLock held",
}


def _validate_registry() -> None:
    ranks: Dict[int, str] = {}
    sites: Dict[str, str] = {}
    prev = None
    for d in _DECLS:
        if d.rank in ranks:
            raise LockDeclError(
                f"locks {ranks[d.rank]!r} and {d.name!r} share rank "
                f"{d.rank}: the hierarchy must be a total order")
        if d.site in sites:
            raise LockDeclError(
                f"locks {sites[d.site]!r} and {d.name!r} share site "
                f"{d.site}")
        if prev is not None and d.rank <= prev:
            raise LockDeclError(
                f"LOCK_ORDER entries out of rank order at {d.name!r}")
        ranks[d.rank] = d.name
        sites[d.site] = d.name
        prev = d.rank
    if len(LOCK_ORDER) != len(_DECLS):
        raise LockDeclError("duplicate lock name in LOCK_ORDER")
    stray = set(DEVIATIONS) - set(LOCK_ORDER)
    if stray:
        raise LockDeclError(f"DEVIATIONS names undeclared locks {stray}")


_validate_registry()


# ---------------------------------------------------------------------------
# runtime witness
# ---------------------------------------------------------------------------

#: construction-time election flag (see module docstring). Reads are a
#: plain attribute load; writes happen in arm/disarm only.
_WITNESS_ARMED = False

#: process-monotonic count of witness violations DETECTED (each one also
#: raises LockOrderViolation at the acquire site)
_WITNESS_VIOLATIONS = [0]
_WITNESS_VIOLATIONS_LOCK = threading.Lock()

#: evidence for the counter: the first N violations' (lock, held chain,
#: acquiring call site). A raised LockOrderViolation can land in a
#: best-effort except or a weakref callback and vanish, so the count alone
#: is undebuggable
_WITNESS_RECORDS: List[dict] = []
_WITNESS_RECORDS_MAX = 20

_held_local = threading.local()


def _held() -> List[Tuple[int, LockDecl, bool]]:
    """This thread's live acquisitions: (lock object id, decl,
    underlying-is-reentrant)."""
    stack = getattr(_held_local, "stack", None)
    if stack is None:
        stack = _held_local.stack = []
    return stack


def arm_witness() -> None:
    """Arm the witness for locks constructed FROM NOW ON."""
    global _WITNESS_ARMED
    _WITNESS_ARMED = True


def disarm_witness() -> None:
    global _WITNESS_ARMED
    _WITNESS_ARMED = False


def witness_armed() -> bool:
    return _WITNESS_ARMED


def configure(conf) -> None:
    """Arm or disarm from ``spark.rapids.lint.lockWitness`` (cheap; the
    session and the query service call it before constructing their
    lock-owning objects, so a conf-armed witness covers every
    per-instance lock those builds create)."""
    if bool(conf.get_entry(LOCK_WITNESS)):
        arm_witness()
    else:
        disarm_witness()


def held_snapshot() -> List[str]:
    """Names of the declared locks THIS thread currently holds (test and
    diagnostic surface)."""
    return [d.name for _oid, d, _r in _held()]


def witness_violations() -> int:
    """Process-monotonic count of detected lock-order violations; callers
    sample it before and after and assert the delta is zero."""
    with _WITNESS_VIOLATIONS_LOCK:
        return _WITNESS_VIOLATIONS[0]


def reset_witness_violations() -> None:
    """Zero the counter and drop the evidence records. A test that
    provokes violations on purpose resets afterwards, or every later
    in-process check reads its deliberate inversions as real ones."""
    with _WITNESS_VIOLATIONS_LOCK:
        _WITNESS_VIOLATIONS[0] = 0
        _WITNESS_RECORDS.clear()


def witness_violation_records() -> List[dict]:
    """The recorded evidence behind :func:`witness_violations` (the first
    ``_WITNESS_RECORDS_MAX`` only): what a failing check dumps."""
    with _WITNESS_VIOLATIONS_LOCK:
        return [dict(r) for r in _WITNESS_RECORDS]


def _count_violation(lock_name: str, chain: str) -> None:
    site = "".join(traceback.format_stack(limit=8)[:-2])
    with _WITNESS_VIOLATIONS_LOCK:
        _WITNESS_VIOLATIONS[0] += 1
        if len(_WITNESS_RECORDS) < _WITNESS_RECORDS_MAX:
            _WITNESS_RECORDS.append(
                {"lock": lock_name, "heldChain": chain, "site": site})


def _check_blocking_acquire(decl: LockDecl, oid: int,
                            reentrant: bool) -> None:
    for hoid, hdecl, _hreent in _held():
        if hoid == oid:
            if reentrant:
                continue
            _count_violation(decl.name, decl.name)
            raise LockOrderViolation(
                f"witness: thread re-acquiring non-reentrant lock "
                f"{decl.name!r} (rank {decl.rank}) it already holds: "
                "guaranteed self-deadlock")
        if hdecl.rank >= decl.rank:
            chain = " -> ".join(
                f"{d.name}({d.rank})" for _o, d, _r in _held())
            _count_violation(decl.name, chain)
            raise LockOrderViolation(
                f"witness: blocking acquire of {decl.name!r} (rank "
                f"{decl.rank}) while holding {hdecl.name!r} (rank "
                f"{hdecl.rank}) inverts the declared order; held chain: "
                f"{chain}. Either acquire in ascending rank, use "
                "acquire(blocking=False), or fix LOCK_ORDER")


def _note_acquired(decl: LockDecl, oid: int, reentrant: bool) -> None:
    _held().append((oid, decl, reentrant))


def _note_released(oid: int) -> None:
    stack = _held()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][0] == oid:
            del stack[i]
            return


class _WitnessedLock:
    """Rank-checking proxy over one threading primitive. Exists only while
    the witness is armed at construction; delegates everything after its
    bookkeeping, so lock SEMANTICS are unchanged: the witness raises
    instead of deadlocking, never the reverse."""

    _reentrant = False

    def __init__(self, inner, decl: LockDecl):
        self._inner = inner
        self._decl = decl

    def acquire(self, blocking: bool = True, timeout: float = -1):
        oid = id(self)
        if blocking:
            _check_blocking_acquire(self._decl, oid, self._reentrant)
            got = (self._inner.acquire(timeout=timeout)
                   if timeout is not None and timeout >= 0
                   else self._inner.acquire())
        else:
            got = self._inner.acquire(blocking=False)
        if got:
            _note_acquired(self._decl, oid, self._reentrant)
        return got

    def release(self):
        self._inner.release()
        _note_released(id(self))

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return (f"<witnessed {self._decl.kind} {self._decl.name!r} "
                f"rank={self._decl.rank}>")


class _WitnessedRLock(_WitnessedLock):
    _reentrant = True


class _WitnessedSemaphore(_WitnessedLock):
    # a semaphore with several permits may be taken twice by one thread;
    # the rank check still applies against the OTHER held locks
    _reentrant = True

    def locked(self):  # semaphores have no locked()
        raise AttributeError("locked")


class _WitnessedCondition(_WitnessedLock):
    # threading.Condition's default lock is an RLock
    _reentrant = True

    def _released_for_wait(self, wait):
        # a wait RELEASES the condition's lock for its duration: the
        # witness must not count it as held, or a wakeup path that
        # re-acquires in rank order would be flagged
        oid = id(self)
        depth = sum(1 for e in _held() if e[0] == oid)
        for _ in range(depth):
            _note_released(oid)
        try:
            return wait()
        finally:
            for _ in range(depth):
                _note_acquired(self._decl, oid, self._reentrant)

    def wait(self, timeout: Optional[float] = None):
        return self._released_for_wait(lambda: self._inner.wait(timeout))

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._released_for_wait(
            lambda: self._inner.wait_for(predicate, timeout))

    def notify(self, n: int = 1):
        return self._inner.notify(n)

    def notify_all(self):
        return self._inner.notify_all()


def _resolve(name: str, kind: str) -> LockDecl:
    decl = LOCK_ORDER.get(name)
    if decl is None:
        raise LockDeclError(
            f"lock {name!r} is not declared in lockorder.LOCK_ORDER: add "
            "a LockDecl with a rank and the construction site "
            "(RL-LOCK-DECL)")
    if decl.kind != kind:
        raise LockDeclError(
            f"lock {name!r} declared as {decl.kind} but constructed as "
            f"{kind}")
    return decl


def ordered_lock(name: str) -> threading.Lock:
    """A declared, rank-ordered ``threading.Lock`` (witnessed when the
    witness is armed at construction time)."""
    decl = _resolve(name, "Lock")
    inner = threading.Lock()
    return _WitnessedLock(inner, decl) if _WITNESS_ARMED else inner


def ordered_rlock(name: str) -> threading.RLock:
    decl = _resolve(name, "RLock")
    inner = threading.RLock()
    return _WitnessedRLock(inner, decl) if _WITNESS_ARMED else inner


def ordered_condition(name: str) -> threading.Condition:
    decl = _resolve(name, "Condition")
    inner = threading.Condition()
    return _WitnessedCondition(inner, decl) if _WITNESS_ARMED else inner


def ordered_semaphore(name: str, value: int = 1) -> threading.Semaphore:
    decl = _resolve(name, "Semaphore")
    inner = threading.Semaphore(value)
    return _WitnessedSemaphore(inner, decl) if _WITNESS_ARMED else inner


# ---------------------------------------------------------------------------
# LOCKS.md generator
# ---------------------------------------------------------------------------


def generate_locks_md() -> str:
    """The committed ``spark_rapids_tpu_torch/docs/LOCKS.md``: the
    hierarchy as a reviewable table, then the deviations from the
    reference's table (regenerated by ``--write-docs``, drift-checked by
    RA-DOC-DRIFT-LOCKS)."""
    lines = [
        "# Lock order registry",
        "",
        "Generated from `spark_rapids_tpu_torch/lockorder.py` "
        "(`python -m spark_rapids_tpu_torch.lint --write-docs`). "
        "Do not edit by hand.",
        "",
        "The concurrency contract: a thread blocking-acquires locks in "
        "strictly ASCENDING rank only; non-blocking "
        "(`acquire(blocking=False)`) try-acquires are exempt (they "
        "cannot deadlock). `lint/concurrency.py` enforces the contract "
        "statically (RL-LOCK-DECL / RL-LOCK-ORDER / RL-LOCK-EFFECT); "
        "the runtime lock witness (`spark.rapids.lint.lockWitness`) "
        "cross-validates it where the conf of a session or a query "
        "service arms it.",
        "",
        "| Rank | Name | Kind | Owning module | Guarded state |",
        "|---:|---|---|---|---|",
    ]
    for d in _DECLS:
        site = d.site.replace(_P, "")
        lines.append(
            f"| {d.rank} | `{d.name}` | {d.kind} | `{site}` | "
            f"{d.guards} |")
    lines += [
        "",
        "## Deviations from the reference's table",
        "",
        "Every other name shared with `spark_rapids_tpu/lockorder.py` "
        "keeps its rank and kind.",
        "",
        "| Name | Why |",
        "|---|---|",
    ]
    for name, why in DEVIATIONS.items():
        lines.append(f"| `{name}` | {why} |")
    lines.append("")
    return "\n".join(lines)
