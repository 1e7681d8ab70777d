"""QueryService: a worker pool, admission control and weighted fair
queueing over one TorchSession (port of
``spark_rapids_tpu/service/scheduler.py``).

Reference: the reference plugin leans on Spark's scheduler. FAIR pools
(``spark.scheduler.pool``) queue jobs per tenant, the driver bounds
concurrent tasks, and ``GpuSemaphore`` bounds how many of them touch the
device at once. This engine owns its sessions, so it provides that stack
itself:

* **Admission.** A bounded queue per pool; a full queue raises the typed
  :class:`~spark_rapids_tpu_torch.errors.QueryRejectedError` carrying a
  ``retry_after_ms`` hint. Before a worker takes a query, admission reads
  the device bytes the port accounts (the memory arbiter's ledger and the
  spill catalog, ``spark.rapids.service.admission.maxDeviceBytes``; never
  the caching allocator's ``memory_reserved``, which keeps freed blocks):
  over the mark, queued queries HOLD until a running one finishes, unless
  nothing runs (forward progress beats the gate). A template the
  quarantine holds is refused at submit with
  :class:`~spark_rapids_tpu_torch.errors.QueryQuarantinedError`.
* **Scheduling.** Two-level weighted fair queueing. Pools come from
  ``spark.rapids.service.pools`` (``name[:weight=W]``), tenant weights from
  ``spark.rapids.service.tenantWeights``. Each completed query charges
  its wall time / weight to its pool's and its tenant's virtual clocks;
  the next query comes from the least-charged pool, then the
  least-charged tenant in it. A newly active tenant joins at the pool's
  current minimum clock, so it can neither starve veterans nor be
  starved by them.
* **Execution.** ``maxConcurrentQueries`` daemon workers share ONE
  TorchSession (its in-flight query state is thread-local). Each worker
  runs its query with the session's device as its current device
  (``_device_context``). Kernels launch on torch's current stream of that
  device, the legacy default stream in every worker thread, so the
  workers' launches serialize on the card; the semaphore
  (``concurrentGpuTasks``) bounds device residency. Results optionally
  come from, and fill, the plan-fingerprint result cache
  (result_cache.py).
* **Lifecycle.** Deadlines (``defaultTimeoutMs`` or per submit) expire
  queued queries at the sweep and running ones at exec boundaries, as
  ``QueryHandle.cancel()`` does.
* **Survivability.** A worker that dies (``service.worker_crash``) or is
  abandoned by the watchdog (watchdog.py) is replaced, its query struck
  and requeued; a ``DeviceLostError`` requeues the query against the
  recovered device, or, once the process latched CPU-only, onto the CPU
  route (``TorchSession._execute_cpu_only``). No worker catches a device
  failure and re-runs the query on the CPU itself.

* **Mesh and cluster.** A service whose conf turns the mesh on
  serializes its workers' launch windows (the mesh gate, taken before the
  RUNNING transition, so a wait counts as queue time); a cached serve's
  record carries the live ``meshShape`` and ``hostTopology``; a cluster
  below its declared host strength (or latched single-process) degrades
  the service (``spark.rapids.service.degrade.onHostLoss``). Recurring
  streams
(streaming/query.py) register with the service (``register_stream``,
``streams()``), and ``mv_registry()`` keeps the materialized views over
its session (streaming/mv.py).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.conf import (  # noqa: F401 (re-exports)
    QUARANTINE_MAX_STRIKES,
    SERVICE_ADMISSION_MAX_DEVICE_BYTES,
    SERVICE_DEFAULT_TIMEOUT_MS,
    SERVICE_DEGRADE_MEMORY_FRACTION,
    SERVICE_DEGRADE_ON_HOST_LOSS,
    SERVICE_INTROSPECT_ENABLED,
    SERVICE_INTROSPECT_PORT,
    SERVICE_MAX_CONCURRENT,
    SERVICE_POOLS,
    SERVICE_QUEUE_DEPTH,
    SERVICE_RESULT_CACHE_ENABLED,
    SERVICE_RESULT_CACHE_MAX_BYTES,
    SERVICE_TENANT_WEIGHTS,
    RapidsConf,
)
from spark_rapids_tpu_torch.errors import (
    ColumnarProcessingError,
    DeviceLostError,
    QueryCancelledError,
    QueryQuarantinedError,
    QueryRejectedError,
    QueryTimeoutError,
    WorkerLostError,
)
from spark_rapids_tpu_torch.lockorder import ordered_condition, ordered_lock
from spark_rapids_tpu_torch.runtime.faults import fault_point
from spark_rapids_tpu_torch.runtime.health import HEALTH, QUARANTINE
from spark_rapids_tpu_torch.service.query import (
    QueryHandle,
    QueryState,
    cancel_scope,
)
from spark_rapids_tpu_torch.service.result_cache import (
    ResultCache,
    epoch_snapshot,
    fingerprint,
    plan_table_ids,
)
from spark_rapids_tpu_torch.service.watchdog import WorkerWatchdog, _Worker

def _mesh_shape():
    """The active mesh's shape for serve-time records (None when off)."""
    from spark_rapids_tpu_torch.parallel.mesh import MESH
    return MESH.shape_str()


def _host_topology():
    """The active cluster's host topology for serve-time records (None
    when off)."""
    from spark_rapids_tpu_torch.runtime.cluster import CLUSTER
    return CLUSTER.topology_str()


def _mem_budget_peak() -> int:
    """The memory arbiter's peak accounted device bytes, for the cache-hit
    record's ``budgetPeak``."""
    from spark_rapids_tpu_torch.runtime.memory import MEMORY
    return int(MEMORY.peak_bytes())


def parse_pools(spec: str) -> "OrderedDict[str, float]":
    """'name[:weight=W];...' -> {name: weight}. Raises on duplicates,
    empty names and non-positive weights (a mistyped spec must fail the
    service's construction, not silently rebalance it)."""
    pools: "OrderedDict[str, float]" = OrderedDict()
    for entry in (e.strip() for e in str(spec).split(";")):
        if not entry:
            continue
        name, _, rest = entry.partition(":")
        name = name.strip()
        weight = 1.0
        if rest:
            key, _, val = rest.partition("=")
            if key.strip() != "weight" or not val:
                raise ColumnarProcessingError(
                    f"bad pool spec entry {entry!r} (want "
                    "'name[:weight=W]')")
            try:
                weight = float(val)
            except ValueError:
                raise ColumnarProcessingError(
                    f"pool {name!r} weight {val!r} is not a number "
                    "(spark.rapids.service.pools)")
        if not name:
            raise ColumnarProcessingError(
                f"bad pool spec entry {entry!r}: empty pool name")
        if name in pools:
            raise ColumnarProcessingError(
                f"duplicate pool {name!r} in spark.rapids.service.pools")
        if weight <= 0:
            raise ColumnarProcessingError(
                f"pool {name!r} weight must be positive, got {weight}")
        pools[name] = weight
    if not pools:
        raise ColumnarProcessingError(
            "spark.rapids.service.pools defines no pools")
    return pools


def parse_tenant_weights(spec: str) -> Dict[str, float]:
    """'tenant=W,tenant=W' -> {tenant: weight}; unlisted tenants 1.0."""
    out: Dict[str, float] = {}
    for entry in (e.strip() for e in str(spec).split(",")):
        if not entry:
            continue
        name, sep, val = entry.partition("=")
        if not sep or not name.strip():
            raise ColumnarProcessingError(
                f"bad tenant weight entry {entry!r} (want 'tenant=W')")
        try:
            w = float(val)
        except ValueError:
            raise ColumnarProcessingError(
                f"tenant {name.strip()!r} weight {val!r} is not a number "
                "(spark.rapids.service.tenantWeights)")
        if w <= 0:
            raise ColumnarProcessingError(
                f"tenant {name.strip()!r} weight must be positive, got {w}")
        out[name.strip()] = w
    return out


def _default_memory_probe() -> int:
    """Admission's device-occupancy read: the memory arbiter's ledger
    (every accounted landing and intermediate), or the spill catalog's
    view where it holds more. Host bookkeeping only: no CUDA call."""
    from spark_rapids_tpu_torch.runtime.memory import MEMORY
    from spark_rapids_tpu_torch.runtime.spill import BufferCatalog
    return max(BufferCatalog.get().device_bytes(), MEMORY.occupancy())


class QueryService:
    """Concurrent multi-tenant front end over one TorchSession.

    >>> svc = QueryService({"spark.rapids.service.maxConcurrentQueries": 4})
    >>> h = svc.submit(df, tenant="alice")
    >>> table = h.result(timeout=60)

    Accepts DataFrames, PlanNodes or SQL text (lowered through the
    session's catalog at submit, so parse and analysis errors reach the
    submitter at once). Without a session it makes one on the card
    (``device`` as ``TorchSession``'s: None is the current CUDA device and
    raises without one; ``"cpu"`` runs the kernels' plain versions)."""

    #: how long an idle worker sleeps between deadline sweeps
    _SWEEP_INTERVAL_S = 0.05

    def __init__(self, conf=None, session=None,
                 max_concurrent: Optional[int] = None,
                 queue_depth: Optional[int] = None, device=None):
        if session is None:
            from spark_rapids_tpu_torch.session import TorchSession
            session = TorchSession(conf, device=device)
        elif conf is not None or device is not None:
            raise ColumnarProcessingError(
                "pass conf/device or a session, not both (the service "
                "reads its knobs from the session's conf)")
        self.session = session
        self.conf: RapidsConf = session.conf
        # arm the runtime lock witness FIRST (construction-time election):
        # every lock this __init__ builds (the scheduler condition, the
        # streams lock, the result cache's) is wrapped iff the conf arms it
        from spark_rapids_tpu_torch import lockorder
        lockorder.configure(self.conf)
        self.pools = parse_pools(self.conf.get_entry(SERVICE_POOLS))
        self.tenant_weights = parse_tenant_weights(
            self.conf.get_entry(SERVICE_TENANT_WEIGHTS))
        self.max_concurrent = max(1, int(
            max_concurrent if max_concurrent is not None
            else self.conf.get_entry(SERVICE_MAX_CONCURRENT)))
        self.queue_depth = max(1, int(
            queue_depth if queue_depth is not None
            else self.conf.get_entry(SERVICE_QUEUE_DEPTH)))
        self.default_timeout_ms = int(
            self.conf.get_entry(SERVICE_DEFAULT_TIMEOUT_MS))
        self.admission_max_device_bytes = int(
            self.conf.get_entry(SERVICE_ADMISSION_MAX_DEVICE_BYTES))
        self._degrade_memory_fraction = float(
            self.conf.get_entry(SERVICE_DEGRADE_MEMORY_FRACTION))
        self._degrade_on_host_loss = bool(
            self.conf.get_entry(SERVICE_DEGRADE_ON_HOST_LOSS))
        # the mesh gate: a mesh service serializes its workers' launch
        # windows (the reference's collective rendezvous rule, kept so a
        # mesh query's exchange and re-lands run as one unit)
        from spark_rapids_tpu_torch.conf import MESH_ENABLED
        self._mesh_gate = None
        if bool(self.conf.get_entry(MESH_ENABLED)):
            self._mesh_gate = ordered_lock("service.mesh_gate")
        self.result_cache: Optional[ResultCache] = None
        if bool(self.conf.get_entry(SERVICE_RESULT_CACHE_ENABLED)):
            self.result_cache = ResultCache(
                int(self.conf.get_entry(SERVICE_RESULT_CACHE_MAX_BYTES)))
        #: injectable for tests; production reads the ledger
        self._memory_probe = _default_memory_probe
        #: recurring tenants (a StreamingQuery registers itself for its
        #: lifetime): name -> stream object exposing describe(), surfaced
        #: by streams(), /streams and ``tools top``
        self._streams_lock = ordered_lock("service.scheduler.streams")
        self._streams: Dict[str, object] = {}
        self._mvs = None

        self._cond = ordered_condition("service.scheduler.cond")
        #: (pool, tenant) -> FIFO of queued handles
        self._queues: Dict[Tuple[str, str], deque] = {}
        #: per-pool queued-handle count (the admission bound)
        self._queued_per_pool: Dict[str, int] = {p: 0 for p in self.pools}
        #: WFQ virtual clocks: seconds of service / weight
        self._tenant_clock: Dict[Tuple[str, str], float] = {}
        self._pool_clock: Dict[str, float] = {p: 0.0 for p in self.pools}
        self._running = 0
        self._held_for_memory = 0
        self._memory_gate_was_open = True
        self._shutdown = False
        self._recent_run_s: deque = deque(maxlen=32)
        self.counters = {"submitted": 0, "finished": 0, "failed": 0,
                         "cancelled": 0, "timed_out": 0, "rejected": 0,
                         "requeued": 0, "quarantineRejected": 0,
                         "hardTimeouts": 0}
        # survivability state (runtime/health.py, watchdog.py): worker
        # lifecycle counters, the DEGRADED latch (cleared by
        # _DEGRADE_CLEAR_SUCCESSES completed queries: event counts, so
        # tests and chaos runs need no wall clock) and the quarantine's
        # strike budget; all mutated under _cond
        from spark_rapids_tpu_torch.obs.metrics import metric_scope
        self._health_metrics = metric_scope("health")
        self._workers_lost = 0
        self._workers_respawned = 0
        self._degraded_pending = 0
        self.quarantine_max_strikes = int(
            self.conf.get_entry(QUARANTINE_MAX_STRIKES))
        #: the pool DEGRADED mode sheds first (lowest weight, name breaks
        #: ties); None with one pool
        self._shed_pool = (min(self.pools, key=lambda p: (self.pools[p], p))
                           if len(self.pools) > 1 else None)

        # arm the fault registry now: service.worker_crash fires in the
        # scheduler before the first execute would arm it from the same
        # conf (re-arming an identical spec is a no-op)
        from spark_rapids_tpu_torch.conf import TEST_FAULTS
        from spark_rapids_tpu_torch.runtime.faults import FAULTS
        FAULTS.arm(str(self.conf.get_entry(TEST_FAULTS) or ""))

        self._worker_seq = 0
        self._workers: List[_Worker] = []
        with self._cond:
            for _ in range(self.max_concurrent):
                self._spawn_worker_locked()
        # a dedicated deadline sweeper: when every worker is busy a queued
        # query's deadline must still expire on time
        self._sweeper = threading.Thread(target=self._sweeper_loop,
                                         name="rapids-svc-sweeper",
                                         daemon=True)
        self._sweeper.start()
        self._watchdog = WorkerWatchdog(self)

        #: (pool, tenant) -> deque of (latency_s, run_s) of recently
        #: FINISHED handles, the /slo source; mutated under _cond
        self._finished_lat: Dict[Tuple[str, str], deque] = {}

        from spark_rapids_tpu_torch.obs.telemetry import (
            TELEMETRY,
            register_service,
        )
        TELEMETRY.configure(self.conf)
        register_service(self)
        from spark_rapids_tpu_torch.runtime.memory import MEMORY
        MEMORY.configure(self.conf)

        self.introspect = None
        self.introspect_port: Optional[int] = None
        if bool(self.conf.get_entry(SERVICE_INTROSPECT_ENABLED)):
            from spark_rapids_tpu_torch.service.introspect import (
                IntrospectionServer,
            )
            self.introspect = IntrospectionServer(
                self, int(self.conf.get_entry(SERVICE_INTROSPECT_PORT)))
            self.introspect_port = self.introspect.port

    # -- submission -----------------------------------------------------------
    def submit(self, query, *, tenant: str = "default",
               pool: Optional[str] = None,
               timeout_ms: Optional[int] = None,
               tag: Optional[str] = None) -> QueryHandle:
        """Admit one query (a DataFrame, a PlanNode or SQL text). Raises
        QueryRejectedError when the pool's queue is full (or a DEGRADED
        service sheds the pool) and QueryQuarantinedError when the query's
        template is quarantined."""
        pool = pool if pool is not None else next(iter(self.pools))
        if pool not in self.pools:
            raise ColumnarProcessingError(
                f"unknown scheduling pool {pool!r} "
                f"(configured: {', '.join(self.pools)})")
        plan, sql_text = self._resolve(query)
        if timeout_ms is None:
            timeout_ms = self.default_timeout_ms
        deadline = (time.monotonic() + timeout_ms / 1000.0
                    if timeout_ms and timeout_ms > 0 else None)
        handle = QueryHandle(tenant=tenant, pool=pool, tag=tag,
                             sql_text=sql_text, plan=plan,
                             deadline=deadline)
        handle._service = self
        # the quarantine at admission: the template walk runs outside the
        # scheduler's lock, and only when something is quarantined
        if QUARANTINE.snapshot()["quarantined"]:
            quarantined = QUARANTINE.is_quarantined(
                self._template_fp(handle))
            if quarantined is not None:
                with self._cond:
                    self.counters["quarantineRejected"] += 1
                raise QueryQuarantinedError(
                    f"query template is quarantined after "
                    f"{len(quarantined)} worker/device kills; submission "
                    "refused", strikes=quarantined)
        with self._cond:
            if self._shutdown:
                raise ColumnarProcessingError("query service is shut down")
            # DEGRADED sheds the lowest-weight pool first; an otherwise
            # idle service still admits it (completions are the only way
            # back to HEALTHY when no other traffic flows)
            if (pool == self._shed_pool
                    and (self._running > 0
                         or any(self._queued_per_pool.values()))
                    and self._health_state_locked() == "DEGRADED"):
                self.counters["rejected"] += 1
                raise QueryRejectedError(
                    f"service is DEGRADED; shedding lowest-weight pool "
                    f"{pool!r} load - retry later",
                    retry_after_ms=self._retry_after_ms_locked(pool))
            if self._queued_per_pool[pool] >= self.queue_depth:
                self.counters["rejected"] += 1
                raise QueryRejectedError(
                    f"pool {pool!r} queue is full ({self.queue_depth} "
                    "queued); retry later",
                    retry_after_ms=self._retry_after_ms_locked(pool))
            self._activate_locked(pool, tenant)
            self._queues.setdefault((pool, tenant), deque()).append(handle)
            self._queued_per_pool[pool] += 1
            self.counters["submitted"] += 1
            # notify_all: the sweeper and the watchdog share the condition
            self._cond.notify_all()
        return handle

    def _resolve(self, query):
        from spark_rapids_tpu_torch.plan import DataFrame
        from spark_rapids_tpu_torch.plan.nodes import PlanNode
        if isinstance(query, str):
            df = self.session.sql(query)
            return df.plan, query
        if isinstance(query, DataFrame):
            return query.plan, getattr(query, "sql_text", None)
        if isinstance(query, PlanNode):
            return query, None
        raise TypeError(
            f"cannot submit {type(query).__name__}; want DataFrame, "
            "PlanNode, or SQL text")

    def _template_fp(self, handle: QueryHandle) -> Optional[str]:
        """The quarantine key: the handle's literal-stripped template
        (plan/fingerprint.py), computed at most once and only when
        needed. None for plans too dynamic to fingerprint."""
        if not handle._template_fp_done:
            from spark_rapids_tpu_torch.plan.fingerprint import (
                template_fingerprint,
            )
            handle.template_fp = template_fingerprint(handle.plan,
                                                      self.conf)
            handle._template_fp_done = True
        return handle.template_fp

    def _handle_has_strikes(self, handle: QueryHandle) -> bool:
        """Does this handle's template carry strikes (the event record's
        ``quarantined``)? Computed only when the ledger has any."""
        if not QUARANTINE.snapshot()["strikes"]:
            return False
        return QUARANTINE.strike_count(self._template_fp(handle)) > 0

    def _retry_after_ms_locked(self, pool: str) -> int:
        mean_run = (sum(self._recent_run_s) / len(self._recent_run_s)
                    if self._recent_run_s else 0.1)
        backlog = self._queued_per_pool[pool] + self._running
        est = mean_run * backlog / max(self.max_concurrent, 1)
        return max(50, int(est * 1000))

    #: tenant clocks kept for idle tenants before pruning (the
    #: re-activation lift makes pruning fairness-neutral)
    _MAX_IDLE_CLOCKS = 4096

    def _activate_locked(self, pool: str, tenant: str) -> None:
        """A tenant (re)gaining queued work joins the race at no less than
        the pool's ACTIVE minimum clock: idle time banks no credit (the
        WFQ virtual-time lift). Pools likewise."""
        key = (pool, tenant)
        busy = [c for (p, t), c in self._tenant_clock.items()
                if p == pool and (p, t) != key and self._queues.get((p, t))]
        cur = self._tenant_clock.get(key, 0.0)
        self._tenant_clock[key] = max(cur, min(busy)) if busy else cur
        busy_pools = [self._pool_clock[p] for p in self.pools
                      if p != pool and self._queued_per_pool.get(p)]
        if busy_pools and not self._queued_per_pool.get(pool):
            self._pool_clock[pool] = max(self._pool_clock[pool],
                                         min(busy_pools))
        if len(self._tenant_clock) > self._MAX_IDLE_CLOCKS:
            for k in [k for k in self._tenant_clock
                      if k != key and not self._queues.get(k)]:
                del self._tenant_clock[k]

    def _drop_if_empty_locked(self, key) -> None:
        """Empty per-tenant deques are deleted, so the sweep and the pick
        scale with tenants that have work."""
        dq = self._queues.get(key)
        if dq is not None and not dq:
            del self._queues[key]

    # -- scheduling -----------------------------------------------------------
    def _remove_queued(self, handle: QueryHandle) -> bool:
        """Pull a still-queued handle out (the cancel path)."""
        with self._cond:
            key = (handle.pool, handle.tenant)
            dq = self._queues.get(key)
            if dq is not None:
                try:
                    dq.remove(handle)
                except ValueError:
                    return False
                self._queued_per_pool[handle.pool] -= 1
                self._drop_if_empty_locked(key)
                return True
            return False

    def _sweep_expired_locked(self) -> None:
        """Time out or cancel queued handles whose deadline passed or
        whose cancel flag is set, without running them."""
        for (pool, tenant), dq in list(self._queues.items()):
            for h in list(dq):
                if h.scope.cancelled.is_set():
                    dq.remove(h)
                    self._queued_per_pool[pool] -= 1
                    if h._transition(QueryState.CANCELLED,
                                     error=QueryCancelledError(
                                         "cancelled while queued")):
                        self.counters["cancelled"] += 1
                elif h.scope.expired():
                    dq.remove(h)
                    self._queued_per_pool[pool] -= 1
                    if h._transition(QueryState.TIMED_OUT,
                                     error=QueryTimeoutError(
                                         "deadline expired while queued")):
                        self.counters["timed_out"] += 1
            self._drop_if_empty_locked((pool, tenant))

    def _memory_gate_open_locked(self) -> bool:
        """Admit when under the mark, or when nothing runs."""
        limit = self.admission_max_device_bytes
        if limit <= 0 or self._running == 0:
            return True
        try:
            used = int(self._memory_probe())
        except Exception:
            return True  # a broken probe must not wedge the service
        return used <= limit

    def _pick_locked(self) -> Optional[QueryHandle]:
        """WFQ pop: least-charged pool, then least-charged tenant in it,
        FIFO within the tenant. The clocks are already weight-normalized
        (``_charge_locked`` adds elapsed / weight), so the pick compares
        them raw."""
        candidates = [(p, t, dq) for (p, t), dq in self._queues.items()
                      if dq]
        if not candidates:
            return None
        if not self._memory_gate_open_locked():
            if self._memory_gate_was_open:
                # held admission EPISODES, not poll wakeups
                self._held_for_memory += 1
                self._memory_gate_was_open = False
            return None
        self._memory_gate_was_open = True
        pool, tenant, dq = min(
            candidates,
            key=lambda c: (self._pool_clock[c[0]],
                           self._tenant_clock[(c[0], c[1])],
                           c[2][0].query_id))
        handle = dq.popleft()
        self._queued_per_pool[pool] -= 1
        self._drop_if_empty_locked((pool, tenant))
        return handle

    def _count_event(self, name: str, n: int = 1) -> None:
        """Every lifecycle counter bump, under the condition lock. A
        completed query also pays down the DEGRADED latch."""
        with self._cond:
            self.counters[name] += n
            if name == "finished" and self._degraded_pending > 0:
                self._degraded_pending -= 1

    def _charge_locked(self, handle: QueryHandle, elapsed_s: float):
        w_t = self.tenant_weights.get(handle.tenant, 1.0)
        key = (handle.pool, handle.tenant)
        self._pool_clock[handle.pool] += elapsed_s / self.pools[handle.pool]
        self._tenant_clock[key] = (self._tenant_clock.get(key, 0.0)
                                   + elapsed_s / w_t)
        self._recent_run_s.append(max(elapsed_s, 1e-4))

    # -- workers --------------------------------------------------------------
    def _sweeper_loop(self):
        while True:
            with self._cond:
                if self._shutdown:
                    return
                self._sweep_expired_locked()
                self._cond.wait(timeout=self._SWEEP_INTERVAL_S)

    #: requeues after a worker or the device died under a query, before it
    #: fails with the typed error
    _DEVICE_LOSS_REPLAYS = 3
    _WORKER_LOSS_REPLAYS = 3
    #: completed queries that clear the DEGRADED latch after a loss
    _DEGRADE_CLEAR_SUCCESSES = 2

    def _spawn_worker_locked(self) -> _Worker:
        self._worker_seq += 1
        w = _Worker(f"rapids-svc-worker-{self._worker_seq}")
        w.thread = threading.Thread(target=self._worker_loop, args=(w,),
                                    name=w.name, daemon=True)
        self._workers.append(w)
        w.thread.start()
        return w

    def _drop_worker_locked(self, w: _Worker) -> None:
        if w in self._workers:
            self._workers.remove(w)

    def _note_worker_lost_locked(self, w: _Worker) -> None:
        """One worker is gone (dead, or abandoned by the watchdog): count
        it, latch DEGRADED and spawn a replacement."""
        self._drop_worker_locked(w)
        self._workers_lost += 1
        self._health_metrics.add("workersLost", 1)
        self._degraded_pending = self._DEGRADE_CLEAR_SUCCESSES
        if not self._shutdown:
            self._spawn_worker_locked()
            self._workers_respawned += 1
            self._health_metrics.add("workersRespawned", 1)

    def _strike_locked(self, handle: QueryHandle, reason: str) -> bool:
        """One strike against the handle's template; True when this one
        quarantined it."""
        return QUARANTINE.strike(self._template_fp(handle), reason,
                                 self.quarantine_max_strikes)

    def _requeue_locked(self, handle: QueryHandle) -> bool:
        """Put a handle whose worker or device died under it back at the
        FRONT of its queue; gated on the QUEUED transition (a handle some
        other path drove terminal is not re-enqueued)."""
        if not handle._transition(QueryState.QUEUED):
            return False
        handle.requeues += 1
        self._activate_locked(handle.pool, handle.tenant)
        self._queues.setdefault((handle.pool, handle.tenant),
                                deque()).appendleft(handle)
        self._queued_per_pool[handle.pool] += 1
        self.counters["requeued"] += 1
        self._cond.notify_all()
        return True

    def _on_worker_death(self, w: _Worker, handle: QueryHandle,
                         exc: BaseException) -> None:
        """The worker's runner raised outside the query (the
        ``service.worker_crash`` fault, or something broken): the thread
        is about to exit. Correct the pool, respawn, strike the template,
        and requeue the handle, or fail it once its replay budget (or the
        quarantine) is spent."""
        fail_with = None
        with self._cond:
            if not w.lost:
                # the watchdog may have abandoned this worker already; it
                # then owns both corrections
                w.lost = True
                self._running -= 1
                self._note_worker_lost_locked(w)
            else:
                self._drop_worker_locked(w)
            if not handle.done:
                quarantined_now = self._strike_locked(
                    handle, f"worker {w.name} killed by "
                            f"{type(exc).__name__}: {exc}")
                blocked = (quarantined_now or QUARANTINE.is_quarantined(
                    handle.template_fp) is not None)
                if (not self._shutdown and not blocked
                        and handle.requeues < self._WORKER_LOSS_REPLAYS
                        and self._requeue_locked(handle)):
                    pass
                elif blocked:
                    fail_with = QueryQuarantinedError(
                        "query template quarantined: it killed "
                        f"{len(QUARANTINE.history(handle.template_fp))}"
                        " worker(s)/device(s)",
                        strikes=QUARANTINE.history(handle.template_fp))
                else:
                    fail_with = WorkerLostError(
                        f"worker {w.name} died running this query "
                        f"({type(exc).__name__}: {exc}); replay budget "
                        f"spent after {handle.requeues} requeues")
            self._cond.notify_all()
        if fail_with is not None:
            if handle._transition(QueryState.FAILED, error=fail_with):
                self._count_event("failed")

    def _on_device_lost(self, handle: QueryHandle,
                        exc: DeviceLostError) -> None:
        """The device died under this query. The session's recovery
        (runtime/health.py) already dropped the device caches and probed
        the context: DeviceLostError is RETRYABLE, so the service requeues
        the query up to its budget. After the CPU-only latch the replay
        plans every node onto the CPU route
        (``TorchSession._execute_cpu_only``) and completes."""
        fail_with: BaseException = exc
        with self._cond:
            self._degraded_pending = self._DEGRADE_CLEAR_SUCCESSES
            if handle.done:
                # the watchdog's hard timeout won: nothing to strike or
                # replay (a phantom strike would push an innocent template
                # toward quarantine)
                return
            quarantined_now = self._strike_locked(
                handle, f"device loss during execution: {exc}")
            blocked = (quarantined_now or QUARANTINE.is_quarantined(
                handle.template_fp) is not None)
            if (not self._shutdown and not blocked
                    and handle.requeues < self._DEVICE_LOSS_REPLAYS
                    and self._requeue_locked(handle)):
                return
            if blocked:
                fail_with = QueryQuarantinedError(
                    "query template quarantined: it killed the device "
                    f"{len(QUARANTINE.history(handle.template_fp))} "
                    "time(s)",
                    strikes=QUARANTINE.history(handle.template_fp))
        if handle._transition(QueryState.FAILED, error=fail_with):
            self._count_event("failed")

    def _worker_loop(self, w: _Worker):
        while True:
            with self._cond:
                handle = None
                while handle is None:
                    if self._shutdown or w.lost:
                        self._drop_worker_locked(w)
                        return
                    self._sweep_expired_locked()
                    handle = self._pick_locked()
                    if handle is None:
                        self._cond.wait(timeout=self._SWEEP_INTERVAL_S)
                if not handle._transition(QueryState.ADMITTED):
                    continue  # terminal while queued; take another
                self._running += 1
                w.handle = handle
            died = False
            try:
                self._run(handle)
            except BaseException as exc:
                # the RUNNER died, not the query (_run absorbs the query's
                # failures): the death protocol, then this thread exits
                died = True
                self._on_worker_death(w, handle, exc)
                return
            finally:
                if not died:
                    with self._cond:
                        w.handle = None
                        lost = w.lost
                        if lost:
                            # abandoned mid-query: the watchdog already
                            # corrected the running count
                            self._drop_worker_locked(w)
                        else:
                            self._running -= 1
                        self._cond.notify_all()
                    if lost:
                        return

    def _run(self, handle: QueryHandle):
        # a mesh service serializes the whole launch window BEFORE the
        # RUNNING transition: the hard wall measures from RUNNING, so the
        # gate's wait books as queue time
        if self._mesh_gate is not None:
            with self._mesh_gate:
                self._run_exclusive(handle)
        else:
            self._run_exclusive(handle)

    def _run_exclusive(self, handle: QueryHandle):
        if not handle._transition(QueryState.RUNNING):
            return
        # an exception here is the WORKER dying (outside the query's own
        # try): it reaches _worker_loop's death protocol
        fault_point("service.worker_crash")
        t0 = time.monotonic()
        try:
            # a cancel or deadline that raced the pop wins before any
            # serve, a cache hit included
            handle.scope.check()
            # the epoch vector before execution: a write that lands while
            # this query runs stales the entry it fills
            epochs = (epoch_snapshot(plan_table_ids(handle.plan))
                      if self.result_cache is not None else None)
            fp = (fingerprint(handle.plan, self.conf)
                  if self.result_cache is not None else None)
            cached = (self.result_cache.get(fp)
                      if self.result_cache is not None else None)
            if cached is not None:
                handle.cache_hit = True
                self._emit_cache_hit_record(handle, cached,
                                            time.monotonic() - t0)
                if handle._transition(QueryState.FINISHED,
                                      result=cached.table):
                    self._count_event("finished")
                    self._note_finished(handle)
                return
            with self._device_context(), cancel_scope(handle.scope):
                self.session.next_query_tag = handle.tag
                if handle.sql_text:
                    self.session.next_query_sql = handle.sql_text
                self.session.next_query_service = {
                    "tenant": handle.tenant,
                    "pool": handle.pool,
                    "queueWaitS": round(handle.queue_wait_s or 0.0, 6),
                    "cacheHit": False,
                    "quarantined": self._handle_has_strikes(handle),
                }
                table = self.session.execute(handle.plan)
            # this thread's record, never another worker's
            handle.event_record = self.session._q.event_record
            if self.result_cache is not None:
                self.result_cache.put(fp, table, handle.event_record,
                                      epochs=epochs)
            if handle._transition(QueryState.FINISHED, result=table):
                self._count_event("finished")
                self._note_finished(handle)
        except QueryCancelledError as exc:
            if handle._transition(QueryState.CANCELLED, error=exc):
                self._count_event("cancelled")
        except QueryTimeoutError as exc:
            if handle._transition(QueryState.TIMED_OUT, error=exc):
                self._count_event("timed_out")
        except DeviceLostError as exc:
            self._on_device_lost(handle, exc)
        except BaseException as exc:
            if handle._transition(QueryState.FAILED, error=exc):
                self._count_event("failed")
        finally:
            with self._cond:
                self._charge_locked(handle, time.monotonic() - t0)

    def _device_context(self):
        """The session's device as this worker thread's current CUDA
        device while the query runs: a hand-written kernel launches on the
        launching thread's current device, and a new thread's is device 0.
        No CUDA call once the process latched CPU-only (a poisoned context
        raises at every one)."""
        from contextlib import nullcontext
        dev = self.session.device
        if dev.type != "cuda" or HEALTH.cpu_only_reason() is not None:
            return nullcontext()
        import torch
        return torch.cuda.device(dev)

    def _emit_cache_hit_record(self, handle: QueryHandle, entry,
                               serve_s: float) -> None:
        """A cache hit still shows in the event log: the filling run's
        record replays with the serve's attribution (tenant, pool, queue
        wait, cacheHit, serve wall) and every per-run count at 0, since
        nothing executed."""
        from spark_rapids_tpu_torch.conf import EVENT_LOG_ENABLED
        if entry.event_record is None or not bool(
                self.conf.get_entry(EVENT_LOG_ENABLED)):
            return
        s = self.session
        with s._obs_lock:
            idx = s._obs_query_seq
            s._obs_query_seq += 1
        rec = dict(entry.event_record)
        rec.update({
            "queryIndex": idx,
            "queryTag": handle.tag,
            "wallS": round(serve_s, 6),
            "tenant": handle.tenant,
            "pool": handle.pool,
            "queueWaitS": round(handle.queue_wait_s or 0.0, 6),
            "cacheHit": True,
            "compileMs": 0.0,
            "executableCacheHit": False,
            "padWasteRows": 0,
            "healthState": HEALTH.state(),
            "quarantined": self._handle_has_strikes(handle),
            "deviceReinits": 0,
            "workerRestarts": 0,
            "meshShape": _mesh_shape(),
            "iciBytes": 0,
            "shardSkew": 0.0,
            "meshDegradations": 0,
            "shardRetries": 0,
            "gatherChecksFailed": 0,
            "hostTopology": _host_topology(),
            "hostsLost": 0,
            "hostRelands": 0,
            "dcnExchanges": 0,
            "hostScans": {},
            "oomRetries": 0,
            "splitRetries": 0,
            "spillBytes": 0,
            "unspills": 0,
            "budgetPeak": _mem_budget_peak(),
            "microBatches": 0,
            "mvRefreshes": 0,
            "mvIncrementalRefreshes": 0,
            "mvFullRecomputes": 0,
            "sinkCommits": 0,
            "sinkReplays": 0,
        })
        handle.event_record = rec
        try:
            s._write_event_record(rec)
        except OSError as exc:  # best-effort, like the session's writer
            print(f"spark_rapids_tpu_torch: cache-hit event emission "
                  f"failed: {exc}")

    # -- lifecycle ------------------------------------------------------------
    def shutdown(self, wait: bool = True) -> None:
        """Stop accepting, and stop the workers after their current query.
        Still-queued handles are CANCELLED so that their waiters unblock."""
        with self._cond:
            self._shutdown = True
            for (pool, _t), dq in self._queues.items():
                while dq:
                    h = dq.popleft()
                    self._queued_per_pool[pool] -= 1
                    if h._transition(QueryState.CANCELLED,
                                     error=QueryCancelledError(
                                         "service shut down")):
                        self.counters["cancelled"] += 1
            self._cond.notify_all()
            workers = list(self._workers)
        if wait:
            for w in workers:
                w.thread.join(timeout=30)
            self._sweeper.join(timeout=5)
            self._watchdog.join(timeout=5)
        if self.introspect is not None:
            self.introspect.shutdown()
            self.introspect = None
        # stop recurring streams and detach the MV registry's epoch
        # listener so neither outlives the service
        with self._streams_lock:
            streams, mvs = list(self._streams.values()), self._mvs
            self._streams.clear()
            self._mvs = None
        for st in streams:
            try:
                st.stop(wait=wait)
            except Exception:
                pass
        if mvs is not None:
            mvs.close()

    def __enter__(self) -> "QueryService":
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- introspection --------------------------------------------------------

    #: FINISHED handles kept per (pool, tenant) for the rolling SLOs
    _SLO_WINDOW = 512

    def _note_finished(self, handle: QueryHandle) -> None:
        lat, run = handle.latency_s, handle.run_s
        with self._cond:
            dq = self._finished_lat.setdefault(
                (handle.pool, handle.tenant),
                deque(maxlen=self._SLO_WINDOW))
            dq.append((lat or 0.0, run or 0.0))

    @staticmethod
    def _pcts(vals: List[float]) -> Dict[str, float]:
        ordered = sorted(vals)
        n = len(ordered)

        def pct(q: float) -> float:
            return ordered[min(n - 1, int(q * n))]

        return {"p50S": round(pct(0.50), 6), "p95S": round(pct(0.95), 6)}

    def slo_snapshot(self) -> dict:
        """Rolling per-pool and per-tenant p50/p95 over recently FINISHED
        handles: ``latency`` is submit to finish (queue wait included),
        ``run`` the running wall only."""
        with self._cond:
            windows = [((p, t), list(dq))
                       for (p, t), dq in self._finished_lat.items() if dq]
        pools: Dict[str, dict] = {}
        tenants: Dict[str, dict] = {}
        by_pool: Dict[str, list] = {}
        for (pool, tenant), samples in windows:
            by_pool.setdefault(pool, []).extend(samples)
            tenants[f"{pool}/{tenant}"] = {
                "count": len(samples),
                "latency": self._pcts([s[0] for s in samples]),
                "run": self._pcts([s[1] for s in samples]),
            }
        for pool, samples in by_pool.items():
            pools[pool] = {
                "count": len(samples),
                "latency": self._pcts([s[0] for s in samples]),
                "run": self._pcts([s[1] for s in samples]),
            }
        return {"window": self._SLO_WINDOW, "pools": pools,
                "tenants": dict(sorted(tenants.items()))}

    def query_table(self, blocking: bool = True) -> Optional[List[dict]]:
        """The live query table: RUNNING handles (from the workers) and
        QUEUED ones. ``blocking=False`` is the flight recorder's: a
        contended lock yields None instead of a wait."""
        if not self._cond.acquire(blocking=blocking):
            return None
        try:
            now = time.monotonic()
            out: List[dict] = []
            for w in self._workers:
                h = w.handle
                if h is None:
                    continue
                out.append({
                    "id": h.query_id, "state": h.state,
                    "tenant": h.tenant, "pool": h.pool, "tag": h.tag,
                    "worker": w.name,
                    "runningS": (round(now - h.start_t, 3)
                                 if h.start_t is not None else None),
                })
            for (pool, tenant), dq in self._queues.items():
                for h in dq:
                    out.append({
                        "id": h.query_id, "state": "QUEUED",
                        "tenant": tenant, "pool": pool, "tag": h.tag,
                        "queuedS": round(now - h.submit_t, 3),
                    })
        finally:
            self._cond.release()
        return out

    def _fleet_degraded_reason(self) -> Optional[str]:
        """The shedding input beside the service's own worker losses: a
        cluster below its declared host strength (or latched
        single-process), and the memory arbiter's occupancy over its
        fraction of the budget."""
        if self._degrade_on_host_loss:
            from spark_rapids_tpu_torch.runtime.cluster import CLUSTER
            hosts = CLUSTER.health_snapshot()
            if hosts["enabled"]:
                if hosts["singleProcessReason"]:
                    return ("cluster latched single-process: "
                            f"{hosts['singleProcessReason']}")
                if hosts["lostHosts"] or hosts["excludedHosts"]:
                    return (
                        "cluster below declared strength: "
                        f"{len(hosts['liveHosts'])}/"
                        f"{hosts['declaredHosts']} live (lost="
                        f"{hosts['lostHosts']}, excluded="
                        f"{hosts['excludedHosts']})")
        frac = self._degrade_memory_fraction
        if frac > 0.0:
            from spark_rapids_tpu_torch.runtime.memory import MEMORY
            budget = MEMORY.budget_bytes()
            occupancy = MEMORY.occupancy()
            if budget > 0 and occupancy > frac * budget:
                return (f"arbiter occupancy {occupancy}B over {frac:g} x "
                        f"budget {budget}B")
        return None

    def _health_state_locked(self) -> str:
        """HEALTHY -> DEGRADED -> CPU_ONLY. CPU_ONLY is the process's
        device latch; DEGRADED while the device is mid loss-streak, while
        this service recently lost workers and has not completed
        _DEGRADE_CLEAR_SUCCESSES queries since, or while the arbiter is
        over its occupancy fraction. Caller holds the condition lock."""
        device = HEALTH.state()
        if device == "CPU_ONLY":
            return "CPU_ONLY"
        if (device == "DEGRADED" or self._degraded_pending > 0
                or self._fleet_degraded_reason() is not None):
            return "DEGRADED"
        return "HEALTHY"

    def topology_snapshot(self) -> dict:
        """One coherent health, quarantine and memory view, taken with
        their locks held together (runtime/health.py); the ``/topology``
        route."""
        from spark_rapids_tpu_torch.runtime.health import (
            consistent_topology_snapshot,
        )
        return consistent_topology_snapshot()

    def health(self) -> dict:
        """The service's health surface (admission's states, and what
        ``tools loadtest`` reports)."""
        topo = self.topology_snapshot()
        with self._cond:
            out = {
                "state": self._health_state_locked(),
                "workersLost": self._workers_lost,
                "workersRespawned": self._workers_respawned,
                "workerCount": len(self._workers),
                "degradedPendingSuccesses": self._degraded_pending,
                "shedPool": self._shed_pool,
                "fleetDegradedReason": self._fleet_degraded_reason(),
            }
        out["cpuOnlyReason"] = topo["cpuOnlyReason"]
        out["device"] = topo["backend"]
        out["quarantine"] = topo["quarantine"]
        out["mesh"] = topo["mesh"]
        out["hosts"] = topo["hosts"]
        out["memory"] = topo["memory"]
        out["topologyGeneration"] = topo["generation"]
        return out

    def stats(self) -> dict:
        # everything mutated under _cond is read under it: a concurrent
        # worker can never hand back a torn view
        with self._cond:
            out = {
                **self.counters,
                "running": self._running,
                "queued": {p: n for p, n in self._queued_per_pool.items()
                           if n},
                "heldForMemory": self._held_for_memory,
                "healthState": self._health_state_locked(),
                "workersLost": self._workers_lost,
                "workersRespawned": self._workers_respawned,
                "poolClocks": {p: round(c, 6)
                               for p, c in self._pool_clock.items()},
                "tenantClocks": {f"{p}/{t}": round(c, 6)
                                 for (p, t), c in
                                 self._tenant_clock.items()},
            }
        out["quarantine"] = QUARANTINE.snapshot()
        if self.result_cache is not None:
            out["resultCache"] = self.result_cache.stats()
        return out

    # -- recurring streams ---------------------------------------------------
    def register_stream(self, stream) -> None:
        """Register a recurring tenant (a StreamingQuery) for the
        introspection surfaces; the latest registration wins a name."""
        with self._streams_lock:
            self._streams[stream.name] = stream

    def unregister_stream(self, name: str) -> None:
        with self._streams_lock:
            self._streams.pop(name, None)

    def streams(self) -> List[dict]:
        """Descriptors of every registered recurring stream (name, source
        kind, pool and tenant, batch and offset progress, state):
        rendered by ``tools top`` and served on /streams and /top."""
        with self._streams_lock:
            items = sorted(self._streams.items())
        out = []
        for _, st in items:
            try:
                out.append(st.describe())
            except Exception:
                pass  # a dying stream must not break introspection
        return out

    def mv_registry(self):
        """The service's MaterializedViewRegistry (streaming/mv.py),
        created on first use over the shared session and torn down with
        the service (its epoch listener must not outlive it)."""
        with self._streams_lock:
            if self._mvs is None:
                from spark_rapids_tpu_torch.streaming.mv import (
                    MaterializedViewRegistry,
                )
                self._mvs = MaterializedViewRegistry(self.session)
            return self._mvs
