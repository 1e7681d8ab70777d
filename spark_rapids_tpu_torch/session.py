"""The port's session: the front door that converts a plan into device
execs, drains them through the placement layer (speculative sizing, the
device semaphore, the asynchronous result fetch) under the recovery
envelope (the circuit breaker's replays, the memory degradation ladder,
device-loss handling, the poison-query strikes) and the query envelope
(the reference's ``TpuSession.execute`` and ``_plan_and_drain``, the
mesh and host ladders included):

* the executable cache (plan/executable_cache.py): a repeated plan checks
  out its converted tree and runs no conversion;
* LORE ids and dumps (lore.py), the fault boundaries
  (runtime/faults.py), the observation boundaries (obs/spans.py) and,
  outermost, the cancellation boundaries (service/query.py), installed
  in the reference's order;
* the profiler around the drain (runtime/profiler.py,
  ``spark.rapids.profile.*``);
* the span tracer and the event log (obs/events.py,
  ``spark.rapids.trace.*``, ``spark.rapids.sql.eventLog.*``): one JSONL
  record per top-level query, with the phase times ``planS``,
  ``executeS`` and ``collectS``, the dispatches and the compile time.

A nested execute (a cached relation's materialization, a WriteFiles
plan's child) rides the outer query's envelope: no record, no profiler
index, no cache checkout. In-flight query state is per thread
(``_TLQueryState``), so sessions may run queries from several threads:
the query service's workers (service/scheduler.py) share one session,
and each hands its query's tenant, pool, queue wait and strikes to the
event record through ``next_query_service``.

Each session starts the process's device manager for its device
(runtime/device_manager.py), configures the memory arbiter's budget from
its conf per query (runtime/memory.py), and per attempt arms
``spark.rapids.sql.test.injectRetryOOM`` and sets the OOM retries; its
``last_metrics()`` adds the query's memory, spill, semaphore, write,
health and recovery counters.

File sources: ``read_parquet``, ``read_orc``, ``read_avro``,
``read_csv``, ``read_json``, ``read_hive_text``, ``read`` (the provider
SPI's ``DataFrameReader``) and ``read_format``; a ``WriteFiles`` plan runs
its child through the overrides, then the committed write, and returns the
stats row; every WriteFiles run, success or failure, bumps the warehouse
invalidation epoch. ``read_delta``, ``delta_table`` and ``read_iceberg``
read the table formats (delta/, iceberg/).
``spark.rapids.test.faults`` arms the fault registry at each execute."""

from __future__ import annotations

import threading
from typing import Dict, Optional

from spark_rapids_tpu_torch import resolve_device
from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.lockorder import ordered_lock
from spark_rapids_tpu_torch.plan import nodes as P

#: the process-wide metric scopes whose per-query change last_metrics adds
RUNTIME_SCOPES = ("memory", "spill", "semaphore", "write", "health",
                  "recovery", "mesh", "cluster", "shuffle")


class _TLQueryState:
    """Per-(session, thread) in-flight query state: a session may run
    queries from several threads at once, so what one execute() writes
    while it runs is thread-local. ``last_*`` reads fall back to the
    session-wide mirror of the last completed query."""

    __slots__ = ("exec_depth", "next_tag", "next_sql", "next_service",
                 "next_mv_epoch", "stream_deltas", "phases",
                 "executable", "dispatches", "event_record", "event_path",
                 "exec_cache_token", "exec_cache_hit", "compile_ms",
                 "meta")

    def __init__(self):
        for name in self.__slots__:
            setattr(self, name, None)
        self.exec_depth = 0


def _tl_mirrored(tls_field: str, doc: str):
    """Property: this thread's value, else the session-wide mirror of the
    last completed query; a write updates both."""

    def _get(self):
        v = getattr(self._q, tls_field)
        return v if v is not None else self._mirror.get(tls_field)

    def _set(self, value):
        setattr(self._q, tls_field, value)
        self._mirror[tls_field] = value

    return property(_get, _set, doc=doc)


def _tl_only(tls_field: str, doc: str):
    def _get(self):
        return getattr(self._q, tls_field)

    def _set(self, value):
        setattr(self._q, tls_field, value)

    return property(_get, _set, doc=doc)


class TorchSession:
    """Runs plans on one torch device. ``device=None`` means the current
    CUDA device and raises when there is none; pass ``device="cpu"`` to
    run the kernels' plain torch versions on the CPU."""

    next_query_tag = _tl_only(
        "next_tag", "query tag the NEXT execute() on this thread records")
    next_query_sql = _tl_only(
        "next_sql", "SQL text the NEXT execute() on this thread records")
    next_query_service = _tl_only(
        "next_service", "service envelope (tenant, pool, queue wait, cache "
        "hit, quarantine strikes) the NEXT execute() on this thread "
        "records")
    next_query_mv_epoch = _tl_only(
        "next_mv_epoch", "materialized-view epoch (the maintained table's "
        "Delta version) the NEXT execute() on this thread records as "
        "mvEpoch: set by the MV serve path, null otherwise")

    def stage_stream_delta(self, key: str, n: int = 1) -> None:
        """Attribute streaming work (microBatches, mvRefreshes, ...,
        sinkReplays) and a Delta commit's retries (commitRetries) to the
        NEXT execute() on this thread: that bookkeeping runs between query
        envelopes, so the process-wide scope's change alone would never
        land inside a record's window. Drained by the next record built
        on this thread."""
        q = self._q
        d = q.stream_deltas or {}
        d[key] = d.get(key, 0) + n
        q.stream_deltas = d

    last_dispatches = _tl_mirrored(
        "dispatches", "hand-written kernel launches of the last query "
        "(dispatch.py)")
    last_event_record = _tl_mirrored(
        "event_record", "event-log record of the last query")
    last_event_path = _tl_mirrored(
        "event_path", "event-log path of the last query")
    last_executable_cache_hit = _tl_mirrored(
        "exec_cache_hit", "did the last query check out a cached "
        "converted executable (plan/executable_cache.py)?")
    last_compile_ms = _tl_mirrored(
        "compile_ms", "milliseconds the last query spent building kernel "
        "libraries with nvcc (dispatch.py)")
    _last_phases = _tl_mirrored("phases", "phase times of the last query")
    last_meta = _tl_mirrored(
        "meta", "the overrides' tagged plan of the last query (None when "
        "spark.rapids.sql.enabled is false): its nodes' reasons to run on "
        "the CPU route")
    _last_executable = _tl_mirrored(
        "executable", "executed tree of the last query")

    #: the padding waste the reference records: the port pads nothing it
    #: uploads for a compiler (dispatch.py), so it reads 0
    last_pad_waste_rows = 0

    def __init__(self, conf: Optional[dict] = None, device=None):
        self.device = resolve_device(device)
        self.conf = RapidsConf(conf)
        self._last_root: Optional[TpuExec] = None
        self._last_replays = 0
        self._last_fault_replays = 0
        self._last_runtime: Dict[str, float] = {}
        self._catalog = None
        self._placement = None
        self._profiler = None
        self._tls = threading.local()
        self._mirror: Dict[str, object] = {}
        self._obs_lock = ordered_lock("session.obs")
        self._obs_query_seq = 0
        self._event_writer = None

    @property
    def _q(self) -> _TLQueryState:
        q = getattr(self._tls, "q", None)
        if q is None:
            q = self._tls.q = _TLQueryState()
        return q

    @property
    def profiler(self):
        """The session's profiler (runtime/profiler.py)."""
        if self._profiler is None:
            from spark_rapids_tpu_torch.runtime.profiler import TorchProfiler
            self._profiler = TorchProfiler(self.conf, self.device)
        return self._profiler

    @property
    def runtime(self):
        """The process's device manager for this session's device and
        conf (started on first use)."""
        from spark_rapids_tpu_torch.runtime.device_manager import (
            TpuDeviceManager,
        )
        return TpuDeviceManager.for_session(self.conf, self.device)

    @property
    def placement(self):
        if self._placement is None:
            from spark_rapids_tpu_torch.runtime.placement import (
                PlacementLayer,
            )
            self._placement = PlacementLayer(self)
        return self._placement

    # -- SQL front end -------------------------------------------------------
    @property
    def catalog(self):
        """The session's temp views."""
        if self._catalog is None:
            from spark_rapids_tpu_torch.sql.catalog import SessionCatalog
            self._catalog = SessionCatalog(self)
        return self._catalog

    def sql(self, text: str):
        """One SQL statement (SELECT, CREATE [OR REPLACE] TEMP VIEW, DROP
        VIEW) through the parser and the analyzer onto the plan layer: a
        DataFrame bound to this session, and so to its device, that runs
        through pruning, the overrides and the execs exactly as a
        DSL-built one does."""
        from spark_rapids_tpu_torch.sql import lower_statement
        df = lower_statement(self, text)
        df.sql_text = text
        return df

    def table(self, name: str):
        """DataFrame over a temp view."""
        return self.catalog.table(name)

    def range(self, start: int, end: Optional[int] = None, step: int = 1):
        """spark.range: a LONG column ``id`` made on the device in batches
        of 2^20 rows."""
        from spark_rapids_tpu_torch.plan.dataframe import range_df
        return range_df(start, end, step, self)

    # -- file sources --------------------------------------------------------
    def read_parquet(self, *paths, **options):
        """A DataFrame over Parquet files (globs and directories expand;
        Hive ``key=value`` directories become partition columns).
        ``columns=``, ``filters=`` (pyarrow's forms) and ``reader_type=``
        as the reference's."""
        from spark_rapids_tpu_torch.io.parquet import ParquetScanNode
        from spark_rapids_tpu_torch.plan import DataFrame
        return DataFrame(ParquetScanNode(list(paths), self.conf, **options),
                         self)

    @property
    def read(self):
        """``session.read.format("parquet").load(path)``: the reader
        surface, routed through the source provider SPI."""
        from spark_rapids_tpu_torch.sources import DataFrameReader
        return DataFrameReader(self)

    def read_format(self, fmt: str, *paths, **options):
        from spark_rapids_tpu_torch.plan import DataFrame
        from spark_rapids_tpu_torch.sources import create_scan
        return DataFrame(create_scan(fmt, list(paths), self.conf, **options),
                         self)

    def read_avro(self, *paths, **options):
        return self.read_format("avro", *paths, **options)

    def read_csv(self, *paths, **options):
        return self.read_format("csv", *paths, **options)

    def read_json(self, *paths, **options):
        return self.read_format("json", *paths, **options)

    def read_orc(self, *paths, **options):
        return self.read_format("orc", *paths, **options)

    def read_hive_text(self, *paths, **options):
        return self.read_format("hive-text", *paths, **options)

    def read_delta(self, path, version_as_of=None, **options):
        return self.read_format("delta", path, version_as_of=version_as_of,
                                **options)

    def delta_table(self, path):
        """The ``DeltaTable`` API over the Delta table at ``path``
        (through the provider SPI, as the reference's)."""
        from spark_rapids_tpu_torch.errors import ColumnarProcessingError
        from spark_rapids_tpu_torch.sources import provider_for
        p = provider_for("delta")
        if p is None:
            raise ColumnarProcessingError(
                "delta source provider is not available")
        return p.create_table_api(self, path)

    def read_iceberg(self, path, snapshot_id=None, **options):
        return self.read_format("iceberg", path, snapshot_id=snapshot_id,
                                **options)

    def execute(self, plan: P.PlanNode) -> HostTable:
        """Run one query: the recovery envelope (``_execute_with_recovery``)
        and the placement layer's drain (speculative sizing and its
        replays, the device semaphore) inside the query envelope. When the
        event log or the span tracer is on, spans collect for the query
        and its record is written when it succeeds. A nested execute rides
        the outer envelope. The replay counts are ``last_metrics()``'s
        ``speculationReplays`` and ``runtimeFaultReplays``. A
        ``WriteFiles`` plan runs its child so, then writes and commits its
        files. Once a device loss latched CPU-only mode, every query runs
        wholly on the CPU route (``_execute_cpu_only``)."""
        import time

        from spark_rapids_tpu_torch.conf import (
            EVENT_LOG_ENABLED,
            TEST_FAULTS,
            TRACE_ENABLED,
        )
        from spark_rapids_tpu_torch.obs.metrics import scopes_snapshot
        from spark_rapids_tpu_torch.obs.spans import TRACER
        from spark_rapids_tpu_torch.runtime.faults import FAULTS
        from spark_rapids_tpu_torch.runtime.health import HEALTH
        from spark_rapids_tpu_torch.runtime.memory import MEMORY
        FAULTS.arm(str(self.conf.get_entry(TEST_FAULTS) or ""))
        # the telemetry sampler and the flight recorder follow this
        # session's conf (a no-op when unchanged)
        from spark_rapids_tpu_torch.obs.telemetry import TELEMETRY
        TELEMETRY.configure(self.conf)
        q = self._q
        query_tag, q.next_tag = q.next_tag, None
        sql_text, q.next_sql = q.next_sql, None
        service_info, q.next_service = q.next_service, None
        mv_epoch, q.next_mv_epoch = q.next_mv_epoch, None
        stream_deltas, q.stream_deltas = (q.stream_deltas or {}), None
        if q.exec_depth:
            # nested query: no envelope of its own (its host scans count
            # into the outer query's attribution)
            q.exec_depth += 1
            try:
                return self._execute_plan(plan)
            finally:
                q.exec_depth -= 1

        ev_enabled = bool(self.conf.get_entry(EVENT_LOG_ENABLED))
        tr_enabled = bool(self.conf.get_entry(TRACE_ENABLED))
        obs_active = ev_enabled or tr_enabled
        q.event_record = None
        q.event_path = None
        with self._obs_lock:
            qidx = self._obs_query_seq
            self._obs_query_seq += 1
        before = scopes_snapshot()
        # fresh per-host scan attribution for this top-level query
        from spark_rapids_tpu_torch.runtime.cluster import (
            reset_host_scan_stats,
        )
        reset_host_scan_stats()
        if obs_active:
            from spark_rapids_tpu_torch.runtime.faults import RECOVERY
            before_recovery = RECOVERY.snapshot()
            before_fires = FAULTS.counters()
            before_health = HEALTH.snapshot()
            ctx = TRACER.begin_query(qidx)
        else:
            # another session's observed query may be live on a worker
            # thread: this query's spans must not be adopted into it
            TRACER.begin_unobserved_query()
        q.exec_depth = 1
        t0 = time.perf_counter()
        try:
            if not isinstance(plan, P.WriteFiles) and \
                    HEALTH.cpu_only_reason() is None:
                MEMORY.reset_peak()
            result = self._execute_plan(plan)
        except BaseException:
            if obs_active:
                TRACER.end_query()
            # a failed run may have left the checked-out tree part
            # drained: drop the entry
            self._release_exec_cache(drop=True)
            raise
        finally:
            q.exec_depth = 0
            if not obs_active:
                TRACER.end_unobserved_query()
            self._last_runtime = _scope_delta(before, scopes_snapshot())
            _bump_epoch_on_write(plan)
        if not obs_active:
            self._release_exec_cache()
            return result
        wall_s = time.perf_counter() - t0
        spans = TRACER.end_query()
        record = self._query_record(
            qidx, wall_s, spans, ctx, before, before_recovery,
            before_fires, before_health, query_tag, sql_text,
            service_info, mv_epoch, stream_deltas)
        self.last_event_record = record
        # the record has read the tree's metrics: the cached tree may now
        # serve the next query (which resets them)
        self._release_exec_cache()
        # emission is best-effort: an unwritable log directory must not
        # fail a query that already has its result
        try:
            if ev_enabled:
                self._write_event_record(record)
            if tr_enabled:
                import os

                from spark_rapids_tpu_torch.conf import TRACE_DIR
                from spark_rapids_tpu_torch.obs.spans import (
                    write_chrome_trace,
                )
                trace_dir = str(self.conf.get_entry(TRACE_DIR))
                os.makedirs(trace_dir, exist_ok=True)
                write_chrome_trace(
                    os.path.join(trace_dir, f"query_{qidx}.trace.json"),
                    spans, query_id=qidx)
        except OSError as exc:
            print(f"spark_rapids_tpu_torch: event/trace emission failed "
                  f"(query {qidx}): {exc}")
        return result

    def _execute_plan(self, plan: P.PlanNode) -> HostTable:
        if isinstance(plan, P.WriteFiles):
            return plan.run(self)
        return self._execute_with_recovery(plan)

    def _query_record(self, qidx, wall_s, spans, ctx, before,
                      before_recovery, before_fires, before_health,
                      query_tag, sql_text, service_info=None,
                      mv_epoch=None, stream_deltas=None) -> dict:
        """The query's event record (obs/events.py), its deferred row
        counts read first in one batched fetch."""
        from spark_rapids_tpu_torch.obs import events as E
        from spark_rapids_tpu_torch.obs.metrics import scopes_snapshot
        from spark_rapids_tpu_torch.parallel import mesh as PM
        from spark_rapids_tpu_torch.runtime import cluster as CL
        from spark_rapids_tpu_torch.obs.spans import (
            finalize_observation,
            summarize_spans,
        )
        from spark_rapids_tpu_torch.runtime.faults import (
            CIRCUIT_BREAKER,
            FAULTS,
            RECOVERY,
        )
        from spark_rapids_tpu_torch.runtime.health import HEALTH
        from spark_rapids_tpu_torch.runtime.memory import MEMORY
        q = self._q
        executable = q.executable
        if executable is not None:
            finalize_observation(executable)
        after_recovery = RECOVERY.snapshot()
        after_fires = FAULTS.counters()
        after_health = HEALTH.snapshot()
        after = scopes_snapshot()

        def _wdelta(key: str, scope: str) -> int:
            return int(after.get(scope, {}).get(key, 0)
                       - before.get(scope, {}).get(key, 0))

        stream = stream_deltas or {}
        health_state = ("CPU_ONLY" if after_health["latched"] else
                        "DEGRADED" if after_health["consecutiveLosses"]
                        else "HEALTHY")
        return E.build_query_record(
            query_index=qidx,
            wall_s=wall_s,
            phases=q.phases or {},
            executable=executable,
            sql_text=sql_text,
            query_tag=query_tag,
            dispatches=int(q.dispatches or 0),
            recovery_delta={k: v - before_recovery.get(k, 0)
                            for k, v in after_recovery.items()
                            if v - before_recovery.get(k, 0)},
            scope_deltas=E.scope_delta(before, after),
            fault_fires={k: v - before_fires.get(k, 0)
                         for k, v in after_fires.items()
                         if v - before_fires.get(k, 0)},
            demotions=CIRCUIT_BREAKER.demoted_ops(),
            spans_summary=summarize_spans(spans, ctx.owner_tid, wall_s),
            fault_replays=int(self._last_fault_replays or 0),
            compile_ms=float(q.compile_ms or 0.0),
            executable_cache_hit=bool(q.exec_cache_hit),
            health_state=health_state,
            device_reinits=int(after_health["deviceReinits"]
                               - before_health["deviceReinits"]),
            # the service's watchdog respawns workers while queries run:
            # the health scope's delta attributes restarts to the wall
            # they happened under
            worker_restarts=_wdelta("workersRespawned", "health"),
            service=service_info,
            files_written=_wdelta("filesWritten", "write"),
            bytes_written=_wdelta("bytesWritten", "write"),
            oom_retries=_wdelta("oomRetries", "memory"),
            split_retries=_wdelta("splitRetries", "memory"),
            spill_bytes=_wdelta("spillBytes", "memory"),
            unspills=_wdelta("unspills", "memory"),
            budget_peak=int(MEMORY.peak_bytes()),
            fallbacks=E.collect_fallbacks(q.meta),
            # a Delta commit runs after its write's query: its retries
            # are staged for the next record on this thread
            commit_retries=_wdelta("commitRetries", "write")
            + stream.get("commitRetries", 0),
            # streaming attribution: the scope's change (work done inside
            # this window) plus what the streaming subsystem staged on
            # this thread between envelopes
            mv_epoch=mv_epoch,
            mesh_shape=PM.MESH.shape_str(),
            ici_bytes=_wdelta("iciBytes", "mesh"),
            mesh_degradations=_wdelta("meshDegradations", "health"),
            shard_retries=_wdelta("shardRetries", "mesh"),
            gather_checks_failed=_wdelta("gatherChecksFailed", "mesh"),
            host_topology=CL.CLUSTER.topology_str(),
            hosts_lost=_wdelta("hostsLost", "cluster"),
            host_relands=_wdelta("hostRelands", "cluster"),
            dcn_exchanges=_wdelta("dcnExchanges", "cluster"),
            host_scans=CL.host_scan_stats(),
            **{arg: _wdelta(key, "streaming") + stream.get(key, 0)
               for arg, key in _STREAM_FIELDS})

    def _write_event_record(self, record: dict) -> str:
        """THE event-log append path: the per-session writer is made
        lazily under the obs lock. Raises OSError on a failed write."""
        from spark_rapids_tpu_torch.conf import EVENT_LOG_DIR
        from spark_rapids_tpu_torch.obs import events as E
        with self._obs_lock:
            if self._event_writer is None:
                self._event_writer = E.QueryEventWriter(
                    str(self.conf.get_entry(EVENT_LOG_DIR)))
        E.note_recent_record(record)
        path = self._event_writer.write(record)
        self.last_event_path = path
        return path

    def _release_exec_cache(self, drop: bool = False) -> None:
        """Return this thread's checked-out executable-cache entry, once
        the envelope is done with the tree (after the event record), or
        drop it when the run failed."""
        tok = self._q.exec_cache_token
        self._q.exec_cache_token = None
        if tok is not None:
            tok.release(drop=drop)

    def _strike_fault_template(self, plan: P.PlanNode, exc: BaseException,
                               action: str, domain: str) -> None:
        """A ladder action past the plain retry records a quarantine strike
        against the plan's template (runtime/health.py). Best-effort:
        strike accounting never masks recovery."""
        try:
            from spark_rapids_tpu_torch.plan.fingerprint import (
                template_fingerprint,
            )
            from spark_rapids_tpu_torch.runtime.health import (
                QUARANTINE,
                QUARANTINE_MAX_STRIKES,
            )
            first = (str(exc).splitlines()[0] if str(exc)
                     else type(exc).__name__)
            QUARANTINE.strike(
                template_fingerprint(plan, self.conf),
                f"{domain} execution killed ({action}): "
                f"{type(exc).__name__}: {first}",
                int(self.conf.get_entry(QUARANTINE_MAX_STRIKES)))
        except Exception:
            pass

    def explain(self, plan) -> str:
        """The tagged plan of ``plan`` (a PlanNode or DataFrame), one node
        a line: ``*`` on the device, ``!`` on the CPU route with the
        reasons (every node in ``spark.rapids.sql.explain=ALL``, else the
        root and the nodes with reasons in full), headed by the
        quarantine's verdict on its template when strikes were recorded
        against it."""
        from spark_rapids_tpu_torch.overrides.input_file import (
            rewrite_input_file_exprs,
        )
        from spark_rapids_tpu_torch.overrides.rules import explain_plan
        from spark_rapids_tpu_torch.runtime.health import QUARANTINE
        plan = getattr(plan, "plan", plan)
        out = explain_plan(rewrite_input_file_exprs(plan), self.conf)
        if QUARANTINE.snapshot()["strikes"]:
            from spark_rapids_tpu_torch.plan.fingerprint import (
                template_fingerprint,
            )
            fp = template_fingerprint(plan, self.conf)
            quarantined = QUARANTINE.is_quarantined(fp)
            if quarantined is not None:
                out = ("!! QUARANTINED template: submissions are rejected "
                       f"({len(quarantined)} strikes: "
                       f"{'; '.join(quarantined)})\n" + out)
            elif QUARANTINE.strike_count(fp):
                out = (f"! poison suspect: {QUARANTINE.strike_count(fp)} "
                       "device kill strike(s) recorded against this "
                       "template\n" + out)
        return out

    def execute_cpu_only(self, plan) -> HostTable:
        """Run ``plan`` (a PlanNode or DataFrame) wholly on the CPU route,
        outside the query envelope (the reference's CPU oracle)."""
        return getattr(plan, "plan", plan).collect_cpu()

    def _execute_with_recovery(self, plan: P.PlanNode) -> HostTable:
        """Plan and drain ``plan``, each attempt afresh, under the port of
        the reference's recovery layers (``session.py:563-818``):

        * an OOM that escaped every retry (a FatalDeviceOOM, or a
          retryable one wrapped as such) walks the memory ladder
          (runtime/health.py): a full spill and a same-shape replay, then
          a replay with the scans chunked at half their share, then a
          replay with the attributed operator demoted onto the CPU route
          (``cpu_demote``); without an attributed operator the
          FatalDeviceOOM re-raises;
        * a fatal device error writes a crash report (or exits 20 under
          ``spark.rapids.fatalError.exit``), hands recovery to the health
          monitor and raises DeviceLostError; once the monitor latched
          CPU-only mode, every later query runs on the CPU route
          (``_execute_cpu_only``);
        * a KernelCrashError replays the query (when
          ``runtimeFallback.enabled``): the circuit breaker counts the
          failure of its operator, and the failure that reaches
          ``runtimeFallback.maxFailures`` demotes the operator, which the
          replay's tag plans onto the CPU route.

        * a MeshDeviceLostError (one logical device of the mesh) walks the
          mesh ladder (``retry``, ``single_device``: the replay lands with
          the mesh suppressed, ``shrink``, then the device-loss ladder);
          a HostLostError (a cluster executor) the host ladder (``retry``,
          ``reland``, ``shrink``, ``single_process``: the replay's scans
          stay local, then the device-loss ladder), each within a replay
          budget that walks every rung.

        The ``chunk``, ``cpu_demote`` and ``abort`` rungs and every mesh
        and host rung past ``retry`` strike the plan's template in the
        quarantine; a device loss strikes it in the query service, which
        requeues the query. A replay drops the query's executable-cache
        entry and plans fresh."""
        from contextlib import nullcontext

        from spark_rapids_tpu_torch.conf import (
            CLUSTER_MAX_HOST_LOSSES,
            DEVICE_LOSS_MAX_REINITS,
            MESH_DEGRADE_MAX_SHRINKS,
            RUNTIME_FALLBACK_ENABLED,
            RUNTIME_FALLBACK_MAX_FAILURES,
        )
        from spark_rapids_tpu_torch.errors import (
            DeviceLostError,
            FatalDeviceOOM,
            HostLostError,
            KernelCrashError,
            MeshDeviceLostError,
        )
        from spark_rapids_tpu_torch.parallel import mesh as PM
        from spark_rapids_tpu_torch.runtime import cluster as CL
        from spark_rapids_tpu_torch.runtime.crash_handler import (
            handle_fatal,
            is_fatal_device_error,
            tree_string,
        )
        from spark_rapids_tpu_torch.runtime.faults import (
            CIRCUIT_BREAKER,
            RECOVERY,
        )
        from spark_rapids_tpu_torch.runtime.health import HEALTH
        from spark_rapids_tpu_torch.runtime.memory import (
            MEMORY,
            forced_chunking,
        )
        from spark_rapids_tpu_torch.runtime.retry import is_device_oom
        rf_enabled = bool(self.conf.get_entry(RUNTIME_FALLBACK_ENABLED))
        max_failures = int(self.conf.get_entry(RUNTIME_FALLBACK_MAX_FAILURES))
        # enough to demote every operator of a plan, never unbounded on an
        # unattributed crash; the memory ladder's replays likewise
        max_replays = max_mem_replays = 4 * max_failures + 4
        # the mesh and host ladders: enough to walk every rung (each
        # shrink, each reinit) and no more
        reinits = int(self.conf.get_entry(DEVICE_LOSS_MAX_REINITS))
        max_mesh_replays = int(self.conf.get_entry(
            MESH_DEGRADE_MAX_SHRINKS)) + reinits + 6
        max_host_replays = int(self.conf.get_entry(
            CLUSTER_MAX_HOST_LOSSES)) + reinits + 6
        replays = mem_replays = mesh_replays = host_replays = 0
        self._last_fault_replays = 0
        force_chunk = None
        suppress_mesh = suppress_cluster = None
        while True:
            if HEALTH.cpu_only_reason() is not None:
                result = self._execute_cpu_only(plan)
                self._last_fault_replays = replays
                HEALTH.note_success()
                return result
            chunk_ctx = (forced_chunking(force_chunk)
                         if force_chunk is not None else nullcontext())
            mesh_ctx = (PM.suppressed_mesh(suppress_mesh)
                        if suppress_mesh is not None else nullcontext())
            cluster_ctx = (CL.suppressed_cluster(suppress_cluster)
                           if suppress_cluster is not None
                           else nullcontext())
            was_msup = suppress_mesh is not None
            was_csup = suppress_cluster is not None
            force_chunk = suppress_mesh = suppress_cluster = None
            try:
                with chunk_ctx, mesh_ctx, cluster_ctx:
                    result = self._execute_attempt(plan)
                self._last_fault_replays = replays
                # the mesh ladder resets only on a mesh-NATIVE success,
                # the host ladder only on a cluster-native one
                HEALTH.note_success(
                    mesh_native=not was_msup and PM.MESH.enabled,
                    cluster_native=not was_csup and CL.CLUSTER.active())
                return result
            except Exception as exc:
                if isinstance(exc, HostLostError):
                    # a cluster executor died (the local device is fine)
                    action = HEALTH.on_host_loss(exc, self.conf,
                                                 self.device)
                    if action != "retry":
                        self._strike_fault_template(plan, exc, action,
                                                    "host")
                    if host_replays >= max_host_replays:
                        raise
                    self._drop_cached_tree()
                    host_replays += 1
                    RECOVERY.bump("query_replays")
                    if action in ("single_process", "DEGRADED",
                                  "CPU_ONLY"):
                        # the replay's scans stay local even if a host
                        # rejoins mid-attempt
                        suppress_cluster = HEALTH.host_demotion_note()
                    continue
                if isinstance(exc, MeshDeviceLostError):
                    # one logical device of the mesh lost
                    action = HEALTH.on_mesh_device_loss(exc, self.conf,
                                                        self.device)
                    if action != "retry":
                        self._strike_fault_template(plan, exc, action,
                                                    "mesh")
                    if mesh_replays >= max_mesh_replays:
                        raise
                    self._drop_cached_tree()
                    mesh_replays += 1
                    RECOVERY.bump("query_replays")
                    if action == "single_device":
                        suppress_mesh = HEALTH.mesh_demotion_note()
                    # retry, shrink, DEGRADED and CPU_ONLY replay plain:
                    # the re-plan sees the shrunk mesh or the latch
                    continue
                if is_device_oom(exc) and not isinstance(exc,
                                                         FatalDeviceOOM):
                    # a retryable OOM that escaped every retry wrapper:
                    # the ladder is better than failing the query
                    wrapped = FatalDeviceOOM(
                        f"unhandled retryable OOM escaped to the session "
                        f"({type(exc).__name__}: {exc})")
                    wrapped.fault_op = getattr(exc, "fault_op", None)
                    wrapped.__cause__ = exc
                    exc = wrapped
                if isinstance(exc, FatalDeviceOOM):
                    action = HEALTH.on_memory_pressure(exc, self.conf)
                    if action != "retry":
                        self._strike_fault_template(plan, exc, action,
                                                    "memory")
                    if action == "abort" or mem_replays >= max_mem_replays:
                        raise HEALTH.abort_error(exc) from exc
                    self._drop_cached_tree()
                    mem_replays += 1
                    RECOVERY.bump("query_replays")
                    if action == "chunk":
                        force_chunk = max(1, MEMORY.scan_chunk_bytes() // 2)
                    # "retry" replays at the same shape after the full
                    # spill; "cpu_demote" re-plans with the operator on
                    # the CPU route
                    continue
                if is_fatal_device_error(exc):
                    report = handle_fatal(exc, self.conf, tree_string(
                        self._last_root or plan))
                    self._drop_cached_tree()
                    # the strike is the query service's
                    # (service/scheduler.py::_on_device_lost), as in the
                    # reference: one per loss
                    state = HEALTH.on_device_loss(exc, self.conf,
                                                  self.device, report)
                    lost = DeviceLostError(
                        f"device lost during execution "
                        f"({type(exc).__name__}: "
                        f"{str(exc).splitlines()[0] if str(exc) else ''}); "
                        f"crash report {report or 'not written'}; " + (
                            f"{HEALTH.cpu_only_reason()}: the next query "
                            "runs on the CPU route" if state == "CPU_ONLY"
                            else "the context probe passed: the next "
                                 "query runs on the card"))
                    lost.fault_op = getattr(exc, "fault_op", None)
                    lost.report_path = report
                    raise lost from exc
                if not rf_enabled or not isinstance(exc, KernelCrashError) \
                        or replays >= max_replays:
                    raise
                op = getattr(exc, "fault_op", None)
                if op is not None:
                    CIRCUIT_BREAKER.record_failure(op, exc, max_failures)
                self._drop_cached_tree()
                replays += 1
                RECOVERY.bump("query_replays")

    def _verify_plan(self, root, meta) -> None:
        """``spark.rapids.sql.planVerify.mode``: off, warn (print each
        diagnostic) or error (raise PlanVerificationError, which no
        recovery layer catches); any other value raises. Runs on a fresh
        conversion only (a cache hit was verified when it was made), and
        not at all with ``spark.rapids.sql.enabled=false`` (no meta). The
        verifier reads structure only: no CUDA call, no host sync."""
        from spark_rapids_tpu_torch.conf import PLAN_VERIFY_MODE
        from spark_rapids_tpu_torch.errors import (
            ColumnarProcessingError,
            PlanVerificationError,
        )
        mode = str(self.conf.get_entry(PLAN_VERIFY_MODE)).lower()
        if mode not in ("off", "warn", "error"):
            raise ColumnarProcessingError(
                f"spark.rapids.sql.planVerify.mode must be off, warn or "
                f"error, got {mode!r}")
        if mode == "off" or meta is None:
            return
        from spark_rapids_tpu_torch.lint.plan_verifier import (
            verify_converted,
        )
        diags = verify_converted(root, meta, self.conf)
        if diags and mode == "error":
            raise PlanVerificationError(diags)
        for d in diags:
            print(f"planVerify: {d}")

    def _execute_cpu_only(self, plan: P.PlanNode) -> HostTable:
        """A query of a process latched CPU-only (runtime/health.py): the
        tag gives every node the latch's reason, and the host plan is
        collected on the host. A CUDA context poisoned by a sticky error
        raises at every CUDA call, so this path makes none: no device
        manager, memory budget, executable cache, semaphore, profiler,
        observation boundaries or device transitions."""
        import time

        from spark_rapids_tpu_torch.overrides.input_file import (
            rewrite_input_file_exprs,
        )
        from spark_rapids_tpu_torch.overrides.rules import (
            convert_meta,
            wrap_plan,
        )
        from spark_rapids_tpu_torch.service.query import check_cancelled
        q = self._q
        top = q.exec_depth == 1
        # a host plan collects without exec pulls: the service's cancel
        # and deadline are checked once here
        check_cancelled()
        t0 = time.perf_counter()
        self._last_root, self._last_replays = None, 0
        meta = wrap_plan(rewrite_input_file_exprs(plan), self.conf)
        root = convert_meta(meta, self.device)
        if self.conf.explain_mode in ("NOT_ON_GPU", "ALL"):
            print(meta.explain(
                only_fallback=self.conf.explain_mode == "NOT_ON_GPU"))
        self._last_root = self._last_executable = root
        t1 = time.perf_counter()
        result = root.collect()
        if top:
            self.last_meta = meta
            self.last_executable_cache_hit = False
            self.last_dispatches = 0
            self.last_compile_ms = 0.0
            self._last_phases = {"planS": t1 - t0,
                                 "executeS": time.perf_counter() - t1,
                                 "collectS": 0.0}
        return result

    def _drop_cached_tree(self) -> None:
        """Before a replay: the failed attempt's checked-out tree is
        suspect and a trip must re-plan, so the entry drops (top level
        only: a nested execute holds no token of its own)."""
        if self._q.exec_depth == 1:
            self._release_exec_cache(drop=True)

    def _execute_attempt(self, plan: P.PlanNode) -> HostTable:
        """One attempt: the plan phase (its span closed on failure too),
        then ``_plan_and_drain``."""
        import time

        from spark_rapids_tpu_torch.obs.spans import TRACER
        t_phase = time.perf_counter()
        plan_span = TRACER.begin("plan", "phase") if TRACER.enabled else None
        try:
            return self._plan_and_drain(plan, plan_span, t_phase)
        except BaseException:
            TRACER.end(plan_span)
            raise

    def _plan_and_drain(self, plan: P.PlanNode, plan_span,
                        t_phase: float) -> HostTable:
        """Prepare the placement (the device manager, a lost device raises
        here, inside the recovery; the memory arbiter), check the plan out
        of the executable cache or convert it (the circuit breaker's
        check runs in the tag), number and tee it (LORE, fresh trees
        only), install the fault and then the observation boundaries,
        arm ``spark.rapids.sql.test.injectRetryOOM`` and drain under the
        profiler. A fully successful run fills its cache slot."""
        import time

        from spark_rapids_tpu_torch import lore
        from spark_rapids_tpu_torch.conf import (
            ASYNC_RESULT_FETCH,
            EXECUTABLE_CACHE_ENABLED,
            EXECUTABLE_CACHE_MAX_PLANS,
            EXECUTABLE_CACHE_MAX_VARIANTS,
            METRICS_LEVEL,
            RETRY_OOM_MAX_RETRIES,
            TEST_INJECT_RETRY_OOM,
        )
        from spark_rapids_tpu_torch.dispatch import (
            compile_stats,
            dispatch_count,
            reset_compile_stats,
            reset_dispatch_count,
        )
        from spark_rapids_tpu_torch.obs.metrics import set_metrics_level
        from spark_rapids_tpu_torch.obs.spans import (
            TRACER,
            install_observation,
        )
        from spark_rapids_tpu_torch.execs.base import CpuRootExec
        from spark_rapids_tpu_torch.overrides.input_file import (
            rewrite_input_file_exprs,
        )
        from spark_rapids_tpu_torch.overrides.optimizer import apply_cbo
        from spark_rapids_tpu_torch.overrides.rules import (
            convert_meta,
            wrap_plan,
        )
        from spark_rapids_tpu_torch.runtime.faults import (
            install_fault_boundaries,
        )
        from spark_rapids_tpu_torch.runtime.retry import MAX_RETRIES_VAR
        from spark_rapids_tpu_torch.service.query import install_cancellation
        q = self._q
        top = q.exec_depth == 1
        self._last_root, self._last_replays = None, 0
        plan = rewrite_input_file_exprs(plan)
        self.placement.prepare()
        tok = None
        if top and self.conf.get_entry(EXECUTABLE_CACHE_ENABLED):
            from spark_rapids_tpu_torch.plan.executable_cache import (
                EXEC_CACHE,
            )
            EXEC_CACHE.configure(
                int(self.conf.get_entry(EXECUTABLE_CACHE_MAX_PLANS)),
                int(self.conf.get_entry(EXECUTABLE_CACHE_MAX_VARIANTS)))
            tok = EXEC_CACHE.checkout(plan, self.conf, self.device)
            q.exec_cache_token = tok
        hit = tok is not None and tok.hit
        if top:
            # a nested execute must not clobber the outer query's flag
            self.last_executable_cache_hit = hit
        if hit:
            root, meta = tok.executable, tok.meta
        else:
            if self.conf.sql_enabled:
                # the tags, then the cost-based optimizer, choose each
                # node's route (overrides/rules.py, optimizer.py)
                meta = wrap_plan(plan, self.conf)
                apply_cbo(meta, self.conf)
                root = convert_meta(meta, self.device)
            else:
                # spark.rapids.sql.enabled=false: the whole plan on the
                # CPU route, untagged (the reference's CPU oracle)
                meta, root = None, CpuRootExec(plan)
            # static plan verification (lint/plan_verifier.py): the
            # converted tree's cross-layer invariants, proved before it
            # runs (the reference's session.py:925-944)
            self._verify_plan(root, meta)
            # a cached tree keeps its ids and dumpers (the lore conf folds
            # into its fingerprint): renumbering would shift ids past the
            # dumpers, and install_dumpers is not idempotent
            lore.install_dumpers(root, self.conf)
        if top:
            self.last_meta = meta
        if meta is not None and self.conf.explain_mode in ("NOT_ON_GPU",
                                                           "ALL"):
            print(meta.explain(
                only_fallback=self.conf.explain_mode == "NOT_ON_GPU"))
        set_metrics_level(self.conf.get_entry(METRICS_LEVEL))
        # fault boundaries, then the observation boundaries over them
        # (idempotent per exec: a cached tree is not wrapped twice)
        install_fault_boundaries(root)
        install_observation(root)
        # cancellation outermost: it reads the executing thread's scope
        # at every pull, so it is installed whether or not one is active
        # (a cached tree filled outside the service still honours cancel
        # when the service reuses it)
        install_cancellation(root)
        self._last_root = root
        self._last_executable = root
        TRACER.end(plan_span)
        phases = {"planS": time.perf_counter() - t_phase}
        _arm_injection(str(self.conf.get_entry(TEST_INJECT_RETRY_OOM)))
        tok_r = MAX_RETRIES_VAR.set(int(self.conf.get_entry(
            RETRY_OOM_MAX_RETRIES)))
        if top:
            # a nested execute adds its launches and builds to the outer
            # query's counts
            reset_dispatch_count()
            reset_compile_stats()
        t_phase = time.perf_counter()
        exec_span = TRACER.begin("execute", "phase") \
            if TRACER.enabled else None
        try:
            with self.profiler.profile_query():
                result = self.placement.drain(
                    root, bool(self.conf.get_entry(ASYNC_RESULT_FETCH)))
            if top:
                self.last_dispatches = dispatch_count()
                root.metrics["dispatches"] = self.last_dispatches
        finally:
            MAX_RETRIES_VAR.reset(tok_r)
            TRACER.end(exec_span)
            phases["executeS"] = time.perf_counter() - t_phase
            if top:
                self._last_phases = phases
        # the drain downloaded the result (executeS, resultFetchTime);
        # the collect phase is the hand-off and the compile accounting
        t_phase = time.perf_counter()
        collect_span = TRACER.begin("collect", "phase") \
            if TRACER.enabled else None
        try:
            if top:
                _, compile_s = compile_stats()
                self.last_compile_ms = round(compile_s * 1000.0, 3)
        finally:
            TRACER.end(collect_span)
            phases["collectS"] = time.perf_counter() - t_phase
        if tok is not None and not hit:
            tok.fill(root, meta)
        return result

    def last_metrics(self) -> Dict[str, int]:
        """Metrics of the most recent execute(): the replay count, every
        exec's counters of the attempt that succeeded, summed by name
        (``directJoinBatches``, ``hashProbeBatches``, ...), and the
        query's nonzero memory, spill and semaphore counters
        (``spillBytes``, ``oomRetries``, ``budgetViolations``,
        ``acquires``, ...; process-wide counters, so a query running
        beside others also counts theirs). Timings are
        ``last_timings()``'s."""
        out = {"speculationReplays": self._last_replays,
               "runtimeFaultReplays": self._last_fault_replays}
        for k, v in self._exec_sums().items():
            if _kind(k) != "timing":
                out[k] = v
        out.update({k: v for k, v in self._last_runtime.items()
                    if _kind(k) != "timing"})
        return out

    def _exec_sums(self) -> Dict[str, float]:
        """Every exec's metrics of the last query summed by name, less
        the per-operator ones."""
        out: Dict[str, float] = {}
        stack = [self._last_root] if self._last_root is not None else []
        while stack:
            e = stack.pop()
            for k, v in e.metrics.items():
                if k not in _PER_OPERATOR:
                    out[k] = out.get(k, 0) + v
            stack.extend(e.children)
        return out

    def last_timings(self) -> Dict[str, float]:
        """The most recent execute()'s runtime timings in seconds
        (``acquireWaitTime``, ``spillTime``), the transitions' of the CPU
        route (``h2dTime``, ``d2hTime``) and the root's
        ``resultFetchTime``: kept apart from ``last_metrics``, whose
        counters repeat from run to run."""
        out = {k: v for k, v in self._last_runtime.items()
               if _kind(k) == "timing"}
        out.update({k: v for k, v in self._exec_sums().items()
                    if _kind(k) == "timing"})
        root = self._last_root
        if root is not None and "resultFetchTime" in root.metrics:
            out["resultFetchTime"] = root.metrics["resultFetchTime"]
        return out


#: exec metrics that mean something per operator only (the event record's
#: plan tree has them), left out of last_metrics()'s sums, with the
#: root's resultFetchTime (a timing, in last_timings())
_PER_OPERATOR = frozenset(("opTime", "numOutputRows", "numOutputBatches",
                           "resultFetchTime"))


#: (build_query_record argument, streaming scope counter) of the record's
#: streaming fields
_STREAM_FIELDS = (
    ("micro_batches", "microBatches"), ("mv_refreshes", "mvRefreshes"),
    ("mv_incremental_refreshes", "mvIncrementalRefreshes"),
    ("mv_full_recomputes", "mvFullRecomputes"),
    ("sink_commits", "sinkCommits"), ("sink_replays", "sinkReplays"))


def _kind(name: str) -> str:
    from spark_rapids_tpu_torch.obs.metrics import registered_specs
    spec = registered_specs().get(name)
    return spec.kind if spec is not None else "count"


def _arm_injection(spec: str) -> None:
    """``retry[:N]`` / ``split[:N]``: arm N injected OOMs on this thread
    (the reference's parse of spark.rapids.sql.test.injectRetryOOM)."""
    if not spec:
        return
    from spark_rapids_tpu_torch.runtime.retry import RMM_TPU
    kind, _, num = spec.partition(":")
    count = int(num) if num else 1
    kind = kind.strip().lower()
    if kind == "retry":
        RMM_TPU.force_retry_oom(count)
    elif kind == "split":
        RMM_TPU.force_split_and_retry_oom(count)
    else:
        raise ValueError(f"spark.rapids.sql.test.injectRetryOOM={spec!r}: "
                         "want retry[:N] or split[:N]")


def _scope_delta(before, after) -> Dict[str, float]:
    """The nonzero change of each counter of the runtime scopes. A name
    that more than one scope counts is one event counted in each (the
    spill catalog's and the arbiter's ``spillCorruptions``, as the
    reference's record shows it once per scope): it reports the largest
    change, never their sum."""
    out = {}
    for scope in RUNTIME_SCOPES:
        b = before.get(scope, {})
        for k, v in after.get(scope, {}).items():
            d = v - b.get(k, 0)
            if d:
                out[k] = max(out.get(k, d), d)
    return out


def _bump_epoch_on_write(plan: P.PlanNode) -> None:
    """A WriteFiles run, whether it succeeded or failed (a failed write
    may have changed files on disk), stales every executable-cache entry
    (plan/fingerprint.py's warehouse epoch)."""
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, P.WriteFiles):
            from spark_rapids_tpu_torch.plan.fingerprint import (
                bump_invalidation_epoch,
            )
            bump_invalidation_epoch("WriteFiles")
            return
        stack.extend(getattr(node, "children", ()))
