"""The port's session: a thin front door that converts a plan into device
execs, drains them through the placement layer (speculative sizing, the
device semaphore) under the recovery envelope (the circuit breaker's
replays, the memory degradation ladder, device-loss handling) and
downloads the result (the reference's TpuSession without the event log,
executable cache, AQE and the mesh and host ladders, none of which is
ported yet), with its SQL entry points (``sql``, ``table``, ``catalog``).

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
stats row. Delta and Iceberg raise naming their ROADMAP item.
``spark.rapids.test.faults`` arms the fault registry at each execute."""

from __future__ import annotations

from typing import Dict, Optional

from spark_rapids_tpu_torch import resolve_device
from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.plan import nodes as P

#: the process-wide metric scopes whose per-query change last_metrics adds
RUNTIME_SCOPES = ("memory", "spill", "semaphore", "write", "health",
                  "recovery")


class TorchSession:
    """Runs plans on one torch device. ``device=None`` means the current
    CUDA device and raises when there is none; pass ``device="cpu"`` to
    run the kernels' plain torch versions on the CPU."""

    def __init__(self, conf: Optional[dict] = None, device=None):
        self.device = resolve_device(device)
        self.conf = RapidsConf(conf)
        self._last_root: Optional[TpuExec] = None
        self._last_replays = 0
        self._last_fault_replays = 0
        self._last_runtime: Dict[str, float] = {}
        self._catalog = None
        self._placement = None

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
        return lower_statement(self, text)

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

    def read_delta(self, path, **options):
        return self.read_format("delta", path, **options)

    def read_iceberg(self, path, **options):
        return self.read_format("iceberg", path, **options)

    def execute(self, plan: P.PlanNode) -> HostTable:
        """Run ``plan`` through the recovery envelope
        (``_execute_with_recovery``) and the placement layer's drain
        (speculative sizing and its replays, the device semaphore). The
        replay counts are ``last_metrics()``'s ``speculationReplays`` and
        ``runtimeFaultReplays``. A ``WriteFiles`` plan runs its child so,
        then writes and commits its files. Once a device loss latched the
        process, raises that DeviceLostError."""
        from spark_rapids_tpu_torch.conf import TEST_FAULTS
        from spark_rapids_tpu_torch.obs.metrics import scopes_snapshot
        from spark_rapids_tpu_torch.runtime.faults import FAULTS
        from spark_rapids_tpu_torch.runtime.health import HEALTH
        from spark_rapids_tpu_torch.runtime.memory import MEMORY
        FAULTS.arm(str(self.conf.get_entry(TEST_FAULTS) or ""))
        HEALTH.check_latch()
        before = scopes_snapshot()
        if isinstance(plan, P.WriteFiles):
            try:
                return plan.run(self)
            finally:
                self._last_runtime = _scope_delta(before, scopes_snapshot())
        MEMORY.reset_peak()
        try:
            return self._execute_with_recovery(plan)
        finally:
            self._last_runtime = _scope_delta(before, scopes_snapshot())

    def _execute_with_recovery(self, plan: P.PlanNode) -> HostTable:
        """Plan and drain ``plan``, each attempt afresh, under the port of
        the reference's recovery layers (``session.py:563-818``, less the
        mesh and host ladders, ROADMAP item 11):

        * an OOM that escaped every retry (a FatalDeviceOOM, or a
          retryable one wrapped as such) walks the memory ladder
          (runtime/health.py): a full spill and a same-shape replay, then
          a replay with the scans chunked at half their share, then the
          FatalDeviceOOM, naming the rung the reference would take;
        * a fatal device error writes a crash report (or exits 20 under
          ``spark.rapids.fatalError.exit``), hands recovery to the health
          monitor and raises DeviceLostError;
        * a KernelCrashError replays the query (within
          ``runtimeFallback.maxFailures`` failures of one operator, when
          ``runtimeFallback.enabled``); the failure that trips the
          circuit breaker raises, where the reference demotes the
          operator to its CPU path."""
        from contextlib import nullcontext

        from spark_rapids_tpu_torch.conf import (
            RUNTIME_FALLBACK_ENABLED,
            RUNTIME_FALLBACK_MAX_FAILURES,
        )
        from spark_rapids_tpu_torch.errors import (
            DeviceLostError,
            FatalDeviceOOM,
            KernelCrashError,
        )
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
        # enough to trip every operator of a plan, never unbounded on an
        # unattributed crash
        max_replays = 4 * max_failures + 4
        replays = mem_replays = 0
        self._last_fault_replays = 0
        force_chunk = None
        while True:
            chunk_ctx = (forced_chunking(force_chunk)
                         if force_chunk is not None else nullcontext())
            force_chunk = None
            try:
                with chunk_ctx:
                    result = self._execute_attempt(plan)
                self._last_fault_replays = replays
                HEALTH.note_success()
                return result
            except Exception as exc:
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
                    if action == "abort":
                        raise HEALTH.abort_error(exc) from exc
                    mem_replays += 1
                    RECOVERY.bump("query_replays")
                    if action == "chunk":
                        force_chunk = max(1, MEMORY.scan_chunk_bytes() // 2)
                    continue
                if is_fatal_device_error(exc):
                    report = handle_fatal(exc, self.conf, tree_string(
                        self._last_root or plan))
                    state = HEALTH.on_device_loss(exc, self.conf,
                                                  self.device, report)
                    lost = DeviceLostError(
                        f"device lost during execution "
                        f"({type(exc).__name__}: "
                        f"{str(exc).splitlines()[0] if str(exc) else ''}); "
                        f"crash report {report or 'not written'}; " + (
                            HEALTH.latch_reason() if state == "LATCHED"
                            else "the context probe passed: the next "
                                 "query runs on the card"))
                    lost.fault_op = getattr(exc, "fault_op", None)
                    lost.report_path = report
                    raise lost from exc
                if not rf_enabled or not isinstance(exc, KernelCrashError) \
                        or replays >= max_replays \
                        or CIRCUIT_BREAKER.reason(
                            getattr(exc, "fault_op", None)) is not None:
                    raise
                op = getattr(exc, "fault_op", None)
                if op is not None and CIRCUIT_BREAKER.record_failure(
                        op, exc, max_failures):
                    tripped = KernelCrashError(CIRCUIT_BREAKER.reason(op))
                    tripped.fault_op = op
                    raise tripped from exc
                replays += 1
                RECOVERY.bump("query_replays")

    def _execute_attempt(self, plan: P.PlanNode) -> HostTable:
        """One attempt: start the device manager and configure the memory
        arbiter (a lost device raises here too, inside the recovery),
        convert (the circuit breaker's check runs in the tag), install the
        fault boundaries, arm ``spark.rapids.sql.test.injectRetryOOM``
        and drain."""
        from spark_rapids_tpu_torch.conf import (
            RETRY_OOM_MAX_RETRIES,
            TEST_INJECT_RETRY_OOM,
        )
        from spark_rapids_tpu_torch.overrides.input_file import (
            rewrite_input_file_exprs,
        )
        from spark_rapids_tpu_torch.overrides.rules import convert
        from spark_rapids_tpu_torch.runtime.faults import (
            install_fault_boundaries,
        )
        from spark_rapids_tpu_torch.runtime.memory import MEMORY
        from spark_rapids_tpu_torch.runtime.retry import MAX_RETRIES_VAR
        self._last_root, self._last_replays = None, 0
        self.runtime  # noqa: B018 (starts the device manager)
        MEMORY.configure(self.conf)
        root = convert(rewrite_input_file_exprs(plan), self.conf,
                       self.device)
        install_fault_boundaries(root)
        self._last_root = root
        _arm_injection(str(self.conf.get_entry(TEST_INJECT_RETRY_OOM)))
        tok = MAX_RETRIES_VAR.set(int(self.conf.get_entry(
            RETRY_OOM_MAX_RETRIES)))
        try:
            return self.placement.drain(root)
        finally:
            MAX_RETRIES_VAR.reset(tok)

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
        stack = [self._last_root] if self._last_root is not None else []
        while stack:
            e = stack.pop()
            for k, v in e.metrics.items():
                out[k] = out.get(k, 0) + v
            stack.extend(e.children)
        out.update({k: v for k, v in self._last_runtime.items()
                    if _kind(k) != "timing"})
        return out

    def last_timings(self) -> Dict[str, float]:
        """The most recent execute()'s runtime timings in seconds
        (``acquireWaitTime``, ``spillTime``): kept apart from
        ``last_metrics``, whose counters repeat from run to run."""
        return {k: v for k, v in self._last_runtime.items()
                if _kind(k) == "timing"}


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
    """The nonzero change of each counter of the runtime scopes."""
    out = {}
    for scope in RUNTIME_SCOPES:
        b = before.get(scope, {})
        for k, v in after.get(scope, {}).items():
            d = v - b.get(k, 0)
            if d:
                out[k] = out.get(k, 0) + d
    return out
