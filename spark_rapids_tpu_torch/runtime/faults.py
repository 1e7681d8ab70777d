"""Fault injection and recovery bookkeeping (port of
``spark_rapids_tpu/runtime/faults.py``): one conf-driven registry of
NAMED fault points (``spark.rapids.test.faults``), each armed with a
deterministic seeded schedule and a per-point fire counter, the recovery
counters, the backoff loop the engine's retrying readers share, the
per-operator circuit breaker and the exec fault boundaries.

* ``FAULTS``: the process-wide :class:`FaultRegistry`; sites call
  :func:`fault_point` with a name registered in :data:`FAULT_POINTS`.
* ``RECOVERY``: counters of every recovery action, in the ``recovery``
  metric scope.
* :func:`backoff_retry`: the exponential-backoff retry loop.
* ``CIRCUIT_BREAKER``: per-operator non-OOM failure counts. An operator
  that failed ``spark.rapids.sql.runtimeFallback.maxFailures`` times is
  demoted onto the CPU route: ``PlanMeta.tag`` (overrides/rules.py) tags
  every later conversion of it with the breaker's reason, until
  :meth:`CircuitBreaker.reset`.
* :func:`install_fault_boundaries`: the ``exec.execute`` point and op
  attribution (``fault_op``) on every exec of a converted tree.

The points: the scan's per-file decode, the writer's per-file write, the
committer's promotion and abort, each exec's execute, the memory
runtime's reserve, spill and unspill, at each hand-written kernel's
launch (``kernels.kernel_launch``) ``dispatch.kernel``, ``dispatch.wedge``
(a stall on the host side of the launch that only the service watchdog's
hard wall limit ends) and ``device.lost``, and the service worker's
``service.worker_crash``, the Delta log's ``delta.commit.race`` (kind
``race``: a lost optimistic-concurrency race, so the commit's rebase and
retry run without a concurrent writer), and the streams'
``stream.batch`` and ``stream.sink.commit``; the host shuffle's
``shuffle.*``, the mesh's ``mesh.*`` and the cluster's ``host.*`` points
(``device_lost`` at a ``mesh.*`` point raises MeshDeviceLostError, at a
``host.*`` point HostLostError).

Spec grammar, entries separated by ``;``:
``<point>[@<op>]:<kind>:<prob-or-count>[:<seed>]``, where an amount with
a ``.`` is a probability in (0, 1] and one without is a count of fires.
"""

from __future__ import annotations

import os
import random
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

from spark_rapids_tpu_torch.errors import (
    ColumnarProcessingError,
    DeviceLostError,
    KernelCrashError,
    RetryOOM,
    ShuffleFetchError,
    ShuffleTransportError,
)
from spark_rapids_tpu_torch.lockorder import ordered_lock

#: injectable fault kinds and the failure each simulates
FAULT_KINDS = (
    "oom",          # device allocation failure (RetryOOM)
    "crash",        # non-OOM kernel failure (KernelCrashError)
    "fetch",        # block fetch failure (ShuffleFetchError)
    "disconnect",   # transport connection drop (ShuffleTransportError)
    "corrupt",      # bit-flip the bytes the site passes
    "slow",         # a short stall (sleep)
    "wedge",        # a long stall inside the site
    "device_lost",  # fatal device loss (DeviceLostError)
    "race",         # a lost optimistic-concurrency race (Delta)
)

#: registered fault points: name -> (module that hosts the call site, doc)
FAULT_POINTS: Dict[str, tuple] = {
    "io.read.file": (
        "spark_rapids_tpu_torch/io/common.py",
        "file-source per-file decode"),
    "io.write.file": (
        "spark_rapids_tpu_torch/io/writer.py",
        "writer per-file write (both branches: the single file "
        "part-00000 and every dynamic-partition file), before the staged "
        "write"),
    "io.write.commit": (
        "spark_rapids_tpu_torch/io/committer.py",
        "task commit, before each staged file's atomic promotion "
        "(os.replace into the final destination)"),
    "io.write.abort": (
        "spark_rapids_tpu_torch/io/committer.py",
        "write-job abort, before the rollback and the staging sweep"),
    "exec.execute": (
        "spark_rapids_tpu_torch/runtime/faults.py",
        "at each exec's execute()/execute_masked() boundary (installed by "
        "install_fault_boundaries; carries the op: the plan-node class the "
        "exec was converted from, else the exec's class)"),
    "mem.reserve": (
        "spark_rapids_tpu_torch/runtime/memory.py",
        "before the arbiter grants a device-landing reservation: 'oom' "
        "simulates a budget squeeze mid-query (RetryOOM into the retry "
        "framework: spill-replay, split-and-retry, then the memory "
        "degradation ladder)"),
    "mem.spill": (
        "spark_rapids_tpu_torch/runtime/spill.py",
        "before a device-to-host spill, under the batch's lock: 'crash' "
        "simulates a failed spill (the buffer stays on the device)"),
    "dispatch.kernel": (
        "spark_rapids_tpu_torch/kernels/__init__.py",
        "before each hand-written kernel's launch (kernel_launch; the op "
        "is the wrapper's name), on the card and for the plain version "
        "on the CPU"),
    "dispatch.wedge": (
        "spark_rapids_tpu_torch/kernels/__init__.py",
        "before each hand-written kernel's launch, between dispatch.kernel "
        "and device.lost; wedge stalls on the host side of the launch, so "
        "only the service watchdog's hard wall limit can end it"),
    "service.worker_crash": (
        "spark_rapids_tpu_torch/service/scheduler.py",
        "service worker runner, after the RUNNING transition and before "
        "the query executes: an exception here kills the WORKER (not the "
        "query), exercising respawn and requeue"),
    "device.lost": (
        "spark_rapids_tpu_torch/kernels/__init__.py",
        "before each hand-written kernel's launch; device_lost simulates "
        "a fatal device loss (the health monitor's device-loss recovery, "
        "runtime/health.py)"),
    "delta.commit.race": (
        "spark_rapids_tpu_torch/delta/log.py",
        "immediately before the atomic commit-file create; kind 'race' "
        "injects a DeltaConcurrentModificationException so the optimistic "
        "rebase-and-retry loop runs without a real concurrent writer, "
        "'crash' dies mid-commit"),
    "stream.batch": (
        "spark_rapids_tpu_torch/streaming/query.py",
        "after a micro-batch's offsets are durably logged, before it "
        "executes (a crash here leaves a pending batch; resume re-runs the "
        "SAME offsets)"),
    "stream.sink.commit": (
        "spark_rapids_tpu_torch/streaming/sink.py",
        "after the sink's replay check, before the transactional commit (a "
        "crash here re-runs the batch; the txn watermark dedupes the "
        "replay)"),
    "mem.unspill": (
        "spark_rapids_tpu_torch/runtime/spill.py",
        "at the disk-tier unspill read, under the batch's lock: 'corrupt' "
        "flips frame bytes and the CRC footer catches it; the typed "
        "SpillCorruptionError re-lands the data through a query replay"),
    # -- the host shuffle (shuffle/): fetch, fetch_disconnect, corrupt and
    # slow are absorbed by the fetch-retry loops and, past them, by the
    # exchange's recompute of the lost map outputs
    "shuffle.write.map": (
        "spark_rapids_tpu_torch/shuffle/manager.py",
        "before a map output's data file is written"),
    "shuffle.read.partition": (
        "spark_rapids_tpu_torch/shuffle/manager.py",
        "before one map output's segment of a reduce partition is read"),
    "shuffle.transport.request": (
        "spark_rapids_tpu_torch/shuffle/transport.py",
        "before a request round trip on a P2P connection"),
    "shuffle.transport.stream": (
        "spark_rapids_tpu_torch/shuffle/transport.py",
        "per received data window of a P2P transfer (corrupt damages the "
        "window before reassembly)"),
    "shuffle.fetch.metadata": (
        "spark_rapids_tpu_torch/shuffle/client_server.py",
        "before a P2P client's metadata request"),
    "shuffle.fetch.stream": (
        "spark_rapids_tpu_torch/shuffle/client_server.py",
        "before a P2P block transfer, and per completed block (corrupt "
        "damages the block; the TPAK CRC catches it)"),
    # -- the mesh: device_lost at any mesh.* point raises the PARTIAL
    # MeshDeviceLostError that walks the mesh ladder (runtime/health.py
    # on_mesh_device_loss)
    "mesh.shard.put": (
        "spark_rapids_tpu_torch/parallel/mesh.py",
        "per sharded landing: every mesh-native scan batch and every "
        "exchange input put onto the mesh, before the transfer"),
    "mesh.ici.exchange": (
        "spark_rapids_tpu_torch/parallel/exchange.py",
        "the all-to-all exchange: before the exchange (crash, device_lost, "
        "slow) and at its checksummed read of the per-target counts "
        "(corrupt flips the read bytes; the digest catches it and the "
        "counts are read again)"),
    "mesh.gather": (
        "spark_rapids_tpu_torch/execs/mesh.py",
        "the re-land onto the session's device: corrupt damages the landed "
        "copy, the row-count and checksum check trips, and the intact "
        "shards re-land"),
    "mesh.dict.upload": (
        "spark_rapids_tpu_torch/parallel/exchange.py",
        "the per-mesh upload of a string dictionary's bytes for hashing, "
        "before the copies"),
    # -- the cluster: device_lost at any host.* point raises HostLostError,
    # which walks the host ladder (runtime/health.py on_host_loss)
    "host.dispatch": (
        "spark_rapids_tpu_torch/runtime/cluster.py",
        "driver -> executor scan dispatch, before the round trip"),
    "host.shard.land": (
        "spark_rapids_tpu_torch/runtime/cluster.py",
        "per landed TPAK frame of an executor's scan reply (corrupt damages "
        "the landed copy; the CRC catches it and the intact frame re-lands, "
        "hostShardRetries)"),
    "host.dcn.exchange": (
        "spark_rapids_tpu_torch/runtime/cluster.py",
        "before an all-to-all exchange whose mesh spans more than one "
        "cluster host group"),
    "host.heartbeat": (
        "spark_rapids_tpu_torch/runtime/cluster.py",
        "an executor heartbeat's receipt at the driver: a fault drops the "
        "beat (executorBeatsDropped); enough of them and the sweep "
        "declares the host lost"),
}

_SLOW_SLEEP_S = 0.05
#: how long a ``wedge`` fault stalls (SRT_WEDGE_SLEEP_S overrides)
_WEDGE_SLEEP_S = 2.0


class _ArmedFault:
    """One armed '<point>[@<op>]:<kind>:<prob-or-count>[:<seed>]' entry."""

    __slots__ = ("point", "op", "kind", "prob", "remaining", "rng", "fired")

    def __init__(self, point: str, op: Optional[str], kind: str,
                 prob: Optional[float], count: Optional[int], seed: int):
        self.point = point
        self.op = op
        self.kind = kind
        self.prob = prob
        self.remaining = count
        self.rng = random.Random(seed)
        self.fired = 0

    def should_fire(self) -> bool:
        if self.remaining is not None:
            if self.remaining <= 0:
                return False
            self.remaining -= 1
            return True
        return self.rng.random() < (self.prob or 0.0)


def parse_fault_spec(spec: str) -> List[_ArmedFault]:
    """Parse the ``spark.rapids.test.faults`` value. Raises on unknown
    points and kinds, so a mistyped schedule fails loudly."""
    out: List[_ArmedFault] = []
    for i, entry in enumerate(e.strip() for e in spec.split(";")):
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (3, 4):
            raise ColumnarProcessingError(
                f"bad fault spec entry {entry!r} (want "
                "<point>[@<op>]:<kind>:<prob-or-count>[:<seed>])")
        target, kind, amount = parts[0], parts[1].lower(), parts[2]
        point, _, op = target.partition("@")
        if point not in FAULT_POINTS:
            raise ColumnarProcessingError(
                f"unknown fault point {point!r} (known: "
                f"{', '.join(sorted(FAULT_POINTS))})")
        if kind not in FAULT_KINDS:
            raise ColumnarProcessingError(
                f"unknown fault kind {kind!r} (known: "
                f"{', '.join(FAULT_KINDS)})")
        prob = count = None
        if "." in amount:
            prob = float(amount)
            if not 0.0 < prob <= 1.0:
                raise ColumnarProcessingError(
                    f"fault probability {prob} outside (0, 1]")
        else:
            count = int(amount)
            if count < 1:
                raise ColumnarProcessingError(
                    f"fault count {count} must be >= 1")
        seed = int(parts[3]) if len(parts) == 4 else i
        out.append(_ArmedFault(point, op or None, kind, prob, count, seed))
    return out


class FaultRegistry:
    """Process-wide armed faults and per-point fire counters."""

    def __init__(self):
        self._lock = ordered_lock("faults.registry")
        self._armed: List[_ArmedFault] = []
        self._spec = ""
        self._counters: Dict[str, int] = {}

    def arm(self, spec: str) -> None:
        """(Re-)arm from a spec string. Re-arming the SAME spec is a no-op,
        so per-query executes do not reset a seeded schedule or its
        counters; a different spec replaces everything."""
        with self._lock:
            if spec == self._spec:
                return
            self._spec = spec
            self._armed = parse_fault_spec(spec) if spec else []
            self._counters = {}

    def disarm(self) -> None:
        with self._lock:
            self._spec = ""
            self._armed = []
            self._counters = {}

    @contextmanager
    def suspended(self):
        """Disarm for the block without losing the armed entries' random
        state or counters."""
        with self._lock:
            saved = (self._spec, self._armed, self._counters)
            self._spec, self._armed, self._counters = "", [], {}
        try:
            yield
        finally:
            with self._lock:
                self._spec, self._armed, self._counters = saved

    @property
    def armed(self) -> bool:
        return bool(self._armed)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def fire(self, point: str, op: Optional[str] = None, data=None):
        """Evaluate every armed entry matching ``point`` (and ``op`` when
        the entry names one). Raises the matched kind's exception;
        ``corrupt`` returns a damaged copy of ``data``; ``slow`` and
        ``wedge`` sleep. Returns ``data``, possibly damaged."""
        if not self._armed:
            return data
        with self._lock:
            hits = [a for a in self._armed
                    if a.point == point
                    and (a.op is None or a.op == op)
                    # corruption needs bytes: a data-less call at the
                    # same point does not consume the schedule
                    and (a.kind != "corrupt" or data is not None)
                    and a.should_fire()]
            for a in hits:
                a.fired += 1
                key = a.point if a.op is None else f"{a.point}@{a.op}"
                self._counters[key] = self._counters.get(key, 0) + 1
        for a in hits:
            where = point if op is None else f"{point}[{op}]"
            if a.kind == "oom":
                raise RetryOOM(f"injected device OOM at {where}")
            if a.kind == "crash":
                raise KernelCrashError(f"injected kernel crash at {where}")
            if a.kind == "fetch":
                raise ShuffleFetchError(f"injected fetch error at {where}")
            if a.kind == "disconnect":
                raise ShuffleTransportError(
                    f"injected transport disconnect at {where}")
            if a.kind == "device_lost":
                if point.startswith("host."):
                    # a whole executor process died: the host ladder
                    from spark_rapids_tpu_torch.errors import HostLostError
                    raise HostLostError(f"injected host loss at {where}")
                if point.startswith("mesh."):
                    # one logical device died: the mesh ladder
                    from spark_rapids_tpu_torch.errors import (
                        MeshDeviceLostError,
                    )
                    raise MeshDeviceLostError(
                        f"injected mesh device loss at {where}")
                raise DeviceLostError(f"injected device loss at {where}")
            if a.kind == "race":
                from spark_rapids_tpu_torch.delta.log import (
                    DeltaConcurrentModificationException,
                )
                raise DeltaConcurrentModificationException(
                    f"injected optimistic-concurrency race at {where}")
            if a.kind == "wedge":
                time.sleep(float(os.environ.get("SRT_WEDGE_SLEEP_S",
                                                _WEDGE_SLEEP_S)))
            elif a.kind == "slow":
                time.sleep(_SLOW_SLEEP_S)
            elif a.kind == "corrupt" and data is not None and len(data):
                buf = bytearray(data)
                pos = a.rng.randrange(len(buf))
                buf[pos] ^= 0xFF
                data = bytes(buf)
        return data


FAULTS = FaultRegistry()


def fault_point(name: str, op: Optional[str] = None, data=None):
    """The site marker for injectable faults: every call names a point
    registered in :data:`FAULT_POINTS`. Disarmed, it costs one attribute
    read."""
    if not FAULTS._armed:
        return data
    return FAULTS.fire(name, op=op, data=data)


# -- recovery accounting -------------------------------------------------------

class RecoveryStats:
    """Process-wide counters of every recovery action, in the unified
    metric registry's ``recovery`` scope (obs/metrics.py)."""

    FIELDS = ("fetch_retries", "peer_exclusions", "recomputed_maps",
              "demotions", "query_replays")

    def __init__(self):
        from spark_rapids_tpu_torch.obs.metrics import (
            metric_scope,
            register_metric,
        )
        self._lock = ordered_lock("faults.recovery")
        self._counts = metric_scope("recovery")
        for f in self.FIELDS:
            register_metric(f, "count", "ESSENTIAL",
                            f"recovery action counter ({f})")
            self._counts.setdefault(f, 0)

    def bump(self, field: str, n: int = 1) -> None:
        if field not in self._counts:
            raise KeyError(field)
        with self._lock:
            self._counts.add(field, n)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            for f in self.FIELDS:
                self._counts[f] = 0


RECOVERY = RecoveryStats()


def backoff_retry(fn, *, max_retries: int, wait_s: float,
                  backoff_mult: float, retryable, on_failure=None):
    """Call ``fn`` until it succeeds: each failure of a ``retryable``
    type bumps ``RECOVERY.fetch_retries`` and calls ``on_failure(exc,
    attempt)`` (a truthy return stops retrying), then sleeps ``wait_s``
    times ``backoff_mult`` to the attempt. After ``max_retries`` retries
    the last exception re-raises."""
    attempt = 0
    wait = wait_s
    while True:
        try:
            return fn()
        except retryable as e:
            attempt += 1
            RECOVERY.bump("fetch_retries")
            stop = on_failure(e, attempt) if on_failure is not None else False
            if stop or attempt > max_retries:
                raise
            time.sleep(wait)
            wait *= backoff_mult


# -- the per-operator circuit breaker ----------------------------------------

class CircuitBreaker:
    """Counts non-OOM device failures per PLAN-NODE class, process-wide
    like the speculation blocklist (a kernel that crashes the shared
    device is broken for every session). The failure that reaches
    ``max_failures`` demotes the operator onto the CPU route: its reason
    feeds ``PlanMeta.reasons``, so ``explain`` and the event record's
    ``fallbacks`` say why it runs there, until :meth:`reset`."""

    def __init__(self):
        self._lock = ordered_lock("faults.breaker")
        self._failures: Dict[str, int] = {}
        self._reasons: Dict[str, str] = {}

    def record_failure(self, op: str, exc: BaseException,
                       max_failures: int) -> bool:
        """Count one failure of ``op``; True when this failure crossed the
        threshold and demoted the op (``RECOVERY.demotions``)."""
        first = str(exc).splitlines()[0] if str(exc) else type(exc).__name__
        with self._lock:
            if op in self._reasons:
                return False
            n = self._failures.get(op, 0) + 1
            self._failures[op] = n
            if n < max_failures:
                return False
            self._reasons[op] = (
                f"runtime circuit breaker: demoted to CPU after {n} device "
                f"failures (last: {type(exc).__name__}: {first})")
        RECOVERY.bump("demotions")
        return True

    def demotion_reason(self, op: str) -> Optional[str]:
        with self._lock:
            return self._reasons.get(op)

    def demoted_ops(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._reasons)

    def reset(self) -> None:
        with self._lock:
            self._failures = {}
            self._reasons = {}


CIRCUIT_BREAKER = CircuitBreaker()


# -- exec fault boundaries ----------------------------------------------------

def _tag_fault_op(exc: BaseException, op: str) -> None:
    """Attach op attribution to a failure the recovery acts on: the
    innermost exec wins (the first wrapper the exception crosses sets
    it). Retryable OOMs are left to the retry framework; a FatalDeviceOOM
    (retries and splits exhausted) is tagged, as in the reference."""
    from spark_rapids_tpu_torch.errors import FatalDeviceOOM
    from spark_rapids_tpu_torch.runtime.crash_handler import (
        is_fatal_device_error,
    )
    from spark_rapids_tpu_torch.runtime.retry import is_device_oom
    if getattr(exc, "fault_op", None) is not None or is_device_oom(exc):
        return
    if isinstance(exc, (KernelCrashError, FatalDeviceOOM)) \
            or is_fatal_device_error(exc):
        exc.fault_op = op


def _guard(fn, op: str, tag: bool):
    def wrapped(*args, **kwargs):
        try:
            # inside the try: an injected crash at this exec's own
            # boundary is tagged by this wrapper (the root has no ancestor)
            fault_point("exec.execute", op=op)
            yield from fn(*args, **kwargs)
        except Exception as exc:
            if tag:
                _tag_fault_op(exc, op)
            raise
    return wrapped


def install_fault_boundaries(root) -> None:
    """Wrap every exec's execute()/execute_masked() in the converted tree
    with the ``exec.execute`` fault point and op attribution for non-OOM
    device failures, which feed the circuit breaker. The op is the
    plan-node class the exec was converted from (``_plan_origin``, set
    by overrides/rules.py); a helper exec (a coalesce wrapper) fires the
    point under its own class name and leaves tagging to the nearest
    converted ancestor. Idempotent per exec instance."""
    stack = [root]
    while stack:
        e = stack.pop()
        stack.extend(e.children)
        if e.__dict__.get("_fault_guarded"):
            continue
        e._fault_guarded = True
        origin = getattr(e, "_plan_origin", None)
        op = origin or type(e).__name__
        e.execute = _guard(e.execute, op, tag=origin is not None)
        e.execute_masked = _guard(e.execute_masked, op,
                                  tag=origin is not None)
