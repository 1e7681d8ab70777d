"""Load driver: the corpus through the concurrent query service (port of
``spark_rapids_tpu/tools/loadtest.py``).

``python -m spark_rapids_tpu_torch.tools loadtest`` fires q1-q22 across
simulated tenants at a configured worker concurrency and reports what the
serial harnesses cannot: the aggregate wall clock against the serial sum,
p50/p95 submit-to-finish latency, queue wait and the result cache's hit
rate, while holding every concurrent result against its serial run.

The bar is the reference's, bit for bit, with one named exception
(:data:`CLOSE_COLUMNS`): an f64 sum over more than 32 segments is one
``index_add_`` (ops/segsum.py::segment_sum), whose f64 atomics on the card
add in an order that changes from run to run, so those columns (and the
aggregates over them) are held within rtol 1e-9 and every other column of
the same result stays bitwise. On the CPU ``index_add_`` adds in row
order and those columns repeat bit for bit too.

Workload shape: every tenant submits every selected query, so T tenants
make T x Q submissions. The serial comparator is what a one-at-a-time
server would do with the same stream: the first submission of each query
pays the cold wall, the other T-1 the warm wall, serialSumS = sum(cold) +
(T-1) * sum(warm). The concurrent side pays the same builds on its misses.
Workers share one session and launch on the card's legacy stream, and the
host work of planning runs under the GIL: the report states the aggregate
wall beside the serial sum and claims no speed-up.

The corpus comes from the port's own models/corpus.py. The report names
the device it measured (the card's name and power limit from
``nvidia-smi``, or ``cpu``).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np

#: per query, the f64 columns that sum more than 32 segments through
#: ``index_add_`` (directly, or an aggregate over such sums): held within
#: rtol 1e-9 instead of bitwise (module docstring). "TPC-H q3" is
#: models/tpch.py's q3, which chip_smoke.py adds to the workload
CLOSE_COLUMNS = {
    "q3": ("spend",),
    "q10": ("total",),
    "q15": ("revenue",),
    "q17": ("avg_yearly",),
    "TPC-H q3": ("revenue",),
}

#: recovery-work ceilings a chaos run asserts (the fault schedule counts
#: fires, so recovery work is bounded by construction)
SERVICE_CHAOS_BOUNDS = {
    "deviceReinits": 8,
    "workersLost": 8,
    "workersRespawned": 8,
    "requeued": 24,
    "hardTimeouts": 8,
}

#: handle errors a chaos run accepts as typed survivability outcomes
_CHAOS_TYPED_ERRORS = ("HardTimeoutError", "WorkerLostError",
                       "DeviceLostError", "QueryQuarantinedError")


def service_chaos_spec(seed: int) -> str:
    """The seeded service-level fault schedule: worker deaths, device
    losses and one wedged launch, by count, so total disruption does not
    scale with the corpus."""
    return ";".join([
        f"service.worker_crash:crash:2:{seed * 100 + 1}",
        f"device.lost:device_lost:2:{seed * 100 + 2}",
        f"dispatch.wedge:wedge:1:{seed * 100 + 3}",
    ])


#: how long the injected wedge stalls its launch during a chaos loadtest
#: (SRT_WEDGE_SLEEP_S): past hardTimeoutMs, so the watchdog fires
_CHAOS_WEDGE_SLEEP_S = 45.0


def service_chaos_settings(concurrency: int) -> dict:
    """The service conf a chaos run needs besides the fault schedule."""
    return {
        # well under the wedge's stall, far over a legitimate run (a
        # device loss drops the device caches, so the queries after it
        # land their tables again, concurrently)
        "spark.rapids.service.hardTimeoutMs": "25000",
        # one semaphore slot per worker: the abandoned, still-stalled
        # thread holds its slot while the others keep flowing
        "spark.rapids.sql.concurrentGpuTasks": str(max(1, concurrency)),
        # injected faults are not the query's: a strike budget over the
        # schedule's kills keeps an innocent template serving
        "spark.rapids.service.quarantine.maxStrikes": "8",
    }


def _chaos_conf(seed: int, concurrency: int) -> dict:
    conf = {"spark.rapids.test.faults": service_chaos_spec(seed)}
    conf.update(service_chaos_settings(concurrency))
    return conf


@contextmanager
def wedge_stall_env():
    """Arm the chaos wedge's stall (SRT_WEDGE_SLEEP_S) for one run,
    restoring what was there before."""
    import os
    before = os.environ.get("SRT_WEDGE_SLEEP_S")
    os.environ["SRT_WEDGE_SLEEP_S"] = str(_CHAOS_WEDGE_SLEEP_S)
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("SRT_WEDGE_SLEEP_S", None)
        else:
            os.environ["SRT_WEDGE_SLEEP_S"] = before


def drive_health_probes(svc, make_query, *, timeout_s: float,
                        max_probes: int = 4) -> int:
    """Return to HEALTHY after a chaos run: the DEGRADED latch pays down
    on completed queries, so drive a few probes as live traffic would.
    Returns the probes driven."""
    probes = 0
    while svc.health()["state"] == "DEGRADED" and probes < max_probes:
        try:
            hp = svc.submit(make_query(), tenant="health-probe",
                            tag=f"probe{probes}")
        except Exception:
            break  # the probe's template quarantined or shed
        hp.wait(timeout=timeout_s)
        probes += 1
    return probes


# ---------------------------------------------------------------------------
# Comparators (the port's own copies of scale_test.py's)
# ---------------------------------------------------------------------------

def tables_differ(a, b) -> Optional[str]:
    """Bit identity of two HostTables over their valid rows; None when
    identical, else the first divergence."""
    if list(a.names) != list(b.names):
        return f"column names differ: {a.names} vs {b.names}"
    if a.num_rows != b.num_rows:
        return f"row counts differ: {a.num_rows} vs {b.num_rows}"
    for name, ca, cb in zip(a.names, a.columns, b.columns):
        if type(ca.dtype) is not type(cb.dtype):
            return f"column {name}: dtypes differ ({ca.dtype} vs {cb.dtype})"
        va = np.asarray(ca.validity, dtype=bool)
        vb = np.asarray(cb.validity, dtype=bool)
        if not np.array_equal(va, vb):
            return f"column {name}: validity differs"
        da, db = np.asarray(ca.data), np.asarray(cb.data)
        if da.dtype == object or db.dtype == object:
            for i in range(a.num_rows):
                if va[i] and da[i] != db[i]:
                    return f"column {name} row {i}: {da[i]!r} != {db[i]!r}"
        elif da[va].tobytes() != db[vb].tobytes():
            # raw bytes: NaN payloads and signed zeros count
            return f"column {name}: valid values differ bitwise"
    return None


def result_differs(name: str, want, got, rtol: float = 1e-9
                   ) -> Optional[str]:
    """The loadtest's comparator: bitwise (:func:`tables_differ`), except
    the f64 columns :data:`CLOSE_COLUMNS` names for ``name``, which are
    held within ``rtol`` while every other column of the result stays
    bitwise. Rows pair up by the bits of their exact columns (a last-bit
    change in a sum may reorder an ORDER BY on it)."""
    close = CLOSE_COLUMNS.get(name, ())
    if not close:
        return tables_differ(want, got)
    if list(want.names) != list(got.names):
        return f"column names differ: {want.names} vs {got.names}"
    if want.num_rows != got.num_rows:
        return f"row counts differ: {want.num_rows} vs {got.num_rows}"
    exact = [i for i, n in enumerate(want.names) if n not in close]

    def order(t):
        rows = [tuple(repr(v) for v in row) for row in zip(
            *[t.columns[i].to_pylist() for i in exact])] \
            if exact else [()] * t.num_rows
        return sorted(range(t.num_rows), key=lambda r: rows[r])

    ow, og = np.asarray(order(want)), np.asarray(order(got))
    for i, (n, cw, cg) in enumerate(zip(want.names, want.columns,
                                        got.columns)):
        vw = np.asarray(cw.validity, dtype=bool)[ow]
        vg = np.asarray(cg.validity, dtype=bool)[og]
        if not np.array_equal(vw, vg):
            return f"column {n}: validity differs"
        dw, dg = np.asarray(cw.data)[ow], np.asarray(cg.data)[og]
        if n in close:
            if dw.dtype.kind != "f" or dg.dtype != dw.dtype:
                return f"column {n}: not an f64 column ({dw.dtype})"
            a, b = dw[vw], dg[vg]
            bad = ~((a == b) | (np.abs(a - b) <= rtol * np.maximum(
                np.abs(a), np.abs(b))))
            if bad.any():
                j = int(np.argmax(bad))
                return (f"column {n}: {a[j]!r} vs {b[j]!r} beyond rtol "
                        f"{rtol}")
        elif dw.dtype == object or dg.dtype == object:
            for j in np.nonzero(vw)[0]:
                if dw[j] != dg[j]:
                    return f"column {n}: {dw[j]!r} != {dg[j]!r}"
        elif dw[vw].tobytes() != dg[vg].tobytes():
            return f"column {n}: valid values differ bitwise"
    return None


def _percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 1]) of a non-empty list."""
    vals = sorted(values)
    idx = min(len(vals) - 1, max(0, int(round(q * (len(vals) - 1)))))
    return vals[idx]


def _scope_delta(before: dict, after: dict) -> dict:
    out = {}
    for k, v in after.items():
        d = v - before.get(k, 0)
        if d:
            out[k] = round(d, 4) if isinstance(d, float) else d
    return out


def device_line(device) -> str:
    """What the numbers were measured on: the card's name and power limit
    (``nvidia-smi --query-gpu=name,power.limit``), or ``cpu``."""
    import torch
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cpu":
        return "cpu"
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)


def run_loadtest(sf: float = 0.05, seed: int = 0, queries=None,
                 use_sql: bool = False, concurrency: int = 4,
                 tenants: int = 2, eventlog_dir: Optional[str] = None,
                 timeout_s: float = 600.0,
                 warmup_from: Optional[str] = None,
                 chaos: bool = False, device=None) -> dict:
    """Run the loadtest; returns the JSON-ready report. ``report["ok"]``
    is False when a result diverged from its serial run or a submission
    failed.

    ``warmup_from``: an event-log directory to warm from first (``tools
    warmup`` in-process over this run's tables).

    ``chaos``: arm the seeded service-level fault schedule
    (:func:`service_chaos_spec`) on the service's session only. The run
    then asserts the survivability contract instead of all-finished:
    every submission reaches a terminal state, every FINISHED result holds
    against its serial run, every failure is typed, the recovery counters
    stay within SERVICE_CHAOS_BOUNDS, and the service returns to HEALTHY.

    ``device``: the sessions' device (None: the current CUDA device;
    ``"cpu"`` runs the kernels' plain versions)."""
    from contextlib import ExitStack

    from spark_rapids_tpu_torch.dispatch import COMPILE_SCOPE
    from spark_rapids_tpu_torch.models.corpus import (
        build_queries,
        build_sql_queries,
        corpus_tables,
    )
    from spark_rapids_tpu_torch.plan.executable_cache import EXEC_CACHE
    from spark_rapids_tpu_torch.runtime.faults import FAULTS
    from spark_rapids_tpu_torch.runtime.health import HEALTH, QUARANTINE
    from spark_rapids_tpu_torch.service import QueryService
    from spark_rapids_tpu_torch.session import TorchSession

    tables = corpus_tables(sf, seed)

    def _conf(extra=None):
        conf = dict(extra or {})
        if eventlog_dir:
            conf["spark.rapids.sql.eventLog.enabled"] = "true"
            conf["spark.rapids.sql.eventLog.dir"] = eventlog_dir
        return conf

    build = build_sql_queries if use_sql else build_queries

    # -- the serial baseline: cold once, warm for the repeat submissions --
    serial_session = TorchSession(_conf(), device=device)
    warmup_report = None
    if warmup_from:
        from spark_rapids_tpu_torch.tools.warmup import run_warmup
        warmup_report = run_warmup(
            warmup_from, sf=sf, seed=seed, use_sql=use_sql, tables=tables,
            session=TorchSession(device=device))

    scope_t0 = dict(COMPILE_SCOPE)
    serial_queries = build(serial_session, tables)
    wanted = list(queries or serial_queries)
    expected: Dict[str, object] = {}
    serial_cold: Dict[str, float] = {}
    serial_warm: Dict[str, float] = {}
    for name in wanted:
        serial_session.next_query_tag = f"{name}_serial_cold"
        t0 = time.perf_counter()
        expected[name] = serial_queries[name]().collect_table()
        serial_cold[name] = time.perf_counter() - t0
        serial_session.next_query_tag = f"{name}_serial"
        t0 = time.perf_counter()
        serial_queries[name]().collect_table()
        serial_warm[name] = time.perf_counter() - t0
    serial_sum = (sum(serial_cold.values())
                  + (tenants - 1) * sum(serial_warm.values()))
    scope_serial = dict(COMPILE_SCOPE)

    # -- the concurrent run through the service ---------------------------
    n_submissions = len(wanted) * tenants
    svc_conf = {
        "spark.rapids.service.maxConcurrentQueries": str(concurrency),
        "spark.rapids.service.queueDepth": str(max(n_submissions, 64)),
    }
    health_before = HEALTH.snapshot()
    chaos_env = ExitStack()
    if chaos:
        svc_conf.update(_chaos_conf(seed, concurrency))
        chaos_env.enter_context(wedge_stall_env())
    svc = QueryService(_conf(svc_conf), device=device)
    svc_queries = build(svc.session, tables)
    mismatches: List[str] = []
    failures: List[str] = []
    rejected: List[str] = []
    handles = []
    hung: List[str] = []
    svc_health_live = None
    health_probes = 0
    t0 = time.perf_counter()
    try:
        with svc:
            for t in range(tenants):
                for name in wanted:
                    label = f"{name}@tenant{t}"
                    try:
                        handles.append((name, f"tenant{t}", svc.submit(
                            svc_queries[name](), tenant=f"tenant{t}",
                            tag=label)))
                    except Exception as exc:
                        # under chaos a DEGRADED shed or the quarantine
                        # may refuse admission: a typed terminal outcome
                        if not chaos:
                            raise
                        rejected.append(
                            f"{label}: {type(exc).__name__}: {exc}")
            for name, tenant, h in handles:
                if not h.wait(timeout=timeout_s):
                    hung.append(f"{name}@{tenant}: still {h.state} after "
                                f"{timeout_s}s")
                    failures.append(hung[-1])
            if chaos and not hung:
                health_probes = drive_health_probes(
                    svc, svc_queries[wanted[0]], timeout_s=timeout_s)
            # while the pool is still up (after shutdown the workers are
            # gone and workerCount reads 0)
            svc_health_live = svc.health()
    finally:
        chaos_fires = FAULTS.counters() if chaos else {}
        if chaos:
            FAULTS.disarm()
        chaos_env.close()
    wall = time.perf_counter() - t0
    scope_conc = dict(COMPILE_SCOPE)

    latencies, queue_waits, per_query = [], [], {}
    cache_hits = 0
    chaos_outcomes: List[dict] = []
    for name, tenant, h in handles:
        if h.state != "FINISHED":
            if chaos and type(h.error).__name__ in _CHAOS_TYPED_ERRORS:
                chaos_outcomes.append({
                    "query": f"{name}@{tenant}", "state": h.state,
                    "error": f"{type(h.error).__name__}: {h.error}",
                    "requeues": h.requeues})
                continue
            failures.append(f"{name}@{tenant}: {h.state} ({h.error})")
            continue
        diff = result_differs(name, expected[name], h.result_table)
        if diff is not None:
            mismatches.append(f"{name}@{tenant}: {diff}")
        latencies.append(h.latency_s)
        queue_waits.append(h.queue_wait_s or 0.0)
        cache_hits += 1 if h.cache_hit else 0
        entry = per_query.setdefault(name, {
            "serialColdS": round(serial_cold[name], 4),
            "serialWarmS": round(serial_warm[name], 4), "runs": []})
        entry["runs"].append({
            "tenant": tenant, "latencyS": round(h.latency_s, 4),
            "queueWaitS": round(h.queue_wait_s or 0.0, 4),
            "cacheHit": h.cache_hit, "identical": diff is None,
            "requeues": h.requeues})

    serial_phase = _scope_delta(scope_t0, scope_serial)
    conc_phase = _scope_delta(scope_serial, scope_conc)
    conc_lookups = (conc_phase.get("executableCacheHits", 0)
                    + conc_phase.get("executableCacheMisses", 0))
    compile_report = {
        "serialPhase": serial_phase,
        "concurrentPhase": conc_phase,
        "repeatPassNewTraces": int(conc_phase.get("kernelTraces", 0)),
        "executableCacheHitRate": (
            round(conc_phase.get("executableCacheHits", 0)
                  / conc_lookups, 4) if conc_lookups else None),
        "templateHitRate": (
            round((conc_phase.get("executableCacheHits", 0)
                   + conc_phase.get("executableCacheTemplateHits", 0))
                  / conc_lookups, 4) if conc_lookups else None),
        "executableCache": EXEC_CACHE.stats(),
    }
    cold_vals = list(serial_cold.values())
    warm_vals = list(serial_warm.values())

    chaos_report = None
    if chaos:
        health_after = HEALTH.snapshot()
        svc_stats = svc.stats()
        svc_health = svc_health_live or svc.health()
        recovery = {
            "deviceReinits": health_after["deviceReinits"]
            - health_before["deviceReinits"],
            "deviceLost": health_after["deviceLost"]
            - health_before["deviceLost"],
            "workersLost": svc_stats["workersLost"],
            "workersRespawned": svc_stats["workersRespawned"],
            "requeued": svc_stats["requeued"],
            "hardTimeouts": svc_stats["hardTimeouts"],
        }
        bounds_violations = [
            f"{k}={recovery[k]} exceeds the chaos bound {bound}"
            for k, bound in SERVICE_CHAOS_BOUNDS.items()
            if recovery.get(k, 0) > bound]
        returned_healthy = svc_health["state"] == "HEALTHY"
        chaos_report = {
            "faultSpec": service_chaos_spec(seed),
            "faultFires": chaos_fires,
            "recovery": recovery,
            "bounds": dict(SERVICE_CHAOS_BOUNDS),
            "boundsViolations": bounds_violations,
            "typedOutcomes": chaos_outcomes,
            "rejectedSubmissions": rejected,
            "hungSubmissions": hung,
            "quarantine": QUARANTINE.snapshot(),
            "healthAtEnd": svc_health,
            "healthProbes": health_probes,
            "returnedToHealthy": returned_healthy,
        }
        if bounds_violations:
            failures.extend(bounds_violations)
        if not returned_healthy:
            failures.append(
                f"service did not return to HEALTHY: {svc_health}")

    def pct(vals, q):
        return round(_percentile(vals, q), 4) if vals else None

    return {
        "mode": "loadtest",
        "scaleFactor": sf,
        "seed": seed,
        # what these numbers measured: the card's name and power limit,
        # or "cpu"
        "backend": device_line(svc.session.device),
        "form": "sql" if use_sql else "dsl",
        "concurrency": concurrency,
        "tenants": tenants,
        "submissions": n_submissions,
        "wallClockS": round(wall, 4),
        "serialSumS": round(serial_sum, 4),
        "serialColdSumS": round(sum(serial_cold.values()), 4),
        "serialWarmSumS": round(sum(serial_warm.values()), 4),
        "coldP50S": pct(cold_vals, 0.50),
        "coldP95S": pct(cold_vals, 0.95),
        "warmP50S": pct(warm_vals, 0.50),
        "warmP95S": pct(warm_vals, 0.95),
        "warmup": warmup_report,
        "compile": compile_report,
        "chaos": chaos_report,
        "speedupVsSerial": round(serial_sum / wall, 3) if wall else None,
        "throughputQps": round(n_submissions / wall, 3) if wall else None,
        "latencyP50S": pct(latencies, 0.50),
        "latencyP95S": pct(latencies, 0.95),
        "queueWaitP50S": pct(queue_waits, 0.50),
        "queueWaitP95S": pct(queue_waits, 0.95),
        "cacheHitRate": round(cache_hits / len(latencies), 4)
        if latencies else None,
        "resultCache": (svc.result_cache.stats()
                        if svc.result_cache is not None else None),
        "service": svc.stats(),
        "closeColumns": {q: list(c) for q, c in CLOSE_COLUMNS.items()
                         if q in wanted},
        "allIdentical": not mismatches and not failures,
        "belowSerialSum": wall < serial_sum,
        "mismatches": mismatches,
        "failures": failures,
        "queries": per_query,
        "ok": not mismatches and not failures,
    }


def render_loadtest(report: dict) -> str:
    lines = [
        f"Loadtest: {report['submissions']} submissions "
        f"({report['tenants']} tenants x {len(report['queries'])} queries, "
        f"{report['form']}) at concurrency {report['concurrency']} on "
        f"{report['backend']}",
        f"  wall clock      {report['wallClockS']:.3f}s  "
        f"(serial sum {report['serialSumS']:.3f}s)",
        f"  throughput      {report['throughputQps']} q/s",
        f"  latency p50/p95 {report['latencyP50S']}s / "
        f"{report['latencyP95S']}s",
        f"  queue p50/p95   {report['queueWaitP50S']}s / "
        f"{report['queueWaitP95S']}s",
        f"  cache hit rate  {report['cacheHitRate']}",
        f"  cold p50/p95    {report['coldP50S']}s / {report['coldP95S']}s"
        + ("  (warmed)" if report.get("warmup") else ""),
        f"  repeat pass     {report['compile']['repeatPassNewTraces']} "
        f"new builds, executable-cache hit rate "
        f"{report['compile']['executableCacheHitRate']} "
        f"(template {report['compile']['templateHitRate']})",
        f"  all held        {report['allIdentical']} (bitwise; rtol 1e-9 "
        f"for {report['closeColumns'] or 'no column'})",
    ]
    if report.get("warmup"):
        w = report["warmup"]
        lines.append(
            f"  warmup          {w['programsCompiled']} compiled / "
            f"{w['programsSkipped']} skipped in {w['wallS']:.2f}s "
            f"({w['newTraces']} builds)")
    if report.get("chaos"):
        c = report["chaos"]
        r = c["recovery"]
        lines.append(
            f"  chaos           fires {sum(c['faultFires'].values())} ("
            + ", ".join(f"{k}={v}"
                        for k, v in sorted(c["faultFires"].items())) + ")")
        lines.append(
            f"    recovery      deviceReinits={r['deviceReinits']} "
            f"workersLost={r['workersLost']} respawned="
            f"{r['workersRespawned']} requeued={r['requeued']} "
            f"hardTimeouts={r['hardTimeouts']}")
        lines.append(
            f"    outcomes      {len(c['typedOutcomes'])} typed "
            f"non-finished, {len(c['rejectedSubmissions'])} rejected, "
            f"{len(c['hungSubmissions'])} hung; health at end: "
            f"{c['healthAtEnd']['state']}")
    if report["mismatches"]:
        lines.append("  MISMATCHES:")
        lines += [f"    {m}" for m in report["mismatches"]]
    if report["failures"]:
        lines.append("  FAILURES:")
        lines += [f"    {f}" for f in report["failures"]]
    return "\n".join(lines)
