"""Per-query structured event log, JSONL (port of
``spark_rapids_tpu/obs/events.py``).

Reference: the Spark event log that spark-rapids-tools' qualification
and profiling analyzers read. One JSON object per completed top-level
query, written by ``TorchSession.execute`` when
``spark.rapids.sql.eventLog.enabled`` is set:

* the executed exec tree with per-operator typed metrics and LORE ids;
* fallback reasons and circuit-breaker trips;
* spill, retry and fault-recovery counter deltas, per-exchange numbers;
* the query's wall and phase times and the span summary.

``python -m spark_rapids_tpu_torch.tools profile|compare`` reads these.
The record keeps the reference's schema, version 11, and its shape.

The query service's fields come from the service when one runs the
query (``TorchSession.next_query_service``): ``tenant``, ``pool``,
``queueWaitS``, ``cacheHit`` and ``quarantined`` (the template carries
strikes); ``workerRestarts`` is the query's change of the ``health``
scope's ``workersRespawned``. Outside the service they read null, false
and 0, as the reference's do.

Delta's ``commitRetries`` is the query's change of the ``write`` scope's
counter; the streaming fields (``microBatches``, ``mvRefreshes``,
``mvIncrementalRefreshes``, ``mvFullRecomputes``, ``sinkCommits``,
``sinkReplays``) are the ``streaming`` scope's change plus what the
streaming subsystem staged on the thread between envelopes
(``TorchSession.stage_stream_delta``), and ``mvEpoch`` is the serving
materialized view's epoch (null otherwise), as the reference writes them.

The mesh's fields (record v7): ``meshShape`` (the active mesh, null when
off), ``iciBytes``, ``shardRetries``, ``gatherChecksFailed`` (the ``mesh``
scope's change), ``meshDegradations`` (the ``health`` scope's) and
``shardSkew`` (over the query's mesh exchanges, the largest
max/median of the per-partition bytes). The cluster's (record v8):
``hostTopology`` (null when off), ``hostsLost``, ``hostRelands``,
``dcnExchanges`` (the ``cluster`` scope's change) and ``hostScans`` (the
per-host scan attribution of runtime/cluster.py). ``padWasteRows`` is 0
(dispatch.py: the port pads nothing for a compiler).

``fallbacks`` lists every node the overrides' tags sent to the CPU route
with its reasons (``collect_fallbacks``). ``dispatches`` counts the
hand-written kernels' launches and
``compileMs`` their nvcc builds (dispatch.py's deviations).
"""

from __future__ import annotations

import json
import os
import uuid
from collections import deque
from typing import Dict, List, Optional

from spark_rapids_tpu_torch.lockorder import ordered_lock

#: the reference's record version (its history: spark_rapids_tpu/obs/
#: events.py); the offline tools key off it
EVENT_SCHEMA_VERSION = 11


def plan_tree(executable) -> dict:
    """The executed tree as nested dicts: operator name, lore id,
    ``describe`` and TYPED metrics per node."""
    from spark_rapids_tpu_torch.obs.metrics import typed

    def node(e) -> dict:
        return {
            "op": type(e).__name__,
            "describe": describe(e),
            "loreId": getattr(e, "_lore_id", None),
            "metrics": typed(getattr(e, "metrics", None) or {}),
            "children": [node(c) for c in getattr(e, "children", ())],
        }

    return node(executable)


def describe(e) -> str:
    """An exec's one-line description: its ``describe()`` where it has
    one, else its class name."""
    fn = getattr(e, "describe", None)
    return fn() if callable(fn) else type(e).__name__


def _walk_exec_tree(executable):
    from spark_rapids_tpu_torch.lore import _iter_tree
    return _iter_tree(executable)


def collect_exchanges(executable) -> List[dict]:
    """Per-exchange summary from the executed tree's metrics."""
    keys = ("shuffleBytesWritten", "shuffleBytesRead", "shuffleWriteTime",
            "shuffleReadTime", "mapOutputBytesMax", "mapOutputBytesMedian",
            "skewedPartitions", "aqeCoalescedPartitions",
            "recomputedMapOutputs", "iciExchangeTime", "iciPartitions",
            "iciBytes", "hostShuffleFallbacks",
            "localSplitParts", "localSplitTime")
    out = []
    for e in _walk_exec_tree(executable):
        m = getattr(e, "metrics", None)
        if not m or not any(k in m for k in keys):
            continue
        entry = {"op": type(e).__name__,
                 "loreId": getattr(e, "_lore_id", None)}
        entry.update({k: m[k] for k in keys if k in m})
        out.append(entry)
    return out


def collect_aqe(executable) -> Dict[str, int]:
    """AQE's runtime re-plans over the tree: the build sides
    ``TpuAdaptiveBuildExec`` converted to a broadcast (execs/broadcast.py);
    the one-device split coalesces no partitions, so that count stays 0."""
    totals = {"broadcastConversions": 0, "coalescedPartitions": 0}
    for e in _walk_exec_tree(executable):
        m = getattr(e, "metrics", None)
        if not m:
            continue
        totals["broadcastConversions"] += int(m.get("aqeBroadcastConverted",
                                                    0))
        totals["coalescedPartitions"] += int(m.get("aqeCoalescedPartitions",
                                                   0))
    return totals


def collect_fallbacks(meta) -> List[dict]:
    """Flatten the overrides' meta tree into [{op, reasons}] for every
    node tagged onto the CPU route (the reference's)."""
    out: List[dict] = []

    def walk(m):
        if m is None:
            return
        reasons = list(getattr(m, "reasons", ()) or ())
        if reasons:
            out.append({"op": type(getattr(m, "node", m)).__name__,
                        "reasons": reasons})
        for c in getattr(m, "children", ()) or ():
            walk(c)

    walk(meta)
    return out


def build_query_record(*, query_index: int, wall_s: float,
                       phases: Dict[str, float], executable,
                       sql_text: Optional[str], query_tag: Optional[str],
                       dispatches: int, recovery_delta: Dict[str, int],
                       scope_deltas: Dict[str, dict],
                       fault_fires: Dict[str, int],
                       demotions: Dict[str, str],
                       spans_summary: Optional[dict],
                       fault_replays: int,
                       compile_ms: float = 0.0,
                       executable_cache_hit: bool = False,
                       health_state: str = "HEALTHY",
                       device_reinits: int = 0,
                       worker_restarts: int = 0,
                       service: Optional[dict] = None,
                       files_written: int = 0,
                       bytes_written: int = 0,
                       oom_retries: int = 0,
                       split_retries: int = 0,
                       spill_bytes: int = 0,
                       unspills: int = 0,
                       budget_peak: int = 0,
                       fallbacks=None,
                       commit_retries: int = 0,
                       micro_batches: int = 0,
                       mv_refreshes: int = 0,
                       mv_incremental_refreshes: int = 0,
                       mv_full_recomputes: int = 0,
                       sink_commits: int = 0,
                       sink_replays: int = 0,
                       mv_epoch: Optional[int] = None,
                       mesh_shape: Optional[str] = None,
                       ici_bytes: int = 0,
                       mesh_degradations: int = 0,
                       shard_retries: int = 0,
                       gather_checks_failed: int = 0,
                       host_topology: Optional[str] = None,
                       hosts_lost: int = 0,
                       host_relands: int = 0,
                       dcn_exchanges: int = 0,
                       host_scans: Optional[dict] = None) -> dict:
    """Assemble one event-log record: every field JSON-native, in the
    reference's schema 11 (the module's docstring). The shape test
    (tests/test_torch_observability.py) holds it to the reference's
    golden record. ``service`` is the query service's envelope (None
    outside the service)."""
    service = service or {}
    shard_skew = 0.0
    for e in collect_exchanges(executable):
        if "iciBytes" in e and e.get("mapOutputBytesMedian"):
            shard_skew = max(shard_skew, e["mapOutputBytesMax"]
                             / max(e["mapOutputBytesMedian"], 1))
    return {
        "schema": EVENT_SCHEMA_VERSION,
        "event": "queryCompleted",
        "queryIndex": query_index,
        "queryTag": query_tag,
        "sqlText": sql_text,
        "tenant": service.get("tenant"),
        "pool": service.get("pool"),
        "queueWaitS": service.get("queueWaitS"),
        "cacheHit": bool(service.get("cacheHit", False)),
        "wallS": round(wall_s, 6),
        "phasesS": {k: round(v, 6) for k, v in sorted(phases.items())},
        "dispatches": dispatches,
        "compileMs": round(float(compile_ms), 3),
        "executableCacheHit": bool(executable_cache_hit),
        "padWasteRows": 0,
        "healthState": str(health_state),
        "quarantined": bool(service.get("quarantined", False)),
        "deviceReinits": int(device_reinits),
        "workerRestarts": int(worker_restarts),
        "filesWritten": int(files_written),
        "bytesWritten": int(bytes_written),
        "commitRetries": int(commit_retries),
        "meshShape": mesh_shape,
        "iciBytes": int(ici_bytes),
        "shardSkew": round(float(shard_skew), 4),
        "meshDegradations": int(mesh_degradations),
        "shardRetries": int(shard_retries),
        "gatherChecksFailed": int(gather_checks_failed),
        "hostTopology": host_topology,
        "hostsLost": int(hosts_lost),
        "hostRelands": int(host_relands),
        "dcnExchanges": int(dcn_exchanges),
        "hostScans": dict(host_scans or {}),
        "oomRetries": int(oom_retries),
        "splitRetries": int(split_retries),
        "spillBytes": int(spill_bytes),
        "unspills": int(unspills),
        "budgetPeak": int(budget_peak),
        "microBatches": int(micro_batches),
        "mvRefreshes": int(mv_refreshes),
        "mvIncrementalRefreshes": int(mv_incremental_refreshes),
        "mvFullRecomputes": int(mv_full_recomputes),
        "sinkCommits": int(sink_commits),
        "sinkReplays": int(sink_replays),
        "mvEpoch": None if mv_epoch is None else int(mv_epoch),
        "faultReplays": fault_replays,
        "plan": plan_tree(executable),
        "fallbacks": list(fallbacks or []),
        "demotions": dict(demotions),
        "aqe": collect_aqe(executable),
        "exchanges": collect_exchanges(executable),
        "recovery": dict(recovery_delta),
        "scopes": scope_deltas,
        "faultFires": dict(fault_fires),
        "spans": spans_summary,
    }


class QueryEventWriter:
    """Appends one JSON line per query to a per-session file under the
    configured directory. Lazy: the file is created at the first
    record, so enabling the conf on an idle session writes nothing."""

    def __init__(self, directory: str):
        self.directory = directory
        self.path = os.path.join(
            directory, f"events-{uuid.uuid4().hex[:12]}.jsonl")
        self._lock = ordered_lock("obs.events.writer")
        self.records_written = 0

    def write(self, record: dict) -> str:
        line = json.dumps(record, sort_keys=True)
        with self._lock:
            os.makedirs(self.directory, exist_ok=True)
            with open(self.path, "a") as f:
                f.write(line + "\n")
            self.records_written += 1
        return self.path


# ---------------------------------------------------------------------------
# Recent-record ring (the flight recorder's "what was the engine doing
# just before the incident" context, obs/telemetry.py)
# ---------------------------------------------------------------------------

#: slimmed summaries of the most recent event records, process-wide
#: (full records carry whole plan trees — the bundle only needs the
#: headline facts)
_RECENT_KEEP = 32
_RECENT_LOCK = ordered_lock("obs.events.recent")
_RECENT = deque(maxlen=_RECENT_KEEP)
_RECENT_FIELDS = ("queryIndex", "queryTag", "wallS", "healthState",
                  "hostTopology", "meshShape", "dispatches",
                  "faultReplays", "hostsLost", "hostRelands",
                  "meshDegradations", "deviceReinits", "cacheHit")


def note_recent_record(record: dict) -> None:
    """Remember a slim summary of one written event record (called by
    the session's event-log append path)."""
    slim = {k: record.get(k) for k in _RECENT_FIELDS}
    slim["demotions"] = sorted(record.get("demotions") or {})
    slim["faultFires"] = dict(record.get("faultFires") or {})
    with _RECENT_LOCK:
        _RECENT.append(slim)


def recent_records(n: int = _RECENT_KEEP) -> List[dict]:
    if n <= 0:
        return []  # [-0:] would return ALL
    with _RECENT_LOCK:
        return list(_RECENT)[-int(n):]


def scope_delta(before: Dict[str, dict],
                after: Dict[str, dict]) -> Dict[str, dict]:
    """Per-scope numeric deltas between two scopes_snapshot() calls —
    only keys that moved, so idle subsystems stay out of the record."""
    out: Dict[str, dict] = {}
    for scope, vals in after.items():
        prev = before.get(scope, {})
        moved = {}
        for k, v in vals.items():
            d = v - prev.get(k, 0)
            if d:
                moved[k] = round(d, 6) if isinstance(d, float) else d
        if moved:
            out[scope] = moved
    return out
