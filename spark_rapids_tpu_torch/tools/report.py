"""Profiling report over query event logs.

Reads the JSONL records ``TorchSession.execute`` writes (obs/events.py)
and builds the per-query / aggregate profile: top operators by SELF
time (opTime minus children's opTime, computed from the recorded plan
tree), compute vs transfer vs shuffle vs spill breakdown, per-exchange
byte/skew summary, spill/retry/recovery counters, the fallback
inventory with reasons, and span attribution (how much of each query's
wall time is covered by named spans — the ≥95% contract; the remainder
is reported as untracked, never silently absorbed)."""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional

from spark_rapids_tpu_torch.obs.events import EVENT_SCHEMA_VERSION


def load_events(path: str) -> List[dict]:
    """Load event records from a .jsonl file or a directory of them
    (recursive). A schema NEWER than this build raises (the tools
    refuse to silently misread fields they don't know about); OLDER
    schemas load with one warning for the whole call — the analyzers
    treat every per-version field as 0/absent via ``.get`` defaults,
    so a mixed-version dir (a long-lived eventlog dir spanning an
    engine upgrade) compares/profiles instead of crashing."""
    files: List[str] = []
    if os.path.isdir(path):
        for dirpath, _dirs, names in os.walk(path):
            for n in sorted(names):
                if n.endswith(".jsonl"):
                    files.append(os.path.join(dirpath, n))
    elif os.path.exists(path):
        files = [path]
    else:
        raise FileNotFoundError(f"no event log at {path}")
    if not files:
        raise FileNotFoundError(f"no .jsonl event logs under {path}")
    records: List[dict] = []
    old_schemas: set = set()
    for f in files:
        with open(f) as fh:
            for lineno, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                schema = rec.get("schema")
                if not isinstance(schema, int) or schema < 1 \
                        or schema > EVENT_SCHEMA_VERSION:
                    raise ValueError(
                        f"{f}:{lineno}: unsupported event schema "
                        f"{schema!r} (this tools build reads schemas "
                        f"1..{EVENT_SCHEMA_VERSION})")
                if schema < EVENT_SCHEMA_VERSION:
                    old_schemas.add(schema)
                records.append(rec)
    if old_schemas:
        import sys
        print(
            f"tools: {path} contains records with older event "
            f"schema(s) {sorted(old_schemas)} (current "
            f"{EVENT_SCHEMA_VERSION}); fields those versions lack "
            "are treated as 0/absent", file=sys.stderr)
    return records


def query_label(rec: dict) -> str:
    tag = rec.get("queryTag")
    return tag if tag else f"query_{rec.get('queryIndex')}"


# ---------------------------------------------------------------------------
# per-record analysis
# ---------------------------------------------------------------------------


def _metric(node: dict, name: str, default=0):
    m = node.get("metrics") or {}
    entry = m.get(name)
    if entry is None:
        return default
    return entry.get("value", default)


def iter_plan_nodes(plan: dict):
    yield plan
    for c in plan.get("children", ()):
        yield from iter_plan_nodes(c)


def op_self_times(plan: dict) -> List[dict]:
    """Per-operator self time: opTime minus the DIRECT children's
    opTime, clamped at zero (a child re-pulled during recovery can
    exceed its parent's accounted window)."""
    out: List[dict] = []

    def walk(node: dict):
        own = float(_metric(node, "opTime", 0.0))
        child_total = sum(float(_metric(c, "opTime", 0.0))
                          for c in node.get("children", ()))
        if "opTime" in (node.get("metrics") or {}):
            out.append({
                "op": node.get("op"),
                "describe": node.get("describe"),
                "loreId": node.get("loreId"),
                "selfTimeS": round(max(own - child_total, 0.0), 6),
                "opTimeS": round(own, 6),
                "rows": int(_metric(node, "numOutputRows", 0)),
                "batches": int(_metric(node, "numOutputBatches", 0)),
            })
        for c in node.get("children", ()):
            walk(c)

    walk(plan)
    out.sort(key=lambda e: -e["selfTimeS"])
    return out


#: metric names summed into each breakdown bucket (tree-wide)
_BREAKDOWN_METRICS = {
    "transfer": ("h2dTime", "d2hTime", "scanUploadTime", "d2hArrowTime",
                 "h2dArrowTime"),
    "shuffle": ("shuffleWriteTime", "shuffleReadTime", "iciExchangeTime",
                "localSplitTime"),
}


def time_breakdown(rec: dict) -> Dict[str, float]:
    """Compute vs transfer vs shuffle vs spill vs untracked, in seconds.
    Transfer/shuffle come from the tree's timing metrics, spill from the
    per-query spill-scope delta; compute is the attributed remainder."""
    plan = rec.get("plan") or {}
    totals = {k: 0.0 for k in _BREAKDOWN_METRICS}
    for node in iter_plan_nodes(plan):
        for bucket, names in _BREAKDOWN_METRICS.items():
            for n in names:
                totals[bucket] += float(_metric(node, n, 0.0))
    spill = float((rec.get("scopes") or {}).get("spill", {})
                  .get("spillTime", 0.0))
    spans = rec.get("spans") or {}
    wall = float(rec.get("wallS", 0.0))
    untracked = float(spans.get("untrackedS", 0.0))
    compute = max(wall - untracked - totals["transfer"]
                  - totals["shuffle"] - spill, 0.0)
    return {
        "computeS": round(compute, 6),
        "transferS": round(totals["transfer"], 6),
        "shuffleS": round(totals["shuffle"], 6),
        "spillS": round(spill, 6),
        "untrackedS": round(untracked, 6),
        "wallS": round(wall, 6),
    }


def analyze_query(rec: dict, top_n: int = 10) -> dict:
    spans = rec.get("spans") or {}
    wall = float(rec.get("wallS", 0.0))
    attributed = float(spans.get("attributedS", 0.0))
    coverage = (attributed / wall) if wall > 0 else 1.0
    retries = dict(rec.get("recovery") or {})
    return {
        "query": query_label(rec),
        "queryIndex": rec.get("queryIndex"),
        "wallS": round(wall, 6),
        "phasesS": rec.get("phasesS") or {},
        "dispatches": rec.get("dispatches", 0),
        "compileMs": round(float(rec.get("compileMs", 0.0)), 3),
        "executableCacheHit": bool(rec.get("executableCacheHit", False)),
        "padWasteRows": int(rec.get("padWasteRows", 0)),
        "healthState": rec.get("healthState", "HEALTHY"),
        "quarantined": bool(rec.get("quarantined", False)),
        "deviceReinits": int(rec.get("deviceReinits", 0)),
        "workerRestarts": int(rec.get("workerRestarts", 0)),
        "meshShape": rec.get("meshShape"),
        "iciBytes": int(rec.get("iciBytes", 0)),
        "shardSkew": float(rec.get("shardSkew", 0.0)),
        "meshDegradations": int(rec.get("meshDegradations", 0)),
        "shardRetries": int(rec.get("shardRetries", 0)),
        "gatherChecksFailed": int(rec.get("gatherChecksFailed", 0)),
        "hostTopology": rec.get("hostTopology"),
        "hostsLost": int(rec.get("hostsLost", 0)),
        "hostRelands": int(rec.get("hostRelands", 0)),
        "dcnExchanges": int(rec.get("dcnExchanges", 0)),
        "hostScans": rec.get("hostScans") or {},
        # schema v10 (out-of-core): the per-query memory-scope deltas
        "oomRetries": int(rec.get("oomRetries", 0)),
        "splitRetries": int(rec.get("splitRetries", 0)),
        "spillBytes": int(rec.get("spillBytes", 0)),
        "unspills": int(rec.get("unspills", 0)),
        "budgetPeak": int(rec.get("budgetPeak", 0)),
        # schema v11 (streaming): micro-batch/MV/sink work under this wall
        "microBatches": int(rec.get("microBatches", 0)),
        "mvRefreshes": int(rec.get("mvRefreshes", 0)),
        "mvIncrementalRefreshes": int(rec.get("mvIncrementalRefreshes", 0)),
        "mvFullRecomputes": int(rec.get("mvFullRecomputes", 0)),
        "sinkCommits": int(rec.get("sinkCommits", 0)),
        "sinkReplays": int(rec.get("sinkReplays", 0)),
        "mvEpoch": rec.get("mvEpoch"),
        "attribution": {
            "attributedS": round(attributed, 6),
            "untrackedS": round(float(spans.get("untrackedS", 0.0)), 6),
            "coverage": round(coverage, 4),
        },
        "breakdown": time_breakdown(rec),
        "topOpsBySelfTime": op_self_times(rec.get("plan") or {})[:top_n],
        "exchanges": rec.get("exchanges") or [],
        "fallbacks": rec.get("fallbacks") or [],
        "demotions": rec.get("demotions") or {},
        "aqe": rec.get("aqe") or {},
        "recovery": retries,
        "scopes": rec.get("scopes") or {},
        "faultReplays": rec.get("faultReplays", 0),
    }


# ---------------------------------------------------------------------------
# aggregate profile
# ---------------------------------------------------------------------------


def build_profile(records: Iterable[dict], top_n: int = 10,
                  coverage_floor: float = 0.95) -> dict:
    """The full report dict. ``coverage_floor`` marks queries whose span
    attribution falls below the contract (reported, never hidden)."""
    queries = []
    agg_ops: Dict[str, dict] = {}
    cache_hits = 0
    for r in records:
        if r.get("cacheHit"):
            # a cache-hit serve REPLAYS the filling run's plan metrics
            # with a near-zero serve wall (schema v2): aggregating it
            # would double-count every operator and produce coverage
            # ratios far above 1 — count it as served traffic instead
            cache_hits += 1
            continue
        queries.append(analyze_query(r, top_n=top_n))
        # aggregate from the FULL per-record op list — truncation is
        # display-only, or an op just below every per-query top-N would
        # vanish from the headline ranking
        for e in op_self_times(r.get("plan") or {}):
            a = agg_ops.setdefault(
                e["op"], {"op": e["op"], "selfTimeS": 0.0, "rows": 0,
                          "batches": 0, "queries": 0})
            a["selfTimeS"] = round(a["selfTimeS"] + e["selfTimeS"], 6)
            a["rows"] += e["rows"]
            a["batches"] += e["batches"]
            a["queries"] += 1
    top_ops = sorted(agg_ops.values(), key=lambda e: -e["selfTimeS"])
    total_wall = round(sum(q["wallS"] for q in queries), 6)
    fallback_ops: Dict[str, set] = {}
    for q in queries:
        for fb in q["fallbacks"]:
            fallback_ops.setdefault(fb["op"], set()).update(fb["reasons"])
    low_coverage = [q["query"] for q in queries
                    if q["attribution"]["coverage"] < coverage_floor]
    cold = [q["query"] for q in queries if q["compileMs"] > 0]
    def _compile_scope(q, key):
        return int((q["scopes"].get("compile") or {}).get(key, 0))

    compile_summary = {
        "totalCompileMs": round(sum(q["compileMs"] for q in queries), 3),
        "coldQueries": cold,
        "executableCacheHits": sum(
            1 for q in queries if q["executableCacheHit"]),
        "padWasteRows": sum(q["padWasteRows"] for q in queries),
        # which path each primitive resolved to at trace time
        # (kernels/): a demoted Pallas kernel is visible offline as
        # hloFallbacks > 0 plus a 'pallas:<name>' demotion entry
        "pallasKernels": sum(
            _compile_scope(q, "pallasKernels") for q in queries),
        "hloFallbacks": sum(
            _compile_scope(q, "hloFallbacks") for q in queries),
    }
    # mesh-native execution (schema v6): which queries ran on the mesh,
    # how much payload rode ICI collectives, the worst per-shard skew
    # the collectives measured, and how many requested exchanges
    # demoted to the host shuffle (from the per-record mesh scope)
    mesh_summary = {
        "meshShapes": sorted({q["meshShape"] for q in queries
                              if q["meshShape"]}),
        "meshQueries": sum(1 for q in queries if q["meshShape"]),
        "iciBytes": sum(q["iciBytes"] for q in queries),
        "maxShardSkew": round(max((q["shardSkew"] for q in queries),
                                  default=0.0), 4),
        "hostShuffleFallbacks": sum(
            int((q["scopes"].get("mesh") or {})
                .get("hostShuffleFallbacks", 0)) for q in queries),
    }
    # mesh resilience (schema v7): the fault-domain counters — how much
    # recovery work the distributed path paid and which queries rode
    # through a degradation
    mesh_resilience = {
        "meshDegradations": sum(q["meshDegradations"] for q in queries),
        "shardRetries": sum(q["shardRetries"] for q in queries),
        "gatherChecksFailed": sum(
            q["gatherChecksFailed"] for q in queries),
        "degradedQueries": sorted(
            {q["query"] for q in queries if q["meshDegradations"]}),
    }
    # host resilience (schema v8): the multi-host fault-domain counters
    # — hosts lost and shards re-landed during the run, plus how many
    # collectives crossed the DCN axis (cluster-spanning meshes)
    # per-executor-host scan attribution (schema v9): each host's
    # dispatch/frame/byte/wall totals summed over the run — the
    # per-host breakdown a skewed or flaky executor shows up in
    per_host: Dict[str, dict] = {}
    for q in queries:
        for host, st in (q["hostScans"] or {}).items():
            agg = per_host.setdefault(
                host, {"scans": 0, "files": 0, "bytes": 0,
                       "wallS": 0.0, "execWallS": 0.0, "crcRetries": 0})
            for k in agg:
                v = st.get(k, 0)
                agg[k] = (round(agg[k] + float(v), 6)
                          if isinstance(agg[k], float)
                          else agg[k] + int(v))
    host_resilience = {
        "hostTopologies": sorted({q["hostTopology"] for q in queries
                                  if q["hostTopology"]}),
        "hostsLost": sum(q["hostsLost"] for q in queries),
        "hostRelands": sum(q["hostRelands"] for q in queries),
        "dcnExchanges": sum(q["dcnExchanges"] for q in queries),
        "degradedQueries": sorted(
            {q["query"] for q in queries
             if q["hostsLost"] or q["hostRelands"]}),
        "perHost": {h: per_host[h] for h in sorted(per_host)},
    }
    # out-of-core memory (schema v10): retry/split/spill/unspill work
    # the run paid under the device budget, and which queries paid it
    memory_summary = {
        "oomRetries": sum(q["oomRetries"] for q in queries),
        "splitRetries": sum(q["splitRetries"] for q in queries),
        "spillBytes": sum(q["spillBytes"] for q in queries),
        "unspills": sum(q["unspills"] for q in queries),
        "budgetPeak": max((q["budgetPeak"] for q in queries), default=0),
        "spilledQueries": sorted(
            {q["query"] for q in queries
             if q["spillBytes"] or q["oomRetries"]}),
    }
    # streaming (schema v11): micro-batches, MV maintenance strategy
    # split, and the sink's exactly-once replay count
    streaming_summary = {
        "microBatches": sum(q["microBatches"] for q in queries),
        "mvRefreshes": sum(q["mvRefreshes"] for q in queries),
        "mvIncrementalRefreshes": sum(
            q["mvIncrementalRefreshes"] for q in queries),
        "mvFullRecomputes": sum(q["mvFullRecomputes"] for q in queries),
        "sinkCommits": sum(q["sinkCommits"] for q in queries),
        "sinkReplays": sum(q["sinkReplays"] for q in queries),
        "mvServes": sorted(
            {q["query"] for q in queries if q["mvEpoch"] is not None}),
    }
    # survivability (schema v4): how healthy was the process this run,
    # and which queries rode through recovery events
    survivability = {
        "deviceReinits": sum(q["deviceReinits"] for q in queries),
        "workerRestarts": sum(q["workerRestarts"] for q in queries),
        "quarantinedQueries": sorted(
            {q["query"] for q in queries if q["quarantined"]}),
        "healthStates": sorted({q["healthState"] for q in queries}),
        "nonHealthyQueries": sorted(
            {q["query"] for q in queries
             if q["healthState"] != "HEALTHY"}),
    }
    return {
        "queryCount": len(queries),
        "cacheHitRecords": cache_hits,
        "totalWallS": total_wall,
        "compile": compile_summary,
        "mesh": mesh_summary,
        "meshResilience": mesh_resilience,
        "hostResilience": host_resilience,
        "memory": memory_summary,
        "streaming": streaming_summary,
        "survivability": survivability,
        "minCoverage": round(min((q["attribution"]["coverage"]
                                  for q in queries), default=1.0), 4),
        "coverageFloor": coverage_floor,
        "queriesBelowCoverageFloor": low_coverage,
        "topOpsBySelfTime": top_ops[:top_n],
        "breakdown": {
            k: round(sum(q["breakdown"][k] for q in queries), 6)
            for k in ("computeS", "transferS", "shuffleS", "spillS",
                      "untrackedS", "wallS")},
        "fallbackInventory": {op: sorted(reasons)
                              for op, reasons in sorted(fallback_ops.items())},
        "queries": queries,
    }


def _fmt_s(v: float) -> str:
    return f"{v:9.4f}s"


def render_profile(report: dict) -> str:
    """Human rendering of a build_profile() report."""
    lines: List[str] = []
    if report.get("cacheHitRecords"):
        lines.append(f"Cache-hit serves (excluded from op stats): "
                     f"{report['cacheHitRecords']}")
    lines.append(f"Queries: {report['queryCount']}   total wall "
                 f"{report['totalWallS']:.4f}s   min span coverage "
                 f"{report['minCoverage'] * 100:.1f}%")
    if report["queriesBelowCoverageFloor"]:
        lines.append(
            f"  BELOW {report['coverageFloor'] * 100:.0f}% coverage: "
            + ", ".join(report["queriesBelowCoverageFloor"]))
    b = report["breakdown"]
    lines.append("Breakdown: "
                 f"compute {b['computeS']:.4f}s | transfer "
                 f"{b['transferS']:.4f}s | shuffle {b['shuffleS']:.4f}s | "
                 f"spill {b['spillS']:.4f}s | untracked "
                 f"{b['untrackedS']:.4f}s")
    c = report["compile"]
    lines.append(
        f"Compile: {c['totalCompileMs']:.1f}ms across "
        f"{len(c['coldQueries'])} cold queries | executable-cache hits "
        f"{c['executableCacheHits']}/{report['queryCount']} | pad waste "
        f"{c['padWasteRows']} rows")
    if c.get("pallasKernels") or c.get("hloFallbacks"):
        lines.append(
            f"Pallas kernels: {c['pallasKernels']} primitive sites on "
            f"the kernel path | {c['hloFallbacks']} HLO fallbacks "
            "(disabled / ineligible shape / demoted — demotions show "
            "per query below)")
    me = report["mesh"]
    if me["meshQueries"]:
        lines.append(
            f"Mesh: {me['meshQueries']}/{report['queryCount']} queries "
            f"on {','.join(me['meshShapes'])} | ICI "
            f"{me['iciBytes']} bytes | max shard skew "
            f"{me['maxShardSkew']:.2f} | host-shuffle fallbacks "
            f"{me['hostShuffleFallbacks']}")
    mr = report.get("meshResilience") or {}
    if (mr.get("meshDegradations") or mr.get("shardRetries")
            or mr.get("gatherChecksFailed")):
        lines.append(
            f"Mesh resilience: degradations {mr['meshDegradations']} | "
            f"shard retries {mr['shardRetries']} | gather checks failed "
            f"{mr['gatherChecksFailed']}"
            + (f" | degraded: {', '.join(mr['degradedQueries'])}"
               if mr.get("degradedQueries") else ""))
    hr = report.get("hostResilience") or {}
    if (hr.get("hostsLost") or hr.get("hostRelands")
            or hr.get("dcnExchanges") or hr.get("perHost")):
        lines.append(
            f"Host resilience: hosts lost {hr['hostsLost']} | shard "
            f"re-lands {hr['hostRelands']} | DCN exchanges "
            f"{hr['dcnExchanges']}"
            + (f" | topologies {','.join(hr['hostTopologies'])}"
               if hr.get("hostTopologies") else "")
            + (f" | degraded: {', '.join(hr['degradedQueries'])}"
               if hr.get("degradedQueries") else ""))
        for host, st in (hr.get("perHost") or {}).items():
            lines.append(
                f"  host {host}: {st['scans']} dispatches, "
                f"{st['files']} frames, {st['bytes']} bytes, wall "
                f"{st['wallS']:.4f}s (executor {st['execWallS']:.4f}s)"
                + (f", CRC retries {st['crcRetries']}"
                   if st.get("crcRetries") else ""))
    mm = report.get("memory") or {}
    if (mm.get("oomRetries") or mm.get("splitRetries")
            or mm.get("spillBytes") or mm.get("unspills")):
        lines.append(
            f"Memory: oom retries {mm['oomRetries']} | split retries "
            f"{mm['splitRetries']} | spilled {mm['spillBytes']} bytes | "
            f"unspills {mm['unspills']} | budget peak "
            f"{mm['budgetPeak']} bytes"
            + (f" | spilled: {', '.join(mm['spilledQueries'])}"
               if mm.get("spilledQueries") else ""))
    sm = report.get("streaming") or {}
    if (sm.get("microBatches") or sm.get("mvRefreshes")
            or sm.get("sinkCommits") or sm.get("sinkReplays")):
        lines.append(
            f"Streaming: micro-batches {sm['microBatches']} | sink "
            f"commits {sm['sinkCommits']} (replays {sm['sinkReplays']}) "
            f"| MV refreshes {sm['mvRefreshes']} "
            f"(incremental {sm['mvIncrementalRefreshes']}, full "
            f"{sm['mvFullRecomputes']})"
            + (f" | MV serves: {', '.join(sm['mvServes'])}"
               if sm.get("mvServes") else ""))
    sv = report["survivability"]
    if (sv["deviceReinits"] or sv["workerRestarts"]
            or sv["quarantinedQueries"]
            or sv["healthStates"] != ["HEALTHY"]):
        lines.append(
            f"Survivability: device reinits {sv['deviceReinits']} | "
            f"worker restarts {sv['workerRestarts']} | health states "
            f"{','.join(sv['healthStates'])}"
            + (f" | quarantined: {', '.join(sv['quarantinedQueries'])}"
               if sv["quarantinedQueries"] else ""))
    lines.append("")
    lines.append("Top operators by self time:")
    for e in report["topOpsBySelfTime"]:
        lines.append(f"  {_fmt_s(e['selfTimeS'])}  {e['op']:32s} "
                     f"rows={e['rows']} batches={e['batches']} "
                     f"queries={e['queries']}")
    if report["fallbackInventory"]:
        lines.append("")
        lines.append("Fallbacks:")
        for op, reasons in report["fallbackInventory"].items():
            for r in reasons:
                lines.append(f"  {op}: {r}")
    lines.append("")
    lines.append("Per query:")
    for q in report["queries"]:
        cov = q["attribution"]["coverage"] * 100
        qb = q["breakdown"]
        lines.append(
            f"  {q['query']:16s} wall {_fmt_s(q['wallS'])}  "
            f"coverage {cov:5.1f}%  dispatches {q['dispatches']:4d}  "
            f"shuffle {qb['shuffleS']:.4f}s  transfer "
            f"{qb['transferS']:.4f}s")
        for e in q["topOpsBySelfTime"][:3]:
            lines.append(f"      {_fmt_s(e['selfTimeS'])}  {e['describe']}")
        for ex in q["exchanges"]:
            parts = [f"{k}={v}" for k, v in ex.items()
                     if k not in ("op", "loreId")]
            lines.append(f"      exchange loreId={ex.get('loreId')} "
                         + " ".join(parts))
        recov = {k: v for k, v in q["recovery"].items() if v}
        if recov:
            lines.append(f"      recovery {recov}")
        if q["demotions"]:
            lines.append(f"      demotions {sorted(q['demotions'])}")
    return "\n".join(lines)


def profile_path(path: str, top_n: int = 10) -> dict:
    return build_profile(load_events(path), top_n=top_n)
