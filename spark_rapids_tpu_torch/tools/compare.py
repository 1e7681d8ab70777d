"""A/B comparison of two event logs (two bench/scale runs).

Matches queries by tag (falling back to query index). A tag usually has
several runs per log (time_query's warm trials); wall times compare as
MEDIANS across runs (min reported alongside) and the per-operator
opTime/self-time diff uses each side's median-wall run — single-sample
comparisons would read run-to-run variance as regressions. Ops are
matched by their position-stable plan path (``op[childIndex]...``) so a
changed plan shape shows up as added/removed ops, not a garbled diff."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.tools.report import (
    _metric,
    load_events,
    query_label,
)


def _op_times(plan: dict) -> Dict[str, dict]:
    """Plan-path -> {op, opTimeS, selfTimeS, rows} for every metered
    node."""
    out: Dict[str, dict] = {}

    def walk(node: dict, path: str):
        own = float(_metric(node, "opTime", 0.0))
        child_total = sum(float(_metric(c, "opTime", 0.0))
                          for c in node.get("children", ()))
        if "opTime" in (node.get("metrics") or {}):
            out[path] = {
                "op": node.get("op"),
                "opTimeS": round(own, 6),
                "selfTimeS": round(max(own - child_total, 0.0), 6),
                "rows": int(_metric(node, "numOutputRows", 0)),
            }
        for i, c in enumerate(node.get("children", ())):
            walk(c, f"{path}.{c.get('op')}[{i}]")

    walk(plan, str(plan.get("op")))
    return out


def _index(records: List[dict]) -> Dict[str, List[dict]]:
    """label -> ALL records with that tag (a tagged query typically has
    several warm runs per report; collapsing to one sample would turn
    run-to-run variance into phantom regressions)."""
    out: Dict[str, List[dict]] = {}
    for r in records:
        if r.get("cacheHit"):
            continue  # replayed metrics + ~0 wall would skew medians
        out.setdefault(query_label(r), []).append(r)
    return out


def _median_record(runs: List[dict]) -> dict:
    """The run with the median wall time — the representative sample
    whose plan tree the per-op diff uses."""
    ordered = sorted(runs, key=lambda r: float(r.get("wallS", 0.0)))
    return ordered[len(ordered) // 2]


def _wall_stats(runs: List[dict]) -> Tuple[float, float]:
    walls = sorted(float(r.get("wallS", 0.0)) for r in runs)
    return walls[0], walls[len(walls) // 2]


def compare_query(a_runs: List[dict], b_runs: List[dict]) -> dict:
    a, b = _median_record(a_runs), _median_record(b_runs)
    min_a, wall_a = _wall_stats(a_runs)
    min_b, wall_b = _wall_stats(b_runs)
    ops_a = _op_times(a.get("plan") or {})
    ops_b = _op_times(b.get("plan") or {})
    op_diffs = []
    for path in sorted(set(ops_a) | set(ops_b)):
        ea, eb = ops_a.get(path), ops_b.get(path)
        if ea is None or eb is None:
            op_diffs.append({
                "path": path,
                "op": (ea or eb)["op"],
                "status": "removed" if eb is None else "added",
                "opTimeS": (ea or eb)["opTimeS"],
            })
            continue
        d = round(eb["opTimeS"] - ea["opTimeS"], 6)
        op_diffs.append({
            "path": path, "op": ea["op"], "status": "common",
            "aOpTimeS": ea["opTimeS"], "bOpTimeS": eb["opTimeS"],
            "deltaOpTimeS": d,
            "deltaSelfTimeS": round(eb["selfTimeS"] - ea["selfTimeS"], 6),
            "deltaRows": eb["rows"] - ea["rows"],
        })
    op_diffs.sort(key=lambda e: -abs(e.get("deltaOpTimeS",
                                           e.get("opTimeS", 0.0))))
    fb_a = {f["op"]: f["reasons"] for f in a.get("fallbacks") or []}
    fb_b = {f["op"]: f["reasons"] for f in b.get("fallbacks") or []}
    return {
        "query": query_label(a),
        # wall times are MEDIANS over the tag's runs (min alongside);
        # per-op detail comes from each side's median-wall run
        "aRuns": len(a_runs),
        "bRuns": len(b_runs),
        "aWallS": round(wall_a, 6),
        "bWallS": round(wall_b, 6),
        "aWallMinS": round(min_a, 6),
        "bWallMinS": round(min_b, 6),
        "deltaWallS": round(wall_b - wall_a, 6),
        "speedup": round(wall_a / wall_b, 4) if wall_b > 0 else None,
        "aDispatches": a.get("dispatches", 0),
        "bDispatches": b.get("dispatches", 0),
        # cold-vs-warm compile breakdown (schema v3): SUMS over the
        # tag's runs — a median would hide the one cold run per tag
        "aCompileMs": round(sum(float(r.get("compileMs", 0.0))
                                for r in a_runs), 3),
        "bCompileMs": round(sum(float(r.get("compileMs", 0.0))
                                for r in b_runs), 3),
        "aExecutableCacheHits": sum(
            1 for r in a_runs if r.get("executableCacheHit")),
        "bExecutableCacheHits": sum(
            1 for r in b_runs if r.get("executableCacheHit")),
        # survivability (schema v4): recovery events under each side's
        # runs — a perf regression explained by a device reinit mid-run
        # is a different conversation than a plan regression
        "aDeviceReinits": sum(int(r.get("deviceReinits", 0))
                              for r in a_runs),
        "bDeviceReinits": sum(int(r.get("deviceReinits", 0))
                              for r in b_runs),
        "aWorkerRestarts": sum(int(r.get("workerRestarts", 0))
                               for r in a_runs),
        "bWorkerRestarts": sum(int(r.get("workerRestarts", 0))
                               for r in b_runs),
        # mesh-native execution (schema v6): ICI payload per side — a
        # wall delta between an on-mesh and an off-mesh run shows up
        # here before anyone blames the plan
        "aIciBytes": sum(int(r.get("iciBytes", 0)) for r in a_runs),
        "bIciBytes": sum(int(r.get("iciBytes", 0)) for r in b_runs),
        # mesh fault domain (schema v7): recovery work the distributed
        # path paid per side — a wall regression explained by shard
        # retries or a mid-run degradation is not a plan regression
        "aShardRetries": sum(int(r.get("shardRetries", 0))
                             for r in a_runs),
        "bShardRetries": sum(int(r.get("shardRetries", 0))
                             for r in b_runs),
        "aMeshDegradations": sum(int(r.get("meshDegradations", 0))
                                 for r in a_runs),
        "bMeshDegradations": sum(int(r.get("meshDegradations", 0))
                                 for r in b_runs),
        "aGatherChecksFailed": sum(int(r.get("gatherChecksFailed", 0))
                                   for r in a_runs),
        "bGatherChecksFailed": sum(int(r.get("gatherChecksFailed", 0))
                                   for r in b_runs),
        # host fault domain (schema v8): per-side host losses / shard
        # re-lands / DCN crossings — a wall regression explained by a
        # mid-run host loss is not a plan regression
        "aHostsLost": sum(int(r.get("hostsLost", 0)) for r in a_runs),
        "bHostsLost": sum(int(r.get("hostsLost", 0)) for r in b_runs),
        "aHostRelands": sum(int(r.get("hostRelands", 0))
                            for r in a_runs),
        "bHostRelands": sum(int(r.get("hostRelands", 0))
                            for r in b_runs),
        "aDcnExchanges": sum(int(r.get("dcnExchanges", 0))
                             for r in a_runs),
        "bDcnExchanges": sum(int(r.get("dcnExchanges", 0))
                             for r in b_runs),
        # memory fault domain (schema v10): per-side spill/retry work —
        # a wall regression explained by out-of-core spilling under a
        # tighter budget is not a plan regression
        "aOomRetries": sum(int(r.get("oomRetries", 0)) for r in a_runs),
        "bOomRetries": sum(int(r.get("oomRetries", 0)) for r in b_runs),
        "aSplitRetries": sum(int(r.get("splitRetries", 0))
                             for r in a_runs),
        "bSplitRetries": sum(int(r.get("splitRetries", 0))
                             for r in b_runs),
        "aSpillBytes": sum(int(r.get("spillBytes", 0)) for r in a_runs),
        "bSpillBytes": sum(int(r.get("spillBytes", 0)) for r in b_runs),
        "aUnspills": sum(int(r.get("unspills", 0)) for r in a_runs),
        "bUnspills": sum(int(r.get("unspills", 0)) for r in b_runs),
        "ops": op_diffs,
        "newFallbacks": sorted(set(fb_b) - set(fb_a)),
        "resolvedFallbacks": sorted(set(fb_a) - set(fb_b)),
    }


def build_compare(path_a: str, path_b: str) -> dict:
    idx_a = _index(load_events(path_a))
    idx_b = _index(load_events(path_b))
    common = [k for k in idx_a if k in idx_b]
    queries = [compare_query(idx_a[k], idx_b[k]) for k in common]
    total_a = round(sum(q["aWallS"] for q in queries), 6)
    total_b = round(sum(q["bWallS"] for q in queries), 6)
    compile_a = round(sum(q["aCompileMs"] for q in queries), 3)
    compile_b = round(sum(q["bCompileMs"] for q in queries), 3)
    return {
        "a": path_a,
        "b": path_b,
        "matchedQueries": len(queries),
        "totalACompileMs": compile_a,
        "totalBCompileMs": compile_b,
        "deltaCompileMs": round(compile_b - compile_a, 3),
        "aDeviceReinits": sum(q["aDeviceReinits"] for q in queries),
        "bDeviceReinits": sum(q["bDeviceReinits"] for q in queries),
        "aWorkerRestarts": sum(q["aWorkerRestarts"] for q in queries),
        "bWorkerRestarts": sum(q["bWorkerRestarts"] for q in queries),
        "aIciBytes": sum(q["aIciBytes"] for q in queries),
        "bIciBytes": sum(q["bIciBytes"] for q in queries),
        "aShardRetries": sum(q["aShardRetries"] for q in queries),
        "bShardRetries": sum(q["bShardRetries"] for q in queries),
        "aMeshDegradations": sum(q["aMeshDegradations"] for q in queries),
        "bMeshDegradations": sum(q["bMeshDegradations"] for q in queries),
        "aGatherChecksFailed": sum(q["aGatherChecksFailed"]
                                   for q in queries),
        "bGatherChecksFailed": sum(q["bGatherChecksFailed"]
                                   for q in queries),
        "aOomRetries": sum(q["aOomRetries"] for q in queries),
        "bOomRetries": sum(q["bOomRetries"] for q in queries),
        "aSplitRetries": sum(q["aSplitRetries"] for q in queries),
        "bSplitRetries": sum(q["bSplitRetries"] for q in queries),
        "aSpillBytes": sum(q["aSpillBytes"] for q in queries),
        "bSpillBytes": sum(q["bSpillBytes"] for q in queries),
        "aUnspills": sum(q["aUnspills"] for q in queries),
        "bUnspills": sum(q["bUnspills"] for q in queries),
        "onlyInA": sorted(set(idx_a) - set(idx_b)),
        "onlyInB": sorted(set(idx_b) - set(idx_a)),
        "totalAWallS": total_a,
        "totalBWallS": total_b,
        "totalSpeedup": round(total_a / total_b, 4) if total_b > 0 else None,
        "queries": queries,
    }


def render_compare(cmp: dict, top_n: int = 5) -> str:
    lines: List[str] = []
    lines.append(f"A: {cmp['a']}")
    lines.append(f"B: {cmp['b']}")
    lines.append(f"Matched queries: {cmp['matchedQueries']}   total "
                 f"{cmp['totalAWallS']:.4f}s -> {cmp['totalBWallS']:.4f}s"
                 + (f"   speedup {cmp['totalSpeedup']}x"
                    if cmp["totalSpeedup"] else ""))
    for side, key in (("only in A", "onlyInA"), ("only in B", "onlyInB")):
        if cmp[key]:
            lines.append(f"  {side}: {', '.join(cmp[key])}")
    lines.append(f"Compile: {cmp['totalACompileMs']:.1f}ms -> "
                 f"{cmp['totalBCompileMs']:.1f}ms "
                 f"({cmp['deltaCompileMs']:+.1f}ms)")
    if cmp["aIciBytes"] or cmp["bIciBytes"]:
        lines.append(f"Mesh: ICI bytes {cmp['aIciBytes']} -> "
                     f"{cmp['bIciBytes']}")
    if (cmp.get("aShardRetries") or cmp.get("bShardRetries")
            or cmp.get("aMeshDegradations")
            or cmp.get("bMeshDegradations")
            or cmp.get("aGatherChecksFailed")
            or cmp.get("bGatherChecksFailed")):
        lines.append(
            f"Mesh resilience: shard retries {cmp['aShardRetries']} -> "
            f"{cmp['bShardRetries']} | degradations "
            f"{cmp['aMeshDegradations']} -> {cmp['bMeshDegradations']} | "
            f"gather checks failed {cmp['aGatherChecksFailed']} -> "
            f"{cmp['bGatherChecksFailed']}")
    if (cmp.get("aOomRetries") or cmp.get("bOomRetries")
            or cmp.get("aSpillBytes") or cmp.get("bSpillBytes")
            or cmp.get("aSplitRetries") or cmp.get("bSplitRetries")):
        lines.append(
            f"Memory: oom retries {cmp['aOomRetries']} -> "
            f"{cmp['bOomRetries']} | split retries "
            f"{cmp['aSplitRetries']} -> {cmp['bSplitRetries']} | "
            f"spilled {cmp['aSpillBytes']} -> {cmp['bSpillBytes']} "
            f"bytes | unspills {cmp['aUnspills']} -> {cmp['bUnspills']}")
    if (cmp["aDeviceReinits"] or cmp["bDeviceReinits"]
            or cmp["aWorkerRestarts"] or cmp["bWorkerRestarts"]):
        lines.append(
            f"Survivability: device reinits "
            f"{cmp['aDeviceReinits']} -> {cmp['bDeviceReinits']} | "
            f"worker restarts {cmp['aWorkerRestarts']} -> "
            f"{cmp['bWorkerRestarts']}")
    for q in cmp["queries"]:
        arrow = f"{q['aWallS']:.4f}s -> {q['bWallS']:.4f}s"
        sp = f"  ({q['speedup']}x)" if q.get("speedup") else ""
        runs = (f"  [median of {q['aRuns']}/{q['bRuns']} runs]"
                if max(q["aRuns"], q["bRuns"]) > 1 else "")
        lines.append(f"  {q['query']:16s} {arrow}{sp}  dispatches "
                     f"{q['aDispatches']} -> {q['bDispatches']}{runs}")
        for e in q["ops"][:top_n]:
            if e["status"] != "common":
                lines.append(f"      {e['status']:7s} {e['path']} "
                             f"({e['opTimeS']:.4f}s)")
            elif e["deltaOpTimeS"]:
                lines.append(
                    f"      {e['deltaOpTimeS']:+9.4f}s {e['path']} "
                    f"(self {e['deltaSelfTimeS']:+.4f}s, rows "
                    f"{e['deltaRows']:+d})")
        if q["newFallbacks"]:
            lines.append(f"      NEW fallbacks: {', '.join(q['newFallbacks'])}")
        if q["resolvedFallbacks"]:
            lines.append("      resolved fallbacks: "
                         + ", ".join(q["resolvedFallbacks"]))
    return "\n".join(lines)
