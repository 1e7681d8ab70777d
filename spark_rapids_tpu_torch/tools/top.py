"""``tools top`` — live view of a running QueryService (port of
``spark_rapids_tpu/tools/top.py``; the renderer is the reference's, so a
document renders the same in both).

Polls the loopback introspection endpoint
(``spark.rapids.service.introspect.enabled`` — service/introspect.py)
and renders the service the way ``top`` renders a machine: health +
topology header, rolling per-pool/tenant p50/p95 SLOs over finished
handles, the live query table, and the telemetry ring's latest
deltas. One-shot by default; ``--watch SECONDS`` refreshes in place.
Stdlib-only over the JSON surface — runs anywhere that can reach
127.0.0.1 of the serving process."""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import List, Optional


def fetch_top(url: str, timeout_s: float = 5.0) -> dict:
    """GET the /top document. Raises ConnectionError with a usable
    message when nothing is listening."""
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except (urllib.error.URLError, OSError, ValueError) as exc:
        raise ConnectionError(
            f"cannot read the introspection endpoint at {url} "
            f"({exc}); is the service running with "
            "spark.rapids.service.introspect.enabled=true?") from exc


def _fmt_slo(entry: dict) -> str:
    lat, run = entry["latency"], entry["run"]
    return (f"n={entry['count']:<5d} latency p50 {lat['p50S']:8.4f}s "
            f"p95 {lat['p95S']:8.4f}s | run p50 {run['p50S']:8.4f}s "
            f"p95 {run['p95S']:8.4f}s")


def render_top(doc: dict) -> str:
    """Human rendering of one /top document."""
    lines: List[str] = []
    health = doc.get("health") or {}
    stats = doc.get("stats") or {}
    mesh = health.get("mesh") or {}
    hosts = health.get("hosts") or {}
    lines.append(
        f"Service: {health.get('state', '?')}   workers "
        f"{health.get('workerCount', '?')} "
        f"(lost {health.get('workersLost', 0)}, respawned "
        f"{health.get('workersRespawned', 0)})   running "
        f"{stats.get('running', 0)}   queued "
        f"{sum((stats.get('queued') or {}).values())}")
    topo = []
    if mesh.get("shape"):
        topo.append(f"mesh {mesh['shape']}")
    if hosts.get("enabled"):
        live = len(hosts.get("liveHosts") or [])
        topo.append(f"hosts {live}/{hosts.get('declaredHosts', '?')}"
                    + (f" (lost: {','.join(hosts['lostHosts'])})"
                       if hosts.get("lostHosts") else ""))
    if health.get("cpuOnlyReason"):
        topo.append(f"CPU-ONLY: {health['cpuOnlyReason']}")
    if topo:
        lines.append("Topology: " + " | ".join(topo))
    counters = {k: stats.get(k, 0)
                for k in ("submitted", "finished", "failed", "cancelled",
                          "timed_out", "rejected", "requeued")}
    lines.append("Lifecycle: " + "  ".join(f"{k}={v}"
                                           for k, v in counters.items()))
    slo = doc.get("slo") or {}
    if slo.get("pools"):
        lines.append("")
        lines.append(f"SLOs (rolling {slo.get('window')} finished):")
        for pool, entry in sorted(slo["pools"].items()):
            lines.append(f"  pool   {pool:20s} {_fmt_slo(entry)}")
        for tenant, entry in (slo.get("tenants") or {}).items():
            lines.append(f"  tenant {tenant:20s} {_fmt_slo(entry)}")
    streams = doc.get("streams") or []
    if streams:
        lines.append("")
        lines.append(f"Streams: {len(streams)} recurring")
        for st in streams:
            src = (st.get("source") or {}).get("kind", "?")
            lines.append(
                f"  {st.get('name', '?'):20s} {st.get('state', '?'):9s} "
                f"{st.get('pool')}/{st.get('tenant')}  src={src}  "
                f"batches={st.get('batchesRun', 0)} "
                f"(committed #{st.get('lastCommittedId', -1)}) "
                f"rows={st.get('rowsSunk', 0)}")
    queries = doc.get("queries") or []
    lines.append("")
    lines.append(f"Live queries: {len(queries)}")
    for q in queries:
        age = (f"running {q['runningS']}s" if q.get("runningS") is not None
               else f"queued {q.get('queuedS')}s")
        lines.append(
            f"  #{q['id']:<5d} {q['state']:9s} {q['pool']}/{q['tenant']}"
            f"  tag={q.get('tag') or '-'}  {age}"
            + (f"  [{q['worker']}]" if q.get("worker") else ""))
    tele = doc.get("telemetry") or {}
    sampler = tele.get("sampler") or {}
    tail = tele.get("tail") or []
    lines.append("")
    lines.append(
        f"Telemetry: {'on' if sampler.get('enabled') else 'off'} "
        f"(interval {sampler.get('intervalMs', '?')}ms, "
        f"{sampler.get('samples', 0)} samples, "
        f"{sampler.get('buffered', 0)} buffered)")
    if tail:
        last = tail[-1]
        lines.append(
            f"  last sample: health={last.get('health')} "
            f"mesh={last.get('meshShape')} "
            f"hosts={last.get('hostTopology')}")
        for scope, deltas in sorted((last.get("deltas") or {}).items()):
            parts = [f"{k}={v}" for k, v in sorted(deltas.items())]
            lines.append(f"    {scope}: " + " ".join(parts))
    return "\n".join(lines)


def run_top(url: Optional[str] = None, port: Optional[int] = None,
            watch_s: float = 0.0, iterations: Optional[int] = None,
            as_json: bool = False) -> int:
    """CLI driver: one-shot (default) or --watch polling loop.
    ``iterations`` bounds a watch loop (tests); exit 1 when the
    endpoint is unreachable."""
    import sys
    import time
    if url is None:
        if port is None:
            print("tools top: need --url or --port (the service "
                  "reports its bound port as introspect_port)",
                  file=sys.stderr)
            return 2
        url = f"http://127.0.0.1:{int(port)}/top"
    n = 0
    while True:
        try:
            doc = fetch_top(url)
        except ConnectionError as exc:
            print(str(exc), file=sys.stderr)
            return 1
        print(json.dumps(doc, sort_keys=True) if as_json
              else render_top(doc))
        n += 1
        if watch_s <= 0 or (iterations is not None and n >= iterations):
            return 0
        time.sleep(watch_s)
