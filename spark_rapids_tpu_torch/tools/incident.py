"""``tools incident`` — render flight-recorder bundles offline (port of
``spark_rapids_tpu/tools/incident.py``; the renderer is the reference's,
and the port's bundles hold the mesh and cluster sections idle).

The black-box reader: loads the incident bundles the flight recorder
(obs/telemetry.py) dumped under ``spark.rapids.obs.flightRecorder.dir``
and renders each one — the triggering fault point and ladder
rung/action, the health/mesh/cluster topology at the instant of the
incident, ladder + recovery counters, the telemetry tail, recent
event-record summaries, and any live query table captured. Stdlib-only
over the JSON bundles, like the rest of the tools."""

from __future__ import annotations

import json
import os
from typing import List


def load_bundles(path: str) -> List[dict]:
    """Load bundles from one .json file or a flight-recorder dir
    (oldest first — bundle filenames sort by millisecond timestamp).
    Unreadable bundles are skipped with a stub entry rather than
    failing the whole render (a truncated bundle from a dying process
    is exactly when you need the others)."""
    if os.path.isdir(path):
        files = [os.path.join(path, n) for n in sorted(os.listdir(path))
                 if n.startswith("incident-") and n.endswith(".json")]
    elif os.path.exists(path):
        files = [path]
    else:
        raise FileNotFoundError(f"no incident bundle(s) at {path}")
    if not files:
        raise FileNotFoundError(f"no incident bundles under {path}")
    out: List[dict] = []
    for f in files:
        try:
            with open(f) as fh:
                b = json.load(fh)
        except (OSError, ValueError) as exc:
            b = {"kind": "unreadable", "action": "",
                 "reason": f"{type(exc).__name__}: {exc}"}
        b["_path"] = f
        out.append(b)
    return out


def _counters_line(d: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted((d or {}).items())
                    if v) or "(none)"


def render_incident(bundles: List[dict], last: int = 0) -> str:
    """Human rendering; ``last`` > 0 renders only the newest N (the
    full count still heads the output)."""
    lines: List[str] = [f"Incident bundles: {len(bundles)}"]
    shown = bundles[-last:] if last > 0 else bundles
    for b in shown:
        lines.append("")
        lines.append(f"== {os.path.basename(b.get('_path', '?'))}")
        lines.append(
            f"   kind={b.get('kind')} action={b.get('action')}"
            + (f" seq={b['seq']}" if b.get("seq") else "")
            + (f" domain={b['faultDomain']}" if b.get("faultDomain")
               else "")
            + (f" faultPoint={b['faultPoint']}" if b.get("faultPoint")
               else ""))
        lines.append(f"   trigger: {b.get('reason')}")
        health = b.get("health") or {}
        if health:
            lines.append(
                f"   health: {health.get('state')}"
                + (f" (CPU-only: {health['cpuOnlyReason']})"
                   if health.get("cpuOnlyReason") else ""))
            lines.append("   ladder: backend "
                         + _counters_line(health.get("backend"))
                         + " | mesh "
                         + _counters_line(health.get("meshLadder"))
                         + " | host "
                         + _counters_line(health.get("hostLadder")))
        cluster = b.get("cluster") or {}
        if cluster.get("enabled"):
            lines.append(
                f"   cluster: {len(cluster.get('liveHosts') or [])}/"
                f"{cluster.get('declaredHosts')} live"
                + (f", lost {','.join(cluster['lostHosts'])}"
                   if cluster.get("lostHosts") else "")
                + (f", excluded {','.join(cluster['excludedHosts'])}"
                   if cluster.get("excludedHosts") else "")
                + (f", single-process: {cluster['singleProcessReason']}"
                   if cluster.get("singleProcessReason") else ""))
        mesh = b.get("mesh") or {}
        if mesh.get("shape"):
            lines.append(f"   mesh: {mesh.get('shape')}"
                         + (f", excluded devices "
                            f"{mesh.get('excludedDeviceIds')}"
                            if mesh.get("excludedDeviceIds") else ""))
        if b.get("demotions"):
            lines.append("   demotions: "
                         + ", ".join(sorted(b["demotions"])))
        if b.get("faultFires"):
            lines.append("   fault fires: "
                         + _counters_line(b["faultFires"]))
        if b.get("recovery"):
            lines.append("   recovery: " + _counters_line(b["recovery"]))
        quarantine = b.get("quarantine") or {}
        if quarantine.get("strikes"):
            lines.append(f"   quarantine: {quarantine['strikes']} "
                         f"strikes, {quarantine.get('quarantined', 0)} "
                         f"templates quarantined")
        tele = b.get("telemetry") or {}
        tail = tele.get("tail") or []
        sampler = tele.get("sampler") or {}
        lines.append(
            f"   telemetry tail: {len(tail)} samples "
            f"(sampler {'on' if sampler.get('enabled') else 'off'}, "
            f"{sampler.get('intervalMs', '?')}ms)")
        if tail:
            last_s = tail[-1]
            moved = {s: d for s, d in (last_s.get("deltas") or {}).items()}
            lines.append(
                f"     last: health={last_s.get('health')} "
                f"hosts={last_s.get('hostTopology')} "
                f"mesh={last_s.get('meshShape')}"
                + (f" deltas={json.dumps(moved, sort_keys=True)}"
                   if moved else ""))
        recent = b.get("recentEvents") or []
        if recent:
            lines.append(f"   recent queries ({len(recent)}):")
            for r in recent[-5:]:
                lines.append(
                    f"     #{r.get('queryIndex')} "
                    f"{r.get('queryTag') or '-'} wall="
                    f"{r.get('wallS')}s health={r.get('healthState')}"
                    + (f" demotions={r['demotions']}"
                       if r.get("demotions") else ""))
        for svc in b.get("activeQueries") or []:
            if svc.get("queries"):
                lines.append(f"   live queries: {len(svc['queries'])}")
                for q in svc["queries"][:8]:
                    lines.append(
                        f"     #{q.get('id')} {q.get('state')} "
                        f"{q.get('pool')}/{q.get('tenant')} "
                        f"tag={q.get('tag') or '-'}")
            elif not svc.get("available"):
                lines.append("   live queries: (service busy — table "
                             "unavailable at capture time)")
    return "\n".join(lines)
