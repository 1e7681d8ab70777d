"""Warmup: replay an event log's plans before traffic arrives (port of
``spark_rapids_tpu/tools/warmup.py``).

``python -m spark_rapids_tpu_torch.tools warmup --eventlog-dir DIR``
reads the query event logs a previous serving period wrote
(``spark.rapids.sql.eventLog.*``), reduces them to DISTINCT plans (full
structural fingerprints, plan/fingerprint.py) and runs each once over
generated tables, so that:

* every kernel library the log's queries launch is built by nvcc
  (``kernels/build.py``; the libraries persist in the package's
  ``_build/``, so a later process loads them instead of compiling);
* the plan -> executable cache holds each plan's converted tree, for the
  session this warms (in-process callers pass theirs);
* the report says what was built and what was already warm: per query
  ``status`` is ``compiled`` when the query built a kernel library and
  ``warm`` otherwise, with ``newTraces`` (libraries built) and
  ``compileMs`` (their nvcc seconds; dispatch.py's meanings).

A record is replayed by its ``queryTag`` (``<qname>[@tenant][_serial]
[_cold]``) against the port's own corpus (models/corpus.py), else by its
``sqlText`` through ``TorchSession.sql`` over the generated tables
registered as temp views. Records matching neither are reported as
unmatched, never dropped.

Not in the port: CUDA-graph capture of the replayed queries (ROADMAP
Queue 2): the reference replays no captured program either, and every
warm query of the port makes host syncs that a capture forbids.
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Optional

#: harness tag suffixes: q3@tenant1, q3_serial_cold, q3_serial, q3_cold
_TAG_RE = re.compile(r"^(?P<name>[A-Za-z0-9_]+?)"
                     r"(?:_serial)?(?:_cold)?(?:@[\w-]+)?$")


def _corpus_name(tag: Optional[str], known) -> Optional[str]:
    if not tag:
        return None
    m = _TAG_RE.match(tag.split("@")[0])
    if m and m.group("name") in known:
        return m.group("name")
    base = tag.split("@")[0]
    for suffix in ("_serial_cold", "_serial", "_cold"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
    return base if base in known else None


def run_warmup(eventlog_dir: str, sf: float = 0.05, seed: int = 0,
               use_sql: bool = False, tables: Optional[Dict] = None,
               session=None, device=None) -> dict:
    """Replay the event log under ``eventlog_dir``; returns the JSON-ready
    report. ``tables``/``session`` let an in-process caller warm against
    ITS tables, so that the executable cache (which keys in-memory tables
    by identity) warms too; standalone runs generate the corpus tables at
    ``sf``/``seed`` on ``device`` (None: the current CUDA device) and
    warm the kernel libraries."""
    from spark_rapids_tpu_torch.dispatch import COMPILE_SCOPE
    from spark_rapids_tpu_torch.models.corpus import (
        build_queries,
        build_sql_queries,
        corpus_tables,
    )
    from spark_rapids_tpu_torch.plan.fingerprint import (
        EXECUTABLE_NEUTRAL_PREFIXES,
        fingerprint,
    )
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.tools.report import load_events

    records = load_events(eventlog_dir)
    if tables is None:
        tables = corpus_tables(sf, seed)
    if session is None:
        # replays must not append records to the very log they read
        session = TorchSession({"spark.rapids.sql.eventLog.enabled":
                                "false"}, device=device)
    build = build_sql_queries if use_sql else build_queries
    corpus = build(session, tables)

    # distinct work units out of the record stream, in order
    units: Dict[str, dict] = {}
    unmatched: List[str] = []
    for rec in records:
        name = _corpus_name(rec.get("queryTag"), corpus)
        if name is not None:
            units.setdefault(f"corpus:{name}", {"kind": "corpus",
                                                "name": name})
            continue
        sql = rec.get("sqlText")
        if sql:
            units.setdefault(f"sql:{sql}", {
                "kind": "sql", "name": rec.get("queryTag") or
                f"query_{rec.get('queryIndex')}", "sql": sql})
            continue
        unmatched.append(str(rec.get("queryTag") or
                             f"query_{rec.get('queryIndex')}"))

    # SQL replays bind against the tables as temp views
    if any(u["kind"] == "sql" for u in units.values()):
        from spark_rapids_tpu_torch.plan import from_host_table
        for tname, t in tables.items():
            from_host_table(t, session).create_or_replace_temp_view(tname)

    seen_plans = set()
    queries: List[dict] = []
    compiled = skipped = failed = 0
    before_all = dict(COMPILE_SCOPE)
    t_start = time.perf_counter()
    for unit in units.values():
        label = unit["name"]
        try:
            if unit["kind"] == "corpus":
                df = corpus[unit["name"]]()
            else:
                df = session.sql(unit["sql"])
            # dedupe by the FULL fingerprint: a literal variant converts
            # a tree of its own
            plan_fp = fingerprint(
                df.plan, session.conf, strip_literals=False,
                neutral_prefixes=EXECUTABLE_NEUTRAL_PREFIXES)
            if plan_fp is not None and plan_fp in seen_plans:
                skipped += 1
                queries.append({"query": label, "status": "skipped",
                                "reason": "duplicate plan"})
                continue
            before = dict(COMPILE_SCOPE)
            t0 = time.perf_counter()
            df.collect_table()
            wall = time.perf_counter() - t0
            traces = (COMPILE_SCOPE.get("kernelTraces", 0)
                      - before.get("kernelTraces", 0))
            if plan_fp is not None:
                seen_plans.add(plan_fp)
            queries.append({
                "query": label,
                "status": "compiled" if traces else "warm",
                "newTraces": int(traces),
                "compileMs": float(session.last_compile_ms or 0.0),
                "executableCacheHit":
                    bool(session.last_executable_cache_hit),
                "wallS": round(wall, 4),
            })
            if traces:
                compiled += 1
            else:
                skipped += 1
        except Exception as exc:  # a bad replay must not stop the rest
            failed += 1
            queries.append({"query": label, "status": "failed",
                            "reason": f"{type(exc).__name__}: {exc}"})
    delta = {k: COMPILE_SCOPE.get(k, 0) - before_all.get(k, 0)
             for k in ("kernelTraces", "kernelCompileTime",
                       "executableCacheHits", "executableCacheMisses")}
    return {
        "mode": "warmup",
        "eventlogDir": eventlog_dir,
        "scaleFactor": sf,
        "seed": seed,
        "form": "sql" if use_sql else "dsl",
        "eventRecords": len(records),
        "distinctUnits": len(units),
        "unmatchedRecords": sorted(set(unmatched)),
        # the kernel libraries persist in the package's _build/
        "persistentCompileCache": True,
        "programsCompiled": compiled,
        "programsSkipped": skipped,
        "failures": failed,
        "newTraces": int(delta["kernelTraces"]),
        "compileSTotal": round(float(delta["kernelCompileTime"]), 4),
        "wallS": round(time.perf_counter() - t_start, 4),
        "queries": queries,
        "ok": failed == 0 and len(units) > 0,
    }


def render_warmup(report: dict) -> str:
    lines = [
        f"Warmup: {report['distinctUnits']} distinct templates from "
        f"{report['eventRecords']} event records "
        f"({report['eventlogDir']})",
        f"  programs compiled {report['programsCompiled']}  "
        f"(skipped {report['programsSkipped']}, "
        f"failed {report['failures']})",
        f"  kernel libraries built {report['newTraces']}  "
        f"({report['compileSTotal']:.2f}s in nvcc, "
        f"wall {report['wallS']:.2f}s)",
        f"  persistent cache  {report['persistentCompileCache']}",
    ]
    for q in report["queries"]:
        if q["status"] == "failed":
            lines.append(f"    {q['query']}: FAILED {q['reason']}")
    if report["unmatchedRecords"]:
        lines.append("  unmatched records: "
                     + ", ".join(report["unmatchedRecords"][:10]))
    return "\n".join(lines)
