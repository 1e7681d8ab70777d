"""CLI: ``python -m spark_rapids_tpu_torch.tools`` (port of
``spark_rapids_tpu/tools/__main__.py``).

Subcommands:

* ``profile <eventlog>``: profiling report over a .jsonl event log (or a
  directory of them): top operators by self time, the compute, transfer,
  shuffle and spill breakdown, per-exchange summary, span attribution
  with the untracked remainder.
* ``compare <A> <B>``: per-query and per-operator diff of two runs.
* ``warmup --eventlog-dir DIR``: replay a log's distinct plans to build
  the kernel libraries and fill the executable cache before traffic
  arrives (``--require-cuda`` takes the reference's ``--require-tpu``
  gate's place).
* ``loadtest``: the corpus through the concurrent query service across
  simulated tenants; reports throughput, p50/p95 latency, queue wait,
  the result cache's hit rate and the cold/warm serial walls, holding
  every result against its serial run (exit 1 on any divergence).
* ``top``: live view of a running QueryService over its loopback
  introspection endpoint (``spark.rapids.service.introspect.enabled``).
* ``incident``: render the flight recorder's bundles
  (``spark.rapids.obs.flightRecorder.dir``).
* ``vacuum``: needs Delta and raises naming ROADMAP item [12b].

``--json`` emits the raw report dict; ``profile`` exits 2 when a query's
span coverage falls below ``--coverage-floor`` (default 0.95).
"""

from __future__ import annotations

import argparse
import json
import sys

#: the reference's subcommands that need what the port lacks
NOT_PORTED = {
    "vacuum": "Delta (delta/*)",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_tpu_torch.tools",
        description="offline profiling / qualification tools over query "
                    "event logs (spark.rapids.sql.eventLog.*)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("profile", help="profiling report over one run")
    p.add_argument("eventlog", help=".jsonl event log file or directory")
    p.add_argument("--json", action="store_true",
                   help="emit the raw report JSON")
    p.add_argument("--top", type=int, default=10,
                   help="operators to show per ranking (default 10)")
    p.add_argument("--coverage-floor", type=float, default=0.95,
                   help="minimum span attribution per query; below it "
                        "the command exits 2 (default 0.95)")

    c = sub.add_parser("compare", help="diff two runs per-query/per-op")
    c.add_argument("a", help="baseline event log file or directory")
    c.add_argument("b", help="candidate event log file or directory")
    c.add_argument("--json", action="store_true",
                   help="emit the raw comparison JSON")
    c.add_argument("--top", type=int, default=5,
                   help="op diffs to show per query (default 5)")

    w = sub.add_parser(
        "warmup",
        help="replay an event log's distinct plans to build the "
             "kernel libraries and fill the executable cache")
    w.add_argument("--eventlog-dir", type=str, required=True,
                   help="event-log .jsonl file or directory to replay")
    w.add_argument("--sf", type=float, default=0.05,
                   help="datagen scale factor for the replay warehouse "
                        "(default 0.05)")
    w.add_argument("--seed", type=int, default=0)
    w.add_argument("--sql", action="store_true",
                   help="replay corpus queries in their SQL-text forms")
    w.add_argument("--device", type=str, default=None,
                   help="torch device of the replays (default: the "
                        "current CUDA device; 'cpu' runs the kernels' "
                        "plain versions)")
    w.add_argument("--require-cuda", action="store_true",
                   help="exit 2 unless torch sees a CUDA device")
    w.add_argument("--json", action="store_true",
                   help="emit the raw report JSON")
    w.add_argument("--out", type=str, default="",
                   help="write the report JSON to this file")

    lt = sub.add_parser(
        "loadtest",
        help="concurrent multi-tenant corpus run through the QueryService, "
             "held against serial runs")
    lt.add_argument("--sf", type=float, default=0.05,
                    help="datagen scale factor (default 0.05)")
    lt.add_argument("--seed", type=int, default=0)
    lt.add_argument("--queries", type=str, default="",
                    help="comma-separated subset (default q1-q22)")
    lt.add_argument("--concurrency", type=int, default=4,
                    help="service worker threads (default 4)")
    lt.add_argument("--tenants", type=int, default=2,
                    help="simulated tenants, each submitting every query "
                         "(default 2)")
    lt.add_argument("--sql", action="store_true",
                    help="submit the SQL-text forms instead of DSL")
    lt.add_argument("--eventlog-dir", type=str, default="",
                    help="also write per-query event logs here")
    lt.add_argument("--json", action="store_true",
                    help="emit the raw report JSON")
    lt.add_argument("--out", type=str, default="",
                    help="write the report JSON to this file")
    lt.add_argument("--warmup-from", type=str, default="",
                    help="warm from this event-log dir before the serial "
                         "baseline (tools warmup, in-process)")
    lt.add_argument("--chaos", action="store_true",
                    help="arm the seeded service-level fault schedule "
                         "(worker crashes, device losses, a wedged launch) "
                         "on the service session; asserts every submission "
                         "terminal, FINISHED results held, failures typed, "
                         "recovery bounded, and health back to HEALTHY")
    lt.add_argument("--device", type=str, default=None,
                    help="torch device of the sessions (default: the "
                         "current CUDA device; 'cpu' runs the kernels' "
                         "plain versions)")

    t = sub.add_parser(
        "top",
        help="live service view over the loopback introspection endpoint "
             "(health, SLOs, query table, telemetry)")
    t.add_argument("--url", type=str, default="",
                   help="endpoint URL (default http://127.0.0.1:<port>/top "
                        "from --port)")
    t.add_argument("--port", type=int, default=0,
                   help="introspection port (QueryService.introspect_port)")
    t.add_argument("--watch", type=float, default=0.0, metavar="SEC",
                   help="poll every SEC seconds instead of one-shot")
    t.add_argument("--iterations", type=int, default=0,
                   help="with --watch: stop after N polls (0 = forever)")
    t.add_argument("--json", action="store_true",
                   help="emit the raw /top JSON per poll")

    inc = sub.add_parser(
        "incident",
        help="render flight-recorder incident bundles "
             "(spark.rapids.obs.flightRecorder.dir)")
    inc.add_argument("path", nargs="?", default="",
                     help="bundle .json file or flight-recorder dir "
                          "(default: the conf default dir)")
    inc.add_argument("--last", type=int, default=0,
                     help="render only the newest N bundles")
    inc.add_argument("--json", action="store_true",
                     help="emit the raw bundle list JSON")

    for name in NOT_PORTED:
        np_ = sub.add_parser(name, help=f"not ported ({NOT_PORTED[name]})")
        np_.add_argument("rest", nargs=argparse.REMAINDER)

    args = ap.parse_args(argv)

    if args.cmd in NOT_PORTED:
        raise NotImplementedError(
            f"tools {args.cmd} is not ported: it needs "
            f"{NOT_PORTED[args.cmd]} (ROADMAP item [12b] Delta)")

    if args.cmd == "top":
        from spark_rapids_tpu_torch.tools.top import run_top
        return run_top(url=args.url or None, port=args.port or None,
                       watch_s=args.watch,
                       iterations=args.iterations or None,
                       as_json=args.json)

    if args.cmd == "incident":
        from spark_rapids_tpu_torch.conf import FLIGHT_RECORDER_DIR
        from spark_rapids_tpu_torch.tools.incident import (
            load_bundles,
            render_incident,
        )
        path = args.path or str(FLIGHT_RECORDER_DIR.default)
        try:
            bundles = load_bundles(path)
        except FileNotFoundError as exc:
            print(str(exc), file=sys.stderr)
            return 1
        print(json.dumps(bundles) if args.json
              else render_incident(bundles, last=args.last))
        return 0

    if args.cmd == "loadtest":
        from spark_rapids_tpu_torch.tools.loadtest import (
            render_loadtest,
            run_loadtest,
        )
        wanted = [q.strip() for q in args.queries.split(",") if q.strip()]
        report = run_loadtest(
            sf=args.sf, seed=args.seed, queries=wanted or None,
            use_sql=args.sql, concurrency=args.concurrency,
            tenants=args.tenants, eventlog_dir=args.eventlog_dir or None,
            warmup_from=args.warmup_from or None, chaos=args.chaos,
            device=args.device)
        print(json.dumps(report, default=str) if args.json
              else render_loadtest(report))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1, default=str)
        return 0 if report["ok"] else 1

    if args.cmd == "warmup":
        from spark_rapids_tpu_torch.tools.warmup import (
            render_warmup,
            run_warmup,
        )
        if args.require_cuda:
            from spark_rapids_tpu_torch.tools import require_cuda
            require_cuda()
        report = run_warmup(args.eventlog_dir, sf=args.sf, seed=args.seed,
                            use_sql=args.sql, device=args.device)
        print(json.dumps(report) if args.json else render_warmup(report))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
        return 0 if report["ok"] else 1

    if args.cmd == "profile":
        from spark_rapids_tpu_torch.tools.report import (
            build_profile,
            load_events,
            render_profile,
        )
        report = build_profile(load_events(args.eventlog), top_n=args.top,
                               coverage_floor=args.coverage_floor)
        print(json.dumps(report) if args.json else render_profile(report))
        return 2 if report["queriesBelowCoverageFloor"] else 0

    from spark_rapids_tpu_torch.tools.compare import (
        build_compare,
        render_compare,
    )
    cmp = build_compare(args.a, args.b)
    print(json.dumps(cmp) if args.json
          else render_compare(cmp, top_n=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
