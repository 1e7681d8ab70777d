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
* ``loadtest``, ``vacuum``, ``top``, ``incident``: need the query
  service, Delta and the flight recorder, and raise naming ROADMAP
  item 12.

``--json`` emits the raw report dict; ``profile`` exits 2 when a query's
span coverage falls below ``--coverage-floor`` (default 0.95).
"""

from __future__ import annotations

import argparse
import json
import sys

#: the reference's subcommands that need what the port lacks
NOT_PORTED = {
    "loadtest": "the query service (service/*)",
    "vacuum": "Delta (delta/*)",
    "top": "the query service's introspection endpoint",
    "incident": "the flight recorder (obs/telemetry.py)",
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

    for name in NOT_PORTED:
        np_ = sub.add_parser(name, help=f"not ported ({NOT_PORTED[name]})")
        np_.add_argument("rest", nargs=argparse.REMAINDER)

    args = ap.parse_args(argv)

    if args.cmd in NOT_PORTED:
        raise NotImplementedError(
            f"tools {args.cmd} is not ported: it needs "
            f"{NOT_PORTED[args.cmd]} (ROADMAP item 12)")

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
