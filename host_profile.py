"""Where a warm query's host time goes, and how two commits' warm latencies
compare.

Profile mode (on the card): runs named queries of ``chip_smoke.py``'s
phases over the corpus tables (``--sf``, ``--seed``) through
``TorchSession``: corpus queries as ``qN`` (the DSL form) or ``qN SQL``
(the text) and the window queries W1-W7. Each query runs cold once, then
``--runs`` times warm (CUDA synchronized after each; the median is
printed, with the garbage collector's passes by generation during those
runs and their time, and on the card the caching allocator's device
allocations and frees), then ``--runs`` more times under cProfile. For each
query it prints the warm median and the own time per warm run of the
port's modules (``spark_rapids_tpu_torch``'s, by file) and of the rest
(torch, numpy, the interpreter), largest first, and the port's ten
costliest functions. ``--package DIR`` imports
``spark_rapids_tpu_torch`` from DIR instead (a checkout of another commit,
such as the parent's), so that two commits are profiled in one call on one
card; the query texts stay this checkout's.

    python3 host_profile.py [--package DIR] [--queries "q20 SQL,W7"]

Compare mode (anywhere): reads the ``warm median`` lines of
``chip_smoke.py`` logs (``NAME: ... warm median X ms``) and prints, for
every query in all of them, each log's median, the ratio of the mean over
the ``--against`` logs to the mean over the ``--compare`` logs, and the
summary: the median ratio, the sums, and the queries whose every
``--against`` median lies above (below) every ``--compare`` median.

    python3 host_profile.py --compare PARENT.log ... --against CHANGE.log ...
"""

from __future__ import annotations

import argparse
import cProfile
import gc
import os
import pstats
import re
import statistics
import sys
import time

WARM_RE = re.compile(r"^  (.+?): .*?warm median ([0-9.]+) ms")


def warm_medians(path: str) -> dict:
    """{query: warm median ms} of one chip_smoke log (the first line of
    each query)."""
    out = {}
    with open(path) as f:
        for line in f:
            m = WARM_RE.match(line)
            if m and m.group(1) not in out:
                out[m.group(1)] = float(m.group(2))
    return out


def compare(base_logs, new_logs) -> int:
    base = [warm_medians(p) for p in base_logs]
    new = [warm_medians(p) for p in new_logs]
    names = [n for n in base[0]
             if all(n in m for m in base + new)]
    if not names:
        print("no query is in every log", file=sys.stderr)
        return 1
    ratios, above, below = [], [], []
    sum_base = sum_new = 0.0
    for n in names:
        b = [m[n] for m in base]
        c = [m[n] for m in new]
        r = statistics.mean(c) / statistics.mean(b)
        ratios.append(r)
        sum_base += statistics.mean(b)
        sum_new += statistics.mean(c)
        if min(c) > max(b):
            above.append(n)
        elif max(c) < min(b):
            below.append(n)
        print(f"{n}: {b} -> {c} ms, ratio {r:.4f}")
    print(f"{len(names)} queries: median ratio "
          f"{statistics.median(ratios):.4f}, sum {sum_base:.1f} -> "
          f"{sum_new:.1f} ms ({sum_new / sum_base:.4f}); above every "
          f"--compare run: {len(above)}, below every one: {len(below)}")
    print(f"above: {above}")
    print(f"below: {below}")
    return 0


def profile(args) -> int:
    import torch
    if not torch.cuda.is_available() and args.device == "cuda":
        print("host_profile: no CUDA device (--device cpu runs on the CPU)",
              file=sys.stderr)
        return 1
    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    import spark_rapids_tpu_torch as pkg

    import chip_smoke
    from spark_rapids_tpu_torch.models.corpus import (
        build_queries,
        build_sql_queries,
        corpus_tables,
        sql_texts,
    )
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.session import TorchSession
    root = os.path.dirname(os.path.abspath(pkg.__file__))
    print(f"package {root}")
    dev = None if args.device == "cuda" else args.device
    sync = (torch.cuda.synchronize if args.device == "cuda"
            else (lambda: None))
    tables = corpus_tables(args.sf, args.seed)
    session = TorchSession(device=dev) if dev else TorchSession()
    build_sql_queries(session, tables)
    for n in ("lineitem", "orders"):
        from_host_table(tables[n], session).create_or_replace_temp_view(n)
    texts = sql_texts()
    dsl = build_queries(session, tables)

    def query_of(name):
        if name.endswith(" SQL"):
            return lambda t=texts[name[:-4]]: session.sql(t)
        if name in dsl:
            return dsl[name]
        return lambda t=chip_smoke.WINDOW_SQL[name]: session.sql(t)

    gc_passes = {}

    def allocator_calls():
        if args.device != "cuda":
            return (0, 0)
        st = torch.cuda.memory_stats()
        return (st.get("num_device_alloc", 0), st.get("num_device_free", 0))

    def on_gc(phase, info, t0=[0.0]):
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            n, ms = gc_passes.get(info["generation"], (0, 0.0))
            gc_passes[info["generation"]] = (
                n + 1, ms + (time.perf_counter() - t0[0]) * 1e3)

    for name in [q.strip() for q in args.queries.split(",") if q.strip()]:
        query = query_of(name)
        query().collect_table()
        sync()
        runs = []
        gc_passes.clear()
        calls0 = allocator_calls()
        gc.callbacks.append(on_gc)
        for _ in range(args.runs):
            t0 = time.perf_counter()
            query().collect_table()
            sync()
            runs.append((time.perf_counter() - t0) * 1e3)
        gc.callbacks.remove(on_gc)
        calls = [b - a for a, b in zip(calls0, allocator_calls())]
        passes = {g: (n, round(ms, 3))
                  for g, (n, ms) in sorted(gc_passes.items())}
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(args.runs):
            query().collect_table()
            sync()
        prof.disable()
        st = pstats.Stats(prof)
        by_file, funcs = {}, []
        for (path, line, fn), (_, _, tt, _, _) in st.stats.items():
            if path.startswith(root):
                rel = os.path.relpath(path, os.path.dirname(root))
                funcs.append((tt, f"{rel}:{line} {fn}"))
            else:
                rel = "(other: torch, numpy, the interpreter)"
            by_file[rel] = by_file.get(rel, 0.0) + tt
        per = 1e3 / args.runs
        print(f"{name}: warm median {statistics.median(runs):.3f} ms "
              f"(runs {[round(r, 3) for r in runs]}); profiled own time "
              f"{st.total_tt * per:.3f} ms a run; in the warm runs garbage "
              f"collector passes (generation: count, ms) {passes}, device "
              f"allocations and frees {calls}")
        for rel, tt in sorted(by_file.items(), key=lambda kv: -kv[1]):
            if tt * per >= 0.005:
                print(f"    {tt * per:8.3f} ms  {rel}")
        print("  costliest functions of the port (own ms a run):")
        for tt, what in sorted(funcs, reverse=True)[:10]:
            print(f"    {tt * per:8.3f} ms  {what}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default=None,
                    help="directory holding the spark_rapids_tpu_torch to "
                         "profile (default: this checkout's)")
    ap.add_argument("--queries", default="q20 SQL,W7,q1 SQL,q3 SQL",
                    help="comma-separated queries: 'qN', 'qN SQL' or W1-W7")
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--runs", type=int, default=15)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--compare", nargs="+", default=None,
                    help="chip_smoke logs of the first commit")
    ap.add_argument("--against", nargs="+", default=None,
                    help="chip_smoke logs of the second commit")
    args = ap.parse_args(argv)
    if args.compare:
        if not args.against:
            ap.error("--compare needs --against")
        return compare(args.compare, args.against)
    return profile(args)


if __name__ == "__main__":
    sys.exit(main())
