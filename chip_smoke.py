"""Drive the PyTorch port (spark_rapids_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--rows N] [--sf SF] [--seed S] [--profile DIR]
                          [--only 21|22|23|24|25|26|27]

Phases, in order; any failure exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, torch version, compute
   capability (must be 9.0, an H100);
2. build the CUDA kernels from ``spark_rapids_tpu_torch/kernels/csrc``,
   with ``csrc/yardstick.cu`` (the kernels before their redesigns, which
   the port does not call, timed beside the port's own);
3. each kernel against its plain torch version on the card, at the shapes
   q1, q3 and the corpus's q2 and q8 give it, at large shapes and on edge
   inputs, with times (CUDA events, warm median) beside the least time the
   card could take, one PyTorch library call computing the same function
   and the yardstick kernels (the forms before each redesign: probe,
   compaction, partial sums, MIN/MAX), each also 20 calls back to back;
   the probe and the compaction run under torch's sync debug mode set to
   raise, and the first one-pass compaction under a watchdog;
4. TPC-H q1 end to end through ``TorchSession`` at ``--rows`` lineitem rows
   (default 6,001,215 = TPC-H SF 1), checked against a numpy oracle, with
   every kernel's launch counter read around the query (phases 4-6 also log
   each sort's rows, operands, varying bits B and digit passes, the sort's
   host syncs, and every host sync of the counted run);
5. TPC-H q3 end to end at the same lineitem rows, in two data forms: the
   dense keys of models/tpch.py (direct-address joins) and the same tables
   with their keys mapped to a sparse 40-bit range (hash-probe joins,
   after a replay), the latter with 4 (the default) and with 8 hash-probe
   attempts; cold and warm times, replays, peak memory and every kernel's
   launches in one warm run, each result against a numpy oracle; dense
   q3's compactions checked and timed again on their own inputs;
6. the golden corpus's q2 and q8 through ``TorchSession`` at
   ``scale_test_specs(--sf)`` (default 10: 2,500,000 orders under an
   Exponential o_custkey skew over 250,000 customers, 10,000,000 lineitem
   rows), seed ``--seed`` (default 7), beside q8's inner group-by (dense
   keys, and o_custkey mapped by ``sparse_keys``: the sort-segment path),
   a MIN/MAX group-by of orders and a global MIN/MAX over lineitem; cold
   and warm times, replays, peak memory and every kernel's launches in one
   warm run, each result against a numpy oracle (MIN, MAX and counts
   exact, q2's sum rtol 1e-9), and every kernel launch of that warm run
   held against its plain version on the inputs it was given;
7. the other 17 corpus queries the port runs (q1, q3-q5, q9-q20, q22) on
   the same tables, each as ``scale_test.py`` writes it: cold and warm
   times, replays, peak memory, host syncs, sorts and every kernel's
   launches in one warm run, each result against a numpy oracle (keys,
   counts, int64 and decimal sums and strings exact, f64 rtol 1e-9),
   every kernel launch of that warm run against its plain version as in
   phase 6, and a JSON summary line of them all;
8. the corpus's window and exchange queries, q6 (row_number per
   customer, a pre-window group limit), q21 (row_number per nation) and
   q7 (a hash repartition into 8, then a group-by), on the same tables as
   in phase 7, with the numbers and checks of phase 7 (the windows against
   a stable ranking in numpy, q7's counts and sums exact), after the
   murmur3 partition ids of l_returnflag (every lineitem row) and
   o_custkey (every order) against the numpy murmur3;
9. the SQL front end on the same tables: the corpus's 22 texts
   (``models/corpus.py::sql_texts``) over temp views of phases 6-8's
   tables, then TPC-H ``Q1_SQL`` and ``Q3_SQL`` (dense, and sparse with 4
   hash-probe attempts) over phases 4-5's, each through
   ``TorchSession.sql`` with the numbers and checks of phase 7 plus the
   host time of ``session.sql(text)`` alone (parse, analyse, lower):
   each result against its DSL form's (bit for bit; rtol 1e-9 for the
   f64 sums over more than 32 segments of q3, q15 and Q3_SQL) and its
   numpy oracle, each kernel launched as often as in the DSL form; and
   one conditional query (CASE, IF, COALESCE, GREATEST, a string-valued
   CASE as the group key) over the 10,000,000 lineitem rows against a
   numpy oracle;
10. the join types on the same tables: J1-J12 (``JOIN_QUERIES``: left,
   right and full outer, semi, anti, cross and conditioned joins, the
   nested-loop NOT IN, a bare LIMIT) through ``TorchSession.sql``, J3 and
   J12 again over o_orderkey/l_orderkey mapped by ``sparse_keys`` (the
   hash probe, at 8 attempts), J1 and J8 with their builds
   sub-partitioned (8 MiB and 2 MiB) and J7 with every nested-loop tile
   its own partial aggregate (the streaming merge), with the numbers and
   checks of phase 7: each result against a numpy oracle (sparse J3's
   over the mapped keys; sparse J12 against the dense result), the
   sub-partitioned ones against their unsplit results;
11. the operator queries O1-O8 (``OPS_QUERIES``) on the same tables and
   ``lineitem_dec`` (lineitem with DECIMAL(15,2) quantity, price,
   discount and tax, a TIMESTAMP and a comment, built on the host): TPC-H
   q1's text over the decimals (its DECIMAL128 products on the card),
   MIN/MAX of every type, FIRST/LAST per customer, UNION ALL and UNION,
   modular and sign arithmetic, a 2^26-row range and a SELECT without
   FROM, a 1% sample and a cached filter read twice, with the numbers and
   checks of phase 7 against numpy oracles (decimals, counts, MIN/MAX and
   FIRST/LAST exact, f64 sums rtol 1e-9);
12. the scalar query set S1-S8 (``SCALAR_QUERIES``) through
   ``TorchSession.sql`` on the same tables and ``lineitem_dec``: DECIMAL128
   quotients, remainders and pmods on each of 10M rows and a ratio of
   decimal sums (the DECIMAL128 division kernel), LIKE, RLIKE, ``||`` and
   the string functions, date arithmetic and DATE +/- INTERVAL, a DST
   zone's timestamps, math, md5, xxhash64 and the DECIMAL128 byte hash,
   ``rand`` and a float32 top-100, with the numbers and checks of phase 7
   against oracles in numpy and Python ints (transcendental doubles within
   2 ulp); then the DECIMAL128 division kernel bit for bit against its
   plain version on S1's operands (sampled to 2^20 rows) and on an edge
   set, also against Python ints, and its time at S1's shape against its
   byte bound;
13. the window query set W1-W8 (``W_QUERIES``) through
   ``TorchSession.sql`` on the same tables: lag, lead and a lag with a
   default per customer, running sums over ROWS and RANGE frames, a ratio
   over whole-partition aggregates, moving AVG/MIN/MAX frames, a
   partition-less percent_rank and row_number, three specs over different
   partition keys, a 2001-row frame's SUM and MAX, and lineitem in 4 input
   batches through the four multi-batch routes (keyed batching, the
   two-pass window, the bounded and the running stream over the
   out-of-core sorted-run merge), each W8 query's route read from
   ``last_metrics()``; with the numbers and checks of phase 7 against
   numpy oracles (f64 sums rtol 1e-9, the wide frame within 1e-9 of its
   mass, everything else exact);
14. the memory runtime (``run_runtime``): the device manager's report
   (``nvidia-smi``'s card line, ``mem_get_info``, the default budget and
   scan chunk), with no budget violation, no arbiter spill and no warm
   query with more host syncs than in the baseline run
   (``BASELINE_WARM_SYNCS``)
   over phases 4-13; corpus q3, J1, an ORDER BY of lineitem, W8b and W8c
   at a quarter of each one's unsqueezed peak accounted bytes (results bit
   for bit, q3 rtol 1e-9; no violation; peak within the budget; a spill
   to the host each; the ORDER BY out of core), and the ORDER BY again
   with a host tier small enough to go to disk; q1, W8a and q1's filter
   and projection under injected RetryOOM and SplitAndRetryOOM (bit for
   bit, the counters ``INJECTED_COUNTS``': the filter's ``with_retry``
   splits its input on the card); q1 through a real CUDA OOM against a spillable ballast
   (under a watchdog); four threads of q1 on two device slots; the spill
   D2H and H2D rates of a 2^24-row, 7-column table, pinned and pageable;
   every kernel launch of the squeezed and injected runs held against its
   plain version;
15. Parquet files in and out (``run_files``): the host library's build
   time and whether pyarrow and pandas are on the machine (the port
   imports neither); the corpus tables at ``scale_test_specs(FILES_SF)``
   (sf 1) and phase 4's lineitem written with the port's writer (SNAPPY,
   two files per table in c000/ and c001/, a temporary directory the
   phase removes), each read back in PERFILE, COALESCING and
   MULTITHREADED and held against its source bit for bit, with its rows,
   bytes on disk, write seconds, host decode seconds and rate, and upload
   ms; TPC-H q1 over lineitem from its files against phase 4's oracle,
   cold (with its counters, and again in a fresh process) and warm
   beside phase 4's warm; the 22 corpus queries from the
   files as DataFrames and as SQL over ``CREATE TEMP VIEW ... USING
   parquet``, each against phase 6-8's oracles (the windows by key),
   through ``run_case`` (every launch held against its plain version); a
   filtered read whose pruned row groups and rows are held, a partitioned
   write read back with its partition column's type inferred, an
   ``input_file_name()`` GROUP BY over three files, and a write under an
   injected ``io.write.file`` fault (aborted with no visible file, then
   committed);
16. text files in and out (``run_text``): the text codec's build time
   and the host compiler; the corpus tables at ``scale_test_specs
   (FILES_SF)`` written as CSV (header, their schema) and as JSON lines,
   phase 4's lineitem as pipe-delimited headerless CSV (dbgen's layout)
   and orders as Hive text partitioned by a low-cardinality column with
   escape.delim set, each read back in PERFILE, COALESCING and
   MULTITHREADED and held against its source bit for bit, with rows,
   bytes on disk, write seconds and host decode seconds and rates by
   mode; TPC-H q1 over the pipe-delimited lineitem against phase 4's
   oracle, cold (with its counters) and warm beside phase 4's and phase
   15's; the 22 corpus queries from the CSV files as
   DataFrames and as SQL over ``CREATE TEMP VIEW ... USING csv``, and
   from the JSON files as DataFrames, against phase 6-8's oracles, with
   the decode's share of each warm run; the options (sep, quote, escape,
   comment, null, custom float spellings, timestampFormat), the three
   modes over ragged and malformed rows, JSON multiLine and
   primitivesAsString, and a faulted CSV write then its retry;
17. ORC and the binary codecs (``run_orc``): the ZSTD, LZ4 and ORC host
   sources' build time and the host compiler; phase 15's corpus tables
   as ORC with ZSTD, phase 4's lineitem as ORC with ZSTD and with LZ4 and
   as Parquet with ZSTD and with LZ4, each written by the port and read
   back in PERFILE, COALESCING and MULTITHREADED bit for bit, with write
   seconds, host decode seconds and MB/s; the port's ZSTD and LZ4 against
   the host's libzstd and liblz4 on the corpus lineitem's uncompressed
   ORC bytes (size and host MB/s each way); TPC-H q1 from the ORC lineitem
   against phase 4's oracle, cold and warm, with its decode and upload
   waits, host syncs and peak memory, beside phase 15's q1 from Parquet
   and phase 4's in memory; the 22 corpus queries from the ORC files as
   DataFrames and as SQL over ``CREATE TEMP VIEW ... USING orc`` against
   phase 6-8's oracles; a faulted ORC write, and a ZSTD frame and an ORC
   file corrupted on purpose raising;
18. dynamic partition pruning, the bloom filter and recovery
   (``run_dpp_phase``): phase 4's lineitem with TPC-H's own ship dates
   written as Parquet Hive-partitioned by ``l_shipmonth`` (84 months), and
   q1's aggregate over its star join with a filtered month dimension
   (``DPP_MONTHS``) from the DSL and from SQL ``USING parquet``, pruning on
   and off, against a numpy oracle (3 files read and 81 pruned when on),
   with warm and decode times and host syncs; a bloom filter over the 1995
   orders' keys built on the card, bit for bit against the plain CPU
   build, with no false negative over lineitem, and the join after it
   against a numpy oracle; q1 at SF 1 under a transient crash, a crash
   past ``maxFailures``, ``mem.reserve`` OOMs, a squeezed budget (the
   memory ladder's ``retry`` and ``chunk`` rungs) and a device loss, each
   against phase 4's oracle or raising its typed error; and a real
   device-side assert in two child processes (``--fatal-child``: exit 20
   with a crash report; DeviceLostError naming the CPU-only latch, then
   two q1 answered on the CPU route); every kernel launch held against
   its plain version;
19. the query envelope (``run_observability``): the profiler's trace of
   q1, the event log and spans over the corpus with the tools, the
   executable cache, warmup in fresh processes, the asynchronous result
   fetch and the launch helper's fault points;
20. nested types (``run_nested``) over phases 6-8's tables: N1
   collect_list, collect_set and percentile by l_orderkey (about 2.45M
   arrays over 10M elements each, DSL and SQL), N2 the array, struct,
   map and higher-order functions over N1's result, N3 posexplode, an
   aggregate by position, explode_outer, sequence and the SQL explode,
   N4 N1's result with a struct and a map written as Parquet (two files,
   SNAPPY), read back bit for bit in the three reader modes and queried;
   each against a numpy oracle on flat buffers, every launch held
   against its kernel's plain version;
21. the CPU route (``run_route``) over phases 6-8's tables with
   l_partkey, l_tax and o_orderpriority added (``route_tables``) and
   phases 4-5's q1 and sparse q3 tables: C1 collect_list by order into a
   filter on the arrays' size (the filter runs on the CPU route: a
   flat-only operator), then size and array_max, a join to orders and a
   group-by on the device; C2 cast(o_orderdate as string) on the route,
   grouped and sorted on the device; C3 a Python UDF the compiler rejects
   on the route, joined and aggregated on the device; C4 q1 with its
   charge through a compiled UDF (no CPU node, q1's launches, bit for bit
   q1's result); C5 to_json on the route, get_json_object and from_json
   on the device; C6 q1 and sparse q3 with spark.rapids.sql.enabled=false
   against the device's results; each cell's CPU-route nodes, reasons,
   transition times, launches and host syncs. Every query of phases 3-20
   converts with 0 CPU-route nodes (``watch_cpu_route``);
22. demotion onto the CPU route at run time and the rest of planning
   (``run_planning``), each cell cold and then warm (``run_case``): P1
   lineitem in 4 batches through a range exchange into 16 partitions on
   (l_shipdate, l_orderkey), and into 8 on (l_returnflag, l_orderkey),
   then the local sort, against the global sort and a numpy lexsort, the
   partition ids never decreasing along the output; P2 q10, q17 and q22
   (DSL and SQL) through AQE's build against phase 7's oracles, the
   decision against the measured bytes, again with a threshold that
   broadcasts q10's and q17's builds and one under q17's (->shuffle); P3
   q1 with the aggregate demoted by the circuit breaker, with the scan
   demoted by the memory ladder's cpu_demote, and the latch child of
   18.4 (q1 answered twice on the CPU route after the poison); P4 a
   50-row filter reverted to the CPU route by the cost-based optimizer
   and q1 left on the device;
23. the query service (``run_service``), V1-V8: V1 the 22 corpus queries
   on phases 6-8's tables, phase 4's q1 and phase 5's sparse q3 from 3
   tenants (SQL texts for one, the DSL for the others) through a
   ``QueryService`` of 4 workers, each (query, form) first run serially;
   then the stream three times: once with every launch held against its
   kernel's plain version as it is recorded (the phase's counted
   launches), and timed with the result cache off and on (the aggregate
   wall against the serial sum, p50/p95 latency, queue wait, hit rate);
   every result against its serial run (``tools.loadtest.result_differs``:
   bitwise, the named f64 sums within rtol 1e-9) and its oracle; V2 two
   pools weighted 3:1 and a burst of 40 q1s each (the picks against the
   charged clocks, a rejection past queueDepth); V3 a cancel and a
   deadline of a 4-batch query held at its second landing, then q1 bit
   for bit; V4 ``dispatch.wedge`` past ``hardTimeoutMs`` (HardTimeoutError,
   a respawned worker, the next q1 bit for bit) and a
   ``service.worker_crash`` (requeued, bit for bit); V5 q1's template
   quarantined by two ``chunk``-rung strikes, one incident bundle each,
   rendered by ``tools incident``; V6 ``GET /top`` and ``tools top --url``
   while V1's traffic runs, the telemetry ring's samples and no host sync
   of the sampler; V7 a child process on a fresh kernel build directory
   (four cold q1s build each library once; then a device-side assert at
   one launch while three other q1s run: every handle requeued and
   FINISHED on the CPU route after the latch); V8 the runtime lock
   witness under load: a service of 3 workers with
   ``spark.rapids.lint.lockWitness=true`` in its conf and a device budget
   of q1's peak accounted bytes over ``SQUEEZE`` serves 4 q1s and 4 dense
   q3s at once, each result held to its serial run (q1 V1's) and each
   launch to its kernel's plain version, then 0 witness violations, the
   main thread's held stack empty and the witness disarmed; the locks the
   witness built, then the burst's wall in turns without and with the
   witness (plain, witnessed, witnessed, plain), during V7's child;
24. Delta Lake, Iceberg and streaming (``run_lakehouse``) over phase 4's
   lineitem with l_orderkey, l_linenumber and l_partkey added
   (``lake_lineitem``): D1 the Delta table (8 files, one commit each), q1
   cold and warm against its oracle and bit for bit against q1 in memory
   over the scan's rows, DELETE of l_partkey < 4000 through deletion
   vectors, UPDATE of l_tax over the first file's orders, and two MERGEs
   of 600,000 source rows keyed (l_orderkey, l_linenumber), half matched
   and half new, with low-shuffle on and off; after each command the row
   count, q1 against the numpy state (``LakeState``) and time travel to
   version 0; D2 OPTIMIZE ZORDER BY (l_shipdate, l_partkey), the
   checkpoint at version 10 replayed by a fresh log against every commit
   file, ``table_changes`` over the DML versions (counts by change type),
   ``rename_column`` under column mapping then q1, VACUUM dry and real,
   and an injected ``delta.commit.race`` retried with ``commitRetries`` 1
   in the next event record; I1 an Iceberg table of the same lineitem
   written by this script's fixture (the port's Parquet writer, a minimal
   Avro encoder for the manifests), q1 at its two snapshots (the second
   with 1% positional deletes and an equality delete that applies to one
   file by sequence number); S1 a file-watch stream over 24 Parquet files
   at 4 a trigger through a one-worker ``QueryService`` into a Delta
   sink (listed on ``/streams``), then the same stream in a child process
   (``--stream-child``) stopped inside a batch's commit and killed, and
   resumed here with one sink replay, its rows equal to the clean run's;
   M1 a reaggregate and an append view over the sink, refreshed after
   every commit and held bit for bit against ``recompute_at_epoch()``,
   and a commit to D1's table leaving the service's cached result over
   the sink. Every launch is held against its kernel's plain version
   (``HeldCalls``), every plan converts with 0 CPU-route nodes;
25. distribution (``run_distribution``): X1 the host shuffle over phase
   15's tables, q7 (its device split off) and lineitem hash repartitioned
   into 200 then grouped, under MULTITHREADED with lz4 and under P2P over
   TCP loopback, each against its numpy oracle and the single-device
   result, with the shuffle's bytes, codec, fetches, host syncs and the
   serialization, codec and download times; X2 a LOGICAL mesh of 8 shards
   on the one card (the log says so: no copy crosses between two cards):
   q1, sparse q3, q7 through the all-to-all exchange and q8, cold and warm,
   against phases 4-8's single-device results (bit for bit; q3's f64
   revenue within rtol 1e-9), ``meshHostUploads`` 0 warm; X3 mesh chaos
   (device_lost x3 at mesh.ici.exchange shrinks the mesh to 7, a corrupt
   gather re-lands, the mesh restored); X4 2 executor processes scanning
   Parquet files by host (q1, q3, q8, q12 equal to the single-process scan;
   neither executor made a CUDA context); X5 host chaos (device_lost at
   host.dispatch walks the host ladder; a SIGKILL mid-query, its detection
   in ms, the respawned executor's rejoin in s); every executor reaped in a
   finally. Every launch is held against its kernel's plain version;
26. static analysis (``run_static_analysis``): every tree phases 3-25
   convert is verified as ``spark.rapids.sql.planVerify.mode=error`` would
   verify it (the hook ``watch_cpu_route`` installs on
   ``rules.convert_meta``; one diagnostic fails the run), with the count
   of trees and the verifier's host ms; q1 and sparse q3 through a
   ``TorchSession`` in error mode against their oracles; a hand-broken
   converted plan (a Limit exec over a host node) raising
   PlanVerificationError with the launch counters unchanged; and
   ``python -m spark_rapids_tpu_torch.lint --json`` in a subprocess on the
   card (repo lint, registry audit, the 88 golden plans converted for
   ``cuda:0``, the executed metrics slice; RL-LOCK-* and
   RA-DOC-DRIFT-LOCKS among its rules), which must exit 0; then the lock
   contract in this process: the CLI's rule ids against the reference's
   (its ``lint/diagnostics.py`` read as text), RL-LOCK-DECL, RL-LOCK-ORDER
   and RL-LOCK-EFFECT timed over the port's sources with 0 diagnostics,
   ``docs/LOCKS.md`` as generated. Every launch is held against its
   kernel's plain version;
27. ANSI mode and the user surface (``run_user_surface``): A1 q1 and
   dense q3 with ``spark.sql.ansi.enabled`` bit for bit ANSI off's, with
   their warm times and host syncs (equal) beside ANSI off's; A2 four
   violations over the same rows (an integral overflow of sparse q3's
   l_orderkey, a cast overflow of q1's l_extendedprice * 1e18 to bigint,
   a remainder by zero, a raising filter predicate), each raising
   AnsiViolation with the reference's message on the card and on the CPU
   route, then the recovery state unchanged and the next q1 bit for bit;
   A3 a guarded CASE WHEN over q1's zero discounts and an overflow only
   filtered-out rows would hit, against numpy; S1 a pivot of
   l_linestatus over l_returnflag against numpy; S2 q1 and sparse q3
   through ``to_device_arrays`` (on ``cuda:0``, equal to
   ``collect_table``, host syncs counted) and the bloom filter over
   o_orderkey through the export against the download-and-upload build;
   S3 q1 under ``spark.rapids.sql.mode=explainOnly`` (its tagged plan
   printed, 0 launches). Every launch is held against its kernel's plain
   version;
28. the summary lines: the lock table's size and V8's result; one ``{"kernels": [...]}`` JSON line (the five TPU
   kernels and the DECIMAL128 division kernel, CUDA work beyond them;
   launches of the main path: q1's, sparse q3's probes, q8's MIN/MAX, plus
   every phase-7 to phase-27 query's), the script's time, the card line,
   and last ``{"ok": true, "device": {...}}``.

Each phase logs its wall time. It needs one CUDA card and exits non-zero
without one. ``--profile DIR`` also writes a torch.profiler table and
trace of one warm run of q1, of each q3 form, of each phase-6, phase-7
and phase-8 query, of phase 9's conditional query, of J1, J7, J8 and J9,
of O1, O2, O3, O4a, O5, O6a and O7, of S1, S2, S5, S7 and S8 and of W1,
W3, W4, W7, W8a and W8c, and of N1 and N3's posexplode. ``--only 21``
(or ``22``, ``23``, ``24``, ``25``, ``26``, ``27``) runs phases 1-3 and then that
phase over tables it makes itself. For the time limit, phases 11-13 take one warm
run before the counted one, 15.4 one, 16.4 none (the counted run's time
is its warm time), and 15.3 one fresh process.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, FP64 (non-tensor) rate; the
#: INT32 rate is half the 67 TFLOP/s FP32 rate (64 INT32 lanes per SM
#: against 128 FP32 lanes)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
INT32_OPS_PER_S = 33.5e12

#: every tensor of the script lives on the card
DEV = torch.device("cuda")
#: where the device export's tensors must be (phase 27)
CUDA0 = torch.device("cuda", 0)

TPU_KERNELS = {
    "onehot_partials": "spark_rapids_tpu/kernels/segreduce.py:145",
    "fused_minmax": "spark_rapids_tpu/kernels/segreduce.py:108",
    "gather_compact": "spark_rapids_tpu/kernels/compact.py:112",
    "sort_with_payload": "spark_rapids_tpu/kernels/sort.py:84",
    "probe_rowids": "spark_rapids_tpu/kernels/hashprobe.py:139",
    # CUDA work beyond the five TPU kernels: the reference divides
    # DECIMAL128 values on its host (DecimalDivide and DecimalRemainder's
    # _host_op)
    "dec128_divide": "spark_rapids_tpu/ops/decimal.py:427",
}
SOURCES = {
    "onehot_partials": "spark_rapids_tpu_torch/kernels/csrc/segreduce.cu",
    "fused_minmax": "spark_rapids_tpu_torch/kernels/csrc/minmax.cu",
    "gather_compact": "spark_rapids_tpu_torch/kernels/csrc/compact.cu",
    "sort_with_payload": "spark_rapids_tpu_torch/kernels/csrc/sort.cu",
    "probe_rowids": "spark_rapids_tpu_torch/kernels/csrc/hashprobe.cu",
    "dec128_divide": "spark_rapids_tpu_torch/kernels/csrc/dec128div.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 15, warmup: int = 3, calls: int = 1) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events, warm). With
    ``calls`` > 1, the events hold that many calls back to back and the
    time is per call: the host's time to launch overlaps the device's
    work, so a kernel slower than its launch shows its device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


#: calls back to back for the per-call device times of the logs
BACK_TO_BACK = 20


def bound_ms(nbytes: float, ops: float, ops_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits(t: torch.Tensor) -> torch.Tensor:
    """An integer view with the same bits, for exact comparison."""
    view = {torch.float64: torch.int64, torch.float32: torch.int32,
            torch.uint32: torch.int32}.get(t.dtype)
    return t.view(view) if view is not None else t


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(bits(a), bits(b))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def q1_like_partials_input(capacity: int, nrows: int, gen: torch.Generator):
    """The aggregate's f64 stack as q1 builds it: 7 value columns (4 SUM,
    3 AVG; column-major), zero where the filter or the padding drops a
    row, and the gid over 4 x 3 key slots (flag/status codes, null slot
    last) padded to 16; padding rows land in the (null, null) slot 11."""
    dev = DEV
    live = torch.arange(capacity, device=dev) < nrows
    flag = torch.randint(0, 3, (capacity,), generator=gen, device=dev)
    status = torch.randint(0, 2, (capacity,), generator=gen, device=dev)
    gid = torch.where(live, flag * 3 + status, torch.full_like(flag, 11))
    keep = live & (torch.rand(capacity, generator=gen, device=dev) < 0.986)
    qty = torch.randint(1, 51, (capacity,), generator=gen,
                        device=dev).to(torch.float64)
    price = torch.round(torch.rand(capacity, generator=gen, device=dev,
                                   dtype=torch.float64) * 1e7) / 100.0
    disc = torch.randint(0, 11, (capacity,), generator=gen,
                         device=dev).to(torch.float64) / 100.0
    tax = torch.randint(0, 9, (capacity,), generator=gen,
                        device=dev).to(torch.float64) / 100.0
    dp = price * (1.0 - disc)
    cols = [qty, price, dp, dp * (1.0 + tax), qty, price, disc]
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    # column-major (capacity, 7), as ops/segsum.py hands it to the kernel
    x = torch.stack([torch.where(keep, c, zero) for c in cols], 0).t()
    return x, gid.to(torch.int32).contiguous()


def partials_error(got, ref, x, gid, nseg, nb, block):
    """(max abs error, max error relative to each partial's absolute
    mass) with NaN positions required to agree."""
    from spark_rapids_tpu_torch.kernels.segreduce import onehot_partials_plain
    mass = onehot_partials_plain(x.abs().to(torch.float64), gid, nseg, nb,
                                 block)
    g, r = got.to(torch.float64), ref.to(torch.float64)
    if not torch.equal(torch.isnan(g), torch.isnan(r)):
        fail("onehot_partials: NaN positions differ from the plain version")
    fin = ~torch.isnan(g) & ~torch.isinf(g) & ~torch.isinf(r)
    if not torch.equal(g[~fin & ~torch.isnan(g)], r[~fin & ~torch.isnan(g)]):
        fail("onehot_partials: infinite partials differ")
    err = (g - r).abs().where(fin, torch.zeros_like(g))
    rel = (err / mass.clamp(min=1e-300)).where(fin, torch.zeros_like(g))
    return float(err.max()), float(rel.max())


def check_segreduce(capacity: int, nrows: int, gen) -> dict:
    from spark_rapids_tpu_torch.kernels.segreduce import (
        onehot_partials,
        onehot_partials_plain,
    )
    dev = DEV
    block = 1024
    nb = capacity // block

    def run_case(name, x, gid, nseg, rtol, blk=block):
        k_nb = x.shape[0] // blk
        a = onehot_partials(x, gid, nseg, k_nb, blk)
        b = onehot_partials(x, gid, nseg, k_nb, blk)
        torch.cuda.synchronize()
        if not same_bits(a, b):
            fail(f"onehot_partials {name}: two runs differ in their bits")
        ref = onehot_partials_plain(x, gid, nseg, k_nb, blk)
        abs_err, rel = partials_error(a, ref, x, gid, nseg, k_nb, blk)
        ok = rel <= rtol
        log(f"  segreduce {name}: max_abs_err={abs_err:.3e} "
            f"max_err/mass={rel:.3e} (tol rtol {rtol:.3g} of each partial's "
            f"absolute mass) bit-identical-rerun=True {'OK' if ok else 'FAIL'}")
        if not ok:
            fail(f"onehot_partials {name} disagrees with its plain version")
        return abs_err

    x, gid = q1_like_partials_input(capacity, nrows, gen)
    q1_err = run_case(f"q1 ({capacity}x7 f64, nseg 16)", x, gid, 16, 1e-12)
    small = 1 << 20
    # f32: two summation orders over a 1024-row block each err by at most
    # (block - 1) * 2^-24 of the absolute mass (recursive summation)
    run_case("f32 (2^20x7, nseg 16)", x[:small].to(torch.float32).contiguous(),
             gid[:small].contiguous(), 16, 2 * (block - 1) * 2.0 ** -24)
    # edges: NaN, +-inf, -0.0, ties (all rows in one segment), nseg 1 / 32
    e = torch.randn((small, 5), generator=gen, device=dev,
                    dtype=torch.float64) * 1e6
    e[:, 1] = -0.0
    e[5, 0], e[70000, 2], e[9, 3], e[10, 3] = (float("nan"), float("inf"),
                                               float("inf"), float("-inf"))
    g32 = torch.randint(0, 32, (small,), generator=gen, device=dev,
                        dtype=torch.int32)
    run_case("edges nseg 32 (row-major x)", e, g32, 32, 1e-12)
    run_case("edges nseg 1", e, torch.zeros_like(g32), 1, 1e-12)
    run_case("ties (one segment of 8)", e, torch.full_like(g32, 3), 8, 1e-12)
    # nine columns; gids outside [0, nseg); blocks shorter than 1024
    # rows and not a multiple of 32
    w = torch.randn((small, 9), generator=gen, device=dev,
                    dtype=torch.float64).t().contiguous().t() * 1e3
    run_case("9 columns nseg 32 (column-major x)", w, g32, 32, 1e-12)
    g_out = torch.randint(-3, 12, (small,), generator=gen, device=dev,
                          dtype=torch.int32)
    run_case("gids outside [0, 8)", w, g_out, 8, 1e-12)
    n96 = 96 * 1000
    run_case("96-row blocks", w[:n96], g_out[:n96].contiguous(), 8, 1e-12,
             blk=96)

    ids = (torch.arange(capacity, device=dev) // block) * 16 + gid.to(torch.int64)
    lib_out = torch.zeros(nb * 16, 7, dtype=torch.float64, device=dev)
    ms, ms_b2b, old, old_b2b = new_and_old_times(
        lambda: onehot_partials(x, gid, 16, nb, block),
        lambda: yardstick_partials(x, gid, 16, nb, block))
    x_rows = x.contiguous()  # the same values row-major
    rows_ms = time_ms(lambda: onehot_partials(x_rows, gid, 16, nb, block))
    plain_ms = time_ms(lambda: onehot_partials_plain(x, gid, 16, nb, block))
    lib_ms = time_ms(lambda: lib_out.zero_().index_add_(0, ids, x))
    nbytes = capacity * (7 * 8 + 4) + nb * 16 * 7 * 8
    bnd, by = bound_ms(nbytes, capacity * 7, FP64_OPS_PER_S)
    log(f"  segreduce time at q1 shape: kernel {ms:.4f} ms "
        f"[{ms_b2b:.4f} {BACK_TO_BACK} back to back], select-add (before) "
        f"{old:.4f} [{old_b2b:.4f}] ms, plain {plain_ms:.4f} ms, index_add_ "
        f"{lib_ms:.4f} ms, bound {bnd:.4f} ms ({by}), "
        f"{nbytes / ms_b2b / 1e6:.1f} GB/s back to back; on row-major x "
        f"{rows_ms:.4f} ms")
    # q2's global sum: one f64 column over 2^24 rows, all in segment 0 of 8
    cap2 = 1 << 24
    x2 = torch.randn((cap2, 1), generator=gen, device=dev,
                     dtype=torch.float64)
    g2 = torch.zeros(cap2, dtype=torch.int32, device=dev)
    nb2 = cap2 // block
    run_case(f"q2 global sum ({cap2}x1 f64, nseg 8)", x2, g2, 8, 1e-12)
    q2 = new_and_old_times(lambda: onehot_partials(x2, g2, 8, nb2, block),
                           lambda: yardstick_partials(x2, g2, 8, nb2, block))
    ids2 = (torch.arange(cap2, device=dev) // block) * 8
    lib2_out = torch.zeros(nb2 * 8, 1, dtype=torch.float64, device=dev)
    plain2 = time_ms(lambda: onehot_partials_plain(x2, g2, 8, nb2, block))
    lib2 = time_ms(lambda: lib2_out.zero_().index_add_(0, ids2, x2))
    bnd2, by2 = bound_ms(cap2 * 12 + nb2 * 8 * 8, cap2, FP64_OPS_PER_S)
    log(f"  segreduce time at q2 shape: kernel {q2[0]:.4f} ms "
        f"[{q2[1]:.4f}], select-add (before) {q2[2]:.4f} [{q2[3]:.4f}] ms, "
        f"plain {plain2:.4f} ms, index_add_ {lib2:.4f} ms, bound "
        f"{bnd2:.4f} ms ({by2})")
    return {"name": "onehot_partials", "max_abs_err": q1_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib_ms}


def compact_inputs(capacity, nkeep_frac, dtypes, gen):
    dev = DEV
    datas = []
    for dt in dtypes:
        if dt == torch.float64:
            d = torch.randn(capacity, generator=gen, device=dev,
                            dtype=torch.float64) * 1e6
            edge = torch.tensor([float("nan"), -0.0, float("inf"),
                                 float("-inf")], dtype=torch.float64)
            d[:4] = edge[:capacity]
        elif dt == torch.int64:
            d = torch.randint(-(2 ** 62), 2 ** 62, (capacity,), generator=gen,
                              device=dev, dtype=torch.int64)
        else:
            d = torch.randint(0, 3, (capacity,), generator=gen, device=dev,
                              dtype=torch.int32)
        datas.append(d)
    valids = [torch.rand(capacity, generator=gen, device=dev) < 0.97
              for _ in dtypes]
    keep = torch.rand(capacity, generator=gen, device=dev) < nkeep_frac
    return datas, valids, keep


_YARDSTICK = None


def yardstick():
    """csrc/yardstick.cu: the probe before its early exit, the compaction
    before its one pass, the probe over 16-byte slots, the partial sums
    before the ranked form and MIN/MAX before the runs; the port calls
    none of them."""
    global _YARDSTICK
    if _YARDSTICK is None:
        from spark_rapids_tpu_torch.kernels.build import load_library
        lib = load_library("yardstick")
        p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.srt_probe_full_walk.restype = ctypes.c_int
        lib.srt_probe_full_walk.argtypes = [p, p, p, p, p, i64, i64, i, p]
        lib.srt_probe_slot16.restype = ctypes.c_int
        lib.srt_probe_slot16.argtypes = [p, p, p, p, p, p, i64, i64, i, p]
        lib.srt_onehot_partials_select_add.restype = ctypes.c_int
        lib.srt_onehot_partials_select_add.argtypes = [
            p, p, p, i64, i, i, i, i64, i64, i, p]
        lib.srt_fused_minmax_row_atomics.restype = ctypes.c_int
        lib.srt_fused_minmax_row_atomics.argtypes = [p, p, p, p, i64, i, i, i,
                                                     p]
        _YARDSTICK = lib
    return _YARDSTICK


def two_pass_compact_pairs(datas, valids, keep, capacity):
    """compact_pairs as it was before the one-pass kernel, the yardstick:
    the torch prologue (keep as int32, its sum, cumsum - 1), a CPU tensor
    of stream descriptors copied to the card, the ctypes signature set on
    the call, then the scatter and the gather launch."""
    from spark_rapids_tpu_torch.kernels import check_launch, stream_handle
    keep_i = keep.to(torch.int32)
    new_n = keep_i.sum(dtype=torch.int32)
    pos = torch.cumsum(keep_i, 0, dtype=torch.int32) - 1
    streams = list(datas) + list(valids)
    outs = [torch.empty_like(t) for t in streams]
    sel = torch.empty(capacity, dtype=torch.int32, device=keep.device)
    desc = torch.tensor([[s.data_ptr(), o.data_ptr(), s.element_size()]
                         for s, o in zip(streams, outs)] or [[0, 0, 0]],
                        dtype=torch.int64).to(keep.device)
    lib = yardstick()
    fn = lib.srt_gather_compact_two_pass
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int64, ctypes.c_void_p]
    rc = fn(keep.data_ptr(), pos.data_ptr(), sel.data_ptr(), new_n.data_ptr(),
            desc.data_ptr(), len(streams), capacity, stream_handle(keep))
    check_launch(lib, rc, "two-pass compaction")
    n = len(datas)
    return list(zip(outs[:n], outs[n:])), new_n


def yardstick_partials(x, gid, nseg, nb, block):
    """onehot_partials before the ranked form: csrc/yardstick.cu's
    select-add kernel, one CTA of 128 threads a block."""
    from spark_rapids_tpu_torch.kernels import check_launch, stream_handle
    lib = yardstick()
    out = torch.empty((nb, nseg, x.shape[1]), dtype=x.dtype, device=x.device)
    rc = lib.srt_onehot_partials_select_add(
        x.data_ptr(), gid.data_ptr(), out.data_ptr(), nb, nseg, x.shape[1],
        block, x.stride(0), x.stride(1), int(x.dtype == torch.float64),
        stream_handle(x))
    check_launch(lib, rc, "yardstick partials")
    return out


def yardstick_minmax(is_min, v, valid, gid, nseg):
    """fused_minmax before the runs: csrc/yardstick.cu's fill, row-atomic
    and finishing kernels."""
    from spark_rapids_tpu_torch.kernels import check_launch, stream_handle
    lib = yardstick()
    out = torch.empty(nseg, dtype=v.dtype, device=v.device)
    rc = lib.srt_fused_minmax_row_atomics(
        v.data_ptr(), valid.data_ptr(), gid.data_ptr(), out.data_ptr(),
        v.shape[0], nseg, int(is_min), int(v.dtype == torch.float64),
        stream_handle(v))
    check_launch(lib, rc, "yardstick minmax")
    return out


def new_and_old_times(new, old):
    """(new, new back to back, old, old back to back) ms: event medians of
    single calls, then per call over BACK_TO_BACK calls (device time where
    the host launches faster than the card runs)."""
    return (time_ms(new), time_ms(new, iters=7, calls=BACK_TO_BACK),
            time_ms(old), time_ms(old, iters=7, calls=BACK_TO_BACK))


@contextlib.contextmanager
def no_host_sync():
    """Raise on any synchronizing torch CUDA call inside the block."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


#: host syncs of each query's counted warm run in phases 5-13 (by the
#: name its log line carries), for phase 14's comparison with
#: ``BASELINE_WARM_SYNCS``
WARM_SYNCS = {}


@contextlib.contextmanager
def host_sync_count():
    """Count the synchronizing torch CUDA calls inside the block (torch's
    sync debug mode: item/tolist/cpu reads, pageable copies, stream
    syncs); ``box["syncs"]`` holds the count afterwards, ``box["sites"]``
    the count per calling ``file:line`` (paths under the repo relative)."""
    box = {"syncs": None}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield box
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    root = os.path.dirname(os.path.abspath(__file__))
    box["messages"] = [str(w.message) for w in syncs]
    box["syncs"] = len(syncs)
    box["sites"] = collections.Counter(
        f"{os.path.relpath(w.filename, root)}:{w.lineno}" for w in syncs)


def watchdog(seconds: float, what: str) -> threading.Timer:
    """Ends the process (exit 4) unless cancelled within ``seconds``: a
    look-back that waits on a tile that never publishes would hang the
    card, and no CUDA call returns to say so."""
    def fire():
        print(f"chip_smoke: FAILED: {what} did not finish within "
              f"{seconds} s", flush=True)
        os._exit(4)
    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    return timer


def compact_case(name, datas, valids, keep, capacity, quiet=False):
    """gather_compact (under no_host_sync) against gather_compact_plain on
    the card: outputs and new_n bit-identical, and no output stream holds
    a nonzero byte past new_n."""
    from spark_rapids_tpu_torch.kernels.compact import (
        gather_compact,
        gather_compact_plain,
    )
    with no_host_sync():
        got, got_n = gather_compact(datas, valids, keep, capacity)
    ref, ref_n = gather_compact_plain(datas, valids, keep, capacity)
    torch.cuda.synchronize()
    n = int(got_n)
    ok = same_bits(got_n, ref_n) and all(
        same_bits(gd, rd) and same_bits(gv, rv)
        for (gd, gv), (rd, rv) in zip(got, ref))
    tails_zero = not any(bool(t[n:].view(torch.uint8).any())
                         for pair in got for t in pair)
    ok = ok and tails_zero
    if not quiet or not ok:
        log(f"  compact {name}: kept {n}/{capacity} new_n exact="
            f"{same_bits(got_n, ref_n)} tails zero={tails_zero} exact={ok} "
            f"(tol: bit-identical) {'OK' if ok else 'FAIL'}")
    if not ok:
        fail(f"gather_compact {name} disagrees with its plain version")


def compact_times(name, datas, valids, keep, capacity):
    """(kernel, two-pass, plain, library, bound ms, bound_by): compact_pairs
    as a whole, from keep to outputs, in each form."""
    from spark_rapids_tpu_torch.kernels.compact import (
        gather_compact,
        gather_compact_plain,
    )
    d, v, k, cap = datas, valids, keep, capacity
    ms = time_ms(lambda: gather_compact(d, v, k, cap))
    old = time_ms(lambda: two_pass_compact_pairs(d, v, k, cap))
    ms_b2b = time_ms(lambda: gather_compact(d, v, k, cap), iters=7,
                     calls=BACK_TO_BACK)
    old_b2b = time_ms(lambda: two_pass_compact_pairs(d, v, k, cap), iters=7,
                      calls=BACK_TO_BACK)
    plain = time_ms(lambda: gather_compact_plain(d, v, k, cap))
    lib = time_ms(lambda: [t[k] for t in list(d) + list(v)])
    row_bytes = sum(t.element_size() for t in list(d) + list(v))
    # the function: keep and every stream read once, every output slot
    # written once; the two-pass form's bound also read pos (4 B a row)
    nbytes = cap * (1 + 2 * row_bytes)
    bnd, by = bound_ms(nbytes, 0, INT32_OPS_PER_S)
    old_bnd, _ = bound_ms(cap * (row_bytes + 1 + 4) + cap * row_bytes, 0,
                          INT32_OPS_PER_S)
    log(f"  compact time at {name} ({cap} rows, {len(d)} columns, "
        f"{row_bytes} B a row, {int(k.sum())} kept): kernel {ms:.4f} ms, "
        f"two-pass (before) {old:.4f} ms, {BACK_TO_BACK} back to back "
        f"{ms_b2b:.4f} / {old_b2b:.4f} ms a call, plain {plain:.4f} ms, mask "
        f"indexing {lib:.4f} ms, bound {bnd:.6f} ms ({by}; with pos read "
        f"{old_bnd:.6f}), {nbytes / ms / 1e6:.1f} GB/s")
    return ms, old, plain, lib, bnd, by


def check_compact(gen) -> dict:
    # q1's group packing: 16 slots, 6 groups, 2 i32 codes + 7 f64 + 1 i64
    q1_types = [torch.int32] * 2 + [torch.float64] * 7 + [torch.int64]
    datas, valids, _ = compact_inputs(16, 1.0, q1_types, gen)
    keep = torch.zeros(16, dtype=torch.bool, device=DEV)
    keep[[0, 1, 3, 4, 6, 7]] = True
    dog = watchdog(120, "the first one-pass compaction")
    compact_case("q1 (16 slots, 10 columns)", datas, valids, keep, 16)
    dog.cancel()
    q1 = (datas, valids, keep)
    for name, frac in (("all kept", 1.0), ("all dropped", 0.0),
                       ("half kept", 0.5)):
        d, v, k = compact_inputs(4096, frac, q1_types, gen)
        compact_case(f"{name} (4096 rows)", d, v, k, 4096)
    pair = [torch.int64, torch.float64]
    for p in range(1, 25):
        d, v, k = compact_inputs(1 << p, 0.5, pair, gen)
        compact_case(f"n=2^{p}", d, v, k, 1 << p, quiet=True)
    log("  compact n=2^1..2^24 (i64 + f64, half kept): exact=True (tol: "
        "bit-identical, new_n and zero tails included) OK")
    for n in (1, 3, 4097, 1_000_003):
        d, v, k = compact_inputs(n, 0.7, q1_types, gen)
        compact_case(f"n={n} (10 columns)", d, v, k, n)
    # more streams than one launch takes: the gather map and its launches
    wide = [torch.int32, torch.float64, torch.int64, torch.float64] * 10
    for n in (10_000, 1 << 20):
        d, v, k = compact_inputs(n, 0.6, wide, gen)
        compact_case(f"{len(wide)} columns = {2 * len(wide)} streams "
                     f"({n} rows)", d, v, k, n)
    big = 1 << 23
    bd, bv, bk = compact_inputs(big, 0.98, [torch.float64] * 7, gen)
    compact_case("large (2^23 rows x 7 f64, 98% kept)", bd, bv, bk, big)

    ms, _, plain, lib, bnd, by = compact_times("q1 shape", *q1, 16)
    compact_times("large shape", bd, bv, bk, big)
    return {"name": "gather_compact", "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib}


def sort_operands(n, nops, hi, gen):
    return [torch.randint(0, hi, (n,), generator=gen, device=DEV,
                          dtype=torch.int32) for _ in range(nops)]


def packed_key(ops, widths):
    """One int64 key with the order of the operand tuples: each operand's
    low ``widths[i]`` bits (its flipped word for a uint32 view), first
    operand most significant."""
    key = torch.zeros_like(ops[0], dtype=torch.int64)
    for o, w in zip(ops, widths):
        v = o.view(torch.int32).to(torch.int64) & ((1 << w) - 1)
        key = (key << w) | v
    return key


def sparse_q8_inner_operands(gen, rows=2_500_000, domain=250_000,
                             capacity=1 << 22):
    """The sort-segment aggregate's operands at sparse q8 inner's shape:
    [dead, null, hi, lo] of ``sparse_keys(o_custkey)``, o_custkey under
    the Exponential skew, 2,500,000 orders in a 2^22 bucket (the padding
    rows dead and null, their key zeroed)."""
    from spark_rapids_tpu_torch.ops.ordering import comparable_operands
    live = torch.arange(capacity, device=DEV) < rows
    key = sparse_keys(exponential_keys(capacity, domain, gen))
    dead = (~live).to(torch.int32)
    return [dead, dead.clone()] + comparable_operands(
        torch.where(live, key, torch.zeros_like(key)))


def check_sort(gen) -> dict:
    from spark_rapids_tpu_torch.kernels.sort import (
        radix_plan,
        sort_with_payload,
        sort_with_payload_plain,
        survey_words,
    )
    from spark_rapids_tpu_torch.ops.ordering import (
        comparable_operands,
        descending_operands,
    )

    def run_case(name, ops, quiet=False):
        n = ops[0].shape[0]
        payload = torch.arange(n, dtype=torch.int32, device=DEV)
        sort_with_payload.trace = []
        got = sort_with_payload(ops, payload)
        (_, m, survey), = sort_with_payload.trace
        sort_with_payload.trace = None
        ref = sort_with_payload_plain(ops, payload)
        torch.cuda.synchronize()
        ok = all(same_bits(g, r) for g, r in zip(got, ref))
        if not quiet or not ok:
            plan = radix_plan(*survey_words(survey.tolist(), m))
            log(f"  sort {name}: B={plan.bits} passes={len(plan.passes)} "
                f"exact={ok} (tol: bit-identical) {'OK' if ok else 'FAIL'}")
        if not ok:
            fail(f"sort_with_payload {name} disagrees with its plain version")

    # q1's ORDER BY: 16 rows, live flag + 2 x (null flag, dictionary code)
    live = (torch.arange(16, device=DEV) >= 6).to(torch.int32)
    q1_ops = [live, torch.zeros(16, dtype=torch.int32, device=DEV),
              torch.randint(0, 3, (16,), generator=gen, device=DEV,
                            dtype=torch.int32),
              torch.zeros(16, dtype=torch.int32, device=DEV),
              torch.randint(0, 2, (16,), generator=gen, device=DEV,
                            dtype=torch.int32)]
    run_case("q1 (16 rows, 5 int32 operands)", q1_ops)

    # edges: f64 sortable words (uint32) with NaN, -0.0, +-inf and ties,
    # ascending and descending, beside int32 ties: B > 64 (multiword), in
    # one CTA and on the planned path
    def f64_edges(n):
        f = torch.randn(n, generator=gen, device=DEV, dtype=torch.float64)
        f[:6] = torch.tensor([float("nan"), -0.0, 0.0, float("inf"),
                              float("-inf"), float("nan")],
                             dtype=torch.float64)
        f[6:n // 2] = f[:6].repeat(n // 12 + 1)[:n // 2 - 6]
        words = comparable_operands(f)
        return ([sort_operands(n, 1, 3, gen)[0]] + words
                + descending_operands(words))

    run_case("edges (4096 rows, uint32 f64 words asc+desc, int32 ties)",
             f64_edges(4096))
    run_case("edges (2^20 rows, uint32 f64 words asc+desc, int32 ties)",
             f64_edges(1 << 20))
    # every power of two from 2 to 2^24 (one CTA up to 4096 rows)
    for p in range(1, 25):
        run_case(f"n=2^{p}", sort_operands(1 << p, 2, 7, gen), quiet=True)
    log("  sort n=2^1..2^24 (2 int32 operands of 7 values): exact=True (tol: "
        "bit-identical) OK")
    for n in (3, 384, 1_000_003):
        run_case(f"n={n} (2 int32 operands of 7 values, 1 uint32)",
                 sort_operands(n, 2, 7, gen)
                 + [torch.randint(-(2 ** 31), 2 ** 31 - 1, (n,),
                                  generator=gen, device=DEV,
                                  dtype=torch.int32).view(torch.uint32)])
    for n in (16, 1 << 20):
        run_case(f"B=0 ({n} equal rows, 3 operands)",
                 [torch.full((n,), v, dtype=torch.int32, device=DEV)
                  for v in (-5, 0, 2 ** 31 - 1)])
    big = 1 << 20
    big_ops = sort_operands(big, 5, 1 << 12, gen)
    run_case("large (2^20 rows, 5 int32 operands of 12 bits)", big_ops)
    sq8_ops = sparse_q8_inner_operands(gen)
    run_case("sparse q8 inner (2^22 rows, [dead, null, hi, lo] of "
             "sparse_keys(o_custkey))", sq8_ops)

    def timings(name, ops, widths):
        n = ops[0].shape[0]
        payload = torch.arange(n, dtype=torch.int32, device=DEV)
        ms = time_ms(lambda: sort_with_payload(ops, payload))
        plain = time_ms(lambda: sort_with_payload_plain(ops, payload))
        key = packed_key(ops, widths)
        lib = time_ms(lambda: torch.sort(key, stable=True))
        narr = len(ops) + 1
        nbytes = 2 * narr * n * 4
        ops_needed = n * math.log2(n) * narr
        bnd, by = bound_ms(nbytes, ops_needed, INT32_OPS_PER_S)
        log(f"  sort time at {name}: kernel {ms:.4f} ms, plain {plain:.4f} "
            f"ms, torch.sort(packed int64, stable=True) {lib:.4f} ms, bound "
            f"{bnd:.6f} ms ({by})")
        return ms, plain, lib, bnd, by

    ms, plain, lib, bnd, by = timings("q1 shape", q1_ops, [1, 1, 2, 1, 1])
    timings("large shape (2^20 x 5)", big_ops, [12] * 5)
    timings("sparse q8 inner shape (2^22 x 4)", sq8_ops, [1, 1, 8, 32])
    return {"name": "sort_with_payload", "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib}


def sort_trace_start() -> int:
    """Record every sort from here on; returns the host syncs so far."""
    from spark_rapids_tpu_torch.kernels.sort import sort_with_payload
    sort_with_payload.trace = []
    return sort_with_payload.host_syncs


def sort_trace_end(what: str, syncs_before: int) -> None:
    """Log each sort since sort_trace_start: rows, operands, varying bits
    B and digit passes, and the survey read-backs (host syncs)."""
    from spark_rapids_tpu_torch.kernels.sort import (
        radix_plan,
        sort_with_payload,
        survey_words,
    )
    trace, sort_with_payload.trace = sort_with_payload.trace, None
    sorts = []
    for n, m, survey in trace:
        plan = radix_plan(*survey_words(survey.tolist(), m))
        sorts.append(f"(n={n}, operands={m}, B={plan.bits}, "
                     f"passes={len(plan.passes)})")
    log(f"  {what}: sorts {', '.join(sorts) or 'none'}; sort host syncs "
        f"{sort_with_payload.host_syncs - syncs_before}")


def sparse_keys(k: torch.Tensor) -> torch.Tensor:
    """The sparse key form of q3: k -> (k * 0x9E3779B1) mod 2^40, a
    bijection on [0, 2^40) (the multiplier is odd)."""
    return (k * 0x9E3779B1) & ((1 << 40) - 1)


def hashprobe_case(n_probe, build_cap, n_build, live_share, match_share,
                   gen):
    """A join's key streams: a build table of ``build_cap`` slots holding
    ``n_build`` sparse unique keys, ``live_share`` of them live (the date
    or segment filter), and ``n_probe`` probe keys of which
    ``match_share`` draw from the build keys; 5% of probe keys null."""
    dev = DEV
    rkeys = sparse_keys(torch.arange(build_cap, device=dev,
                                     dtype=torch.int64))
    live_r = (torch.arange(build_cap, device=dev) < n_build) & (
        torch.rand(build_cap, generator=gen, device=dev) < live_share)
    pick = torch.randint(0, n_build, (n_probe,), generator=gen, device=dev)
    miss = sparse_keys(torch.randint(build_cap, 1 << 40, (n_probe,),
                                     generator=gen, device=dev))
    hit = torch.rand(n_probe, generator=gen, device=dev) < match_share
    lkeys = torch.where(hit, rkeys[pick], miss)
    lvalid = torch.rand(n_probe, generator=gen, device=dev) < 0.95
    return lkeys, lvalid, rkeys, live_r


def probe_library(lkeys, lvalid, rkeys, valid_r):
    """The probe's function in PyTorch library calls, the yardstick: the
    valid build keys sorted (``torch.sort``), ``torch.searchsorted``, and
    the gather and equality mask that turn a position into a rowid or -1
    (with unique build keys, the kernel's answer)."""
    rows = torch.nonzero(valid_r).squeeze(1)
    sorted_keys, order = torch.sort(rkeys[rows])
    at = torch.searchsorted(sorted_keys, lkeys).clamp_(
        max=sorted_keys.shape[0] - 1)
    hit = lvalid & (sorted_keys[at] == lkeys)
    return torch.where(hit, rows[order[at]].to(torch.int32), -1)


def yardstick_probe(slot16, lkeys, lvalid, trow, tkey, attempts):
    """The full walk before the early exit, or (``slot16``) the walk over
    16-byte {key, rowid} slots packed from build_table's two arrays, the
    packing in the same call: rowids of csrc/yardstick.cu."""
    from spark_rapids_tpu_torch.kernels import check_launch, stream_handle
    lib = yardstick()
    n, tbl = lkeys.shape[0], trow.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=DEV)
    args = (lkeys.data_ptr(), lvalid.data_ptr(), trow.data_ptr(),
            tkey.data_ptr())
    if slot16:
        slots = torch.empty((tbl, 2), dtype=torch.int64, device=DEV)
        rc = lib.srt_probe_slot16(*args, slots.data_ptr(), out.data_ptr(), n,
                                  tbl, attempts, stream_handle(lkeys))
    else:
        rc = lib.srt_probe_full_walk(*args, out.data_ptr(), n, tbl, attempts,
                                     stream_handle(lkeys))
    check_launch(lib, rc, "yardstick probe")
    return out


def probe_forms(lkeys, lvalid, rkeys, live_r, tbl, attempts):
    """{form: () -> rowids} of the probe at one shape: the kernel, the
    full walk before the early exit, the 16-byte-slot layout (its packing
    included), the plain version and the library calls."""
    from spark_rapids_tpu_torch.kernels import hashprobe as H
    trow, tkey, _ = H.build_table(rkeys, live_r, tbl, attempts)
    return {
        "kernel": lambda: H.probe_rowids(lkeys, lvalid, trow, rkeys,
                                         attempts),
        "full walk (before)": lambda: yardstick_probe(
            False, lkeys, lvalid, trow, tkey, attempts),
        "16-byte slots": lambda: yardstick_probe(
            True, lkeys, lvalid, trow, tkey, attempts),
        "plain": lambda: H.probe_rowids_plain(lkeys, lvalid, trow, rkeys,
                                              attempts),
        "library": lambda: probe_library(lkeys, lvalid, rkeys, live_r),
    }


def probe_shape(name, lkeys, lvalid, rkeys, live_r, tbl, attempts,
                timed=True):
    """At one shape: every form's rowids against the plain version's (the
    library's only where the build keys are unique), the kernel under
    no_host_sync; then each form's time beside the bound. Returns
    {form: ms}."""
    forms = probe_forms(lkeys, lvalid, rkeys, live_r, tbl, attempts)
    with no_host_sync():
        got = forms["kernel"]()
    ref = forms["plain"]()
    outs = {f: forms[f]() for f in ("full walk (before)", "16-byte slots",
                                    "library")}
    torch.cuda.synchronize()
    ok = same_bits(got, ref) and same_bits(outs["full walk (before)"], ref) \
        and same_bits(outs["16-byte slots"], ref)
    lib_same = same_bits(outs["library"], ref)
    log(f"  hashprobe {name}: matched {int((got >= 0).sum())}/"
        f"{lkeys.shape[0]} kernel exact={ok} (tol: bit-identical to the "
        f"plain version, both yardstick kernels too; library calls "
        f"{'equal' if lib_same else 'differ'}) {'OK' if ok else 'FAIL'}")
    if not ok:
        fail(f"probe_rowids {name} disagrees with its plain version")
    if not timed:
        return None
    times = {f: time_ms(fn) for f, fn in forms.items()}
    b2b = {f: time_ms(forms[f], iters=7, calls=BACK_TO_BACK)
           for f in ("kernel", "full walk (before)", "16-byte slots")}
    n = lkeys.shape[0]
    # each probe row: key 8 B + validity 1 B read, rowid 4 B written; the
    # table (rowid 4 B + key 8 B per slot) read once, whatever the layout
    nbytes = n * (8 + 1 + 4) + tbl * 12
    bnd, by = bound_ms(nbytes, 0, INT32_OPS_PER_S)
    log(f"  hashprobe time at {name}: " + ", ".join(
        f"{f} {t:.4f} ms" for f, t in times.items())
        + f", bound {bnd:.4f} ms ({by}), {nbytes / times['kernel'] / 1e6:.1f}"
        f" GB/s; {BACK_TO_BACK} back to back, a call: " + ", ".join(
            f"{f} {t:.4f} ms" for f, t in b2b.items()))
    return dict(times, bound=bnd, bound_by=by)


def check_hashprobe(gen) -> dict:
    from spark_rapids_tpu_torch.kernels import hashprobe as H

    def to_cpu(*ts):
        return [t.cpu() for t in ts]

    def run_ranges(name, lkeys, lvalid, rkeys, live_r, tbl, attempts,
                   want_fail=None):
        """probe_ranges on the card (kernel) against probe_ranges on CPU
        copies (plain version): all six outputs bit-identical, and the
        table the card built equal to the CPU's."""
        live_l = torch.ones_like(lvalid)
        args = ((lkeys, lvalid), (rkeys, live_r), live_l, live_r, tbl,
                attempts)
        got = H.probe_ranges(*args)
        cl, clv, cr, clr, cll = to_cpu(lkeys, lvalid, rkeys, live_r, live_l)
        ref = H.probe_ranges((cl, clv), (cr, clr), cll, clr, tbl, attempts)
        g_tab = H.build_table(rkeys, live_r, tbl, attempts)
        r_tab = H.build_table(cr, clr, tbl, attempts)
        torch.cuda.synchronize()
        ok = all(same_bits(g.cpu(), r) for g, r in zip(got, ref)) and all(
            same_bits(g.cpu(), r) for g, r in zip(g_tab, r_tab))
        fail_flag = bool(got[-1])
        if want_fail is not None and fail_flag != want_fail:
            ok = False
        log(f"  hashprobe {name}: matched {int(got[2])}/{lkeys.shape[0]} "
            f"fail={fail_flag} exact={ok} (tol: bit-identical rowids, "
            f"table and fail) {'OK' if ok else 'FAIL'}")
        if not ok:
            fail(f"probe_rowids {name} disagrees with its plain version")
        return got

    big = 1 << 23
    # join 1 of sparse q3 at SF 1: lineitem probes orders (capacity 2^21,
    # 1,500,303 rows, ~40% before the order-date cut), H = 2^22
    j1 = hashprobe_case(big, 1 << 21, 1_500_303, 0.402, 0.4, gen)
    # ~600k live keys at load 0.14: with 4 attempts some 10^2 rows stay
    # homeless (fail set, as in the reference); 8 attempts place them all
    run_ranges("q3 join 1 (2^23 probe rows, H 2^22, 4 attempts)", *j1,
               1 << 22, 4)
    run_ranges("q3 join 1 (2^23 probe rows, H 2^22, 8 attempts)", *j1,
               1 << 22, 8, want_fail=False)
    # join 2: the join 1 output probes customer (capacity 2^18, 150,030
    # rows, 1 in 5 in the segment), H = 2^19
    j2 = hashprobe_case(big, 1 << 18, 150_030, 0.2, 0.2, gen)
    run_ranges("q3 join 2 (2^23 probe rows, H 2^19, 4 attempts)", *j2,
               1 << 19, 4, want_fail=False)
    # edges: extreme keys and nulls; a duplicated build key; homeless rows
    e_l, e_lv, e_r, e_lr = hashprobe_case(4096, 2048, 2048, 0.9, 0.5, gen)
    edges = torch.tensor([-(2 ** 63), 2 ** 63 - 1, 0, -1, -(2 ** 31)],
                         dtype=torch.int64, device=DEV)
    e_r[:5] = edges
    e_l[:5] = edges
    e_l[5:10] = edges
    e_lv[5:10] = False
    run_ranges("edges (INT64_MIN/MAX, 0, -1, -2^31, null probe keys)", e_l,
               e_lv, e_r, e_lr, 4096, 8)
    probe_shape("edges, 8 attempts", e_l, e_lv, e_r, e_lr, 4096, 8,
                timed=False)
    d_r, d_lr = e_r.clone(), e_lr.clone()
    d_r[100] = d_r[1500]
    d_lr[100] = d_lr[1500] = True
    run_ranges("duplicated build key", e_l, e_lv, d_r, d_lr, 4096, 4,
               want_fail=True)
    probe_shape("duplicated build key, self-probe", d_r, d_lr, d_r, d_lr,
                4096, 4, timed=False)
    run_ranges("homeless rows (H 64, 1 attempt)", e_l, e_lv, e_r, e_lr, 64,
               1, want_fail=True)
    probe_shape("homeless rows, probe", e_l, e_lv, e_r, e_lr, 64, 1,
                timed=False)

    # every shape the joins give the kernel: the probes and the self-probes
    # of join 1 and join 2 with 4 attempts (sparse q3) and 8 (sparse-8)
    times = {}
    for att in (4, 8):
        times[("join 1", att)] = probe_shape(
            f"q3 join 1 (2^23 probes, H 2^22, {att} attempts)", *j1, 1 << 22,
            att)
        probe_shape(f"q3 join 1 self-probe (2^21 rows, H 2^22, {att} "
                    "attempts)", j1[2], j1[3], j1[2], j1[3], 1 << 22, att)
        probe_shape(f"q3 join 2 (2^23 probes, H 2^19, {att} attempts)", *j2,
                    1 << 19, att)
        probe_shape(f"q3 join 2 self-probe (2^18 rows, H 2^19, {att} "
                    "attempts)", j2[2], j2[3], j2[2], j2[3], 1 << 19, att)
    t = times[("join 1", 4)]
    return {"name": "probe_rowids", "max_abs_err": 0.0, "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": t["bound"],
            "bound_by": t["bound_by"], "library_ms": t["library"]}


INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)
#: a NaN with a payload and the sign bit set (the kernel must still give
#: the canonical NaN)
NEG_NAN_BITS = 0xFFF8_0000_0000_0001 - (1 << 64)


Q8_SHAPE = "q8 (Exponential skew)"


def minmax_values(n, dtype, gen):
    """int64 values with the extremes, or doubles with NaN (two payloads),
    -0.0, 0.0 and +-inf sprinkled in."""
    if dtype == torch.int64:
        v = torch.randint(-(2 ** 62), 2 ** 62, (n,), generator=gen,
                          device=DEV, dtype=torch.int64)
        v[:4] = torch.tensor([INT64_MAX, INT64_MIN, 0, -1], dtype=torch.int64)
        return v
    v = torch.randn(n, generator=gen, device=DEV, dtype=torch.float64) * 1e6
    u = torch.rand(n, generator=gen, device=DEV)
    v = torch.where(u < 1e-3, float("nan"), v)
    v = torch.where((u >= 1e-3) & (u < 2e-3), -0.0, v)
    v = torch.where((u >= 2e-3) & (u < 3e-3), 0.0, v)
    v[:3] = torch.tensor([float("inf"), float("-inf"), 0.0],
                         dtype=torch.float64)
    v[3:4] = torch.tensor([NEG_NAN_BITS], dtype=torch.int64).view(
        torch.float64)
    return v


def minmax_edges(v, valid, gid, segs):
    """Rows 8..31 become edge segments ``segs`` = (all-NaN, all-null,
    -0.0 then 0.0, 0.0 then -0.0); for int64 the NaN segment holds the
    extremes instead."""
    s_nan, s_null, s_z1, s_z2 = segs
    rows = torch.arange(8, 32, device=DEV)
    gid[8:14], gid[14:20], gid[20:26], gid[26:32] = s_nan, s_null, s_z1, s_z2
    valid[8:32] = True
    valid[14:20] = False
    if v.dtype == torch.float64:
        v[8:14] = float("nan")
        v[20:26] = torch.where(rows[12:18] % 2 == 0, -0.0, 0.0).to(v.dtype)
        v[26:32] = torch.where(rows[18:24] % 2 == 0, 0.0, -0.0).to(v.dtype)
    else:
        v[8:14] = torch.tensor([INT64_MAX, INT64_MIN] * 3, dtype=torch.int64)


def exponential_keys(n, domain, gen):
    """ForeignKey(parent_rows=domain, distribution=Exponential()) of
    datagen.py, drawn on the card: floor(min(Exp(rate 4), 1-) * domain)."""
    u = torch.empty(n, device=DEV, dtype=torch.float64).exponential_(
        4.0, generator=gen).clamp_(max=1.0 - 2.0 ** -53)
    return (u * domain).to(torch.int64)


def minmax_shapes(gen, global_rows=10_000_000, q8_rows=2_500_000,
                  domain=250_000):
    """{name: (nrows, capacity, nseg, valid, gid, edge segments)} at the
    three shapes the main path gives the kernel."""
    from spark_rapids_tpu_torch.columnar import bucket_for
    shapes = {}
    # q2-style global aggregate over lineitem at SF 10: 10M rows in a
    # 2^24 bucket, all in segment 0 of the global layout's 8, half kept
    # by the filter; the edge segments use the padding slots 1-4
    cap, nrows = bucket_for(global_rows), global_rows
    live = torch.arange(cap, device=DEV) < nrows
    valid = live & (torch.rand(cap, generator=gen, device=DEV) < 0.5)
    gid = torch.zeros(cap, dtype=torch.int32, device=DEV)
    shapes["global (all rows in segment 0 of 8)"] = (
        nrows, cap, 8, valid, gid, (1, 2, 3, 4))
    # q8's inner group-by at SF 10: 2,500,000 orders in a 2^22 bucket,
    # o_custkey under the Exponential skew over 250,000 keys, gpad 2^18;
    # padding rows on the null slot 250,000 (never valid)
    cap, nrows, dom = bucket_for(q8_rows), q8_rows, domain
    gpad = 1 << dom.bit_length()  # the key domain + its null slot, padded
    live = torch.arange(cap, device=DEV) < nrows
    keys = exponential_keys(cap, dom, gen)
    gid = torch.where(live, keys, dom).to(torch.int32)
    shapes[Q8_SHAPE] = (nrows, cap, gpad, live.clone(), gid,
                        tuple(range(gpad - 4, gpad)))
    # the sort-segment path: the same keys sorted and densely ranked,
    # nseg = capacity, dead rows parked past it (never valid)
    srt = torch.sort(keys[:nrows]).values
    rank = torch.cumsum((srt != torch.roll(srt, 1)).to(torch.int64), 0)
    rank = rank - rank[0]
    rows = torch.arange(cap, device=DEV)
    gid = torch.where(live, torch.cat([rank, rank.new_zeros(cap - nrows)]),
                      cap + rows).to(torch.int32)
    ng = int(rank[-1]) + 1
    shapes["sort-segment (nseg = capacity, sorted gid)"] = (
        nrows, cap, cap, live.clone(), gid, (ng, ng + 1, ng + 2, ng + 3))
    return shapes


def minmax_run_case(n, nseg, dtype, gen):
    """n rows whose gids come in runs of 1-40 rows, so a thread's 8-row
    run crosses segment boundaries and holds several runs; about 80%
    valid, 2% of gids outside [0, nseg); the edge segments (minmax_edges)
    at the top of the range where n >= 32."""
    lengths = torch.randint(1, 41, (n,), generator=gen, device=DEV)
    keys = torch.randint(0, nseg - 4, (n,), generator=gen, device=DEV)
    gid = torch.repeat_interleave(keys, lengths)[:n]
    out = torch.rand(n, generator=gen, device=DEV) < 0.02
    gid = torch.where(out, torch.full_like(gid, nseg + 3), gid)
    gid = torch.where(out & (torch.rand(n, generator=gen, device=DEV) < 0.5),
                      torch.full_like(gid, -1), gid).to(torch.int32)
    valid = torch.rand(n, generator=gen, device=DEV) < 0.8
    v = minmax_values(max(n, 4), dtype, gen)[:n].contiguous()
    if n >= 32:
        minmax_edges(v, valid, gid, tuple(range(nseg - 4, nseg)))
    return v, valid, gid


def minmax_exact(what, v, valid, gid, nseg, is_min, quiet=False):
    """fused_minmax bit-identical to its plain version and across two
    launches."""
    from spark_rapids_tpu_torch.kernels.segreduce import (
        fused_minmax,
        fused_minmax_plain,
    )
    a = fused_minmax(is_min, v, valid, gid, nseg)
    b = fused_minmax(is_min, v, valid, gid, nseg)
    ref = fused_minmax_plain(is_min, v, valid, gid, nseg)
    torch.cuda.synchronize()
    ok = same_bits(a, b) and same_bits(a, ref)
    if not quiet or not ok:
        log(f"  minmax {what}: exact={ok} (tol: bit-identical to the plain "
            f"version and across two launches) {'OK' if ok else 'FAIL'}")
    if not ok:
        fail(f"fused_minmax {what} disagrees with its plain version")
    return a


def check_minmax_runs(gen) -> None:
    """Runs of rows that cross segment boundaries or are part valid, n not
    a multiple of the 8-row run, few segments (the finishing map in the
    last CTA) and many (a second launch), and inputs that are not 16-byte
    aligned (row by row loads)."""
    for n in (1, 3, 17, 4097, 1_000_003):
        for nseg in (24, 5000):
            for dtype in (torch.int64, torch.float64):
                v, valid, gid = minmax_run_case(n, nseg, dtype, gen)
                for is_min in (True, False):
                    minmax_exact(f"runs n={n} nseg={nseg}", v, valid, gid,
                                 nseg, is_min, quiet=True)
    log("  minmax runs across segment boundaries, part valid, n = 1, 3, 17, "
        "4097, 1,000,003, nseg 24 and 5000, int64 and f64, min and max: "
        "exact=True (tol: bit-identical to the plain version and across "
        "two launches) OK")
    for dtype in (torch.int64, torch.float64):
        v, valid, gid = minmax_run_case(1_000_004, 5000, dtype, gen)
        for is_min in (True, False):
            minmax_exact(f"unaligned (views at row 1) {str(dtype)[6:]} "
                         f"{'min' if is_min else 'max'}", v[1:], valid[1:],
                         gid[1:], 5000, is_min)


def check_minmax(seed: int = 3, **shape_args) -> dict:
    """fused_minmax against its plain version at the main path's three
    shapes, on inputs from its own generator (``seed``)."""
    from spark_rapids_tpu_torch.kernels.segreduce import (
        _f64_keys,
        fused_minmax,
        fused_minmax_plain,
    )
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    times = {}
    for name, (nrows, cap, nseg, valid0, gid0, segs) in \
            minmax_shapes(gen, **shape_args).items():
        for dtype in (torch.int64, torch.float64):
            v = minmax_values(cap, dtype, gen)
            valid, gid = valid0.clone(), gid0.clone()
            minmax_edges(v, valid, gid, segs)
            for is_min in (True, False):
                what = (f"{name} {cap} rows {nseg} segments "
                        f"{str(dtype)[6:]} "
                        f"{'min' if is_min else 'max'}")
                a = minmax_exact(what, v, valid, gid, nseg, is_min,
                                 quiet=True)
                ok = True
                if dtype == torch.float64:
                    nan = a[segs[0]].view(torch.int64)
                    ok = int(nan) == 0x7FF8_0000_0000_0000
                    z1, z2 = (a[list(segs[2:])].view(torch.int64)
                              .tolist())
                    zero = -(1 << 63) if is_min else 0
                    ok = ok and z1 == z2 == zero
                log(f"  minmax {what}: exact=True (tol: bit-identical to "
                    f"the plain version and across two launches); edges "
                    f"ok={ok} (NaN canonical, -0.0 < 0.0) "
                    f"{'OK' if ok else 'FAIL'}")
                if not ok:
                    fail(f"fused_minmax {what}: wrong edge segments")
        # times of a double max (q8's aggregate)
        v = minmax_values(cap, torch.float64, gen)
        valid, gid = valid0, gid0
        got = fused_minmax(False, v, valid, gid, nseg)
        if not same_bits(got, yardstick_minmax(False, v, valid, gid, nseg)):
            fail(f"fused_minmax at {name}: the yardstick kernel disagrees")
        ms, ms_b2b, old, old_b2b = new_and_old_times(
            lambda: fused_minmax(False, v, valid, gid, nseg),
            lambda: yardstick_minmax(False, v, valid, gid, nseg))
        plain = time_ms(lambda: fused_minmax_plain(False, v, valid, gid,
                                                   nseg))
        use = valid & (gid >= 0) & (gid < nseg)
        k_use, g_use = _f64_keys(v)[use], gid[use].to(torch.int64)
        lib_out = torch.full((nseg,), INT64_MIN, dtype=torch.int64,
                             device=DEV)
        lib = time_ms(lambda: lib_out.scatter_reduce_(
            0, g_use, k_use, "amax", include_self=True))
        # what the function needs: every row's validity (1 B), a valid
        # row's gid (4 B), the value (8 B) of a valid row inside the
        # segments, each segment's result (8 B) written once; one compare
        # per used row
        n_valid, n_use = int(valid.sum()), int(use.sum())
        nbytes = cap + n_valid * 4 + n_use * 8 + nseg * 8
        bnd, by = bound_ms(nbytes, n_use, INT32_OPS_PER_S)
        times[name] = (ms, plain, lib, bnd, by)
        log(f"  minmax time at {name} (f64 max, {cap} rows, {nseg} "
            f"segments, {n_use} valid rows): kernel {ms:.4f} ms "
            f"[{ms_b2b:.4f} {BACK_TO_BACK} back to back], row atomics "
            f"(before) {old:.4f} [{old_b2b:.4f}] ms, plain {plain:.4f} ms, "
            f"scatter_reduce_ amax on the valid rows' int64 keys {lib:.4f} "
            f"ms, bound {bnd:.4f} ms ({by}), {nbytes / ms_b2b / 1e6:.1f} "
            "GB/s back to back")
    check_minmax_runs(gen)
    ms, plain, lib, bnd, by = times[Q8_SHAPE]
    return {"name": "fused_minmax", "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib}


# ---------------------------------------------------------------------------
# phase 4: q1 end to end
# ---------------------------------------------------------------------------

def string_codes(table, names) -> dict:
    """{name: (sorted distinct strings, each row's index into them)} of
    the string columns ``names``, by ``np.unique`` over their values."""
    by = dict(zip(table.names, table.columns))
    out = {}
    for n in names:
        u, i = np.unique(by[n].data.astype(str), return_inverse=True)
        out[n] = (u, i.reshape(-1))
    return out


def q1_oracle(table, codes=None):
    """q1 in plain numpy: rows sorted by (flag, status) with exact counts.
    ``codes`` maps l_returnflag and l_linestatus to (sorted distinct
    strings, each row's index into them), as ``np.unique`` gives them over
    the table's strings (``string_codes``); without it they are made
    here."""
    from spark_rapids_tpu_torch.models.tpch import Q1_CUTOFF_DAYS
    col = {n: c.data for n, c in zip(table.names, table.columns)}
    codes = codes or string_codes(table, ("l_returnflag", "l_linestatus"))
    m = col["l_shipdate"] <= Q1_CUTOFF_DAYS
    rf_u, rf_i = codes["l_returnflag"][0], codes["l_returnflag"][1][m]
    ls_u, ls_i = codes["l_linestatus"][0], codes["l_linestatus"][1][m]
    g = rf_i * len(ls_u) + ls_i
    ng = len(rf_u) * len(ls_u)
    qty, price = col["l_quantity"][m], col["l_extendedprice"][m]
    disc, tax = col["l_discount"][m], col["l_tax"][m]
    dp = price * (1.0 - disc)
    cnt = np.bincount(g, minlength=ng)

    def s(v):
        return np.bincount(g, weights=v, minlength=ng)

    present = np.nonzero(cnt)[0]
    n = np.maximum(cnt, 1)
    cols = {
        "l_returnflag": rf_u[present // len(ls_u)].astype(object),
        "l_linestatus": ls_u[present % len(ls_u)].astype(object),
        "sum_qty": s(qty)[present], "sum_base_price": s(price)[present],
        "sum_disc_price": s(dp)[present],
        "sum_charge": s(dp * (1.0 + tax))[present],
        "avg_qty": (s(qty) / n)[present], "avg_price": (s(price) / n)[present],
        "avg_disc": (s(disc) / n)[present],
        "count_order": cnt[present].astype(np.int64),
    }
    return cols


def check_q1_result(got, oracle) -> None:
    if list(got.names) != list(oracle):
        fail(f"q1 columns {got.names}")
    for name, c in zip(got.names, got.columns):
        want = oracle[name]
        if len(c.data) != len(want) or not c.validity.all():
            fail(f"q1 {name}: {len(c.data)} rows / validity, want "
                 f"{len(want)} valid rows")
        if c.data.dtype.kind == "f":
            if not np.isfinite(c.data).all() or not np.allclose(
                    c.data, want, rtol=1e-9, atol=0):
                fail(f"q1 {name}: {c.data} vs oracle {want} (rtol 1e-9)")
        elif not (c.data == want).all() or c.data.dtype != want.dtype:
            fail(f"q1 {name}: {c.data} vs oracle {want} (exact)")


def run_q1(rows: int, profile_dir, keep=None) -> dict:
    """q1 through the DSL against its oracle. With ``keep`` (a dict),
    ``keep["TPC-H q1"]`` holds what phase 9 holds the SQL form to: the
    table, the builder, the result, the oracle check, the launches and
    the warm median."""
    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.models.tpch import lineitem_table, q1_dataframe
    from spark_rapids_tpu_torch.session import TorchSession

    t0 = time.perf_counter()
    table = lineitem_table(rows, seed=0)
    log(f"  generated {rows} lineitem rows in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    oracle = q1_oracle(table)
    session = TorchSession()
    if session.device.type != DEV.type:
        fail(f"session device {session.device}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    K.reset_launch_counts()
    syncs = sort_trace_start()
    t0 = time.perf_counter()
    with host_sync_count() as box:
        got = q1_dataframe(session, table).collect_table()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = K.launch_counts()
    log(f"  q1 launches during the query: {launches}")
    sort_trace_end("q1", syncs)
    log(f"  q1 (cold): host syncs {box['syncs']} (torch's sync debug mode, "
        "the upload's pageable copies included)")
    for name in ("onehot_partials", "gather_compact", "sort_with_payload"):
        if launches[name] < 1:
            fail(f"q1 did not launch {name}")
    check_q1_result(got, oracle)
    log(f"  q1 result matches the numpy oracle ({got.num_rows} groups; keys "
        "and counts exact, floats rtol 1e-9)")

    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = q1_dataframe(session, table).collect_table()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        check_q1_result(again, oracle)
    peak = torch.cuda.max_memory_allocated()
    log(f"  q1 at {rows} rows: cold {cold * 1e3:.1f} ms (host dictionary "
        f"encoding + upload included), warm median "
        f"{statistics.median(warm) * 1e3:.2f} ms (scan cache hit; runs "
        f"{[round(w * 1e3, 2) for w in warm]}), peak device memory "
        f"{peak / 2**30:.2f} GiB")
    if profile_dir:
        profile_q1(session, table, profile_dir)
    if keep is not None:
        keep["TPC-H q1"] = {
            "tables": (table,), "result": got, "launches": dict(launches),
            "build": lambda: q1_dataframe(session, table),
            "check": lambda g: check_q1_result(g, oracle),
            "warm_ms": round(statistics.median(warm) * 1e3, 2)}
    return launches


def profile_q1(session, table, out_dir) -> None:
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    profile_run("q1", lambda: q1_dataframe(session, table).collect_table(),
                out_dir)


#: kernels by family, for their shares of device time: the radix sort's
#: (csrc/sort.cu), the probe's (csrc/hashprobe.cu), the compaction's
#: (csrc/compact.cu), the partial sums' (csrc/segreduce.cu) and MIN/MAX's
#: (csrc/minmax.cu; its output memset is not a kernel), each with the
#: names of the form before its redesign (csrc/yardstick.cu), so that the
#: traces of an older commit read the same way
KERNEL_FAMILIES = {
    "sort": ("survey_bits", "pack_hist", "onesweep_pass", "finish_rows",
             "sort_small"),
    "probe": ("probe_rows",),
    "compaction": ("compact_tiles", "gather_streams", "invert_positions"),
    "partials": ("partials_block", "onehot_partials_kernel"),
    "minmax": ("minmax_runs", "minmax_finish", "minmax_rows",
               "fill_identity", "keys_to_f64"),
    "dec128div": ("dec128div_kernel",),
}


def trace_times(path):
    """(device busy ms, span ms from the first device event to the end of
    the last, {family: ms of its kernels}) of a chrome trace's kernels,
    copies and memsets; None when the trace holds no device event."""
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        return None
    busy = sum(e["dur"] for e in dev) / 1e3
    span = (max(e["ts"] + e["dur"] for e in dev)
            - min(e["ts"] for e in dev)) / 1e3
    families = {f: sum(e["dur"] for e in dev
                       if any(k in e["name"] for k in names)) / 1e3
                for f, names in KERNEL_FAMILIES.items()}
    return busy, span, families


def profile_run(name, run, out_dir) -> dict:
    """One warm run of ``run`` under the engine's profiler
    (``runtime/profiler.py::record_trace``): its chrome trace and its
    table of device time by operator under ``out_dir/<name>/``, and the
    run's device busy time, idle share and kernel families' times from
    that trace (the first two returned). A trace without device events
    (CUPTI's buffers; the profiler says so in its directory) is profiled
    again, at most twice more."""
    from spark_rapids_tpu_torch.runtime.profiler import record_trace
    tag = "_".join("".join(ch if ch.isalnum() else " "
                           for ch in name).split())
    path = os.path.join(out_dir, tag)
    for attempt in range(3):
        with record_trace(path, cuda=True) as handle:
            run()
        times = trace_times(handle.trace_path)
        if times is not None:
            break
        log(f"  {name}: the trace of profile attempt {attempt + 1} holds "
            "no device event")
    else:
        fail(f"{handle.trace_path}: no device event in three profiled runs")
    busy, span, families = times
    with open(os.path.join(path, "ops.txt")) as f:
        table_txt = f.read()
    log(f"  {name}: device busy {busy:.3f} ms over a span of {span:.3f} ms "
        f"({100 * (1 - busy / span):.1f}% idle); " + ", ".join(
            f"{f} kernels {ms:.3f} ms ({100 * ms / busy:.1f}% of busy)"
            for f, ms in families.items()))
    log(f"  profile of one warm {name} run (top by device time):")
    for line in table_txt.splitlines()[:25]:
        log("    " + line)
    return {"busy_ms": round(busy, 3), "idle_pct": round(
        100 * (1 - busy / span), 1)}


# ---------------------------------------------------------------------------
# phase 5: q3 end to end, dense and sparse keys
# ---------------------------------------------------------------------------

Q3_SPARSE_KEYS = ("c_custkey", "o_orderkey", "o_custkey", "l_orderkey")


def sparse_form(table):
    """The table with its q3 key columns mapped k -> (k * 0x9E3779B1)
    mod 2^40 (a bijection: unique keys stay unique, but their range no
    longer fits a direct-address table)."""
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    cols = []
    for name, c in zip(table.names, table.columns):
        if name in Q3_SPARSE_KEYS:
            c = HostColumn(c.dtype, (c.data.astype(np.int64) * 0x9E3779B1)
                           & ((1 << 40) - 1), c.validity)
        cols.append(c)
    return HostTable(table.names, cols)


def q3_oracle(cust, orders, lineitem):
    """q3 in plain numpy: (l_orderkey, revenue, n) of the top 10 by
    revenue, ties in ascending key order."""
    from spark_rapids_tpu_torch.models.tpch import Q3_DATE

    def cols(t):
        return {n: c.data for n, c in zip(t.names, t.columns)}

    c, o, li = cols(cust), cols(orders), cols(lineitem)
    ckeys = c["c_custkey"][c["c_mktsegment"].astype(str) == "BUILDING"]
    om = (o["o_orderdate"] < Q3_DATE) & np.isin(o["o_custkey"], ckeys)
    lm = (li["l_shipdate"] > Q3_DATE) & np.isin(li["l_orderkey"],
                                                o["o_orderkey"][om])
    keys, inv = np.unique(li["l_orderkey"][lm], return_inverse=True)
    vol = li["l_extendedprice"][lm] * (1.0 - li["l_discount"][lm])
    rev = np.bincount(inv, weights=vol, minlength=len(keys))
    cnt = np.bincount(inv, minlength=len(keys)).astype(np.int64)
    top = np.argsort(-rev, kind="stable")[:10]
    return {"l_orderkey": keys[top], "revenue": rev[top], "n": cnt[top]}


def check_q3_result(got, oracle, what) -> None:
    if list(got.names) != list(oracle):
        fail(f"{what} columns {got.names}")
    for name, c in zip(got.names, got.columns):
        want = oracle[name]
        if len(c.data) != len(want) or not c.validity.all():
            fail(f"{what} {name}: {len(c.data)} rows / validity, want "
                 f"{len(want)} valid rows")
        if c.data.dtype.kind == "f":
            if not np.isfinite(c.data).all() or not np.allclose(
                    c.data, want, rtol=1e-9, atol=0):
                fail(f"{what} {name}: {c.data} vs oracle {want} (rtol 1e-9)")
        elif not (c.data == want).all() or c.data.dtype != want.dtype:
            fail(f"{what} {name}: {c.data} vs oracle {want} (exact)")


def run_q3_form(what, tables, oracle, conf, expect, profile_dir,
                time_compactions=False, keep=None) -> dict:
    """Cold run (replays counted), three warm runs, and one more warm run
    between launch-counter reads (host syncs counted, every launch held
    against its kernel's plain version on its inputs); every result
    against the oracle. ``time_compactions``: each compaction of that warm
    run is checked and timed again on its own inputs. With ``keep`` (a
    dict), ``keep[what]`` holds the tables, the builder, the counted run's
    result and launches, the oracle check and the warm median (phase
    9)."""
    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.models.tpch import q3_dataframe
    from spark_rapids_tpu_torch.runtime import speculation
    from spark_rapids_tpu_torch.session import TorchSession

    # the blocklist is process-wide and both forms share the join sites
    speculation.clear_blocklist()
    session = TorchSession(conf)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = q3_dataframe(session, *tables).collect_table()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    cold_m = session.last_metrics()
    check_q3_result(got, oracle, what)
    warm = []
    revenue_bits = {got.columns[1].data.tobytes()}
    for _ in range(3):
        t0 = time.perf_counter()
        again = q3_dataframe(session, *tables).collect_table()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        check_q3_result(again, oracle, what)
        revenue_bits.add(again.columns[1].data.tobytes())
    # before the counted run, whose recorded inputs stay allocated
    peak = torch.cuda.max_memory_allocated()
    K.reset_launch_counts()
    syncs = sort_trace_start()
    K.calls = []
    with host_sync_count() as box:
        again = q3_dataframe(session, *tables).collect_table()
    torch.cuda.synchronize()
    launches = K.launch_counts()
    calls, K.calls = K.calls, None
    sort_trace_end(what, syncs)
    compactions = [args for k, args, _ in calls if k == "gather_compact"]
    WARM_SYNCS[what] = box["syncs"]
    log(f"  {what}: host syncs in one warm query {box['syncs']} (torch's "
        f"sync debug mode); compactions (capacity, columns, kept): "
        f"{[(c, len(d), int(k.sum())) for d, _, k, c in compactions]}")
    warm_m = session.last_metrics()
    check_q3_result(again, oracle, what)
    hold_launches(what, calls)
    del calls
    log(f"  {what}: cold {cold * 1e3:.1f} ms ({cold_m['speculationReplays']} "
        f"replays), warm median {statistics.median(warm) * 1e3:.2f} ms (runs "
        f"{[round(w * 1e3, 2) for w in warm]}), peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"  {what}: cold metrics {cold_m}")
    log(f"  {what}: warm metrics {warm_m}")
    log(f"  {what}: launches during one warm query: {launches}")
    log(f"  {what}: result matches the numpy oracle (keys and counts exact, "
        "revenue rtol 1e-9); the revenue bits of the cold and 3 warm runs "
        f"are {'identical' if len(revenue_bits) == 1 else 'NOT identical'} "
        "(f64 index_add_ adds in atomic order)")
    if warm_m["speculationReplays"] != 0:
        fail(f"{what}: a warm run replayed")
    observed = dict(launches, speculationReplays=cold_m["speculationReplays"])
    for key, allowed in expect.items():
        if observed[key] not in allowed:
            fail(f"{what}: {key} = {observed[key]}, expected one of {allowed}")
    for name in ("gather_compact", "sort_with_payload"):
        if launches[name] < 1:
            fail(f"{what} did not launch {name}")
    if time_compactions:
        for i, (d, v, k, c) in enumerate(compactions):
            compact_case(f"{what} call {i + 1}", d, v, k, c)
            compact_times(f"{what} call {i + 1}", d, v, k, c)
    del compactions
    if profile_dir:
        profile_run(what, lambda: q3_dataframe(session, *tables)
                    .collect_table(), profile_dir)
    if keep is not None:
        keep[what] = {
            "tables": tables, "result": again, "launches": dict(launches),
            "build": lambda: q3_dataframe(session, *tables),
            "check": lambda g: check_q3_result(g, oracle, what),
            "warm_ms": round(statistics.median(warm) * 1e3, 2)}
    return launches


def run_q3(rows: int, profile_dir, keep=None) -> int:
    """Dense q3, sparse q3 with the default 4 hash-probe attempts, and
    sparse q3 with 8. Returns probe_rowids' launches in one warm run of
    the 8-attempt sparse form (the form in which both joins probe).
    ``keep``: as in ``run_q3_form``, for the dense and the default sparse
    forms."""
    from spark_rapids_tpu_torch.models.tpch import q3_tables
    t0 = time.perf_counter()
    dense = q3_tables(rows, seed=0)
    sparse = tuple(sparse_form(t) for t in dense)
    o_dense, o_sparse = q3_oracle(*dense), q3_oracle(*sparse)
    log(f"  generated q3 tables ({rows} lineitem, {dense[1].num_rows} "
        f"orders, {dense[0].num_rows} customer rows) and both oracles in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    # dense: both joins direct. Sparse: the direct joins fail (one
    # replay); a join whose hash table leaves a build row homeless replays
    # once more onto the sort-based probe, which 4 attempts may do at SF 1
    run_q3_form("q3 dense", dense, o_dense, None,
                {"speculationReplays": (0,), "probe_rowids": (0,),
                 "sort_with_payload": (1,)},
                profile_dir, time_compactions=True, keep=keep)
    default = run_q3_form("q3 sparse", sparse, o_sparse, None,
                          {"speculationReplays": (1, 2),
                           "probe_rowids": (2, 4),
                           "sort_with_payload": (2, 4)}, profile_dir,
                          keep=keep)
    eight = run_q3_form(
        "q3 sparse, 8 attempts", sparse, o_sparse,
        {"spark.rapids.tpu.kernels.hashprobe.attempts": "8"},
        {"speculationReplays": (1,), "probe_rowids": (4,),
         "sort_with_payload": (2,)}, None)
    log(f"  probe_rowids launches per warm sparse q3: "
        f"{default['probe_rowids']} with 4 attempts, {eight['probe_rowids']} "
        "with 8")
    return eight["probe_rowids"]


# ---------------------------------------------------------------------------
# phase 6: the corpus's q2 and q8, MIN/MAX group-bys and global aggregates
# ---------------------------------------------------------------------------

def host_cols(t):
    return {n: c.data for n, c in zip(t.names, t.columns)}


def sparse_custkey(orders):
    """The orders table with o_custkey mapped by ``sparse_keys``: its range
    no longer fits the no-sort layout, so the group-by takes the
    sort-segment path."""
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    cols = []
    for name, c in zip(orders.names, orders.columns):
        if name == "o_custkey":
            c = HostColumn(c.dtype, sparse_keys(torch.from_numpy(
                c.data.astype(np.int64))).numpy(), c.validity)
        cols.append(c)
    return HostTable(orders.names, cols)


def grouped_oracle(keys, values):
    """{column: per-key MIN/MAX} over the distinct keys in ascending order,
    in numpy (reduceat over the key-sorted rows)."""
    order = np.argsort(keys, kind="stable")
    uniq, starts = np.unique(keys[order], return_index=True)
    out = {"key": uniq}
    for name, (fn, v) in values.items():
        out[name] = fn.reduceat(v[order], starts)
    return out


def check_grouped(got, want, what) -> None:
    """The port's group-by output sorted by its key against the oracle:
    keys, MIN and MAX bit for bit, every value valid."""
    cols = host_cols(got)
    key = cols[got.names[0]]
    if len(key) != len(want["key"]):
        fail(f"{what}: {len(key)} groups, oracle {len(want['key'])}")
    order = np.argsort(key, kind="stable")
    if not (key[order] == want["key"]).all():
        fail(f"{what}: group keys differ from the oracle")
    for name in got.names[1:]:
        c = got.columns[got.names.index(name)]
        if not c.validity.all():
            fail(f"{what} {name}: null results")
        g, w = c.data[order], want[name]
        if g.dtype != w.dtype or g.tobytes() != w.tobytes():
            fail(f"{what} {name}: differs from the oracle (bitwise)")


def check_scalars(got, want, what, rtol=0.0) -> None:
    """One output row against the oracle's scalars: exact, or within
    ``rtol`` where a sum is compared."""
    if got.num_rows != 1:
        fail(f"{what}: {got.num_rows} rows, want 1")
    for name, w in want.items():
        c = got.columns[got.names.index(name)]
        g = c.data[0]
        if not c.validity[0]:
            fail(f"{what} {name}: null")
        if rtol:
            ok = np.isfinite(g) and abs(g - w) <= rtol * abs(w)
        else:
            ok = np.asarray(g).tobytes() == \
                np.asarray(w, c.data.dtype).tobytes()
        if not ok:
            fail(f"{what} {name}: {g!r} vs oracle {w!r}"
                 f"{f' (rtol {rtol})' if rtol else ' (exact)'}")


def corpus_cases(session, tables, sparse_orders):
    """{name: (() -> DataFrame, oracle check, expected fused_minmax
    launches in one warm run)}."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.models.corpus import build_queries
    from spark_rapids_tpu_torch.plan import from_host_table

    q = build_queries(session, tables)
    o, li = host_cols(tables["orders"]), host_cols(tables["lineitem"])
    so = host_cols(sparse_orders)
    n_custs = len(np.unique(o["o_custkey"]))
    m = (li["l_discount"] > 0.05) & (li["l_quantity"] < 25)
    q2_total = float(np.sum(li["l_extendedprice"][m] * li["l_discount"][m]))
    inner = grouped_oracle(o["o_custkey"], {
        "m": (np.maximum, o["o_totalprice"])})
    inner_sparse = grouped_oracle(so["o_custkey"], {
        "m": (np.maximum, so["o_totalprice"])})
    mm = grouped_oracle(o["o_custkey"], {
        "min_key": (np.minimum, o["o_orderkey"]),
        "max_key": (np.maximum, o["o_orderkey"]),
        "min_price": (np.minimum, o["o_totalprice"]),
        "max_price": (np.maximum, o["o_totalprice"])})
    glob = {"max_price": li["l_extendedprice"].max(),
            "min_price": li["l_extendedprice"].min(),
            "max_key": li["l_orderkey"].max()}

    def inner_q(t):
        return lambda: from_host_table(t, session).group_by(
            "o_custkey").agg(F.max("o_totalprice").alias("m"))

    return {
        "q8": (q["q8"], lambda g: check_scalars(
            g, {"n_custs": np.int64(n_custs)}, "q8"), 1),
        "q2": (q["q2"], lambda g: check_scalars(
            g, {"total": q2_total}, "q2", rtol=1e-9), 0),
        "q8 inner": (inner_q(tables["orders"]), lambda g: check_grouped(
            g, inner, "q8 inner"), 1),
        "q8 inner, sparse keys": (inner_q(sparse_orders),
                                  lambda g: check_grouped(
                                      g, inner_sparse, "q8 inner sparse"),
                                  1),
        "min/max group-by": (
            lambda: minmax_groupby(session, tables["orders"]),
            lambda g: check_grouped(g, mm, "min/max group-by"), 4),
        "global min/max": (
            lambda: from_host_table(tables["lineitem"], session).agg(
                F.max("l_extendedprice").alias("max_price"),
                F.min("l_extendedprice").alias("min_price"),
                F.max("l_orderkey").alias("max_key")),
            lambda g: check_scalars(g, glob, "global min/max"), 3),
    }


#: sorts in one warm run of a phase-6 query (0 where not listed): only
#: the sort-segment aggregate sorts
CORPUS_SORTS = {"q8 inner, sparse keys": 1}


def held_call(kernel, args, out):
    """One recorded launch against its kernel's plain version on the
    same inputs: (agrees, what). onehot_partials within rtol 1e-12 of
    each partial's absolute mass (f32 within two 1024-row summation
    orders), every other kernel (the DECIMAL128 division too) bit for
    bit."""
    from spark_rapids_tpu_torch.kernels.compact import gather_compact_plain
    from spark_rapids_tpu_torch.kernels.hashprobe import probe_rowids_plain
    from spark_rapids_tpu_torch.kernels.segreduce import (
        fused_minmax_plain,
        onehot_partials_plain,
    )
    from spark_rapids_tpu_torch.kernels.sort import sort_with_payload_plain
    if kernel == "onehot_partials":
        x, gid, nseg, nb, block = args
        tol = 1e-12 if x.dtype == torch.float64 else \
            2 * (block - 1) * 2.0 ** -24
        _, rel = partials_error(out, onehot_partials_plain(*args), *args)
        return rel <= tol, (f"{tuple(x.shape)} {str(x.dtype)[6:]} nseg "
                            f"{nseg}: err/mass {rel:.2e}")
    if kernel == "gather_compact":
        datas, valids, keep, capacity = args
        pairs, new_n = gather_compact_plain(*args)
        ok = int(new_n) == int(out[1]) and all(
            same_bits(a, b) and same_bits(va, vb)
            for (a, va), (b, vb) in zip(out[0], pairs))
        return ok, (f"{capacity} rows x " + "/".join(
            str(d.dtype)[6:] for d in datas) + f", {int(new_n)} kept")
    if kernel == "sort_with_payload":
        ops, payload = args
        return all(same_bits(a, b) for a, b in zip(
            out, sort_with_payload_plain(ops, payload))), \
            f"{payload.shape[0]} rows x {len(ops)} operands"
    if kernel == "probe_rowids":
        return torch.equal(out, probe_rowids_plain(*args)), \
            f"{args[0].shape[0]} probes, {args[4]} attempts"
    if kernel == "dec128_divide":
        from spark_rapids_tpu_torch.kernels.decimal import dec128_divide_plain
        return all(torch.equal(a, b) for a, b in zip(
            out, dec128_divide_plain(*args))), \
            f"{args[0]} of {args[1].shape[0]} rows"
    return same_bits(out, fused_minmax_plain(*args)), \
        f"{args[1].shape[0]} rows nseg {args[4]}"


def hold_launches(name, calls) -> None:
    """Hold each kernel launch of a query's counted run against its plain
    version on the inputs that launch was given (``kernels.calls``,
    ``held_call``)."""
    held = {}
    for kernel, args, out in calls:
        ok, what = held_call(kernel, args, out)
        if not ok:
            fail(f"{name}: {kernel} ({what}) disagrees with its plain "
                 "version on the inputs of the counted run")
        held.setdefault(kernel, []).append(what)
    for kernel, whats in held.items():
        more = f"; and {len(whats) - 8} more" if len(whats) > 8 else ""
        log(f"  {name}: {kernel} agrees with its plain version on the "
            f"inputs of each of its {len(whats)} launches in the counted "
            f"run: {'; '.join(whats[:8])}{more}")


def run_case(session, name, build, check, profile_dir, keep=None,
             warm_runs: int = 3) -> dict:
    """One query: a cold run (replays counted), ``warm_runs`` warm runs
    (with none, no warm time: the counted run's stands as ``counted_ms``),
    and one more warm run between launch-counter reads (host syncs and
    sorts logged, every launch's inputs recorded and then held against the
    kernel's plain version); each result against its oracle. Returns the
    launches of the counted run and the query's numbers. With ``keep`` (a
    dict), ``keep[name]`` holds the builder, the counted run's result and
    launches, the oracle check and the warm median (phase 9)."""
    from spark_rapids_tpu_torch import kernels as K
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = build().collect_table()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    replays = session.last_metrics()["speculationReplays"]
    check(got)
    warm = []
    for _ in range(warm_runs):
        t0 = time.perf_counter()
        again = build().collect_table()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        check(again)
    # before the counted run, whose recorded inputs stay allocated
    peak = torch.cuda.max_memory_allocated()
    K.reset_launch_counts()
    syncs = sort_trace_start()
    K.calls = []
    t0 = time.perf_counter()
    with host_sync_count() as box:
        again = build().collect_table()
    torch.cuda.synchronize()
    # the counted run: sync debug mode on and every launch's inputs
    # recorded, so slower than a warm run
    counted = time.perf_counter() - t0
    launches = K.launch_counts()
    calls, K.calls = K.calls, None
    sort_trace_end(name, syncs)
    WARM_SYNCS[name] = box["syncs"]
    log(f"  {name}: host syncs in one warm query {box['syncs']} "
        "(torch's sync debug mode), most by site: " + ", ".join(
            f"{site} {n}" for site, n in box["sites"].most_common(4)))
    warm_replays = session.last_metrics()["speculationReplays"]
    check(again)
    hold_launches(name, calls)
    del calls
    timed = (f"warm median {statistics.median(warm) * 1e3:.2f} ms (runs "
             f"{[round(w * 1e3, 2) for w in warm]})" if warm else
             f"no warm run, the counted run {counted * 1e3:.2f} ms")
    log(f"  {name}: cold {cold * 1e3:.1f} ms ({replays} replays), {timed}, "
        f"peak device memory {peak / 2**30:.2f} GiB, {got.num_rows} rows")
    log(f"  {name}: launches during one warm query: {launches}")
    if warm_replays != 0:
        fail(f"{name}: a warm run replayed")
    stats = {"cold_ms": round(cold * 1e3, 2),
             "warm_ms": round(statistics.median(warm) * 1e3, 2)
             if warm else None,
             "counted_ms": round(counted * 1e3, 2),
             "replays": replays, "syncs": box["syncs"],
             "peak_gib": round(peak / 2**30, 3), "rows": got.num_rows}
    if profile_dir:
        stats.update(profile_run(name, lambda: build().collect_table(),
                                 profile_dir))
    if keep is not None:
        keep[name] = {"result": again, "launches": dict(launches),
                      "check": check, "warm_ms": stats["warm_ms"],
                      "build": build}
    return {"launches": launches, "stats": stats}


def run_corpus(tables, sf: float, seed: int, profile_dir,
               keep=None) -> int:
    """Every phase-6 query through ``run_case``, with its oracle and its
    expected MIN/MAX and sort launches. Returns fused_minmax's launches in
    one warm q8."""
    from spark_rapids_tpu_torch.session import TorchSession

    t0 = time.perf_counter()
    sparse_orders = sparse_custkey(tables["orders"])
    session = TorchSession()
    cases = corpus_cases(session, tables, sparse_orders)
    log(f"  scale_test_specs({sf}) seed {seed}: "
        f"{tables['orders'].num_rows} orders, "
        f"{tables['lineitem'].num_rows} lineitem rows; the oracles in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    q8_launches = None
    for name, (build, check, want_minmax) in cases.items():
        launches = run_case(session, name, build, check, profile_dir,
                            keep)["launches"]
        log(f"  {name}: result matches the numpy oracle (MIN, MAX and "
            "counts exact, sums rtol 1e-9)")
        if launches["fused_minmax"] != want_minmax:
            fail(f"{name}: fused_minmax launched {launches['fused_minmax']} "
                 f"times, expected {want_minmax}")
        want_sorts = CORPUS_SORTS.get(name, 0)
        if launches["sort_with_payload"] != want_sorts:
            fail(f"{name}: sort_with_payload launched "
                 f"{launches['sort_with_payload']} times, expected "
                 f"{want_sorts}")
        if name == "q8":
            q8_launches = launches["fused_minmax"]
    return q8_launches


# ---------------------------------------------------------------------------
# phase 7: the rest of the ported corpus
# ---------------------------------------------------------------------------

#: the corpus queries phase 7 runs (q2 and q8 are phase 6's)
WIDE_QUERIES = ("q1", "q3", "q4", "q5", "q9", "q10", "q11", "q12", "q13",
                "q14", "q15", "q16", "q17", "q18", "q19", "q20", "q22")
#: queries with no f64 sum: their integer and decimal sums must never take
#: the one-hot partials' f64 route
NO_F64_SUMS = ("q11", "q13", "q16", "q18", "q20", "q22")


def group_sum(inv, ngroups, values):
    """Per-group sums of ``values`` by group index ``inv``: exact int64
    (np.add.at) for integers, np.bincount for doubles."""
    if values.dtype.kind == "f":
        return np.bincount(inv, weights=values, minlength=ngroups)
    out = np.zeros(ngroups, dtype=np.int64)
    np.add.at(out, inv, values.astype(np.int64))
    return out


def check_table(got, want, what, key=(), f64=()) -> None:
    """The port's result against the oracle's columns ``want`` ({name:
    values}, in the output's order): every value valid; rows in order, or
    with ``key`` both sides sorted by those columns first (the oracle's
    are already); ``f64`` columns within rtol 1e-9, every other column
    exact (strings and DECIMAL128 values as Python objects)."""
    if list(got.names) != list(want):
        fail(f"{what}: columns {list(got.names)}, oracle {list(want)}")
    n = len(next(iter(want.values())))
    if got.num_rows != n:
        fail(f"{what}: {got.num_rows} rows, oracle {n}")
    cols = {nm: c for nm, c in zip(got.names, got.columns)}
    for nm, c in cols.items():
        if not c.validity.all():
            fail(f"{what} {nm}: null results")
    order = np.arange(n)
    if key:
        keys = [cols[k].data for k in key]
        if all(k.dtype != object for k in keys):
            order = np.lexsort(keys[::-1])
        else:
            order = np.array(sorted(range(n), key=lambda i: tuple(
                k[i] for k in keys)), dtype=np.int64)
    for nm, w in want.items():
        g = cols[nm].data[order]
        w = np.asarray(w) if not isinstance(w, np.ndarray) else w
        if nm in f64:
            if not np.allclose(g, w, rtol=1e-9, atol=0):
                fail(f"{what} {nm}: {g[:5]} vs oracle {w[:5]} (rtol 1e-9)")
        elif g.dtype == object or w.dtype == object:
            if list(g) != list(w):
                fail(f"{what} {nm}: differs from the oracle (exact)")
        elif g.dtype != w.dtype or g.tobytes() != w.tobytes():
            fail(f"{what} {nm}: {g[:5]} vs oracle {w[:5]} (exact)")


def wide_oracles(tables):
    """{query: check(got)} of every phase-7 query, each answer computed
    in numpy from the host tables (keys are dense: every key column is a
    row index of its parent table)."""
    L, O, C = (host_cols(tables[t]) for t in ("lineitem", "orders",
                                                "customer"))
    for t in ("lineitem", "orders", "customer"):
        for nm, c in zip(tables[t].names, tables[t].columns):
            if not c.validity.all():
                fail(f"oracle: {t}.{nm} holds nulls")
    if not ((O["o_orderkey"] == np.arange(len(O["o_orderkey"]))).all()
            and (C["c_custkey"] == np.arange(len(C["c_custkey"]))).all()):
        fail("oracle: the primary keys are not row indices")
    n_o, n_c = len(O["o_orderkey"]), len(C["c_custkey"])
    l_ok = L["l_orderkey"]
    qty, ext, disc = L["l_quantity"], L["l_extendedprice"], L["l_discount"]
    ship = L["l_shipdate"]
    cust_of_line = O["o_custkey"][l_ok]
    nat_of_line = C["c_nationkey"][cust_of_line]
    rev_all = ext * (1.0 - disc)
    out = {}

    def grouped(keys, values, mask=None):
        """(distinct keys ascending, {name: per-group sum})."""
        k = keys if mask is None else keys[mask]
        uniq, inv = np.unique(k, return_inverse=True)
        return uniq, {nm: group_sum(inv, len(uniq),
                                    v if mask is None else v[mask])
                      for nm, v in values.items()}

    # q1: filter, two string keys, int64 and f64 sums, avg, count
    rf_codes, rf_dict = tables["lineitem"].columns[
        tables["lineitem"].names.index("l_returnflag")].encoded()
    ls_codes, ls_dict = tables["lineitem"].columns[
        tables["lineitem"].names.index("l_linestatus")].encoded()
    m = ship <= 10500
    gk = rf_codes.astype(np.int64) * len(ls_dict) + ls_codes
    uniq, sums = grouped(gk, {"sum_qty": qty, "sum_base": ext,
                              "disc": disc,
                              "cnt": np.ones(len(qty), np.int64)}, m)
    out["q1"] = lambda g, w={
        "l_returnflag": rf_dict[uniq // len(ls_dict)],
        "l_linestatus": ls_dict[uniq % len(ls_dict)],
        "sum_qty": sums["sum_qty"], "sum_base": sums["sum_base"],
        "avg_disc": sums["disc"] / sums["cnt"], "cnt": sums["cnt"]}: \
        check_table(g, w, "q1", key=("l_returnflag", "l_linestatus"),
                    f64=("sum_base", "avg_disc"))

    # q3: join orders -> lineitem, group by o_custkey
    uniq, sums = grouped(cust_of_line, {"spend": ext, "items": np.ones(
        len(ext), np.int64)})
    out["q3"] = lambda g, w={"o_custkey": uniq, "spend": sums["spend"],
                             "items": sums["items"]}: \
        check_table(g, w, "q3", key=("o_custkey",), f64=("spend",))

    # q4: customer -> orders -> lineitem, group by c_nationkey
    uniq4, s4 = grouped(nat_of_line, {"rev": ext})
    out["q4"] = lambda g, w={"c_nationkey": uniq4, "rev": s4["rev"]}: \
        check_table(g, w, "q4", key=("c_nationkey",), f64=("rev",))

    # q5: top 100 orders by price (stable: ties in row order)
    top = np.argsort(-O["o_totalprice"], kind="stable")[:100]
    out["q5"] = lambda g, w={nm: O[nm][top] for nm in tables[
        "orders"].names}: check_table(g, w, "q5")

    # q9: date filter, two joins, revenue per nation, top 10
    m9 = O["o_orderdate"][l_ok] >= 9000
    uniq9, s9 = grouped(nat_of_line, {"revenue": rev_all}, m9)
    top9 = np.argsort(-s9["revenue"], kind="stable")[:10]
    out["q9"] = lambda g, w={"c_nationkey": uniq9[top9],
                             "revenue": s9["revenue"][top9]}: \
        check_table(g, w, "q9", f64=("revenue",))

    # q10 and q17: lines below a share of their order's average quantity
    qsum = np.bincount(l_ok, weights=qty.astype(np.float64), minlength=n_o)
    qcnt = np.bincount(l_ok, minlength=n_o)
    avg_q = qsum[l_ok] / qcnt[l_ok]
    qf = qty.astype(np.float64)
    total10 = float(np.sum(ext[qf < 0.6 * avg_q]))
    out["q10"] = lambda g: check_table(g, {"total": np.array([total10])},
                                       "q10", f64=("total",))
    s17 = float(np.sum(ext[qf < 0.5 * avg_q]))
    out["q17"] = lambda g: check_table(
        g, {"avg_yearly": np.array([s17 / 7.0])}, "q17",
        f64=("avg_yearly",))

    # q11: exact decimal sum per nation, count, filter, sort desc
    nat, bal = C["c_nationkey"], C["c_acctbal"]
    uniq11, s11 = grouped(nat, {"total_bal": bal, "n": np.ones(
        n_c, np.int64)})
    keep = s11["n"] > 5
    o11 = np.argsort(-s11["total_bal"][keep], kind="stable")
    out["q11"] = lambda g, w={
        "c_nationkey": uniq11[keep][o11],
        "total_bal": np.array([int(v) for v in s11["total_bal"][keep][o11]],
                              dtype=object),
        "n": s11["n"][keep][o11]}: check_table(g, w, "q11")

    # q12: shipdate window, join orders, per return flag
    m12 = (ship >= 9000) & (ship < 10000)
    uniq12, s12 = grouped(rf_codes, {"n": np.ones(len(ship), np.int64),
                                     "p": O["o_totalprice"][l_ok]}, m12)
    out["q12"] = lambda g, w={"l_returnflag": rf_dict[uniq12],
                              "n": s12["n"],
                              "avg_price": s12["p"] / s12["n"]}: \
        check_table(g, w, "q12", key=("l_returnflag",), f64=("avg_price",))

    # q13: distribution of orders per customer
    per_cust = np.bincount(O["o_custkey"], minlength=n_c)
    per_cust = per_cust[per_cust > 0]
    uniq13, n13 = np.unique(per_cust, return_counts=True)
    out["q13"] = lambda g, w={"c_orders": uniq13.astype(np.int64),
                              "n_custs": n13.astype(np.int64)}: \
        check_table(g, w, "q13")

    # q14: windowed revenue, its sum, count and ratio
    m14 = (ship >= 9500) & (ship < 9700)
    tot14 = float(np.sum(rev_all[m14]))
    n14 = int(m14.sum())
    out["q14"] = lambda g: check_table(
        g, {"avg_rev": np.array([tot14 / n14]),
            "total_rev": np.array([tot14])}, "q14",
        f64=("avg_rev", "total_rev"))

    # q15: top 5 customers by revenue
    uniq15, s15 = grouped(cust_of_line, {"revenue": rev_all})
    top15 = np.argsort(-s15["revenue"], kind="stable")[:5]
    out["q15"] = lambda g, w={"o_custkey": uniq15[top15],
                              "revenue": s15["revenue"][top15]}: \
        check_table(g, w, "q15", f64=("revenue",))

    # q16: customers with orders, per nation
    active = np.unique(O["o_custkey"])
    uniq16, n16 = np.unique(nat[active], return_counts=True)
    out["q16"] = lambda g, w={"c_nationkey": uniq16,
                              "active_custs": n16.astype(np.int64)}: \
        check_table(g, w, "q16")

    # q18: orders over 150 units, joined with orders, top 20 by price
    sq = np.zeros(n_o, dtype=np.int64)
    np.add.at(sq, l_ok, qty)
    big = np.flatnonzero(sq > 150)
    top18 = big[np.argsort(-O["o_totalprice"][big], kind="stable")[:20]]
    out["q18"] = lambda g, w={"l_orderkey": top18.astype(np.int64),
                              "sum_qty": sq[top18],
                              "o_custkey": O["o_custkey"][top18],
                              "o_totalprice": O["o_totalprice"][top18]}: \
        check_table(g, w, "q18")

    # q19: the disjunctive predicate
    m19 = (((qty >= 1) & (qty <= 11) & (disc > 0.02))
           | ((qty >= 10) & (qty <= 20) & (disc < 0.06))
           | (L["l_returnflag"] == "R00000001"))
    rev19 = float(np.sum(rev_all[m19]))
    out["q19"] = lambda g: check_table(g, {"revenue": np.array([rev19])},
                                       "q19", f64=("revenue",))

    # q20: customers with big orders, top 10 by count (ties by custkey:
    # the group-by emits keys ascending and the sort is stable)
    nbig = np.bincount(O["o_custkey"][O["o_totalprice"] > 400000.0],
                       minlength=n_c)
    custs = np.flatnonzero(nbig)
    top20 = custs[np.lexsort((custs, -nbig[custs]))[:10]]
    names = tables["customer"].columns[
        tables["customer"].names.index("c_name")].data
    out["q20"] = lambda g, w={"c_custkey": top20.astype(np.int64),
                              "nbig": nbig[top20].astype(np.int64),
                              "c_name": names[top20],
                              "c_acctbal": bal[top20]}: \
        check_table(g, w, "q20")

    # q22: accounts above the global average, per nation
    ab = float(sum(int(v) for v in bal)) / (n_c * 100.0)
    m22 = (bal.astype(np.float64) / 100.0) > ab
    uniq22, s22 = grouped(nat, {"numcust": np.ones(n_c, np.int64),
                                "tot": bal}, m22)
    out["q22"] = lambda g, w={
        "c_nationkey": uniq22, "numcust": s22["numcust"],
        "totacctbal": np.array([int(v) for v in s22["tot"]],
                               dtype=object)}: check_table(g, w, "q22")
    return out


def run_corpus_wide(tables, profile_dir, keep=None) -> dict:
    """Every phase-7 query through ``run_case`` against its numpy oracle.
    Returns every kernel's launches summed over the counted runs."""
    from spark_rapids_tpu_torch.models.corpus import build_queries
    from spark_rapids_tpu_torch.session import TorchSession

    t0 = time.perf_counter()
    oracles = wide_oracles(tables)
    log(f"  the numpy oracles in {time.perf_counter() - t0:.2f} s (host)")
    session = TorchSession()
    queries = build_queries(session, tables)
    total, summary = {}, {}
    for name in WIDE_QUERIES:
        res = run_case(session, name, queries[name], oracles[name],
                       profile_dir, keep)
        launches = res["launches"]
        log(f"  {name}: result matches the numpy oracle (keys, counts, "
            "int64 and decimal sums and strings exact, f64 rtol 1e-9)")
        if name in NO_F64_SUMS and launches["onehot_partials"]:
            fail(f"{name}: an integer or decimal sum launched "
                 "onehot_partials (the f64 route)")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        summary[name] = dict(res["stats"], launches={
            k: v for k, v in launches.items() if v})
    for k in ("onehot_partials", "gather_compact", "sort_with_payload"):
        if not total.get(k):
            fail(f"phase 7 launched no {k}")
    log("  phase-7 summary: " + json.dumps(summary))
    return total


# ---------------------------------------------------------------------------
# phase 8: the window and exchange queries (q6, q21, q7)
# ---------------------------------------------------------------------------

#: the corpus queries phase 8 runs, with the radix sorts each warm run
#: makes: q6's group limit and its window over the survivors, q21's window
#: (its pruning Project keeps the group limit out, as in the reference);
#: q7's group-by has a dictionary key and sorts nothing
WINDOW_QUERIES = {"q6": 2, "q7": 0, "q21": 1}


def stable_row_number(part, order):
    """row_number over ``part`` ordered by ``order``, ties by input row
    (the port's sorts are stable), in input row order (int32)."""
    n = len(part)
    idx = np.lexsort((np.arange(n), order, part))
    ps = part[idx]
    start = np.r_[True, ps[1:] != ps[:-1]]
    pos = np.arange(n)
    seg = np.maximum.accumulate(np.where(start, pos, 0))
    rn = np.empty(n, dtype=np.int32)
    rn[idx] = pos - seg + 1
    return rn


def window_oracles(tables, keyed: bool = False):
    """{query: check(got)} of q6, q7 and q21 in numpy: stable ranking for
    the windows (the kept rows in input order, every column exact), exact
    counts and int64 sums for q7. With ``keyed`` the windows' rows may
    come in another order (input in several batches: phase 15's files)
    and are compared sorted by their unique key, as the oracle's are."""
    O, C = host_cols(tables["orders"]), host_cols(tables["customer"])
    out = {}
    rn = stable_row_number(O["o_custkey"], O["o_totalprice"])
    keep = np.flatnonzero(rn <= 3)
    want = {nm: O[nm][keep] for nm in tables["orders"].names}
    want["rn"] = rn[keep]
    out["q6"] = lambda g, w=want: check_table(
        g, w, "q6", key=("o_orderkey",) if keyed else ())
    rn = stable_row_number(C["c_nationkey"], C["c_custkey"])
    keep = np.flatnonzero(rn <= 2)
    want = {"c_nationkey": C["c_nationkey"][keep],
            "c_custkey": C["c_custkey"][keep], "rn": rn[keep]}
    out["q21"] = lambda g, w=want: check_table(
        g, w, "q21", key=("c_custkey",) if keyed else ())
    li = tables["lineitem"]
    codes, dictionary = li.columns[li.names.index("l_returnflag")].encoded()
    qty = host_cols(li)["l_quantity"].astype(np.int64)
    counts = np.bincount(codes, minlength=len(dictionary))
    sums = np.zeros(len(dictionary), dtype=np.int64)
    np.add.at(sums, codes, qty)
    present = np.flatnonzero(counts)
    want = {"l_returnflag": np.asarray(dictionary, dtype=object)[present],
            "c": counts[present].astype(np.int64), "s": sums[present]}
    out["q7"] = lambda g, w=want: check_table(g, w, "q7",
                                             key=("l_returnflag",))
    return out


def check_partition_ids(tables) -> None:
    """Murmur3 partition ids on the card (HashPartitioner over every row
    of the scanned batch) against the port's numpy murmur3
    (``murmur3_hash_host``, Python integers) over the live rows: q7's
    l_returnflag at 8 partitions, o_custkey at 8 and 200."""
    from spark_rapids_tpu_torch.columnar import BucketPolicy
    from spark_rapids_tpu_torch.execs.basic import TpuScanExec
    from spark_rapids_tpu_torch.ops.expr import col
    from spark_rapids_tpu_torch.shuffle.hashing import murmur3_hash_host
    from spark_rapids_tpu_torch.shuffle.partitioning import HashPartitioner
    for tname, cname, nparts in (("lineitem", "l_returnflag", (8,)),
                                 ("orders", "o_custkey", (8, 200))):
        t = tables[tname]
        hc = t.columns[t.names.index(cname)]
        scan = TpuScanExec([t], DEV, BucketPolicy())
        batch = next(scan.execute())
        key = col(cname).bind(scan.output_schema())
        t0 = time.perf_counter()
        if hc.dtype.simple_string() == "string":
            inv, uniq = hc.encoded()
        else:
            uniq, inv = np.unique(hc.data, return_inverse=True)
        hashes = np.array([murmur3_hash_host([(v, True, hc.dtype)])
                           for v in uniq], dtype=np.int64)
        host_s = time.perf_counter() - t0
        for n in nparts:
            got = HashPartitioner([key], n).partition_ids(batch)
            torch.cuda.synchronize()
            want = np.mod(hashes, n)[inv].astype(np.int32)
            live = got[:t.num_rows].cpu().numpy()
            if not np.array_equal(live, want):
                bad = int(np.flatnonzero(live != want)[0])
                fail(f"murmur3 partition ids of {cname} (n={n}) row {bad}: "
                     f"{live[bad]} vs numpy {want[bad]}")
            log(f"  murmur3 partition ids of {cname} at n={n}: "
                f"{t.num_rows} rows in a {batch.capacity}-row batch equal "
                f"the numpy murmur3 ({len(uniq)} distinct keys hashed on "
                f"the host in {host_s:.2f} s); rows per partition "
                f"{np.bincount(want, minlength=n)[:8].tolist()}"
                f"{'...' if n > 8 else ''}")


def run_corpus_window(tables, profile_dir, keep=None) -> dict:
    """q6, q7 and q21 through ``run_case`` against their numpy oracles, and
    the murmur3 partition ids against the numpy murmur3. Returns every
    kernel's launches summed over the counted runs."""
    from spark_rapids_tpu_torch.models.corpus import build_queries
    from spark_rapids_tpu_torch.session import TorchSession

    t0 = time.perf_counter()
    oracles = window_oracles(tables)
    log(f"  the numpy oracles in {time.perf_counter() - t0:.2f} s (host)")
    check_partition_ids(tables)
    session = TorchSession()
    queries = build_queries(session, tables)
    total, summary = {}, {}
    for name, sorts in WINDOW_QUERIES.items():
        res = run_case(session, name, queries[name], oracles[name],
                       profile_dir, keep)
        launches = res["launches"]
        log(f"  {name}: result matches the numpy oracle (stable ranks, "
            "counts and int64 sums exact)")
        if launches["sort_with_payload"] != sorts:
            fail(f"{name}: sort_with_payload launched "
                 f"{launches['sort_with_payload']} times, expected {sorts}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        summary[name] = dict(res["stats"], launches={
            k: v for k, v in launches.items() if v})
    for k in ("gather_compact", "sort_with_payload"):
        if not total.get(k):
            fail(f"phase 8 launched no {k}")
    log("  phase-8 summary: " + json.dumps(summary))
    return total


# ---------------------------------------------------------------------------
# phase 9: the SQL front end (TorchSession.sql)
# ---------------------------------------------------------------------------

#: SQL forms (Q3_SQL as "TPC-H q3 ...") whose f64 sums run over more
#: than 32 segments, through ``index_add_``, whose atomics add in another
#: order from run to run: held to their DSL forms within rtol 1e-9; every
#: other SQL form bit for bit
SQL_RTOL = ("q3", "q15", "TPC-H q3 dense", "TPC-H q3 sparse")

#: the conditional query over the corpus's lineitem: two counted CASE
#: sums split on l_discount (TPC-H q12's high/low line counts), a
#: string-valued CASE over l_returnflag as the group key, COALESCE over
#: IF, and GREATEST
CONDITIONAL_SQL = """
SELECT CASE WHEN l_returnflag = 'R00000000' THEN 'flag0'
            WHEN l_returnflag = 'R00000001' THEN l_linestatus
            ELSE 'rest' END AS flag_class,
       SUM(CASE WHEN l_discount > 0.05 THEN 1 ELSE 0 END) AS high_lines,
       SUM(CASE WHEN l_discount <= 0.05 THEN 1 ELSE 0 END) AS low_lines,
       SUM(COALESCE(IF(l_discount < 0.08, l_extendedprice, NULL), 0.0))
           AS kept_price,
       MAX(GREATEST(l_extendedprice * l_discount, l_quantity)) AS top,
       COUNT(*) AS n
FROM lineitem
GROUP BY 1
ORDER BY 1
"""


def same_table(got, want, what, rtol) -> None:
    """The SQL form's result against its DSL form's: names, rows, types
    and validity exact; values bit for bit over valid rows (strings and
    DECIMAL128 by value), floats within ``rtol`` where it is given."""
    if list(got.names) != list(want.names) or got.num_rows != want.num_rows:
        fail(f"{what}: {list(got.names)} x {got.num_rows} rows, DSL form "
             f"{list(want.names)} x {want.num_rows}")
    for name, g, w in zip(got.names, got.columns, want.columns):
        if type(g.dtype) is not type(w.dtype) or not np.array_equal(
                g.validity, w.validity):
            fail(f"{what} {name}: type or validity differs")
        gv, wv = g.data[g.validity], w.data[w.validity]
        if gv.dtype == object or wv.dtype == object:
            ok = list(gv) == list(wv)
        elif rtol and gv.dtype.kind == "f":
            ok = np.allclose(gv, wv, rtol=rtol, atol=0, equal_nan=True)
        else:
            ok = gv.dtype == wv.dtype and gv.tobytes() == wv.tobytes()
        if not ok:
            fail(f"{what} {name}: values differ "
                 f"({'rtol ' + str(rtol) if rtol else 'bitwise'})")


def run_sql_case(session, name, text, dsl, profile_dir) -> dict:
    """One SQL form through ``run_case``: each result against the oracle
    of its DSL form (``dsl['check']``) and against the DSL form's result;
    the counted run's launches must equal the DSL form's. Adds the host
    time of ``session.sql(text)`` alone (parse, analyse, lower)."""
    front = []

    def build():
        t0 = time.perf_counter()
        df = session.sql(text)
        front.append(time.perf_counter() - t0)
        return df

    rtol = 1e-9 if name in SQL_RTOL else 0.0

    def check(got):
        dsl["check"](got)
        same_table(got, dsl["result"], f"{name} SQL", rtol)

    res = run_case(session, f"{name} SQL", build, check, profile_dir)
    launches = res["launches"]
    if launches != dsl["launches"]:
        fail(f"{name} SQL launched {launches}, its DSL form "
             f"{dsl['launches']}")
    front_ms = [f * 1e3 for f in front[:5]]
    # the two forms in turns (DSL, SQL, SQL, DSL, ...), and the DSL
    # form's host syncs, in this phase beside the SQL form's
    paired = {"dsl": [], "sql": []}
    for order in (("dsl", "sql"), ("sql", "dsl")) * 2:
        for form in order:
            t0 = time.perf_counter()
            (dsl["build"] if form == "dsl" else build)().collect_table()
            torch.cuda.synchronize()
            paired[form].append(time.perf_counter() - t0)
    with host_sync_count() as box:
        dsl["build"]().collect_table()
    torch.cuda.synchronize()
    stats = dict(res["stats"], dsl_warm_ms=dsl["warm_ms"],
                 paired_sql_ms=round(statistics.median(paired["sql"]) * 1e3,
                                     2),
                 paired_dsl_ms=round(statistics.median(paired["dsl"]) * 1e3,
                                     2),
                 dsl_syncs=box["syncs"],
                 front_cold_ms=round(front_ms[0], 3),
                 front_ms=round(statistics.median(front_ms[1:]), 3),
                 launches={k: v for k, v in launches.items() if v})
    log(f"  {name} SQL: warm {stats['warm_ms']} ms (the DSL form's "
        f"{dsl['warm_ms']} ms in its phase); in turns SQL "
        f"{stats['paired_sql_ms']} ms, DSL {stats['paired_dsl_ms']} ms "
        f"(medians of 4); host syncs SQL {stats['syncs']}, DSL "
        f"{box['syncs']}; front end (parse, analyse, lower) "
        f"{stats['front_ms']} ms warm, {stats['front_cold_ms']} ms cold; "
        f"result equals the DSL form's "
        f"({'rtol 1e-9' if rtol else 'bitwise'}) and its numpy oracle; "
        "launches equal the DSL form's")
    return {"launches": launches, "stats": stats}


def conditional_oracle(lineitem):
    """CONDITIONAL_SQL in numpy, on the dictionary codes of l_returnflag
    and l_linestatus: counts and int64 sums exact, MAX bit for bit,
    kept_price rtol 1e-9."""
    cols = host_cols(lineitem)
    rf_codes, rf_dict = lineitem.columns[
        lineitem.names.index("l_returnflag")].encoded()
    ls_codes, ls_dict = lineitem.columns[
        lineitem.names.index("l_linestatus")].encoded()
    # the class of each (flag, status) code pair, then each row's class
    pair = {}
    for i, f in enumerate(rf_dict):
        for j, st in enumerate(ls_dict):
            pair[(i, j)] = ("flag0" if f == "R00000000"
                            else st if f == "R00000001" else "rest")
    classes = sorted(set(pair.values()))
    table = np.zeros((len(rf_dict), len(ls_dict)), dtype=np.int64)
    for (i, j), c in pair.items():
        table[i, j] = classes.index(c)
    inv = table[rf_codes, ls_codes]
    k = len(classes)
    disc, price = cols["l_discount"], cols["l_extendedprice"]
    qty = cols["l_quantity"].astype(np.float64)
    prod = price * disc
    top_row = np.where(qty > prod, qty, prod)
    top = np.full(k, -np.inf)
    np.maximum.at(top, inv, top_row)
    want = {
        "flag_class": np.array(classes, dtype=object),
        "high_lines": np.bincount(inv[disc > 0.05], minlength=k)
        .astype(np.int64),
        "low_lines": np.bincount(inv[disc <= 0.05], minlength=k)
        .astype(np.int64),
        "kept_price": np.bincount(inv, weights=np.where(
            disc < 0.08, price, 0.0), minlength=k),
        "top": top,
        "n": np.bincount(inv, minlength=k).astype(np.int64)}
    present = want["n"] > 0
    want = {n: v[present] for n, v in want.items()}
    return lambda g: check_table(g, want, "conditional query",
                                 f64=("kept_price",))


def run_sql(tables, dsl, profile_dir) -> dict:
    """Phase 9: the 22 corpus texts over temp views of the phase 6-8
    tables, the conditional query, Q1_SQL and Q3_SQL (dense, and sparse
    with the default 4 attempts) over the phase 4-5 tables, each through
    ``run_sql_case`` against its DSL form (``dsl``: what phases 4-8
    kept). Returns every kernel's launches summed over the counted
    runs."""
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models.corpus import (
        CORPUS,
        build_sql_queries,
        sql_texts,
    )
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.runtime import speculation
    from spark_rapids_tpu_torch.session import TorchSession

    total, summary = {}, {}

    def add(name, res):
        for k, v in res["launches"].items():
            total[k] = total.get(k, 0) + v
        summary[name] = res["stats"]

    # the corpus first: the speculation blocklist stands as phases 6-8
    # saw it
    session = TorchSession()
    build_sql_queries(session, tables)
    texts = sql_texts()
    for name in CORPUS:
        add(name, run_sql_case(session, name, texts[name], dsl[name], None))

    t0 = time.perf_counter()
    check = conditional_oracle(tables["lineitem"])
    log(f"  conditional query: the numpy oracle in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    res = run_case(session, "conditional query",
                   lambda: session.sql(CONDITIONAL_SQL), check, profile_dir)
    log("  conditional query: result matches the numpy oracle (counts, "
        "int64 sums and MAX exact, kept_price rtol 1e-9)")
    for k in ("onehot_partials", "fused_minmax", "gather_compact",
              "sort_with_payload"):
        if not res["launches"][k]:
            fail(f"the conditional query launched no {k}")
    add("conditional query", dict(res, stats=dict(
        res["stats"], launches={k: v for k, v in res["launches"].items()
                                if v})))

    # TPC-H: each form after clearing the blocklist, as phases 4-5 ran it
    forms = (("TPC-H q1", "TPC-H q1", tpch.Q1_SQL, ("lineitem",)),
             ("TPC-H q3 dense", "q3 dense", tpch.Q3_SQL,
              ("customer", "orders", "lineitem")),
             ("TPC-H q3 sparse", "q3 sparse", tpch.Q3_SQL,
              ("customer", "orders", "lineitem")))
    for name, dsl_name, text, views in forms:
        speculation.clear_blocklist()
        sess = TorchSession()
        for view, table in zip(views, dsl[dsl_name]["tables"]):
            from_host_table(table, sess).create_or_replace_temp_view(view)
        add(name, run_sql_case(sess, name, text.format(segment="BUILDING"),
                               dsl[dsl_name], None))
    for k in ("onehot_partials", "fused_minmax", "gather_compact",
              "sort_with_payload", "probe_rowids"):
        if not total.get(k):
            fail(f"phase 9 launched no {k}")
    log("  phase-9 summary: " + json.dumps(summary))
    return total


# ---------------------------------------------------------------------------
# phase 10: the join types
# ---------------------------------------------------------------------------

#: the join query set: SQL texts in the shapes Spark users write for
#: TPC-H (q13's outer count, q18's IN, q22's NOT EXISTS and scalar AVG,
#: q15's = MAX, q16's NOT IN, a period-over-period full outer join, q12's
#: date test in the ON clause, a bare LIMIT, a CROSS JOIN with a one-row
#: table, a filtered left outer join); ``{cut}`` is J7's blocklist cut
#: (``join_texts``)
JOIN_QUERIES = {
    "J1": "SELECT c_count, COUNT(*) AS custdist FROM (SELECT c_custkey, "
          "COUNT(o_orderkey) AS c_count FROM customer LEFT OUTER JOIN orders "
          "ON c_custkey = o_custkey GROUP BY c_custkey) c_orders GROUP BY "
          "c_count ORDER BY custdist DESC, c_count DESC",
    "J2": "SELECT c_count, COUNT(*) AS custdist FROM (SELECT c_custkey, "
          "COUNT(o_orderkey) AS c_count FROM orders RIGHT OUTER JOIN "
          "customer ON c_custkey = o_custkey GROUP BY c_custkey) c_orders "
          "GROUP BY c_count ORDER BY custdist DESC, c_count DESC",
    "J3": "SELECT o_orderkey, o_custkey, o_totalprice FROM orders WHERE "
          "o_orderkey IN (SELECT l_orderkey FROM lineitem GROUP BY "
          "l_orderkey HAVING SUM(l_quantity) > 150) ORDER BY o_totalprice "
          "DESC, o_orderkey LIMIT 100",
    "J4": "SELECT c_nationkey, COUNT(*) AS numcust, SUM(c_acctbal) AS "
          "totacctbal FROM customer LEFT ANTI JOIN orders ON c_custkey = "
          "o_custkey GROUP BY c_nationkey ORDER BY c_nationkey",
    "J5": "SELECT c_nationkey, COUNT(*) AS numcust, SUM(c_acctbal) AS "
          "totacctbal FROM customer WHERE c_acctbal > (SELECT AVG(c_acctbal) "
          "FROM customer WHERE c_acctbal > 0.0) GROUP BY c_nationkey ORDER BY "
          "c_nationkey",
    "J6": "SELECT o_custkey, n FROM (SELECT o_custkey, COUNT(*) AS n FROM "
          "orders GROUP BY o_custkey) r WHERE n = (SELECT MAX(n) FROM (SELECT "
          "o_custkey, COUNT(*) AS n FROM orders GROUP BY o_custkey) r2) ORDER "
          "BY o_custkey",
    "J7": "SELECT COUNT(*) AS n, SUM(o_totalprice) AS total FROM orders "
          "WHERE o_custkey NOT IN (SELECT c_custkey FROM customer WHERE "
          "c_acctbal > {cut})",
    "J8": "SELECT COUNT(*) AS n, COUNT(a_cust) AS na, COUNT(b_cust) AS nb, "
          "SUM(a_n) AS sa, SUM(b_n) AS sb FROM (SELECT o_custkey AS a_cust, "
          "COUNT(*) AS a_n FROM orders WHERE o_orderdate < DATE '1995-06-01' "
          "GROUP BY o_custkey) a FULL OUTER JOIN (SELECT o_custkey AS b_cust, "
          "COUNT(*) AS b_n FROM orders WHERE o_orderdate >= DATE '1995-06-01' "
          "AND o_totalprice > 300000.0 GROUP BY o_custkey) b ON a_cust = "
          "b_cust",
    "J9": "SELECT l_returnflag, COUNT(*) AS n, SUM(l_quantity) AS q FROM "
          "lineitem JOIN orders ON l_orderkey = o_orderkey AND l_shipdate > "
          "o_orderdate GROUP BY l_returnflag ORDER BY l_returnflag",
    "J10": "SELECT l_orderkey, l_quantity FROM lineitem WHERE l_quantity > "
           "45 LIMIT 1000",
    "J11": "SELECT c_custkey, n_lo FROM customer CROSS JOIN (SELECT "
           "MIN(o_orderdate) AS n_lo FROM orders) m WHERE c_nationkey = 3 "
           "ORDER BY c_custkey LIMIT 5",
    "J12": "SELECT l_returnflag, COUNT(*) AS n, COUNT(o_orderkey) AS "
           "matched, SUM(l_quantity) AS qty FROM lineitem LEFT OUTER JOIN "
           "(SELECT o_orderkey FROM orders WHERE o_orderdate < DATE "
           "'1995-06-01') o ON l_orderkey = o_orderkey GROUP BY l_returnflag "
           "ORDER BY l_returnflag",
}
#: the forms beside the dense texts: J3 and J12 over o_orderkey and
#: l_orderkey mapped by ``sparse_keys`` (their unique builds then take the
#: hash probe), J1 and J8 with their builds sub-partitioned
SPARSE_JOIN_QUERIES = ("J3", "J12")
SPARSE_JOIN_KEYS = ("o_orderkey", "l_orderkey")
#: the sparse forms' conf: at sf 10 their builds (489,061 and 1,067,916
#: unique keys in 2^23-slot tables) leave 3 and 118 rows homeless at the
#: default 4 attempts, which replays them onto the sort-based probe (as
#: sparse q3's join 1); at 8 attempts every row places. Likely cause:
#: ``sparse_keys``'s multiplier is also the probe's first salt
#: (kernels/hashprobe.py::_SALTS), not the tables' 0.06-0.14 load
SPARSE_JOIN_CONF = {"spark.rapids.tpu.kernels.hashprobe.attempts": "8"}
SUBPARTITIONED_JOIN_QUERIES = ("J1", "J8")
#: ``spark.rapids.sql.join.subPartition.targetBytes`` of the sub-partitioned
#: forms at sf 10: J1's build (orders' two key columns, 2^22 slots, 72 MiB
#: of device columns) splits at 8 MiB; J8's (the late-order aggregate over
#: o_custkey's 2^18 domain slots, two int64 columns: 4.5 MiB) at 2 MiB
SUBPARTITION_BYTES = {"J1": 8 << 20, "J8": 2 << 20}


def join_texts(sf: float) -> dict:
    """JOIN_QUERIES with J7's cut filled in for ``sf``: 9995.0 at sf 10
    (about 113 customers), 9900.0 below it (11 customers at sf 0.02,
    seed 0)."""
    cut = "9995.0" if sf >= 10 else "9900.0"
    return {k: v.replace("{cut}", cut) for k, v in JOIN_QUERIES.items()}


def sparse_join_tables(tables, mapper):
    """``tables`` with o_orderkey and l_orderkey mapped by ``mapper``
    (int64 numpy array -> int64 numpy array)."""
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    out = {}
    for name, t in tables.items():
        cols = [HostColumn(c.dtype, mapper(c.data.astype(np.int64)),
                           c.validity) if n in SPARSE_JOIN_KEYS else c
                for n, c in zip(t.names, t.columns)]
        out[name] = HostTable(t.names, cols)
    return out


def join_oracles(tables, sf: float):
    """{query: check(got)} of J1-J12 in numpy over the dense host tables
    (every primary key is its row index; no column holds a null, so SQL's
    null rules never fire here: COUNT(col) counts every row, NOT IN is a
    plain set difference): counts, keys, int64 and decimal sums, dates
    and strings exact, J7's f64 SUM rtol 1e-9."""
    import datetime as dt
    L, O, C = (host_cols(tables[t]) for t in ("lineitem", "orders",
                                                "customer"))
    for t in ("lineitem", "orders", "customer"):
        for nm, c in zip(tables[t].names, tables[t].columns):
            if not c.validity.all():
                fail(f"join oracle: {t}.{nm} holds nulls")
    n_o, n_c = len(O["o_orderkey"]), len(C["c_custkey"])
    if not ((O["o_orderkey"] == np.arange(n_o)).all()
            and (C["c_custkey"] == np.arange(n_c)).all()):
        fail("join oracle: the primary keys are not row indices")
    i64 = np.int64
    cut_day = (dt.date(1995, 6, 1) - dt.date(1970, 1, 1)).days
    o_cust, o_date, o_price = O["o_custkey"], O["o_orderdate"], \
        O["o_totalprice"]
    acct = C["c_acctbal"].astype(i64)  # decimal(12,2), unscaled
    li = tables["lineitem"]
    rf_codes, rf_dict = li.columns[li.names.index("l_returnflag")].encoded()
    flags = np.asarray(rf_dict, dtype=object)
    l_ok, l_qty = L["l_orderkey"], L["l_quantity"].astype(i64)
    out = {}

    def by_flag(mask, *values):
        """Per l_returnflag (in dictionary order, present flags only):
        the row count and each value's int64 sum over ``mask``."""
        k = len(flags)
        n = np.bincount(rf_codes[mask], minlength=k).astype(i64)
        sums = []
        for v in values:
            acc = np.zeros(k, dtype=i64)
            np.add.at(acc, rf_codes[mask], v[mask])
            sums.append(acc)
        keep = n > 0
        return flags[keep], n[keep], [x[keep] for x in sums]

    def dec(values):
        return np.array([int(v) for v in values], dtype=object)

    # J1/J2: orders per customer (0 without), then customers per count
    per_cust = np.bincount(o_cust, minlength=n_c).astype(i64)
    c_count, custdist = np.unique(per_cust, return_counts=True)
    order = np.lexsort((-c_count, -custdist))
    want = {"c_count": c_count[order].astype(i64),
            "custdist": custdist[order].astype(i64)}
    out["J1"] = out["J2"] = lambda g, w=want: check_table(g, w, "J1/J2")
    out["J3"] = j3_oracle(tables)
    # J4: customers without an order, per nation
    nation = C["c_nationkey"]

    def per_nation(mask):
        k = int(nation.max()) + 1
        n = np.bincount(nation[mask], minlength=k).astype(i64)
        s = np.zeros(k, dtype=i64)
        np.add.at(s, nation[mask], acct[mask])
        keep = np.flatnonzero(n)
        return {"c_nationkey": keep.astype(i64), "numcust": n[keep],
                "totacctbal": dec(s[keep])}

    want = per_nation(per_cust == 0)
    out["J4"] = lambda g, w=want: check_table(g, w, "J4")
    # J5: above the average positive balance (as the port computes it:
    # the exact sum as a double over count x 100)
    val = acct / 100.0
    pos = val > 0.0
    avg = float(acct[pos].sum()) / (float(pos.sum()) * 100.0)
    want = per_nation(val > avg)
    out["J5"] = lambda g, w=want: check_table(g, w, "J5")
    # J6: the customers with the most orders
    have = np.flatnonzero(per_cust)
    top = have[per_cust[have] == per_cust[have].max()]
    want = {"o_custkey": top.astype(i64), "n": per_cust[top]}
    out["J6"] = lambda g, w=want: check_table(g, w, "J6")
    # J7: orders of customers outside the blocklist
    cut = float(join_texts(sf)["J7"].rsplit(">", 1)[1].strip(" )"))
    blocked = np.zeros(n_c, dtype=bool)
    blocked[C["c_custkey"][val > cut]] = True
    keep = ~blocked[o_cust]
    want = {"n": np.array([keep.sum()], dtype=i64),
            "total": np.array([o_price[keep].sum()])}
    out["J7"] = lambda g, w=want: check_table(g, w, "J7", f64=("total",))
    log(f"  J7: {int(blocked.sum())} customers in the NOT IN list "
        f"(c_acctbal > {cut})")
    # J8: early order counts against late large ones, full outer
    a = np.bincount(o_cust[o_date < cut_day], minlength=n_c)
    b = np.bincount(o_cust[(o_date >= cut_day) & (o_price > 300000.0)],
                    minlength=n_c)
    want = {"n": [int(((a > 0) | (b > 0)).sum())], "na": [int((a > 0).sum())],
            "nb": [int((b > 0).sum())], "sa": [int(a.sum())],
            "sb": [int(b.sum())]}
    want = {k: np.array(v, dtype=i64) for k, v in want.items()}
    out["J8"] = lambda g, w=want: check_table(g, w, "J8")
    # J9: lines shipped after their order date, per flag
    f, n, (q,) = by_flag(L["l_shipdate"] > o_date[l_ok], l_qty)
    want = {"l_returnflag": f, "n": n, "q": q}
    out["J9"] = lambda g, w=want: check_table(g, w, "J9")
    # J10: the first 1000 lines with more than 45 items, in row order
    rows = np.flatnonzero(l_qty > 45)[:1000]
    want = {"l_orderkey": l_ok[rows], "l_quantity": L["l_quantity"][rows]}
    out["J10"] = lambda g, w=want: check_table(g, w, "J10")
    # J11: nation 3's first five customers beside the earliest order date
    five = C["c_custkey"][nation == 3][:5]
    want = {"c_custkey": five,
            "n_lo": np.full(len(five), o_date.min(), dtype=o_date.dtype)}
    out["J11"] = lambda g, w=want: check_table(g, w, "J11")
    # J12: every line, those of early orders counted, per flag
    ones = np.ones(len(l_ok), dtype=bool)
    f, n, (matched, qty) = by_flag(ones, (o_date[l_ok] < cut_day).astype(
        i64), l_qty)
    want = {"l_returnflag": f, "n": n, "matched": matched, "qty": qty}
    out["J12"] = lambda g, w=want: check_table(g, w, "J12")
    return out


def j3_oracle(tables, key_map=None):
    """J3's check: the orders whose lines sum past 150 items, the first
    100 by o_totalprice descending, then o_orderkey (mapped by
    ``key_map`` for the sparse form: o_totalprice ties, as the values
    clipped at the top of its range, break by the mapped key)."""
    L, O = host_cols(tables["lineitem"]), host_cols(tables["orders"])
    okeys = O["o_orderkey"] if key_map is None else key_map(
        O["o_orderkey"].astype(np.int64))
    qsum = np.bincount(L["l_orderkey"], weights=L["l_quantity"],
                       minlength=len(okeys))
    sel = np.flatnonzero(qsum > 150)
    price = O["o_totalprice"]
    top = sel[np.lexsort((okeys[sel], -price[sel]))][:100]
    want = {"o_orderkey": okeys[top], "o_custkey": O["o_custkey"][top],
            "o_totalprice": price[top]}
    what = "J3" if key_map is None else "J3 sparse"
    return lambda g: check_table(g, want, what)


def run_joins(tables, sf: float, profile_dir) -> dict:
    """Phase 10: J1-J12 over temp views of phases 6-9's tables, J3 and J12
    again over o_orderkey/l_orderkey mapped by ``sparse_keys`` on the card
    at 8 hash-probe attempts (which must reach ``probe_rowids``), and J1
    and J8 with their builds
    sub-partitioned (``SUBPARTITION_BYTES``; ``subPartitions`` above 1),
    and J7 with the aggregate's input coalesce at a 1-byte target (every
    nested-loop tile its own partial, then the merge), each through
    ``run_case`` against its numpy oracle (sparse J3's over the mapped
    keys, sparse J12 against the dense result bit for bit), the
    sub-partitioned ones against their unsplit results bit for bit.
    ``--profile`` traces J1,
    J7, J8 and J9. Returns every kernel's launches summed over the counted
    runs."""
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.session import TorchSession

    def on_card(a):
        return sparse_keys(torch.from_numpy(a).to(DEV)).cpu().numpy()

    t0 = time.perf_counter()
    oracles = join_oracles(tables, sf)
    log(f"  the numpy oracles in {time.perf_counter() - t0:.2f} s (host)")
    t0 = time.perf_counter()
    sparse = sparse_join_tables(tables, on_card)
    log(f"  o_orderkey and l_orderkey mapped by sparse_keys on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    texts = join_texts(sf)
    total, summary, results = {}, {}, {}

    def session_over(tabs, conf=None):
        sess = TorchSession(conf)
        for name, t in tabs.items():
            from_host_table(t, sess).create_or_replace_temp_view(name)
        return sess

    def run(sess, name, query, check):
        prof = profile_dir if name in ("J1", "J7", "J8", "J9") else None
        res = run_case(sess, name, lambda: sess.sql(texts[query]), check,
                       prof)
        results[name] = res
        for k, v in res["launches"].items():
            total[k] = total.get(k, 0) + v
        m = sess.last_metrics()
        summary[name] = dict(res["stats"], launches={
            k: v for k, v in res["launches"].items() if v},
            metrics={k: v for k, v in m.items() if k in (
                "directJoinBatches", "hashProbeBatches", "subPartitions",
                "nestedLoopTiles", "concatBatches", "partialAggBatches",
                "probeBatches")})
        return res, m

    dense = session_over(tables)
    kept = {}
    for q in JOIN_QUERIES:
        def check(g, q=q):
            oracles[q](g)
            kept[q] = g
        run(dense, q, q, check)
        log(f"  {q}: result matches the numpy oracle")
    # the sparse forms: J3's rows (o_orderkey among them) against its
    # oracle over the mapped keys, J12's (no key column) against the dense
    # result bit for bit
    sparse_checks = {
        "J3": j3_oracle(tables, on_card),
        "J12": lambda g: same_table(g, kept["J12"], "J12 sparse", 0.0)}
    for q in SPARSE_JOIN_QUERIES:
        sess = session_over(sparse, SPARSE_JOIN_CONF)
        res, _ = run(sess, f"{q} sparse", q, sparse_checks[q])
        if not res["launches"]["probe_rowids"]:
            fail(f"{q} sparse launched no probe_rowids")
        log(f"  {q} sparse: matches ({'its numpy oracle over the mapped '
            'keys' if q == 'J3' else 'the dense result bit for bit'}); "
            f"probe_rowids launched {res['launches']['probe_rowids']} times")
    for q in SUBPARTITIONED_JOIN_QUERIES:
        sess = session_over(tables, {
            "spark.rapids.sql.join.subPartition.targetBytes":
                str(SUBPARTITION_BYTES[q])})
        _, m = run(sess, f"{q} sub-partitioned", q, lambda g, q=q: same_table(
            g, kept[q], f"{q} sub-partitioned", 0.0))
        if m.get("subPartitions", 0) <= 1:
            fail(f"{q} sub-partitioned: subPartitions {m.get('subPartitions')}")
        log(f"  {q} sub-partitioned: {m['subPartitions']} partitions, equal "
            "to the unsplit result bit for bit")
    # the aggregate's input coalesce (1 GiB) concatenates J7's tiles into
    # one batch; at a 1-byte target each tile is its own partial, and the
    # streaming merge runs on the card against the same oracle
    from spark_rapids_tpu_torch.execs import basic as xbasic
    target, xbasic.BATCH_SIZE_BYTES = xbasic.BATCH_SIZE_BYTES, 1
    try:
        _, m = run(session_over(tables), "J7 per-tile partials", "J7",
                   oracles["J7"])
    finally:
        xbasic.BATCH_SIZE_BYTES = target
    if m.get("partialAggBatches") != m.get("nestedLoopTiles"):
        fail(f"J7 per-tile partials: {m.get('partialAggBatches')} partials "
             f"over {m.get('nestedLoopTiles')} tiles")
    log(f"  J7 per-tile partials: {m['partialAggBatches']} partials merged, "
        "matches the numpy oracle")
    for q, kernel in (("J6", "fused_minmax"), ("J11", "fused_minmax"),
                      ("J7", "onehot_partials")):
        if not results[q]["launches"][kernel]:
            fail(f"{q} launched no {kernel}")
    for k in ("onehot_partials", "fused_minmax", "gather_compact",
              "sort_with_payload", "probe_rowids"):
        if not total.get(k):
            fail(f"phase 10 launched no {k}")
    log("  phase-10 summary: " + json.dumps(summary))
    return total


# ---------------------------------------------------------------------------
# phase 11: the operator queries (decimal arithmetic, MIN/MAX of every
# type, FIRST/LAST, UNION, range, sample and cache)
# ---------------------------------------------------------------------------

#: the corpus q1's shipdate cutoff (days since 1970), O1's and O7's
OPS_CUTOFF_DAY = 10500
#: O6's range: 64 batches of 2^20 rows (512 MiB of ids)
OPS_RANGE_ROWS = 1 << 26
#: O8's cached filter
OPS_CACHE_PRICE = 250000.0


def _iso(day: int) -> str:
    import datetime as dt
    return (dt.date(1970, 1, 1) + dt.timedelta(days=day)).isoformat()


#: the SQL texts of the operator query set: O1 is TPC-H q1 as the
#: specification writes it (the integer 1 in its arithmetic) over the
#: DECIMAL(15,2) view; O2 the MIN/MAX of every type; O4 the UNIONs; O6b
#: a SELECT without FROM
OPS_SQL = {
    "O1": f"""
SELECT l_returnflag, l_linestatus,
       SUM(l_quantity) AS sum_qty,
       SUM(l_extendedprice) AS sum_base_price,
       SUM(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
       SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
       AVG(l_quantity) AS avg_qty,
       AVG(l_extendedprice) AS avg_price,
       AVG(l_discount) AS avg_disc,
       COUNT(*) AS count_order
FROM lineitem_dec
WHERE l_shipdate <= DATE '{_iso(OPS_CUTOFF_DAY)}'
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus""",
    "O2": """
SELECT l_returnflag, l_linestatus,
       MIN(CAST(l_quantity AS TINYINT)) AS min_q8,
       MAX(CAST(l_quantity AS TINYINT)) AS max_q8,
       MIN(CAST(l_quantity AS SMALLINT)) AS min_q16,
       MAX(CAST(l_quantity AS SMALLINT)) AS max_q16,
       MIN(CAST(l_tax AS FLOAT)) AS min_tax,
       MAX(CAST(l_tax AS FLOAT)) AS max_tax,
       MIN(l_tax > 0.04) AS min_high_tax,
       MAX(l_tax > 0.04) AS max_high_tax,
       MIN(l_shipts) AS first_ship,
       MAX(l_shipts) AS last_ship,
       MIN(l_comment) AS min_comment,
       MAX(l_comment) AS max_comment,
       MIN(l_extendedprice) AS min_price,
       MAX(l_extendedprice) AS max_price,
       MIN(l_extendedprice * l_quantity) AS min_volume,
       MAX(l_extendedprice * l_quantity) AS max_volume
FROM lineitem_dec
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus""",
    "O4a": f"""
SELECT l_returnflag, SUM(l_quantity) AS sum_qty,
       SUM(l_extendedprice) AS sum_price, COUNT(*) AS n
FROM (SELECT l_returnflag, l_quantity, l_extendedprice FROM lineitem
      WHERE l_shipdate < DATE '{_iso(8500)}'
      UNION ALL
      SELECT l_returnflag, l_quantity, l_extendedprice FROM lineitem
      WHERE l_shipdate >= DATE '{_iso(10500)}')
GROUP BY l_returnflag
ORDER BY l_returnflag""",
    "O4b": f"""
SELECT COUNT(*) AS n
FROM (SELECT o_custkey FROM orders WHERE o_orderdate < DATE '{_iso(8200)}'
      UNION
      SELECT o_custkey FROM orders WHERE o_totalprice > 450000.0)""",
    "O6b": "SELECT 1 + 2 AS three, abs(-3) AS abs3, -(4) AS neg4",
}

#: the order phase 11 runs them in
OPS_QUERIES = ("O1", "O2", "O3", "O4a", "O4b", "O5", "O6a", "O6b", "O7",
               "O8a", "O8b")


def port_api():
    """The port's expression constructors, as ``ops_queries`` takes them
    (a test passes the reference package's instead)."""
    from types import SimpleNamespace

    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.ops import arithmetic as A
    from spark_rapids_tpu_torch.ops.expr import col, lit
    return SimpleNamespace(F=F, col=col, lit=lit, Pmod=A.Pmod,
                           IntegralDivide=A.IntegralDivide)


#: lineitem_dec by (lineitem table, seed): phases 11 and 12 share one, so
#: its strings are encoded on the host once
_DEC_TABLES: dict = {}


def lineitem_dec(tables, seed: int):
    """The lineitem rows of ``tables`` with l_quantity, l_extendedprice,
    l_discount and l_tax as DECIMAL(15,2) (unscaled ``round(v * 100)``: the
    discount falls in 0.00-0.10 and the tax in 0.00-0.08, as dbgen's),
    l_shipts (a TIMESTAMP: l_shipdate's midnight plus a seeded second of
    the day) and l_comment (up to 24 characters, 2% null, drawn from 2^16
    strings made by the datagen's generator). l_tax comes from the
    lineitem spec's own generator at ``seed``. A port HostTable, made once
    per (lineitem table, seed)."""
    key = (id(tables["lineitem"]), seed)
    hit = _DEC_TABLES.get(key)
    if hit is not None and hit[0] is tables["lineitem"]:
        return hit[1]
    dec = _lineitem_dec(tables, seed)
    _DEC_TABLES[key] = (tables["lineitem"], dec)
    return dec


def _lineitem_dec(tables, seed: int):
    from spark_rapids_tpu_torch.datagen import RandomString, scale_test_specs
    from spark_rapids_tpu_torch.interop import host_table_from_arrays
    li = tables["lineitem"]
    L = host_cols(li)
    n = li.num_rows
    spec = scale_test_specs(1.0)["lineitem"]
    tax = dict(spec.columns)["l_tax"].generate(n, seed, "lineitem",
                                               "l_tax").data
    rng = np.random.default_rng(seed + 1000)
    pool = np.array(RandomString(max_len=24).values(1 << 16, rng),
                    dtype=object)
    comment = pool[rng.integers(0, len(pool), n)]
    comment_ok = rng.random(n) >= 0.02
    ship_ts = (L["l_shipdate"].astype(np.int64) * 86_400_000_000
               + rng.integers(0, 86_400, n) * 1_000_000)

    def cents(v):
        return np.round(np.asarray(v, dtype=np.float64) * 100).astype(
            np.int64)

    ones = np.ones(n, bool)
    cols = {
        "l_returnflag": ("string", L["l_returnflag"]),
        "l_linestatus": ("string", L["l_linestatus"]),
        "l_quantity": ("decimal(15,2)", cents(L["l_quantity"])),
        "l_extendedprice": ("decimal(15,2)", cents(L["l_extendedprice"])),
        "l_discount": ("decimal(15,2)", cents(L["l_discount"])),
        "l_tax": ("decimal(15,2)", cents(tax)),
        "l_shipdate": ("date", L["l_shipdate"]),
        "l_shipts": ("timestamp", ship_ts),
        "l_comment": ("string", comment),
    }
    return host_table_from_arrays(
        list(cols), [t for t, _ in cols.values()],
        [(v, comment_ok if name == "l_comment" else ones)
         for name, (_, v) in cols.items()])


def ops_queries(session, api, range_rows: int = OPS_RANGE_ROWS):
    """{name: () -> DataFrame} of O1-O8 over ``session``'s temp views
    lineitem, orders and lineitem_dec, built with ``api``'s constructors
    (``port_api``, or the reference package's in a test). O8's cached
    filter is made once here: its first run materializes it, and every
    later run of O8a and O8b scans the kept table."""
    import datetime as dt
    F, col, lit = api.F, api.col, api.lit
    cutoff = dt.date(1970, 1, 1) + dt.timedelta(days=OPS_CUTOFF_DAY)
    cached = session.table("orders").filter(
        col("o_totalprice") > lit(OPS_CACHE_PRICE)).cache()

    def sql(name):
        return lambda: session.sql(OPS_SQL[name])

    def o3():
        return session.table("orders").group_by("o_custkey").agg(
            F.first("o_orderdate").alias("first_date"),
            F.last("o_totalprice").alias("last_price"),
            F.first("o_orderkey").alias("first_order"),
            F.count("*").alias("n"))

    def o5():
        key = col("l_orderkey")
        return session.table("lineitem").group_by(
            (key % lit(16)).alias("bucket")).agg(
            F.sum(-col("l_quantity")).alias("neg_qty"),
            F.max(F.abs(col("l_extendedprice") - lit(50000.0))).alias(
                "max_dev"),
            F.sum(api.Pmod(key - lit(5000000), lit(7))).alias("pmod_sum"),
            F.max(api.IntegralDivide(key, lit(1000))).alias("max_div"),
            F.count("*").alias("n")).sort("bucket")

    def o6a():
        ids = col("id")
        return session.range(0, range_rows).agg(
            F.sum(ids % lit(7)).alias("sum_mod7"),
            F.max(-ids).alias("max_neg"), F.count("*").alias("n"))

    def o7():
        return (session.table("lineitem").sample(0.01, seed=7)
                .filter(col("l_shipdate") <= lit(cutoff))
                .group_by("l_returnflag", "l_linestatus")
                .agg(F.sum("l_quantity").alias("sum_qty"),
                     F.sum("l_extendedprice").alias("sum_base"),
                     F.avg("l_discount").alias("avg_disc"),
                     F.count("l_quantity").alias("cnt")))

    def o8a():
        return cached.group_by("o_custkey").agg(
            F.count("*").alias("n"), F.max("o_totalprice").alias("top"))

    def o8b():
        return cached.agg(F.sum("o_totalprice").alias("total"),
                          F.min("o_orderdate").alias("first_date"),
                          F.count("*").alias("n"))

    out = {"O1": sql("O1"), "O2": sql("O2"), "O3": o3, "O4a": sql("O4a"),
           "O4b": sql("O4b"), "O5": o5, "O6a": o6a, "O6b": sql("O6b"),
           "O7": o7, "O8a": o8a, "O8b": o8b}
    out["cached"] = cached
    return out


def ops_oracles(tables, dec, range_rows: int = OPS_RANGE_ROWS):
    """{query: check(got)} of O1-O8 in numpy from the host tables and the
    decimal view: decimals (as Python ints where the result is DECIMAL128),
    counts, MIN/MAX and FIRST/LAST exact, the AVG of a decimal as the
    port computes it (the exact sum as a double over count x 100), f64
    sums rtol 1e-9."""
    L, O, D = (host_cols(t) for t in (tables["lineitem"], tables["orders"],
                                       dec))
    i64 = np.int64
    out = {}

    def codes(table, name):
        c = table.columns[table.names.index(name)]
        return c.encoded()

    rf, rf_dict = codes(dec, "l_returnflag")
    ls, ls_dict = codes(dec, "l_linestatus")
    nls = len(ls_dict)

    def flag_groups(mask):
        """(group index of each masked row, the present groups' flag and
        status strings, the group count) in (flag, status) order."""
        g = rf[mask].astype(i64) * nls + ls[mask]
        present, inv = np.unique(g, return_inverse=True)
        return (inv, np.asarray(rf_dict, dtype=object)[present // nls],
                np.asarray(ls_dict, dtype=object)[present % nls],
                len(present))

    def pyints(v):
        return np.array([int(x) for x in v], dtype=object)

    sorted_by = {}

    def per_group(inv, k, values, fn):
        """``fn`` (a ufunc) reduced over each of ``inv``'s k groups (every
        group present), with one argsort per grouping."""
        key = id(inv)
        if key not in sorted_by:
            order = np.argsort(inv, kind="stable")
            sorted_by[key] = (inv, order, np.searchsorted(inv[order],
                                                          np.arange(k)))
        _, order, starts = sorted_by[key]
        return fn.reduceat(values[order], starts)

    # O1: q1 over DECIMAL(15,2), unscaled int64 sums (below 1.2e18 at
    # sf 10: 10.5e6 x 100 x 108 a row)
    m = D["l_shipdate"] <= OPS_CUTOFF_DAY
    inv, f, s, k = flag_groups(m)
    qty, price = D["l_quantity"][m], D["l_extendedprice"][m]
    disc, tax = D["l_discount"][m], D["l_tax"][m]
    n = np.bincount(inv, minlength=k).astype(i64)

    def isum(v):
        return per_group(inv, k, v.astype(i64), np.add)

    def avg(total):
        return np.array([float(int(t)) / (float(c) * 100.0)
                         for t, c in zip(total, n)])

    sq, sp, sd = isum(qty), isum(price), isum(disc)
    want = {"l_returnflag": f, "l_linestatus": s, "sum_qty": pyints(sq),
            "sum_base_price": pyints(sp),
            "sum_disc_price": pyints(isum(price * (100 - disc))),
            "sum_charge": pyints(isum(price * (100 - disc) * (100 + tax))),
            "avg_qty": avg(sq), "avg_price": avg(sp), "avg_disc": avg(sd),
            "count_order": n}
    out["O1"] = lambda g, w=want: check_table(g, w, "O1")
    # O2: MIN/MAX of every type per (flag, status)
    inv, f, s, k = flag_groups(np.ones(len(rf), bool))
    qd, tx = D["l_quantity"], D["l_tax"]
    ctab = dec.columns[dec.names.index("l_comment")]
    ccodes, cdict = ctab.encoded()
    cok = ctab.validity
    big = np.iinfo(i64).max
    want = {"l_returnflag": f, "l_linestatus": s}
    vals = {"q8": (qd // 100).astype(np.int8),
            "q16": (qd // 100).astype(np.int16),
            "tax": (tx.astype(np.float64) / 100.0).astype(np.float32),
            "high_tax": tx.astype(np.float64) / 100.0 > 0.04,
            "ship": D["l_shipts"]}
    for tag, (lo_name, hi_name) in {
            "q8": ("min_q8", "max_q8"), "q16": ("min_q16", "max_q16"),
            "tax": ("min_tax", "max_tax"),
            "high_tax": ("min_high_tax", "max_high_tax"),
            "ship": ("first_ship", "last_ship")}.items():
        want[lo_name] = per_group(inv, k, vals[tag], np.minimum)
        want[hi_name] = per_group(inv, k, vals[tag], np.maximum)
    ccodes = ccodes.astype(i64)
    cmin = per_group(inv, k, np.where(cok, ccodes, big), np.minimum)
    cmax = per_group(inv, k, np.where(cok, ccodes, -1), np.maximum)
    want["min_comment"] = np.asarray(cdict, dtype=object)[cmin]
    want["max_comment"] = np.asarray(cdict, dtype=object)[cmax]
    want["min_price"] = per_group(inv, k, D["l_extendedprice"], np.minimum)
    want["max_price"] = per_group(inv, k, D["l_extendedprice"], np.maximum)
    volume = D["l_extendedprice"] * qd
    want["min_volume"] = pyints(per_group(inv, k, volume, np.minimum))
    want["max_volume"] = pyints(per_group(inv, k, volume, np.maximum))
    out["O2"] = lambda g, w=want: check_table(g, w, "O2")
    # O3: the first and last order of each customer, in row order
    cust = O["o_custkey"]
    keys, first = np.unique(cust, return_index=True)
    last = len(cust) - 1 - np.unique(cust[::-1], return_index=True)[1]
    want = {"o_custkey": keys, "first_date": O["o_orderdate"][first],
            "last_price": O["o_totalprice"][last],
            "first_order": O["o_orderkey"][first],
            "n": np.bincount(cust)[keys].astype(i64)}
    out["O3"] = lambda g, w=want: check_table(g, w, "O3",
                                              key=("o_custkey",))
    # O4a: the two date arms, per flag
    li = tables["lineitem"]
    lrf, lrf_dict = codes(li, "l_returnflag")
    m = (L["l_shipdate"] < 8500) | (L["l_shipdate"] >= 10500)
    present, inv = np.unique(lrf[m], return_inverse=True)
    k = len(present)
    want = {"l_returnflag": np.asarray(lrf_dict, dtype=object)[present],
            "sum_qty": per_group(inv, k, L["l_quantity"][m].astype(i64),
                                 np.add),
            "sum_price": np.bincount(inv, weights=L["l_extendedprice"][m],
                                     minlength=k),
            "n": np.bincount(inv, minlength=k).astype(i64)}
    out["O4a"] = lambda g, w=want: check_table(g, w, "O4a",
                                               f64=("sum_price",))
    # O4b: distinct customers of the two order filters
    m = (O["o_orderdate"] < 8200) | (O["o_totalprice"] > 450000.0)
    want = {"n": np.array([len(np.unique(cust[m]))], dtype=i64)}
    out["O4b"] = lambda g, w=want: check_table(g, w, "O4b")
    # O5: buckets of l_orderkey (all non-negative)
    ok = L["l_orderkey"].astype(i64)
    bucket = ok % 16
    present, inv = np.unique(bucket, return_inverse=True)
    k = len(present)

    def bsum(v):
        return per_group(inv, k, v, np.add)

    dev = np.abs(L["l_extendedprice"] - 50000.0)
    want = {"bucket": present, "neg_qty": bsum(-L["l_quantity"].astype(i64)),
            "max_dev": per_group(inv, k, dev, np.maximum),
            "pmod_sum": bsum(np.mod(ok - 5000000, 7)),
            "max_div": per_group(inv, k, ok // 1000, np.maximum),
            "n": np.bincount(inv, minlength=k).astype(i64)}
    out["O5"] = lambda g, w=want: check_table(g, w, "O5")
    # O6: the range's closed forms, and the constant row
    full, rest = divmod(range_rows, 7)
    want = {"sum_mod7": np.array([full * 21 + rest * (rest - 1) // 2],
                                 dtype=i64),
            "max_neg": np.array([0], dtype=i64),
            "n": np.array([range_rows], dtype=i64)}
    out["O6a"] = lambda g, w=want: check_table(g, w, "O6a")
    want = {"three": np.array([3], dtype=np.int32),
            "abs3": np.array([3], dtype=np.int32),
            "neg4": np.array([-4], dtype=np.int32)}
    out["O6b"] = lambda g, w=want: check_table(g, w, "O6b")
    # O7: the reference's draw (one batch), then the corpus q1's aggregate
    keep = np.random.default_rng(7).random(li.num_rows) < 0.01
    m = keep & (L["l_shipdate"] <= OPS_CUTOFF_DAY)
    g = lrf[m].astype(i64) * 2 + codes(li, "l_linestatus")[0][m]
    present, inv = np.unique(g, return_inverse=True)
    k = len(present)
    ls_dict_li = codes(li, "l_linestatus")[1]
    acc = per_group(inv, k, L["l_quantity"][m].astype(i64), np.add)
    cnt = np.bincount(inv, minlength=k).astype(i64)
    want = {"l_returnflag": np.asarray(lrf_dict, dtype=object)[present // 2],
            "l_linestatus": np.asarray(ls_dict_li, dtype=object)[present % 2],
            "sum_qty": acc,
            "sum_base": np.bincount(inv, weights=L["l_extendedprice"][m],
                                    minlength=k),
            "avg_disc": np.bincount(inv, weights=L["l_discount"][m],
                                    minlength=k) / cnt,
            "cnt": cnt}
    out["O7"] = lambda g, w=want: check_table(
        g, w, "O7", key=("l_returnflag", "l_linestatus"),
        f64=("sum_base", "avg_disc"))
    # O8: the cached filter, grouped and global
    m = O["o_totalprice"] > OPS_CACHE_PRICE
    keys, inv = np.unique(cust[m], return_inverse=True)
    want = {"o_custkey": keys,
            "n": np.bincount(inv).astype(i64),
            "top": per_group(inv, len(keys), O["o_totalprice"][m],
                             np.maximum)}
    out["O8a"] = lambda g, w=want: check_table(g, w, "O8a",
                                               key=("o_custkey",))
    want = {"total": np.array([O["o_totalprice"][m].sum()]),
            "first_date": np.array([O["o_orderdate"][m].min()],
                                   dtype=O["o_orderdate"].dtype),
            "n": np.array([int(m.sum())], dtype=i64)}
    out["O8b"] = lambda g, w=want: check_table(g, w, "O8b", f64=("total",))
    return out


def run_ops(tables, sf: float, seed: int, profile_dir) -> dict:
    """Phase 11: O1-O8 (``OPS_QUERIES``) over temp views of phases 6-10's
    tables and ``lineitem_dec``, each through ``run_case`` against its
    numpy oracle; fused_minmax must run in O2 (MIN/MAX of every type) and
    O3 (FIRST/LAST), and O8b must scan O8a's kept table (no filter exec).
    ``--profile`` traces O1, O2, O3, O4a, O5, O6a and O7. Returns every
    kernel's launches summed over the counted runs."""
    from spark_rapids_tpu_torch.execs.basic import TpuFilterExec
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.session import TorchSession

    t0 = time.perf_counter()
    dec = lineitem_dec(tables, seed)
    log(f"  lineitem_dec ({dec.num_rows} rows, DECIMAL(15,2) quantity, "
        "price, discount and tax, a TIMESTAMP and a comment) in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    t0 = time.perf_counter()
    oracles = ops_oracles(tables, dec, OPS_RANGE_ROWS)
    log(f"  the numpy oracles in {time.perf_counter() - t0:.2f} s (host)")
    session = TorchSession()
    for name, t in (("lineitem", tables["lineitem"]),
                    ("orders", tables["orders"]), ("lineitem_dec", dec)):
        from_host_table(t, session).create_or_replace_temp_view(name)
    queries = ops_queries(session, port_api(), OPS_RANGE_ROWS)
    total, summary, results = {}, {}, {}
    for name in OPS_QUERIES:
        prof = profile_dir if name in ("O1", "O2", "O3", "O4a", "O5", "O6a",
                                       "O7") else None
        res = run_case(session, name, queries[name], oracles[name], prof,
                       warm_runs=1)
        results[name] = res
        for k, v in res["launches"].items():
            total[k] = total.get(k, 0) + v
        summary[name] = dict(res["stats"], launches={
            k: v for k, v in res["launches"].items() if v})
        log(f"  {name}: result matches the numpy oracle")

    def execs(e):
        yield e
        for c in e.children:
            yield from execs(c)

    if any(isinstance(e, TpuFilterExec)
           for e in execs(session._last_root)):
        fail("O8b ran the cached filter again")
    if queries["cached"].plan._table is None:
        fail("O8's cached relation did not materialize")
    log("  O8b: scans the table O8a's first run kept (no filter exec)")
    for q in ("O2", "O3"):
        if not results[q]["launches"]["fused_minmax"]:
            fail(f"{q} launched no fused_minmax")
    for k in ("onehot_partials", "fused_minmax", "gather_compact",
              "sort_with_payload"):
        if not total.get(k):
            fail(f"phase 11 launched no {k}")
    log("  phase-11 summary: " + json.dumps(summary))
    return total


# ---------------------------------------------------------------------------
# phase 12: the scalar functions (strings, dates and timestamps, math,
# hashes) and DECIMAL128 division as TPC-H-style queries S1-S8
# ---------------------------------------------------------------------------

#: S5's zone (a DST zone: the transition-table lookup), and the fixed
#: offset S5 takes where the machine's zoneinfo database lacks it
SCALAR_ZONE = "America/Los_Angeles"
SCALAR_FIXED_ZONE = "+05:30"

#: the SQL texts of the scalar query set (``{zone}`` is S5's zone); pmod
#: and bitand are global SQL registrations (``register_scalar_functions``),
#: as neither package's builtin table has them
SCALAR_SQL = {
    "S1": """
SELECT l_returnflag, l_linestatus,
       SUM(l_extendedprice * (1 - l_discount) / l_quantity) AS sum_unit_net,
       MAX(l_extendedprice * (1 - l_discount) % l_quantity) AS max_rem,
       MIN(pmod(l_extendedprice * (1 - l_discount), l_quantity)) AS min_pmod,
       COUNT(*) AS n
FROM lineitem_dec
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus""",
    "S2": """
SELECT month(l_shipdate) AS m,
       SUM(CASE WHEN l_comment LIKE 'P%'
                THEN l_extendedprice * (1 - l_discount)
                ELSE CAST(0 AS DECIMAL(32,4)) END)
         / SUM(l_extendedprice * (1 - l_discount)) AS promo_share,
       COUNT(*) AS n
FROM lineitem_dec
WHERE l_shipdate >= DATE '1995-01-01'
  AND l_shipdate < DATE '1995-01-01' + INTERVAL 1 YEAR
GROUP BY month(l_shipdate)
ORDER BY m""",
    "S3": """
SELECT year(o_orderdate) AS y, substring(c_name, 16, 2) AS tail,
       COUNT(*) AS n, MAX(o_totalprice) AS top,
       MIN(o_orderkey) AS first_order
FROM orders JOIN customer ON o_custkey = c_custkey
WHERE quarter(o_orderdate) IN (1, 4)
  AND upper(c_name) LIKE 'CUSTOMER#000%'
GROUP BY year(o_orderdate), substring(c_name, 16, 2)
ORDER BY y, tail""",
    "S4": """
SELECT dayofweek(o_orderdate) AS dow, COUNT(*) AS n,
       SUM(datediff(l_shipdate, o_orderdate)) AS delay,
       MAX(last_day(add_months(o_orderdate, 1))) AS last_next,
       MIN(date_add(l_shipdate, 7)) AS first_week
FROM lineitem JOIN orders ON l_orderkey = o_orderkey
WHERE l_shipdate >= o_orderdate + INTERVAL 30 DAY
  AND o_orderdate < DATE '1996-01-01' - INTERVAL 3 MONTH
GROUP BY dayofweek(o_orderdate)
ORDER BY dow""",
    "S5": """
SELECT hour(from_utc_timestamp(l_shipts, '{zone}')) AS h, COUNT(*) AS n,
       MIN(minute(from_utc_timestamp(l_shipts, '{zone}'))) AS min_minute,
       MAX(second(from_utc_timestamp(l_shipts, '{zone}'))) AS max_second,
       SUM(minute(from_utc_timestamp(l_shipts, '{zone}'))) AS sum_minute,
       SUM(unix_timestamp(l_shipts)) AS sum_unix,
       MAX(to_date(l_shipts)) AS last_date
FROM lineitem_dec
GROUP BY hour(from_utc_timestamp(l_shipts, '{zone}'))
ORDER BY h""",
    "S6a": """
SELECT floor(log10(o_totalprice)) AS band, COUNT(*) AS n,
       MAX(round(o_totalprice, 2)) AS max_round,
       MIN(bround(o_totalprice, -2)) AS min_bround,
       MAX(ceil(sqrt(o_totalprice))) AS max_ceil_sqrt,
       MAX(pow(o_totalprice, 0.25)) AS max_pow,
       MIN(exp(o_totalprice / 1000000.0)) AS min_exp,
       SUM(bitand(shiftleft(o_custkey, 3), 255)) AS sum_bits
FROM orders
GROUP BY floor(log10(o_totalprice))
ORDER BY band""",
    "S6b": """
SELECT o_orderkey, CAST(o_totalprice AS FLOAT) AS price32
FROM orders
ORDER BY price32, o_orderkey
LIMIT 100""",
    "S7": """
SELECT length(l_comment) AS len, COUNT(*) AS n,
       SUM(CASE WHEN l_comment LIKE '%ab%' THEN 1 ELSE 0 END) AS n_ab,
       SUM(CASE WHEN l_comment RLIKE '^[0-9]' THEN 1 ELSE 0 END) AS n_digit,
       MAX(trim(l_comment)) AS max_trim,
       MIN(lpad(l_comment, 30, '*')) AS min_pad,
       MAX(replace(l_comment, 'a', 'A')) AS max_rep,
       MAX(md5(l_comment)) AS max_md5
FROM lineitem_dec
GROUP BY length(l_comment)
ORDER BY len""",
    "S8": """
SELECT concat_ws('|', 'flag', l_returnflag) AS label,
       l_linestatus || '#' AS status,
       SUM(xxhash64(l_extendedprice, l_shipdate) % 1000) AS xx,
       SUM(hash(l_extendedprice * l_quantity) % 1000) AS mm,
       SUM(CASE WHEN rand(7) < 0.5 THEN 1 ELSE 0 END) AS heads,
       COUNT(*) AS n
FROM lineitem_dec
GROUP BY concat_ws('|', 'flag', l_returnflag), l_linestatus || '#'
ORDER BY label DESC, status""",
}

#: the order phase 12 runs them in
SCALAR_QUERIES = ("S1", "S2", "S3", "S4", "S5", "S6a", "S6b", "S7", "S8")
#: the transcendental double columns, held within 2 ulp of the oracle
#: (XLA's CPU, torch's CPU and CUDA's libm differ by an ulp); every other
#: value is exact
SCALAR_ULP_COLUMNS = {"S6a": ("max_pow", "min_exp")}


def register_scalar_functions(F, ops) -> None:
    """``pmod`` and ``bitand`` as global SQL functions of the package whose
    ``functions`` module is ``F`` (``ops``: its Pmod and BitwiseAnd)."""
    F.register_sql_function("pmod", ops.Pmod)
    F.register_sql_function("bitand", ops.BitwiseAnd)


def scalar_texts(zone: str = SCALAR_ZONE) -> dict:
    return {k: v.replace("{zone}", zone) for k, v in SCALAR_SQL.items()}


def zone_available(zone: str) -> bool:
    """Whether the machine's zoneinfo database has ``zone``."""
    try:
        from zoneinfo import ZoneInfo
        ZoneInfo(zone)
        return True
    except Exception:
        return False


def check_rows(got, want, what, ulps=()) -> None:
    """The result against the oracle's columns ``want`` ({name: list of
    Python values, None for null}, in order): every value exact (strings,
    ints, unscaled decimals, dates as days, doubles bit for bit), the
    ``ulps`` columns within 2 ulp."""
    if list(got.names) != list(want):
        fail(f"{what}: columns {list(got.names)}, oracle {list(want)}")
    for name, c in zip(got.names, got.columns):
        g, w = c.to_pylist(), list(want[name])
        if len(g) != len(w):
            fail(f"{what}: {len(g)} rows, oracle {len(w)}")
        for i, (a, b) in enumerate(zip(g, w)):
            if a is None or b is None:
                ok = a is None and b is None
            elif name in ulps:
                ok = abs(int(np.float64(a).view(np.int64))
                         - int(np.float64(b).view(np.int64))) <= 2
            elif isinstance(b, float):
                ok = np.float64(a).tobytes() == np.float64(b).tobytes()
            else:
                ok = a == b
            if not ok:
                fail(f"{what} {name} row {i}: {a!r}, oracle {b!r}"
                     f"{' (2 ulp)' if name in ulps else ' (exact)'}")


def _groups(keys):
    """(group index of each row, (k, len(keys)) distinct key tuples in
    ascending order) of parallel small-range integer key arrays: one
    mixed-radix code a row and a bincount."""
    keys = [np.asarray(k, dtype=np.int64) for k in keys]
    los = [int(k.min()) for k in keys]
    spans = [int(k.max()) - lo + 1 for k, lo in zip(keys, los)]
    code = np.zeros(len(keys[0]), dtype=np.int64)
    for k, lo, span in zip(keys, los, spans):
        code = code * span + (k - lo)
    present = np.flatnonzero(np.bincount(code))
    rank = np.zeros(int(code.max()) + 1, dtype=np.int64)
    rank[present] = np.arange(len(present))
    uniq = np.empty((len(present), len(keys)), dtype=np.int64)
    rest = present.copy()
    for j in range(len(keys) - 1, -1, -1):
        uniq[:, j] = rest % spans[j] + los[j]
        rest //= spans[j]
    return rank[code], uniq


def _reduce(inv, k, values, fn, empty):
    out = np.full(k, empty, dtype=values.dtype)
    fn.at(out, inv, values)
    return out


def _big_sum(inv, k, v):
    """Exact per-group sums of non-negative int64 values as Python ints
    (two int64 sums of 32-bit halves)."""
    lo_s = np.zeros(k, dtype=np.int64)
    hi_s = np.zeros(k, dtype=np.int64)
    np.add.at(lo_s, inv, v & 0xFFFFFFFF)
    np.add.at(hi_s, inv, v >> 32)
    return [int(h) * (1 << 32) + int(lo) for h, lo in zip(hi_s, lo_s)]


def _half_up(num: int, den: int) -> int:
    q, r = divmod(abs(num), abs(den))
    q += 2 * r >= abs(den)
    return -q if (num < 0) != (den < 0) else q


def _np_murmur3_bytes(rows, lens, seed=42):
    """Spark's murmur3 hashUnsafeBytes of each row's first ``lens`` bytes
    (``rows`` (n, L) uint8), numpy uint32 arithmetic: the oracle of the
    DECIMAL128 byte hash."""
    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    def mix(h, k):
        k = k * np.uint32(0xCC9E2D51)
        k = rotl(k, 15) * np.uint32(0x1B873593)
        h = rotl(h ^ k, 13)
        return h * np.uint32(5) + np.uint32(0xE6546B64)

    out = np.zeros(len(lens), dtype=np.uint32)
    for L in np.unique(lens):
        m = lens == L
        b = rows[m].astype(np.uint32)
        h = np.full(int(m.sum()), seed, dtype=np.uint32)
        aligned = L - L % 4
        for i in range(0, aligned, 4):
            h = mix(h, b[:, i] | (b[:, i + 1] << np.uint32(8))
                    | (b[:, i + 2] << np.uint32(16))
                    | (b[:, i + 3] << np.uint32(24)))
        for i in range(aligned, L):
            sb = b[:, i].astype(np.int32)
            sb = np.where(sb >= 128, sb - 256, sb).astype(np.int64)
            h = mix(h, (sb & 0xFFFFFFFF).astype(np.uint32))
        h = h ^ np.uint32(L)
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        out[m] = h ^ (h >> np.uint32(16))
    return out.view(np.int32)


_XP = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
       0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5)


def _np_xx(value, seed, width):
    """Spark's XXH64 hashLong (width 8, ``value`` int64) or hashInt (width
    4, ``value`` int32) with per-row ``seed`` (uint64), numpy uint64."""
    P1, P2, P3, P4, P5 = (np.uint64(p) for p in _XP)

    def rotl(x, r):
        return (x << np.uint64(r)) | (x >> np.uint64(64 - r))

    h = seed + P5 + np.uint64(width)
    if width == 8:
        k = rotl(value.astype(np.int64).view(np.uint64) * P2, 31) * P1
        h = rotl(h ^ k, 27) * P1 + P4
    else:
        k = value.astype(np.int32).view(np.uint32).astype(np.uint64) * P1
        h = rotl(h ^ k, 23) * P2 + P3
    h = h ^ (h >> np.uint64(33))
    h = h * P2
    h = h ^ (h >> np.uint64(29))
    h = h * P3
    return h ^ (h >> np.uint64(32))


def _dict_rank_max(codes, valid, dictionary, fn, inv, k, use_max=True):
    """Per group of ``inv`` the MAX (or MIN) of ``fn`` over each valid
    row's dictionary entry, None for a group with no valid row: ``fn``
    runs once per entry, the rows compare by the rank of its result."""
    vals = np.array([fn(s) for s in dictionary], dtype=object)
    uniq, rank = np.unique(vals, return_inverse=True)
    r = rank.reshape(-1)[codes].astype(np.int64)
    if use_max:
        best = _reduce(inv, k, np.where(valid, r, -1), np.maximum, -1)
    else:
        big = len(uniq)
        best = _reduce(inv, k, np.where(valid, r, big), np.minimum, big)
    return [None if b < 0 or b >= len(uniq) else uniq[b] for b in best]


def scalar_oracles(tables, dec, zone: str = SCALAR_ZONE) -> dict:
    """{query: check(got)} of S1-S8 in numpy and Python ints from the host
    tables and ``lineitem_dec``: decimals (HALF_UP in Python ints),
    integers, dates, strings and hashes exact; S6a's transcendental
    doubles (``SCALAR_ULP_COLUMNS``) within 2 ulp."""
    import datetime as dt
    import hashlib
    L, O, C, D = (host_cols(t) for t in (tables["lineitem"], tables["orders"],
                                          tables["customer"], dec))
    i64 = np.int64
    out = {}

    def col(table, name):
        return table.columns[table.names.index(name)]

    def day(iso):
        return (dt.date.fromisoformat(iso) - dt.date(1970, 1, 1)).days

    def done(name, want):
        out[name] = lambda g, w=want, n=name: check_rows(
            g, w, n, SCALAR_ULP_COLUMNS.get(n, ()))

    rf, rf_dict = col(dec, "l_returnflag").encoded()
    ls, ls_dict = col(dec, "l_linestatus").encoded()
    price, disc = D["l_extendedprice"].astype(i64), D["l_discount"].astype(i64)
    qty = D["l_quantity"].astype(i64)
    net = price * (100 - disc)  # scale 4
    # S1: per-row DECIMAL128 quotients (every operand positive)
    inv, uniq = _groups([rf, ls])
    k = len(uniq)
    unit = (2 * net * 10 ** 6 + qty) // (2 * qty)  # HALF_UP, scale 8
    rem = net % (qty * 100)  # scale 4: the quantity rescaled by 10^2
    done("S1", {
        "l_returnflag": list(rf_dict[uniq[:, 0]]),
        "l_linestatus": list(ls_dict[uniq[:, 1]]),
        "sum_unit_net": _big_sum(inv, k, unit),
        "max_rem": [int(v) for v in _reduce(inv, k, rem, np.maximum, -1)],
        "min_pmod": [int(v) for v in _reduce(inv, k, rem, np.minimum,
                                             np.iinfo(i64).max)],
        "n": [int(v) for v in np.bincount(inv, minlength=k)]})
    # S2: the promotional share of 1995's net revenue by month
    ship = D["l_shipdate"].astype(i64)
    m = (ship >= day("1995-01-01")) & (ship < day("1996-01-01"))
    month = ship[m].astype("datetime64[D]").astype("datetime64[M]").astype(
        i64) % 12 + 1
    ccodes, cdict = col(dec, "l_comment").encoded()
    cok = col(dec, "l_comment").validity
    promo_entry = np.array([s.startswith("P") for s in cdict], dtype=bool)
    promo = cok & promo_entry[ccodes]
    minv, months = _groups([month])
    months = months[:, 0]
    total = np.zeros(len(months), dtype=i64)
    part = np.zeros(len(months), dtype=i64)
    np.add.at(total, minv, net[m])
    np.add.at(part, minv, np.where(promo[m], net[m], 0))
    done("S2", {
        "m": [int(v) for v in months],
        "promo_share": [_half_up(int(a) * 10 ** 6, int(b))
                        for a, b in zip(part, total)],
        "n": [int(v) for v in np.bincount(minv)]})
    # S3: orders of '000' customers in the first and last quarters (the
    # string tests once a customer)
    ckey = C["c_custkey"].astype(i64)
    picked_c = np.zeros(int(ckey.max()) + 1, dtype=bool)
    tail_c = np.zeros(int(ckey.max()) + 1, dtype=i64)
    picked_c[ckey] = [n.upper().startswith("CUSTOMER#000")
                      for n in C["c_name"]]
    tail_u, tail_i = np.unique(np.array([n[15:17] for n in C["c_name"]],
                                        dtype=object), return_inverse=True)
    tail_c[ckey] = tail_i.reshape(-1)
    cust = O["o_custkey"].astype(i64)
    known = (cust >= 0) & (cust < len(picked_c))
    cidx = np.clip(cust, 0, len(picked_c) - 1)
    od = O["o_orderdate"].astype(i64)
    odates = od.astype("datetime64[D]")
    year = odates.astype("datetime64[Y]").astype(i64) + 1970
    mon = odates.astype("datetime64[M]").astype(i64) % 12 + 1
    quarter = (mon - 1) // 3 + 1
    m = known & picked_c[cidx] & ((quarter == 1) | (quarter == 4))
    inv, uniq = _groups([year[m], tail_c[cidx[m]]])
    k = len(uniq)
    done("S3", {
        "y": [int(v) for v in uniq[:, 0]],
        "tail": list(tail_u[uniq[:, 1]]),
        "n": [int(v) for v in np.bincount(inv, minlength=k)],
        "top": [float(v) for v in _reduce(inv, k, O["o_totalprice"][m],
                                          np.maximum, -np.inf)],
        "first_order": [int(v) for v in _reduce(
            inv, k, O["o_orderkey"][m].astype(i64), np.minimum,
            np.iinfo(i64).max)]})
    # S4: the ship delay of orders placed before 1995-10-01
    okey = O["o_orderkey"].astype(i64)
    date_of = np.full(int(okey.max()) + 1, np.iinfo(i64).max, dtype=i64)
    date_of[okey] = od
    lkey = L["l_orderkey"].astype(i64)
    inside = (lkey >= 0) & (lkey < len(date_of))
    lod = np.where(inside, date_of[np.clip(lkey, 0, len(date_of) - 1)],
                   np.iinfo(i64).max)
    lship = L["l_shipdate"].astype(i64)
    m = (lod != np.iinfo(i64).max) & (lship >= lod + 30) & \
        (lod < day("1995-10-01"))
    dow = (lod[m] + 4) % 7 + 1
    last_next = (lod[m].astype("datetime64[D]").astype("datetime64[M]")
                 + np.timedelta64(2, "M")).astype("datetime64[D]").astype(
        i64) - 1
    inv, dows = _groups([dow])
    dows, k = dows[:, 0], len(dows)
    delay = np.zeros(k, dtype=i64)
    np.add.at(delay, inv, lship[m] - lod[m])
    done("S4", {
        "dow": [int(v) for v in dows],
        "n": [int(v) for v in np.bincount(inv, minlength=k)],
        "delay": [int(v) for v in delay],
        "last_next": [int(v) for v in _reduce(inv, k, last_next, np.maximum,
                                              np.iinfo(i64).min)],
        "first_week": [int(v) + 7 for v in _reduce(
            inv, k, lship[m], np.minimum, np.iinfo(i64).max)]})
    # S5: local hours of the ship timestamps (the offset of each UTC hour
    # from zoneinfo, or the fixed offset)
    ts = D["l_shipts"].astype(i64)
    hour_us = 3_600_000_000
    utc_hour = ts // hour_us
    if zone == SCALAR_ZONE:
        from zoneinfo import ZoneInfo
        tz = ZoneInfo(zone)
        hinv, hours = _groups([utc_hour])
        hours = hours[:, 0]
        offs = np.array([int(dt.datetime.fromtimestamp(
            int(h) * 3600, dt.timezone.utc).astimezone(tz).utcoffset()
            .total_seconds()) * 1_000_000 for h in hours], dtype=i64)
        local = ts + offs[hinv.reshape(-1)]
    else:
        sign = -1 if zone.startswith("-") else 1
        hh, mm = zone[1:].split(":")
        local = ts + sign * (int(hh) * 3600 + int(mm) * 60) * 1_000_000
    lh = (local // hour_us) % 24
    lmin = (local // 60_000_000) % 60
    lsec = (local // 1_000_000) % 60
    inv, hs = _groups([lh])
    hs, k = hs[:, 0], len(hs)
    s_min = np.zeros(k, dtype=i64)
    s_unix = np.zeros(k, dtype=i64)
    np.add.at(s_min, inv, lmin)
    np.add.at(s_unix, inv, ts // 1_000_000)
    done("S5", {
        "h": [int(v) for v in hs],
        "n": [int(v) for v in np.bincount(inv, minlength=k)],
        "min_minute": [int(v) for v in _reduce(inv, k, lmin, np.minimum,
                                               60)],
        "max_second": [int(v) for v in _reduce(inv, k, lsec, np.maximum,
                                               -1)],
        "sum_minute": [int(v) for v in s_min],
        "sum_unix": [int(v) for v in s_unix],
        "last_date": [int(v) for v in _reduce(
            inv, k, ts // 86_400_000_000, np.maximum, np.iinfo(i64).min)]})
    # S6a: price bands, IEEE-exact rounding, transcendentals within 2 ulp
    p = O["o_totalprice"].astype(np.float64)
    band = np.floor(np.log10(p)).astype(i64)
    inv, bands = _groups([band])
    bands, k = bands[:, 0], len(bands)
    x = p * 100.0
    rnd = np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5)) / 100.0
    brnd = np.rint(p * 0.01) / 0.01
    bits = np.zeros(k, dtype=i64)
    np.add.at(bits, inv, (cust << 3) & 255)
    done("S6a", {
        "band": [int(v) for v in bands],
        "n": [int(v) for v in np.bincount(inv, minlength=k)],
        "max_round": [float(v) for v in _reduce(inv, k, rnd, np.maximum,
                                                -np.inf)],
        "min_bround": [float(v) for v in _reduce(inv, k, brnd, np.minimum,
                                                 np.inf)],
        "max_ceil_sqrt": [int(v) for v in _reduce(
            inv, k, np.ceil(np.sqrt(p)).astype(i64), np.maximum, -1)],
        "max_pow": [float(v) for v in _reduce(inv, k, np.power(p, 0.25),
                                              np.maximum, -np.inf)],
        "min_exp": [float(v) for v in _reduce(inv, k, np.exp(p / 1e6),
                                              np.minimum, np.inf)],
        "sum_bits": [int(v) for v in bits]})
    # S6b: the 100 cheapest orders by their float32 price
    p32 = p.astype(np.float32)
    top = np.lexsort((okey, p32))[:100]
    done("S6b", {"o_orderkey": [int(v) for v in okey[top]],
                 "price32": [float(v) for v in p32[top]]})
    # S7: the comment scan by comment length (null comments: a null group)
    lens = np.array([len(s) for s in cdict], dtype=i64)[ccodes]
    key = np.where(cok, lens, -1)
    inv, keys = _groups([key])
    keys, k = keys[:, 0], len(keys)

    def count_where(entry_pred):
        hit = cok & np.array([entry_pred(s) for s in cdict],
                             dtype=bool)[ccodes]
        return [int(v) for v in np.bincount(inv, weights=hit.astype(i64),
                                            minlength=k).astype(i64)]

    def md5(s):
        return hashlib.md5(s.encode("utf-8")).hexdigest()

    def lpad30(s):
        return s[:30] if len(s) >= 30 else ("*" * 30)[:30 - len(s)] + s

    done("S7", {
        "len": [None if v < 0 else int(v) for v in keys],
        "n": [int(v) for v in np.bincount(inv, minlength=k)],
        "n_ab": count_where(lambda s: "ab" in s),
        "n_digit": count_where(lambda s: s[:1].isdigit() and s[:1].isascii()),
        "max_trim": _dict_rank_max(ccodes, cok, cdict, lambda s: s.strip(" "),
                                   inv, k),
        "min_pad": _dict_rank_max(ccodes, cok, cdict, lpad30, inv, k,
                                  use_max=False),
        "max_rep": _dict_rank_max(ccodes, cok, cdict,
                                  lambda s: s.replace("a", "A"), inv, k),
        "max_md5": _dict_rank_max(ccodes, cok, cdict, md5, inv, k)})
    # S8: labels, the two row hashes and rand(7) (one stream in row order)
    xx = _np_xx(D["l_shipdate"], _np_xx(price, np.full(
        len(price), 42, dtype=np.uint64), 8), 4).view(i64)
    vol = price * qty  # decimal(31,4), positive: its minimal bytes
    bitlen = np.frexp(vol.astype(np.float64))[1].astype(i64)  # exact < 2^53
    nbytes = bitlen // 8 + 1
    rows = np.zeros((len(vol), 8), dtype=np.uint8)
    for j in range(8):  # big-endian, left-aligned to each row's length
        shift = (nbytes - 1 - j) * 8
        rows[:, j] = np.where(j < nbytes, (vol >> np.clip(shift, 0, 63))
                              & 0xFF, 0)
    mm = _np_murmur3_bytes(rows, nbytes)
    heads = np.random.default_rng(7).random(len(vol)) < 0.5
    inv, uniq = _groups([rf, ls])
    k = len(uniq)
    # ORDER BY label DESC, status: two stable sorts
    order = sorted(range(k), key=lambda g: ls_dict[uniq[g, 1]])
    order = sorted(order, key=lambda g: rf_dict[uniq[g, 0]], reverse=True)
    xs = np.zeros(k, dtype=i64)
    ms = np.zeros(k, dtype=i64)
    np.add.at(xs, inv, np.fmod(xx, 1000))
    np.add.at(ms, inv, np.fmod(mm.astype(i64), 1000))
    hs = np.bincount(inv, weights=heads.astype(i64), minlength=k).astype(i64)
    n = np.bincount(inv, minlength=k)
    done("S8", {
        "label": ["flag|" + rf_dict[uniq[g, 0]] for g in order],
        "status": [ls_dict[uniq[g, 1]] + "#" for g in order],
        "xx": [int(xs[g]) for g in order],
        "mm": [int(ms[g]) for g in order],
        "heads": [int(hs[g]) for g in order],
        "n": [int(n[g]) for g in order]})
    return out


def dec128_edges():
    """The edge set of the DECIMAL128 division, as (mode, a, b, pow_a,
    pow_b, precision, what) with Python-int operands: a zero divisor,
    negative operands of each sign, a quotient at 10^38 - 1 and at 10^38,
    decimal(38,0) / decimal(38,38) (a 273-bit numerator) and 256-bit
    remainder operands."""
    big = 10 ** 38 - 1
    vals = [0, 1, -1, 7, -7, 2, -2, big, -big, 10 ** 19 + 3, -(2 ** 64),
            2 ** 63, 12345678901234567890123, 5 * 10 ** 37]
    pairs = [(a, b) for a in vals for b in vals]
    return [
        ("divide", pairs, 10 ** 6, 1, 38, "decimal(32,4)/decimal(15,2)"),
        ("divide", pairs, 10 ** 44, 1, 38, "decimal(38,0)/decimal(38,38)"),
        ("divide", pairs + [(big, 10), (-big, 10), (10 ** 37, 1),
                            (-(10 ** 37), 1), (big, 1)], 10, 1, 38,
         "quotients at 10^38 - 1 and 10^38"),
        ("remainder", pairs, 10 ** 38, 1, 38, "decimal(38,0)%decimal(38,38)"),
        ("remainder", pairs, 1, 10 ** 38, 38, "256-bit divisors"),
        ("pmod", pairs, 10 ** 38, 1, 38, "pmod at 256 bits"),
        ("pmod", pairs, 1, 100, 17, "decimal(32,4) pmod decimal(15,2)"),
    ]


def dec128_oracle(mode, a, b, pow_a, pow_b, precision):
    """The Python-int (Python ``decimal``-free) value of one row, None for
    null: HALF_UP on the magnitude with the sign of a / b, Java's %."""
    big_a, big_b = abs(a) * pow_a, abs(b) * pow_b
    if big_b == 0:
        return None
    if mode == "divide":
        q, r = divmod(big_a, big_b)
        q += 2 * r >= big_b
        v = -q if (a < 0) != (b < 0) else q
    else:
        r = big_a % big_b
        v = -r if a < 0 else r
        if mode == "pmod" and r and (a < 0) != (b < 0):
            v = (big_b - r) * (-1 if b < 0 else 1)
    return v if abs(v) < 10 ** precision else None


def _limb_streams(values):
    m64 = (1 << 64) - 1
    hi = torch.tensor([v >> 64 for v in values], dtype=torch.int64)
    lo = torch.tensor([(v & m64) - (1 << 64) if v & m64 >= 1 << 63
                       else v & m64 for v in values], dtype=torch.int64)
    return hi.to(DEV), lo.to(DEV)


def dec128_divide_ops(streams, pow_a: int, pow_b: int) -> float:
    """32-bit integer operations Knuth's algorithm D needs for these rows
    (what this run's data needs, not the most it could): a row of
    A = |a| x pow_a in m + n words over B = |b| x pow_b in n words takes
    (m + 1) x n multiply-adds, each counted as 2 operations (the multiply
    and the add), for the quotient's digits, as the kernel's 32-bit
    words do; invalid rows take none. Word counts from each operand's
    magnitude in float64 (its bit length to within one bit)."""
    a_hi, a_lo, b_hi, b_lo, valid = streams

    def bits(hi, lo):
        lo_u = lo.to(torch.float64) + (lo < 0).to(torch.float64) * 2.0 ** 64
        mag = hi.to(torch.float64) * 2.0 ** 64 + lo_u
        mag = torch.where(hi < 0, -mag, mag).clamp(min=1.0)
        return torch.floor(torch.log2(mag)) + 1

    num = bits(a_hi, a_lo) + math.log2(pow_a)
    den = bits(b_hi, b_lo) + math.log2(pow_b)
    n = torch.clamp(torch.ceil(den / 32), min=1)
    total = torch.maximum(torch.ceil(num / 32), n)
    ops = 2 * (total - n + 1) * n
    return float(torch.where(valid, ops, torch.zeros_like(ops)).sum())


def check_dec128div(s1_args) -> dict:
    """The DECIMAL128 division kernel bit for bit against its plain version
    on the card, at S1's three launches' operands sampled to 2^20 rows and
    on the edge set (both also against Python ints), then its time at
    S1's divide shape (CUDA events, median of 15, and 20 back to back)
    beside the plain version's and the byte bound."""
    from spark_rapids_tpu_torch.kernels.decimal import (
        dec128_divide,
        dec128_divide_plain,
    )
    m64 = (1 << 64) - 1
    sample = 1 << 20
    for args in s1_args:
        mode, streams, rest = args[0], args[1:6], args[6:]
        n = streams[0].shape[0]
        idx = torch.randperm(n, device=DEV)[:sample].sort().values
        cut = [t[idx].contiguous() for t in streams]
        got = dec128_divide(mode, *cut, *rest)
        want = dec128_divide_plain(mode, *cut, *rest)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"dec128_divide ({mode}, S1's operands, {len(idx)} rows) "
                 "differs from its plain version")
        # a few hundred rows against Python ints too
        host = [t[:512].tolist() for t in cut]
        for i in range(len(host[0])):
            a = (host[0][i] << 64) | (host[1][i] & m64)
            b = (host[2][i] << 64) | (host[3][i] & m64)
            w = dec128_oracle(mode, a, b, *rest) if host[4][i] else None
            g = ((int(got[0][i]) << 64) | (int(got[1][i]) & m64)) \
                if bool(got[2][i]) else None
            if g != w:
                fail(f"dec128_divide ({mode}) row {i}: {g}, Python ints {w}")
        log(f"  dec128_divide ({mode}): bit for bit with its plain version "
            f"on {len(idx)} sampled rows of S1's operands, and with Python "
            "ints on 512 of them")
    n_edges = 0
    for mode, pairs, pow_a, pow_b, prec, what in dec128_edges():
        a_hi, a_lo = _limb_streams([a for a, _ in pairs])
        b_hi, b_lo = _limb_streams([b for _, b in pairs])
        valid = torch.ones(len(pairs), dtype=torch.bool, device=DEV)
        got = dec128_divide(mode, a_hi, a_lo, b_hi, b_lo, valid, pow_a,
                            pow_b, prec)
        want = dec128_divide_plain(mode, a_hi, a_lo, b_hi, b_lo, valid,
                                   pow_a, pow_b, prec)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            fail(f"dec128_divide edge set {what}: differs from its plain "
                 "version")
        hi, lo, ok = (t.tolist() for t in got)
        for i, (a, b) in enumerate(pairs):
            g = ((hi[i] << 64) | (lo[i] & m64)) if ok[i] else None
            if g != dec128_oracle(mode, a, b, pow_a, pow_b, prec):
                fail(f"dec128_divide edge {what} ({a}, {b}): {g}")
        n_edges += len(pairs)
    log(f"  dec128_divide: the edge set ({n_edges} rows: zero divisors, "
        "negative operands, quotients at 10^38 - 1 and 10^38, a 273-bit "
        "numerator, 256-bit remainder operands) bit for bit with its plain "
        "version and with Python ints")
    mode, streams, rest = s1_args[0][0], s1_args[0][1:6], s1_args[0][6:]
    n = streams[0].shape[0]

    def kernel():
        return dec128_divide(mode, *streams, *rest)

    def plain():
        return dec128_divide_plain(mode, *streams, *rest)

    before = dec128_divide.launches
    ms = time_ms(kernel)
    ms_b2b = time_ms(kernel, calls=BACK_TO_BACK)
    # the plain version ran on the sampled rows above: warm, and 2.6 s a
    # call at this shape, so two calls (a third and a warm-up cost 5 s of
    # the script's limit)
    plain_ms = time_ms(plain, iters=2, warmup=0)
    dec128_divide.launches = before
    # each row reads two (hi, lo) operands and a validity byte and writes
    # a (hi, lo) result and a validity byte; the operations are algorithm
    # D's multiply-adds at these rows' word counts (dec128_divide_ops);
    # the bound is the larger of the two times
    nbytes = n * (2 * 16 + 1 + 16 + 1)
    ops = dec128_divide_ops(streams, rest[0], rest[1])
    bnd, by = bound_ms(nbytes, ops, INT32_OPS_PER_S)
    log(f"  dec128_divide time at S1's divide ({n} rows, decimal(32,4) / "
        f"decimal(15,2)): kernel {ms:.4f} ms [{ms_b2b:.4f} {BACK_TO_BACK} "
        f"back to back], plain version {plain_ms:.2f} ms, bound "
        f"{bnd:.4f} ms ({by}; bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f} "
        f"ms, {ops:.0f} 32-bit operations {ops / INT32_OPS_PER_S * 1e3:.4f}"
        " ms), no PyTorch call computes it")
    return {"name": "dec128_divide", "max_abs_err": 0.0, "ms": ms_b2b,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": None}


def scalar_session(tables, dec, session):
    """Temp views lineitem, orders, customer and lineitem_dec on
    ``session`` (the port's; a test passes the reference's too)."""
    from spark_rapids_tpu_torch.plan import from_host_table
    for name in ("lineitem", "orders", "customer"):
        from_host_table(tables[name], session).create_or_replace_temp_view(
            name)
    from_host_table(dec, session).create_or_replace_temp_view("lineitem_dec")


def run_scalars(tables, sf: float, seed: int, profile_dir) -> tuple:
    """Phase 12: S1-S8 (``SCALAR_QUERIES``) over temp views of phases
    6-11's tables through ``TorchSession.sql``, each through ``run_case``
    against its oracle; S1 must launch the DECIMAL128 division kernel
    three times a run (divide, remainder, pmod), whose launches are then
    checked and timed (``check_dec128div``). Returns (every kernel's
    launches summed over the counted runs, the inputs of S1's division
    launches: divide first)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.ops import arithmetic as A
    from spark_rapids_tpu_torch.ops import math as M
    from spark_rapids_tpu_torch.session import TorchSession
    from types import SimpleNamespace

    zone = SCALAR_ZONE if zone_available(SCALAR_ZONE) else SCALAR_FIXED_ZONE
    log(f"  S5's zone: {zone}" + ("" if zone == SCALAR_ZONE else
                                  f" ({SCALAR_ZONE} is not in this "
                                  "machine's zoneinfo database)"))
    t0 = time.perf_counter()
    dec = lineitem_dec(tables, seed)
    log(f"  lineitem_dec ({dec.num_rows} rows) in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    t0 = time.perf_counter()
    oracles = scalar_oracles(tables, dec, zone)
    log(f"  the oracles in {time.perf_counter() - t0:.2f} s (host)")
    register_scalar_functions(F, SimpleNamespace(Pmod=A.Pmod,
                                                 BitwiseAnd=M.BitwiseAnd))
    session = TorchSession()
    scalar_session(tables, dec, session)
    texts = scalar_texts(zone)
    total, summary = {}, {}
    for name in SCALAR_QUERIES:
        prof = profile_dir if name in ("S1", "S2", "S5", "S7", "S8") else None
        res = run_case(session, name, lambda t=texts[name]: session.sql(t),
                       oracles[name], prof, warm_runs=1)
        for k, v in res["launches"].items():
            total[k] = total.get(k, 0) + v
        summary[name] = dict(res["stats"], launches={
            k: v for k, v in res["launches"].items() if v})
        log(f"  {name}: result matches its oracle")
    got = summary["S1"]["launches"].get("dec128_divide")
    if got != 3:
        fail(f"S1 launched dec128_divide {got} times, want 3 (divide, "
             "remainder, pmod)")
    log("  phase-12 summary: " + json.dumps(summary))
    # S1 once more, its division launches' inputs kept for the kernel's
    # checks and times (launches outside the counted runs)
    K.calls = []
    session.sql(texts["S1"]).collect_table()
    s1_args = sorted((inputs for kernel, inputs, _ in K.calls
                      if kernel == "dec128_divide"),
                     key=lambda a: a[0] != "divide")
    K.calls = None
    return total, s1_args


# ---------------------------------------------------------------------------
# phase 13: the window queries (W1-W8)
# ---------------------------------------------------------------------------

#: the window texts of phase 13 (TPC-DS shapes: W1 q47/q57's neighbours,
#: W2 q51's cumulative sums, W3 q12/q20/q98's ratios, W4 moving windows,
#: W5 q49's partition-less ranks); W8a-d run over ``lineitem4``, lineitem
#: in 4 input batches with its row number ``l_row``
_CUST_ORDER = "PARTITION BY o_custkey ORDER BY o_orderdate, o_orderkey"
_FLAG_ORDER = "PARTITION BY l_returnflag ORDER BY l_shipdate, l_orderkey"
WINDOW_SQL = {
    "W1": f"""SELECT o_orderkey,
        LAG(o_totalprice, 1) OVER ({_CUST_ORDER}) AS prev_price,
        LEAD(o_orderdate, 1) OVER ({_CUST_ORDER}) AS next_date,
        LAG(o_orderkey, 2, -1) OVER ({_CUST_ORDER}) AS prev2_key
        FROM orders""",
    "W2": """SELECT l_shipdate,
        SUM(l_extendedprice) OVER (PARTITION BY l_returnflag, l_linestatus
            ORDER BY l_shipdate ROWS BETWEEN UNBOUNDED PRECEDING AND
            CURRENT ROW) AS run_price,
        SUM(l_quantity) OVER (PARTITION BY l_returnflag, l_linestatus
            ORDER BY l_shipdate) AS run_qty,
        COUNT(*) OVER (PARTITION BY l_returnflag, l_linestatus
            ORDER BY l_shipdate) AS run_cnt
        FROM lineitem""",
    "W3": """SELECT o_orderkey, o_totalprice * 100 / cust_total AS pct,
        cust_avg, cust_cnt, first_date, max_price
        FROM (SELECT o_orderkey, o_totalprice,
            SUM(o_totalprice) OVER (PARTITION BY o_custkey) AS cust_total,
            AVG(o_totalprice) OVER (PARTITION BY o_custkey) AS cust_avg,
            COUNT(*) OVER (PARTITION BY o_custkey) AS cust_cnt,
            MIN(o_orderdate) OVER (PARTITION BY o_custkey) AS first_date,
            MAX(o_totalprice) OVER (PARTITION BY o_custkey) AS max_price
            FROM orders)""",
    "W4": f"""SELECT o_orderkey,
        AVG(o_totalprice) OVER ({_CUST_ORDER} ROWS BETWEEN 2 PRECEDING AND
            2 FOLLOWING) AS avg5,
        MIN(o_totalprice) OVER ({_CUST_ORDER} ROWS BETWEEN 6 PRECEDING AND
            CURRENT ROW) AS min7,
        MAX(o_totalprice) OVER ({_CUST_ORDER} ROWS BETWEEN CURRENT ROW AND
            UNBOUNDED FOLLOWING) AS max_rest
        FROM orders""",
    "W5": """SELECT o_orderkey,
        PERCENT_RANK() OVER (ORDER BY o_totalprice) AS pr,
        ROW_NUMBER() OVER (ORDER BY o_totalprice, o_orderkey) AS rn
        FROM orders""",
    "W6": """SELECT o_orderkey,
        RANK() OVER (PARTITION BY o_custkey ORDER BY o_totalprice DESC)
            AS price_rank,
        NTH_VALUE(o_orderkey, 2) OVER (PARTITION BY o_custkey
            ORDER BY o_orderdate) AS second_key,
        DENSE_RANK() OVER (PARTITION BY o_orderdate
            ORDER BY o_totalprice DESC) AS day_rank
        FROM orders""",
    "W7": f"""SELECT l_shipdate,
        SUM(l_extendedprice) OVER ({_FLAG_ORDER} ROWS BETWEEN 1000 PRECEDING
            AND 1000 FOLLOWING) AS wsum,
        MAX(l_quantity) OVER ({_FLAG_ORDER} ROWS BETWEEN 1000 PRECEDING
            AND 1000 FOLLOWING) AS wmax
        FROM lineitem""",
    "W8a": """SELECT l_row, LAG(l_quantity) OVER (PARTITION BY l_orderkey
        ORDER BY l_shipdate, l_row) AS prev_qty FROM lineitem4""",
    "W8b": """SELECT l_row, SUM(l_extendedprice) OVER (PARTITION BY
        l_orderkey) AS order_total FROM lineitem4""",
    "W8c": """SELECT l_row, AVG(l_extendedprice) OVER (PARTITION BY
        l_returnflag ORDER BY l_shipdate, l_orderkey, l_row ROWS BETWEEN 3
        PRECEDING AND 3 FOLLOWING) AS avg7 FROM lineitem4""",
    "W8d": """SELECT l_row, SUM(l_quantity) OVER (ORDER BY l_shipdate,
        l_orderkey, l_row ROWS UNBOUNDED PRECEDING) AS run_qty
        FROM lineitem4""",
}
#: the order phase 13 runs them in
W_QUERIES = tuple(WINDOW_SQL)
#: the multi-batch route each W8 query must take: its metric
W8_ROUTES = {"W8a": "keyBatchedPartitions", "W8b": "twoPassPartitions",
             "W8c": "boundedWindowBatches", "W8d": "runningWindowBatches"}
#: input batches of ``lineitem4``, and the W8 session's range target
#: (``spark.rapids.sql.window.streamTargetRows``)
W8_BATCHES = 4
W8_STREAM_ROWS = 1 << 21


def lineitem4(tables):
    """lineitem's columns W8 reads, with the row number ``l_row``."""
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    from spark_rapids_tpu_torch import types as TT
    li = tables["lineitem"]
    names = ("l_orderkey", "l_quantity", "l_extendedprice", "l_returnflag",
             "l_shipdate")
    cols = [li.columns[li.names.index(n)] for n in names]
    row = HostColumn(TT.LONG, np.arange(li.num_rows, dtype=np.int64))
    return HostTable(("l_row",) + names, [row] + cols)


def window_layout(parts, orders):
    """The sorted structure of a window spec, in numpy: rows sorted
    stably by (partition keys, order keys; ties in input order); per
    sorted row its segment's start and end and its peer group's start
    and end (positions in sort order), and the sort order itself."""
    n = len((parts or orders)[0])
    order = _stable_order(list(parts) + list(orders), n)

    def breaks(cols):
        new = np.zeros(n, dtype=bool)
        new[0] = True
        for c in cols:
            s = np.asarray(c)[order]
            new[1:] |= s[1:] != s[:-1]
        return new

    def span(new):
        pos = np.arange(n)
        starts = np.flatnonzero(new)
        gid = np.cumsum(new) - 1
        ends = np.append(starts[1:], n) - 1
        return starts[gid], ends[gid]

    new_seg = breaks(parts)
    seg_start, seg_end = span(new_seg)
    peer_start, peer_last = span(new_seg | breaks(orders))
    return {"order": order, "seg_start": seg_start, "seg_end": seg_end,
            "peer_start": peer_start, "peer_last": peer_last,
            "new_seg": new_seg}


def _stable_order(keys, n):
    """The rows in key order, ties in input order: one np.sort of int64
    words packing each integer key's offset from its minimum and the row
    number, when they fit in 63 bits; np.lexsort otherwise."""
    row_bits = max(n - 1, 1).bit_length()
    bits, packed = row_bits, []
    for k in keys:
        k = np.asarray(k)
        if k.dtype.kind not in "iub":
            packed = None
            break
        lo = int(k.min())
        width = max(int(k.max()) - lo, 1).bit_length()
        packed.append((k, lo, width))
        bits += width
    if packed is None or bits > 63:
        return np.lexsort([np.arange(n)] + [np.asarray(k)
                                            for k in reversed(keys)])
    word = np.zeros(n, dtype=np.int64)
    for k, lo, width in packed:
        word = (word << width) | (k.astype(np.int64) - lo)
    word = (word << row_bits) | np.arange(n, dtype=np.int64)
    return np.sort(word) & ((1 << row_bits) - 1)


def _in_input_order(lay, sorted_values):
    out = np.empty_like(sorted_values)
    out[lay["order"]] = sorted_values
    return out


def _shift(lay, values, off):
    """(values ``off`` rows away within the segment, whether there is
    one), both in input order."""
    n = len(values)
    pos = np.arange(n)
    j = pos + off
    ok = (j >= lay["seg_start"]) & (j <= lay["seg_end"])
    vs = np.asarray(values)[lay["order"]]
    got = np.where(ok, vs[np.clip(j, 0, n - 1)], np.zeros(1, vs.dtype))
    return _in_input_order(lay, got), _in_input_order(lay, ok)


def _offset_sum(lay, values, lo, hi):
    """(the frame sum offset by offset in order lo..hi, the frame's row
    count), in input order: the port's per-offset sum, bit for bit."""
    n = len(values)
    pos = np.arange(n)
    vs = np.asarray(values, dtype=np.float64)[lay["order"]]
    total = np.zeros(n)
    cnt = np.zeros(n, dtype=np.int64)
    for k in range(lo, hi + 1):
        j = pos + k
        inside = (j >= lay["seg_start"]) & (j <= lay["seg_end"])
        total = total + np.where(inside, vs[np.clip(j, 0, n - 1)], 0.0)
        cnt += inside
    return _in_input_order(lay, total), _in_input_order(lay, cnt)


def _seg_prefix(lay, values):
    """The inclusive prefix sum within each segment, in sort order (one
    cumsum a segment: no cancellation across segments)."""
    vs = np.asarray(values)[lay["order"]]
    out = np.empty(len(vs), dtype=vs.dtype)
    starts = np.flatnonzero(lay["new_seg"])
    for a, b in zip(starts, np.append(starts[1:], len(vs))):
        out[a:b] = np.cumsum(vs[a:b])
    return out


def _range_max(values, a, b, width):
    """max over [a, b] per row through a doubling table (b - a < width),
    exact for integers."""
    levels = [np.asarray(values)]
    span = 1
    while span < width:
        prev = levels[-1]
        nxt = prev.copy()
        nxt[:-span] = np.maximum(prev[:-span], prev[span:])
        levels.append(nxt)
        span *= 2
    k = np.floor(np.log2(np.maximum(b - a + 1, 1))).astype(np.int64)
    tab = np.stack(levels)
    return np.maximum(tab[k, a], tab[k, b - (1 << k) + 1])


def check_window(got, want, what, order_by=None, close=(),
                 mass=None) -> None:
    """The result against the oracle's ``want`` ({name: (values,
    validity)} in the output's column order, rows in input order): with
    ``order_by`` the result's rows first sort by that column (a row
    number); validity exact, valid values exact (doubles bit for bit),
    the ``close`` columns within rtol 1e-9, and the ``mass`` columns
    ({name: frame sums of |v|}) within 1e-9 of that mass."""
    if list(got.names) != list(want):
        fail(f"{what}: columns {list(got.names)}, oracle {list(want)}")
    cols = dict(zip(got.names, got.columns))
    order = slice(None)
    if order_by is not None:
        # a row number: its inverse permutation puts the rows in order
        key = cols[order_by].data
        order = np.zeros(len(key), dtype=np.int64)
        order[np.clip(key, 0, len(key) - 1)] = np.arange(len(key))
    mass = mass or {}
    for name, (w, wv) in want.items():
        c = cols[name]
        g, gv = c.data[order], c.validity[order]
        w = np.asarray(w)
        wv = np.broadcast_to(np.asarray(wv, dtype=bool), g.shape)
        if len(g) != len(w):
            fail(f"{what}: {len(g)} rows, oracle {len(w)}")
        if not np.array_equal(gv, wv):
            i = int(np.flatnonzero(gv != wv)[0])
            fail(f"{what} {name} row {i}: validity {bool(gv[i])}, oracle "
                 f"{bool(wv[i])}")
        g, w = g[wv], w[wv]
        if name in mass:
            bad = np.abs(g - w) > 1e-9 * np.asarray(mass[name])[wv]
        elif name in close:
            bad = ~np.isclose(g, w, rtol=1e-9, atol=0)
        else:
            bad = g.view(np.uint8).reshape(len(g), -1) != \
                w.astype(g.dtype).view(np.uint8).reshape(len(w), -1)
            bad = bad.any(axis=1)
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            fail(f"{what} {name}: valid row {i} {g[i]!r}, oracle {w[i]!r}"
                 + (" (rtol 1e-9)" if name in close or name in mass
                    else " (exact)"))


def w_oracles(tables, w8):
    """{query: check(got)} of W1-W8, each computed in numpy from the host
    tables, independently of the port: stable lexsorts, then segment
    arithmetic (f64 sums within rtol 1e-9, W7's wide frame within 1e-9 of
    its absolute mass, everything else exact)."""
    o = host_cols(tables["orders"])
    li = host_cols(tables["lineitem"])
    lcols = dict(zip(tables["lineitem"].names, tables["lineitem"].columns))
    rf = lcols["l_returnflag"].encoded()[0]
    ls = lcols["l_linestatus"].encoded()[0]
    ok_, ck, od, price = (o["o_orderkey"], o["o_custkey"], o["o_orderdate"],
                          o["o_totalprice"])
    n_o, n_l = len(ok_), len(li["l_orderkey"])
    checks = {}

    # W1: lag, lead and a lag with a default, per customer
    lay = window_layout([ck], [od, ok_])
    pp, pv = _shift(lay, price, -1)
    nd, nv = _shift(lay, od, 1)
    p2, p2v = _shift(lay, ok_, -2)
    w1 = {"o_orderkey": (ok_, True), "prev_price": (pp, pv),
          "next_date": (nd, nv), "prev2_key": (np.where(p2v, p2, -1), True)}
    checks["W1"] = lambda got: check_window(got, w1, "W1")

    # W2: running sums per (flag, status) over shipdate peers
    lay = window_layout([rf, ls], [li["l_shipdate"]])
    run_price = _in_input_order(lay, _seg_prefix(lay, li["l_extendedprice"]))
    qpref = _seg_prefix(lay, li["l_quantity"].astype(np.int64))
    pl = lay["peer_last"]
    run_qty = _in_input_order(lay, qpref[pl])
    run_cnt = _in_input_order(lay, (pl - lay["seg_start"] + 1).astype(
        np.int64))
    w2 = {"l_shipdate": (li["l_shipdate"], True),
          "run_price": (run_price, True), "run_qty": (run_qty, True),
          "run_cnt": (run_cnt, True)}
    checks["W2"] = lambda got: check_window(got, w2, "W2",
                                            close=("run_price",))

    # W3: whole-partition aggregates per customer and the ratio over them
    k = int(ck.max()) + 1
    total = np.bincount(ck, weights=price, minlength=k)
    cnt = np.bincount(ck, minlength=k).astype(np.int64)
    first = np.full(k, np.iinfo(np.int32).max, dtype=np.int32)
    np.minimum.at(first, ck, od)
    mx = np.full(k, -np.inf)
    np.maximum.at(mx, ck, price)
    w3 = {"o_orderkey": (ok_, True),
          "pct": (price * 100 / total[ck], True),
          "cust_avg": (total[ck] / cnt[ck], True),
          "cust_cnt": (cnt[ck], True), "first_date": (first[ck], True),
          "max_price": (mx[ck], True)}
    checks["W3"] = lambda got: check_window(got, w3, "W3",
                                            close=("pct", "cust_avg"))

    # W4: moving windows per customer
    lay = window_layout([ck], [od, ok_])
    s5, c5 = _offset_sum(lay, price, -2, 2)
    ps = price[lay["order"]]
    pos = np.arange(n_o)
    m7 = np.full(n_o, np.inf)
    for off in range(-6, 1):
        j = pos + off
        inside = j >= lay["seg_start"]
        m7 = np.where(inside, np.minimum(m7, ps[np.clip(j, 0, n_o - 1)]), m7)
    # the maximum from each row to its segment's end: a running max of
    # (segment rank, value rank) keys over the reversed sort order
    uniq, rank = np.unique(ps, return_inverse=True)
    seg_rank = np.cumsum(lay["new_seg"]) - 1
    key = (seg_rank.max() - seg_rank) * len(uniq) + rank
    rest = uniq[np.maximum.accumulate(key[::-1])[::-1] % len(uniq)]
    w4 = {"o_orderkey": (ok_, True), "avg5": (s5 / c5, True),
          "min7": (_in_input_order(lay, m7), True),
          "max_rest": (_in_input_order(lay, rest), True)}
    checks["W4"] = lambda got: check_window(got, w4, "W4")

    # W5: partition-less percent_rank and row_number
    srt = np.sort(price, kind="stable")
    rank = np.searchsorted(srt, price, "left") + 1
    pr = (rank - 1.0) / max(n_o - 1.0, 1.0)
    rn = np.empty(n_o, dtype=np.int32)
    rn[np.lexsort((ok_, price))] = np.arange(1, n_o + 1, dtype=np.int32)
    w5 = {"o_orderkey": (ok_, True), "pr": (pr, True), "rn": (rn, True)}
    checks["W5"] = lambda got: check_window(got, w5, "W5")

    # W6: three specs over different partition keys
    lay = window_layout([ck], [-price])
    price_rank = _in_input_order(
        lay, (lay["peer_start"] - lay["seg_start"] + 1).astype(np.int32))
    lay2 = window_layout([ck], [od])
    at = lay2["seg_start"] + 1
    avail = (at <= lay2["peer_last"]) & (at <= lay2["seg_end"])
    second = np.where(avail, ok_[lay2["order"]][np.clip(at, 0, n_o - 1)], 0)
    lay3 = window_layout([od], [-price])
    newp = np.zeros(n_o, dtype=bool)
    newp[lay3["peer_start"]] = True
    dense = np.cumsum(newp) - np.cumsum(newp)[lay3["seg_start"]] + 1
    w6 = {"o_orderkey": (ok_, True), "price_rank": (price_rank, True),
          "second_key": (_in_input_order(lay2, second),
                         _in_input_order(lay2, avail)),
          "day_rank": (_in_input_order(lay3, dense.astype(np.int32)), True)}
    checks["W6"] = lambda got: check_window(got, w6, "W6")

    # W7: a 2001-row frame per return flag: prefix difference and the
    # doubling table
    lay = lay7 = window_layout([rf], [li["l_shipdate"], li["l_orderkey"]])
    pos = np.arange(n_l)
    a = np.maximum(lay["seg_start"], pos - 1000)
    b = np.minimum(lay["seg_end"], pos + 1000)
    pref = _seg_prefix(lay, li["l_extendedprice"])
    before = np.where(a > lay["seg_start"], pref[np.maximum(a - 1, 0)], 0.0)
    wsum = _in_input_order(lay, pref[b] - before)
    q = li["l_quantity"][lay["order"]].astype(np.int16)
    wmax = _in_input_order(lay, _range_max(q, a, b, 2001).astype(np.int64))
    w7 = {"l_shipdate": (li["l_shipdate"], True), "wsum": (wsum, True),
          "wmax": (wmax, True)}
    # the prices are positive: each frame's absolute mass is its sum
    checks["W7"] = lambda got: check_window(got, w7, "W7",
                                            mass={"wsum": wsum})

    # W8: the same shapes over lineitem4, rows compared by l_row
    c8 = dict(zip(w8.names, w8.columns))
    row = c8["l_row"].data
    okey, qty = c8["l_orderkey"].data, c8["l_quantity"].data
    ship, ext = c8["l_shipdate"].data, c8["l_extendedprice"].data
    # (l_row, the SQL's last order key, is the oracle's input order)
    lay = window_layout([okey], [ship])
    prev, pv = _shift(lay, qty, -1)
    w8a = {"l_row": (row, True), "prev_qty": (prev, pv)}
    checks["W8a"] = lambda got: check_window(got, w8a, "W8a",
                                             order_by="l_row")
    tot = np.bincount(okey, weights=ext)
    w8b = {"l_row": (row, True), "order_total": (tot[okey], True)}
    checks["W8b"] = lambda got: check_window(
        got, w8b, "W8b", order_by="l_row", close=("order_total",))
    # W8c's sort is W7's: l_row is the input order lexsort breaks ties by
    s7, c7 = _offset_sum(lay7, ext, -3, 3)
    w8c = {"l_row": (row, True), "avg7": (s7 / c7, True)}
    checks["W8c"] = lambda got: check_window(got, w8c, "W8c",
                                             order_by="l_row")
    lay = window_layout([], [ship, okey])
    run = _in_input_order(lay, np.cumsum(qty[lay["order"]]))
    w8d = {"l_row": (row, True), "run_qty": (run, True)}
    checks["W8d"] = lambda got: check_window(got, w8d, "W8d",
                                             order_by="l_row")
    return checks


def run_windows(tables, profile_dir) -> dict:
    """Phase 13: W1-W8 (``W_QUERIES``) through ``TorchSession.sql``
    over temp views of phases 6-12's tables (W8 over ``lineitem4`` in
    ``W8_BATCHES`` input batches, on a session whose ranges hold
    ``W8_STREAM_ROWS`` rows), each through ``run_case`` against its numpy
    oracle; every query must launch the radix sort, and each W8 query
    must take its route (``W8_ROUTES``, read from ``last_metrics()``).
    ``--profile`` traces W1, W3, W4, W7, W8a and W8c. Returns every
    kernel's launches summed over the counted runs."""
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.session import TorchSession
    t0 = time.perf_counter()
    w8 = lineitem4(tables)
    oracles = w_oracles(tables, w8)
    log(f"  the numpy oracles in {time.perf_counter() - t0:.2f} s (host)")
    session = TorchSession()
    for name in ("lineitem", "orders"):
        from_host_table(tables[name], session).create_or_replace_temp_view(
            name)
    s8 = TorchSession({"spark.rapids.sql.window.streamTargetRows":
                       str(W8_STREAM_ROWS)})
    from_host_table(w8, s8, num_batches=W8_BATCHES) \
        .create_or_replace_temp_view("lineitem4")
    total, summary = {}, {}
    for name in W_QUERIES:
        sess = s8 if name.startswith("W8") else session
        prof = profile_dir if name in ("W1", "W3", "W4", "W7", "W8a",
                                       "W8c") else None
        res = run_case(sess, name, lambda t=WINDOW_SQL[name], s=sess:
                       s.sql(t), oracles[name], prof, warm_runs=1)
        for k, v in res["launches"].items():
            total[k] = total.get(k, 0) + v
        summary[name] = dict(res["stats"], launches={
            k: v for k, v in res["launches"].items() if v})
        if name in W8_ROUTES:
            metrics = sess.last_metrics()
            got = metrics.get(W8_ROUTES[name], 0)
            if not got:
                fail(f"{name} did not take its route: no "
                     f"{W8_ROUTES[name]} in {metrics}")
            summary[name]["metrics"] = {
                k: v for k, v in metrics.items() if k != "speculationReplays"}
            log(f"  {name}: {W8_ROUTES[name]} = {got} ({metrics})")
        if not res["launches"].get("sort_with_payload"):
            fail(f"{name} launched no sort_with_payload")
        log(f"  {name}: result matches its numpy oracle")
    log("  phase-13 summary: " + json.dumps(summary))
    return total


# ---------------------------------------------------------------------------
# phase 14: the memory runtime
# ---------------------------------------------------------------------------

#: host syncs in the counted warm run of each query of phases 5-13 in the
#: last run of this script before the memory runtime existed (on an
#: NVIDIA H100 80GB HBM3 at 700.00 W): under the default device budget
#: the runtime may add none, so no query may take more
BASELINE_WARM_SYNCS = {
    'q3 dense': 12, 'q3 sparse': 15, 'q3 sparse, 8 attempts': 13, 'q8': 4,
    'q2': 4, 'q8 inner': 6, 'q8 inner, sparse keys': 8,
    'min/max group-by': 12, 'global min/max': 8, 'q1': 14, 'q3': 10, 'q4': 9,
    'q5': 11, 'q9': 9, 'q10': 7, 'q11': 8, 'q12': 10, 'q13': 9, 'q14': 6,
    'q15': 9, 'q16': 8, 'q17': 7, 'q18': 14, 'q19': 4, 'q20': 13, 'q22': 10,
    'q6': 14, 'q7': 10, 'q21': 9, 'q1 SQL': 14, 'q2 SQL': 4, 'q3 SQL': 10,
    'q4 SQL': 9, 'q5 SQL': 11, 'q6 SQL': 14, 'q7 SQL': 10, 'q8 SQL': 4,
    'q9 SQL': 9, 'q10 SQL': 7, 'q11 SQL': 8, 'q12 SQL': 10, 'q13 SQL': 9,
    'q14 SQL': 6, 'q15 SQL': 9, 'q16 SQL': 8, 'q17 SQL': 7, 'q18 SQL': 14,
    'q19 SQL': 4, 'q20 SQL': 13, 'q21 SQL': 9, 'q22 SQL': 10,
    'conditional query': 17, 'TPC-H q1 SQL': 22, 'TPC-H q3 dense SQL': 12,
    'TPC-H q3 sparse SQL': 15, 'J1': 13, 'J2': 13, 'J3': 12, 'J4': 11,
    'J5': 11, 'J6': 11, 'J7': 9, 'J8': 16, 'J9': 10, 'J10': 7, 'J11': 10,
    'J12': 12, 'J3 sparse': 12, 'J12 sparse': 12, 'J1 sub-partitioned': 57,
    'J8 sub-partitioned': 30, 'J7 per-tile partials': 521, 'O1': 22, 'O2': 38,
    'O3': 12, 'O4a': 11, 'O4b': 5, 'O5': 17, 'O6a': 7, 'O6b': 7, 'O7': 15,
    'O8a': 8, 'O8b': 8, 'S1': 14, 'S2': 11, 'S3': 16, 'S4': 16, 'S5': 19,
    'S6a': 21, 'S6b': 7, 'S7': 21, 'S8': 15, 'W1': 11, 'W2': 12, 'W3': 16,
    'W4': 12, 'W5': 10, 'W6': 13, 'W7': 10, 'W8a': 33, 'W8b': 39, 'W8c': 126,
    'W8d': 93,
}
#: a squeezed budget is the query's unsqueezed peak accounted bytes over
#: this
SQUEEZE = 4
#: the ORDER BY of phase 14's squeezed set (over ``lineitem4`` in
#: ``W8_BATCHES`` batches; the key is unique, so every route gives one
#: order)
ORDER_BY_SQL = ("SELECT * FROM lineitem4 ORDER BY l_shipdate, l_orderkey, "
                "l_row")
#: the host tier (``spark.rapids.memory.host.spillStorageSize``) of the
#: run whose spills must go to disk: the squeezed budget over this
DISK_RUN_HOST_SHARE = 4
#: the injections of phase 14 and the queries they run on
INJECTIONS = ("retry:2", "split:1")
#: threads and device slots (``spark.rapids.sql.concurrentGpuTasks``) of
#: the semaphore run
SEM_THREADS, SEM_SLOTS = 4, 2
#: the spill-rate table: rows and int64 columns, the pinned pool of its
#: pooled run, and the runs of each median
SPILL_RATE_ROWS, SPILL_RATE_COLS = 1 << 24, 7
SPILL_RATE_POOL = 256 << 20
SPILL_RATE_RUNS = 5


def runtime_counters() -> dict:
    """The process-wide memory and spill counters."""
    from spark_rapids_tpu_torch.obs.metrics import scopes_snapshot
    snap = scopes_snapshot()
    return {**snap.get("memory", {}), **snap.get("spill", {})}


def fresh_device() -> None:
    """Nothing cached on the card: the scan's device images dropped and
    torch's free blocks returned, so a run's peak is its own."""
    import gc

    from spark_rapids_tpu_torch.columnar.table import evict_device_caches
    evict_device_caches()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def check_default_budget(session, before: dict) -> None:
    """14.1: the device manager's report; then phases 4-13 under the
    default budget: no budget violation, no arbiter spill, and no warm
    query with more host syncs than in the baseline run."""
    from spark_rapids_tpu_torch.runtime.memory import MEMORY
    mgr = session.runtime
    MEMORY.configure(session.conf)
    free, total = torch.cuda.mem_get_info(DEV)
    log(f"  {card_line()}")
    log(f"  mem_get_info: total {total} B ({total / 2**30:.2f} GiB), free "
        f"{free} B ({free / 2**30:.2f} GiB)")
    log(f"  device budget at allocFraction 0.9 less the 640 MiB reserve: "
        f"{mgr.info.hbm_limit_bytes} B ({mgr.info.hbm_limit_bytes / 2**30:.2f}"
        f" GiB); the arbiter's budget {MEMORY.budget_bytes()} B, scan chunk "
        f"{MEMORY.scan_chunk_bytes()} B ({MEMORY.scan_chunk_bytes() / 2**30:.2f}"
        f" GiB)")
    if MEMORY.budget_bytes() != mgr.info.hbm_limit_bytes:
        fail("the arbiter's default budget is not the device manager's")
    after = runtime_counters()
    for k in ("budgetViolations", "arbiterSpills"):
        d = after.get(k, 0) - before.get(k, 0)
        log(f"  phases 4-13 under the default budget: {k} {d}")
        if d:
            fail(f"phases 4-13 counted {d} {k} under the default budget")
    risen = {n: (c, BASELINE_WARM_SYNCS[n]) for n, c in WARM_SYNCS.items()
             if n in BASELINE_WARM_SYNCS and c > BASELINE_WARM_SYNCS[n]}
    fell = {n: (c, BASELINE_WARM_SYNCS[n]) for n, c in WARM_SYNCS.items()
            if n in BASELINE_WARM_SYNCS and c < BASELINE_WARM_SYNCS[n]}
    unmatched = sorted(set(WARM_SYNCS) ^ set(BASELINE_WARM_SYNCS))
    log(f"  host syncs of {len(WARM_SYNCS)} warm queries against the "
        "baseline's: "
        f"{len(WARM_SYNCS) - len(risen) - len(fell)} equal, fewer "
        f"{fell} (now, baseline), not in both runs {unmatched}")
    if risen:
        fail(f"warm queries with more host syncs than in the baseline run "
             f"(now, baseline): {risen}")


def counted_run(session, name, build, hold=True):
    """One run of ``build()``: (result, last_metrics, launches, the run's
    peak accounted bytes, seconds). With ``hold`` every kernel launch of
    the run is held against its plain version (``hold_launches``)."""
    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.runtime.memory import MEMORY
    K.reset_launch_counts()
    K.calls = [] if hold else None
    t0 = time.perf_counter()
    try:
        got = build().collect_table()
        torch.cuda.synchronize()
    finally:
        calls, K.calls = K.calls, None
    dt = time.perf_counter() - t0
    launches = K.launch_counts()
    peak = MEMORY.peak_bytes()
    if hold:
        hold_launches(name, calls)
    del calls
    return got, session.last_metrics(), launches, peak, dt


def squeeze_cases(tables, w8):
    """{name: (session factory over a conf, query over a session, f64
    rtol, the unique key a result without an order is compared in)} of
    phase 14's squeezed set: corpus q3, J1, the ORDER BY of lineitem, W8b
    and W8c."""
    from spark_rapids_tpu_torch.models.corpus import build_queries
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.session import TorchSession

    def over(tabs, conf, batches=1):
        def make(extra):
            sess = TorchSession({**conf, **(extra or {})})
            for n, t in tabs.items():
                from_host_table(t, sess, num_batches=batches) \
                    .create_or_replace_temp_view(n)
            return sess
        return make

    w8conf = {"spark.rapids.sql.window.streamTargetRows": str(W8_STREAM_ROWS)}
    corpus = over({}, {})
    # J1's build (orders) goes through the single-batch coalesce, never a
    # broadcast, at every scale (at sf 10 it is far above the broadcast
    # threshold anyway): a broadcast build is one table whatever the budget
    joins = over({n: tables[n] for n in ("customer", "orders")},
                 {"spark.rapids.sql.broadcastSizeBytes": "0"})
    li4 = over({"lineitem4": w8}, w8conf, W8_BATCHES)
    j1 = join_texts(10.0)["J1"]
    return {
        "q3": (corpus, lambda s: build_queries(s, tables)["q3"](), 1e-9,
               None),
        "J1": (joins, lambda s: s.sql(j1), 0.0, None),
        "ORDER BY lineitem": (li4, lambda s: s.sql(ORDER_BY_SQL), 0.0,
                              None),
        # W8b has no ORDER BY: its join emits rows by probe batch and, once
        # the squeezed budget sub-partitions the build, by partition, so
        # it is compared in l_row order; its partition sums are f64 SUMs
        # of the two-pass aggregate, and an order whose rows straddle a
        # chunk boundary adds two partials where it added one run
        "W8b": (li4, lambda s: s.sql(WINDOW_SQL["W8b"]), 1e-9, "l_row"),
        "W8c": (li4, lambda s: s.sql(WINDOW_SQL["W8c"]), 0.0, None),
    }


def in_key_order(table, key):
    """``table``'s rows in the order of its unique column ``key`` (as it
    is when ``key`` is None)."""
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    if key is None:
        return table
    order = np.argsort(table.columns[table.names.index(key)].data,
                       kind="stable")
    return HostTable(table.names, [HostColumn(c.dtype, c.data[order],
                                              c.validity[order])
                                   for c in table.columns])


RUNTIME_KEYS = ("spillBytes", "unspills", "scanChunks", "sortOutOfCore",
                "subPartitions", "budgetRaises", "oomRetries",
                "splitRetries", "arbiterSpills", "spillDiskCount",
                "budgetViolations")


def runtime_metrics(m: dict) -> dict:
    return {k: m.get(k, 0) for k in RUNTIME_KEYS}


def run_squeezed(tables, w8, totals) -> dict:
    """14.2: each query of ``squeeze_cases`` unsqueezed, then at a
    ``SQUEEZE``-th of its unsqueezed peak accounted bytes: the result bit
    for bit (the f64 sums of q3 and W8b, which add per-chunk partials,
    rtol 1e-9; W8b, which has no ORDER BY, in l_row order), no budget
    violation, the peak within the budget, at least one spill to the
    host, and the ORDER BY
    out of core; then the ORDER BY once more with a host tier of the
    budget over ``DISK_RUN_HOST_SHARE``, whose spills go to disk and read
    back."""
    out = {}
    kept = {}
    for name, (make, build, rtol, key) in squeeze_cases(tables,
                                                        w8).items():
        fresh_device()
        plain_s = make(None)
        want, pm, _, peak, pdt = counted_run(plain_s, name,
                                             lambda: build(plain_s), False)
        budget = peak // SQUEEZE
        fresh_device()
        sq = make({"spark.rapids.memory.device.budgetBytes": str(budget)})
        got, m, launches, sq_peak, dt = counted_run(
            sq, f"{name} squeezed", lambda: build(sq))
        same_table(in_key_order(got, key), in_key_order(want, key),
                   f"{name} squeezed", rtol)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        rm = runtime_metrics(m)
        out[name] = dict(rm, unsqueezed_peak=peak, budget=budget,
                         peak=sq_peak, ms=round(dt * 1e3, 2),
                         unsqueezed_ms=round(pdt * 1e3, 2))
        log(f"  {name}: unsqueezed peak {peak} B ({pdt * 1e3:.1f} ms); at a "
            f"budget of {budget} B: peak {sq_peak} B, {dt * 1e3:.1f} ms, "
            f"{rm}; result equals the unsqueezed one "
            f"({'rtol 1e-9' if rtol else 'bit for bit'}"
            f"{', in ' + key + ' order' if key else ''})")
        if rm["budgetViolations"]:
            fail(f"{name} squeezed: {rm['budgetViolations']} budget "
                 "violations")
        if sq_peak > budget:
            fail(f"{name} squeezed: peak {sq_peak} B over the budget "
                 f"{budget} B")
        if rm["spillBytes"] <= 0:
            fail(f"{name} squeezed: nothing spilled to the host")
        if name == "ORDER BY lineitem":
            if pm.get("sortOutOfCore") or rm["sortOutOfCore"] != 1:
                fail(f"{name}: sortOutOfCore {pm.get('sortOutOfCore')} "
                     f"unsqueezed, {rm['sortOutOfCore']} squeezed (want "
                     "none, then 1)")
            kept = {"make": make, "build": build, "want": want,
                    "budget": budget}
    fresh_device()
    host_tier = kept["budget"] // DISK_RUN_HOST_SHARE
    sess = kept["make"]({
        "spark.rapids.memory.device.budgetBytes": str(kept["budget"]),
        "spark.rapids.memory.host.spillStorageSize": str(host_tier)})
    got, m, _, peak, dt = counted_run(sess, "ORDER BY lineitem, disk tier",
                                      lambda: kept["build"](sess), False)
    same_table(got, kept["want"], "ORDER BY lineitem, disk tier", 0.0)
    rm = runtime_metrics(m)
    out["ORDER BY lineitem, disk tier"] = dict(rm, peak=peak,
                                               ms=round(dt * 1e3, 2))
    log(f"  ORDER BY lineitem with a {host_tier} B host tier: "
        f"{rm}, {dt * 1e3:.1f} ms; its disk frames read back bit for bit")
    if rm["spillDiskCount"] <= 0:
        fail("the disk-tier run wrote no disk frame")
    return out


def q1_filter_project(session, table):
    """q1's filter and projection without its aggregate: its first retry
    site is the filter's ``with_retry``, which can split its input."""
    from spark_rapids_tpu_torch import types as TT
    from spark_rapids_tpu_torch.models.tpch import Q1_CUTOFF_DAYS
    from spark_rapids_tpu_torch.ops.expr import col, lit
    from spark_rapids_tpu_torch.plan import from_host_table
    return (from_host_table(table, session)
            .filter(col("l_shipdate") <= lit(Q1_CUTOFF_DAYS, TT.DATE))
            .select(col("l_returnflag"), col("l_quantity"),
                    (col("l_extendedprice") * (lit(1.0) - col("l_discount")))
                    .alias("disc_price")))


#: (oomRetries, splitRetries) each injection must give, by query: q1's and
#: W8a's first retry sites are ``retry_block``s (the coalesce's and the
#: exchange's), where an injected split replays as a retry, as in the
#: reference; the filter's ``with_retry`` splits its input in half
INJECTED_COUNTS = {
    "q1": {"retry:2": (2, 0), "split:1": (1, 0)},
    "W8a": {"retry:2": (2, 0), "split:1": (1, 0)},
    "q1 filter and projection": {"retry:2": (2, 0), "split:1": (0, 1)},
}


def run_injected(q1_keep, tables, w8, totals) -> dict:
    """14.3: q1, W8a and q1's filter and projection with
    ``spark.rapids.sql.test.injectRetryOOM`` at ``INJECTIONS``, each after
    an uninjected run that fills the scan's device cache (a retry's spill
    pass evicts it, and a cold scan's landing would be the first retry
    site): each result bit for bit the uninjected one, and the counters
    ``INJECTED_COUNTS``'."""
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.session import TorchSession
    table = q1_keep["tables"][0]
    w8conf = {"spark.rapids.sql.window.streamTargetRows": str(W8_STREAM_ROWS)}

    def q1_case(conf):
        s = TorchSession(conf)
        return s, lambda: q1_dataframe(s, table)

    def fp_case(conf):
        s = TorchSession(conf)
        return s, lambda: q1_filter_project(s, table)

    def w8a_case(conf):
        s = TorchSession({**w8conf, **conf})
        from_host_table(w8, s, num_batches=W8_BATCHES) \
            .create_or_replace_temp_view("lineitem4")
        return s, lambda: s.sql(WINDOW_SQL["W8a"])

    out = {}
    for name, case in (("q1", q1_case), ("W8a", w8a_case),
                       ("q1 filter and projection", fp_case)):
        _, plain = case({})
        want = plain().collect_table()
        for inject in INJECTIONS:
            plain().collect_table()  # the scan's cache filled again
            s, build = case({"spark.rapids.sql.test.injectRetryOOM": inject})
            got, m, launches, _, dt = counted_run(
                s, f"{name} {inject}", build)
            same_table(got, want, f"{name} {inject}", 0.0)
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
            r, sp = m.get("oomRetries", 0), m.get("splitRetries", 0)
            out[f"{name} {inject}"] = {"oomRetries": r, "splitRetries": sp,
                                       "ms": round(dt * 1e3, 2)}
            log(f"  {name} {inject}: oomRetries {r}, splitRetries {sp}, "
                f"{dt * 1e3:.1f} ms; result bit for bit the uninjected one")
            if (r, sp) != INJECTED_COUNTS[name][inject]:
                fail(f"{name} {inject}: oomRetries {r}, splitRetries {sp}, "
                     f"want {INJECTED_COUNTS[name][inject]}")
    return out


def run_real_oom(q1_keep) -> dict:
    """14.4: a ballast SpillableBatch (and an unspillable filler) leave
    less free memory than q1's working set; q1 must meet a real
    torch.cuda.OutOfMemoryError, spill the ballast to the host, empty
    torch's cache and replay, with the uninjected result bit for bit. Runs
    under a watchdog."""
    from spark_rapids_tpu_torch import types as TT
    from spark_rapids_tpu_torch.columnar import DeviceColumn, DeviceTable
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    from spark_rapids_tpu_torch.runtime.spill import (
        BufferCatalog,
        SpillableBatch,
    )
    from spark_rapids_tpu_torch.session import TorchSession
    table = q1_keep["tables"][0]
    s = TorchSession()
    want = q1_dataframe(s, table).collect_table()  # the scan cache filled
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    again = q1_dataframe(s, table).collect_table()
    torch.cuda.synchronize()
    same_table(again, want, "q1 warm", 0.0)
    work = torch.cuda.max_memory_allocated() - base
    # the ballast frees what q1 lacks, and fits the default host tier
    # (spark.rapids.memory.host.spillStorageSize, 2 GiB), so it spills to
    # the host and not on to disk
    ballast_bytes = min(max(work, 256 << 20), 3 << 29)
    rows = ballast_bytes // 9
    ballast = SpillableBatch(DeviceTable(
        ["ballast"], [DeviceColumn(TT.LONG, torch.ones(rows, dtype=torch.int64,
                                                       device=DEV),
                                   torch.ones(rows, dtype=torch.bool,
                                              device=DEV))],
        rows, rows, DEV), BufferCatalog.get())
    torch.cuda.empty_cache()
    # less than q1 needs; with the ballast's bytes, more
    margin = max(work // 4, work + work // 8 - ballast.device_bytes)
    filler = None
    for _ in range(8):  # the device's free count moves a little
        free, _ = torch.cuda.mem_get_info(DEV)
        try:
            filler = torch.empty(max(free - margin, 0), dtype=torch.uint8,
                                 device=DEV)
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            margin += 64 << 20
    if filler is None:
        fail("could not allocate the filler of the real-OOM run")
    log(f"  q1's warm working set {work} B; ballast {ballast.device_bytes} "
        f"B in the spill catalog, a filler of {filler.numel()} B leaves "
        f"{torch.cuda.mem_get_info(DEV)[0]} B free")
    before = runtime_counters()
    dog = watchdog(300, "q1 under a real CUDA OOM")
    try:
        t0 = time.perf_counter()
        got = q1_dataframe(s, table).collect_table()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        dog.cancel()
    m = s.last_metrics()
    tier = ballast.tier
    del filler
    ballast.release()
    del ballast
    torch.cuda.empty_cache()
    retries = m.get("oomRetries", 0)
    after = runtime_counters()
    spilled = after.get("spillBytes", 0) - before.get("spillBytes", 0)
    log(f"  q1 under a real CUDA OOM: oomRetries {retries}, ballast tier "
        f"{tier}, {spilled} B spilled, {dt * 1e3:.1f} ms; result bit for bit "
        "the unsqueezed one and phase 4's")
    same_table(got, want, "q1 after a real CUDA OOM", 0.0)
    same_table(got, q1_keep["result"], "q1 after a real CUDA OOM (phase 4)",
               0.0)
    if retries < 1 or tier != "HOST":
        fail(f"q1 under a real CUDA OOM: oomRetries {retries}, ballast "
             f"{tier}")
    return {"oomRetries": retries, "ballast_tier": tier,
            "spill_bytes": spilled, "ms": round(dt * 1e3, 2),
            "working_set": work}


def run_semaphore(q1_keep) -> dict:
    """14.5: ``SEM_THREADS`` threads run q1 at once on one session with
    ``SEM_SLOTS`` device slots: never more holders than slots, every
    result bit for bit the single-thread one."""
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    from spark_rapids_tpu_torch.obs.metrics import metric_scope
    from spark_rapids_tpu_torch.runtime.semaphore import TpuSemaphore
    from spark_rapids_tpu_torch.session import TorchSession
    table = q1_keep["tables"][0]
    s = TorchSession({"spark.rapids.sql.concurrentGpuTasks": str(SEM_SLOTS)})
    want = q1_dataframe(s, table).collect_table()
    sem = TpuSemaphore.current()
    sem.reset_peak()
    scope = metric_scope("semaphore")
    w0, a0 = scope.get("acquireWaitTime", 0.0), scope.get("acquires", 0)
    got, errors = [None] * SEM_THREADS, []

    def run(i):
        try:
            got[i] = q1_dataframe(s, table).collect_table()
            torch.cuda.synchronize()
        except Exception as e:  # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(SEM_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    if errors:
        fail(f"semaphore run: {errors}")
    for i, g in enumerate(got):
        same_table(g, want, f"q1 thread {i}", 0.0)
    wait = scope.get("acquireWaitTime", 0.0) - w0
    acquires = scope.get("acquires", 0) - a0
    log(f"  {SEM_THREADS} threads x q1 at concurrentGpuTasks={SEM_SLOTS}: "
        f"most holders at once {sem.peak_holders}, acquires {acquires}, "
        f"acquireWaitTime {wait:.4f} s, {dt * 1e3:.1f} ms in all; every "
        "result bit for bit the single-thread one")
    if sem.peak_holders > SEM_SLOTS or sem.max_tasks != SEM_SLOTS:
        fail(f"semaphore: {sem.peak_holders} holders over {SEM_SLOTS} slots")
    return {"peak_holders": sem.peak_holders, "acquires": acquires,
            "acquireWaitTime_s": wait, "ms": round(dt * 1e3, 2)}


def spill_rates() -> dict:
    """14.6: D2H (spill) and H2D (unspill) GB/s of a
    ``SPILL_RATE_ROWS`` x ``SPILL_RATE_COLS`` int64 table through the
    pinned pool (``SPILL_RATE_POOL``) and pageable (pool 0), medians of
    ``SPILL_RATE_RUNS``; each round trip bit for bit."""
    from spark_rapids_tpu_torch import types as TT
    from spark_rapids_tpu_torch.columnar import DeviceColumn, DeviceTable
    from spark_rapids_tpu_torch.runtime.spill import (
        BufferCatalog,
        SpillableBatch,
    )
    from spark_rapids_tpu_torch.session import TorchSession
    n = SPILL_RATE_ROWS
    base = torch.arange(n, dtype=torch.int64, device=DEV)
    cols = [DeviceColumn(TT.LONG, base * (3 + 2 * i) + i,
                         (base % (i + 2)) != 0)
            for i in range(SPILL_RATE_COLS)]
    keep = [(c.data.clone(), c.validity.clone()) for c in cols]
    table = DeviceTable([f"c{i}" for i in range(SPILL_RATE_COLS)], cols, n,
                        n, DEV)
    nbytes = table.device_nbytes()
    del cols, base
    sb = SpillableBatch(table, BufferCatalog.get())
    del table
    out = {"bytes": nbytes}
    from spark_rapids_tpu_torch.runtime.host_alloc import PinnedMemoryPool
    for form, size in (("pinned", SPILL_RATE_POOL), ("pageable", 0)):
        TorchSession({"spark.rapids.memory.pinnedPool.size":
                      str(size)}).runtime  # noqa: B018 (starts the pool)
        pool = PinnedMemoryPool.get()
        if (pool is None) != (size == 0):
            fail(f"pinnedPool.size {size}: pool {pool}")
        d2h, h2d = [], []
        for _ in range(SPILL_RATE_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sb.spill_to_host()
            d2h.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            back = sb.get()
            torch.cuda.synchronize()
            h2d.append(time.perf_counter() - t0)
            for c, (d, v) in zip(back.columns, keep):
                if not (torch.equal(c.data, d) and torch.equal(c.validity, v)):
                    fail(f"spill round trip ({form}) changed the bits")
            del back
        if pool is not None and not pool.hits:
            fail("the pinned run's copies did not go through the pool")
        out[form] = {
            "d2h_gb_s": round(nbytes / statistics.median(d2h) / 1e9, 3),
            "h2d_gb_s": round(nbytes / statistics.median(h2d) / 1e9, 3),
            "d2h_ms": round(statistics.median(d2h) * 1e3, 2),
            "h2d_ms": round(statistics.median(h2d) * 1e3, 2)}
        log(f"  spill of {n} rows x {SPILL_RATE_COLS} int64 columns "
            f"({nbytes} B), {form}: D2H {out[form]['d2h_gb_s']} GB/s "
            f"({out[form]['d2h_ms']} ms), H2D {out[form]['h2d_gb_s']} GB/s "
            f"({out[form]['h2d_ms']} ms), medians of {SPILL_RATE_RUNS} "
            f"({card_line()}); round trips bit for bit")
    sb.release()
    TorchSession().runtime  # noqa: B018 (the default pool again)
    return out


def run_runtime(tables, q1_keep, before: dict) -> dict:
    """Phase 14: the memory runtime (14.1-14.6). Returns every kernel's
    launches over its counted runs."""
    from spark_rapids_tpu_torch.session import TorchSession
    totals, summary = {}, {}
    t0 = time.perf_counter()
    check_default_budget(TorchSession(), before)
    log(f"  14.1 ran {time.perf_counter() - t0:.1f} s")
    w8 = lineitem4(tables)
    t0 = time.perf_counter()
    summary["squeezed"] = run_squeezed(tables, w8, totals)
    log(f"  14.2 ran {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    summary["injected"] = run_injected(q1_keep, tables, w8, totals)
    log(f"  14.3 ran {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fresh_device()
    summary["real_oom"] = run_real_oom(q1_keep)
    log(f"  14.4 ran {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    summary["semaphore"] = run_semaphore(q1_keep)
    log(f"  14.5 ran {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fresh_device()
    summary["spill_rates"] = spill_rates()
    log(f"  14.6 ran {time.perf_counter() - t0:.1f} s")
    log("  phase-14 summary: " + json.dumps(summary))
    return totals


# ---------------------------------------------------------------------------
# phase 15: Parquet files in and out
# ---------------------------------------------------------------------------

#: the file corpus's scale factor (cut from 1.0 for the script's time
#: limit, PERF.md section 4) and its files per table (c000/, c001/)
FILES_SF = 0.5
FILES_PER_TABLE = 2
#: row groups of the pruning check's orders files
FILES_PRUNE_ROW_GROUP = 1 << 15
#: the pruning check's o_orderkey range [lo, hi)
FILES_PRUNE_KEYS = (100_000, 140_000)
#: the phase's time budget on the card (seconds): past it, lower FILES_SF
FILES_BUDGET_S = 120.0


def same_host_table(got, want, what) -> None:
    """``got`` equal to ``want`` bit for bit, column by column: names,
    types, validity, and every valid value (floats by their bits, strings
    and DECIMAL128 values as Python objects)."""
    if list(got.names) != list(want.names):
        fail(f"{what}: columns {list(got.names)}, want {list(want.names)}")
    if got.num_rows != want.num_rows:
        fail(f"{what}: {got.num_rows} rows, want {want.num_rows}")
    for name, g, w in zip(got.names, got.columns, want.columns):
        if g.dtype != w.dtype:
            fail(f"{what} {name}: {g.dtype}, want {w.dtype}")
        if not np.array_equal(g.validity, w.validity):
            fail(f"{what} {name}: validity differs")
        gv, wv = g.data[w.validity], w.data[w.validity]
        if gv.dtype == object or wv.dtype == object:
            ok = list(gv) == list(wv)
        else:
            ok = gv.dtype == wv.dtype and gv.tobytes() == wv.tobytes()
        if not ok:
            fail(f"{what} {name}: values differ (bit for bit)")


def dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        total += sum(os.path.getsize(os.path.join(root, f)) for f in files)
    return total


def file_tables(tables, lineitem, base: str, card: str) -> tuple:
    """15.2: each table written with the port's writer (SNAPPY, two files
    in c000/ and c001/), then read back in PERFILE, COALESCING and
    MULTITHREADED and held against its source bit for bit. Returns
    ({name: directory}, {name: numbers})."""
    from spark_rapids_tpu_torch.columnar.table import upload_host_table
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.io.parquet import ParquetScanNode
    from spark_rapids_tpu_torch.models.corpus import write_corpus_files
    paths, numbers = {}, {}
    for name, t in list(tables.items()) + [("lineitem_q1", lineitem)]:
        t0 = time.perf_counter()
        paths.update(write_corpus_files({name: t}, base, FILES_PER_TABLE))
        write_s = time.perf_counter() - t0
        on_disk = dir_bytes(paths[name])
        decode = {}
        for mode in ("PERFILE", "COALESCING", "MULTITHREADED"):
            scan = ParquetScanNode([paths[name]], RapidsConf(),
                                   reader_type=mode)
            t0 = time.perf_counter()
            got = scan.collect_host()
            decode[mode] = time.perf_counter() - t0
            same_host_table(got, t, f"{name} read back ({mode})")
        host_mb = got.nbytes() / 1e6
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dt = upload_host_table(got, DEV)
        torch.cuda.synchronize()
        upload_ms = (time.perf_counter() - t0) * 1e3
        del dt, got
        best = min(decode.values())
        numbers[name] = {
            "rows": t.num_rows, "bytes_on_disk": on_disk,
            "write_s": round(write_s, 3),
            "decode_s": {m: round(v, 3) for m, v in decode.items()},
            "decoded_mb_per_s": round(host_mb / best, 1),
            "host_mb": round(host_mb, 1), "upload_ms": round(upload_ms, 2)}
        log(f"  15.2 {name}: {t.num_rows} rows, {on_disk} B on disk, write "
            f"{write_s:.3f} s, decode (host) "
            f"{', '.join(f'{m} {v:.3f} s' for m, v in decode.items())}, "
            f"{host_mb / best:.1f} MB/s decoded ({host_mb:.1f} MB), upload "
            f"{upload_ms:.2f} ms; read back bit for bit in all three modes "
            f"[{card}]")
    return paths, numbers


def files_q1(paths, q1_keep, card: str) -> tuple:
    """15.3: TPC-H q1 over lineitem read from its files, through
    ``run_case`` (cold, warm, host syncs, every launch held against its
    plain version), against phase 4's oracle."""
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    from spark_rapids_tpu_torch.session import TorchSession
    session = TorchSession()
    cold = {}

    def check(got):
        # run_case checks the cold run first: keep what that run counted
        if not cold:
            cold.update(session.last_metrics(), **session.last_timings())
        q1_keep["check"](got)

    res = run_case(session, "q1 from files",
                   lambda: q1_dataframe(session, session.read_parquet(
                       paths["lineitem_q1"])), check, None)
    log("  15.3 q1 from files, the cold run's counters and seconds: "
        + json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in cold.items() if v}))
    fresh = [fresh_cold_q1(paths["lineitem_q1"], q1_keep["result"].num_rows)]
    log(f"  15.3 q1 from files cold: {res['stats']['cold_ms']} ms in this "
        f"process, {[f['cold_ms'] for f in fresh]} ms in a fresh "
        "process; its counters and seconds: "
        + json.dumps([f["counters"] for f in fresh]) + f" [{card}]")
    for f in fresh:
        log(f"  15.3 fresh cold q1's event record {f['event_log']}: "
            + json.dumps(f["record"]))
    q1_keep["files_warm_ms"] = res["stats"]["warm_ms"]
    for k in ("onehot_partials", "gather_compact", "sort_with_payload"):
        if not res["launches"].get(k):
            fail(f"q1 from files launched no {k}")
    m = session.last_metrics()
    decode_ms = round(m.get("scanDecodeTime", 0) * 1e3, 2)
    upload_ms = round(m.get("scanUploadTime", 0) * 1e3, 2)
    log(f"  15.3 q1 from files: cold {res['stats']['cold_ms']} ms, warm "
        f"{res['stats']['warm_ms']} ms against phase 4's in-memory warm "
        f"{q1_keep['warm_ms']} ms (the counted run waited {decode_ms} ms on "
        f"the decode and uploaded for {upload_ms} ms); host syncs "
        f"{res['stats']['syncs']}; result matches phase 4's oracle [{card}]")
    return res["launches"], dict(res["stats"], decode_ms=decode_ms,
                                 upload_ms=upload_ms,
                                 in_memory_warm_ms=q1_keep["warm_ms"],
                                 fresh_cold_ms=[f["cold_ms"] for f in fresh])


#: one cold TPC-H q1 over lineitem's Parquet files in a process of its
#: own (argv: the repo root, the files' directory)
COLD_Q1_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from spark_rapids_tpu_torch.models.tpch import q1_dataframe
from spark_rapids_tpu_torch.session import TorchSession
s = TorchSession({"spark.rapids.sql.eventLog.enabled": "true",
                  "spark.rapids.sql.eventLog.dir": sys.argv[3]})
s.next_query_tag = "q1_cold"
t0 = time.perf_counter()
got = q1_dataframe(s, s.read_parquet(sys.argv[2])).collect_table()
torch.cuda.synchronize()
ms = (time.perf_counter() - t0) * 1e3
counters = dict(s.last_metrics(), **s.last_timings())
rec = s.last_event_record
print(json.dumps({"cold_ms": round(ms, 2), "rows": got.num_rows,
                  "counters": {k: round(v, 4) if isinstance(v, float) else v
                               for k, v in counters.items() if v},
                  "event_log": s.last_event_path,
                  "record": {k: rec[k] for k in (
                      "wallS", "phasesS", "compileMs", "dispatches",
                      "executableCacheHit", "spans")}},
                 default=str))
"""


def fresh_cold_q1(path: str, rows: int) -> dict:
    """q1 over the Parquet files at ``path`` cold in a fresh process (its
    time, counters and seconds, and the event record it writes with its
    phase times and span summary; its result must have phase 4's
    ``rows``): Queue 3's unexplained 13 s cold run, instrumented."""
    out = subprocess.run(
        [sys.executable, "-c", COLD_Q1_CHILD,
         os.path.dirname(os.path.abspath(__file__)), path,
         tempfile.mkdtemp(prefix="cold_q1_eventlog_")],
        capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        fail(f"the fresh cold q1 failed: {out.stderr[-2000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    if got["rows"] != rows:
        fail(f"the fresh cold q1 gave {got['rows']} rows, want {rows}")
    return got


#: the file phases' corpus tables and oracles by (scale factor, seed):
#: phases 15 and 16 read the same tables, made and checked once
_FILE_CORPUS = {}


def file_corpus(seed: int) -> dict:
    """{"tables", "oracles"} of ``scale_test_specs(FILES_SF)`` seed
    ``seed``, the tables generated at the first call (``oracles`` is
    None until ``file_oracles`` fills it)."""
    from spark_rapids_tpu_torch.models.corpus import corpus_tables
    key = (FILES_SF, seed)
    if key not in _FILE_CORPUS:
        _FILE_CORPUS[key] = {"tables": corpus_tables(FILES_SF, seed),
                             "oracles": None}
    return _FILE_CORPUS[key]


def file_oracles(tables):
    """{query: check(got)} of all 22 corpus queries: phase 7's oracles,
    phase 8's (the windows compared by key: two files are two batches)
    and phase 6's q2 and q8; computed once for tables from
    ``file_corpus``."""
    from spark_rapids_tpu_torch.session import TorchSession
    entry = next((e for e in _FILE_CORPUS.values()
                  if e["tables"] is tables), None)
    if entry is not None and entry["oracles"] is not None:
        return entry["oracles"]
    oracles = wide_oracles(tables)
    oracles.update(window_oracles(tables, keyed=True))
    cases = corpus_cases(TorchSession(), tables,
                         sparse_custkey(tables["orders"]))
    oracles["q2"] = cases["q2"][1]
    oracles["q8"] = cases["q8"][1]
    if entry is not None:
        entry["oracles"] = oracles
    return oracles


def files_corpus(tables, paths, card: str) -> tuple:
    """15.4: the 22 corpus queries over the files, as DataFrames
    (``build_queries(..., paths=)``) and as SQL texts over ``CREATE TEMP
    VIEW ... USING parquet``, each through ``run_case`` against its
    oracle. Returns (launch totals, numbers)."""
    from spark_rapids_tpu_torch.models.corpus import (
        CORPUS,
        build_queries,
        sql_texts,
    )
    from spark_rapids_tpu_torch.session import TorchSession
    t0 = time.perf_counter()
    oracles = file_oracles(tables)
    log(f"  15.4 the oracles in {time.perf_counter() - t0:.2f} s (host)")
    table_paths = {n: paths[n] for n in tables}
    dsl = TorchSession()
    queries = build_queries(dsl, tables, paths=table_paths)
    sql = TorchSession()
    for name, tdir in table_paths.items():
        sql.sql(f"CREATE OR REPLACE TEMP VIEW {name} USING parquet "
                f"OPTIONS (path '{tdir}')")
    texts = sql_texts()
    total, numbers = {}, {}
    for name in CORPUS:
        for form, session, build in (
                ("dsl", dsl, queries[name]),
                ("sql", sql, lambda t=texts[name]: sql.sql(t))):
            label = f"{name} from files" + (" SQL" if form == "sql" else "")
            res = run_case(session, label, build, oracles[name], None,
                           warm_runs=1)
            # the counted warm run's scan metrics (its last execute)
            m = session.last_metrics()
            for k, v in res["launches"].items():
                total[k] = total.get(k, 0) + v
            numbers[label] = {
                "warm_ms": res["stats"]["warm_ms"],
                "cold_ms": res["stats"]["cold_ms"],
                "decode_ms": round(m.get("scanDecodeTime", 0) * 1e3, 2),
                "upload_ms": round(m.get("scanUploadTime", 0) * 1e3, 2),
                "syncs": res["stats"]["syncs"],
                "launches": {k: v for k, v in res["launches"].items() if v}}
    log(f"  15.4 all {2 * len(CORPUS)} corpus queries from files match their "
        f"oracles; warm ms (of it: waiting on the decode, uploading, in the "
        f"counted run): " + ", ".join(
            f"{k} {v['warm_ms']} ({v['decode_ms']}, {v['upload_ms']})"
            for k, v in numbers.items()) + f" [{card}]")
    return total, numbers


def files_features(tables, paths, base: str, card: str) -> dict:
    """15.5: a filtered read across row groups (pruned row groups and rows
    held), a partitioned write read back with its partition column's type
    inferred, an input_file_name() GROUP BY over three files, and a write
    under an injected io.write.file fault (aborted with no visible file,
    then committed on the retry)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    from spark_rapids_tpu_torch.errors import KernelCrashError
    from spark_rapids_tpu_torch.io import parquet_format as PF
    from spark_rapids_tpu_torch.io.common import expand_paths
    from spark_rapids_tpu_torch.io.committer import read_manifest
    from spark_rapids_tpu_torch.io.parquet import write_parquet
    from spark_rapids_tpu_torch.models.corpus import write_corpus_files
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.plan import nodes as P
    from spark_rapids_tpu_torch.runtime.faults import FAULTS
    from spark_rapids_tpu_torch.session import TorchSession
    out = {}
    session = TorchSession()
    # the filtered read: o_orderkey is ascending, so each row group covers
    # its own key range
    orders = tables["orders"]
    rg_dir = write_corpus_files({"orders_rg": orders}, base,
                                FILES_PER_TABLE,
                                row_group_rows=FILES_PRUNE_ROW_GROUP)
    lo, hi = FILES_PRUNE_KEYS
    keys = host_cols(orders)["o_orderkey"]
    per_file = -(-orders.num_rows // FILES_PER_TABLE)
    want_pruned = 0
    for f0 in range(0, orders.num_rows, per_file):
        fkeys = keys[f0:f0 + per_file]
        for r0 in range(0, len(fkeys), FILES_PRUNE_ROW_GROUP):
            rk = fkeys[r0:r0 + FILES_PRUNE_ROW_GROUP]
            want_pruned += int(rk.max() < lo or rk.min() >= hi)
    t0 = time.perf_counter()
    got = session.read_parquet(
        rg_dir["orders_rg"], reader_type="PERFILE",
        filters=[("o_orderkey", ">=", lo), ("o_orderkey", "<", hi)]
    ).collect_table()
    filt_s = time.perf_counter() - t0
    pruned = session.last_metrics().get("prunedRowGroups", 0)
    m = (keys >= lo) & (keys < hi)
    if pruned != want_pruned:
        fail(f"filtered read pruned {pruned} row groups, want "
             f"{want_pruned}")
    if not np.array_equal(host_cols(got)["o_orderkey"], keys[m]):
        fail("filtered read: rows differ from the numpy filter")
    out["filtered_read"] = {"rows": got.num_rows,
                            "pruned_row_groups": pruned,
                            "ms": round(filt_s * 1e3, 2)}
    log(f"  15.5 filtered read: {got.num_rows} rows, {pruned} row groups "
        f"pruned by their statistics (as computed from the layout), "
        f"{filt_s * 1e3:.1f} ms [{card}]")
    # the partitioned write
    cust = tables["customer"]
    pdir = os.path.join(base, "customer_by_nation")
    t0 = time.perf_counter()
    files = write_parquet(cust, pdir, partition_by=["c_nationkey"])
    pw_s = time.perf_counter() - t0
    back = session.read_parquet(pdir)
    if dict(back.schema)["c_nationkey"] != T.LONG:
        fail(f"partition column inferred as {dict(back.schema)}")
    got = back.collect_table()
    order = np.argsort(host_cols(got)["c_custkey"], kind="stable")
    got = HostTable(cust.names, [
        HostColumn(c.dtype, c.data[order], c.validity[order])
        for c in (got.columns[got.names.index(n)] for n in cust.names)])
    same_host_table(got, cust, "partitioned customer read back")
    n_parts = len(np.unique(host_cols(cust)["c_nationkey"]))
    if len(files) != n_parts:
        fail(f"partitioned write made {len(files)} files, want {n_parts}")
    out["partitioned_write"] = {"files": len(files),
                                "write_s": round(pw_s, 3)}
    log(f"  15.5 partitioned write: {len(files)} c_nationkey=... files in "
        f"{pw_s:.3f} s, read back with c_nationkey inferred as bigint, "
        f"rows equal by c_custkey [{card}]")
    # input_file_name() over three files
    three = write_corpus_files({"customer3": cust}, base, 3)["customer3"]
    g = session.read_parquet(three).group_by(
        F.input_file_name().alias("f")).agg(F.count().alias("c")
                                            ).collect_table()
    want = {p: PF.read_footer(p).num_rows for p in expand_paths([three])}
    have = dict(zip(host_cols(g)["f"], host_cols(g)["c"].tolist()))
    if have != want:
        fail(f"input_file_name() GROUP BY: {have}, want {want}")
    out["input_file_name"] = {"files": len(have)}
    log(f"  15.5 input_file_name() GROUP BY over {len(have)} files: each "
        f"file's row count [{card}]")
    # the write under an injected fault
    fdir = os.path.join(base, "faulted")
    faulty = TorchSession({"spark.rapids.test.faults":
                           "io.write.file:crash:1"})
    node = P.WriteFiles(from_host_table(cust, faulty).plan, "parquet", fdir,
                        None, {})
    try:
        faulty.execute(node)
        fail("the injected io.write.file fault did not fire")
    except KernelCrashError:
        pass
    visible = [f for _r, _d, fs in os.walk(fdir) for f in fs] \
        if os.path.isdir(fdir) else []
    if visible or read_manifest(fdir) is not None:
        fail(f"aborted write left files: {visible}")
    stats = faulty.execute(node)
    FAULTS.disarm()
    same_host_table(session.read_parquet(fdir).collect_table(), cust,
                    "the retried write read back")
    out["faulted_write"] = {"retry_files": int(stats.columns[0].data[0])}
    log(f"  15.5 injected io.write.file fault: the write aborted with no "
        f"visible file, the retry committed {int(stats.columns[0].data[0])} "
        f"file(s), read back bit for bit [{card}]")
    return out


def run_files(seed: int, q1_keep) -> dict:
    """Phase 15: Parquet files in and out (15.1-15.5). Returns every
    kernel's launches over the counted runs."""
    import importlib.util
    import pathlib
    import shutil
    import tempfile

    from spark_rapids_tpu_torch import native
    card = card_line()
    t_phase = time.perf_counter()
    # a clean build of the host library's sources into a scratch
    # directory times the build (the port built them at first use)
    kept, scratch = native.BUILD_DIR, tempfile.mkdtemp(prefix="srt-host-")
    native.BUILD_DIR = pathlib.Path(scratch)
    try:
        t0 = time.perf_counter()
        built = native.build()
        build_s = time.perf_counter() - t0
    finally:
        native.BUILD_DIR = kept
        shutil.rmtree(scratch, ignore_errors=True)
    log(f"  15.1 host library: {sorted(built)} built from source in "
        f"{build_s:.2f} s (one g++ each, in parallel)")
    facts = {m: importlib.util.find_spec(m) is not None
             for m in ("pyarrow", "pandas")}
    log(f"  15.1 on this machine: find_spec('pyarrow') "
        f"{'found' if facts['pyarrow'] else 'None'}, find_spec('pandas') "
        f"{'found' if facts['pandas'] else 'None'} (the port imports "
        "neither)")
    base = tempfile.mkdtemp(prefix="srt-files-")
    summary = {"card": card, "import_facts": facts,
               "host_build_s": round(build_s, 2)}
    totals = {}
    try:
        t0 = time.perf_counter()
        tables = file_corpus(seed)["tables"]
        log(f"  15.2 generated scale_test_specs({FILES_SF}) seed {seed} in "
            f"{time.perf_counter() - t0:.2f} s (host); lineitem for q1: "
            f"phase 4's {q1_keep['tables'][0].num_rows} rows")
        t0 = time.perf_counter()
        paths, summary["tables"] = file_tables(tables, q1_keep["tables"][0],
                                               base, card)
        log(f"  15.2 ran {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches, summary["q1"] = files_q1(paths, q1_keep, card)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        log(f"  15.3 ran {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches, summary["corpus"] = files_corpus(tables, paths, card)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        log(f"  15.4 ran {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        summary["features"] = files_features(tables, paths, base, card)
        log(f"  15.5 ran {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    took = time.perf_counter() - t_phase
    summary["seconds"] = round(took, 1)
    summary["launches"] = {k: v for k, v in totals.items() if v}
    if took > FILES_BUDGET_S:
        log(f"  phase 15 took {took:.1f} s, past its {FILES_BUDGET_S:.0f} s "
            f"budget: lower FILES_SF ({FILES_SF})")
    for k in ("onehot_partials", "gather_compact", "sort_with_payload",
              "fused_minmax"):
        if not totals.get(k):
            fail(f"phase 15 launched no {k}")
    log("  phase-15 summary: " + json.dumps(summary))
    return totals


# ---------------------------------------------------------------------------
# phase 16: text files in and out
# ---------------------------------------------------------------------------

#: the phase's time budget on the card (seconds): past it, lower FILES_SF
TEXT_BUDGET_S = 120.0
#: the Hive text orders table's escape.delim and its partition column
HIVE_ESCAPE = "~"
HIVE_BUCKETS = 4


def text_build() -> dict:
    """16.1: the text codec's source built from scratch into a scratch
    directory, timed, and the host compiler's version."""
    import pathlib
    import shutil
    import tempfile

    from spark_rapids_tpu_torch import native
    kept, scratch = native.BUILD_DIR, tempfile.mkdtemp(prefix="srt-text-")
    native.BUILD_DIR = pathlib.Path(scratch)
    try:
        t0 = time.perf_counter()
        native.build(["text_host"])
        build_s = time.perf_counter() - t0
    finally:
        native.BUILD_DIR = kept
        shutil.rmtree(scratch, ignore_errors=True)
    gxx = subprocess.run([native.compiler(), "--version"],
                         capture_output=True, text=True, timeout=60)
    version = (gxx.stdout.splitlines() or ["?"])[0]
    # the port's own first use (built into _build/ unless there already),
    # so that no write or read below is timed with a build in it
    t0 = time.perf_counter()
    native.load("text_host")
    load_s = time.perf_counter() - t0
    log(f"  16.1 text_host.cpp built from source in {build_s:.2f} s by "
        f"{version}; its first use loaded in {load_s:.2f} s")
    return {"build_s": round(build_s, 2), "gxx": version,
            "first_use_s": round(load_s, 2)}


def json_expected(t):
    """A corpus table as its JSON lines read under ``json_read_schema``: a
    DATE as midnight micros, a decimal as its unscaled LONG."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    cols = []
    for c in t.columns:
        if isinstance(c.dtype, T.DateType):
            c = HostColumn(T.TIMESTAMP, np.where(
                c.validity, c.data.astype(np.int64) * 86_400_000_000, 0),
                c.validity)
        elif isinstance(c.dtype, T.DecimalType):
            c = HostColumn(T.LONG, np.where(c.validity, c.data, 0).astype(
                np.int64), c.validity)
        cols.append(c)
    return HostTable(list(t.names), cols)


def hive_orders(orders):
    """Orders with ``o_bucket`` (o_orderkey mod HIVE_BUCKETS), the
    low-cardinality column the Hive text table is partitioned by."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    keys = host_cols(orders)["o_orderkey"]
    return HostTable(list(orders.names) + ["o_bucket"], list(
        orders.columns) + [HostColumn(T.LONG, keys % HIVE_BUCKETS)])


def text_scans(fmt: str, path: str, schema, mode: str):
    """The scan node of one written table, in reader mode ``mode``."""
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.io.csv import CsvScanNode
    from spark_rapids_tpu_torch.io.hive_text import HiveTextScanNode
    from spark_rapids_tpu_torch.io.json import JsonScanNode
    from spark_rapids_tpu_torch.models.corpus import json_read_schema
    if fmt == "csv":
        return CsvScanNode([path], RapidsConf(), schema=schema,
                           reader_type=mode)
    if fmt == "dbgen":
        return CsvScanNode([path], RapidsConf(), schema=schema, sep="|",
                           header=False, reader_type=mode)
    if fmt == "json":
        return JsonScanNode([path], RapidsConf(),
                            schema=json_read_schema(schema),
                            reader_type=mode)
    return HiveTextScanNode([path], RapidsConf(), schema=schema,
                            escape=HIVE_ESCAPE, reader_type=mode)


def text_tables(tables, lineitem, base: str, card: str) -> tuple:
    """16.2: the corpus tables written as CSV (header, the tables' schema)
    and as JSON lines, phase 4's lineitem as pipe-delimited headerless CSV
    (dbgen's layout without its trailing |) and orders as Hive text
    partitioned by o_bucket with escape.delim set, two files a table
    (Hive: one a partition); each read back in PERFILE, COALESCING and
    MULTITHREADED and held against its source bit for bit. Returns
    ({form: {name: directory}}, {label: numbers})."""
    from spark_rapids_tpu_torch.columnar.table import upload_host_table
    from spark_rapids_tpu_torch.io.hive_text import write_hive_text
    from spark_rapids_tpu_torch.models.corpus import write_corpus_files
    jobs = [("csv", n, t, t) for n, t in tables.items()]
    jobs += [("json", n, t, json_expected(t)) for n, t in tables.items()]
    jobs.append(("dbgen", "lineitem_q1", lineitem, lineitem))
    hive = hive_orders(tables["orders"])
    jobs.append(("hive", "orders", tables["orders"], hive))
    paths, numbers = {"csv": {}, "json": {}, "dbgen": {}, "hive": {}}, {}
    for form, name, t, want in jobs:
        sub = os.path.join(base, form)
        t0 = time.perf_counter()
        if form == "hive":
            paths[form][name] = os.path.join(sub, name)
            write_hive_text(hive, paths[form][name],
                            partition_by=["o_bucket"], escape=HIVE_ESCAPE)
        elif form == "dbgen":
            paths[form].update(write_corpus_files(
                {name: t}, sub, FILES_PER_TABLE, fmt="csv", header=False,
                sep="|"))
        else:
            paths[form].update(write_corpus_files(
                {name: t}, sub, FILES_PER_TABLE, fmt=form))
        write_s = time.perf_counter() - t0
        on_disk = dir_bytes(paths[form][name])
        decode = {}
        for mode in ("PERFILE", "COALESCING", "MULTITHREADED"):
            scan = text_scans(form, paths[form][name], t.schema(), mode)
            t0 = time.perf_counter()
            got = scan.collect_host()
            decode[mode] = time.perf_counter() - t0
            if form == "hive":
                order = np.argsort(host_cols(got)["o_orderkey"],
                                   kind="stable")
                got = type(got)(list(got.names), [
                    type(c)(c.dtype, c.data[order], c.validity[order])
                    for c in got.columns])
            same_host_table(got, want, f"{form} {name} read back ({mode})")
        host_mb = got.nbytes() / 1e6
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dt = upload_host_table(got, DEV)
        torch.cuda.synchronize()
        upload_ms = (time.perf_counter() - t0) * 1e3
        del dt, got
        best = min(decode.values())
        label = f"{form} {name}"
        numbers[label] = {
            "rows": t.num_rows, "bytes_on_disk": on_disk,
            "write_s": round(write_s, 3),
            "decode_s": {m: round(v, 3) for m, v in decode.items()},
            "decoded_mb_per_s": {m: round(host_mb / v, 1)
                                 for m, v in decode.items()},
            "disk_mb_per_s": round(on_disk / 1e6 / best, 1),
            "host_mb": round(host_mb, 1), "upload_ms": round(upload_ms, 2)}
        log(f"  16.2 {label}: {t.num_rows} rows, {on_disk} B on disk, write "
            f"{write_s:.3f} s, decode (host) "
            f"{', '.join(f'{m} {v:.3f} s' for m, v in decode.items())}, "
            f"{host_mb / best:.1f} MB/s decoded ({host_mb:.1f} MB; "
            f"{on_disk / 1e6 / best:.1f} MB/s of text), upload "
            f"{upload_ms:.2f} ms; read back bit for bit in all three modes "
            f"[{card}]")
    return paths, numbers


def text_q1(paths, lineitem, q1_keep, card: str) -> tuple:
    """16.3: TPC-H q1 over lineitem from its pipe-delimited CSV files
    (``schema=``), through ``run_case`` (cold, warm, host syncs, every
    launch held against its plain version) against phase 4's oracle, with
    the cold run's counters."""
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    from spark_rapids_tpu_torch.session import TorchSession
    session = TorchSession()
    path = paths["dbgen"]["lineitem_q1"]
    schema = lineitem.schema()
    cold = {}

    def check(got):
        if not cold:
            cold.update(session.last_metrics(), **session.last_timings())
        q1_keep["check"](got)

    res = run_case(session, "q1 from CSV",
                   lambda: q1_dataframe(session, session.read_csv(
                       path, schema=schema, sep="|", header=False)),
                   check, None)
    log("  16.3 q1 from CSV, the cold run's counters and seconds: "
        + json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in cold.items() if v}))
    for k in ("onehot_partials", "gather_compact", "sort_with_payload"):
        if not res["launches"].get(k):
            fail(f"q1 from CSV launched no {k}")
    m = session.last_metrics()
    decode_ms = round(m.get("scanDecodeTime", 0) * 1e3, 2)
    upload_ms = round(m.get("scanUploadTime", 0) * 1e3, 2)
    peak = round(res["stats"]["peak_gib"], 3)
    log(f"  16.3 q1 from CSV: cold {res['stats']['cold_ms']} ms, warm "
        f"{res['stats']['warm_ms']} ms against phase 4's in-memory warm "
        f"{q1_keep['warm_ms']} ms and phase 15's q1 from Parquet warm "
        f"{q1_keep.get('files_warm_ms')} ms (the counted run waited "
        f"{decode_ms} ms on the decode and uploaded for {upload_ms} ms); "
        f"host syncs {res['stats']['syncs']}; peak {peak} GiB; result "
        f"matches phase 4's oracle [{card}]")
    return res["launches"], dict(
        res["stats"], decode_ms=decode_ms, upload_ms=upload_ms,
        in_memory_warm_ms=q1_keep["warm_ms"],
        parquet_warm_ms=q1_keep.get("files_warm_ms"))


def text_corpus(tables, paths, card: str) -> tuple:
    """16.4: the 22 corpus queries over the CSV files as DataFrames and as
    SQL over ``CREATE TEMP VIEW ... USING csv OPTIONS (path, schema)``,
    and over the JSON files as DataFrames (``read_corpus_table``), each
    through ``run_case`` (a cold and the counted run; no warm run) against
    its oracle. Returns (launch totals, numbers)."""
    from spark_rapids_tpu_torch.models.corpus import (
        CORPUS,
        build_queries,
        build_sql_queries,
    )
    from spark_rapids_tpu_torch.session import TorchSession
    oracles = file_oracles(tables)
    forms = []
    for label, fmt, sql in (("CSV", "csv", False), ("CSV SQL", "csv", True),
                            ("JSON", "json", False)):
        session = TorchSession()
        build = build_sql_queries if sql else build_queries
        forms.append((label, session, build(session, tables,
                                            paths=paths[fmt], fmt=fmt)))
    total, numbers = {}, {}
    for name in CORPUS:
        for label, session, queries in forms:
            case = f"{name} from {label}"
            res = run_case(session, case, queries[name], oracles[name], None,
                           warm_runs=0)
            m = session.last_metrics()
            for k, v in res["launches"].items():
                total[k] = total.get(k, 0) + v
            decode_ms = round(m.get("scanDecodeTime", 0) * 1e3, 2)
            numbers[case] = {
                "counted_ms": res["stats"]["counted_ms"],
                "cold_ms": res["stats"]["cold_ms"],
                "decode_ms": decode_ms,
                "upload_ms": round(m.get("scanUploadTime", 0) * 1e3, 2),
                "decode_share": round(decode_ms / max(
                    res["stats"]["counted_ms"], 1e-9), 3),
                "syncs": res["stats"]["syncs"],
                "launches": {k: v for k, v in res["launches"].items() if v}}
    log(f"  16.4 all {len(forms) * len(CORPUS)} corpus runs from text files "
        "match their oracles; ms of the counted run (sync debug mode, "
        "launches recorded; no warm run) and the decode's share of it: "
        + ", ".join(f"{k} {v['counted_ms']} ({v['decode_share']})"
                             for k, v in numbers.items()) + f" [{card}]")
    return total, numbers


def _rows_of(df):
    return [tuple(r) for r in df.collect()]


def text_features(tables, base: str, card: str) -> dict:
    """16.5: options and failures on the card, each held against rows
    written out by hand: sep, quote, escape, comment and null; the custom
    float spellings and a timestampFormat; PERMISSIVE, DROPMALFORMED and
    FAILFAST over ragged and malformed rows; JSON multiLine and
    primitivesAsString; a faulted CSV write leaving no visible file, then
    its retry committing."""
    import datetime

    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.errors import KernelCrashError
    from spark_rapids_tpu_torch.io.committer import read_manifest
    from spark_rapids_tpu_torch.io.text_format import TextParseError
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.plan import nodes as P
    from spark_rapids_tpu_torch.runtime.faults import FAULTS
    from spark_rapids_tpu_torch.session import TorchSession
    s = TorchSession()
    d = os.path.join(base, "options")
    os.makedirs(d, exist_ok=True)

    def put(name, text):
        p = os.path.join(d, name)
        with open(p, "w") as f:
            f.write(text)
        return p

    def expect(what, got, want):
        if got != want:
            fail(f"16.5 {what}: {got}, want {want}")

    checks = []
    p = put("opts.csv", "# comment\na;b;c\n1;'x;y';NA\n  # mid\n"
            "2;z\\;w;7\n3;'q r';NA\n")
    expect("sep, quote, escape, comment, null", _rows_of(s.read_csv(
        p, sep=";", quote="'", escape="\\", comment="#", null_value="NA",
        schema=[("a", T.INT), ("b", T.STRING), ("c", T.INT)]).sort("a")),
        [(1, "x;y", None), (2, "z;w", 7), (3, "q r", None)])
    checks.append("sep/quote/escape/comment/null")
    p = put("floats.csv", "x,t\nbad,2024/01/15 10:30:00\n1.5,1999/12/31 "
            "23:59:59\nP_INF,2000/02/29 00:00:01\nN_INF,2024/01/15 10:30:00\n")
    got = _rows_of(s.read_csv(
        p, nan_value="bad", positive_inf="P_INF", negative_inf="N_INF",
        timestamp_format="yyyy/MM/dd HH:mm:ss",
        schema=[("x", T.DOUBLE), ("t", T.TIMESTAMP)]))

    def micros(*ymdhms):
        delta = datetime.datetime(*ymdhms) - datetime.datetime(1970, 1, 1)
        return (delta.days * 86400 + delta.seconds) * 1_000_000
    if not (math.isnan(got[0][0]) and got[1:] == [
            (1.5, micros(1999, 12, 31, 23, 59, 59)),
            (math.inf, micros(2000, 2, 29, 0, 0, 1)),
            (-math.inf, micros(2024, 1, 15, 10, 30))]):
        fail(f"16.5 custom floats and timestampFormat: {got}")
    checks.append("custom floats/timestampFormat")
    p = put("ragged.csv", "a,b\n1,2\n3\n5,6\n7,8,9\n")
    schema = [("a", T.INT), ("b", T.INT)]
    expect("PERMISSIVE", _rows_of(s.read_csv(p, schema=schema)),
           [(1, 2), (5, 6), (3, None), (7, 8)])
    expect("DROPMALFORMED", _rows_of(s.read_csv(
        p, schema=schema, mode="DROPMALFORMED")), [(1, 2), (5, 6)])
    for mode, path, what in (("FAILFAST", p, "a ragged row"),
                             ("PERMISSIVE", put("bad.csv", "a,b\n1,x\n"),
                              "a value that does not convert")):
        try:
            s.read_csv(path, schema=schema, mode=mode).collect()
            fail(f"16.5 {mode} over {what} did not raise")
        except TextParseError:
            pass
    checks.append("PERMISSIVE/DROPMALFORMED/FAILFAST")
    p = put("multi.json", '[{"a": 1, "b": "x"},\n {"a": 2, "b": null}]')
    expect("JSON multiLine", _rows_of(s.read_json(p, multi_line=True)),
           [(1, "x"), (2, None)])
    p = put("prim.json", '{"a": 1, "b": 2.5, "c": true}\n{"a": 7, "b": 2, '
            '"c": null}\n{"a": null, "b": 1e-7}\n')
    expect("JSON primitivesAsString", _rows_of(s.read_json(
        p, primitives_as_string=True)),
        [("1", "2.5", "true"), ("7", "2", None), (None, "1e-7", None)])
    p = put("modes.json", '{"a": 1}\nnot json\n{"a": NaN}\n{"a": 3}\n')
    expect("JSON PERMISSIVE", _rows_of(s.read_json(
        p, schema=[("a", T.LONG)])), [(1,), (None,), (None,), (3,)])
    expect("JSON DROPMALFORMED", _rows_of(s.read_json(
        p, schema=[("a", T.LONG)], mode="DROPMALFORMED")), [(1,), (3,)])
    checks.append("JSON multiLine/primitivesAsString/modes")
    cust = tables["customer"]
    fdir = os.path.join(base, "faulted_csv")
    faulty = TorchSession({"spark.rapids.test.faults":
                           "io.write.file:crash:1"})
    node = P.WriteFiles(from_host_table(cust, faulty).plan, "csv", fdir,
                        None, {})
    try:
        faulty.execute(node)
        fail("the injected io.write.file fault did not fire")
    except KernelCrashError:
        pass
    visible = [f for _r, _d, fs in os.walk(fdir) for f in fs] \
        if os.path.isdir(fdir) else []
    if visible or read_manifest(fdir) is not None:
        fail(f"aborted CSV write left files: {visible}")
    stats = faulty.execute(node)
    FAULTS.disarm()
    same_host_table(s.read_csv(fdir, schema=cust.schema()).collect_table(),
                    cust, "the retried CSV write read back")
    checks.append("faulted CSV write")
    log(f"  16.5 on the card: {', '.join(checks)} held; the faulted CSV "
        f"write aborted with no visible file and its retry committed "
        f"{int(stats.columns[0].data[0])} file(s), read back bit for bit "
        f"[{card}]")
    return {"checks": checks}


def run_text(seed: int, q1_keep) -> dict:
    """Phase 16: text files in and out (16.1-16.5). Returns every kernel's
    launches over the counted runs."""
    import shutil
    import tempfile

    card = card_line()
    t_phase = time.perf_counter()
    summary = {"card": card, "build": text_build()}
    base = tempfile.mkdtemp(prefix="srt-text-files-")
    totals = {}
    try:
        tables = file_corpus(seed)["tables"]
        lineitem = q1_keep["tables"][0]
        log(f"  16.2 phase 15's scale_test_specs({FILES_SF}) seed {seed} "
            f"tables and oracles; lineitem for q1: phase 4's "
            f"{lineitem.num_rows} rows")
        t0 = time.perf_counter()
        paths, summary["tables"] = text_tables(tables, lineitem, base, card)
        log(f"  16.2 ran {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches, summary["q1"] = text_q1(paths, lineitem, q1_keep, card)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        log(f"  16.3 ran {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches, summary["corpus"] = text_corpus(tables, paths, card)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        log(f"  16.4 ran {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        summary["features"] = text_features(tables, base, card)
        log(f"  16.5 ran {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    took = time.perf_counter() - t_phase
    summary["seconds"] = round(took, 1)
    summary["launches"] = {k: v for k, v in totals.items() if v}
    if took > TEXT_BUDGET_S:
        log(f"  phase 16 took {took:.1f} s, past its {TEXT_BUDGET_S:.0f} s "
            f"budget: lower FILES_SF ({FILES_SF}) for it")
    for k in ("onehot_partials", "gather_compact", "sort_with_payload",
              "fused_minmax"):
        if not totals.get(k):
            fail(f"phase 16 launched no {k}")
    log("  phase-16 summary: " + json.dumps(summary))
    return totals


# ---------------------------------------------------------------------------
# phase 17: ORC files in and out, and the binary codecs
# ---------------------------------------------------------------------------

#: the phase's time budget on the card (seconds)
ORC_BUDGET_S = 120.0
#: the new host sources of the phase
ORC_SOURCES = ("zstd_host", "lz4_host", "orc_host")


def orc_build() -> dict:
    """17.1: the ZSTD, LZ4 and ORC host sources built from scratch into a
    scratch directory (one g++ each, in parallel), timed, and the host
    compiler's version."""
    import pathlib
    import shutil
    import tempfile

    from spark_rapids_tpu_torch import native
    kept, scratch = native.BUILD_DIR, tempfile.mkdtemp(prefix="srt-orc-")
    native.BUILD_DIR = pathlib.Path(scratch)
    try:
        t0 = time.perf_counter()
        native.build(list(ORC_SOURCES))
        build_s = time.perf_counter() - t0
    finally:
        native.BUILD_DIR = kept
        shutil.rmtree(scratch, ignore_errors=True)
    gxx = subprocess.run([native.compiler(), "--version"],
                         capture_output=True, text=True, timeout=60)
    version = (gxx.stdout.splitlines() or ["?"])[0]
    t0 = time.perf_counter()
    for name in ORC_SOURCES:
        native.load(name)
    load_s = time.perf_counter() - t0
    log(f"  17.1 {', '.join(n + '.cpp' for n in ORC_SOURCES)} built from "
        f"source in {build_s:.2f} s by {version}; their first use loaded "
        f"in {load_s:.2f} s")
    return {"build_s": round(build_s, 2), "gxx": version,
            "first_use_s": round(load_s, 2)}


def orc_scan(fmt: str, path: str, mode: str):
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.io.orc import OrcScanNode
    from spark_rapids_tpu_torch.io.parquet import ParquetScanNode
    cls = OrcScanNode if fmt == "orc" else ParquetScanNode
    return cls([path], RapidsConf(), reader_type=mode)


def orc_tables(tables, lineitem, base: str, card: str) -> tuple:
    """17.2: the corpus tables as ORC (ZSTD) and phase 4's lineitem as ORC
    (ZSTD, LZ4) and as Parquet (ZSTD, LZ4), two files a table, written by
    the port and read back in PERFILE, COALESCING and MULTITHREADED, each
    held against its source bit for bit. Returns ({name: ORC directory},
    {label: numbers})."""
    from spark_rapids_tpu_torch.columnar.table import upload_host_table
    from spark_rapids_tpu_torch.models.corpus import write_corpus_files
    jobs = [("orc", "zstd", n, t) for n, t in tables.items()]
    jobs += [("orc", "zstd", "lineitem_q1", lineitem),
             ("orc", "lz4", "lineitem_q1", lineitem),
             ("parquet", "zstd", "lineitem_q1", lineitem),
             ("parquet", "lz4", "lineitem_q1", lineitem)]
    paths, numbers = {}, {}
    for fmt, codec, name, t in jobs:
        label = f"{fmt} {codec} {name}"
        sub = os.path.join(base, f"{fmt}_{codec}")
        t0 = time.perf_counter()
        got_paths = write_corpus_files({name: t}, sub, FILES_PER_TABLE,
                                       fmt=fmt, compression=codec)
        write_s = time.perf_counter() - t0
        path = got_paths[name]
        if fmt == "orc" and codec == "zstd":
            paths[name] = path
        on_disk = dir_bytes(path)
        decode = {}
        for mode in ("PERFILE", "COALESCING", "MULTITHREADED"):
            scan = orc_scan(fmt, path, mode)
            t0 = time.perf_counter()
            got = scan.collect_host()
            decode[mode] = time.perf_counter() - t0
            same_host_table(got, t, f"{label} read back ({mode})")
        host_mb = got.nbytes() / 1e6
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dt = upload_host_table(got, DEV)
        torch.cuda.synchronize()
        upload_ms = (time.perf_counter() - t0) * 1e3
        del dt, got
        best = min(decode.values())
        numbers[label] = {
            "rows": t.num_rows, "bytes_on_disk": on_disk,
            "write_s": round(write_s, 3),
            "decode_s": {m: round(v, 3) for m, v in decode.items()},
            "decoded_mb_per_s": {m: round(host_mb / v, 1)
                                 for m, v in decode.items()},
            "disk_mb_per_s": round(on_disk / 1e6 / best, 1),
            "host_mb": round(host_mb, 1), "upload_ms": round(upload_ms, 2)}
        log(f"  17.2 {label}: {t.num_rows} rows, {on_disk} B on disk, write "
            f"{write_s:.3f} s, decode (host) "
            f"{', '.join(f'{m} {v:.3f} s' for m, v in decode.items())}, "
            f"{host_mb / best:.1f} MB/s decoded ({host_mb:.1f} MB; "
            f"{on_disk / 1e6 / best:.1f} MB/s of file), upload "
            f"{upload_ms:.2f} ms; read back bit for bit in all three modes "
            f"[{card}]")
    return paths, numbers


#: the ZSTD level of the system library's side of the codec comparison:
#: Arrow's default, which pyarrow and Spark's Parquet and ORC writers use
SYSTEM_ZSTD_LEVEL = 1


def host_cpu() -> str:
    """The host CPU's model (``lscpu``'s, else /proc/cpuinfo's), its
    architecture and the cores this process may use."""
    import platform
    model = "model unknown"
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
        with open("/proc/cpuinfo") as f:
            out += f.read()
    except (OSError, subprocess.SubprocessError):
        out = ""
    for line in out.splitlines():
        key, _, value = line.partition(":")
        if key.strip().lower() == "model name" and value.strip():
            model = value.strip()
            break
    return (f"{model}, {platform.machine()}, "
            f"{len(os.sched_getaffinity(0))} cores")


def system_codecs() -> dict:
    """The host's libzstd and liblz4 through ctypes, where the machine
    has them: {name: (compress, decompress)} for the codec comparison
    (the port links neither)."""
    import ctypes.util
    size, buf = ctypes.c_size_t, ctypes.c_char_p
    out = {}
    path = ctypes.util.find_library("zstd")
    if path:
        z = ctypes.CDLL(path)
        z.ZSTD_compressBound.restype = size
        z.ZSTD_compressBound.argtypes = [size]
        z.ZSTD_compress.restype = size
        z.ZSTD_compress.argtypes = [buf, size, buf, size, ctypes.c_int]
        z.ZSTD_decompress.restype = size
        z.ZSTD_decompress.argtypes = [buf, size, buf, size]
        z.ZSTD_isError.restype = ctypes.c_uint
        z.ZSTD_isError.argtypes = [size]

        def zc(src: bytes) -> bytes:
            cap = z.ZSTD_compressBound(len(src))
            dst = ctypes.create_string_buffer(cap)
            k = z.ZSTD_compress(dst, cap, src, len(src), SYSTEM_ZSTD_LEVEL)
            if z.ZSTD_isError(k):
                raise RuntimeError("libzstd: ZSTD_compress failed")
            return dst.raw[:k]

        def zd(src: bytes, n: int) -> bytes:
            dst = ctypes.create_string_buffer(n)
            k = z.ZSTD_decompress(dst, n, src, len(src))
            if z.ZSTD_isError(k) or k != n:
                raise RuntimeError("libzstd: ZSTD_decompress failed")
            return dst.raw
        out[f"zstd {os.path.basename(path)} level {SYSTEM_ZSTD_LEVEL}"] = \
            (zc, zd)
    path = ctypes.util.find_library("lz4")
    if path:
        c = ctypes.CDLL(path)
        c.LZ4_compressBound.restype = ctypes.c_int
        c.LZ4_compressBound.argtypes = [ctypes.c_int]
        for fn in (c.LZ4_compress_default, c.LZ4_decompress_safe):
            fn.restype = ctypes.c_int
            fn.argtypes = [buf, buf, ctypes.c_int, ctypes.c_int]

        def lc(src: bytes) -> bytes:
            cap = c.LZ4_compressBound(len(src))
            dst = ctypes.create_string_buffer(cap)
            k = c.LZ4_compress_default(src, dst, len(src), cap)
            if k <= 0:
                raise RuntimeError("liblz4: LZ4_compress_default failed")
            return dst.raw[:k]

        def ld(src: bytes, n: int) -> bytes:
            dst = ctypes.create_string_buffer(n)
            if c.LZ4_decompress_safe(src, dst, len(src), n) != n:
                raise RuntimeError("liblz4: LZ4_decompress_safe failed")
            return dst.raw
        out[f"lz4 {os.path.basename(path)}"] = (lc, ld)
    return out


def orc_codec_rates(table, base: str, card: str, reps: int = 3) -> dict:
    """17.2: the port's ZSTD and LZ4 (``native/zstd_host.cpp``,
    ``lz4_host.cpp``) against the host's libzstd (Arrow's default level)
    and liblz4, on the bytes the ORC writer compresses: ``table`` written
    as uncompressed ORC, cut into the writer's 256 KiB blocks. Each side
    round-trips every block, then is timed (median of ``reps``): its
    compressed share of the input and its host MB/s each way. Host
    numbers, not device ones; a library the machine lacks is logged as
    not measured."""
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.io import orc_format as OF
    path = os.path.join(base, "codecs.orc")
    OF.write_table(table, path, compression="none")
    with open(path, "rb") as f:
        raw = f.read()
    os.remove(path)
    blocks = [raw[i:i + OF.BLOCK_SIZE]
              for i in range(0, len(raw), OF.BLOCK_SIZE)]
    sides = {"zstd port": (native.zstd_compress, native.zstd_decompress),
             "lz4 port": (native.lz4_compress, native.lz4_decompress)}
    sides.update(system_codecs())
    out = {"input_bytes": len(raw), "blocks": len(blocks),
           "rows": table.num_rows, "host": host_cpu(), "sides": {}}

    def median_s(fn) -> float:
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            runs.append(time.perf_counter() - t0)
        return statistics.median(runs)

    for name, (comp, decomp) in sides.items():
        packed = [comp(b) for b in blocks]
        for b, p in zip(blocks, packed):
            if bytes(decomp(p, len(b))) != b:
                raise AssertionError(f"17.2 codecs: {name} did not "
                                     "round-trip a block")
        enc = median_s(lambda: [comp(b) for b in blocks])
        dec = median_s(lambda: [decomp(p, len(b))
                                for b, p in zip(blocks, packed)])
        share = sum(map(len, packed)) / len(raw)
        out["sides"][name] = {
            "compressed_share": round(share, 4),
            "compress_mb_per_s": round(len(raw) / 1e6 / enc, 1),
            "decompress_mb_per_s": round(len(raw) / 1e6 / dec, 1)}
        log(f"  17.2 codecs, {name}: {share:.4f} of {len(raw)} B in "
            f"{len(blocks)} blocks, compress {len(raw) / 1e6 / enc:.1f} "
            f"MB/s, decompress {len(raw) / 1e6 / dec:.1f} MB/s (host: "
            f"{out['host']}) [{card}]")
    for lib in ("zstd", "lz4"):
        if not any(n.startswith(lib) and not n.endswith("port")
                   for n in out["sides"]):
            log(f"  17.2 codecs: no system lib{lib} on this machine, its "
                "side not measured")
    return out


def orc_q1(paths, q1_keep, card: str) -> tuple:
    """17.3: TPC-H q1 over lineitem from its ORC (ZSTD) files through
    ``run_case`` (cold, warm, host syncs, peak memory, every launch held
    against its plain version) against phase 4's oracle."""
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    from spark_rapids_tpu_torch.session import TorchSession
    session = TorchSession()
    cold = {}

    def check(got):
        if not cold:
            cold.update(session.last_metrics(), **session.last_timings())
        q1_keep["check"](got)

    res = run_case(session, "q1 from ORC",
                   lambda: q1_dataframe(session, session.read_orc(
                       paths["lineitem_q1"])), check, None, warm_runs=2)
    log("  17.3 q1 from ORC, the cold run's counters and seconds: "
        + json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in cold.items() if v}))
    for k in ("onehot_partials", "gather_compact", "sort_with_payload"):
        if not res["launches"].get(k):
            fail(f"q1 from ORC launched no {k}")
    m = session.last_metrics()
    decode_ms = round(m.get("scanDecodeTime", 0) * 1e3, 2)
    upload_ms = round(m.get("scanUploadTime", 0) * 1e3, 2)
    log(f"  17.3 q1 from ORC: cold {res['stats']['cold_ms']} ms, warm "
        f"{res['stats']['warm_ms']} ms against phase 15's q1 from Parquet "
        f"warm {q1_keep.get('files_warm_ms')} ms and phase 4's in-memory "
        f"warm {q1_keep['warm_ms']} ms (the counted run waited {decode_ms} "
        f"ms on the decode and uploaded for {upload_ms} ms); host syncs "
        f"{res['stats']['syncs']}; peak {res['stats']['peak_gib']} GiB; "
        f"result matches phase 4's oracle [{card}]")
    return res["launches"], dict(
        res["stats"], decode_ms=decode_ms, upload_ms=upload_ms,
        in_memory_warm_ms=q1_keep["warm_ms"],
        parquet_warm_ms=q1_keep.get("files_warm_ms"))


def orc_corpus(tables, paths, card: str) -> tuple:
    """17.4: the 22 corpus queries over the ORC files as DataFrames
    (``build_queries(..., fmt="orc")``) and as SQL over ``CREATE TEMP VIEW
    ... USING orc``, each through ``run_case`` (one warm run before the
    counted one) against its oracle. Returns (launch totals, numbers)."""
    from spark_rapids_tpu_torch.models.corpus import (
        CORPUS,
        build_queries,
        build_sql_queries,
    )
    from spark_rapids_tpu_torch.session import TorchSession
    oracles = file_oracles(tables)
    table_paths = {n: paths[n] for n in tables}
    forms = []
    for label, build in (("ORC", build_queries),
                         ("ORC SQL", build_sql_queries)):
        session = TorchSession()
        forms.append((label, session, build(session, tables,
                                            paths=table_paths, fmt="orc")))
    total, numbers = {}, {}
    for name in CORPUS:
        for label, session, queries in forms:
            case = f"{name} from {label}"
            res = run_case(session, case, queries[name], oracles[name], None,
                           warm_runs=1)
            m = session.last_metrics()
            for k, v in res["launches"].items():
                total[k] = total.get(k, 0) + v
            decode_ms = round(m.get("scanDecodeTime", 0) * 1e3, 2)
            numbers[case] = {
                "warm_ms": res["stats"]["warm_ms"],
                "cold_ms": res["stats"]["cold_ms"],
                "decode_ms": decode_ms,
                "upload_ms": round(m.get("scanUploadTime", 0) * 1e3, 2),
                "decode_share": round(decode_ms / max(
                    res["stats"]["warm_ms"], 1e-9), 3),
                "syncs": res["stats"]["syncs"],
                "launches": {k: v for k, v in res["launches"].items() if v}}
    log(f"  17.4 all {len(forms) * len(CORPUS)} corpus runs from ORC files "
        "match their oracles; warm ms (the decode's share of the counted "
        "run): " + ", ".join(f"{k} {v['warm_ms']} ({v['decode_share']})"
                             for k, v in numbers.items()) + f" [{card}]")
    return total, numbers


def orc_faults(tables, paths, base: str, card: str) -> dict:
    """17.5: an ORC write under an injected io.write.file fault (aborted
    with no visible file, then committed on the retry and read back bit
    for bit), a ZSTD frame with one byte flipped and one cut short, and
    an ORC file cut short, each raising ColumnarProcessingError."""
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.errors import (
        ColumnarProcessingError,
        KernelCrashError,
    )
    from spark_rapids_tpu_torch.io import orc_format as OF
    from spark_rapids_tpu_torch.io.committer import read_manifest
    from spark_rapids_tpu_torch.io.common import expand_paths
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.plan import nodes as P
    from spark_rapids_tpu_torch.runtime.faults import FAULTS
    from spark_rapids_tpu_torch.session import TorchSession
    cust = tables["customer"]
    fdir = os.path.join(base, "orc_faulted")
    faulty = TorchSession({"spark.rapids.test.faults":
                           "io.write.file:crash:1"})
    node = P.WriteFiles(from_host_table(cust, faulty).plan, "orc", fdir,
                        None, {"compression": "zstd"})
    try:
        faulty.execute(node)
        fail("the injected io.write.file fault did not fire (ORC)")
    except KernelCrashError:
        pass
    visible = [f for _r, _d, fs in os.walk(fdir) for f in fs] \
        if os.path.isdir(fdir) else []
    if visible or read_manifest(fdir) is not None:
        fail(f"aborted ORC write left files: {visible}")
    stats = faulty.execute(node)
    FAULTS.disarm()
    same_host_table(TorchSession().read_orc(fdir).collect_table(), cust,
                    "the retried ORC write read back")
    text = ("|".join(str(i) for i in range(20000))).encode()
    frame = bytearray(native.zstd_compress(text, checksum=True))
    raised = []
    for what, bad in (("a flipped byte", bytes(frame[:len(frame) // 2])
                       + bytes([frame[len(frame) // 2] ^ 0x10])
                       + bytes(frame[len(frame) // 2 + 1:])),
                      ("a cut frame", bytes(frame[:len(frame) - 7]))):
        try:
            native.zstd_decompress(bad)
            fail(f"a ZSTD frame with {what} decoded")
        except ColumnarProcessingError as e:
            raised.append(f"{what}: {e}")
    one = expand_paths([paths["customer"]])[0]
    raw = open(one, "rb").read()
    cut = os.path.join(base, "cut.orc")
    with open(cut, "wb") as f:
        f.write(raw[:len(raw) // 2])
    try:
        OF.read_table(cut)
        fail("an ORC file cut in half decoded")
    except ColumnarProcessingError as e:
        raised.append(f"a cut ORC file: {e}")
    log(f"  17.5 injected io.write.file fault on an ORC write: aborted with "
        f"no visible file, the retry committed "
        f"{int(stats.columns[0].data[0])} file(s), read back bit for bit; "
        f"corrupt input raised ColumnarProcessingError: {raised} [{card}]")
    return {"retry_files": int(stats.columns[0].data[0]),
            "raised": len(raised)}


def run_orc(seed: int, q1_keep) -> dict:
    """Phase 17: ORC files in and out and the binary codecs (17.1-17.5).
    Returns every kernel's launches over the counted runs."""
    import shutil
    import tempfile

    card = card_line()
    t_phase = time.perf_counter()
    summary = {"card": card, "build": orc_build()}
    base = tempfile.mkdtemp(prefix="srt-orc-files-")
    totals = {}
    try:
        tables = file_corpus(seed)["tables"]
        lineitem = q1_keep["tables"][0]
        log(f"  17.2 phase 15's scale_test_specs({FILES_SF}) seed {seed} "
            f"tables and oracles; lineitem for q1: phase 4's "
            f"{lineitem.num_rows} rows")
        t0 = time.perf_counter()
        paths, summary["tables"] = orc_tables(tables, lineitem, base, card)
        summary["codecs"] = orc_codec_rates(tables["lineitem"], base, card)
        log(f"  17.2 ran {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches, summary["q1"] = orc_q1(paths, q1_keep, card)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        log(f"  17.3 ran {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches, summary["corpus"] = orc_corpus(tables, paths, card)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        log(f"  17.4 ran {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        summary["faults"] = orc_faults(tables, paths, base, card)
        log(f"  17.5 ran {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    took = time.perf_counter() - t_phase
    summary["seconds"] = round(took, 1)
    summary["launches"] = {k: v for k, v in totals.items() if v}
    if took > ORC_BUDGET_S:
        log(f"  phase 17 took {took:.1f} s, past its {ORC_BUDGET_S:.0f} s "
            f"budget: lower FILES_SF ({FILES_SF}) for it")
    for k in ("onehot_partials", "gather_compact", "sort_with_payload",
              "fused_minmax"):
        if not totals.get(k):
            fail(f"phase 17 launched no {k}")
    log("  phase-17 summary: " + json.dumps(summary))
    return totals


# ---------------------------------------------------------------------------
# phase 18: dynamic partition pruning, the bloom filter and recovery
# ---------------------------------------------------------------------------

#: the phase's time budget on the card (seconds)
DPP_BUDGET_S = 120.0
#: TPC-H's own l_shipdate range (dbgen: o_orderdate from 1992-01-01 to
#: 1998-08-02, plus 1 to 121 days): 84 months
TPCH_SHIP_FIRST = "1992-01-02"
TPCH_SHIP_LAST = "1998-12-01"
#: the months the DPP query keeps (m_year = 1995 AND m_quarter = 1)
DPP_MONTHS = (199501, 199502, 199503)
#: rows of q1 in each fatal-error child process (18.4)
FATAL_CHILD_ROWS = 1 << 20


def _days(iso: str) -> int:
    return int(np.datetime64(iso, "D").astype(np.int64))


def dpp_lineitem(table, seed: int):
    """Phase 4's lineitem with ``l_shipdate`` drawn again, uniformly over
    TPC-H's own range (models/tpch.py's generator draws 1994-1999), and
    the derived ``l_shipmonth`` LONG (yyyymm): 84 months."""
    from spark_rapids_tpu_torch import types as TT
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    rng = np.random.default_rng(seed)
    ship = rng.integers(_days(TPCH_SHIP_FIRST), _days(TPCH_SHIP_LAST) + 1,
                        size=table.num_rows).astype(np.int32)
    ym = ship.astype("datetime64[D]").astype("datetime64[M]").astype(
        np.int64)
    month = (ym // 12 + 1970) * 100 + ym % 12 + 1
    cols = {n: c for n, c in zip(table.names, table.columns)}
    cols["l_shipdate"] = HostColumn(TT.DATE, ship)
    cols["l_shipmonth"] = HostColumn(TT.LONG, month)
    return HostTable(list(cols), list(cols.values()))


def months_table():
    """The month dimension: ``m_month`` (yyyymm LONG), ``m_year`` and
    ``m_quarter`` (INT), 1992-01 to 1998-12."""
    from spark_rapids_tpu_torch import types as TT
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    m = np.array([y * 100 + k for y in range(1992, 1999)
                  for k in range(1, 13)], dtype=np.int64)
    return HostTable(["m_month", "m_year", "m_quarter"], [
        HostColumn(TT.LONG, m),
        HostColumn(TT.INT, (m // 100).astype(np.int32)),
        HostColumn(TT.INT, ((m % 100 - 1) // 3 + 1).astype(np.int32))])


def dpp_oracle(li):
    """q1's numpy oracle over the rows of ``DPP_MONTHS``."""
    from spark_rapids_tpu_torch.columnar import HostTable
    keep = np.isin(li.columns[li.names.index("l_shipmonth")].data,
                   DPP_MONTHS)
    return q1_oracle(HostTable(li.names, [type(c)(c.dtype, c.data[keep])
                                          for c in li.columns]))


#: the DPP query as SQL: Q1_SQL over the star join, the dimension's filter
#: written on its side of the join (neither package pushes a predicate
#: through a join)
DPP_JOIN = ("lineitem_parts JOIN (SELECT m_month FROM months WHERE "
            "m_year = 1995 AND m_quarter = 1) m ON l_shipmonth = m.m_month")


def dpp_forms(path, months):
    """{form: (session -> DataFrame)} of the DPP query: q1's aggregate over
    ``lineitem JOIN months ON l_shipmonth = m_month WHERE m_year = 1995
    AND m_quarter = 1`` from the DSL and from SQL text over ``CREATE TEMP
    VIEW ... USING parquet``."""
    from spark_rapids_tpu_torch.models.tpch import Q1_SQL, q1_dataframe
    from spark_rapids_tpu_torch.ops.expr import col, lit
    from spark_rapids_tpu_torch.plan import from_host_table

    def dsl(s):
        dim = (from_host_table(months, s)
               .filter((col("m_year") == lit(1995))
                       & (col("m_quarter") == lit(1)))
               .select(col("m_month").alias("l_shipmonth")))
        return q1_dataframe(s, s.read_parquet(path).join(dim,
                                                         on="l_shipmonth"))

    text = Q1_SQL.replace("FROM lineitem", "FROM " + DPP_JOIN)

    def sql(s):
        s.sql(f"CREATE OR REPLACE TEMP VIEW lineitem_parts USING parquet "
              f"OPTIONS (path '{path}')")
        from_host_table(months, s).create_or_replace_temp_view("months")
        return s.sql(text)

    return {"DSL": dsl, "SQL": sql}


def run_dpp(li, base: str, card: str) -> tuple:
    """18.1: the SF 1 lineitem written Hive-partitioned by l_shipmonth (84
    directories), then the DPP query from each form with pruning on and
    off, each through ``run_case`` (every launch held against its plain
    version, the host syncs of a warm run counted, the provider's
    read-back among them) against the numpy oracle; on, the scan reads 3
    files and prunes 81. Returns (launch totals, numbers)."""
    from spark_rapids_tpu_torch.io.common import expand_paths
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.session import TorchSession
    path = os.path.join(base, "lineitem_by_month")
    t0 = time.perf_counter()
    from_host_table(li, TorchSession()).write_parquet(
        path, partition_by=["l_shipmonth"])
    write_s = time.perf_counter() - t0
    files = expand_paths([path])
    log(f"  18.1 wrote {li.num_rows} lineitem rows as {len(files)} Parquet "
        f"files under l_shipmonth=yyyymm in {write_s:.2f} s "
        f"({dir_bytes(path)} B) [{card}]")
    if len(files) != 84:
        fail(f"the partitioned lineitem has {len(files)} files, want 84")
    oracle = dpp_oracle(li)
    months = months_table()
    totals, numbers = {}, {"write_s": round(write_s, 3), "files": len(files)}
    for form, build in dpp_forms(path, months).items():
        for on in (True, False):
            name = f"DPP q1 {form} {'on' if on else 'off'}"
            session = TorchSession(
                {} if on else {"spark.rapids.sql.dpp.enabled": "false"})
            res = run_case(session, name, lambda s=session: build(s),
                           lambda g: check_q1_result(g, oracle), None,
                           warm_runs=2)
            m = session.last_metrics()
            for k, v in res["launches"].items():
                totals[k] = totals.get(k, 0) + v
            for k in ("onehot_partials", "gather_compact",
                      "sort_with_payload"):
                if not res["launches"].get(k):
                    fail(f"{name} launched no {k}")
            scanned, pruned = m.get("dppScannedFiles"), m.get("dppPrunedFiles")
            if (scanned, pruned) != ((3, 81) if on else (None, None)):
                fail(f"{name}: dppScannedFiles {scanned}, dppPrunedFiles "
                     f"{pruned}")
            numbers[name] = dict(
                res["stats"], decode_ms=round(
                    m.get("scanDecodeTime", 0) * 1e3, 2),
                upload_ms=round(m.get("scanUploadTime", 0) * 1e3, 2),
                scanned=scanned if on else len(files), pruned=pruned or 0,
                launches={k: v for k, v in res["launches"].items() if v})
            log(f"  18.1 {name}: warm {res['stats']['warm_ms']} ms, cold "
                f"{res['stats']['cold_ms']} ms, {numbers[name]['decode_ms']} "
                f"ms on the decode; files read {numbers[name]['scanned']}, "
                f"pruned {numbers[name]['pruned']}; host syncs "
                f"{res['stats']['syncs']}; matches the oracle [{card}]")
    return totals, numbers


def run_bloom(tables, card: str) -> tuple:
    """18.2: a bloom filter over the keys of the 1995 orders at the
    default 2^20 bits and 3 hashes, built on the card; its bits against
    the plain build on the CPU over the same keys, bit for bit; every
    lineitem row of a 1995 order kept by ``might_contain``; the join
    after the pre-filter (through ``run_case``) against a numpy oracle,
    beside the join without it. Returns (launch totals, numbers)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch import types as TT
    from spark_rapids_tpu_torch.ops.bloom import build_bits
    from spark_rapids_tpu_torch.ops.expr import col, lit
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.session import TorchSession
    orders, li = tables["orders"], tables["lineitem"]
    lo, hi = _days("1995-01-01"), _days("1996-01-01")
    s = TorchSession()
    od = from_host_table(orders, s).filter(
        (col("o_orderdate") >= lit(lo, TT.DATE))
        & (col("o_orderdate") < lit(hi, TT.DATE)))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        bloom = F.build_bloom_filter(od, "o_orderkey")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    # the build's host syncs: the column stays on the card (the export)
    with host_sync_count() as box:
        F.build_bloom_filter(od, "o_orderkey")
        torch.cuda.synchronize()
    o = {n: c.data for n, c in zip(orders.names, orders.columns)}
    keys = o["o_orderkey"][(o["o_orderdate"] >= lo) & (o["o_orderdate"] < hi)]
    plain = build_bits(torch.from_numpy(keys.astype(np.int64)),
                       torch.ones(len(keys), dtype=torch.bool),
                       bloom.num_bits, bloom.num_hashes)
    if bloom.bits.device.type != DEV.type or not torch.equal(
            bloom.bits.cpu(), plain):
        fail("the bloom filter's bits differ from the plain CPU build")
    lcol = {n: c for n, c in zip(li.names, li.columns)}
    truth = np.isin(lcol["l_orderkey"].data, keys)
    kept = from_host_table(li, s).filter(F.might_contain(
        bloom, col("l_orderkey"))).collect_table()
    kept_keys = kept.columns[kept.names.index("l_orderkey")].data
    if int(np.isin(kept_keys, keys).sum()) != int(truth.sum()):
        fail("might_contain dropped a lineitem row of a 1995 order")
    rf, ls = lcol["l_returnflag"].data[truth], lcol["l_linestatus"].data[truth]
    want = collections.Counter(zip(rf, ls))
    qty = collections.defaultdict(int)
    price = collections.defaultdict(float)
    for a, b, q, p in zip(rf, ls, lcol["l_quantity"].data[truth],
                          lcol["l_extendedprice"].data[truth]):
        qty[(a, b)] += int(q)
        price[(a, b)] += float(p)

    def check(got):
        rows = list(zip(*[c.data for c in got.columns]))
        if [(r[0], r[1]) for r in rows] != sorted(want) or any(
                r[2] != want[(r[0], r[1])] or r[3] != qty[(r[0], r[1])]
                or not math.isclose(r[4], price[(r[0], r[1])], rel_tol=1e-9)
                for r in rows):
            fail(f"the bloom pre-filtered join: {rows}")

    def join(pre):
        def build():
            df = from_host_table(li, s)
            if pre:
                df = df.filter(F.might_contain(bloom, col("l_orderkey")))
            return (df.join(od.select(col("o_orderkey").alias("l_orderkey")),
                            on="l_orderkey")
                    .group_by("l_returnflag", "l_linestatus")
                    .agg(F.count().alias("c"), F.sum("l_quantity").alias("q"),
                         F.sum("l_extendedprice").alias("p"))
                    .sort("l_returnflag", "l_linestatus"))
        return build

    totals, numbers = {}, {}
    for pre in (True, False):
        name = f"join of 1995 orders {'after' if pre else 'without'} the " \
               "bloom pre-filter"
        res = run_case(s, name, join(pre), check, None, warm_runs=2)
        for k, v in res["launches"].items():
            totals[k] = totals.get(k, 0) + v
        numbers["prefiltered" if pre else "plain"] = res["stats"]
    numbers.update(
        build_syncs=box["syncs"],
        build_ms=round(statistics.median(times) * 1e3, 3),
        build_cold_ms=round(times[0] * 1e3, 3), keys=int(len(keys)),
        set_bits=bloom.approx_set_bits(), kept=kept.num_rows,
        true_matches=int(truth.sum()),
        false_positives=kept.num_rows - int(truth.sum()))
    log(f"  18.2 bloom filter over {len(keys)} keys of the 1995 orders "
        f"({bloom.num_bits} bits, {bloom.num_hashes} hashes, "
        f"{numbers['set_bits']} set): built in {numbers['build_ms']} ms warm "
        f"({numbers['build_cold_ms']} cold, {numbers['build_syncs']} host "
        "syncs), bits equal the plain CPU build; "
        f"might_contain keeps {kept.num_rows} of {li.num_rows} lineitem rows "
        f"({numbers['false_positives']} false positives, no false negative); "
        f"the join warm {numbers['prefiltered']['warm_ms']} ms after the "
        f"pre-filter, {numbers['plain']['warm_ms']} ms without [{card}]")
    return totals, numbers


def _recovery_run(session, name, build, expect=None):
    """One run of ``build()`` with every kernel launch recorded and held
    against its plain version: (result or the expected exception,
    last_metrics, launches, seconds)."""
    from spark_rapids_tpu_torch import kernels as K
    K.reset_launch_counts()
    K.calls = []
    t0 = time.perf_counter()
    try:
        out = build().collect_table()
        torch.cuda.synchronize()
        if expect is not None:
            fail(f"{name}: no {expect.__name__} raised")
    except Exception as e:  # noqa: BLE001 (the expected one is kept)
        if expect is None or not isinstance(e, expect):
            raise
        out = e
    finally:
        calls, K.calls = K.calls, None
    dt = time.perf_counter() - t0
    hold_launches(name, calls)
    return out, session.last_metrics(), K.launch_counts(), dt


def squeeze_ballast(table, budget: int):
    """An unspillable accounted tensor on the card (a co-resident query's
    pinned working set) that leaves three quarters of one scan chunk of
    ``table`` free under ``budget``: q1's landing and rung ``retry``'s
    same-shape replay do not fit, rung ``chunk``'s half chunks do."""
    from spark_rapids_tpu_torch import types as TT
    from spark_rapids_tpu_torch.columnar import DeviceColumn, DeviceTable
    from spark_rapids_tpu_torch.columnar import bucket_for
    from spark_rapids_tpu_torch.runtime.memory import (
        MEMORY,
        estimate_device_nbytes,
    )
    cap = bucket_for(table.num_rows)
    per_row = estimate_device_nbytes(table, cap) / cap
    rows = 128
    while rows * 2 <= int(budget * 0.25 / per_row):
        rows *= 2
    chunk = int(per_row * rows)
    occupied = MEMORY.snapshot()["occupancyBytes"]
    n = max(1, (budget - 3 * chunk // 4 - occupied) // 9)
    ballast = DeviceTable(["ballast"], [DeviceColumn(
        TT.LONG, torch.ones(n, dtype=torch.int64, device=DEV),
        torch.ones(n, dtype=torch.bool, device=DEV))], n, n, DEV)
    MEMORY.account(ballast)
    return ballast, chunk


def run_recovery(q1_keep, base: str, card: str) -> tuple:
    """18.3: q1 at SF 1 (phase 4's table and oracle) under injected and
    real faults, each run's launches held against their plain versions:
    a transient crash at the aggregate (one replay; the breaker's
    demotion is phase 22's P3), ``mem.reserve`` OOMs past the retries
    (rung ``retry``), a squeezed budget (rungs ``retry`` then ``chunk``)
    and an injected device loss (a crash report, DeviceLostError, then
    the next q1 on the card). Returns (launch totals, numbers)."""
    from spark_rapids_tpu_torch.errors import DeviceLostError
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    from spark_rapids_tpu_torch.runtime.faults import CIRCUIT_BREAKER, FAULTS
    from spark_rapids_tpu_torch.runtime.health import HEALTH
    from spark_rapids_tpu_torch.runtime.memory import estimate_device_nbytes
    from spark_rapids_tpu_torch.runtime.spill import BufferCatalog
    from spark_rapids_tpu_torch.session import TorchSession
    table, check = q1_keep["tables"][0], q1_keep["check"]
    totals, numbers = {}, {}

    def case(name, conf, expect=None, ms_of=True):
        session = TorchSession(conf)
        out, m, launches, dt = _recovery_run(
            session, name, lambda: q1_dataframe(session, table), expect)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        if expect is None:
            check(out)
        numbers[name] = {"ms": round(dt * 1e3, 2), **{
            k: m[k] for k in ("runtimeFaultReplays", "query_replays",
                              "oomRetries", "memoryPressure",
                              "memoryChunkedReexecutions", "deviceLost",
                              "deviceReinits") if m.get(k)}}
        return out, m

    faults = "spark.rapids.test.faults"
    _, m = case("q1 exec.execute@Aggregate:crash:1",
                {faults: "exec.execute@Aggregate:crash:1"})
    if m["runtimeFaultReplays"] != 1:
        fail(f"q1 crash:1 replayed {m['runtimeFaultReplays']} times")
    # one recorded failure: a later crash of the aggregate must not trip
    # the breaker (its demotion is phase 22's)
    CIRCUIT_BREAKER.reset()
    fresh_device()
    _, m = case("q1 mem.reserve:oom:3", {faults: "mem.reserve:oom:3"})
    if (m.get("memoryPressure"), m.get("memoryChunkedReexecutions")) != \
            (1, None):
        fail(f"q1 mem.reserve:oom:3: {m}")
    fresh_device()
    BufferCatalog.get().spill_all_device()
    budget = estimate_device_nbytes(table)
    ballast, chunk = squeeze_ballast(table, budget)
    try:
        _, m = case("q1 squeezed", {
            "spark.rapids.memory.device.budgetBytes": str(budget)})
    finally:
        del ballast
    numbers["q1 squeezed"].update(budget=budget, chunk=chunk)
    if (m.get("memoryPressure"), m.get("memoryChunkedReexecutions")) != \
            (2, 1):
        fail(f"q1 squeezed: {m}")
    fresh_device()
    dump = os.path.join(base, "crash")
    err, m = case("q1 exec.execute:device_lost:1", {
        faults: "exec.execute:device_lost:1",
        "spark.rapids.memory.crashDump.dir": dump}, expect=DeviceLostError)
    report = json.load(open(err.report_path))
    if "TpuHashAggregateExec" not in report["plan"] or \
            (m.get("deviceLost"), m.get("deviceReinits")) != (1, 1):
        fail(f"the device loss: {m}, plan {report['plan']!r}")
    FAULTS.disarm()
    case("q1 after the device loss", {})
    if HEALTH.snapshot()["consecutiveLosses"] != 0:
        fail("the q1 after the device loss did not reset the health monitor")
    log("  18.3 recovery on q1 at SF 1 (phase 4's warm "
        f"{q1_keep['warm_ms']} ms): " + "; ".join(
            f"{k}: {v}" for k, v in numbers.items()) + f" [{card}]")
    return totals, numbers


def fatal_child(mode: str, dump_dir: str) -> int:
    """18.4's child process: q1 warm, then an out-of-bounds index on the
    card (a device-side assert that poisons the context), then q1 three
    more times; prints what each later run raised or answered as one JSON
    line. Under ``exit`` the session has ``spark.rapids.fatalError.exit``
    set and the process should exit 20 before printing. Under ``latch``
    the second run meets the poisoned context and raises DeviceLostError
    (its failed probe latches CPU-only mode); the third and fourth answer
    q1's oracle on the CPU route, the latch's reason in ``explain``,
    making no CUDA call (phase 22's P3 (c))."""
    from spark_rapids_tpu_torch.models.tpch import lineitem_table, q1_dataframe
    from spark_rapids_tpu_torch.overrides.rules import collect_cpu_nodes
    from spark_rapids_tpu_torch.runtime.health import HEALTH
    from spark_rapids_tpu_torch.session import TorchSession
    table = lineitem_table(FATAL_CHILD_ROWS, seed=0)
    oracle = q1_oracle(table)
    conf = {"spark.rapids.memory.crashDump.dir": dump_dir}
    if mode == "exit":
        conf["spark.rapids.fatalError.exit"] = "true"
    s = TorchSession(conf)
    for _ in range(2):
        check_q1_result(q1_dataframe(s, table).collect_table(), oracle)
    out = {"mode": mode}
    try:
        x = torch.zeros(4, device=DEV)
        x[torch.full((1,), 1 << 20, dtype=torch.int64, device=DEV)]
    except Exception as e:  # noqa: BLE001 (reported, not expected)
        out["poison"] = f"{type(e).__name__}: {e}"
    for run in ("second", "third", "fourth"):
        t0 = time.perf_counter()
        try:
            df = q1_dataframe(s, table)
            got = df.collect_table()
            check_q1_result(got, oracle)
            reason = HEALTH.cpu_only_reason()
            out[run] = "answered"
            out[f"{run}_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
            out[f"{run}_latch_in_explain"] = bool(reason) and \
                reason in s.explain(df)
            out[f"{run}_cpu_nodes"] = collect_cpu_nodes(s._last_root)
        except Exception as e:  # noqa: BLE001 (each run's outcome)
            out[run] = f"{type(e).__name__}: {e}"
    out["cpuOnlyReason"] = HEALTH.snapshot()["cpuOnlyReason"]
    print(json.dumps(out), flush=True)
    os._exit(0)


def run_fatal_children(base: str, card: str) -> dict:
    """18.4: the two fatal-error children, run together: under
    ``spark.rapids.fatalError.exit`` the child exits 20 and leaves a
    report naming the plan and the CUDA error; without it, its q1 after
    the poison raises DeviceLostError naming the CPU-only latch, and the
    next two answer q1 on the CPU route (phase 22's P3 (c))."""
    procs = {}
    for mode in ("exit", "latch"):
        d = os.path.join(base, f"fatal_{mode}")
        os.makedirs(d, exist_ok=True)
        procs[mode] = (d, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--fatal-child",
             mode, "--fatal-dir", d], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = {}
    for mode, (d, p) in procs.items():
        try:
            so, se = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
            fail(f"the fatal-error child ({mode}) did not finish")
        reports = sorted(f for f in os.listdir(d) if f.startswith("crash_"))
        report = json.load(open(os.path.join(d, reports[-1]))) \
            if reports else {}
        out[mode] = {"rc": p.returncode, "reports": len(reports),
                     "exception": report.get("exception", "")[:200],
                     "stdout": so.strip().splitlines()[-1:] if so else []}
        cuda = "device-side assert" in report.get("exception", "") or \
            "device-side assert" in report.get("traceback", "")
        if not reports or "TpuHashAggregateExec" not in report.get(
                "plan", "") or not cuda:
            fail(f"the fatal-error child ({mode}) left no report naming the "
                 f"plan and the CUDA error: rc {p.returncode}, stderr "
                 f"{se[-2000:]}")
        if mode == "exit" and p.returncode != 20:
            fail(f"the fatal-error child (exit) returned {p.returncode}, "
                 f"want 20; stderr {se[-2000:]}")
        if mode == "latch":
            res = json.loads(so.strip().splitlines()[-1]) if p.returncode \
                == 0 and so.strip() else {}
            answered = all(res.get(r) == "answered"
                           and res.get(f"{r}_latch_in_explain")
                           for r in ("third", "fourth"))
            if not (res.get("second", "").startswith("DeviceLostError")
                    and "CPU-only mode latched" in res.get("second", "")
                    and answered and res.get("cpuOnlyReason")):
                fail(f"the fatal-error child (latch): rc {p.returncode}, "
                     f"{res}, stderr {se[-2000:]}")
            out[mode].update({k: (v[:200] if isinstance(v, str) else v)
                              for k, v in res.items() if k != "mode"})
    log(f"  18.4 fatal CUDA errors in two child processes: {out} [{card}]")
    FATAL_RESULTS.update(out)
    return out


def run_dpp_phase(seed: int, q1_keep) -> dict:
    """Phase 18: DPP at SF 1 (18.1), the bloom filter (18.2), recovery on
    q1 (18.3) and a real fatal CUDA error in two children (18.4).
    Returns every kernel's launches over the counted runs."""
    import shutil
    import tempfile

    card = card_line()
    t_phase = time.perf_counter()
    summary = {"card": card}
    base = tempfile.mkdtemp(prefix="srt-dpp-")
    totals = {}
    try:
        t0 = time.perf_counter()
        li = dpp_lineitem(q1_keep["tables"][0], seed)
        launches, summary["dpp"] = run_dpp(li, base, card)
        del li
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        log(f"  18.1 ran {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches, summary["bloom"] = run_bloom(file_corpus(seed)["tables"],
                                               card)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        log(f"  18.2 ran {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches, summary["recovery"] = run_recovery(q1_keep, base, card)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        log(f"  18.3 ran {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        summary["fatal"] = run_fatal_children(base, card)
        log(f"  18.4 ran {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    took = time.perf_counter() - t_phase
    summary["seconds"] = round(took, 1)
    summary["launches"] = {k: v for k, v in totals.items() if v}
    if took > DPP_BUDGET_S:
        log(f"  phase 18 took {took:.1f} s, past its {DPP_BUDGET_S:.0f} s "
            "budget")
    for k in ("onehot_partials", "gather_compact", "sort_with_payload"):
        if not totals.get(k):
            fail(f"phase 18 launched no {k}")
    log("  phase-18 summary: " + json.dumps(summary))
    return totals


# ---------------------------------------------------------------------------
# phase 19: the query envelope's observability and warm path
# ---------------------------------------------------------------------------

#: the seconds phase 19 may take
OBS_BUDGET_S = 120.0
#: the kernels q1's engine trace must show under their launch ranges, with
#: the family (``KERNEL_FAMILIES``) whose CUDA names they launch
Q1_TRACE_KERNELS = {"onehot_partials": "partials",
                    "gather_compact": "compaction",
                    "sort_with_payload": "sort"}
#: phase 19.2's queries: the 22 corpus queries, sparse q3 and q8's MIN/MAX
OBS_QUERIES = tuple(f"q{i}" for i in range(1, 23)) + (
    "q3 sparse", "min/max group-by")
#: the pinned pool of phase 19.5's sessions (both: a pool of another size
#: restarts the device manager)
ASYNC_POOL_BYTES = 2 << 30
#: phase 19.5's large results
ASYNC_QUERIES = ("W2", "W7")
#: the corpus scale and query of phase 19.4's fresh processes
WARMUP_CHILD_SF, WARMUP_CHILD_QUERY = 1.0, "q1"


def minmax_groupby(session, orders):
    """q8's MIN/MAX group-by over ``orders`` (phases 6 and 19.2)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.plan import from_host_table
    return from_host_table(orders, session).group_by("o_custkey").agg(
        F.min("o_orderkey").alias("min_key"),
        F.max("o_orderkey").alias("max_key"),
        F.min("o_totalprice").alias("min_price"),
        F.max("o_totalprice").alias("max_price"))


def kernel_ranges(trace_path) -> dict:
    """{range name: CUDA kernel names launched inside it} from a chrome
    trace of the engine's profiler: each kernel event is matched to its
    launch call by correlation id, and the launch to the host
    ``user_annotation`` ranges (``op_range``) that enclose it on its
    thread."""
    with open(trace_path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("ph") == "X" and e.get("cat") in (
                    "cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = collections.defaultdict(set)
    for k in events:
        if k.get("ph") != "X" or k.get("cat") != "kernel":
            continue
        launch = launches.get(k.get("args", {}).get("correlation"))
        if launch is None:
            continue
        for r in ranges:
            if r.get("tid") == launch.get("tid") and \
                    r["ts"] <= launch["ts"] <= r["ts"] + r["dur"]:
                out[r["name"]].add(k["name"])
    return out


def obs_profiler(q1_keep, base: str, card: str) -> dict:
    """19.1: q1 three times warm through a session whose profiler takes
    query 1 only; one trace directory, ``query_1``, whose kernels of the
    partial sums, the compaction and the sort sit under their launch
    ranges inside the engine's operator ranges; then the median device
    busy time of three more engine traces within 0.2 ms of the median of
    three ``--profile`` reads (``profile_run``) of warm q1, in turns."""
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    from spark_rapids_tpu_torch.session import TorchSession
    table = q1_keep["tables"][0]
    for attempt in range(2):
        prefix = os.path.join(base, f"profile{attempt}")
        s = TorchSession({"spark.rapids.profile.enabled": "true",
                          "spark.rapids.profile.pathPrefix": prefix,
                          "spark.rapids.profile.queryRanges": "1"})
        for _ in range(3):
            got = q1_dataframe(s, table).collect_table()
            torch.cuda.synchronize()
            q1_keep["check"](got)
        dirs = sorted(os.listdir(prefix))
        if dirs != ["query_1"]:
            fail(f"19.1: the profiler wrote {dirs}, want ['query_1']")
        trace = os.path.join(prefix, "query_1", "trace.json")
        times = trace_times(trace)
        if times is not None:
            break
        note = os.path.join(prefix, "query_1", "NO_DEVICE_EVENTS.txt")
        log(f"  19.1: query_1's trace holds no device event; the profiler "
            f"said so ({os.path.exists(note) and note}); profiling again")
    else:
        fail("19.1: two engine traces of q1 without device events")
    busy, span, families = times
    ranges = kernel_ranges(trace)
    for wrapper, family in Q1_TRACE_KERNELS.items():
        names = ranges.get(wrapper, set())
        if not any(any(k in n for k in KERNEL_FAMILIES[family])
                   for n in names):
            fail(f"19.1: no {family} kernel under the {wrapper} range "
                 f"(ranges: { {k: sorted(v) for k, v in ranges.items()} })")
    exec_ranges = sorted(r for r in ranges if r.startswith("Tpu"))
    if not exec_ranges:
        fail("19.1: no engine operator range encloses a kernel launch")
    log(f"  19.1 the engine's trace of q1 (query_1 of 3): device busy "
        f"{busy:.3f} ms over {span:.3f} ms; kernels by range: "
        + json.dumps({k: sorted(v) for k, v in sorted(ranges.items())})
        + f" [{card}]")
    # a warm run's device busy time moves by up to 0.3 ms from run to run
    # (an H100 80GB HBM3 at 700 W): medians of three traces a side, in
    # turns
    prefix = os.path.join(base, "profile_median")
    s3 = TorchSession({"spark.rapids.profile.enabled": "true",
                       "spark.rapids.profile.pathPrefix": prefix,
                       "spark.rapids.profile.queryRanges": "0,2,4"})
    s0 = TorchSession()
    engine, reader = [], []
    for i in range(3):
        for _ in range(2):
            q1_dataframe(s3, table).collect_table()
        t = trace_times(os.path.join(prefix, f"query_{2 * i}", "trace.json"))
        if t is None:
            fail(f"19.1: engine trace query_{2 * i} holds no device event")
        engine.append(t[0])
        reader.append(profile_run(
            "q1 (--profile's reader)",
            lambda: q1_dataframe(s0, table).collect_table(),
            os.path.join(base, f"profile_run{i}"))["busy_ms"])
    diff = abs(statistics.median(engine) - statistics.median(reader))
    log(f"  19.1 device busy of warm q1: the engine's traces "
        f"{[round(b, 3) for b in engine]} ms, --profile's reader "
        f"{reader} ms; the medians differ by {diff:.3f} ms")
    if diff > 0.2:
        fail(f"19.1: the engine traces' median busy time differs from "
             f"--profile's by {diff:.3f} ms (> 0.2)")
    return {"busy_ms": round(busy, 3), "span_ms": round(span, 3),
            "engine_busy_ms": [round(b, 3) for b in engine],
            "profile_busy_ms": reader}


def obs_builders(session, tables, sparse_q3_tables) -> dict:
    """Phase 19.2's queries as builders over ``session``."""
    from spark_rapids_tpu_torch.models.corpus import build_queries
    from spark_rapids_tpu_torch.models.tpch import q3_dataframe
    q = build_queries(session, tables)
    out = {name: q[name] for name in OBS_QUERIES if name.startswith("q")
           and name in q}
    out["q3 sparse"] = lambda: q3_dataframe(session, *sparse_q3_tables)
    out["min/max group-by"] = lambda: minmax_groupby(session,
                                                     tables["orders"])
    return out


def obs_eventlog(tables, dsl, base: str, card: str) -> tuple:
    """19.2: each query once with the event log and the span tracer on
    (one record each, schema 11, each result against its oracle; the
    root's numOutputRows the result's rows; ``dispatches`` the launch
    counters' delta; every launch held against its plain version; host
    syncs at most one over the same warm run with both off, which may
    not exceed phase 14's baseline); then
    ``tools profile`` over the log and ``tools compare`` of it against a
    second pass. Returns (the log's directory, launches summed)."""
    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.session import TorchSession
    logdir = os.path.join(base, "eventlog")
    conf = {"spark.rapids.sql.eventLog.enabled": "true",
            "spark.rapids.sql.eventLog.dir": logdir,
            "spark.rapids.trace.enabled": "true",
            "spark.rapids.trace.dir": os.path.join(base, "trace")}
    ev, off = TorchSession(conf), TorchSession()
    sparse = dsl["q3 sparse"]["tables"]
    on_b = obs_builders(ev, tables, sparse)
    off_b = obs_builders(off, tables, sparse)
    missing = [n for n in OBS_QUERIES if n not in on_b or n not in dsl]
    if missing:
        fail(f"19.2: no builder or oracle for {missing}")
    total, rows = {}, {}
    for name in OBS_QUERIES:
        off_b[name]().collect_table()  # warm, unrecorded
        with host_sync_count() as box_off:
            want = off_b[name]().collect_table()
        torch.cuda.synchronize()
        dsl[name]["check"](want)
        K.reset_launch_counts()
        K.calls = []
        ev.next_query_tag = name
        with host_sync_count() as box:
            got = on_b[name]().collect_table()
        torch.cuda.synchronize()
        launches = K.launch_counts()
        calls, K.calls = K.calls, None
        hold_launches(f"19.2 {name}", calls)
        del calls
        # against the oracle (an f64 sum by atomics varies its last bits
        # from run to run: ROADMAP Queue 3 item 1)
        dsl[name]["check"](got)
        rec = json.loads(json.dumps(ev.last_event_record))
        root_rows = rec["plan"]["metrics"]["numOutputRows"]["value"]
        if rec["schema"] != 11 or rec["queryTag"] != name:
            fail(f"19.2 {name}: record schema {rec['schema']}, tag "
                 f"{rec['queryTag']}")
        if root_rows != got.num_rows:
            fail(f"19.2 {name}: the root's numOutputRows {root_rows}, the "
                 f"result has {got.num_rows} rows")
        if rec["dispatches"] != sum(launches.values()):
            fail(f"19.2 {name}: dispatches {rec['dispatches']}, launch "
                 f"counters {launches}")
        base_syncs = BASELINE_WARM_SYNCS.get(name)
        if box["syncs"] > box_off["syncs"] + 1:
            fail(f"19.2 {name}: {box['syncs']} host syncs with the event "
                 f"log on, {box_off['syncs']} off")
        if base_syncs is not None and box_off["syncs"] > base_syncs:
            fail(f"19.2 {name}: {box_off['syncs']} host syncs with the log "
                 f"off, more than the baseline's {base_syncs}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        rows[name] = {"rows": got.num_rows, "syncs_on": box["syncs"],
                      "syncs_off": box_off["syncs"],
                      "syncs_baseline": base_syncs,
                      "dispatches": rec["dispatches"],
                      "wall_ms": round(rec["wallS"] * 1e3, 3),
                      "phases_ms": {k: round(v * 1e3, 3)
                                    for k, v in rec["phasesS"].items()},
                      "cache_hit": rec["executableCacheHit"]}
    from spark_rapids_tpu_torch.tools.report import load_events
    records = load_events(logdir)
    if len(records) != len(OBS_QUERIES):
        fail(f"19.2: {len(records)} records in the log, want "
             f"{len(OBS_QUERIES)}")
    log("  19.2 per query (rows, host syncs with the log on/off/baseline, "
        "dispatches, wall and phases in ms, cache hit): "
        + json.dumps(rows) + f" [{card}]")
    for k in ("probe_rowids", "fused_minmax", "onehot_partials",
              "gather_compact", "sort_with_payload"):
        if not total.get(k):
            fail(f"19.2 launched no {k}")
    # a second pass for tools compare
    logdir2 = os.path.join(base, "eventlog2")
    ev2 = TorchSession(dict(conf, **{
        "spark.rapids.sql.eventLog.dir": logdir2}))
    for name, build in obs_builders(ev2, tables, sparse).items():
        ev2.next_query_tag = name
        build().collect_table()
    for cmd in (["profile", logdir, "--top", "8"],
                ["compare", logdir, logdir2, "--top", "3"]):
        out = subprocess.run([sys.executable, "-m", "spark_rapids_tpu_torch."
                              "tools", *cmd], capture_output=True,
                             text=True, timeout=120)
        if out.returncode not in (0, 2):
            fail(f"19.2 tools {cmd[0]} exited {out.returncode}: "
                 f"{out.stderr[-2000:]}")
        lines = out.stdout.splitlines()
        log(f"  19.2 tools {cmd[0]} (exit {out.returncode}; 2: a query's "
            f"span coverage under 0.95), its first {min(len(lines), 40)} "
            f"of {len(lines)} lines:")
        for line in lines[:40]:
            log("    " + line)
    return logdir, total


def cache_counts(before: dict) -> dict:
    from spark_rapids_tpu_torch.dispatch import COMPILE_SCOPE
    keys = ("executableCacheHits", "executableCacheMisses",
            "executableCacheTemplateHits", "executableCacheInvalidations",
            "executableCacheEvictions")
    return {k.replace("executableCache", ""): COMPILE_SCOPE.get(k, 0)
            - before.get(k, 0) for k in keys}


def obs_cache(q1_keep, dsl, base: str, card: str) -> dict:
    """19.3: q1, dense and sparse q3 and Q3_SQL five times warm with the
    executable cache on and off: hits and misses as expected, results bit
    for bit (q3's f64 revenue within rtol 1e-9), launches equal; the host
    planning time (``planS``) with and without a hit. Then a literal variant of q1 (a template hit) and a
    WriteFiles run between two runs of q1 over a Parquet source (an
    invalidation)."""
    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.dispatch import COMPILE_SCOPE
    from spark_rapids_tpu_torch.models.tpch import (
        Q1_SQL,
        Q3_SQL,
        q1_dataframe,
        q3_dataframe,
    )
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.plan.executable_cache import EXEC_CACHE
    from spark_rapids_tpu_torch.session import TorchSession
    on = TorchSession()
    off = TorchSession({"spark.rapids.sql.executableCache.enabled": "false"})
    q1t = q1_keep["tables"][0]
    dense, sparse = dsl["q3 dense"]["tables"], dsl["q3 sparse"]["tables"]
    for s in (on, off):
        for name, t in zip(("customer", "orders", "lineitem"), dense):
            from_host_table(t, s).create_or_replace_temp_view(name)
    #: q3's revenue is an f64 sum by atomics, whose last bits vary from
    #: run to run (ROADMAP Queue 3 item 1): rtol 1e-9 there, else bitwise
    rtol = {"q1": 0.0, "q3 dense": 1e-9, "q3 sparse": 1e-9, "Q3_SQL": 1e-9}
    cases = {
        "q1": lambda s: q1_dataframe(s, q1t),
        "q3 dense": lambda s: q3_dataframe(s, *dense),
        "q3 sparse": lambda s: q3_dataframe(s, *sparse),
        "Q3_SQL": lambda s: s.sql(Q3_SQL.format(segment="BUILDING")),
    }
    summary = {}
    for name, build in cases.items():
        per = {}
        results = {}
        # settle the speculation blocklist first (a cold sparse q3
        # replays), uncached
        build(off).collect_table()
        EXEC_CACHE.clear()
        for label, s in (("on", on), ("off", off)):
            before = dict(COMPILE_SCOPE)
            plan_s, launches, outs = [], [], []
            for _ in range(5):
                K.reset_launch_counts()
                outs.append(build(s).collect_table())
                torch.cuda.synchronize()
                launches.append(K.launch_counts())
                plan_s.append(s._last_phases["planS"])
            counts = cache_counts(before)
            want = {"Hits": 4, "Misses": 1} if label == "on" else \
                {"Hits": 0, "Misses": 0}
            if any(counts[k] != v for k, v in want.items()):
                fail(f"19.3 {name} cache {label}: counts {counts}, want "
                     f"{want}")
            if any(x != launches[0] for x in launches):
                fail(f"19.3 {name} cache {label}: launches vary {launches}")
            for o in outs[1:]:
                same_table(o, outs[0], f"19.3 {name} cache {label}",
                           rtol[name])
            results[label] = (outs[0], launches[0])
            per[label] = {"counts": counts, "planS_ms": [
                round(p * 1e3, 3) for p in plan_s]}
        same_table(results["on"][0], results["off"][0],
                   f"19.3 {name}, cache on against off", rtol[name])
        if results["on"][1] != results["off"][1]:
            fail(f"19.3 {name}: launches {results['on'][1]} with the cache, "
                 f"{results['off'][1]} without")
        summary[name] = per
        log(f"  19.3 {name}: {json.dumps(per)} (the first run's planS "
            f"converts; with the cache on the others check out) [{card}]")
    # a literal variant of q1: a template hit
    for s in (on,):
        from_host_table(q1t, s).create_or_replace_temp_view("lineitem")
    first = Q1_SQL.index("DATE '")
    variant = Q1_SQL[:first] + "DATE '1998-08-01'" + Q1_SQL[first + 17:]
    on.sql(Q1_SQL).collect_table()
    before = dict(COMPILE_SCOPE)
    on.sql(variant).collect_table()
    counts = cache_counts(before)
    log(f"  19.3 a literal variant of Q1_SQL: {counts}")
    if counts["TemplateHits"] != 1 or counts["Hits"] != 0:
        fail(f"19.3: the literal variant counted {counts}, want one "
             "template hit")
    # a write between two runs of q1 over a Parquet source: an
    # invalidation
    src = os.path.join(base, "q1_parquet")
    sample = q1t.slice(0, min(q1t.num_rows, 1 << 20))
    from_host_table(sample, on).write_parquet(src)
    before = dict(COMPILE_SCOPE)
    for _ in range(2):
        q1_dataframe(on, on.read_parquet(src)).collect_table()
    from_host_table(sample, on).write_parquet(os.path.join(base, "other"))
    q1_dataframe(on, on.read_parquet(src)).collect_table()
    counts = cache_counts(before)
    log(f"  19.3 q1 over Parquet, run, run, a WriteFiles run elsewhere, "
        f"run: {counts}")
    if counts["Invalidations"] != 1 or counts["Hits"] != 1:
        fail(f"19.3: a write between runs counted {counts}, want one "
             "invalidation after one hit")
    summary["invalidation"] = counts
    return summary


WARMUP_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from spark_rapids_tpu_torch.models.corpus import build_queries, corpus_tables
from spark_rapids_tpu_torch.session import TorchSession
mode, logdir, sf, name = sys.argv[2:6]
sf = float(sf)
tables = corpus_tables(sf, 7)
s = TorchSession()
out = {"mode": mode}
if mode == "warm":
    from spark_rapids_tpu_torch.tools.warmup import run_warmup
    t0 = time.perf_counter()
    rep = run_warmup(logdir, sf=sf, seed=7, tables=tables, session=s)
    out["warmup_s"] = round(time.perf_counter() - t0, 3)
    out["report"] = {k: rep[k] for k in (
        "eventRecords", "distinctUnits", "unmatchedRecords",
        "programsCompiled", "programsSkipped", "failures", "newTraces",
        "compileSTotal")}
    out["statuses"] = {q["query"]: q["status"] for q in rep["queries"]}
t0 = time.perf_counter()
got = build_queries(s, tables)[name]().collect_table()
torch.cuda.synchronize()
out.update(query_ms=round((time.perf_counter() - t0) * 1e3, 2),
           rows=got.num_rows, compile_ms=s.last_compile_ms,
           cache_hit=s.last_executable_cache_hit)
print(json.dumps(out))
"""


def obs_warmup(logdir: str, card: str) -> dict:
    """19.4: two fresh processes, each building its kernels into a fresh
    directory: the first runs ``tools warmup`` over 19.2's log, then one
    corpus query; the second runs the same query cold, unwarmed. Both
    times printed; no claim is made of them."""
    out = {}
    for mode in ("warm", "cold"):
        env = dict(os.environ, SRT_KERNEL_BUILD_DIR=tempfile.mkdtemp(
            prefix=f"warmup_{mode}_build_"))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", WARMUP_CHILD,
             os.path.dirname(os.path.abspath(__file__)), mode, logdir,
             str(WARMUP_CHILD_SF), WARMUP_CHILD_QUERY],
            capture_output=True, text=True, timeout=300, env=env)
        if res.returncode != 0:
            fail(f"19.4 the {mode} child failed: {res.stderr[-3000:]}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        got["process_s"] = round(time.perf_counter() - t0, 3)
        out[mode] = got
        log(f"  19.4 {mode} child: " + json.dumps(got) + f" [{card}]")
    if out["warm"]["report"]["failures"]:
        fail(f"19.4: the warmup failed to replay "
             f"{out['warm']['report']['failures']} plans")
    if out["warm"]["rows"] != out["cold"]["rows"]:
        fail("19.4: the warmed and the cold query disagree on rows")
    log(f"  19.4 {WARMUP_CHILD_QUERY} at sf {WARMUP_CHILD_SF}: "
        f"{out['warm']['query_ms']} ms after the warmup (compiled "
        f"{out['warm']['report']['programsCompiled']}, warm "
        f"{out['warm']['report']['programsSkipped']}), "
        f"{out['cold']['query_ms']} ms cold without it")
    return out


def obs_async(tables, card: str) -> dict:
    """19.5: W2 and W7 with the asynchronous result fetch on and off (one
    pinned pool for both sessions): bit-identical results, the fetch's
    wait, both warm times and the synchronous fallbacks."""
    from spark_rapids_tpu_torch.obs.metrics import scopes_snapshot
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.session import TorchSession
    pool = {"spark.rapids.memory.pinnedPool.size": str(ASYNC_POOL_BYTES)}
    sessions = {"on": TorchSession(pool), "off": TorchSession(dict(
        pool, **{"spark.rapids.sql.asyncResultFetch": "false"}))}
    for s in sessions.values():
        for name in ("lineitem", "orders"):
            from_host_table(tables[name], s).create_or_replace_temp_view(
                name)
    summary = {}
    for q in ASYNC_QUERIES:
        res = {}
        for label, s in sessions.items():
            s.sql(WINDOW_SQL[q]).collect_table()  # cold
            warm, fetch, sync0 = [], [], scopes_snapshot().get(
                "memory", {}).get("asyncFetchSynchronous", 0)
            for _ in range(3):
                t0 = time.perf_counter()
                got = s.sql(WINDOW_SQL[q]).collect_table()
                torch.cuda.synchronize()
                warm.append(time.perf_counter() - t0)
                m = s.last_metrics()
                fetch.append(s.last_timings().get("resultFetchTime", 0.0))
            syncs = scopes_snapshot().get("memory", {}).get(
                "asyncFetchSynchronous", 0) - sync0
            res[label] = got
            summary[f"{q} {label}"] = {
                "warm_ms": round(statistics.median(warm) * 1e3, 2),
                "result_fetch_ms": [round(f * 1e3, 3) for f in fetch],
                "async_batches": m.get("asyncFetchBatches", 0),
                "synchronous_fallbacks": syncs, "rows": got.num_rows}
        same_host_table(res["on"], res["off"],
                        f"19.5 {q}, async fetch on against off")
        if q == "W2" and not summary[f"{q} on"]["async_batches"]:
            fail("19.5: W2 never took the asynchronous fetch")
    log("  19.5 async result fetch: " + json.dumps(summary) + f" [{card}]")
    return summary


def obs_faults(q1_keep, card: str) -> dict:
    """19.6: ``device.lost:device_lost:1`` on q1 walks the device-loss
    recovery (``deviceReinits`` 1) and the next q1 answers right;
    ``dispatch.kernel:crash:1`` replays once and answers right."""
    from spark_rapids_tpu_torch.errors import DeviceLostError
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    from spark_rapids_tpu_torch.runtime.faults import CIRCUIT_BREAKER, FAULTS
    from spark_rapids_tpu_torch.runtime.health import HEALTH
    from spark_rapids_tpu_torch.session import TorchSession
    table = q1_keep["tables"][0]
    out = {}
    before = HEALTH.snapshot()
    s = TorchSession({"spark.rapids.test.faults":
                      "device.lost:device_lost:1"})
    t0 = time.perf_counter()
    try:
        q1_dataframe(s, table).collect_table()
        fail("19.6: device.lost:device_lost:1 did not raise")
    except DeviceLostError as exc:
        out["device_lost_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
        out["device_lost_op"] = getattr(exc, "fault_op", None)
    after = HEALTH.snapshot()
    reinits = after["deviceReinits"] - before["deviceReinits"]
    if reinits != 1 or after["latched"]:
        fail(f"19.6: the device loss gave {reinits} reinits, latched "
             f"{after['latched']}")
    FAULTS.disarm()
    s0 = TorchSession()
    t0 = time.perf_counter()
    got = q1_dataframe(s0, table).collect_table()
    torch.cuda.synchronize()
    out["next_q1_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
    q1_keep["check"](got)
    s = TorchSession({"spark.rapids.test.faults": "dispatch.kernel:crash:1"})
    t0 = time.perf_counter()
    got = q1_dataframe(s, table).collect_table()
    torch.cuda.synchronize()
    out["crash_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
    q1_keep["check"](got)
    out["crash_replays"] = s.last_metrics()["runtimeFaultReplays"]
    FAULTS.disarm()
    CIRCUIT_BREAKER.reset()
    if out["crash_replays"] != 1:
        fail(f"19.6: dispatch.kernel:crash:1 replayed "
             f"{out['crash_replays']} times, want 1")
    log("  19.6 fault points: " + json.dumps(out) + f" [{card}]")
    return out


def run_observability(tables, dsl, q1_keep) -> dict:
    """Phase 19: the profiler (19.1), the event log and the span tracer
    with the tools (19.2), the executable cache (19.3), warmup in fresh
    processes (19.4), the asynchronous result fetch (19.5) and the
    launch helper's fault points (19.6). Returns the kernels' launches in
    19.2's recorded runs."""
    t_start = time.perf_counter()
    card = card_line()
    base = tempfile.mkdtemp(prefix="obs_phase_")
    steps = {}
    steps["19.1"] = obs_profiler(q1_keep, base, card)
    logdir, launches = obs_eventlog(tables, dsl, base, card)
    steps["19.3"] = obs_cache(q1_keep, dsl, base, card)
    steps["19.4"] = obs_warmup(logdir, card)
    steps["19.5"] = obs_async(tables, card)
    steps["19.6"] = obs_faults(q1_keep, card)
    took = time.perf_counter() - t_start
    log(f"  phase 19 summary ({took:.1f} s): " + json.dumps(
        {k: v for k, v in steps.items() if k != "19.4"}, default=str))
    if took > OBS_BUDGET_S:
        fail(f"phase 19 took {took:.1f} s, over its {OBS_BUDGET_S} s budget")
    return launches


# ---------------------------------------------------------------------------
# phase 20: nested types

#: the seconds phase 20 should take (logged past it)
NESTED_BUDGET_S = 120.0


class _Groups:
    """A numpy oracle's view of lineitem grouped by l_orderkey: a stable
    sort by key (np.lexsort), the distinct keys, each group's start and
    size, and each row's group, all flat buffers."""

    def __init__(self, keys: np.ndarray):
        self.order = np.lexsort((np.arange(len(keys)), keys))
        sk = keys[self.order]
        self.keys, self.starts, self.sizes = np.unique(
            sk, return_index=True, return_counts=True)
        self.offsets = np.zeros(len(self.keys) + 1, dtype=np.int64)
        self.offsets[1:] = np.cumsum(self.sizes)
        self.rid = np.repeat(np.arange(len(self.keys)), self.sizes)

    def sorted_within(self, keys: np.ndarray, values: np.ndarray):
        """``values`` sorted by (key, value), stably: each group's values
        in ascending order."""
        return values[np.lexsort((values, keys))]


def n1_oracle(li) -> dict:
    """N1's expected columns on flat buffers: each group's values in input
    order (lists), its distinct sorted values (sets) and the linear
    interpolated median of its prices."""
    c = {n: col.data for n, col in zip(li.names, li.columns)}
    keys = c["l_orderkey"]
    g = _Groups(keys)
    q = c["l_quantity"][g.order]
    qs = g.sorted_within(keys, c["l_quantity"])
    first = np.ones(len(qs), dtype=bool)
    first[1:] = (qs[1:] != qs[:-1]) | (g.rid[1:] != g.rid[:-1])
    set_counts = np.bincount(g.rid[first], minlength=len(g.keys))
    set_off = np.zeros(len(g.keys) + 1, dtype=np.int64)
    set_off[1:] = np.cumsum(set_counts)
    ps = g.sorted_within(keys, c["l_extendedprice"])
    k = (g.sizes - 1).astype(np.float64) * 0.5
    lo, hi = np.floor(k).astype(np.int64), np.ceil(k).astype(np.int64)
    vlo, vhi = ps[g.offsets[:-1] + lo], ps[g.offsets[:-1] + hi]
    med = vlo + (vhi - vlo) * (k - lo)
    return {"groups": g, "keys": g.keys, "offsets": g.offsets,
            "q": q, "sd": c["l_shipdate"][g.order],
            "pl": c["l_extendedprice"][g.order], "set_off": set_off,
            "qs": qs[first], "med": med}


def _flat_of(col):
    """(int64 offsets, data, validity) of a host array column."""
    a = col.data
    return a.offsets.astype(np.int64), a.data, a.validity


def check_array(col, offsets, data, what: str) -> None:
    """A host array column equal to the oracle's (offsets, data): every
    row valid, every element valid, the elements bit for bit."""
    off, d, v = _flat_of(col)
    if not col.validity.all():
        fail(f"{what}: a null row")
    if off.shape != offsets.shape or not np.array_equal(off, offsets):
        fail(f"{what}: the row offsets differ from the oracle's")
    if not v.all():
        fail(f"{what}: a null element")
    want = np.ascontiguousarray(data).astype(d.dtype)
    if d.tobytes() != want.tobytes():
        fail(f"{what}: the elements differ from the oracle's (bit for bit)")


def check_n1(got, want) -> None:
    names = list(got.names)
    if names != ["l_orderkey", "q", "qs", "sd", "pl", "med"]:
        fail(f"N1: columns {names}")
    cols = dict(zip(names, got.columns))
    keys = cols["l_orderkey"].data
    order = np.argsort(keys, kind="stable")
    if not np.array_equal(keys[order], want["keys"]):
        fail("N1: the group keys differ from the oracle's")
    for name in ("q", "qs", "sd", "pl"):
        c = cols[name]
        if not np.array_equal(order, np.arange(len(order))):
            c = type(c)(c.dtype, c.data.take(order), c.validity[order])
        off = want["set_off"] if name == "qs" else want["offsets"]
        check_array(c, off, want[name], f"N1 {name}")
    med = cols["med"].data[order]
    if not cols["med"].validity.all() or not np.allclose(
            med, want["med"], rtol=1e-12, atol=0.0):
        fail("N1: the percentile differs from the oracle's (rtol 1e-12)")


def n1_builders(session, li_df, view: str):
    """N1 in the DSL and in SQL over ``view``."""
    from spark_rapids_tpu_torch import functions as F

    def dsl():
        return li_df().group_by("l_orderkey").agg(
            F.collect_list("l_quantity").alias("q"),
            F.collect_set("l_quantity").alias("qs"),
            F.collect_list("l_shipdate").alias("sd"),
            F.collect_list("l_extendedprice").alias("pl"),
            F.percentile("l_extendedprice", 0.5).alias("med"))

    text = ("SELECT l_orderkey, collect_list(l_quantity) AS q, "
            "collect_set(l_quantity) AS qs, collect_list(l_shipdate) AS sd, "
            "collect_list(l_extendedprice) AS pl, "
            "percentile(l_extendedprice, 0.5) AS med "
            f"FROM {view} GROUP BY l_orderkey")
    return {"N1 collect (DSL)": dsl,
            "N1 collect (SQL)": lambda: session.sql(text)}


def n2_build(n1_df):
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.ops.expr import col, lit

    def build():
        m = F.create_map(col("l_orderkey"), col("med"))
        return n1_df().select(
            "l_orderkey", F.size("q").alias("n"),
            F.array_contains("q", 25).alias("c25"),
            F.sort_array("q", False).alias("qd"),
            F.element_at(F.sort_array("q", False), 0).alias("qmax"),
            F.array_min("pl").alias("pmin"), F.array_max("pl").alias("pmax"),
            F.transform("q", lambda x: x * lit(2) + col("l_orderkey"))
            .alias("t"),
            F.filter("q", lambda x: x > lit(25)).alias("f"),
            F.exists("q", lambda x: x > lit(45)).alias("ex"),
            F.forall("q", lambda x: x > lit(1)).alias("fa"),
            F.named_struct("k", col("l_orderkey"), "m", col("med"))
            .getField("m").alias("sm"),
            F.element_at(m, col("l_orderkey")).alias("mv"),
            F.map_keys(m).alias("mk"), F.map_values(m).alias("mvs"),
            F.transform_values(m, lambda k, v: v * lit(2.0)).alias("tv"),
            F.map_filter(m, lambda k, v: v > lit(50000.0)).alias("mf"))
    return build


def n2_check(want):
    g = want["groups"]
    off, q, pl, med, keys = (want["offsets"], want["q"], want["pl"],
                             want["med"], want["keys"])
    nrows = len(keys)
    rid = g.rid
    qd = q[np.lexsort((-q, rid))]
    big = q > 25
    f_off = np.zeros(nrows + 1, dtype=np.int64)
    f_off[1:] = np.cumsum(np.bincount(rid[big], minlength=nrows))
    one = np.arange(nrows + 1, dtype=np.int64)
    keep = med > 50000.0
    mf_off = np.zeros(nrows + 1, dtype=np.int64)
    mf_off[1:] = np.cumsum(keep)

    def check(got):
        cols = dict(zip(got.names, got.columns))
        if not np.array_equal(cols["l_orderkey"].data, keys):
            fail("N2: rows out of N1's order")
        sizes = np.diff(off)

        def flat(name, want_v, what):
            c = cols[name]
            if not c.validity.all() or not np.array_equal(c.data, want_v):
                fail(f"N2 {what}: differs from the oracle")

        flat("n", sizes.astype(np.int32), "size")
        flat("c25", np.bincount(rid[q == 25], minlength=nrows) > 0,
             "array_contains(q, 25)")
        check_array(cols["qd"], off, qd, "N2 sort_array(q, false)")
        flat("qmax", np.maximum.reduceat(q, off[:-1]), "element_at")
        flat("pmin", np.minimum.reduceat(pl, off[:-1]), "array_min")
        flat("pmax", np.maximum.reduceat(pl, off[:-1]), "array_max")
        check_array(cols["t"], off, q * 2 + keys[rid], "N2 transform")
        check_array(cols["f"], f_off, q[big], "N2 filter")
        flat("ex", np.bincount(rid[q > 45], minlength=nrows) > 0, "exists")
        flat("fa", np.bincount(rid[q <= 1], minlength=nrows) == 0, "forall")
        flat("sm", med, "named_struct getField")
        flat("mv", med, "element_at(create_map)")
        check_array(cols["mk"], one, keys, "N2 map_keys")
        check_array(cols["mvs"], one, med, "N2 map_values")
        tv = cols["tv"].data
        if not (np.array_equal(tv.offsets, one) and np.array_equal(
                tv.kdata, keys) and np.array_equal(tv.vdata, med * 2.0)
                and tv.vvalid.all()):
            fail("N2 transform_values: differs from the oracle")
        mf = cols["mf"].data
        if not (np.array_equal(mf.offsets, mf_off) and np.array_equal(
                mf.kdata, keys[keep]) and np.array_equal(mf.vdata,
                                                          med[keep])):
            fail("N2 map_filter: differs from the oracle")
    return check


def n3_cases(session, n1_df, view: str, want):
    """N3's queries and checks: posexplode with l_orderkey passing
    through (10M rows), an aggregate by position, explode_outer of the
    filtered lists with its null rows, sequence, and the SQL form."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.ops.expr import col, lit
    g = want["groups"]
    off, q, keys = want["offsets"], want["q"], want["keys"]
    rid = g.rid
    pos = (np.arange(len(q)) - off[rid]).astype(np.int32)
    nrows = len(keys)

    def posexplode():
        return n1_df().select("l_orderkey",
                              F.posexplode("q").alias("x"))

    def check_pe(got):
        c = dict(zip(got.names, got.columns))
        if got.num_rows != len(q) or not (
                np.array_equal(c["l_orderkey"].data, keys[rid])
                and np.array_equal(c["pos"].data, pos)
                and np.array_equal(c["x"].data, q)):
            fail("N3 posexplode: differs from the oracle")

    def by_pos():
        return posexplode().group_by("pos").agg(
            F.sum("x").alias("s"), F.count().alias("n")).sort("pos")

    s_want = np.bincount(pos, weights=q).astype(np.int64)
    n_want = np.bincount(pos)

    def check_by_pos(got):
        c = [x.data for x in got.columns]
        if not (np.array_equal(c[0], np.arange(len(n_want)))
                and np.array_equal(c[1], s_want)
                and np.array_equal(c[2], n_want)):
            fail("N3 aggregate by position: differs from the oracle")

    big = q > 45
    has = np.bincount(rid[big], minlength=nrows) > 0
    o_keys = np.concatenate([keys[rid[big]], keys[~has]])
    o_vals = q[big]

    def outer():
        return n1_df().select("l_orderkey", F.explode_outer(
            F.filter("q", lambda x: x > lit(45))).alias("x"))

    def check_outer(got):
        c = dict(zip(got.names, got.columns))
        k = int(big.sum())
        xv = c["x"].validity
        if not (np.array_equal(c["l_orderkey"].data, o_keys)
                and xv[:k].all() and not xv[k:].any()
                and np.array_equal(c["x"].data[:k], o_vals)):
            fail("N3 explode_outer: differs from the oracle")

    sizes = np.diff(off)
    seq_vals = (np.arange(len(q)) - off[rid] + 1).astype(np.int64)

    def seq():
        return n1_df().select("l_orderkey", F.explode(F.sequence(
            lit(1), F.size("q"))).alias("i"))

    def check_seq(got):
        c = dict(zip(got.names, got.columns))
        if not (np.array_equal(c["l_orderkey"].data,
                               np.repeat(keys, sizes))
                and np.array_equal(c["i"].data, seq_vals)):
            fail("N3 sequence: differs from the oracle")

    text = f"SELECT l_orderkey, explode(q) AS x FROM {view}"

    def check_sql(got):
        c = dict(zip(got.names, got.columns))
        if not (np.array_equal(c["l_orderkey"].data, keys[rid])
                and np.array_equal(c["x"].data, q)):
            fail("N3 explode (SQL): differs from the oracle")

    return {"N3 posexplode": (posexplode, check_pe),
            "N3 aggregate by position": (by_pos, check_by_pos),
            "N3 explode_outer of filter": (outer, check_outer),
            "N3 sequence": (seq, check_seq),
            "N3 explode (SQL)": (lambda: session.sql(text), check_sql)}


def same_nested_table(got, want, what) -> None:
    """Two host tables equal bit for bit, nested columns buffer by
    buffer."""
    if list(got.names) != list(want.names) or got.num_rows != want.num_rows:
        fail(f"{what}: {list(got.names)} x {got.num_rows}, want "
             f"{list(want.names)} x {want.num_rows}")
    for name, g, w in zip(got.names, got.columns, want.columns):
        if g.dtype != w.dtype or not np.array_equal(g.validity, w.validity):
            fail(f"{what} {name}: type or validity differs")
        gl = g.data.leaves() if hasattr(g.data, "leaves") else (g.data,)
        wl = w.data.leaves() if hasattr(w.data, "leaves") else (w.data,)
        for a, b in zip(gl, wl):
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                fail(f"{what} {name}: buffers differ (bit for bit)")


def n4_files(n1_host, base: str, card: str) -> tuple:
    """20.4: N1's result with a struct and a map column written by the
    port's writer (SNAPPY, two files), read back in the three reader
    modes and held against the device result bit for bit. Returns (the
    directory, numbers)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.io.parquet import ParquetScanNode
    from spark_rapids_tpu_torch.models.corpus import write_corpus_files
    from spark_rapids_tpu_torch.ops.expr import col
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.session import TorchSession
    s = TorchSession()
    full = from_host_table(n1_host, s).select(
        "l_orderkey", "q", "qs", "sd", "pl", "med",
        F.named_struct("k", col("l_orderkey"), "m", col("med")).alias("st"),
        F.create_map(col("l_orderkey"), col("med")).alias("mp"))
    t0 = time.perf_counter()
    device_result = full.collect_table()
    select_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths = write_corpus_files({"n1": device_result}, base, 2,
                               compression="snappy")
    write_s = time.perf_counter() - t0
    on_disk = dir_bytes(paths["n1"])
    decode = {}
    for mode in ("PERFILE", "COALESCING", "MULTITHREADED"):
        scan = ParquetScanNode([paths["n1"]], RapidsConf(), reader_type=mode)
        t0 = time.perf_counter()
        got = scan.collect_host()
        decode[mode] = time.perf_counter() - t0
        same_nested_table(got, device_result, f"N4 read back ({mode})")
    host_mb = got.nbytes() / 1e6
    best = min(decode.values())
    numbers = {"rows": device_result.num_rows, "bytes_on_disk": on_disk,
               "select_s": round(select_s, 3), "write_s": round(write_s, 3),
               "write_mb_per_s": round(host_mb / write_s, 1),
               "decode_s": {m: round(v, 3) for m, v in decode.items()},
               "decoded_mb_per_s": round(host_mb / best, 1),
               "host_mb": round(host_mb, 1)}
    log(f"  20.4 N1 + struct + map: {device_result.num_rows} rows, "
        f"{on_disk} B on disk (two files, SNAPPY), write {write_s:.3f} s "
        f"({numbers['write_mb_per_s']} MB/s), decode (host) "
        f"{', '.join(f'{m} {v:.3f} s' for m, v in decode.items())}, "
        f"{numbers['decoded_mb_per_s']} MB/s decoded ({host_mb:.1f} MB); "
        f"read back bit for bit in all three modes [{card}]")
    return paths["n1"], numbers


def run_nested(tables, profile_dir) -> dict:
    """Phase 20: N1 (collect_list, collect_set, percentile by
    l_orderkey over lineitem, DSL and SQL), N2 (the array, struct and map
    functions and the higher-order functions over N1's result), N3
    (posexplode, an aggregate by position, explode_outer, sequence, the
    SQL explode) and N4 (N1's result in Parquet, read back and queried),
    each through ``run_case`` against a numpy oracle on flat buffers.
    Returns every kernel's launches over the counted runs."""
    import shutil

    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.runtime.memory import MEMORY
    from spark_rapids_tpu_torch.session import TorchSession
    t_phase = time.perf_counter()
    card = card_line()
    li = tables["lineitem"]
    keep = ("l_orderkey", "l_quantity", "l_extendedprice", "l_shipdate")
    li = type(li)(list(keep), [li.columns[li.names.index(n)] for n in keep])
    t0 = time.perf_counter()
    want = n1_oracle(li)
    log(f"  20.0 lineitem {li.num_rows} rows, {len(want['keys'])} orders "
        f"with lines; the numpy oracle (lexsort, unique) in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    s = TorchSession()
    from_host_table(li, s).create_or_replace_temp_view("nested_li")
    totals, stats = {}, {}

    def case(name, build, check, profile=False, keep=None):
        res = run_case(s, name, build, check,
                       profile_dir if profile else None, keep)
        for k, v in res["launches"].items():
            totals[k] = totals.get(k, 0) + v
        # the ledger's peak over the counted run (the session resets it
        # at each query's start)
        res["stats"]["peak_accounted_mb"] = round(MEMORY.peak_bytes() / 1e6,
                                                  1)
        stats[name] = res["stats"]
        log(f"  {name}: peak accounted bytes "
            f"{res['stats']['peak_accounted_mb']} MB")
        return res

    n1_host = None
    for name, build in n1_builders(
            s, lambda: from_host_table(li, s), "nested_li").items():
        keep_res = {}
        case(name, build, lambda got: check_n1(got, want), "DSL" in name,
             keep_res)
        if n1_host is None:
            n1_host = keep_res[name]["result"]
        log(f"  {name}: {n1_host.num_rows} arrays over "
            f"{int(want['offsets'][-1])} elements each; lists exact, sets "
            "by their sorted values, the percentile rtol 1e-12")
    from_host_table(n1_host, s).create_or_replace_temp_view("nested_n1")

    def n1_df():
        return from_host_table(n1_host, s)

    case("N2 array, struct and map functions", n2_build(n1_df),
         n2_check(want))
    for name, (build, check) in n3_cases(s, n1_df, "nested_n1",
                                         want).items():
        case(name, build, check, profile=name == "N3 posexplode")
    base = tempfile.mkdtemp(prefix="srt-nested-")
    try:
        path, numbers = n4_files(n1_host, base, card)
        pe_build, pe_check = n3_cases(s, n1_df, "nested_n1",
                                      want)["N3 posexplode"]
        from spark_rapids_tpu_torch import functions as F
        res = case("N4 posexplode from Parquet", lambda: s.read_parquet(
            path).select("l_orderkey", F.posexplode("q").alias("x")),
            pe_check)
        numbers["warm_ms"] = res["stats"]["warm_ms"]
        numbers["in_memory_warm_ms"] = stats["N3 posexplode"]["warm_ms"]
        log(f"  20.4 N3's posexplode from the files: warm "
            f"{numbers['warm_ms']} ms against {numbers['in_memory_warm_ms']}"
            f" ms over N1's result in memory [{card}]")
        stats["N4 files"] = numbers
    finally:
        shutil.rmtree(base, ignore_errors=True)
    took = time.perf_counter() - t_phase
    summary = {"card": card, "seconds": round(took, 1),
               "launches": {k: v for k, v in totals.items() if v},
               "cases": stats}
    if took > NESTED_BUDGET_S:
        log(f"  phase 20 took {took:.1f} s, past its "
            f"{NESTED_BUDGET_S:.0f} s budget")
    for k in ("gather_compact", "sort_with_payload", "fused_minmax"):
        if not totals.get(k):
            fail(f"phase 20 launched no {k}")
    log("  phase-20 summary: " + json.dumps(summary, default=str))
    return totals


# ---------------------------------------------------------------------------
# phase 21: the CPU route
# ---------------------------------------------------------------------------

#: the seconds phase 21 should take (logged past it)
ROUTE_BUDGET_S = 90.0

#: rows of each cell's driving table (PERF.md section 4 lists the cuts):
#: C1 groups the whole sf-10 lineitem; C2 casts every order's date; C3's
#: row-wise UDF reads every order; C5's to_json and C6's whole-plan CPU
#: route would pass the phase's budget at full size, so they take a prefix
C5_ORDERS = 100_000
C6_LINEITEM = 500_000

#: TPC-H's order priorities (C1 and C3 group by them)
PRIORITIES = np.array(["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                       "5-LOW"], dtype=object)

#: C3's row-wise UDF reads this dict, which the UDF compiler rejects (a
#: free variable)
PRIORITY_RANK = {"1-URGENT": 1, "2-HIGH": 2, "3-MEDIUM": 3}

#: the plan-node classes the CPU route ran in each converted tree while
#: ``"expected"`` is set (phase 21); outside it any is a failure
CPU_ROUTE = {"expected": False, "converted": 0}


#: the plan verifier over every converted tree of the run (the hook
#: ``watch_cpu_route`` installs): trees verified, the verifier's host ms
#: (the service's workers convert concurrently: VERIFY_LOCK)
VERIFY = {"trees": 0, "ms": 0.0}
VERIFY_LOCK = threading.Lock()


def watch_cpu_route() -> None:
    """Count the CPU-route nodes of every converted tree of the run (the
    overrides' ``collect_cpu_nodes``): phases 3-20 must convert with 0.
    Each tree is also verified as ``spark.rapids.sql.planVerify.mode=
    error`` would verify it (lint/plan_verifier.py, its host time in
    ``VERIFY``): one diagnostic fails the run."""
    from spark_rapids_tpu_torch.lint.plan_verifier import verify_converted
    from spark_rapids_tpu_torch.obs.events import collect_fallbacks
    from spark_rapids_tpu_torch.overrides import rules
    convert_meta = rules.convert_meta

    def counted(meta, device):
        root = convert_meta(meta, device)
        CPU_ROUTE["converted"] += 1
        nodes = rules.collect_cpu_nodes(root)
        if nodes and not CPU_ROUTE["expected"]:
            fail(f"a query converted with CPU-route nodes {nodes}: "
                 f"{collect_fallbacks(meta)}")
        t0 = time.perf_counter()
        diags = verify_converted(root, meta, meta.conf)
        with VERIFY_LOCK:
            VERIFY["ms"] += (time.perf_counter() - t0) * 1e3
            VERIFY["trees"] += 1
        if diags:
            fail(f"the plan verifier found {len(diags)} diagnostic(s) in "
                 f"a converted tree: {'; '.join(map(str, diags[:8]))}")
        return root

    rules.convert_meta = counted


def route_tables(tables, seed: int) -> dict:
    """Phases 6-8's tables with the columns the cells read beyond the
    corpus's: lineitem's l_partkey (C1) and l_tax (C4, TPC-H's 0.00-0.08),
    orders' o_orderpriority (C1, C3), each from its own seed stream."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    li, orders = tables["lineitem"], tables["orders"]
    rng = np.random.default_rng([seed, 21])
    n, m = li.num_rows, orders.num_rows
    partkey = rng.integers(1, 200 * max(n // 6000, 1) + 1, n,
                           dtype=np.int64)
    tax = rng.integers(0, 9, n).astype(np.float64) / 100.0
    pri = PRIORITIES[rng.integers(0, len(PRIORITIES), m)]
    return {
        "lineitem": HostTable(list(li.names) + ["l_partkey", "l_tax"],
                              list(li.columns) + [
                                  HostColumn(T.LONG, partkey),
                                  HostColumn(T.DOUBLE, tax)]),
        "orders": HostTable(list(orders.names) + ["o_orderpriority"],
                            list(orders.columns) + [
                                HostColumn(T.STRING, pri)])}


def _cols(t, *names):
    return [t.columns[t.names.index(n)].data for n in names]


def _take(t, names, rows=None):
    """``t`` narrowed to ``names`` (and its first ``rows`` rows)."""
    cols = [t.columns[t.names.index(n)] for n in names]
    if rows is not None:
        cols = [c.slice(0, min(rows, len(c))) for c in cols]
    return type(t)(list(names), cols)


def _result(got, *names):
    return [got.columns[got.names.index(n)] for n in names]


def c1_oracle(li, orders):
    """C1: per order with >= 5 lines, its line count and largest part key,
    joined to its priority, then by priority: sum of counts, max part key,
    orders."""
    keys, parts = _cols(li, "l_orderkey", "l_partkey")
    order = np.argsort(keys, kind="stable")
    sk, sp = keys[order], parts[order]
    uk, starts, counts = np.unique(sk, return_index=True, return_counts=True)
    mx = np.maximum.reduceat(sp, starts)
    keep = counts >= 5
    ok, pri = _cols(orders, "o_orderkey", "o_orderpriority")
    pos = np.searchsorted(ok, uk[keep])
    if not np.array_equal(ok[pos], uk[keep]):
        fail("C1 oracle: a lineitem order is not in orders")
    prios = pri[pos]
    out = {}
    for p in PRIORITIES:
        sel = prios == p
        if sel.any():
            out[p] = (int(counts[keep][sel].sum()), int(mx[keep][sel].max()),
                      int(sel.sum()))
    return out, int(len(uk)), int(keys.shape[0])


def c1_build(s, li, orders):
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.ops.expr import col, lit
    from spark_rapids_tpu_torch.plan import from_host_table

    def build():
        arrays = from_host_table(li, s).group_by("l_orderkey").agg(
            F.collect_list("l_partkey").alias("parts"))
        many = arrays.filter(F.size("parts") >= lit(5))
        per = many.select(col("l_orderkey"), F.size("parts").alias("n"),
                          F.array_max("parts").alias("mx"))
        o = from_host_table(orders, s).select(
            col("o_orderkey").alias("l_orderkey"), col("o_orderpriority"))
        return per.join(o, on="l_orderkey", how="inner").group_by(
            "o_orderpriority").agg(F.sum("n").alias("lines"),
                                   F.max("mx").alias("mx"),
                                   F.count().alias("orders"))
    return build


def c1_check(want):
    def check(got):
        p, lines, mx, n = _result(got, "o_orderpriority", "lines", "mx",
                                  "orders")
        have = {p.data[i]: (int(lines.data[i]), int(mx.data[i]),
                            int(n.data[i])) for i in range(got.num_rows)}
        if have != want:
            fail(f"C1: {have} differs from the oracle's {want}")
    return check


def c2_oracle(orders):
    days, price = _cols(orders, "o_orderdate", "o_totalprice")
    ud, inv = np.unique(days, return_inverse=True)
    return {"ds": np.datetime_as_string(ud.astype("datetime64[D]")),
            "c": np.bincount(inv).astype(np.int64),
            "tp": np.bincount(inv, weights=price)}


def c2_build(s, orders):
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.ops.expr import col
    from spark_rapids_tpu_torch.plan import from_host_table

    def build():
        return from_host_table(orders, s).select(
            col("o_orderdate").cast("string").alias("ds"),
            col("o_totalprice")).group_by("ds").agg(
            F.count().alias("c"), F.sum("o_totalprice").alias("tp")).sort(
            "ds")
    return build


def c2_check(want):
    def check(got):
        ds, c, tp = _result(got, "ds", "c", "tp")
        if list(ds.data) != list(want["ds"]):
            fail("C2: the date strings or their order differ from numpy's")
        if not np.array_equal(c.data, want["c"]):
            fail("C2: the counts differ")
        if not np.allclose(tp.data, want["tp"], rtol=1e-9, atol=0.0):
            fail("C2: the price sums differ (rtol 1e-9)")
    return check


def c3_oracle(li, orders):
    lk, q = _cols(li, "l_orderkey", "l_quantity")
    ok, pri = _cols(orders, "o_orderkey", "o_orderpriority")
    rank = np.array([PRIORITY_RANK.get(p, 0) for p in PRIORITIES])
    pr = rank[np.searchsorted(PRIORITIES, pri)]
    pos = np.clip(np.searchsorted(ok, lk), 0, len(ok) - 1)
    hit = ok[pos] == lk
    prl = pr[pos[hit]]
    return {int(r): (int(q[hit][prl == r].sum()), int((prl == r).sum()))
            for r in np.unique(prl)}


def c3_build(s, li, orders, fn):
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.ops.expr import col
    from spark_rapids_tpu_torch.plan import from_host_table
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rank = F.udf(fn, T.INT)

    def build():
        o = from_host_table(orders, s).select(
            col("o_orderkey").alias("l_orderkey"),
            rank(col("o_orderpriority")).alias("pr"))
        return from_host_table(li, s).join(o, on="l_orderkey").group_by(
            "pr").agg(F.sum("l_quantity").alias("q"),
                      F.count().alias("c"))
    return build


def c3_check(want):
    def check(got):
        pr, q, c = _result(got, "pr", "q", "c")
        have = {int(pr.data[i]): (int(q.data[i]), int(c.data[i]))
                for i in range(got.num_rows)}
        if have != want:
            fail(f"C3: {have} differs from the oracle's {want}")
    return check


def q1_udf_dataframe(session, table):
    """models/tpch.py's q1 with its charge through a compiled UDF."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.models.tpch import Q1_CUTOFF_DAYS
    from spark_rapids_tpu_torch.ops.expr import col, lit
    from spark_rapids_tpu_torch.plan import from_host_table
    charge = F.udf(lambda p, d, t: p * (1.0 - d) * (1.0 + t))
    if not charge.compiled:
        fail("C4: the charge UDF did not compile")
    return (from_host_table(table, session)
            .filter(col("l_shipdate") <= lit(Q1_CUTOFF_DAYS, T.DATE))
            .select(col("l_returnflag"), col("l_linestatus"),
                    col("l_quantity"), col("l_extendedprice"),
                    col("l_discount"),
                    (col("l_extendedprice") * (lit(1.0) - col("l_discount")))
                    .alias("disc_price"),
                    charge(col("l_extendedprice"), col("l_discount"),
                           col("l_tax")).alias("charge"))
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.sum(F.col("l_quantity")).alias("sum_qty"),
                 F.sum(F.col("l_extendedprice")).alias("sum_base_price"),
                 F.sum(F.col("disc_price")).alias("sum_disc_price"),
                 F.sum(F.col("charge")).alias("sum_charge"),
                 F.avg(F.col("l_quantity")).alias("avg_qty"),
                 F.avg(F.col("l_extendedprice")).alias("avg_price"),
                 F.avg(F.col("l_discount")).alias("avg_disc"),
                 F.count().alias("count_order"))
            .sort("l_returnflag", "l_linestatus"))


#: C5's struct of orders' columns read back by from_json (the date as the
#: day number to_json writes)
def c5_schema():
    from spark_rapids_tpu_torch import types as T
    return T.StructType([T.StructField("o_orderkey", T.LONG),
                         T.StructField("o_totalprice", T.DOUBLE),
                         T.StructField("o_orderdate", T.LONG)])


def c5_build(s, orders):
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.ops.expr import col
    from spark_rapids_tpu_torch.plan import from_host_table

    def build():
        js = from_host_table(orders, s).select(
            col("o_orderkey"), F.to_json(F.struct(
                col("o_orderkey"), col("o_totalprice"),
                col("o_orderdate"))).alias("js"))
        parsed = js.select(
            col("o_orderkey"),
            F.get_json_object(col("js"), "$.o_totalprice").alias("tp_s"),
            F.from_json(col("js"), c5_schema()).alias("st"))
        return parsed.select(
            col("o_orderkey"), col("tp_s"),
            col("st").getField("o_orderkey").alias("k2"),
            col("st").getField("o_totalprice").alias("tp"),
            col("st").getField("o_orderdate").alias("d"))
    return build


def c5_check(orders):
    ok, price, days = _cols(orders, "o_orderkey", "o_totalprice",
                            "o_orderdate")

    def render(f):
        return json.dumps(int(f)) if float(f).is_integer() else json.dumps(
            float(f))
    want_s = np.array([render(f) for f in price], dtype=object)

    def check(got):
        k, tp_s, k2, tp, d = _result(got, "o_orderkey", "tp_s", "k2", "tp",
                                     "d")
        order = np.argsort(k.data, kind="stable")
        if not np.array_equal(k.data[order], ok):
            fail("C5: the order keys differ")
        for name, c, want in (("k2", k2, ok), ("tp", tp, price),
                              ("d", d, days.astype(np.int64))):
            if not c.validity.all() or \
                    c.data[order].tobytes() != want.tobytes():
                fail(f"C5: the round trip's {name} differs from the column "
                     "it came from (bit for bit)")
        if list(tp_s.data[order]) != list(want_s):
            fail("C5: get_json_object's strings differ")
    return check


def route_case(s, name, build, check, expect_nodes, results,
               warm_runs: int = 3) -> dict:
    """``run_case`` of one cell, then its converted tree's CPU-route nodes
    (they must be ``expect_nodes``), the overrides' reasons, the
    transitions' times and the warm host syncs."""
    from spark_rapids_tpu_torch.obs.events import collect_fallbacks
    from spark_rapids_tpu_torch.overrides.rules import collect_cpu_nodes
    res = run_case(s, name, build, check, None, warm_runs=warm_runs)
    nodes = collect_cpu_nodes(s._last_root)
    reasons = collect_fallbacks(s.last_meta)
    timings = s.last_timings()
    if sorted(nodes) != sorted(expect_nodes):
        fail(f"{name}: CPU-route nodes {nodes}, expected {expect_nodes}")
    if s.conf.sql_enabled and len(reasons) != len(nodes):
        fail(f"{name}: {len(nodes)} CPU-route nodes but {len(reasons)} "
             "reported fallbacks")
    stats = dict(res["stats"], cpu_nodes=nodes,
                 reasons=[f"{r['op']}: {'; '.join(r['reasons'])}"
                          for r in reasons],
                 h2d_ms=round(timings.get("h2dTime", 0.0) * 1e3, 2),
                 d2h_ms=round(timings.get("d2hTime", 0.0) * 1e3, 2),
                 launches={k: v for k, v in res["launches"].items() if v})
    log(f"  {name}: CPU-route nodes {nodes}; reasons {stats['reasons']}; "
        f"h2dTime {stats['h2d_ms']} ms, d2hTime {stats['d2h_ms']} ms "
        f"(counted run)")
    results[name] = stats
    return res


def run_route(tables, q1_table, q3_sparse, seed: int) -> dict:
    """Phase 21: C1-C6 over phases 6-8's tables (plus the columns
    ``route_tables`` adds) and phase 4-5's q1 and sparse q3 tables, each
    through ``route_case`` against its numpy oracle (C4 bit for bit
    against the hand-written q1, C6 against the device's results).
    Returns every kernel's launches over the counted runs."""
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe, q3_dataframe
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.udf import UdfCompileError
    t_phase = time.perf_counter()
    card = card_line()
    t0 = time.perf_counter()
    rt = route_tables(tables, seed)
    li, orders = rt["lineitem"], rt["orders"]
    log(f"  21.0 {li.num_rows} lineitem rows, {orders.num_rows} orders; "
        f"l_partkey, l_tax and o_orderpriority added in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    s = TorchSession()
    totals, results = {}, {}
    CPU_ROUTE["expected"] = True

    def add(res):
        for k, v in res["launches"].items():
            totals[k] = totals.get(k, 0) + v
        return res

    try:
        li1 = _take(li, ("l_orderkey", "l_partkey"))
        o1 = _take(orders, ("o_orderkey", "o_orderpriority"))
        want1, n_orders, n_lines = c1_oracle(li1, o1)
        log(f"  C1: collect_list over {n_lines} lines gives {n_orders} "
            "arrays")
        add(route_case(s, "C1 arrays into a flat-only filter",
                       c1_build(s, li1, o1), c1_check(want1), ["Filter"],
                       results))

        o2 = _take(orders, ("o_orderdate", "o_totalprice"))
        # the host-bound cells (C2, C3, C5) run one warm run each (their
        # cold and counted runs too, every result checked): seconds a run
        add(route_case(s, "C2 cast(date as string) as a grouping key",
                       c2_build(s, o2), c2_check(c2_oracle(o2)),
                       ["Project"], results, warm_runs=1))

        def rank_of(p):
            return PRIORITY_RANK.get(p, 0)

        from spark_rapids_tpu_torch import functions as F
        from spark_rapids_tpu_torch.ops.expr import col
        try:
            F.udf(rank_of)(col("o_orderpriority"))
            fail("C3: a dict lookup compiled")
        except UdfCompileError as exc:
            log(f"  C3: the UDF compiler rejects the dict lookup ({exc})")
        o3 = _take(orders, ("o_orderkey", "o_orderpriority"))
        li3 = _take(li, ("l_orderkey", "l_quantity"))
        add(route_case(s, "C3 a row-wise Python UDF",
                       c3_build(s, li3, o3, rank_of),
                       c3_check(c3_oracle(li3, o3)), ["Project"], results,
                       warm_runs=1))

        li4 = _take(li, ("l_returnflag", "l_linestatus", "l_quantity",
                         "l_extendedprice", "l_discount", "l_tax",
                         "l_shipdate"))
        keep4 = {}
        hand = run_case(s, "C4 q1 written by hand",
                        lambda: q1_dataframe(s, li4), lambda got: None, None,
                        keep4)
        want4 = keep4["C4 q1 written by hand"]["result"]

        def c4_check(got):
            same_table(got, want4, "C4", 0.0)
            for a, b in zip(got.columns, want4.columns):
                if a.data.tobytes() != b.data.tobytes():
                    fail("C4: the UDF's q1 differs from q1 (bit for bit)")
        udf4 = add(route_case(s, "C4 q1 with a compiled UDF",
                              lambda: q1_udf_dataframe(s, li4), c4_check,
                              [], results))
        if udf4["launches"] != hand["launches"]:
            fail(f"C4: launches {udf4['launches']}, q1's "
                 f"{hand['launches']}")
        results["C4 q1 with a compiled UDF"]["q1_warm_ms"] = \
            hand["stats"]["warm_ms"]

        o5 = _take(orders, ("o_orderkey", "o_totalprice", "o_orderdate"),
                   C5_ORDERS)
        add(route_case(s, "C5 to_json, then get_json_object and from_json",
                       c5_build(s, o5), c5_check(o5), ["Project"], results,
                       warm_runs=1))

        cpu = TorchSession({"spark.rapids.sql.enabled": "false"})
        t6 = _take(q1_table, q1_table.names, C6_LINEITEM)
        cust, ords, lines = q3_sparse
        q3t = (cust, ords, _take(lines, lines.names, C6_LINEITEM))
        for name, build in (
                ("q1", lambda sess: q1_dataframe(sess, t6)),
                ("sparse q3", lambda sess: q3_dataframe(sess, *q3t))):
            dev_keep = {}
            run_case(s, f"C6 {name} on the device", lambda: build(s),
                     lambda got: None, None, dev_keep)
            want6 = dev_keep[f"C6 {name} on the device"]["result"]
            add(route_case(
                cpu, f"C6 {name} with spark.rapids.sql.enabled=false",
                lambda: build(cpu),
                lambda got: same_table(got, want6, f"C6 {name}", 1e-9),
                plan_nodes(build(cpu).plan),
                results))
            results[f"C6 {name} with spark.rapids.sql.enabled=false"][
                "device_warm_ms"] = dev_keep[
                f"C6 {name} on the device"]["warm_ms"]
    finally:
        CPU_ROUTE["expected"] = False
    took = time.perf_counter() - t_phase
    summary = {"card": card, "seconds": round(took, 1),
               "launches": {k: v for k, v in totals.items() if v},
               "cases": results}
    if took > ROUTE_BUDGET_S:
        log(f"  phase 21 took {took:.1f} s, past its "
            f"{ROUTE_BUDGET_S:.0f} s budget")
    log("  phase-21 summary: " + json.dumps(summary, default=str))
    return totals


# ---------------------------------------------------------------------------
# phase 22: demotion onto the CPU route at run time, and the rest of planning
# ---------------------------------------------------------------------------

#: the phase's budget (PERF.md section 4: about 50 s on the card)
PLANNING_BUDGET_S = 90.0
#: warm runs of each cell after its cold run (run_case adds the counted one)
PLANNING_WARM_RUNS = 4
#: P1's two range exchanges over ``lineitem4`` in ``W8_BATCHES`` batches:
#: (name, keys, partitions)
P1_FORMS = (("P1 range (l_shipdate, l_orderkey)",
             ("l_shipdate", "l_orderkey"), 16),
            ("P1 range (l_returnflag, l_orderkey)",
             ("l_returnflag", "l_orderkey"), 8))
#: the corpus queries whose build is an aggregate: AQE decides at run time
AQE_QUERIES = ("q10", "q17", "q22")
#: P2's wide threshold: every corpus aggregate build at sf 10 lands under it
AQE_WIDE_THRESHOLD = 1 << 30
#: rows of P4's small filter (under the cost-based optimizer's break-even)
CBO_SMALL_ROWS = 50
#: the latch child's output, when phase 18's 18.4 ran it (P3 (c) logs it)
FATAL_RESULTS = {}


def _walk_execs(root):
    """Every exec and host plan node of a converted tree (through the
    transitions)."""
    out, stack = [], [root]
    while stack:
        e = stack.pop()
        out.append(e)
        stack.extend(getattr(e, "children", ()))
        for attr in ("cpu_node", "source", "tpu_exec"):
            if getattr(e, attr, None) is not None:
                stack.append(getattr(e, attr))
    return out


def p1_plan(session, scan, keys, nparts, local: bool):
    """``scan`` (``lineitem4`` in ``W8_BATCHES`` batches, made once, so a
    warm run finds its uploads in the scan cache) through
    Exchange(range, ``nparts``, keys) and Sort(global_sort=False) on the
    same keys (``local``), or through the global sort alone."""
    from spark_rapids_tpu_torch.ops.expr import col
    from spark_rapids_tpu_torch.plan import nodes as P
    from spark_rapids_tpu_torch.plan.dataframe import DataFrame
    orders = [P.SortOrder(col(k)) for k in keys]
    if local:
        ex = P.Exchange(scan, "range", nparts, [col(k) for k in keys])
        return DataFrame(P.Sort(ex, orders, global_sort=False), session)
    return DataFrame(P.Sort(scan, orders), session)


def p1_order(li4, keys):
    """The row numbers of ``lineitem4`` in a stable sort by ``keys``
    (numpy; a string key by its sorted dictionary's codes)."""
    cols = {n: c for n, c in zip(li4.names, li4.columns)}
    operands = [np.arange(li4.num_rows)]
    for k in reversed(keys):
        c = cols[k]
        operands.append(c.encoded()[0] if c.data.dtype == object else c.data)
    return cols["l_row"].data[np.lexsort(operands)]


def p1_check(li4, order, name):
    """Each run's output rows in the numpy stable sort's order (by the row
    numbers); with ``full`` every column the row number selects too."""
    cols = {n: c for n, c in zip(li4.names, li4.columns)}

    def check(got, full=False):
        g = {n: c for n, c in zip(got.names, got.columns)}
        if got.num_rows != li4.num_rows or \
                not np.array_equal(g["l_row"].data, order):
            fail(f"{name}: the rows are not in the numpy lexsort's order")
        for n in li4.names if full else ():
            want = cols[n].data[order]
            ok = (np.array_equal(g[n].data, want) if want.dtype == object
                  else g[n].data.tobytes() == want.tobytes())
            if not ok or not g[n].validity.all():
                fail(f"{name}: column {n} differs from the numpy lexsort's")
    return check


def p1_partition_ids(li4, keys, nparts, got):
    """Each output row's partition under the bounds the exchange drew
    (the same sample of the same rows in the same order)."""
    from spark_rapids_tpu_torch.columnar.table import upload_host_table
    from spark_rapids_tpu_torch.ops.expr import col
    from spark_rapids_tpu_torch.shuffle.partitioning import RangePartitioner
    schema = li4.schema()
    parter = RangePartitioner([col(k).bind(schema) for k in keys], nparts)
    parter.compute_bounds(upload_host_table(li4, DEV))
    pids = parter.partition_ids(upload_host_table(got, DEV))
    return pids[:got.num_rows].cpu().numpy()


def run_p1(tables, totals, results) -> None:
    """P1: the range exchange and the local sort (two key forms), each
    against the global sort and the numpy lexsort; partition ids never
    decrease along the output."""
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.session import TorchSession
    li4 = lineitem4(tables)
    s = TorchSession()
    scan = from_host_table(li4, s, num_batches=W8_BATCHES).plan
    for name, keys, nparts in P1_FORMS:
        whole = p1_plan(s, scan, keys, nparts, local=False).collect_table()
        check = p1_check(li4, p1_order(li4, keys), name)
        check(whole, full=True)
        keep = {}
        res = run_case(s, name, lambda k=keys, n=nparts: p1_plan(
            s, scan, k, n, local=True), check, None, keep,
            warm_runs=PLANNING_WARM_RUNS)
        got = keep[name]["result"]
        check(got, full=True)
        same_table(got, whole, f"{name} against the global sort", 0.0)
        pids = p1_partition_ids(li4, keys, nparts, got)
        if np.any(np.diff(pids) < 0):
            fail(f"{name}: a partition id decreases along the sorted rows")
        counts = np.bincount(pids, minlength=nparts).tolist()
        m = s.last_metrics()
        if m.get("localSplitParts") != nparts:
            fail(f"{name}: localSplitParts {m.get('localSplitParts')}")
        add_launches(totals, res["launches"])
        results[name] = dict(res["stats"], partition_rows=counts, launches={
            k: v for k, v in res["launches"].items() if v})
        log(f"  {name}: equals the global sort and the numpy lexsort; "
            f"partition ids never decrease; rows per partition {counts}")


def add_launches(totals, launches) -> None:
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v


def aqe_build(session):
    """The adaptive build of the session's last executed tree (or None)."""
    from spark_rapids_tpu_torch.execs.broadcast import TpuAdaptiveBuildExec
    builds = [e for e in _walk_execs(session._last_root)
              if isinstance(e, TpuAdaptiveBuildExec)]
    return builds[0] if builds else None


def run_p2(tables, checks, totals, results) -> None:
    """P2: q10, q17 and q22 as DSL and SQL under the default threshold,
    q10 and q17 again under ``AQE_WIDE_THRESHOLD`` (->broadcast), and q17
    under half its measured build (->shuffle); each against phase 7's
    oracle (``checks``), its decision against its measured bytes, its warm
    host syncs beside phase 7's."""
    from spark_rapids_tpu_torch.conf import BROADCAST_SIZE_BYTES
    from spark_rapids_tpu_torch.models.corpus import (
        build_queries,
        build_sql_queries,
        sql_texts,
    )
    from spark_rapids_tpu_torch.session import TorchSession
    texts = sql_texts()
    measured = {}

    def cell(s, name, build, want=None):
        res = run_case(s, name, build, checks[name.split()[1]], None,
                       warm_runs=PLANNING_WARM_RUNS)
        ab = aqe_build(s)
        if ab is None:
            fail(f"{name}: no TpuAdaptiveBuildExec in the tree")
        threshold = s.conf.get_entry(BROADCAST_SIZE_BYTES)
        nbytes = ab.metrics.get("aqeMeasuredBuildBytes")
        converted = ab.metrics.get("aqeBroadcastConverted", 0)
        if nbytes is None or converted != int(nbytes <= threshold) or \
                ab.converted is not bool(converted):
            fail(f"{name}: {ab.describe()}, measured {nbytes} B against "
                 f"{threshold} B, aqeBroadcastConverted {converted}")
        if want is not None and ab.describe() != want:
            fail(f"{name}: {ab.describe()}, want {want}")
        add_launches(totals, res["launches"])
        base = name.split()[1] + (" SQL" if name.endswith("SQL") else "")
        results[name] = dict(res["stats"], build=ab.describe(),
                             aqeMeasuredBuildBytes=nbytes,
                             aqeBroadcastConverted=converted,
                             threshold=threshold,
                             phase7_syncs=WARM_SYNCS.get(base),
                             launches={k: v for k, v in
                                       res["launches"].items() if v})
        log(f"  {name}: {ab.describe()} (aqeMeasuredBuildBytes {nbytes} B, "
            f"threshold {threshold} B, aqeBroadcastConverted {converted}); "
            f"warm host syncs {res['stats']['syncs']} (phase 7's "
            f"{WARM_SYNCS.get(base, 'not measured')})")
        measured[name] = nbytes

    s = TorchSession()
    queries = build_queries(s, tables)
    build_sql_queries(s, tables)
    for q in AQE_QUERIES:
        cell(s, f"P2 {q}", queries[q],
             "TpuAdaptiveBuild[->broadcast]" if q == "q22" else None)
        cell(s, f"P2 {q} SQL", lambda t=texts[q]: s.sql(t),
             "TpuAdaptiveBuild[->broadcast]" if q == "q22" else None)
    wide = TorchSession({"spark.rapids.sql.broadcastSizeBytes":
                         str(AQE_WIDE_THRESHOLD)})
    wq = build_queries(wide, tables)
    for q in ("q10", "q17"):
        cell(wide, f"P2 {q} at broadcastSizeBytes={AQE_WIDE_THRESHOLD}",
             wq[q], "TpuAdaptiveBuild[->broadcast]")
    half = measured[f"P2 q17 at broadcastSizeBytes={AQE_WIDE_THRESHOLD}"] \
        // 2
    narrow = TorchSession({"spark.rapids.sql.broadcastSizeBytes":
                           str(half)})
    cell(narrow, f"P2 q17 at broadcastSizeBytes={half}",
         build_queries(narrow, tables)["q17"], "TpuAdaptiveBuild[->shuffle]")


def run_p3(q1_keep, totals, results) -> None:
    """P3: the three rungs on q1 over phase 4's table: (a) the breaker's
    demotion of the aggregate, (b) the memory ladder's ``cpu_demote``,
    (c) the CPU-only latch in the fatal-error child."""
    from spark_rapids_tpu_torch.conf import RUNTIME_FALLBACK_MAX_FAILURES
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    from spark_rapids_tpu_torch.obs.events import collect_fallbacks
    from spark_rapids_tpu_torch.overrides.rules import collect_cpu_nodes
    from spark_rapids_tpu_torch.runtime.faults import CIRCUIT_BREAKER, FAULTS
    from spark_rapids_tpu_torch.runtime.health import HEALTH
    from spark_rapids_tpu_torch.session import TorchSession
    table, check = q1_keep["tables"][0], q1_keep["check"]
    faults = "spark.rapids.test.faults"

    def rung(name, conf, want_nodes, want_metrics):
        CIRCUIT_BREAKER.reset()
        fresh_device()
        s = TorchSession(conf)
        t0 = time.perf_counter()
        got = q1_dataframe(s, table).collect_table()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        check(got)
        m = s.last_metrics()
        nodes = collect_cpu_nodes(s._last_root)
        fallbacks = collect_fallbacks(s.last_meta)
        demoted = CIRCUIT_BREAKER.demoted_ops()
        explain = s.explain(q1_dataframe(s, table))
        bad = {k: m.get(k, 0) for k, v in want_metrics.items()
               if m.get(k, 0) != v}
        if nodes != want_nodes or bad or sorted(demoted) != want_nodes or \
                any(f["reasons"] != [demoted[f["op"]]] for f in fallbacks) \
                or not all(r in explain for r in demoted.values()):
            fail(f"{name}: CPU-route nodes {nodes}, metrics off {bad}, "
                 f"demoted {demoted}, fallbacks {fallbacks}")
        FAULTS.disarm()
        warm = TorchSession()
        res = route_case(warm, f"{name}, warm", lambda: q1_dataframe(
            warm, table), check, want_nodes, results,
            warm_runs=PLANNING_WARM_RUNS)
        add_launches(totals, res["launches"])
        results[f"{name}, warm"].update(
            cold_ms=round(cold * 1e3, 2), demoted=demoted,
            metrics={k: m.get(k, 0) for k in (
                "runtimeFaultReplays", "query_replays", "demotions",
                "memoryPressure", "memoryChunkedReexecutions",
                "memoryCpuDemotions")})
        log(f"  {name}: answered q1 (cold {cold * 1e3:.1f} ms) with "
            f"{nodes} on the CPU route: {list(demoted.values())}")
        CIRCUIT_BREAKER.reset()
        again = TorchSession()
        check(q1_dataframe(again, table).collect_table())
        if collect_cpu_nodes(again._last_root):
            fail(f"{name}: after the breaker's reset q1 still has CPU-route "
                 f"nodes {collect_cpu_nodes(again._last_root)}")

    CPU_ROUTE["expected"] = True
    try:
        max_failures = TorchSession().conf.get_entry(
            RUNTIME_FALLBACK_MAX_FAILURES)
        rung("P3 (a) the breaker",
             {faults: f"exec.execute@Aggregate:crash:{max_failures}"},
             ["Aggregate"], {"runtimeFaultReplays": max_failures,
                             "demotions": 1})
        rung("P3 (b) the ladder's cpu_demote",
             {faults: "mem.reserve:oom:9"}, ["LocalScan"],
             {"memoryPressure": 3, "memoryChunkedReexecutions": 1,
              "memoryCpuDemotions": 1, "demotions": 1})
    finally:
        CPU_ROUTE["expected"] = False
        FAULTS.disarm()
        CIRCUIT_BREAKER.reset()
    if HEALTH.cpu_only_reason() is not None:
        fail("P3: the process latched CPU-only mode")
    if not FATAL_RESULTS:
        base = tempfile.mkdtemp(prefix="srt-latch-")
        FATAL_RESULTS.update(run_fatal_children(base, card_line()))
    latch = FATAL_RESULTS["latch"]
    results["P3 (c) the latch"] = latch
    log(f"  P3 (c) the latch child: second {latch.get('second')!r}; third "
        f"{latch.get('third')} in {latch.get('third_ms')} ms, fourth "
        f"{latch.get('fourth')} in {latch.get('fourth_ms')} ms on the CPU "
        f"route ({latch.get('third_cpu_nodes')}); cpuOnlyReason "
        f"{latch.get('cpuOnlyReason')!r}")


def run_p4(q1_keep, totals, results) -> None:
    """P4: under ``spark.rapids.sql.optimizer.enabled`` a small filter
    reverts to the CPU route with a reason naming CBO, and q1 stays on the
    device (its aggregate's row count is unknown)."""
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    from spark_rapids_tpu_torch.obs.events import collect_fallbacks
    from spark_rapids_tpu_torch.ops.expr import col, lit
    from spark_rapids_tpu_torch.overrides.rules import collect_cpu_nodes
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.session import TorchSession
    table = q1_keep["tables"][0]
    small = table.slice(0, CBO_SMALL_ROWS)
    qty = small.columns[list(small.names).index("l_quantity")]
    want = int((qty.data > 25.0).sum())
    s = TorchSession({"spark.rapids.sql.optimizer.enabled": "true"})

    def small_check(got):
        if got.num_rows != want:
            fail(f"P4 the small filter: {got.num_rows} rows, want {want}")

    CPU_ROUTE["expected"] = True
    try:
        res = route_case(s, f"P4 a {CBO_SMALL_ROWS}-row filter", lambda:
                         from_host_table(small, s).filter(
                             col("l_quantity") > lit(25.0)),
                         small_check, ["Filter", "LocalScan"], results,
                         warm_runs=PLANNING_WARM_RUNS)
    finally:
        CPU_ROUTE["expected"] = False
    reasons = [r for f in collect_fallbacks(s.last_meta)
               for r in f["reasons"]]
    if not reasons or not all(r.startswith("CBO: ") for r in reasons):
        fail(f"P4: the small filter's reasons {reasons}")
    add_launches(totals, res["launches"])
    res = run_case(s, "P4 q1 under the optimizer", lambda: q1_dataframe(
        s, table), q1_keep["check"], None, warm_runs=PLANNING_WARM_RUNS)
    if collect_cpu_nodes(s._last_root) or not s.last_meta.can_run_on_gpu:
        fail("P4: q1 left the device under the optimizer")
    add_launches(totals, res["launches"])
    results["P4 q1 under the optimizer"] = dict(res["stats"], launches={
        k: v for k, v in res["launches"].items() if v})
    log(f"  P4: the {CBO_SMALL_ROWS}-row filter on the CPU route "
        f"({reasons[0]}); q1 on the device with 0 CPU-route nodes")


def run_planning(tables, q1_keep, checks) -> dict:
    """Phase 22: P1 range partitioning and the local sort, P2 AQE's build
    (``checks``: phase 7's oracles of ``AQE_QUERIES``), P3 the three rungs
    onto the CPU route, P4 the cost-based optimizer. Returns every
    kernel's launches over the counted runs."""
    t_phase = time.perf_counter()
    card = card_line()
    totals, results = {}, {}
    for part in (lambda: run_p1(tables, totals, results),
                 lambda: run_p2(tables, checks, totals, results),
                 lambda: run_p3(q1_keep, totals, results),
                 lambda: run_p4(q1_keep, totals, results)):
        t0 = time.perf_counter()
        part()
        log(f"  ({time.perf_counter() - t0:.1f} s)")
    for k in ("onehot_partials", "gather_compact", "sort_with_payload"):
        if not totals.get(k):
            fail(f"phase 22 launched no {k}")
    took = time.perf_counter() - t_phase
    summary = {"card": card, "seconds": round(took, 1),
               "launches": {k: v for k, v in totals.items() if v},
               "cases": results}
    if took > PLANNING_BUDGET_S:
        log(f"  phase 22 took {took:.1f} s, past its "
            f"{PLANNING_BUDGET_S:.0f} s budget")
    log("  phase-22 summary: " + json.dumps(summary, default=str))
    return totals


def plan_nodes(plan) -> list:
    """The plan-node classes of ``plan``, pre-order: what the CPU route
    runs when spark.rapids.sql.enabled is false."""
    out = [type(plan).__name__]
    for c in plan.children:
        out += plan_nodes(c)
    return out


# ---------------------------------------------------------------------------
# phase 23: the query service
# ---------------------------------------------------------------------------

#: the phase's aim in seconds (logged past it)
SERVICE_BUDGET_S = 90.0
#: V1's submitters: tenant 0 sends SQL texts, the others the DSL
SERVICE_TENANTS = 3
#: V1's workers (spark.rapids.service.maxConcurrentQueries)
SERVICE_WORKERS = 4
#: V2: two pools weighted 3:1, a burst of this many q1s from each
V2_POOLS = "hi:weight=3;lo"
V2_BURST = 40
#: V4: the hard wall limit and the injected wedge's stall on the host
V4_HARD_TIMEOUT_MS = 2000
V4_WEDGE_S = 6.0
#: V5: reserve OOMs that walk one q1 down to the memory ladder's chunk
#: rung (the retry framework's retries, the rung retry, then chunk), and
#: the strikes that quarantine its template
V5_OOMS = 6
V5_STRIKES = 2
#: V7's child: lineitem rows of its q1s
SERVICE_CHILD_ROWS = 1 << 20


def tpch_sql(name: str) -> str:
    """TPC-H q1 and sparse q3 as SQL over views named apart from the
    corpus's (``tpch1_lineitem``, ``tpch3_customer`` ...)."""
    import re

    from spark_rapids_tpu_torch.models.tpch import Q1_SQL, Q3_SQL
    if name == "TPC-H q1":
        return re.sub(r"\blineitem\b", "tpch1_lineitem", Q1_SQL)
    return re.sub(r"\b(customer|orders|lineitem)\b", r"tpch3_\1",
                  Q3_SQL.format(segment="BUILDING"))


def service_workload(session, tables, q1_table, q3_tables, sql: bool):
    """{name: submission}: the 22 corpus queries, TPC-H q1 and sparse q3,
    as DataFrames (``sql`` False) or SQL texts over temp views of the same
    tables registered on ``session``."""
    from spark_rapids_tpu_torch.models.corpus import (
        CORPUS,
        build_queries,
        sql_texts,
    )
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe, q3_dataframe
    from spark_rapids_tpu_torch.plan import from_host_table
    if sql:
        for name, t in tables.items():
            from_host_table(t, session).create_or_replace_temp_view(name)
        from_host_table(q1_table, session).create_or_replace_temp_view(
            "tpch1_lineitem")
        for view, t in zip(("customer", "orders", "lineitem"), q3_tables):
            from_host_table(t, session).create_or_replace_temp_view(
                f"tpch3_{view}")
        texts = sql_texts()
        out = {n: (lambda t=texts[n]: t) for n in CORPUS}
        out["TPC-H q1"] = lambda: tpch_sql("TPC-H q1")
        out["TPC-H q3"] = lambda: tpch_sql("TPC-H q3")
        return out
    qs = build_queries(session, tables)
    out = {n: qs[n] for n in CORPUS}
    out["TPC-H q1"] = lambda: q1_dataframe(session, q1_table)
    out["TPC-H q3"] = lambda: q3_dataframe(session, *q3_tables)
    return out


class HeldCalls(list):
    """``kernels.calls`` of a concurrent run: each launch is held against
    its kernel's plain version as its worker records it (one at a time),
    and only the verdict is kept, so the recorded tensors die at once."""

    def __init__(self):
        super().__init__()
        self.lock = threading.Lock()
        self.held = collections.Counter()
        self.bad = []

    def append(self, call):
        kernel, args, out = call
        with self.lock:
            ok, what = held_call(kernel, args, out)
            self.held[kernel] += 1
            if not ok:
                self.bad.append(f"{kernel} ({what})")


def pct(values, q):
    vals = sorted(values)
    return vals[min(len(vals) - 1, max(0, int(round(q * (len(vals) - 1)))))]


def service_session(extra=None):
    from spark_rapids_tpu_torch.session import TorchSession
    conf = {"spark.rapids.service.maxConcurrentQueries": str(SERVICE_WORKERS),
            "spark.rapids.service.queueDepth": "256"}
    conf.update(extra or {})
    return TorchSession(conf)


def v1_stream(svc, tables, q1_table, q3_tables):
    """(name, form, tenant, submission) of V1's stream: every tenant every
    query, tenant 0 in SQL."""
    forms = {f: service_workload(svc.session, tables, q1_table, q3_tables,
                                 f == "sql") for f in ("sql", "dsl")}
    out = []
    for t in range(SERVICE_TENANTS):
        form = "sql" if t == 0 else "dsl"
        out += [(n, form, f"tenant{t}", b) for n, b in forms[form].items()]
    return out


def run_v1_pass(label, svc, stream, serial, checks, on_submitted=None):
    """Submit the stream to ``svc`` and wait; every result against its
    serial run (``tools.loadtest.result_differs``) and its oracle. Returns
    the numbers of the pass."""
    from spark_rapids_tpu_torch.tools.loadtest import result_differs
    t0 = time.perf_counter()
    handles, submit_s = [], []
    for n, f, ten, b in stream:
        # admission: the submit call's host time (a SQL text is parsed
        # and analysed here)
        t1 = time.perf_counter()
        handles.append((n, f, svc.submit(b(), tenant=ten,
                                         tag=f"{n}@{ten}")))
        submit_s.append(time.perf_counter() - t1)
    if on_submitted is not None:
        on_submitted()
    for n, f, h in handles:
        if not h.wait(600):
            fail(f"V1 {label}: {n} ({f}) still {h.state}")
    wall = time.perf_counter() - t0
    for n, f, h in handles:
        if h.state != "FINISHED":
            fail(f"V1 {label}: {n} ({f}) {h.state}: {h.error}")
        diff = result_differs(n, serial[(n, f)], h.result_table)
        if diff is not None:
            fail(f"V1 {label}: {n} ({f}) differs from its serial run: "
                 f"{diff}")
        checks[n](h.result_table)
    lat = [h.latency_s for _, _, h in handles]
    qw = [h.queue_wait_s or 0.0 for _, _, h in handles]
    serve = [h.run_s for _, _, h in handles]
    hits = sum(h.cache_hit for _, _, h in handles)
    return {"submissions": len(handles), "wall_s": round(wall, 4),
            "submit_p50_ms": round(pct(submit_s, 0.5) * 1e3, 3),
            "submit_p95_ms": round(pct(submit_s, 0.95) * 1e3, 3),
            "serve_p50_s": round(pct(serve, 0.5), 4),
            "serve_p95_s": round(pct(serve, 0.95), 4),
            "latency_p50_s": round(pct(lat, 0.5), 4),
            "latency_p95_s": round(pct(lat, 0.95), 4),
            "queue_wait_p50_s": round(pct(qw, 0.5), 4),
            "queue_wait_p95_s": round(pct(qw, 0.95), 4),
            "hit_rate": round(hits / len(handles), 4)}


def run_v1(tables, q1_table, q3_tables, checks, card: str) -> tuple:
    """V1 (with V6 during its timed pass): serial runs of every query in
    both forms, then three passes of the stream through the service: held
    (every launch held against its plain version, the phase's counted
    launches), timed with the result cache off (introspection and the
    telemetry ring on), and timed with it on. Returns (the held pass's
    launches, the serial q1 DSL result, the numbers)."""
    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.service import QueryService
    svc_held = QueryService(session=service_session(
        {"spark.rapids.service.resultCache.enabled": "false"}))
    stream = v1_stream(svc_held, tables, q1_table, q3_tables)
    # the serial runs, on the held service's session before it serves:
    # cold once, then the warm run each submission is held to
    serial, warm_s = {}, {}
    serial_launches = {"sql": collections.Counter(),
                       "dsl": collections.Counter()}
    t0 = time.perf_counter()
    s = svc_held.session
    for n, f, ten, build in stream[:len(stream) // SERVICE_TENANTS * 2]:
        if (n, f) in serial:
            continue
        q = build()
        run = (lambda q=q: s.sql(q).collect_table()) if f == "sql" \
            else (lambda q=q: q.collect_table())
        run()
        K.reset_launch_counts()
        t1 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        warm_s[(n, f)] = time.perf_counter() - t1
        serial_launches[f].update({k: v for k, v in
                                   K.launch_counts().items() if v})
        checks[n](got)
        serial[(n, f)] = got
    log(f"  V1 serial: {len(serial)} (query, form) pairs cold and warm in "
        f"{time.perf_counter() - t0:.1f} s, each against its oracle; warm "
        f"sum {sum(warm_s.values()):.3f} s [{card}]")
    serial_sum = sum(warm_s[(n, f)] for n, f, _, _ in stream)

    # the held pass: the counted launches, each held as it is recorded
    K.reset_launch_counts()
    K.calls = HeldCalls()
    try:
        held = run_v1_pass("held", svc_held, stream, serial, checks)
    finally:
        calls, K.calls = K.calls, None
    launches = K.launch_counts()
    svc_held.shutdown()
    if calls.bad:
        fail(f"V1: launches disagree with their plain versions: "
             f"{calls.bad[:5]}")
    for k in TPU_KERNELS:
        if k != "dec128_divide" and not launches.get(k):
            fail(f"V1 launched no {k}")
    if dict(calls.held) != {k: v for k, v in launches.items() if v}:
        fail(f"V1: held {dict(calls.held)} of launches {launches}")
    # the stream's launches are its serial runs' (one SQL tenant, the
    # others DSL): concurrency changes no route
    want = serial_launches["sql"] + collections.Counter(
        {k: v * (SERVICE_TENANTS - 1)
         for k, v in serial_launches["dsl"].items()})
    if dict(want) != dict(calls.held):
        fail(f"V1: the held pass launched {dict(calls.held)}, its serial "
             f"runs {dict(want)}")
    log(f"  V1 held pass ({SERVICE_TENANTS} tenants x "
        f"{len(stream) // SERVICE_TENANTS} queries, {SERVICE_WORKERS} "
        f"workers, every launch held against its plain version as "
        f"recorded): launches {dict(calls.held)}, as the stream's serial "
        f"runs launch; {held}")

    # V6 rides the timed pass with the cache off
    results = {"serial_warm_sum_s": round(serial_sum, 4), "held": held}
    v6 = {}
    for label, cache in (("timed, cache off", False),
                         ("timed, cache on", True)):
        extra = {"spark.rapids.service.resultCache.enabled": str(cache)
                 .lower()}
        if not cache:
            extra.update({"spark.rapids.service.introspect.enabled": "true",
                          "spark.rapids.obs.telemetry.enabled": "true",
                          "spark.rapids.obs.telemetry.intervalMs": "50"})
        svc = QueryService(session=service_session(extra))
        st = v1_stream(svc, tables, q1_table, q3_tables)
        # the views and the executable cache warm before the clock
        for n, f, _, b in st[:len(st) // SERVICE_TENANTS * 2]:
            q = b()
            (svc.session.sql(q) if f == "sql" else q).collect_table()
        res = run_v1_pass(label, svc, st, serial, checks,
                          on_submitted=(lambda svc=svc: v6.update(
                              v6_during(svc))) if not cache else None)
        res["stats"] = {k: svc.stats()[k] for k in (
            "finished", "failed", "rejected", "requeued")}
        if cache:
            res["resultCache"] = svc.result_cache.stats()
        else:
            v6.update(v6_after(svc))
        svc.shutdown()
        results[label] = res
        log(f"  V1 {label}: aggregate wall {res['wall_s']:.3f} s against "
            f"the serial sum {serial_sum:.3f} s (warm runs, one at a time); "
            f"latency p50/p95 {res['latency_p50_s']}/"
            f"{res['latency_p95_s']} s, queue wait p50/p95 "
            f"{res['queue_wait_p50_s']}/{res['queue_wait_p95_s']} s, "
            f"serve (RUNNING to done) p50/p95 {res['serve_p50_s']}/"
            f"{res['serve_p95_s']} s, admission (a submit call) p50/p95 "
            f"{res['submit_p50_ms']}/{res['submit_p95_ms']} ms, hit rate "
            f"{res['hit_rate']} [{card}]")
    if not results["timed, cache on"]["hit_rate"] > 0:
        fail("V1: the result cache served nothing")
    log(f"  V6 while V1's timed traffic ran: GET /top and tools top --url "
        f"({v6}) [{card}]")
    results["V6"] = v6
    return launches, serial[("TPC-H q1", "dsl")], results


def v6_during(svc) -> dict:
    """V6 while V1's traffic runs: GET /top on 127.0.0.1, then
    ``tools top --url``."""
    import urllib.request

    from spark_rapids_tpu_torch.tools import __main__ as tools_main
    url = f"http://127.0.0.1:{svc.introspect_port}/top"
    with urllib.request.urlopen(url, timeout=30) as r:
        doc = json.loads(r.read().decode())
    for key in ("health", "stats", "slo", "queries", "streams", "telemetry"):
        if key not in doc:
            fail(f"V6: /top lacks {key}")
    live = len(doc["queries"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tools_main.main(["top", "--url", url])
    text = buf.getvalue()
    if rc != 0 or not text.startswith("Service: "):
        fail(f"V6: tools top --url returned {rc}: {text[:300]}")
    return {"top_live_queries": live, "top_state": doc["health"]["state"],
            "tools_top_first_line": text.splitlines()[0]}


def v6_after(svc) -> dict:
    """V6 after the timed pass: the ring holds at least 3 samples, and the
    sampler makes no host sync in a window where only it runs."""
    from spark_rapids_tpu_torch.obs.telemetry import TELEMETRY
    t0 = time.perf_counter()
    while TELEMETRY.stats()["samples"] < 3:
        if time.perf_counter() - t0 > 30:
            fail(f"V6: the telemetry ring holds {TELEMETRY.stats()}")
        time.sleep(0.05)
    before = TELEMETRY.stats()["samples"]
    with host_sync_count() as box:
        for _ in range(5):
            TELEMETRY.sample_once()
            time.sleep(0.06)
    st = TELEMETRY.stats()
    if box["syncs"] != 0 or st["errors"]:
        fail(f"V6: the sampler made {box['syncs']} host syncs "
             f"({box['sites']}), errors {st['errors']}")
    return {"ring_samples": st["samples"], "window_samples":
            st["samples"] - before, "window_host_syncs": box["syncs"]}


@contextlib.contextmanager
def scan_gate(at: int):
    """Hold the ``at``-th scan landing (``TpuScanExec._land``) until
    ``gate["release"]`` is set; ``gate["entered"]`` is set when a query
    reaches it."""
    from spark_rapids_tpu_torch.execs.basic import TpuScanExec
    gate = {"calls": 0, "entered": threading.Event(),
            "release": threading.Event(), "lock": threading.Lock()}
    real = TpuScanExec._land

    def land(self, *a, **k):
        with gate["lock"]:
            gate["calls"] += 1
            hold = gate["calls"] == at
        if hold:
            gate["entered"].set()
            gate["release"].wait(120)
        return real(self, *a, **k)

    TpuScanExec._land = land
    try:
        yield gate
    finally:
        gate["release"].set()
        TpuScanExec._land = real


def run_v2(q1_table, card: str) -> dict:
    """V2: pools hi and lo weighted 3:1, a burst of V2_BURST q1s from each
    across two tenants, one worker, the cache off: at every pick while both
    pools wait, the picked pool's charged clock is the lesser and the two
    stay within the largest weighted charge; a queue past queueDepth
    raises QueryRejectedError with retry_after_ms > 0."""
    from spark_rapids_tpu_torch.errors import QueryRejectedError
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    from spark_rapids_tpu_torch.service import QueryService
    svc = QueryService({"spark.rapids.service.pools": V2_POOLS,
                        "spark.rapids.service.maxConcurrentQueries": "1",
                        "spark.rapids.service.queueDepth": str(V2_BURST),
                        "spark.rapids.service.resultCache.enabled": "false"})
    picks, charges = [], []
    real_pick, real_charge = svc._pick_locked, svc._charge_locked

    def pick():
        waiting = {p for p, n in svc._queued_per_pool.items() if n}
        h = real_pick()
        if h is not None:
            picks.append((h.pool, dict(svc._pool_clock), waiting))
        return h

    def charge(h, elapsed):
        charges.append(elapsed / svc.pools[h.pool])
        real_charge(h, elapsed)

    svc._pick_locked, svc._charge_locked = pick, charge
    handles = []
    with svc._cond:  # the worker cannot pick while the burst queues
        for i in range(V2_BURST):
            for pool in ("hi", "lo"):
                handles.append(svc.submit(
                    q1_dataframe(svc.session, q1_table), pool=pool,
                    tenant=f"{pool}{i % 2}"))
        try:
            svc.submit(q1_dataframe(svc.session, q1_table), pool="hi")
            fail("V2: a queue past queueDepth admitted")
        except QueryRejectedError as e:
            retry = e.retry_after_ms
    if not retry > 0:
        fail(f"V2: retry_after_ms {retry}")
    for h in handles:
        if not h.wait(600) or h.state != "FINISHED":
            fail(f"V2: {h} {h.error}")
    svc.shutdown()
    # one worker: pick i follows the charges of the i picks before it
    both = []
    for i, (pool, clocks, waiting) in enumerate(picks):
        if waiting != {"hi", "lo"}:
            continue
        both.append((pool, clocks))
        other = "lo" if pool == "hi" else "hi"
        bound = max(charges[:i] or [0.0])
        if clocks[pool] > clocks[other] or \
                abs(clocks["hi"] - clocks["lo"]) > bound + 1e-9:
            fail(f"V2: pick {i} from {pool} at clocks {clocks} (largest "
                 f"weighted charge so far {bound})")
    hi = sum(p == "hi" for p, _ in both)
    out = {"picks_both_waiting": len(both), "hi_picks": hi,
           "lo_picks": len(both) - hi, "retry_after_ms": retry,
           "rejected": svc.stats()["rejected"]}
    log(f"  V2 pools 3:1, {2 * V2_BURST} q1s: while both pools waited "
        f"{hi} picks went to hi and {len(both) - hi} to lo, each pick from "
        f"the lesser clock, the clocks within the largest weighted charge; "
        f"one more hi submission past queueDepth {V2_BURST} rejected with "
        f"retry_after_ms {retry} [{card}]")
    return out


def run_v3(tables, q1_table, q1_result, card: str) -> dict:
    """V3: a group-by over lineitem in 4 scan batches, cancelled while
    RUNNING (held at its second landing): CANCELLED at that boundary;
    again with a 300 ms deadline: TIMED_OUT; then q1 bit for bit."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.service import QueryService
    from spark_rapids_tpu_torch.tools.loadtest import tables_differ
    li4 = lineitem4(tables)
    svc = QueryService({"spark.rapids.service.resultCache.enabled": "false"})

    def q():
        return from_host_table(li4, svc.session, W8_BATCHES).group_by(
            "l_returnflag").agg(F.sum("l_quantity").alias("q"),
                                F.count("l_orderkey").alias("n"))

    out = {}
    with scan_gate(2) as gate:
        h = svc.submit(q())
        if not gate["entered"].wait(120) or h.state != "RUNNING":
            fail(f"V3: the query did not reach its second batch: {h}")
        h.cancel()
        gate["release"].set()
        if not h.wait(120) or h.state != "CANCELLED":
            fail(f"V3: cancel ended in {h.state}: {h.error}")
        out["cancel"] = {"landings": gate["calls"],
                         "checks": h.scope.checks}
        if gate["calls"] != 2:
            fail(f"V3: {gate['calls']} landings after the cancel")
    with scan_gate(2) as gate:
        h = svc.submit(q(), timeout_ms=300)
        if not gate["entered"].wait(120):
            fail("V3: the deadline query did not reach its second batch")
        time.sleep(max(0.0, h.scope.deadline - time.monotonic()) + 0.05)
        gate["release"].set()
        if not h.wait(120) or h.state != "TIMED_OUT":
            fail(f"V3: the deadline ended in {h.state}: {h.error}")
        out["deadline"] = {"landings": gate["calls"],
                           "run_ms": round(h.run_s * 1e3, 1)}
    h = svc.submit(q1_dataframe(svc.session, q1_table))
    if not h.wait(120) or h.state != "FINISHED" or tables_differ(
            q1_result, h.result_table) is not None:
        fail(f"V3: q1 after the cancel: {h.state} {h.error}")
    svc.shutdown()
    log(f"  V3: cancel while RUNNING ended CANCELLED at its next batch "
        f"boundary ({out['cancel']}); a 300 ms deadline ended TIMED_OUT "
        f"({out['deadline']}); then q1 bit for bit [{card}]")
    return out


def run_v4(q1_table, q1_result, card: str) -> dict:
    """V4: ``dispatch.wedge`` at one launch with hardTimeoutMs: the query
    fails HardTimeoutError, one worker respawned, the next q1 bit for bit;
    ``service.worker_crash`` once: the query requeued and bit for bit."""
    from spark_rapids_tpu_torch.errors import HardTimeoutError
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    from spark_rapids_tpu_torch.runtime.faults import FAULTS
    from spark_rapids_tpu_torch.service import QueryService
    from spark_rapids_tpu_torch.tools.loadtest import tables_differ
    out = {}
    before = os.environ.get("SRT_WEDGE_SLEEP_S")
    os.environ["SRT_WEDGE_SLEEP_S"] = str(V4_WEDGE_S)
    try:
        svc = QueryService({
            "spark.rapids.test.faults": "dispatch.wedge:wedge:1",
            "spark.rapids.service.hardTimeoutMs": str(V4_HARD_TIMEOUT_MS),
            "spark.rapids.service.resultCache.enabled": "false"})
        h = svc.submit(q1_dataframe(svc.session, q1_table))
        if not h.wait(120) or not isinstance(h.error, HardTimeoutError):
            fail(f"V4: the wedged q1 ended {h.state}: {h.error!r}")
        health = svc.health()
        if health["workersRespawned"] != 1 or health["workerCount"] != 4:
            fail(f"V4: after the hard timeout {health}")
        nxt = svc.submit(q1_dataframe(svc.session, q1_table))
        if not nxt.wait(120) or nxt.state != "FINISHED" or tables_differ(
                q1_result, nxt.result_table) is not None:
            fail(f"V4: the q1 after the wedge: {nxt.state} {nxt.error}")
        out["wedge"] = {"run_ms": round(h.run_s * 1e3, 1),
                        "workersRespawned": health["workersRespawned"],
                        "hardTimeouts": svc.stats()["hardTimeouts"]}
        svc.shutdown()
        # the abandoned worker ends when its stalled launch returns: wait
        # for it, so that nothing of V4 runs beside the next cells
        for t in threading.enumerate():
            if t.name.startswith("rapids-svc-worker"):
                t.join(timeout=V4_WEDGE_S + 60)
    finally:
        if before is None:
            os.environ.pop("SRT_WEDGE_SLEEP_S", None)
        else:
            os.environ["SRT_WEDGE_SLEEP_S"] = before
    svc = QueryService({
        "spark.rapids.test.faults": "service.worker_crash:crash:1",
        "spark.rapids.service.resultCache.enabled": "false"})
    h = svc.submit(q1_dataframe(svc.session, q1_table))
    if not h.wait(120) or h.state != "FINISHED" or tables_differ(
            q1_result, h.result_table) is not None or h.requeues != 1:
        fail(f"V4: the crashed worker's q1: {h.state} {h.error} requeues "
             f"{h.requeues}")
    out["crash"] = {k: svc.stats()[k] for k in (
        "workersLost", "workersRespawned", "requeued")}
    svc.shutdown()
    FAULTS.disarm()
    log(f"  V4: a launch wedged {V4_WEDGE_S:.0f} s on the host past "
        f"hardTimeoutMs {V4_HARD_TIMEOUT_MS}: HardTimeoutError, "
        f"{out['wedge']}, the next q1 bit for bit; a worker crash: "
        f"{out['crash']}, its q1 requeued and bit for bit [{card}]")
    return out


def run_v5(q1_table, check_q1, base: str, card: str) -> dict:
    """V5: q1's template takes V5_STRIKES strikes through the memory
    ladder's chunk rung (V5_OOMS injected reserve OOMs a run); the next
    submission raises QueryQuarantinedError with the strikes; one bundle
    per strike, which ``tools incident`` renders."""
    from spark_rapids_tpu_torch.columnar.table import evict_device_caches
    from spark_rapids_tpu_torch.errors import QueryQuarantinedError
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    from spark_rapids_tpu_torch.obs.telemetry import flush_incidents
    from spark_rapids_tpu_torch.runtime.faults import CIRCUIT_BREAKER, FAULTS
    from spark_rapids_tpu_torch.runtime.health import HEALTH, QUARANTINE
    from spark_rapids_tpu_torch.service import QueryService
    from spark_rapids_tpu_torch.tools.incident import (
        load_bundles,
        render_incident,
    )
    rec_dir = os.path.join(base, "flightrec")
    svc = QueryService({
        "spark.rapids.test.faults": f"mem.reserve:oom:{V5_OOMS}",
        "spark.rapids.service.quarantine.maxStrikes": str(V5_STRIKES),
        "spark.rapids.service.maxConcurrentQueries": "1",
        "spark.rapids.service.resultCache.enabled": "false",
        "spark.rapids.obs.flightRecorder.dir": rec_dir})
    rungs = []
    for _ in range(V5_STRIKES):
        # a cold scan reserves (a cached one lands nothing); the count
        # re-arms
        evict_device_caches()
        FAULTS.disarm()
        h = svc.submit(q1_dataframe(svc.session, q1_table))
        if not h.wait(300) or h.state != "FINISHED":
            fail(f"V5: q1 under {V5_OOMS} reserve OOMs: {h.state} {h.error}")
        check_q1(h.result_table)
        m = svc.session.last_metrics()
        rungs.append((m.get("memoryPressure"),
                      m.get("memoryChunkedReexecutions")))
        if m.get("memoryChunkedReexecutions") != 1:
            fail(f"V5: q1 walked {m}")
    try:
        svc.submit(q1_dataframe(svc.session, q1_table))
        fail("V5: the quarantined template was admitted")
    except QueryQuarantinedError as e:
        strikes = list(e.strikes)
    svc.shutdown()
    FAULTS.disarm()
    flush_incidents()
    bundles = load_bundles(rec_dir)
    quarantine = [b for b in bundles if b.get("kind") == "quarantine"]
    text = render_incident(bundles)
    if len(strikes) != V5_STRIKES or len(quarantine) != V5_STRIKES or \
            "kind=quarantine action=quarantined" not in text:
        fail(f"V5: strikes {strikes}, {len(quarantine)} quarantine bundles "
             f"of {len(bundles)}")
    QUARANTINE.reset()
    HEALTH.reset()
    CIRCUIT_BREAKER.reset()
    out = {"rungs": rungs, "strikes": len(strikes),
           "bundles": {k: sum(b.get("kind") == k for b in bundles)
                       for k in sorted({b.get("kind") for b in bundles})}}
    log(f"  V5: {V5_STRIKES} q1s through the chunk rung (memoryPressure, "
        f"chunked) {rungs}, each answering q1's oracle; the next submission "
        f"QueryQuarantinedError with {len(strikes)} strikes; bundles "
        f"{out['bundles']}; tools incident renders {len(bundles)} "
        f"[{card}]")
    return out


def poison_context() -> None:
    """An out-of-bounds index on the card: a device-side assert, sticky
    for the whole CUDA context (18.4's poison), surfaced here."""
    x = torch.zeros(4, device=DEV)
    x[torch.full((1,), 1 << 20, dtype=torch.int64, device=DEV)]
    torch.cuda.synchronize()


def service_child(out_dir: str) -> int:
    """V7's child, in a fresh SRT_KERNEL_BUILD_DIR: four q1s at once on a
    cold process (one nvcc run per library, none twice), then four q1s at
    once again, held together at their first landing, while one launch
    poisons the context with a real device-side assert: every handle
    requeued and FINISHED on the CPU route after the latch, each against
    q1's oracle. Prints one JSON line."""
    from spark_rapids_tpu_torch.dispatch import COMPILE_SCOPE
    from spark_rapids_tpu_torch.execs.basic import TpuScanExec
    from spark_rapids_tpu_torch.kernels.build import BUILD_DIR
    from spark_rapids_tpu_torch.models.tpch import lineitem_table, q1_dataframe
    from spark_rapids_tpu_torch.obs.telemetry import TELEMETRY
    from spark_rapids_tpu_torch.runtime import faults as F
    from spark_rapids_tpu_torch.runtime.health import HEALTH
    from spark_rapids_tpu_torch.service import QueryService
    table = lineitem_table(SERVICE_CHILD_ROWS, seed=0)
    oracle = q1_oracle(table)
    res = {"build_dir_empty": not any(BUILD_DIR.glob("*.so"))}
    before = dict(COMPILE_SCOPE)
    svc = QueryService({"spark.rapids.service.resultCache.enabled": "false",
                        "spark.rapids.sql.concurrentGpuTasks": "4",
                        # the injected poison is not the template's: a
                        # strike budget over its four losses keeps q1
                        # serving (the loadtest's chaos setting)
                        "spark.rapids.service.quarantine.maxStrikes": "8",
                        "spark.rapids.memory.crashDump.dir": out_dir})
    t0 = time.perf_counter()
    hs = [svc.submit(q1_dataframe(svc.session, table)) for _ in range(4)]
    for h in hs:
        h.wait(600)
    res["cold"] = {"states": [h.state for h in hs],
                   "s": round(time.perf_counter() - t0, 2),
                   "kernelTraces": COMPILE_SCOPE.get("kernelTraces", 0)
                   - before.get("kernelTraces", 0),
                   "libraries": sorted(p.name.split("-")[0]
                                       for p in BUILD_DIR.glob("*.so"))}
    for h in hs:
        check_q1_result(h.result_table, oracle)
    # the poison: the first device.lost point reached indexes out of
    # bounds on the card (a device-side assert, sticky for the context)
    barrier = threading.Barrier(4, timeout=120)
    real_land, real_point = TpuScanExec._land, F.fault_point
    armed = {"n": 1, "lock": threading.Lock(), "first": set()}

    def land(self, *a, **k):
        me = threading.get_ident()
        with armed["lock"]:
            first = me not in armed["first"]
            armed["first"].add(me)
        if first and HEALTH.cpu_only_reason() is None:
            barrier.wait()
        return real_land(self, *a, **k)

    def point(name, op=None, data=None):
        if name == "device.lost":
            with armed["lock"]:
                fire, armed["n"] = armed["n"] > 0, armed["n"] - 1
            if fire:
                poison_context()
        return real_point(name, op, data)

    TpuScanExec._land, F.fault_point = land, point
    t0 = time.perf_counter()
    hs = [svc.submit(q1_dataframe(svc.session, table)) for _ in range(4)]
    for h in hs:
        h.wait(600)
    res["poison"] = {"states": [h.state for h in hs],
                     "requeues": [h.requeues for h in hs],
                     "errors": [repr(h.error)[:160] for h in hs if h.error],
                     "s": round(time.perf_counter() - t0, 2),
                     "cpuOnlyReason": (HEALTH.cpu_only_reason() or "")[:300],
                     "service": {k: svc.stats()[k] for k in (
                         "finished", "failed", "requeued")},
                     "health": svc.health()["state"]}
    for h in hs:
        if h.state == "FINISHED":
            check_q1_result(h.result_table, oracle)
    # the sampler in the latched process: host reads only
    res["poison"]["sample"] = TELEMETRY.sample_once() is not None
    svc.shutdown(wait=False)
    print(json.dumps(res), flush=True)
    os._exit(0)


def start_service_child(base: str):
    d = os.path.join(base, "service_child")
    os.makedirs(os.path.join(d, "build"), exist_ok=True)
    env = dict(os.environ, SRT_KERNEL_BUILD_DIR=os.path.join(d, "build"))
    return d, subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--service-child", d],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def finish_v7(child, card: str) -> dict:
    """V7's verdict over the child's JSON line."""
    d, p = child
    try:
        so, se = p.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        p.kill()
        so, se = p.communicate()
        fail("V7: the service child did not finish")
    lines = so.strip().splitlines()
    res = json.loads(lines[-1]) if p.returncode == 0 and lines else {}
    cold, poison = res.get("cold", {}), res.get("poison", {})
    libs = cold.get("libraries", [])
    if not (res.get("build_dir_empty") and cold.get("states") == [
            "FINISHED"] * 4 and libs and len(libs) == len(set(libs))
            and cold.get("kernelTraces") == len(libs)):
        fail(f"V7: the cold builds: rc {p.returncode} {res}; stderr "
             f"{se[-3000:]}")
    if not (poison.get("states") == ["FINISHED"] * 4
            and all(r >= 1 for r in poison.get("requeues", []))
            and poison.get("cpuOnlyReason") and poison.get("sample")
            and poison.get("health") == "CPU_ONLY"):
        fail(f"V7: under the poison: {poison}; stderr {se[-3000:]}")
    log(f"  V7 (child): 4 cold q1s at once built {libs} once each "
        f"(kernelTraces {cold['kernelTraces']}) in {cold['s']} s; a "
        f"device-side assert at one launch while 3 other q1s ran: every "
        f"handle requeued {poison['requeues']} and FINISHED on the CPU "
        f"route after the latch against q1's oracle ({poison['service']}, "
        f"{poison['s']} s) [{card}]")
    return res


#: V8: the witnessed service's workers, and the q1s and dense q3s of its
#: burst (each)
V8_WORKERS = 3
V8_EACH = 4
#: V8's aim in seconds (logged past it)
V8_BUDGET_S = 20.0
#: V8's numbers, for phase 27's summary (filled when phase 23 runs)
V8_RESULT: dict = {}


def v8_burst(svc, q1_table, q3_tables, want: dict, checks: dict,
             held: bool):
    """One burst of V8: ``V8_EACH`` q1s and dense q3s, interleaved,
    submitted together; every result held to its oracle and to its serial
    run in ``want``. Under the squeezed budget the scans land in chunks
    and the coalesce stops at a chunk (``execs/basic.py``'s coalesce
    target), so both queries add per-chunk partials, as phase 14's
    squeezed q3 and W8b do: q1's floats within rtol 1e-9 and every other
    column bitwise (``same_table``), q3's revenue within rtol 1e-9 and the
    rest bitwise (V1's comparator, ``result_differs``). Returns (wall
    seconds, the launches' HeldCalls or None)."""
    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe, q3_dataframe
    from spark_rapids_tpu_torch.tools.loadtest import result_differs
    make = {"TPC-H q1": lambda: q1_dataframe(svc.session, q1_table),
            "TPC-H q3": lambda: q3_dataframe(svc.session, *q3_tables)}
    calls = None
    if held:
        K.reset_launch_counts()
        K.calls = calls = HeldCalls()
    try:
        t0 = time.perf_counter()
        handles = [(n, svc.submit(make[n](), tag=f"V8 {n} {i}"))
                   for i in range(V8_EACH) for n in make]
        for n, h in handles:
            if not h.wait(600):
                fail(f"V8: {n} still {h.state}")
        wall = time.perf_counter() - t0
    finally:
        if held:
            K.calls = None
    for n, h in handles:
        if h.state != "FINISHED":
            fail(f"V8: {n} {h.state}: {h.error}")
        checks[n](h.result_table)
        if n == "TPC-H q1":
            same_table(h.result_table, want[n], "V8 TPC-H q1 against its "
                       "serial run", 1e-9)
            continue
        diff = result_differs(n, want[n], h.result_table)
        if diff is not None:
            fail(f"V8: {n} differs from its serial run: {diff}")
    return wall, calls


def run_v8(q1_table, q1_result, q1_check, q3_dense, card: str) -> dict:
    """V8: the runtime lock witness under load. A service of ``V8_WORKERS``
    workers with ``spark.rapids.lint.lockWitness=true`` in its conf and a
    device budget of q1's unsqueezed peak accounted bytes over
    ``SQUEEZE`` (the arbiter, the spill catalog, the batches' locks and
    the host arbiter taken under load) serves ``V8_EACH`` TPC-H q1s and
    dense q3s at once: each result held to its serial run (q1 V1's), each
    launch to its kernel's plain version, then 0 witness violations, an
    empty held stack on this thread and the witness disarmed. Then the
    same burst timed in turns, without and with the witness (plain,
    witnessed, witnessed, plain; no launch held). Returns the held
    burst's launches."""
    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch import lockorder
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe, q3_dataframe
    from spark_rapids_tpu_torch.runtime.host_alloc import HostMemoryArbiter
    from spark_rapids_tpu_torch.runtime.memory import MEM_SCOPE, MEMORY
    from spark_rapids_tpu_torch.service import QueryService
    from spark_rapids_tpu_torch.tools.loadtest import result_differs
    t_v8 = time.perf_counter()
    base = {"spark.rapids.service.maxConcurrentQueries": str(V8_WORKERS),
            "spark.rapids.sql.concurrentGpuTasks": "1",
            "spark.rapids.service.resultCache.enabled": "false"}
    # q1's unsqueezed peak and dense q3's serial result
    s = service_session(base)
    fresh_device()
    MEMORY.reset_peak()
    got = q1_dataframe(s, q1_table).collect_table()
    torch.cuda.synchronize()
    peak = MEMORY.peak_bytes()
    diff = result_differs("TPC-H q1", q1_result, got)
    if diff is not None:
        fail(f"V8: q1 differs from V1's serial run: {diff}")
    q3_serial = q3_dataframe(s, *q3_dense["tables"]).collect_table()
    q3_dense["check"](q3_serial)
    want = {"TPC-H q1": q1_result, "TPC-H q3": q3_serial}
    checks = {"TPC-H q1": q1_check, "TPC-H q3": q3_dense["check"]}
    del s, got
    budget = peak // SQUEEZE
    squeezed = dict(base, **{
        "spark.rapids.memory.device.budgetBytes": str(budget)})
    host_limit = HostMemoryArbiter.get().limit_bytes

    def burst(witnessed: bool, held: bool):
        conf = dict(squeezed)
        if witnessed:
            conf["spark.rapids.lint.lockWitness"] = "true"
        fresh_device()
        svc = QueryService(session=service_session(conf))
        if lockorder.witness_armed() != witnessed:
            fail(f"V8: the service's conf left the witness "
                 f"{'off' if witnessed else 'on'}")
        if witnessed:
            # the host arbiter is process state built before (raw):
            # re-made here, as a device manager's restart makes it, its
            # condition is witnessed under the batches' locks
            HostMemoryArbiter.reset(host_limit)
        try:
            return v8_burst(svc, q1_table, q3_dense["tables"], want, checks,
                            held)
        finally:
            svc.shutdown()

    # the held burst: every lock built from here on is witnessed and
    # counted by name
    built = collections.Counter()
    real_init = lockorder._WitnessedLock.__init__

    def counting_init(self, inner, decl):
        built[decl.name] += 1
        real_init(self, inner, decl)

    v0 = lockorder.witness_violations()
    mem0 = {k: MEM_SCOPE.get(k, 0) for k in RUNTIME_KEYS}
    walls = {"plain": [], "witnessed": []}
    try:
        lockorder._WitnessedLock.__init__ = counting_init
        try:
            _, calls = burst(True, True)
        finally:
            lockorder._WitnessedLock.__init__ = real_init
        launches = K.launch_counts()
        mem = {k: MEM_SCOPE.get(k, 0) - v for k, v in mem0.items()}
        for witnessed in (False, True, True, False):
            wall, _ = burst(witnessed, False)
            walls["witnessed" if witnessed else "plain"].append(wall)
    finally:
        lockorder.disarm_witness()
        HostMemoryArbiter.reset(host_limit)
    violations = lockorder.witness_violations() - v0
    if violations:
        fail(f"V8: {violations} lock witness violations: "
             f"{lockorder.witness_violation_records()}")
    if lockorder.held_snapshot() != []:
        fail(f"V8: the main thread holds {lockorder.held_snapshot()}")
    if lockorder.witness_armed():
        fail("V8: the witness is still armed")
    if calls.bad:
        fail(f"V8: launches disagree with their plain versions: "
             f"{calls.bad[:5]}")
    if dict(calls.held) != {k: v for k, v in launches.items() if v}:
        fail(f"V8: held {dict(calls.held)} of launches {launches}")
    for k in ("onehot_partials", "gather_compact", "sort_with_payload"):
        if not launches.get(k):
            fail(f"V8 launched no {k}")
    for name in ("service.scheduler.cond", "service.handle", "spill.batch",
                 "host_alloc.cv"):
        if not built[name]:
            fail(f"V8: no witnessed {name} was built ({dict(built)})")
    if mem["budgetViolations"]:
        fail(f"V8: {mem['budgetViolations']} budget violations")
    took = time.perf_counter() - t_v8
    res = {"budget": budget, "unsqueezed_peak": peak,
           "witnessed_locks": sum(built.values()), "by_name": dict(built),
           "walls_witnessed_s": [round(w, 4) for w in walls["witnessed"]],
           "walls_plain_s": [round(w, 4) for w in walls["plain"]],
           "violations": violations,
           "memory": {k: v for k, v in mem.items() if v},
           "seconds": round(took, 1)}
    V8_RESULT.update(res)
    log(f"  V8 {V8_EACH} q1s and {V8_EACH} dense q3s at once, "
        f"{V8_WORKERS} workers, a budget of {budget} B (q1's unsqueezed "
        f"peak {peak} B over {SQUEEZE}): every result against its oracle "
        f"and its serial run (floats within rtol 1e-9: per-chunk partials), "
        f"launches {dict(calls.held)} held against their plain versions, "
        f"memory {res['memory']}; "
        f"{sum(built.values())} witnessed locks built ({dict(built)}), 0 "
        f"violations over 3 witnessed bursts, the main thread's held stack "
        f"empty, the witness disarmed after")
    log(f"  V8 wall of the burst in turns (plain, witnessed, witnessed, "
        f"plain; no launch held): witnessed {res['walls_witnessed_s']} s, "
        f"plain {res['walls_plain_s']} s [{card}]")
    if took > V8_BUDGET_S:
        log(f"  V8 took {took:.1f} s, past its {V8_BUDGET_S:.0f} s aim")
    return launches


def run_service(tables, q1_table, q1_check, q3_tables, checks,
                q3_dense) -> dict:
    """Phase 23 (V1-V8): returns V1's held pass's launches and V8's.
    ``q3_dense``: dense q3's tables and oracle check (V8)."""
    from spark_rapids_tpu_torch.runtime.speculation import clear_blocklist
    t_phase = time.perf_counter()
    card = card_line()
    # from a fresh process's speculation state, as ``--only 23`` runs:
    # earlier phases' homeless rows at 4 probe attempts put sparse q3's
    # join sites (shared with the J-queries') on the sort-based probe
    clear_blocklist()
    base = tempfile.mkdtemp(prefix="srt-service-")
    results = {}
    child = None
    try:
        t0 = time.perf_counter()
        launches, q1_result, results["V1"] = run_v1(
            tables, q1_table, q3_tables, checks, card)
        log(f"  (V1 and V6 {time.perf_counter() - t0:.1f} s)")
        child = start_service_child(base)
        for name, part in (
                ("V2", lambda: run_v2(q1_table, card)),
                ("V3", lambda: run_v3(tables, q1_table, q1_result, card)),
                ("V4", lambda: run_v4(q1_table, q1_result, card)),
                ("V5", lambda: run_v5(q1_table, q1_check, base, card))):
            t0 = time.perf_counter()
            results[name] = part()
            log(f"  ({name} {time.perf_counter() - t0:.1f} s)")
        # V8 runs while V7's child builds its libraries and serves (the
        # parent waited for it idle before)
        t0 = time.perf_counter()
        for k, v in run_v8(q1_table, q1_result, q1_check, q3_dense,
                           card).items():
            launches[k] = launches.get(k, 0) + v
        results["V8"] = dict(V8_RESULT)
        log(f"  (V8 {time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        results["V7"] = finish_v7(child, card)
        log(f"  (V7's wait {time.perf_counter() - t0:.1f} s)")
    finally:
        if child is not None and child[1].poll() is None:
            child[1].kill()  # a failed cell leaves no child behind
            child[1].communicate()
        shutil.rmtree(base, ignore_errors=True)
    took = time.perf_counter() - t_phase
    summary = {"card": card, "seconds": round(took, 1),
               "launches": {k: v for k, v in launches.items() if v},
               "cells": results}
    if took > SERVICE_BUDGET_S:
        log(f"  phase 23 took {took:.1f} s, past its "
            f"{SERVICE_BUDGET_S:.0f} s aim")
    log("  phase-23 summary: " + json.dumps(summary, default=str))
    return launches


# -- phase 24: Delta Lake, Iceberg and streaming ---------------------------------

#: D1: the Delta table's data files (slices of phase 4's lineitem, one
#: commit each)
LAKE_FILES = 8
#: D1: each MERGE's source rows, half matched (update) and half new
#: (insert)
LAKE_MERGE_ROWS = 600_000
#: D1: DELETE's share of the rows (l_partkey below this of 200,000 parts)
LAKE_DELETE_PARTKEY = 4000
#: D1: UPDATE's orders (l_orderkey at most this: the first file's rows)
LAKE_UPDATE_ORDERS = 100_000
#: D2: rows of the append that loses an injected commit race
LAKE_RACE_ROWS = 1000
#: S1: the stream's Parquet files, their rows in all (lineitem's first
#: rows: cut from SF 1 for the script's time limit, PERF.md section 4),
#: and files per trigger
STREAM_FILES = 24
STREAM_ROWS = 1_000_000
STREAM_PER_TRIGGER = 4
#: S1: the child process stops dead inside the commit of this batch
STREAM_KILL_BATCH = 2
#: the phase's aim on the usual host, seconds
LAKE_BUDGET_S = 60.0
LAKE_PHASE = ("phase 24: Delta Lake, Iceberg and streaming (D1 the Delta "
              "table of lineitem: q1, DELETE by deletion vectors, UPDATE, "
              "MERGE low-shuffle and full; D2 OPTIMIZE ZORDER, the "
              "checkpoint's replay, the change feed, a column rename, "
              "VACUUM, a lost commit race; I1 an Iceberg table at two "
              "snapshots with deletes; S1 a file-watch stream into a Delta "
              "sink, killed and resumed; M1 two views over it)")


class LakeState:
    """The Delta table's expected rows, kept in numpy beside every
    command (the oracle of D1 and D2): columns by name, the live rows, and
    q1's string columns as ``np.unique`` codes over the same rows."""

    #: the string columns q1 groups by
    GROUPED = ("l_returnflag", "l_linestatus")

    def __init__(self, table):
        self.names = list(table.names)
        self.types = {n: c.dtype for n, c in zip(table.names, table.columns)}
        self.cols = {n: np.array(c.data, copy=True)
                     for n, c in zip(table.names, table.columns)}
        self.alive = np.ones(table.num_rows, dtype=bool)
        #: rows of the original table (an original row's index follows
        #: from its key: (l_orderkey - 1) * 4 + l_linenumber - 1)
        self.n0 = table.num_rows
        self.codes = string_codes(table, self.GROUPED)

    def table(self):
        from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
        return HostTable(self.names, [
            HostColumn(self.types[n], self.cols[n][self.alive])
            for n in self.names])

    def q1(self):
        """q1's oracle over the live rows."""
        return q1_oracle(self.table(), {
            n: (u, i[self.alive]) for n, (u, i) in self.codes.items()})

    def index(self, orderkey, linenumber):
        return (orderkey - 1) * 4 + linenumber.astype(np.int64) - 1

    def append(self, table):
        for n, c in zip(table.names, table.columns):
            self.cols[n] = np.concatenate([self.cols[n], c.data])
        for n, (u, i) in self.codes.items():
            vals = self.cols[n][len(i):].astype(str)
            new = np.searchsorted(u, vals)
            if (new >= len(u)).any() or (u[np.minimum(new, len(u) - 1)]
                                         != vals).any():
                fail(f"LakeState: a new {n} value outside {list(u)}")
            self.codes[n] = (u, np.concatenate([i, new]))
        self.alive = np.concatenate(
            [self.alive, np.ones(table.num_rows, dtype=bool)])

    def merge(self, src):
        """MERGE ... WHEN MATCHED UPDATE (quantity, price) WHEN NOT
        MATCHED INSERT: returns (matched, inserted)."""
        by = dict(zip(src.names, src.columns))
        idx = self.index(by["l_orderkey"].data, by["l_linenumber"].data)
        hit = (idx < self.n0)
        hit[hit] = self.alive[idx[hit]]
        for n in ("l_quantity", "l_extendedprice"):
            self.cols[n][idx[hit]] = by[n].data[hit]
        keep = ~hit
        from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
        self.append(HostTable(src.names, [
            HostColumn(c.dtype, c.data[keep]) for c in src.columns]))
        return int(hit.sum()), int(keep.sum())


def lake_lineitem(table, seed: int):
    """Phase 4's lineitem with the keys the DML needs: l_orderkey (four
    lines an order), l_linenumber and l_partkey (TPC-H SF 1's 200,000
    parts, from its own seed stream)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    n = table.num_rows
    rng = np.random.default_rng(seed + 24)
    i = np.arange(n, dtype=np.int64)
    extra = [("l_orderkey", HostColumn(T.LONG, i // 4 + 1)),
             ("l_linenumber", HostColumn(T.INT,
                                         (i % 4 + 1).astype(np.int32))),
             ("l_partkey", HostColumn(T.LONG, rng.integers(1, 200_001, n)))]
    return HostTable(list(table.names) + [e[0] for e in extra],
                     list(table.columns) + [e[1] for e in extra])


def lake_slices(table, k: int):
    n = table.num_rows
    per = -(-n // k)
    return [table.slice(i * per, min(per, n - i * per)) for i in range(k)]


def merge_source(table, state: LakeState, region, seed: int):
    """LAKE_MERGE_ROWS source rows keyed (l_orderkey, l_linenumber): half
    the original rows of ``region`` (a row range; quantity and price
    changed), half new keys past every key of the table."""
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    rng = np.random.default_rng(seed)
    half = LAKE_MERGE_ROWS // 2
    hit = np.sort(rng.choice(np.arange(*region), half, replace=False))
    new_rows = rng.integers(0, table.num_rows, LAKE_MERGE_ROWS - half)
    rows = np.concatenate([hit, new_rows])
    cols = {n: c.data[rows] for n, c in zip(table.names, table.columns)}
    cols["l_quantity"] = cols["l_quantity"] + 1.0
    cols["l_extendedprice"] = (cols["l_extendedprice"] * 1.01).round(2)
    top = int(state.cols["l_orderkey"].max())
    j = np.arange(LAKE_MERGE_ROWS - half, dtype=np.int64)
    cols["l_orderkey"][half:] = top + 1 + j // 4
    cols["l_linenumber"][half:] = (j % 4 + 1).astype(np.int32)
    return HostTable(table.names, [HostColumn(c.dtype, cols[n])
                                   for n, c in zip(table.names,
                                                   table.columns)])


def by_key(table):
    """``table``'s columns in (l_orderkey, l_linenumber) order."""
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    by = dict(zip(table.names, table.columns))
    order = np.lexsort((by["l_linenumber"].data, by["l_orderkey"].data))
    return HostTable(table.names, [HostColumn(c.dtype, c.data[order],
                                              c.validity[order])
                                   for c in table.columns])


def lake_count(session, path: str) -> int:
    """The Delta table's rows through a COUNT on the card (no column
    decoded: the files' footers and deletion vectors)."""
    from spark_rapids_tpu_torch import functions as F
    got = session.read_delta(path).agg(F.count().alias("n")).collect_table()
    return int(got.columns[0].data[0])


def lake_q1(session, df, oracle, what: str, warm: bool = True) -> dict:
    """q1 over ``df`` against the oracle, cold then (``warm``) warm; its
    ms, host syncs (of the warm run, else of the cold) and launches."""
    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    before = K.launch_counts()
    times = []
    for _ in range(2 if warm else 1):
        with host_sync_count() as box:
            t0 = time.perf_counter()
            got = q1_dataframe(session, df).collect_table()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        check_q1_result(got, oracle)
    after = K.launch_counts()
    return {"what": what, "cold_ms": round(times[0], 1),
            "warm_ms": round(times[-1], 1) if warm else None,
            "syncs": box["syncs"],
            "launches": {k: after[k] - before[k] for k in after
                         if after[k] - before[k]}, "result": got}


def lake_d1(session, li, base: str, card: str, res: dict):
    """D1: the Delta table of lineitem, q1 over it, DELETE, UPDATE and
    two MERGEs, each checked. Returns (path, state, the change counts)."""
    from spark_rapids_tpu_torch.columnar.table import concat_host
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe
    from spark_rapids_tpu_torch.ops.expr import col, lit
    from spark_rapids_tpu_torch.plan import from_host_table
    path = os.path.join(base, "delta_lineitem")
    slices = lake_slices(li, LAKE_FILES)
    t0 = time.perf_counter()
    for i, part in enumerate(slices):
        v = from_host_table(part, session).write_delta(
            path, mode="append" if i else "error")
        if v != i:
            fail(f"D1: write {i} committed version {v}")
    write_s = time.perf_counter() - t0
    state = LakeState(li)
    oracle = state.q1()
    q1 = lake_q1(session, session.read_delta(path), oracle, "D1 q1")
    # bit for bit: q1 over the Delta scan against q1 in memory over the
    # same rows in the scan's order (its files sorted by path: version
    # i's file holds slice i)
    files = [json.loads(line)["add"]["path"]
             for v in range(LAKE_FILES)
             for line in open(os.path.join(path, "_delta_log",
                                           f"{v:020d}.json"))
             if '"add"' in line]
    in_order = concat_host([slices[i] for i in sorted(
        range(LAKE_FILES), key=lambda i: files[i])])
    mem = q1_dataframe(session, in_order).collect_table()
    same_host_table(q1["result"], mem, "D1 q1 (Delta vs in memory)")
    log(f"  D1 wrote {li.num_rows} rows in {LAKE_FILES} files (versions "
        f"0-{LAKE_FILES - 1}) in {write_s:.1f} s; q1 cold "
        f"{q1['cold_ms']} ms, warm {q1['warm_ms']} ms ({q1['syncs']} host "
        f"syncs), bit for bit q1 in memory over the scan's rows "
        f"[{card}]")
    res["D1"] = {"write_s": round(write_s, 2), "q1": {
        k: v for k, v in q1.items() if k != "result"}}
    dt = session.delta_table(path)
    dt.set_properties({"delta.enableChangeDataFeed": "true"})
    v0 = by_key(slices[0])

    def after(name, t_op, expect_rows):
        n = lake_count(session, path)
        if n != expect_rows:
            fail(f"D1 {name}: {n} rows, want {expect_rows}")
        q = lake_q1(session, session.read_delta(path),
                    state.q1(), f"D1 q1 after {name}",
                    warm=False)
        same_host_table(by_key(session.read_delta(
            path, version_as_of=0).collect_table()), v0,
            f"D1 time travel to version 0 after {name}")
        log(f"  D1 {name}: {t_op:.2f} s (host), {n} rows, q1 "
            f"{q['cold_ms']} ms ({q['syncs']} syncs, launches "
            f"{q['launches']}), version 0 as written")
        res[f"D1 {name}"] = {"s": round(t_op, 2), "rows": n,
                             "q1": {k: v for k, v in q.items()
                                    if k != "result"}}

    t0 = time.perf_counter()
    r = dt.delete(col("l_partkey") < lit(LAKE_DELETE_PARTKEY))
    took = time.perf_counter() - t0
    dead = state.alive & (state.cols["l_partkey"] < LAKE_DELETE_PARTKEY)
    state.alive &= ~dead
    if r["num_affected_rows"] != int(dead.sum()):
        fail(f"D1 DELETE: {r} for {int(dead.sum())} rows")
    dvs = sum(1 for f in dt.log.snapshot().files if f.deletion_vector)
    if dvs != LAKE_FILES:
        fail(f"D1 DELETE: {dvs} files with a DV, want {LAKE_FILES}")
    after("DELETE", took, int(state.alive.sum()))
    counts = {"delete": int(dead.sum())}

    t0 = time.perf_counter()
    r = dt.update(col("l_orderkey") <= lit(LAKE_UPDATE_ORDERS),
                  {"l_tax": lit(0.0)})
    took = time.perf_counter() - t0
    hit = state.alive & (state.cols["l_orderkey"] <= LAKE_UPDATE_ORDERS)
    state.cols["l_tax"] = np.where(hit, 0.0, state.cols["l_tax"])
    if r["num_affected_rows"] != int(hit.sum()):
        fail(f"D1 UPDATE: {r} for {int(hit.sum())} rows")
    after("UPDATE", took, int(state.alive.sum()))
    counts["update"] = int(hit.sum())

    per = -(-li.num_rows // LAKE_FILES)
    for name, region, low in (("MERGE low-shuffle", (2 * per, 3 * per),
                               "true"),
                              ("MERGE full rewrite", (5 * per, 6 * per),
                               "false")):
        src = merge_source(li, state, region, seed=len(name))
        msession = type(session)({
            "spark.rapids.sql.delta.lowShuffleMerge.enabled": low})
        mdt = msession.delta_table(path)
        t0 = time.perf_counter()
        r = (mdt.merge(from_host_table(src, msession),
                       ["l_orderkey", "l_linenumber"])
             .when_matched_update(set={"l_quantity": "l_quantity",
                                       "l_extendedprice": "l_extendedprice"})
             .when_not_matched_insert().execute())
        took = time.perf_counter() - t0
        matched, inserted = state.merge(src)
        if (r["num_matched_rows"], r["num_inserted_rows"],
                r["low_shuffle"]) != (matched, inserted, low == "true"):
            fail(f"D1 {name}: {r}, want {matched} matched, {inserted} "
                 "inserted")
        after(name, took, int(state.alive.sum()))
        res[f"D1 {name}"]["merge"] = r
        counts["update"] += matched
        counts["insert"] = counts.get("insert", 0) + inserted
    return path, state, counts


def lake_d2(session, path, state, counts, li, base: str, res: dict):
    """D2: OPTIMIZE ZORDER, the checkpoint's replay, the change feed,
    a rename under column mapping, VACUUM, and a lost commit race."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    from spark_rapids_tpu_torch.delta.log import DeltaLog
    from spark_rapids_tpu_torch.ops.expr import col, lit
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.runtime.faults import FAULTS
    from spark_rapids_tpu_torch.session import TorchSession
    dt = session.delta_table(path)
    t0 = time.perf_counter()
    r = dt.optimize(zorder_by=["l_shipdate", "l_partkey"])
    took = time.perf_counter() - t0
    snap = dt.log.snapshot()
    if r["files_added"] != 1 or len(snap.files) != 1:
        fail(f"D2 OPTIMIZE ZORDER: {r}, {len(snap.files)} live files")
    q = lake_q1(session, session.read_delta(path), state.q1(),
                "D2 q1 after OPTIMIZE", warm=False)
    log(f"  D2 OPTIMIZE ZORDER BY (l_shipdate, l_partkey): {r} in "
        f"{took:.2f} s (host); q1 {q['cold_ms']} ms")
    res["D2 OPTIMIZE"] = {"s": round(took, 2), "q1": {
        k: v for k, v in q.items() if k != "result"}}

    # the checkpoint written at version 10, and a fresh log's replay from
    # it against a replay of every commit file
    log_dir = os.path.join(path, "_delta_log")
    cp = DeltaLog(path)._last_checkpoint()
    if not cp or cp["version"] != 10 or not os.path.exists(os.path.join(
            log_dir, f"{10:020d}.checkpoint.parquet")):
        fail(f"D2: no checkpoint at version 10 ({cp})")
    t0 = time.perf_counter()
    from_cp = DeltaLog(path).snapshot()
    cp_ms = (time.perf_counter() - t0) * 1e3
    os.rename(os.path.join(log_dir, "_last_checkpoint"),
              os.path.join(base, "_last_checkpoint"))
    t0 = time.perf_counter()
    full = DeltaLog(path).snapshot()
    full_ms = (time.perf_counter() - t0) * 1e3
    full10 = DeltaLog(path).snapshot(10)
    os.rename(os.path.join(base, "_last_checkpoint"),
              os.path.join(log_dir, "_last_checkpoint"))

    def files(adds):
        return sorted((a.path, json.dumps(a.partition_values, sort_keys=True),
                       a.size, a.stats,
                       json.dumps(a.deletion_vector, sort_keys=True))
                      for a in adds)
    if files(from_cp.files) != files(full.files) or \
            from_cp.metadata.schema_json != full.metadata.schema_json:
        fail("D2: the replay from the checkpoint differs from the full one")
    # the checkpoint file itself, read by the record codec (a replay falls
    # back to the commit files when it cannot read it): version 10's
    # files, their stats and DVs, and the schema, as the commit files give
    # them
    cp_meta, cp_adds = DeltaLog(path)._read_checkpoint(10)
    if files(cp_adds.values()) != files(full10.files) or \
            cp_meta.schema_json != full10.metadata.schema_json or \
            cp_meta.configuration != full10.metadata.configuration:
        fail("D2: the checkpoint's actions differ from a replay of "
             "versions 0-10")
    log(f"  D2 checkpoint at version 10: its {len(cp_adds)} add actions and "
        f"metadata equal a replay of versions 0-10; a fresh DeltaLog "
        f"replays from it in {cp_ms:.1f} ms (every commit file: "
        f"{full_ms:.1f} ms), same snapshot")

    # the change feed over the DML versions (9 DELETE .. 12 MERGE)
    t0 = time.perf_counter()
    feed = dt.table_changes(9, 12)
    got = feed.group_by("_change_type").agg(F.count().alias("n")) \
        .collect_table()
    took = time.perf_counter() - t0
    by = dict(zip(got.columns[0].to_pylist(), got.columns[1].to_pylist()))
    want = {"delete": counts["delete"], "update_preimage": counts["update"],
            "update_postimage": counts["update"], "insert": counts["insert"]}
    if by != want:
        fail(f"D2 table_changes(9, 12): {by}, want {want}")
    log(f"  D2 table_changes(9, 12): {by} in {took:.2f} s")
    res["D2 CDF"] = {"s": round(took, 2), "changes": by}

    # rename under column mapping: no file rewritten, q1 reads the new name
    before = sorted(a.path for a in dt.log.snapshot().files)
    dt.rename_column("l_tax", "l_taxrate")
    m = dt.log.snapshot().metadata
    if m.column_mapping_mode() != "name" or \
            m.physical_names()["l_taxrate"] != "l_tax" or \
            sorted(a.path for a in dt.log.snapshot().files) != before:
        fail("D2 rename_column: mapping or files")
    renamed = session.read_delta(path)
    df = renamed.select(*[col(n).alias("l_tax") if n == "l_taxrate"
                          else col(n) for n, _ in renamed.schema])
    q = lake_q1(session, df, state.q1(), "D2 q1 after rename",
                warm=False)
    log(f"  D2 rename_column l_tax -> l_taxrate (mode name, no file "
        f"rewritten); q1 {q['cold_ms']} ms")

    # VACUUM: dry run, then real; q1 still answers
    t0 = time.perf_counter()
    dry = dt.vacuum(dry_run=True)
    real = dt.vacuum()
    took = time.perf_counter() - t0
    if not dry["orphans"] or real["files_deleted"] != len(dry["orphans"]):
        fail(f"D2 VACUUM: dry {len(dry['orphans'])}, real {real}")
    lake_q1(session, df, state.q1(), "D2 q1 after VACUUM",
            warm=False)
    log(f"  D2 VACUUM: dry run lists {len(dry['orphans'])} orphans, the real "
        f"one deletes {real['files_deleted']} ({took:.2f} s); q1 as before")
    res["D2 VACUUM"] = {"orphans": len(dry["orphans"]),
                        "deleted": real["files_deleted"]}

    # one injected lost race: the append rebases and retries once, and
    # the next record on the thread carries commitRetries 1
    ev = os.path.join(base, "race_events")
    race = TorchSession({"spark.rapids.test.faults":
                         "delta.commit.race:race:1",
                         "spark.rapids.sql.eventLog.enabled": "true",
                         "spark.rapids.sql.eventLog.dir": ev})
    rows = li.slice(0, LAKE_RACE_ROWS)
    top = int(state.cols["l_orderkey"].max())
    # the appended rows get new keys, and the table's renamed column
    extra = from_host_table(rows, race).select(
        *[(col(n) + lit(top)).alias(n) if n == "l_orderkey" else
          col(n).alias("l_taxrate") if n == "l_tax" else col(n)
          for n in rows.names])
    try:
        v = extra.write_delta(path, mode="append")
        n = lake_count(race, path)
        rec = race.last_event_record
    finally:
        FAULTS.disarm()
    if v != 15 or rec is None or rec["commitRetries"] != 1:
        fail(f"D2 race: version {v} (want 15), record "
             f"{rec and rec['commitRetries']}")
    state.append(HostTable(rows.names, [
        HostColumn(c.dtype, c.data + top if nm == "l_orderkey" else c.data)
        for nm, c in zip(rows.names, rows.columns)]))
    if n != int(state.alive.sum()):
        fail(f"D2 race: {n} rows, want {int(state.alive.sum())}")
    log(f"  D2 an injected delta.commit.race: the append committed version "
        f"{v} after one retry; commitRetries {rec['commitRetries']} in the "
        f"event record, {n} rows")
    res["D2 race"] = {"version": v, "commitRetries": rec["commitRetries"]}


# -- Iceberg, written by this script (the reference writes no Iceberg) ------------

ICEBERG_MANIFEST = {
    "type": "record", "name": "manifest_entry", "fields": [
        {"name": "status", "type": "int"},
        {"name": "sequence_number", "type": ["null", "long"]},
        {"name": "data_file", "type": {
            "type": "record", "name": "r2", "fields": [
                {"name": "content", "type": "int"},
                {"name": "file_path", "type": "string"},
                {"name": "file_format", "type": "string"},
                {"name": "record_count", "type": "long"},
                {"name": "file_size_in_bytes", "type": "long"},
                {"name": "equality_ids",
                 "type": ["null", {"type": "array", "items": "int"}]}]}}]}
ICEBERG_MANIFEST_LIST = {
    "type": "record", "name": "manifest_file", "fields": [
        {"name": "manifest_path", "type": "string"},
        {"name": "manifest_length", "type": "long"},
        {"name": "content", "type": "int"}]}
ICEBERG_TYPES = {"bigint": "long", "int": "int", "double": "double",
                 "string": "string", "date": "date"}


def _zz(n: int) -> bytes:
    """Avro's zigzag varint."""
    u = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        out.append(b | 0x80 if u else b)
        if not u:
            return bytes(out)


def _avro_value(schema, v, out: bytearray) -> None:
    if isinstance(schema, list):  # ["null", T]
        if v is None:
            out += _zz(schema.index("null"))
            return
        i = next(k for k, b in enumerate(schema) if b != "null")
        out += _zz(i)
        _avro_value(schema[i], v, out)
    elif isinstance(schema, dict) and schema["type"] == "record":
        for f in schema["fields"]:
            _avro_value(f["type"], v[f["name"]], out)
    elif isinstance(schema, dict) and schema["type"] == "array":
        if v:
            out += _zz(len(v))
            for x in v:
                _avro_value(schema["items"], x, out)
        out += _zz(0)
    elif schema in ("int", "long"):
        out += _zz(int(v))
    elif schema == "string":
        b = v.encode("utf-8")
        out += _zz(len(b)) + b
    else:
        raise ValueError(f"no encoder for avro type {schema!r}")


def avro_container(path: str, schema: dict, rows) -> None:
    """A minimal Avro object container (null codec, one block): the
    Iceberg fixture's manifests (a test fixture, not a port feature)."""
    sync = b"iceberg-fixture!"
    out = bytearray(b"Obj\x01")
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": b"null"}
    out += _zz(len(meta))
    for k, v in meta.items():
        out += _zz(len(k)) + k.encode() + _zz(len(v)) + v
    out += _zz(0) + sync
    body = bytearray()
    for r in rows:
        _avro_value(schema, r, body)
    out += _zz(len(rows)) + _zz(len(body)) + body + sync
    with open(path, "wb") as f:
        f.write(bytes(out))


def iceberg_entry(path: str, content: int, rows: int, seq: int,
                  equality_ids=None) -> dict:
    return {"status": 1, "sequence_number": seq, "data_file": {
        "content": content, "file_path": path, "file_format": "PARQUET",
        "record_count": rows, "file_size_in_bytes": os.path.getsize(path),
        "equality_ids": equality_ids}}


def write_iceberg(path: str, schema, snapshots) -> None:
    """An Iceberg v2 table at ``path``: ``schema`` [(name, type name)],
    ``snapshots`` a list of (snapshot id, manifest entries); one manifest
    and one manifest list a snapshot, the last snapshot current."""
    mdir = os.path.join(path, "metadata")
    os.makedirs(mdir, exist_ok=True)
    snaps = []
    for sid, entries in snapshots:
        manifest = os.path.join(mdir, f"manifest-{sid}.avro")
        avro_container(manifest, ICEBERG_MANIFEST, entries)
        mlist = os.path.join(mdir, f"snap-{sid}.avro")
        avro_container(mlist, ICEBERG_MANIFEST_LIST, [{
            "manifest_path": manifest,
            "manifest_length": os.path.getsize(manifest), "content": 0}])
        snaps.append({"snapshot-id": sid, "manifest-list": mlist,
                      "timestamp-ms": 0})
    fields = [{"id": i + 1, "name": n, "required": False,
               "type": ICEBERG_TYPES[t]} for i, (n, t) in enumerate(schema)]
    meta = {"format-version": 2, "table-uuid": "chip-smoke-iceberg",
            "location": path,
            "schemas": [{"schema-id": 0, "type": "struct",
                         "fields": fields}],
            "current-schema-id": 0,
            "partition-specs": [{"spec-id": 0, "fields": []}],
            "default-spec-id": 0,
            "current-snapshot-id": snapshots[-1][0], "snapshots": snaps}
    with open(os.path.join(mdir, "v1.metadata.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(mdir, "version-hint.text"), "w") as f:
        f.write("1")


def iceberg_lineitem(li, base: str, parts: int = LAKE_FILES) -> dict:
    """I1's table: ``li`` in ``parts`` data files through the port's
    Parquet writer; snapshot 1 holds them, snapshot 2 adds 1% positional
    deletes (every 100th row of each file, sequence 4: all files) and an
    equality delete of l_returnflag 'R' at sequence 2, which applies to
    the first file only (sequence 1; the others are at 3). Returns the
    path and each snapshot's expected rows (a keep mask over ``li``)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    from spark_rapids_tpu_torch.io import parquet_format as PF
    path = os.path.join(base, "iceberg_lineitem")
    os.makedirs(os.path.join(path, "data"), exist_ok=True)
    data, pos_paths, pos_rows = [], [], []
    keep = np.ones(li.num_rows, dtype=bool)
    start = 0
    rf = dict(zip(li.names, li.columns))["l_returnflag"].data
    for i, part in enumerate(lake_slices(li, parts)):
        p = os.path.join(path, "data", f"part-{i:03d}.parquet")
        PF.write_table(part, p)
        data.append(iceberg_entry(p, 0, part.num_rows, 1 if i == 0 else 3))
        pos = np.arange(0, part.num_rows, 100, dtype=np.int64)
        pos_paths += [p] * len(pos)
        pos_rows.append(pos)
        keep[start + pos] = False
        if i == 0:
            keep[start:start + part.num_rows] &= \
                rf[start:start + part.num_rows] != "R"
        start += part.num_rows
    pos_rows = np.concatenate(pos_rows)
    dp = os.path.join(path, "data", "pos-deletes.parquet")
    PF.write_table(HostTable(["file_path", "pos"], [
        HostColumn(T.STRING, np.array(pos_paths, dtype=object)),
        HostColumn(T.LONG, pos_rows)]), dp)
    ep = os.path.join(path, "data", "eq-deletes.parquet")
    PF.write_table(HostTable(["l_returnflag"], [
        HostColumn(T.STRING, np.array(["R"], dtype=object))]), ep)
    schema = [(n, c.dtype.simple_string())
              for n, c in zip(li.names, li.columns)]
    rf_id = 1 + list(li.names).index("l_returnflag")
    write_iceberg(path, schema, [
        (1, data),
        (2, data + [iceberg_entry(dp, 1, len(pos_rows), 4),
                    iceberg_entry(ep, 2, 1, 2, [rf_id])])])
    return {"path": path, "keep": {1: np.ones(li.num_rows, dtype=bool),
                                   2: keep}}


def lake_i1(session, li, state: LakeState, base: str, res: dict) -> None:
    """I1 over ``li``; ``state``'s codes of its first rows are li's."""
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    t0 = time.perf_counter()
    ice = iceberg_lineitem(li, base)
    write_s = time.perf_counter() - t0
    for sid in (1, 2):
        rows = np.flatnonzero(ice["keep"][sid])
        want = HostTable(li.names, [HostColumn(c.dtype, c.data[rows])
                                    for c in li.columns])
        codes = {n: (u, i[:state.n0][rows])
                 for n, (u, i) in state.codes.items()}
        df = session.read_iceberg(ice["path"], snapshot_id=sid)
        n = df.count()
        if n != want.num_rows:
            fail(f"I1 snapshot {sid}: {n} rows, want {want.num_rows}")
        q = lake_q1(session, df, q1_oracle(want, codes),
                    f"I1 q1 at snapshot {sid}",
                    warm=sid == 2)
        log(f"  I1 snapshot {sid}: {n} rows; q1 cold {q['cold_ms']} ms warm "
            f"{q['warm_ms']} ms ({q['syncs']} syncs, launches "
            f"{q['launches']})")
        res[f"I1 snapshot {sid}"] = {"rows": n, "q1": {
            k: v for k, v in q.items() if k != "result"}}
    log(f"  I1 wrote the table (8 data files, a positional and an equality "
        f"delete file, two snapshots, manifests in Avro) in {write_s:.1f} s")


# -- S1 and M1: a stream into a Delta sink, and views over it ----------------------

def stream_files(li, base: str) -> str:
    """S1's input: ``li`` as STREAM_FILES Parquet files (the port's
    writer)."""
    from spark_rapids_tpu_torch.io import parquet_format as PF
    d = os.path.join(base, "stream_in")
    os.makedirs(d, exist_ok=True)
    for i, part in enumerate(lake_slices(li, STREAM_FILES)):
        PF.write_table(part, os.path.join(d, f"part-{i:03d}.parquet"))
    return d


def stream_transform(df):
    """S1's micro-batch: a filter (every row passes) and a projection on
    the card."""
    from spark_rapids_tpu_torch.ops.expr import col, lit
    return df.filter(col("l_quantity") > lit(0.0)).select(
        "l_orderkey", "l_linenumber", "l_quantity", "l_extendedprice",
        "l_discount", "l_returnflag", "l_linestatus", "l_shipdate")


def stream_query(svc, d: str, sink: str, ck: str, name: str):
    from spark_rapids_tpu_torch.streaming import (
        DeltaStreamSink,
        FileWatchSource,
        StreamingQuery,
    )
    return StreamingQuery(
        svc, FileWatchSource(os.path.join(d), svc.session.conf,
                             max_files_per_trigger=STREAM_PER_TRIGGER),
        DeltaStreamSink(sink, name), ck, name=name,
        transform=stream_transform)


def stream_child(d: str) -> int:
    """S1's child: the stream over ``d/in`` into ``d/sink``; inside the
    commit of batch STREAM_KILL_BATCH (its data in the log, its commit
    marker not yet written) it prints a line and stops, for the parent to
    kill it."""
    from spark_rapids_tpu_torch.plan.fingerprint import (
        delta_table_id,
        register_epoch_listener,
    )
    from spark_rapids_tpu_torch.service import QueryService
    sink = os.path.join(d, "sink")
    svc = QueryService({"spark.rapids.service.maxConcurrentQueries": "1"})
    seen = {"n": 0}

    def stop_in_commit(table_id, epoch, reason):
        if table_id == delta_table_id(sink):
            seen["n"] += 1
            if seen["n"] == STREAM_KILL_BATCH + 1:
                print("SINK-COMMITTED", flush=True)
                time.sleep(600)

    register_epoch_listener(stop_in_commit)
    q = stream_query(svc, os.path.join(d, "in"), sink,
                     os.path.join(d, "ck"), "s1")
    q.process_available()
    print("STREAM-ENDED", flush=True)
    return 2


def canonical(t):
    """``t``'s rows sorted by every column (strings by rank, floats by
    their bits, nulls first), for a bit for bit comparison of two tables
    of one row multiset (``same_host_table``)."""
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    keys = []
    for c in t.columns:
        v = c.validity
        if c.data.dtype == object:
            _, k = np.unique(np.where(v, c.data, "").astype(str),
                             return_inverse=True)
        else:
            k = np.ascontiguousarray(c.data).view(
                {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[
                    c.data.dtype.itemsize])
        keys += [np.where(v, k.reshape(-1), 0), v]
    order = np.lexsort(keys[::-1]) if keys else np.zeros(0, np.int64)
    return HostTable(t.names, [HostColumn(c.dtype, c.data[order],
                                          c.validity[order])
                               for c in t.columns])


def lake_s1_m1(li, d1_path: str, base: str, res: dict) -> None:
    """S1 (a file-watch stream into a Delta sink through a one-worker
    service, once clean with two views maintained after every commit,
    once killed in a child process and resumed) and M1."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    from spark_rapids_tpu_torch.ops.expr import col, lit
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.service import QueryService
    from spark_rapids_tpu_torch.service.introspect import _routes
    from spark_rapids_tpu_torch.streaming import STREAM_METRICS
    li = li.slice(0, min(li.num_rows, STREAM_ROWS))
    t0 = time.perf_counter()
    src_dir = stream_files(li, base)
    write_s = time.perf_counter() - t0
    svc = QueryService({"spark.rapids.service.maxConcurrentQueries": "1"})
    s = svc.session
    try:
        sink = os.path.join(base, "sink")
        # the sink exists (empty, CDF on) before the views register
        empty = stream_transform(from_host_table(li.slice(0, 0), s))
        empty.write_delta(sink)
        s.delta_table(sink).set_properties(
            {"delta.enableChangeDataFeed": "true"})
        reg = svc.mv_registry()
        sdf = s.read_delta(sink)
        agg = reg.register("flags", sdf.group_by(
            "l_returnflag", "l_linestatus").agg(
            F.sum(col("l_quantity")).alias("sum_qty"),
            F.count().alias("n"), F.max(col("l_shipdate")).alias("max_ship")))
        app = reg.register("discounted", sdf.filter(
            col("l_discount") > lit(0.05)).select(
            "l_orderkey", "l_linenumber", "l_extendedprice"))
        q = stream_query(svc, src_dir, sink, os.path.join(base, "ck"), "s1")
        svc.register_stream(q)
        listed = [st["name"] for st in _routes(svc, "/streams",
                                               {})["streams"]]
        if listed != ["s1"]:
            fail(f"S1: /streams lists {listed}")
        t0 = time.perf_counter()
        batches, mv_ms = 0, []
        while q.run_one_batch():
            batches += 1
            for mv in (agg, app):
                t1 = time.perf_counter()
                got = mv.read()
                mv_ms.append((time.perf_counter() - t1) * 1e3)
                same_host_table(canonical(got),
                                canonical(mv.recompute_at_epoch()),
                                f"M1 {mv.name} at epoch {mv.epoch()} "
                                "against its recompute")
        took = time.perf_counter() - t0
        want_b = STREAM_FILES // STREAM_PER_TRIGGER
        clean = s.read_delta(sink).collect_table()
        if batches != want_b or clean.num_rows != li.num_rows:
            fail(f"S1: {batches} batches, {clean.num_rows} rows")
        # exactly once: the sink holds the input's rows through the
        # batch's filter and projection, done here in numpy
        by = dict(zip(li.names, li.columns))
        keep = by["l_quantity"].validity & (by["l_quantity"].data > 0.0)
        fed = HostTable(clean.names, [
            HostColumn(by[n].dtype, by[n].data[keep], by[n].validity[keep])
            for n in clean.names])
        same_host_table(by_key(clean), by_key(fed),
                        "S1 the clean run's sink against its input rows")
        modes = {mv.name: (mv.strategy, mv.incremental_refreshes,
                           mv.full_recomputes) for mv in (agg, app)}
        if modes != {"flags": ("reaggregate", want_b, 1),
                     "discounted": ("append", want_b, 1)}:
            fail(f"M1: {modes}")
        for mv in (agg, app):
            if f"strategy={mv.strategy}" not in mv.explain():
                fail(f"M1 {mv.name}: explain() {mv.explain()}")
        log(f"  S1 {want_b} micro-batches of {STREAM_PER_TRIGGER} files "
            f"({STREAM_FILES} files of {-(-li.num_rows // STREAM_FILES)} "
            f"rows written in "
            f"{write_s:.1f} s) through a one-worker QueryService into the "
            f"Delta sink in {took:.1f} s, /streams {listed}; M1 after every "
            f"commit: {modes} bit for bit against recompute_at_epoch() "
            f"(refresh and serve {statistics.median(mv_ms):.1f} ms median)")
        res["S1"] = {"batches": batches, "s": round(took, 2),
                     "write_s": round(write_s, 2)}
        res["M1"] = {"modes": modes,
                     "serve_ms": round(statistics.median(mv_ms), 1)}

        # a commit to D1's table leaves the cached result over the sink
        over_sink = s.read_delta(sink).group_by("l_returnflag").agg(
            F.count().alias("n"))
        svc.submit(over_sink).result(timeout=600)
        h0 = svc.result_cache.stats()["hits"]
        s.delta_table(d1_path).set_properties({"chip_smoke": "cache"})
        svc.submit(over_sink).result(timeout=600)
        if svc.result_cache.stats()["hits"] != h0 + 1:
            fail("M1: a commit to D1's table evicted the result over the "
                 "sink")
        log("  M1 a commit to D1's table left the cached result over S1's "
            "sink in the service's cache (one more hit)")

        # the same stream in a child process, killed inside the commit of
        # batch STREAM_KILL_BATCH, then resumed here
        cd = os.path.join(base, "stream_child")
        os.makedirs(cd)
        os.symlink(src_dir, os.path.join(cd, "in"))
        t0 = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--stream-child",
             cd], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        line = child.stdout.readline().strip()
        child.kill()
        _, err = child.communicate(timeout=120)
        if line != "SINK-COMMITTED":
            fail(f"S1: the child printed {line!r}; stderr {err[-3000:]}")
        replays = STREAM_METRICS.get("sinkReplays", 0)
        rq = stream_query(svc, src_dir, os.path.join(cd, "sink"),
                          os.path.join(cd, "ck"), "s1")
        resumed = rq.process_available()
        s.next_query_tag = "after-resume"
        killed = s.read_delta(os.path.join(cd, "sink")).collect_table()
        got_replays = STREAM_METRICS.get("sinkReplays", 0) - replays
        took = time.perf_counter() - t0
        if resumed != want_b - STREAM_KILL_BATCH or got_replays != 1:
            fail(f"S1 resume: {resumed} batches, sinkReplays {got_replays}")
        same_host_table(by_key(killed), by_key(fed),
                        "S1 the resumed sink against its input rows")
        log(f"  S1 a child killed inside batch {STREAM_KILL_BATCH}'s commit; "
            f"resumed here: {resumed} batches (the first replayed through "
            f"the txn watermark: sinkReplays {got_replays}), the sink's "
            f"{killed.num_rows} rows equal the clean run's ({took:.1f} s "
            "with the child)")
        res["S1 kill"] = {"resumed": resumed, "sinkReplays": got_replays,
                          "s": round(took, 2)}
    finally:
        svc.shutdown()


def run_lakehouse(table, seed: int) -> dict:
    """Phase 24 (D1, D2, I1, S1, M1) over phase 4's lineitem: returns the
    phase's launches, every one held against its kernel's plain version."""
    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.session import TorchSession
    t_phase = time.perf_counter()
    card = card_line()
    base = tempfile.mkdtemp(prefix="srt-lake-")
    li = lake_lineitem(table, seed)
    converted = CPU_ROUTE["converted"]
    res = {}
    K.reset_launch_counts()
    K.calls = held = HeldCalls()
    try:
        session = TorchSession()
        parts = {}
        t0 = time.perf_counter()
        path, state, counts = lake_d1(session, li, base, card, res)
        parts["D1"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lake_d2(session, path, state, counts, li, base, res)
        parts["D2"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lake_i1(session, li, state, base, res)
        parts["I1"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lake_s1_m1(li, path, base, res)
        parts["S1+M1"] = time.perf_counter() - t0
    finally:
        K.calls = None
        shutil.rmtree(base, ignore_errors=True)
    launches = K.launch_counts()
    if held.bad:
        fail(f"phase 24: launches disagree with their plain versions: "
             f"{held.bad[:8]}")
    for name in ("onehot_partials", "gather_compact", "sort_with_payload",
                 "fused_minmax"):
        if launches[name] < 1:
            fail(f"phase 24 did not launch {name}")
    took = time.perf_counter() - t_phase
    log(f"  phase 24: every launch held against its plain version "
        f"({dict(held.held)}); {CPU_ROUTE['converted'] - converted} plans "
        f"converted with 0 CPU-route nodes; parts "
        f"{ {k: round(v, 1) for k, v in parts.items()} } s")
    summary = {"card": card, "seconds": round(took, 1),
               "launches": {k: v for k, v in launches.items() if v},
               "cells": res}
    if took > LAKE_BUDGET_S:
        log(f"  phase 24 took {took:.1f} s, past its {LAKE_BUDGET_S:.0f} s "
            "aim")
    log("  phase-24 summary: " + json.dumps(summary, default=str))
    return launches


# ---------------------------------------------------------------------------
# phase 25: distribution (X1-X5)
# ---------------------------------------------------------------------------

#: phase 25's aim on the slower card hosts (seconds)
DIST_BUDGET_S = 60.0
DIST_PHASE = ("phase 25: distribution (X1 the host shuffle, MULTITHREADED "
              "with lz4 and P2P over TCP loopback; X2 a logical mesh of 8 "
              "shards on the card; X3 mesh chaos; X4 the cluster of 2 "
              "executor processes over Parquet files; X5 host chaos and a "
              "SIGKILL)")
#: X1's repartition: its partitions (Spark's spark.sql.shuffle.partitions)
X1_PARTITIONS = 200
#: X2's logical devices, all on the one card
MESH_SHARDS = 8
#: X4's corpus queries over the files (q1 and three more), each with the
#: tolerance of its f64 columns against the single-process scan: q3's and
#: q12's sums over many groups are index_add_'s, whose bits vary from run
#: to run on the card (ROADMAP Queue 3, item 1); everything else bitwise
CLUSTER_QUERIES = {"q1": 0.0, "q3": 1e-9, "q8": 0.0, "q12": 1e-9}
#: X4's files a table
CLUSTER_FILES = 4


def _scope(name: str) -> dict:
    from spark_rapids_tpu_torch.obs.metrics import scopes_snapshot
    return dict(scopes_snapshot().get(name, {}))


def _scope_change(before: dict, after: dict) -> dict:
    return {k: round(after[k] - before.get(k, 0), 6) for k in after
            if after[k] != before.get(k, 0)}


def dist_x1(ftables, foracles, res) -> None:
    """X1: over phase 15's tables (FILES_SF), q7 (its device split off, so
    that its 8 partitions take the host shuffle) and lineitem hash
    repartitioned into 200 by l_orderkey then grouped by l_returnflag,
    under MULTITHREADED with lz4 and under P2P over TCP loopback; each
    against its numpy oracle and the single-device result (q7's device
    split; the group-by without the repartition), bit for bit."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.models.corpus import build_queries
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.session import TorchSession
    li = ftables["lineitem"]
    L = host_cols(li)
    oracle = grouped_oracle(L["l_returnflag"], {
        "n": (np.add, np.ones(li.num_rows, dtype=np.int64)),
        "qty": (np.add, L["l_quantity"]),
        "max_price": (np.maximum, L["l_extendedprice"])})

    def rep200(s, partitions=True):
        df = from_host_table(li, s).select(
            "l_orderkey", "l_quantity", "l_extendedprice", "l_returnflag")
        if partitions:
            df = df.repartition(X1_PARTITIONS, "l_orderkey")
        return df.group_by("l_returnflag").agg(
            F.count("l_quantity").alias("n"),
            F.sum("l_quantity").alias("qty"),
            F.max("l_extendedprice").alias("max_price"))
    single = TorchSession()
    want = {"q7": build_queries(single, ftables)["q7"]().collect_table(),
            "rep200": rep200(single, False).collect_table()}
    foracles["q7"](want["q7"])
    check_grouped(want["rep200"], oracle, "X1 group-by (single device)")
    modes = {
        "MULTITHREADED lz4": {
            "spark.rapids.shuffle.compression.codec": "lz4",
            "spark.rapids.shuffle.localDeviceSplit.enabled": "false"},
        "P2P tcp": {"spark.rapids.shuffle.mode": "P2P",
                    "spark.rapids.shuffle.p2p.transport": "tcp"}}
    for mode, conf in modes.items():
        s = TorchSession(conf)
        cases = {"q7": lambda: build_queries(s, ftables)["q7"](),
                 "rep200": lambda: rep200(s)}
        for name, build in cases.items():
            before = _scope("shuffle")
            requests = p2p_requests()
            with host_sync_count() as box:
                t0 = time.perf_counter()
                got = build().collect_table()
                wall = time.perf_counter() - t0
            m, tm = s.last_metrics(), s._exec_sums()
            if name == "q7":
                foracles["q7"](got)
            else:
                check_grouped(got, oracle, f"X1 {name} ({mode})")
            same_table(got, want[name], f"X1 {name} ({mode}) against the "
                       "single-device result", 0.0)
            if not m.get("shuffleMapOutputs"):
                fail(f"X1 {name} ({mode}) did not take the host shuffle")
            sc = _scope_change(before, _scope("shuffle"))
            nparts = X1_PARTITIONS if name == "rep200" else 8
            fetches = (p2p_requests() - requests if mode.startswith("P2P")
                       else m["shuffleMapOutputs"] * nparts)
            stats = {
                "rows": li.num_rows, "partitions": nparts,
                "codec": "lz4" if "lz4" in mode else "none",
                "wall_ms": round(wall * 1e3, 2),
                "bytes_written": m["shuffleBytesWritten"],
                "bytes_read": m["shuffleBytesRead"],
                "map_outputs": m["shuffleMapOutputs"],
                "fetches": fetches,
                "map_downloads": m["shuffleMapDownloads"],
                "download_bytes": m["shuffleDownloadBytes"],
                "host_syncs": box["syncs"],
                "split_download_ms": round(tm.get("shuffleSplitTime", 0.0)
                                           * 1e3, 2),
                "write_ms": round(tm.get("shuffleWriteTime", 0.0) * 1e3, 2),
                "serialize_ms": round(sc.get("serializeTime", 0.0) * 1e3, 2),
                "pack_thread_ms": round(sc.get("packThreadTime", 0.0) * 1e3,
                                        2),
                "codec_thread_ms": round(sc.get("codecThreadTime", 0.0)
                                         * 1e3, 2),
                "read_ms": round(tm.get("shuffleReadTime", 0.0) * 1e3, 2),
                "upload_ms": round(tm.get("shuffleUploadTime", 0.0) * 1e3,
                                   2),
                "coalesced": m.get("aqeCoalescedPartitions", 0)}
            res[f"X1 {name} {mode}"] = stats
            log(f"  X1 {name} ({mode}): equals its numpy oracle and the "
                f"single-device result bit for bit; {json.dumps(stats)}")


def p2p_requests() -> int:
    """Metadata requests every P2P server of the process answered."""
    from spark_rapids_tpu_torch.shuffle import p2p
    return sum(e.server.requests_served for e in p2p._P2P_ENVS.values())


def mesh_cases(s, q1_keep, q3_keep, corpus_keep, tables):
    """{name: (builder, kept single-device result, rtol)} of X2."""
    from spark_rapids_tpu_torch.models.corpus import build_queries
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe, q3_dataframe
    q = build_queries(s, tables)
    q1t, = q1_keep["tables"]
    # q3's f64 revenue sums over its many orders are index_add_'s, whose
    # bits vary from run to run on the card (ROADMAP Queue 3, item 1)
    return {"TPC-H q1": (lambda: q1_dataframe(s, q1t), q1_keep, 0.0),
            "q3 sparse": (lambda: q3_dataframe(s, *q3_keep["tables"]),
                          q3_keep, 1e-9),
            "q7": (q["q7"], corpus_keep["q7"], 0.0),
            "q8": (q["q8"], corpus_keep["q8"], 0.0)}


def dist_x2(q1_keep, q3_keep, corpus_keep, tables, res) -> dict:
    """X2: a mesh of MESH_SHARDS logical devices on the card: q1, sparse q3
    at the default 4 probe attempts, q7 through the all-to-all exchange
    and q8, each cold then warm, against its oracle and the port's own
    single-device result of phases 4-8 (bit for bit, q3's f64 revenue
    within rtol 1e-9); meshHostUploads 0 on every warm run. Returns
    {name: result} for X3."""
    from spark_rapids_tpu_torch.parallel import mesh as PM
    from spark_rapids_tpu_torch.runtime import speculation
    from spark_rapids_tpu_torch.session import TorchSession
    PM.declare_logical_devices(MESH_SHARDS)
    devs = PM.logical_devices()
    log(f"  X2: a LOGICAL mesh of {MESH_SHARDS} shards over "
        f"{PM.physical_count(devs)} physical card(s) "
        f"({sorted({str(d) for d in devs})}): the sharded landing, the "
        "exchange's bucketing and order, the re-land and its checks and "
        "the ladder run on the card, but no copy crosses between two "
        "cards")
    # earlier phases may have put sparse q3's probe on the sort
    speculation.clear_blocklist()
    s = TorchSession({"spark.rapids.mesh.enabled": "true"})
    out = {}
    for name, (build, keep, rtol) in mesh_cases(s, q1_keep, q3_keep,
                                                corpus_keep, tables).items():
        t0 = time.perf_counter()
        cold = build().collect_table()
        cold_ms = (time.perf_counter() - t0) * 1e3
        mc = s.last_metrics()
        before = _scope("mesh")
        t0 = time.perf_counter()
        warm = build().collect_table()
        warm_ms = (time.perf_counter() - t0) * 1e3
        mw = s.last_metrics()
        mesh_w = _scope_change(before, _scope("mesh"))
        for label, got in (("cold", cold), ("warm", warm)):
            keep["check"](got)
            same_table(got, keep["result"], f"X2 {name} ({label}) against "
                       "the single-device result", rtol)
        if mesh_w.get("meshHostUploads", 0):
            fail(f"X2 {name}: {mesh_w['meshHostUploads']} host uploads in "
                 "the mesh's dispatch on the warm run")
        if not mc.get("shardsDispatched"):
            fail(f"X2 {name}: no sharded landing")
        if name == "q7" and not mw.get("iciExchanges"):
            fail("X2 q7 did not take the all-to-all exchange")
        stats = {"cold_ms": round(cold_ms, 2), "warm_ms": round(warm_ms, 2),
                 "single_device_warm_ms": keep.get("warm_ms"),
                 "mesh_warm": mesh_w, "shards": mc.get("shardsDispatched")}
        res[f"X2 {name}"] = stats
        out[name] = (warm, keep, rtol)
        log(f"  X2 {name}: cold and warm equal the single-device result "
            f"({'bit for bit' if not rtol else 'f64 sums rtol 1e-9'}) and "
            f"the oracle; {json.dumps(stats)}")
    return out


def dist_x3(q1_keep, q3_keep, corpus_keep, tables, x2, res) -> None:
    """X3: three device_lost faults at mesh.ici.exchange under q7 walk the
    mesh ladder (retry, a single-device replay, then a shrink to 7
    shards); a corrupt gather under q1 trips the re-land's check and
    re-lands; results equal X2's; the mesh is restored to 8 at the end."""
    from spark_rapids_tpu_torch.parallel import mesh as PM
    from spark_rapids_tpu_torch.runtime import faults as tfaults
    from spark_rapids_tpu_torch.runtime.health import HEALTH
    from spark_rapids_tpu_torch.session import TorchSession
    tfaults.FAULTS.disarm()
    s = TorchSession({"spark.rapids.mesh.enabled": "true",
                      "spark.rapids.test.faults":
                          "mesh.ici.exchange:device_lost:3:15"})
    cases = mesh_cases(s, q1_keep, q3_keep, corpus_keep, tables)
    before = HEALTH.mesh_snapshot()
    t0 = time.perf_counter()
    for _ in range(2):
        got = cases["q7"][0]().collect_table()
        same_table(got, x2["q7"][0], "X3 q7 against X2's", 0.0)
    snap = PM.MESH.health_snapshot()
    ladder = HEALTH.mesh_snapshot()
    if snap["shape"] != str(MESH_SHARDS - 1) or ladder["meshShrinks"] != \
            before["meshShrinks"] + 1:
        fail(f"X3: the mesh ladder did not shrink to "
             f"{MESH_SHARDS - 1}: {snap} {ladder}")
    if "mesh degraded" not in s.explain(cases["q7"][0]()):
        fail("X3: explain does not name the degraded mesh")
    lost_ms = (time.perf_counter() - t0) * 1e3
    tfaults.FAULTS.disarm()
    s2 = TorchSession({"spark.rapids.mesh.enabled": "true",
                       "spark.rapids.test.faults": "mesh.gather:corrupt:1:13"})
    b = _scope("mesh")
    got = mesh_cases(s2, q1_keep, q3_keep, corpus_keep,
                     tables)["TPC-H q1"][0]().collect_table()
    d = _scope_change(b, _scope("mesh"))
    same_table(got, x2["TPC-H q1"][0], "X3 q1 (corrupt gather) against "
               "X2's", 0.0)
    if d.get("gatherChecksFailed") != 1 or d.get("shardRetries") != 1:
        fail(f"X3: the corrupt gather was not caught and re-landed: {d}")
    tfaults.FAULTS.disarm()
    PM.MESH.restore("X3 done")
    s3 = TorchSession({"spark.rapids.mesh.enabled": "true"})
    s3.placement.prepare()
    if PM.MESH.health_snapshot()["shape"] != str(MESH_SHARDS):
        fail("X3: the mesh was not restored")
    res["X3"] = {"ladder": ladder, "shrunk_shape": snap["shape"],
                 "device_lost_ms": round(lost_ms, 2), "corrupt_gather": d}
    log(f"  X3: device_lost x3 at mesh.ici.exchange walked retry, "
        f"single_device and a shrink to {snap['shape']} shards, q7 equal "
        f"to X2's throughout ({lost_ms:.0f} ms); a corrupt gather tripped "
        f"the check and re-landed ({d}); the mesh restored to "
        f"{MESH_SHARDS}; {json.dumps(ladder)}")


def dist_mesh_off() -> None:
    from spark_rapids_tpu_torch.parallel import mesh as PM
    from spark_rapids_tpu_torch.session import TorchSession
    PM.MESH.restore("phase 25 done")
    PM.reset_logical_devices()
    TorchSession().placement.prepare()


def cluster_files(ftables, base: str) -> dict:
    """X4's files: lineitem, orders and customer of phase 15's tables, each
    in CLUSTER_FILES Parquet files; {table: directory}."""
    from spark_rapids_tpu_torch.models.corpus import write_corpus_files
    return write_corpus_files({n: ftables[n] for n in (
        "lineitem", "orders", "customer")}, base, CLUSTER_FILES)


def ping_executor(driver, host: str) -> dict:
    from spark_rapids_tpu_torch.runtime.cluster import _recv_msg, _send_msg
    ch = driver._channel(host)
    with ch.lock:
        _send_msg(ch.sock, {"type": "ping"})
        reply, _ = _recv_msg(ch.sock)
    return reply


def dist_x4_x5(ftables, foracles, base: str, res) -> None:
    """X4: a driver and 2 executor processes (each binds nothing and
    connects to the driver's loopback port; neither may make a CUDA
    context); q1 and three corpus queries over Parquet files scanned by
    host, each equal to the single-process scan of the same files bit for
    bit and to its oracle. X5: device_lost at host.dispatch walks the host
    ladder (retry, re-land on the survivor); then one executor is killed
    (SIGKILL) at its dispatch in the middle of a query: the loss is
    detected (ms), the query converges on the survivor, a respawned
    executor rejoins (s) and the topology is back at full strength.
    Every executor is reaped in the finally."""
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.models.corpus import build_queries
    from spark_rapids_tpu_torch.runtime import faults as tfaults
    from spark_rapids_tpu_torch.runtime.cluster import (
        CLUSTER,
        ClusterDriver,
        host_scan_stats,
        spawn_executor,
    )
    from spark_rapids_tpu_torch.runtime.health import HEALTH
    from spark_rapids_tpu_torch.session import TorchSession
    t0 = time.perf_counter()
    paths = cluster_files(ftables, base)
    write_s = time.perf_counter() - t0
    hb = 200
    cconf = {"spark.rapids.cluster.enabled": "true",
             "spark.rapids.cluster.hosts": "2",
             "spark.rapids.cluster.heartbeatIntervalMs": str(hb),
             "spark.rapids.cluster.missedBeats": "150"}
    driver = ClusterDriver(2, RapidsConf(cconf))
    executors = {}
    try:
        t0 = time.perf_counter()
        for h in ("h0", "h1"):
            executors[h] = spawn_executor(driver.address, h, heartbeat_ms=hb)
        driver.wait_ready(2, timeout_s=120.0)
        spawn_s = time.perf_counter() - t0
        CLUSTER.attach_driver(driver)
        single = TorchSession()
        clus = TorchSession(cconf)
        qs = build_queries(single, ftables, paths=paths)
        cq = build_queries(clus, ftables, paths=paths)
        want, x4 = {}, {}
        for name in CLUSTER_QUERIES:
            want[name] = qs[name]().collect_table()
            foracles[name](want[name])
            before = _scope("cluster")
            t1 = time.perf_counter()
            got = cq[name]().collect_table()
            wall = time.perf_counter() - t1
            d = _scope_change(before, _scope("cluster"))
            foracles[name](got)
            same_table(got, want[name], f"X4 {name} against the "
                       "single-process scan", CLUSTER_QUERIES[name])
            if not d.get("hostShardsLanded"):
                fail(f"X4 {name}: no batch came from an executor")
            x4[name] = {"wall_ms": round(wall * 1e3, 2),
                        "frames": d["hostShardsLanded"],
                        "host_scans": {
                            h: {k: v[k] for k in ("files", "bytes")}
                            for h, v in host_scan_stats().items()}}
        for h in ("h0", "h1"):
            reply = ping_executor(driver, h)
            if reply["cudaInitialized"] or reply["forbiddenModules"]:
                fail(f"X4: executor {h} made a CUDA context or imported "
                     f"{reply['forbiddenModules']}")
        res["X4"] = {"files_write_s": round(write_s, 2),
                     "spawn_s": round(spawn_s, 2), "queries": x4}
        log(f"  X4: 2 executor processes (spawned and registered in "
            f"{spawn_s:.1f} s; neither made a CUDA context, neither "
            f"imported JAX, pyarrow or pandas); "
            f"{', '.join(CLUSTER_QUERIES)} over {CLUSTER_FILES} files a "
            f"table scanned by host equal the single-process scan (bit for "
            f"bit; q3's and q12's f64 sums within rtol 1e-9) and their "
            f"oracles; {json.dumps(x4)}")

        # X5 (a): device_lost at the dispatch walks the host ladder
        tfaults.FAULTS.disarm()
        faulted = TorchSession(dict(cconf, **{
            "spark.rapids.test.faults": "host.dispatch:device_lost:2:3"}))
        before = HEALTH.host_snapshot()
        got = build_queries(faulted, ftables, paths=paths)["q1"]()\
            .collect_table()
        tfaults.FAULTS.disarm()
        same_table(got, want["q1"], "X5 q1 (host.dispatch device_lost) "
                   "against the single-process scan", 0.0)
        ladder = HEALTH.host_snapshot()
        if ladder["hostsLost"] - before["hostsLost"] != 2:
            fail(f"X5: the host ladder did not walk retry and reland: "
                 f"{ladder}")
        if not wait_for(lambda: not CLUSTER.health_snapshot()["lostHosts"],
                        30.0):
            fail("X5: the marked host was not restored")
        # X5 (b): SIGKILL of h1 at its dispatch, mid-query
        killed = {}
        scan_host = driver.scan_host

        def kill_at_dispatch(host_id, scan_node, sub):
            if host_id == "h1" and not killed:
                executors["h1"].proc.kill()
                t_kill = time.perf_counter()
                # the beat connection's EOF declares the host lost
                if not wait_for(lambda: "h1" in CLUSTER.health_snapshot()[
                        "lostHosts"], 30.0):
                    fail("X5: the killed executor was not declared lost")
                killed["ms"] = (time.perf_counter() - t_kill) * 1e3
                executors["h1"].proc.wait(timeout=10)
            return scan_host(host_id, scan_node, sub)
        driver.scan_host = kill_at_dispatch
        try:
            got = cq["q1"]().collect_table()
        finally:
            driver.scan_host = scan_host
        if "ms" not in killed:
            fail("X5: the query never dispatched to h1")
        detect_ms = killed["ms"]
        same_table(got, want["q1"], "X5 q1 (SIGKILL mid-query) against the "
                   "single-process scan", 0.0)
        t1 = time.perf_counter()
        executors["h1"] = spawn_executor(driver.address, "h1",
                                         heartbeat_ms=hb)
        if not wait_for(lambda: CLUSTER.topology_str() == "2"
                        and not CLUSTER.health_snapshot()["lostHosts"],
                        120.0):
            fail("X5: the respawned executor did not rejoin")
        rejoin_s = time.perf_counter() - t1
        got = cq["q3"]().collect_table()
        same_table(got, want["q3"], "X5 q3 at full strength again",
                   CLUSTER_QUERIES["q3"])
        if clus.last_event_record and clus.last_event_record.get(
                "hostTopology") not in (None, "2"):
            fail("X5: not at full strength after the rejoin")
        res["X5"] = {"ladder": ladder, "kill_detect_ms": round(detect_ms, 2),
                     "rejoin_s": round(rejoin_s, 2),
                     "cluster_scope": _scope("cluster")}
        log(f"  X5: device_lost x2 at host.dispatch walked retry and "
            f"reland ({json.dumps(ladder)}), the host restored by the "
            f"sweep; a SIGKILL of h1 at its dispatch was detected "
            f"{detect_ms:.1f} ms after the kill (the query converged on h0, "
            f"equal to the single-process scan), the respawned h1 rejoined "
            f"in {rejoin_s:.2f} s and q3 ran at full strength")
    finally:
        CLUSTER.attach_driver(None)
        driver.shutdown()
        for h in executors.values():
            try:
                h.terminate()
            except Exception:
                pass
        left = [h for h, e in executors.items() if e.alive()]
        if left:
            fail(f"phase 25: executors {left} outlived their kill")


def wait_for(predicate, timeout_s: float) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


def only_distribution_keep(rows: int, sf: float, seed: int) -> dict:
    """``--only 25``: phase 25's inputs made here, as phases 4-8 keep them
    in a full run (the tables, and each X2 query's single-device result
    and oracle check)."""
    from spark_rapids_tpu_torch.models.corpus import (
        build_queries,
        corpus_tables,
    )
    from spark_rapids_tpu_torch.models.tpch import (
        lineitem_table,
        q1_dataframe,
        q3_dataframe,
        q3_tables,
    )
    from spark_rapids_tpu_torch.session import TorchSession
    t0 = time.perf_counter()
    s = TorchSession()
    tables = corpus_tables(sf, seed)
    li = lineitem_table(rows, seed=0)
    o1 = q1_oracle(li)
    sparse = tuple(sparse_form(t) for t in q3_tables(rows, seed=0))
    o3 = q3_oracle(*sparse)
    q = build_queries(s, tables)
    keep = {
        "tables": tables,
        "TPC-H q1": {"tables": (li,),
                     "result": q1_dataframe(s, li).collect_table(),
                     "check": lambda g: check_q1_result(g, o1)},
        "q3 sparse": {"tables": sparse,
                      "result": q3_dataframe(s, *sparse).collect_table(),
                      "check": lambda g: check_q3_result(g, o3, "q3 sparse")},
        "q7": {"result": q["q7"]().collect_table(),
               "check": window_oracles(tables)["q7"]},
        "q8": {"result": q["q8"]().collect_table(),
               "check": corpus_cases(s, tables, sparse_custkey(
                   tables["orders"]))["q8"][1]}}
    log(f"  phase 25's tables and single-device results made in "
        f"{time.perf_counter() - t0:.1f} s")
    return keep


def run_distribution(q1_keep, q3_keep, corpus_keep, tables, seed) -> dict:
    """Phase 25 (X1-X5): returns the phase's launches, every one held
    against its kernel's plain version."""
    from spark_rapids_tpu_torch import kernels as K
    t_phase = time.perf_counter()
    card = card_line()
    ftables = file_corpus(seed)["tables"]
    foracles = file_oracles(ftables)
    base = tempfile.mkdtemp(prefix="srt-dist-")
    converted = CPU_ROUTE["converted"]
    res, parts = {}, {}
    K.reset_launch_counts()
    K.calls = held = HeldCalls()
    try:
        t0 = time.perf_counter()
        dist_x1(ftables, foracles, res)
        parts["X1"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            x2 = dist_x2(q1_keep, q3_keep, corpus_keep, tables, res)
            parts["X2"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            dist_x3(q1_keep, q3_keep, corpus_keep, tables, x2, res)
            parts["X3"] = time.perf_counter() - t0
        finally:
            dist_mesh_off()
        t0 = time.perf_counter()
        dist_x4_x5(ftables, foracles, base, res)
        parts["X4+X5"] = time.perf_counter() - t0
    finally:
        K.calls = None
        shutil.rmtree(base, ignore_errors=True)
    launches = K.launch_counts()
    if held.bad:
        fail(f"phase 25: launches disagree with their plain versions: "
             f"{held.bad[:8]}")
    for name in ("onehot_partials", "gather_compact", "sort_with_payload",
                 "fused_minmax", "probe_rowids"):
        if launches[name] < 1:
            fail(f"phase 25 did not launch {name}")
    took = time.perf_counter() - t_phase
    log(f"  phase 25: every launch held against its plain version "
        f"({dict(held.held)}); {CPU_ROUTE['converted'] - converted} plans "
        f"converted with 0 CPU-route nodes; parts "
        f"{ {k: round(v, 1) for k, v in parts.items()} } s")
    summary = {"card": card, "seconds": round(took, 1),
               "parts_s": {k: round(v, 2) for k, v in parts.items()},
               "launches": {k: v for k, v in launches.items() if v},
               "cells": res}
    if took > DIST_BUDGET_S:
        log(f"  phase 25 took {took:.1f} s, past its {DIST_BUDGET_S:.0f} s "
            "aim")
    log("  phase-25 summary: " + json.dumps(summary, default=str))
    return launches


STATIC_BUDGET_S = 60.0
#: the lint CLI's subprocess on the card (repo lint, registry audit, the 88
#: golden plans converted for cuda:0, the executed metrics slice)
STATIC_CLI_TIMEOUT_S = 300
STATIC_PHASE = ("phase 26: static analysis (every converted tree of phases "
                "3-25 verified, q1 and sparse q3 through a session with "
                "planVerify.mode=error, a hand-broken plan raising before "
                "any launch, the lint CLI on the card, the lock contract's "
                "RL-LOCK-* and LOCKS.md)")


def only_static_keep(rows: int) -> dict:
    """``--only 26``: phase 26's inputs made here, as phases 4-5 keep them
    in a full run (q1's table and sparse q3's tables, each with its
    oracle check)."""
    from spark_rapids_tpu_torch.models.tpch import lineitem_table, q3_tables
    li = lineitem_table(rows, seed=0)
    o1 = q1_oracle(li)
    sparse = tuple(sparse_form(t) for t in q3_tables(rows, seed=0))
    o3 = q3_oracle(*sparse)
    return {"TPC-H q1": {"tables": (li,),
                         "check": lambda g: check_q1_result(g, o1)},
            "q3 sparse": {"tables": sparse,
                          "check": lambda g: check_q3_result(
                              g, o3, "q3 sparse")}}


def run_static_analysis(q1_keep, q3_keep) -> dict:
    """Phase 26: 26.1 the verifier's count over every converted tree so
    far; 26.2 q1 and sparse q3 through a session in error mode, each
    verified and held to its oracle; 26.3 a hand-broken converted plan
    (a Limit exec over a host node) raising PlanVerificationError before
    any launch; 26.4 ``python -m spark_rapids_tpu_torch.lint --json`` in a
    subprocess on the card (RL-LOCK-* and RA-DOC-DRIFT-LOCKS among its
    rules); 26.5 the lock contract timed in this process
    (``static_lock_contract``). Returns the phase's launches, every one
    held against its kernel's plain version."""
    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.errors import PlanVerificationError
    from spark_rapids_tpu_torch.execs.basic import TpuLimitExec
    from spark_rapids_tpu_torch.lint import plan_verifier
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe, q3_dataframe
    from spark_rapids_tpu_torch.overrides import rules
    from spark_rapids_tpu_torch.plan import nodes as P
    from spark_rapids_tpu_torch.session import TorchSession
    t_phase = time.perf_counter()
    card = card_line()
    trees, ms = VERIFY["trees"], VERIFY["ms"]
    log(f"  26.1 the plan verifier over every tree converted so far: "
        f"{trees} trees, 0 diagnostics, {ms:.1f} ms of host time in all "
        f"({ms / max(trees, 1):.3f} ms a tree; {card})")
    res = {"verifiedTrees": trees, "verifierMs": round(ms, 3)}

    # 26.2: the session's own path
    session_ms = []
    orig = plan_verifier.verify_converted

    def timed(root, meta=None, conf=None):
        t0 = time.perf_counter()
        try:
            return orig(root, meta, conf)
        finally:
            session_ms.append((time.perf_counter() - t0) * 1e3)

    s = TorchSession({"spark.rapids.sql.planVerify.mode": "error"})
    K.reset_launch_counts()
    K.calls = held = HeldCalls()
    plan_verifier.verify_converted = timed
    try:
        for name, make, keep in (
                ("TPC-H q1", lambda: q1_dataframe(s, *q1_keep["tables"]),
                 q1_keep),
                ("q3 sparse", lambda: q3_dataframe(s, *q3_keep["tables"]),
                 q3_keep)):
            n0 = len(session_ms)
            t0 = time.perf_counter()
            got = make().collect_table()
            wall = (time.perf_counter() - t0) * 1e3
            keep["check"](got)
            verified = session_ms[n0:]
            if not verified:
                fail(f"26.2 {name}: the session ran a tree it did not "
                     "verify")
            res[name] = {"ms": round(wall, 2), "verifications": len(verified),
                         "verifyMs": round(sum(verified), 3),
                         "replays": s.last_metrics().get(
                             "speculationReplays", 0)}
            log(f"  26.2 {name} with planVerify.mode=error: oracle ok, "
                f"{len(verified)} tree(s) verified in {sum(verified):.2f} "
                f"ms, {wall:.1f} ms cold")
    finally:
        plan_verifier.verify_converted = orig
        K.calls = None
    launches = K.launch_counts()
    if held.bad:
        fail(f"phase 26: launches disagree with their plain versions: "
             f"{held.bad[:8]}")
    if not any(launches.values()):
        fail("phase 26 launched no kernel")

    # 26.3: a hand-broken converted plan raises before anything runs
    broken = TorchSession({"spark.rapids.sql.planVerify.mode": "error",
                           "spark.rapids.sql.executableCache.enabled":
                               "false"})
    before = K.launch_counts()
    hooked = rules.convert_meta
    rules.convert_meta = lambda meta, device: TpuLimitExec(
        P.RangeNode(0, 10), 5)
    try:
        q1_dataframe(broken, *q1_keep["tables"]).collect_table()
    except PlanVerificationError as exc:
        ids = sorted({d.rule_id for d in exc.diagnostics})
    else:
        fail("26.3: a Limit exec over a host node ran in error mode")
    finally:
        rules.convert_meta = hooked
    if "PV-TRANSITION" not in ids or K.launch_counts() != before:
        fail(f"26.3: the broken plan gave {ids}, launches "
             f"{before} -> {K.launch_counts()}")
    log(f"  26.3 a Limit exec over a host node: PlanVerificationError "
        f"{ids} before any launch (launch counters unchanged)")
    res["broken"] = ids

    # 26.4: the CLI on the card, in a child; 26.5 runs here meanwhile
    t0 = time.perf_counter()
    cli = subprocess.Popen(
        [sys.executable, "-m", "spark_rapids_tpu_torch.lint", "--json"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        res["locks"], locks_line = static_lock_contract(card)
        stdout, stderr = cli.communicate(timeout=STATIC_CLI_TIMEOUT_S)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.communicate()
    wall = time.perf_counter() - t0
    if cli.returncode != 0:
        fail(f"26.4: the lint CLI exited {cli.returncode}: "
             f"{stdout[-3000:]} {stderr[-3000:]}")
    rep = json.loads(stdout)
    if not rep["ok"] or sorted(rep["phases"]) != [
            "exec_metrics", "plans", "registry", "repo"] or \
            any(rep["phases"].values()):
        fail(f"26.4: the lint CLI reported {rep}")
    log(f"  26.4 python -m spark_rapids_tpu_torch.lint --json on the card: "
        f"exit 0, phases {rep['phases']}, {wall:.1f} s wall ({card})")
    res["cli"] = {"phases": rep["phases"], "wallS": round(wall, 2)}
    log(locks_line)

    took = time.perf_counter() - t_phase
    summary = {"card": card, "seconds": round(took, 1),
               "launches": {k: v for k, v in launches.items() if v},
               "held": dict(held.held), "cells": res}
    if took > STATIC_BUDGET_S:
        log(f"  phase 26 took {took:.1f} s, past its {STATIC_BUDGET_S:.0f} "
            "s aim")
    log("  phase-26 summary: " + json.dumps(summary, default=str))
    return launches


def static_lock_contract(card: str) -> dict:
    """26.5: the lock contract in this process. The CLI's rule ids equal
    the reference's (read from its ``lint/diagnostics.py`` as text: this
    script imports nothing of it); RL-LOCK-DECL, RL-LOCK-ORDER and
    RL-LOCK-EFFECT over the port's sources, timed, 0 diagnostics;
    RA-DOC-DRIFT-LOCKS over ``spark_rapids_tpu_torch/docs/LOCKS.md``
    clean. Returns (the numbers, the line to log)."""
    import ast

    from spark_rapids_tpu_torch import lockorder
    from spark_rapids_tpu_torch.lint.__main__ import main as lint_main
    from spark_rapids_tpu_torch.lint.concurrency import check_concurrency
    from spark_rapids_tpu_torch.lint.registry_audit import _audit_doc_drift
    from spark_rapids_tpu_torch.lint.rules.common import (
        _iter_source_files,
        _rel,
    )
    root = os.path.dirname(os.path.abspath(__file__))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = lint_main(["--list-rules"])
    ids = sorted(line.split()[0] for line in buf.getvalue().splitlines())
    ref = os.path.join(root, "spark_rapids_tpu", "lint", "diagnostics.py")
    with open(ref, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    want = next(sorted(ast.literal_eval(node.value)) for node in tree.body
                if isinstance(node, ast.AnnAssign)
                and getattr(node.target, "id", "") == "RULES")
    if rc != 0 or ids != want:
        fail(f"26.5: the CLI lists {ids}, the reference {want}")
    t0 = time.perf_counter()
    trees = {}
    for path in _iter_source_files(root):
        with open(path, encoding="utf-8") as f:
            trees[_rel(root, path)] = ast.parse(f.read())
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    diags = []
    check_concurrency(trees, diags)
    lock_s = time.perf_counter() - t0
    drift = []
    _audit_doc_drift(drift, root)
    if diags or drift:
        fail(f"26.5: {[str(d) for d in diags + drift][:8]}")
    line = (f"  26.5 the lock contract (while the CLI ran): the CLI's "
            f"{len(ids)} rule ids are the reference's; "
            f"RL-LOCK-DECL/ORDER/EFFECT over {len(trees)} files in "
            f"{lock_s:.2f} s ({parse_s:.2f} s to parse), 0 diagnostics; "
            f"{len(lockorder.LOCK_ORDER)} declared locks, "
            f"{len(lockorder.DEVIATIONS)} deviations from the reference's "
            f"table; docs/LOCKS.md as generated ({card})")
    return {"ruleIds": len(ids), "files": len(trees),
            "lockPassS": round(lock_s, 3), "parseS": round(parse_s, 3),
            "declared": len(lockorder.LOCK_ORDER),
            "deviations": len(lockorder.DEVIATIONS)}, line


def corpus_checks(tables) -> dict:
    """{corpus query: oracle check} of all 22 (phases 6-8's oracles)."""
    from spark_rapids_tpu_torch.session import TorchSession
    checks = dict(wide_oracles(tables))
    checks.update(window_oracles(tables))
    cases = corpus_cases(TorchSession(), tables,
                         sparse_custkey(tables["orders"]))
    checks.update({n: cases[n][1] for n in ("q2", "q8")})
    return checks


# ---------------------------------------------------------------------------
# phase 27: ANSI mode and the user surface
# ---------------------------------------------------------------------------

USER_PHASE = ("phase 27: ANSI and the user surface (A1 q1 and dense q3 with "
              "spark.sql.ansi.enabled, A2 four violations on the card and "
              "on the CPU route, A3 guards, S1 a pivot, S2 the device export "
              "and the bloom build through it, S3 explainOnly)")
#: phase 27's aim in seconds (logged when passed)
USER_BUDGET_S = 30.0
ANSI_ON = {"spark.sql.ansi.enabled": "true"}
ANSI_CPU = {**ANSI_ON, "spark.rapids.sql.enabled": "false"}


def only_user_keep(rows: int) -> dict:
    """``--only 27``: phase 27's inputs made here, as phases 4-5 keep them
    in a full run (q1's table, dense and sparse q3's tables, each with its
    oracle check)."""
    from spark_rapids_tpu_torch.models.tpch import lineitem_table, q3_tables
    li = lineitem_table(rows, seed=0)
    o1 = q1_oracle(li)
    dense = q3_tables(rows, seed=0)
    sparse = tuple(sparse_form(t) for t in dense)
    od, osp = q3_oracle(*dense), q3_oracle(*sparse)
    return {"TPC-H q1": {"tables": (li,),
                         "check": lambda g: check_q1_result(g, o1)},
            "q3 dense": {"tables": dense,
                         "check": lambda g: check_q3_result(
                             g, od, "q3 dense")},
            "q3 sparse": {"tables": sparse,
                          "check": lambda g: check_q3_result(
                              g, osp, "q3 sparse")}}


@contextlib.contextmanager
def recorded(held):
    """Record the block's kernel launches (``kernels.calls``: inputs and
    outputs cloned on the card, no host sync) and hold each against its
    kernel's plain version when the block ends, outside any timed or
    sync-counted window the block holds."""
    from spark_rapids_tpu_torch import kernels as K
    K.calls = []
    try:
        yield
    finally:
        calls, K.calls = K.calls, None
        for call in calls:
            held.append(call)


def _warm_counted(make, held, runs: int = 3):
    """One converting run, ``runs`` warm runs (their median ms) and one
    more under the sync counter, every launch held after its run:
    (result of the counted run, warm median ms, host syncs)."""
    with recorded(held):
        make().collect_table()
    times = []
    for _ in range(runs):
        with recorded(held):
            t0 = time.perf_counter()
            make().collect_table()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    with recorded(held), host_sync_count() as box:
        got = make().collect_table()
        torch.cuda.synchronize()
    return got, round(statistics.median(times), 3), box["syncs"]


def _expect_ansi(make, want: str, what: str) -> float:
    """``make().collect_table()`` must raise AnsiViolation with message
    ``want``; returns the ms it took to raise."""
    from spark_rapids_tpu_torch.errors import AnsiViolation
    t0 = time.perf_counter()
    try:
        make().collect_table()
    except AnsiViolation as e:
        if str(e) != want:
            fail(f"A2 {what}: AnsiViolation {str(e)!r}, want {want!r}")
    else:
        fail(f"A2 {what}: no AnsiViolation")
    torch.cuda.synchronize()
    return round((time.perf_counter() - t0) * 1e3, 2)


def _recovery_state():
    """What an ANSI error must leave as it was: the speculation blocklist,
    the recovery counters (replays, demotions), the health monitor, the
    quarantine and the circuit breaker."""
    from spark_rapids_tpu_torch.runtime import speculation as spec
    from spark_rapids_tpu_torch.runtime.faults import (
        CIRCUIT_BREAKER,
        RECOVERY,
    )
    from spark_rapids_tpu_torch.runtime.health import HEALTH, QUARANTINE
    return (sorted(spec._BLOCKLIST), RECOVERY.snapshot(), HEALTH.snapshot(),
            QUARANTINE.snapshot(), dict(CIRCUIT_BREAKER._failures))


def run_ansi(q1_keep, q3_dense, res, held) -> dict:
    """A1-A3 and the state check after A2 (``run_user_surface``); returns
    A1's ANSI results by query."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe, q3_dataframe
    from spark_rapids_tpu_torch.ops.expr import col, lit
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.session import TorchSession
    li = q1_keep["tables"][0]
    dense = q3_dense["tables"]
    off, on = TorchSession(), TorchSession(ANSI_ON)
    results = {}
    # dense q3's f64 revenue sums over more than 32 groups by atomics,
    # whose last bits vary from run to run (ROADMAP Queue 3 item 1): it
    # is held within rtol 1e-9, every other value bit for bit
    for name, make, check, rtol in (
            ("TPC-H q1", lambda s: q1_dataframe(s, li), q1_keep["check"],
             None),
            ("q3 dense", lambda s: q3_dataframe(s, *dense),
             q3_dense["check"], 1e-9)):
        cell = {}
        for label, s in (("off", off), ("on", on)):
            got, ms, syncs = _warm_counted(lambda s=s: make(s), held)
            check(got)
            cell[label] = (got, ms, syncs)
        same_table(cell["on"][0], cell["off"][0], f"A1 {name} ANSI on",
                   rtol)
        if cell["on"][2] != cell["off"][2]:
            fail(f"A1 {name}: {cell['on'][2]} host syncs with ANSI on, "
                 f"{cell['off'][2]} with it off")
        results[name] = cell["on"][0]
        res["A1"][name] = {"warmMsOff": cell["off"][1],
                           "warmMsOn": cell["on"][1],
                           "syncs": cell["on"][2]}
        how = ("bit for bit" if rtol is None else
               "f64 sums within rtol 1e-9, the rest bit for bit")
        log(f"  A1 {name} with spark.sql.ansi.enabled: ANSI off's result "
            f"({how}), oracle ok, warm {cell['on'][1]} ms (off "
            f"{cell['off'][1]} ms), host syncs {cell['on'][2]} (off "
            f"{cell['off'][2]})")

    # A2: violations over the same rows, on the card and the CPU route
    q3li = dense[2]
    kmax = int(q3li.columns[q3li.names.index("l_orderkey")].data.max())
    big = (1 << 63) - 1 - kmax + 1
    cases = {
        "integral overflow": (
            lambda s: from_host_table(q3li, s).select(
                (col("l_orderkey") + lit(big)).alias("y")),
            "integer overflow in +"),
        "cast overflow": (
            lambda s: from_host_table(li, s).select(
                (col("l_extendedprice") * lit(1e18)).cast("bigint")
                .alias("y")),
            "cast overflow to bigint"),
        "divide by zero": (
            lambda s: from_host_table(li, s).select(
                (col("l_quantity") % (col("l_quantity")
                                      - col("l_quantity"))).alias("y")),
            "divide by zero"),
        "filter predicate": (
            lambda s: from_host_table(q3li, s).filter(
                (col("l_orderkey") + lit(big)) > lit(0)),
            "integer overflow in +"),
    }
    before = _recovery_state()
    cpu = TorchSession(ANSI_CPU)
    for what, (make, label) in cases.items():
        with recorded(held):
            dev_ms = _expect_ansi(lambda: make(on), f"[ANSI] {label}", what)
        m = on.last_metrics()
        if m.get("speculationReplays", 0) or m.get("runtimeFaultReplays", 0):
            fail(f"A2 {what}: replays {m}")
        cpu_ms = _expect_ansi(lambda: make(cpu),
                              f"{label} (spark.sql.ansi.enabled)", what)
        res["A2"][what] = {"deviceMs": dev_ms, "cpuRouteMs": cpu_ms}
        log(f"  A2 {what}: AnsiViolation '[ANSI] {label}' on the card in "
            f"{dev_ms} ms, '{label} (spark.sql.ansi.enabled)' on the CPU "
            f"route in {cpu_ms} ms")
    after = _recovery_state()
    if after != before:
        fail(f"A2 changed the recovery state: {before} -> {after}")
    with recorded(held):
        again = q1_dataframe(on, li).collect_table()
    same_table(again, results["TPC-H q1"], "q1 after A2", None)
    log("  after A2: 0 replays, the blocklist, the recovery counters "
        "(demotions), the health monitor, the quarantine and the breaker "
        "unchanged; the next q1 bit for bit")

    # A3: guards
    p = li.columns[li.names.index("l_extendedprice")].data
    d = li.columns[li.names.index("l_discount")].data
    want = np.where(d != 0, p / np.where(d != 0, d, 1.0), 0.0)
    for label, s in (("card", on), ("CPU route", cpu)):
        with recorded(held):
            got = from_host_table(li, s).select(
                F.when(col("l_discount") != lit(0.0),
                       col("l_extendedprice") / col("l_discount"))
                .otherwise(lit(0.0)).alias("r")).collect_table()
        r = got.columns[0]
        if not (r.validity.all() and r.data.tobytes() == want.tobytes()):
            fail(f"A3 CASE WHEN on the {label}: not the numpy oracle")
    ok = q3li.columns[q3li.names.index("l_orderkey")].data
    below = ok[ok < kmax]
    for label, s in (("card", on), ("CPU route", cpu)):
        with recorded(held):
            got = from_host_table(q3li, s).filter(
                col("l_orderkey") < lit(kmax)).select(
                (col("l_orderkey") + lit(big)).alias("y")).agg(
                F.max("y").alias("m"), F.count().alias("n")).collect_table()
        m, n = (c.data[0] for c in got.columns)
        if int(m) != int(below.max()) + big or int(n) != len(below):
            fail(f"A3 filtered overflow on the {label}: {m}, {n}")
    zeros = int((d == 0).sum())
    res["A3"] = {"zeroDiscounts": zeros, "filteredRows": int(len(ok) -
                                                             len(below))}
    log(f"  A3 CASE WHEN l_discount != 0 THEN l_extendedprice / l_discount "
        f"ELSE 0 over {len(d)} rows ({zeros} zero discounts): the numpy "
        f"oracle bit for bit, on the card and the CPU route; l_orderkey + "
        f"{big} past a filter that drops the {len(ok) - len(below)} rows it "
        "would overflow: max and count as numpy's, no raise")
    return results


def run_surface(q1_keep, q3_dense, q3_sparse, results, res, held) -> None:
    """S1-S3 (``run_user_surface``)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch import kernels as K
    from spark_rapids_tpu_torch.columnar import DeviceColumn
    from spark_rapids_tpu_torch.models.tpch import q1_dataframe, q3_dataframe
    from spark_rapids_tpu_torch.ops.bloom import build_bits
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.runtime import speculation as spec
    from spark_rapids_tpu_torch.session import TorchSession
    li = q1_keep["tables"][0]
    s = TorchSession()

    # S1: the pivot
    before = K.launch_counts()
    with recorded(held):
        t0 = time.perf_counter()
        got = from_host_table(li, s).group_by("l_returnflag").pivot(
            "l_linestatus", ["F", "O"]).agg(
            F.sum("l_quantity").alias("q"),
            F.sum("l_extendedprice").alias("p"),
            F.count().alias("n")).sort("l_returnflag").collect_table()
        torch.cuda.synchronize()
        pivot_ms = round((time.perf_counter() - t0) * 1e3, 2)
    pl = {k: K.launch_counts()[k] - before[k] for k in before}
    c = {n: li.columns[li.names.index(n)].data for n in li.names}
    flags = sorted(set(c["l_returnflag"]))
    want_names = ["l_returnflag"] + [f"{v}_{a}" for v in ("F", "O")
                                     for a in ("q", "p", "n")]
    if list(got.names) != want_names or \
            list(got.columns[0].data) != flags:
        fail(f"S1 pivot: {list(got.names)} {list(got.columns[0].data)}")
    for i, rf in enumerate(flags):
        for j, ls in enumerate(("F", "O")):
            sel = (c["l_returnflag"] == rf) & (c["l_linestatus"] == ls)
            q, pr, n = (got.columns[1 + 3 * j + k].data[i] for k in range(3))
            if int(n) != int(sel.sum()) or not math.isclose(
                    q, c["l_quantity"][sel].sum(), rel_tol=1e-9) or \
                    not math.isclose(pr, c["l_extendedprice"][sel].sum(),
                                     rel_tol=1e-9):
                fail(f"S1 pivot ({rf}, {ls}): {q}, {pr}, {n}")
    if pl["onehot_partials"] < 1:
        fail(f"S1 pivot launched no partial sums: {pl}")
    res["S1"] = {"ms": pivot_ms, "launches": {k: v for k, v in pl.items()
                                              if v}}
    log(f"  S1 pivot of l_linestatus (F, O) over l_returnflag, sums and "
        f"count(*): the numpy oracle (counts exact, sums rtol 1e-9), "
        f"{pivot_ms} ms cold, launches {res['S1']['launches']}")

    # S2: the device export (sparse q3 from a clear blocklist: earlier
    # phases may have put its hash probe on the sort)
    spec.clear_blocklist()
    # sparse q3's f64 revenue: as in A1, within rtol 1e-9
    for name, make, check, rtol in (
            ("TPC-H q1", lambda ss: q1_dataframe(ss, li), q1_keep["check"],
             None),
            ("q3 sparse", lambda ss: q3_dataframe(ss, *q3_sparse["tables"]),
             q3_sparse["check"], 1e-9)):
        ss = TorchSession()
        table, _, collect_syncs = _warm_counted(lambda: make(ss), held,
                                                runs=1)
        check(table)
        with recorded(held):
            make(ss).to_device_arrays()
        with recorded(held), host_sync_count() as box:
            arrays, n = make(ss).to_device_arrays()
            torch.cuda.synchronize()
        if n != table.num_rows:
            fail(f"S2 {name}: {n} rows exported, {table.num_rows} collected")
        for cname, hc in zip(table.names, table.columns):
            parts = arrays[cname]
            if any(t.device != CUDA0 for t in parts[:2]):
                fail(f"S2 {name} {cname}: not on {CUDA0}")
            data = parts[0][:n].cpu().numpy()
            valid = parts[1][:n].cpu().numpy()
            if len(parts) == 3:
                data = np.asarray(parts[2], dtype=object)[data]
            got, want = data[valid], hc.data[hc.validity]
            if data.dtype == object:
                same = list(got) == list(want)
            elif rtol and data.dtype.kind == "f":
                same = np.allclose(got, want, rtol=rtol, atol=0)
            else:
                same = got.tobytes() == want.tobytes()
            if not np.array_equal(valid, hc.validity) or not same:
                fail(f"S2 {name} {cname}: the export differs from "
                     "collect_table")
        if box["syncs"] > collect_syncs:
            fail(f"S2 {name}: the export made {box['syncs']} host syncs, "
                 f"the collect {collect_syncs}")
        res["S2"][name] = {"exportSyncs": box["syncs"],
                           "collectSyncs": collect_syncs, "rows": n}
        log(f"  S2 {name}: to_device_arrays on cuda:0 equals collect_table "
            f"column for column ({n} rows); host syncs {box['syncs']} "
            f"(collect {collect_syncs}: no result download)")
    spec.clear_blocklist()

    # the bloom build through the export against the download-and-upload
    orders = q3_dense["tables"][1]
    od = from_host_table(orders, s)
    with recorded(held):
        F.build_bloom_filter(od, "o_orderkey")
    with recorded(held), host_sync_count() as box:
        bloom = F.build_bloom_filter(od, "o_orderkey")
        torch.cuda.synchronize()
    with recorded(held), host_sync_count() as old:
        host = od.select("o_orderkey").collect_table().columns[0]
        dc = DeviceColumn.from_host(host, len(host), DEV)
        bits = build_bits(dc.data.to(torch.int64), dc.validity,
                          bloom.num_bits, bloom.num_hashes)
        torch.cuda.synchronize()
    if not torch.equal(bits, bloom.bits):
        fail("S2 the bloom filter through the export differs from the "
             "download-and-upload build")
    res["S2"]["bloom"] = {"keys": orders.num_rows, "syncs": box["syncs"],
                          "oldSyncs": old["syncs"]}
    log(f"  S2 build_bloom_filter over {orders.num_rows} o_orderkey through "
        f"the export: bits equal the download-and-upload build's; host "
        f"syncs {box['syncs']} (the old path {old['syncs']}: its download "
        "and its upload)")

    # S3: explainOnly
    ex = TorchSession({"spark.rapids.sql.mode": "explainOnly",
                       "spark.rapids.sql.explain": "ALL"})
    before = K.launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        got = q1_dataframe(ex, li).collect_table()
    ms = round((time.perf_counter() - t0) * 1e3, 1)
    if K.launch_counts() != before or ex.last_dispatches:
        fail("S3 explainOnly launched a kernel")
    q1_keep["check"](got)
    text = buf.getvalue()
    if "Aggregate" not in text or ex.last_meta is None:
        fail(f"S3 explainOnly printed no tagged plan: {text[:300]!r}")
    same_table(got, results["TPC-H q1"], "S3 q1 explainOnly", 1e-9)
    res["S3"] = {"ms": ms, "planLines": len(text.splitlines())}
    log(f"  S3 q1 with spark.rapids.sql.mode=explainOnly: the tagged plan "
        f"printed ({len(text.splitlines())} lines), 0 launches, the result "
        f"from the CPU route in {ms} ms (the oracle's; the card's within "
        "rtol 1e-9)")


def run_user_surface(q1_keep, q3_dense, q3_sparse) -> dict:
    """Phase 27: ANSI mode (A1-A3) and the rest of the user surface
    (S1-S3) over phase 4's lineitem and phase 5's tables. Returns the
    phase's launches, every one held against its kernel's plain version
    after the run that made it (``recorded``)."""
    from spark_rapids_tpu_torch import kernels as K
    t_phase = time.perf_counter()
    card = card_line()
    res = {"A1": {}, "A2": {}, "S2": {}}
    K.reset_launch_counts()
    held = HeldCalls()
    CPU_ROUTE["expected"] = True
    try:
        results = run_ansi(q1_keep, q3_dense, res, held)
        run_surface(q1_keep, q3_dense, q3_sparse, results, res, held)
    finally:
        K.calls = None
        CPU_ROUTE["expected"] = False
    if sum(held.held.values()) != sum(K.launch_counts().values()):
        fail(f"phase 27 held {dict(held.held)} of launches "
             f"{K.launch_counts()}")
    launches = K.launch_counts()
    if held.bad:
        fail(f"phase 27: launches disagree with their plain versions: "
             f"{held.bad[:8]}")
    for k in ("onehot_partials", "gather_compact", "sort_with_payload",
              "probe_rowids"):
        if not launches.get(k):
            fail(f"phase 27 launched no {k}")
    took = time.perf_counter() - t_phase
    summary = {"card": card, "seconds": round(took, 1),
               "launches": {k: v for k, v in launches.items() if v},
               "held": dict(held.held), "cells": res}
    if took > USER_BUDGET_S:
        log(f"  phase 27 took {took:.1f} s, past its {USER_BUDGET_S:.0f} s "
            "aim")
    log("  phase-27 summary: " + json.dumps(summary, default=str))
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=6_001_215,
                    help="lineitem rows for q1 and q3 (default: TPC-H SF 1)")
    ap.add_argument("--sf", type=float, default=10.0,
                    help="scale factor of the corpus tables of phase 6 "
                         "(default 10)")
    ap.add_argument("--seed", type=int, default=7,
                    help="seed of the corpus tables of phase 6 (default 7)")
    ap.add_argument("--profile", default=None,
                    help="directory for torch.profiler tables and traces of "
                         "one warm run of q1, of each q3 form and of each "
                         "phase-6 query")
    ap.add_argument("--only", type=int,
                    choices=(21, 22, 23, 24, 25, 26, 27),
                    default=None,
                    help="run phases 1-3 and this phase only (its tables "
                         "made here); a full run is the default")
    ap.add_argument("--fatal-child", choices=("exit", "latch"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--fatal-dir", help=argparse.SUPPRESS)
    ap.add_argument("--service-child", help=argparse.SUPPRESS)
    ap.add_argument("--stream-child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.fatal_child:
        return fatal_child(args.fatal_child, args.fatal_dir)
    if args.service_child:
        return service_child(args.service_child)
    if args.stream_child:
        return stream_child(args.stream_child)
    from spark_rapids_tpu_torch.columnar import bucket_for
    from spark_rapids_tpu_torch.kernels.build import SOURCES as CU_SOURCES
    from spark_rapids_tpu_torch.kernels.build import build

    t_start = time.perf_counter()
    log("phase 1: the card")
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    log(f"  {card}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {cap} devices {torch.cuda.device_count()}")
    if cap != (9, 0):
        fail(f"compute capability {cap}, want (9, 0)")

    log("phase 2: build the kernels")
    t0 = time.perf_counter()
    reports = build(CU_SOURCES + ("yardstick",))
    log(f"  built {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"    {name}: {line.strip()}")

    log(f"  phases 1-2 ran {time.perf_counter() - t_start:.1f} s")
    watch_cpu_route()
    t_phase = time.perf_counter()
    log("phase 3: kernels against their plain versions")
    with host_sync_count() as box:
        torch.ones(1, device=DEV).item()
    log(f"  sync debug mode: one item() counts {box['syncs']} "
        f"({sorted(set(m.splitlines()[0] for m in box['messages']))})")
    if box["syncs"] < 1:
        fail("sync debug mode counted no sync for one item()")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    capacity = bucket_for(args.rows)
    rows = [check_segreduce(capacity, args.rows, gen), check_minmax(),
            check_compact(gen), check_sort(gen), check_hashprobe(gen)]
    log(f"  phase 3 ran {time.perf_counter() - t_phase:.1f} s")
    if args.only == 21:
        from spark_rapids_tpu_torch.models.corpus import corpus_tables
        from spark_rapids_tpu_torch.models.tpch import (
            lineitem_table,
            q3_tables,
        )
        launches = {r["name"]: 0 for r in rows}
        tables = corpus_tables(args.sf, args.seed)
        route = run_route(tables, lineitem_table(args.rows, seed=0),
                          tuple(sparse_form(t)
                                for t in q3_tables(args.rows, seed=0)),
                          args.seed)
        for k, v in route.items():
            launches[k] = launches.get(k, 0) + v
        return summary_phase(rows, launches, t_start)
    if args.only == 22:
        from spark_rapids_tpu_torch.models.corpus import corpus_tables
        from spark_rapids_tpu_torch.models.tpch import lineitem_table
        launches = {r["name"]: 0 for r in rows}
        tables = corpus_tables(args.sf, args.seed)
        table = lineitem_table(args.rows, seed=0)
        oracle = q1_oracle(table)
        oracles = wide_oracles(tables)
        t_phase = time.perf_counter()
        log("phase 22: demotion onto the CPU route and the rest of planning")
        for k, v in run_planning(tables, {
                "tables": (table,),
                "check": lambda g: check_q1_result(g, oracle)},
                {q: oracles[q] for q in AQE_QUERIES}).items():
            launches[k] = launches.get(k, 0) + v
        log(f"  phase 22 ran {time.perf_counter() - t_phase:.1f} s")
        return summary_phase(rows, launches, t_start)
    if args.only == 23:
        from spark_rapids_tpu_torch.models.corpus import corpus_tables
        from spark_rapids_tpu_torch.models.tpch import (
            lineitem_table,
            q3_tables,
        )
        launches = {r["name"]: 0 for r in rows}
        t0 = time.perf_counter()
        tables = corpus_tables(args.sf, args.seed)
        table = lineitem_table(args.rows, seed=0)
        oracle = q1_oracle(table)
        dense = q3_tables(args.rows, seed=0)
        sparse = tuple(sparse_form(t) for t in dense)
        o_sparse, o_dense = q3_oracle(*sparse), q3_oracle(*dense)
        q3_dense = {"tables": dense, "check": lambda g: check_q3_result(
            g, o_dense, "q3 dense")}
        checks = corpus_checks(tables)
        checks["TPC-H q1"] = lambda g: check_q1_result(g, oracle)
        checks["TPC-H q3"] = lambda g: check_q3_result(g, o_sparse,
                                                       "q3 sparse")
        log(f"  tables and oracles in {time.perf_counter() - t0:.1f} s "
            "(host)")
        t_phase = time.perf_counter()
        log("phase 23: the query service")
        for k, v in run_service(tables, table, checks["TPC-H q1"], sparse,
                                checks, q3_dense).items():
            launches[k] = launches.get(k, 0) + v
        log(f"  phase 23 ran {time.perf_counter() - t_phase:.1f} s")
        return summary_phase(rows, launches, t_start)
    if args.only == 24:
        from spark_rapids_tpu_torch.models.tpch import lineitem_table
        launches = {r["name"]: 0 for r in rows}
        table = lineitem_table(args.rows, seed=0)
        t_phase = time.perf_counter()
        log(LAKE_PHASE)
        for k, v in run_lakehouse(table, args.seed).items():
            launches[k] = launches.get(k, 0) + v
        log(f"  phase 24 ran {time.perf_counter() - t_phase:.1f} s")
        return summary_phase(rows, launches, t_start)
    if args.only == 25:
        launches = {r["name"]: 0 for r in rows}
        keep = only_distribution_keep(args.rows, args.sf, args.seed)
        t_phase = time.perf_counter()
        log(DIST_PHASE)
        for k, v in run_distribution(keep["TPC-H q1"], keep["q3 sparse"],
                                     keep, keep["tables"],
                                     args.seed).items():
            launches[k] = launches.get(k, 0) + v
        log(f"  phase 25 ran {time.perf_counter() - t_phase:.1f} s")
        return summary_phase(rows, launches, t_start)
    if args.only == 26:
        launches = {r["name"]: 0 for r in rows}
        keep = only_static_keep(args.rows)
        t_phase = time.perf_counter()
        log(STATIC_PHASE)
        for k, v in run_static_analysis(keep["TPC-H q1"],
                                        keep["q3 sparse"]).items():
            launches[k] = launches.get(k, 0) + v
        log(f"  phase 26 ran {time.perf_counter() - t_phase:.1f} s")
        return summary_phase(rows, launches, t_start)
    if args.only == 27:
        launches = {r["name"]: 0 for r in rows}
        keep = only_user_keep(args.rows)
        t_phase = time.perf_counter()
        log(USER_PHASE)
        for k, v in run_user_surface(keep["TPC-H q1"], keep["q3 dense"],
                                     keep["q3 sparse"]).items():
            launches[k] = launches.get(k, 0) + v
        log(f"  phase 27 ran {time.perf_counter() - t_phase:.1f} s")
        return summary_phase(rows, launches, t_start)

    #: what phases 4-8 keep of each DSL form for phase 9's SQL forms
    dsl = {}
    #: the memory and spill counters before phase 4 (phase 14 reads the
    #: change over phases 4-13)
    counters_before = runtime_counters()
    t_phase = time.perf_counter()
    log("phase 4: TPC-H q1 through TorchSession")
    launches = run_q1(args.rows, args.profile, dsl)
    log(f"  phase 4 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log("phase 5: TPC-H q3 through TorchSession, dense and sparse keys")
    launches["probe_rowids"] = run_q3(args.rows, args.profile, dsl)
    log(f"  phase 5 ran {time.perf_counter() - t_phase:.1f} s")

    from spark_rapids_tpu_torch.models.corpus import corpus_tables
    t_phase = time.perf_counter()
    tables = corpus_tables(args.sf, args.seed)
    log(f"  generated scale_test_specs({args.sf}) seed {args.seed} (every "
        f"column the ported corpus reads) in "
        f"{time.perf_counter() - t_phase:.2f} s (host)")

    t_phase = time.perf_counter()
    log("phase 6: the corpus's q2 and q8 and MIN/MAX through TorchSession")
    launches["fused_minmax"] = run_corpus(tables, args.sf, args.seed,
                                          args.profile, dsl)
    log(f"  phase 6 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log(f"phase 7: the other {len(WIDE_QUERIES)} ported corpus queries "
        "through TorchSession")
    for k, v in run_corpus_wide(tables, args.profile, dsl).items():
        launches[k] += v
    log(f"  phase 7 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log("phase 8: the window and exchange queries (q6, q21, q7) through "
        "TorchSession")
    for k, v in run_corpus_window(tables, args.profile, dsl).items():
        launches[k] += v
    log(f"  phase 8 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log("phase 9: the SQL front end: the corpus's 22 texts, a conditional "
        "query, Q1_SQL and Q3_SQL through TorchSession.sql")
    for k, v in run_sql(tables, dsl, args.profile).items():
        launches[k] += v
    q1_keep = dsl["TPC-H q1"]
    log(f"  phase 9 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log("phase 10: the join types (J1-J12, sparse J3 and J12, "
        "sub-partitioned J1 and J8) through TorchSession.sql")
    for k, v in run_joins(tables, args.sf, args.profile).items():
        launches[k] += v
    log(f"  phase 10 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log("phase 11: the operator queries (O1-O8: DECIMAL(15,2) q1, MIN/MAX "
        "of every type, FIRST/LAST, UNION, range, sample, cache)")
    for k, v in run_ops(tables, args.sf, args.seed, args.profile).items():
        launches[k] += v
    log(f"  phase 11 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log("phase 12: the scalar queries (S1-S8: DECIMAL128 division, "
        "strings, dates and timestamps, math, hashes) through "
        "TorchSession.sql")
    totals, s1_args = run_scalars(tables, args.sf, args.seed, args.profile)
    for k, v in totals.items():
        launches[k] = launches.get(k, 0) + v
    rows.append(check_dec128div(s1_args))
    log(f"  phase 12 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log("phase 13: the window queries (W1-W8: lag, lead, nth_value, "
        "percent_rank, aggregate windows over whole, running and bounded "
        "frames, the multi-batch routes) through TorchSession.sql")
    for k, v in run_windows(tables, args.profile).items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 13 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log("phase 14: the memory runtime (the device manager's report, "
        "squeezed budgets, injected and real OOMs, the semaphore, spill "
        "rates)")
    for k, v in run_runtime(tables, q1_keep, counters_before).items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 14 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log("phase 15: Parquet files in and out (the port's writer and codec, "
        "the reader modes, q1 and the corpus from files, pruning, "
        "partitions, input_file_name, a faulted write)")
    for k, v in run_files(args.seed, q1_keep).items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 15 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log("phase 16: text files in and out (CSV, JSON lines and Hive text "
        "through the port's text codec, the reader modes, q1 and the "
        "corpus from text, options and modes, a faulted write)")
    for k, v in run_text(args.seed, q1_keep).items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 16 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log("phase 17: ORC files in and out and the binary codecs (ZSTD and "
        "LZ4 of the port's own, ORC's run-length streams; ORC and Parquet "
        "with ZSTD and LZ4 read back in the reader modes, q1 and the "
        "corpus from ORC, a faulted ORC write, corrupt input)")
    for k, v in run_orc(args.seed, q1_keep).items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 17 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log("phase 18: dynamic partition pruning at SF 1 (84 month partitions, "
        "the DSL and SQL forms, on and off), the bloom runtime filter, "
        "recovery on q1 (replay, the breaker, the memory ladder, device "
        "loss) and a real fatal CUDA error in two child processes")
    for k, v in run_dpp_phase(args.seed, q1_keep).items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 18 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log("phase 19: the query envelope (the profiler's trace of q1, the "
        "event log and spans over the corpus with the tools, the "
        "executable cache, warmup in fresh processes, the asynchronous "
        "result fetch, the launch helper's fault points)")
    for k, v in run_observability(tables, dsl, q1_keep).items():
        launches[k] = launches.get(k, 0) + v
    q3_sparse = dsl["q3 sparse"]["tables"]
    aqe_checks = {q: dsl[q]["check"] for q in AQE_QUERIES}
    from spark_rapids_tpu_torch.models.corpus import CORPUS
    svc_checks = {q: dsl[q]["check"] for q in CORPUS}
    svc_checks["TPC-H q1"] = q1_keep["check"]
    svc_checks["TPC-H q3"] = dsl["q3 sparse"]["check"]
    # phase 25's mesh holds these against the single-device results
    dist_keep = {k: dsl[k] for k in ("q3 sparse", "q7", "q8")}
    # phase 23's V8 serves dense q3 over phase 5's tables
    q3_dense = {k: dsl["q3 dense"][k] for k in ("tables", "check")}
    del dsl
    log(f"  phase 19 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log("phase 20: nested types (collect_list, collect_set and percentile "
        "by order over lineitem; the array, struct, map and higher-order "
        "functions; the explodes; nested Parquet in and out)")
    for k, v in run_nested(tables, args.profile).items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 20 ran {time.perf_counter() - t_phase:.1f} s")

    log(f"  phases 3-20 converted {CPU_ROUTE['converted']} plans, each "
        "with 0 CPU-route nodes")

    t_phase = time.perf_counter()
    log("phase 21: the CPU route (C1 arrays into a flat-only filter, C2 a "
        "cast to string as a grouping key, C3 a row-wise Python UDF, C4 a "
        "compiled UDF in q1, C5 to_json and the JSON functions, C6 q1 and "
        "sparse q3 with spark.rapids.sql.enabled=false)")
    for k, v in run_route(tables, q1_keep["tables"][0], q3_sparse,
                          args.seed).items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 21 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log("phase 22: demotion onto the CPU route and the rest of planning (P1 "
        "a range exchange and the local sort, P2 AQE's build of q10, q17 "
        "and q22, P3 the breaker, the memory ladder's cpu_demote and the "
        "CPU-only latch on q1, P4 the cost-based optimizer)")
    for k, v in run_planning(tables, q1_keep, aqe_checks).items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 22 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log("phase 23: the query service (V1 the corpus, q1 and sparse q3 from "
        "3 tenants at 4 workers, V2 pools, V3 cancellation and deadlines, "
        "V4 the watchdog and a worker's death, V5 quarantine and the "
        "flight recorder, V6 introspection, V7 a device loss under load "
        "in a child, V8 the lock witness under a squeezed budget)")
    for k, v in run_service(tables, q1_keep["tables"][0], q1_keep["check"],
                            q3_sparse, svc_checks, q3_dense).items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 23 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log(LAKE_PHASE)
    for k, v in run_lakehouse(q1_keep["tables"][0], args.seed).items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 24 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log(DIST_PHASE)
    for k, v in run_distribution(q1_keep, dist_keep["q3 sparse"], dist_keep,
                                 tables, args.seed).items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 25 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log(STATIC_PHASE)
    for k, v in run_static_analysis(q1_keep, dist_keep["q3 sparse"]).items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 26 ran {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    log(USER_PHASE)
    for k, v in run_user_surface(q1_keep, q3_dense,
                                 dist_keep["q3 sparse"]).items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 27 ran {time.perf_counter() - t_phase:.1f} s")
    return summary_phase(rows, launches, t_start)


def summary_phase(rows, launches, t_start: float) -> int:
    from spark_rapids_tpu_torch import lockorder
    log("phase 28: summary")
    log("  dec128_divide is CUDA work beyond the five TPU kernels: the "
        "reference divides DECIMAL128 values on its host")
    log(f"  the lock table: {len(lockorder.LOCK_ORDER)} declared locks, "
        f"{len(lockorder.DEVIATIONS)} deviations from the reference's "
        f"({sorted(lockorder.DEVIATIONS)}); V8: "
        + (json.dumps({k: v for k, v in V8_RESULT.items() if k != "by_name"})
           if V8_RESULT else "not run (phase 23 did not run)"))
    for r in rows:
        r.update(route="cuda", source=SOURCES[r["name"]],
                 replaces=TPU_KERNELS[r["name"]],
                 launches=launches[r["name"]])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    log(f"  the script ran {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
