"""Typed configuration (the entries of ``spark_rapids_tpu/conf.py`` that
the ported path reads; keys and defaults are the reference's).

A key the port does not know raises: silently ignoring, say,
``spark.rapids.sql.enabled=false`` would run a query the caller asked to
keep off the device."""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

_REGISTRY: Dict[str, "ConfEntry"] = {}


@dataclass(frozen=True)
class ConfEntry:
    key: str
    default: Any
    doc: str
    conv: Callable[[str], Any]


def _conf(key, default, doc, conv) -> ConfEntry:
    e = ConfEntry(key=key, default=default, doc=doc, conv=conv)
    if key in _REGISTRY:
        raise ValueError(f"duplicate conf key {key}")
    _REGISTRY[key] = e
    return e


SHAPE_BUCKETS_MIN = _conf(
    "spark.rapids.sql.shapeBuckets.minBucket", 128,
    "Smallest capacity bucket of the power-of-two bucket policy (a "
    "power-of-two multiple of 128).", int)

def _to_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("true", "1", "yes", "on")


def _attempts(v) -> int:
    n = int(v)
    if not 1 <= n <= 8:
        raise ValueError(
            f"spark.rapids.tpu.kernels.hashprobe.attempts={n} outside [1, 8]: "
            "the port has no sorted-probe route for it")
    return n


AGG_MAX_DICT_GROUPS = _conf(
    "spark.rapids.tpu.agg.maxDictGroups", 1 << 16,
    "Max key-domain product for the no-sort dictionary-code aggregation "
    "fast path.", int)

AGG_MAX_KEY_DOMAIN_GROUPS = _conf(
    "spark.rapids.tpu.agg.maxKeyDomainGroups", 1 << 21,
    "Max key-domain product for the no-sort INTEGER-key aggregation fast "
    "path (keys whose (min, max) is known from upload-time column "
    "statistics); wider domains take the sort-segment path. 0 disables.",
    int)

SPECULATIVE_SIZING = _conf(
    "spark.rapids.tpu.speculativeSizing.enabled", True,
    "Size data-dependent outputs (join outputs, direct-address join "
    "tables, hash-probe tables, the sort-segment aggregate's output) "
    "speculatively with device validation flags, read once at collect; a "
    "failed speculation blocklists its site and replays the query.",
    _to_bool)

JOIN_DIRECT_TABLE_MULT = _conf(
    "spark.rapids.tpu.join.directTableMultiplier", 4,
    "Direct-address join: the key-range table is this multiple of the "
    "build side's capacity; wider build key ranges fail the speculation "
    "and replay on the hash probe.", int)

BROADCAST_SIZE_BYTES = _conf(
    "spark.rapids.sql.broadcastSizeBytes", 10 << 20,
    "Join build sides whose plan-size estimate is at or below this are "
    "materialized once through a broadcast exchange; larger ones are "
    "coalesced into one batch per query.", int)

KERNELS_HASHPROBE_ATTEMPTS = _conf(
    "spark.rapids.tpu.kernels.hashprobe.attempts", 4,
    "Rehash attempts of the hash-probe table: build rows that cannot place "
    "within this many salted slots (or duplicate build keys) set the "
    "failure flag and the join replays on the sort-based probe. Must lie "
    "in [1, 8].", _attempts)

JOIN_SUBPARTITION_BYTES = _conf(
    "spark.rapids.sql.join.subPartition.targetBytes", 1 << 30,
    "Build sides larger than this sub-partition by Spark-exact key hash "
    "into ceil(size/target) buckets; probe batches split the same way and "
    "bucket pairs join independently. Capped by the memory arbiter's scan "
    "chunk (runtime/memory.py: min(this, scan_chunk_bytes())). 0 "
    "disables.", int)

JOIN_MAX_SUBPARTITIONS = _conf(
    "spark.rapids.sql.join.maxSubPartitions", 64,
    "Upper bound on hash sub-partitions when a join's build side exceeds "
    "the sub-partitioning threshold.", int)

WINDOW_ROWS_FRAME_MAX_BOUND = _conf(
    "spark.rapids.sql.window.rowsFrameMaxBound", 1 << 16,
    "Rows-frame window bounds beyond this magnitude raise (the reference "
    "tags them to its CPU route): the sparse table's levels and the "
    "unrolled frame's offsets grow with the frame's finite endpoints.",
    int)

WINDOW_STREAM_TARGET_ROWS = _conf(
    "spark.rapids.sql.window.streamTargetRows", 0,
    "Target rows per streamed range batch of the multi-batch running and "
    "bounded-frame windows (0 = the largest input run's size).", int)

VARIABLE_FLOAT_AGG = _conf(
    "spark.rapids.sql.variableFloatAgg.enabled", True,
    "Allow float aggregations whose result may differ in ULPs from the "
    "CPU's because of the reduction order (here: a float window sum over "
    "a bounded rows frame wider than 512 rows, by prefix difference).",
    _to_bool)

SORT_OOC_THRESHOLD = _conf(
    "spark.rapids.sql.sort.outOfCoreThresholdBytes", 1 << 30,
    "Multi-batch sorts whose input exceeds this many device bytes merge "
    "out of core: each batch sorts on the device and moves to a host run, "
    "sampled first-key bounds split the key space into ranges, and each "
    "range uploads and sorts on its own. Capped by the memory arbiter's "
    "scan chunk (runtime/memory.py: min(this, scan_chunk_bytes())).", int)


# -- the memory runtime (runtime/): the reference's keys and defaults ------

CONCURRENT_GPU_TASKS = _conf(
    "spark.rapids.sql.concurrentGpuTasks", 2,
    "Number of tasks that may hold the device semaphore concurrently "
    "(runtime/semaphore.py; reference: GpuSemaphore).", int)

HBM_POOL_FRACTION = _conf(
    "spark.rapids.memory.gpu.allocFraction", 0.9,
    "Fraction of the card's memory (torch.cuda.mem_get_info's total) the "
    "engine may use: the device budget is total x fraction less the "
    "reserve.", float)

HBM_RESERVE_BYTES = _conf(
    "spark.rapids.memory.gpu.reserve", 640 << 20,
    "Device memory held back from the budget for kernel workspaces and "
    "the caching allocator's fragmentation.", int)

HOST_SPILL_STORAGE_SIZE = _conf(
    "spark.rapids.memory.host.spillStorageSize", 1 << 31,
    "Bytes of host memory used for spilled device buffers before disk.",
    int)

PINNED_POOL_SIZE = _conf(
    "spark.rapids.memory.pinnedPool.size", 0,
    "Page-locked host staging pool for device-to-host spill copies "
    "(0 = unpooled: pageable copies).", int)

HOST_MEMORY_LIMIT = _conf(
    "spark.rapids.memory.host.limit", 4 << 30,
    "Host-memory arbiter budget for engine host buffers: here the spill "
    "catalog's host copies. Exhaustion spills the host tier to disk, "
    "then blocks, then raises CpuRetryOOM (runtime/host_alloc.py; "
    "reference: HostAlloc).", int)

RETRY_OOM_MAX_RETRIES = _conf(
    "spark.rapids.memory.gpu.oomMaxRetries", 2,
    "Synchronous-spill retries before escalating to split-and-retry.",
    int)

DEVICE_BUDGET_BYTES = _conf(
    "spark.rapids.memory.device.budgetBytes", 0,
    "Hard device-memory budget the memory arbiter (runtime/memory.py) "
    "enforces on every device landing: a reservation that would exceed "
    "it synchronously spills idle BufferCatalog entries and, when "
    "spilling cannot make room, raises RetryOOM into the retry framework "
    "(spill-replay, then split-and-retry). 0 = the device manager's "
    "budget (allocFraction and reserve applied).", int)

DEVICE_SCAN_CHUNK_FRACTION = _conf(
    "spark.rapids.memory.device.scanChunkFraction", 0.25,
    "Largest share of the device budget one scan batch may occupy: a host "
    "batch whose estimated device bytes exceed budgetBytes * fraction "
    "lands as several bounded partitions (chunked out-of-core scan).",
    float)

DEVICE_ORDINAL = _conf(
    "spark.rapids.tpu.deviceOrdinal", -1,
    "CUDA device the device manager picks: -1 = the current CUDA device; "
    "an explicit ordinal must be below torch.cuda.device_count().", int)

TEST_INJECT_RETRY_OOM = _conf(
    "spark.rapids.sql.test.injectRetryOOM", "",
    "Test-only: 'retry[:N]' or 'split[:N]' arms N injected RetryOOM or "
    "SplitAndRetryOOM throws at the query's next retry blocks "
    "(reference: RmmSpark.forceRetryOOM).", str)

TEST_FAULTS = _conf(
    "spark.rapids.test.faults", "",
    "Test-only fault injection: semicolon-separated "
    "'<point>[@<op>]:<kind>:<prob-or-count>[:<seed>]' entries armed on "
    "the process-wide fault registry at execute() (runtime/faults.py).",
    str)

# -- recovery (runtime/{faults,health,crash_handler}.py) --------------------

RUNTIME_FALLBACK_ENABLED = _conf(
    "spark.rapids.sql.runtimeFallback.enabled", True,
    "Per-operator circuit breaker: a non-OOM device failure "
    "(KernelCrashError) replays the query, and after maxFailures failures "
    "of the same operator the breaker trips. The reference then demotes "
    "the operator to its CPU path; the port has none, so a tripped "
    "operator raises KernelCrashError naming the breaker. Disable to "
    "surface every crash without a replay.", _to_bool)

RUNTIME_FALLBACK_MAX_FAILURES = _conf(
    "spark.rapids.sql.runtimeFallback.maxFailures", 2,
    "Non-OOM device failures of the same operator before the circuit "
    "breaker trips.", int)

DEVICE_LOSS_MAX_REINITS = _conf(
    "spark.rapids.service.deviceLoss.maxReinits", 3,
    "Consecutive device losses (fatal non-OOM device errors with no "
    "successful query between them) tolerated before the process latches: "
    "every later execute raises DeviceLostError (the reference latches "
    "CPU-only mode instead).", int)

CRASH_DUMP_DIR = _conf(
    "spark.rapids.memory.crashDump.dir",
    os.path.join(tempfile.gettempdir(), "rapids_tpu_crash"),
    "Directory for fatal-device-error crash reports "
    "(GpuCoreDumpHandler analog).", str)

EXIT_ON_FATAL = _conf(
    "spark.rapids.fatalError.exit", False,
    "Exit the process with code 20 on a fatal device error so the "
    "scheduler replaces this executor (reference Plugin.scala:669-694).",
    _to_bool)

# -- observability and the warm path ---------------------------------------

PROFILE_ENABLED = _conf(
    "spark.rapids.profile.enabled", False,
    "Collect torch.profiler traces of the card (CPU and CUDA activities, "
    "the engine's operators and kernels as named ranges) for queries "
    "(profiler.scala analog).", _to_bool)

PROFILE_PATH = _conf(
    "spark.rapids.profile.pathPrefix",
    os.path.join(tempfile.gettempdir(), "rapids_tpu_profile"),
    "Directory prefix for collected trace sessions (one query_<N> "
    "directory per profiled query).", str)

PROFILE_QUERY_RANGES = _conf(
    "spark.rapids.profile.queryRanges", "",
    "Query-index ranges to profile, e.g. \"0-2,5\" (empty = all queries "
    "when profiling is enabled). RangeConfMatcher syntax.", str)

TRACE_ENABLED = _conf(
    "spark.rapids.trace.enabled", False,
    "Collect host-side spans for every query and export a Chrome "
    "trace-event JSON per query under spark.rapids.trace.dir (load it in "
    "Perfetto next to the profiler's device trace).", _to_bool)

TRACE_DIR = _conf(
    "spark.rapids.trace.dir",
    os.path.join(tempfile.gettempdir(), "rapids_tpu_trace"),
    "Directory for exported Chrome trace JSON files (one "
    "query_<N>.trace.json per traced query).", str)

EVENT_LOG_ENABLED = _conf(
    "spark.rapids.sql.eventLog.enabled", False,
    "Write one structured JSONL record per executed query (plan tree "
    "with per-op metrics, fallback/demotion reasons, recovery counters, "
    "span attribution) under spark.rapids.sql.eventLog.dir: the input "
    "to `python -m spark_rapids_tpu_torch.tools`.", _to_bool)

EVENT_LOG_DIR = _conf(
    "spark.rapids.sql.eventLog.dir",
    os.path.join(tempfile.gettempdir(), "rapids_tpu_eventlog"),
    "Directory for query event logs (one events-<session>.jsonl per "
    "session).", str)

EXECUTABLE_CACHE_ENABLED = _conf(
    "spark.rapids.sql.executableCache.enabled", True,
    "Cache the converted executable plan (the exec tree and the "
    "overrides' tags) keyed on the literal-stripped structural "
    "fingerprint (plan/fingerprint.py): a repeated query template skips "
    "the conversion; distinct-literal variants of one template count a "
    "template hit. Entries drop on warehouse invalidation (writes, "
    "catalog changes) and on circuit-breaker trips. Hit/miss counters "
    "live in the `compile` metric scope.", _to_bool)

EXECUTABLE_CACHE_MAX_PLANS = _conf(
    "spark.rapids.sql.executableCache.maxPlans", 64,
    "LRU bound on cached plan TEMPLATES (literal-stripped fingerprints) "
    "in the executable cache. A cached tree pins its plan's in-memory "
    "source tables, so this bound also bounds the host memory the cache "
    "pins.", int)

EXECUTABLE_CACHE_MAX_VARIANTS = _conf(
    "spark.rapids.sql.executableCache.maxVariantsPerPlan", 4,
    "LRU bound on literal variants retained per cached template: each "
    "variant pins one converted exec tree.", int)

ASYNC_RESULT_FETCH = _conf(
    "spark.rapids.sql.asyncResultFetch", True,
    "Move the final device-to-host result copy off the device "
    "semaphore's critical section: the copies into pinned host buffers "
    "are ENQUEUED under the semaphore, the semaphore releases, and the "
    "copy completes (a CUDA event) before any byte is read. A result "
    "the pinned pool cannot hold downloads synchronously "
    "(asyncFetchSynchronous).", _to_bool)

METRICS_LEVEL = _conf(
    "spark.rapids.sql.metrics.level", "MODERATE",
    "ESSENTIAL, MODERATE or DEBUG metric collection.", str)

LORE_DUMP_IDS = _conf(
    "spark.rapids.sql.lore.idsToDump", "",
    "Comma-separated LORE operator ids (the event record's plan tree "
    "shows each operator's id) whose input batches and operator dump to "
    "lore.dumpPath during execution; spark_rapids_tpu_torch.lore.replay() "
    "re-executes one dumped operator, including in a fresh process.", str)

LORE_DUMP_PATH = _conf(
    "spark.rapids.sql.lore.dumpPath", "",
    "Directory for LORE dumps (one lore-<id> subdirectory per operator).",
    str)

QUARANTINE_MAX_STRIKES = _conf(
    "spark.rapids.service.quarantine.maxStrikes", 3,
    "Strikes (device kills, memory-ladder actions past the plain retry) "
    "after which a query template is quarantined: the service refuses "
    "further submissions of it at admission (the service scheduler is "
    "not ported: ROADMAP item 12).", int)

# -- dynamic partition pruning and the bloom filter --------------------------

DPP_ENABLED = _conf(
    "spark.rapids.sql.dpp.enabled", True,
    "Dynamic partition pruning: when a broadcast join's probe side scans "
    "a Hive-partitioned source keyed on a partition column, prune the "
    "scan's file list to the build side's distinct key values before "
    "reading (GpuFileSourceScanExec DynamicPruningExpression analog).",
    _to_bool)

BLOOM_DEFAULT_NUM_BITS = _conf(
    "spark.rapids.tpu.bloomFilter.numBits", 1 << 20,
    "Default bit-array size for build_bloom_filter.", int)

BLOOM_DEFAULT_NUM_HASHES = _conf(
    "spark.rapids.tpu.bloomFilter.numHashes", 3,
    "Default hash-function count for build_bloom_filter.", int)


# -- file IO (io/): the reference's keys and defaults ----------------------

PARQUET_READER_TYPE = _conf(
    "spark.rapids.sql.format.parquet.reader.type", "AUTO",
    "PERFILE, COALESCING, MULTITHREADED or AUTO (reference: "
    "GpuParquetScan reader modes).", str)

AVRO_READER_TYPE = _conf(
    "spark.rapids.sql.format.avro.reader.type", "AUTO",
    "PERFILE, COALESCING, MULTITHREADED or AUTO.", str)

CSV_READER_TYPE = _conf(
    "spark.rapids.sql.format.csv.reader.type", "AUTO",
    "PERFILE, COALESCING, MULTITHREADED or AUTO.", str)

JSON_READER_TYPE = _conf(
    "spark.rapids.sql.format.json.reader.type", "AUTO",
    "PERFILE, COALESCING, MULTITHREADED or AUTO.", str)

ORC_READER_TYPE = _conf(
    "spark.rapids.sql.format.orc.reader.type", "AUTO",
    "PERFILE, COALESCING, MULTITHREADED or AUTO (reference: GpuOrcScan "
    "reader modes).", str)

HIVE_TEXT_READER_TYPE = _conf(
    "spark.rapids.sql.format.hiveText.reader.type", "AUTO",
    "PERFILE, COALESCING, MULTITHREADED or AUTO.", str)

MULTITHREADED_READ_NUM_THREADS = _conf(
    "spark.rapids.sql.multiThreadedRead.numThreads", 20,
    "Thread pool for multithreaded file prefetch.", int)

READER_COALESCE_TARGET_BYTES = _conf(
    "spark.rapids.sql.reader.coalescing.targetBytes", 256 << 20,
    "Target bytes when stitching small files/row-groups into one decode.",
    int)

FILECACHE_ENABLED = _conf(
    "spark.rapids.filecache.enabled", False,
    "Cache decoded file batches in host memory keyed by (path, mtime, "
    "scan options); repeated scans skip the decode (FileCache analog).",
    _to_bool)

FILECACHE_MAX_BYTES = _conf(
    "spark.rapids.filecache.maxBytes", 1 << 30,
    "LRU budget for the decoded-batch file cache.", int)

#: per-format kill switches of the file scans (the reference's
#: spark.rapids.sql.exec.<ScanNode> keys); the port has no CPU route, so
#: a disabled scan raises
FILE_SCAN_ENABLED = {
    fmt: _conf(f"spark.rapids.sql.exec.{cls}", True,
               f"Enable {fmt} scans on the accelerator.", _to_bool)
    for fmt, cls in (("parquet", "ParquetScanNode"),
                     ("orc", "OrcScanNode"),
                     ("avro", "AvroScanNode"), ("csv", "CsvScanNode"),
                     ("json", "JsonScanNode"),
                     ("hiveText", "HiveTextScanNode"))}


class RapidsConf:
    """A typed view over a plain ``{key: value}`` dict."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings = dict(settings or {})
        unknown = sorted(k for k in self._settings if k not in _REGISTRY)
        if unknown:
            raise NotImplementedError(
                f"conf keys not supported by the port: {unknown}")

    def to_dict(self) -> Dict[str, Any]:
        """The explicitly set ``{key: value}`` pairs."""
        return dict(self._settings)

    def get_entry(self, entry: ConfEntry):
        if entry.key in self._settings:
            return entry.conv(self._settings[entry.key])
        return entry.default
