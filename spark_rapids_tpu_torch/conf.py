"""Typed configuration (the entries of ``spark_rapids_tpu/conf.py`` that
the ported path reads; keys and defaults are the reference's).

A key the port does not know raises: silently ignoring, say,
``spark.rapids.sql.enabled=false`` would run a query the caller asked to
keep off the device."""

from __future__ import annotations

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
    "bucket pairs join independently. The reference also caps it by its "
    "memory manager's scan chunk; the port, which has no memory manager, "
    "uses this value alone. 0 disables.", int)

JOIN_MAX_SUBPARTITIONS = _conf(
    "spark.rapids.sql.join.maxSubPartitions", 64,
    "Upper bound on hash sub-partitions when a join's build side exceeds "
    "the sub-partitioning threshold.", int)


class RapidsConf:
    """A typed view over a plain ``{key: value}`` dict."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings = dict(settings or {})
        unknown = sorted(k for k in self._settings if k not in _REGISTRY)
        if unknown:
            raise NotImplementedError(
                f"conf keys not supported by the port: {unknown}")

    def get_entry(self, entry: ConfEntry):
        if entry.key in self._settings:
            return entry.conv(self._settings[entry.key])
        return entry.default
