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

AGG_MAX_DICT_GROUPS = _conf(
    "spark.rapids.tpu.agg.maxDictGroups", 1 << 16,
    "Max key-domain product for the no-sort dictionary-code aggregation "
    "fast path.", int)



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
