"""Metric registry (a minimal copy of ``spark_rapids_tpu/obs/metrics.py``).

A metric name maps to a kind (``timing`` seconds, ``count``, ``bytes``)
and a collection level. Subsystems that are not operators (the memory
arbiter, the spill catalog, the task semaphore) record into named
process-wide scopes fetched with :func:`metric_scope`; the session reads
a query's counters as the difference of the scopes around it
(``TorchSession.last_metrics``). An exec's metrics honour the level
filter (``spark.rapids.sql.metrics.level``, :func:`set_metrics_level`):
a metric whose level is above the query's is not recorded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from spark_rapids_tpu_torch.lockorder import ordered_lock

METRIC_LEVELS = ("ESSENTIAL", "MODERATE", "DEBUG")
METRIC_KINDS = ("timing", "count", "bytes")


@dataclass(frozen=True)
class MetricSpec:
    name: str
    kind: str
    level: str
    doc: str = ""


_SPECS: Dict[str, MetricSpec] = {}
_SPEC_LOCK = ordered_lock("obs.metrics.spec")


def register_metric(name: str, kind: str = "count",
                    level: str = "MODERATE", doc: str = "") -> MetricSpec:
    """Declare a typed metric. Re-registering the same kind and level is
    a no-op; a conflicting one raises."""
    if kind not in METRIC_KINDS:
        raise ValueError(f"unknown metric kind {kind!r} for {name!r}")
    if level not in METRIC_LEVELS:
        raise ValueError(f"unknown metric level {level!r} for {name!r}")
    with _SPEC_LOCK:
        old = _SPECS.get(name)
        if old is not None:
            if (old.kind, old.level) != (kind, level):
                raise ValueError(
                    f"metric {name!r} re-registered as ({kind}, {level}) "
                    f"but is already ({old.kind}, {old.level})")
            return old
        spec = _SPECS[name] = MetricSpec(name, kind, level, doc)
        return spec


def spec_for(name: str) -> MetricSpec:
    """The spec of a metric name; an undeclared name gets an inferred one
    (``*Time`` -> timing, ``*Bytes*`` -> bytes, else count) at MODERATE,
    as the reference's."""
    spec = _SPECS.get(name)
    if spec is not None:
        return spec
    if name.endswith("Time") or name.endswith("TimeS"):
        kind = "timing"
    elif "Bytes" in name or name.endswith("bytes"):
        kind = "bytes"
    else:
        kind = "count"
    return MetricSpec(name, kind, "MODERATE")


_LEVEL_RANK = {lvl: i for i, lvl in enumerate(METRIC_LEVELS)}
#: the active collection level's rank (set per query by the session)
_ACTIVE_LEVEL = [_LEVEL_RANK["MODERATE"]]


def set_metrics_level(level: str) -> None:
    """The query's ``spark.rapids.sql.metrics.level``: ESSENTIAL,
    MODERATE or DEBUG; anything else raises naming the key."""
    lvl = str(level).strip().upper()
    if lvl not in _LEVEL_RANK:
        raise ValueError(f"spark.rapids.sql.metrics.level={level!r}: want "
                         f"one of {', '.join(METRIC_LEVELS)}")
    _ACTIVE_LEVEL[0] = _LEVEL_RANK[lvl]


def level_allows(name: str) -> bool:
    """Is metric ``name`` collected at the active level?"""
    return _LEVEL_RANK[spec_for(name).level] <= _ACTIVE_LEVEL[0]


def typed(metrics: Dict[str, object]) -> Dict[str, dict]:
    """{name: {value, kind, level}}: the event log's rendering."""
    out = {}
    for k, v in sorted(metrics.items()):
        spec = spec_for(k)
        out[k] = {"value": v, "kind": spec.kind, "level": spec.level}
    return out


def registered_specs() -> Dict[str, MetricSpec]:
    with _SPEC_LOCK:
        return dict(_SPECS)


class LockedMetricSet(dict):
    """A process-wide scope: a dict of name -> value whose ``add`` is
    atomic (scopes are written from several query threads at once)."""

    def __init__(self):
        super().__init__()
        self._lock = ordered_lock("obs.metrics.scope")

    def add(self, key: str, value) -> None:
        with self._lock:
            self[key] = self.get(key, 0) + value

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return dict(self)


_SCOPES: Dict[str, LockedMetricSet] = {}
_SCOPE_LOCK = ordered_lock("obs.metrics.scopes")


def metric_scope(name: str) -> LockedMetricSet:
    """The named process-wide scope (``memory``, ``spill``,
    ``semaphore``), created on first use."""
    with _SCOPE_LOCK:
        s = _SCOPES.get(name)
        if s is None:
            s = _SCOPES[name] = LockedMetricSet()
        return s


def scopes_snapshot() -> Dict[str, Dict[str, object]]:
    """{scope: {name: value}} of every scope."""
    with _SCOPE_LOCK:
        scopes = dict(_SCOPES)
    return {name: s.snapshot() for name, s in scopes.items()}
