"""Metric registry (a minimal copy of ``spark_rapids_tpu/obs/metrics.py``).

A metric name maps to a kind (``timing`` seconds, ``count``, ``bytes``)
and a collection level. Subsystems that are not operators (the memory
arbiter, the spill catalog, the task semaphore) record into named
process-wide scopes fetched with :func:`metric_scope`; the session reads
a query's counters as the difference of the scopes around it
(``TorchSession.last_metrics``). Every metric is collected: the
reference's level filter (``spark.rapids.sql.metrics.level``) is not
ported.
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
