"""Incrementally-maintained materialized views (port of
``spark_rapids_tpu/streaming/mv.py``).

Register a plan as an MV and the registry keeps a maintained HostTable
current against the Delta tables the plan reads. Table-scoped
invalidation epochs (plan/fingerprint.bump_table_epoch, fired from
DeltaLog.commit) are the trigger: a commit to a base table marks the
view stale, and the NEXT read refreshes it by *delta recomputation* —
running the plan over the table's CDF rows since the view's last epoch —
instead of recomputing from scratch:

* ``append``  — (Project|Filter)* over one Delta scan, insert-only delta:
  run the chain over just the change rows and append.
* ``reaggregate`` — Aggregate over such a chain with plain-column keys:
  find the group keys the delta touches, recompute ONLY those groups
  against the new snapshot (a filtered run of the original plan), and
  splice them over the maintained rows. Per-group accumulation order is
  the scan order either way, so the incremental result is bit-identical
  to a full recompute at the same epoch.
* ``full``    — everything else (joins, renamed keys, non-insert deltas
  when appending, too many touched groups): recompute at the target
  version. The chosen strategy and any fallback reason surface in
  ``explain()``.

MV maintenance deliberately does NOT touch the service result cache:
the epoch API is the only coupling. Every refresh plan (the change rows
through the chain, the touched groups' recompute, a full recompute) and
every serve runs through the session on the card.
"""

from __future__ import annotations

import copy
import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar.table import HostTable, concat_host
from spark_rapids_tpu_torch.conf import (
    STREAMING_MV_INCREMENTAL,
    STREAMING_MV_MAX_TOUCHED_GROUPS,
)
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.plan.fingerprint import (
    plan_table_ids,
    register_epoch_listener,
    unregister_epoch_listener,
)
from spark_rapids_tpu_torch.streaming.metrics import STREAM_METRICS
from spark_rapids_tpu_torch.lockorder import ordered_lock

__all__ = ["MaterializedView", "MaterializedViewRegistry"]


def _clone_with_children(node, children: tuple):
    """Shallow-copy a plan node onto replacement children. Sound because
    every replacement child preserves the original child's output
    schema, so bound expressions (ordinals) stay valid."""
    new = copy.copy(node)
    new.children = tuple(children)
    return new


def _rebuild_chain(chain: List, leaf):
    """Re-root a (Project|Filter)* chain (outermost first) onto ``leaf``."""
    node = leaf
    for op in reversed(chain):
        node = _clone_with_children(op, (node,))
    return node


class MaterializedView:
    """One registered view; refreshed under its own lock."""

    def __init__(self, name: str, plan, session):
        from spark_rapids_tpu_torch.delta.table import DeltaScanNode
        from spark_rapids_tpu_torch.plan import nodes as P

        self.name = name
        self.plan = plan
        self.session = session
        self.table_ids = plan_table_ids(plan)
        if not self.table_ids:
            raise ColumnarProcessingError(
                f"materialized view {name!r} reads no Delta table; "
                "register a plan with at least one Delta scan")
        self._refresh_lock = ordered_lock("streaming.mv.refresh")
        self._stale = threading.Event()
        self._stale.set()
        self.table: Optional[HostTable] = None
        #: per-base-table Delta version the maintained table reflects
        self.versions: Dict[str, int] = {}
        self.refreshes = 0
        self.incremental_refreshes = 0
        self.full_recomputes = 0
        self.last_refresh_mode = "none"
        self.fallback_reason: Optional[str] = None

        # -- strategy detection (by plan shape) ---------------------------
        self.strategy = "full"
        self._chain: List = []
        self._scan = None
        self._agg = None
        node, chain = plan, []
        while isinstance(node, (P.Project, P.Filter)):
            chain.append(node)
            node = node.children[0]
        if isinstance(node, DeltaScanNode):
            self.strategy, self._chain, self._scan = "append", chain, node
        elif isinstance(node, P.Aggregate) and not chain:
            agg, inner, chain2 = node, node.children[0], []
            while isinstance(inner, (P.Project, P.Filter)):
                chain2.append(inner)
                inner = inner.children[0]
            from spark_rapids_tpu_torch.ops.expr import BoundReference
            keys_ok = bool(agg.grouping) and all(
                isinstance(g, BoundReference) for g in agg.grouping)
            if isinstance(inner, DeltaScanNode) and keys_ok:
                self.strategy = "reaggregate"
                self._chain, self._scan, self._agg = chain2, inner, agg
            else:
                self.fallback_reason = (
                    "aggregate keys are not plain columns" if
                    isinstance(inner, DeltaScanNode)
                    else "aggregate input is not a Delta scan chain")
        else:
            self.fallback_reason = "plan shape outside the incremental whitelist"

    # -- epoch bookkeeping ---------------------------------------------------
    @property
    def stale(self) -> bool:
        return self._stale.is_set()

    def mark_stale(self) -> None:
        self._stale.set()

    def epoch(self) -> int:
        """The maintained table's epoch: the newest base-table version it
        reflects (single-table views have exactly one)."""
        return max(self.versions.values()) if self.versions else -1

    def _base_paths(self) -> List[str]:
        import os
        return [tid[len("delta:"):] if tid.startswith("delta:") else tid
                for tid in sorted(self.table_ids)] if self._scan is None \
            else [os.path.abspath(self._scan.table_path)]

    # -- refresh -------------------------------------------------------------
    def refresh(self) -> str:
        """Bring the maintained table to the base tables' current
        versions; returns the refresh mode used (``"noop"`` when already
        current)."""
        from spark_rapids_tpu_torch.delta.log import DeltaLog
        with self._refresh_lock:
            targets = {p: DeltaLog(p).latest_version()
                       for p in self._base_paths()}
            if (self.table is not None
                    and targets == self.versions and not self.stale):
                return "noop"
            self._stale.clear()
            if targets == self.versions and self.table is not None:
                return "noop"
            mode = self._refresh_locked(targets)
            self.versions = targets
            self.refreshes += 1
            STREAM_METRICS.add("mvRefreshes", 1)
            if mode.startswith("incremental"):
                self.incremental_refreshes += 1
                STREAM_METRICS.add("mvIncrementalRefreshes", 1)
            else:
                self.full_recomputes += 1
                STREAM_METRICS.add("mvFullRecomputes", 1)
            self.last_refresh_mode = mode
            return mode

    def _refresh_locked(self, targets: Dict[str, int]) -> str:
        incremental_on = bool(
            self.session.conf.get_entry(STREAMING_MV_INCREMENTAL))
        if (self.table is None or self.strategy == "full"
                or not incremental_on):
            if self.table is not None and self.strategy != "full" \
                    and not incremental_on:
                self.fallback_reason = \
                    "spark.rapids.streaming.mv.incremental.enabled=false"
            return self._full_recompute(targets)
        base = self._base_paths()[0]
        lo, hi = self.versions.get(base, -1) + 1, targets[base]
        try:
            changes = self._collect_changes(base, lo, hi)
        except ColumnarProcessingError as e:
            self.fallback_reason = f"CDF unavailable: {e}"
            return self._full_recompute(targets)
        if self.strategy == "append":
            return self._refresh_append(changes, targets)
        return self._refresh_reaggregate(changes, targets)

    def _collect_changes(self, base: str, lo: int, hi: int) -> HostTable:
        from spark_rapids_tpu_torch.delta.commands import DeltaTable
        df = DeltaTable(self.session, base).table_changes(lo, hi)
        return self.session.execute(df.plan)

    def _project_to_scan_schema(self, changes: HostTable) -> HostTable:
        names = [n for n, _ in self._scan.output_schema()]
        return HostTable(names, [_column(changes, n) for n in names])

    def _run(self, plan) -> HostTable:
        return self.session.execute(plan)

    def _full_recompute(self, targets: Dict[str, int]) -> str:
        self.session.stage_stream_delta("mvRefreshes")
        self.session.stage_stream_delta("mvFullRecomputes")
        self.table = self._run(self._pinned_plan(targets))
        return "full-recompute"

    def _pinned_plan(self, targets: Dict[str, int]):
        """The registered plan with every Delta scan replaced by a fresh
        scan pinned at the target version (also the bit-identity oracle:
        pin at ``self.versions`` to recompute the CURRENT epoch)."""
        import os

        from spark_rapids_tpu_torch.delta.table import DeltaScanNode

        def rebuild(node):
            if isinstance(node, DeltaScanNode):
                return DeltaScanNode(
                    node.table_path, node.conf,
                    version_as_of=targets[os.path.abspath(node.table_path)],
                    columns=node.columns)
            kids = tuple(rebuild(c) for c in getattr(node, "children", ()))
            return _clone_with_children(node, kids) if kids else node

        return rebuild(self.plan)

    def recompute_at_epoch(self) -> HostTable:
        """From-scratch recompute at the maintained epoch (does not touch
        the maintained table) — the tests' bit-identity oracle."""
        with self._refresh_lock:
            return self._run(self._pinned_plan(dict(self.versions)))

    # -- append strategy -----------------------------------------------------
    def _refresh_append(self, changes: HostTable,
                        targets: Dict[str, int]) -> str:
        from spark_rapids_tpu_torch.plan import nodes as P
        kinds = set(_column(changes, "_change_type").to_pylist())
        if kinds - {"insert"}:
            self.fallback_reason = \
                f"non-insert changes for append view: {sorted(kinds)}"
            return self._full_recompute(targets)
        if changes.num_rows:
            self.session.stage_stream_delta("mvRefreshes")
            self.session.stage_stream_delta("mvIncrementalRefreshes")
            leaf = P.LocalScan([self._project_to_scan_schema(changes)])
            delta = self._run(_rebuild_chain(self._chain, leaf))
            self.table = concat_host([self.table, delta])
        return "incremental-append"

    # -- reaggregate strategy ------------------------------------------------
    def _key_source_columns(self) -> List[str]:
        child_schema = self._agg.children[0].output_schema()
        return [child_schema[g.ordinal][0] for g in self._agg.grouping]

    def _touched_keys(self, changes: HostTable) -> Set[Tuple]:
        """Distinct group-key tuples the delta touches, AFTER the chain
        below the aggregate (its filters decide group membership; a
        deleted row's key still lands here because its values evaluate
        the same predicates they passed when inserted)."""
        from spark_rapids_tpu_torch.plan import nodes as P
        if not changes.num_rows:
            return set()
        leaf = P.LocalScan([self._project_to_scan_schema(changes)])
        filtered = self._run(_rebuild_chain(self._chain, leaf))
        cols = [_column(filtered, n).to_pylist()
                for n in self._key_source_columns()]
        return set(zip(*cols)) if cols else set()

    def _refresh_reaggregate(self, changes: HostTable,
                             targets: Dict[str, int]) -> str:
        from spark_rapids_tpu_torch.ops.expr import col, lit
        from spark_rapids_tpu_torch.plan import nodes as P
        touched = self._touched_keys(changes)
        if not touched:
            return "incremental-reaggregate"
        max_groups = int(
            self.session.conf.get_entry(STREAMING_MV_MAX_TOUCHED_GROUPS))
        if len(touched) > max_groups:
            self.fallback_reason = (
                f"{len(touched)} touched groups > "
                f"spark.rapids.streaming.mv.maxTouchedGroups={max_groups}")
            return self._full_recompute(targets)
        # recompute ONLY the touched groups against the new snapshot:
        # scan@target -> chain -> keep touched keys -> original aggregate
        base = self._base_paths()[0]
        key_cols = self._key_source_columns()
        pred = None
        for tup in sorted(touched, key=repr):
            conj = None
            for c, v in zip(key_cols, tup):
                term = col(c) == lit(v)
                conj = term if conj is None else (conj & term)
            pred = conj if pred is None else (pred | conj)
        pinned = self._pinned_plan({base: targets[base]})
        # pinned is Aggregate over chain over fresh scan; splice the
        # touched-keys filter between aggregate and its input
        agg_in = pinned.children[0]
        self.session.stage_stream_delta("mvRefreshes")
        self.session.stage_stream_delta("mvIncrementalRefreshes")
        recomputed = self._run(_clone_with_children(
            pinned, (P.Filter(agg_in, pred),)))
        self._splice_groups(touched, recomputed)
        return "incremental-reaggregate"

    def _splice_groups(self, touched: Set[Tuple],
                       recomputed: HostTable) -> None:
        """Replace maintained rows whose key is touched with the freshly
        recomputed groups (order: surviving rows keep their order,
        recomputed groups append — MV equality is row-set equality)."""
        key_names = list(self._agg.grouping_names)
        maintained = self.table
        key_lists = [_column(maintained, n).to_pylist() for n in key_names]
        keep = np.asarray([i for i, tup in enumerate(zip(*key_lists))
                           if tup not in touched], dtype=np.int64)
        kept = HostTable(maintained.names,
                         [c.take(keep) for c in maintained.columns])
        self.table = concat_host([kept, recomputed]) \
            if recomputed.num_rows else kept

    # -- serving -------------------------------------------------------------
    def read(self) -> HostTable:
        """Serve the view (refreshing first if stale) THROUGH the session
        so the serve lands in the event log with the view's epoch
        (schema v11 ``mvEpoch``)."""
        from spark_rapids_tpu_torch.plan import nodes as P
        if self.stale or self.table is None:
            self.refresh()
        with self._refresh_lock:
            table, epoch = self.table, self.epoch()
        self.session.next_query_mv_epoch = epoch
        self.session.next_query_tag = f"mv:{self.name}@v{epoch}"
        return self.session.execute(P.LocalScan([table]))

    def explain(self) -> str:
        lines = [
            f"MaterializedView[{self.name}]",
            f"  strategy={self.strategy}"
            + (f" (fallback: {self.fallback_reason})"
               if self.strategy == "full" and self.fallback_reason else ""),
            f"  epoch=v{self.epoch()} stale={self.stale}",
            f"  refreshes={self.refreshes} "
            f"(incremental={self.incremental_refreshes}, "
            f"full={self.full_recomputes})",
            f"  lastRefresh={self.last_refresh_mode}"
            + (f" (fallback: {self.fallback_reason})"
               if self.last_refresh_mode == "full-recompute"
               and self.fallback_reason else ""),
        ]
        return "\n".join(lines)

    def describe(self) -> dict:
        return {
            "name": self.name,
            "kind": "materialized-view",
            "strategy": self.strategy,
            "epoch": self.epoch(),
            "stale": self.stale,
            "refreshes": self.refreshes,
            "incrementalRefreshes": self.incremental_refreshes,
            "fullRecomputes": self.full_recomputes,
            "rows": self.table.num_rows if self.table is not None else 0,
        }


def _column(table: HostTable, name: str):
    """The column of ``table`` named ``name``."""
    return table.columns[list(table.names).index(name)]


class MaterializedViewRegistry:
    """Named MVs over one session, wired to the table-scoped epoch bus."""

    def __init__(self, session):
        self.session = session
        self._lock = ordered_lock("streaming.mv.registry")
        self._views: Dict[str, MaterializedView] = {}
        register_epoch_listener(self._on_epoch)
        self._closed = False

    def _on_epoch(self, table_id: Optional[str], epoch: int,
                  reason: str) -> None:
        # fired from inside DeltaLog.commit — only MARK here; the
        # refresh itself runs on the next read (or explicit refresh())
        with self._lock:
            views = list(self._views.values())
        for v in views:
            if table_id is None or table_id in v.table_ids:
                v.mark_stale()

    def register(self, name: str, df, refresh: bool = True) \
            -> MaterializedView:
        plan = df.plan if hasattr(df, "plan") else df
        mv = MaterializedView(name, plan, self.session)
        with self._lock:
            if self._closed:
                raise ColumnarProcessingError("MV registry is closed")
            if name in self._views:
                raise ColumnarProcessingError(
                    f"materialized view {name!r} already registered")
            self._views[name] = mv
        if refresh:
            mv.refresh()
        return mv

    def get(self, name: str) -> MaterializedView:
        with self._lock:
            mv = self._views.get(name)
        if mv is None:
            raise ColumnarProcessingError(
                f"no materialized view named {name!r}")
        return mv

    def drop(self, name: str) -> None:
        with self._lock:
            self._views.pop(name, None)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._views)

    def describe(self) -> List[dict]:
        with self._lock:
            views = list(self._views.values())
        return [v.describe() for v in views]

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._views.clear()
        unregister_epoch_listener(self._on_epoch)
