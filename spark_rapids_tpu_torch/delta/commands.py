"""Delta DML commands: DELETE, UPDATE, MERGE, OPTIMIZE (+Z-ORDER), VACUUM,
the change data feed and the table's metadata commands (port of
``spark_rapids_tpu/delta/commands.py``).

Reference (SURVEY.md §2.8): ``GpuDeleteCommand`` / ``GpuUpdateCommand`` /
``GpuMergeIntoCommand`` (+``GpuLowShuffleMergeCommand``), ``GpuOptimize``
and Z-ORDER, all inside ``GpuOptimisticTransaction`` commits.

As in the JAX package, the commands work per file on the host: a data
file decodes through the port's Parquet codec, the condition evaluates
through the expression's host evaluation (``eval_cpu``), and the
deletion-vector bookkeeping and Z-ORDER's stable sort are numpy:

- DELETE: files whose every row matches are removed; partially matched
  files get a deletion vector (merged with any existing one);
- UPDATE: matched files are rewritten (surviving rows, updates applied);
- MERGE: equi-key merge (a numpy sort-merge of the live, non-null keys,
  where the reference runs a pandas inner merge): matched rows update or
  delete, unmatched source rows insert; touched target files rewrite, or,
  low-shuffle, lose the matched rows through a deletion vector;
- OPTIMIZE: bin-packs small files; ZORDER BY reorders rows by the
  interleaved-bits key before rewriting;
- VACUUM: removes data files the latest snapshot no longer references.

Reads of the table (``to_df``, ``table_changes``) and MERGE's source run
through the session on the card."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.columnar.table import concat_host
from spark_rapids_tpu_torch.delta.log import (AddFile, DeltaLog, Metadata,
                                              RemoveFile,
                                              schema_fields_from_json)
from spark_rapids_tpu_torch.delta.table import (
    DeltaScanNode,
    OptimisticTransaction,
    _mask_table,
    _write_data_file,
    read_dv,
    write_dv_file,
)
from spark_rapids_tpu_torch.delta.zorder import zorder_sort_indexes
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.io import parquet_format as PF
from spark_rapids_tpu_torch.ops.expr import Expression, bind


def _cast_col(col: HostColumn, dt) -> HostColumn:
    if col.dtype.simple_string() == dt.simple_string():
        return col
    from spark_rapids_tpu_torch.ops.cast import _cast_data_np
    return HostColumn(dt, _cast_data_np(col.data, col.dtype, dt),
                      col.validity)


def _read_physical(table_path: str, add: AddFile, schema,
                   physical: Optional[Dict[str, str]] = None) -> HostTable:
    """One data file's PHYSICAL rows (no DV applied) as the TABLE data
    schema — delegates to the single shared reader (table.py
    read_physical_parquet). ``physical``: logical->physical name map when
    the table uses column mapping."""
    from spark_rapids_tpu_torch.delta.table import read_physical_parquet
    return read_physical_parquet(os.path.join(table_path, add.path),
                                 schema, physical)


from spark_rapids_tpu_torch.delta.table import \
    attach_partition_columns as _with_partitions  # shared with the scan

def _const_strings(n: int, value: str) -> HostColumn:
    """An n-row string column of one value, its codes seeded."""
    data = np.empty(n, dtype=object)
    data[:] = value
    col = HostColumn(T.STRING, data)
    col._cache["encode"] = (np.zeros(n, dtype=np.int32),
                            np.array([value] if n else [], dtype=object))
    return col


# -- change data feed --------------------------------------------------------
#: cdc files land here (Delta protocol _change_data/ + cdc actions)
CDF_DIR = "_change_data"


def _cdc_rows(full_table: HostTable, mask: np.ndarray,
              change_type: str) -> HostTable:
    """Selected rows + the protocol's _change_type column."""
    sub = _mask_table(full_table, mask)
    ct = _const_strings(sub.num_rows, change_type)
    return HostTable(list(sub.names) + ["_change_type"],
                     list(sub.columns) + [ct])


def _write_cdc_file(table_path: str, tables: List[HostTable],
                    physical: Optional[Dict[str, str]] = None
                    ) -> Optional[dict]:
    """One cdc parquet under _change_data/ + its raw ``cdc`` log action
    (reference: delta's AddCDCFile; GpuDeltaCatalog handles these through
    the same commitLarge path as adds). The engine writes FULL logical
    rows (incl. partition columns) into the cdc file — simpler than the
    protocol's partitionValues split and round-trips through
    table_changes exactly."""
    import uuid as _uuid
    tables = [t for t in tables if t.num_rows]
    if not tables:
        return None
    table = concat_host(tables)
    os.makedirs(os.path.join(table_path, CDF_DIR), exist_ok=True)
    rel = os.path.join(CDF_DIR, f"cdc-{_uuid.uuid4().hex}.parquet")
    full = os.path.join(table_path, rel)
    if physical:
        table = HostTable([physical.get(n, n) for n in table.names],
                          list(table.columns))
    PF.write_table(table, full)
    return {"cdc": {"path": rel, "partitionValues": {},
                    "size": os.path.getsize(full), "dataChange": False}}


class DeltaTable:
    """User API (io.delta.tables.DeltaTable analog)."""

    def __init__(self, session, table_path: str):
        self.session = session
        self.table_path = table_path
        self.log = DeltaLog(table_path)
        if not self.log.exists():
            raise ColumnarProcessingError(
                f"{table_path} is not a delta table")

    # -- read ----------------------------------------------------------------
    def to_df(self, version_as_of: Optional[int] = None):
        from spark_rapids_tpu_torch.plan.dataframe import DataFrame
        return DataFrame(
            DeltaScanNode(self.table_path, self.session.conf,
                          version_as_of=version_as_of), self.session)

    def history(self) -> List[dict]:
        return self.log.history()

    def version(self) -> int:
        return self.log.latest_version()

    # -- shared helpers ------------------------------------------------------
    @staticmethod
    def _phys(snap) -> Optional[Dict[str, str]]:
        """logical->physical map when the table uses column mapping."""
        m = snap.metadata
        if m is None or m.column_mapping_mode() == "none":
            return None
        return m.physical_names()

    def _ctx(self):
        snap = self.log.snapshot()
        parts = set(snap.metadata.partition_columns)
        data_schema = [(n, dt) for n, dt in snap.schema if n not in parts]
        part_schema = [(n, dt) for n, dt in snap.schema if n in parts]
        return snap, data_schema, part_schema

    def _eval_mask(self, cond: Expression, table: HostTable) -> np.ndarray:
        bound = bind(cond, table.schema())
        res = bound.eval_cpu(table)
        return np.asarray(res.data, dtype=bool) & res.validity

    # -- DELETE --------------------------------------------------------------
    def delete(self, condition: Optional[Expression] = None) -> dict:
        """Returns {"num_affected_rows": N}; deletion-vector write path
        for partial files (GpuDeleteCommand + DV support)."""
        snap, data_schema, part_schema = self._ctx()
        pmap = self._phys(snap)
        cdf = snap.metadata.cdf_enabled()
        cdc_tables: List[HostTable] = []
        txn = OptimisticTransaction(self.log, self.session.conf,
                                    read_version=snap.version,
                                    session=self.session)
        now = int(time.time() * 1000)
        affected = 0
        for add in snap.files:
            if condition is None and not cdf:
                n = add.num_records
                if n is None:
                    n = _read_physical(self.table_path, add,
                                       data_schema, physical=pmap).num_rows
                if add.deletion_vector:
                    # stats count PHYSICAL rows; already-deleted ones are
                    # not affected by this delete
                    n -= add.deletion_vector.get("cardinality", 0)
                affected += max(n, 0)
                txn.stage(RemoveFile(add.path, now))
                continue
            phys = _read_physical(self.table_path, add, data_schema,
                                  physical=pmap)
            full = _with_partitions(phys, add, part_schema)
            matched = (np.ones(phys.num_rows, dtype=bool)
                       if condition is None
                       else self._eval_mask(condition, full))
            already = np.zeros(phys.num_rows, dtype=bool)
            if add.deletion_vector:
                dv = read_dv(self.table_path, add.deletion_vector)
                already[dv[dv < phys.num_rows]] = True
            new_hits = matched & ~already
            if not new_hits.any():
                continue
            affected += int(new_hits.sum())
            if cdf:
                cdc_tables.append(_cdc_rows(full, new_hits, "delete"))
            total = already | matched
            if total.all():
                txn.stage(RemoveFile(add.path, now))
            else:
                desc = write_dv_file(self.table_path,
                                     np.flatnonzero(total).astype(np.int64))
                txn.stage(RemoveFile(add.path, now, data_change=False))
                txn.stage(AddFile(
                    path=add.path, partition_values=add.partition_values,
                    size=add.size, modification_time=now,
                    data_change=False, stats=add.stats,
                    deletion_vector=desc))
        if cdf:
            cdc = _write_cdc_file(self.table_path, cdc_tables, pmap)
            if cdc is not None:
                txn.stage(cdc)
        if txn.actions:
            txn.commit("DELETE")
        return {"num_affected_rows": affected}

    # -- UPDATE --------------------------------------------------------------
    def update(self, condition: Optional[Expression],
               set: Dict[str, Expression]) -> dict:  # noqa: A002
        """Copy-on-write rewrite of matched files (GpuUpdateCommand)."""
        snap, data_schema, part_schema = self._ctx()
        part_names = {n for n, _ in part_schema}
        for c in set:
            if c in part_names:
                raise ColumnarProcessingError(
                    f"cannot UPDATE partition column {c!r}")
        pmap = self._phys(snap)
        cdf = snap.metadata.cdf_enabled()
        cdc_tables: List[HostTable] = []
        txn = OptimisticTransaction(self.log, self.session.conf,
                                    read_version=snap.version,
                                    session=self.session)
        now = int(time.time() * 1000)
        affected = 0
        for add in snap.files:
            phys = _read_physical(self.table_path, add, data_schema,
                                  physical=pmap)
            live = np.ones(phys.num_rows, dtype=bool)
            if add.deletion_vector:
                dv = read_dv(self.table_path, add.deletion_vector)
                live[dv[dv < phys.num_rows]] = False
            full = _with_partitions(phys, add, part_schema)
            matched = (np.ones(phys.num_rows, dtype=bool)
                       if condition is None
                       else self._eval_mask(condition, full)) & live
            if not matched.any():
                continue
            affected += int(matched.sum())
            # apply updates to matched rows over the LIVE subset
            out_cols = []
            schema = full.schema()
            for name, col in zip(full.names, full.columns):
                if name in set:
                    val = _cast_col(bind(set[name], schema).eval_cpu(full),
                                    col.dtype)
                    data = col.data.copy()
                    data[matched] = val.data[matched]
                    validity = np.where(matched, val.validity, col.validity)
                    out_cols.append(HostColumn(col.dtype, data, validity))
                else:
                    out_cols.append(col)
            updated = HostTable(list(full.names), out_cols)
            if cdf:
                cdc_tables.append(_cdc_rows(full, matched,
                                            "update_preimage"))
                cdc_tables.append(_cdc_rows(updated, matched,
                                            "update_postimage"))
            survivors = _mask_table(updated, live)
            data_only = HostTable(
                [n for n, _ in data_schema],
                [survivors.columns[list(survivors.names).index(n)]
                 for n, _ in data_schema])
            new_add = _write_data_file(
                self.table_path, data_only, add.partition_values,
                os.path.dirname(add.path), physical=pmap)
            txn.stage(RemoveFile(add.path, now), new_add)
        if cdf:
            cdc = _write_cdc_file(self.table_path, cdc_tables, pmap)
            if cdc is not None:
                txn.stage(cdc)
        if txn.actions:
            txn.commit("UPDATE")
        return {"num_affected_rows": affected}

    # -- MERGE ---------------------------------------------------------------
    def merge(self, source_df, on: Sequence[str]) -> "MergeBuilder":
        return MergeBuilder(self, source_df, list(on))

    # -- table properties / metadata commands --------------------------------
    def set_properties(self, props: Dict[str, str]) -> int:
        """Metadata-only commit updating table configuration (ALTER TABLE
        SET TBLPROPERTIES — how delta.enableChangeDataFeed turns on)."""
        snap = self.log.snapshot()
        m = snap.metadata
        cfg = dict(m.configuration)
        cfg.update(props)
        txn = OptimisticTransaction(self.log, self.session.conf,
                                    read_version=snap.version,
                                    session=self.session)
        txn.stage(Metadata(m.schema_json, m.partition_columns,
                           table_id=m.table_id, name=m.name,
                           configuration=cfg))
        return txn.commit("SET TBLPROPERTIES")

    def rename_column(self, old: str, new: str) -> int:
        """Rename WITHOUT rewriting any data file — the headline feature
        of Delta column mapping (reference: delta-lake column mapping
        support; GpuDeltaLog keeps the physical name in field metadata).
        First rename upgrades the table to columnMapping.mode=name,
        pinning every field's physicalName to its current name so
        existing files keep resolving."""
        snap = self.log.snapshot()
        m = snap.metadata
        fields = schema_fields_from_json(m.schema_json)
        if old not in [f["name"] for f in fields]:
            raise ColumnarProcessingError(
                f"no column {old!r} in {[f['name'] for f in fields]}")
        if new in [f["name"] for f in fields]:
            raise ColumnarProcessingError(f"column {new!r} already exists")
        if old in m.partition_columns:
            # existing AddFile.partitionValues are keyed by the current
            # name; renaming would null every old file's partition values
            raise ColumnarProcessingError(
                f"cannot rename partition column {old!r} (partitionValues "
                f"in the log are keyed by it)")
        cfg = dict(m.configuration)
        upgrading = m.column_mapping_mode() == "none"
        for i, f in enumerate(fields):
            md = dict(f.get("metadata") or {})
            if upgrading:
                md.setdefault("delta.columnMapping.physicalName", f["name"])
                md.setdefault("delta.columnMapping.id", i + 1)
            f["metadata"] = md
        if upgrading:
            cfg["delta.columnMapping.mode"] = "name"
            cfg["delta.columnMapping.maxColumnId"] = str(len(fields))
        for f in fields:
            if f["name"] == old:
                f["name"] = new
        parts = [new if c == old else c for c in m.partition_columns]
        schema_json = json.dumps({"type": "struct", "fields": fields})
        txn = OptimisticTransaction(self.log, self.session.conf,
                                    read_version=snap.version,
                                    session=self.session)
        if upgrading:
            # column mapping requires reader 2 / writer 5 per the protocol
            txn.stage({"protocol": {"minReaderVersion": 2,
                                    "minWriterVersion": 5}})
        txn.stage(Metadata(schema_json, parts, table_id=m.table_id,
                           name=m.name, configuration=cfg))
        return txn.commit("RENAME COLUMN")

    # -- change data feed reader ---------------------------------------------
    def table_changes(self, starting_version: int,
                      ending_version: Optional[int] = None):
        """DataFrame of row-level changes between versions (inclusive):
        table schema + _change_type + _commit_version. Commits carrying
        cdc actions read those files; plain add/remove commits derive
        insert/delete rows from the data files themselves (the Delta
        CDF read contract). A derived change goes through the deletion
        vectors: an added file's DV drops its dead rows from ``insert``,
        and a removed file reports as ``delete`` only the rows that were
        live before the commit and, when the commit re-adds the file with
        a DV, only the rows that DV newly deletes (the reference reports
        every physical row of the file)."""
        from spark_rapids_tpu_torch.delta.table import (
            _null_column,
            read_physical_parquet,
        )
        from spark_rapids_tpu_torch.plan import from_host_table
        latest = self.log.latest_version()
        end = latest if ending_version is None else min(ending_version,
                                                       latest)
        # parse the range's commit jsons ONCE; the CDF pre-check and the
        # change-derivation loop below share them (snapshot(v) per
        # version replays the whole log each time — O(V^2) in history)
        version_actions: List[Tuple[int, list]] = []
        for v in range(starting_version, end + 1):
            path = os.path.join(self.log.log_path, f"{v:020d}.json")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                version_actions.append(
                    (v, [json.loads(line) for line in f if line.strip()]))
        # Delta CDF contract: versions where delta.enableChangeDataFeed
        # was not set have no recorded change data. Deriving them from
        # add/remove actions invents changes — a deletion-vector partial
        # DELETE would surface every physical row of the file as
        # 'delete', survivors included — so the whole range must be
        # covered by the feed (DeltaErrors.changeDataNotRecorded). One
        # snapshot seeds the flag; metaData actions inside the range
        # update it forward.
        cdf_on = self.log.snapshot(
            min(starting_version, end)).metadata.cdf_enabled()
        for v, actions in version_actions:
            for a in actions:
                if "metaData" in a:
                    cfg = a["metaData"].get("configuration") or {}
                    cdf_on = cfg.get("delta.enableChangeDataFeed",
                                     "false").lower() == "true"
            if not cdf_on:
                raise ColumnarProcessingError(
                    f"change data was not recorded for version {v} "
                    f"(requested range [{starting_version}, {end}]): "
                    "delta.enableChangeDataFeed was not set; changes "
                    "are only readable from the version that enabled it")
        snap = self.log.snapshot(end)
        pmap = self._phys(snap)
        parts = set(snap.metadata.partition_columns)
        schema = snap.schema
        data_schema = [(n, dt) for n, dt in schema if n not in parts]
        part_schema = [(n, dt) for n, dt in schema if n in parts]
        out: List[HostTable] = []

        def _with_meta(tbl: HostTable, version: int,
                       change_type: Optional[str]) -> HostTable:
            names = list(tbl.names)
            cols = list(tbl.columns)
            if change_type is not None:
                names.append("_change_type")
                cols.append(_const_strings(tbl.num_rows, change_type))
            names.append("_commit_version")
            cols.append(HostColumn(T.LongType(), np.full(
                tbl.num_rows, version, dtype=np.int64)))
            return HostTable(names, cols)

        def _read_data_file(rel: str, pv: Dict[str, str],
                            dead: Optional[np.ndarray]) -> HostTable:
            add = AddFile(path=rel, partition_values=pv, size=0,
                          modification_time=0)
            tbl = _read_physical(self.table_path, add, data_schema,
                                 physical=pmap)
            tbl = _with_partitions(tbl, add, part_schema)
            if dead is not None and len(dead):
                keep = np.ones(tbl.num_rows, dtype=bool)
                keep[dead[dead < tbl.num_rows]] = False
                tbl = _mask_table(tbl, keep)
            # SCHEMA order, matching the cdc branch: concat_host is
            # positional
            by = dict(zip(tbl.names, tbl.columns))
            order = [n for n, _ in schema]
            return HostTable(order, [by[n] for n in order])

        def _dv(desc) -> np.ndarray:
            return (read_dv(self.table_path, desc) if desc
                    else np.zeros(0, dtype=np.int64))

        for v, actions in version_actions:
            cdcs = [a["cdc"] for a in actions if "cdc" in a]
            if cdcs:
                cdc_schema = list(schema) + [("_change_type",
                                             T.StringType())]
                for c in cdcs:
                    tbl = read_physical_parquet(
                        os.path.join(self.table_path, c["path"]),
                        cdc_schema, pmap)
                    out.append(_with_meta(tbl, v, None))
                continue
            readds = {a["add"]["path"]: a["add"] for a in actions
                      if "add" in a and not a["add"].get("dataChange", True)}
            before = None
            for a in actions:
                if "add" in a and a["add"].get("dataChange", True):
                    ad = a["add"]
                    out.append(_with_meta(
                        _read_data_file(ad["path"],
                                        ad.get("partitionValues", {}),
                                        _dv(ad.get("deletionVector"))),
                        v, "insert"))
                elif "remove" in a and a["remove"].get("dataChange", True):
                    rel = a["remove"]["path"]
                    if not os.path.exists(os.path.join(self.table_path,
                                                       rel)):
                        continue
                    if before is None:
                        before = {f.path: f for f in (
                            self.log.snapshot(v - 1).files if v > 0
                            else [])}
                    prev = before.get(rel)
                    pv = a["remove"].get("partitionValues") or (
                        prev.partition_values if prev is not None else {})
                    dead = _dv(prev.deletion_vector if prev is not None
                               else None)
                    readd = readds.get(rel)
                    if readd is not None and readd.get("deletionVector"):
                        # a partial delete: the rows the new DV adds
                        n = _read_physical(
                            self.table_path,
                            AddFile(rel, pv, 0, 0), data_schema,
                            physical=pmap).num_rows
                        now_dead = np.zeros(n, dtype=bool)
                        nd = _dv(readd["deletionVector"])
                        now_dead[nd[nd < n]] = True
                        now_dead[dead[dead < n]] = False
                        dead = np.flatnonzero(~now_dead)
                    out.append(_with_meta(_read_data_file(rel, pv, dead),
                                          v, "delete"))
        if not out:
            empty = HostTable(
                [n for n, _ in schema] + ["_change_type",
                                          "_commit_version"],
                [_null_column(dt, 0) for _, dt in schema]
                + [_const_strings(0, ""),
                   HostColumn(T.LongType(), np.array([], np.int64))])
            return from_host_table(empty, self.session)
        return from_host_table(concat_host(out), self.session)

    # -- OPTIMIZE ------------------------------------------------------------
    def optimize(self, zorder_by: Optional[Sequence[str]] = None,
                 target_file_size: int = 128 << 20) -> dict:
        """Bin-pack small files; with zorder_by, rewrite ALL files in
        z-order (GpuOptimize / Z-ORDER BY)."""
        snap, data_schema, part_schema = self._ctx()
        txn = OptimisticTransaction(self.log, self.session.conf,
                                    read_version=snap.version,
                                    session=self.session)
        now = int(time.time() * 1000)
        # group files by partition (optimize never crosses partitions)
        groups: Dict[tuple, List[AddFile]] = {}
        for add in snap.files:
            key = tuple(sorted(add.partition_values.items()))
            groups.setdefault(key, []).append(add)
        removed = added = 0
        for key, adds in groups.items():
            if zorder_by is None:
                small = [a for a in adds if a.size < target_file_size]
                if len(small) < 2:
                    continue
                batch = small
            else:
                batch = adds
                if not batch:
                    continue
            tables = []
            pmap = self._phys(snap)
            for a in batch:
                phys = _read_physical(self.table_path, a, data_schema,
                                      physical=pmap)
                live = np.ones(phys.num_rows, dtype=bool)
                if a.deletion_vector:
                    dv = read_dv(self.table_path, a.deletion_vector)
                    live[dv[dv < phys.num_rows]] = False
                tables.append(_mask_table(phys, live))
            merged = concat_host(tables)
            if zorder_by is not None:
                zcols = [c for c in zorder_by
                         if c in [n for n, _ in data_schema]]
                if zcols:
                    order = zorder_sort_indexes(merged, zcols)
                    merged = merged.take(order)
            pv = dict(key)
            subdir = os.path.dirname(batch[0].path)
            new_add = _write_data_file(self.table_path, merged, pv, subdir,
                                       physical=pmap)
            for a in batch:
                txn.stage(RemoveFile(a.path, now, data_change=False))
            new_add.data_change = False
            txn.stage(new_add)
            removed += len(batch)
            added += 1
        if txn.actions:
            txn.commit("OPTIMIZE" if zorder_by is None
                       else "OPTIMIZE ZORDER")
        return {"files_removed": removed, "files_added": added}

    # -- VACUUM --------------------------------------------------------------
    def vacuum(self, dry_run: bool = False,
               retention_hours: Optional[float] = None) -> dict:
        """Delete data files not referenced by the LATEST snapshot.
        ``dry_run`` reports the orphans without touching them;
        ``retention_hours`` (default: the
        ``spark.rapids.delta.vacuum.retentionHours`` conf) keeps
        orphans younger than the window — a concurrent uncommitted
        transaction may still be about to commit them."""
        return vacuum_table(self.table_path, conf=self.session.conf,
                            dry_run=dry_run,
                            retention_hours=retention_hours)


def vacuum_table(table_path: str, conf=None, dry_run: bool = False,
                 retention_hours: Optional[float] = None) -> dict:
    """VACUUM over a Delta table directory: every file not referenced
    by the latest snapshot (data files, resolved deletion-vector files)
    is an orphan — leftovers of overwritten versions, failed/conflicted
    transactions, or jobs that died mid-write. ``tools vacuum`` and
    :meth:`DeltaTable.vacuum` share this implementation; no session
    needed."""
    from spark_rapids_tpu_torch.conf import (
        DELTA_VACUUM_RETENTION_HOURS,
        RapidsConf,
    )
    from spark_rapids_tpu_torch.delta.table import _dv_relative_path
    from spark_rapids_tpu_torch.io.committer import (
        WRITE_METRICS,
        unlink_and_prune,
        vacuum_protection,
    )
    conf = conf if conf is not None else RapidsConf()
    if retention_hours is None:
        retention_hours = float(
            conf.get_entry(DELTA_VACUUM_RETENTION_HOURS))
    log = DeltaLog(table_path)
    snap = log.snapshot()
    live = {a.path for a in snap.files}
    for a in snap.files:
        dv = a.deletion_vector
        if not dv:
            continue
        # resolve the descriptor to the ON-DISK relative path ('u'
        # storage encodes a base85 uuid, not a filename — matching the
        # raw pathOrInlineDv would sweep every live DV file)
        st = dv.get("storageType")
        if st == "u":
            live.add(_dv_relative_path(dv["pathOrInlineDv"]))
        elif st == "p":
            p = dv["pathOrInlineDv"]
            if not os.path.isabs(p):
                live.add(p)
    protected = vacuum_protection(table_path, retention_hours)
    orphans: List[str] = []
    for root, dirs, files in os.walk(table_path):
        dirs[:] = [d for d in dirs if d != "_delta_log"]
        for f in sorted(files):
            full = os.path.join(root, f)
            rel = os.path.relpath(full, table_path)
            if rel.startswith(CDF_DIR):
                # cdc files are owned by the change feed, not the
                # snapshot; without a retention clock vacuum leaves
                # them for table_changes
                continue
            if rel in live or protected(full):
                continue
            orphans.append(rel)
    deleted = 0
    if not dry_run:
        deleted = unlink_and_prune(table_path, orphans,
                                   keep_dirs=("_delta_log", CDF_DIR))
        if deleted:
            WRITE_METRICS.add("vacuumedFiles", deleted)
    return {"files_deleted": deleted, "orphans": orphans,
            "dry_run": bool(dry_run),
            "retention_hours": retention_hours}


def _key_codes(cols, n: int = -1) -> np.ndarray:
    """Dense int64 codes of the rows of the key columns ``cols`` (equal
    codes exactly where every column's values are equal; NaN equals NaN,
    as in pandas' merge)."""
    code = None
    for c in cols:
        uniq, inv = np.unique(c, return_inverse=True)
        inv = inv.reshape(-1).astype(np.int64)
        if code is None:
            code = inv
        else:
            _, code = np.unique(code * len(uniq) + inv, return_inverse=True)
            code = code.reshape(-1).astype(np.int64)
    return code if code is not None else np.zeros(max(n, 0), np.int64)


def _merge_match(tgt_keys, src_keys):
    """MERGE's key match as a sort-merge: (for each target row, the last
    source row with equal keys, else -1; which source rows equal some
    target row). The pairs are those of the reference's pandas inner
    merge; the last source row is the one its assignment keeps."""
    nt = len(tgt_keys[0])
    codes = _key_codes([np.concatenate([t, s_])
                        for t, s_ in zip(tgt_keys, src_keys)])
    tc, sc = codes[:nt], codes[nt:]
    order = np.argsort(sc, kind="stable")
    ss = sc[order]
    lo = np.searchsorted(ss, tc, "left")
    hi = np.searchsorted(ss, tc, "right")
    got = np.where(hi > lo, order[np.maximum(hi - 1, 0)], -1) if len(ss) \
        else np.full(nt, -1, dtype=np.int64)
    return got, np.isin(sc, tc)


class MergeBuilder:
    """merge(source, on).when_matched_update(set=...)
    .when_matched_delete().when_not_matched_insert().execute()"""

    def __init__(self, table: DeltaTable, source_df, on: List[str]):
        self.table = table
        self.source_df = source_df
        self.on = on
        self._update_set: Optional[Dict[str, str]] = None
        self._delete = False
        self._insert = False

    def when_matched_update(self, set: Dict[str, str]):  # noqa: A002
        """set maps target column -> SOURCE column name."""
        if self._delete:
            raise ColumnarProcessingError(
                "cannot combine when_matched_update with "
                "when_matched_delete (unconditional clauses are ambiguous)")
        self._update_set = dict(set)
        return self

    def when_matched_delete(self):
        if self._update_set is not None:
            raise ColumnarProcessingError(
                "cannot combine when_matched_update with "
                "when_matched_delete (unconditional clauses are ambiguous)")
        self._delete = True
        return self

    def when_not_matched_insert(self):
        self._insert = True
        return self

    def execute(self) -> dict:
        t = self.table
        snap, data_schema, part_schema = t._ctx()
        if part_schema and self._insert:
            raise ColumnarProcessingError(
                "MERGE insert into partitioned tables is not supported yet")
        src = self.source_df.collect_table()
        src_names = list(src.names)
        for k in self.on:
            if k not in src_names:
                raise ColumnarProcessingError(
                    f"merge key {k!r} not in source {src_names}")
        key_idx = [src_names.index(k) for k in self.on]
        # SQL null semantics: a NULL key never matches — exclude null-keyed
        # source rows from the probe side entirely
        src_valid = np.ones(src.num_rows, dtype=bool)
        for i in key_idx:
            src_valid &= src.columns[i].validity
        src_rows = np.flatnonzero(src_valid)
        src_keys = [src.columns[i].data[src_valid] for i in key_idx]
        if (self._update_set or self._delete) and len(src_rows) and \
                len(np.unique(_key_codes(src_keys))) < len(src_rows):
            # Delta semantics: a target row must not match multiple source
            # rows when matched-clauses exist
            raise ColumnarProcessingError(
                "MERGE source has multiple rows for at least one key "
                "(ambiguous matched-clause application)")

        from spark_rapids_tpu_torch.conf import DELTA_LOW_SHUFFLE_MERGE
        low_shuffle = bool(
            t.session.conf.get_entry(DELTA_LOW_SHUFFLE_MERGE))
        pmap = t._phys(snap)
        cdf = snap.metadata.cdf_enabled()
        cdc_tables: List[HostTable] = []
        txn = OptimisticTransaction(t.log, t.session.conf,
                                    read_version=snap.version,
                                    session=t.session)
        now = int(time.time() * 1000)
        matched_rows = deleted_rows = rewritten_files = dv_files = 0
        #: source rows (of the non-null-keyed ones) that matched a target row
        matched_src = np.zeros(len(src_rows), dtype=bool)
        for add in snap.files:
            phys = _read_physical(t.table_path, add, data_schema,
                                  physical=pmap)
            live = np.ones(phys.num_rows, dtype=bool)
            if add.deletion_vector:
                dv = read_dv(t.table_path, add.deletion_vector)
                live[dv[dv < phys.num_rows]] = False
            full = _with_partitions(phys, add, part_schema)
            tgt_idx = [list(full.names).index(k) for k in self.on]
            tgt_valid = live.copy()
            for i in tgt_idx:
                tgt_valid &= full.columns[i].validity
            tgt_rows = np.flatnonzero(tgt_valid)
            got, src_hit = _merge_match(
                [full.columns[i].data[tgt_valid] for i in tgt_idx], src_keys)
            hit = np.zeros(full.num_rows, dtype=np.int64) - 1
            hit[tgt_rows[got >= 0]] = src_rows[got[got >= 0]]
            matched_src |= src_hit
            matched = hit >= 0
            if not matched.any():
                continue
            matched_rows += int(matched.sum())
            if cdf and self._delete:
                cdc_tables.append(_cdc_rows(full, matched & live, "delete"))
            if self._delete:
                deleted_rows += int(matched.sum())
                keep = live & ~matched
            else:
                keep = live
            if low_shuffle and not (self._update_set or self._delete):
                # insert-only merge: matched target rows are untouched —
                # no file actions at all for this file
                continue
            if low_shuffle:
                # LOW-SHUFFLE path (GpuLowShuffleMergeCommand analog):
                # matched rows die via a deletion vector; updates write
                # ONLY the touched rows to a small file — untouched rows
                # of this file never rewrite
                dead = ~live | matched
                if dead.all():
                    txn.stage(RemoveFile(add.path, now))
                else:
                    desc = write_dv_file(
                        t.table_path,
                        np.flatnonzero(dead).astype(np.int64))
                    txn.stage(RemoveFile(add.path, now,
                                         data_change=False))
                    txn.stage(AddFile(
                        path=add.path,
                        partition_values=add.partition_values,
                        size=add.size, modification_time=now,
                        data_change=False, stats=add.stats,
                        deletion_vector=desc))
                    dv_files += 1
                if self._update_set and not self._delete:
                    rows = np.flatnonzero(matched)
                    upd_cols = []
                    for name, col in zip(full.names, full.columns):
                        if name in self._update_set:
                            sc = _cast_col(src.columns[src_names.index(
                                self._update_set[name])], col.dtype)
                            upd_cols.append(HostColumn(
                                col.dtype, sc.data[hit[rows]],
                                sc.validity[hit[rows]]))
                        else:
                            upd_cols.append(HostColumn(
                                col.dtype, col.data[rows],
                                col.validity[rows]))
                    upd = HostTable(list(full.names), upd_cols)
                    if cdf:
                        allm = np.ones(upd.num_rows, dtype=bool)
                        cdc_tables.append(_cdc_rows(
                            full, matched & live, "update_preimage"))
                        cdc_tables.append(_cdc_rows(upd, allm,
                                                    "update_postimage"))
                    data_only = HostTable(
                        [n for n, _ in data_schema],
                        [upd.columns[list(upd.names).index(n)]
                         for n, _ in data_schema])
                    txn.stage(_write_data_file(
                        t.table_path, data_only, add.partition_values,
                        os.path.dirname(add.path), physical=pmap))
                continue
            rewritten_files += 1
            out_cols = []
            for name, col in zip(full.names, full.columns):
                if (self._update_set and name in self._update_set
                        and not self._delete):
                    sc = src.columns[src_names.index(
                        self._update_set[name])]
                    data = col.data.copy()
                    validity = col.validity.copy()
                    rows = np.flatnonzero(matched)
                    data[rows] = sc.data[hit[rows]]
                    validity[rows] = sc.validity[hit[rows]]
                    out_cols.append(HostColumn(col.dtype, data, validity))
                else:
                    out_cols.append(col)
            full_updated = HostTable(list(full.names), out_cols)
            if cdf and self._update_set and not self._delete:
                cdc_tables.append(_cdc_rows(full, matched & live,
                                            "update_preimage"))
                cdc_tables.append(_cdc_rows(full_updated, matched & live,
                                            "update_postimage"))
            updated = _mask_table(full_updated, keep)
            data_only = HostTable(
                [n for n, _ in data_schema],
                [updated.columns[list(updated.names).index(n)]
                 for n, _ in data_schema])
            if data_only.num_rows:
                txn.stage(_write_data_file(
                    t.table_path, data_only, add.partition_values,
                    os.path.dirname(add.path), physical=pmap))
            txn.stage(RemoveFile(add.path, now))

        inserted = 0
        if self._insert:
            mask = np.ones(src.num_rows, dtype=bool)
            mask[src_rows[matched_src]] = False
            unmatched = np.flatnonzero(mask)
            if len(unmatched):
                ins = _mask_table(src, mask)
                # project source to the target data schema by name
                cols = []
                for n, dt in data_schema:
                    if n not in src_names:
                        raise ColumnarProcessingError(
                            f"insert requires source column {n!r}")
                    cols.append(_cast_col(ins.columns[src_names.index(n)],
                                          dt))
                ins_table = HostTable([n for n, _ in data_schema], cols)
                txn.stage(_write_data_file(
                    t.table_path, ins_table, {}, physical=pmap))
                if cdf:
                    cdc_tables.append(_cdc_rows(
                        ins_table, np.ones(ins_table.num_rows, dtype=bool),
                        "insert"))
                inserted = len(unmatched)

        if cdf:
            cdc = _write_cdc_file(t.table_path, cdc_tables, pmap)
            if cdc is not None:
                txn.stage(cdc)
        if txn.actions:
            txn.commit("MERGE")
        return {"num_matched_rows": matched_rows,
                "num_deleted_rows": deleted_rows,
                "num_inserted_rows": inserted,
                "low_shuffle": low_shuffle,
                "num_rewritten_files": rewritten_files,
                "num_dv_files": dv_files}
