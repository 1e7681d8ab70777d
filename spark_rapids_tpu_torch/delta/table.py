"""Delta table read and write through the engine (port of
``spark_rapids_tpu/delta/table.py``).

Reference (SURVEY.md §2.8): the delta-lake module's scan and write path:
``GpuDelta*Scan`` reads the snapshot's Parquet files with deletion-vector
filtering; ``GpuOptimisticTransaction`` stages Parquet writes and commits
add and remove actions with per-file column statistics
(``GpuStatisticsCollection``). Here the scan node is a ``FileScanNode``
registered with the overrides (``TpuFileScanExec`` on the card: the files
decode on the host through the port's Parquet codec, the deletion vectors
apply there, and the batches upload), and writes go through the port's
Parquet writer with optimistic commits and retries."""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.conf import DELTA_CHECKPOINT_INTERVAL, RapidsConf
from spark_rapids_tpu_torch.delta.log import (
    AddFile,
    DeltaConcurrentModificationException,
    DeltaConcurrentWriteException,
    DeltaLog,
    DeltaMetadataChangedException,
    Metadata,
    PROTOCOL_ACTION,
    RemoveFile,
    Snapshot,
    schema_to_json,
)
from spark_rapids_tpu_torch.delta.roaring import deserialize_dv, serialize_dv
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.io import parquet_format as PF
from spark_rapids_tpu_torch.io.common import FileScanNode, row_carrier_table
from spark_rapids_tpu_torch.plan.nodes import PlanNode, Schema


# -- deletion vectors --------------------------------------------------------
#
# Spec framing (Delta PROTOCOL.md "Deletion Vector Format"):
# a DV FILE starts with a 1-byte format version (1); each stored vector is
# a 4-byte big-endian size, the serialized RoaringBitmapArray blob, and a
# 4-byte big-endian CRC-32 of the blob. The descriptor's ``offset`` points
# at the size prefix; ``sizeInBytes`` is the blob length (without
# prefix/checksum). Storage types: 'u' = path derived from a base85 uuid
# relative to the table (written here), 'p' = absolute path, 'i' = inline
# base85 blob.

import base64
import zlib


def _dv_relative_path(path_or_inline: str) -> str:
    """'u' storage: the LAST 20 chars are the base85 (RFC 1924) uuid; any
    leading chars are a directory prefix."""
    enc = path_or_inline[-20:]
    prefix = path_or_inline[:-20]
    u = uuid.UUID(bytes=base64.b85decode(enc))
    name = f"deletion_vector_{u}.bin"
    return os.path.join(prefix, name) if prefix else name


def write_dv_file(table_path: str, row_indexes: np.ndarray) -> dict:
    """Persist a deletion vector with spec framing; returns the
    deletionVector descriptor for the add action ('u' storage)."""
    blob = serialize_dv(row_indexes)
    u = uuid.uuid4()
    enc = base64.b85encode(u.bytes).decode()
    name = f"deletion_vector_{u}.bin"
    dv_path = os.path.join(table_path, name)
    with open(dv_path, "wb") as f:
        f.write(b"\x01")  # format version
        f.write(len(blob).to_bytes(4, "big"))
        f.write(blob)
        f.write(zlib.crc32(blob).to_bytes(4, "big"))
    return {"storageType": "u", "pathOrInlineDv": enc, "offset": 1,
            "sizeInBytes": len(blob), "cardinality": int(len(row_indexes))}


def read_dv(table_path: str, descriptor: dict) -> np.ndarray:
    st = descriptor["storageType"]
    if st == "i":
        return deserialize_dv(base64.b85decode(descriptor["pathOrInlineDv"]))
    if st == "u":
        p = os.path.join(table_path,
                         _dv_relative_path(descriptor["pathOrInlineDv"]))
    elif st == "p":
        p = descriptor["pathOrInlineDv"]
        if not os.path.isabs(p):  # tolerate our pre-spec relative form
            p = os.path.join(table_path, p)
    else:
        raise ColumnarProcessingError(
            f"deletion-vector storage {st!r} not supported")
    with open(p, "rb") as f:
        off = descriptor.get("offset", 0)
        if off == 0:
            # pre-framing files stored the bare blob at offset 0
            buf = f.read()
            return deserialize_dv(buf)
        f.seek(off)
        size = int.from_bytes(f.read(4), "big")
        blob = f.read(size)
        crc = int.from_bytes(f.read(4), "big")
    if len(blob) != size or zlib.crc32(blob) != crc:
        raise ColumnarProcessingError(
            f"deletion vector at {p}:{off} failed checksum")
    return deserialize_dv(blob)


# -- scan --------------------------------------------------------------------

def attach_partition_columns(table: HostTable, add: AddFile,
                             part_schema) -> HostTable:
    """Append typed partition-value columns from an add action's
    partitionValues (one shared implementation for the scan and the DML
    commands)."""
    if not part_schema:
        return table
    n = table.num_rows
    names = list(table.names)
    cols = list(table.columns)
    for name, dt in part_schema:
        raw = add.partition_values.get(name)
        if raw is None:
            validity = np.zeros(n, dtype=np.bool_)
            data = (np.full(n, None, dtype=object)
                    if isinstance(dt, T.StringType)
                    else np.zeros(n, dtype=dt.np_dtype))
        else:
            validity = np.ones(n, dtype=np.bool_)
            if isinstance(dt, T.StringType):
                data = np.full(n, raw, dtype=object)
            elif isinstance(dt, (T.FloatType, T.DoubleType)):
                data = np.full(n, float(raw), dtype=dt.np_dtype)
            elif isinstance(dt, T.BooleanType):
                data = np.full(n, raw == "true", dtype=np.bool_)
            else:
                data = np.full(n, int(raw), dtype=dt.np_dtype)
        names.append(name)
        cols.append(HostColumn(dt, data, validity))
    return HostTable(names, cols)


class DeltaScanNode(FileScanNode):
    """Snapshot scan: file list + partition values + deletion vectors come
    from the LOG, not from directory structure."""

    format_name = "delta"

    def __init__(self, table_path: str, conf: RapidsConf,
                 version_as_of: Optional[int] = None,
                 columns: Optional[Sequence[str]] = None,
                 snapshot: Optional[Snapshot] = None, **options):
        self.table_path = table_path
        self.delta_log = DeltaLog(table_path)
        self.snap = snapshot if snapshot is not None \
            else self.delta_log.snapshot(version_as_of)
        self._adds = {os.path.join(table_path, a.path): a
                      for a in self.snap.files}
        if not self._adds:
            # empty table: synthesize an empty scan over the schema
            paths = []
        else:
            paths = sorted(self._adds)
        self._empty = not paths
        super().__init__(paths or ["<empty>"], conf, columns=columns,
                         **options)

    # expand_paths would reject []; bypass for the empty-table case
    def output_schema(self) -> Schema:
        full = list(self.snap.schema)
        if self.columns is not None:
            by_name = dict(full)
            for c in self.columns:
                if c not in by_name:
                    raise ColumnarProcessingError(
                        f"column {c!r} not in {[n for n, _ in full]}")
            full = [(c, by_name[c]) for c in self.columns]
        return full

    def file_schema(self, path: str) -> Schema:
        # data columns = schema minus partition columns
        parts = set(self.snap.metadata.partition_columns)
        return [(n, dt) for n, dt in self.snap.schema if n not in parts]

    def _cache_key_extra(self) -> tuple:
        # deletion vectors change what a FILE decodes to between versions
        return (self.snap.version,)

    def _resolve_schemas(self):
        if self._schema is not None:
            return
        parts = set(self.snap.metadata.partition_columns)
        full = self.output_schema()
        self._schema = full
        self._data_schema = [(n, dt) for n, dt in full if n not in parts]
        self._partition_schema = [(n, dt) for n, dt in full if n in parts]

    def read_file(self, path: str) -> HostTable:
        self._resolve_schemas()
        if not self._data_schema:
            # projection touches only partition columns: the row COUNT
            # still comes from the file, carried by a placeholder column
            table = row_carrier_table(PF.read_footer(path).num_rows)
        else:
            # column mapping: files store PHYSICAL names; the engine reads
            # by physical name and surfaces logical (Delta columnMapping
            # mode=name/id; identity map when off)
            phys = None
            if self.snap.metadata is not None \
                    and self.snap.metadata.column_mapping_mode() != "none":
                phys = self.snap.metadata.physical_names()
            table = read_physical_parquet(path, self._data_schema, phys)
        add = self._adds[path]
        if add.deletion_vector:
            deleted = read_dv(self.table_path, add.deletion_vector)
            keep = np.ones(table.num_rows, dtype=bool)
            keep[deleted[deleted < table.num_rows]] = False
            table = _mask_table(table, keep)
        return table

    def _with_partition_columns(self, table: HostTable, path: str) -> HostTable:
        """Partition values come from the add action, typed per schema."""
        self._resolve_schemas()
        if not self._partition_schema:
            return table
        full = attach_partition_columns(table, self._adds[path],
                                        self._partition_schema)
        by_name = dict(zip(full.names, full.columns))
        out = [n2 for n2, _ in self._schema]
        return HostTable(out, [by_name[n2] for n2 in out])

    def execute_host(self, dynamic_prunes=None,
                     metrics=None) -> Iterator[HostTable]:
        if self._empty:
            from spark_rapids_tpu_torch.columnar.table import (
                empty_host_table,
            )
            return iter([empty_host_table(self.output_schema())])
        return super().execute_host(dynamic_prunes=dynamic_prunes,
                                    metrics=metrics)

    def estimate_bytes(self):
        return sum(a.size for a in self.snap.files)

    def describe(self):
        return (f"DeltaScan[v{self.snap.version}, "
                f"{len(self.snap.files)} files]")


def _mask_table(table: HostTable, keep: np.ndarray) -> HostTable:
    return table.take(np.flatnonzero(keep))


# -- write transaction -------------------------------------------------------

def _column_stats(table: HostTable) -> str:
    """Per-file stats JSON (numRecords + min/max per leaf column) — the
    GpuStatisticsCollection analog used for data skipping."""
    stats = {"numRecords": int(table.num_rows), "minValues": {},
             "maxValues": {}, "nullCount": {}}
    for name, col in zip(table.names, table.columns):
        valid = col.validity
        stats["nullCount"][name] = int((~valid).sum())
        if not valid.any():
            continue
        vals = col.data[valid]
        if isinstance(col.dtype, T.StringType):
            # the sorted dictionary's codes of the valid rows (the writer
            # encodes the column anyway): min and max by code
            codes, dictionary = col.encoded()
            used = codes[valid]
            stats["minValues"][name] = dictionary[used.min()]
            stats["maxValues"][name] = dictionary[used.max()]
        elif isinstance(col.dtype, (T.FloatType, T.DoubleType)):
            finite = vals[np.isfinite(vals)]
            if len(finite):
                stats["minValues"][name] = float(finite.min())
                stats["maxValues"][name] = float(finite.max())
        else:
            stats["minValues"][name] = int(vals.min())
            stats["maxValues"][name] = int(vals.max())
    return json.dumps(stats)


def read_physical_parquet(full_path: str, schema,
                          phys_map: Optional[Dict[str, str]]) -> HostTable:
    """ONE data/cdc parquet as the given LOGICAL schema: read by physical
    column name (column mapping; identity when None), decode, rename to
    logical, null-fill columns the file predates (mergeSchema evolution).
    The single implementation behind the scan node, the DML readers and
    the cdc reader."""
    from spark_rapids_tpu_torch.io.parquet import _widen, _widens
    meta = PF.read_footer(full_path)
    have = {lf.name for lf in meta.leaves}
    pn = (lambda n: phys_map.get(n, n)) if phys_map else (lambda n: n)
    present = [(n, dt) for n, dt in schema if pn(n) in have]
    missing = [(n, dt) for n, dt in schema if pn(n) not in have]
    for n, dt in present:
        got = meta.leaf(pn(n)).require()
        if got != dt and not _widens(got, dt):
            raise ColumnarProcessingError(
                f"{full_path}: column {pn(n)!r} is {got}, the Delta schema "
                f"says {dt}")
    if present:
        t = PF.read_columns(full_path, meta, [pn(n) for n, _ in present])
        table = HostTable([n for n, _ in present],
                          [_widen(c, dt) for c, (_, dt) in
                           zip(t.columns, present)])
    else:
        table = HostTable([], [])
    if not missing:
        return table
    by_name = dict(zip(table.names, table.columns))
    n_rows = table.num_rows if present else meta.num_rows
    for n, dt in missing:
        by_name[n] = _null_column(dt, n_rows)
    return HostTable([n for n, _ in schema],
                     [by_name[n] for n, _ in schema])


def _evolved_metadata(old_meta: Metadata, evolved_schema,
                      partition_by) -> Metadata:
    """Metadata action for a schema evolution that PRESERVES table
    configuration and per-field metadata (column-mapping physical names,
    ids). A bare schema_to_json would wipe delta.columnMapping state and
    delta.enableChangeDataFeed.

    On a mapped table (columnMapping.mode != none) every NEW field must
    get its own physicalName/id and maxColumnId must advance, or the
    committed metadata violates the column-mapping protocol for external
    readers."""
    from spark_rapids_tpu_torch.delta.log import schema_fields_from_json
    old_fields = {f["name"]: f
                  for f in schema_fields_from_json(old_meta.schema_json)}
    new_json = json.loads(schema_to_json(evolved_schema))
    cfg = dict(old_meta.configuration)
    mapped = old_meta.column_mapping_mode() != "none"
    max_id = int(cfg.get("delta.columnMapping.maxColumnId", "0") or 0)
    for f in old_fields.values():
        fid = (f.get("metadata") or {}).get("delta.columnMapping.id", 0)
        max_id = max(max_id, int(fid or 0))
    merged = []
    for f in new_json["fields"]:
        have = old_fields.get(f["name"])
        if have is not None:
            merged.append(have)
            continue
        if mapped:
            md = dict(f.get("metadata") or {})
            max_id += 1
            # new physical names are UUID-based so a later rename/re-add
            # of the same logical name can never collide with this file
            # column (Delta's DeltaColumnMapping convention)
            md.setdefault("delta.columnMapping.physicalName",
                          f"col-{uuid.uuid4()}")
            md.setdefault("delta.columnMapping.id", max_id)
            f = dict(f, metadata=md)
        merged.append(f)
    if mapped:
        cfg["delta.columnMapping.maxColumnId"] = str(max_id)
    return Metadata(json.dumps({"type": "struct", "fields": merged}),
                    list(partition_by), table_id=old_meta.table_id,
                    name=old_meta.name, configuration=cfg)


def _write_data_file(table_path: str, table: HostTable,
                     partition_values: Dict[str, str],
                     subdir: str = "",
                     physical: Optional[Dict[str, str]] = None) -> AddFile:
    rel_dir = subdir
    os.makedirs(os.path.join(table_path, rel_dir) if rel_dir else table_path,
                exist_ok=True)
    rel = os.path.join(rel_dir, f"part-{uuid.uuid4().hex}.parquet") \
        if rel_dir else f"part-{uuid.uuid4().hex}.parquet"
    full = os.path.join(table_path, rel)
    if physical:
        # column mapping: data files carry PHYSICAL column names
        table = HostTable([physical.get(n, n) for n in table.names],
                          list(table.columns))
    PF.write_table(table, full)
    return AddFile(path=rel, partition_values=dict(partition_values),
                   size=os.path.getsize(full),
                   modification_time=int(time.time() * 1000),
                   stats=_column_stats(table))


class OptimisticTransaction:
    """Stage file writes, then commit with conflict classification and
    bounded rebase-and-retry (GpuOptimisticTransaction analog). A
    transaction that ultimately FAILS sweeps the data files it staged
    into the table directory — they are unreferenced by any committed
    version and would otherwise sit as orphans until vacuum."""

    def __init__(self, log: DeltaLog, conf: RapidsConf,
                 read_version: Optional[int] = None, session=None):
        self.log = log
        self.conf = conf
        self.read_version = read_version
        #: the session whose next event record carries this commit's
        #: retries (the commit runs between query envelopes)
        self.session = session
        self.actions: List[dict] = []
        #: full paths of files this txn wrote into the table dir —
        #: shielded from concurrent vacuum until commit resolves
        self._created: set = set()

    def stage(self, *actions):
        from spark_rapids_tpu_torch.io.committer import protect_files
        for a in actions:
            act = a.to_action() if hasattr(a, "to_action") else a
            self.actions.append(act)
            rel = None
            if "add" in act:
                rel = act["add"].get("path")
            elif "cdc" in act:
                rel = act["cdc"].get("path")
            if rel:
                self._created.add(
                    os.path.join(self.log.table_path, rel))
        if self._created:
            protect_files(self, self.log.table_path, self._created)

    # -- conflict handling ---------------------------------------------------
    def _classify_conflict(self, attempt: int):
        """Examine the winners' commits in [attempt, latest]; raise the
        typed conflict when this transaction cannot safely rebase, else
        return (no raise) meaning a blind-append rebase is legal.

        Rebase is legal exactly when this transaction is a PURE APPEND
        (no removes, no metadata — unique new files never invalidate a
        reader) AND no winner changed metadata/protocol AND no winner's
        add collides with ours on path. Everything staging removes
        (DELETE/UPDATE/MERGE/overwrite) read table state the winner may
        have changed — retrying those stale actions would silently lose
        the winner's commit."""
        try:
            latest = self.log.latest_version()
        except ColumnarProcessingError:
            return  # injected race on a log with no winner: plain retry
        pure_append = all("remove" not in a and "metaData" not in a
                          and "protocol" not in a for a in self.actions)
        my_adds = {a["add"]["path"] for a in self.actions if "add" in a}
        for v in range(attempt, latest + 1):
            try:
                winner = self.log.read_actions(v)
            except FileNotFoundError:
                continue  # gap in the log: nothing to conflict with
            except (OSError, ValueError) as exc:
                # commit files publish atomically (content-complete at
                # first visibility), so an unreadable/unparseable
                # winner is durable corruption or an access failure —
                # safety is unprovable; surface typed, never
                # blind-rebase over a winner we could not inspect
                raise DeltaConcurrentWriteException(
                    f"cannot verify concurrent commit v{v} of "
                    f"{self.log.table_path} ({exc}); not rebasing "
                    "over an unreadable winner") from exc
            for wa in winner:
                if "metaData" in wa or "protocol" in wa:
                    raise DeltaMetadataChangedException(
                        f"concurrent commit v{v} of "
                        f"{self.log.table_path} changed table "
                        "metadata/protocol; re-read the table and "
                        "re-derive the write")
                if not pure_append and ("add" in wa or "remove" in wa):
                    raise DeltaConcurrentWriteException(
                        f"concurrent commit v{v} of "
                        f"{self.log.table_path} wrote files this "
                        "transaction's removes/rewrites were derived "
                        "without; re-read the table and retry the "
                        "command")
                if "add" in wa and wa["add"].get("path") in my_adds:
                    raise DeltaConcurrentWriteException(
                        f"concurrent commit v{v} of "
                        f"{self.log.table_path} added the same file "
                        f"path {wa['add'].get('path')!r}")

    def _sweep_staged_files(self) -> int:
        """Delete the DATA files this failed transaction wrote into the
        table directory. Only files this transaction CREATED are swept:
        an add that re-stages an existing path with a deletion vector
        (DELETE/MERGE DV path) or that was live at the read snapshot is
        someone's committed data and stays."""
        pre_existing: set = set()
        if self.read_version is not None and self.read_version >= 0:
            try:
                pre_existing = {
                    a.path
                    for a in self.log.snapshot(self.read_version).files}
            except ColumnarProcessingError:
                pre_existing = set()
        swept = 0
        for act in self.actions:
            if "add" in act:
                a = act["add"]
                if a.get("deletionVector") or a["path"] in pre_existing:
                    continue
                rel = a["path"]
            elif "cdc" in act:
                rel = act["cdc"]["path"]
            else:
                continue
            full = os.path.join(self.log.table_path, rel)
            try:
                os.unlink(full)
                swept += 1
            except OSError:
                pass
        if swept:
            from spark_rapids_tpu_torch.io.committer import WRITE_METRICS
            WRITE_METRICS.add("stagingFilesSwept", swept)
        return swept

    def commit(self, op_name: str, max_retries: Optional[int] = None) -> int:
        from spark_rapids_tpu_torch.io.committer import unprotect_files
        try:
            return self._commit(op_name, max_retries)
        finally:
            # the txn lifecycle ends either way: committed files are in
            # the log (vacuum's live set), failed ones were swept —
            # drop the concurrent-vacuum shield
            unprotect_files(self)

    def _commit(self, op_name: str, max_retries: Optional[int]) -> int:
        from spark_rapids_tpu_torch.conf import (
            WRITE_COMMIT_RETRY_WAIT_MS,
            WRITE_MAX_COMMIT_RETRIES,
        )
        from spark_rapids_tpu_torch.io.committer import WRITE_METRICS
        if max_retries is None:
            max_retries = int(self.conf.get_entry(WRITE_MAX_COMMIT_RETRIES))
        wait_s = int(
            self.conf.get_entry(WRITE_COMMIT_RETRY_WAIT_MS)) / 1000.0
        base = self.read_version
        if base is None:
            try:
                base = self.log.latest_version()
            except ColumnarProcessingError:
                base = -1
        attempt = base + 1
        for retry in range(max_retries + 1):
            try:
                v = self.log.commit(self.actions, attempt, op_name)
                self._maybe_checkpoint(v)
                return v
            except DeltaConcurrentModificationException:
                WRITE_METRICS.add("commitConflicts", 1)
                try:
                    # typed metadata/overlap conflicts raise from here;
                    # a clean blind-append race falls through to rebase
                    self._classify_conflict(attempt)
                except DeltaConcurrentModificationException:
                    self._sweep_staged_files()
                    raise
                try:
                    attempt = self.log.latest_version() + 1
                except ColumnarProcessingError:
                    pass  # injected race before any commit exists
                if retry < max_retries:
                    WRITE_METRICS.add("commitRetries", 1)
                    if self.session is not None:
                        self.session.stage_stream_delta("commitRetries")
                    if wait_s > 0:
                        time.sleep(wait_s)
        self._sweep_staged_files()
        raise DeltaConcurrentModificationException(
            f"gave up committing to {self.log.table_path} after "
            f"{max_retries} retries")

    def _maybe_checkpoint(self, version: int):
        interval = int(self.conf.get_entry(DELTA_CHECKPOINT_INTERVAL))
        if interval > 0 and version > 0 and version % interval == 0:
            self.log.write_checkpoint(self.log.snapshot(version))


def _split_partitions(table: HostTable, partition_by: List[str]):
    """Yield (partition_values dict, subdir, subtable-without-partition-
    columns)."""
    if not partition_by:
        yield {}, "", table
        return
    pdf_cols = {n: c for n, c in zip(table.names, table.columns)}
    keys = [pdf_cols[k] for k in partition_by]
    n = table.num_rows
    tags = np.zeros(n, dtype=object)
    for i in range(n):
        tags[i] = tuple(
            None if not k.validity[i] else k.data[i] for k in keys)
    data_names = [nm for nm in table.names if nm not in set(partition_by)]
    for tag in sorted(set(tags.tolist()), key=repr):
        mask = np.array([t == tag for t in tags.tolist()])
        vals = {k: (None if v is None else str(v))
                for k, v in zip(partition_by, tag)}
        subdir = "/".join(
            f"{k}={'__HIVE_DEFAULT_PARTITION__' if v is None else v}"
            for k, v in vals.items())
        sub = _mask_table(table, mask)
        idx = {nm: i for i, nm in enumerate(sub.names)}
        sub = HostTable(data_names,
                        [sub.columns[idx[nm]] for nm in data_names])
        yield vals, subdir, sub


def _null_column(dt, n: int) -> HostColumn:
    """All-null host column of ``dt`` (mergeSchema: files written before
    the evolution lack the added columns)."""
    if isinstance(dt, T.StringType) or T.is_dec128(dt):
        data = np.empty(n, dtype=object)
        data[:] = [None if isinstance(dt, T.StringType) else 0] * n
    else:
        data = np.zeros(n, dtype=dt.np_dtype)
    return HostColumn(dt, data, np.zeros(n, dtype=np.bool_))


def _check_write_compat(snap: Snapshot, schema, partition_by,
                        table_path: str, verb: str,
                        merge_schema: bool = False):
    """Returns the EFFECTIVE table schema: unchanged normally; with
    ``merge_schema`` (Spark's mergeSchema option), the union of the table
    schema and any NEW trailing columns the write adds — overlapping
    columns must still type-match (reference: delta-lake schema
    evolution)."""
    existing = [(n, dt.simple_string()) for n, dt in snap.schema]
    incoming = [(n, dt.simple_string()) for n, dt in schema]
    if merge_schema:
        have = dict(existing)
        for n, t in incoming:
            if n in have and have[n] != t:
                raise ColumnarProcessingError(
                    f"schema mismatch {verb} {table_path}: column {n!r} "
                    f"is {have[n]} in the table but {t} in the write "
                    "(mergeSchema cannot change column types)")
        evolved = list(snap.schema) + [
            (n, dt) for n, dt in schema if n not in have]
    else:
        if existing != incoming:
            raise ColumnarProcessingError(
                f"schema mismatch {verb} {table_path}: table has "
                f"{existing}, write has {incoming} (pass "
                "merge_schema=True to evolve the schema)")
        evolved = list(snap.schema)
    table_parts = list(snap.metadata.partition_columns)
    if list(partition_by) != table_parts:
        raise ColumnarProcessingError(
            f"partitioning mismatch {verb} {table_path}: table is "
            f"partitioned by {table_parts}, write specified "
            f"{list(partition_by)}")
    return evolved


def write_delta(df_plan: PlanNode, session, table_path: str,
                mode: str = "error",
                partition_by: Optional[List[str]] = None,
                merge_schema: bool = False,
                txn_action=None) -> int:
    """modes: error | append | overwrite (Spark writer semantics).
    ``merge_schema`` allows the write to ADD columns; the widened schema
    commits as a Metadata action (Spark mergeSchema). ``txn_action``
    (a SetTransaction) commits a streaming watermark atomically with the
    data — the exactly-once sink contract rides on it."""
    if mode not in ("error", "append", "overwrite", "ignore"):
        raise ColumnarProcessingError(
            f"unknown write mode {mode!r} (error|append|overwrite|ignore)")
    partition_by = list(partition_by or [])
    log = DeltaLog(table_path)
    schema = df_plan.output_schema()
    for k in partition_by:
        if k not in [n for n, _ in schema]:
            raise ColumnarProcessingError(
                f"partition column {k!r} not in output {schema}")
    exists = log.exists()
    if exists and mode == "error":
        raise ColumnarProcessingError(
            f"delta table already exists at {table_path} (mode=error)")
    if exists and mode == "ignore":
        return log.latest_version()
    new_meta: Optional[Metadata] = None

    if session is None:
        raise ValueError("a Delta write runs through a session")
    os.makedirs(table_path, exist_ok=True)
    table = session.execute(df_plan)

    txn = OptimisticTransaction(log, session.conf, session=session)
    if not exists:
        txn.stage(PROTOCOL_ACTION,
                  Metadata(schema_to_json(schema), partition_by,
                           table_id=uuid.uuid4().hex))
        op = "CREATE TABLE AS SELECT"
    elif mode == "overwrite":
        snap = log.snapshot()
        evolved = _check_write_compat(snap, schema, partition_by,
                                      table_path, "overwriting",
                                      merge_schema)
        if [n for n, _ in evolved] != [n for n, _ in snap.schema]:
            new_meta = _evolved_metadata(snap.metadata, evolved,
                                         partition_by)
            txn.stage(new_meta)
        # conflict detection: the removes below are vs THIS snapshot; a
        # concurrent commit must surface, not silently survive the
        # overwrite (commit() refuses blind retry when removes are staged)
        txn.read_version = snap.version
        now = int(time.time() * 1000)
        for a in snap.files:
            txn.stage(RemoveFile(a.path, now))
        op = "WRITE (overwrite)"
    else:
        op = "WRITE (append)"
        snap = log.snapshot()
        evolved = _check_write_compat(snap, schema, partition_by,
                                      table_path, "appending to",
                                      merge_schema)
        if [n for n, _ in evolved] != [n for n, _ in snap.schema]:
            # log-recorded schema change: subsequent snapshots read the
            # widened schema; old files null-fill the new columns
            txn.read_version = snap.version
            new_meta = _evolved_metadata(snap.metadata, evolved,
                                         partition_by)
            txn.stage(new_meta)

    phys = None
    if exists:
        # an evolving write must use the EVOLVED mapping so data files
        # carry the new fields' physical names, not their logical ones
        m = new_meta if new_meta is not None else log.snapshot().metadata
        if m is not None and m.column_mapping_mode() != "none":
            phys = m.physical_names()
    for vals, subdir, sub in _split_partitions(table, partition_by):
        if sub.num_rows == 0:
            continue
        txn.stage(_write_data_file(table_path, sub, vals, subdir,
                                   physical=phys))
    if txn_action is not None:
        txn.stage(txn_action)
    return txn.commit(op)
