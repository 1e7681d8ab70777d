"""Delta transaction log: actions, snapshot replay, checkpoints, commits
(port of ``spark_rapids_tpu/delta/log.py``).

Reference (SURVEY.md §2.8): the ``delta-lake/`` module family accelerates
Delta Lake on the GPU (``GpuOptimisticTransaction``, ``GpuDeltaLog``,
checkpoint and snapshot machinery per Delta version). Like the JAX
package, the port implements the Delta PROTOCOL itself, on the host:

- ``_delta_log/{version:020d}.json``: newline-delimited action objects
  (``metaData``, ``add``, ``remove``, ``protocol``, ``txn``, ``cdc``,
  ``commitInfo``);
- ``_delta_log/{version:020d}.checkpoint.parquet`` and
  ``_last_checkpoint``: the snapshot in the protocol's nested action
  schema, written and read by the port's record codec
  (io/parquet_records.py: no pyarrow), which also reads the reference's
  pyarrow-written checkpoints and its legacy flattened form;
- commits publish atomically (a temp file, then ``os.link`` claims the
  version); losers re-read and retry (OptimisticTransaction, table.py),
  and every commit bumps the table's epoch (plan/fingerprint.py), which
  stales cached results over that table only and wakes the materialized
  views (streaming/mv.py)."""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.errors import ColumnarProcessingError

from spark_rapids_tpu_torch.io.parquet_records import (
    read_records,
    write_records,
)

LOG_DIR = "_delta_log"

#: the checkpoint's action schema (Delta PROTOCOL.md), as the reference's
#: pyarrow schema spells it (io/parquet_records.py's field specs)
CHECKPOINT_SCHEMA = [
    ("protocol", "struct", [("minReaderVersion", "int32"),
                            ("minWriterVersion", "int32")]),
    ("metaData", "struct", [
        ("id", "string"), ("name", "string"),
        ("format", "struct", [("provider", "string"), ("options", "map")]),
        ("schemaString", "string"), ("partitionColumns", "list"),
        ("configuration", "map"), ("createdTime", "int64")]),
    ("add", "struct", [
        ("path", "string"), ("partitionValues", "map"), ("size", "int64"),
        ("modificationTime", "int64"), ("dataChange", "bool"),
        ("stats", "string"),
        ("deletionVector", "struct", [
            ("storageType", "string"), ("pathOrInlineDv", "string"),
            ("offset", "int32"), ("sizeInBytes", "int32"),
            ("cardinality", "int64")])]),
]


class DeltaConcurrentModificationException(ColumnarProcessingError):
    """Lost the optimistic version race. Base class: retryable when the
    transaction is a blind append (the commit loop rebases); the typed
    subclasses below are TRUE conflicts that must surface."""


class DeltaMetadataChangedException(DeltaConcurrentModificationException):
    """A concurrent winner changed table metadata/protocol (schema
    evolution, property change, protocol upgrade) — staged actions read
    state that no longer holds; blind retry would revert the winner."""


class DeltaConcurrentWriteException(DeltaConcurrentModificationException):
    """A concurrent winner's file actions OVERLAP this transaction's
    (both touched existing files — DELETE/UPDATE/MERGE/overwrite vs
    anything, or colliding add paths); retrying the stale actions would
    silently lose the winner's changes."""


# -- schema JSON (Spark StructType JSON) -------------------------------------

_TYPE_TO_JSON = {
    T.BooleanType: "boolean", T.ByteType: "byte", T.ShortType: "short",
    T.IntegerType: "integer", T.LongType: "long", T.FloatType: "float",
    T.DoubleType: "double", T.StringType: "string", T.DateType: "date",
    T.TimestampType: "timestamp",
}
_JSON_TO_TYPE = {
    "boolean": T.BOOLEAN, "byte": T.BYTE, "short": T.SHORT,
    "integer": T.INT, "long": T.LONG, "float": T.FLOAT, "double": T.DOUBLE,
    "string": T.STRING, "date": T.DATE, "timestamp": T.TIMESTAMP,
}


def schema_to_json(schema: List[Tuple[str, T.DataType]]) -> str:
    fields = []
    for name, dt in schema:
        tj = _TYPE_TO_JSON.get(type(dt))
        if tj is None:
            raise ColumnarProcessingError(
                f"type {dt.simple_string()} not supported in delta schema")
        fields.append({"name": name, "type": tj, "nullable": True,
                       "metadata": {}})
    return json.dumps({"type": "struct", "fields": fields})


def schema_from_json(s: str) -> List[Tuple[str, T.DataType]]:
    obj = json.loads(s)
    out = []
    for f in obj["fields"]:
        t = f["type"]
        if not isinstance(t, str) or t not in _JSON_TO_TYPE:
            raise ColumnarProcessingError(
                f"delta schema type {t!r} not supported on this engine")
        out.append((f["name"], _JSON_TO_TYPE[t]))
    return out


def schema_fields_from_json(s: str) -> List[dict]:
    """Raw schema field dicts incl. per-field metadata (column-mapping
    physical names / ids live there — the Delta protocol's
    delta.columnMapping.physicalName key)."""
    return list(json.loads(s)["fields"])


# -- actions -----------------------------------------------------------------

@dataclass
class AddFile:
    path: str                      # relative to table root
    partition_values: Dict[str, Optional[str]]
    size: int
    modification_time: int
    data_change: bool = True
    stats: Optional[str] = None    # JSON: numRecords, minValues, maxValues
    deletion_vector: Optional[dict] = None

    def to_action(self) -> dict:
        a = {"path": self.path, "partitionValues": self.partition_values,
             "size": self.size, "modificationTime": self.modification_time,
             "dataChange": self.data_change}
        if self.stats is not None:
            a["stats"] = self.stats
        if self.deletion_vector is not None:
            a["deletionVector"] = self.deletion_vector
        return {"add": a}

    @property
    def num_records(self) -> Optional[int]:
        if self.stats:
            try:
                return json.loads(self.stats).get("numRecords")
            except (ValueError, AttributeError):
                return None
        return None


@dataclass
class RemoveFile:
    path: str
    deletion_timestamp: int
    data_change: bool = True

    def to_action(self) -> dict:
        return {"remove": {"path": self.path,
                           "deletionTimestamp": self.deletion_timestamp,
                           "dataChange": self.data_change}}


@dataclass
class SetTransaction:
    """The Delta protocol's ``txn`` action: an application-scoped
    watermark (appId -> monotonically increasing version) committed
    ATOMICALLY with the data it covers. THE exactly-once primitive for
    streaming sinks: a micro-batch's append commits
    ``txn(streamId, batchId)`` alongside its add actions, so a replay
    after a mid-write death reads the watermark back and skips the
    batch instead of double-appending (Structured Streaming's
    DeltaSink idempotency contract)."""

    app_id: str
    version: int
    last_updated: int = 0

    def to_action(self) -> dict:
        return {"txn": {"appId": self.app_id, "version": self.version,
                        "lastUpdated": self.last_updated
                        or int(time.time() * 1000)}}


@dataclass
class Metadata:
    schema_json: str
    partition_columns: List[str] = field(default_factory=list)
    table_id: str = ""
    name: Optional[str] = None
    configuration: Dict[str, str] = field(default_factory=dict)

    def to_action(self) -> dict:
        return {"metaData": {
            "id": self.table_id, "name": self.name,
            "format": {"provider": "parquet", "options": {}},
            "schemaString": self.schema_json,
            "partitionColumns": self.partition_columns,
            "configuration": self.configuration,
            "createdTime": int(time.time() * 1000)}}

    def column_mapping_mode(self) -> str:
        return self.configuration.get("delta.columnMapping.mode", "none")

    def physical_names(self) -> Dict[str, str]:
        """logical -> physical column name map. Identity when the table
        has no column mapping (physical names ARE logical names then).
        Memoized — a scan calls this per file and the schema JSON parse
        is not free at 10k files."""
        got = getattr(self, "_phys_cache", None)
        if got is None:
            got = {}
            for f in schema_fields_from_json(self.schema_json):
                md = f.get("metadata") or {}
                got[f["name"]] = md.get(
                    "delta.columnMapping.physicalName", f["name"])
            self._phys_cache = got
        return got

    def cdf_enabled(self) -> bool:
        return self.configuration.get(
            "delta.enableChangeDataFeed", "false").lower() == "true"


PROTOCOL_ACTION = {"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}}


# -- snapshot ----------------------------------------------------------------

@dataclass
class Snapshot:
    version: int
    metadata: Optional[Metadata]
    files: List[AddFile]           # live files after replay

    @property
    def schema(self) -> List[Tuple[str, T.DataType]]:
        if self.metadata is None:
            raise ColumnarProcessingError("delta table has no metadata")
        return schema_from_json(self.metadata.schema_json)


def _log_dir(table_path: str) -> str:
    return os.path.join(table_path, LOG_DIR)


def _version_of(fname: str) -> Optional[int]:
    stem = fname.split(".")[0]
    return int(stem) if stem.isdigit() and len(stem) == 20 else None


class DeltaLog:
    """Per-table log accessor (GpuDeltaLog analog)."""

    def __init__(self, table_path: str):
        self.table_path = table_path
        self.log_path = _log_dir(table_path)

    def exists(self) -> bool:
        return os.path.isdir(self.log_path) and any(
            f.endswith(".json") for f in os.listdir(self.log_path))

    def latest_version(self) -> int:
        versions = [] if not os.path.isdir(self.log_path) else [
            v for f in os.listdir(self.log_path)
            if f.endswith(".json") and (v := _version_of(f)) is not None]
        if not versions:
            raise ColumnarProcessingError(
                f"no delta log at {self.log_path}")
        return max(versions)

    # -- checkpoints --------------------------------------------------------
    def _last_checkpoint(self) -> Optional[dict]:
        p = os.path.join(self.log_path, "_last_checkpoint")
        if not os.path.exists(p):
            return None
        try:
            with open(p) as f:
                return json.load(f)
        except ValueError:
            return None

    @staticmethod
    def _as_pv(pv) -> dict:
        """partitionValues may arrive as a dict (struct read) or a list of
        (key, value) tuples (parquet map type)."""
        if pv is None:
            return {}
        if isinstance(pv, dict):
            return pv
        return dict(pv)

    def _read_checkpoint(self, version: int) -> Tuple[Optional[Metadata],
                                                      Dict[str, AddFile]]:
        """Read a checkpoint in the SPEC schema (nested metaData/add
        structs — interoperates with real Delta readers/writers) or the
        engine's earlier flattened metaData_*/add_* form."""
        path = os.path.join(self.log_path,
                            f"{version:020d}.checkpoint.parquet")
        rows = read_records(path)
        meta = None
        adds: Dict[str, AddFile] = {}
        recognized = 0
        for r in rows:
            md = r.get("metaData")
            if md and md.get("schemaString"):
                recognized += 1
                meta = Metadata(
                    schema_json=md["schemaString"],
                    partition_columns=md.get("partitionColumns") or [],
                    table_id=md.get("id") or "",
                    name=md.get("name"),
                    configuration=self._as_pv(md.get("configuration")))
            a = r.get("add")
            if a and a.get("path"):
                recognized += 1
                dv = a.get("deletionVector")
                adds[a["path"]] = AddFile(
                    path=a["path"],
                    partition_values=self._as_pv(a.get("partitionValues")),
                    size=a.get("size") or 0,
                    modification_time=a.get("modificationTime") or 0,
                    data_change=bool(a.get("dataChange", True)),
                    stats=a.get("stats"),
                    deletion_vector=dv if dv and dv.get("storageType")
                    else None)
            # legacy flattened form
            if r.get("metaData_schemaString"):
                recognized += 1
                meta = Metadata(
                    schema_json=r["metaData_schemaString"],
                    partition_columns=json.loads(
                        r["metaData_partitionColumns"] or "[]"),
                    table_id=r.get("metaData_id") or "",
                    configuration=json.loads(
                        r.get("metaData_configuration") or "{}"))
            if r.get("add_path"):
                recognized += 1
                af = AddFile(
                    path=r["add_path"],
                    partition_values=json.loads(
                        r["add_partitionValues"] or "{}"),
                    size=r["add_size"] or 0,
                    modification_time=r["add_modificationTime"] or 0,
                    stats=r.get("add_stats"),
                    deletion_vector=json.loads(r["add_deletionVector"])
                    if r.get("add_deletionVector") else None)
                adds[af.path] = af
        if meta is None or recognized == 0:
            # schema-mismatched/foreign checkpoint: treating it as empty
            # would silently drop every pre-checkpoint AddFile
            raise ValueError(
                f"unrecognized checkpoint schema at version {version}")
        return meta, adds

    def write_checkpoint(self, snapshot: Snapshot):
        """Single-file checkpoint in the SPEC's nested action schema
        (metaData/add/protocol structs, partitionValues as map<str,str>) +
        _last_checkpoint pointer — interoperable with real Delta readers
        (Delta PROTOCOL.md's checkpoint schema)."""
        m = snapshot.metadata
        rows = [
            {"protocol": {"minReaderVersion": PROTOCOL_ACTION["protocol"][
                "minReaderVersion"],
                "minWriterVersion": PROTOCOL_ACTION["protocol"][
                "minWriterVersion"]},
             "metaData": None, "add": None},
            {"protocol": None, "add": None,
             "metaData": {
                 "id": m.table_id, "name": m.name,
                 "format": {"provider": "parquet", "options": {}},
                 "schemaString": m.schema_json,
                 "partitionColumns": m.partition_columns,
                 "configuration": dict(m.configuration),
                 "createdTime": None}},
        ]
        for a in snapshot.files:
            dv = a.deletion_vector
            rows.append({"protocol": None, "metaData": None, "add": {
                "path": a.path,
                "partitionValues": dict(a.partition_values),
                "size": a.size,
                "modificationTime": a.modification_time,
                "dataChange": False,
                "stats": a.stats,
                "deletionVector": {
                    "storageType": dv["storageType"],
                    "pathOrInlineDv": dv["pathOrInlineDv"],
                    "offset": dv.get("offset", 0),
                    "sizeInBytes": dv.get("sizeInBytes", 0),
                    "cardinality": dv.get("cardinality", 0),
                } if dv else None}})
        path = os.path.join(self.log_path,
                            f"{snapshot.version:020d}.checkpoint.parquet")
        write_records(path, CHECKPOINT_SCHEMA, rows)
        tmp = os.path.join(self.log_path, "_last_checkpoint.tmp")
        with open(tmp, "w") as f:
            json.dump({"version": snapshot.version, "size": len(rows)}, f)
        os.replace(tmp, os.path.join(self.log_path, "_last_checkpoint"))

    # -- replay -------------------------------------------------------------
    def snapshot(self, version: Optional[int] = None) -> Snapshot:
        """Replay the log up to ``version`` (default: latest), starting
        from the newest usable checkpoint."""
        latest = self.latest_version()
        target = latest if version is None else version
        if target > latest:
            raise ColumnarProcessingError(
                f"version {target} does not exist (latest {latest})")

        meta: Optional[Metadata] = None
        adds: Dict[str, AddFile] = {}
        start = 0
        cp = self._last_checkpoint()
        if cp and cp.get("version", -1) <= target:
            try:
                meta, adds = self._read_checkpoint(cp["version"])
                start = cp["version"] + 1
            except (OSError, KeyError, ValueError):
                meta, adds, start = None, {}, 0

        for v in range(start, target + 1):
            p = os.path.join(self.log_path, f"{v:020d}.json")
            if not os.path.exists(p):
                raise ColumnarProcessingError(
                    f"delta log is missing version {v}")
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    action = json.loads(line)
                    if "metaData" in action:
                        md = action["metaData"]
                        meta = Metadata(
                            schema_json=md["schemaString"],
                            partition_columns=md.get("partitionColumns", []),
                            table_id=md.get("id", ""),
                            name=md.get("name"),
                            configuration=md.get("configuration", {}))
                    elif "add" in action:
                        a = action["add"]
                        adds[a["path"]] = AddFile(
                            path=a["path"],
                            partition_values=a.get("partitionValues", {}),
                            size=a.get("size", 0),
                            modification_time=a.get("modificationTime", 0),
                            data_change=a.get("dataChange", True),
                            stats=a.get("stats"),
                            deletion_vector=a.get("deletionVector"))
                    elif "remove" in action:
                        adds.pop(action["remove"]["path"], None)
        return Snapshot(target, meta, list(adds.values()))

    def last_txn_version(self, app_id: str) -> Optional[int]:
        """The newest committed ``txn`` watermark for ``app_id``, or
        None if the application never committed one. Walks the log
        newest-first so the common case (watermark in the tail) is
        O(1) commits; txn actions replay like any action, so a
        watermark is durable exactly when its data is."""
        try:
            latest = self.latest_version()
        except ColumnarProcessingError:
            return None
        best: Optional[int] = None
        for v in range(latest, -1, -1):
            try:
                actions = self.read_actions(v)
            except (FileNotFoundError, OSError):
                continue
            for a in actions:
                t = a.get("txn")
                if t and t.get("appId") == app_id:
                    best = int(t["version"])
                    break
            if best is not None:
                return best
        return None

    # -- commit -------------------------------------------------------------
    def read_actions(self, version: int) -> List[dict]:
        """The raw action objects of one committed version (conflict
        classification reads the winners' commits through this)."""
        p = os.path.join(self.log_path, f"{version:020d}.json")
        with open(p) as f:
            return [json.loads(line) for line in f if line.strip()]

    def commit(self, actions: List[dict], expected_version: int,
               op_name: str = "WRITE") -> int:
        """Atomically write version ``expected_version``; raises
        DeltaConcurrentModificationException if someone else won the race
        (optimistic concurrency — OptimisticTransaction.commit re-reads,
        classifies the conflict, and rebases blind appends)."""
        import uuid as _uuid

        from spark_rapids_tpu_torch.runtime.faults import fault_point
        os.makedirs(self.log_path, exist_ok=True)
        payload = [{"commitInfo": {
            "timestamp": int(time.time() * 1000), "operation": op_name,
            "engineInfo": "spark-rapids-tpu-torch"}}] + actions
        path = os.path.join(self.log_path, f"{expected_version:020d}.json")
        # 'race' here simulates losing the version race without a real
        # concurrent writer; 'crash' dies mid-commit (the version file
        # either fully exists or not at all)
        fault_point("delta.commit.race")
        # publish ATOMICALLY: the payload is fully written to a temp
        # name (never matching *.json, so log listings ignore it), then
        # os.link claims the version — exclusive like open('x') AND
        # content-complete at first visibility, so a concurrent loser's
        # conflict classification can never read an empty/truncated
        # winner commit
        tmp = os.path.join(self.log_path,
                           f"{expected_version:020d}.tmp-"
                           f"{_uuid.uuid4().hex[:8]}")
        try:
            with open(tmp, "w") as f:
                for a in payload:
                    f.write(json.dumps(a) + "\n")
            try:
                os.link(tmp, path)
            except FileExistsError:
                raise DeltaConcurrentModificationException(
                    f"concurrent commit at version {expected_version} "
                    f"of {self.table_path}")
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        # a committed table write stales cached service results over
        # THIS table (the result cache keys entries on the epoch vector
        # of the tables their plan read) — scoped, so a hot cache over
        # an unrelated table survives, and the per-table bump is the
        # incremental-MV refresh trigger (epoch listeners)
        from spark_rapids_tpu_torch.plan.fingerprint import (
            bump_table_epoch,
            delta_table_id,
        )
        bump_table_epoch(
            delta_table_id(self.table_path),
            f"delta {op_name} v{expected_version} {self.table_path}")
        return expected_version

    def history(self) -> List[dict]:
        """commitInfo per version, newest first (DESCRIBE HISTORY)."""
        out = []
        for v in range(self.latest_version(), -1, -1):
            p = os.path.join(self.log_path, f"{v:020d}.json")
            if not os.path.exists(p):
                continue
            info = {"version": v}
            with open(p) as f:
                for line in f:
                    if line.strip():
                        a = json.loads(line)
                        if "commitInfo" in a:
                            info.update(a["commitInfo"])
                            break
            out.append(info)
        return out
