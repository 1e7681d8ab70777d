"""Iceberg table metadata and manifest parsing (port of
``spark_rapids_tpu/iceberg/metadata.py``).

Reference: the Iceberg library side the plugin binds (table metadata JSON,
manifest-list Avro, manifest Avro with nested ``data_file`` records) —
``IcebergProviderImpl.scala`` wires it, ``GpuIcebergReader.java`` consumes
the planned file tasks. Here the protocol is parsed natively: metadata
JSON (v1 ``schema`` / v2 ``schemas``), snapshot selection, manifest-list →
manifests → data/delete file entries with sequence numbers; the Avro
manifests decode through io/avro.py::decode_records."""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.errors import ColumnarProcessingError

_PRIMITIVES = {
    "boolean": T.BOOLEAN, "int": T.INT, "long": T.LONG, "float": T.FLOAT,
    "double": T.DOUBLE, "string": T.STRING, "date": T.DATE,
    "timestamp": T.TIMESTAMP, "timestamptz": T.TIMESTAMP,
}

DATA_CONTENT = 0
POSITION_DELETES = 1
EQUALITY_DELETES = 2


def _schema_from_iceberg(fields: List[dict]) -> List[Tuple[str, T.DataType]]:
    out = []
    for f in fields:
        t = f["type"]
        if not isinstance(t, str) or t not in _PRIMITIVES:
            raise ColumnarProcessingError(
                f"iceberg column {f['name']!r} type {t!r} is not supported "
                "on this engine")
        out.append((f["name"], _PRIMITIVES[t]))
    return out


@dataclass
class DataFileEntry:
    content: int           # 0 data, 1 position deletes, 2 equality deletes
    file_path: str
    file_format: str
    record_count: int
    sequence_number: int = 0
    equality_ids: List[int] = field(default_factory=list)


@dataclass
class IcebergSnapshot:
    snapshot_id: int
    manifest_list: str
    data_files: List[DataFileEntry] = field(default_factory=list)
    delete_files: List[DataFileEntry] = field(default_factory=list)


@dataclass
class IcebergTableMetadata:
    location: str
    schema: List[Tuple[str, T.DataType]]
    field_ids: Dict[int, str]        # iceberg field id -> column name
    current_snapshot_id: Optional[int]
    snapshots: List[dict]

    def snapshot_entry(self, snapshot_id: Optional[int] = None) -> dict:
        sid = snapshot_id if snapshot_id is not None \
            else self.current_snapshot_id
        if sid is None:
            raise ColumnarProcessingError("iceberg table has no snapshot")
        for s in self.snapshots:
            if s["snapshot-id"] == sid:
                return s
        raise ColumnarProcessingError(f"no iceberg snapshot {sid}")


def _resolve_path(table_path: str, p: str) -> str:
    """Iceberg stores absolute URIs; map file:// and table-relative."""
    if p.startswith("file://"):
        return p[len("file://"):]
    if os.path.isabs(p):
        return p
    return os.path.join(table_path, p)


def load_table_metadata(table_path: str) -> IcebergTableMetadata:
    meta_dir = os.path.join(table_path, "metadata")
    if not os.path.isdir(meta_dir):
        raise ColumnarProcessingError(
            f"{table_path} is not an iceberg table (no metadata/)")
    hint = os.path.join(meta_dir, "version-hint.text")
    meta_file = None
    if os.path.exists(hint):
        with open(hint) as f:
            v = f.read().strip()
        for cand in (f"v{v}.metadata.json", f"{v}.metadata.json"):
            if os.path.exists(os.path.join(meta_dir, cand)):
                meta_file = os.path.join(meta_dir, cand)
                break
    if meta_file is None:
        versions = []
        for fn in os.listdir(meta_dir):
            m = re.match(r"v?(\d+)(?:-[0-9a-f-]+)?\.metadata\.json$", fn)
            if m:
                versions.append((int(m.group(1)), fn))
        if not versions:
            raise ColumnarProcessingError(
                f"no metadata json under {meta_dir}")
        meta_file = os.path.join(meta_dir, max(versions)[1])

    with open(meta_file) as f:
        meta = json.load(f)

    if "schemas" in meta:  # v2
        sid = meta.get("current-schema-id", 0)
        schema_obj = next(s for s in meta["schemas"]
                          if s.get("schema-id", 0) == sid)
    else:  # v1
        schema_obj = meta["schema"]
    schema = _schema_from_iceberg(schema_obj["fields"])
    field_ids = {f["id"]: f["name"] for f in schema_obj["fields"]}
    return IcebergTableMetadata(
        location=meta.get("location", table_path),
        schema=schema,
        field_ids=field_ids,
        current_snapshot_id=meta.get("current-snapshot-id"),
        snapshots=meta.get("snapshots", []))


def load_snapshot(table_path: str, meta: IcebergTableMetadata,
                  snapshot_id: Optional[int] = None) -> IcebergSnapshot:
    from spark_rapids_tpu_torch.io.avro import decode_records
    entry = meta.snapshot_entry(snapshot_id)
    manifest_list = _resolve_path(table_path, entry["manifest-list"])
    with open(manifest_list, "rb") as f:
        manifests = decode_records(f.read())

    snap = IcebergSnapshot(entry["snapshot-id"], manifest_list)
    for m in manifests:
        mpath = _resolve_path(table_path, m["manifest_path"])
        with open(mpath, "rb") as f:
            entries = decode_records(f.read())
        for e in entries:
            status = e.get("status", 1)
            if status == 2:  # DELETED entry
                continue
            df = e["data_file"]
            entry_obj = DataFileEntry(
                content=df.get("content", DATA_CONTENT) or DATA_CONTENT,
                file_path=_resolve_path(table_path, df["file_path"]),
                file_format=(df.get("file_format") or "PARQUET").upper(),
                record_count=df.get("record_count", 0) or 0,
                sequence_number=e.get("sequence_number") or 0,
                equality_ids=list(df.get("equality_ids") or []))
            if entry_obj.file_format != "PARQUET":
                raise ColumnarProcessingError(
                    f"iceberg file format {entry_obj.file_format} not "
                    "supported (parquet only)")
            if entry_obj.content == DATA_CONTENT:
                snap.data_files.append(entry_obj)
            else:
                snap.delete_files.append(entry_obj)
    snap.data_files.sort(key=lambda d: d.file_path)
    return snap
