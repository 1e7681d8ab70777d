"""Iceberg snapshot scan with delete-file application (port of
``spark_rapids_tpu/iceberg/scan.py``).

Reference: ``GpuIcebergReader.java`` (applies the delete filter then hands
batches to the engine), ``GpuDeleteFilter.java`` (positional + equality
deletes), ``GpuMultiFileBatchReader.java`` (reader-mode integration).
Positional deletes are parquet files of (file_path, pos); equality
deletes are parquet files whose rows name deleted keys over the columns
given by ``equality_ids``, applied to data files with a SMALLER sequence
number (v2 sequence-number semantics). The files decode on the host
through the port's Parquet codec; the deletes apply there, vectorized
(the equality keys as dense codes, the reference's tuple set), and the
batches upload through ``TpuFileScanExec``."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.iceberg.metadata import (
    EQUALITY_DELETES,
    POSITION_DELETES,
    IcebergSnapshot,
    IcebergTableMetadata,
    load_snapshot,
    load_table_metadata,
)
from spark_rapids_tpu_torch.io import parquet_format as PF
from spark_rapids_tpu_torch.io.common import FileScanNode
from spark_rapids_tpu_torch.plan.nodes import Schema


class IcebergScanNode(FileScanNode):
    format_name = "iceberg"
    #: the delete files, loaded at the first read
    FINGERPRINT_SKIP = FileScanNode.FINGERPRINT_SKIP + ("_pos_deletes",
                                                        "_eq_deletes")

    def __init__(self, table_path: str, conf: RapidsConf,
                 snapshot_id: Optional[int] = None,
                 columns: Optional[Sequence[str]] = None, **options):
        self.table_path = table_path
        self.meta: IcebergTableMetadata = load_table_metadata(table_path)
        self.snap: IcebergSnapshot = load_snapshot(table_path, self.meta,
                                                   snapshot_id)
        self._seq_by_path = {d.file_path: d.sequence_number
                             for d in self.snap.data_files}
        self._pos_deletes: Optional[Dict[str, np.ndarray]] = None
        #: (sequence number, columns, the deleted keys' rows) per file
        self._eq_deletes: Optional[List[Tuple[int, List[str],
                                              HostTable]]] = None
        paths = [d.file_path for d in self.snap.data_files]
        self._empty = not paths
        super().__init__(paths or ["<empty>"], conf, columns=columns,
                         **options)

    def output_schema(self) -> Schema:
        full = list(self.meta.schema)
        if self.columns is not None:
            by_name = dict(full)
            for c in self.columns:
                if c not in by_name:
                    raise ColumnarProcessingError(
                        f"column {c!r} not in {[n for n, _ in full]}")
            full = [(c, by_name[c]) for c in self.columns]
        return full

    def file_schema(self, path: str) -> Schema:
        return list(self.meta.schema)

    def _resolve_schemas(self):
        if self._schema is not None:
            return
        self._schema = self.output_schema()
        self._data_schema = self._schema
        self._partition_schema = []

    def _cache_key_extra(self) -> tuple:
        return (self.snap.snapshot_id,)

    # -- delete files --------------------------------------------------------
    def _load_deletes(self):
        if self._pos_deletes is not None:
            return
        pos: Dict[str, List[np.ndarray]] = {}
        eqs: List[Tuple[int, List[str], HostTable]] = []
        for d in self.snap.delete_files:
            t = PF.read_table(d.file_path)
            by = dict(zip(t.names, t.columns))
            if d.content == POSITION_DELETES:
                paths = by["file_path"].data
                positions = by["pos"].data.astype(np.int64)
                uniq, inv = np.unique(paths.astype(str), return_inverse=True)
                inv = inv.reshape(-1)
                for i, p in enumerate(uniq):
                    pos.setdefault(self._norm(p), []).append(
                        positions[inv == i])
            elif d.content == EQUALITY_DELETES:
                cols = [self.meta.field_ids[i] for i in d.equality_ids]
                if not cols:
                    cols = list(t.names)
                eqs.append((d.sequence_number, cols,
                            HostTable(cols, [by[c] for c in cols])))
        self._pos_deletes = {p: np.unique(np.concatenate(v))
                             for p, v in pos.items()}
        self._eq_deletes = eqs

    def _norm(self, p: str) -> str:
        if p.startswith("file://"):
            p = p[len("file://"):]
        return os.path.normpath(p)

    def read_file(self, path: str) -> HostTable:
        from spark_rapids_tpu_torch.io.parquet import _widen, _widens
        self._resolve_schemas()
        self._load_deletes()
        my_seq = self._seq_by_path.get(path, 0)
        # equality deletes may need columns beyond the projection
        eq_cols = {c for seq, cols, _k in self._eq_deletes for c in cols
                   if seq > my_seq}
        proj = [n for n, _ in self._data_schema]
        read_cols = list(dict.fromkeys(proj + sorted(eq_cols)))
        all_schema = dict(self.meta.schema)
        meta = PF.read_footer(path)
        for n in read_cols:
            got = meta.leaf(n).require()
            if got != all_schema[n] and not _widens(got, all_schema[n]):
                raise ColumnarProcessingError(
                    f"{path}: column {n!r} is {got}, the Iceberg schema "
                    f"says {all_schema[n]}")
        t = PF.read_columns(path, meta, read_cols)
        by = {n: _widen(c, all_schema[n]) for n, c in zip(read_cols,
                                                           t.columns)}
        keep = np.ones(meta.num_rows, dtype=bool)
        dv = self._pos_deletes.get(self._norm(path))
        if dv is not None:
            keep[dv[dv < meta.num_rows]] = False
        for seq, cols, keys in self._eq_deletes:
            if seq <= my_seq:
                continue  # deletes only apply to OLDER data
            keep &= ~_rows_in([by[c] for c in cols], list(keys.columns))
        if not proj:
            from spark_rapids_tpu_torch.io.common import row_carrier_table
            return row_carrier_table(int(keep.sum()))
        return HostTable(proj, [by[n] for n in proj]).take(
            np.flatnonzero(keep))

    def execute_host(self, dynamic_prunes=None, metrics=None):
        if self._empty:
            from spark_rapids_tpu_torch.columnar.table import (
                empty_host_table,
            )
            return iter([empty_host_table(self.output_schema())])
        return super().execute_host(dynamic_prunes=dynamic_prunes,
                                    metrics=metrics)

    def estimate_bytes(self):
        try:
            return sum(os.path.getsize(d.file_path)
                       for d in self.snap.data_files)
        except OSError:
            return None

    def describe(self):
        return (f"IcebergScan[snap={self.snap.snapshot_id}, "
                f"{len(self.snap.data_files)} data files, "
                f"{len(self.snap.delete_files)} delete files]")


def _rows_in(cols: List[HostColumn], keys: List[HostColumn]) -> np.ndarray:
    """Which rows of ``cols`` equal some row of ``keys`` (null equals
    null), as dense joint codes of both sides."""
    n = len(cols[0])
    code = None
    for c, k in zip(cols, keys):
        both = np.concatenate([c.data[c.validity], k.data[k.validity]])
        if both.dtype == object:
            both = both.astype(str)
        uniq, inv = np.unique(both, return_inverse=True)
        inv = inv.reshape(-1)
        nv = int(c.validity.sum())
        cc = np.full(n, -1, dtype=np.int64)
        cc[c.validity] = inv[:nv]
        kc = np.full(len(k), -1, dtype=np.int64)
        kc[k.validity] = inv[nv:]
        part = np.concatenate([cc, kc]) + 1
        if code is None:
            code = part
        else:
            _, code = np.unique(code * (len(uniq) + 1) + part,
                                return_inverse=True)
            code = code.reshape(-1)
    return np.isin(code[:n], code[n:])
