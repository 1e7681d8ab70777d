"""ORC scan and writer (port of ``spark_rapids_tpu/io/orc.py``) over the
port's own codec (``io/orc_format.py``), with no pyarrow.

The scan takes the three reader modes of ``io/common.py``; COALESCING
stitches at stripe granularity, as the reference's
MultiFileOrcPartitionReader analog does. The first file sets the scan's
schema; a later file's column of another type widens losslessly to it
(the reference's safe cast) or the read raises."""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.io import orc_format as OF
from spark_rapids_tpu_torch.io.common import FileScanNode, row_carrier_table
from spark_rapids_tpu_torch.io.parquet import _widen, _widens
from spark_rapids_tpu_torch.io.writer import write_partitioned
from spark_rapids_tpu_torch.lockorder import ordered_lock
from spark_rapids_tpu_torch.plan.nodes import Schema

ORC_READER_TYPE = C.ORC_READER_TYPE


class OrcScanNode(FileScanNode):
    format_name = "orc"

    def __init__(self, paths, conf: C.RapidsConf, columns=None,
                 reader_type=None, **options):
        self._tails = {}
        self._lock = ordered_lock("io.scan.orc")
        super().__init__(paths, conf, columns=columns,
                         reader_type=reader_type, **options)

    def _conf_reader_type(self) -> str:
        return self.conf.get_entry(ORC_READER_TYPE)

    def tail(self, path: str) -> OF.FileMeta:
        """``path``'s file tail, read once per version of the file."""
        st = os.stat(path)
        key = (path, st.st_mtime_ns, st.st_size)
        got = self._tails.get(key)
        if got is None:
            got = OF.read_tail(path)
            with self._lock:
                self._tails[key] = got
        return got

    def file_schema(self, path: str) -> Schema:
        return self.tail(path).schema()

    def _file_columns(self) -> Optional[List[str]]:
        if self.columns is None:
            return None
        data_names = {n for n, _ in self.data_schema}
        return [c for c in self.columns if c in data_names]

    def _read(self, path: str, stripes: Optional[Sequence[int]]
              ) -> HostTable:
        """``path``'s data columns (of ``stripes``, or all), checked
        against the scan's schema."""
        meta = self.tail(path)
        names = self._file_columns()
        if names is None:
            names = [n for n, _ in self.data_schema]
        want = dict(self.data_schema)
        for name, dt in self.data_schema:
            got = meta.column(name).require()
            if got != dt and not _widens(got, dt):
                raise ColumnarProcessingError(
                    f"{path}: column {name!r} is {got}, the scan's schema "
                    f"says {dt}")
        if not names:
            picked = (meta.stripes if stripes is None
                      else [meta.stripes[i] for i in stripes])
            return row_carrier_table(
                meta.num_rows if stripes is None
                else sum(s.num_rows for s in picked))
        t = OF.read_columns(path, meta, names, stripes)
        return HostTable(names, [_widen(c, want[nm])
                                 for nm, c in zip(names, t.columns)])

    def read_file(self, path: str) -> HostTable:
        return self._read(path, None)

    def _coalescing_chunks(self, paths) -> Iterator[HostTable]:
        """Stripe-granular chunks for the stitcher."""
        for path in paths:
            for s in range(len(self.tail(path).stripes)):
                yield self._with_partition_columns(self._read(path, [s]),
                                                   path)


def write_orc(table: HostTable, path: str,
              partition_by: Optional[Sequence[str]] = None,
              compression: str = "zstd", committer=None) -> List[str]:
    """Write a HostTable as ORC file(s) with the port's writer; returns
    the written paths. With ``partition_by``, Hive-style key=value
    directories; all output stages through the transactional committer
    (io/committer.py); pass ``committer`` to run under a caller-owned
    WriteJob."""
    def _write_one(tbl: HostTable, file_path: str):
        OF.write_table(tbl, file_path, compression=compression)

    return write_partitioned(table, path, _write_one, "orc", partition_by,
                             committer=committer)
