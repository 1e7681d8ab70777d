"""Hive text (LazySimpleSerDe delimited) scan and writer (port of
``spark_rapids_tpu/io/hive_text.py``; reference: GpuHiveTextFileFormat /
GpuHiveTableScanExec): Hive's default layout, a \\x01 field delimiter, no
header, ``\\N`` as the null marker, no quoting. It rides the CSV scan with
Hive's defaults pinned, over the port's text codec."""

from __future__ import annotations

from typing import List, Optional, Sequence

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.io import text_format as TF
from spark_rapids_tpu_torch.io.csv import CsvScanNode
from spark_rapids_tpu_torch.io.writer import write_partitioned
from spark_rapids_tpu_torch.plan.nodes import Schema

HIVE_TEXT_READER_TYPE = C.HIVE_TEXT_READER_TYPE

HIVE_DELIM = "\x01"
HIVE_NULL = "\\N"

class HiveTextScanNode(CsvScanNode):
    """The LazySimpleSerDe properties the reference's GpuHiveTableScanExec
    reads: ``field.delim`` (``delimiter``), ``serialization.null.format``
    (``null_value``) and ``escape.delim`` (``escape``: an escaped
    delimiter, escape or newline is data). Partitioned tables (key=value
    directories) get their partition columns from the shared file scan
    (io/common.py)."""

    format_name = "hiveText"

    def __init__(self, paths, conf: C.RapidsConf, schema: Schema = None,
                 columns=None, reader_type=None,
                 delimiter: str = HIVE_DELIM, null_value: str = HIVE_NULL,
                 escape: Optional[str] = None, **options):
        if schema is None:
            raise ValueError("Hive text tables require an explicit schema "
                             "(the format carries no header)")
        super().__init__(paths, conf, columns=columns,
                         reader_type=reader_type, schema=schema,
                         header=False, sep=delimiter, null_value=null_value,
                         quote="", escape=escape, **options)

    def _conf_reader_type(self) -> str:
        return self.conf.get_entry(HIVE_TEXT_READER_TYPE)


def render_hive_text(table: HostTable, delimiter: str = HIVE_DELIM,
                     null_value: str = HIVE_NULL,
                     escape: Optional[str] = None) -> bytes:
    """The reference's ``_hive_cell`` rendering, column by column:
    lowercase booleans, ``str()`` of each Python value (unscaled integers
    for decimals, ``YYYY-MM-DD HH:MM:SS[.ffffff]`` timestamps), the null
    marker; with ``escape`` set, the escape, the delimiter and a newline
    in the rendered text are each escaped."""
    texts = [TF.format_column(c, "hive") for c in table.columns]
    if escape:
        d = TF.one_byte(delimiter, "Hive field.delim")
        e = TF.one_byte(escape, "Hive escape.delim")
        texts = [TF.escape(buf, off, TF.ESC_HIVE, d, e)
                 for buf, off in texts]
    nt = null_value.encode("utf-8")
    return TF.assemble(texts, [c.validity for c in table.columns],
                       [nt] * len(texts), [b""] * len(texts),
                       table.num_rows, b"", delimiter.encode("utf-8"),
                       b"\n", False)


def write_hive_text(table: HostTable, path: str,
                    partition_by: Optional[Sequence[str]] = None,
                    delimiter: str = HIVE_DELIM,
                    null_value: str = HIVE_NULL,
                    escape: Optional[str] = None,
                    committer=None) -> List[str]:
    def _write_one(tbl: HostTable, file_path: str):
        with open(file_path, "wb") as f:
            f.write(render_hive_text(tbl, delimiter, null_value, escape))

    return write_partitioned(table, path, _write_one, "txt", partition_by,
                             committer=committer)
