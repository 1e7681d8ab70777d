"""File IO: scans and writers (port of ``spark_rapids_tpu/io``: the
Parquet, ORC, Avro, CSV, Hive text and JSON scans over the three reader
modes, the Parquet, ORC, CSV, Hive text and JSON writers and the
transactional committer).

Decoding runs on the host, as in the reference, but through the port's
own codecs: Parquet in ``parquet_format.py``, ORC in ``orc_format.py``,
the text formats in ``text_format.py`` (no pyarrow for any), Avro in pure
Python; ZSTD, LZ4, Snappy and the run-length streams in the host library
(``native/``).
"""

from spark_rapids_tpu_torch.io.avro import AvroScanNode
from spark_rapids_tpu_torch.io.committer import WriteJob, read_manifest
from spark_rapids_tpu_torch.io.common import FileScanNode, ReaderMode
from spark_rapids_tpu_torch.io.csv import CsvScanNode, write_csv
from spark_rapids_tpu_torch.io.hive_text import (
    HiveTextScanNode,
    write_hive_text,
)
from spark_rapids_tpu_torch.io.json import JsonScanNode, write_json
from spark_rapids_tpu_torch.io.orc import OrcScanNode, write_orc
from spark_rapids_tpu_torch.io.parquet import ParquetScanNode, write_parquet
from spark_rapids_tpu_torch.overrides.rules import register_file_scan

for _cls in (ParquetScanNode, OrcScanNode, AvroScanNode, CsvScanNode, JsonScanNode,
             HiveTextScanNode):
    register_file_scan(_cls)
del _cls

__all__ = [
    "AvroScanNode",
    "CsvScanNode",
    "FileScanNode",
    "HiveTextScanNode",
    "JsonScanNode",
    "OrcScanNode",
    "ParquetScanNode",
    "ReaderMode",
    "WriteJob",
    "read_manifest",
    "write_csv",
    "write_hive_text",
    "write_json",
    "write_orc",
    "write_parquet",
]
