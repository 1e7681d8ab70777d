"""File IO: scans and writers (port of ``spark_rapids_tpu/io``: the
Parquet and Avro scans over the three reader modes, the Parquet writer and
the transactional committer).

Decoding runs on the host, as in the reference, but through the port's
own codecs: Parquet in ``parquet_format.py`` (no pyarrow), Avro in pure
Python. CSV, Hive text, JSON and ORC wait for ROADMAP item 8b and raise
through the source SPI (sources.py).
"""

from spark_rapids_tpu_torch.io.avro import AvroScanNode
from spark_rapids_tpu_torch.io.committer import WriteJob, read_manifest
from spark_rapids_tpu_torch.io.common import FileScanNode, ReaderMode
from spark_rapids_tpu_torch.io.parquet import ParquetScanNode, write_parquet
from spark_rapids_tpu_torch.overrides.rules import register_file_scan

for _cls in (ParquetScanNode, AvroScanNode):
    register_file_scan(_cls)
del _cls

__all__ = [
    "AvroScanNode",
    "FileScanNode",
    "ParquetScanNode",
    "ReaderMode",
    "WriteJob",
    "read_manifest",
    "write_parquet",
]
