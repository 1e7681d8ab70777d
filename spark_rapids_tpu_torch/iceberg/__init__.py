"""Iceberg read path (port of ``spark_rapids_tpu/iceberg``; reference:
sql-plugin/.../iceberg and the Java Iceberg classes, SURVEY.md §2.8):
table metadata JSON, manifest-list and manifest Avro parsing, the
data-file scan through the port's Parquet reader, positional and equality
delete application (GpuDeleteFilter / GpuIcebergReader /
GpuMultiFileBatchReader analogs)."""

from spark_rapids_tpu_torch.iceberg.metadata import (
    IcebergSnapshot,
    IcebergTableMetadata,
    load_table_metadata,
)
from spark_rapids_tpu_torch.iceberg.scan import IcebergScanNode

__all__ = ["IcebergScanNode", "IcebergTableMetadata", "IcebergSnapshot",
           "load_table_metadata"]

from spark_rapids_tpu_torch.overrides.rules import register_file_scan  # noqa: E402

register_file_scan(IcebergScanNode)
