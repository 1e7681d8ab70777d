"""Delta Lake connector (port of ``spark_rapids_tpu/delta``; reference:
the delta-lake module family, SURVEY.md §2.8): the Delta protocol (JSON
log, Parquet checkpoints, deletion vectors) over the port's scan and write
paths: snapshot reads with time travel, append and overwrite writes with
per-file statistics, DELETE (deletion vectors), UPDATE, MERGE, OPTIMIZE
(+Z-ORDER), VACUUM, the change data feed, column mapping and DESCRIBE
HISTORY."""

from spark_rapids_tpu_torch.delta.commands import (
    DeltaTable,
    MergeBuilder,
    vacuum_table,
)
from spark_rapids_tpu_torch.delta.log import (
    DeltaConcurrentModificationException,
    DeltaLog,
    SetTransaction,
    Snapshot,
)
from spark_rapids_tpu_torch.delta.table import DeltaScanNode, write_delta

__all__ = [
    "DeltaTable", "MergeBuilder", "DeltaLog", "Snapshot", "SetTransaction",
    "DeltaConcurrentModificationException", "DeltaScanNode", "write_delta",
    "vacuum_table",
]

# register the scan with the overrides engine (kill switch:
# spark.rapids.sql.exec.DeltaScanNode)
from spark_rapids_tpu_torch.overrides.rules import register_file_scan  # noqa: E402

register_file_scan(DeltaScanNode)
