"""Columnar data model: host (numpy) and device (torch) columns and tables."""

from spark_rapids_tpu_torch.columnar.column import (  # noqa: F401
    BucketPolicy,
    DeviceColumn,
    HostColumn,
    MIN_BUCKET,
    bucket_for,
)
from spark_rapids_tpu_torch.columnar.table import (  # noqa: F401
    DeviceTable,
    HostTable,
)
