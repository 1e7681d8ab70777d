"""Logical plan nodes and the DataFrame API of the port."""

from spark_rapids_tpu_torch.plan.dataframe import (  # noqa: F401
    DataFrame,
    GroupedData,
    from_host_table,
)
