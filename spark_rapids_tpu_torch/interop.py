"""Carry tables between the port and anything else through plain numpy.

For this system tables take the place of weights: a test builds the same
table in both packages from these arrays and compares the results the
same way. ``HostTable.to_arrays()`` is the inverse."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable


def host_table_from_arrays(
        names: Sequence[str], type_names: Sequence[str],
        arrays: Sequence[Tuple[np.ndarray, np.ndarray]]) -> HostTable:
    """A HostTable from column names, Spark type names (``'double'``,
    ``'string'``, ``'date'``, ``'bigint'``, ...) and (data, validity)
    numpy pairs holding the Spark internal representation (dates as int32
    days, strings as object arrays of str)."""
    cols = []
    for tname, (data, validity) in zip(type_names, arrays):
        dt = T.parse_type(tname)
        data = np.asarray(data)
        if not isinstance(dt, T.StringType):
            data = data.astype(dt.np_dtype, copy=False)
        cols.append(HostColumn(dt, data, np.asarray(validity, dtype=np.bool_)))
    return HostTable(list(names), cols)
